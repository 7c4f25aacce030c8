"""K4's plan and split-K arithmetic on the CPU (hydrainfer_tpu_torch/ops/cuda/quant_matmul.py).

The kernel (csrc/quant_matmul.cuh) takes its form, column strip, split count
and K tile from `plan(M, K, N, fmt)`, from shapes and the weight format only.
Here: `plan` gives the skinny form at M <= 64 (int4 in 128-deep K tiles, the
others in 64-deep ones), and above it the tma form for int4 and fp8 where
TMA can address the rows, else the wide form; at least 132 blocks at every
decode shape of the three serving paths, at most 8 splits (one portable
cluster) and a block's shared memory within 227 KB in every form, strip,
format and M, with and without group scales; the K tiles of the splits
cover every tile once, and the split partials follow each format's K tile; the kernel's arithmetic in PyTorch (`quant_matmul_int8_split_plain`:
K slices summed in a fixed order, then scaled and cast) gives the plain
version within f32 rounding and the JAX Pallas kernel in interpret mode on the
same numpy inputs; and the card tests' bf16 bound (2e-2, relative and
absolute, tests/test_torch_kernels_cuda.py) holds a correctly rounded result
and rejects one that lost a K slice, so the card tests would catch a dropped
split. The wrapper passes the plan to the launch without reading data: on
"meta" tensors, which hold none, any host read would raise.
"""
import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hydrainfer_tpu.ops.pallas.quant_matmul import quant_matmul_int8 as jax_qmm
from hydrainfer_tpu_torch.models.random_init import ARCH_CONFIGS, int8_matmul_shapes
from hydrainfer_tpu_torch.ops.cuda import build
from hydrainfer_tpu_torch.ops.cuda import quant_matmul as qmm

# (K, N) of every int8 matmul on the serving paths, the lm_heads included
SERVING_ARCHS = {"serve": "llava-7b-lm", "vlm": "qwen2-vl-2b-lm", "mla": "mla-2b-lm"}
PATH_SHAPES = {f"{path}_{name}": kn for path, arch in SERVING_ARCHS.items()
               for name, kn in int8_matmul_shapes(ARCH_CONFIGS[arch]).items()}
M_SWEEP = [1, 8, 16, 17, 32, 64, 65, 256, 2048]


FORMS = ["int8", "int4", "fp8"]
FORM_BNS = {"skinny": (64, 128, 256), "wide": (128,), "tma": (128,)}


@pytest.mark.parametrize("fmt", FORMS)
@pytest.mark.parametrize("M", M_SWEEP)
@pytest.mark.parametrize("shape", list(PATH_SHAPES))
def test_plan_on_the_path_shapes(shape, M, fmt):
    K, N = PATH_SHAPES[shape]
    p = qmm.plan(M, K, N, fmt)
    form, bn, splits = p.form, p.bn, p.splits
    assert form == ("skinny" if M <= 64 else "wide" if fmt == "int8" else "tma")
    assert bn in FORM_BNS[form]
    assert p.bk == (128 if form == "skinny" and fmt == "int4" else 64)
    assert 1 <= splits <= qmm.MAX_SPLITS
    if M <= 64:
        assert p.blocks(M, N) >= qmm.SMS
    for grouped in (False, True):
        assert p.smem_bytes(M, fmt, grouped) <= qmm.MAX_SMEM
    # every split keeps at least one K tile
    tiles = -(-K // p.bk)
    assert all(qmm.split_tiles(tiles, splits, i)[1] > qmm.split_tiles(tiles, splits, i)[0]
               for i in range(splits))


@pytest.mark.parametrize("M", M_SWEEP)
@pytest.mark.parametrize("shape", list(PATH_SHAPES))
def test_int4_skinny_plan_keeps_int8s_bytes_in_flight(shape, M):
    """At M <= 64 an int4 K tile is 128 deep, so a stage holds int8's 64
    weight byte rows: int4 takes int8's strip and split count (a slice keeps
    K 256 at least: two of its tiles), so the blocks, their stages and the
    bytes in flight are int8's. fp8 plans as int8 at every M <= 64."""
    if M > 64:
        return
    K, N = PATH_SHAPES[shape]
    p8, p4, pf = (qmm.plan(M, K, N, fmt) for fmt in FORMS)
    assert pf == p8
    assert p4 == p8._replace(bk=qmm.INT4_SKINNY_BK)
    assert p4.smem_bytes(M, "int4") == p8.smem_bytes(M, "int8") + qmm.STAGES * p8.rows(M) * 128


@pytest.mark.parametrize("M", [65, 128, 256, 512, 2048])
@pytest.mark.parametrize("K,N", [(4096, 12288), (4096, 4096), (4096, 22016), (11008, 4096),
                                 (4096, 32064), (1536, 151936), (384, 256)])
def test_tma_plan_splits_to_the_fewest_waves(M, K, N):
    """The tma form (one block an SM): the split count of 1, 2 or 3 that
    finishes in the fewest waves of tile-slices (3 keeps 126 blocks
    resident), the fewest such splits within 2%."""
    p = qmm.plan(M, K, N, "int4")
    assert (p.form, p.bn, p.bk) == ("tma", qmm.TMA_COLS, qmm.BK)
    rows = 256 if M > 128 else 128
    assert p.rows(M) == rows
    tiles = -(-N // qmm.TMA_COLS) * -(-M // rows)
    most = -(-K // qmm.BK) // qmm.MIN_SLICE_TILES
    waves = {s: -(-tiles * s // r) / s for s, r in qmm.TMA_RESIDENT.items() if s <= most}
    best = min(waves.values())
    assert p.splits in waves and waves[p.splits] <= 1.02 * best
    assert all(waves[s] > 1.02 * best for s in waves if s < p.splits)
    assert p.blocks(M, N) == p.splits * tiles
    assert qmm.plan(M, K, N, "fp8") == p


@pytest.mark.parametrize("M,K,N,splits", [(256, 4096, 12288, 1), (256, 4096, 4096, 3),
                                          (256, 4096, 22016, 2), (256, 11008, 4096, 3),
                                          (512, 4096, 12288, 2), (512, 4096, 4096, 2),
                                          (512, 4096, 22016, 1), (512, 11008, 4096, 2)])
def test_tma_plan_at_llava_prefill_shapes(M, K, N, splits):
    """llava-7b-lm's four projections at M 256 and 512: the split counts
    that timed fastest on an H100 (1, 2 and 3 tried against 4, 6 and 8)."""
    assert qmm.plan(M, K, N, "fp8") == qmm.Plan("tma", 128, splits)


@pytest.mark.parametrize("K,N", [(4100, 4096), (4096, 4104), (4096, 201), (200, 256)])
def test_shapes_tma_cannot_address_take_the_wide_form(K, N):
    """x rows of K bf16 and weight rows of N bytes need 16-byte strides:
    K % 8 and N % 16, else the cp.async wide form."""
    assert qmm.tma_ok(K, N) == (K % 8 == 0 and N % 16 == 0)
    for fmt in ("int4", "fp8"):
        p = qmm.plan(256, K, N, fmt)
        assert p.form == ("tma" if qmm.tma_ok(K, N) else "wide")


@pytest.mark.parametrize("tiles", [1, 3, 24, 86, 172])
@pytest.mark.parametrize("splits", [1, 2, 5, 8])
def test_split_tiles_cover_every_tile_once(tiles, splits):
    seen = np.zeros(tiles, np.int32)
    for i in range(splits):
        lo, hi = qmm.split_tiles(tiles, splits, i)
        assert 0 <= lo <= hi <= tiles
        seen[lo:hi] += 1
    assert (seen == 1).all()


def _case(M, K, N, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = rng.integers(-127, 128, (K, N), dtype=np.int8)
    scale = ((rng.random(N) + 0.5) / (127 * K ** 0.5)).astype(np.float32)
    return x, w, scale


# skinny with 8 splits, skinny unsplit at a ragged N, wide with 4 splits, a
# K that is no multiple of either form's K tile
SPLIT_CASES = [(16, 2048, 256), (3, 200, 72), (100, 2048, 256), (65, 1000, 136)]


@pytest.mark.parametrize("M,K,N", SPLIT_CASES)
def test_split_plain_matches_the_plain_version(M, K, N):
    x, w, scale = (torch.from_numpy(a) for a in _case(M, K, N))
    got = qmm.quant_matmul_int8_split_plain(x, w, scale, torch.float32)
    ref = qmm.quant_matmul_int8_plain(x, w, scale, torch.float32)
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-5 * ref.abs().max().item())


@pytest.mark.parametrize("M,K,N", [(16, 512, 256), (100, 1024, 128)])
def test_split_plain_matches_the_jax_kernel(M, K, N):
    """Against hydrainfer_tpu's quant_matmul_int8 (the TPU kernel K4 replaces)
    in interpret mode, 128 x 128 blocks, f32 in and out."""
    x, w, scale = _case(M, K, N, seed=1)
    assert qmm.plan(M, K, N).splits > 1
    ref = np.asarray(jax_qmm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale),
                             block_k=128, block_n=128, interpret=True))
    got = qmm.quant_matmul_int8_split_plain(*(torch.from_numpy(a) for a in (x, w, scale)),
                                            torch.float32).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("M,K,N", [(16, 2048, 256), (100, 2048, 256), (32, 5472, 128)])
def test_bf16_bound_catches_a_missing_split(M, K, N):
    """bf16 x and bf16 out, as K4 serves: the kernel's arithmetic with the
    output rounded to bf16 lies within the card tests' 2e-2 of the f32 plain
    version; without any one of its K slices it does not."""
    x, w, scale = _case(M, K, N, seed=2)
    x = torch.from_numpy(x).to(torch.bfloat16)
    w, scale = torch.from_numpy(w), torch.from_numpy(scale)
    ref = qmm.quant_matmul_int8_plain(x, w, scale, torch.float32)
    got = qmm.quant_matmul_int8_split_plain(x, w, scale, torch.bfloat16)
    torch.testing.assert_close(got.float(), ref, rtol=2e-2, atol=2e-2)
    splits = qmm.plan(M, K, N).splits
    assert splits > 1
    parts = qmm.split_partials(x, w)
    for drop in range(splits):
        # what a kernel that lost slice `drop` would give
        kept = [parts[i] for i in range(splits) if i != drop]
        miss = (sum(kept[1:], kept[0]) * scale[None, :]).to(torch.bfloat16)
        with pytest.raises(AssertionError):
            torch.testing.assert_close(miss.float(), ref, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("M,K,N", [(16, 11008, 4096), (32, 2048, 32064), (256, 4096, 4096),
                                   (2048, 1536, 151936)])
def test_wrapper_launches_the_plan_from_shapes(monkeypatch, M, K, N):
    calls = []
    monkeypatch.setattr(build, "launch", lambda name, *args: calls.append((name, args)))
    meta = dict(device="meta")
    out = qmm.quant_matmul_int8(torch.empty((M, K), dtype=torch.bfloat16, **meta),
                                torch.empty((K, N), dtype=torch.int8, **meta),
                                torch.empty((N,), dtype=torch.float32, **meta), torch.float32)
    (name, args), = calls
    p = qmm.plan(M, K, N)
    # (x, w, scale, out, M, K, N, x dtype, out dtype, form, bn, splits)
    assert name == "quant_matmul"
    assert args[4:] == (M, K, N, 1, 0, qmm.FORM_CODES[p.form], p.bn, p.splits)
    assert out.shape == (M, N) and out.dtype == torch.float32


# ---------------------------------------------- the int4 and fp8 forms

from hydrainfer_tpu_torch.ops.quant import quantize_fp8, quantize_int4  # noqa: E402

FORM_QUANT = {"int4": quantize_int4, "fp8": quantize_fp8}
FORM_KERNEL = {"int4": qmm.quant_matmul_int4, "fp8": qmm.quant_matmul_fp8}
FORM_PLAIN = {"int4": qmm.quant_matmul_int4_plain, "fp8": qmm.quant_matmul_fp8_plain}


@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("fmt", ["int8", "int4", "fp8"])
@pytest.mark.parametrize("M", M_SWEEP + [3, 40])
def test_every_forms_shared_memory_fits_a_block(M, fmt, grouped):
    """Every strip width of the format's form at M (and, above 64, the
    cp.async wide form that shapes TMA cannot address take): the ring
    (int4's 128-deep skinny tiles and bk / 16 scale rows a stage with
    groups; the tma form's 5 or 6 stages) within 227 KB, and the merge tile
    within what the block asks for."""
    p = qmm.plan(M, 4096, 4096, fmt)
    forms = [p] + ([qmm.plan(M, 4100, 4096, fmt)] if M > 64 else [])
    for q in forms:
        for bn in FORM_BNS[q.form]:
            smem = q._replace(bn=bn, splits=1).smem_bytes(M, fmt, grouped)
            assert smem <= qmm.MAX_SMEM
            rows = (8 * (1 if M <= 8 else 2 if M <= 16 else 4 if M <= 32 else 8)
                    if q.form == "skinny" else 256 if q.form == "tma" and M > 128 else 128)
            assert q.rows(M) == rows and rows * (bn + 4) * 4 <= smem
    if fmt == "int8" and not grouped:
        assert qmm.Plan(p.form, bn, 1).smem_bytes(M) == smem    # int8's default


def _form_case(fmt, M, K, N, group, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((K, N)) / K ** 0.5).astype(np.float32))
    return x, FORM_QUANT[fmt](w, group=group)


# (M, K, N, group): a skinny split with g = 128, a ragged K and N per column,
# a wide split with g = 64, a K with no whole K tile at g = 32
FORM_SPLIT_CASES = [(16, 2048, 256, 128), (3, 200, 72, 0), (100, 2048, 256, 64),
                    (65, 1000, 136, 32)]


@pytest.mark.parametrize("fmt", ["int4", "fp8"])
@pytest.mark.parametrize("M,K,N,group", FORM_SPLIT_CASES)
def test_forms_split_plain_matches_the_plain_version(fmt, M, K, N, group):
    x, qt = _form_case(fmt, M, K, N, group)
    for x_dtype in (torch.float32, torch.bfloat16):
        xd = x.to(x_dtype)
        got = qmm.quant_matmul_split_plain(xd, qt.q, qt.scale, fmt, qt.group, torch.float32)
        ref = FORM_PLAIN[fmt](xd, qt.q, qt.scale, qt.group, torch.float32)
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-5 * ref.abs().max().item())


@pytest.mark.parametrize("fmt", ["int4", "fp8"])
@pytest.mark.parametrize("M,K,N,group", [(16, 2048, 256, 128), (100, 2048, 256, 0),
                                         (32, 5504, 128, 64)])
def test_forms_bf16_bound_catches_a_missing_split(fmt, M, K, N, group):
    """The card tests' 2e-2 bound on the new forms holds the kernels'
    arithmetic rounded to bf16 and rejects it without any one K slice."""
    x, qt = _form_case(fmt, M, K, N, group, seed=2)
    x = x.to(torch.bfloat16)
    ref = FORM_PLAIN[fmt](x, qt.q, qt.scale, qt.group, torch.float32)
    got = qmm.quant_matmul_split_plain(x, qt.q, qt.scale, fmt, qt.group, torch.bfloat16)
    torch.testing.assert_close(got.float(), ref, rtol=2e-2, atol=2e-2)
    splits = qmm.plan(M, K, N, fmt).splits
    assert splits > 1
    w_eff = (qmm.dequantize_weight(qt.q, qt.scale, fmt, qt.group, x.dtype) if qt.group
             else qmm.weight_values(qt.q, fmt))
    parts = qmm.split_partials(x, w_eff, fmt)
    for drop in range(splits):
        kept = [parts[i] for i in range(splits) if i != drop]
        miss = sum(kept[1:], kept[0])
        miss = (miss if qt.group else miss * qt.scale[None, :]).to(torch.bfloat16)
        with pytest.raises(AssertionError):
            torch.testing.assert_close(miss.float(), ref, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("fmt,group", [("int4", 128), ("int4", 0), ("fp8", 0), ("fp8", 64)])
@pytest.mark.parametrize("M,K,N", [(16, 11008, 4096), (32, 4096, 32000), (256, 4096, 4096),
                                   (2048, 4096, 22016)])
def test_forms_launch_the_plan_from_shapes(monkeypatch, fmt, group, M, K, N):
    """On "meta" tensors (no data: a host read would raise), as a CUDA
    graph's capture needs: the wrapper passes `plan`'s launch and the
    group."""
    calls = []
    monkeypatch.setattr(build, "launch", lambda name, *args: calls.append((name, args)))
    meta = dict(device="meta")
    w = (torch.empty((K // 2, N), dtype=torch.int8, **meta) if fmt == "int4"
         else torch.empty((K, N), dtype=torch.float8_e4m3fn, **meta))
    scale = torch.empty((K // group, N) if group else (N,), dtype=torch.float32, **meta)
    out = FORM_KERNEL[fmt](torch.empty((M, K), dtype=torch.bfloat16, **meta), w, scale, group,
                           torch.bfloat16)
    (name, args), = calls
    p = qmm.plan(M, K, N, fmt)
    # (x, w, scale, out, M, K, N, group, x dtype, out dtype, form, bn, splits)
    assert name == f"quant_matmul_{fmt}"
    assert args[4:] == (M, K, N, group, 1, 1, qmm.FORM_CODES[p.form], p.bn, p.splits)
    assert out.shape == (M, N) and out.dtype == torch.bfloat16


@pytest.mark.parametrize("fmt", ["int4", "fp8"])
def test_forms_refuse_what_the_kernel_does_not_take(fmt):
    meta = dict(device="meta")
    x = torch.empty((16, 96), dtype=torch.bfloat16, **meta)
    w = (torch.empty((48, 64), dtype=torch.int8, **meta) if fmt == "int4"
         else torch.empty((96, 64), dtype=torch.float8_e4m3fn, **meta))
    with pytest.raises(ValueError, match="group 24"):          # not a 16-multiple
        FORM_KERNEL[fmt](x, w, torch.empty((4, 64), dtype=torch.float32, **meta), 24)
    with pytest.raises(ValueError, match="scale"):
        FORM_KERNEL[fmt](x, w, torch.empty((2, 64), dtype=torch.float32, **meta), 32)
    assert not qmm.group_ok(48) and qmm.group_ok(192) and qmm.group_ok(16)


@pytest.mark.parametrize("fmt", ["int4", "fp8"])
def test_misaligned_views_take_the_wide_form(monkeypatch, fmt):
    """TMA reads 16-byte aligned bases: an x that starts one element into
    its storage (a view) takes the cp.async wide form at the tma form's
    shape, with its own split count; aligned operands take the tma form."""
    calls = []
    monkeypatch.setattr(build, "launch", lambda name, *args: calls.append(args))
    meta = dict(device="meta")
    M, K, N = 256, 4096, 4096
    w = (torch.empty((K // 2, N), dtype=torch.int8, **meta) if fmt == "int4"
         else torch.empty((K, N), dtype=torch.float8_e4m3fn, **meta))
    scale = torch.empty((N,), dtype=torch.float32, **meta)
    x = torch.empty((M * K + 1,), dtype=torch.bfloat16, **meta)
    FORM_KERNEL[fmt](x[:M * K].view(M, K), w, scale)
    FORM_KERNEL[fmt](x[1:].view(M, K), w, scale)
    wide = qmm.plan(M, K, N, "int8")
    assert calls[0][10:] == (qmm.FORM_CODES["tma"], qmm.TMA_COLS, qmm.plan(M, K, N, fmt).splits)
    assert calls[1][10:] == (qmm.FORM_CODES["wide"], 128, wide.splits)


@pytest.mark.parametrize("M,K,N,group", [(16, 1000, 72, 0), (1, 4096, 256, 128),
                                         (40, 11008, 128, 64), (16, 2048, 256, 32)])
def test_int4_split_partials_follow_its_128_deep_tile(M, K, N, group):
    """int4's skinny slices are cut in 128-deep K tiles: every slice but the
    last starts and ends on a multiple of 128, the slices cover K once, and
    their partials sum to the whole product."""
    x, qt = _form_case("int4", M, K, N, group, seed=3)
    p = qmm.plan(M, K, N, "int4")
    assert p.bk == 128
    tiles = -(-K // 128)
    bounds = [qmm.split_tiles(tiles, p.splits, i) for i in range(p.splits)]
    assert bounds[0][0] == 0 and bounds[-1][1] == tiles
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    w_eff = qmm.weight_values(qt.q, "int4")
    parts = qmm.split_partials(x, w_eff, "int4")
    assert parts.shape == (p.splits, M, N)
    for (lo, hi), part in zip(bounds, parts):
        k0, k1 = lo * 128, min(K, hi * 128)
        torch.testing.assert_close(part, x[:, k0:k1] @ w_eff[k0:k1], rtol=0, atol=1e-4)
    torch.testing.assert_close(parts.sum(0), x @ w_eff, rtol=0, atol=1e-3)

