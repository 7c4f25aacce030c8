"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA card with nvcc (the `cuda` marker) and skips
elsewhere. The file imports nothing of JAX, so it also runs where JAX is not
installed (`python -m pytest --noconftest tests/test_torch_kernels_cuda.py`).
Inputs are made from a seed with numpy. Tolerances: f32 1e-4 (summation
order); bf16 outputs 2e-2 (bf16 rounding of the output and, in the plain
attention, of the dequantized K/V; in K5, of the probabilities fed to the
tensor cores); the int8 KV write within one step (the plain version's
division may round through a reciprocal). K2's tensor-core form (bf16 q
over int8 and bf16 caches) runs at qwen2-vl-2b-lm's GQA 6:1 x d128 and at
d64 and d80, with chunks longer than its 64-row q tile, continuations that
start off a tile boundary, a 75-page table and NaN in every page and slot it
must not read. K5 runs in its ViT form (T not a multiple of its q tile,
segments spanning several tiles, tiles of padding only), its causal form and
with V a strided view of a fused qkv, at D 32, 64, 80 and 128, in bf16 and
f32, and at the LLaVA encode's shape (577-row segments, 16 heads x d64). The bf16 forms of K2 and K5 are held against the plain version run in
f32 on the same bf16 inputs within 2e-2 x max|plain|, a bound that a
reference missing one kv tile breaks (test_torch_kernel_bounds.py). K6
runs decode and mixed batches over a single-plane latent cache at mla-2b-lm's
D576 and softmax scale 1/sqrt(192), with 16 and 8 heads (bf16 q, int8 and
bf16 planes), and at small f32 D (24, 48), with a 75-page table, padded rows
and sequences, and NaN in every page and slot it must not read; its bf16 form
is held against the plain version run in f32 on the same bf16 inputs, within
2e-2 x max|plain| (bf16 P and output rounding), a bound that a reference
missing one 64-row kv tile breaks. K3's
single-plane form writes latent rows with the int8 quantize rounding half to
even and drops negative slots. K3 is held bit for bit to the host's quantize
clip(rint(x_f32 / f32(scale)), -127, 127) (or cast), with a sentinel left
in every slot it must not write: its paired form at 32 and 2 kv heads x
d128 with v a strided view of a fused qkv, its single-plane form at 576, at
T = 8 and 452 with padded rows; at every vector width its plan can pick (16
down to 2 bytes or one element: D 20, views 1, 2 or 4 elements off, bf16
and f32 in, int8, bf16 and f32 caches); and two replays of a CUDA graph
that captured it leave identical pages. K4 runs at every int8 projection and lm_head
of the three serving paths over M 1-2048 (both its skinny and its wide
form, and their boundary at 64/65), at ragged N (200, 72) and K (5472, 200,
104), with bf16 out held within 2e-2 and f32 logits within 1e-4 of the f32
plain version (a result missing one K slice breaks the bf16 bound:
test_torch_quant_matmul.py); two calls agree bit for bit, and so do two
replays of a CUDA graph that captured it. K4's int4 and fp8 forms (weights
from the port's own quantize_int4 / quantize_fp8, group 0, 32, 64 and 128)
are held to their plain versions (JAX's arithmetic: with a group the weight
is rounded to x's dtype before the product) at M 1, 16, 64, 65, 128, 256
and 512 (the skinny form, and above 64 the tma form or, at N 201, where no
row is 16-byte aligned, the cp.async wide form), K 384 and 320 (whole and
ragged against int4's 128-deep skinny tile; groups of 32 and 64 several to
a tile), N 201 and 256, bf16 and f32 x, within the int8 form's bounds, at
the llava-7b-lm projections (M 16, 256, 512), bit for bit across two calls
and two graph replays, and across replays of a graph that captured the tma
form over rotating weight copies, each launch giving its own weight's
result; their shared-memory plans equal the kernels'; their e4m3 bit
placement equals the cvt conversion bit for bit over all 256 codes; and a
ragged last K tile gives the same result after every SM's shared memory was
filled with NaN bytes (the group-scale rows it reaches past the last group
are written as zeros). The block migration between two
caches on the card (gather_blocks, then scatter_blocks) moves int8 and bf16
KV, MLA plane and image blocks bit for bit and touches no other block. K5
also runs at SigLIP's 16 heads of 72 padded to 80 (DeepSeek-VL2), its
padding columns exactly 0. The MoE grouped product (torch._grouped_mm, a
library call) is held to the dense plain version in bf16 within 2e-2, and a
MoE layer captured in a CUDA graph replays its eager result bit for bit.
K1 and K2's tensor-core forms also run at GPT-2 XL's 25 heads x d64 over a
bf16 cache and at Mixtral-8x7B's GQA 4:1 x d128 over an int8 cache, and K3
writes GPT-2 XL's bf16 rows into a bf16 cache bit for bit. The logits
interface (forward_with_logits over the quality scripts' all-position
batch) on tiny-lm and mla-tiny-lm at int8, int4 and fp8 weights over the
int8 KV cache, bf16 and f32, agrees with the plain versions (1e-2 x
max|logit| in f32: an int8 KV entry may round one step apart; 3e-2 in bf16),
and K4 runs the lm_head at every position of a 512-token sequence (M 512, N
32064, f32 out) in its three forms within 1e-4. A pipeline-parallel
microbatched decode step (tiny-lm over two stages on the card) replays from
its CUDA graph bit for bit as it runs eagerly, and a node refuses decode
graphs over stages on two cards.
"""
import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)
import numpy as np
import pytest
import torch

from hydrainfer_tpu_torch.models.random_init import ARCH_CONFIGS, int8_matmul_shapes
from hydrainfer_tpu_torch.ops.cuda import (mha_decode_attention, mha_varlen_flash,
                                           paged_attention_latent,
                                           paged_attention_varlen,
                                           quant_matmul_int8, write_kv_pages)
from hydrainfer_tpu_torch.ops.cuda import kv_writer
from hydrainfer_tpu_torch.ops.cuda.kv_writer import write_kv_pages_plain
from hydrainfer_tpu_torch.ops.cuda.mha_decode import mha_decode_attention_plain
from hydrainfer_tpu_torch.ops.cuda.mha_varlen import mha_varlen_plain
from hydrainfer_tpu_torch.ops.cuda.paged_attention import \
    paged_attention_varlen_plain
from hydrainfer_tpu_torch.ops.cuda.quant_matmul import (FORM_CODES, plan,
                                                        quant_matmul_fp8,
                                                        quant_matmul_fp8_plain,
                                                        quant_matmul_int4,
                                                        quant_matmul_int4_plain,
                                                        quant_matmul_int8_plain)
from hydrainfer_tpu_torch.ops.quant import quantize_fp8, quantize_int4

pytestmark = pytest.mark.cuda
SCALE = 0.05


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def paged_case(seq_specs, H, KVH, D, bs, dtype, seed=0):
    """Pages holding each sequence's kv_len tokens in shuffled blocks, the
    flattened queries of seq_specs = [(q_len, kv_len), ...] and geometry."""
    rng = np.random.default_rng(seed)
    S = len(seq_specs)
    mb = max(-(-kv // bs) for _, kv in seq_specs)
    nb = S * mb + 1
    perm = rng.permutation(np.arange(1, nb))
    tables = np.full((S, mb), -1, np.int32)
    for s, (_, kv) in enumerate(seq_specs):
        n = -(-kv // bs)
        tables[s, :n] = perm[s * mb: s * mb + n]
    vals = rng.standard_normal((nb, bs, 2 * KVH, D)).astype(np.float32)
    if dtype == torch.int8:
        pages = torch.from_numpy(np.clip(np.round(vals / SCALE), -127, 127)
                                 .astype(np.int8))
    else:
        pages = torch.from_numpy(vals).to(dtype)
    T = sum(q for q, _ in seq_specs)
    q = torch.from_numpy(rng.standard_normal((T + 3, H, D)).astype(np.float32))
    cu = np.concatenate([[0], np.cumsum([q_ for q_, _ in seq_specs])]).astype(np.int32)
    i32 = lambda a: torch.from_numpy(np.asarray(a, np.int32))
    return (q, pages, i32([kv for _, kv in seq_specs]),
            torch.from_numpy(np.maximum(tables, 0)), i32(cu), i32([S]))


ATTN = [
    ("mha_int8_bf16q", 8, 8, 128, 16, torch.int8, torch.bfloat16),
    ("gqa4_f32", 8, 2, 32, 4, torch.float32, torch.float32),
    ("gqa2_bf16kv", 4, 2, 64, 16, torch.bfloat16, torch.bfloat16),
]


@pytest.mark.parametrize("name,H,KVH,D,bs,kv_dtype,q_dtype", ATTN,
                         ids=[a[0] for a in ATTN])
def test_k1_decode(dev, name, H, KVH, D, bs, kv_dtype, q_dtype):
    specs = [(1, 300), (1, 1), (1, 17), (1, 64)]       # 75-page table
    q, pages, kv_lens, tables, _, ns = paged_case(specs, H, KVH, D, bs, kv_dtype)
    scale = SCALE if kv_dtype == torch.int8 else None
    args = [q.to(dev, q_dtype), pages.to(dev), kv_lens.to(dev), tables.to(dev),
            ns.to(dev)]
    got = mha_decode_attention(*args, D ** -0.5, scale)
    ref = mha_decode_attention_plain(*args, D ** -0.5, scale)
    torch.cuda.synchronize()
    tol = 1e-4 if q_dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), ref.float(), rtol=tol, atol=tol)
    assert bool((got[len(specs):] == 0).all())


# the tensor-core form: qwen2-vl-2b-lm's GQA 6:1 (6 splits at these 13
# rows), llava-7b-lm's MHA (one split, no merge), GQA 8:1 (11 splits), D 256
# at BS 4 (split boundaries mid-page) and D 32
K1_MMA = [
    ("vlm_gqa6_int8", 12, 2, 128, 16, torch.int8),
    ("mha32_int8", 32, 32, 128, 16, torch.int8),
    ("gqa8_bf16_d64", 8, 1, 64, 16, torch.bfloat16),
    ("gqa4_int8_d256_bs4", 4, 1, 256, 4, torch.int8),
    ("mha2_bf16_d32", 2, 2, 32, 16, torch.bfloat16),
    ("gpt2_xl_mha25_bf16_d64", 25, 25, 64, 16, torch.bfloat16),   # GPT-2 XL's heads
    ("mixtral_gqa4_int8", 32, 8, 128, 16, torch.int8),           # Mixtral-8x7B's
]
# kv lengths on both sides of the 16-row sub-tiles, the 64 rows of a block's
# first pass and the split boundaries, and a table over 128 pages
K1_SPECS = [(1, kv) for kv in (0, 1, 15, 16, 17, 63, 64, 65, 464, 2070)]


@pytest.mark.parametrize("name,H,KVH,D,bs,kv_dtype", K1_MMA, ids=[a[0] for a in K1_MMA])
def test_k1_tensor_cores(dev, name, H, KVH, D, bs, kv_dtype):
    """The bf16-q form over combined-head pages holding NaN (-128 for int8)
    in every page and slot it must not read, NaN query padding rows, a
    padded sequence; held within 2e-2 x max|plain| against the plain version
    in f32 on the same bf16 inputs, padding rows zero."""
    q, pages, clean, kv_lens, tables, _, ns = poisoned_case(
        K1_SPECS, H, D, bs, kv_dtype, seed=13, planes=2 * KVH, nan_q=True)
    scale = SCALE if kv_dtype == torch.int8 else None
    geo = [kv_lens.to(dev), tables.to(dev), ns.to(dev)]
    qd = q.to(dev, torch.bfloat16)
    got = mha_decode_attention(qd, pages.to(dev), *geo, D ** -0.5, scale)
    ref_pages = clean.to(dev) if kv_dtype == torch.int8 else clean.to(dev).float()
    ref = mha_decode_attention_plain(torch.nan_to_num(qd.float()), ref_pages, *geo,
                                     D ** -0.5, scale)
    torch.cuda.synchronize()
    hold_bf16(got, ref, len(K1_SPECS))


def test_k1_counts_its_launches(dev):
    """One count per wrapper call, with and without the merge launch."""
    for H, KVH in ((12, 2), (32, 32)):
        q, pages, _, kv_lens, tables, _, ns = poisoned_case([(1, 40), (1, 9)], H, 128, 16,
                                                            torch.int8, planes=2 * KVH)
        mha_decode_attention.launches = 0
        mha_decode_attention(q.to(dev, torch.bfloat16), pages.to(dev), kv_lens.to(dev),
                             tables.to(dev), ns.to(dev), 0.09, SCALE)
        torch.cuda.synchronize()
        assert mha_decode_attention.launches == 1


@pytest.mark.parametrize("name,H,KVH,D,bs,kv_dtype,q_dtype", ATTN,
                         ids=[a[0] for a in ATTN])
def test_k2_mixed(dev, name, H, KVH, D, bs, kv_dtype, q_dtype):
    specs = [(40, 40), (1, 300), (7, 23), (1, 9), (20, 120)]
    q, pages, kv_lens, tables, cu, ns = paged_case(specs, H, KVH, D, bs, kv_dtype,
                                                   seed=1)
    scale = SCALE if kv_dtype == torch.int8 else None
    args = [q.to(dev, q_dtype), pages.to(dev), kv_lens.to(dev), tables.to(dev),
            cu.to(dev), ns.to(dev)]
    got = paged_attention_varlen(*args, D ** -0.5, scale)
    ref = paged_attention_varlen_plain(*args, D ** -0.5, scale)
    torch.cuda.synchronize()
    tol = 1e-4 if q_dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), ref.float(), rtol=tol, atol=tol)
    assert bool((got[int(cu[-1]):] == 0).all())


def hold_bf16(got, ref, n):
    """A bf16 kernel output against the plain version run in f32 on the same
    bf16 inputs: rows below n within 2e-2 x max|plain| (bf16 P and output
    rounding), finite everywhere, rows from n on exactly zero."""
    bound = 2e-2 * ref[:n].abs().max().item()
    assert bool(torch.isfinite(got.float()).all())
    assert (got[:n].float() - ref[:n]).abs().max().item() <= bound
    assert bool((got[n:] == 0).all())


K2_MMA = [
    ("vlm_gqa6_int8", 12, 2, 128, 16, torch.int8),     # qwen2-vl-2b-lm's heads
    ("mha_int8_bs4", 8, 8, 128, 4, torch.int8),        # a 75-page table
    ("gqa2_bf16_d64", 4, 2, 64, 16, torch.bfloat16),
    ("gqa6_bf16_d80", 6, 1, 80, 16, torch.bfloat16),
    ("gpt2_xl_mha25_bf16_d64", 25, 25, 64, 16, torch.bfloat16),
    ("mixtral_gqa4_int8", 32, 8, 128, 16, torch.int8),
]
# chunks longer than one q tile (130 tokens), continuations starting off a
# tile boundary (64 over 192, 37 over 101), decodes, a short prefill
K2_SPECS = [(130, 130), (64, 192), (37, 101), (1, 300), (1, 9), (7, 23), (3, 3)]


@pytest.mark.parametrize("name,H,KVH,D,bs,kv_dtype", K2_MMA, ids=[a[0] for a in K2_MMA])
def test_k2_tensor_cores(dev, name, H, KVH, D, bs, kv_dtype):
    """The bf16-q form over combined-head pages holding NaN (-128 for int8)
    in every page and slot it must not read, NaN query padding rows and a
    padded sequence."""
    q, pages, clean, kv_lens, tables, cu, ns = poisoned_case(
        K2_SPECS, H, D, bs, kv_dtype, seed=9, planes=2 * KVH, nan_q=True)
    scale = SCALE if kv_dtype == torch.int8 else None
    geo = [kv_lens.to(dev), tables.to(dev), cu.to(dev), ns.to(dev)]
    qd = q.to(dev, torch.bfloat16)
    got = paged_attention_varlen(qd, pages.to(dev), *geo, D ** -0.5, scale)
    ref_pages = clean.to(dev) if kv_dtype == torch.int8 else clean.to(dev).float()
    ref = paged_attention_varlen_plain(qd.float(), ref_pages, *geo, D ** -0.5, scale)
    torch.cuda.synchronize()
    hold_bf16(got, ref, int(cu[-1]))


def test_k2_counts_its_launches(dev):
    q, pages, _, kv_lens, tables, cu, ns = poisoned_case([(70, 90), (1, 20)], 12, 128, 16,
                                                         torch.int8, planes=4)
    paged_attention_varlen.launches = 0
    paged_attention_varlen(q.to(dev, torch.bfloat16), pages.to(dev), kv_lens.to(dev),
                           tables.to(dev), cu.to(dev), ns.to(dev), 0.09, SCALE)
    torch.cuda.synchronize()
    assert paged_attention_varlen.launches == 1


@pytest.mark.parametrize("cache_dtype,in_dtype", [
    (torch.int8, torch.bfloat16), (torch.float32, torch.float32),
    (torch.bfloat16, torch.bfloat16)])
def test_k3_write(dev, cache_dtype, in_dtype):
    rng = np.random.default_rng(2)
    T, kvh, D, bs, nb = 37, 4, 64, 16, 12
    slots = rng.permutation(nb * bs)[:T].astype(np.int32)
    slots[[3, 20]] = -1                                   # dropped rows
    qkv = torch.from_numpy(rng.standard_normal((T, 3 * kvh * D)).astype(np.float32))
    qkv = qkv.to(dev, in_dtype)
    k = qkv[:, kvh * D: 2 * kvh * D].reshape(T, kvh, D)  # strided rows
    v = qkv[:, 2 * kvh * D:].reshape(T, kvh, D)
    scale = SCALE if cache_dtype == torch.int8 else None
    got = torch.zeros((nb, bs, 2 * kvh, D), dtype=cache_dtype, device=dev)
    ref = torch.zeros_like(got)
    s = torch.from_numpy(slots).to(dev)
    write_kv_pages(got, k, v, s, scale)
    write_kv_pages_plain(ref, k, v, s, scale)
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= (1.0 if cache_dtype == torch.int8 else 0.0)


def _k4_case(M, K, N, seed=3):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
    w = torch.from_numpy(rng.integers(-127, 128, (K, N), dtype=np.int8))
    scale = torch.from_numpy((rng.random(N) + 0.5).astype(np.float32) / (127 * K ** 0.5))
    return x, w, scale


@pytest.mark.parametrize("M,K,N", [(1, 256, 200), (17, 512, 384), (130, 384, 72),
                                   (16, 5472, 2048), (65, 5472, 72), (9, 200, 200),
                                   (100, 104, 136)])
@pytest.mark.parametrize("x_dtype,out_dtype", [
    (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
    (torch.float32, torch.float32)])
def test_k4_gemm(dev, M, K, N, x_dtype, out_dtype):
    """Small and ragged shapes: N = 200 and 72 (no multiple of 16: masked
    scalar loads at the edge), K = 5472 (no multiple of 64), K = 200 and 104
    (no multiple of 16), M on both sides of the skinny/wide boundary."""
    x, w, scale = _k4_case(M, K, N)
    x, w, scale = x.to(dev, x_dtype), w.to(dev), scale.to(dev)
    got = quant_matmul_int8(x, w, scale, out_dtype)
    ref = quant_matmul_int8_plain(x, w, scale, out_dtype)
    torch.cuda.synchronize()
    tol = 1e-4 if out_dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), ref.float(), rtol=tol, atol=tol)


# every int8 projection of the three serving paths (K, N), and the lm_heads
# (f32 logits): llava-7b-lm (serve), qwen2-vl-2b-lm (vlm), mla-2b-lm (mla)
_K4_SHAPES = {f"{path}_{name}": kn
              for path, arch in (("serve", "llava-7b-lm"), ("vlm", "qwen2-vl-2b-lm"),
                                 ("mla", "mla-2b-lm"))
              for name, kn in int8_matmul_shapes(ARCH_CONFIGS[arch]).items()}
K4_PROJECTIONS = {k: v for k, v in _K4_SHAPES.items() if not k.endswith("lm_head")}
K4_LM_HEADS = {k: v for k, v in _K4_SHAPES.items() if k.endswith("lm_head")}
K4_M = [1, 8, 16, 17, 32, 64, 65, 256, 2048]


def _check_k4_bf16(dev, M, K, N, out_dtype):
    """bf16 x through K4 against the plain version in f32 on the same inputs:
    2e-2 (bf16 out) or 1e-4 (f32 out), relative and absolute."""
    x, w, scale = _k4_case(M, K, N, seed=M + K + N)
    x, w, scale = x.to(dev, torch.bfloat16), w.to(dev), scale.to(dev)
    got = quant_matmul_int8(x, w, scale, out_dtype)
    ref = quant_matmul_int8_plain(x, w, scale, torch.float32)
    torch.cuda.synchronize()
    assert got.dtype == out_dtype and got.shape == (M, N)
    tol = 1e-4 if out_dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("M", K4_M)
@pytest.mark.parametrize("proj", list(K4_PROJECTIONS))
def test_k4_path_shapes(dev, proj, M):
    _check_k4_bf16(dev, M, *K4_PROJECTIONS[proj], torch.bfloat16)


@pytest.mark.parametrize("M", [1, 16, 32, 64, 65])
@pytest.mark.parametrize("head", list(K4_LM_HEADS))
def test_k4_lm_heads(dev, head, M):
    _check_k4_bf16(dev, M, *K4_LM_HEADS[head], torch.float32)


# a skinny split (serve's down at M = 16: 5 slices), a wide split (serve's o
# at M = 256: 3 slices), one unsplit wide tile grid
@pytest.mark.parametrize("M,K,N", [(16, 11008, 4096), (256, 4096, 4096), (2048, 1536, 2048)])
def test_k4_is_deterministic(dev, M, K, N):
    x, w, scale = _k4_case(M, K, N, seed=7)
    x, w, scale = x.to(dev, torch.bfloat16), w.to(dev), scale.to(dev)
    a = quant_matmul_int8(x, w, scale)
    b = quant_matmul_int8(x, w, scale)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.parametrize("M,K,N,out_dtype", [(16, 11008, 4096, torch.bfloat16),
                                             (32, 2048, 32064, torch.float32),
                                             (256, 4096, 4096, torch.bfloat16)])
def test_k4_graph_replay(dev, M, K, N, out_dtype):
    """K4 captured in a CUDA graph and replayed twice gives the eager result
    bit for bit (the split merge leaves no state behind)."""
    x, w, scale = _k4_case(M, K, N, seed=8)
    x, w, scale = x.to(dev, torch.bfloat16), w.to(dev), scale.to(dev)
    eager = quant_matmul_int8(x, w, scale, out_dtype)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        quant_matmul_int8(x, w, scale, out_dtype)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = quant_matmul_int8(x, w, scale, out_dtype)
    for _ in range(2):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)


@pytest.mark.parametrize("M", [1, 8, 16, 17, 32, 64, 65, 256, 2048])
def test_k4_plan_states_the_kernels_shared_memory(dev, M):
    """Plan.smem_bytes (which the CPU tests hold within 227 KB) is the
    dynamic shared memory the kernel asks for, at every plan of the path
    shapes and at every strip width of the form."""
    import ctypes
    from hydrainfer_tpu_torch.ops.cuda import build
    build.build_all(["quant_matmul"])
    smem = ctypes.CDLL(str(build.library_path("quant_matmul"))).hydra_quant_matmul_smem
    smem.argtypes, smem.restype = [ctypes.c_int] * 3, ctypes.c_int
    plans = {plan(M, K, N) for K, N in _K4_SHAPES.values()}
    form = plan(M, 4096, 4096).form
    plans |= {p._replace(bn=bn) for p in plans for bn in
              ((64, 128, 256) if form == "skinny" else (128,))}
    for p in plans:
        assert smem(FORM_CODES[p.form], p.bn, M) == p.smem_bytes(M), p


def test_k4_counts_its_launches(dev):
    x, w, scale = _k4_case(16, 512, 256)
    x, w, scale = x.to(dev, torch.bfloat16), w.to(dev), scale.to(dev)
    before = quant_matmul_int8.launches
    quant_matmul_int8(x, w, scale)
    assert quant_matmul_int8.launches == before + 1


K4_FORMS = {"int4": (quantize_int4, quant_matmul_int4, quant_matmul_int4_plain),
            "fp8": (quantize_fp8, quant_matmul_fp8, quant_matmul_fp8_plain)}


def _k4_form_case(fmt, group, M, K, N, seed=11):
    """x (M, K) f32 and a weight of K x N values ~N(0, 1/K) quantized by the
    port's own quantize function at `group` (0: per column)."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((K, N)) / K ** 0.5).astype(np.float32))
    qt = K4_FORMS[fmt][0](w, group=group)
    assert qt.group == group
    return x, qt


def _check_k4_form(dev, fmt, group, M, K, N, x_dtype, out_dtype, seed=11):
    _, kernel, plain = K4_FORMS[fmt]
    x, qt = _k4_form_case(fmt, group, M, K, N, seed)
    x, w, scale = x.to(dev, x_dtype), qt.q.to(dev), qt.scale.to(dev)
    got = kernel(x, w, scale, qt.group, out_dtype)
    ref = plain(x, w, scale, qt.group, torch.float32)
    torch.cuda.synchronize()
    assert got.dtype == out_dtype and got.shape == (M, N)
    tol = 1e-4 if out_dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("x_dtype,out_dtype", [
    (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
    (torch.float32, torch.float32)], ids=["bf16", "bf16_f32out", "f32"])
@pytest.mark.parametrize("N", [201, 256])
@pytest.mark.parametrize("M", [1, 16, 64, 65, 128, 256, 512])
@pytest.mark.parametrize("K,group", [(384, 0), (384, 32), (384, 64), (384, 128), (320, 0),
                                     (320, 32), (320, 64)])
@pytest.mark.parametrize("fmt", list(K4_FORMS))
def test_k4_int4_fp8_forms(dev, fmt, K, group, M, N, x_dtype, out_dtype):
    """K = 384 (six 64-deep K tiles, three of int4's 128-deep skinny ones;
    12, 6 or 3 groups) and 320 (2.5 of int4's tiles: a ragged last tile;
    groups of 32 and 64 several to a tile), N = 201 (odd: no weight or scale
    row 16-byte aligned, masked loads at every row; above M 64 the cp.async
    wide form) and 256 (above M 64 the tma form)."""
    _check_k4_form(dev, fmt, group, M, K, N, x_dtype, out_dtype)


# llava-7b-lm's projections: the int4 and fp8 forms serve them in the quant phase
_LLAVA_K4 = {k: v for k, v in int8_matmul_shapes(ARCH_CONFIGS["llava-7b-lm"]).items()}


@pytest.mark.parametrize("M", [16, 256, 512])
@pytest.mark.parametrize("proj", list(_LLAVA_K4))
@pytest.mark.parametrize("fmt,group", [("int4", 128), ("fp8", 0), ("fp8", 128)])
def test_k4_forms_at_llava_shapes(dev, fmt, group, proj, M):
    K, N = _LLAVA_K4[proj]
    out_dtype = torch.float32 if proj == "lm_head" else torch.bfloat16
    _check_k4_form(dev, fmt, group, M, K, N, torch.bfloat16, out_dtype, seed=M + K + N)


@pytest.mark.parametrize("fmt,group", [("int4", 128), ("int4", 0), ("fp8", 0), ("fp8", 64)])
def test_k4_forms_deterministic_and_graph_replay(dev, fmt, group):
    """serve's down at M = 16 (a skinny split) and o at M = 256 (a wide
    split): two calls agree bit for bit, and two replays of a CUDA graph
    that captured the call give the eager result."""
    _, kernel, _ = K4_FORMS[fmt]
    for M, K, N in ((16, 11008, 4096), (256, 4096, 4096)):
        x, qt = _k4_form_case(fmt, group, M, K, N, seed=8)
        x, w, scale = x.to(dev, torch.bfloat16), qt.q.to(dev), qt.scale.to(dev)
        eager = kernel(x, w, scale, qt.group)
        assert torch.equal(eager, kernel(x, w, scale, qt.group))
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            kernel(x, w, scale, qt.group)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = kernel(x, w, scale, qt.group)
        for _ in range(2):
            out.zero_()
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(out, eager)


@pytest.mark.parametrize("M", [1, 8, 16, 17, 32, 64, 65, 256, 2048])
@pytest.mark.parametrize("fmt", list(K4_FORMS))
def test_k4_forms_plan_states_the_kernels_shared_memory(dev, fmt, M):
    """The format's plan (int4's 128-deep skinny tile; the tma form above M
    64 and, for shapes TMA cannot address, the wide form) at every strip
    width of its form, with and without group scales."""
    import ctypes
    from hydrainfer_tpu_torch.ops.cuda import build
    name = f"quant_matmul_{fmt}"
    build.build_all([name])
    smem = getattr(ctypes.CDLL(str(build.library_path(name))), f"hydra_{name}_smem")
    smem.argtypes, smem.restype = [ctypes.c_int] * 4, ctypes.c_int
    plans = [plan(M, 4096, 4096, fmt)] + ([plan(M, 4100, 4096, fmt)] if M > 64 else [])
    for q in plans:
        for bn in {"skinny": (64, 128, 256), "wide": (128,), "tma": (128,)}[q.form]:
            p = q._replace(bn=bn)
            for grouped in (False, True):
                assert smem(FORM_CODES[p.form], bn, M, int(grouped)) == \
                    p.smem_bytes(M, fmt, grouped), (p, grouped)


@pytest.mark.parametrize("fmt,group", [("int4", 128), ("int4", 0), ("fp8", 0), ("fp8", 64)])
def test_k4_tma_graph_replays_follow_rotating_weights(dev, fmt, group):
    """One CUDA graph captures the tma form (M 256, K 4096, N 4096: 4
    slices) over three weight copies of different values, each with its own
    x, as a benchmark over rotating copies does: each launch's TMA
    descriptors are made for its own operands, so every replay gives each
    output the eager result of its own weight, bit for bit."""
    _, kernel, _ = K4_FORMS[fmt]
    M, K, N = 256, 4096, 4096
    assert plan(M, K, N, fmt).form == "tma"
    cases = []
    for seed in (31, 32, 33):
        x, qt = _k4_form_case(fmt, group, M, K, N, seed=seed)
        cases.append((x.to(dev, torch.bfloat16), qt.q.to(dev), qt.scale.to(dev), qt.group))
    eager = [kernel(*c) for c in cases]
    assert not torch.equal(eager[0], eager[1])
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for c in cases:
            kernel(*c)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [kernel(*c) for c in cases]
    for _ in range(2):
        for o in outs:
            o.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(o, e) for o, e in zip(outs, eager))


# Two test-only kernels beside K4's templates: built here from this source
# (the libraries' nvcc flags, csrc/ on the include path) into the build
# directory, never part of the port's libraries.
_K4_PROBES = r"""
#include "quant_matmul.cuh"

// Every word of each block's dynamic shared memory set to `word` (volatile:
// the stores stay, though nothing reads them).
__global__ void fill_smem_kernel(int words, uint32_t word) {
  extern __shared__ uint32_t buf[];
  volatile uint32_t* v = buf;
  for (int i = threadIdx.x; i < words; i += blockDim.x) v[i] = word;
}

extern "C" int hydra_fill_smem(int bytes, unsigned word, int blocks, void* stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      fill_smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  fill_smem_kernel<<<blocks, 1024, bytes, static_cast<cudaStream_t>(stream)>>>(bytes / 4, word);
  return launch_status();
}

// Code c in the first half of a pair and 255 - c in the second: placed[c]
// is the tma form's conversion (e4m3_place_bf16x2), cvt[c] the skinny and
// wide forms' (e4m3pair_to_bf16x2: __nv_cvt_fp8x2_to_halfraw2, then f16 ->
// f32 -> bf16).
__global__ void fp8_conversions_kernel(uint32_t* placed, uint32_t* cvt) {
  const uint32_t c = threadIdx.x;
  placed[c] = e4m3_place_bf16x2(c | ((255u - c) << 16), 0xA280u);
  cvt[c] = e4m3pair_to_bf16x2(c | ((255u - c) << 8));
}

extern "C" int hydra_fp8_conversions(void* placed, void* cvt, void* stream) {
  fp8_conversions_kernel<<<1, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(placed), static_cast<uint32_t*>(cvt));
  return launch_status();
}
"""
_k4_probe_lib = []


def _k4_probes():
    """The probe library (ctypes), built on first use; a failed build fails
    the test with nvcc's output."""
    import ctypes
    import hashlib
    import os
    import subprocess
    from hydrainfer_tpu_torch.ops.cuda import build
    if _k4_probe_lib:
        return _k4_probe_lib[0]
    h = hashlib.sha256(_K4_PROBES.encode() + " ".join(build.NVCC_FLAGS).encode())
    for header in sorted(build.CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    out = build.BUILD_DIR / f"k4_probes-{h.hexdigest()[:16]}.so"
    if not out.exists():
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        src = out.with_suffix(f".{os.getpid()}.cu")
        src.write_text(_K4_PROBES)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        run = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(build.CSRC_DIR),
                              "-o", str(tmp), str(src)], capture_output=True, text=True)
        src.unlink()
        assert run.returncode == 0, run.stdout + run.stderr
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    lib.hydra_fill_smem.argtypes = [ctypes.c_int, ctypes.c_uint, ctypes.c_int, ctypes.c_void_p]
    lib.hydra_fp8_conversions.argtypes = [ctypes.c_void_p] * 3
    lib.hydra_fill_smem.restype = lib.hydra_fp8_conversions.restype = ctypes.c_int
    _k4_probe_lib.append(lib)
    return lib


def test_k4_fp8_bit_placement_matches_cvt(dev):
    """The tma form's e4m3 conversion (sign, exponent and mantissa placed in
    bf16's bit positions, times 2^120 in bf16; NaN codes to bf16's NaN)
    against the skinny and wide forms' (__nv_cvt_fp8x2_to_halfraw2, then f16
    -> f32 -> bf16) over all 256 codes, each code in both halves of a pair,
    bit for bit; and the finite codes against torch's own float8_e4m3fn ->
    bfloat16 cast."""
    lib = _k4_probes()
    placed = torch.zeros(256, dtype=torch.int32, device=dev)
    cvt = torch.zeros(256, dtype=torch.int32, device=dev)
    assert lib.hydra_fp8_conversions(placed.data_ptr(), cvt.data_ptr(),
                                     torch.cuda.current_stream().cuda_stream) == 0
    torch.cuda.synchronize()
    assert torch.equal(placed, cvt), [
        (c, hex(a & 0xFFFFFFFF), hex(b & 0xFFFFFFFF))
        for c, (a, b) in enumerate(zip(placed.tolist(), cvt.tolist())) if a != b]
    codes = torch.arange(256, dtype=torch.int32)
    low = (placed.cpu() & 0xFFFF).to(torch.int16).view(torch.bfloat16)
    high = ((placed.cpu() >> 16) & 0xFFFF).to(torch.int16).view(torch.bfloat16)
    ref = codes.to(torch.uint8).view(torch.float8_e4m3fn).to(torch.bfloat16)
    finite = (codes & 0x7F) != 0x7F
    assert torch.equal(low[finite].view(torch.int16), ref[finite].view(torch.int16))
    assert torch.equal(high.flip(0)[finite].view(torch.int16), ref[finite].view(torch.int16))
    assert bool(low[~finite].isnan().all()) and bool(high[~finite.flip(0)].isnan().all())


@pytest.mark.parametrize("M,K,N,group", [
    (16, 320, 256, 32), (16, 320, 256, 64), (16, 160, 256, 32), (128, 160, 201, 32),
    (128, 160, 256, 32)])
@pytest.mark.parametrize("fmt", list(K4_FORMS))
def test_k4_ragged_k_ignores_stale_shared_memory(dev, fmt, M, K, N, group):
    """A ragged last K tile runs all its K steps, past the last group too;
    the group-scale rows it reaches there must be zeros, not what an earlier
    launch left in shared memory. So every SM's shared memory is first
    filled with 0xFF bytes (f32 NaN), then the form runs, twice: the skinny
    form at K 320 (int4's 128-deep tile ends half full: groups of 32 and 64
    past K) and 160 (int4's tile a quarter full, the 8-bit formats' 64-deep
    tile half full),
    the cp.async wide form (N 201) and the tma form (N 256) at K 160 with
    groups of 32. K 160 takes at most three K tiles, so the last one lands in
    a ring slot that no earlier tile of the launch wrote. The f32 result
    holds no NaN and agrees with the plain version within 1e-4."""
    lib = _k4_probes()
    _, kernel, plain = K4_FORMS[fmt]
    x, qt = _k4_form_case(fmt, group, M, K, N)
    x, w, scale = x.to(dev, torch.bfloat16), qt.q.to(dev), qt.scale.to(dev)
    ref = plain(x, w, scale, group, torch.float32)
    props = torch.cuda.get_device_properties(dev)
    smem = getattr(props, "shared_memory_per_block_optin", 227 * 1024)
    stream = torch.cuda.current_stream().cuda_stream
    for _ in range(2):
        assert lib.hydra_fill_smem(smem, 0xFFFFFFFF, 2 * props.multi_processor_count,
                                   stream) == 0
        got = kernel(x, w, scale, group, torch.float32)
        torch.cuda.synchronize()
        assert not bool(got.isnan().any()), int(got.isnan().sum())
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)


def test_k4_forms_count_their_launches(dev):
    for fmt, (_, kernel, _) in K4_FORMS.items():
        x, qt = _k4_form_case(fmt, 128, 16, 512, 256)
        before = kernel.launches
        kernel(x.to(dev, torch.bfloat16), qt.q.to(dev), qt.scale.to(dev), qt.group)
        assert kernel.launches == before + 1


def _check_k5(dev, dtype, q, k, v, ids, kv_ids=None, q_pos=None, kv_pos=None):
    on = lambda t: None if t is None else torch.from_numpy(t).to(dev)
    args = dict(kv_seq_ids=on(kv_ids), q_pos=on(q_pos), kv_pos=on(kv_pos))
    q, k, v = (torch.from_numpy(a).to(dev, dtype) for a in (q, k, v))
    sm = q.shape[-1] ** -0.5
    got = mha_varlen_flash(q, k, v, on(ids), sm, **args)
    ref = mha_varlen_plain(q, k, v, on(ids), sm, **args)[0]
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), ref.float(), rtol=tol, atol=tol)
    assert bool((got[torch.from_numpy(ids < 0).to(dev)] == 0).all())


@pytest.mark.parametrize("segments,pad", [([100, 28, 60], 12), ([70], 130)],
                         ids=["three_images_T200", "padding_tiles"])
@pytest.mark.parametrize("D", [32, 64, 80, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_k5_vit(dev, segments, pad, D, dtype):
    rng = np.random.default_rng(4)
    ids = np.asarray(sum(([i] * n for i, n in enumerate(segments)), []) + [-1] * pad,
                     np.int32)
    q, k, v = (rng.standard_normal((len(ids), 3, D)).astype(np.float32) for _ in range(3))
    _check_k5(dev, dtype, q, k, v, ids)


@pytest.mark.parametrize("D", [32, 64, 80, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_k5_causal(dev, D, dtype):
    """Built as hydrainfer_tpu/ops/attention.py:paged_attention_varlen_prefill
    builds it: gathered kv rows with segment ids (-1 past each kv_len) and
    cache positions; q rows carry their cache position; 5 padded q rows."""
    rng = np.random.default_rng(5)
    specs = [(70, 70), (1, 90), (33, 150), (5, 5)]
    max_kv = max(kv for _, kv in specs)
    kv_pos = np.tile(np.arange(max_kv, dtype=np.int32), len(specs))
    kv_ids = np.repeat(np.arange(len(specs), dtype=np.int32), max_kv)
    kv_ids = np.where(kv_pos < np.repeat([kv for _, kv in specs], max_kv), kv_ids, -1)
    ids = np.concatenate([[s] * ql for s, (ql, _) in enumerate(specs)] + [[-1] * 5])
    q_pos = np.concatenate([np.arange(kv - ql, kv) for ql, kv in specs] + [[0] * 5])
    H = 2
    q = rng.standard_normal((len(ids), H, D)).astype(np.float32)
    k, v = (rng.standard_normal((len(kv_ids), H, D)).astype(np.float32) for _ in range(2))
    _check_k5(dev, dtype, q, k, v, ids.astype(np.int32), kv_ids.astype(np.int32),
              q_pos.astype(np.int32), kv_pos)


def test_k5_strided_v(dev):
    """V as a strided view of a fused qkv projection, as the ViT passes it."""
    rng = np.random.default_rng(6)
    ids = np.asarray([0] * 90 + [1] * 40, np.int32)
    H, D = 4, 80
    qkv = torch.from_numpy(rng.standard_normal((len(ids), 3, H, D)).astype(np.float32))
    qkv = qkv.to(dev, torch.bfloat16)
    q, k, v = qkv[:, 0].contiguous(), qkv[:, 1].contiguous(), qkv[:, 2]
    i = torch.from_numpy(ids).to(dev)
    got = mha_varlen_flash(q, k, v, i, D ** -0.5)
    ref = mha_varlen_plain(q, k, v.contiguous(), i, D ** -0.5)[0]
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), ref.float(), rtol=2e-2, atol=2e-2)


def vit_case(segments, pad, H, D, seed):
    """Fused qkv rows (T, 3, H, D) of `segments` images and `pad` padding
    rows (NaN in q, k and v) and their segment ids."""
    rng = np.random.default_rng(seed)
    ids = np.asarray(sum(([i] * n for i, n in enumerate(segments)), []) + [-1] * pad,
                     np.int32)
    qkv = rng.standard_normal((len(ids), 3, H, D)).astype(np.float32)
    qkv[ids < 0] = np.nan
    return qkv, ids


# segments not aligned to the 128-row q tile, one spanning five and a half
# tiles; the Qwen2-VL tower's 16 heads x d80; a q tile of padding only
K5_MMA = [("long_segments", [700, 130, 60], 20, 2),
          ("qwen2vl_heads", [256, 64, 144], 0, 16),
          ("padding_tile", [70], 130, 2)]


@pytest.mark.parametrize("D", [64, 80, 128])
@pytest.mark.parametrize("name,segments,pad,H", K5_MMA, ids=[a[0] for a in K5_MMA])
def test_k5_tensor_cores(dev, name, segments, pad, H, D):
    """The bf16 form with V a strided view of the fused qkv, as the ViT
    passes it, held against the plain version in f32 on the same bf16
    inputs with the padding rows zeroed."""
    qkv, ids = vit_case(segments, pad, H, D, seed=10)
    x = torch.from_numpy(qkv).to(dev, torch.bfloat16)
    q, k, v = x[:, 0].contiguous(), x[:, 1].contiguous(), x[:, 2]
    i = torch.from_numpy(ids).to(dev)
    got = mha_varlen_flash(q, k, v, i, D ** -0.5)
    clean = torch.nan_to_num(x.float(), nan=0.0)
    ref = mha_varlen_plain(clean[:, 0], clean[:, 1], clean[:, 2], i, D ** -0.5)[0]
    torch.cuda.synchronize()
    n = int((ids >= 0).sum())          # the padding rows come last
    hold_bf16(got, ref, n)


@pytest.mark.parametrize("n_images", [1, 4])
def test_k5_llava_encode_shape(dev, n_images):
    """The CLIP-L/14-336 tower's attention as the LLaVA encode runs it:
    segments of 577 rows (the class token and 24 x 24 patches), 16 heads x
    d64, V a strided view of the fused qkv; no padding rows."""
    qkv, ids = vit_case([577] * n_images, 0, 16, 64, seed=12)
    x = torch.from_numpy(qkv).to(dev, torch.bfloat16)
    q, k, v = x[:, 0].contiguous(), x[:, 1].contiguous(), x[:, 2]
    i = torch.from_numpy(ids).to(dev)
    got = mha_varlen_flash(q, k, v, i, 64 ** -0.5)
    ref = mha_varlen_plain(x[:, 0].float(), x[:, 1].float(), x[:, 2].float(), i,
                           64 ** -0.5)[0]
    torch.cuda.synchronize()
    hold_bf16(got, ref, len(ids))


@pytest.mark.parametrize("D", [80, 128])
def test_k5_tensor_cores_causal(dev, D):
    """The causal form with chunks longer than one q tile, held as above."""
    rng = np.random.default_rng(11)
    specs = [(200, 200), (1, 90), (64, 192), (5, 5)]
    max_kv = max(kv for _, kv in specs)
    kv_pos = np.tile(np.arange(max_kv, dtype=np.int32), len(specs))
    kv_ids = np.repeat(np.arange(len(specs), dtype=np.int32), max_kv)
    kv_ids = np.where(kv_pos < np.repeat([kv for _, kv in specs], max_kv), kv_ids, -1)
    ids = np.concatenate([[s] * ql for s, (ql, _) in enumerate(specs)] + [[-1] * 9])
    q_pos = np.concatenate([np.arange(kv - ql, kv) for ql, kv in specs] + [[0] * 9])
    H = 3
    q = rng.standard_normal((len(ids), H, D)).astype(np.float32)
    k, v = (rng.standard_normal((len(kv_ids), H, D)).astype(np.float32) for _ in range(2))
    v[kv_ids < 0] = np.nan              # gathered past each kv_len: never read as such
    on = lambda a: torch.from_numpy(np.asarray(a, np.int32)).to(dev)
    args = dict(kv_seq_ids=on(kv_ids), q_pos=on(q_pos), kv_pos=on(kv_pos))
    qb, kb, vb = (torch.from_numpy(a).to(dev, torch.bfloat16) for a in (q, k, v))
    got = mha_varlen_flash(qb, kb, vb, on(ids), D ** -0.5, **args)
    ref = mha_varlen_plain(qb.float(), kb.float(), torch.nan_to_num(vb.float(), nan=0.0),
                           on(ids), D ** -0.5, **args)[0]
    torch.cuda.synchronize()
    hold_bf16(got, ref, int((ids >= 0).sum()))


def poisoned_case(seq_specs, H, D, bs, dtype, seed=0, pad_tokens=3, pad_seqs=1, planes=1,
                  nan_q=False):
    """A cache (NB, BS, planes, D) holding each sequence's kv_len rows in
    shuffled pages (planes = 1: K6's single latent plane; 2 x KVH: K2's
    combined heads); every other page, and every slot past a sequence's
    kv_len, holds NaN (bf16/f32) or -128 (int8, never written by the
    quantize). Returns q (T + pad_tokens rows; those past T NaN with nan_q), the
    poisoned pages, the same pages with the poison zeroed, and the geometry
    with pad_seqs empty sequences."""
    rng = np.random.default_rng(seed)
    S = len(seq_specs) + pad_seqs
    mb = max(-(-kv // bs) for _, kv in seq_specs)
    nb = S * mb + 3
    perm = rng.permutation(np.arange(1, nb))
    tables = np.zeros((S, mb), np.int32)
    live = np.zeros((nb, bs), bool)
    for s, (_, kv) in enumerate(seq_specs):
        n = -(-kv // bs)
        tables[s, :n] = perm[s * mb: s * mb + n]
        for i in range(kv):
            live[tables[s, i // bs], i % bs] = True
    vals = rng.standard_normal((nb, bs, planes, D)).astype(np.float32)
    if dtype == torch.int8:
        clean = np.clip(np.round(vals / SCALE), -127, 127).astype(np.int8)
        poison = -128
    else:
        clean = vals
        poison = np.nan
    poisoned = np.where(live[:, :, None, None], clean, poison).astype(clean.dtype)
    clean = np.where(live[:, :, None, None], clean, 0).astype(clean.dtype)
    T = sum(q for q, _ in seq_specs)
    q = rng.standard_normal((T + pad_tokens, H, D)).astype(np.float32)
    if nan_q:
        q[T:] = np.nan
    cu = np.concatenate([[0], np.cumsum([q_ for q_, _ in seq_specs]),
                         [T] * pad_seqs]).astype(np.int32)
    kv_lens = np.asarray([kv for _, kv in seq_specs] + [0] * pad_seqs, np.int32)
    conv = (lambda a: torch.from_numpy(a)) if dtype == torch.int8 else \
        (lambda a: torch.from_numpy(a).to(dtype))
    i32 = lambda a: torch.from_numpy(np.asarray(a, np.int32))
    return (torch.from_numpy(q), conv(poisoned), conv(clean), i32(kv_lens),
            torch.from_numpy(tables), i32(cu), i32([len(seq_specs)]))


LATENT = [
    ("d576_int8_bf16q", 16, 576, 16, torch.int8, torch.bfloat16),
    ("d576_bf16_bf16q", 16, 576, 16, torch.bfloat16, torch.bfloat16),
    ("d576_int8_f32q", 16, 576, 16, torch.int8, torch.float32),
    ("d576_h8_bf16_bf16q", 8, 576, 4, torch.bfloat16, torch.bfloat16),
    ("d48_h8_f32", 8, 48, 4, torch.float32, torch.float32),
    ("d24_h4_int8_f32q", 4, 24, 4, torch.int8, torch.float32),
]
LATENT_SPECS = {
    "decode": [(1, 300), (1, 1), (1, 17), (1, 129), (1, 64)],    # 75 pages at BS 4
    "mixed": [(40, 40), (1, 300), (7, 23), (1, 9), (20, 120), (3, 3)],
}


@pytest.mark.parametrize("batch", sorted(LATENT_SPECS))
@pytest.mark.parametrize("name,H,D,bs,kv_dtype,q_dtype", LATENT, ids=[a[0] for a in LATENT])
def test_k6_latent(dev, batch, name, H, D, bs, kv_dtype, q_dtype):
    specs = LATENT_SPECS[batch]
    q, pages, clean, kv_lens, tables, cu, ns = poisoned_case(specs, H, D, bs, kv_dtype,
                                                           seed=7)
    scale = SCALE if kv_dtype == torch.int8 else None
    sm = 192 ** -0.5 if D == 576 else D ** -0.5        # mla-2b-lm: 1/sqrt(nope + rope)
    geo = [kv_lens.to(dev), tables.to(dev), cu.to(dev), ns.to(dev)]
    qd = q.to(dev, q_dtype)
    got = paged_attention_latent(qd, pages.to(dev), *geo, sm, scale,
                                 max_q=1 if batch == "decode" else None)
    # the plain version in f32 on the same (rounded) inputs, NaN-free pages
    ref_pages = clean.to(dev) if kv_dtype == torch.int8 else clean.to(dev).float()
    ref = paged_attention_varlen_plain(qd.float(), ref_pages, *geo, sm, scale)
    torch.cuda.synchronize()
    n = int(cu[-1])
    assert bool(torch.isfinite(got.float()).all())
    if q_dtype == torch.float32:
        torch.testing.assert_close(got[:n], ref[:n], rtol=1e-4, atol=1e-4)
    else:
        bound = 2e-2 * ref[:n].abs().max().item()
        assert (got[:n].float() - ref[:n]).abs().max().item() <= bound
        if batch == "decode":
            # the bound is tight enough to catch a kernel that skips one kv
            # tile: the first sequence (kv 300) without its rows 64..127
            drop = 64 // bs
            t = tables.clone()
            t[0, drop:-drop] = tables[0, 2 * drop:]
            kl = kv_lens.clone()
            kl[0] -= 64
            miss = paged_attention_varlen_plain(qd.float(), ref_pages, kl.to(dev),
                                                t.to(dev), *geo[2:], sm, scale)
            assert (miss[0] - ref[0]).abs().max().item() > bound
    assert bool((got[n:] == 0).all())                  # padding rows: zeros


def test_k6_counts_its_launches(dev):
    q, pages, _, kv_lens, tables, cu, ns = poisoned_case([(1, 20), (3, 9)], 16, 576, 16,
                                                       torch.int8, pad_tokens=0,
                                                       pad_seqs=0)
    paged_attention_latent.launches = 0
    paged_attention_latent(q.to(dev, torch.bfloat16), pages.to(dev), kv_lens.to(dev),
                           tables.to(dev), cu.to(dev), ns.to(dev), 0.07, SCALE)
    torch.cuda.synchronize()
    assert paged_attention_latent.launches == 1


def test_k6_decode_counts_its_launches(dev):
    """The decode form counts one per wrapper call, its merge launch included."""
    q, pages, _, kv_lens, tables, cu, ns = poisoned_case([(1, 20), (1, 9)], 16, 576, 16,
                                                       torch.int8, pad_tokens=0,
                                                       pad_seqs=0)
    paged_attention_latent.launches = 0
    paged_attention_latent(q.to(dev, torch.bfloat16), pages.to(dev), kv_lens.to(dev),
                           tables.to(dev), cu.to(dev), ns.to(dev), 0.07, SCALE, max_q=1)
    torch.cuda.synchronize()
    assert paged_attention_latent.launches == 1


LATENT_MMA = [a for a in LATENT if a[5] == torch.bfloat16]
# chunks ending on and off the 4-token q tile (1, 3, 4, 5, 130 tokens),
# continuations starting mid kv tile (at cache positions 38 and 64), a
# decode among them
K6_MIXED = [(1, 1), (3, 3), (4, 4), (5, 5), (130, 130), (7, 45), (6, 70), (1, 300)]
# decode lengths on both sides of the 32-row kv tile and of the split
# boundaries: 12 sequences (one padded) take 11 splits (ceil(kv / 11) rows
# each: 10 rows fill 10 of them, 11 all, 12 six)
K6_DECODE = [(1, kv) for kv in (1, 10, 11, 12, 31, 32, 33, 64, 65, 300, 353)]


@pytest.mark.parametrize("form", ["mixed", "decode"])
@pytest.mark.parametrize("name,H,D,bs,kv_dtype,q_dtype", LATENT_MMA,
                         ids=[a[0] for a in LATENT_MMA])
def test_k6_tile_and_split_edges(dev, form, name, H, D, bs, kv_dtype, q_dtype):
    """K6's tensor-core forms at their tile and split boundaries, over pages
    poisoned as test_k6_latent's, held within 2e-2 x max|plain| against the
    plain version in f32; padding rows zero."""
    specs = K6_MIXED if form == "mixed" else K6_DECODE
    q, pages, clean, kv_lens, tables, cu, ns = poisoned_case(specs, H, D, bs, kv_dtype,
                                                           seed=12, nan_q=True)
    scale = SCALE if kv_dtype == torch.int8 else None
    geo = [kv_lens.to(dev), tables.to(dev), cu.to(dev), ns.to(dev)]
    qd = q.to(dev, q_dtype)
    got = paged_attention_latent(qd, pages.to(dev), *geo, 192 ** -0.5, scale,
                                 max_q=1 if form == "decode" else None)
    ref_pages = clean.to(dev) if kv_dtype == torch.int8 else clean.to(dev).float()
    ref = paged_attention_varlen_plain(torch.nan_to_num(qd.float()), ref_pages, *geo,
                                       192 ** -0.5, scale)
    torch.cuda.synchronize()
    hold_bf16(got, ref, int(cu[-1]))


@pytest.mark.parametrize("cache_dtype,in_dtype", [
    (torch.int8, torch.bfloat16), (torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.float32)])
def test_k3_single_plane_write(dev, cache_dtype, in_dtype):
    """The latent write: rows as they are (no interleave), int8 rounding half
    to even (scale 0.25 makes x / scale exactly k + 0.5), dropped negative
    slots leave their rows untouched."""
    rng = np.random.default_rng(8)
    T, D, bs, nb, scale = 29, 576, 16, 6, 0.25
    slots = rng.permutation(nb * bs)[:T].astype(np.int32)
    slots[[0, 11, 28]] = -1
    half = (rng.integers(-200, 200, (T, 1, D)) + 0.5) * scale     # exact in bf16
    x = torch.from_numpy(half.astype(np.float32)).to(dev, in_dtype)
    q8 = cache_dtype == torch.int8
    got = torch.full((nb, bs, 1, D), 7, dtype=cache_dtype, device=dev)
    ref = got.clone()
    s = torch.from_numpy(slots).to(dev)
    write_kv_pages(got, x, None, s, scale if q8 else None)
    write_kv_pages_plain(ref, x, None, s, scale if q8 else None)
    torch.cuda.synchronize()
    expect = np.full((nb * bs, 1, D), 7, np.float32)
    keep = slots >= 0
    rows = np.clip(np.round(half / scale), -127, 127) if q8 else \
        x.float().cpu().numpy()
    expect[slots[keep]] = rows[keep]
    np.testing.assert_array_equal(got.float().cpu().numpy().reshape(-1, 1, D), expect)
    np.testing.assert_array_equal(ref.float().cpu().numpy().reshape(-1, 1, D), expect)


K3_SENTINEL = -128      # never written by the quantize, which clips at -127


def _k3_case(T, kvh, D, single, in_dtype, v_shift=0, k_shift=0, n_pad=2, seed=11):
    """T rows in a fused buffer (k and v strided views of it, v `v_shift`
    and a single-plane k `k_shift` elements off their places), n_pad of them
    padded (slot -1), the others in shuffled slots of a pool with room to
    spare. Returns k, v (None when single), the slots and the rows as the
    cache must hold them, interleaved, as f32 numpy."""
    rng = np.random.default_rng(seed)
    planes = kvh if single else 2 * kvh
    bs = 16
    nb = -(-T // bs) + 3
    slots = rng.permutation(nb * bs)[:T].astype(np.int32)
    slots[rng.permutation(T)[:n_pad]] = -1
    width = (kvh * D + k_shift) if single else (3 * kvh * D + v_shift)
    buf = torch.from_numpy(rng.standard_normal((T, width)).astype(np.float32)).to(in_dtype)
    if single:
        k, v = buf[:, k_shift:].reshape(T, kvh, D), None
        rows = k.float().numpy()
    else:
        k = buf[:, kvh * D: 2 * kvh * D].reshape(T, kvh, D)
        v = buf[:, 2 * kvh * D + v_shift:].reshape(T, kvh, D)
        rows = torch.stack([k, v], 2).reshape(T, planes, D).float().numpy()
    return k, v, slots, rows, (nb, bs, planes, D)


def _k3_expect(rows, slots, shape, cache_dtype, scale):
    """The pages K3 must leave, on the host: the sentinel everywhere but the
    real rows' slots; int8 rows clip(rint(x_f32 / f32(scale)), -127, 127)."""
    expect = torch.full((shape[0] * shape[1],) + shape[2:], K3_SENTINEL, dtype=cache_dtype)
    keep = slots >= 0
    if cache_dtype == torch.int8:
        q = np.clip(np.rint(rows / np.float32(scale)), -127, 127).astype(np.int8)
        expect[torch.from_numpy(slots[keep]).long()] = torch.from_numpy(q[keep])
    else:
        expect[torch.from_numpy(slots[keep]).long()] = \
            torch.from_numpy(rows[keep]).to(cache_dtype)
    return expect.view(shape)


def _k3_run(dev, k, v, slots, shape, cache_dtype, scale, expect_vec_bytes=None):
    """One K3 launch over sentinel pages; asserts the plan's vector width."""
    pages = torch.full(shape, K3_SENTINEL, dtype=cache_dtype, device=dev)
    s = torch.from_numpy(slots).to(dev)
    if expect_vec_bytes is not None:
        in_bits = 0
        for t in (k,) if v is None else (k, v):
            in_bits |= t.data_ptr() | t.stride(0) * k.element_size()
        p = kv_writer.plan(k.shape[0], shape[2], shape[3], k.element_size(),
                           pages.element_size(), kv_writer.alignment(in_bits),
                           kv_writer.alignment(pages.data_ptr()))
        assert p.vec * k.element_size() == expect_vec_bytes
    write_kv_pages(pages, k, v, s, scale)
    torch.cuda.synchronize()
    return pages.cpu()


def _on(dev, k, v):
    """k and v moved to the card as views of one moved buffer, so that
    their offsets and strides survive the move."""
    base = k._base if k._base is not None else k
    moved = base.to(dev)
    view = lambda t: None if t is None else moved.as_strided(
        t.shape, t.stride(), t.storage_offset())
    return view(k), view(v)


@pytest.mark.parametrize("T", [8, 452])
@pytest.mark.parametrize("kvh,D,single", [(32, 128, False), (2, 128, False),
                                          (1, 576, True)])
def test_k3_bit_exact_at_path_shapes(dev, kvh, D, single, T):
    """llava-7b-lm's and qwen2-vl-2b-lm's paired form and mla-2b-lm's latent
    plane, at a decode step and a prefill's rows, bf16 into int8: bit for
    bit the host quantize, the sentinel left in every other slot."""
    k, v, slots, rows, shape = _k3_case(T, kvh, D, single, torch.bfloat16, n_pad=2 + T // 9)
    k, v = _on(dev, k, v)
    got = _k3_run(dev, k, v, slots, shape, torch.int8, SCALE, expect_vec_bytes=16)
    assert torch.equal(got, _k3_expect(rows, slots, shape, torch.int8, SCALE))


@pytest.mark.parametrize("T", [32, 452])
def test_k3_bf16_cache_at_gpt2_xl_shapes(dev, T):
    """GPT-2 XL's write: 25 heads x d64 of bf16 rows, k and v strided views
    of the fused c_attn output, into a bf16 cache (no quantize), at a
    decode step and a prefill's rows: bit for bit the rows, the sentinel
    left in every other slot, 16-byte vectors."""
    k, v, slots, rows, shape = _k3_case(T, 25, 64, False, torch.bfloat16, n_pad=2 + T // 9)
    k, v = _on(dev, k, v)
    got = _k3_run(dev, k, v, slots, shape, torch.bfloat16, None, expect_vec_bytes=16)
    assert torch.equal(got, _k3_expect(rows, slots, shape, torch.bfloat16, None))


@pytest.mark.parametrize("in_dtype,cache_dtype,kvh,D,single,v_shift,k_shift,vec_bytes", [
    (torch.bfloat16, torch.int8, 2, 128, False, 0, 0, 16),
    (torch.bfloat16, torch.int8, 2, 20, False, 0, 0, 8),      # odd head width
    (torch.bfloat16, torch.int8, 2, 128, False, 4, 0, 8),     # v 8 bytes off
    (torch.bfloat16, torch.int8, 2, 128, False, 2, 0, 4),
    (torch.bfloat16, torch.int8, 2, 128, False, 1, 0, 2),
    (torch.bfloat16, torch.bfloat16, 2, 128, False, 0, 0, 16),
    (torch.bfloat16, torch.float32, 2, 128, False, 0, 0, 16),  # two 16-byte stores
    (torch.float32, torch.float32, 2, 128, False, 0, 0, 16),
    (torch.float32, torch.int8, 2, 128, False, 2, 0, 8),
    (torch.float32, torch.bfloat16, 2, 128, False, 1, 0, 4),
    (torch.float32, torch.int8, 3, 20, False, 0, 0, 16),
    (torch.bfloat16, torch.int8, 1, 576, True, 0, 1, 2),      # misaligned latent rows
    (torch.bfloat16, torch.int8, 1, 576, True, 0, 4, 8),
])
def test_k3_every_vector_width(dev, in_dtype, cache_dtype, kvh, D, single, v_shift, k_shift,
                               vec_bytes):
    k, v, slots, rows, shape = _k3_case(37, kvh, D, single, in_dtype, v_shift, k_shift,
                                        n_pad=5)
    k, v = _on(dev, k, v)
    scale = SCALE if cache_dtype == torch.int8 else None
    got = _k3_run(dev, k, v, slots, shape, cache_dtype, scale, expect_vec_bytes=vec_bytes)
    assert torch.equal(got, _k3_expect(rows, slots, shape, cache_dtype, scale))


@pytest.mark.parametrize("T,kvh,D,single", [(8, 32, 128, False), (452, 32, 128, False),
                                            (32, 1, 576, True)])
def test_k3_graph_replays_are_identical(dev, T, kvh, D, single):
    k, v, slots, rows, shape = _k3_case(T, kvh, D, single, torch.bfloat16, n_pad=3)
    k, v = _on(dev, k, v)
    pages = torch.full(shape, K3_SENTINEL, dtype=torch.int8, device=dev)
    s = torch.from_numpy(slots).to(dev)
    write_kv_pages(pages, k, v, s, SCALE)             # built and loaded before capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        write_kv_pages(pages, k, v, s, SCALE)
    replays = []
    for _ in range(2):
        pages.fill_(K3_SENTINEL)
        graph.replay()
        torch.cuda.synchronize()
        replays.append(pages.cpu())
    assert torch.equal(replays[0], replays[1])
    assert torch.equal(replays[0], _k3_expect(rows, slots, shape, torch.int8, SCALE))


def test_k3_counts_its_launches(dev):
    k, v, slots, _, shape = _k3_case(8, 2, 128, False, torch.bfloat16)
    k, v = _on(dev, k, v)
    pages = torch.zeros(shape, dtype=torch.int8, device=dev)
    write_kv_pages.launches = 0
    write_kv_pages(pages, k, v, torch.from_numpy(slots).to(dev), SCALE)
    torch.cuda.synchronize()
    assert write_kv_pages.launches == 1


# ------------------------------------------------ block migration on one card

@pytest.mark.parametrize("form,layers,heads,D,bs,dtype", [
    ("kv_int8", 4, 64, 128, 16, torch.int8), ("kv_bf16", 2, 16, 128, 16, torch.bfloat16),
    ("mla_plane", 3, 1, 576, 16, torch.int8), ("image", 1, 32, 128, 576, torch.bfloat16)])
def test_block_migration_round_trip_on_the_card(dev, form, layers, heads, D, bs, dtype):
    """gather_blocks on one cache and scatter_blocks into another on the same
    card (as a pull between two nodes does) move the blocks bit for bit and
    touch no other block; a payload through the host lands the same."""
    from hydrainfer_tpu_torch.memory import (TokenCacheBlockManager,
                                             TokenCacheBlockManagerConfig)
    name = {torch.int8: "int8", torch.bfloat16: "bf16"}[dtype]
    cfg = lambda n: TokenCacheBlockManagerConfig(n_layers=layers, n_tensors=1, n_blocks=n,
                                                 block_size=bs, n_heads=heads, head_dim=D,
                                                 dtype=name)
    src, dst = TokenCacheBlockManager(cfg(9), dev), TokenCacheBlockManager(cfg(7), dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    if dtype == torch.int8:
        src.cache_array.copy_(torch.randint(-127, 128, src.cache_array.shape, device=dev,
                                            generator=gen, dtype=torch.int8))
        dst.cache_array.fill_(-128)
    else:
        src.cache_array.copy_(torch.randn(src.cache_array.shape, device=dev, generator=gen,
                                          dtype=dtype))
        dst.cache_array.fill_(float("nan"))
    before = dst.cache_array.clone()
    src_ids, dst_ids = [8, 2, 5], [1, 6, 3]
    dst.scatter_blocks(dst_ids, src.gather_blocks(src_ids))
    torch.cuda.synchronize()
    for s, d in zip(src_ids, dst_ids):
        assert torch.equal(dst.cache_array[:, :, d], src.cache_array[:, :, s])
    others = [i for i in range(7) if i not in dst_ids]
    assert torch.equal(dst.cache_array[:, :, others].view(torch.uint8),
                       before[:, :, others].view(torch.uint8))
    host = src.gather_blocks(src_ids).cpu()
    dst.scatter_blocks([0, 4, 2], host)
    assert torch.equal(dst.gather_blocks([0, 4, 2]).cpu(), host)


# ------------------------------------------------ DeepSeek-VL2 and MoE on the card

def test_k5_siglip_heads_padded_72_to_80(dev):
    """SigLIP-so400m's attention as the VL2 encode runs it: 784-row tiles,
    16 heads of 72 padded with zero columns to 80 (the load-time padding of
    models/deepseek_vl2.py), V a strided view of the fused qkv, scaled by
    1/sqrt(72): the first 72 columns held to the plain attention over the
    unpadded heads, the padding columns exactly 0."""
    qkv, ids = vit_case([784] * 3, 0, 16, 80, seed=13)
    qkv[..., 72:] = 0
    x = torch.from_numpy(qkv).to(dev, torch.bfloat16)
    q, k, v = x[:, 0].contiguous(), x[:, 1].contiguous(), x[:, 2]
    i = torch.from_numpy(ids).to(dev)
    got = mha_varlen_flash(q, k, v, i, 72 ** -0.5)
    real = x[..., :72].float()
    ref = mha_varlen_plain(real[:, 0], real[:, 1], real[:, 2], i, 72 ** -0.5)[0]
    torch.cuda.synchronize()
    assert got.shape[-1] == 80 and not got[..., 72:].any()
    hold_bf16(got[..., :72], ref, len(ids))


def _moe_case(dev, T, E=16, k=6, d=256, I=128, seed=14):
    from hydrainfer_tpu_torch.ops import moe
    rng = np.random.default_rng(seed)
    on = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    x = on(rng.standard_normal((T, d))).to(torch.bfloat16)
    gate_up = (on(rng.standard_normal((E, d, 2 * I))) * 0.05).to(torch.bfloat16)
    down = (on(rng.standard_normal((E, I, d))) * 0.05).to(torch.bfloat16)
    logits = on(rng.standard_normal((T, E)))
    logits[:, 3] = -30.0                        # an expert no token picks
    weights, ids = moe.route(logits, k, norm_topk=False)
    return x, gate_up, down, weights, ids


@pytest.mark.parametrize("T", [1, 32, 300])
def test_moe_ffn_on_the_card(dev, T):
    """The grouped-product dispatch (torch._grouped_mm, bf16) against the
    dense plain version in f32 on the same inputs, within 2e-2 x max|plain|
    (bf16 rounding of the gate_up product and of the down product)."""
    from hydrainfer_tpu_torch.ops import moe
    x, gate_up, down, weights, ids = _moe_case(dev, T)
    got = moe.moe_ffn(x, gate_up, down, weights, ids)
    ref = moe.moe_ffn_dense(x.float(), gate_up.float(), down.float(), weights, ids)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
    tol = 2e-2 * ref.abs().max().item()
    assert (got.float() - ref).abs().max().item() <= tol


def test_moe_layer_graph_replay_equals_eager(dev):
    """A MoE layer (routing from f32 router logits, the grouped products, the
    shared experts through K4) captured in a CUDA graph: a replay on new
    inputs written into the captured buffers equals the eager call on them,
    bit for bit; the dispatch reads nothing on the host."""
    from dataclasses import replace
    from hydrainfer_tpu_torch.models.decoder import DecoderConfig, _mlp
    from hydrainfer_tpu_torch.ops.quant import quantize_int8
    x, gate_up, down, _, _ = _moe_case(dev, 32)
    rng = np.random.default_rng(15)
    on = lambda *s: (torch.from_numpy(rng.standard_normal(s).astype(np.float32)) * 0.05
                     ).to(dev)
    lw = {"moe_router": on(256, 16).to(torch.bfloat16), "moe_gate_up": gate_up,
          "moe_down": down, "gate_up": quantize_int8(on(256, 512)),
          "down": quantize_int8(on(256, 256))}
    cfg = replace(DecoderConfig(n_layers=1, hidden_size=256, intermediate_size=256,
                                n_qo_heads=2, n_kv_heads=2, head_dim=128, vocab_size=64,
                                max_position_embeddings=64),
                  moe_top_k=6, n_experts=16, moe_norm_topk=False)
    static = x.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        _mlp(static, lw, cfg)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = _mlp(static, lw, cfg)
    for seed in (1, 2):
        new = torch.from_numpy(np.random.default_rng(seed).standard_normal((32, 256))
                               .astype(np.float32)).to(dev, torch.bfloat16)
        static.copy_(new)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, _mlp(new, lw, cfg))


def test_debug_probe_raises_inside_a_graph_capture(dev, monkeypatch):
    """utils/debug.py: a probe outside a capture keeps a CPU copy; one inside
    a CUDA-graph capture raises instead of recording nothing."""
    from hydrainfer_tpu_torch.utils import debug
    monkeypatch.setattr(debug, "_ENABLED", True)
    monkeypatch.setattr(debug, "_REGISTRY", {})
    x = torch.arange(4, device=dev, dtype=torch.float32)
    debug.probe("x", x * 2)
    assert debug._REGISTRY["x"][0].tolist() == [0.0, 2.0, 4.0, 6.0]
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="CUDA-graph capture"):
        with torch.cuda.graph(graph):
            debug.probe("x", x * 3)
    assert len(debug._REGISTRY["x"]) == 1


# ------------------------------------------- the logits interface on the card

def _swap_in_plain_versions(monkeypatch):
    """Every kernel wrapper the model code looks up by name, swapped for its
    plain PyTorch version."""
    from hydrainfer_tpu_torch.ops import attention, cache_ops, quant
    from hydrainfer_tpu_torch.ops.cuda import mha_decode
    from hydrainfer_tpu_torch.ops.cuda import paged_attention as pa
    from hydrainfer_tpu_torch.ops.cuda import quant_matmul as qmm
    for mod, name, fn in ((quant, "quant_matmul_int8", qmm.quant_matmul_int8_plain),
                          (quant, "quant_matmul_int4", qmm.quant_matmul_int4_plain),
                          (quant, "quant_matmul_fp8", qmm.quant_matmul_fp8_plain),
                          (cache_ops, "write_kv_pages", write_kv_pages_plain),
                          (attention, "mha_decode_attention",
                           mha_decode.mha_decode_attention_plain),
                          (attention, "paged_attention_varlen", pa.paged_attention_varlen_plain),
                          (attention, "paged_attention_latent",
                           pa.paged_attention_varlen_plain)):
        monkeypatch.setattr(mod, name, fn)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("quant", ["int8", "int4", "fp8"])
@pytest.mark.parametrize("arch", ["tiny-lm", "mla-tiny-lm"])
def test_forward_with_logits_against_plain_versions(dev, arch, quant, dtype, monkeypatch):
    """forward_with_logits over every position of a 48-token sequence
    (evaluation/perplexity.py's all-position batch) with int8 weights, int4
    (the lm_head int8) or fp8, over the int8 KV cache: through the kernels
    (K2 or K6, K3, K4's form for the mode) and through the plain versions,
    within 1e-2 x max|logit| in f32 (an int8 KV entry may round one step
    apart) and 3e-2 in bf16."""
    from hydrainfer_tpu_torch.evaluation.perplexity import all_logits
    from hydrainfer_tpu_torch.models.random_init import RandomWeightFactory
    from hydrainfer_tpu_torch.ops.cuda import launch_counts
    factory = RandomWeightFactory(arch, dtype=dtype, quantization=quant, kv_scale=SCALE,
                                  device=dev, seed=3)
    lm, lcfg = factory.getLanguageModel(), factory.getLanguageModelConfig()
    ids = [int(t) for t in np.random.default_rng(5).integers(3, lcfg.vocab_size, size=48)]
    before = launch_counts()
    got = all_logits(lm, lcfg, ids, 16, torch.int8)
    after = launch_counts()
    ran = {k for k in after if after[k] > before[k]}
    attention = "paged_attention_latent" if lcfg.kv_single_plane else "paged_attention"
    form = {"int8": "quant_matmul", "int4": "quant_matmul_int4",
            "fp8": "quant_matmul_fp8"}[quant]
    assert {attention, "kv_writer", form} <= ran
    _swap_in_plain_versions(monkeypatch)
    ref = all_logits(lm, lcfg, ids, 16, torch.int8)
    assert got.shape == ref.shape == (48, lcfg.vocab_size)
    tol = (1e-2 if dtype == torch.float32 else 3e-2) * ref.abs().max().item()
    assert (got - ref).abs().max().item() <= tol


@pytest.mark.parametrize("fmt", ["int8", "int4", "fp8"])
def test_k4_lm_head_at_every_position(dev, fmt):
    """llava-7b-lm's lm_head over every row of a 512-token sequence (M 512, K
    4096, N 32064, f32 out: the quality scripts' all-position logits), in
    each form (int4 at group 128), within 1e-4 of the f32 plain version."""
    M, K, N = 512, 4096, 32064
    if fmt != "int8":
        _check_k4_form(dev, fmt, 128 if fmt == "int4" else 0, M, K, N, torch.bfloat16,
                       torch.float32, seed=21)
        return
    from hydrainfer_tpu_torch.ops.quant import quantize_int8
    rng = np.random.default_rng(21)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)).to(dev, torch.bfloat16)
    qt = quantize_int8(torch.from_numpy((rng.standard_normal((K, N)) / K ** 0.5)
                                        .astype(np.float32)).to(dev))
    got = quant_matmul_int8(x, qt.q, qt.scale, torch.float32)
    ref = quant_matmul_int8_plain(x, qt.q, qt.scale, torch.float32)
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)


# The shapes one of two tensor-parallel ranks gives the kernels
# (parallel/mesh.py): llava-7b-lm's int8 projections and lm_head (vocabulary
# 32064 / 2), and DeepSeek-V2-Lite's (MLA o_proj, its dense layer, its two
# shared experts, lm_head 102400 / 2); K1 and K2 at llava-7b-lm's 16 heads a
# rank, K6 at V2-Lite's 8 heads a rank over the int8 576-wide plane
TP_K4 = {"llava_qkv": (4096, 6144), "llava_o": (2048, 4096),
         "llava_gate_up": (4096, 11008), "llava_down": (5504, 4096),
         "v2lite_o": (1024, 2048), "v2lite_dense_gate_up": (2048, 10944),
         "v2lite_dense_down": (5472, 2048), "v2lite_shared_gate_up": (2048, 2816),
         "v2lite_shared_down": (1408, 2048)}
TP_LM_HEADS = {"llava": (4096, 16032), "v2lite": (2048, 51200)}


@pytest.mark.parametrize("M", [1, 8, 16, 256, 1024])
@pytest.mark.parametrize("proj", list(TP_K4))
def test_k4_at_tp_shard_shapes(dev, proj, M):
    _check_k4_bf16(dev, M, *TP_K4[proj], torch.bfloat16)


@pytest.mark.parametrize("M", [1, 8, 16])
@pytest.mark.parametrize("head", list(TP_LM_HEADS))
def test_k4_tp_lm_heads(dev, head, M):
    _check_k4_bf16(dev, M, *TP_LM_HEADS[head], torch.float32)


def test_k1_k2_at_tp_shard_heads(dev):
    """llava-7b-lm's 16 q / 16 kv heads a rank over int8 pages poisoned as
    test_k1_tensor_cores' and test_k2_tensor_cores' are, held to the plain
    version in f32."""
    for specs, fn, plain, seed in ((K1_SPECS, mha_decode_attention,
                                    mha_decode_attention_plain, 13),
                                   (K2_SPECS, paged_attention_varlen,
                                    paged_attention_varlen_plain, 9)):
        q, pages, clean, kv_lens, tables, cu, ns = poisoned_case(
            specs, 16, 128, 16, torch.int8, seed=seed, planes=32, nan_q=True)
        geo = ([kv_lens.to(dev), tables.to(dev), ns.to(dev)] if fn is mha_decode_attention
               else [kv_lens.to(dev), tables.to(dev), cu.to(dev), ns.to(dev)])
        qd = q.to(dev, torch.bfloat16)
        got = fn(qd, pages.to(dev), *geo, 128 ** -0.5, SCALE)
        ref = plain(torch.nan_to_num(qd.float()), clean.to(dev), *geo, 128 ** -0.5, SCALE)
        torch.cuda.synchronize()
        hold_bf16(got, ref, len(specs) if fn is mha_decode_attention else int(cu[-1]))


@pytest.mark.parametrize("form", ["mixed", "decode"])
def test_k6_at_tp_shard_heads(dev, form):
    """V2-Lite's 8 heads a rank over an int8 576-wide plane (the copy every
    rank holds), bf16 q, in both forms."""
    specs = K6_MIXED if form == "mixed" else K6_DECODE
    q, pages, clean, kv_lens, tables, cu, ns = poisoned_case(specs, 8, 576, 16, torch.int8,
                                                           seed=14, nan_q=True)
    geo = [kv_lens.to(dev), tables.to(dev), cu.to(dev), ns.to(dev)]
    qd = q.to(dev, torch.bfloat16)
    got = paged_attention_latent(qd, pages.to(dev), *geo, 192 ** -0.5, SCALE,
                                 max_q=1 if form == "decode" else None)
    ref = paged_attention_varlen_plain(torch.nan_to_num(qd.float()), clean.to(dev), *geo,
                                       192 ** -0.5, SCALE)
    torch.cuda.synchronize()
    hold_bf16(got, ref, int(cu[-1]))


def _pp_decode_case(dev, S=8, bs=16, n_blocks=64, seed=21):
    """tiny-lm (bf16, int8 weights, int8 KV) over two pipeline stages on
    the card, a pure decode batch of S rows (the last two padding, kv_len
    0) over a random int8 cache, as the stages' shards."""
    from hydrainfer_tpu_torch.models.factory import LanguageModelBatch
    from hydrainfer_tpu_torch.models.random_init import RandomWeightFactory
    from hydrainfer_tpu_torch.ops.attention import PagedAttentionParams
    from hydrainfer_tpu_torch.parallel.mesh import shard_kv_cache
    lm = RandomWeightFactory("tiny-lm", dtype=torch.bfloat16, quantization="int8",
                             kv_scale=SCALE, device=dev, seed=0).getLanguageModel()
    lm.shard_to_pp([dev, dev])
    cfg = lm.cfg
    rng = np.random.default_rng(seed)
    kv_lens = np.array([5, 17, 33, 9, 40, 2, 0, 0][:S], np.int32)
    mb = -(-int(kv_lens.max()) // bs)
    tables = np.full((S, mb), -1, np.int32)
    perm = rng.permutation(n_blocks)
    for s, n in enumerate(kv_lens):
        tables[s, :-(-int(n) // bs)] = perm[s * mb:s * mb + -(-int(n) // bs)]
    live = kv_lens > 0
    pos = np.where(live, kv_lens - 1, 0).astype(np.int32)
    slots = np.where(live, tables[np.arange(S), pos // bs] * bs + pos % bs, -1).astype(np.int32)
    t = lambda a: torch.from_numpy(np.asarray(a, np.int32)).to(dev)  # noqa: E731
    batch = LanguageModelBatch(
        token_ids=t(rng.integers(3, cfg.vocab_size, S)), positions=t(pos),
        attention=PagedAttentionParams(
            q_seq_ids=t(np.where(live, np.arange(S), -1)), q_local_ids=t(np.zeros(S)),
            positions=t(pos), kv_lens=t(kv_lens), block_tables=t(tables),
            new_kv_slot_ids=t(slots), cu_q_lens=t(np.minimum(np.arange(S + 1), live.sum())),
            num_seqs=t([live.sum()])),
        sample_token_idx=t(np.arange(S)), token_src_slots=t(np.full(S, -1)),
        sample_dst_slots=t(np.where(live, np.arange(S), -1)))
    cache = torch.from_numpy(rng.integers(-127, 128, (cfg.n_layers, 1, n_blocks, bs,
                                                      2 * cfg.n_kv_heads, cfg.head_dim),
                                          dtype=np.int8)).to(dev)
    return lm, batch, (lambda: shard_kv_cache(cache, lm.stages.cache_shards()))


def test_pp_microbatched_decode_graph_equals_eager(dev):
    """A pp-2 microbatched decode step (2 microbatches of 4 rows, both stages
    on the card) captured in a CUDA graph: its replay gives the eager step's
    tokens, token table and stage caches bit for bit, and it launched K1, K3
    and K4 inside the capture."""
    from hydrainfer_tpu_torch.ops.cuda import launch_counts
    from hydrainfer_tpu_torch.parallel.pipeline import decoder_forward_pp_decode
    lm, batch, caches = _pp_decode_case(dev)

    def step(cs, table):
        return decoder_forward_pp_decode(lm.stages, cs, batch, lm.cos_tab, lm.sin_tab, table, 2)

    eager_caches, eager_table = caches(), torch.zeros(16, dtype=torch.int32, device=dev)
    eager = step(eager_caches, eager_table)
    graph_caches, graph_table = caches(), torch.zeros(16, dtype=torch.int32, device=dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):            # warm up off the capturing stream
        step(graph_caches, graph_table)
    torch.cuda.current_stream().wait_stream(side)
    for c, c0 in zip(graph_caches, caches()):
        c.copy_(c0)
    graph_table.zero_()
    before = launch_counts()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = step(graph_caches, graph_table)
    captured = {k: n - before[k] for k, n in launch_counts().items()}
    assert all(captured[k] > 0 for k in ("mha_decode", "kv_writer", "quant_matmul"))
    assert captured["paged_attention"] == 0
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager) and torch.equal(graph_table, eager_table)
    assert all(torch.equal(a, b) for a, b in zip(graph_caches, eager_caches))


def test_pp_graphs_refuse_stages_on_two_cards(dev):
    """A decode graph captures one card's stream: a node whose pipeline
    stages sit on two cards refuses cuda_graphs before it touches either;
    with graphs off, or with both stages on one card, it is built."""
    from hydrainfer_tpu_torch.cluster.migrate import NodeType
    from hydrainfer_tpu_torch.cluster.node import AsyncEPDNode, NodeConfig, NodeContext
    two = [torch.device("cuda", 0), torch.device("cuda", 1)]
    with pytest.raises(NotImplementedError, match="pipeline stages on different devices"):
        AsyncEPDNode(NodeConfig(cuda_graphs=True), NodeContext(
            node_type=NodeType("PD"), device=two, parallel="pp"))
    for devices, graphs in ((two, False), ([dev, dev], True)):
        AsyncEPDNode(NodeConfig(cuda_graphs=graphs), NodeContext(
            node_type=NodeType("PD"), device=devices, parallel="pp"))
