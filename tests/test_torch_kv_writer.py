"""K3 (the paged KV write, csrc/kv_writer.cu) on the CPU: its launch plan and
its index arithmetic.

The kernel's work item is one input vector of one (row, combined head);
`kv_writer.plan` picks the vector width and the grid from shapes, strides and
addresses alone, and `kv_writer.divisor` gives the multiply-and-shift
constants the kernel divides an item's index with. Here: the plan takes
16-byte vectors at the three serving paths' shapes (llava-7b-lm's 32 kv heads
x d128 with v a strided view of the fused qkv, qwen2-vl-2b-lm's 2 x d128,
mla-2b-lm's single 576-wide latent plane) and narrower ones for an odd head
width or a misaligned view; a decode step of llava-7b-lm spans at least 64
blocks; the divisions are exact over every index a launch can reach; the
kernel's item -> (source, destination) mapping, replayed here in numpy with
the plan's width and the same constants, writes what the plain version
writes; and on "meta" tensors, which hold no data, the wrapper reaches
build.launch with the plan's arguments.
"""
import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)
import numpy as np
import pytest
import torch

from hydrainfer_tpu_torch.models.random_init import ARCH_CONFIGS
from hydrainfer_tpu_torch.ops.cuda import build, kv_writer
from hydrainfer_tpu_torch.ops.cuda.kv_writer import (alignment, divisor, plan,
                                                     write_kv_pages,
                                                     write_kv_pages_plain)

META = dict(device="meta")


def _fused(T, hq, kvh, D, dtype, v_shift=0, device="meta"):
    """k (a fresh tensor, as rope returns it) and v (a strided view of a fused
    qkv row, `v_shift` elements past its place)."""
    qkv = torch.empty((T, (hq + 2 * kvh) * D + v_shift), dtype=dtype, device=device)
    k = torch.empty((T, kvh, D), dtype=dtype, device=device)
    start = (hq + kvh) * D + v_shift
    return k, qkv[:, start: start + kvh * D].view(T, kvh, D)


def _launches(monkeypatch):
    calls = []
    monkeypatch.setattr(build, "launch", lambda name, *args: calls.append((name, args)))
    return calls


def _wrapper_plan(monkeypatch, pages, k, v):
    """The (vec, blocks) the wrapper hands the kernel."""
    calls = _launches(monkeypatch)
    T = k.shape[0]
    write_kv_pages(pages, k, v, torch.empty((T,), dtype=torch.int32, device=pages.device),
                   0.05 if pages.dtype == torch.int8 else None)
    (name, args), = calls
    # (k, v, k stride, v stride, slots, pages, T, planes, D, in, cache, vec,
    #  blocks, row mul, row shift, head mul, head shift, scale)
    assert name == "kv_writer"
    return args[11], args[12]


@pytest.mark.parametrize("arch,T,blocks", [
    ("llava-7b-lm", 8, 64), ("llava-7b-lm", 512, 4096),
    ("qwen2-vl-2b-lm", 8, 4), ("qwen2-vl-2b-lm", 2048, 1024),
    ("mla-2b-lm", 32, 18), ("mla-2b-lm", 2048, 1152)])
def test_paths_take_16_byte_vectors(monkeypatch, arch, T, blocks):
    cfg = ARCH_CONFIGS[arch]
    if cfg.mla_kv_lora:
        D = cfg.mla_kv_lora + cfg.mla_rope_dim
        # the latent rows come from torch.cat, contiguous
        k, v, planes = torch.empty((T, 1, D), dtype=torch.bfloat16, **META), None, 1
    else:
        D = cfg.head_dim
        k, v = _fused(T, cfg.n_qo_heads, cfg.n_kv_heads, D, torch.bfloat16)
        planes = 2 * cfg.n_kv_heads
    pages = torch.empty((64, 16, planes, D), dtype=torch.int8, **META)
    vec, n_blocks = _wrapper_plan(monkeypatch, pages, k, v)
    assert vec * k.element_size() == 16
    assert (vec, n_blocks) == plan(T, planes, D, 2, 1, 16, 16)[:2]
    assert n_blocks == blocks


def test_serve_decode_step_spreads_over_the_card():
    cfg = ARCH_CONFIGS["llava-7b-lm"]
    p = plan(8, 2 * cfg.n_kv_heads, cfg.head_dim, 2, 1, 16, 16)
    # one block a row was 8 blocks; one 16-byte vector a thread is 64
    assert p.blocks >= 64


@pytest.mark.parametrize("D,dtype,v_shift,cache,vec_bytes", [
    (128, torch.bfloat16, 0, torch.int8, 16),
    (20, torch.bfloat16, 0, torch.int8, 8),     # odd head width: 4 values a vector
    (128, torch.bfloat16, 4, torch.int8, 8),    # v 8 bytes off a 16-byte boundary
    (128, torch.bfloat16, 2, torch.int8, 4),
    (128, torch.bfloat16, 1, torch.int8, 2),    # one element a vector
    (128, torch.float32, 0, torch.float32, 16),
    (128, torch.float32, 2, torch.bfloat16, 8),
    (128, torch.float32, 1, torch.int8, 4),
    (6, torch.float32, 0, torch.int8, 8),       # D 6: two f32 values
])
def test_plan_narrows_for_odd_widths_and_misaligned_views(monkeypatch, D, dtype, v_shift,
                                                          cache, vec_bytes):
    k, v = _fused(12, 4, 2, D, dtype, v_shift)
    pages = torch.empty((4, 16, 4, D), dtype=cache, **META)
    vec, _ = _wrapper_plan(monkeypatch, pages, k, v)
    assert vec * k.element_size() == vec_bytes


def test_plan_narrows_for_misaligned_pages(monkeypatch):
    k, v = _fused(8, 4, 2, 128, torch.bfloat16)
    buf = torch.empty((4 * 16 * 4 * 128 + 4,), dtype=torch.int8, **META)
    pages = buf[4:].view(4, 16, 4, 128)       # 8 int8 values (8 bytes) cannot land
    vec, _ = _wrapper_plan(monkeypatch, pages, k, v)
    assert vec == 4


def test_alignment():
    assert alignment(0) == 16 and alignment(256 | 4096) == 16
    assert alignment(64 | 24) == 8 and alignment(1152 | 6) == 2 and alignment(3) == 1


@pytest.mark.parametrize("d", [1, 2, 3, 5, 9, 16, 18, 36, 64, 72, 144, 576, 1024, 1152])
def test_divisor_is_exact(d):
    mul, shift = divisor(d)
    assert 0 < mul < 2 ** 32
    rng = np.random.default_rng(d)
    i = np.concatenate([np.arange(1 << 16), rng.integers(0, 2 ** 31, 1 << 14),
                        np.array([2 ** 31 - 1, 2 ** 31 - d, 2 ** 31 - d - 1])]).astype(np.uint64)
    q = (i * np.uint64(mul)) >> np.uint64(shift)
    np.testing.assert_array_equal(q, i // np.uint64(d))


def _kernel_write(pages, k, v, slots, scale, vec, blocks):
    """csrc/kv_writer.cu:kv_write_kernel's indexing, for every thread at
    once in numpy: its item's row and combined head from the same division
    constants, then the vector's source and destination."""
    T, kvh, D = k.shape
    planes = kvh if v is None else 2 * kvh
    row_d, head_d = planes * D // vec, D // vec
    (row_mul, row_shift), (head_mul, head_shift) = divisor(row_d), divisor(head_d)
    n_vec = T * row_d
    i = np.arange(blocks * kv_writer.THREADS, dtype=np.uint64)
    t = ((i * np.uint64(row_mul)) >> np.uint64(row_shift)).astype(np.int64)
    j = i.astype(np.int64) - t * row_d
    live = i.astype(np.int64) < n_vec
    slot = np.where(live, slots[np.minimum(t, T - 1)], -1)
    t, j, slot = t[slot >= 0], j[slot >= 0], slot[slot >= 0]
    kf, vf = k.reshape(T, -1), None if v is None else v.reshape(T, -1)
    lanes = np.arange(vec)
    if v is None:
        src = kf[t[:, None], j[:, None] * vec + lanes]
    else:
        c = ((j.astype(np.uint64) * np.uint64(head_mul)) >> np.uint64(head_shift)).astype(np.int64)
        w = j - c * head_d
        col = (c >> 1)[:, None] * D + w[:, None] * vec + lanes
        src = np.where((c & 1)[:, None] == 1, vf[t[:, None], col], kf[t[:, None], col])
    flat = pages.reshape(-1)
    dst = slot[:, None] * (planes * D) + j[:, None] * vec + lanes
    assert len(np.unique(dst)) == dst.size          # every element written once
    if scale is None:
        flat[dst] = src
    else:
        flat[dst] = np.clip(np.rint(src / np.float32(scale)), -127, 127)
    return pages


@pytest.mark.parametrize("T,kvh,D,single,vec", [
    (8, 32, 128, False, 8), (300, 4, 128, False, 8), (37, 2, 20, False, 4),
    (29, 1, 576, True, 8), (33, 3, 6, True, 2), (5, 2, 16, False, 1)])
def test_kernel_indexing_writes_what_the_plain_version_writes(T, kvh, D, single, vec):
    """Scale 0.25 makes x / scale exact (whether divided or multiplied by the
    reciprocal) and gives ties that round half to even and values to clip."""
    rng = np.random.default_rng(T)
    bs, scale = 16, 0.25
    nb = -(-T // bs) + 2
    slots = rng.permutation(nb * bs)[:T].astype(np.int32)
    slots[rng.permutation(T)[: max(1, T // 7)]] = -1               # padded rows

    def rows():
        return (rng.integers(-160, 160, (T, kvh, D)) * 0.125).astype(np.float32)

    k, v = rows(), None if single else rows()
    planes = kvh if single else 2 * kvh
    blocks = -(-(T * planes * D // vec) // kv_writer.THREADS)
    got = _kernel_write(np.full((nb, bs, planes, D), -128, np.int8), k, v, slots, scale,
                        vec, blocks)
    ref = torch.full((nb, bs, planes, D), -128, dtype=torch.int8)
    write_kv_pages_plain(ref, torch.from_numpy(k), None if v is None else torch.from_numpy(v),
                         torch.from_numpy(slots), scale)
    np.testing.assert_array_equal(got, ref.numpy())


def test_wrapper_runs_the_plain_version_on_the_cpu(monkeypatch):
    calls = _launches(monkeypatch)
    before = kv_writer.write_kv_pages.launches
    k, v = _fused(5, 2, 1, 16, torch.bfloat16, device="cpu")
    rng = np.random.default_rng(5)
    for t in (k, v):
        t.copy_(torch.from_numpy(rng.standard_normal(t.shape).astype(np.float32)))
    pages = torch.zeros((2, 16, 2, 16), dtype=torch.int8)
    slots = torch.tensor([3, -1, 17, 0, 9], dtype=torch.int32)
    write_kv_pages(pages, k, v, slots, 0.05)
    ref = write_kv_pages_plain(torch.zeros_like(pages), k, v, slots, 0.05)
    assert calls == [] and kv_writer.write_kv_pages.launches == before
    assert torch.equal(pages, ref)
