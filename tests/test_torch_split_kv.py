"""Split-KV decode (K1 and K6's decode form) on the CPU: the plan and the merge.

The kernels cut each decode row's kv range into `num_splits` pieces chosen
from shapes alone (hydrainfer_tpu_torch/ops/cuda/split_kv.py, mirroring
csrc/common.cuh:split_range), and a second launch merges the pieces' partial
softmax states (csrc/common.cuh:split_merge_kernel, mirrored by
split_kv.merge_partials). Here: the plan covers every kv row of every length
exactly once; merging partials computed from the plain attention piece by
piece gives the plain version's output within f32 tolerance (1e-5 x max,
summation order), empty pieces included; and the wrappers pick their form and
split count from shapes alone: on "meta" tensors, which hold no data, any
read of kv_lens or cu_q_lens on the host would raise.
"""
import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)
import math

import numpy as np
import pytest
import torch

from hydrainfer_tpu_torch.ops.cuda import build, split_kv
from hydrainfer_tpu_torch.ops.cuda.mha_decode import (mha_decode_attention,
                                                      mha_decode_attention_plain)
from hydrainfer_tpu_torch.ops.cuda.paged_attention_latent import paged_attention_latent

LOG2E = 1.0 / math.log(2.0)

# (blocks before the split, MB, BS): qwen2-vl-2b-lm's K1 window (8 rows x 2
# kv heads), llava-7b-lm's (8 x 32: one split), mla-2b-lm's K6 window (32
# sequences), one sequence over 128 pages (16 splits), a short table
PLANS = [(16, 32, 16), (256, 16, 16), (32, 32, 16), (1, 128, 16), (3, 5, 4)]


@pytest.mark.parametrize("blocks,MB,BS", PLANS)
def test_split_plan_covers_every_row_once(blocks, MB, BS):
    n = split_kv.num_splits(blocks, MB * BS)
    assert 1 <= n <= split_kv.MAX_SPLITS
    if blocks < split_kv.SMS and MB * BS >= split_kv.MIN_CHUNK * split_kv.MAX_SPLITS:
        assert blocks * n >= split_kv.SMS or n == split_kv.MAX_SPLITS
    for kv_len in range(MB * BS + 1):
        seen = np.zeros(kv_len, np.int32)
        for i in range(n):
            lo, hi = split_kv.split_range(kv_len, n, i)
            assert 0 <= lo <= hi <= kv_len
            seen[lo:hi] += 1
        assert (seen == 1).all(), (kv_len, n)


def test_split_counts_on_the_serving_windows():
    """At least 128 working blocks at the vlm (K1) and mla (K6) windows'
    shortest kv, one split (no merge launch) at serve."""
    n_vlm = split_kv.num_splits(8 * 2, 32 * 16)
    n_mla = split_kv.num_splits(32, 32 * 16)
    assert split_kv.num_splits(8 * 32, 16 * 16) == 1
    for rows, n, kv_min in ((16, n_vlm, 144), (32, n_mla, 129)):
        working = sum(split_kv.split_range(kv_min, n, i)[1] >
                      split_kv.split_range(kv_min, n, i)[0] for i in range(n))
        assert rows * working >= 128


def _partials(q, k, v, scale, ranges):
    """Each piece's (acc, m, l) from the plain attention over its kv rows,
    as a split block leaves them: m in log2 units; an empty piece m = -inf,
    l = 0 and acc NaN (the merge must never read it)."""
    accs, ms, ls = [], [], []
    for lo, hi in ranges:
        if hi <= lo:
            accs.append(torch.full((q.shape[0], v.shape[1]), float("nan")))
            ms.append(torch.full((q.shape[0],), float("-inf")))
            ls.append(torch.zeros(q.shape[0]))
            continue
        s = (q @ k[lo:hi].T) * scale * LOG2E
        m = s.amax(dim=1)
        p = torch.exp2(s - m[:, None])
        accs.append(p @ v[lo:hi])
        ms.append(m)
        ls.append(p.sum(dim=1))
    return torch.stack(accs), torch.stack(ms), torch.stack(ls)


@pytest.mark.parametrize("kv_len,n_splits", [(1, 1), (3, 9), (17, 9), (144, 9), (464, 9),
                                             (253, 5), (40, 16), (0, 4)])
def test_merge_of_plain_partials_is_the_plain_attention(kv_len, n_splits):
    """One decode row (GQA 6:1 over one kv head's pages, int8 KV at 0.05)
    through the plain version, and the same row as split partials merged."""
    rng = np.random.default_rng(kv_len + 100 * n_splits)
    R, D, bs, scale = 6, 64, 16, 0.05
    mb = max(1, -(-kv_len // bs))
    pages = np.clip(np.round(rng.standard_normal((mb + 1, bs, 2, D)) / scale),
                    -127, 127).astype(np.int8)
    tables = rng.permutation(np.arange(1, mb + 1))[None].astype(np.int32)
    q = torch.from_numpy(rng.standard_normal((1, R, D)).astype(np.float32))
    i32 = lambda a: torch.from_numpy(np.asarray(a, np.int32))
    ref = mha_decode_attention_plain(q, torch.from_numpy(pages), i32([kv_len]),
                                     torch.from_numpy(tables), i32([1]), D ** -0.5, scale)[0]
    rows = torch.from_numpy(pages[tables[0]].reshape(-1, 2, D)[:kv_len]).float()
    ranges = [split_kv.split_range(kv_len, n_splits, i) for i in range(n_splits)]
    acc, m, l = _partials(q[0], rows[:, 0] * scale, rows[:, 1], D ** -0.5, ranges)
    got = split_kv.merge_partials(acc, m, l, v_scale=scale)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-5 * max(1.0, ref.abs().max().item()))


def _launches(monkeypatch):
    calls = []
    monkeypatch.setattr(build, "launch", lambda name, *args: calls.append((name, args)))
    return calls


@pytest.mark.parametrize("rows,H,KVH,kv_dtype,splits", [
    (8, 12, 2, torch.int8, 9), (8, 32, 32, torch.int8, 1), (2, 8, 1, torch.bfloat16, 16)])
def test_k1_form_and_splits_from_shapes(monkeypatch, rows, H, KVH, kv_dtype, splits):
    calls = _launches(monkeypatch)
    meta = dict(device="meta")
    i32 = dict(dtype=torch.int32, **meta)
    out = mha_decode_attention(
        torch.empty((rows, H, 128), dtype=torch.bfloat16, **meta),
        torch.empty((512, 16, 2 * KVH, 128), dtype=kv_dtype, **meta),
        torch.empty((rows,), **i32), torch.empty((rows, 32), **i32), torch.empty((1,), **i32),
        0.088, 0.05 if kv_dtype == torch.int8 else None)
    (name, args), = calls
    # (..., T, S, H, KVH, D, BS, MB, n_splits, ...)
    assert name == "mha_decode" and args[15] == splits
    assert out.shape == (rows, H, 128)


@pytest.mark.parametrize("max_q,S,splits", [(1, 32, 5), (1, 4, 16), (1, 200, 1), (16, 32, 1),
                                            (None, 32, 1)])
def test_k6_form_and_splits_from_shapes(monkeypatch, max_q, S, splits):
    calls = _launches(monkeypatch)
    meta = dict(device="meta")
    i32 = dict(dtype=torch.int32, **meta)
    T = S if max_q == 1 else 2048
    paged_attention_latent(torch.empty((T, 16, 576), dtype=torch.bfloat16, **meta),
                           torch.empty((1024, 16, 1, 576), dtype=torch.int8, **meta),
                           torch.empty((S,), **i32), torch.empty((S, 32), **i32),
                           torch.empty((S + 1,), **i32), torch.empty((1,), **i32),
                           192 ** -0.5, 0.05, max_q=max_q)
    (name, args), = calls
    # (..., T, S, H, D, BS, MB, n_splits, ...); scratch pointers only with splits
    assert name == "paged_attention_latent" and args[15] == splits
