"""How tight the card tests' bound on the bf16 attention kernels is, on the CPU.

tests/test_torch_kernels_cuda.py holds the bf16 forms of K1 (decode
attention), K2 (mixed paged attention), K5 (segment-masked varlen attention)
and K6 (latent attention) within 2e-2 x max|plain| of their plain versions
run in f32 on the same bf16 inputs. Here, with the plain versions only: the
same computation with bf16 K/V, scores' inputs and output (the rounding a
bf16 kernel adds) stays inside that bound, and a reference that misses one kv
tile, or one split of a split-KV decode, of one sequence falls outside it.
So the card tests would catch a kernel that skips a tile or a split.
"""
import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)
import numpy as np
import pytest
import torch

from hydrainfer_tpu_torch.ops.cuda import split_kv
from hydrainfer_tpu_torch.ops.cuda.mha_decode import mha_decode_attention_plain
from hydrainfer_tpu_torch.ops.cuda.mha_varlen import mha_varlen_plain
from hydrainfer_tpu_torch.ops.cuda.paged_attention import paged_attention_varlen_plain
from tests.test_torch_kernels_cuda import (K1_SPECS, K2_SPECS, K6_DECODE, K6_MIXED, SCALE,
                                           poisoned_case, vit_case)


@pytest.mark.parametrize("H,KVH,D,kv_dtype", [(12, 2, 128, torch.int8),
                                              (4, 2, 64, torch.bfloat16)],
                         ids=["gqa6_int8", "gqa2_bf16"])
def test_k2_bound_catches_a_missing_tile(H, KVH, D, kv_dtype):
    q, _, clean, kv_lens, tables, cu, ns = poisoned_case(K2_SPECS, H, D, 16, kv_dtype,
                                                         seed=9, planes=2 * KVH)
    scale = SCALE if kv_dtype == torch.int8 else None
    pages = clean if kv_dtype == torch.int8 else clean.float()
    qb = q.to(torch.bfloat16)
    ref = paged_attention_varlen_plain(qb.float(), pages, kv_lens, tables, cu, ns,
                                       D ** -0.5, scale)
    n = int(cu[-1])
    bound = 2e-2 * ref[:n].abs().max().item()
    rounded = paged_attention_varlen_plain(qb, clean, kv_lens, tables, cu, ns, D ** -0.5,
                                           scale)
    assert (rounded[:n].float() - ref[:n]).abs().max().item() <= bound
    # the decode row over kv 300 (sequence 3) without its cache rows 64..127
    s, drop = 3, 64 // 16
    t = tables.clone()
    t[s, drop:-drop] = tables[s, 2 * drop:]
    kl = kv_lens.clone()
    kl[s] -= 64
    miss = paged_attention_varlen_plain(qb.float(), pages, kl, t, cu, ns, D ** -0.5, scale)
    row = int(cu[s])
    assert (miss[row] - ref[row]).abs().max().item() > bound


@pytest.mark.parametrize("segments,H,D", [([700, 130, 60], 2, 64), ([256, 64, 144], 16, 80)],
                         ids=["long_segments", "qwen2vl_heads"])
def test_k5_bound_catches_a_missing_tile(segments, H, D):
    qkv, ids = vit_case(segments, 0, H, D, seed=10)
    x = torch.from_numpy(qkv).to(torch.bfloat16)
    i = torch.from_numpy(ids)
    ref = mha_varlen_plain(*(x[:, j].float() for j in range(3)), i, D ** -0.5)[0]
    bound = 2e-2 * ref.abs().max().item()
    rounded = mha_varlen_plain(*(x[:, j] for j in range(3)), i, D ** -0.5)[0]
    assert (rounded.float() - ref).abs().max().item() <= bound
    # the first image's kv rows 64..127 unseen
    kv_ids = i.clone()
    kv_ids[64:128] = -1
    miss = mha_varlen_plain(*(x[:, j].float() for j in range(3)), i, D ** -0.5,
                            kv_seq_ids=kv_ids)[0]
    first = slice(0, segments[0])
    assert (miss[first] - ref[first]).abs().max().item() > bound


def _drop_pages(tables, kv_lens, s, first, n):
    """Sequence s's block table and kv_len without its pages first..first+n-1
    (the rows a kernel would skip if it lost that piece)."""
    t, kl = tables.clone(), kv_lens.clone()
    t[s, first:-n] = tables[s, first + n:]
    kl[s] -= n * 16
    return t, kl


def test_k1_bound_catches_a_missing_split():
    """K1's tensor-core case at qwen2-vl-2b-lm's heads (test_k1_tensor_cores):
    the bf16 rounding stays inside the card tests' bound, and the kv-464 row
    without one split's rows (whole pages covering ceil(464 / n) rows) falls
    outside it."""
    H, KVH, D = 12, 2, 128
    q, _, clean, kv_lens, tables, _, ns = poisoned_case(K1_SPECS, H, D, 16, torch.int8,
                                                        seed=13, planes=2 * KVH, nan_q=True)
    q = torch.nan_to_num(q.to(torch.bfloat16).float())
    ref = mha_decode_attention_plain(q, clean, kv_lens, tables, ns, D ** -0.5, SCALE)
    n = len(K1_SPECS)
    bound = 2e-2 * ref[:n].abs().max().item()
    rounded = mha_decode_attention_plain(q.to(torch.bfloat16), clean, kv_lens, tables, ns,
                                         D ** -0.5, SCALE)
    assert (rounded[:n].float() - ref[:n]).abs().max().item() <= bound
    s = [kv for _, kv in K1_SPECS].index(464)
    n_splits = split_kv.num_splits(q.shape[0] * KVH, tables.shape[1] * 16)
    chunk = -(-464 // n_splits)
    t, kl = _drop_pages(tables, kv_lens, s, 1, -(-chunk // 16))
    miss = mha_decode_attention_plain(q, clean, kl, t, ns, D ** -0.5, SCALE)
    assert (miss[s] - ref[s]).abs().max().item() > bound


@pytest.mark.parametrize("form", ["mixed", "decode"])
def test_k6_bound_catches_a_missing_tile(form):
    """K6's edge cases (test_k6_tile_and_split_edges, 16 heads x 576, int8):
    the bf16 rounding stays inside the bound, and a decode row without one
    32-row kv tile (mixed: the kv-300 decode) or one split (decode: kv 353 of
    11 splits) falls outside it."""
    specs = K6_MIXED if form == "mixed" else K6_DECODE
    q, _, clean, kv_lens, tables, cu, ns = poisoned_case(specs, 16, 576, 16, torch.int8,
                                                         seed=12, nan_q=True)
    q = torch.nan_to_num(q.to(torch.bfloat16).float())
    sm = 192 ** -0.5
    ref = paged_attention_varlen_plain(q, clean, kv_lens, tables, cu, ns, sm, SCALE)
    n = int(cu[-1])
    bound = 2e-2 * ref[:n].abs().max().item()
    rounded = paged_attention_varlen_plain(q.to(torch.bfloat16), clean, kv_lens, tables, cu,
                                           ns, sm, SCALE)
    assert (rounded[:n].float() - ref[:n]).abs().max().item() <= bound
    kv = 300 if form == "mixed" else 353
    s = [k for _, k in specs].index(kv)
    rows = 32 if form == "mixed" else -(-kv // split_kv.num_splits(len(specs) + 1,
                                                                    tables.shape[1] * 16))
    t, kl = _drop_pages(tables, kv_lens, s, 1, -(-rows // 16))
    miss = paged_attention_varlen_plain(q, clean, kl, t, cu, ns, sm, SCALE)
    row = int(cu[s])
    assert (miss[row] - ref[row]).abs().max().item() > bound


@pytest.mark.parametrize("mode,layer_mb,step_gb", [("int8", 202.545, 6.613),
                                                   ("int4", 107.512, 3.572),
                                                   ("fp8", 202.545, 6.613)])
def test_k4_byte_bound_counts_the_stored_bytes(mode, layer_mb, step_gb):
    """K4's byte bound at llava-7b-lm counts each weight as stored: int4
    packed two a byte plus its f32 group scales (g = 128: K / 128 rows), int8
    and fp8 a byte plus a column scale; the lm_head int8 in int4 mode. One
    layer's four projections, and a whole decode step's weights (32 layers
    and the lm_head), over 3.35 TB/s: 1.07 ms at int4 against 1.97 at int8."""
    from hydrainfer_tpu_torch.models.random_init import (ARCH_CONFIGS, quant_matmul_forms,
                                                         quant_weight_bytes)
    cfg = ARCH_CONFIGS["llava-7b-lm"]
    forms = quant_matmul_forms(cfg, mode)
    nbytes = {name: quant_weight_bytes(*f) for name, f in forms.items()}
    layer = sum(v for k, v in nbytes.items() if k != "lm_head")
    assert layer / 1e6 == pytest.approx(layer_mb, abs=0.001)
    assert nbytes["lm_head"] == 4096 * 32064 + 4 * 32064
    if mode == "int4":
        assert {f[3] for k, f in forms.items() if k != "lm_head"} == {128}
        # the packed values and the scales
        assert layer == 202_375_168 // 2 + 4 * (32 * (12288 + 4096 + 22016) + 86 * 4096)
    step = cfg.n_layers * layer + nbytes["lm_head"]
    assert step / 1e9 == pytest.approx(step_gb, abs=0.001)
    assert 1e3 * step / 3.35e12 == pytest.approx({"int4": 1.07}.get(mode, 1.97), abs=0.01)
