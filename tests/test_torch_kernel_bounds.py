"""How tight the card tests' bound on the bf16 attention kernels is, on the CPU.

tests/test_torch_kernels_cuda.py holds the bf16 forms of K2 (mixed paged
attention) and K5 (segment-masked varlen attention) within 2e-2 x max|plain|
of their plain versions run in f32 on the same bf16 inputs. Here, with the
plain versions only: the same computation with bf16 K/V, scores' inputs and
output (the rounding a bf16 kernel adds) stays inside that bound, and a
reference that misses one 64-row kv tile of one sequence falls outside it.
So the card tests would catch a kernel that skips a tile.
"""
import numpy as np
import pytest
import torch

from hydrainfer_tpu_torch.ops.cuda.mha_varlen import mha_varlen_plain
from hydrainfer_tpu_torch.ops.cuda.paged_attention import paged_attention_varlen_plain
from tests.test_torch_kernels_cuda import K2_SPECS, SCALE, poisoned_case, vit_case


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
