"""K1: decode paged attention, one query per sequence (csrc/mha_decode.cu).

Replaces hydrainfer_tpu/ops/pallas/mha_decode.py:mha_decode_attention: row i
of q is sequence i's single query token; it attends over the sequence's
kv_len cached tokens through the block table, with an int8 cache dequantized
by one static scale. MHA and uniform GQA (up to 8 query heads per kv head),
head_dim 32/64/128/256, heads in natural order. Bound on H100: bytes (each
sequence's pages are read once for all of its heads), in practice latency.
bf16 queries over an int8 or bf16 cache take the tensor-core form, split-KV
over (sequence, kv head, split) with the split count from shapes alone
(split_kv.num_splits); f32 queries or an f32 cache the scalar form.
"""
from typing import Optional

import torch

from . import build, split_kv
from .paged_attention import dense_paged_attention


def mha_decode_attention_plain(q, kv_pages, kv_lens, page_indices, num_seqs,
                               sm_scale: float,
                               kv_scale: Optional[float] = None) -> torch.Tensor:
    """The plain version: the dense attention with one query per sequence;
    rows at or past num_seqs come out as zeros, as the kernel writes them."""
    T = q.shape[0]
    S = kv_lens.shape[0]
    rows = torch.arange(T, device=q.device, dtype=torch.int32)
    live = (rows < num_seqs.to(torch.int32)) & (rows < S)
    seq_ids = torch.where(live, rows, -1)
    out = dense_paged_attention(q, kv_pages, kv_lens, page_indices, seq_ids,
                                torch.zeros_like(rows),
                                torch.ones_like(kv_lens), sm_scale, 1, kv_scale)
    return torch.where(live[:, None, None], out,
                       torch.zeros((), dtype=out.dtype, device=out.device))


def mha_decode_attention(q: torch.Tensor, kv_pages: torch.Tensor,
                         kv_lens: torch.Tensor, page_indices: torch.Tensor,
                         num_seqs: torch.Tensor, sm_scale: float,
                         kv_scale: Optional[float] = None) -> torch.Tensor:
    """q: (T, Hq, D) f32/bf16, row i = sequence i; kv_pages: (NB, BS, 2*KVH, D)
    f32/bf16/int8; kv_lens: (S,) i32; page_indices: (S, MB) i32 (>= 0);
    num_seqs: (1,) i32 -> (T, Hq, D)."""
    if q.device.type == "cpu":
        return mha_decode_attention_plain(q, kv_pages, kv_lens, page_indices,
                                          num_seqs, sm_scale, kv_scale)
    T, H, D = q.shape
    nb, bs, ckv, d2 = kv_pages.shape
    S, mb = page_indices.shape
    kvh = ckv // 2
    if d2 != D or ckv % 2 or H % kvh or kv_lens.shape != (S,) \
            or num_seqs.shape != (1,):
        raise ValueError("mha_decode_attention: inconsistent shapes")
    if H // kvh > 8 or D not in (32, 64, 128, 256):
        raise ValueError(f"unsupported decode shape: {H} q heads / {kvh} kv "
                         f"heads, head_dim {D}")
    for t in (kv_lens, page_indices, num_seqs):
        if t.dtype != torch.int32:
            raise TypeError("geometry tensors must be int32")
    build.check_cuda(q, kv_pages, kv_lens, page_indices, num_seqs)
    q_code = build.dtype_code(q, (torch.float32, torch.bfloat16))
    kv_code = build.dtype_code(kv_pages, (torch.float32, torch.bfloat16, torch.int8))
    # the form from the dtypes, the split count from shapes
    tensor_cores = q.dtype == torch.bfloat16 and kv_pages.dtype != torch.float32
    n_splits = split_kv.num_splits(T * kvh, mb * bs) if tensor_cores else 1
    out = torch.empty_like(q)
    part_acc, part_ml = split_kv.partials(n_splits, T, H, D, q.device)
    scale = float(kv_scale) if kv_scale is not None else 1.0
    build.launch("mha_decode", q.data_ptr(), kv_pages.data_ptr(), kv_lens.data_ptr(),
                 page_indices.data_ptr(), num_seqs.data_ptr(), out.data_ptr(),
                 build.ptr(part_acc), build.ptr(part_ml), T, S, H, kvh, D, bs, mb, n_splits,
                 float(sm_scale), scale, scale, q_code, kv_code)
    mha_decode_attention.launches += 1
    return out


mha_decode_attention.launches = 0
