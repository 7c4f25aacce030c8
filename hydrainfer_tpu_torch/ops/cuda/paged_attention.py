"""K2: ragged mixed prefill + decode paged attention (csrc/paged_attention.cu).

Replaces hydrainfer_tpu/ops/pallas/paged_attention.py:layered_paged_attention
(CKV-even form): token t of sequence s sits at cache position
kv_len - q_len + (t - cu_q_lens[s]) and attends causally to the sequence's
pages. Bound on H100: bytes at the serving paths' shapes, and in practice
the latency of a block's few kv tiles. bf16 queries over an int8 or bf16
cache take the tensor-core form: 64 (token, query head) rows of one kv head
a block, Q.K^T and P.V on mma.sync, K/V tiles of 64 rows staged by cp.async
in two stages, ahead of their use. f32 queries and an f32 cache take a
scalar FMA form. This module also holds the dense gather-and-mask attention
that is the plain version of K1 and K2 and of
ops/attention.py:paged_attention_plain.
"""
from typing import Optional

import torch

from . import build

NEG_INF = -0.7 * torch.finfo(torch.float32).max


def dense_paged_attention(q: torch.Tensor, pages: torch.Tensor,
                          kv_lens: torch.Tensor, block_tables: torch.Tensor,
                          q_seq_ids: torch.Tensor, q_local_ids: torch.Tensor,
                          q_lens: torch.Tensor, sm_scale: float, max_q: int,
                          kv_scale: Optional[float] = None) -> torch.Tensor:
    """Gather-dense masked attention (the port of
    hydrainfer_tpu/ops/attention.py:paged_attention_jnp, dense form).

    q: (T, H, D); pages: (NB, BS, 2*KVH, D), or (NB, BS, 1, D) for the
    single-plane latent cache, whose one vector per token is both K and V;
    block_tables: (S, MB), -1 padded; q_seq_ids/q_local_ids: (T,) with -1
    seq = padding; q_lens: (S,).
    """
    T, H, D = q.shape
    S, MB = block_tables.shape
    pg = pages[block_tables.clamp(min=0).long()]          # (S, MB, BS, CKV, D)
    if pages.shape[-2] == 1:
        kvh = 1
        k = v = pg.reshape(S, -1, 1, D)
    else:
        kvh = pages.shape[-2] // 2
        k = pg[..., 0::2, :].reshape(S, -1, kvh, D)
        v = pg[..., 1::2, :].reshape(S, -1, kvh, D)
    if kv_scale is not None:
        k = (k.float() * kv_scale).to(q.dtype)
        v = (v.float() * kv_scale).to(q.dtype)
    max_kv = k.shape[1]
    k = k.repeat_interleave(H // kvh, dim=2)                # (S, max_kv, H, D)
    v = v.repeat_interleave(H // kvh, dim=2)

    # flat q -> (S, max_q) per-sequence layout; padding rows land in row S
    seq_ids = torch.where(q_seq_ids < 0, S, q_seq_ids).long()
    local = q_local_ids.long()
    q_pad = torch.zeros((S + 1, max_q, H, D), dtype=q.dtype, device=q.device)
    q_pad[seq_ids, local] = q
    # causal masking over CACHE positions (kv_len - q_len + local id)
    cache_pos = (kv_lens - q_lens)[q_seq_ids.clamp(min=0).long()] + q_local_ids
    pos_pad = torch.zeros((S + 1, max_q), dtype=torch.int32, device=q.device)
    pos_pad[seq_ids, local] = cache_pos.to(torch.int32)
    q_pad, pos_pad = q_pad[:S], pos_pad[:S]

    scores = torch.einsum("sqhd,skhd->shqk", q_pad.float() * sm_scale, k.float())
    kv_idx = torch.arange(max_kv, device=q.device, dtype=torch.int32)
    causal = kv_idx[None, None, :] <= pos_pad[:, :, None]
    valid = kv_idx[None, None, :] < kv_lens[:, None, None]
    mask = (causal & valid)[:, None]                       # (S, 1, max_q, max_kv)
    scores = torch.where(mask, scores, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores - torch.clamp(m, min=NEG_INF / 2))
    e = torch.where(mask, e, 0.0)
    p = e / torch.clamp(e.sum(dim=-1, keepdim=True), min=1e-30)
    out_pad = torch.einsum("shqk,skhd->sqhd", p, v.float())
    out = out_pad[seq_ids.clamp(max=S - 1), local]
    return out.to(q.dtype)


def _varlen_geometry(T: int, cu_q_lens: torch.Tensor, num_seqs: torch.Tensor):
    """Per-token (seq id, local id, valid) from cu_q_lens and num_seqs."""
    S = cu_q_lens.shape[0] - 1
    t = torch.arange(T, device=cu_q_lens.device, dtype=torch.int64)
    cu = cu_q_lens.long()
    total = cu.gather(0, num_seqs.long().reshape(1))
    seq = torch.searchsorted(cu[1:].contiguous(), t, right=True)
    valid = (t < total) & (seq < S)
    seq = seq.clamp(max=S - 1)
    local = t - cu[seq]
    return (torch.where(valid, seq, -1).to(torch.int32),
            torch.where(valid, local, 0).to(torch.int32), valid)


def paged_attention_varlen_plain(q, kv_pages, kv_lens, page_indices, cu_q_lens,
                                 num_seqs, sm_scale: float,
                                 kv_scale: Optional[float] = None,
                                 max_q: Optional[int] = None) -> torch.Tensor:
    """The plain version of K2: the dense attention over the same inputs, with
    rows past cu_q_lens[num_seqs] zeroed as the kernel leaves them."""
    seq_ids, local, valid = _varlen_geometry(q.shape[0], cu_q_lens, num_seqs)
    q_lens = cu_q_lens[1:] - cu_q_lens[:-1]
    if max_q is None:
        max_q = max(int(q_lens.max()), 1)
    out = dense_paged_attention(q, kv_pages, kv_lens, page_indices, seq_ids, local,
                                q_lens, sm_scale, max_q, kv_scale)
    return torch.where(valid[:, None, None], out, torch.zeros((), dtype=out.dtype,
                                                              device=out.device))


def paged_attention_varlen(q: torch.Tensor, kv_pages: torch.Tensor,
                           kv_lens: torch.Tensor, page_indices: torch.Tensor,
                           cu_q_lens: torch.Tensor, num_seqs: torch.Tensor,
                           sm_scale: float, kv_scale: Optional[float] = None,
                           max_q: Optional[int] = None) -> torch.Tensor:
    """Mixed prefill/decode paged attention.

    q: (T, Hq, D) f32/bf16; kv_pages: (NB, BS, 2*KVH, D) f32/bf16/int8;
    kv_lens: (S,) i32; page_indices: (S, MB) i32 (>= 0); cu_q_lens: (S+1,) i32;
    num_seqs: (1,) i32 -> (T, Hq, D). max_q bounds the plain version's
    per-sequence padding (the kernel does not need it). bf16 queries over an
    int8 or bf16 cache need D a multiple of 16 up to 128.
    """
    if q.device.type == "cpu":
        return paged_attention_varlen_plain(q, kv_pages, kv_lens, page_indices,
                                            cu_q_lens, num_seqs, sm_scale,
                                            kv_scale, max_q)
    T, H, D = q.shape
    nb, bs, ckv, d2 = kv_pages.shape
    S, mb = page_indices.shape
    if d2 != D or ckv % 2 or H % (ckv // 2) or kv_lens.shape != (S,) \
            or cu_q_lens.shape != (S + 1,) or num_seqs.shape != (1,):
        raise ValueError("paged_attention_varlen: inconsistent shapes")
    if H // (ckv // 2) > 64:
        raise ValueError("query heads per kv head above 64 are not supported")
    for t in (kv_lens, page_indices, cu_q_lens, num_seqs):
        if t.dtype != torch.int32:
            raise TypeError("geometry tensors must be int32")
    build.check_cuda(q, kv_pages, kv_lens, page_indices, cu_q_lens, num_seqs)
    q_code = build.dtype_code(q, (torch.float32, torch.bfloat16))
    kv_code = build.dtype_code(kv_pages, (torch.float32, torch.bfloat16, torch.int8))
    tensor_cores = q.dtype == torch.bfloat16 and kv_pages.dtype != torch.float32
    if tensor_cores and (D % 16 or D > 128):
        raise ValueError(f"head_dim {D} not supported for bf16 queries over an "
                         f"{kv_pages.dtype} cache (a multiple of 16 up to 128)")
    # the tensor-core form writes every row, padding included; the FMA form
    # leaves rows past the last sequence as it finds them
    out = torch.empty_like(q) if tensor_cores else torch.zeros_like(q)
    scale = float(kv_scale) if kv_scale is not None else 1.0
    build.launch("paged_attention", q.data_ptr(), kv_pages.data_ptr(),
                 kv_lens.data_ptr(), page_indices.data_ptr(), cu_q_lens.data_ptr(),
                 num_seqs.data_ptr(), out.data_ptr(), T, S, H, ckv // 2, D, bs, mb,
                 float(sm_scale), scale, scale, q_code, kv_code)
    paged_attention_varlen.launches += 1
    return out


paged_attention_varlen.launches = 0
