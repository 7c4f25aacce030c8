"""K6: latent (MLA) paged attention over a single-plane cache
(csrc/paged_attention_latent.cu).

Replaces hydrainfer_tpu/ops/pallas/paged_attention.py:layered_paged_attention
in its CKV = 1 form: each cached row is one [c_kv | k_pe] vector serving as
both K and V, so it is an MQA of all query heads over one plane (D = 576 for
mla-2b-lm). Token t of sequence s sits at cache position
kv_len - q_len + (t - cu_q_lens[s]) and attends causally to the sequence's
pages; an int8 plane is dequantized with one static scale for both roles.
Bound on H100: bytes (a mixed batch's queries and outputs; a decode window's
plane), in practice latency at decode. bf16 queries take the tensor-core
forms: 64 query rows a block for a batch with prefill chunks, split-KV over
(sequence, split) for an all-decode window (max_q == 1), the split count
from shapes alone (split_kv.num_splits). The plain version is K2's
`paged_attention_varlen_plain`, whose dense gather-and-mask attention takes
a single-plane pool as K = V = the plane.
"""
from typing import Optional

import torch

from . import build, split_kv
from .paged_attention import paged_attention_varlen_plain

# head dim of the bf16 (tensor-core) forms, mla-2b-lm's kv_lora + rope: the
# warps split it into whole 16-column k-steps; f32 queries take any D
BF16_HEAD_DIM = 576


def paged_attention_latent(q: torch.Tensor, pages: torch.Tensor, kv_lens: torch.Tensor,
                           page_indices: torch.Tensor, cu_q_lens: torch.Tensor,
                           num_seqs: torch.Tensor, sm_scale: float,
                           kv_scale: Optional[float] = None,
                           max_q: Optional[int] = None) -> torch.Tensor:
    """Mixed prefill/decode attention over a single-plane latent cache.

    q: (T, Hq, D) f32/bf16; pages: (NB, BS, 1, D) f32/bf16/int8 (a bf16 q
    takes bf16 or int8 pages; at D other than BF16_HEAD_DIM it runs the f32
    form); kv_lens: (S,) i32;
    page_indices: (S, MB) i32 (>= 0); cu_q_lens: (S+1,) i32; num_seqs: (1,)
    i32 -> (T, Hq, D), zeros past cu_q_lens[num_seqs]. Hq divides 16. max_q
    bounds every sequence's query tokens (the plain version's padding); the
    kernel takes its split-KV decode form for max_q == 1.
    """
    if q.device.type == "cpu":
        return paged_attention_varlen_plain(q, pages, kv_lens, page_indices, cu_q_lens,
                                            num_seqs, sm_scale, kv_scale, max_q)
    if q.dtype == torch.bfloat16 and q.shape[-1] != BF16_HEAD_DIM:
        # the tensor-core forms are built for D = 576; another latent width
        # (a tiny checkpoint's) takes the f32 form over the same bf16 or int8
        # plane, one launch, its output rounded back to bf16
        return paged_attention_latent(q.float(), pages, kv_lens, page_indices, cu_q_lens,
                                      num_seqs, sm_scale, kv_scale,
                                      max_q).to(torch.bfloat16)
    T, H, D = q.shape
    nb, bs, planes, d2 = pages.shape
    S, mb = page_indices.shape
    if planes != 1 or d2 != D or kv_lens.shape != (S,) \
            or cu_q_lens.shape != (S + 1,) or num_seqs.shape != (1,):
        raise ValueError(f"paged_attention_latent: inconsistent shapes q {tuple(q.shape)}, "
                         f"pages {tuple(pages.shape)}, tables {tuple(page_indices.shape)}")
    if H > 16 or 16 % H:
        raise ValueError(f"{H} query heads: must divide 16")
    for t in (kv_lens, page_indices, cu_q_lens, num_seqs):
        if t.dtype != torch.int32:
            raise TypeError("geometry tensors must be int32")
    if (kv_scale is not None) != (pages.dtype == torch.int8):
        raise ValueError("an int8 plane needs kv_scale, and kv_scale an int8 plane")
    build.check_cuda(q, pages, kv_lens, page_indices, cu_q_lens, num_seqs)
    q_code = build.dtype_code(q, (torch.float32, torch.bfloat16))
    if q.dtype == torch.bfloat16:
        kv_code = build.dtype_code(pages, (torch.bfloat16, torch.int8))
        if pages.data_ptr() % 16:
            raise ValueError("bf16 path: pages not 16-byte aligned")
    else:
        kv_code = build.dtype_code(pages, (torch.float32, torch.bfloat16, torch.int8))
    # one block a sequence before the split: the form and the split count
    # come from shapes and max_q, never from kv_lens
    n_splits = (split_kv.num_splits(S, mb * bs)
                if q.dtype == torch.bfloat16 and max_q == 1 else 1)
    out = torch.empty_like(q)
    part_acc, part_ml = split_kv.partials(n_splits, T, H, D, q.device)
    build.launch("paged_attention_latent", q.data_ptr(), pages.data_ptr(),
                 kv_lens.data_ptr(), page_indices.data_ptr(), cu_q_lens.data_ptr(),
                 num_seqs.data_ptr(), out.data_ptr(), build.ptr(part_acc),
                 build.ptr(part_ml), T, S, H, D, bs, mb, n_splits, float(sm_scale),
                 float(kv_scale if kv_scale is not None else 1.0), q_code, kv_code)
    paged_attention_latent.launches += 1
    return out


paged_attention_latent.launches = 0
