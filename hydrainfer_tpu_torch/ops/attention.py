"""Paged causal attention over the block cache (port of
hydrainfer_tpu/ops/attention.py).

Cache layout, shared with the kernels:
  (n_layers, 1, n_blocks, block_size, 2*n_kv_heads, head_dim)
with K at even combined-head indices and V at odd; or, for MLA, the
single-plane latent cache (n_layers, 1, n_blocks, block_size, 1, head_dim)
whose one vector per token serves as both K and V. Tokens of all sequences
are flattened to one (T,) axis with each sequence's tokens contiguous; a batch
mixes prefill chunks and decode steps freely.

The dispatcher `paged_attention` sends every batch over a single-plane cache
to kernel K6 (ops/cuda/paged_attention_latent.py), all-decode windows
included, as the JAX chain does; over a combined-head cache, all-decode
batches (max_q == 1) go to kernel K1 (ops/cuda/mha_decode.py) and mixed or
prefill batches to kernel K2 (ops/cuda/paged_attention.py). Each takes its
plain PyTorch version for CPU tensors. `paged_attention_plain` is the port of
`paged_attention_jnp`, single-plane gather included. `paged_attention_tp`
runs the dispatcher on each tensor-parallel rank's heads and cache shard
(the decoder's attention, one rank or many).

`mha_varlen` is the ViT towers' segment-masked attention over the patches of
all images in a batch: kernel K5 (ops/cuda/mha_varlen.py) for CUDA tensors,
its plain version `mha_varlen_plain` for CPU tensors or when the scores are
asked for (the focal token-pruning form), as the JAX dispatcher does.
"""
import math
from dataclasses import dataclass, fields, is_dataclass, replace
from typing import List, Optional, Sequence, Tuple

import torch

from .cuda.mha_decode import mha_decode_attention
from .cuda.mha_varlen import mha_varlen_flash, mha_varlen_plain
from .cuda.paged_attention import dense_paged_attention, paged_attention_varlen
from .cuda.paged_attention_latent import paged_attention_latent


@dataclass(frozen=True)
class PagedAttentionParams:
    """Device-side batch geometry for one fill step.

    q_seq_ids:    (T,) int32  sequence index of each token; -1 = padding
    q_local_ids:  (T,) int32  token's index within its sequence's q chunk
    positions:    (T,) int32  rope position of each token
    kv_lens:      (S,) int32  kv length per sequence incl. this chunk; 0 = pad
    block_tables: (S, MB) int32 physical block ids; -1 = pad
    new_kv_slot_ids: (T,) int32 physical slot receiving each token's K/V; -1 = pad
    cu_q_lens:    (S+1,) int32 cumulative q-chunk lengths
    num_seqs:     (1,) int32 number of real sequences
    """
    q_seq_ids: torch.Tensor
    q_local_ids: torch.Tensor
    positions: torch.Tensor
    kv_lens: torch.Tensor
    block_tables: torch.Tensor
    new_kv_slot_ids: torch.Tensor
    cu_q_lens: torch.Tensor
    num_seqs: torch.Tensor

    @property
    def n_seqs(self) -> int:
        return self.kv_lens.shape[0]

    @property
    def n_tokens(self) -> int:
        return self.q_seq_ids.shape[0]

    def replace(self, **kw) -> "PagedAttentionParams":
        return replace(self, **kw)


def paged_attention_plain(q: torch.Tensor, cache: torch.Tensor, layer_id: int,
                          params: PagedAttentionParams, sm_scale: float,
                          max_q: int, kv_scale: Optional[float] = None) -> torch.Tensor:
    """Gather-dense reference implementation (q: (T, H, D) -> (T, H, D))."""
    q_lens = params.cu_q_lens[1:] - params.cu_q_lens[:-1]
    return dense_paged_attention(q, cache[layer_id, 0], params.kv_lens,
                                 params.block_tables, params.q_seq_ids,
                                 params.q_local_ids, q_lens, sm_scale, max_q,
                                 kv_scale)


def paged_attention(q: torch.Tensor, cache: torch.Tensor, layer_id: int,
                    params: PagedAttentionParams, sm_scale: float, max_q: int,
                    kv_scale: Optional[float] = None) -> torch.Tensor:
    """Dispatcher: a single-plane (MLA latent) cache to K6 for every batch;
    otherwise all-decode windows (max_q == 1, row i = sequence i) to K1 and
    mixed prefill/decode batches to K2."""
    pages = cache[layer_id, 0]
    tables = params.block_tables.clamp(min=0)
    if cache.shape[-2] == 1:
        return paged_attention_latent(q, pages, params.kv_lens, tables,
                                      params.cu_q_lens, params.num_seqs, sm_scale,
                                      kv_scale, max_q=max_q)
    if max_q == 1:
        return mha_decode_attention(q, pages, params.kv_lens, tables,
                                    params.num_seqs, sm_scale, kv_scale)
    return paged_attention_varlen(q, pages, params.kv_lens, tables,
                                  params.cu_q_lens, params.num_seqs, sm_scale,
                                  kv_scale, max_q=max_q)


def paged_attention_tp(qs: Sequence[torch.Tensor], caches: Sequence[torch.Tensor],
                       layer_id: int, params: Sequence[PagedAttentionParams],
                       sm_scale: float, max_q: int, kv_scale: Optional[float] = None
                       ) -> List[torch.Tensor]:
    """Tensor-parallel paged attention (port of the JAX paged_attention_tp):
    rank r runs `paged_attention` on its contiguous run of q heads, qs[r],
    against its own cache shard caches[r] (its K/V pairs whole, or a full
    copy of a latent plane), with the batch's params[r] on its device.
    Attention is independent per head, so nothing is summed: each output
    stays on its rank as the input of that rank's o_proj
    (models/decoder.py:_layer_attention), and their concatenation along the
    head axis is the JAX function's output."""
    return [paged_attention(q, cache, layer_id, p, sm_scale, max_q, kv_scale=kv_scale)
            for q, cache, p in zip(qs, caches, params)]


def params_to(params, device: torch.device):
    """A dataclass of tensors (PagedAttentionParams, a LanguageModelBatch)
    with every tensor on `device`; itself where they already are there."""
    moved = {}
    for f in fields(params):
        v = getattr(params, f.name)
        if isinstance(v, torch.Tensor) and v.device != device:
            moved[f.name] = v.to(device)
        elif is_dataclass(v):
            w = params_to(v, device)
            if w is not v:
                moved[f.name] = w
    return replace(params, **moved) if moved else params


def mha_varlen(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               seq_ids: torch.Tensor, sm_scale: Optional[float] = None,
               return_scores: bool = False
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Bidirectional attention within segments. q/k/v: (T, H, D) flat across
    images; seq_ids: (T,) int32 image index per patch (-1 = padding).
    Returns (out, the (H, T, T) probabilities if return_scores else None)."""
    if return_scores:
        return mha_varlen_plain(q, k, v, seq_ids, sm_scale, return_scores=True)
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    return mha_varlen_flash(q, k, v, seq_ids, scale), None
