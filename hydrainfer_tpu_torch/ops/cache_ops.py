"""Paged-cache writes (port of hydrainfer_tpu/ops/cache_ops.py).

Caches are (n_layers, n_tensors, n_blocks, block_size, n_heads, head_dim).
Unlike the JAX functions, which return a new cache, the writes here update
the cache tensor IN PLACE and return it. A slot id is block * block_size +
offset; a negative slot marks padding, whose row is dropped (JAX maps it out
of range and scatters with mode="drop": a negative index would wrap).

The KV cache has n_tensors 1 and combined heads, K at even and V at odd; its
write goes through kernel K3, and an int8 cache takes kv_scale: rows are
quantized as clip(round(x / kv_scale), -127, 127) on the way in
(hydrainfer_tpu/models/decoder.py:_write_kv).
"""
from typing import Optional

import torch

from .cuda.kv_writer import write_kv_pages


def write_kv_cache(cache: torch.Tensor, layer_id: int, slot_ids: torch.Tensor,
                   k: torch.Tensor, v: torch.Tensor,
                   kv_scale: Optional[float] = None) -> torch.Tensor:
    """k, v: (n_tokens, n_kv_heads, head_dim); slot_ids: (n_tokens,) int32
    physical slots (block * block_size + offset), negative = padding."""
    write_kv_pages(cache[layer_id, 0], k, v, slot_ids, kv_scale)
    return cache


def write_token_cache(cache: torch.Tensor, layer_id: int, slot_ids: torch.Tensor,
                      values: torch.Tensor) -> torch.Tensor:
    """Scatter per-token rows (n_tokens, n_heads, head_dim) into tensor 0 of
    one layer (the image cache's single tensor), cast to the cache's dtype."""
    flat = cache[layer_id, 0].view(-1, cache.shape[-2], cache.shape[-1])
    keep = torch.nonzero(slot_ids >= 0).squeeze(1)
    flat.index_copy_(0, slot_ids[keep].long(), values[keep].to(cache.dtype))
    return cache
