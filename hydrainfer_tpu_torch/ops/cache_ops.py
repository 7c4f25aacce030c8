"""Paged-cache writes (port of hydrainfer_tpu/ops/cache_ops.py).

Caches are (n_layers, n_tensors, n_blocks, block_size, n_heads, head_dim).
Unlike the JAX functions, which return a new cache, the writes here update
the cache tensor IN PLACE and return it. A slot id is block * block_size +
offset; a negative slot marks padding, whose row is dropped (JAX maps it out
of range and scatters with mode="drop": a negative index would wrap).

The KV cache has n_tensors 1 and combined heads, K at even and V at odd; its
write goes through kernel K3, and an int8 cache takes kv_scale: rows are
quantized as clip(round(x / kv_scale), -127, 127) on the way in
(hydrainfer_tpu/models/decoder.py:_write_kv). The MLA latent cache has one
plane (n_heads 1) and is written through K3's single-plane form with the same
quantize (hydrainfer_tpu/models/decoder.py:_mla_layer). No write here
synchronises the host.
"""
from typing import Optional

import torch

from .cuda.kv_writer import scatter_rows, write_kv_pages


def write_kv_cache(cache: torch.Tensor, layer_id: int, slot_ids: torch.Tensor,
                   k: torch.Tensor, v: torch.Tensor,
                   kv_scale: Optional[float] = None) -> torch.Tensor:
    """k, v: (n_tokens, n_kv_heads, head_dim); slot_ids: (n_tokens,) int32
    physical slots (block * block_size + offset), negative = padding."""
    write_kv_pages(cache[layer_id, 0], k, v, slot_ids, kv_scale)
    return cache


def write_latent_cache(cache: torch.Tensor, layer_id: int, slot_ids: torch.Tensor,
                       kv_vec: torch.Tensor,
                       kv_scale: Optional[float] = None) -> torch.Tensor:
    """kv_vec: (n_tokens, 1, kv_lora + rope) latent rows into the single-plane
    cache (n_layers, 1, n_blocks, block_size, 1, kv_lora + rope)."""
    write_kv_pages(cache[layer_id, 0], kv_vec, None, slot_ids, kv_scale)
    return cache


def write_token_cache(cache: torch.Tensor, layer_id: int, slot_ids: torch.Tensor,
                      values: torch.Tensor) -> torch.Tensor:
    """Scatter per-token rows (n_tokens, n_heads, head_dim) into tensor 0 of
    one layer (the image cache's single tensor), cast to the cache's dtype."""
    flat = cache[layer_id, 0].view(-1, cache.shape[-2], cache.shape[-1])
    scatter_rows(flat, slot_ids, values.to(cache.dtype))
    return cache
