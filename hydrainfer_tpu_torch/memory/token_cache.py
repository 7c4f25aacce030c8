"""Paged token-cache block manager over one torch tensor (port of
hydrainfer_tpu/memory/token_cache.py:TokenCacheBlockManager).

Storage is a single device tensor
(n_layers, n_tensors, n_blocks, block_size, n_heads, head_dim) that the model
step updates IN PLACE; for the KV cache n_tensors is 1 and the head axis holds
the combined heads (K even, V odd), the layout the attention kernels read.
Host-side metadata (block tables, allocator, prefix cache) is plain Python.

Migration between nodes moves whole blocks: `gather_blocks` packs a request's
blocks into one (n, layers, tensors, block, heads, dim) payload and the
destination's `scatter_blocks` writes it into its own blocks, cast to its
cache's dtype. Both are queued on the current stream, so on one card a copy
is ordered after the source's earlier writes and before the destination's
later reads, with no event.

A tensor- or pipeline-parallel node's cache (`shards`, a list of
parallel/mesh.py:CacheShard) is a list of tensors over the same blocks, one
a shard: a tensor-parallel rank's holds its run of the head axis (whole K/V
pairs; a latent plane is copied on every rank), a pipeline stage's its run
of the layer axis, a rank of a stage both. The payload keeps the
single-device layout either way: a gather puts the shards' heads and layer
runs together on the first shard's device (each head from the first rank
that holds it), a scatter gives every shard its runs. So blocks move between
nodes of any two TP or PP degrees.
"""
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..parallel.mesh import merge_kv_shards, shard_kv_cache
from ..utils.counter import IncreasingAllocator
from ..utils.device import resolve_device
from .block_allocator import BlockAllocator, BlockAllocatorMetrics
from .shared_cache import SharedCache, SharedCacheConfig

_DTYPES = {"bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
           "fp16": torch.float16, "float16": torch.float16,
           "fp32": torch.float32, "float32": torch.float32, "int8": torch.int8}


def str2dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


@dataclass
class TokenCacheBlockManagerConfig:
    n_layers: int = 32
    n_tensors: int = 1
    n_blocks: int = 1024
    block_size: int = 16
    n_heads: int = 64
    head_dim: int = 128
    dtype: str = "bf16"

    @property
    def block_nbytes(self) -> int:
        return (self.n_layers * self.n_tensors * self.block_size * self.n_heads
                * self.head_dim * torch.empty((), dtype=str2dtype(self.dtype)).element_size())


@dataclass
class VirtualTokenCache:
    """A request's cache handle: a virtual id plus the block table mapping
    virtual block index -> physical block id."""
    vid: int
    n_cache_tokens: int = 0
    block_table: List[int] = field(default_factory=list)


@dataclass
class TokenCacheBlockManagerMetrics:
    allocator: BlockAllocatorMetrics
    prefix_cache_hit_rate: float


class TokenCacheBlockManager:
    def __init__(self, config: TokenCacheBlockManagerConfig, device=None,
                 node_name: str = "", shards=None):
        self.config = config
        self.block_size = config.block_size
        self.n_blocks = config.n_blocks
        self.node_name = node_name
        self.dtype = str2dtype(config.dtype)
        self.shards = shards
        self.device = resolve_device(shards[0][0] if shards else device)
        shape = (config.n_layers, config.n_tensors, config.n_blocks,
                 config.block_size, config.n_heads, config.head_dim)
        if shards:
            # one tensor a shard: its run of the layer axis and of the head axis
            self.cache_array = [
                torch.zeros((layers or shape[0],) + shape[1:-2] + (n, shape[-1]),
                            dtype=self.dtype, device=resolve_device(dev))
                for dev, _, n, _, layers in shards]
        else:
            self.cache_array = torch.zeros(shape, dtype=self.dtype, device=self.device)
        self.block_allocator = BlockAllocator(config.n_blocks)
        self.shared_cache = SharedCache(SharedCacheConfig(n_blocks=config.n_blocks))
        self._vid_allocator = IncreasingAllocator(start=1)
        self._n_blocks_queried = 0
        self._n_blocks_matched = 0

    # ---------------- allocation / virtual caches ----------------

    def n_available_blocks(self) -> int:
        return self.block_allocator.n_free + self.shared_cache.n_available()

    def _allocate_new_blocks(self, n: int) -> List[int]:
        block_ids = self.block_allocator.allocate(n)
        if len(block_ids) < n:
            # second chance: evict cold prefix-cache blocks
            block_ids += self.shared_cache.allocate(n - len(block_ids))
        assert len(block_ids) == n, "out of cache blocks"
        self.shared_cache.pin(block_ids)
        return block_ids

    def allocate_virtual_cache(self, hashes: Optional[Sequence[int]] = None
                               ) -> VirtualTokenCache:
        """New virtual cache, pre-populated with the longest prefix-cache hit."""
        matched: List[int] = []
        if hashes:
            for bid in self.shared_cache.match(hashes):
                if bid == -1:
                    break
                matched.append(bid)
            self.shared_cache.pin(matched)
            self._n_blocks_matched += len(matched)
            self._n_blocks_queried += len(hashes)
        return VirtualTokenCache(vid=self._vid_allocator.allocate(),
                                 n_cache_tokens=len(matched) * self.block_size,
                                 block_table=matched)

    def realloc(self, vc: VirtualTokenCache, n_tokens: int) -> None:
        """Grow or shrink a virtual cache to cover n_tokens."""
        n_need = -(-n_tokens // self.block_size)
        if n_need > len(vc.block_table):
            vc.block_table += self._allocate_new_blocks(n_need - len(vc.block_table))
        elif n_need < len(vc.block_table):
            self._release_blocks(vc.block_table[n_need:])
            vc.block_table = vc.block_table[:n_need]
        vc.n_cache_tokens = n_tokens

    def _release_blocks(self, block_ids: List[int]) -> None:
        # unpin only: released blocks stay matchable until evicted
        self.shared_cache.unpin(block_ids)

    # ---------------- address translation ----------------

    def v2p(self, vc: VirtualTokenCache, virtual_cache_ids: Sequence[int]) -> List[int]:
        """Virtual token position -> physical slot (= block_id*block_size+off)."""
        bs = self.block_size
        table = vc.block_table
        return [table[v // bs] * bs + v % bs for v in virtual_cache_ids]

    # ---------------- prefix-cache registration ----------------

    def set_blocks(self, vc: VirtualTokenCache, virtual_block_ids: Sequence[int],
                   hashes: Sequence[int]) -> None:
        """Register filled virtual blocks in the prefix cache."""
        assert len(virtual_block_ids) == len(hashes)
        physical = [vc.block_table[v] for v in virtual_block_ids]
        self.shared_cache.insert(hashes=hashes, block_ids=physical)

    # ---------------- migration data plane ----------------

    def _block_index(self, block_ids: Sequence[int], device=None) -> torch.Tensor:
        # from pageable host memory a non-blocking copy stages its source
        # before it returns, and waits for nothing queued on the card (a
        # blocking one would drain the stream: every decode window in flight)
        ids = torch.from_numpy(np.asarray(block_ids, dtype=np.int64))
        return ids.to(device or self.device, non_blocking=True)

    def _words(self, t: torch.Tensor) -> torch.Tensor:
        """A (layers, tensors, n, ...) tensor of this cache's dtype as
        (layers * tensors, n, words): one block of one layer is contiguous,
        so the copies index whole 8-byte words (or elements, where a block's
        bytes do not divide by 8) rather than single int8 or bf16 values."""
        rows = t.reshape(t.shape[0] * t.shape[1], t.shape[2], -1)
        return rows.view(torch.int64) if rows.shape[-1] * t.element_size() % 8 == 0 else rows

    def _gather(self, a: torch.Tensor, block_ids: Sequence[int]) -> torch.Tensor:
        out = self._words(a).index_select(1, self._block_index(block_ids, a.device))
        return out.view(a.dtype).view(a.shape[:2] + (len(block_ids),) + a.shape[3:]).movedim(2, 0)

    def gather_blocks(self, block_ids: Sequence[int]) -> torch.Tensor:
        """The blocks as one (n, layers, tensors, block, heads, dim) payload,
        a copy on this cache's (the first shard's) device, in the
        single-device layout."""
        if self.shards is None:
            return self._gather(self.cache_array, block_ids)
        return merge_kv_shards([self._gather(a, block_ids) for a in self.cache_array],
                               self.shards, layer_dim=1)

    def scatter_blocks(self, block_ids: Sequence[int], blocks) -> None:
        """Write a gather_blocks payload (a tensor on any device, or an
        array) into these blocks, in this cache's dtype."""
        blocks = torch.as_tensor(blocks)
        if self.shards is None:
            self._scatter(self.cache_array, block_ids, blocks)
            return
        for a, part in zip(self.cache_array, shard_kv_cache(blocks, self.shards, layer_dim=1)):
            self._scatter(a, block_ids, part)

    def _scatter(self, a: torch.Tensor, block_ids: Sequence[int], blocks: torch.Tensor):
        blocks = blocks.to(a.device, self.dtype).movedim(0, 2)
        self._words(a).index_copy_(1, self._block_index(block_ids, a.device),
                                   self._words(blocks.contiguous()))

    # ---------------- sizing / metrics ----------------

    @classmethod
    def compute_n_blocks(cls, config: TokenCacheBlockManagerConfig,
                         budget_bytes: Optional[int] = None, device=None,
                         utilization: float = 0.9) -> int:
        """Blocks that fit in budget_bytes; without a budget, in `utilization`
        of the device's free memory (torch.cuda.mem_get_info)."""
        if budget_bytes is None:
            free, _ = torch.cuda.mem_get_info(resolve_device(device))
            budget_bytes = int(free * utilization)
        return budget_bytes // config.block_nbytes

    def metrics(self) -> TokenCacheBlockManagerMetrics:
        hit = (self._n_blocks_matched / self._n_blocks_queried
               if self._n_blocks_queried else 0.0)
        return TokenCacheBlockManagerMetrics(self.block_allocator.metrics(), hit)
