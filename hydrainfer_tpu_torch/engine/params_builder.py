"""Ragged batch -> padded flat fill buffer (port of
hydrainfer_tpu/engine/params_builder.py, the Python packer).

Every array is padded to a shape bucket (tokens and image-feature tokens to
TOKEN_BUCKETS, sequences to SEQ_BUCKETS, block-table width to a power of
two), and all int32 fields go into one flat buffer so a step costs one
host-to-device copy: the core fields, each image feature's image-cache slot
and destination token, under M-RoPE the h/w position streams, and when a
sequence samples (temperature > 0) the sampling tail (`sampling_tail`).

`build` takes the executor's high-water floors on S, MB and Ti. The dims are
the key of a step's CUDA graph (models/step_graphs.py), as they are the key
of a compiled program in the JAX package, so the floors bound the graph-key
set: without them a draining batch walks S back down the buckets and growing
contexts walk MB up through every power of two, each a new capture.

A batch whose requests each fill a run of consecutive positions and cache
slots is packed by the native C++ packer (csrc/hostops.cpp, built at first
use by engine/hostops.py); the Python packer `_build_python` is its oracle
and the path of the other batches, as in the JAX package. Unlike JAX, a
packer that fails to build raises instead of falling back.
"""
import bisect
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ..memory import TokenCacheBlockManager
from ..models.factory import FillDims, fill_sizes, pack_fill_batch
from . import hostops
from .isa import Fill, ImageEmbedFill
from .rcb import BatchRequest, RequestControlBlock

TOKEN_BUCKETS = [8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192]
SEQ_BUCKETS = [1, 2, 4, 8, 16, 32, 64, 128, 256]


def bucket_of(n: int, buckets: List[int]) -> int:
    i = bisect.bisect_left(buckets, n)
    return buckets[i] if i < len(buckets) else _next_pow2(n)


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


@dataclass
class FillBatchPlan:
    """Host-side companion of a packed fill batch: the flat int32 buffer, its
    dims, and which sequence slot belongs to which request."""
    flat: np.ndarray
    dims: FillDims
    seq_rcbs: List[RequestControlBlock]
    seq_insts: List[Fill]
    n_tokens: int
    n_seqs: int
    # fused decode window (set by the executor): step_insts[s] is step s's
    # instruction row
    n_steps: int = 1
    step_insts: Optional[List[List[Fill]]] = None


def sampling_tail(seq_rcbs, S: int) -> np.ndarray:
    """The per-sequence sampling controls, floats bitcast into the int32
    buffer: [temperatures (S) | top_ks (S) | top_ps (S) | seed (1)]. The one
    definition of the tail (models/factory.py:unpack_fill_batch reads it
    back); the fill builder and the speculative plan both use it. The seed
    counts the tails built in this process, as in the JAX package."""
    temps = np.zeros(S, np.float32)
    top_ks = np.full(S, -1, np.int32)
    top_ps = np.ones(S, np.float32)
    for i, rcb in enumerate(seq_rcbs):
        sp = rcb.sampling_params
        if sp is None:
            continue
        temps[i], top_ks[i], top_ps[i] = sp.temperature, sp.top_k, sp.top_p
    LanguageModelBatchBuilder._seed_counter += 1
    seed = np.asarray([LanguageModelBatchBuilder._seed_counter], np.int32)
    return np.concatenate([temps.view(np.int32), top_ks, top_ps.view(np.int32), seed])


def _is_range(ids: List[int]) -> bool:
    return len(ids) == 1 or ids[-1] - ids[0] == len(ids) - 1


def samples(seq_rcbs) -> bool:
    """Whether any of the sequences samples stochastically."""
    return any(r.sampling_params is not None and r.sampling_params.temperature > 0
               for r in seq_rcbs)


class LanguageModelBatchBuilder:
    _seed_counter = 0

    def __init__(self, kv_cache_manager: TokenCacheBlockManager,
                 image_cache_manager: Optional[TokenCacheBlockManager] = None,
                 mrope: bool = False):
        self.kv = kv_cache_manager
        self.image = image_cache_manager
        self.image_slot_ids: List[int] = []
        self.image_dst_idx: List[int] = []
        self._mrope = mrope
        self._pos_h: List[int] = []
        self._pos_w: List[int] = []
        self.seq_rcbs: List[RequestControlBlock] = []
        self.seq_insts: List[Fill] = []
        self._n_tokens = 0
        self._max_q = 1
        self._max_blocks = 1
        self._contiguous = True

    def add(self, rcb: RequestControlBlock, inst: Fill) -> None:
        n = len(inst.position_ids)
        if isinstance(inst, ImageEmbedFill) and inst.image_token_cache_ids:
            self.image_slot_ids.extend(self.image.v2p(rcb.virtual_image_cache,
                                                      inst.image_token_cache_ids))
            self.image_dst_idx.extend(self._n_tokens + i for i, is_img
                                      in enumerate(inst.image_token_mask) if is_img)
        if self._mrope:
            hw = inst.mrope_hw or [inst.position_ids, inst.position_ids]
            self._pos_h.extend(hw[0])
            self._pos_w.extend(hw[1])
        self.seq_rcbs.append(rcb)
        self.seq_insts.append(inst)
        self._n_tokens += n
        self._max_q = max(self._max_q, n)
        self._max_blocks = max(self._max_blocks, len(rcb.virtual_kv_cache.block_table))
        if not (_is_range(inst.cache_ids) and _is_range(inst.position_ids)):
            self._contiguous = False

    def add_batch(self, batch: BatchRequest) -> None:
        for rcb, inst in batch:
            if isinstance(inst, Fill):
                self.add(rcb, inst)

    def build(self, s_floor: int = 1, mb_floor: int = 1,
              ti_floor: int = 0) -> FillBatchPlan:
        """s_floor, mb_floor, ti_floor: the executor's high-water floors on the
        S, MB and Ti key dims (rounded up as the dims are). Padding sequence
        rows and block-table width costs a decode step little; T is not
        floored, since padded prefill rows are real work."""
        n_seqs = len(self.seq_rcbs)
        T = bucket_of(self._n_tokens, TOKEN_BUCKETS)
        dims = FillDims(
            T=T, S=max(bucket_of(n_seqs, SEQ_BUCKETS), _next_pow2(s_floor)),
            MB=max(_next_pow2(self._max_blocks), _next_pow2(mb_floor)),
            # prefill-carrying batches bound max_q by T; all-decode batches
            # keep max_q = 1 (they go to the decode kernel)
            max_q=T if self._max_q > 1 else 1,
            # text-only batches carry no image gather; image-bearing ones are
            # floored at ti_floor
            Ti=(max(bucket_of(len(self.image_slot_ids), TOKEN_BUCKETS),
                    bucket_of(ti_floor, TOKEN_BUCKETS) if ti_floor else 0)
                if self.image_slot_ids else 0),
            mrope=self._mrope, sampling=samples(self.seq_rcbs))
        flat = self._build_native(dims) if self._contiguous else self._build_python(dims)
        if dims.sampling:
            flat = np.concatenate([flat, sampling_tail(self.seq_rcbs, dims.S)])
        return FillBatchPlan(flat=flat, dims=dims,
                             seq_rcbs=self.seq_rcbs, seq_insts=self.seq_insts,
                             n_tokens=self._n_tokens, n_seqs=n_seqs)

    def native_seqs(self) -> list:
        """One tuple per sequence, as csrc/hostops.cpp:pack_fill_batch takes
        it (the JAX `_build_native`'s tuples)."""
        seqs = []
        for rcb, inst in zip(self.seq_rcbs, self.seq_insts):
            n = len(inst.position_ids)
            unresolved = n == 1 and inst.token_ids[0] < 0
            dst = rcb.token_slot if (inst.sample and inst.sample_dst is not None) else -1
            seqs.append((None if unresolved else inst.token_ids,
                         inst.position_ids[0], n, rcb.token_slot,
                         inst.cache_ids[-1] + 1, dst,
                         rcb.virtual_kv_cache.block_table, inst.cache_ids[0]))
        return seqs

    def _build_native(self, dims: FillDims) -> np.ndarray:
        """The core fields in one C pass, then the M-RoPE streams."""
        T = dims.T
        core = sum(fill_sizes(dims)[:14])
        flat = np.empty(core + (2 * T if self._mrope else 0), np.int32)
        hostops.load().pack_fill_batch(flat[:core], T, dims.S, dims.MB, dims.Ti,
                                       self.kv.block_size, self.native_seqs(),
                                       self.image_slot_ids, self.image_dst_idx)
        if self._mrope:
            hw = flat[core:].reshape(2, T)
            hw[:] = 0
            hw[0, :len(self._pos_h)] = self._pos_h
            hw[1, :len(self._pos_w)] = self._pos_w
        return flat

    def _build_python(self, dims: FillDims) -> np.ndarray:
        T, S, MB, Ti = dims.T, dims.S, dims.MB, dims.Ti
        token_ids: List[int] = []
        token_src: List[int] = []
        positions: List[int] = []
        new_slots: List[int] = []
        q_seq_ids: List[int] = []
        q_local_ids: List[int] = []
        kv_lens: List[int] = []
        tables = np.full((S, MB), -1, np.int32)
        sample_idx = np.full(S, -1, np.int32)
        dst_slots = np.full(S, -1, np.int32)
        cu = np.zeros(S + 1, np.int32)

        for s, (rcb, inst) in enumerate(zip(self.seq_rcbs, self.seq_insts)):
            n = len(inst.position_ids)
            if n == 1 and inst.token_ids[0] < 0:
                # unresolved decode token: read from the device token table
                assert rcb.token_slot >= 0, "decode fill without a token slot"
                token_ids.append(0)
                token_src.append(rcb.token_slot)
            else:
                token_ids.extend(inst.token_ids)
                token_src.extend([-1] * n)
            positions.extend(inst.position_ids)
            new_slots.extend(self.kv.v2p(rcb.virtual_kv_cache, inst.cache_ids))
            q_seq_ids.extend([s] * n)
            q_local_ids.extend(range(n))
            kv_lens.append(inst.cache_ids[-1] + 1)
            bt = rcb.virtual_kv_cache.block_table
            tables[s, :len(bt)] = bt
            sample_idx[s] = len(token_ids) - 1
            if inst.sample and inst.sample_dst is not None:
                dst_slots[s] = rcb.token_slot
            cu[s + 1] = len(token_ids)
        cu[len(self.seq_insts) + 1:] = cu[len(self.seq_insts)]

        def pad_i32(vals, size, fill=0):
            a = np.full(size, fill, np.int32)
            a[:len(vals)] = vals
            return a

        return pack_fill_batch(
            token_ids=pad_i32(token_ids, T), positions=pad_i32(positions, T),
            q_seq_ids=pad_i32(q_seq_ids, T, fill=-1),
            q_local_ids=pad_i32(q_local_ids, T),
            new_kv_slot_ids=pad_i32(new_slots, T, fill=-1),
            token_src_slots=pad_i32(token_src, T, fill=-1),
            kv_lens=pad_i32(kv_lens, S), sample_token_idx=sample_idx,
            sample_dst_slots=dst_slots, block_tables=tables, cu_q_lens=cu,
            num_seqs=np.asarray([len(self.seq_insts)], np.int32),
            image_slot_ids=pad_i32(self.image_slot_ids, Ti),
            image_dst_idx=pad_i32(self.image_dst_idx, Ti, fill=-1),
            positions_hw=(np.stack([pad_i32(self._pos_h, T), pad_i32(self._pos_w, T)])
                          if self._mrope else None))
