"""Fill and image-embed executors (port of hydrainfer_tpu/engine/executor.py:
FillExecutor and ImageEmbedExecutor).

FillExecutor registers finished blocks in the prefix cache, packs the padded
batch, runs the language-model step with the KV cache updated in place, then
on the host scatters each sampled token into its sample_dst decode Fill and
feeds the output-token processors. ImageEmbedExecutor runs the vision tower
over a batch's images, whole or (the layer-chunked encode) one segment of
layers a step, and writes the features into the image cache, where the
image-bearing prefills gather them.

Async overlap: the step's kernels are queued on the current CUDA stream and
the call returns before the card finishes. The sampled tokens are copied into
pinned host memory on the same stream, behind the step, and a CUDA event
marks the copy's completion; the returned Future's get() waits on that event
only, is_ready() polls it, and wait() blocks on it (from any thread). The
card meanwhile feeds itself: a decode step reads its input token from the
device token table, where the previous step wrote it.

Shape keys: the builder pads S, MB and Ti up to the executor's high-water
floors (raised by every build, and before serving by `preratchet`), so the
set of (FillDims, n_steps) keys converges. On the card with CUDA graphs on,
each all-decode key runs from its graph (models/step_graphs.py): the step's
host buffers are copied into that key's device buffers, and the graph is
replayed. Every new key is logged, as the JAX executor logs a new compile.

Sampling: the executor owns the node's torch.Generator (on the KV cache's
device, seeded 0 unless the caller gives a seed); every step whose batch
samples draws from it, graph replays included.

N-gram speculative decoding (`execute_spec`, the JAX executor's
prompt-lookup verify path): each request of an all-decode batch proposes up
to k_draft tokens from its own history (`propose_ngram`), and one verify step
(S segments of K1 = 1 + k_draft rows) checks them all on the device. The
accepted count decides how far each request's cursor moves, so the step is
synchronous: the node drains the pipeline before the proposer runs and
reads the verify step's result before the next step. A proposer miss backs
the attempts off (2, 4, ... 64 eligible steps skipped); a hit resets it.
"""
import time
from typing import Optional

import numpy as np
import torch

from ..memory import TokenCacheBlockManager
from ..models.factory import FillDims, VisionModelParameters, pack_fill_batch
from ..models.step_graphs import StepGraphs, graphed, wait_event
from ..ops.cache_ops import write_token_cache
from ..utils import hostprof
from ..utils.logger import getLogger
from .isa import Fill, ImageEmbedFill
from .params_builder import (SEQ_BUCKETS, TOKEN_BUCKETS, FillBatchPlan,
                             LanguageModelBatchBuilder, _next_pow2, bucket_of,
                             samples, sampling_tail)
from .rcb import BatchRequest
from .worker import Worker

logger = getLogger(__name__)


class Future:
    def get(self):
        raise NotImplementedError

    def is_ready(self) -> bool:
        return True


class EmptyFuture(Future):
    def get(self):
        pass


class FillFuture(Future):
    """The sampled tokens of one dispatched step or window: get() waits for
    their device-to-host copy and runs the host postprocess exactly once."""

    def __init__(self, plan, sampled_dev: torch.Tensor, n_steps: int,
                 postprocess=None):
        self.plan = plan
        self.n_steps = n_steps      # device steps this read covers
        # postprocess(plan, sampled): the host's consumption of the tokens
        self.postprocess = postprocess or postprocess_plan
        # called once the tokens are on the host and postprocessed (the
        # node's latency-breakdown stamp)
        self.on_read = None
        # a fill window's id (FillExecutor.execute), the tag of its
        # hostprof timeline events; verify steps carry none, as in JAX
        self.win_id = None
        self._done = False
        if sampled_dev.device.type == "cuda":
            # queued on the stream right behind the step: when the step was a
            # graph replay, sampled_dev is the graph's own output, and the
            # next replay of the same key (later on this stream) overwrites
            # it only after this copy has read it
            self._host = torch.empty(sampled_dev.shape, dtype=sampled_dev.dtype,
                                     pin_memory=True)
            self._host.copy_(sampled_dev, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host, self._event = sampled_dev, None

    def is_ready(self) -> bool:
        return self._event is None or self._event.query()

    def wait(self) -> None:
        """Block until the tokens have landed; callable from any thread (not
        while a graph capture is in progress: models/step_graphs.py)."""
        if self._event is not None:
            wait_event(self._event)

    def get(self):
        if self._done:
            return
        self._done = True
        if self.win_id is not None:
            hostprof.event("read_start", self.win_id)
        with hostprof.span("fill.d2h_read"):
            if self._event is not None:
                self._event.synchronize()
            sampled = self._host.numpy()
        if self.win_id is not None:
            hostprof.event("read_done", self.win_id)
        with hostprof.span("fill.postprocess"):
            self.postprocess(self.plan, sampled)
        if self.on_read is not None:
            self.on_read()


def _tokens_done(rcb) -> bool:
    """Token-based completion (max_tokens reached or eos emitted)."""
    sp = rcb.sampling_params
    if len(rcb.output_token_ids) >= sp.max_tokens:
        return True
    return (bool(rcb.output_token_ids) and not sp.ignore_eos
            and rcb.output_token_ids[-1] in sp.eos_token_ids)


class FillExecutor:
    def __init__(self, kv_cache_manager: TokenCacheBlockManager, worker: Worker,
                 token_table_size: int = 4096,
                 image_cache_manager: Optional[TokenCacheBlockManager] = None,
                 mrope: bool = False, cuda_graphs: bool = False, seed: int = 0):
        self.kv = kv_cache_manager
        self.image = image_cache_manager
        self.mrope = mrope
        self.worker = worker
        # device-resident async-decode feedback buffer: one slot per resident
        # request holding its latest sampled token, plus a trailing discard
        # slot that absorbs the writes of padded sequences
        self.token_table = torch.zeros(token_table_size + 1, dtype=torch.int32,
                                       device=self.kv.device)
        self._free_slots = list(range(token_table_size - 1, -1, -1))
        # the draws of every sampling step
        self.generator = torch.Generator(device=self.kv.device).manual_seed(seed)
        # the all-decode and verify steps' CUDA graphs; none on the CPU
        self.graphs = (StepGraphs(self.kv.cache_array, self.token_table, self.generator)
                       if cuda_graphs and self.kv.device.type == "cuda" else None)
        # high-water marks of the S / MB / Ti key dims (see
        # params_builder.build): once a key exists, no smaller batch or
        # narrower block table makes a new one
        self._s_highwater = 1
        self._mb_highwater = 1
        self._ti_highwater = 0
        # every (dims, n_steps) dispatched; a new one mid-serving is a new
        # graph capture (decode) or a new eager shape (prefill)
        self._seen_fill_keys = set()
        # speculative decoding: verify steps run and the tokens they emitted
        self.spec_steps = 0
        self.spec_tokens = 0
        # the proposer's backoff: after a miss the next 2, 4, ... 64 eligible
        # steps skip the attempt (each attempt costs a pipeline drain)
        self._spec_skip = 0
        self._spec_backoff = 0

    def preratchet(self, s_floor: int, mb_floor: int, ti_floor: int = 0) -> None:
        """Raise the S / MB / Ti floors to the serving envelope before
        serving, so that the key set converges at boot instead of growing as
        the batch fills and contexts grow. Ti (the image-feature gather
        width) applies to image-bearing batches only."""
        self._s_highwater = max(self._s_highwater, int(s_floor))
        self._mb_highwater = max(self._mb_highwater, int(mb_floor))
        self._ti_highwater = max(self._ti_highwater, int(ti_floor))

    def acquire_slot(self, rcb) -> None:
        if rcb.token_slot < 0:
            assert self._free_slots, "token table exhausted"
            rcb.token_slot = self._free_slots.pop()

    def release_slot(self, rcb) -> None:
        if rcb.token_slot >= 0:
            self._free_slots.append(rcb.token_slot)
            rcb.token_slot = -1

    def _register_prefix_blocks(self, batch: BatchRequest) -> None:
        """Insert hashes for every block this step completes."""
        bs = self.kv.block_size
        for rcb, inst in batch:
            if not isinstance(inst, Fill) or inst.hashes is None:
                continue
            vbids, hashes = [], []
            for cid in inst.cache_ids:
                if cid % bs != bs - 1:
                    continue
                vbid = cid // bs
                if vbid >= len(inst.hashes):
                    continue  # decode tokens are not prefix-cached
                vbids.append(vbid)
                hashes.append(inst.hashes[vbid])
            if vbids:
                self.kv.set_blocks(rcb.virtual_kv_cache, vbids, hashes)

    def _multi_step_window(self, batch: BatchRequest, n_steps: int):
        """Fused-decode window for this batch: (n_steps, per-request ks).

        Fusion needs a pure single-token-decode batch whose pre-created decode
        Fills advance position == cache id. Each request contributes ks[i]
        real steps (its run of consecutive eligible Fills, capped at n_steps);
        requests with fewer steps ride along with their state writes masked on
        the device. n_steps stays the configured value and is halved only
        under KV-block pressure, through {16, 8, 4, 1}.
        """
        if n_steps <= 1 or not self.worker.supports_multi_step():
            return 1, None
        ks = []
        for rcb, inst in batch:
            # an ImageEmbedFill is excluded even at one token: each fused step
            # would splice its image features in again
            if (not isinstance(inst, Fill) or isinstance(inst, ImageEmbedFill)
                    or len(inst.position_ids) != 1
                    or not inst.sample or inst.is_chunked):
                return 1, None
            ks.append(self._decode_chain_len(inst, n_steps))
        if max(ks) <= 1:
            return 1, None
        # realloc the look-ahead blocks; shrink the window under pressure
        bs = self.kv.block_size
        while n_steps > 1:
            need = 0
            for (rcb, inst), k in zip(batch, ks):
                target = inst.cache_ids[0] + min(k, n_steps)
                need += max(0, -(-target // bs)
                            - len(rcb.virtual_kv_cache.block_table))
            if need <= self.kv.n_available_blocks():
                break
            n_steps = n_steps // 2 if n_steps > 4 else 1
        if n_steps <= 1:
            return 1, None
        ks = [min(k, n_steps) for k in ks]
        for (rcb, inst), k in zip(batch, ks):
            self.kv.realloc(rcb.virtual_kv_cache, inst.cache_ids[0] + k)
        return n_steps, ks

    @staticmethod
    def _decode_chain_len(inst, limit: int) -> int:
        """Length of the consecutive single-token-decode Fill run starting at
        inst: rope position and cache slot advance by exactly 1 per node (a
        constant offset between them is fine: M-RoPE compresses rope
        positions below cache ids)."""
        k, node = 0, inst
        prev_p, prev_c = inst.position_ids[0] - 1, inst.cache_ids[0] - 1
        while (k < limit and isinstance(node, Fill)
               and not isinstance(node, ImageEmbedFill)
               and len(node.position_ids) == 1 and node.sample
               and not node.is_chunked
               and node.position_ids[0] == prev_p + 1
               and node.cache_ids[0] == prev_c + 1):
            prev_p, prev_c = node.position_ids[0], node.cache_ids[0]
            k += 1
            node = node.next
        return k

    # ---------------- n-gram speculative decoding ----------------

    @staticmethod
    def propose_ngram(ctx, k: int, n: int = 3):
        """Prompt-lookup draft: the continuation of the latest earlier
        occurrence of the context's trailing n-gram (n, then 2), at most k
        tokens; [] when there is none."""
        a = np.asarray(ctx, np.int32)
        L = a.shape[0]
        for nn in (n, 2):
            if L < nn + 1:
                continue
            pat = a[-nn:]
            hits = a[: L - nn] == pat[0]
            for j in range(1, nn):
                hits &= a[j: L - nn + j] == pat[j]
            idx = np.flatnonzero(hits)
            if idx.size:
                i = int(idx[-1])
                cont = a[i + nn: i + nn + k]
                if cont.size:
                    return [int(t) for t in cont]
        return []

    def spec_should_try(self) -> bool:
        """The backoff gate: call it last among the eligibility checks (it
        spends one skip credit per call)."""
        if self._spec_skip > 0:
            self._spec_skip -= 1
            return False
        return True

    def _spec_miss(self) -> None:
        self._spec_backoff = min(max(2, self._spec_backoff * 2), 64)
        self._spec_skip = self._spec_backoff

    def _spec_hit(self) -> None:
        self._spec_backoff = 0

    def spec_precheck(self, batch: BatchRequest, k_draft: int) -> bool:
        """The cheap eligibility test (no proposer, no token state), so that
        the node drains its pipeline only for batches that can speculate:
        every request a single-token decode with k_draft + 1 decode Fills
        ahead."""
        if not self.worker.supports_multi_step():
            return False
        for rcb, inst in batch:
            if (not isinstance(inst, Fill) or isinstance(inst, ImageEmbedFill)
                    or len(inst.position_ids) != 1
                    or not inst.sample or inst.is_chunked):
                return False
            if self._decode_chain_len(inst, k_draft + 1) < k_draft + 1:
                return False
        return True

    def _spec_context(self, rcb) -> list:
        """The proposer's token history: the prompt fills' literal tokens
        (cached on the rcb, the prompt does not change) and the output."""
        base = getattr(rcb, "_spec_ctx_base", None)
        if base is None:
            base = []
            node = rcb.instructions.head.next
            while node is not None:
                if isinstance(node, Fill) and node.token_ids and len(node.token_ids) > 1:
                    base.extend(int(t) for t in node.token_ids)
                node = node.next
            rcb._spec_ctx_base = base
        return base + rcb.output_token_ids

    def execute_spec(self, batch: BatchRequest, k_draft: int,
                     ngram_n: int = 3) -> Optional[Future]:
        """One speculative verify step: every request contributes its real
        next-token row and up to k_draft proposed rows, verified in one
        device step. Returns None (the caller takes the normal path) when the
        batch is not eligible, no request has a draft, or the KV pool cannot
        hold the drafts; else the step's Future, which the caller must read
        before its next step (the accepted counts move the cursors)."""
        if not self.spec_precheck(batch, k_draft):
            return None
        K1 = k_draft + 1
        drafts = [self.propose_ngram(self._spec_context(rcb), k_draft, ngram_n)
                  for rcb, _ in batch]
        if not any(drafts):
            self._spec_miss()
            return None
        # look-ahead blocks to each draft's own depth; under pressure back off
        # instead of shrinking
        bs = self.kv.block_size
        need = 0
        for (rcb, inst), draft in zip(batch, drafts):
            target = inst.cache_ids[0] + 1 + len(draft)
            need += max(0, -(-target // bs) - len(rcb.virtual_kv_cache.block_table))
        if need > self.kv.n_available_blocks():
            self._spec_miss()
            return None
        for (rcb, inst), draft in zip(batch, drafts):
            self.kv.realloc(rcb.virtual_kv_cache, inst.cache_ids[0] + 1 + len(draft))
            self.acquire_slot(rcb)
        plan = self._build_spec_plan(batch, drafts, K1)
        out = self._dispatch(plan, 1, None)
        self.spec_steps += 1
        self._spec_hit()
        return FillFuture(plan, out.sample_token_ids, 1, postprocess=self._spec_postprocess)

    def _spec_postprocess(self, plan, raw: np.ndarray) -> None:
        """The verify step's [emitted (S * K1) | acc (S)]: emitted[:acc] are
        accepted drafts and emitted[acc] the final token; each request's
        cursor moves acc + 1 Fills."""
        S, K1 = plan.dims.S, plan.dims.spec
        n = len(plan.seq_rcbs)
        tok = raw[: S * K1].reshape(S, K1)[:n]
        accs = raw[S * K1:][:n]
        token_time = time.perf_counter()
        for i, rcb in enumerate(plan.seq_rcbs):
            acc = int(accs[i])
            self.spec_tokens += acc + 1
            for j in range(acc + 1):
                token = int(tok[i, j])
                inst = rcb.current_instruction()
                if inst.sample_dst is not None:
                    inst.sample_dst.token_ids = [token]
                rcb.step()
                if _tokens_done(rcb):
                    continue
                rcb.metric.token_times.append(token_time)
                rcb.output_token_ids.append(token)
                is_last = _tokens_done(rcb)
                for proc in rcb.output_token_processors:
                    proc.append_token_id(token, is_last)

    def _build_spec_plan(self, batch: BatchRequest, drafts, K1: int) -> FillBatchPlan:
        """S uniform segments of K1 rows (row 0 the real input, then the
        drafts), padded to the S and MB floors; T = the token bucket of
        S * K1. No M-RoPE tail: a decode token after an image has its three
        axes equal, so plain rope at the t position is M-RoPE's result."""
        n_seqs = len(drafts)
        S = max(bucket_of(n_seqs, SEQ_BUCKETS), _next_pow2(self._s_highwater))
        MB = max(_next_pow2(max(len(r.virtual_kv_cache.block_table) for r, _ in batch)),
                 _next_pow2(self._mb_highwater))
        self._s_highwater = max(self._s_highwater, S)
        self._mb_highwater = max(self._mb_highwater, MB)
        T = bucket_of(S * K1, TOKEN_BUCKETS)

        token_ids = np.zeros(T, np.int32)
        token_src = np.full(T, -1, np.int32)
        positions = np.zeros(T, np.int32)
        new_slots = np.full(T, -1, np.int32)
        q_seq_ids = np.full(T, -1, np.int32)
        q_local_ids = np.zeros(T, np.int32)
        kv_lens = np.zeros(S, np.int32)
        tables = np.full((S, MB), -1, np.int32)
        sample_idx = np.full(S, -1, np.int32)
        dst_slots = np.full(S, -1, np.int32)
        cu = np.zeros(S + 1, np.int32)
        draft_lens = np.zeros(S, np.int32)
        for s, ((rcb, inst), draft) in enumerate(zip(batch, drafts)):
            r0, dl = s * K1, len(draft)
            c0, p0 = inst.cache_ids[0], inst.position_ids[0]
            if inst.token_ids[0] >= 0:       # a host-resolved literal
                token_ids[r0] = inst.token_ids[0]
            else:                            # the device token table's
                token_src[r0] = rcb.token_slot
            token_ids[r0 + 1: r0 + 1 + dl] = draft
            new_slots[r0: r0 + 1 + dl] = self.kv.v2p(rcb.virtual_kv_cache,
                                                     list(range(c0, c0 + 1 + dl)))
            q_seq_ids[r0: r0 + K1] = s
            q_local_ids[r0: r0 + K1] = np.arange(K1)
            positions[r0: r0 + K1] = p0 + np.arange(K1)
            kv_lens[s] = c0 + K1
            bt = rcb.virtual_kv_cache.block_table
            tables[s, :len(bt)] = bt
            sample_idx[s] = r0 + K1 - 1
            dst_slots[s] = rcb.token_slot
            draft_lens[s] = dl
            cu[s + 1] = r0 + K1
        cu[n_seqs + 1:] = cu[n_seqs]
        seq_rcbs = [r for r, _ in batch]
        dims = FillDims(T=T, S=S, MB=MB, max_q=_next_pow2(K1),
                        sampling=samples(seq_rcbs), spec=K1)
        flat = pack_fill_batch(
            token_ids=token_ids, positions=positions, q_seq_ids=q_seq_ids,
            q_local_ids=q_local_ids, new_kv_slot_ids=new_slots,
            token_src_slots=token_src, kv_lens=kv_lens, sample_token_idx=sample_idx,
            sample_dst_slots=dst_slots, block_tables=tables, cu_q_lens=cu,
            num_seqs=np.asarray([n_seqs], np.int32))
        parts = [flat, draft_lens]
        if dims.sampling:
            parts.append(sampling_tail(seq_rcbs, S))
        return FillBatchPlan(flat=np.concatenate(parts), dims=dims, seq_rcbs=seq_rcbs,
                             seq_insts=[i for _, i in batch], n_tokens=n_seqs * K1,
                             n_seqs=n_seqs)

    def _dispatch(self, plan: FillBatchPlan, n_steps: int, k_host):
        """Copy the plan's buffers to the card (into its graph key's buffers
        when the step is graphed) and run the step."""
        dims = plan.dims
        graphs = self.graphs if self.graphs is not None and graphed(dims) else None
        if (dims, n_steps) not in self._seen_fill_keys:
            self._seen_fill_keys.add((dims, n_steps))
            logger.info(f"new fill graph key #{len(self._seen_fill_keys)}: {dims} "
                        f"n_steps={n_steps} ({'graph' if graphs else 'eager'})")
        # from pageable host memory, a non-blocking copy stages its source
        # before it returns, so the host arrays may go at once; the device
        # write is ordered on the stream behind earlier steps that read the
        # same buffer (a graph key's inputs are reused at every replay)
        with hostprof.span("fill.h2d"):
            if graphs is not None:
                flat, fused_k = graphs.inputs(dims, n_steps)
                flat.copy_(torch.from_numpy(plan.flat), non_blocking=True)
                if fused_k is not None:
                    fused_k.copy_(torch.from_numpy(k_host), non_blocking=True)
            else:
                device = self.kv.device
                flat = torch.from_numpy(plan.flat).to(device, non_blocking=True)
                fused_k = (None if k_host is None else
                           torch.from_numpy(k_host).to(device, non_blocking=True))
        with hostprof.span("fill.dispatch"):
            return self.worker.execute_language_model(
                self.kv.cache_array, self.token_table, flat, dims,
                n_steps=n_steps, fused_k=fused_k,
                image_cache=self.image.cache_array if self.image is not None else None,
                graphs=graphs, generator=self.generator)

    def execute(self, batch: BatchRequest, n_steps: int = 1) -> Future:
        if len(batch) == 0:
            return EmptyFuture()
        with hostprof.span("fill.window_walk"):
            n_steps, ks = self._multi_step_window(batch, n_steps)
        with hostprof.span("fill.prefix_reg"):
            self._register_prefix_blocks(batch)
            for rcb, _ in batch:
                self.acquire_slot(rcb)
        with hostprof.span("fill.build"):
            builder = LanguageModelBatchBuilder(self.kv, self.image, self.mrope)
            builder.add_batch(batch)
            plan = builder.build(s_floor=self._s_highwater, mb_floor=self._mb_highwater,
                                 ti_floor=self._ti_highwater)
        dims = plan.dims
        self._s_highwater = max(self._s_highwater, dims.S)
        self._mb_highwater = max(self._mb_highwater, dims.MB)
        self._ti_highwater = max(self._ti_highwater, dims.Ti)
        k_host = None
        if n_steps > 1:
            k_host = np.zeros(dims.S, np.int32)
            k_host[:len(ks)] = ks
        out = self._dispatch(plan, n_steps, k_host)

        # advance each request through ITS window (ks[i] steps), collecting
        # per-step instruction rows for the host-side token resolution; rows
        # a request does not reach hold None (its device lanes were masked)
        plan.n_steps = n_steps
        with hostprof.span("fill.cursor"):
            if n_steps == 1:
                batch.step()
            else:
                rows = [[None] * len(plan.seq_rcbs) for _ in range(n_steps)]
                for i, rcb in enumerate(plan.seq_rcbs):
                    for s in range(ks[i]):
                        rows[s][i] = rcb.current_instruction()
                        rcb.step()
                plan.step_insts = rows
        fut = FillFuture(plan, out.sample_token_ids, n_steps)
        FillExecutor._win_counter += 1
        fut.win_id = FillExecutor._win_counter
        hostprof.event("dispatched", fut.win_id)
        return fut

    _win_counter = 0


class ImageEmbedExecutor:
    """Encodes a batch's images and scatters the features into the image
    cache (one cache slot per feature token, its n_heads * head_dim values
    holding the LM-hidden feature).

    `execute` runs the whole tower in one call. With `chunk_layers` > 0 and a
    fixed-resolution tower that has the segment API (models/llava.py), the
    node may instead run the layer-chunked encode: `start_chunked` embeds
    the batch and runs its first segment of chunk_layers layers, and each
    later step's `advance` runs the next one, until the last step projects,
    scatters and hands the batch back. The node dispatches each segment
    after the step's fills, so decode windows reach the card between
    segments. The JAX executor also pads a fixed-resolution batch to a
    power-of-two image count to bound its jit keys; the port runs eagerly,
    so the padding would only add tower work, and it pads nothing."""

    def __init__(self, image_cache_manager: TokenCacheBlockManager, worker: Worker,
                 chunk_layers: int = 0):
        self.image = image_cache_manager
        self.worker = worker
        self.n_heads = image_cache_manager.config.n_heads
        self.head_dim = image_cache_manager.config.head_dim
        self.chunk_layers = chunk_layers
        self._inflight = None

    def chunking_enabled(self) -> bool:
        vm = self.worker.vision_model
        return (self.chunk_layers > 0 and vm is not None
                and hasattr(vm, "forward_segment") and vm.fixed_resolution)

    @property
    def busy(self) -> bool:
        """A chunked encode is in flight."""
        return self._inflight is not None

    def _prep(self, batch: BatchRequest):
        """The batch's images stacked, its image-cache slots, its sizes."""
        pixel_values, slot_ids, images_size = [], [], []
        for rcb, inst in batch:
            pixel_values.append(np.asarray(inst.pixel_values))
            inst.pixel_values = None
            slot_ids.extend(self.image.v2p(rcb.virtual_image_cache, inst.cache_ids))
            images_size.extend(inst.images_size)
        return np.concatenate(pixel_values, axis=0), slot_ids, images_size

    def _scatter(self, feats: torch.Tensor, slot_ids) -> None:
        rows = feats.reshape(-1, self.n_heads, self.head_dim)
        slots = torch.tensor(slot_ids, dtype=torch.int32, device=rows.device)
        write_token_cache(self.image.cache_array, 0, slots, rows)

    def start_chunked(self, batch: BatchRequest) -> None:
        """Embed the batch and run the tower's first segment; the node calls
        advance() once a step until the encode completes."""
        assert self._inflight is None and self.chunking_enabled()
        stacked, slot_ids, _ = self._prep(batch)
        vm = self.worker.vision_model
        hidden = vm.forward_segment(vm.forward_embed(stacked), 0, self.chunk_layers)
        self._inflight = {"batch": batch, "hidden": hidden, "seg": 1,
                          "n_segs": vm.encode_segments(self.chunk_layers),
                          "slot_ids": slot_ids}

    def advance(self) -> Optional[BatchRequest]:
        """Run the next segment; after the last one, project, scatter, step
        the batch's requests and return the batch (else None)."""
        st = self._inflight
        assert st is not None
        vm = self.worker.vision_model
        if st["seg"] < st["n_segs"]:
            st["hidden"] = vm.forward_segment(st["hidden"], st["seg"], self.chunk_layers)
            st["seg"] += 1
            return None
        self._scatter(vm.forward_project(st["hidden"]), st["slot_ids"])
        st["batch"].step()
        self._inflight = None
        return st["batch"]

    def execute(self, batch: BatchRequest) -> Future:
        if len(batch) == 0:
            return EmptyFuture()
        stacked, slot_ids, images_size = self._prep(batch)
        out = self.worker.execute_vision_model(
            stacked, VisionModelParameters(original_image_sizes=images_size))
        self._scatter(out.image_features, slot_ids)   # (n_images, n_tok, hidden)
        batch.step()
        return EmptyFuture()


def postprocess_plan(plan, sampled: np.ndarray) -> None:
    """Host-side consumption of one step's sampled tokens (or of a fused
    window's: the device returns n_steps * S tokens)."""
    token_time = time.perf_counter()
    n_steps = plan.n_steps
    step_insts = plan.step_insts if n_steps > 1 else [plan.seq_insts]
    sampled = sampled.reshape(n_steps, -1)
    for s in range(n_steps):
        for i, (rcb, inst) in enumerate(zip(plan.seq_rcbs, step_insts[s])):
            if inst is None or not inst.sample:
                continue
            next_token = int(sampled[s, i])
            if inst.sample_dst is not None:
                inst.sample_dst.token_ids = [next_token]
            if inst.is_chunked:
                continue
            # termination is decided from TOKEN state only: the instruction
            # cursor runs ahead of the token postprocess, and in-flight steps
            # past a request's final token must be dropped
            if _tokens_done(rcb):
                continue
            rcb.metric.token_times.append(token_time)
            rcb.output_token_ids.append(next_token)
            is_last = _tokens_done(rcb)
            for proc in rcb.output_token_processors:
                proc.append_token_id(next_token, is_last)

