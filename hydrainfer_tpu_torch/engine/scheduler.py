"""Continuous-batching scheduler (port of hydrainfer_tpu/engine/scheduler.py).

  - waiting deque with PullCache queue-jumping (appendleft);
  - admission up to max_running_requests minus in-flight migrations, plus an
    overload window admitting only PullCache requests;
  - admission reserves each request's worst-case KV footprint (prompt +
    max_tokens, discounted by a pinned prefix-cache hit), so decode growth
    can never deadlock the pool;
  - lazy virtual-KV allocation with prefix-cache match: the matched prefix
    is skipped by chunking the prefill at the match point and stepping past
    the head chunk;
  - allocation failures become back-pressure (the request is deferred), not
    crashes; a round in which every resident request defers logs the
    per-request reservation accounting every 20,000th time (the JAX
    invariant dump);
  - a node without a KV cache (an encode-only node) reserves nothing;
  - image-cache allocation for encodes (ImageEmbed), deferred like KV;
  - batch packing under the image budget (at most encode_chunk_images per
    step while fills are resident, so encodes interleave with decode
    windows) and the token budget, prefills first, with chunked prefill of
    the marginal request;
  - queueing-latency stamps on entry to and exit from the waiting queue.
"""
import time
from collections import deque
from dataclasses import dataclass
from typing import List, Literal, Optional

from ..memory import TokenCacheBlockManager
from ..utils.counter import IncreasingAllocator
from ..utils.logger import getLogger
from .isa import Fill, ImageEmbed, PullCache
from .rcb import BatchRequest, RequestControlBlock

logger = getLogger(__name__)


@dataclass
class BatchSchedulerConfig:
    # which fills the token budget takes first
    priority: Literal["prefill", "decode"] = "prefill"
    max_running_requests: int = 16
    # chunk the marginal prefill to fill the token budget
    chunked_prefill: bool = True
    # log every step's batch
    debug: bool = False
    # with fills resident, admit at most this many images per step instead
    # of the full image budget; 0 = no cap
    encode_chunk_images: int = 2


@dataclass
class BatchSchedulerMetrics:
    n_running_requests: int
    n_requests_waiting_migrate: int


class BatchScheduler:
    def __init__(self, config: BatchSchedulerConfig,
                 kv_cache_manager: TokenCacheBlockManager,
                 token_budget: int = 2048,
                 image_cache_manager: Optional[TokenCacheBlockManager] = None,
                 image_budget: int = 8):
        self.config = config
        self.kv_cache_manager = kv_cache_manager
        self.image_cache_manager = image_cache_manager
        self.token_budget = token_budget
        self.image_budget = image_budget

        self.waiting: deque = deque()
        self.running: List[RequestControlBlock] = []
        self.step_cnt = 0
        self._sid_allocator = IncreasingAllocator(start=1)
        self.max_overload_requests = config.max_running_requests
        self._running_cnt = 0
        self._migrating_cnt = 0
        self._oom_deferrals = 0
        self._reserved_blocks = 0

    # -------- migration OOM guard --------

    def migrating_acquire(self) -> None:
        assert self._migrating_cnt < self.config.max_running_requests + self.max_overload_requests
        self._migrating_cnt += 1

    def migrating_release(self) -> None:
        assert self._migrating_cnt > 0
        self._migrating_cnt -= 1

    # -------- queueing-latency stamps --------

    def _stamp_queue_begin(self, rcb: RequestControlBlock) -> None:
        m = rcb.metric
        if isinstance(rcb.current_instruction(), ImageEmbed):
            m.encode_queueing.append(time.perf_counter())
        elif not m.prefill_queueing:
            m.prefill_queueing.append(time.perf_counter())
        elif not m.decode_queueing:
            m.decode_queueing.append(time.perf_counter())

    def _stamp_queue_end(self, rcb: RequestControlBlock) -> None:
        m = rcb.metric
        for span in (m.encode_queueing, m.prefill_queueing, m.decode_queueing):
            if len(span) == 1:
                span.append(time.perf_counter())
                return

    # -------- entry points --------

    def schedule_new(self, rcb: RequestControlBlock) -> None:
        rcb.sid = self._sid_allocator.allocate()
        if isinstance(rcb.current_instruction(), PullCache):
            self.waiting.appendleft(rcb)
        else:
            self.waiting.append(rcb)
        self._stamp_queue_begin(rcb)

    def schedule_running(self, rcb: RequestControlBlock) -> None:
        self.running.append(rcb)
        self._stamp_queue_end(rcb)

    def _demand_blocks(self, rcb: RequestControlBlock) -> int:
        """Worst-case KV blocks for the request's full lifetime (none on a
        node without a KV cache)."""
        if self.kv_cache_manager is None:
            return 0
        n_prompt = rcb.request_metadata.n_prompt_tokens if rcb.request_metadata else 0
        n_tokens = n_prompt + (rcb.sampling_params.max_tokens
                               if rcb.sampling_params else 0)
        return -(-n_tokens // self.kv_cache_manager.block_size)

    def _try_reserve(self, rcb: RequestControlBlock) -> bool:
        """Reserve the request's worst-case footprint, discounted by its
        prefix-cache hit. The matched blocks are PINNED here so the discount
        stays real until the request adopts them (an advisory match could be
        evicted before allocate_virtual_cache runs); release_admission_pins()
        drops the pins once the virtual cache holds its own."""
        if self.kv_cache_manager is None:
            return True
        need = self._demand_blocks(rcb)
        sc = self.kv_cache_manager.shared_cache
        pins: List[int] = []
        inst = rcb.current_instruction()
        hashes = inst.hashes if isinstance(inst, Fill) else None
        if hashes:
            for bid in sc.match(hashes):
                if bid == -1:
                    break
                pins.append(bid)
        need = max(need - len(pins), 0)
        if self._reserved_blocks + need > self.kv_cache_manager.n_blocks:
            return False
        if pins:
            sc.pin(pins)
        self._reserved_blocks += need
        rcb._kv_reservation = need
        rcb._admission_pins = pins
        return True

    def release_admission_pins(self, rcb: RequestControlBlock) -> None:
        pins = getattr(rcb, "_admission_pins", None)
        if pins:
            self.kv_cache_manager.shared_cache.unpin(pins)
        rcb._admission_pins = None

    def release_reservation(self, rcb: RequestControlBlock) -> int:
        """End the request's reservation here; the blocks it held."""
        need = getattr(rcb, "_kv_reservation", 0)
        self._reserved_blocks -= need
        rcb._kv_reservation = 0
        self.release_admission_pins(rcb)
        return need

    def restore_reservation(self, rcb: RequestControlBlock, need: int) -> None:
        """Give back a reservation ended by a hand-off that fell back to
        this node."""
        self._reserved_blocks += need
        rcb._kv_reservation = need

    def _log_invariant_dump(self, deferred: List[RequestControlBlock]) -> None:
        """Every resident request deferred: under the admission invariant (the
        worst-case reservations, prefix-discounted, sum to at most the pool)
        one of them should always be able to grow, so this is either a
        passing pool-full moment or the KV-pool livelock the JAX package
        documents (evaluation/results/slo_trace_open_issue.md). Log each
        request's accounting (blocks held, worst case, reservation, OVER
        where it holds more than its worst case), as the JAX scheduler does.
        On a node without a KV cache (an E node, deferred on its image pool)
        every row reads alloc=0 worst=0."""
        kv = self.kv_cache_manager
        rows = []
        for rcb in deferred:
            alloc = (len(rcb.virtual_kv_cache.block_table)
                     if rcb.virtual_kv_cache else 0)
            worst = self._demand_blocks(rcb)
            resv = getattr(rcb, "_kv_reservation", -1)
            flag = " OVER" if alloc > worst else ""
            rows.append(f"{rcb.request_id}: alloc={alloc} worst={worst} resv={resv}{flag}")
        logger.warning("back-pressure invariant dump (reserved=%s pool=%s):\n  %s",
                       self._reserved_blocks, kv.n_blocks if kv is not None else 0,
                       "\n  ".join(rows))

    # -------- the step --------

    def step(self) -> BatchRequest:
        self.step_cnt += 1
        cap = self.config.max_running_requests - self._migrating_cnt
        while len(self.running) < cap and self.waiting:
            head = self.waiting[0]
            if (self.kv_cache_manager is not None
                    and self._demand_blocks(head) > self.kv_cache_manager.n_blocks):
                # can never fit: reject instead of stalling the queue
                self.waiting.popleft()
                logger.error(f"request {head.request_id} needs "
                             f"{self._demand_blocks(head)} blocks > pool "
                             f"{self.kv_cache_manager.n_blocks}; rejected")
                for proc in head.output_token_processors:
                    proc.append_token_id(-1, True)
                continue
            if not self._try_reserve(head):
                break  # head-of-line blocks until KV reservations free up
            self.schedule_running(self.waiting.popleft())
        # overload window: PullCache requests bypass the cap
        while (len(self.running) < cap + self.max_overload_requests
               and self.waiting
               and isinstance(self.waiting[0].current_instruction(), PullCache)):
            if not self._try_reserve(self.waiting[0]):
                break
            self.schedule_running(self.waiting.popleft())

        self._running_cnt = len(self.running)
        if not self.running:
            return BatchRequest()

        # 1. allocate caches; skip prefix-cache-matched prefill spans
        deferred: List[RequestControlBlock] = []
        runnable: List[RequestControlBlock] = []
        for rcb in self.running:
            inst = rcb.current_instruction()
            if isinstance(inst, Fill):
                if rcb.virtual_kv_cache is None:
                    rcb.virtual_kv_cache = \
                        self.kv_cache_manager.allocate_virtual_cache(inst.hashes)
                    self.release_admission_pins(rcb)
                    assert rcb.virtual_kv_cache.n_cache_tokens <= len(inst.token_ids)
                    # always recompute at least the last prompt token so the
                    # sample chain stays intact on a full prefix hit
                    n_matched = min(rcb.virtual_kv_cache.n_cache_tokens,
                                    len(inst.token_ids) - 1)
                    if n_matched > 0:
                        inst.chunk_prefill(n_matched)
                        rcb.step()  # the matched span needs no compute
                inst = rcb.current_instruction()
                if isinstance(inst, Fill):
                    vc = rcb.virtual_kv_cache
                    target = max(vc.n_cache_tokens, max(inst.cache_ids) + 1)
                    bs = self.kv_cache_manager.block_size
                    n_more = -(-target // bs) - len(vc.block_table)
                    if n_more > self.kv_cache_manager.n_available_blocks():
                        deferred.append(rcb)
                        continue
                    self.kv_cache_manager.realloc(vc, target)
            elif isinstance(inst, ImageEmbed):
                if rcb.virtual_image_cache is None:
                    rcb.virtual_image_cache = \
                        self.image_cache_manager.allocate_virtual_cache()
                vc = rcb.virtual_image_cache
                target = max(vc.n_cache_tokens, max(inst.cache_ids) + 1)
                bs = self.image_cache_manager.block_size
                n_more = -(-target // bs) - len(vc.block_table)
                if n_more > self.image_cache_manager.n_available_blocks():
                    deferred.append(rcb)
                    continue
                self.image_cache_manager.realloc(vc, target)
            runnable.append(rcb)
        if deferred:
            self._oom_deferrals += 1
            if self._oom_deferrals % 1000 == 1:
                pools = [f"{name} free blocks: {m.n_available_blocks()}"
                         for name, m in (("kv", self.kv_cache_manager),
                                         ("image", self.image_cache_manager))
                         if m is not None]
                logger.warning(f"cache back-pressure: {len(deferred)} request(s) "
                               f"deferred ({', '.join(pools)})")
            if self._oom_deferrals % 20000 == 1 and not runnable:
                self._log_invariant_dump(deferred)
        self.running = runnable

        # 2. classify
        embed_seqs, prefill_seqs, decode_seqs, this_step, next_step = [], [], [], [], []
        for rcb in self.running:
            inst = rcb.current_instruction()
            if isinstance(inst, Fill):
                (decode_seqs if len(inst.token_ids) == 1 else prefill_seqs).append(rcb)
            elif isinstance(inst, ImageEmbed):
                embed_seqs.append(rcb)
            else:
                this_step.append(rcb)  # migrations always run

        # 3. pack encodes under the image budget (sub-batched while fills are
        # resident), then fills under the token budget in priority order; the
        # marginal prefill is chunked to fill the budget
        n_images = 0
        image_budget = self.image_budget
        if self.config.encode_chunk_images > 0 and (prefill_seqs or decode_seqs):
            image_budget = min(image_budget, self.config.encode_chunk_images)
        for rcb in embed_seqs:
            if n_images < image_budget:
                this_step.append(rcb)
                n_images += len(rcb.current_instruction().images_size)
            else:
                next_step.append(rcb)
        fill_seqs = (prefill_seqs + decode_seqs if self.config.priority == "prefill"
                     else decode_seqs + prefill_seqs)
        n_tokens = 0
        for rcb in fill_seqs:
            inst = rcb.current_instruction()
            t = len(inst.token_ids)
            if n_tokens + t <= self.token_budget:
                this_step.append(rcb)
                n_tokens += t
            elif (n_tokens < self.token_budget and t > 1
                  and self.config.chunked_prefill):
                chunk = self.token_budget - n_tokens
                inst.chunk_prefill(chunk)
                this_step.append(rcb)
                n_tokens += chunk
            elif n_tokens == 0:
                # a single oversized prefill must not starve
                this_step.append(rcb)
                n_tokens += t
            else:
                next_step.append(rcb)

        if self.config.debug:
            logger.debug(
                f"step {self.step_cnt}: batch="
                + " ".join(f"{rcb.sid}:{rcb.current_instruction()!r}" for rcb in this_step)
                + f" images={n_images} tokens={n_tokens}")

        self.running = next_step + deferred
        return BatchRequest(this_step)

    def metrics(self) -> BatchSchedulerMetrics:
        return BatchSchedulerMetrics(self._running_cnt, self._migrating_cnt)

    @property
    def n_resident(self) -> int:
        """Resident (admitted, unfinished) request count as of the last
        step(): unlike len(self.running), it includes the requests handed out
        in the current batch, so it is the load signal for adaptive policies
        that run while a batch is in flight."""
        return self._running_cnt
