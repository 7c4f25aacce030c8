"""SLO-driven batch-budget search and the boot-time decode warm-up (port of
hydrainfer_tpu/engine/profiler.py: BatchSchedulerProfilerConfig,
BatchSchedulerProfiler and its warm_decode).

At node boot, `profile_token_budgets` and `profile_image_budgets` binary-
search the largest token batch and image batch whose measured step time
stays under `tpot_slo - slo_margin`, by pushing synthetic batches through
the node's real executors; the budgets bound what the scheduler packs a
step. Each timed probe ends in the host read of its sampled tokens (on the
card: a CUDA event wait), so the clock stops after the device finished.
Every probe gives back the KV blocks, image-cache blocks and token-table
slots it took (the JAX `_time_fill` frees its blocks but keeps its slots).
A failed search falls back to the default budget, as in the JAX package,
and is logged and counted in `fallbacks`.

The encode probe's pixels come from the model's own image processor over a
blank 336x336 image (the JAX probe feeds zeros of one fixed pixel shape,
which only a fixed-resolution tower takes).

`warm_decode` pushes synthetic requests through the fill executor at the
serving batch size: a prefill, then the fused windows K and K/2 and a single
decode step, largest first, so every all-decode key serving meets at that
batch size is captured as a CUDA graph before the first request arrives.
The JAX `warm_prefill_ladder` (TPU-only, off by default there) is not
ported.
"""
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..memory import TokenCacheBlockManager
from ..request import SamplingParameters
from ..utils.logger import getLogger
from .isa import ImageEmbed, InstructionListBuilder, TextFill
from .rcb import BatchRequest, RequestControlBlock

logger = getLogger(__name__)


# prompt tokens of each synthetic warm-up sequence (the JAX warm-up's)
N_PROMPT = 8


@dataclass
class BatchSchedulerProfilerConfig:
    enabled: bool = True
    tpot_slo: float = 0.4
    slo_margin: float = 0.01
    max_image_budget: int = 8
    max_token_budget: int = 2048
    # the budgets when the search is off or fails
    default_image_budget: int = 8
    default_token_budget: int = 2048


class BatchSchedulerProfiler:
    def __init__(self, config: BatchSchedulerProfilerConfig, fill_executor=None,
                 kv_cache_manager: Optional[TokenCacheBlockManager] = None,
                 image_cache_manager: Optional[TokenCacheBlockManager] = None,
                 n_image_tokens: int = 576, image_embed_executor=None,
                 image_processor=None):
        self.config = config
        self.fill_executor = fill_executor
        self.image_embed_executor = image_embed_executor
        self.kv = kv_cache_manager
        self.image = image_cache_manager
        self.n_image_tokens = n_image_tokens
        self.image_processor = image_processor
        self.fallbacks = 0      # searches that failed and took the default

    # ---------------- synthetic batches ----------------

    def _make_fill_rcb(self, n_tokens: int, rng) -> RequestControlBlock:
        rcb = RequestControlBlock()
        rcb.sampling_params = SamplingParameters(max_tokens=1)
        builder = InstructionListBuilder()
        builder.append(TextFill(
            token_ids=[int(t) for t in rng.integers(10, 100, size=n_tokens)],
            position_ids=list(range(n_tokens)), cache_ids=list(range(n_tokens)),
            sample=True, sample_dst=None, hashes=None))
        rcb.instructions = builder.build()
        rcb.virtual_kv_cache = self.kv.allocate_virtual_cache()
        self.kv.realloc(rcb.virtual_kv_cache, n_tokens)
        return rcb

    def _time_fill(self, n_tokens: int, n_seqs: int = 1) -> float:
        """Seconds of one fill step of n_tokens over n_seqs sequences, after
        one untimed run of the same batch (the first meeting of its key)."""
        per_seq = max(1, n_tokens // max(1, n_seqs))
        rng = np.random.default_rng(n_tokens)
        rcbs = []
        try:
            for _ in range(n_seqs):
                rcbs.append(self._make_fill_rcb(per_seq, rng))
            self.fill_executor.execute(BatchRequest(rcbs)).get()
            for rcb in rcbs:
                rcb.instructions.curr = rcb.instructions.head.next
                rcb.output_token_ids.clear()
            t0 = time.perf_counter()
            self.fill_executor.execute(BatchRequest(rcbs)).get()
            return time.perf_counter() - t0
        finally:
            for rcb in rcbs:
                self.fill_executor.release_slot(rcb)
                self.kv.realloc(rcb.virtual_kv_cache, 0)

    def _time_encode(self, n_images: int) -> float:
        """Seconds of one encode of n_images blank 336x336 images, after one
        untimed run."""
        from PIL import Image
        img = Image.fromarray(np.zeros((336, 336, 3), np.uint8))
        pixels = np.asarray(self.image_processor.process(img))
        if pixels.ndim == 3:
            pixels = pixels[None]
        rcbs = []
        try:
            for _ in range(n_images):
                rcb = RequestControlBlock()
                rcb.sampling_params = SamplingParameters(max_tokens=1)
                rcb.virtual_image_cache = self.image.allocate_virtual_cache()
                rcbs.append(rcb)
                self.image.realloc(rcb.virtual_image_cache, self.n_image_tokens)
                builder = InstructionListBuilder()
                builder.append(ImageEmbed(pixel_values=pixels,
                                          cache_ids=list(range(self.n_image_tokens)),
                                          images_size=[(336, 336)], hashes=None))
                rcb.instructions = builder.build()
            self._encode(rcbs, pixels)
            t0 = time.perf_counter()
            self._encode(rcbs, pixels)
            return time.perf_counter() - t0
        finally:
            for rcb in rcbs:
                self.image.realloc(rcb.virtual_image_cache, 0)

    def _encode(self, rcbs, pixels) -> None:
        for rcb in rcbs:
            rcb.instructions.curr = rcb.instructions.head.next
            rcb.current_instruction().pixel_values = pixels   # the executor drops it
        self.image_embed_executor.execute(BatchRequest(rcbs)).get()
        # the encode is queued on the card: wait for the features to land
        self.image.cache_array.view(-1)[:1].cpu()

    # ---------------- binary searches ----------------

    def _binary_search_budget(self, lo: int, hi: int, timer) -> int:
        """Largest n in [lo, hi] with timer(n) under the SLO."""
        budget = lo
        target = self.config.tpot_slo - self.config.slo_margin
        while lo <= hi:
            mid = (lo + hi) // 2
            if timer(mid) < target:
                budget = mid
                lo = mid + 1
            else:
                hi = mid - 1
        return budget

    def profile_image_budgets(self) -> int:
        if (not self.config.enabled or self.image_embed_executor is None
                or self.image is None or self.image_processor is None):
            return self.config.default_image_budget
        try:
            budget = self._binary_search_budget(
                1, self.config.max_image_budget, self._time_encode)
        except Exception:
            self.fallbacks += 1
            logger.exception("image budget profiling failed; using the default")
            return self.config.default_image_budget
        logger.info(f"profiled image budget: {budget}")
        return budget

    def profile_token_budgets(self) -> int:
        if not self.config.enabled or self.fill_executor is None or self.kv is None:
            return self.config.default_token_budget
        try:
            budget = self._binary_search_budget(
                16, self.config.max_token_budget, self._time_fill)
        except Exception:
            self.fallbacks += 1
            logger.exception("token budget profiling failed; using the default")
            return self.config.default_token_budget
        logger.info(f"profiled token budget: {budget}")
        return budget

    def warm_decode(self, n_seqs: int, k_fused: int) -> None:
        if self.fill_executor is not None and self.kv is not None:
            warm_decode(self.fill_executor, self.kv, n_seqs, k_fused)


def warm_decode(fill_executor, kv: TokenCacheBlockManager, n_seqs: int,
                k_fused: int) -> None:
    """Run a prefill of n_seqs sequences of N_PROMPT tokens through
    `fill_executor`, then the windows {k_fused, k_fused // 2, 1}, largest
    first, over decode chains long enough for all of them."""
    windows = sorted({k_fused, max(k_fused // 2, 1), 1}, reverse=True)
    n_decode = sum(windows) + 1
    rng = np.random.default_rng(0)
    rcbs = []
    try:
        for _ in range(n_seqs):
            rcb = RequestControlBlock()
            rcb.sampling_params = SamplingParameters(max_tokens=n_decode, ignore_eos=True)
            b = InstructionListBuilder()
            prompt = TextFill(token_ids=[int(t) for t in rng.integers(10, 100, N_PROMPT)],
                              position_ids=list(range(N_PROMPT)),
                              cache_ids=list(range(N_PROMPT)),
                              sample=True, sample_dst=None, hashes=None)
            b.append(prompt)
            last = prompt
            for i in range(N_PROMPT, N_PROMPT + n_decode):
                d = TextFill(token_ids=[-1], position_ids=[i], cache_ids=[i],
                             sample=True, sample_dst=None, hashes=None)
                b.append(d)
                last.sample_dst = d
                last = d
            rcb.instructions = b.build()
            rcb.virtual_kv_cache = kv.allocate_virtual_cache()
            kv.realloc(rcb.virtual_kv_cache, N_PROMPT)
            rcbs.append(rcb)
        fill_executor.execute(BatchRequest(rcbs)).get()
        for k in windows:
            # the scheduler's per-step contract, which this path bypasses:
            # cover the current instruction's slot (the window grows its own
            # look-ahead, and may have shrunk past steps' blocks)
            for rcb in rcbs:
                kv.realloc(rcb.virtual_kv_cache, rcb.current_instruction().cache_ids[0] + 1)
            fill_executor.execute(BatchRequest(rcbs), n_steps=k).get()
    finally:
        for rcb in rcbs:
            fill_executor.release_slot(rcb)
            kv.realloc(rcb.virtual_kv_cache, 0)
    logger.info(f"decode warm-up done (S={n_seqs}, K={k_fused})")
