"""Boot-time decode warm-up (port of hydrainfer_tpu/engine/profiler.py:
BatchSchedulerProfiler.warm_decode, as a function).

`warm_decode` pushes synthetic requests through the real fill executor at
the serving batch size: a prefill, then the fused windows K and K/2 and a
single decode step, in that order (largest first). So every all-decode key
serving meets at that batch size is captured as a CUDA graph before the
first request arrives, and the executor's high-water floors start at their
steady-state values. Every KV block and token-table slot it takes is given
back.

The JAX profiler's budget search (profile_image_budgets,
profile_token_budgets: timed synthetic batches searched against the TPOT
SLO) is not ported yet; the node takes the JAX defaults of 8 images and 2048
tokens a step (ROADMAP.md queue 1, item 3).
"""
import numpy as np

from ..memory import TokenCacheBlockManager
from ..request import SamplingParameters
from ..utils.logger import getLogger
from .isa import InstructionListBuilder, TextFill
from .rcb import BatchRequest, RequestControlBlock

logger = getLogger(__name__)


# prompt tokens of each synthetic sequence (the JAX warm-up's)
N_PROMPT = 8


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
