"""CUDA graphs of the language model's all-decode steps (the counterpart of
the JAX package's jitted step programs, hydrainfer_tpu/models/llama.py:
_flat_step and _flat_multi, compiled once per static key).

One graph is captured per key (FillDims, n_steps) whose step is all decode
(max_q == 1) and carries no image features: single decode steps and the
fused K-step windows. The speculative-verify steps (dims.spec > 0, n_steps
1, the counterpart of the JAX model's _flat_spec) are graphed too: their
shape is fixed by the S and MB floors and by K1 (serve's S floor of 8 and
K1 = 13 give T = 128, max_q = 16), and speculation is synchronous, so an
eager verify step would pay the whole host launch cost on the critical path.
A verify key is captured the first time it is met, as the JAX package
compiles _flat_spec at first use; the boot warm-up does not meet it. A step
that carries a prefill chunk or image features runs eagerly: its host cost
is spread over up to a token budget of rows, and its T walks every token
bucket.

Keys whose batch samples (dims.sampling) are graphed like greedy ones. A
capture records the random generator's offset arithmetic, not numbers: the
node's generator (the executor's) is registered with each sampling graph
before its capture (`CUDAGraph.register_generator_state`), so every replay
advances it and draws fresh numbers.

What a graph reads:
  - a `flat` buffer of exactly the key's length and, for a window, a
    `fused_k` (S,) buffer, both owned here; the executor copies each step's
    host buffers into them before the replay (`inputs`);
  - the node's KV cache and token table, the weights and the rope tables:
    the same tensors at every replay, read and written in place. Nothing may
    reallocate the cache or the token table after a capture (`run` checks).
Its output is the graph's own token tensor, which the next replay of the
same key overwrites: the caller copies it out on the same stream right
behind the replay (engine/executor.py:FillFuture).

The first time a key is met, its step runs eagerly (the real step: its tokens
are returned), which loads every kernel library and makes the kernels'
cudaFuncSetAttribute calls outside a capture; then the step is captured,
without running, into one memory pool that every key shares (replays run one
at a time on one stream). The boot warm-up (engine/profiler.py:warm_decode)
meets the windows largest first. torch.cuda.graph synchronises the device
when a capture begins, so a key first met while serving drains the pipeline
once: `captures` and `capture_s` count it.

The kernel wrappers count their launches in Python, which a replay does not
run: each graph keeps what its capture added to the counts (and takes it
back, since a capture launches nothing), and each replay adds it again.

On the card with graphs on, a failed capture or replay raises; nothing falls
back to the eager step.

Captures and token waits are ordered process-wide. torch.cuda.graph captures
in CUDA's global mode, where a CUDA call that may synchronise, made by any
other thread while a capture is in progress, is refused and invalidates the
capture. A node waits for its tokens in a worker thread (`wait_event`, from
cluster/node.py), and with several nodes in one process another node may
capture meanwhile: a capture therefore begins only when no such wait is in
progress, and a wait begins only when no capture is.
"""
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple

import torch

from ..ops import cuda as kernels
from .factory import FillDims, fill_sizes


_gate = threading.Condition()
_waits = 0
_capturing = False


def wait_event(event: "torch.cuda.Event") -> None:
    """event.synchronize() from a thread other than the capturing one,
    never while a capture is in progress."""
    global _waits
    with _gate:
        while _capturing:
            _gate.wait()
        _waits += 1
    try:
        event.synchronize()
    finally:
        with _gate:
            _waits -= 1
            _gate.notify_all()


@contextmanager
def _no_waits():
    """Hold off new waits and let those in progress end (their events fire
    on their own: the work they wait for is already queued)."""
    global _capturing
    with _gate:
        _capturing = True
        while _waits:
            _gate.wait()
    try:
        yield
    finally:
        with _gate:
            _capturing = False
            _gate.notify_all()


def graphed(dims: FillDims) -> bool:
    """Whether a step of these dims runs from a graph: all decode or a
    speculative verify, no image features."""
    return (dims.max_q == 1 or dims.spec > 0) and dims.Ti == 0


@dataclass
class StepGraph:
    flat: torch.Tensor
    fused_k: Optional[torch.Tensor]
    graph: Optional[torch.cuda.CUDAGraph] = None
    tokens: Optional[torch.Tensor] = None
    launches: Dict[str, int] = field(default_factory=dict)
    replays: int = 0


class StepGraphs:
    """The graphs of one node: bound to its KV cache, its token table and
    the generator its sampling steps draw from."""

    def __init__(self, cache: torch.Tensor, token_table: torch.Tensor,
                 generator: Optional[torch.Generator] = None):
        self.cache = cache
        self.token_table = token_table
        self.generator = generator
        self.pool = torch.cuda.graph_pool_handle()
        self.graphs: Dict[Tuple[FillDims, int], StepGraph] = {}
        self.captures = 0
        self.capture_s = 0.0
        self.replays = 0

    def inputs(self, dims: FillDims, n_steps: int):
        """The key's device input buffers (flat, fused_k or None)."""
        g = self.graphs.get((dims, n_steps))
        if g is None:
            dev = self.token_table.device
            g = StepGraph(
                flat=torch.zeros(sum(fill_sizes(dims)), dtype=torch.int32, device=dev),
                fused_k=(torch.zeros(dims.S, dtype=torch.int32, device=dev)
                         if n_steps > 1 else None))
            self.graphs[(dims, n_steps)] = g
        return g.flat, g.fused_k

    def run(self, step: Callable, cache: torch.Tensor, token_table: torch.Tensor,
            flat: torch.Tensor, dims: FillDims, n_steps: int,
            fused_k: Optional[torch.Tensor],
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The key's step: replayed, or on its first meeting run eagerly and
        captured. step(cache, token_table, flat, dims, n_steps, fused_k,
        generator=generator) is the eager step; its inputs must be this
        key's buffers, and a sampling step's generator the node's."""
        g = self.graphs.get((dims, n_steps))
        if (g is None or flat is not g.flat or fused_k is not g.fused_k
                or cache is not self.cache or token_table is not self.token_table
                or (dims.sampling and (generator is None
                                       or generator is not self.generator))):
            raise RuntimeError("a graphed step must read its key's input buffers, "
                               "the node's cache and token table and, when it "
                               "samples, the node's generator")
        if g.graph is not None:
            g.graph.replay()
            kernels.add_launch_counts(g.launches)
            g.replays += 1
            self.replays += 1
            return g.tokens
        tokens = step(cache, token_table, flat, dims, n_steps, fused_k, generator=generator)
        t0 = time.perf_counter()
        before = kernels.launch_counts()
        graph = torch.cuda.CUDAGraph()
        if dims.sampling:
            graph.register_generator_state(generator)
        with _no_waits(), torch.cuda.graph(graph, pool=self.pool):
            g.tokens = step(cache, token_table, flat, dims, n_steps, fused_k,
                            generator=generator)
        after = kernels.launch_counts()
        g.launches = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        kernels.add_launch_counts({k: -n for k, n in g.launches.items()})
        g.graph = graph
        self.captures += 1
        self.capture_s += time.perf_counter() - t0
        return tokens

    def pool_bytes(self) -> int:
        """Device memory the shared graph pool holds (its segments)."""
        pool = tuple(self.pool)
        return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
                   if tuple(s.get("segment_pool_id", ())) == pool)
