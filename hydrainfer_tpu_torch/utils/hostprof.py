"""Host-side phase profiler for the engine hot loop (port of
hydrainfer_tpu/utils/hostprof.py).

Spans wrap each host phase of the fill path (schedule, batch build, H2D,
dispatch, token read, postprocess, cursor walk) and accumulate totals, to
attribute the gap between device-busy time and wall time. Enabled by
HYDRAINFER_HOST_PROF=1; when off, a span costs one attribute check. Level 2
also records a (name, tag, time) timeline of each fill window's life:
`dispatched` (engine/executor.py, the step queued), `ready` (cluster/node.py,
the first drain that finds its tokens landed), `read_start` and `read_done`
(the host read), each tagged with the window's id.
"""
import os
import time
from collections import defaultdict

enabled = bool(int(os.environ.get("HYDRAINFER_HOST_PROF", "0") or "0"))
events_enabled = (os.environ.get("HYDRAINFER_HOST_PROF", "0") or "0") == "2"
totals = defaultdict(float)
counts = defaultdict(int)
events = []


def event(name: str, tag=None) -> None:
    if events_enabled:
        events.append((name, tag, time.perf_counter()))


class span:
    __slots__ = ("name", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        if enabled:
            self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if enabled:
            totals[self.name] += time.perf_counter() - self.t0
            counts[self.name] += 1
        return False


def reset() -> None:
    totals.clear()
    counts.clear()
    events.clear()


def report() -> dict:
    return {k: {"total_s": round(v, 4), "n": counts[k],
                "mean_ms": round(1e3 * v / max(counts[k], 1), 3)}
            for k, v in sorted(totals.items(), key=lambda kv: -kv[1])}
