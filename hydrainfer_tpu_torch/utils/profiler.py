"""Wall-clock span profiler with totals reported at exit (port of hydrainfer_tpu/utils/profiler.py).

Host-side spans, off until `enable()`. Each span is also a
`torch.profiler.record_function` range, so a torch.profiler trace shows it
beside the device's kernels (the JAX package's jax.profiler.TraceAnnotation).
The totals by name are logged at exit, longest first.
"""
import atexit
import collections
import contextlib
import time
from typing import Dict, Tuple

import torch

from .logger import getLogger

logger = getLogger(__name__)

_totals: Dict[str, Tuple[float, int]] = collections.defaultdict(lambda: (0.0, 0))
_enabled = False


def enable() -> None:
    global _enabled
    _enabled = True


@contextlib.contextmanager
def span(name: str):
    """Time a host-side span; accumulate totals reported at exit."""
    if not _enabled:
        yield
        return
    with torch.profiler.record_function(name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            total, n = _totals[name]
            _totals[name] = (total + dt, n + 1)


@atexit.register
def _report() -> None:
    if not _totals:
        return
    lines = ["profiler totals:"]
    for name, (total, n) in sorted(_totals.items(), key=lambda kv: -kv[1][0]):
        lines.append(f"  {name}: total={total * 1e3:.2f}ms n={n} avg={total / n * 1e3:.3f}ms")
    logger.info("\n".join(lines))
