"""Tensor probes for cross-implementation debugging (port of hydrainfer_tpu/utils/debug.py).

Two workflows:

1. Probes. `probe("name", x)` anywhere in the model code records a detached
   CPU copy of x (bf16 and fp8 as f32) into the process-global registry;
   `dump(path)` writes the registry as an .npz (hit i of `name` saved as
   `name.i`, the JAX package's layout); `clear()` resets it. A probe inside
   a CUDA-graph capture raises: the capture would record no copy, and a
   graph replay would run none.

2. Offline comparison. `compare(path_a, path_b)` (or `compare_with(path)`
   against the live registry) prints a per-tensor max-abs/mean-abs table.
   A dump of the JAX package and one of the port, of the same probes, diff
   by name with either package's `compare`: the tool for bisecting a
   divergence between the two.

Probes are no-ops unless enabled (HYDRAINFER_DEBUG_PROBES=1 or
`enable(True)`), so call sites can stay in the code.
"""
import os
from typing import Dict, List

import numpy as np
import torch

_ENABLED = os.environ.get("HYDRAINFER_DEBUG_PROBES", "0") == "1"
_REGISTRY: Dict[str, List[np.ndarray]] = {}


def enable(on: bool = True) -> None:
    global _ENABLED
    _ENABLED = on


def clear() -> None:
    _REGISTRY.clear()


def _host(x) -> np.ndarray:
    if not isinstance(x, torch.Tensor):
        return np.asarray(x)
    x = x.detach()
    if x.is_floating_point() and x.dtype not in (torch.float32, torch.float64):
        x = x.float()           # numpy has no bf16 or fp8
    return x.cpu().numpy().copy()


def probe(name: str, x):
    """Record x under `name` (appends on repeated hits, e.g. per layer).
    Returns x unchanged so it can be used inline:
    `h = probe("post_norm", rms_norm(...))`."""
    if not _ENABLED:
        return x
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(f"debug probe {name!r} inside a CUDA-graph capture: a replay "
                           "would record nothing (run with cuda_graphs off)")
    _REGISTRY.setdefault(name, []).append(_host(x))
    return x


def stats(name: str):
    """Summary of everything recorded under name."""
    vals = _REGISTRY.get(name, [])
    return [{"shape": v.shape,
             "mean": float(np.mean(v)), "std": float(np.std(v)),
             "absmax": float(np.max(np.abs(v))) if v.size else 0.0,
             "nan": int(np.isnan(v).sum()), "inf": int(np.isinf(v).sum())}
            for v in vals]


def _flat() -> Dict[str, np.ndarray]:
    return {f"{k}.{i}": v for k, vs in _REGISTRY.items() for i, v in enumerate(vs)}


def dump(path: str) -> None:
    """Registry -> one .npz (hit i of `name` saved as `name.i`)."""
    np.savez(path, **_flat())


def _load(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def compare(path_a: str, path_b: str, atol: float = 1e-5) -> List[dict]:
    return _diff(_load(path_a), _load(path_b), atol)


def compare_with(path: str, atol: float = 1e-5) -> List[dict]:
    """Diff a saved dump against the live registry."""
    return _diff(_load(path), _flat(), atol)


def _diff(a: Dict[str, np.ndarray], b: Dict[str, np.ndarray],
          atol: float) -> List[dict]:
    rows = []
    for k in sorted(set(a) | set(b)):
        if k not in a or k not in b:
            rows.append({"name": k, "status": "only_in_" + ("a" if k in a else "b")})
            continue
        va, vb = a[k], b[k]
        if va.shape != vb.shape:
            rows.append({"name": k, "status": "shape", "a": va.shape, "b": vb.shape})
            continue
        d = np.abs(va.astype(np.float64) - vb.astype(np.float64))
        rows.append({"name": k,
                     "status": "ok" if float(d.max(initial=0)) <= atol else "DIFF",
                     "max_abs": float(d.max(initial=0)),
                     "mean_abs": float(d.mean()) if d.size else 0.0})
    for r in rows:
        print(r)
    return rows
