"""Caps torch's intra-op threads in each pytest-xdist worker.

Every `tests/test_torch_*.py` imports this module before anything else, as
the top-level `torch_threads` (pytest puts `tests/` on sys.path, the
directory having no `__init__.py`): `from tests import ...` could resolve to
another installed package named `tests`.

Each xdist worker collects every test file, so the first collected port
file runs the cap once in each worker, before any port test runs. Left
alone, each worker's torch starts a pool as wide as the box, and six
workers on eight cores oversubscribe the CPU several times over.

The cap is `os.cpu_count() // n_workers` (at least 1), `n_workers` from
`PYTEST_XDIST_WORKER_COUNT`, which xdist sets in each worker; outside xdist
it is 1, torch's own default. `OMP_NUM_THREADS` carries the same cap to the
node processes that the process-deployment tests spawn.
"""
import os

import torch


def worker_threads():
    n_workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    return max(1, (os.cpu_count() or 1) // n_workers)


N_THREADS = worker_threads()
torch.set_num_threads(N_THREADS)
if "PYTEST_XDIST_WORKER_COUNT" in os.environ:
    os.environ.setdefault("OMP_NUM_THREADS", str(N_THREADS))
