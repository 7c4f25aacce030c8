"""Builds the hand-written Hopper kernels of ``csrc/`` and binds them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own with ``nvcc -gencode
arch=compute_90a,code=sm_90a -O3 -shared`` into
``hydrainfer_tpu_torch/_build/<name>-<hash>.so`` (the directory is
git-ignored). The hash covers the source, the shared headers and the flags, so
an edited source rebuilds and an unchanged one is loaded as it is. The first
call to a kernel builds its library; ``build_all`` starts one nvcc per source
at once. Nothing here runs when the module is imported.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

import torch

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
KERNELS = ("mha_decode", "paged_attention", "kv_writer", "quant_matmul", "mha_varlen",
           "paged_attention_latent", "quant_matmul_int4", "quant_matmul_fp8")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v"]

# dtype codes shared with csrc/common.cuh:DTypeCode
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C signatures of the entry points (every one returns the launch's cudaError_t)
SIGNATURES = {
    "mha_decode": ("hydra_mha_decode", [_P] * 8 + [_I] * 8 + [_F] * 3 + [_I, _I, _P]),
    "paged_attention": ("hydra_paged_attention",
                        [_P] * 7 + [_I] * 7 + [_F] * 3 + [_I, _I, _P]),
    "kv_writer": ("hydra_kv_write",
                  [_P, _P, _L, _L, _P, _P] + [_I] * 7 + [_L, _I, _L, _I, _F, _P]),
    "quant_matmul": ("hydra_quant_matmul", [_P] * 4 + [_I] * 8 + [_P]),
    "quant_matmul_int4": ("hydra_quant_matmul_int4", [_P] * 4 + [_I] * 9 + [_P]),
    "quant_matmul_fp8": ("hydra_quant_matmul_fp8", [_P] * 4 + [_I] * 9 + [_P]),
    "mha_varlen": ("hydra_mha_varlen",
                   [_P] * 4 + [_L] * 4 + [_P] * 5 + [_I] * 4 + [_F, _I, _P]),
    "paged_attention_latent": ("hydra_paged_attention_latent",
                               [_P] * 9 + [_I] * 7 + [_F] * 2 + [_I, _I, _P]),
}

_lock = threading.Lock()
_fns: Dict[str, ctypes._CFuncPtr] = {}
# what the last build printed per kernel (ptxas register/spill report)
build_logs: Dict[str, str] = {}


def nvcc_path() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                           "the CUDA toolkit is installed")
    return path


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for part in ((CSRC_DIR / f"{name}.cu").read_bytes(),
                 *(p.read_bytes() for p in sorted(CSRC_DIR.glob("*.cuh"))),
                 " ".join(NVCC_FLAGS).encode()):
        h.update(part)
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Iterable[str] = KERNELS) -> Dict[str, float]:
    """Compile every named library that is missing, one nvcc per source, all
    started together. Returns the seconds each build took (0.0 = cached)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs, seconds = {}, {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if out.exists():
            seconds[name] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        build_logs[name] = log
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return seconds


def kernel_fn(name: str):
    """The ctypes entry point of kernel library `name`, built on first use."""
    fn = _fns.get(name)
    if fn is not None:
        return fn
    with _lock:
        if name not in _fns:
            path = library_path(name)
            if not path.exists():
                build_all([name])
            symbol, argtypes = SIGNATURES[name]
            fn = getattr(ctypes.CDLL(str(path)), symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _fns[name] = fn
    return _fns[name]


def launch(name: str, *args) -> None:
    """Call kernel `name` on the current stream; raise if the launch failed."""
    err = kernel_fn(name)(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed (error {err})")


def ptr(t) -> int:
    """A tensor's device address, or 0 (NULL) for an absent operand."""
    return 0 if t is None else t.data_ptr()


def dtype_code(t: torch.Tensor, allowed: Iterable[torch.dtype]) -> int:
    if t.dtype not in allowed:
        raise TypeError(f"dtype {t.dtype} not supported here "
                        f"(takes {sorted(str(d) for d in allowed)})")
    return DTYPE_CODES[t.dtype]


def check_cuda(*tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {t.device} vs {dev}")
        if not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous")
