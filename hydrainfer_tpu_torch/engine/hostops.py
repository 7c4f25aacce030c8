"""Builds and loads the native host packer (csrc/hostops.cpp).

The source is a plain CPython extension, so the host C++ compiler builds it
in about a second: ``c++ -O3 -std=c++17 -shared -fPIC`` with Python's include
directory, into ``hydrainfer_tpu_torch/_build/hostops-<hash><EXT_SUFFIX>``
(git-ignored). The hash covers the source, the compiler, the flags and the
interpreter's extension suffix, so an edited source rebuilds and an
unchanged one is loaded as it is. The library is written under a temporary
name and renamed, so processes that build it at once do not clash. It is
built at the first `load()`, never at import, and a failed build raises with
the compiler's output: the engine does not fall back to the Python packer.
"""
import hashlib
import importlib.machinery
import importlib.util
import os
import shutil
import subprocess
import sysconfig
import threading
import time
from pathlib import Path
from typing import Optional

PKG_DIR = Path(__file__).resolve().parents[1]
SOURCE = PKG_DIR / "csrc" / "hostops.cpp"
BUILD_DIR = PKG_DIR / "_build"
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

_lock = threading.Lock()
_module = None
# seconds the build took in this process (0.0: the library was already
# there), None before the first load
build_seconds: Optional[float] = None


def compiler() -> str:
    cxx = os.environ.get("CXX") or shutil.which("c++") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("no C++ compiler (c++ or g++, or $CXX) to build "
                           f"the native host packer {SOURCE}")
    return cxx


def library_path(cxx: str) -> Path:
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    h = hashlib.sha256()
    for part in (SOURCE.read_bytes(), cxx.encode(), " ".join(CXX_FLAGS).encode(),
                 suffix.encode()):
        h.update(part)
    return BUILD_DIR / f"hostops-{h.hexdigest()[:16]}{suffix}"


def build() -> Path:
    """Compile the library unless it is there; return its path."""
    global build_seconds
    cxx = compiler()
    out = library_path(cxx)
    if out.exists():
        build_seconds = 0.0
        return out
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [cxx, *CXX_FLAGS, f"-I{sysconfig.get_paths()['include']}",
           "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native host packer build failed ({' '.join(cmd)}):\n"
                           f"{proc.stdout}")
    os.replace(tmp, out)
    build_seconds = time.perf_counter() - t0
    return out


def load():
    """The extension module, built on first use."""
    global _module
    if _module is None:
        with _lock:
            if _module is None:
                path = build()
                loader = importlib.machinery.ExtensionFileLoader("hostops", str(path))
                spec = importlib.util.spec_from_file_location("hostops", str(path),
                                                              loader=loader)
                module = importlib.util.module_from_spec(spec)
                loader.exec_module(module)
                _module = module
    return _module
