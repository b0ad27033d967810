"""Build the port's CUDA kernels at first use.

Each kernel library is one `.cu` file under `csrc/` with a plain C
interface, compiled by nvcc into a shared library and loaded with ctypes.
Libraries go to `blindshadowremoval_tpu_torch/_build/`, named by a hash of
their source and flags, so an edited source rebuilds and an unchanged one
is reused.  Nothing is built when a module is imported: `load` builds on the
first launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
BUILD_DIR = _PKG / "_build"

# library name -> its source, relative to the package
SOURCES = {"nonlocal_attn": "csrc/nonlocal_attn.cu",
           "nonlocal_attn_bwd": "csrc/nonlocal_attn_bwd.cu"}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((os.path.join(home, "bin", "nvcc") if home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    src = (_PKG / SOURCES[name]).read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def _start(name: str):
    """(process, temporary output) of nvcc building library `name`, or None
    when it is built already."""
    so = library_path(name)
    if so.is_file():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_PKG / SOURCES[name])],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp


def _finish(name: str, started) -> str:
    if started is None:
        return ""
    proc, tmp = started
    log = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError(f"kernel build failed: {name} (nvcc exit "
                           f"{proc.returncode}):\n{log}")
    os.replace(tmp, library_path(name))   # atomic: a concurrent loader
    return log                            # sees all or none


def build(name: str) -> str:
    """Compile library `name` unless it is built already.  Returns nvcc's
    output (ptxas's register and shared-memory report), "" when nothing was
    built; raises with that output when nvcc fails."""
    return _finish(name, _start(name))


def build_all() -> dict[str, str]:
    """Compile every library not built yet, one nvcc per source, all
    started together.  Returns {name: nvcc output}."""
    started = {name: _start(name) for name in SOURCES}
    return {name: _finish(name, proc) for name, proc in started.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library `name`, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build(name)
            lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
        return lib
