"""Build the port's CUDA kernels at first use.

Each kernel library is one `.cu` file under `csrc/` with a plain C
interface, compiled by nvcc into a shared library and loaded with ctypes.
Libraries go to `blindshadowremoval_tpu_torch/_build/`, named by a hash of
their source, every header it includes from `csrc/` and the flags, so an
edited source or header rebuilds and an unchanged one is reused.  Nothing is
built when a module is imported: `load` builds on the first launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
BUILD_DIR = _PKG / "_build"

# library name -> its source, relative to the package
SOURCES = {"nonlocal_attn": "csrc/nonlocal_attn.cu",
           "nonlocal_attn_bwd": "csrc/nonlocal_attn_bwd.cu",
           "rasterize": "csrc/rasterize.cu"}

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


_QUOTED_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def source_files(name: str) -> list[Path]:
    """The source of library `name` and every file it includes with
    quotes, directly or not, each resolved beside the file that includes
    it; in the order found."""
    found: list[Path] = []
    todo = [(_PKG / SOURCES[name]).resolve()]
    while todo:
        path = todo.pop(0)
        if path in found:
            continue
        found.append(path)
        todo += [(path.parent / inc).resolve()
                 for inc in _QUOTED_INCLUDE.findall(path.read_text())]
    return found


def library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for path in source_files(name):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _start(name: str, force: bool = False):
    """(process, temporary output) of nvcc building library `name`, or None
    when it is built already and `force` is false."""
    so = library_path(name)
    if so.is_file() and not force:
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


def build_all(force: bool = False) -> dict[str, str]:
    """Compile every library not built yet (every library when `force`),
    one nvcc per source, all started together.  Returns {name: nvcc
    output}.  Every nvcc started is waited for before a failure raises."""
    started = {name: _start(name, force) for name in SOURCES}
    logs, failed = {}, []
    for name, proc in started.items():
        try:
            logs[name] = _finish(name, proc)
        except RuntimeError as e:
            failed.append(e)
    if failed:
        raise failed[0]
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library `name`, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build(name)
            lib = ctypes.CDLL(str(library_path(name)))
            # every library exports it, for raise_on_error
            lib.bsr_cuda_error_string.argtypes = [ctypes.c_int]
            lib.bsr_cuda_error_string.restype = ctypes.c_char_p
            _loaded[name] = lib
        return lib


def raise_on_error(err: int, lib: ctypes.CDLL, name: str) -> None:
    """Raises unless `err`, the cudaError_t value a launch of `lib`
    returned, is 0 (success)."""
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed: "
                           + lib.bsr_cuda_error_string(err).decode()
                           + f" (error {err})")
