"""Host crop + resize and flip (port of
`blindshadowremoval_tpu/utils/native.py`).

`native/loader.cc` (the JAX package's source, copied unchanged) holds
zero-padded crop + half-pixel bilinear resize, horizontal flip and a
thread-pooled batched crop.  It is compiled by g++ at first use with the
JAX package's flags (`GXX_FLAGS`: at -O3 -march=native g++ contracts the
lerps to FMAs, so only the same flags give the same bits) into
`blindshadowremoval_tpu_torch/_build/`, under a name keyed by the source,
the flags and the host CPU, and bound with ctypes.

Every function takes the library whenever it loads, as the JAX package's
do; the numpy versions (`_crop_resize_np`, equal bit for bit to the JAX
package's fallback) run only when g++ is absent or the build fails, and
the first such call warns with the cause.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
import warnings
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "native" / "loader.cc"
BUILD_DIR = _PKG / "_build"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib = None
_tried = False


def _host_cpu() -> bytes:
    """What -march=native tunes for: the machine and /proc/cpuinfo's first
    model name and flags lines (a library built for one CPU may not run on
    another)."""
    ident = platform.machine().encode()
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = f.read().splitlines()
    except OSError:
        return ident
    for tag in (b"model name", b"flags"):
        ident += next((ln for ln in lines if ln.startswith(tag)), b"")
    return ident


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(GXX_FLAGS).encode() + b"\0" + _host_cpu())
    return BUILD_DIR / f"libbsrloader-{digest.hexdigest()[:16]}.so"


def _build(so: Path) -> None:
    """Compile the library into `so`; raises with g++'s output on a
    failure, FileNotFoundError when there is no g++."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ exit {proc.returncode}: {proc.stderr[-2000:]}")
    os.replace(tmp, so)      # atomic: a concurrent loader sees all or none


def get_lib():
    """The loaded library, built at first use; None when g++ is absent or
    the build fails (the first call warns, naming the cause)."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so = library_path()
        try:
            if not so.is_file():
                _build(so)
            lib = ctypes.CDLL(str(so))
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            warnings.warn(f"the native loader is unavailable ({e}); host "
                          "crops run in numpy", RuntimeWarning, stacklevel=2)
            return None
        fp = ctypes.POINTER(ctypes.c_float)
        ip = ctypes.POINTER(ctypes.c_int)
        i = ctypes.c_int
        lib.crop_resize_bilinear.argtypes = [fp, i, i, i, ip, fp, i]
        lib.crop_resize_bilinear.restype = None
        lib.hflip.argtypes = [fp, i, i, i, fp]
        lib.hflip.restype = None
        lib.batch_crop_resize.argtypes = [fp, i, i, i, i, ip, fp, i, i]
        lib.batch_crop_resize.restype = None
        _lib = lib
        return _lib


def _fp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _ip(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))


def _box(box) -> np.ndarray:
    box = np.ascontiguousarray(np.asarray(box, np.int32))
    if box.shape[-1:] != (4,):
        raise ValueError(f"boxes are (x0, y0, x1, y1), got shape {box.shape}")
    return box


def crop_resize(img: np.ndarray, box, size: int) -> np.ndarray:
    """Zero-padded crop of `box` (x0, y0, x1, y1) of img[H, W, C] plus a
    bilinear resize to (size, size): the native library, numpy without
    it."""
    img = np.ascontiguousarray(img, np.float32)
    lib = get_lib()
    if lib is None:
        return _crop_resize_np(img, box, size)
    h, w, c = img.shape
    out = np.empty((size, size, c), np.float32)
    lib.crop_resize_bilinear(_fp(img), h, w, c, _ip(_box(box)), _fp(out),
                             size)
    return out


def _crop_resize_np(img: np.ndarray, box, size: int) -> np.ndarray:
    """The numpy version of `crop_resize`, with f64 positions."""
    img = np.ascontiguousarray(img, np.float32)
    x0, y0, x1, y1 = [int(v) for v in box]
    h, w, _ = img.shape
    ys = y0 + (np.arange(size) + 0.5) * (y1 - y0) / size - 0.5
    xs = x0 + (np.arange(size) + 0.5) * (x1 - x0) / size - 0.5
    yy0 = np.floor(ys).astype(np.int64)
    xx0 = np.floor(xs).astype(np.int64)
    fy = (ys - yy0)[:, None, None]
    fx = (xs - xx0)[None, :, None]

    def take(yi, xi):
        valid = ((yi[:, None] >= 0) & (yi[:, None] < h)
                 & (xi[None, :] >= 0) & (xi[None, :] < w))
        ycl = np.clip(yi, 0, h - 1)
        xcl = np.clip(xi, 0, w - 1)
        vals = img[ycl[:, None], xcl[None, :], :]
        return vals * valid[..., None]

    v00 = take(yy0, xx0)
    v01 = take(yy0, xx0 + 1)
    v10 = take(yy0 + 1, xx0)
    v11 = take(yy0 + 1, xx0 + 1)
    top = v00 * (1 - fx) + v01 * fx
    bot = v10 * (1 - fx) + v11 * fx
    return (top * (1 - fy) + bot * fy).astype(np.float32)


def batch_crop_resize(imgs: np.ndarray, boxes, size: int,
                      n_threads: int = 0) -> np.ndarray:
    """`crop_resize` of each of imgs[N, H, W, C] by its box of boxes[N, 4],
    over `n_threads` threads (default: one a core, at most N)."""
    imgs = np.ascontiguousarray(imgs, np.float32)
    n, h, w, c = imgs.shape
    boxes = _box(boxes)
    if boxes.shape != (n, 4):
        raise ValueError(f"{n} images need boxes of shape ({n}, 4), got "
                         f"{boxes.shape}")
    lib = get_lib()
    if lib is None:
        return np.stack([_crop_resize_np(imgs[i], boxes[i], size)
                         for i in range(n)])
    if n_threads <= 0:
        n_threads = min(os.cpu_count() or 1, n)
    out = np.empty((n, size, size, c), np.float32)
    lib.batch_crop_resize(_fp(imgs), n, h, w, c, _ip(boxes), _fp(out), size,
                          n_threads)
    return out


def hflip(img: np.ndarray) -> np.ndarray:
    """img[H, W, C] mirrored left to right."""
    img = np.ascontiguousarray(img, np.float32)
    lib = get_lib()
    if lib is None:
        return np.ascontiguousarray(img[:, ::-1])
    h, w, c = img.shape
    out = np.empty_like(img)
    lib.hflip(_fp(img), h, w, c, _fp(out))
    return out
