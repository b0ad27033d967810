"""glibc's malloc tunables for the process that hosts a cell, set from the
cell's traffic file (`"malloc": {"M_MMAP_THRESHOLD": bytes, ...}`).

With glibc's defaults, each allocation over its (moving) mmap threshold is
a fresh mapping, and memory freed above its trim threshold goes back to
the kernel, so the served path's large host buffers (a photo copied to
f32, a padded batch, the fetched outputs) fault their pages in anew on
every request, from the frontend's two threads at once.  A threshold
above those buffers keeps them in the heap, which then reuses what was
freed.  `apply` calls `mallopt(3)` once a key and returns what undoes it:
each parameter back at the value mallopt(3) documents as the default.
"""

from __future__ import annotations

import ctypes
import ctypes.util
from typing import Callable

# mallopt(3)'s parameter numbers and documented defaults
PARAMS = {"M_TRIM_THRESHOLD": -1, "M_TOP_PAD": -2, "M_MMAP_THRESHOLD": -3}
DEFAULTS = {"M_TRIM_THRESHOLD": 128 * 1024, "M_TOP_PAD": 128 * 1024,
            "M_MMAP_THRESHOLD": 128 * 1024}


def _mallopt() -> Callable[[int, int], int]:
    libc = ctypes.CDLL(ctypes.util.find_library("c") or "libc.so.6")
    fn = libc.mallopt
    fn.argtypes, fn.restype = (ctypes.c_int, ctypes.c_int), ctypes.c_int
    return fn


def apply(settings: dict, mallopt=None) -> Callable[[], None]:
    """Set each of `settings` ({name: bytes}); raises when glibc refuses
    one (mallopt returns 0), so a run never measures settings it did not
    get.  Returns the function that puts the defaults back."""
    unknown = set(settings) - set(PARAMS)
    if unknown:
        raise ValueError(f"unknown malloc settings {sorted(unknown)}")
    fn = mallopt or _mallopt()

    def put(values: dict) -> None:
        for name, value in values.items():
            if fn(PARAMS[name], int(value)) != 1:
                raise RuntimeError(f"mallopt refused {name}={value}")

    put(settings)
    return lambda: put({n: DEFAULTS[n] for n in settings})
