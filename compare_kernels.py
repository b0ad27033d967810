"""Times the port's attention kernels against the same kernels built from
another checkout's sources, in turns on one NVIDIA GPU.

    git archive <commit> blindshadowremoval_tpu_torch/csrc \
        | tar -x -C runs/parent
    python3 compare_kernels.py runs/parent/blindshadowremoval_tpu_torch/csrc

Builds both checkouts' `nonlocal_attn.cu` and `nonlocal_attn_bwd.cu` with
this checkout's nvcc flags (one nvcc per source, all started together),
loads each library through its own C interface (the forward's workspace
argument is newer than some checkouts), and at every
(kernel, shape) of SHAPES times the other checkout's kernel and this one's
in turns (other, this, this, other), each turn the device time a call with
the calls queued ahead.  Prints one line a cell with both times and the
largest difference between the two outputs; then K1's host time a launch
at LAUNCH_SHAPES, in the same turns; then the card's name and power limit.
Operands are 0.3 randn (dout randn), made on the card from a seed.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

from blindshadowremoval_tpu_torch.ops import _build
from blindshadowremoval_tpu_torch.tools._timing import device_ms

LIBS = ("nonlocal_attn", "nonlocal_attn_bwd")
# (kernel, shape, dtype): K1 f32 at every shape the evaluators, goldens and
# f32 train steps launch it at, K2 f32 at the train steps' shapes and a
# full-width step's
SHAPES = ([("K1", (b, 1024, 128), torch.float32)
           for b in (1, 2, 4, 5, 8, 10, 16, 40, 80)]
          + [("K1", s, torch.float32) for s in
             [(10, 1024, 256), (80, 1024, 256), (2, 256, 128),
              (1, 256, 256), (4, 64, 128), (8, 64, 128), (8, 64, 256)]]
          + [("K2", s, torch.float32) for s in
             [(4, 64, 128), (8, 64, 128), (8, 64, 256), (64, 1024, 128),
              (64, 1024, 256)]])
ITERS = 20
# K1's launch from the host at batches whose calls are shorter than their
# launch: microseconds of host time a call, LAUNCHES calls queued without
# waiting (the device's queue of pending launches holds a few hundred)
LAUNCH_SHAPES = [((2, 1024, 128), torch.bfloat16),
                 ((16, 1024, 128), torch.bfloat16),
                 ((2, 1024, 128), torch.float32)]
LAUNCHES = 100
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def build(csrc: Path, out: Path) -> dict:
    """{library: ctypes.CDLL} of the sources under `csrc`, built into
    `out`."""
    out.mkdir(parents=True, exist_ok=True)
    procs = {name: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out / f"{name}.so"),
         str(csrc / f"{name}.cu")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for name in LIBS}
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"{csrc}/{name}.cu failed to build:\n{log}")
        lib = libs[name] = ctypes.CDLL(str(out / f"{name}.so"))
        if name == "nonlocal_attn":
            # the forward's workspace argument is newer than some checkouts
            lib.has_workspace = hasattr(lib,
                                        "bsr_nonlocal_attn_fwd_workspace")
            lib.bsr_nonlocal_attn_fwd.argtypes = (
                [ctypes.c_void_p] * (6 if lib.has_workspace else 5)
                + [ctypes.c_int] * 4 + [ctypes.c_void_p])
            if lib.has_workspace:
                lib.bsr_nonlocal_attn_fwd_workspace.argtypes = (
                    [ctypes.c_int] * 4)
                lib.bsr_nonlocal_attn_fwd_workspace.restype = (
                    ctypes.c_longlong)
        else:
            lib.bsr_nonlocal_attn_bwd.argtypes = (
                [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4
                + [ctypes.c_void_p])
            lib.bsr_nonlocal_attn_bwd_workspace.argtypes = [ctypes.c_int] * 4
            lib.bsr_nonlocal_attn_bwd_workspace.restype = ctypes.c_longlong
    return libs


def calls(libs: dict, kernel: str, shape: tuple, dtype, ops: list):
    """(a call of `kernel` from `libs` on `ops`, its outputs)."""
    b, n, d = shape
    t, p, g, do = ops
    code = _DTYPE_CODE[dtype]
    stream = torch.cuda.current_stream().cuda_stream
    k1 = libs["nonlocal_attn"]
    extra = []
    if k1.has_workspace:
        floats = k1.bsr_nonlocal_attn_fwd_workspace(b, n, d, code)
        work1 = torch.empty(max(floats, 1), dtype=torch.float32,
                            device=t.device)
        extra = [work1.data_ptr() if floats else None]

    def fwd(lse_ptr):
        return k1.bsr_nonlocal_attn_fwd(t.data_ptr(), p.data_ptr(),
                                        g.data_ptr(), out.data_ptr(),
                                        lse_ptr, *extra, b, n, d, code,
                                        stream)

    out = torch.empty_like(t)
    lse = torch.empty((b, n), dtype=torch.float32, device=t.device)
    if fwd(lse.data_ptr()) != 0:
        raise SystemExit(f"K1 failed at {shape}")
    if kernel == "K1":
        return (lambda: fwd(None), [out])
    lib = libs["nonlocal_attn_bwd"]
    work = torch.empty(max(lib.bsr_nonlocal_attn_bwd_workspace(b, n, d,
                                                               code), 1),
                       dtype=torch.float32, device=t.device)
    grads = [torch.empty_like(t) for _ in range(3)]
    return (lambda: lib.bsr_nonlocal_attn_bwd(
        t.data_ptr(), p.data_ptr(), g.data_ptr(), out.data_ptr(),
        do.data_ptr(), lse.data_ptr(), work.data_ptr(),
        *(x.data_ptr() for x in grads), b, n, d, code, stream), grads)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", help="the other checkout's "
                    "blindshadowremoval_tpu_torch/csrc directory")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare_kernels: no CUDA device", file=sys.stderr)
        return 1
    here = (Path(__file__).resolve().parent / "blindshadowremoval_tpu_torch"
            / "csrc")
    with tempfile.TemporaryDirectory() as tmp:
        sides = {"other": build(Path(args.other), Path(tmp) / "other"),
                 "this": build(here, Path(tmp) / "this")}
        dev = torch.device("cuda")
        gen = torch.Generator(device=dev).manual_seed(0)
        for kernel, shape, dtype in SHAPES:
            ops = [0.3 * torch.randn(*shape, generator=gen, device=dev)
                   for _ in range(3)]
            ops = [x.to(dtype) for x in
                   ops + [torch.randn(*shape, generator=gen, device=dev)]]
            fns, outs = {}, {}
            for side, libs in sides.items():
                fns[side], outs[side] = calls(libs, kernel, shape, dtype, ops)
                fns[side]()
            torch.cuda.synchronize()
            diff = max((a.float() - b.float()).abs().max().item()
                       for a, b in zip(outs["other"], outs["this"]))
            times = {side: [] for side in sides}
            for side in ("other", "this", "this", "other"):
                times[side].append(device_ms(fns[side], ITERS))
            print(f"{kernel} {shape} {str(dtype).split('.')[-1]}: other "
                  f"{', '.join(f'{x:.4f}' for x in times['other'])} ms, "
                  f"this {', '.join(f'{x:.4f}' for x in times['this'])} ms "
                  f"(this / other "
                  f"{min(times['this']) / min(times['other']):.3f}), "
                  f"max |this - other| {diff:.3e}", flush=True)
            del ops, outs, fns
        for shape, dtype in LAUNCH_SHAPES:
            ops = [(0.3 * torch.randn(*shape, generator=gen, device=dev)
                    ).to(dtype) for _ in range(4)]
            fns = {side: calls(libs, "K1", shape, dtype, ops)[0]
                   for side, libs in sides.items()}
            times = {side: [] for side in sides}
            for side in ("other", "this", "this", "other"):
                fns[side]()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(LAUNCHES):
                    fns[side]()
                times[side].append(1e6 * (time.perf_counter() - t0)
                                   / LAUNCHES)
                torch.cuda.synchronize()
            print(f"K1 launch {shape} {str(dtype).split('.')[-1]}: host "
                  f"us a call, other "
                  f"{', '.join(f'{x:.2f}' for x in times['other'])}, this "
                  f"{', '.join(f'{x:.2f}' for x in times['this'])}",
                  flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
