"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's hand-written kernels from the sources in this checkout
(one nvcc per source, started together) and fails if ptxas serialises the
wgmma of an attention kernel or spills a bf16 one, or if an f32 one runs
no TF32 product on the tensor cores (its SASS, by cuobjdump; its
registers and spills are printed), holds each kernel against
its plain PyTorch version on the card and times it in turns with flash
SDPA, forward and backward, runs the GSC
generator against the TF-reference golden, serves a batch of requests
through `ShadowRemovalService` (the serving path, counting kernel launches),
times the bench.py configuration, runs the GSC GAN train step at full width
(the train path, counting launches of the forward and backward kernels) and
an f32 step of each variant against the same step on the CPU, drives
the evaluation path
(SFW-GSC AUC and SFW video against the TF-reference goldens, in-the-wild,
and UCB with the heuristic post-processor, host-orchestrated and fused k
images a pass, on a synthetic UCB tree) with K1 held and timed at the
evaluation batches, drives the TSM and RGB generators through the same
entry points (forward goldens, SFW-TSM, TSM video, TSM and RGB UCB, both
services, both train steps) with K1 held and timed at their batches and
K1 and K2 held on an RGB step's own operands, trains end to end through
`fit` on a synthetic training tree (both train wires, the val pass, the
UCB probe, the checkpoint restored bitwise, a resume, the trained
generator served; phase 13), takes raw photos to deshadowed faces
(phase 14: `DeshadowPipeline.run_dir` with the S3FD detector and the 2D-FAN
aligner on seeded weights, overlapped and serial, against the CPU's f32
pipeline; the detector and aligner in f32 against the CPU; the
`BatchingFrontend` under client threads), runs every subcommand of
`python -m blindshadowremoval_tpu_torch` (phase 15: train, infer with both
engines and the int8 head, ucb, sfw, sfw-video, preprocess, landmarks and
e2e, each against the same call through the library; the int8 head's
int32 accumulators against their plain version), runs over more than one
device (phase 16: the service over a mesh of two entries on the card
against one device; the full-width sharded train step through one NCCL
rank; then two gloo ranks, processes of their own sharing the card, with
the full-width sharded step bitwise equal across the ranks after each
step, an f32 sharded step against the one-process step, the TSM video
forward with the collective ShareLayer against the local one, and K1 and
K2 at every shape these runs gave them against their plain versions), runs
the rest of the port (phase 17: the committed TF bundle read without
TensorFlow, bitwise against its synthetic values, and loaded into the
discriminators and the golden generator; the g++ native loader, which must
load, against numpy and timed; the fused UCB step of 8 images over a (2,)
mesh on the card against the one-device step; bench.py's forward with
`s2d_convs` off and on and the packed decoder tail against the direct
one, in turns; K1 at every shape these runs gave it), runs every
measurement tool of `blindshadowremoval_tpu_torch/tools/` once (phase 18:
one JSON record each; the profilers must name K1, and for training K2;
K1 and K2 at every shape the tools gave them), times K1 and K2 against
their plain versions, SDPA and the bound at every (shape, dtype) phases
9 to 18 launched them at and K1 (with the logsumexp) and K2 in f32 at a
full-width f32 train step's shapes, and, after phases 13 to 18, prints one
JSON line with every kernel and, last,
`{"ok": true, "device": {...}}`.  Any failure ends the run with a non-zero
exit and no result line.  Exits 1 at once when CUDA
is absent.  Imports nothing of JAX or of the JAX package.

    python3 chip_smoke.py --parallel-rank ADDR RANK WORK

is one of phase 16's gloo ranks, started by phase 16 itself.
"""

from __future__ import annotations

import contextlib
import dataclasses
import glob as glob_module
import inspect
import io
import json
import os
import re
import socket
import subprocess
import sys
import tempfile
import threading
import time
import types
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel
from torch.utils._python_dispatch import TorchDispatchMode

from blindshadowremoval_tpu_torch import cli
from blindshadowremoval_tpu_torch import config as config_module
from blindshadowremoval_tpu_torch.config import get_config
from blindshadowremoval_tpu_torch.data.dataset import Dataset
from blindshadowremoval_tpu_torch.data.synthesis import (
    compose_from_draws,
    darkened_views_from_draws,
    derive_darkened_views,
    draw_compose,
)
from blindshadowremoval_tpu_torch.eval.evaluators import (
    InTheWildEvaluator,
    SFWEvaluator,
    SFWVideoEvaluator,
    UCBEvaluator,
)
from blindshadowremoval_tpu_torch.eval.fused import (
    PartInputs,
    build_fused_ucb_batch_step,
    dynamic_resize_matrix,
    fused_postprocess,
    prep_part_inputs,
    resize_into_box,
)
from blindshadowremoval_tpu_torch.eval.e2e import DeshadowPipeline
from blindshadowremoval_tpu_torch.eval.postprocess import PostprocessParams
from blindshadowremoval_tpu_torch.eval.serving import (
    BatchingFrontend,
    ShadowRemovalService,
)
from blindshadowremoval_tpu_torch.geometry.crop import offline_crop
from blindshadowremoval_tpu_torch.geometry.landmarks import LM_REF
from blindshadowremoval_tpu_torch.geometry.triangulation import (
    device_geometry_maps,
    generate_face_region,
    generate_uv_map,
)
from blindshadowremoval_tpu_torch.models import blocks as blocks_module
from blindshadowremoval_tpu_torch.models import GENERATORS, build_generator
from blindshadowremoval_tpu_torch.models import generator as generator_module
from blindshadowremoval_tpu_torch.models import (
    generator_rgb as generator_rgb_module,
)
from blindshadowremoval_tpu_torch.models.blocks import frozen_stats
from blindshadowremoval_tpu_torch.models.discriminator import (
    MultiScaleDiscriminators,
)
from blindshadowremoval_tpu_torch.models.fan import (
    LandmarkAligner,
    box_to_center_scale,
    build_fan,
    crop_for_fan,
    decode_heatmaps,
    landmarks_from_image,
    load_fan_npz,
)
from blindshadowremoval_tpu_torch.models.sfd import (
    FaceDetector,
    build_s3fd,
    detect_faces,
    letterbox,
    load_sfd_npz,
)
from blindshadowremoval_tpu_torch.models.sfd import nms as sfd_nms
from blindshadowremoval_tpu_torch.models.generator_tsm import TSMGenerator
from blindshadowremoval_tpu_torch.models.tf_checkpoint import (
    VAL_SUFFIX,
    list_variables,
    load_tf_checkpoint,
    read_bundle,
    verify_against_index,
)
from blindshadowremoval_tpu_torch.models.vgg import preprocess
from blindshadowremoval_tpu_torch.models.weights import (
    discriminator_mapping,
    fan_from_jax,
    generator_mapping,
    load_tf_weights,
    sfd_from_jax,
    synthetic_fan_weights,
    synthetic_sfd_weights,
    synthetic_tf_weights,
)
from blindshadowremoval_tpu_torch.ops import _build, packed, quant
from blindshadowremoval_tpu_torch.ops import nonlocal_attn as attn_module
from blindshadowremoval_tpu_torch.ops.nonlocal_attn import (
    KERNEL_TOLERANCE,
    SUPPORTED_D,
    PlainRoute,
    _launch_fwd,
    bwd_tolerance,
    nonlocal_attention,
    nonlocal_attention_bwd,
    nonlocal_attention_bwd_reference,
    nonlocal_attention_lse_reference,
    nonlocal_attention_reference,
)
from blindshadowremoval_tpu_torch.ops.calibration import calibrate_config
from blindshadowremoval_tpu_torch.ops.filters import find_edge
from blindshadowremoval_tpu_torch.ops.image import dequantize
from blindshadowremoval_tpu_torch.ops.image import psnr as psnr_fn
from blindshadowremoval_tpu_torch.ops.image import rgb_to_grayscale
from blindshadowremoval_tpu_torch.ops.image import ssim as ssim_fn
from blindshadowremoval_tpu_torch.ops.tonecurve import draw_face_darken
from blindshadowremoval_tpu_torch.parallel import distributed
from blindshadowremoval_tpu_torch.parallel.mesh import make_mesh
from blindshadowremoval_tpu_torch.train import loop as train_loop
from blindshadowremoval_tpu_torch.train import trainer as trainer_module
from blindshadowremoval_tpu_torch.train.losses import (
    multi_scale_gradient_loss,
    reconstruction_losses,
)
from blindshadowremoval_tpu_torch.train.trainer import LOSS_NAMES, Trainer
from blindshadowremoval_tpu_torch.tools import _timing
from blindshadowremoval_tpu_torch.tools import bench as tools_bench
from blindshadowremoval_tpu_torch.tools import bench_e2e as tools_e2e
from blindshadowremoval_tpu_torch.tools import bench_fit as tools_bench_fit
from blindshadowremoval_tpu_torch.tools import (
    bench_int8_decoder as tools_int8,
)
from blindshadowremoval_tpu_torch.tools import (
    bench_landmarks as tools_landmarks,
)
from blindshadowremoval_tpu_torch.tools import (
    bench_packed_tail as tools_packed,
)
from blindshadowremoval_tpu_torch.tools import (
    bench_serving_frontend as tools_frontend,
)
from blindshadowremoval_tpu_torch.tools import bench_sweep as tools_sweep
from blindshadowremoval_tpu_torch.tools import (
    bench_train as tools_bench_train,
)
from blindshadowremoval_tpu_torch.tools import bench_ucb_eval as tools_ucb
from blindshadowremoval_tpu_torch.tools import (
    calibrate_int8_head as tools_calibrate,
)
from blindshadowremoval_tpu_torch.tools import parity_serving as tools_parity
from blindshadowremoval_tpu_torch.tools import (
    profile_infer as tools_profile_infer,
)
from blindshadowremoval_tpu_torch.tools import (
    profile_train as tools_profile_train,
)
from blindshadowremoval_tpu_torch.tools import (
    roofline_infer as tools_roofline,
)
from blindshadowremoval_tpu_torch.tools._timing import (
    PEAK_BF16_FLOPS,
    PEAK_BYTES,
    PEAK_TF32_FLOPS,
    device_ms,
    kernel_kind,
)
from blindshadowremoval_tpu_torch.utils import native, profiling
from blindshadowremoval_tpu_torch.utils.checkpoint import CheckpointManager
from blindshadowremoval_tpu_torch.utils.imageio import (
    imread,
    read_png,
    resize_linear_u8,
    write_png,
)
from blindshadowremoval_tpu_torch.utils.logging import TrainLogger

ROOT = Path(__file__).resolve().parent
TF_REF = ROOT / "tests" / "goldens" / "tf_ref"
GOLDEN = TF_REF / "e2e_eval.npz"

SERVE_BATCH = 64
SERVE_REQUESTS = 70          # one full batch and one padded tail
BENCH_BATCH = 128            # bench.py's shape
BENCH_ITERS = 20
ATTN_CALLS_PER_FORWARD = 6   # one NonLocal block per ResBottleneck

# kernel vs plain version, each within KERNEL_TOLERANCE[dtype] (its
# derivation sits beside it in ops/nonlocal_attn.py)
ATTN_CASES = [((128, 1024, 128), torch.bfloat16),   # bench batch
              ((64, 1024, 128), torch.bfloat16),    # serve batch
              ((4, 1024, 128), torch.float32),
              ((2, 200, 128), torch.bfloat16),      # ragged N
              ((2, 1024, 256), torch.bfloat16),     # RGB's width
              ((2, 1, 128), torch.bfloat16),        # one row
              ((2, 129, 128), torch.bfloat16),      # one row past a tile
              ((2, 129, 256), torch.bfloat16),      # ragged 64-key tiles
              ((3, 200, 128), torch.bfloat16)]      # batch boundary, below
# in this case batch element 1 is 50 randn, its neighbours 0.3 randn: a
# ragged tile that read the next element's keys, or a store past row N,
# would move the whole output out of tolerance
BOUNDARY_SHAPE = (3, 200, 128)
# K1 timed at (shape, with the logsumexp write): bench.py's forward, the
# train step's, and the RGB variant's width at two batches; flash SDPA at
# the same head dim is the yardstick of each
K1_TIMED = [((128, 1024, 128), False), ((64, 1024, 128), True),
            ((2, 1024, 256), False), ((64, 1024, 256), False)]
# K2 against the plain backward, each gradient within bwd_tolerance (its
# derivation sits beside KERNEL_BWD_TOLERANCE in ops/nonlocal_attn.py)
BWD_CASES = [((64, 1024, 128), torch.bfloat16),     # the train step's shape
             ((2, 1024, 128), torch.float32),
             ((2, 200, 128), torch.bfloat16),       # ragged N
             ((2, 129, 128), torch.bfloat16),       # one key past a block
             ((300, 64, 128), torch.bfloat16),      # short N
             ((2, 1024, 256), torch.bfloat16)]      # RGB's width
# K2 timed in turns with flash SDPA's backward: the train step's shape and
# the RGB variant's width at the same batch
K2_TIMED = [(64, 1024, 128), (64, 1024, 256)]
# K1's row logsumexp against the plain one: f32 max + log(sum of exps), a
# few ulps of values near 5 (tests/test_torch_kernels_cuda.py's bound)
LSE_TOLERANCE = (1e-4, 1e-5)
# a full-width f32 train step's attention (64 views, both widths), which no
# phase launches: K1 with the logsumexp and K2 checked and timed in the
# table's cells
F32_TRAIN_SHAPES = [(64, 1024, 128), (64, 1024, 256)]

# the train path: GSC at 256 px, bf16, batch 32 (64 views a step, the size
# of docs/perf.md's fit() measurements)
TRAIN_BATCH = 32
TRAIN_WARMUP = 3
TRAIN_STEPS = 10
# the card's f32 step against the CPU's: 64 px, n_res=2, 4 samples (8 views
# through G, 16 through each discriminator's BatchNorms)
CHECK_CFG = dict(img_size=64, n_res=2, batch_size=4, compute_dtype="float32",
                 vgg_dtype="float32")
# f32 on both sides with TF32 off; the card's cuDNN and cuBLAS sum in other
# orders than the CPU's, and the step amplifies such rounding: on the CPU,
# the batch perturbed by 1e-6 relative noise moves the worst tensor's first
# moment by 1.1e-2 at 2 samples and 1.2e-2 at 4 (PERF.md), so more samples
# do not condition it better; the phase reruns that perturbed CPU step and
# prints it.  On the card the moments came within 5.3e-3 and the losses
# within 1.5e-4 (the adversarial term, 0.059 in size: 8.6e-6 apart).  A wrong step moves far more: Delta =
# rowsum(dO o O) off by 3% in K2 moves the worst first moment by 0.44,
# attention operands rounded to bf16 by 0.29 and the losses by 2.6e-2; the
# phase plants both on the card and fails unless the limits reject each.
# So: losses within 1e-3 relative, Adam's first moments within 3e-2
# (relative Frobenius norm, per tensor)
CHECK_LOSS_RTOL = 1e-3
CHECK_MOMENT_RTOL = 3e-2
# a moment below CHECK_ZERO_SHARE of the largest on the CPU is a bias
# feeding train-mode BatchNorm, zero in exact arithmetic (the perturbed CPU
# step leaves 2.1e-6 of the largest, the card 1.1e-6): on the card it must
# stay below CHECK_STRAY_SHARE, where K2 with the 3% Delta fault leaves
# 6.9e-3
CHECK_ZERO_SHARE = 1e-5
CHECK_STRAY_SHARE = 1e-4


# the evaluation path (phase 10): K1 at the batches the evaluators give it
# (one UCB image or SFW sample of 10 views; the fused UCB pass of 8 images),
# held to KERNEL_TOLERANCE and timed in turns with flash SDPA
EVAL_ATTN_CASES = [((10, 1024, 128), torch.bfloat16),
                   ((10, 1024, 128), torch.float32),
                   ((80, 1024, 128), torch.bfloat16)]
EVAL_K1_TIMED = [(10, 1024, 128), (80, 1024, 128)]
UCB_IMAGES = 9               # k=8 leaves a padded tail of one
UCB_PER_CALL = 8
UCB_PARTS = {                # part-mask rectangles (rows, cols) at 256 px
    "face_hair": ((20, 240), (30, 230)),
    "face_no_hair": ((40, 230), (40, 220)),
    "mouth": ((170, 200), (100, 160)),
    "nose": ((110, 165), (110, 145)),
    "eyebrow": ((70, 85), (60, 200)),
    "eye": ((90, 105), (60, 200)),
    "glasses": ((88, 108), (55, 205)),
}


def phase(name: str) -> None:
    print(f"\n== {name}", flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call of `fn`, by CUDA events over `iters`
    calls after `warmup` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def alternate_ms(fns: dict, reps: int = 3, settle_s: float = 0.3,
                 iters: int = 20) -> dict:
    """{name: [ms per call, one per turn]} of each function in `fns`, timed
    by cuda_ms over `iters` calls in turns (a, b, a, b, ...) `reps` times.
    The first function runs alone for `settle_s` seconds before, so the
    card's clocks have left the state the work before (a build, a burst of
    matrix products) put them in."""
    first = next(iter(fns.values()))
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < settle_s:
        first()
        torch.cuda.synchronize()
    times = {name: [] for name in fns}
    for _ in range(reps):
        for name, fn in fns.items():
            times[name].append(cuda_ms(fn, iters=iters))
    return times


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = float(np.mean((np.asarray(a, np.float32)
                         - np.asarray(b, np.float32)) ** 2))
    return float("inf") if mse == 0 else 10.0 * np.log10(1.0 / mse)


def product_seconds(flops: float, dtype: torch.dtype) -> float:
    """The least seconds in which the card does `flops` of matrix products
    in `dtype`: bf16 at the dense bf16 rate; f32 to f32 accuracy, which one
    TF32 pass misses, as three TF32 passes (3xTF32) at the dense TF32 rate,
    less time than one pass on the CUDA cores (PEAK_F32_FLOPS)."""
    if dtype == torch.bfloat16:
        return flops / PEAK_BF16_FLOPS
    return 3.0 * flops / PEAK_TF32_FLOPS


def attention_bound_ms(b: int, n: int, d: int, dtype: torch.dtype,
                       lse: bool = False):
    """(least ms, "operations" | "bytes") for one attention call: two
    N x N x D products per batch element (product_seconds), and three
    inputs read and one output written once, with the f32 row logsumexp
    when `lse`."""
    nbytes = 4.0 * b * n * d * torch.tensor([], dtype=dtype).element_size()
    nbytes += 4.0 * b * n if lse else 0.0
    t_ops = product_seconds(4.0 * b * n * n * d, dtype)
    t_bytes = nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def attention_bwd_bound_ms(b: int, n: int, d: int, dtype: torch.dtype):
    """(least ms, "operations" | "bytes") for one K2 call: five N x N x D
    products per batch element (S is needed by both passes;
    product_seconds); theta, phi, g, out and dout read once, the f32
    logsumexp read once, three gradients written once."""
    es = torch.tensor([], dtype=dtype).element_size()
    nbytes = 8.0 * b * n * d * es + 4.0 * b * n
    t_ops = product_seconds(10.0 * b * n * n * d, dtype)
    t_bytes = nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def check_k1(gen, shape, dtype, with_lse: bool = False) -> float:
    """K1 against its plain version on 0.3-randn operands (batch element 1
    at 50 randn in BOUNDARY_SHAPE), within KERNEL_TOLERANCE[dtype], and
    with `with_lse` its row logsumexp within LSE_TOLERANCE; exits on a
    disagreement.  Returns the max abs error of the output."""
    dev = gen.device
    atol, rtol = KERNEL_TOLERANCE[dtype]
    t, p, g = (0.3 * torch.randn(*shape, generator=gen, device=dev)
               for _ in range(3))
    if shape == BOUNDARY_SHAPE:
        for x in (t, p, g):
            x[1] = 50 * torch.randn(shape[1:], generator=gen, device=dev)
    t, p, g = t.to(dtype), p.to(dtype), g.to(dtype)
    with torch.no_grad():
        if with_lse:
            out, lse = _launch_fwd(t, p, g, with_lse=True)
        else:
            out = nonlocal_attention(t, p, g)
        torch.cuda.synchronize()
        ref, ref_lse = nonlocal_attention_lse_reference(t, p, g)
        torch.cuda.synchronize()
    diff = (out.float() - ref.float()).abs()
    err = diff.max().item()
    # the largest |out - ref| - rtol * |ref|, held against atol
    excess = (diff - rtol * ref.float().abs()).max().item()
    ok = bool(torch.isfinite(out).all()) and excess <= atol
    note = ""
    if with_lse:
        lse_excess = _excess(lse, ref_lse, LSE_TOLERANCE[1])
        ok = ok and lse_excess <= LSE_TOLERANCE[0]
        note = (f", lse max(err - {LSE_TOLERANCE[1]:g}|ref|) "
                f"{lse_excess:.3e} (atol {LSE_TOLERANCE[0]:g})")
    print(f"{shape} {str(dtype):15s} max_abs_err {err:.3e}, mean |ref| "
          f"{ref.float().abs().mean().item():.3e}, max(err - {rtol:.3g}"
          f"|ref|) {excess:.3e} (atol {atol:g}){note} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise SystemExit(f"K1 disagrees with its plain version at {shape}")
    return err


def time_k1(gen, shape, with_lse: bool, iters: int = 20):
    """K1 (bf16, 0.3 randn) timed in turns with flash SDPA at the same
    head dim (`iters` calls a turn), and the plain version; prints them
    with the bound.  Returns {ms, plain_ms, library_ms, bound_ms, bound_by,
    device_ms, library_device_ms}: CUDA events' medians, and the device
    time per call with the calls queued ahead (device_ms)."""
    b, n, d = shape
    dev = gen.device
    t, p, g = ((0.3 * torch.randn(b, n, d, generator=gen, device=dev)
                ).to(torch.bfloat16) for _ in range(3))
    # yardstick only: the port never calls it.  [B, 1, N, D] (one head),
    # with the flash backend forced, so the run fails rather than time the
    # unfused math fallback
    t4, p4, g4 = t[:, None], p[:, None], g[:, None]
    with torch.no_grad(), sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        turns = alternate_ms({
            "kernel": lambda: _launch_fwd(t, p, g, with_lse=with_lse),
            "flash": lambda: F.scaled_dot_product_attention(
                t4, p4, g4, scale=1.0)}, iters=iters)
        plain_ms = cuda_ms(lambda: nonlocal_attention_reference(t, p, g))
        dev_k1 = device_ms(lambda: _launch_fwd(t, p, g, with_lse=with_lse))
        dev_sdpa = device_ms(lambda: F.scaled_dot_product_attention(
            t4, p4, g4, scale=1.0))
        sdpa = F.scaled_dot_product_attention(t4, p4, g4, scale=1.0)[:, 0]
        sdpa_err = (sdpa.float() - nonlocal_attention_reference(
            t, p, g).float()).abs().max().item()
    k1_ms, sdpa_ms = (float(np.median(turns[k])) for k in turns)
    bound_ms, bound_by = attention_bound_ms(b, n, d, torch.bfloat16)
    tflops = 4.0 * b * n * n * d / k1_ms / 1e9
    print(f"({b},{n},{d}) bf16{' with the logsumexp' if with_lse else ''}"
          f": kernel {k1_ms:.4f} ms ({tflops:.0f} TFLOP/s, "
          f"{100 * bound_ms / k1_ms:.1f}% of the bound {bound_ms:.4f} ms,"
          f" {bound_by}), plain {plain_ms:.4f} ms, flash sdpa "
          f"{sdpa_ms:.4f} ms (max_abs_err vs plain {sdpa_err:.3e}); "
          f"kernel / flash {k1_ms / sdpa_ms:.2f} (medians; by turn "
          f"kernel {', '.join(f'{x:.4f}' for x in turns['kernel'])}, "
          f"flash {', '.join(f'{x:.4f}' for x in turns['flash'])}); "
          f"device time per call (calls queued ahead): kernel "
          f"{dev_k1:.4f} ms ({100 * bound_ms / dev_k1:.1f}% of the bound), "
          f"flash {dev_sdpa:.4f} ms", flush=True)
    return dict(ms=k1_ms, plain_ms=plain_ms, library_ms=sdpa_ms,
                bound_ms=bound_ms, bound_by=bound_by, device_ms=dev_k1,
                library_device_ms=dev_sdpa)


def golden_weights(variant: str = "gsc", n_res: int = 6,
                   head_bias: float = 0.5) -> dict:
    """The TF-golden weights of a generator variant: synthetic_tf_weights
    (seed=0), with the RGB head bias of gsc and tsm lifted by `head_bias`,
    as tests/goldens/tf_ref/e2e_eval.npz was made (the *_forward.npz
    goldens: head_bias=0)."""
    mapping = generator_mapping(variant, n_res)
    weights = synthetic_tf_weights(GENERATORS[variant](n_res).state_dict(),
                                   mapping, 0)
    if variant != "rgb":
        weights["generator/clr_conv3/conv/bias"] += head_bias
    return load_tf_weights(weights, mapping)


def synthetic_requests(n: int, seed: int = 0):
    """n random 512x512 images, each with LM_REF scaled and shifted into it."""
    rng = np.random.default_rng(seed)
    images, lms = [], []
    for _ in range(n):
        images.append(rng.uniform(size=(512, 512, 3)).astype(np.float32))
        scale = rng.uniform(220.0, 320.0)
        x0, y0 = rng.uniform(60.0, 512.0 - scale - 60.0, size=2)
        lm = LM_REF * scale + np.array([x0, y0]) + rng.normal(
            scale=1.5, size=LM_REF.shape)
        lms.append(lm.astype(np.float32))
    return images, lms


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

    phase("1 environment")
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}  device {kind}  "
          f"count {torch.cuda.device_count()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    phase("2 build")
    t0 = time.perf_counter()
    # one nvcc per source, started together; built afresh even where a
    # library is cached, so that ptxas reports on every kernel
    logs = _build.build_all(force=True)
    print(f"built {', '.join(logs)} in {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        print(f"{name} -> {_build.library_path(name)}")
        # ptxas: each kernel's name, then its registers and spills
        print("\n".join(ln.split("Function properties for ")[-1][:90]
                        if "Function properties" in ln else ln
                        for ln in log.splitlines()
                        if "registers" in ln or "spill" in ln
                        or "Function properties" in ln))
    for name, label, keys, count in PTXAS_CHECKED:
        faults = ptxas_faults(logs[name], label, keys, count)
        if faults:
            raise SystemExit(f"{label}'s bf16 kernels: " + "; ".join(faults))
    f32_kernel_report(logs)

    phase("3 kernel K1 vs its plain version")
    gen = torch.Generator(device=dev).manual_seed(0)
    max_err = 0.0
    for shape, dtype in ATTN_CASES:
        err = check_k1(gen, shape, dtype)
        if shape != BOUNDARY_SHAPE:   # 50 randn values: not a unit-scale error
            max_err = max(max_err, err)
    timed = {(b, n, d): time_k1(gen, (b, n, d), with_lse)
             for (b, n, d), with_lse in K1_TIMED}
    k1 = timed[K1_TIMED[0][0]]

    phase("4 golden forward at 256 px (TF-reference e2e_eval.npz)")
    golden = np.load(GOLDEN)
    sd = golden_weights()
    img = torch.from_numpy(golden["ffhq_input"].astype(np.float32))[None]
    uv = torch.from_numpy(golden["ffhq_uv"].astype(np.float32))[None]
    ref = golden["ffhq_pred"].astype(np.float32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    for label, overrides, bar in (
            ("f32", dict(compute_dtype="float32"), 45.0),
            ("bf16+folded BN+bf16 egress",
             dict(compute_dtype="bfloat16", fold_bn=True,
                  egress_dtype="bfloat16"), 40.0)):
        model = build_generator(get_config(**overrides), sd, dev)
        before = nonlocal_attention.launches
        with torch.inference_mode():
            out = model(img.to(dev), uv.to(dev))[1]
        torch.cuda.synchronize()
        launches = nonlocal_attention.launches - before
        score = psnr(out[0].float().clamp(0, 1).cpu().numpy(), ref)
        print(f"{label}: PSNR {score:.2f} dB vs the TF reference "
              f"(bar {bar} dB), K1 launches {launches}", flush=True)
        if not score >= bar:
            raise SystemExit(f"golden forward {label}: {score:.2f} dB")
        if launches != ATTN_CALLS_PER_FORWARD:
            raise SystemExit(f"golden forward {label}: {launches} launches")
        del model

    phase("5 serve: ShadowRemovalService, the main path")
    cfg = get_config(compute_dtype="bfloat16", fold_bn=True,
                     egress_dtype="bfloat16")
    # the service rasterizes the maps on the device by default
    svc = ShadowRemovalService(cfg, sd, batch_size=SERVE_BATCH, device=dev)
    assert svc.device_geometry
    images, lms = synthetic_requests(SERVE_REQUESTS)
    nonlocal_attention.launches = 0
    t0 = time.perf_counter()
    results = svc.remove_shadows(images, lms)
    serve_s = time.perf_counter() - t0
    main_launches = nonlocal_attention.launches
    n_batches = -(-SERVE_REQUESTS // SERVE_BATCH)
    print(f"{len(results)} requests in {n_batches} batches of "
          f"{SERVE_BATCH}: {serve_s:.2f} s wall (first call, host "
          f"preprocessing included), K1 launches {main_launches}")
    warm = []
    for _ in range(3):
        t0 = time.perf_counter()
        svc.remove_shadows(images, lms)
        warm.append(time.perf_counter() - t0)
    warm_s = min(warm)
    print("warm calls: " + ", ".join(f"{w:.3f} s" for w in warm))
    # the same call again, step by step on the host clock (each step ends
    # in a synchronize), to place the wall time
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    views = [svc.preprocess(im, lm) for im, lm in zip(images, lms)]
    pre_s = time.perf_counter() - t0
    stage_s = batch_s = 0.0
    for start in range(0, SERVE_REQUESTS, SERVE_BATCH):
        chunk = views[start:start + SERVE_BATCH]
        t0 = time.perf_counter()
        staged = svc.stage(chunk)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        svc.forward_staged(staged, chunk)
        t2 = time.perf_counter()
        stage_s, batch_s = stage_s + t1 - t0, batch_s + t2 - t1
    print(f"fastest warm call: {warm_s:.2f} s wall, "
          f"{SERVE_REQUESTS / warm_s:.1f} "
          f"requests/s; step by step: preprocess {pre_s:.3f} s "
          f"({1e3 * pre_s / SERVE_REQUESTS:.1f} ms/request), stage "
          f"{stage_s:.3f} s, forward_staged {batch_s:.3f} s, sum "
          f"{pre_s + stage_s + batch_s:.3f} s", flush=True)
    # the device side of one full batch, by CUDA events over 3 calls after
    # 1: geometry, generator, and the rest of _forward (clip, gate, cast);
    # the fetch is the rest of forward_staged on the host clock
    chunk = views[:SERVE_BATCH]
    staged = svc.stage(chunk)
    with torch.inference_mode():
        geo_ms = cuda_ms(lambda: device_geometry_maps(*staged[1:], cfg.img_size),
                         iters=3, warmup=1)
        maps = device_geometry_maps(*staged[1:], cfg.img_size)
        gen_ms = cuda_ms(lambda: svc.gen(staged[0], maps["uv"], maps["reg"]),
                         iters=3, warmup=1)
        fwd_ms = cuda_ms(lambda: svc._forward(staged), iters=3, warmup=1)
    t0 = time.perf_counter()
    svc.forward_staged(staged, chunk)
    batch_ms = 1e3 * (time.perf_counter() - t0)
    print(f"one batch of {SERVE_BATCH}, device side: geometry {geo_ms:.1f} "
          f"ms, generator {gen_ms:.1f} ms, clip/gate/cast "
          f"{fwd_ms - geo_ms - gen_ms:.1f} ms; fetch and unpack "
          f"{batch_ms - fwd_ms:.1f} ms", flush=True)
    del staged, maps
    if len(results) != SERVE_REQUESTS:
        raise SystemExit(f"served {len(results)} of {SERVE_REQUESTS}")
    for r in results:
        pred, mask = r["pred"], r["mask_pred"]
        if pred.shape != (256, 256, 3) or mask.shape != (256, 256, 1):
            raise SystemExit(f"bad output shapes {pred.shape} {mask.shape}")
        if not (np.isfinite(pred).all() and np.isfinite(mask).all()):
            raise SystemExit("non-finite service output")
        if pred.min() < 0.0 or pred.max() > 1.0:
            raise SystemExit("pred outside [0, 1]")
    if main_launches != ATTN_CALLS_PER_FORWARD * n_batches:
        raise SystemExit(f"main path launched K1 {main_launches} times, "
                         f"expected {ATTN_CALLS_PER_FORWARD * n_batches}")
    # the same requests on the CPU in f32 (plain attention): the card's
    # bf16 main path must hold bench.py's 40 dB production bar against it
    cpu = ShadowRemovalService(get_config(compute_dtype="float32"), sd,
                               batch_size=2, device="cpu")
    for i, r in enumerate(cpu.remove_shadows(images[:2], lms[:2])):
        score = psnr(results[i]["pred"], r["pred"])
        print(f"request {i}: card bf16 vs CPU f32 pred PSNR {score:.2f} dB")
        if not score >= 40.0:
            raise SystemExit(f"served output disagrees with CPU f32: {score}")
    # compact wires (uint16 ingress, uint8 / f16 egress) on the card
    compact = ShadowRemovalService(
        get_config(compute_dtype="bfloat16", fold_bn=True,
                   egress_dtype="bfloat16", compact_ingress=True,
                   compact_output=True), sd, batch_size=4, device=dev)
    for i, r in enumerate(compact.remove_shadows(images[:3], lms[:3])):
        err = float(np.abs(r["pred"] - results[i]["pred"]).max())
        print(f"request {i}: compact wires vs f32 wires max |pred diff| "
              f"{err:.4f}")
        if not err <= 8.0 / 255:
            raise SystemExit(f"compact wires disagree: {err}")
    del cpu, compact

    phase("6 throughput: bench.py's configuration, for the record")
    # tools/bench.py's harness on the served generator: BENCH_ITERS
    # forwards chained after a warm-up chain, the input perturbed per call
    # and per trial, the best of 3 trials by CUDA events; it raises when
    # the summed outputs do not change between trials
    model = svc.gen
    s = cfg.img_size
    img, uv, reg = tools_bench.make_inputs(BENCH_BATCH, s, 0, dev)
    torch.cuda.reset_peak_memory_stats()
    before = nonlocal_attention.launches
    bench_ms = 1e3 * tools_bench.timed_forward(
        model, img, uv, reg, iters=BENCH_ITERS) / BENCH_ITERS
    bench_launches = nonlocal_attention.launches - before
    if bench_launches != ATTN_CALLS_PER_FORWARD * BENCH_ITERS * 4:
        raise SystemExit(f"bench: {bench_launches} K1 launches")
    faces = BENCH_BATCH * 1e3 / bench_ms
    print(f"B={BENCH_BATCH} {s}x{s} bf16 folded: {bench_ms:.2f} ms/forward, "
          f"{faces:.1f} faces/s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"({smi})", flush=True)
    fwd = tools_bench.step(model)

    def step(k: int):
        fwd(img + k * _timing.STEP_EPS, uv, reg)

    # where the time goes: two forwards under torch.profiler, with a range
    # around each top-level block of the generator (forward hooks, removed
    # after); device kernels listed alone, since aten ops nest
    blocks = [(n, m) for n, m in model.named_children() if n != "res"]
    blocks += [(f"res.{i}", m) for i, m in enumerate(model.res)]
    open_ranges = {}

    def enter(name):
        def hook(module, args):
            open_ranges[name] = torch.profiler.record_function(f"block:{name}")
            open_ranges[name].__enter__()
        return hook

    def leave(name):
        def hook(module, args, out):
            open_ranges.pop(name).__exit__(None, None, None)
        return hook

    hooks = [h for name, m in blocks
             for h in (m.register_forward_pre_hook(enter(name)),
                       m.register_forward_hook(leave(name)))]
    with torch.inference_mode(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for k in range(2):
            step(k)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / 2
    for h in hooks:
        h.remove()
    events = prof.key_averages()
    kernels = sorted(
        ((e.key, e.device_time_total / 1e3 / 2, e.count // 2) for e in events
         if e.device_type == torch.autograd.DeviceType.CUDA
         and e.device_time_total > 0 and not e.key.startswith("block:")),
        key=lambda e: -e[1])
    busy_ms = sum(ms for _, ms, _ in kernels)
    print(f"profiled forward: {busy_ms:.2f} ms of device kernels in "
          f"{wall_ms:.2f} ms wall (device idle {100 * (1 - busy_ms / wall_ms):.1f}"
          f"%, profiler on)")
    for key, ms, count in kernels[:12]:
        print(f"  {ms:8.3f} ms  {100 * ms / busy_ms:5.1f}%  x{count:<3d} {key[:100]}")
    k1_prof = [(ms, count) for key, ms, count in kernels if "attn_fwd" in key]
    print(f"K1 in the profiled forward: {sum(ms for ms, _ in k1_prof):.3f} ms "
          f"({100 * sum(ms for ms, _ in k1_prof) / busy_ms:.1f}% of the "
          f"kernels), {sum(c for _, c in k1_prof)} launches")
    by_block: dict[str, float] = {}
    for e in events:
        if e.key.startswith("block:"):
            name = e.key[len("block:"):]
            by_block[name] = max(by_block.get(name, 0.0),
                                 e.device_time_total / 1e3 / 2)
    print("device time by generator block (ms/forward, share of kernels):")
    for name, ms in sorted(by_block.items(), key=lambda kv: -kv[1]):
        print(f"  {ms:8.3f} ms  {100 * ms / busy_ms:5.1f}%  {name}")

    phase("7 kernel K2 vs its plain backward")
    k2_err, k2_timed = check_k2(dev)
    k2_ms, bwd_plain_ms, sdpa_bwd_ms, k2_bound_ms, k2_bound_by = k2_timed[
        K2_TIMED[0]]

    phase("8 train: the GSC GAN train step at full width, the train path")
    k1_train, k2_train, bare_step_ms = train_full_width(dev, smi)

    # every (wrapper, shape, dtype) K1 and K2 launch at in this process
    # from here to phase 18, for the kernel table's cells
    table_seen, stop_table = record_attention_shapes()
    phase("9 the card's f32 train step against the CPU's")
    for variant in ("gsc", "tsm", "rgb"):
        card_vs_cpu_step(dev, variant)

    phase("10 eval: the evaluation path")
    with tempfile.TemporaryDirectory() as work:
        eval_launches, eval_err = eval_path(dev, sd, smi, work)
    max_err = max(max_err, eval_err)

    phase("11 variants: the TSM and RGB generators on every path")
    with tempfile.TemporaryDirectory() as work:
        var = variants_path(dev, smi, work)
    max_err = max(max_err, var["k1_err"])

    phase("13 fit: training end to end on the card")
    with tempfile.TemporaryDirectory() as work:
        fit, fit_k1_err, fit_k2_err = fit_path(dev, smi, work,
                                               bare_step_ms)
    max_err = max(max_err, fit_k1_err)
    k2_err = max(k2_err, fit_k2_err)

    phase("14 front end: raw photos to deshadowed faces")
    with tempfile.TemporaryDirectory() as work:
        front = frontend_path(dev, sd, smi, work)
    max_err = max(max_err, front["k1_err"])

    phase("15 cli: python -m blindshadowremoval_tpu_torch, every subcommand")
    with tempfile.TemporaryDirectory() as work:
        clip = cli_path(dev, smi, work, faces)
    max_err = max(max_err, clip["k1_err"])
    k2_err = max(k2_err, clip["k2_err"])

    phase("16 parallel: the train step sharded over ranks, the service "
          "over a mesh")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as work:
        par = parallel_path(dev, smi, work)
    max_err = max(max_err, par["k1_err"])
    k2_err = max(k2_err, par["k2_err"])
    par_k1 = {k: v if isinstance(v, int) else v[0]
              for k, v in par["launches"].items()}
    par_k2 = {k: v[1] for k, v in par["launches"].items()
              if not isinstance(v, int)}

    phase("17 the rest: the TF bundle reader, the native loader, the fused "
          "UCB step over a mesh, the s2d and packed convs")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as work:
        rest = rest_path(dev, smi, work)
    max_err = max(max_err, rest["k1_err"])

    phase("18 tools: the port's measurement programs")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as work:
        tools = tools_path(dev, smi, work, faces)
    max_err = max(max_err, tools["k1_err"])
    k2_err = max(k2_err, tools["k2_err"])
    stop_table()
    t0 = time.perf_counter()
    print("K1 with the logsumexp and K2 in f32 at a full-width train step's "
          "shapes, against their plain versions:", flush=True)
    gen = torch.Generator(device=dev).manual_seed(21)
    with no_tf32():
        for shape in F32_TRAIN_SHAPES:
            max_err = max(max_err, check_k1(gen, shape, torch.float32,
                                            with_lse=True))
            k2_err = max(k2_err, check_k2_case(gen, shape, torch.float32))
    cells = table_seen | {(name, shape, torch.float32)
                          for shape in F32_TRAIN_SHAPES
                          for name in ("nonlocal_attention_lse",
                                       "nonlocal_attention_bwd")}
    print(f"the table's cells: K1 and K2 at the {len(table_seen)} (wrapper, "
          "shape, dtype) phases 9-18 launched them at in this process, and "
          "the f32 train step's, device time a call:", flush=True)
    k1_cells, k2_cells = kernel_cells(
        torch.Generator(device=dev).manual_seed(20), cells)
    print(f"the table's cells: {time.perf_counter() - t0:.1f} s", flush=True)

    phase("12 kernels")
    print(f"launches by path: serve K1 {main_launches}; train "
          f"({TRAIN_STEPS} steps) K1 {k1_train}, K2 {k2_train}; eval K1 "
          f"{sum(eval_launches.values())}; variants "
          + ", ".join(f"{k} {v}" for k, v in var["launches"].items())
          + "; fit " + ", ".join(f"{k} K1 {v[0]}, K2 {v[1]}"
                                 for k, v in fit.items())
          + "; front end " + ", ".join(f"{k} K1 {v}"
                                       for k, v in front["launches"].items())
          + "; cli " + ", ".join(f"{k} K1 {v[0]}, K2 {v[1]}"
                                 for k, v in clip["launches"].items())
          + "; parallel " + ", ".join(f"{k} K1 {v}" for k, v in
                                      par_k1.items())
          + ", K2 " + ", ".join(f"{k} {v}" for k, v in par_k2.items())
          + "; the rest " + ", ".join(f"{k} K1 {v}"
                                      for k, v in rest["launches"].items())
          + "; tools " + ", ".join(f"{k} K1 {v[0]}, K2 {v[1]}"
                                   for k, v in tools["launches"].items()))
    fit_k1 = sum(v[0] for v in fit.values())
    fit_k2 = sum(v[1] for v in fit.values())
    k1_shapes = [dict(shape=list(shape), **rec) for shape, rec in
                 {**timed, **var["k1"]}.items()]
    k1_shapes.append(dict(shape=list(PARALLEL_ATTN_SHAPE),
                          path="sharded train step, per rank", **par["k1"]))
    # the sharded step's own launches: the NCCL rank's and both gloo ranks'
    par_train = [k for k in par_k1 if "train" in k]
    print(json.dumps({"kernels": [{
        "name": "nonlocal_attn_fwd",
        "route": "cuda",
        "source": "blindshadowremoval_tpu_torch/csrc/nonlocal_attn.cu",
        "replaces": "blindshadowremoval_tpu/ops/pallas/nonlocal_attn.py:70",
        "launches": (main_launches + fit_k1
                     + front["launches"]["run_dir overlapped"]
                     + sum(par_k1[k] for k in par_train)
                     + sum(rest["launches"].values())
                     + sum(v[0] for v in tools["launches"].values())),
        "max_abs_err": max_err,
        "ms": k1["ms"],
        "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"],
        "library_ms": k1["library_ms"],
        "launches_by_path": {"serve": main_launches, "train": k1_train,
                             **{f"eval {k}": v
                                for k, v in eval_launches.items()},
                             **{k: v if isinstance(v, int) else v[0]
                                for k, v in var["launches"].items()},
                             **{f"fit {k}": v[0] for k, v in fit.items()},
                             **{f"front end {k}": v
                                for k, v in front["launches"].items()},
                             **{f"cli {k}": v[0]
                                for k, v in clip["launches"].items()},
                             **{f"parallel {k}": v
                                for k, v in par_k1.items()},
                             **{f"rest {k}": v
                                for k, v in rest["launches"].items()},
                             **{f"tools {k}": v[0]
                                for k, v in tools["launches"].items()}},
        "shapes": k1_shapes + k1_cells,
    }, {
        "name": "nonlocal_attn_bwd",
        "route": "cuda",
        "source": "blindshadowremoval_tpu_torch/csrc/nonlocal_attn_bwd.cu",
        "replaces": "blindshadowremoval_tpu/ops/pallas/nonlocal_attn.py:117",
        "launches": (k2_train + fit_k2 + sum(par_k2[k] for k in par_train)
                     + sum(v[1] for v in tools["launches"].values())),
        "max_abs_err": k2_err,
        "ms": k2_ms,
        "plain_ms": bwd_plain_ms,
        "bound_ms": k2_bound_ms,
        "bound_by": k2_bound_by,
        "library_ms": sdpa_bwd_ms,
        "launches_by_path": {"train": k2_train,
                             "tsm train": var["launches"]["tsm train"][1],
                             "rgb train": var["launches"]["rgb train"][1],
                             **{f"fit {k}": v[1] for k, v in fit.items()},
                             **{f"cli {k}": v[1]
                                for k, v in clip["launches"].items()
                                if v[1]},
                             **{f"parallel {k}": v
                                for k, v in par_k2.items()},
                             **{f"tools {k}": v[1]
                                for k, v in tools["launches"].items()
                                if v[1]}},
        "shapes": [dict(shape=list(shape), ms=rec[0], plain_ms=rec[1],
                        library_ms=rec[2], bound_ms=rec[3], bound_by=rec[4])
                   for shape, rec in k2_timed.items()]
        + [dict(shape=[2 * TRAIN_BATCH, 1024, 256], path="rgb train step",
                max_abs_err=var["k2_err"], **var["k2"]),
           dict(shape=list(PARALLEL_ATTN_SHAPE),
                path="sharded train step, per rank", max_abs_err=par["k2_err"],
                **dict(zip(("ms", "plain_ms", "library_ms", "bound_ms",
                            "bound_by"), par["k2"]))),
           *k2_cells],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


@contextlib.contextmanager
def no_tf32():
    """f32 convolutions and matrix products in true f32 inside, the
    process's settings restored after."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


@contextlib.contextmanager
def without_f32_scope():
    """The generators' f32 convolution scope taken away inside (P2's
    readings: f32 forwards under the process's TF32 settings)."""
    modules = (generator_module, generator_rgb_module)
    saved = [m.f32_convs for m in modules]
    for m in modules:
        m.f32_convs = lambda dtype: contextlib.nullcontext()
    try:
        yield
    finally:
        for m, scope in zip(modules, saved):
            m.f32_convs = scope


def synthetic_ucb_tree(root: str, n_images: int = UCB_IMAGES,
                       per_id: int = 3, seed: int = 0) -> str:
    """A UCB test tree under `root` from the sfw_gsc_synth frames and
    landmarks: `input/<id>/<n>.png|.npy` (the frame with a darkened
    rectangle, the shadow), `gt/<id>/<n>.png` (the frame) and the 7
    part-mask directories of `<id>_<n>-result.png` (UCB_PARTS, each moved
    by up to 6 px).  Returns root."""
    rng = np.random.default_rng(seed)
    frames = TF_REF / "sfw_gsc_synth" / "vid0"
    for i in range(n_images):
        ident, n = f"id{i // per_id}", str(i)
        frame = read_png(str(frames / f"{i}.png"))
        shadow = frame.astype(np.float32)
        r0, c0 = rng.integers(60, 120, 2)
        shadow[r0:r0 + 60, c0:c0 + 70] *= rng.uniform(0.35, 0.6)
        for sub, img in (("input", np.rint(shadow).astype(np.uint8)),
                         ("gt", frame)):
            os.makedirs(os.path.join(root, sub, ident), exist_ok=True)
            write_png(os.path.join(root, sub, ident, f"{n}.png"), img)
        np.save(os.path.join(root, "input", ident, f"{n}.npy"),
                np.load(frames / f"{i}.npy"))
        for key, ((a, b), (c, e)) in UCB_PARTS.items():
            dy, dx = rng.integers(-6, 7, 2)
            m = np.zeros((256, 256, 3), np.uint8)
            m[a + dy:b + dy, c + dx:e + dx] = 255
            d = os.path.join(root, UCBEvaluator.PART_DIRS[key])
            os.makedirs(d, exist_ok=True)
            write_png(os.path.join(d, f"{ident}_{n}-result.png"), m)
    return root


def eval_path(dev, sd: dict, smi: str, work: str):
    """Phase 10: every evaluator on the card through Dataset -> run, at 256
    px, n_res=6, with the TF-golden weights, K1 launches counted per path.
    TF32 as PyTorch ships it (cuDNN on, matmul off), off inside the f32
    forwards only.  Returns ({path: K1 launches}, K1's largest max abs
    error at the evaluation batches)."""
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    launches = {}

    # --- SFW-GSC against e2e_sfw_gsc.npz (tests/test_tf_ref_e2e.py:186-189);
    # the maps rasterized on the card (the host rasterizer takes ~1 s a
    # view at 256 px; the CPU tests run the preset's host maps)
    golden = np.load(TF_REF / "e2e_sfw_gsc.npz")
    kw = dict(variant="gsc", device_geometry=True,
              data_dirs_test=(str(TF_REF / "sfw_gsc_synth" / "*"),))
    batch, box, name = next(iter(Dataset(
        get_config("sfw", **kw), "test", dset="sfw")))
    for label, overrides in (("f32", dict(compute_dtype="float32")),
                             ("bf16 folded", dict(compute_dtype="bfloat16",
                                                  fold_bn=True))):
        cfg = get_config("sfw", checkpoint_dir=os.path.join(work, "sfw"),
                         **kw, **overrides)
        ev = SFWEvaluator(cfg, sd, device=dev)
        nonlocal_attention.launches = 0
        with no_tf32() if label == "f32" else contextlib.nullcontext():
            r = ev.run_one(batch, box, "sfwgsc0")
        launches[f"sfw {label}"] = nonlocal_attention.launches
        d_auc = abs(r["auc"] - float(golden["sfw_gsc_auc"]))
        d_psnr = abs(r["psnr"] - float(golden["sfw_gsc_psnr"]))
        d_ssim = abs(r["ssim"] - float(golden["sfw_gsc_ssim"]))
        mask_db = psnr(r["mask_pred"], golden["sfw_gsc_mask_pred"])
        print(f"SFW-GSC {label}: AUC {r['auc']:.6f} (dAUC {d_auc:.2e}), PSNR "
              f"{r['psnr']:.4f} (d {d_psnr:.2e}), SSIM {r['ssim']:.6f} (d "
              f"{d_ssim:.2e}), mask_pred {mask_db:.2f} dB vs the TF "
              f"reference; K1 launches {launches[f'sfw {label}']}",
              flush=True)
        if label == "f32" and not (d_auc <= 1e-3 and d_psnr <= 0.05
                                   and d_ssim <= 0.005 and mask_db >= 40.0):
            raise SystemExit("SFW-GSC f32 misses the TF-reference bars")
        del ev

    # --- SFW video against e2e_video.npz (tests/test_tf_ref_e2e.py:237-279)
    import scipy.io

    golden = np.load(TF_REF / "e2e_video.npz")
    cfg = get_config("sfw_video", variant="gsc", compute_dtype="float32",
                     device_geometry=True,
                     data_dirs_test=(str(TF_REF / "sfw_video_synth" / "*"),),
                     checkpoint_dir=os.path.join(work, "video"))
    batch, box, name = next(iter(Dataset(cfg, "test", dset="sfw")))
    bbox_dir = os.path.join(work, "bbox")
    nonlocal_attention.launches = 0
    with no_tf32():
        r = SFWVideoEvaluator(cfg, sd, device=dev).run_one(
            batch, box, name, export_bbox_dir=bbox_dir)
    launches["video"] = nonlocal_attention.launches
    pred_db = psnr(r["pred"], golden["vid_pred"])
    mask_db = psnr(r["mask_pred"] * 2.0, golden["vid_mask_pred2"])
    parts = name.replace("\\", "/").split("/")
    mat = scipy.io.loadmat(os.path.join(bbox_dir,
                                        f"{parts[-2]}_{parts[-1]}.mat"))
    box_ok = np.array_equal(np.asarray(mat["bbox"]).reshape(4),
                            golden["vid_box"])
    print(f"SFW video: pred {pred_db:.2f} dB, mask {mask_db:.2f} dB over "
          f"{r['pred'].shape[0]} frames, .mat box {'equal' if box_ok else 'DIFFERENT'}"
          f"; K1 launches {launches['video']}", flush=True)
    if not (pred_db >= 45.0 and mask_db >= 28.0 and box_ok):
        raise SystemExit("SFW video misses the TF-reference bars")

    # --- in-the-wild on the e2e_eval.npz maps (A7)
    golden = np.load(GOLDEN)
    batch = {k: golden[f"ffhq_{src}"].astype(np.float32)[None]
             for k, src in (("img", "input"), ("uv", "uv"), ("face", "face"))}
    cfg = get_config(compute_dtype="float32", eval_views=1,
                     device_geometry=False,
                     checkpoint_dir=os.path.join(work, "wild"))
    nonlocal_attention.launches = 0
    with no_tf32():
        r = InTheWildEvaluator(cfg, sd, device=dev).run_one(
            batch, np.zeros(4, np.float32), "02165")
    launches["in-the-wild"] = nonlocal_attention.launches
    wild_db = psnr(r["pred"], golden["ffhq_pred"])
    print(f"in-the-wild: pred {wild_db:.2f} dB vs the TF reference; K1 "
          f"launches {launches['in-the-wild']}", flush=True)
    if not wild_db >= 45.0:
        raise SystemExit(f"in-the-wild: {wild_db:.2f} dB")

    # --- UCB on a synthetic tree, host-orchestrated and fused k=8
    root = synthetic_ucb_tree(os.path.join(work, "ucb"))
    kw = dict(data_dirs_test=(os.path.join(root, "input", "*"),),
              part_mask_root=root, device_geometry=True)
    fused_f32 = None
    for label, overrides in (("bf16 folded", dict(compute_dtype="bfloat16",
                                                  fold_bn=True)),
                             ("f32", dict(compute_dtype="float32"))):
        cfg = get_config("ucb", checkpoint_dir=os.path.join(work, label),
                         **kw, **overrides)
        ev = UCBEvaluator(cfg, sd, device=dev)
        scope = no_tf32 if label == "f32" else contextlib.nullcontext
        with scope(), contextlib.redirect_stdout(io.StringIO()):
            nonlocal_attention.launches = 0
            host = ev.run(Dataset(cfg, "test"), root, fused=False)
            launches[f"ucb host {label}"] = nonlocal_attention.launches
            nonlocal_attention.launches = 0
            t0 = time.perf_counter()
            fused = ev.run(Dataset(cfg, "test"), root,
                           images_per_call=UCB_PER_CALL)
            cold_s = time.perf_counter() - t0
            launches[f"ucb fused {label}"] = nonlocal_attention.launches
            t0 = time.perf_counter()
            ev.run(Dataset(cfg, "test"), root, images_per_call=UCB_PER_CALL)
            warm_s = time.perf_counter() - t0
            iters = max(ev.label_iterations)
        differ = [int((h["detected"][..., 0] != f["detected"][..., 0]).sum())
                  for h, f in zip(host, fused)]
        d_psnr = max(abs(h["psnr"] - f["psnr"]) for h, f in zip(host, fused))
        d_ssim = max(abs(h["ssim"] - f["ssim"]) for h, f in zip(host, fused))
        print(f"UCB {label}, {UCB_IMAGES} images x {cfg.eval_views} views "
              f"at {cfg.img_size} px: host-orchestrated vs fused k="
              f"{UCB_PER_CALL}: detected pixels that differ per image "
              f"{differ}, max |dPSNR| {d_psnr:.2e} dB, max |dSSIM| "
              f"{d_ssim:.2e}; mean PSNR "
              f"{np.mean([f['psnr'] for f in fused]):.3f} dB, SSIM "
              f"{np.mean([f['ssim'] for f in fused]):.4f}, detected "
              f"{100 * np.mean([f['detected'].mean() for f in fused]):.1f}% "
              f"of pixels; K1 launches host {launches[f'ucb host {label}']},"
              f" fused {launches[f'ucb fused {label}']}", flush=True)
        print(f"UCB {label}: fused k={UCB_PER_CALL} run, host parsing "
              f"included: cold {cold_s:.2f} s, warm {warm_s:.2f} s = "
              f"{UCB_IMAGES / warm_s:.2f} images/s ({smi}); label "
              f"propagation took at most {iters} iterations a pass",
              flush=True)
        # in f32 the two paths compute the same function up to summation
        # order; in bf16 the generator's rounding follows the batch (10
        # views a call against 80, so other cuDNN algorithms), and a map
        # value within rounding of a threshold moves a pixel: record only
        if label == "f32" and not (max(differ) == 0 and d_psnr <= 0.01
                                   and d_ssim <= 1e-4):
            raise SystemExit(f"UCB {label}: fused and host paths disagree")
        ucb_split(ev, cfg, root, label)
        if label == "f32":
            fused_f32 = fused
        del ev

    # the card's fused f32 masks against the port's on the CPU (f32, the
    # same weights).  An eval forward is per view, so the anchor's outputs
    # do not depend on the reference views: the CPU runs the anchor alone
    cfg = get_config("ucb", checkpoint_dir=os.path.join(work, "cpu"),
                     compute_dtype="float32", eval_views=1, **kw)
    with contextlib.redirect_stdout(io.StringIO()):
        cpu = UCBEvaluator(cfg, sd, device="cpu").run(
            Dataset(cfg, "test"), root, images_per_call=UCB_PER_CALL)
    differ = [int((c["detected"][..., 0] != f["detected"][..., 0]).sum())
              for c, f in zip(cpu, fused_f32)]
    d_psnr = max(abs(c["psnr"] - f["psnr"]) for c, f in zip(cpu, fused_f32))
    print(f"UCB f32, card vs CPU: detected pixels that differ per image "
          f"{differ} of {256 * 256} (bar 0.1%), max |dPSNR| {d_psnr:.2e} dB",
          flush=True)
    if max(differ) > 0.001 * 256 * 256:
        raise SystemExit("UCB: the card's detected masks disagree with the "
                         "CPU's")
    # SSIM runs in f32 whatever TF32 allows: the card's against the CPU's on
    # one composite pair, with cuDNN's TF32 on
    a, b = (torch.from_numpy(fused_f32[i]["pred"]) for i in (0, 1))
    on_card = float(ssim_fn(a[None].to(dev), b[None].to(dev))[0])
    on_cpu = float(ssim_fn(a[None], b[None])[0])
    print(f"SSIM with TF32 allowed: card {on_card:.7f}, CPU {on_cpu:.7f}, "
          f"|d| {abs(on_card - on_cpu):.2e}", flush=True)
    if not abs(on_card - on_cpu) <= 1e-5:
        raise SystemExit("SSIM on the card is not f32")

    # --- K1 at the evaluation batches
    gen = torch.Generator(device=dev).manual_seed(2)
    err = max(check_k1(gen, shape, dtype) for shape, dtype in EVAL_ATTN_CASES)
    for shape in EVAL_K1_TIMED:
        # a call at B=10 is shorter than its launch through the wrapper:
        # 200 a turn, and the device time with the calls queued ahead
        time_k1(gen, shape, False, iters=200)
    print("K1 launches on the evaluation path: " + ", ".join(
        f"{k} {v}" for k, v in launches.items()), flush=True)
    for path, n in launches.items():
        per_call = {"ucb host": UCB_IMAGES, "ucb fused": -(-UCB_IMAGES //
                                                           UCB_PER_CALL)}
        forwards = next((v for k, v in per_call.items()
                         if path.startswith(k)), 1)
        if n != ATTN_CALLS_PER_FORWARD * forwards:
            raise SystemExit(f"eval path {path}: {n} K1 launches, expected "
                             f"{ATTN_CALLS_PER_FORWARD * forwards}")
    return launches, err


def ucb_split(ev, cfg, root: str, label: str) -> None:
    """The device side of one fused k=8 pass, by CUDA events (3 calls after
    1): the geometry maps and the generator on the k*V views, the resizes
    into the crop boxes, the post-processing with the components, the
    metrics, and the whole step."""
    ds = Dataset(cfg, "test")
    params = PostprocessParams()
    s = cfg.img_size
    jbs, sizes, pis = [], [], []
    for step, (batch, box, name) in zip(range(UCB_PER_CALL), ds):
        parts = ev._load_part_masks(root, step, sample_name=name)
        size = int(min(box[3] - box[1], s))
        pis.append(prep_part_inputs(ev._resized_parts(parts, size), params))
        jbs.append(ev._ingress(batch, to_device=False))
        sizes.append(size)
    _, stacked, sizes, pi = ev._stack_chunk([], jbs, sizes, pis, UCB_PER_CALL)
    batch = {k: ev._tensor(v) for k, v in stacked.items()}
    size_t, pi = ev._tensor(sizes), pi.to(ev.device)
    k, v = batch["img"].shape[:2]
    views = {key: t.reshape((k * v,) + t.shape[2:])
             for key, t in batch.items() if key != "gt"}
    step_fn = build_fused_ucb_batch_step(ev._fused_fwd(), params, s)
    scope = no_tf32 if label == "f32" else contextlib.nullcontext
    with scope(), torch.inference_mode():
        geo = [views[key] for key in ("lm", "face_pts", "uv_tris",
                                      "face_tris", "reg_tris")]
        t = {"device geometry maps": cuda_ms(
            lambda: device_geometry_maps(*geo, s), iters=3, warmup=1)}
        maps = device_geometry_maps(*geo, s)
        img = views["img"].float()
        t["generator"] = cuda_ms(lambda: ev.gen(img, maps["uv"]), iters=3,
                                 warmup=1)
        outs = ev.gen(img, maps["uv"])
        alone = ev.gen(img[:v], maps["uv"][:v])
        batch_dep = max((a.float() - b[:v].float()).abs().max().item()
                        for a, b in zip(alone, outs))
        rgb, mp = (o.reshape((k, v) + o.shape[1:])[:, 0].float()
                   for o in outs[1::2])
        a = dynamic_resize_matrix(size_t, s)
        img0 = batch["img"][:, 0].float()
        t["resizes into the crop boxes"] = cuda_ms(
            lambda: [resize_into_box(x, a) for x in
                     (batch["gt"][:, 0].float(), img0, rgb, mp)],
            iters=3, warmup=1)
        tmp, mpr = resize_into_box(img0, a), resize_into_box(mp, a)
        t["post-processing with the components"] = cuda_ms(
            lambda: fused_postprocess(mpr, tmp, pi, params), iters=3,
            warmup=1)
        t["metrics (PSNR, SSIM)"] = cuda_ms(
            lambda: (psnr_fn(tmp, tmp * 0.9), ssim_fn(tmp, tmp * 0.9)),
            iters=3, warmup=1)
        whole = cuda_ms(lambda: step_fn(batch, size_t, pi), iters=3,
                        warmup=1)
    print(f"UCB {label}: one fused pass of {k} images x {v} views, device "
          f"side (ms): " + ", ".join(f"{name} {ms:.2f}"
                                     for name, ms in t.items())
          + f"; the whole step {whole:.2f}, of which the rest (ingress "
          f"dequantize, composite, egress casts, host syncs) "
          f"{whole - sum(t.values()):.2f}; the first image's {v} views "
          f"through the generator alone against inside the pass: max |diff| "
          f"{batch_dep:.3e}", flush=True)


# the variants (phase 11): K1 at the batches the TSM and RGB paths give it
# (TSM: an anchor and its mirror, 8 such pairs in a fused UCB pass; RGB at
# D=256: an evaluation sample of 10 views, a serve batch of 64, a fused UCB
# pass of 80), held to KERNEL_TOLERANCE and timed in turns with flash SDPA
VARIANT_ATTN_CASES = [((2, 1024, 128), torch.bfloat16),
                      ((2, 1024, 128), torch.float32),
                      ((16, 1024, 128), torch.bfloat16),
                      ((10, 1024, 256), torch.bfloat16),
                      ((10, 1024, 256), torch.float32),
                      ((64, 1024, 256), torch.bfloat16),
                      ((80, 1024, 256), torch.bfloat16)]
VARIANT_K1_TIMED = [(2, 1024, 128), (16, 1024, 128), (10, 1024, 256),
                    (64, 1024, 256), (80, 1024, 256)]
# NonLocal blocks a forward: one a ResBottleneck; RGB runs n_res // 2
ATTN_CALLS = {"gsc": 6, "tsm": 6, "rgb": 3}
OUT_NAMES = ("gs", "con_rgb", "mask22", "dif")
# K2's kernels, by name (ptxas and the profiler)
K2_KERNELS = ("bwd_hopper", "bwd_prep", "bwd_dq", "bwd_f32")


def golden_forward_inputs(variant: str):
    """tests/test_tf_model_parity.py's inputs at 128 px: one seeded view,
    and for TSM a second uniform one (tools/make_tf_ref_goldens.py)."""
    rng = np.random.default_rng(123)
    img = rng.uniform(0.0, 1.0, (1, 128, 128, 3))
    uv = rng.uniform(0.0, 1.0, (1, 128, 128, 3))
    reg = rng.uniform(-0.02, 0.02, (1, 128, 128, 6))
    if variant == "tsm":
        rng = np.random.default_rng(124)
        img = np.concatenate([img, rng.uniform(0, 1, img.shape)], 0)
        uv = np.concatenate([uv, rng.uniform(0, 1, uv.shape)], 0)
        reg = np.concatenate([reg, rng.uniform(-0.02, 0.02, reg.shape)], 0)
    return [torch.from_numpy(a.astype(np.float32)) for a in (img, uv, reg)]


def forward_golden(variant: str, dev, label: str) -> float:
    """The variant's f32 forward (built by build_generator, in eval and in
    train mode) against {variant}_forward.npz at the bars of
    tests/test_tf_model_parity.py (a 1e-4 floor, widened by 20x the TF
    reference's own noise).  Returns the worst error / bar."""
    golden = np.load(TF_REF / f"{variant}_forward.npz")
    sd = golden_weights(variant, head_bias=0.0)
    img, uv, reg = (t.to(dev) for t in golden_forward_inputs(variant))
    names = OUT_NAMES if variant == "tsm" else ("con",)
    worst = 0.0
    for mode in ("eval", "train"):
        model = build_generator(get_config(variant=variant,
                                           compute_dtype="float32"), sd, dev)
        model.train(mode == "train")
        nonlocal_attention.launches = 0
        with torch.no_grad():
            outs = (model(img, uv, reg, frame=2, share=True)
                    if variant == "tsm" else (model(img, uv),))
        launched = nonlocal_attention.launches
        ratios = []
        for name, out in zip(names, outs):
            tol = max(1e-4, 20.0 * float(golden[f"{mode}_{name}_selfnoise"]))
            err = float(np.abs(out.float().cpu().numpy()
                               - golden[f"{mode}_{name}"]).max())
            ratios.append(err / tol)
            print(f"{variant}_forward.npz {mode} {label}: {name} max abs err "
                  f"{err:.3e} (bar {tol:.3e}, {err / tol:.3f} of it)")
        worst = max(worst, *ratios)
        if launched != ATTN_CALLS[variant]:
            raise SystemExit(f"{variant} forward: {launched} K1 launches")
    return worst


def sfw_golden(ev, batch, box, golden, prefix: str, label: str) -> dict:
    """One SFW sample through `ev` against the TF reference's AUC, PSNR,
    SSIM and mask_pred; returns the shares of tests/test_tf_ref_e2e.py's
    bars (|dAUC| 1e-3, |dPSNR| 0.05, |dSSIM| 0.005, mask >= 40 dB), as
    {metric: reading / bar}, mask as 40 / dB."""
    nonlocal_attention.launches = 0
    r = ev.run_one(batch, box, f"{prefix}0")
    shares = {"auc": abs(r["auc"] - float(golden[f"{prefix}_auc"])) / 1e-3,
              "psnr": abs(r["psnr"] - float(golden[f"{prefix}_psnr"])) / 0.05,
              "ssim": abs(r["ssim"] - float(golden[f"{prefix}_ssim"])) / 5e-3}
    mask_db = psnr(r["mask_pred"], golden[f"{prefix}_mask_pred"])
    shares["mask"] = 40.0 / mask_db
    print(f"{prefix} {label}: AUC {r['auc']:.6f}, PSNR {r['psnr']:.4f}, SSIM "
          f"{r['ssim']:.6f}, mask_pred {mask_db:.2f} dB; shares of the bars "
          + ", ".join(f"{k} {v:.3f}" for k, v in shares.items())
          + f"; K1 launches {nonlocal_attention.launches}", flush=True)
    return shares


def variants_path(dev, smi: str, work: str) -> dict:
    """Phase 11: the TSM and RGB generators at 256 px, n_res=6, on every
    entry point (forward goldens, SFW-TSM against the TF reference, TSM
    video, TSM and RGB UCB on a synthetic tree, both services, both train
    steps), with K1 and K2 launches counted per path, K1 held and timed at
    the new batches and K1 and K2 held on an RGB step's own operands.  TF32
    as PyTorch ships it (cuDNN on, matmul off), off inside the f32 checks
    that hold a bar, and on, without the generators' f32 scope, for the P2
    readings.  Returns {launches, k1_err,
    k2_err, k1, k2, train}."""
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    launches = {}

    # --- the forward goldens: TF32 off, and with cuDNN's TF32 on, where the
    # generators' own f32 scope (models/generator.py:f32_convs) must hold
    # the bars; P2's readings take that scope away
    p2 = {}
    for variant in ("tsm", "rgb"):
        with no_tf32():
            off = forward_golden(variant, dev, "TF32 off")
        on = forward_golden(variant, dev, "TF32 on, f32 scope")
        if not max(off, on) < 1.0:
            raise SystemExit(f"{variant}_forward.npz misses its bar")
        with without_f32_scope():
            p2[f"{variant}_forward"] = forward_golden(
                variant, dev, "TF32 on, no f32 scope")

    # --- SFW-TSM against e2e_eval.npz sfw_* (the sfw preset: TSM, host maps)
    golden = np.load(GOLDEN)
    tsm_sd, rgb_sd = golden_weights("tsm"), golden_weights("rgb")
    cfg = get_config("sfw", compute_dtype="float32",
                     data_dirs_test=(str(TF_REF / "sfw_synth" / "*"),),
                     checkpoint_dir=os.path.join(work, "sfw"))
    batch, box, _ = next(iter(Dataset(cfg, "test", dset="sfw")))
    ev = SFWEvaluator(cfg, tsm_sd, device=dev)
    with no_tf32():
        shares = sfw_golden(ev, batch, box, golden, "sfw", "f32, TF32 off")
    launches["tsm sfw"] = nonlocal_attention.launches
    if not max(shares.values()) <= 1.0:
        raise SystemExit("SFW-TSM f32 misses the TF-reference bars")
    with without_f32_scope():
        p2["sfw_tsm"] = max(sfw_golden(ev, batch, box, golden, "sfw",
                                       "f32, TF32 on, no f32 scope").values())
        # P2 on SFW-GSC, phase 10's sample
        cfg = get_config("sfw", variant="gsc", compute_dtype="float32",
                         device_geometry=True,
                         data_dirs_test=(str(TF_REF / "sfw_gsc_synth" / "*"),),
                         checkpoint_dir=os.path.join(work, "sfwgsc"))
        batch, box, _ = next(iter(Dataset(cfg, "test", dset="sfw")))
        p2["sfw_gsc"] = max(sfw_golden(
            SFWEvaluator(cfg, golden_weights(), device=dev), batch, box,
            np.load(TF_REF / "e2e_sfw_gsc.npz"), "sfw_gsc",
            "f32, TF32 on, no f32 scope").values())
    print("P2, f32 with cuDNN's TF32 on and no f32 scope: worst share of a "
          "bar " + ", ".join(f"{k} {v:.3f}" for k, v in p2.items()),
          flush=True)
    del ev

    # --- TSM video: the 10 frames as one group, card against the CPU
    cfg = get_config("sfw_video", compute_dtype="float32",
                     device_geometry=True,
                     data_dirs_test=(str(TF_REF / "sfw_video_synth" / "*"),),
                     checkpoint_dir=os.path.join(work, "video"))
    batch, box, name = next(iter(Dataset(cfg, "test", dset="sfw")))
    nonlocal_attention.launches = 0
    with no_tf32():
        card = SFWVideoEvaluator(cfg, tsm_sd, device=dev).run_one(
            batch, box, name)
    launches["tsm video"] = nonlocal_attention.launches
    cpu = SFWVideoEvaluator(cfg, tsm_sd, device="cpu").run_one(batch, box,
                                                                name)
    pred_db, mask_db = (psnr(card[k], cpu[k]) for k in ("pred", "mask_pred"))
    print(f"TSM video, {card['pred'].shape[0]} frames, frame=10: card vs CPU "
          f"pred {pred_db:.2f} dB, mask {mask_db:.2f} dB (bar 60); K1 "
          f"launches {launches['tsm video']}", flush=True)
    if not (pred_db >= 60.0 and mask_db >= 60.0):
        raise SystemExit("TSM video: the card disagrees with the CPU")

    # --- TSM UCB: host-orchestrated vs fused k=8 (f32), card vs CPU
    root = synthetic_ucb_tree(os.path.join(work, "ucb"))
    kw = dict(compute_dtype="float32", device_geometry=True,
              data_dirs_test=(os.path.join(root, "input", "*"),),
              part_mask_root=root)
    cfg = get_config("ucb", variant="tsm",
                     checkpoint_dir=os.path.join(work, "tsm"), **kw)
    ev = UCBEvaluator(cfg, tsm_sd, device=dev)
    with no_tf32(), contextlib.redirect_stdout(io.StringIO()):
        nonlocal_attention.launches = 0
        host = ev.run(Dataset(cfg, "test"), root, fused=False)
        launches["tsm ucb host"] = nonlocal_attention.launches
        nonlocal_attention.launches = 0
        fused = ev.run(Dataset(cfg, "test"), root,
                       images_per_call=UCB_PER_CALL)
        launches["tsm ucb fused"] = nonlocal_attention.launches
        t0 = time.perf_counter()
        ev.run(Dataset(cfg, "test"), root, images_per_call=UCB_PER_CALL)
        warm_s = time.perf_counter() - t0
        cpu = UCBEvaluator(cfg, tsm_sd, device="cpu").run(
            Dataset(cfg, "test"), root, images_per_call=UCB_PER_CALL)
    differ = [int((h["detected"][..., 0] != f["detected"][..., 0]).sum())
              for h, f in zip(host, fused)]
    d_psnr = max(abs(h["psnr"] - f["psnr"]) for h, f in zip(host, fused))
    d_ssim = max(abs(h["ssim"] - f["ssim"]) for h, f in zip(host, fused))
    vs_cpu = [int((c["detected"][..., 0] != f["detected"][..., 0]).sum())
              for c, f in zip(cpu, fused)]
    print(f"TSM UCB f32, {UCB_IMAGES} images (anchor + mirror): host vs "
          f"fused k={UCB_PER_CALL}: pixels that differ per image {differ}, "
          f"max |dPSNR| {d_psnr:.2e}, max |dSSIM| {d_ssim:.2e}; card vs CPU "
          f"{vs_cpu} of {256 * 256} (bar 0.1%); mean PSNR "
          f"{np.mean([f['psnr'] for f in fused]):.3f} dB; warm fused run "
          f"{warm_s:.2f} s = {UCB_IMAGES / warm_s:.2f} images/s ({smi}); K1 "
          f"launches host {launches['tsm ucb host']}, fused "
          f"{launches['tsm ucb fused']}", flush=True)
    if not (max(differ) == 0 and d_psnr <= 0.01 and d_ssim <= 1e-4):
        raise SystemExit("TSM UCB: fused and host paths disagree")
    if max(vs_cpu) > 0.001 * 256 * 256:
        raise SystemExit("TSM UCB: the card's masks disagree with the CPU's")

    # --- RGB UCB: the simple composite, card vs CPU; the heuristics, host
    # vs fused k=8
    cfg = get_config("ucb", variant="rgb",
                     checkpoint_dir=os.path.join(work, "rgb"), **kw)
    ev = UCBEvaluator(cfg, rgb_sd, device=dev)
    with no_tf32(), contextlib.redirect_stdout(io.StringIO()):
        nonlocal_attention.launches = 0
        simple = ev.run(Dataset(cfg, "test"), root)
        launches["rgb ucb simple"] = nonlocal_attention.launches
        nonlocal_attention.launches = 0
        heur_host = ev.run(Dataset(cfg, "test"), root, rgb_heuristics=True,
                           fused=False)
        launches["rgb ucb heuristics host"] = nonlocal_attention.launches
        nonlocal_attention.launches = 0
        heur = ev.run(Dataset(cfg, "test"), root, rgb_heuristics=True,
                      images_per_call=UCB_PER_CALL)
        launches["rgb ucb heuristics fused"] = nonlocal_attention.launches
        # an eval forward is per view: the CPU runs the anchor alone
        cpu_cfg = get_config("ucb", variant="rgb", eval_views=1,
                             checkpoint_dir=os.path.join(work, "rgbcpu"),
                             **kw)
        cpu = UCBEvaluator(cpu_cfg, rgb_sd, device="cpu").run(
            Dataset(cpu_cfg, "test"), root)
    d_pred = max(float(np.abs(a["pred"] - b["pred"]).max())
                 for a, b in zip(simple, cpu))
    d_psnr = max(abs(a["psnr"] - b["psnr"]) for a, b in zip(simple, cpu))
    differ = [int((h["detected"][..., 0] != f["detected"][..., 0]).sum())
              for h, f in zip(heur_host, heur)]
    print(f"RGB UCB f32, simple composite: card vs CPU max |pred diff| "
          f"{d_pred:.2e}, max |dPSNR| {d_psnr:.2e} dB, mean PSNR "
          f"{np.mean([r['psnr'] for r in simple]):.3f} dB; rgb_heuristics "
          f"host vs fused k={UCB_PER_CALL}: pixels that differ per image "
          f"{differ}; K1 launches simple {launches['rgb ucb simple']}, "
          f"heuristics host {launches['rgb ucb heuristics host']}, fused "
          f"{launches['rgb ucb heuristics fused']}", flush=True)
    if not (d_pred <= 1e-3 and d_psnr <= 0.01 and max(differ) == 0):
        raise SystemExit("RGB UCB: the card disagrees")
    del ev

    # --- both services: one batch of 64, bf16 folded, device geometry
    images, lms = synthetic_requests(SERVE_BATCH, seed=1)
    for variant, sd in (("tsm", tsm_sd), ("rgb", rgb_sd)):
        svc = ShadowRemovalService(
            get_config(variant=variant, compute_dtype="bfloat16",
                       fold_bn=True, egress_dtype="bfloat16"), sd,
            batch_size=SERVE_BATCH, device=dev)
        nonlocal_attention.launches = 0
        t0 = time.perf_counter()
        results = svc.remove_shadows(images, lms)
        wall = time.perf_counter() - t0
        launches[f"{variant} serve"] = nonlocal_attention.launches
        ref = ShadowRemovalService(get_config(variant=variant,
                                              compute_dtype="float32"),
                                   sd, batch_size=2, device="cpu"
                                   ).remove_shadows(images[:2], lms[:2])
        scores = [psnr(results[i]["pred"], r["pred"])
                  for i, r in enumerate(ref)]
        print(f"{variant} service: {len(results)} requests in one batch, "
              f"{wall:.2f} s (first call); card bf16 vs CPU f32 pred "
              + ", ".join(f"{s:.2f}" for s in scores) + " dB (bar 40); K1 "
              f"launches {launches[f'{variant} serve']}", flush=True)
        for r in results:
            if not (r["pred"].shape == (256, 256, 3)
                    and np.isfinite(r["pred"]).all()
                    and 0.0 <= r["pred"].min() and r["pred"].max() <= 1.0):
                raise SystemExit(f"{variant} service: bad output")
            if variant == "rgb" and r["mask_pred"].any():
                raise SystemExit("RGB service: the shadow map is not zeros")
        if not min(scores) >= 40.0:
            raise SystemExit(f"{variant} service disagrees with the CPU")
        del svc

    # --- both train steps at full width
    train = {v: train_variant(dev, smi, v) for v in ("tsm", "rgb")}
    launches["tsm train"] = train["tsm"]["launches"]
    launches["rgb train"] = train["rgb"]["launches"]

    # --- K1 at the new batches
    gen = torch.Generator(device=dev).manual_seed(3)
    k1_err = max(check_k1(gen, shape, dtype)
                 for shape, dtype in VARIANT_ATTN_CASES)
    k1 = {}
    for shape in VARIANT_K1_TIMED:
        # below ~B=16 a call is shorter than its launch through the
        # wrapper: 200 calls a turn, and the device time with the calls
        # queued ahead
        k1[shape] = time_k1(gen, shape, False, iters=200)

    print("launches by path (K1, or K1/K2 in a train step): " + ", ".join(
        f"{k} {v}" for k, v in launches.items()), flush=True)
    want = {"tsm sfw": 6, "tsm video": 6, "tsm ucb host": 6 * UCB_IMAGES,
            "tsm ucb fused": 6 * -(-UCB_IMAGES // UCB_PER_CALL),
            "rgb ucb simple": 3 * UCB_IMAGES,
            "rgb ucb heuristics host": 3 * UCB_IMAGES,
            "rgb ucb heuristics fused": 3 * -(-UCB_IMAGES // UCB_PER_CALL),
            "tsm serve": 6, "rgb serve": 3,
            "tsm train": (6 * TRAIN_STEPS,) * 2,
            "rgb train": (3 * TRAIN_STEPS,) * 2}
    for path, n in want.items():
        if launches[path] != n:
            raise SystemExit(f"{path}: {launches[path]} launches, expected "
                             f"{n}")
    return dict(launches=launches, k1_err=max(k1_err, train["rgb"]["k1_err"]),
                k2_err=train["rgb"]["k2_err"], k1=k1,
                k2=train["rgb"]["k2"], train=train)


def train_variant(dev, smi: str, variant: str) -> dict:
    """TRAIN_WARMUP + TRAIN_STEPS steps of the variant's train step at 256
    px, n_res=6, bf16, batch TRAIN_BATCH (64 views), as phase 8 runs GSC;
    for TSM one step with the ShareLayer gate forced on and one forced
    off; one step profiled (K1 and K2's share, K2's device time a call);
    for RGB, K1 and K2 held against their plain versions on the operands
    of one step's first NonLocal block.  Returns {launches (K1, K2 of the
    timed steps), ms, k1_err, k2_err, k2}."""
    torch.backends.cudnn.allow_tf32 = True     # PyTorch's defaults
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("train", variant=variant, batch_size=TRAIN_BATCH,
                     compute_dtype="bfloat16", vgg_dtype="bfloat16",
                     remat=False)
    trainer = Trainer(cfg, device=dev)
    state = trainer.init_state(seed=0)
    views = 2 * cfg.batch_size
    batch = synthetic_train_batch(views, cfg.img_size, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    for _ in range(TRAIN_WARMUP):
        trainer.train_step(state, batch, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    nonlocal_attention.launches = 0
    nonlocal_attention_bwd.launches = 0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    losses = []
    start.record()
    for _ in range(TRAIN_STEPS):
        state, step_losses, _ = trainer.train_step(state, batch, gen)
        losses.append(torch.stack([step_losses[k] for k in LOSS_NAMES]))
    end.record()
    torch.cuda.synchronize()
    launched = (nonlocal_attention.launches, nonlocal_attention_bwd.launches)
    step_ms = start.elapsed_time(end) / TRAIN_STEPS
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    vals = torch.stack(losses).float().cpu().numpy()
    print(f"{variant} train, {views} views of {cfg.img_size} px a step, bf16:"
          f" {step_ms:.1f} ms/step, {views * 1e3 / step_ms:.1f} views/s, peak "
          f"memory {peak:.2f} GiB ({smi}); K1, K2 launches {launched} in "
          f"{TRAIN_STEPS} steps; last losses " + ", ".join(
              f"{k} {v:.4g}" for k, v in zip(LOSS_NAMES, vals[-1])),
          flush=True)
    if not np.isfinite(vals).all():
        raise SystemExit(f"{variant} train: a loss is not finite")
    if variant == "tsm":
        for share in (True, False):
            trainer.share_gate = (lambda g, train, _s=share:
                                  torch.tensor(_s, device=dev))
            nonlocal_attention.launches = 0
            nonlocal_attention_bwd.launches = 0
            state, step_losses, _ = trainer.train_step(state, batch, gen)
            vals = torch.stack([step_losses[k] for k in LOSS_NAMES])
            ok = bool(torch.isfinite(vals).all())
            print(f"tsm train, the ShareLayer gate forced {share}: losses "
                  f"{'finite' if ok else 'NOT FINITE'}, K1, K2 launches "
                  f"{nonlocal_attention.launches}, "
                  f"{nonlocal_attention_bwd.launches}", flush=True)
            if not ok or (nonlocal_attention.launches,
                          nonlocal_attention_bwd.launches) != (6, 6):
                raise SystemExit(f"tsm train with the gate {share} failed")
        del trainer.share_gate
    # one step profiled
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_step(state, batch, gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [(e.key, e.device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.device_time_total > 0]
    busy = sum(ms for _, ms, _ in kernels)
    k1_ms = sum(ms for key, ms, _ in kernels if "attn_fwd" in key)
    k2_ms = sum(ms for key, ms, _ in kernels
                if any(k in key for k in K2_KERNELS))
    calls = ATTN_CALLS[variant]
    print(f"{variant} train, one step profiled: {busy:.2f} ms of device "
          f"kernels in {wall_ms:.2f} ms wall (idle "
          f"{100 * (1 - busy / wall_ms):.1f}%); K1 {k1_ms:.3f} ms, K2 "
          f"{k2_ms:.3f} ms ({k2_ms / calls:.4f} ms a call), together "
          f"{100 * (k1_ms + k2_ms) / busy:.2f}% of the kernels", flush=True)
    out = dict(launches=launched, ms=step_ms, k1_err=0.0, k2_err=0.0,
               k2=dict(device_ms=k2_ms / calls))
    if variant == "rgb":
        out.update(step_operand_checks(trainer, state, batch, gen))
        out["k2"]["device_ms"] = k2_ms / calls
    del state, trainer, batch
    torch.cuda.empty_cache()
    return out


def k1_rounding_bound(t, p, g, chunk: int = 8):
    """(exact, bound) per element for softmax(t p^T) g of bf16 operands of
    any scale: `exact` in f64 from the same operands, and how far from it
    an implementation may land that rounds each weight to bf16 (normalized,
    or unnormalized with a normalizer of rounded or unrounded weights: at
    most 2^-7 relative a weight), sums the scores and the second product in
    f32 (D and N terms), and rounds the output once to bf16 (2^-8 of it).
    With A = sum_j w_j |g_j| and S = max_j sum_k |t_k p_jk| of a row:
    |out - exact| <= (2^-7 + (2D + 4) 2^-24 S + N 2^-24) A (1 + 2^-8)
    + 2^-8 |exact|, times 1.01 for the second-order terms.
    KERNEL_TOLERANCE is a tighter figure for 0.3-randn operands (unit-
    variance scores), which a trained network's activations need not be."""
    b, n, d = t.shape
    u = 2.0 ** -24
    exact, bound = [], []
    for i in range(0, b, chunk):
        t64, p64, g64 = (x[i:i + chunk].double() for x in (t, p, g))
        w = torch.softmax(t64 @ p64.transpose(1, 2), dim=-1)
        o = w @ g64
        a = w @ g64.abs()
        s = (t64.abs() @ p64.abs().transpose(1, 2)).amax(-1, keepdim=True)
        eps_w = 2.0 ** -7 + (2 * d + 4) * u * s + n * u
        exact.append(o)
        bound.append(1.01 * (eps_w * a * (1 + 2.0 ** -8)
                             + 2.0 ** -8 * o.abs()))
        del w, s
    return torch.cat(exact), torch.cat(bound)


def k1_on_real_operands(t, p, g, out, ref) -> bool:
    """K1 and its plain version on a train step's own operands: each
    against f64 arithmetic within k1_rounding_bound, and K1 against the
    plain version within the sum of both bounds.  Prints the operands'
    scale, KERNEL_TOLERANCE's reading (for the record) and each share of
    its bound."""
    exact, bound = k1_rounding_bound(t, p, g)
    of = {name: (x.double() - exact).abs() / bound
          for name, x in (("kernel", out), ("plain", ref))}
    pair = ((out.double() - ref.double()).abs() / (2 * bound)).max().item()
    atol, rtol = KERNEL_TOLERANCE[t.dtype]
    worst = int(((out.float() - ref.float()).abs()).argmax())
    scores = torch.matmul(t[:1].float(), p[:1].float().transpose(1, 2))
    print(f"K1 on real operands {tuple(t.shape)} {t.dtype}: max |theta| "
          f"{t.float().abs().max():.3g}, |phi| {p.float().abs().max():.3g}, "
          f"|g| {g.float().abs().max():.3g}; element 0's scores span "
          f"{scores.min():.3g}..{scores.max():.3g}, its largest weight "
          f"{torch.softmax(scores, -1).max():.3g}; kernel vs plain at the "
          f"worst element: {out.flatten()[worst].item():.6g} vs "
          f"{ref.flatten()[worst].item():.6g} (exact "
          f"{exact.flatten()[worst].item():.6g}); KERNEL_TOLERANCE reading "
          f"max(err - {rtol:.3g}|ref|) {_excess(out, ref, rtol):.3e} (atol "
          f"{atol:g}, for 0.3-randn operands); share of the rounding bound "
          f"against f64: kernel {of['kernel'].max():.3f}, plain "
          f"{of['plain'].max():.3f}, kernel vs plain {pair:.3f}", flush=True)
    return bool(torch.isfinite(out).all()) and max(
        of["kernel"].max().item(), pair) <= 1.0


def step_operand_checks(trainer, state, batch, gen) -> dict:
    """K1 and K2 against their plain versions on the operands of a train
    step's first NonLocal block (captured on the way), within
    KERNEL_TOLERANCE and bwd_tolerance; K2 timed there in turns with flash
    SDPA's backward, with its bound.  Returns {k1_err, k2_err, k2}."""
    captured = {}
    launch_fwd, launch_bwd = attn_module._launch_fwd, \
        attn_module.nonlocal_attention_bwd

    def fwd(theta, phi, g, with_lse):
        captured.setdefault("fwd", (theta.clone(), phi.clone(), g.clone()))
        return launch_fwd(theta, phi, g, with_lse)

    def bwd(*args):
        captured.setdefault("bwd", tuple(a.clone() for a in args))
        return launch_bwd(*args)

    # the launcher counts on the module's nonlocal_attention_bwd, which is
    # `bwd` while the patch holds
    bwd.launches = 0
    attn_module._launch_fwd, attn_module.nonlocal_attention_bwd = fwd, bwd
    try:
        trainer.train_step(state, batch, gen)
    finally:
        attn_module._launch_fwd = launch_fwd
        attn_module.nonlocal_attention_bwd = launch_bwd
    t, p, g = captured["fwd"]
    with torch.no_grad():
        out = _launch_fwd(t, p, g, with_lse=False)[0]
        ref = nonlocal_attention_reference(t, p, g)
    k1_err = float((out.float() - ref.float()).abs().max())
    k1_ok = k1_on_real_operands(t, p, g, out, ref)
    theta, phi, g, out, lse, dout = captured["bwd"]
    grads = nonlocal_attention_bwd(theta, phi, g, out, lse, dout)
    refs = nonlocal_attention_bwd_reference(theta, phi, g, dout)
    k2_err, k2_ok, parts = 0.0, True, []
    for name, a, r in zip(("dtheta", "dphi", "dg"), grads, refs):
        atol2, rtol2 = bwd_tolerance(r, theta.dtype)
        ex = _excess(a, r, rtol2)
        k2_err = max(k2_err, float((a.float() - r.float()).abs().max()))
        k2_ok = k2_ok and ex <= atol2 and bool(torch.isfinite(a).all())
        parts.append(f"{name} max(err - {rtol2:.3g}|ref|) {ex:.3e} (atol "
                     f"{atol2:.3g}, max |ref| {r.float().abs().max():.3f})")
    b, n, d = theta.shape
    print(f"rgb train step's operands {tuple(theta.shape)} {theta.dtype}: K1 "
          f"max_abs_err {k1_err:.3e} ({'ok' if k1_ok else 'FAIL'}); K2 "
          + "; ".join(parts) + f" ({'ok' if k2_ok else 'FAIL'})", flush=True)
    if not (k1_ok and k2_ok and (b, n, d) == (2 * TRAIN_BATCH, 1024, 256)):
        raise SystemExit("K1 or K2 disagrees on the RGB step's operands")
    # K2 there, in turns with flash SDPA's backward on the same operands
    q4, k4, v4 = (x[:, None].clone().requires_grad_() for x in (t, p, g))
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        flash, _ = sdpa_backward(q4, k4, v4, dout[:, None].contiguous())
    turns = alternate_ms({
        "kernel": lambda: nonlocal_attention_bwd(theta, phi, g, out, lse,
                                                 dout),
        "flash": flash})
    with torch.no_grad():
        plain_ms = cuda_ms(lambda: nonlocal_attention_bwd_reference(
            theta, phi, g, dout))
    k2_ms, sdpa_ms = (float(np.median(turns[k])) for k in turns)
    bound_ms, bound_by = attention_bwd_bound_ms(b, n, d, theta.dtype)
    print(f"K2 at the RGB step's ({b},{n},{d}): {k2_ms:.4f} ms "
          f"({100 * bound_ms / k2_ms:.1f}% of the bound {bound_ms:.4f} ms, "
          f"{bound_by}), plain {plain_ms:.4f} ms, flash sdpa backward "
          f"{sdpa_ms:.4f} ms (medians; by turn kernel "
          f"{', '.join(f'{x:.4f}' for x in turns['kernel'])})", flush=True)
    return dict(k1_err=k1_err, k2_err=k2_err,
                k2=dict(ms=k2_ms, plain_ms=plain_ms, library_ms=sdpa_ms,
                        bound_ms=bound_ms, bound_by=bound_by))


# (library, label, name substrings of its bf16 kernels, how many): the
# kernels whose ptxas report phase 2 holds to no wgmma serialisation and no
# spill
PTXAS_CHECKED = (
    ("nonlocal_attn", "K1", ("attn_fwd_bf16",), len(SUPPORTED_D)),
    ("nonlocal_attn_bwd", "K2", ("bwd_hopper_bf16",), len(SUPPORTED_D)),
)


def ptxas_faults(log: str, label: str, keys: tuple, count: int) -> list[str]:
    """Prints every line of ptxas's report on one library that mentions
    wgmma, and returns the faults in it: wgmma serialised, or spills in a
    kernel whose name holds one of `keys` (either makes the kernel right
    and slow).  Raises when the report does not cover `count` such
    kernels."""
    faults, seen, current = [], set(), ""
    for line in log.splitlines():
        if "wgmma" in line:
            print(line.strip())
            if "serialized" in line:
                faults.append(line.strip())
        if "Function properties for" in line:
            current = line.split("Function properties for")[-1].strip()
        elif "spill" in line and any(k in current for k in keys):
            seen.add(current)
            if any(int(v) for v in re.findall(r"(\d+) bytes spill", line)):
                faults.append(f"{current}: {line.strip()}")
    if len(seen) != count:
        raise SystemExit(f"ptxas reported on {len(seen)} bf16 {label} "
                         f"kernels, expected {count}")
    print(f"ptxas: {len(seen)} bf16 {label} kernels, "
          f"{'no wgmma serialisation, no spills' if not faults else 'FAULTS'}")
    return faults


# (library, label, name substring of its f32 kernels that run the
# products, how many): phase 2 reports their registers and spills, and
# fails unless each one's SASS runs TF32 on the tensor cores (HMMA ...
# TF32, mma.sync; HGMMA ... TF32, wgmma)
F32_CHECKED = (
    ("nonlocal_attn", "K1", "attn_fwd_f32", len(SUPPORTED_D)),
    ("nonlocal_attn_bwd", "K2", "bwd_f32", len(SUPPORTED_D)),
)


def ptxas_usage(log: str) -> dict:
    """{kernel: (registers, spill store bytes, spill load bytes)} from
    ptxas's report."""
    usage, current, spills = {}, "", (0, 0)
    for line in log.splitlines():
        if "Function properties for" in line:
            current = line.split("Function properties for")[-1].strip()
        elif "spill" in line and current:
            found = re.findall(r"(\d+) bytes spill", line)
            spills = ((int(found[0]), int(found[1])) if len(found) == 2
                      else (0, 0))
        elif "Used" in line and "registers" in line and current:
            regs = int(re.search(r"Used (\d+) registers", line).group(1))
            usage[current] = (regs, *spills)
            current = ""
    return usage


def sass_tensor_ops(path) -> dict:
    """{kernel: (tensor-core instructions, of them on TF32)} in a built
    library's SASS, by cuobjdump from nvcc's toolkit."""
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(path)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    counts, current = {}, None
    for line in sass.splitlines():
        found = re.search(r"Function : (\S+)", line)
        if found:
            current = found.group(1)
            counts[current] = [0, 0]
        elif current and re.search(r"\bH(G)?MMA\.", line):
            counts[current][0] += 1
            counts[current][1] += ".TF32" in line
    return {k: tuple(v) for k, v in counts.items()}


def f32_kernel_report(logs: dict) -> None:
    """Phase 2 on the f32 kernels: each one's registers and spills
    (ptxas) and its tensor-core instructions (SASS); exits unless every
    f32 kernel of F32_CHECKED runs TF32 products on the tensor cores."""
    for name, label, key, count in F32_CHECKED:
        usage = ptxas_usage(logs[name])
        sass = sass_tensor_ops(_build.library_path(name))
        kernels = sorted(k for k in usage if key in k)
        if len(kernels) != count:
            raise SystemExit(f"ptxas reported on {len(kernels)} f32 {label} "
                             f"kernels, expected {count}")
        for kernel in kernels:
            regs, stores, loads = usage[kernel]
            ops, tf32 = sass.get(kernel, (0, 0))
            width = re.search(r"ILi(\d+)E", kernel)
            print(f"{label} f32 {key}<{width.group(1) if width else '?'}>: "
                  f"{regs} registers, spills {stores} B stored / {loads} B "
                  f"loaded; SASS {ops} tensor-core instructions, {tf32} on "
                  f"TF32", flush=True)
            if tf32 == 0:
                raise SystemExit(f"{label}'s f32 kernel {kernel} runs no TF32 "
                                 "product on the tensor cores")


def _excess(out: torch.Tensor, ref: torch.Tensor, rtol: float) -> float:
    """The largest |out - ref| - rtol * |ref|, to hold against atol."""
    return ((out.float() - ref.float()).abs()
            - rtol * ref.float().abs()).max().item()


def k2_operands(gen, shape, dtype):
    """theta, phi, g of 0.3 randn and dout of randn, the scales of
    KERNEL_BWD_TOLERANCE's derivation."""
    t, p, g = (0.3 * torch.randn(*shape, generator=gen, device=gen.device)
               for _ in range(3))
    do = torch.randn(*shape, generator=gen, device=gen.device)
    return [x.to(dtype) for x in (t, p, g, do)]


def check_k2_case(gen, shape, dtype) -> float:
    """K2 (through the autograd Function, after K1) at `shape` against the
    plain backward and against autograd through the plain forward in f32,
    each gradient within bwd_tolerance; exits on a disagreement.  Returns
    the max abs error."""
    t, p, g, do = k2_operands(gen, shape, dtype)
    leaves = [x.clone().requires_grad_() for x in (t, p, g)]
    k1, k2 = nonlocal_attention.launches, nonlocal_attention_bwd.launches
    grads = torch.autograd.grad(nonlocal_attention(*leaves), leaves, do)
    torch.cuda.synchronize()
    launched = (nonlocal_attention.launches - k1,
                nonlocal_attention_bwd.launches - k2)
    ref = nonlocal_attention_bwd_reference(t, p, g, do)
    leaves32 = [x.float().requires_grad_() for x in (t, p, g)]
    auto = torch.autograd.grad(nonlocal_attention_reference(*leaves32),
                               leaves32, do.float())
    ok, max_err = launched == (1, 1), 0.0
    for name, a, r, au in zip(("dtheta", "dphi", "dg"), grads, ref, auto):
        atol, rtol = bwd_tolerance(r, dtype)
        err = (a.float() - r.float()).abs().max().item()
        ex, ex_auto = _excess(a, r, rtol), _excess(a, au, rtol)
        good = (bool(torch.isfinite(a).all()) and a.dtype == dtype
                and ex <= atol and ex_auto <= atol)
        ok = ok and good
        max_err = max(max_err, err)
        print(f"{shape} {str(dtype):15s} {name:6s} max_abs_err {err:.3e}, "
              f"max |ref| {r.float().abs().max().item():.3f}, "
              f"max(err - {rtol:.3g}|ref|) {ex:.3e} vs the plain "
              f"backward, {ex_auto:.3e} vs autograd of the plain "
              f"forward (atol {atol:.3g}) {'ok' if good else 'FAIL'}",
              flush=True)
    if not ok:
        raise SystemExit(f"K2 disagrees with its plain backward at "
                         f"{shape} (launches K1, K2: {launched})")
    return max_err


def check_k2(dev):
    """K2 (through the autograd Function, after K1) against the plain
    backward and against autograd through the plain forward in f32, at
    BWD_CASES; then K2 and flash SDPA's backward timed in turns, and the
    plain backward, at K2_TIMED.  Returns (max_abs_err, {shape: (ms,
    plain_ms, library_ms, bound_ms, bound_by)})."""
    gen = torch.Generator(device=dev).manual_seed(1)
    max_err = max(check_k2_case(gen, shape, dtype)
                  for shape, dtype in BWD_CASES)
    timed = {shape: time_k2(gen, shape) for shape in K2_TIMED}
    return max_err, timed


class RecordOps(TorchDispatchMode):
    """Records each op dispatched inside, with its arguments, and runs
    it."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.calls.append((func, args, kwargs))
        return func(*args, **kwargs)


def sdpa_backward(q4, k4, v4, do4):
    """(a call that runs the ops SDPA's autograd node dispatches for the
    gradients of q4, k4, v4 given do4, their names): recorded once under
    the SDPA backend in force, replayed without autograd's engine, which
    would add its host time to a timing by events."""
    o4 = F.scaled_dot_product_attention(q4, k4, v4, scale=1.0)
    with RecordOps() as rec:
        torch.autograd.grad(o4, (q4, k4, v4), do4)
    return ((lambda: [f(*a, **kw) for f, a, kw in rec.calls]),
            sorted({str(f) for f, _, _ in rec.calls}))


def time_k2(gen, shape) -> tuple:
    """K2 (bf16) timed in turns with flash SDPA's backward at the same
    head dim, and the plain backward; prints them with the bound.  Returns
    (ms, plain_ms, library_ms, bound_ms, bound_by)."""
    b, n, d = shape
    t, p, g, do = k2_operands(gen, (b, n, d), torch.bfloat16)
    with torch.no_grad():
        out, lse = _launch_fwd(t, p, g, with_lse=True)
    # yardstick only: the port never calls it.  The backward of flash
    # SDPA on [B, 1, N, D] with scale 1, the forward kept out of the
    # timing; the gradients returned fresh, as K2's are, not
    # accumulated into .grad
    q4, k4, v4 = (x[:, None].clone().requires_grad_() for x in (t, p, g))
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        flash, _ = sdpa_backward(q4, k4, v4, do[:, None].contiguous())
    turns = alternate_ms({
        "kernel": lambda: nonlocal_attention_bwd(t, p, g, out, lse, do),
        "flash": flash})
    with torch.no_grad():
        plain_ms = cuda_ms(lambda: nonlocal_attention_bwd_reference(
            t, p, g, do))
    k2_ms, sdpa_ms = (float(np.median(turns[k])) for k in turns)
    bound_ms, bound_by = attention_bwd_bound_ms(b, n, d, torch.bfloat16)
    tflops = 10.0 * b * n * n * d / k2_ms / 1e9
    print(f"({b},{n},{d}) bf16: kernel {k2_ms:.4f} ms ({tflops:.0f} "
          f"TFLOP/s, {100 * bound_ms / k2_ms:.1f}% of the bound "
          f"{bound_ms:.4f} ms, {bound_by}), plain backward "
          f"{plain_ms:.4f} ms, flash sdpa backward {sdpa_ms:.4f} ms; "
          f"kernel / flash {k2_ms / sdpa_ms:.2f} (medians; by turn "
          f"kernel {', '.join(f'{x:.4f}' for x in turns['kernel'])}, "
          f"flash {', '.join(f'{x:.4f}' for x in turns['flash'])})",
          flush=True)
    return k2_ms, plain_ms, sdpa_ms, bound_ms, bound_by


def synthetic_train_batch(views: int, size: int, device, seed: int = 0):
    """A seeded synthetic train batch: uniform images and their darkened
    twins, one random elliptic occluder mask a view, small offsets; the UV
    and face maps of LM_REF from the port's host rasterizer."""
    rng = np.random.default_rng(seed)
    gt = rng.uniform(0.05, 0.95, (views, size, size, 3)).astype(np.float32)
    dark = gt * rng.uniform(0.3, 0.7, (views, 1, 1, 1)).astype(np.float32)
    yy, xx = np.mgrid[:size, :size] / size
    cy, cx = rng.uniform(0.3, 0.7, (2, views, 1, 1))
    ry, rx = rng.uniform(0.1, 0.3, (2, views, 1, 1))
    mask = (((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1.0)
    uv = generate_uv_map(LM_REF, size)
    face = generate_face_region(LM_REF, size)
    batch = {
        "gt": gt, "img_dark": dark.astype(np.float32),
        "mask": mask[..., None].astype(np.float32),
        "uv": np.broadcast_to(uv, (views,) + uv.shape),
        "face": np.broadcast_to(face, (views,) + face.shape),
        "reg": rng.uniform(-0.02, 0.02, (views, size, size, 6)).astype(
            np.float32)}
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def train_full_width(dev, smi: str):
    """TRAIN_WARMUP + TRAIN_STEPS steps of the GSC train step at 256 px,
    n_res=6, bf16 compute and VGG, random VGG, no remat, batch TRAIN_BATCH;
    the timed steps by CUDA events, with K1 and K2 counted.  Checks finite
    losses, moving G and D parameters and 6 launches of each kernel a step,
    then profiles one step.  Returns the (K1, K2) launches of the timed
    steps and the ms a step."""
    torch.backends.cudnn.allow_tf32 = True     # PyTorch's defaults
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("train", batch_size=TRAIN_BATCH,
                     compute_dtype="bfloat16", vgg_dtype="bfloat16",
                     remat=False)
    trainer = Trainer(cfg, device=dev)
    state = trainer.init_state(seed=0)
    views = 2 * cfg.batch_size
    batch = synthetic_train_batch(views, cfg.img_size, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    for _ in range(TRAIN_WARMUP):
        trainer.train_step(state, batch, gen)
    torch.cuda.synchronize()
    print(f"{TRAIN_WARMUP} warm-up steps: {time.perf_counter() - t0:.1f} s")
    g_before = [p.detach().clone() for p in state.gen.parameters()]
    d_before = [p.detach().clone() for p in state.disc.parameters()]
    torch.cuda.reset_peak_memory_stats()
    nonlocal_attention.launches = 0
    nonlocal_attention_bwd.launches = 0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    losses = []
    start.record()
    for _ in range(TRAIN_STEPS):
        state, step_losses, _ = trainer.train_step(state, batch, gen)
        losses.append(torch.stack([step_losses[k] for k in LOSS_NAMES]))
    end.record()
    torch.cuda.synchronize()
    k1, k2 = nonlocal_attention.launches, nonlocal_attention_bwd.launches
    step_ms = start.elapsed_time(end) / TRAIN_STEPS
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    vals = torch.stack(losses).float().cpu().numpy()
    print(f"{views} views of {cfg.img_size} px a step, bf16: {step_ms:.1f} "
          f"ms/step, {views * 1e3 / step_ms:.1f} views/s, peak memory "
          f"{peak:.2f} GiB ({smi}); K1 launches {k1}, K2 launches {k2} in "
          f"{TRAIN_STEPS} steps", flush=True)
    print("last step's losses: " + ", ".join(
        f"{k} {v:.4g}" for k, v in zip(LOSS_NAMES, vals[-1])))
    moved_g = sum(not torch.equal(a, b) for a, b in
                  zip(g_before, state.gen.parameters()))
    moved_d = sum(not torch.equal(a, b) for a, b in
                  zip(d_before, state.disc.parameters()))
    print(f"parameter tensors moved: G {moved_g}/{len(g_before)}, "
          f"D {moved_d}/{len(d_before)}")
    if not np.isfinite(vals).all():
        raise SystemExit("train: a loss is not finite")
    if moved_g == 0 or moved_d == 0:
        raise SystemExit("train: G or D parameters did not move")
    want = ATTN_CALLS_PER_FORWARD * TRAIN_STEPS
    if (k1, k2) != (want, want):
        raise SystemExit(f"train: K1 {k1}, K2 {k2} launches, expected "
                         f"{want} each")
    forward_stages(state, batch, gen, step_ms)
    # where the time goes: one step under torch.profiler
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_step(state, batch, gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = sorted(
        ((e.key, e.device_time_total / 1e3, e.count)
         for e in prof.key_averages()
         if e.device_type == torch.autograd.DeviceType.CUDA
         and e.device_time_total > 0), key=lambda e: -e[1])
    busy_ms = sum(ms for _, ms, _ in kernels)
    print(f"profiled step: {busy_ms:.2f} ms of device kernels in "
          f"{wall_ms:.2f} ms wall (device idle "
          f"{100 * (1 - busy_ms / wall_ms):.1f}%, profiler on), "
          f"{sum(c for _, _, c in kernels)} kernel launches")
    for key, ms, count in kernels[:15]:
        print(f"  {ms:8.3f} ms  {100 * ms / busy_ms:5.1f}%  x{count:<4d} "
              f"{key[:100]}")
    by_kind: dict[str, list] = {}
    for key, ms, count in kernels:
        entry = by_kind.setdefault(kernel_kind(key), [0.0, 0])
        entry[0] += ms
        entry[1] += count
    print("device time by kind of kernel (ms/step, share, launches):")
    for kind, (ms, count) in sorted(by_kind.items(), key=lambda kv: -kv[1][0]):
        print(f"  {ms:8.3f} ms  {100 * ms / busy_ms:5.1f}%  x{count:<5d} {kind}")
    del state, trainer, batch
    torch.cuda.empty_cache()
    return k1, k2, step_ms


def forward_stages(state, batch, gen, step_ms: float) -> None:
    """The forward side of the train step, stage by stage, without
    autograd (CUDA events, 3 calls after 1): the compositor, the generator,
    one discriminator pass, the two VGG passes and the losses.  The rest of
    the step is the backward passes, the second discriminator pass and the
    updates."""
    b = batch
    stages = {}
    with torch.no_grad():
        def compose():
            return trainer_module.compose_shadow_image(
                gen, b["mask"], b["gt"], b["img_dark"], b["face"])

        stages["compositor"] = cuda_ms(compose, iters=3, warmup=1)
        img, mask_sv, _ = compose()
        stages["generator"] = cuda_ms(
            lambda: state.gen(img, b["uv"], b["reg"]), iters=3, warmup=1)
        gs, rgb, _, _ = state.gen(img, b["uv"], b["reg"])
        d_in = torch.cat([torch.cat([b["gt"], rgb], 0),
                          torch.cat([mask_sv, mask_sv], 0)], 3)
        with frozen_stats(state.disc):
            stages["discriminators (one pass)"] = cuda_ms(
                lambda: state.disc(d_in), iters=3, warmup=1)
        stages["VGG (real and fake)"] = cuda_ms(
            lambda: (state.vgg(preprocess(b["gt"])),
                     state.vgg(preprocess(rgb))), iters=3, warmup=1)
        mask_bi = (mask_sv > 0.01).float()
        mask_edge = find_edge(mask_sv)
        gray = rgb_to_grayscale(b["gt"])
        stages["losses (recon, gradient)"] = cuda_ms(
            lambda: (reconstruction_losses(gs, rgb, b["gt"], gray, mask_bi,
                                           mask_edge),
                     multi_scale_gradient_loss(rgb, b["gt"], mask_bi,
                                               mask_edge)),
            iters=3, warmup=1)
    total = sum(stages.values())
    print("forward side by stage, without autograd (ms):")
    for name, ms in stages.items():
        print(f"  {ms:8.2f} ms  {100 * ms / step_ms:5.1f}% of a step  {name}")
    print(f"  {step_ms - total:8.2f} ms  {100 * (step_ms - total) / step_ms:5.1f}"
          f"% of a step  the rest (backward, second D pass, updates)",
          flush=True)


def _to(draws, device):
    if isinstance(draws, dict):
        return {k: _to(v, device) for k, v in draws.items()}
    if isinstance(draws, list):
        return [_to(v, device) for v in draws]
    return draws.to(device)


def _delta_fault(ctx, dout):
    """The autograd Function's backward with K2 taking Delta = rowsum(dO o O)
    3% too large: O enters K2 only there."""
    theta, phi, g, out, lse = ctx.saved_tensors
    return nonlocal_attention_bwd(theta, phi, g, 1.03 * out, lse,
                                  dout.contiguous())


def _bf16_fault(theta, phi, g):
    """K1 (and K2) on operands rounded to bf16 inside the f32 step."""
    return nonlocal_attention(*(x.to(torch.bfloat16).float()
                                for x in (theta, phi, g)))


def card_vs_cpu_step(dev, variant: str = "gsc"):
    """One f32 train step of `variant` (TF32 off) on the card and on the
    CPU, on the same batch and initial weights, with the randomness pinned:
    the same compositor draws on both, no saturation jitter, no mirror
    swap, and TSM's ShareLayer gate on.  Holds the losses and Adam's first
    moments of G and D to CHECK_LOSS_RTOL and CHECK_MOMENT_RTOL, and the
    moments that are zero in exact arithmetic to CHECK_STRAY_SHARE.  For
    GSC it then plants two faults on the card and fails unless the same
    limits reject each."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("train", variant=variant, **CHECK_CFG)
    views = 2 * cfg.batch_size
    batch = synthetic_train_batch(views, cfg.img_size, "cpu", seed=1)
    draws = draw_compose(torch.Generator().manual_seed(2), views, "cpu")
    gen = torch.Generator().manual_seed(5)
    perturbed = {k: v * (1.0 + 1e-6 * torch.randn(v.shape, generator=gen))
                 for k, v in batch.items()}
    cpu = torch.device("cpu")
    # (label, device, batch, (owner, name, planted function) or None)
    cases = (("card", dev, batch, None),
             ("cpu", cpu, batch, None),
             ("cpu+1e-6", cpu, perturbed, None))
    if variant == "gsc":
        cases += (("card, K2 Delta x1.03", dev, batch,
                   (attn_module._NonLocalAttention, "backward",
                    staticmethod(_delta_fault))),
                  ("card, bf16 attention operands", dev, batch,
                   (blocks_module, "nonlocal_attention", _bf16_fault)))
    compose = trainer_module.compose_shadow_image
    runs = {}
    for label, device, b, fault in cases:
        saved = fault and inspect.getattr_static(fault[0], fault[1])
        try:
            trainer_module.compose_shadow_image = (
                lambda gen, mask, gt, dark, face, _d=_to(draws, device):
                compose_from_draws(_d, mask, gt, dark, face))
            if fault:
                setattr(fault[0], fault[1], fault[2])
            trainer = Trainer(cfg, device=device)
            trainer._saturation_aug = lambda gen, gt, dark: (gt, dark)
            trainer._mirror_consistency = lambda gen, img: img
            trainer.share_gate = lambda gen, train: True
            state = trainer.init_state(seed=0)
            nonlocal_attention.launches = 0
            nonlocal_attention_bwd.launches = 0
            state, losses, _ = trainer.train_step(
                state, {k: v.to(device) for k, v in b.items()},
                torch.Generator(device=device))
        finally:
            trainer_module.compose_shadow_image = compose
            if fault:
                setattr(fault[0], fault[1], saved)
        launches = (nonlocal_attention.launches,
                    nonlocal_attention_bwd.launches)
        moments = {
            f"{net}.{n}": opt.state[p]["exp_avg"].cpu()
            for net, module, opt in (("G", state.gen, state.gen_opt),
                                     ("D", state.disc, state.disc_opt))
            for n, p in module.named_parameters()}
        runs[label] = ({k: float(v) for k, v in losses.items()}, moments,
                       launches)
    cpu_losses, cpu_mu, _ = runs["cpu"]
    top = max(float(m.abs().max()) for m in cpu_mu.values())
    zero = {n for n, m in cpu_mu.items()
            if float(m.abs().max()) < CHECK_ZERO_SHARE * top}

    def worst(label):
        """(worst relative loss difference, (worst relative first-moment
        difference, its tensor), largest |moment| / top over `zero`)."""
        losses, mu, _ = runs[label]
        loss = max(abs(losses[k] - cpu_losses[k])
                   / max(abs(cpu_losses[k]), 1e-6) for k in LOSS_NAMES)
        errs = [(float((mu[n] - m).norm() / m.norm()), n)
                for n, m in cpu_mu.items() if n not in zero]
        stray = max((float(mu[n].abs().max()) / top for n in zero),
                    default=0.0)
        return loss, max(errs), stray

    print(f"{variant}: launches (K1, K2): " + ", ".join(
        f"{label} {runs[label][2]}" for label, *_ in cases))
    print("losses card / CPU: " + ", ".join(
        f"{k} {runs['card'][0][k]:.6g} / {cpu_losses[k]:.6g}"
        for k in LOSS_NAMES))
    print(f"{len(zero)} first moments below {CHECK_ZERO_SHARE:g} of the "
          f"largest on the CPU (biases feeding train-mode BatchNorm)")
    rejected = {}
    for label, *_ in cases:
        if label == "cpu":
            continue
        loss, (mu, name), stray = worst(label)
        rejected[label] = not (loss <= CHECK_LOSS_RTOL
                               and mu <= CHECK_MOMENT_RTOL)
        print(f"{label} against cpu: worst relative loss difference "
              f"{loss:.3e} (limit {CHECK_LOSS_RTOL:g}); worst first-moment "
              f"difference {mu:.3e} at {name} (limit {CHECK_MOMENT_RTOL:g}); "
              f"largest of the zero moments {stray:.3e} of the top (limit "
              f"{CHECK_STRAY_SHARE:g} for the card)"
              f"{'; rejected' if rejected[label] else ''}", flush=True)
    # RGB has n_res // 2 ResBottlenecks, each with its NonLocal block
    want = 2 * (CHECK_CFG["n_res"] // (2 if variant == "rgb" else 1),)
    if any(runs[label][2] != (want if device.type == "cuda" else (0, 0))
           for label, device, *_ in cases):
        raise SystemExit(f"{variant}: a card step did not launch K1 and K2 "
                         "once per NonLocal block, or a CPU step did")
    if rejected["card"] or worst("card")[2] >= CHECK_STRAY_SHARE:
        raise SystemExit(f"the card's {variant} train step disagrees with "
                         "the CPU's")
    if not all(rejected[label] for label, _, _, fault in cases if fault):
        raise SystemExit("the limits let a planted fault through")


# the fit path (phase 13): fit on a synthetic training tree at full width
FIT_IDENTITIES = 8           # 6 to train on, 2 to validate on
FIT_FRAMES = 4
FIT_IMAGE = 512
FIT_MASKS = 16               # the occluder library
FIT_STEPS = 10               # a val pass of FIT_STEPS // 10 = 1 step
FIT_PROBE_IMAGES = 4         # the UCB probe of select_best
FIT_HOST_BATCH = 4           # the host wires: the host rasterizer takes
FIT_HOST_STEPS = 2           # ~1.1 s of pool time a sample
FIT_RESUME_STEPS = 3         # the resumed epoch, profiled


def synthetic_train_tree(root: str, seed: int = 0):
    """A training tree under `root`: `train/id<k>/<f>.png|.npy` (6
    identities) and `val/...` (2), FIT_FRAMES frames of FIT_IMAGE^2 each,
    a colour ramp in the identity's tint with noise, and LM_REF scaled,
    shifted and jittered into it; `masks/`, FIT_MASKS occluder PNGs
    (ellipses, half of them with a bar).  Returns (train glob, val glob,
    mask dir)."""
    rng = np.random.default_rng(seed)
    n = FIT_IMAGE
    yy, xx = np.mgrid[:n, :n] / n
    ramp = np.stack([yy, xx, yy * xx], -1)
    for k in range(FIT_IDENTITIES):
        split = "train" if k < FIT_IDENTITIES - 2 else "val"
        d = os.path.join(root, split, f"id{k}")
        os.makedirs(d)
        tint = rng.uniform(0.2, 0.6, 3)
        for f in range(FIT_FRAMES):
            img = tint + 0.3 * ramp + rng.normal(0.0, 0.05, (n, n, 3))
            write_png(os.path.join(d, f"{f}.png"),
                      np.rint(np.clip(img, 0, 1) * 255).astype(np.uint8),
                      level=1)
            # 220-320 px faces at 512 px, as synthetic_requests places them
            scale = n * rng.uniform(0.43, 0.625)
            x0, y0 = rng.uniform(0.12 * n, 0.88 * n - scale, size=2)
            lm = LM_REF * scale + np.array([x0, y0]) + rng.normal(
                scale=1.5, size=LM_REF.shape)
            np.save(os.path.join(d, f"{f}.npy"), lm.astype(np.float32))
    masks = os.path.join(root, "masks")
    os.makedirs(masks)
    yy, xx = np.mgrid[:256, :256] / 256
    for i in range(FIT_MASKS):
        cy, cx = rng.uniform(0.3, 0.7, 2)
        ry, rx = rng.uniform(0.1, 0.35, 2)
        m = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1.0
        if i % 2:
            m |= np.abs(xx - rng.uniform(0.2, 0.8)) < rng.uniform(0.02, 0.08)
        write_png(os.path.join(masks, f"{i}.png"), (m * 255).astype(np.uint8))
    return (os.path.join(root, "train", "*"), os.path.join(root, "val", "*"),
            masks)


def parse_ms(cfg, samples: int, workers: int) -> float:
    """ms a sample from `cfg`'s train iterator with `workers` parse
    processes, over `samples` after the 2 * workers it starts with."""
    it = iter(Dataset(cfg, "train", workers=workers))
    try:
        for _ in range(2 * workers):
            next(it)
        t0 = time.perf_counter()
        for _ in range(samples):
            next(it)
        return 1e3 * (time.perf_counter() - t0) / samples
    finally:
        it.close()


def state_differences(a, b) -> list[str]:
    """Names of what differs (not bitwise equal) between two TrainStates:
    the step, G, D and VGG tensors, both Adam states, the LR count."""
    sa, sb = a.state_dict(), b.state_dict()
    out = [k for k in ("step", "lr_count") if sa[k] != sb[k]]
    for net in ("gen", "disc", "vgg"):
        out += [f"{net} {k}" for k in sa[net]
                if not torch.equal(sa[net][k], sb[net][k])]
    for opt in ("gen_opt", "disc_opt"):
        if sa[opt]["count"] != sb[opt]["count"]:
            out.append(f"{opt} count")
        for moment in ("exp_avg", "exp_avg_sq"):
            ma, mb = sa[opt][moment], sb[opt][moment]
            if ma.keys() != mb.keys():
                out.append(f"{opt} {moment} keys")
                continue
            out += [f"{opt} {moment} {k}" for k in ma
                    if not torch.equal(ma[k], mb[k])]
    return out


def run_fit(cfg, label: str, dev, expect: tuple, smi: str, **kw):
    """`fit` of `cfg` on its train (and val) tree with K1 and K2 counted;
    fails unless they launched `expect` times, every epoch's last losses
    are finite and the parameters are finite.  Prints each epoch's step
    time, prefetcher wait and losses.  Returns (state, stats, launches)."""
    stats = {}
    val = Dataset(cfg, "val", seed=1) if cfg.data_dirs_val else None
    nonlocal_attention.launches = 0
    nonlocal_attention_bwd.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as log:
        state = train_loop.fit(cfg, Dataset(cfg, "train"), val, seed=0,
                               device=dev, stats=stats, **kw)
    wall = time.perf_counter() - t0
    launched = (nonlocal_attention.launches, nonlocal_attention_bwd.launches)
    views = 2 * cfg.batch_size
    for line in log.getvalue().splitlines():
        if line.startswith(("probe:", "Restore from")):
            print(f"{label}: {line}")
    for ep in stats["epochs"]:
        ms = 1e3 * ep["step_s"] / ep["steps"]
        print(f"{label} epoch {ep['epoch']}: {ep['steps']} steps of {views} "
              f"views, {ms:.1f} ms/step ({views * 1e3 / ms:.1f} views/s, "
              f"host clock, synchronized at the epoch's end), waiting on "
              f"the prefetcher {100 * ep['wait_s'] / ep['step_s']:.1f}% of "
              f"it; save {ep['save_s']:.2f} s, probe {ep['probe_s']:.2f} s, "
              f"val {ep['val_s']:.2f} s ({smi}); last losses " + ", ".join(
                  f"{k} {v:.4g}" for k, v in ep["losses"].items()),
              flush=True)
        if not all(np.isfinite(v) for v in ep["losses"].values()):
            raise SystemExit(f"{label}: a loss is not finite")
    print(f"{label}: {wall:.1f} s wall; K1, K2 launches {launched} "
          f"(expected {expect})", flush=True)
    if launched != expect:
        raise SystemExit(f"{label}: K1, K2 launches {launched}, expected "
                         f"{expect}")
    if not all(bool(torch.isfinite(p).all()) for p in state.gen.parameters()):
        raise SystemExit(f"{label}: a generator parameter is not finite")
    return state, stats, launched


def fit_window_idle(prof, name: str = "fit.steps"):
    """(window ms, kernel ms, copy ms) of the device inside the first
    CPU-side `name` range of a profile: kernels and copies that started in
    it (the range ends in a synchronize)."""
    events = prof.events()
    window = next(e for e in events if e.name == name
                  and e.device_type == torch.autograd.DeviceType.CPU)
    t0, t1 = window.time_range.start, window.time_range.end
    kern = copies = 0.0
    for e in events:
        if (e.device_type != torch.autograd.DeviceType.CUDA or e.name == name
                or not t0 <= e.time_range.start < t1):
            continue
        us = e.time_range.elapsed_us()
        if e.name.startswith(("Memcpy", "Memset")):
            copies += us
        else:
            kern += us
    return (t1 - t0) / 1e3, kern / 1e3, copies / 1e3


def record_attention_shapes():
    """Records (wrapper, shape, dtype) of every K1 and K2 launch from now
    on, at the wrappers' contract check.  Returns (the set it fills, a
    function that stops the recording)."""
    seen, check = set(), attn_module._check

    def recording(name, tensors):
        first = next(iter(tensors.values()))
        seen.add((name, tuple(first.shape), first.dtype))
        return check(name, tensors)

    attn_module._check = recording

    def stop():
        attn_module._check = check

    return seen, stop


def fit_path(dev, smi: str, work: str, bare_step_ms: float):
    """Phase 13: training end to end through `fit`, at 256 px, n_res=6,
    bf16, batch TRAIN_BATCH, on a synthetic training tree: fit A on the
    JAX CLI's default wires (compact uint8 ingress, device geometry,
    device darkening) for 2 epochs with the val pass and select_best's
    UCB probe; the checkpoint restored bitwise; a resume to a third epoch
    of FIT_RESUME_STEPS steps, profiled; fit B on the host wires (host
    maps, host tone curve, uint16); the trained generator served from
    `restore_eval`, the card's bf16 against the CPU's f32; then K1 and K2
    against their plain versions at every shape the path gave them.  And
    the tone curve on the card with TF32 allowed against the CPU.  Returns
    ({sub-path: (K1, K2 launches)}, K1's and K2's max abs errors)."""
    torch.backends.cudnn.allow_tf32 = True     # PyTorch's defaults
    torch.backends.cuda.matmul.allow_tf32 = False
    t_phase = time.perf_counter()
    train_glob, val_glob, masks = synthetic_train_tree(
        os.path.join(work, "data"))
    ucb = synthetic_ucb_tree(os.path.join(work, "ucb"),
                             n_images=FIT_PROBE_IMAGES)
    base = dict(compute_dtype="bfloat16", vgg_dtype="bfloat16", remat=False,
                data_dirs=(train_glob,), shadow_mask_dir=masks,
                data_dirs_test=(os.path.join(ucb, "input", "*"),),
                part_mask_root=ucb, img_log_freq=FIT_STEPS,
                txt_log_freq=FIT_STEPS)
    device_wires = dict(compact_ingress=True, ingress_u8=True,
                        device_geometry=True, device_darken=True)
    host_wires = dict(compact_ingress=True, ingress_u8=False,
                      device_geometry=False, device_darken=False)
    ckpt = os.path.join(work, "ckpt")
    cfg_a = get_config("train", batch_size=TRAIN_BATCH,
                       steps_per_epoch=FIT_STEPS, max_epoch=2,
                       data_dirs_val=(val_glob,), checkpoint_dir=ckpt,
                       **base, **device_wires)
    cfg_b = get_config("train", batch_size=FIT_HOST_BATCH,
                       steps_per_epoch=FIT_HOST_STEPS, max_epoch=1,
                       checkpoint_dir=os.path.join(work, "ckpt_host"),
                       **base, **host_wires)
    print(f"training tree: {FIT_IDENTITIES - 2} + 2 identities x "
          f"{FIT_FRAMES} frames of {FIT_IMAGE} px, {FIT_MASKS} occluder "
          f"PNGs, {FIT_PROBE_IMAGES} UCB probe images; written in "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)

    # --- the host parse on each wire from the default pool; on the device
    # wires also from one worker process
    workers = Dataset(cfg_a, "train").workers
    one = parse_ms(cfg_a, 8, 1)
    for label, cfg, n_pool in (("device wires", cfg_a, 48),
                               ("host wires", cfg_b, workers)):
        pool = parse_ms(cfg, n_pool, workers)
        print(f"host parse, {label}: {pool:.1f} ms a sample from {workers} "
              f"worker processes on {os.cpu_count()} cores, so "
              f"{TRAIN_BATCH * pool:.0f} ms a batch of {TRAIN_BATCH}"
              + (f"; {one:.1f} ms from one" if cfg is cfg_a else "")
              + f" ({smi})", flush=True)

    # --- the tone curve on the card with TF32 allowed, against the CPU
    ds = Dataset(cfg_a, "train")
    rng = np.random.default_rng(3)
    raw = torch.from_numpy(np.concatenate(
        [ds.parse_train(ds.name_list[i % len(ds.name_list)], rng=rng)["gt"]
         for i in range(8)]))
    g1, g2 = draw_face_darken(torch.Generator().manual_seed(0), 8, "cpu")
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        card = darkened_views_from_draws(g1.to(dev), g2.to(dev), raw.to(dev))
        a = raw[0::2].reshape(8, -1, 3).to(dev)
        ata_tf32 = a.transpose(1, 2) @ a         # what an f32 product gives
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
    cpu = darkened_views_from_draws(g1, g2, raw)
    err = max(float((c.cpu() - r).abs().max()) for c, r in zip(card, cpu))
    ata = a.double().transpose(1, 2) @ a.double()
    tf32_err = float(((ata_tf32.double() - ata).abs()
                      / ata.abs().amax(dim=(1, 2), keepdim=True)).max())
    print(f"tone curve on 16 crops, card with TF32 allowed vs CPU: max "
          f"|d| {err:.2e} (bar 1e-5); the normal equations as a TF32 "
          f"product would be {tf32_err:.1e} of their largest entry off",
          flush=True)
    if not err <= 1e-5:
        raise SystemExit("the tone curve on the card disagrees with the CPU")
    del card, a, ata, ata_tf32, ds

    # --- fit A, the CLI's default wires, 2 epochs
    seen, stop_recording = record_attention_shapes()
    k = ATTN_CALLS_PER_FORWARD
    per_epoch = (k * (FIT_STEPS + FIT_STEPS // 10 + FIT_PROBE_IMAGES),
                 k * FIT_STEPS)
    launches = {}
    state_a, stats_a, launches["A"] = run_fit(
        cfg_a, "fit A", dev, tuple(2 * n for n in per_epoch), smi,
        select_best=True, probe_images=FIT_PROBE_IMAGES)
    mgr = CheckpointManager(ckpt, device=dev)
    if state_a.step != 2 * FIT_STEPS or mgr.all_steps() != [1, 2]:
        raise SystemExit(f"fit A: step {state_a.step}, checkpoints "
                         f"{mgr.all_steps()}")
    best = mgr.best_record()
    print(f"fit A: checkpoints {mgr.all_steps()}, best {best}", flush=True)
    ep2 = stats_a["epochs"][-1]
    fit_ms = 1e3 * ep2["step_s"] / ep2["steps"]
    print(f"fit A, epoch 2: {fit_ms:.1f} ms/step against the bare step's "
          f"{bare_step_ms:.1f} (phase 8, CUDA events), "
          f"{fit_ms / bare_step_ms:.2f}x; waiting on the prefetcher "
          f"{100 * ep2['wait_s'] / ep2['step_s']:.1f}% of the step loop "
          f"({smi})", flush=True)

    # --- the checkpoint restores bitwise
    template = Trainer(cfg_a, device=dev).init_state(seed=1)
    restored, epoch = mgr.restore_latest(template)
    differ = state_differences(state_a, restored)
    print(f"restored epoch {epoch}: {len(differ)} tensors or counts differ "
          f"from the saved state (G, D, VGG, both Adam states, step)",
          flush=True)
    if epoch != 2 or differ:
        raise SystemExit(f"restore: epoch {epoch}, differing {differ[:5]}")
    saved_gen = {k: v.clone() for k, v in state_a.gen.state_dict().items()}
    del template, restored

    # --- the bare step on a batch of the device wires (u8 raw crops,
    # landmarks and topologies), as phase 8 times it on host maps, and the
    # two stages those wires move onto the device
    it = iter(Dataset(cfg_a, "train"))      # closed after the next timing
    host = train_loop._assemble(it, cfg_a.batch_size, True, True)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
    trainer = Trainer.shared(cfg_a, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    nonlocal_attention.launches = 0
    nonlocal_attention_bwd.launches = 0
    wire_ms = cuda_ms(lambda: trainer.train_step(state_a, batch, gen),
                      iters=5, warmup=2)
    with torch.no_grad():
        geo_ms = cuda_ms(lambda: device_geometry_maps(
            batch["lm"], batch["face_pts"], batch["uv_tris"],
            batch["face_tris"], batch["reg_tris"], cfg_a.img_size),
            iters=3, warmup=1)
        raw = dequantize(batch["gt"])
        dark_ms = cuda_ms(lambda: derive_darkened_views(gen, raw), iters=3,
                          warmup=1)
    print(f"the bare step on a device-wire batch: {wire_ms:.1f} ms/step "
          f"(CUDA events, 5 steps after 2; fit A's epoch 2 "
          f"{fit_ms / wire_ms:.2f}x of it), against phase 8's "
          f"{bare_step_ms:.1f} on host maps; on the device: geometry maps "
          f"{geo_ms:.1f} ms, tone curve {dark_ms:.1f} ms a batch ({smi})",
          flush=True)
    # the same step beside the parse pool and the batch assembly: the
    # host work fit's prefetcher does while a step runs
    done = threading.Event()

    def feed():
        while not done.is_set():
            train_loop._assemble(it, cfg_a.batch_size, True, True)

    feeder = threading.Thread(target=feed)
    feeder.start()
    try:
        time.sleep(1.0)
        beside_ms = cuda_ms(lambda: trainer.train_step(state_a, batch, gen),
                            iters=5, warmup=1)
    finally:
        done.set()
        feeder.join()
        it.close()
    launches["bare device wires"] = (nonlocal_attention.launches,
                                     nonlocal_attention_bwd.launches)
    print(f"the same step beside the default {workers} parse processes and "
          f"a thread assembling their batches: {beside_ms:.1f} ms/step "
          f"(CUDA events, 5 steps after 1; {beside_ms / wire_ms:.2f}x of "
          f"it alone; fit A's epoch 2 {fit_ms / beside_ms:.2f}x of it); "
          f"K1, K2 launches in the 13 bare steps "
          f"{launches['bare device wires']} ({smi})", flush=True)
    if launches["bare device wires"] != (13 * k, 13 * k):
        raise SystemExit("bare device-wire steps: K1, K2 launches "
                         f"{launches['bare device wires']}")
    del state_a, batch, raw, trainer
    torch.cuda.empty_cache()

    # --- resume: max_epoch raised, one more epoch (of FIT_RESUME_STEPS
    # steps) from the saved one, profiled: the device's idle share
    cfg_r = dataclasses.replace(cfg_a, max_epoch=3,
                                steps_per_epoch=FIT_RESUME_STEPS)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
        state_r, stats_r, launches["resume"] = run_fit(
            cfg_r, "resume", dev,
            (k * (FIT_RESUME_STEPS + FIT_PROBE_IMAGES),
             k * FIT_RESUME_STEPS), smi, select_best=True,
            probe_images=FIT_PROBE_IMAGES)
    window_ms, kern_ms, copy_ms = fit_window_idle(prof)
    # the profiler's host-side recording of every launch stretches the
    # window; fit A's unprofiled second epoch runs the same steps
    step_kern_ms = kern_ms / FIT_RESUME_STEPS
    print(f"resume, its {FIT_RESUME_STEPS} steps profiled: device kernels "
          f"{kern_ms:.1f} ms, {step_kern_ms:.1f} a step, copies "
          f"{copy_ms:.1f} ms; the device idles "
          f"{100 * (1 - step_kern_ms / fit_ms):.1f}% of fit A's unprofiled "
          f"{fit_ms:.1f} ms step, {100 * (1 - kern_ms / window_ms):.1f}% "
          f"of the profiled window ({window_ms:.1f} ms from the first step "
          f"to the synchronize, profiler on) ({smi})", flush=True)
    moved = sum(not torch.equal(v, saved_gen[k])
                for k, v in state_r.gen.state_dict().items())
    print(f"resume: epochs run {[e['epoch'] for e in stats_r['epochs']]}, "
          f"step {state_r.step}, generator tensors moved {moved}/"
          f"{len(saved_gen)}", flush=True)
    if ([e["epoch"] for e in stats_r["epochs"]] != [3] or moved == 0
            or state_r.step != 2 * FIT_STEPS + FIT_RESUME_STEPS):
        raise SystemExit("resume did not continue from epoch 2")
    del state_r, saved_gen, prof
    torch.cuda.empty_cache()

    # --- fit B, the host wires
    state_b, _, launches["B"] = run_fit(
        cfg_b, "fit B (host maps, host tone curve, uint16)", dev,
        (k * FIT_HOST_STEPS, k * FIT_HOST_STEPS), smi)
    del state_b
    torch.cuda.empty_cache()

    # --- from training to serving: the newest checkpoint's generator
    sd, step = CheckpointManager(ckpt).restore_eval()
    svc = ShadowRemovalService(
        get_config(compute_dtype="bfloat16", fold_bn=True,
                   egress_dtype="bfloat16"), sd, batch_size=8, device=dev)
    images, lms = synthetic_requests(4, seed=3)
    nonlocal_attention.launches = 0
    results = svc.remove_shadows(images, lms)
    launches["serve"] = (nonlocal_attention.launches, 0)
    cpu = ShadowRemovalService(get_config(compute_dtype="float32"), sd,
                               batch_size=2, device="cpu")
    scores = [psnr(results[i]["pred"], r["pred"]) for i, r in
              enumerate(cpu.remove_shadows(images[:2], lms[:2]))]
    print(f"served the epoch-{step} generator: {len(results)} requests, K1 "
          f"launches {launches['serve'][0]}; card bf16 vs CPU f32 pred PSNR "
          + ", ".join(f"{x:.2f}" for x in scores) + " dB (bar 40 dB)",
          flush=True)
    if not all(x >= 40.0 for x in scores):
        raise SystemExit("the trained generator served on the card "
                         "disagrees with the CPU")
    if launches["serve"][0] != k:
        raise SystemExit(f"serve: {launches['serve'][0]} K1 launches")
    stop_recording()

    # the resumed epoch's UCB probe (the card, bf16) against the same probe
    # of the same generator on the CPU in f32.  Phase 10 holds UCB to the
    # CPU in f32 and records bf16's rounding only; this bar catches gross
    # faults (a composite from the wrong mask or image moves it by dBs)
    card_psnr = stats_r["epochs"][0]["probe"]
    cpu_probe = train_loop._UCBProbe(
        dataclasses.replace(cfg_r, compute_dtype="float32"),
        FIT_PROBE_IMAGES, device="cpu")
    cpu_psnr = cpu_probe(types.SimpleNamespace(
        gen=types.SimpleNamespace(state_dict=lambda: sd)))
    print(f"the epoch-{step} UCB probe: card bf16 {card_psnr:.4f} dB, CPU "
          f"f32 {cpu_psnr:.4f} dB, |d| {abs(card_psnr - cpu_psnr):.2e} "
          f"(bar 1 dB)", flush=True)
    if not abs(card_psnr - cpu_psnr) <= 1.0:
        raise SystemExit("the UCB probe on the card disagrees with the CPU")

    # --- K1 and K2 at every shape the path gave them
    print("K1 and K2 at the shapes the fit path gave them, against their "
          "plain versions:", flush=True)
    check_gen = torch.Generator(device=dev).manual_seed(13)
    k1_err = k2_err = 0.0
    for name, shape, dtype in sorted(seen, key=str):
        if name == "nonlocal_attention":
            k1_err = max(k1_err, check_k1(check_gen, shape, dtype))
        else:
            k2_err = max(k2_err, check_k2_case(check_gen, shape, dtype))
    print(f"phase 13: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches, k1_err, k2_err


# the front end (phase 14): run_e2e's defaults (cli.py:210-226 in the JAX
# package) on uncropped photos: the SFW-synth face scaled 2-3x into 720x1280
# and 1024x768 frames, half of them with their landmarks beside them
E2E_PHOTOS = 64
E2E_CANVASES = ((720, 1280), (1024, 768))
E2E_FACE_SCALE = (2.0, 3.0)
E2E_STAGES = dict(det_size=640, det_batch=4, fan_batch=16, fan_modules=4,
                  min_face=250)
E2E_SERVE_BATCH = 16
E2E_BATCH_FILES = 16
E2E_CPU_PHOTOS = 8           # 4 with landmarks, 4 detected
FRONTEND_REQUESTS = 70
FRONTEND_CLIENTS = 4
SFW_FACE = TF_REF / "sfw_synth" / "vid0" / "0"
# card f32 against CPU f32 (TF32 off in both networks' convolutions; cuDNN
# and oneDNN sum in different orders): S3FD scores and box offsets, FAN
# heatmaps (which reach ~50 under the seeded weights)
DET_SCORE_ATOL = 1e-4
DET_LOC_ATOL = 1e-3
DET_BOX_ATOL = 1e-2          # px, in the frame
FAN_HM_ATOL = 2e-3


def uncropped_photos(root: str, n: int = E2E_PHOTOS, seed: int = 0) -> list:
    """n PNGs `<i>.png` under root: a seeded two-colour gradient frame of
    E2E_CANVASES[i % 2] with the SFW-synth face scaled 2-3x pasted at a
    seeded place (the face clears min_face); photos 0, 1, 4, 5, ... get
    their landmarks as `<i>.npy`.  Returns the sorted paths."""
    face = read_png(str(SFW_FACE) + ".png")
    lm0 = np.load(str(SFW_FACE) + ".npy")
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    paths = []
    for i in range(n):
        h, w = E2E_CANVASES[i % 2]
        lo, hi = E2E_FACE_SCALE
        scale = rng.uniform(lo, min(hi, min(h, w) / face.shape[0]))
        side = round(face.shape[0] * scale)
        x, y = (int(v) for v in rng.integers(0, (w - side + 1, h - side + 1)))
        c0, c1 = rng.uniform(0.0, 255.0, (2, 3))
        ramp = (np.linspace(0.0, 0.5, w)[None, :, None]
                + np.linspace(0.0, 0.5, h)[:, None, None])
        photo = (c0 + (c1 - c0) * ramp).astype(np.uint8)
        photo[y:y + side, x:x + side] = resize_linear_u8(face, (side, side))
        path = os.path.join(root, f"{i:02d}.png")
        write_png(path, photo, level=1)
        if (i // 2) % 2 == 0:
            np.save(path[:-4] + ".npy",
                    (lm0 * (side / face.shape[0]) + [x, y]).astype(np.float32))
        paths.append(path)
    return paths


def read_photos(paths) -> tuple[list, list]:
    """RGB frames and their landmarks (None without a .npy), as run_dir
    reads them."""
    imgs, lms = [], []
    for f in paths:
        imgs.append(np.ascontiguousarray(imread(f)[..., ::-1]))
        npy = f[:-4] + ".npy"
        lms.append(np.load(npy) if os.path.isfile(npy) else None)
    return imgs, lms


def written(r: dict, key: str) -> np.ndarray:
    """A result plane as run_dir writes it, back on [0, 1]."""
    img8 = np.clip(np.asarray(r[key], np.float32) * 255.0, 0,
                   255).astype(np.uint8)
    if img8.shape[-1] == 1:
        img8 = np.repeat(img8, 3, axis=-1)
    return img8.astype(np.float32) / 255.0


def iou(a, b) -> float:
    ix = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
    iy = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = ix * iy
    area = lambda r: (r[2] - r[0]) * (r[3] - r[1])
    return inter / (area(a) + area(b) - inter)


def check_candidates(card: np.ndarray, cpu: np.ndarray, spans) -> tuple:
    """One image's top-k candidates ([K, 6]: score, flat index, loc 4) on
    the card against the CPU's, scale by scale: the indices both keep
    within DET_SCORE_ATOL and DET_LOC_ATOL, and an index only one keeps
    must lie within DET_SCORE_ATOL of that scale's k-th score (a near-tie
    at the cut).  Returns (max |d score|, max |d loc|, indices kept by one
    side only)."""
    d_score = d_loc = 0.0
    odd = start = 0
    for k, _ in spans:
        a, b = card[start:start + k], cpu[start:start + k]
        start += k
        ia = {int(i): r for i, r in zip(a[:, 1], a)}
        ib = {int(i): r for i, r in zip(b[:, 1], b)}
        for i in ia.keys() & ib.keys():
            d_score = max(d_score, abs(float(ia[i][0] - ib[i][0])))
            d_loc = max(d_loc, float(np.abs(ia[i][2:] - ib[i][2:]).max()))
        kth = float(b[-1, 0])
        for i in ia.keys() ^ ib.keys():
            odd += 1
            score = float((ia.get(i) if i in ia else ib[i])[0])
            if abs(score - kth) > DET_SCORE_ATOL:
                raise SystemExit(f"detector top-k: index {i} (score {score})"
                                 f" kept by one side only, k-th {kth}")
    if d_score > DET_SCORE_ATOL or d_loc > DET_LOC_ATOL:
        raise SystemExit(f"detector candidates card vs CPU: score "
                         f"{d_score:.3e}, loc {d_loc:.3e}")
    return d_score, d_loc, odd


def frontend_path(dev, sd: dict, smi: str, work: str) -> dict:
    """Phase 14: raw photos to deshadowed faces with `run_e2e`'s defaults
    (S3FD at 640, batch 4; FAN-4 at batch 16, both bf16, u8 FAN ingress;
    GSC 256 px, n_res 6, bf16 folded, compact wires, device geometry,
    serve batch 16; 16 files a chunk), the detector and aligner on seeded
    synthetic weights, the generator on the TF-golden ones:
    `run_dir` on E2E_PHOTOS photos, overlapped and serial (identical
    bytes), held against the CPU's f32 pipeline given the card's
    landmarks; the detector and aligner in f32 against the CPU's, bf16
    recorded; `DeshadowPipeline(images, boxes=...)` with f32 stages
    against the CPU; the `BatchingFrontend` under FRONTEND_CLIENTS client
    threads against `remove_shadows`; the stages' device and host times;
    K1 at every shape the path gave it.  Returns {"launches": {sub-path:
    K1 launches}, "k1_err"}."""
    torch.backends.cudnn.allow_tf32 = True     # PyTorch's defaults
    t_phase = time.perf_counter()
    threads_before = set(threading.enumerate())
    seen, stop_recording = record_attention_shapes()
    photos = os.path.join(work, "photos")
    paths = uncropped_photos(photos)
    chunks = [paths[s:s + E2E_BATCH_FILES]
              for s in range(0, len(paths), E2E_BATCH_FILES)]
    n_lm = sum(os.path.isfile(p[:-4] + ".npy") for p in paths)
    print(f"{len(paths)} photos ({n_lm} with landmarks) of "
          f"{' and '.join(f'{h}x{w}' for h, w in E2E_CANVASES)} written in "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)

    sfd_w = sfd_from_jax(synthetic_sfd_weights(0))
    fan_w = fan_from_jax(synthetic_fan_weights(0, E2E_STAGES["fan_modules"]))
    cfg = get_config(compute_dtype="bfloat16", fold_bn=True,
                     egress_dtype="bfloat16", compact_ingress=True,
                     compact_output=True)
    pipe = DeshadowPipeline(cfg, sd, fan_weights=fan_w, sfd_weights=sfd_w,
                            device=dev, batch_size=E2E_SERVE_BATCH,
                            **E2E_STAGES)
    assert pipe.service.device_geometry
    imgs0, lms0 = read_photos(chunks[0])
    t0 = time.perf_counter()
    pipe(imgs0, landmarks=lms0)                   # first calls at each shape
    torch.cuda.synchronize()
    print(f"pipeline built; a first chunk of {len(imgs0)} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # --- run_dir, overlapped then serial: the slice's main path
    launches, stats = {}, {}
    for mode, overlap in (("overlapped", True), ("serial", False)):
        nonlocal_attention.launches = 0
        stats[mode] = pipe.run_dir(photos, os.path.join(work, mode),
                                   batch_files=E2E_BATCH_FILES,
                                   overlap=overlap)
        launches[f"run_dir {mode}"] = nonlocal_attention.launches
        st = stats[mode]
        print(f"run_dir {mode}: {st['images']} photos, {st['written']} "
              f"written, {st['images'] - st['faces']} without a usable face, "
              f"{st['wall']:.2f} s wall, {st['images_per_s_wall']:.2f} "
              f"images/s; stage seconds detect {st['detect']:.2f}, align "
              f"{st['align']:.2f}, crop {st['crop']:.2f}, deshadow "
              f"{st['deshadow']:.2f} (sum {st['total']:.2f}); K1 launches "
              f"{launches[f'run_dir {mode}']} ({smi})", flush=True)
    over, ser = (sorted(os.listdir(os.path.join(work, m)))
                 for m in ("overlapped", "serial"))
    same = over == ser and all(
        open(os.path.join(work, "overlapped", f), "rb").read()
        == open(os.path.join(work, "serial", f), "rb").read() for f in over)
    print(f"overlapped and serial wrote {len(over)} and {len(ser)} files, "
          f"{'byte for byte the same' if same else 'DIFFERENT'}; overlapped "
          f"{stats['serial']['wall'] / stats['overlapped']['wall']:.2f}x "
          f"faster", flush=True)
    if not same or stats["overlapped"]["written"] == 0:
        raise SystemExit("run_dir: the overlapped and serial runs differ")
    served = -(-stats["overlapped"]["faces"] // E2E_SERVE_BATCH)
    chunks_with_faces = len(chunks)   # every chunk holds landmarked photos
    for mode in stats:
        if launches[f"run_dir {mode}"] != (ATTN_CALLS_PER_FORWARD
                                           * chunks_with_faces):
            raise SystemExit(f"run_dir {mode}: "
                             f"{launches[f'run_dir {mode}']} K1 launches")

    # --- the card's boxes and landmarks, stage by stage on the chunks and
    # batches run_dir used; then the CPU's f32 pipeline given them
    card_lms, card_boxes, frames = [], [], []
    for chunk in chunks:
        imgs, lms = read_photos(chunk)
        bxs, _ = pipe._stage_detect(imgs, lms, [None] * len(imgs))
        lms, _ = pipe._stage_align(imgs, lms, bxs)
        frames += imgs
        card_lms += lms
        card_boxes += bxs
    # the CPU's f32 pipeline takes ~1.7 s a photo on 8 host cores: it
    # holds the first E2E_CPU_PHOTOS (both kinds of photo), in
    # batches of 4 (a tail pads to the batch); the card's own f32 generator
    # holds all of them
    cpu_pipe = DeshadowPipeline(get_config(compute_dtype="float32"), sd,
                                fan_weights=fan_w, stage_dtype=torch.float32,
                                device="cpu", batch_size=4,
                                **{**E2E_STAGES, "fan_batch": 4})
    f32_pipe = DeshadowPipeline(get_config(compute_dtype="float32"), sd,
                                device=dev, batch_size=E2E_SERVE_BATCH,
                                **E2E_STAGES)
    for label, ref_pipe, n_ref in (
            ("CPU f32", cpu_pipe, E2E_CPU_PHOTOS),
            ("the card's f32 generator", f32_pipe, len(paths))):
        t0 = time.perf_counter()
        scores = {"out": [], "pred": [], "mask_pred": []}
        for start in range(0, n_ref, E2E_BATCH_FILES):
            sl = slice(start, min(start + E2E_BATCH_FILES, n_ref))
            for path, r in zip(paths[sl], ref_pipe(frames[sl],
                                                   landmarks=card_lms[sl])):
                name = os.path.basename(path)[:-4]
                have = os.path.isfile(os.path.join(work, "overlapped",
                                                   f"{name}-out.png"))
                if have != (r is not None):
                    raise SystemExit(f"{name}: {label} and the card disagree "
                                     "on whether it holds a usable face")
                if r is None:
                    continue
                for key, suffix in (("out", "out"), ("pred", "pred"),
                                    ("mask_pred", "mask")):
                    card = read_png(os.path.join(
                        work, "overlapped", f"{name}-{suffix}.png"))
                    scores[key].append(psnr(card.astype(np.float32) / 255.0,
                                            written(r, key)))
        worst = {k: min(v) for k, v in scores.items()}
        print(f"run_dir card bf16 vs {label} given the card's landmarks, "
              f"{len(scores['out'])} photos as written (uint8): PSNR min / "
              f"median " + ", ".join(f"{k} {worst[k]:.2f} / "
                                     f"{np.median(v):.2f}"
                                     for k, v in scores.items())
              + f" dB (bar 40 dB); {time.perf_counter() - t0:.1f} s"
              + (f" on {torch.get_num_threads()} threads"
                 if ref_pipe is cpu_pipe else ""), flush=True)
        if not all(x >= 40.0 for x in worst.values()):
            raise SystemExit(f"run_dir on the card disagrees with {label}")
    del f32_pipe

    # --- the detector: f32 card vs f32 CPU, bf16 recorded
    detected = [i for i, p in enumerate(paths)
                if not os.path.isfile(p[:-4] + ".npy")]
    det32 = FaceDetector(sfd_w, det_size=E2E_STAGES["det_size"],
                         batch_size=E2E_STAGES["det_batch"],
                         dtype=torch.float32, device=dev)
    det_cpu = FaceDetector(sfd_w, det_size=E2E_STAGES["det_size"],
                           batch_size=E2E_STAGES["det_batch"],
                           dtype=torch.float32, device="cpu")
    four = [frames[i] for i in detected[:E2E_STAGES["det_batch"]]]
    canvases = np.stack([letterbox(im, E2E_STAGES["det_size"])[0]
                         for im in four])
    c32, spans = det32.candidates(torch.from_numpy(canvases).to(dev))
    c32 = c32.cpu().numpy()
    ccpu = det_cpu.candidates(torch.from_numpy(canvases))[0].numpy()
    c16 = pipe.detector.candidates(torch.from_numpy(canvases).to(dev))[0]
    c16 = c16.float().cpu().numpy()
    d_score = d_loc = 0.0
    odd = 0
    for i in range(len(four)):
        ds, dl, o = check_candidates(c32[i], ccpu[i], spans)
        d_score, d_loc, odd = max(d_score, ds), max(d_loc, dl), odd + o
    # greedy NMS keeps the best box first and suppresses by it, so a score
    # near-tie (within the rounding of the two devices) may keep other
    # boxes: the best box must agree unless the two best candidates tie
    b32, bcpu = det32(four), det_cpu(four)
    same_nms = total_nms = 0
    d_best = 0.0
    for a, b, cand in zip(b32, bcpu, ccpu):
        total_nms += len(b)
        same_nms += sum(bool(np.any(np.abs(a - row).max(-1) <= DET_BOX_ATOL))
                        for row in b) if len(a) else 0
        if len(a) == 0 or len(b) == 0:
            if len(a) != len(b):
                raise SystemExit("detector: a face on one side only")
            continue
        top2 = np.sort(cand[:, 0])[-2:]
        d = float(np.abs(a[0, :4] - b[0, :4]).max())
        if d > DET_BOX_ATOL and top2[1] - top2[0] > DET_SCORE_ATOL:
            raise SystemExit(f"detector best box card vs CPU: {d:.3e} px")
        d_best = max(d_best, d)
    # bf16 (the path's) against f32 on the card, every detected photo
    best32 = [d[0, :4] if len(d) else None
              for d in det32([frames[i] for i in detected])]
    best16 = [card_boxes[i] for i in detected]
    same_box = sum(a is not None and b is not None and iou(a, b) > 0.99
                   for a, b in zip(best32, best16))
    d16 = float(np.abs(c16[..., 0] - c32[..., 0]).max())
    print(f"S3FD f32 card vs CPU at ({len(four)}, "
          f"{E2E_STAGES['det_size']}, {E2E_STAGES['det_size']}): top-k "
          f"scores {d_score:.3e} (atol {DET_SCORE_ATOL:g}), box offsets "
          f"{d_loc:.3e} (atol {DET_LOC_ATOL:g}), {odd} indices kept by one "
          f"side (near-ties at the cut); the best box within {d_best:.3e} "
          f"px (atol {DET_BOX_ATOL:g}); {same_nms} of {total_nms} boxes "
          f"after NMS the same on both. bf16 "
          f"on the card (record): top-k score |d| up to {d16:.3e} at the "
          f"same ranks; the best box (IoU > 0.99) the same as f32's on "
          f"{same_box} of {len(detected)} photos", flush=True)

    # --- the aligner: f32 card vs f32 CPU, bf16 recorded
    boxes = [b for b in best32 if b is not None][:E2E_STAGES["fan_batch"]]
    faces = [frames[i] for i, b in zip(detected, best32) if b is not None]
    faces = faces[:len(boxes)]
    al32 = LandmarkAligner(fan_w, E2E_STAGES["fan_modules"],
                           E2E_STAGES["fan_batch"], torch.float32,
                           device=dev)
    al_cpu = LandmarkAligner(fan_w, E2E_STAGES["fan_modules"],
                             E2E_STAGES["fan_batch"], torch.float32,
                             device="cpu")
    cs = [box_to_center_scale(b) for b in boxes]
    crops = al32.crops(faces, cs)
    hm32 = al32.heatmaps(torch.from_numpy(crops).to(dev)).cpu()
    hmcpu = al_cpu.heatmaps(torch.from_numpy(crops))
    d_hm = float((hm32 - hmcpu).abs().max())
    p32, pcpu = decode_heatmaps(hm32), decode_heatmaps(hmcpu)
    top2 = hmcpu.flatten(2).topk(2, dim=2).values
    near_tie = (top2[..., 0] - top2[..., 1]) <= 2 * FAN_HM_ATOL
    moved = (p32 != pcpu).any(-1)
    print(f"FAN-{E2E_STAGES['fan_modules']} f32 card vs CPU on {len(boxes)} "
          f"crops: heatmaps {d_hm:.3e} of maps reaching "
          f"{float(hmcpu.abs().max()):.1f} (atol {FAN_HM_ATOL:g}); "
          f"landmarks {int(moved.sum())} of {moved.numel()} apart, "
          f"{int((moved & near_tie).sum())} of them at near-ties", flush=True)
    if d_hm > FAN_HM_ATOL or bool((moved & ~near_tie).any()):
        raise SystemExit("the aligner on the card disagrees with the CPU")
    l16 = pipe.aligner(faces, boxes)
    l32 = al32(faces, boxes)
    d_lm = np.stack([np.abs(a - b).max(-1) for a, b in zip(l16, l32)])
    print(f"FAN bf16 + u8 crops (the path's) vs f32 on the card (record): "
          f"{100 * float((d_lm == 0).mean()):.1f}% of landmarks equal, "
          f"median {float(np.median(d_lm)):.2f} px, max {float(d_lm.max()):.1f} "
          f"px", flush=True)

    # --- FAN -> crop -> deshadow on the card from boxes, f32 stages, vs CPU
    pipe32 = DeshadowPipeline(cfg, fan_weights=fan_w,
                              stage_dtype=torch.float32,
                              service=pipe.service, device=dev, **E2E_STAGES)
    k = min(4, len(boxes))
    nonlocal_attention.launches = 0
    got = pipe32(faces[:k], boxes=[tuple(b) for b in boxes[:k]])
    launches["pipeline from boxes"] = nonlocal_attention.launches
    want = cpu_pipe(faces[:k], boxes=[tuple(b) for b in boxes[:k]])
    box_scores = []
    for g, w in zip(got, want):
        if (g is None) != (w is None):
            raise SystemExit("pipeline from boxes: card and CPU disagree on "
                             "a usable face")
        if g is not None:
            box_scores.append(min(psnr(written(g, key), written(w, key))
                                  for key in ("out", "pred", "mask_pred")))
    print(f"DeshadowPipeline(images, boxes=...) f32 stages, bf16 generator, "
          f"card vs CPU f32 on {k} photos: {len(box_scores)} faces, worst "
          f"PSNR of out/pred/mask " + ", ".join(f"{x:.2f}" for x in box_scores)
          + f" dB (bar 40 dB); K1 launches {launches['pipeline from boxes']}",
          flush=True)
    if not box_scores or min(box_scores) < 40.0:
        raise SystemExit("pipeline from boxes disagrees with the CPU")
    del cpu_pipe, al_cpu, det_cpu

    # --- the BatchingFrontend: FRONTEND_CLIENTS client threads
    svc = ShadowRemovalService(
        get_config(compute_dtype="bfloat16", fold_bn=True,
                   egress_dtype="bfloat16"), sd,
        batch_size=E2E_SERVE_BATCH, device=dev)
    images, lms = synthetic_requests(FRONTEND_REQUESTS)
    want = svc.remove_shadows(images, lms)
    results = [None] * FRONTEND_REQUESTS
    latency = [0.0] * FRONTEND_REQUESTS
    errors = []
    nonlocal_attention.launches = 0
    t0 = time.perf_counter()
    with BatchingFrontend(svc, max_delay_ms=5.0) as fe:
        def client(k: int):
            try:
                sent = [(i, time.perf_counter(), fe.submit(images[i], lms[i]))
                        for i in range(k, FRONTEND_REQUESTS,
                                       FRONTEND_CLIENTS)]
                for i, t_sent, fut in sent:
                    results[i] = fut.result(timeout=300.0)
                    latency[i] = time.perf_counter() - t_sent
            except BaseException as e:
                errors.append(e)

        clients = [threading.Thread(target=client, args=(k,))
                   for k in range(FRONTEND_CLIENTS)]
        for c in clients:
            c.start()
        for c in clients:
            c.join()
    front_s = time.perf_counter() - t0
    launches["BatchingFrontend"] = nonlocal_attention.launches
    if errors:
        raise errors[0]
    fe_scores = [min(psnr(r["pred"], w["pred"]),
                     psnr(r["mask_pred"], w["mask_pred"]))
                 for r, w in zip(results, want)]
    print(f"BatchingFrontend: {fe.requests_served} requests from "
          f"{FRONTEND_CLIENTS} client threads in {fe.batches_dispatched} "
          f"batches (max {E2E_SERVE_BATCH}, 5 ms), {front_s:.2f} s wall, "
          f"{FRONTEND_REQUESTS / front_s:.1f} requests/s; latency after "
          f"result() p50 {1e3 * np.percentile(latency, 50):.0f} ms, p95 "
          f"{1e3 * np.percentile(latency, 95):.0f} ms; vs remove_shadows "
          f"worst PSNR {min(fe_scores):.2f} dB (bar 40); K1 launches "
          f"{launches['BatchingFrontend']} ({smi})", flush=True)
    if fe.requests_served != FRONTEND_REQUESTS or min(fe_scores) < 40.0:
        raise SystemExit("the BatchingFrontend disagrees with remove_shadows")
    if launches["BatchingFrontend"] != (ATTN_CALLS_PER_FORWARD
                                        * fe.batches_dispatched):
        raise SystemExit(f"frontend: {launches['BatchingFrontend']} K1 "
                         "launches")

    # --- where the time goes: the networks on the device, their host work
    batch = torch.from_numpy(canvases).to(dev)
    crops_u8 = torch.from_numpy(np.rint(crops * 255.0).astype(np.uint8)).to(
        dev)
    with torch.inference_mode():
        det_ms = {dt: cuda_ms(lambda d=d: d.candidates(batch), iters=10,
                              warmup=2)
                  for dt, d in (("bf16", pipe.detector), ("f32", det32))}
        fan_ms = {dt: cuda_ms(lambda a=a, x=x: a.heatmaps(x), iters=10,
                              warmup=2)
                  for dt, a, x in (("bf16", pipe.aligner, crops_u8),
                                   ("f32", al32,
                                    torch.from_numpy(crops).to(dev)))}
    det_frames = [frames[i] for i in detected]
    t0 = time.perf_counter()
    pairs = [letterbox(im, E2E_STAGES["det_size"]) for im in det_frames]
    lb_ms = 1e3 * (time.perf_counter() - t0) / len(det_frames)
    cands, spans = pipe.detector.candidates(
        torch.from_numpy(np.stack([c for c, _ in pairs[:4]])).to(dev))
    cands = cands.float().cpu().numpy()
    t0 = time.perf_counter()
    n_cand = 0
    for c in cands:
        dets = pipe.detector._decode_topk(c, spans)
        n_cand += len(dets)
        dets = dets[sfd_nms(dets)]
    dec_ms = 1e3 * (time.perf_counter() - t0) / len(cands)
    t0 = time.perf_counter()
    for im, (c, s_) in zip(faces, cs):
        crop_for_fan(im, c, s_)
    crop_ms = 1e3 * (time.perf_counter() - t0) / len(faces)
    print(f"device, CUDA events: S3FD at ({E2E_STAGES['det_batch']}, "
          f"{E2E_STAGES['det_size']}, {E2E_STAGES['det_size']}) bf16 "
          f"{det_ms['bf16']:.2f} ms, f32 {det_ms['f32']:.2f} ms; "
          f"FAN-{E2E_STAGES['fan_modules']} at {E2E_STAGES['fan_batch']} "
          f"crops bf16 u8 {fan_ms['bf16']:.2f} ms, f32 {fan_ms['f32']:.2f} "
          f"ms. host: letterbox {lb_ms:.1f} ms a photo, top-k decode + NMS "
          f"{dec_ms:.1f} ms a photo ({n_cand / len(cands):.0f} candidates), "
          f"crop_for_fan {crop_ms:.1f} ms a face ({smi})", flush=True)

    # --- K1 at every shape the path gave it
    stop_recording()
    check_gen = torch.Generator(device=dev).manual_seed(14)
    k1_err = 0.0
    for name, shape, dtype in sorted(seen, key=str):
        if name != "nonlocal_attention":
            raise SystemExit(f"the front end launched {name}")
        k1_err = max(k1_err, check_k1(check_gen, shape, dtype))
    print(f"K1 at the front end's shapes: "
          f"{sorted({s for _, s, _ in seen})}", flush=True)

    del pipe, pipe32, svc, det32, al32
    torch.cuda.empty_cache()
    left = [t.name for t in set(threading.enumerate()) - threads_before
            if t.is_alive()]
    if left:
        raise SystemExit(f"threads left running: {left}")
    print(f"phase 14: {time.perf_counter() - t_phase:.1f} s, no thread left "
          f"running", flush=True)
    return {"launches": launches, "k1_err": k1_err}


# the command line (phase 15): every subcommand through cli.main at full
# width (256 px, n_res 6, bf16: the CLI's own config) on small synthetic
# data from the helpers of phases 10, 13 and 14
CLI_TRAIN_BATCH = 4          # samples a step, 8 views
CLI_TRAIN_STEPS = 3
CLI_PHOTOS = 8               # phase 14's photos, 4 with landmarks
CLI_CPU_IMAGES = 2           # the CPU's f32 CLI against the card's bf16
INT8_CHECK_BATCH = 8         # the head's own input, for the accumulators
INT8_BENCH_ITERS = 5


def run_cli(argv: list, label: str, launches: dict, **patch) -> str:
    """`cli.main(argv)` in this process with K1 and K2 counted and its
    standard output captured; fails unless it exits 0.  Returns what it
    printed."""
    nonlocal_attention.launches = 0
    nonlocal_attention_bwd.launches = 0
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    launches[label] = (nonlocal_attention.launches,
                       nonlocal_attention_bwd.launches)
    print(f"cli {label}: exit {rc} in {time.perf_counter() - t0:.1f} s; "
          f"K1, K2 launches {launches[label]}", flush=True)
    if rc != 0:
        raise SystemExit(f"cli {label} exited {rc}:\n{out.getvalue()[-2000:]}")
    return out.getvalue()


@contextlib.contextmanager
def cli_compute_dtype(dtype: str):
    """Inside, the CLI's configs compute in `dtype` (the CLI itself has
    no option for it: its runs are bf16)."""
    real = config_module.get_config

    def patched(preset="in_the_wild", **kw):
        return real(preset, **{**kw, "compute_dtype": dtype})

    config_module.get_config = patched
    try:
        yield
    finally:
        config_module.get_config = real


def same_files(a: str, b: str, label: str) -> int:
    """Fails unless directories a and b hold the same file names with the
    same bytes; returns the count."""
    names = sorted(os.listdir(a))
    if names != sorted(os.listdir(b)) or not names:
        raise SystemExit(f"cli {label}: the CLI wrote {names[:5]}, the "
                         f"library {sorted(os.listdir(b))[:5]}")
    for n in names:
        with open(os.path.join(a, n), "rb") as fa, \
                open(os.path.join(b, n), "rb") as fb:
            if fa.read() != fb.read():
                raise SystemExit(f"cli {label}: {n} differs from the "
                                 f"library's")
    return len(names)


def line_of(out: str, prefix: str) -> str:
    lines = [ln for ln in out.splitlines() if ln.startswith(prefix)]
    if len(lines) != 1:
        raise SystemExit(f"expected one '{prefix}' line, got {lines}")
    return lines[0]


def strip_pred(path: str) -> np.ndarray:
    """The prediction panel (the second of three) of a result strip."""
    strip = read_png(path).astype(np.float32) / 255.0
    s = strip.shape[0]
    return strip[:, s:2 * s]


def serve_strips(cfg, sd, data: str, out_dir: str, dev) -> None:
    """What `infer --engine serving` writes, made by the library: every
    <name>.png/.npy pair of the data glob through one ShadowRemovalService
    on the compact wires, each result saved as a strip."""
    names, images, lms = [], [], []
    for folder in sorted(glob_module.glob(data)):
        for lm_path in sorted(glob_module.glob(folder + "/*.npy")):
            names.append(lm_path)
            images.append(imread(lm_path[:-4] + ".png")[..., ::-1] / 255.0)
            lms.append(np.load(lm_path))
    svc = ShadowRemovalService(
        dataclasses.replace(cfg, compact_output=True, compact_ingress=True),
        sd, batch_size=min(64, len(names)), device=dev)
    log = TrainLogger(out_dir)
    for name, r in zip(names, svc.remove_shadows(images, lms)):
        log.save_result_image(
            [r["img"][None], r["pred"][None], r["mask_pred"][None] * 2.0],
            name)


def cli_path(dev, smi: str, work: str, bench_faces: float) -> dict:
    """Phase 15: every subcommand of `python -m blindshadowremoval_tpu_torch`
    on the card through `cli.main`, at 256 px, n_res 6, bf16: `--help` as
    a subprocess; `train` on a synthetic identity tree, then `infer` (both
    engines; serving folded, with the int8 head, and under
    utils/profiling.trace), `ucb`, `sfw`, `sfw-video`, `preprocess`,
    `landmarks` and `e2e` on its checkpoint and seeded S3FD/FAN npz
    weights; each output held against the same call made through the
    library (files byte for byte, printed figures equal), `infer` bf16
    against the CPU's f32 CLI; the int8 head's int32 accumulators against
    their plain version in each scale mode, its forward against bf16's,
    its throughput at bench.py's configuration; K1 and K2 at every shape
    the CLI gave them.  Returns {"launches": {subcommand: (K1, K2)},
    "k1_err", "k2_err"}."""
    torch.backends.cudnn.allow_tf32 = True     # PyTorch's defaults
    torch.backends.cuda.matmul.allow_tf32 = False
    t_phase = time.perf_counter()
    launches = {}

    out = subprocess.run(
        [sys.executable, "-m", "blindshadowremoval_tpu_torch", "--help"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    subs = ("infer", "ucb", "sfw", "sfw-video", "train", "preprocess",
            "e2e", "landmarks")
    print(f"python -m blindshadowremoval_tpu_torch --help: exit "
          f"{out.returncode}, lists {[s for s in subs if s in out.stdout]}",
          flush=True)
    if out.returncode != 0 or not all(s in out.stdout for s in subs):
        raise SystemExit(f"--help failed: {out.stderr[-2000:]}")

    seen, stop_recording = record_attention_shapes()
    # --- train: CLI_TRAIN_STEPS steps on the CLI's default wires (u8
    # compact ingress, device darkening) with the maps on the device
    train_glob, _, masks = synthetic_train_tree(os.path.join(work, "data"))
    ckpt = os.path.join(work, "ckpt")
    run_cli(["train", "--data", train_glob, "--shadow-masks", masks,
             "--device-geometry", "--batch-size", str(CLI_TRAIN_BATCH),
             "--steps-per-epoch", str(CLI_TRAIN_STEPS), "--max-epoch", "1",
             "--ckpt", ckpt], "train", launches)
    k = ATTN_CALLS_PER_FORWARD
    if launches["train"] != (k * CLI_TRAIN_STEPS, k * CLI_TRAIN_STEPS):
        raise SystemExit(f"cli train: K1, K2 launches {launches['train']}")
    sd, step = CheckpointManager(ckpt).restore_eval()
    if step != 1 or not all(bool(torch.isfinite(v).all())
                            for v in sd.values()):
        raise SystemExit(f"cli train: checkpoint step {step}, or a tensor "
                         f"is not finite")

    def ckpt_copy(name: str) -> str:
        d = os.path.join(work, name)
        os.makedirs(d)
        os.symlink(os.path.join(ckpt, "1.pt"), os.path.join(d, "1.pt"))
        return d

    def lib_dir(name: str) -> str:
        return os.path.join(work, "lib", name)

    ucb = synthetic_ucb_tree(os.path.join(work, "ucb"))
    data = os.path.join(ucb, "input", "*")

    # --- infer, the evaluator engine (10 views a sample); the maps on the
    # device here and in ucb (the host rasterizer takes ~1 s a view)
    d = ckpt_copy("infer")
    printed = run_cli(["infer", "--data", data, "--ckpt", d,
                       "--device-geometry"], "infer", launches)
    cfg = get_config(data_dirs_test=(data,), device_geometry=True,
                     checkpoint_dir=lib_dir("infer"))
    nonlocal_attention.launches = 0
    InTheWildEvaluator(cfg, sd, device=dev).run(Dataset(cfg, "test", seed=0))
    n = same_files(os.path.join(d, "test"),
                   os.path.join(lib_dir("infer"), "test"), "infer")
    print(f"cli infer: {line_of(printed, 'Restore from')}; {n} strips, "
          f"byte for byte the library's", flush=True)
    if launches["infer"][0] != k * UCB_IMAGES:
        raise SystemExit(f"cli infer: {launches['infer'][0]} K1 launches")

    # --- infer, the serving engine folded, then with the int8 head, then
    # traced by utils/profiling.trace
    serve_cfg = get_config(data_dirs_test=(data,), fold_bn=True)
    for label, extra, cfg in (
            ("infer serving", [], serve_cfg),
            ("infer serving int8", ["--int8-head"],
             dataclasses.replace(serve_cfg, int8_head=True))):
        d = ckpt_copy(label.replace(" ", "_"))
        printed = run_cli(["infer", "--data", data, "--ckpt", d, "--engine",
                           "serving", "--fold-bn"] + extra, label, launches)
        serve_strips(cfg, sd, data, lib_dir(label), dev)
        n = same_files(os.path.join(d, "test"),
                       os.path.join(lib_dir(label), "test"), label)
        print(f"cli {label}: '{line_of(printed, 'wrote')}'; {n} strips, "
              f"byte for byte the library's", flush=True)
        if launches[label][0] != k:
            raise SystemExit(f"cli {label}: {launches[label][0]} K1 "
                             f"launches")
    bf16_dir, int8_dir = (os.path.join(work, n, "test") for n in (
        "infer_serving", "infer_serving_int8"))
    scores = [psnr(strip_pred(os.path.join(int8_dir, f)),
                   strip_pred(os.path.join(bf16_dir, f)))
              for f in sorted(os.listdir(bf16_dir))]
    print(f"cli infer serving, int8 head against the bf16 head: pred PSNR "
          f"min {min(scores):.2f}, mean {np.mean(scores):.2f} dB over "
          f"{len(scores)} strips (recorded)", flush=True)
    d = ckpt_copy("traced")
    logdir = os.path.join(work, "trace")
    with profiling.trace(logdir) as prof:
        run_cli(["infer", "--data", data, "--ckpt", d, "--engine", "serving",
                 "--fold-bn"], "infer serving traced", launches)
    traces = glob_module.glob(os.path.join(logdir, "*.pt.trace.json"))
    k1_events = 0
    for t in traces:
        with open(t) as fh:
            k1_events += sum(ev.get("name", "").find("attn_fwd") >= 0
                             and ev.get("cat") == "kernel"
                             for ev in json.load(fh).get("traceEvents", []))
    k1_profiled = [(e.key, e.count) for e in prof.key_averages()
                   if "attn_fwd" in e.key and e.device_time_total > 0]
    print(f"utils/profiling.trace: {len(traces)} trace file(s), {k1_events} "
          f"K1 kernel events in the trace ({k1_profiled})", flush=True)
    if not traces or k1_events == 0:
        raise SystemExit("the trace of infer --engine serving names no K1 "
                         "kernel")

    # --- infer bf16 on the card against the CPU's f32 CLI
    two = synthetic_ucb_tree(os.path.join(work, "ucb2"),
                             n_images=CLI_CPU_IMAGES, per_id=CLI_CPU_IMAGES)
    data2 = os.path.join(two, "input", "*")
    d_card, d_cpu = ckpt_copy("card2"), ckpt_copy("cpu2")
    run_cli(["infer", "--data", data2, "--ckpt", d_card, "--engine",
             "serving"], "infer serving 2 images", launches)
    with cli_compute_dtype("float32"):
        run_cli(["infer", "--data", data2, "--ckpt", d_cpu, "--engine",
                 "serving", "--device", "cpu"], "infer serving 2 images, "
                "the CPU in f32", launches)
    scores = [psnr(strip_pred(os.path.join(d_card, "test", f)),
                   strip_pred(os.path.join(d_cpu, "test", f)))
              for f in sorted(os.listdir(os.path.join(d_cpu, "test")))]
    print(f"cli infer: card bf16 against the CPU's f32 CLI, pred PSNR "
          + ", ".join(f"{x:.2f}" for x in scores) + " dB (bar 40 dB)",
          flush=True)
    if len(scores) != CLI_CPU_IMAGES or not min(scores) >= 40.0:
        raise SystemExit("cli infer on the card disagrees with the CPU's")

    # --- ucb (fused, 8 images a call, compact ingress)
    d = ckpt_copy("ucb_cli")
    printed = run_cli(["ucb", "--data", data, "--part-masks", ucb, "--ckpt",
                       d, "--device-geometry"], "ucb", launches)
    cfg = get_config("ucb", data_dirs_test=(data,), compact_ingress=True,
                     device_geometry=True, checkpoint_dir=lib_dir("ucb"))
    with contextlib.redirect_stdout(io.StringIO()):
        res = UCBEvaluator(cfg, sd, device=dev).run(
            Dataset(cfg, "test", seed=0), ucb, images_per_call=UCB_PER_CALL)
    want = (f"UCB mean PSNR {np.mean([r['psnr'] for r in res]):.3f}  mean "
            f"SSIM {np.mean([r['ssim'] for r in res]):.4f}")
    got = line_of(printed, "UCB mean")
    n = same_files(os.path.join(d, "test"),
                   os.path.join(lib_dir("ucb"), "test"), "ucb")
    print(f"cli ucb: '{got}', the library '{want}'; {n} strips byte for "
          f"byte", flush=True)
    if got != want:
        raise SystemExit("cli ucb's figures differ from the library's")

    # --- sfw and sfw-video on the TF-golden samples, the GSC variant
    sfw_data = str(TF_REF / "sfw_gsc_synth" / "*")
    d = ckpt_copy("sfw_cli")
    printed = run_cli(["sfw", "--data", sfw_data, "--variant", "gsc",
                       "--device-geometry", "--ckpt", d], "sfw", launches)
    cfg = get_config("sfw", variant="gsc", device_geometry=True,
                     data_dirs_test=(sfw_data,), checkpoint_dir=lib_dir("sfw"))
    res = SFWEvaluator(cfg, sd, device=dev).run(
        Dataset(cfg, "test", dset="sfw", seed=0))
    want = f"SFW mean AUC {np.mean([r['auc'] for r in res]):.4f}"
    got = line_of(printed, "SFW mean AUC")
    print(f"cli sfw: '{got}', the library '{want}'", flush=True)
    if got != want:
        raise SystemExit("cli sfw's figure differs from the library's")
    vid = str(TF_REF / "sfw_video_synth" / "*")
    d = ckpt_copy("video_cli")
    run_cli(["sfw-video", "--data", vid, "--variant", "gsc",
             "--device-geometry", "--ckpt", d, "--export-bbox",
             os.path.join(work, "bbox_cli")], "sfw-video", launches)
    cfg = get_config("sfw_video", variant="gsc", device_geometry=True,
                     data_dirs_test=(vid,), checkpoint_dir=lib_dir("video"))
    SFWVideoEvaluator(cfg, sd, device=dev).run(
        Dataset(cfg, "test", dset="sfw", seed=0),
        os.path.join(work, "bbox_lib"))
    n = same_files(os.path.join(d, "test"),
                   os.path.join(lib_dir("video"), "test"), "sfw-video")
    import scipy.io

    mats = sorted(os.listdir(os.path.join(work, "bbox_lib")))
    boxes_equal = mats == sorted(os.listdir(os.path.join(
        work, "bbox_cli"))) and all(np.array_equal(
            scipy.io.loadmat(os.path.join(work, "bbox_cli", m))["bbox"],
            scipy.io.loadmat(os.path.join(work, "bbox_lib", m))["bbox"])
            for m in mats)
    print(f"cli sfw-video: {n} strips byte for byte, {len(mats)} .mat boxes "
          f"{'equal' if boxes_equal else 'DIFFERENT'}", flush=True)
    if not boxes_equal:
        raise SystemExit("cli sfw-video's boxes differ from the library's")

    # --- preprocess, landmarks and e2e on phase 14's photos, seeded S3FD
    # and FAN-4 weights saved as the npz the loaders read
    photos = os.path.join(work, "photos")
    paths = uncropped_photos(photos, n=CLI_PHOTOS)
    pre = os.path.join(work, "pre")
    printed = run_cli(["preprocess", "--input", photos, "--output", pre],
                      "preprocess", launches)
    n_crops = 0
    for p in paths:
        if not os.path.isfile(p[:-4] + ".npy"):
            continue
        res = offline_crop(imread(p)[..., ::-1], np.load(p[:-4] + ".npy"),
                           out_size=256)
        name = os.path.basename(p)[:-4]
        got_png = os.path.join(pre, name, name + ".png")
        if res is None:
            if os.path.exists(got_png):
                raise SystemExit(f"cli preprocess wrote a crop of {name}")
            continue
        if not (np.array_equal(read_png(got_png), res[0].astype(np.uint8))
                and np.array_equal(np.load(got_png[:-4] + ".npy"), res[1])):
            raise SystemExit(f"cli preprocess: {name} differs from "
                             f"offline_crop's")
        n_crops += 1
    print(f"cli preprocess: '{line_of(printed, 'preprocessed')}', {n_crops} "
          f"crops and landmarks equal to offline_crop's", flush=True)
    if n_crops == 0:
        raise SystemExit("cli preprocess wrote no crop")

    fan_npz = os.path.join(work, "fan.npz")
    sfd_npz = os.path.join(work, "sfd.npz")
    np.savez(fan_npz, **synthetic_fan_weights(0, E2E_STAGES["fan_modules"]))
    np.savez(sfd_npz, **synthetic_sfd_weights(0))
    lm_in = os.path.join(work, "lm_in")
    os.makedirs(lm_in)
    unmarked = [p for p in paths if not os.path.isfile(p[:-4] + ".npy")][:2]
    for p in unmarked:
        os.symlink(p, os.path.join(lm_in, os.path.basename(p)))
    run_cli(["landmarks", "--input", lm_in, "--fan-weights", fan_npz,
             "--sfd-weights", sfd_npz], "landmarks", launches)
    net = build_fan(load_fan_npz(fan_npz), E2E_STAGES["fan_modules"],
                    device=dev)
    s3fd = build_s3fd(load_sfd_npz(sfd_npz), device=dev)
    n_lm = 0
    for p in unmarked:
        img = np.ascontiguousarray(imread(p)[..., ::-1])
        dets = detect_faces(s3fd, img)
        out_npy = os.path.join(lm_in, os.path.basename(p)[:-4] + ".npy")
        if not len(dets):
            if os.path.exists(out_npy):
                raise SystemExit("cli landmarks wrote a face the library "
                                 "did not find")
            continue
        want = landmarks_from_image(net, img, box=tuple(dets[0, :4]))
        if not np.array_equal(np.load(out_npy), want):
            raise SystemExit(f"cli landmarks: {out_npy} differs from the "
                             f"library's")
        n_lm += 1
    print(f"cli landmarks: {n_lm} of {len(unmarked)} photos' landmarks "
          f"equal to detect_faces + landmarks_from_image's", flush=True)
    if n_lm == 0:
        raise SystemExit("cli landmarks found no face")
    del net, s3fd

    d = ckpt_copy("e2e_ckpt")
    printed = run_cli(["e2e", "--input", photos, "--output",
                       os.path.join(work, "e2e_cli"), "--ckpt", d,
                       "--fan-weights", fan_npz, "--sfd-weights", sfd_npz],
                      "e2e", launches)
    pipe = DeshadowPipeline(
        get_config(checkpoint_dir=d, device_geometry=True,
                   compact_output=True, compact_ingress=True), sd,
        fan_weights=load_fan_npz(fan_npz), sfd_weights=load_sfd_npz(sfd_npz),
        device=dev, batch_size=E2E_SERVE_BATCH, **E2E_STAGES)
    with contextlib.redirect_stdout(io.StringIO()):
        stats = pipe.run_dir(photos, os.path.join(work, "e2e_lib"),
                             batch_files=E2E_BATCH_FILES, overlap=True)
    n = same_files(os.path.join(work, "e2e_cli"),
                   os.path.join(work, "e2e_lib"), "e2e")
    got = line_of(printed, "e2e:")
    counts = {k: stats[k] for k in ("images", "faces", "written")}
    print(f"cli e2e: '{got}'; the library's counts {counts}; {n} files "
          f"byte for byte", flush=True)
    if not all(f"'{k}': {v}" in got for k, v in counts.items()):
        raise SystemExit("cli e2e's counts differ from the library's")
    del pipe
    stop_recording()

    # --- the int8 head on the card: the accumulators in each scale mode
    # on the head's own input, its forward against bf16's, its throughput
    # at bench.py's configuration
    cfg16 = get_config(fold_bn=True, egress_dtype="bfloat16")
    cfg8 = calibrate_config(dataclasses.replace(cfg16, int8_head=True), sd)
    m16, m8 = (build_generator(c, sd, dev) for c in (cfg16, cfg8))
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.uniform(0.0, 0.9, (BENCH_BATCH, 256, 256, 3))
                         .astype(np.float32)).to(dev)
    u = torch.from_numpy(rng.uniform(size=(BENCH_BATCH, 256, 256, 3))
                         .astype(np.float32)).to(dev)
    seen_head = []
    hook = m8.head.register_forward_pre_hook(
        lambda mod, inp: seen_head.append(inp[0]))
    with torch.inference_mode():
        out8 = m8(x[:INT8_CHECK_BATCH], u[:INT8_CHECK_BATCH])
        out16 = m16(x[:INT8_CHECK_BATCH], u[:INT8_CHECK_BATCH])
    hook.remove()
    head_in = seen_head[0]
    bounds = cfg8.int8_head_scale
    w = m8.head.conv.weight
    for label, scale in (("per channel (auto)", bounds),
                         ("scalar", max(bounds)), ("dynamic", -1.0)):
        with torch.inference_mode():
            xq, wq, _ = quant.quantize_activations(head_in, w, scale)
            acc = quant.int8_accumulate(xq, wq)
            ref = quant.int8_accumulate_reference(xq, wq)
        torch.cuda.synchronize()
        differ = int((acc != ref).sum())
        print(f"int8 head, {label} scale: int32 accumulators of "
              f"{tuple(acc.shape)} from _int_mm against the plain f64 "
              f"convolution of the codes: {differ} differ (|acc| up to "
              f"{int(ref.abs().max())})", flush=True)
        if differ or acc.dtype != torch.int32:
            raise SystemExit(f"int8 accumulators differ ({label})")
    head_psnr = psnr(out8[1].float().clamp(0, 1).cpu().numpy(),
                     out16[1].float().clamp(0, 1).cpu().numpy())
    print(f"int8 head (auto bounds) against the bf16 head, con_rgb of "
          f"{INT8_CHECK_BATCH} views: PSNR {head_psnr:.2f} dB (recorded)",
          flush=True)
    del out8, out16, seen_head, head_in
    with torch.inference_mode():
        turns = alternate_ms({"bf16 head": lambda: m16(x, u),
                              "int8 head": lambda: m8(x, u)},
                             reps=2, iters=INT8_BENCH_ITERS)
        # the head alone at the bench batch, on its own input
        seen_head = []
        hook = m8.head.register_forward_pre_hook(
            lambda mod, inp: seen_head.append(inp[0]))
        m8(x, u)
        hook.remove()
        h = seen_head[0]
        head_turns = alternate_ms({
            "bf16 conv": lambda: blocks_module.conv2d_same(h, m16.head.conv),
            "int8 conv": lambda: m8.head(h)}, reps=2, iters=INT8_BENCH_ITERS)
    ms16, ms8 = (float(np.median(v)) for v in turns.values())
    hc16, hc8 = (float(np.median(v)) for v in head_turns.values())
    print(f"B={BENCH_BATCH} 256x256 bf16 folded: bf16 head {ms16:.2f} "
          f"ms/forward ({BENCH_BATCH * 1e3 / ms16:.1f} faces/s), int8 head "
          f"{ms8:.2f} ms/forward ({BENCH_BATCH * 1e3 / ms8:.1f} faces/s), "
          f"medians of 2 turns of {INT8_BENCH_ITERS}; phase 6: "
          f"{bench_faces:.1f} faces/s; the head conv alone: bf16 "
          f"{hc16:.3f} ms, int8 {hc8:.3f} ms ({smi})", flush=True)
    del m16, m8, x, u, h, seen_head
    torch.cuda.empty_cache()

    # --- K1 and K2 at every shape the CLI gave them
    check_gen = torch.Generator(device=dev).manual_seed(15)
    k1_err = k2_err = 0.0
    for name, shape, dtype in sorted(seen, key=str):
        if name == "nonlocal_attention":
            k1_err = max(k1_err, check_k1(check_gen, shape, dtype))
        else:
            k2_err = max(k2_err, check_k2_case(check_gen, shape, dtype))
    print(f"phase 15: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"launches": launches, "k1_err": k1_err, "k2_err": k2_err}


# the parallel path (phase 16): the train step sharded over ranks.  The
# card's machine has one GPU and NCCL refuses two ranks on one device, so
# one NCCL rank drives the full-width sharded step through torch.distributed
# in this process, and two gloo ranks (gloo all-reduces CUDA tensors; every
# all-reduce of the step is f32) share the card in processes of their own
PARALLEL_RANKS = 2
PARALLEL_STEPS = 3
PARALLEL_VIEWS = 2 * TRAIN_BATCH             # 64 views, 32 a gloo rank
PARALLEL_ATTN_SHAPE = (TRAIN_BATCH, 1024, 128)
PARALLEL_TIMEOUT_S = 600
# tests/test_sharding.py:203-220's bars: the JAX step sharded against one
# device
PARALLEL_LOSS_TOL = dict(rtol=2e-4, atol=2e-4)
PARALLEL_STATE_TOL = dict(rtol=5e-4, atol=2e-4)
VIDEO_FRAMES = 10                            # one group, 5 frames a rank
SHARE_ATOL = 1e-5                            # tests/test_sharding.py:86
MESH_SERVICE_REQUESTS = 13                   # a full batch of 8, a tail of 5
MESH_SERVICE_BATCH = 8
MESH_SERVICE_ATOL = 2e-5                     # tests/test_sharding.py:120


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def flat_state(state) -> torch.Tensor:
    """Every parameter and BatchNorm statistic of G and D, in one f32
    vector."""
    return torch.cat([v.detach().reshape(-1).float()
                      for m in (state.gen, state.disc)
                      for v in m.state_dict().values()])


def same_on_every_rank(x: torch.Tensor) -> bool:
    """Whether `x` is bitwise rank 0's on every rank (a broadcast, then
    one verdict for all)."""
    ref = x.clone()
    dist.broadcast(ref, src=0)
    same = torch.tensor([float(torch.equal(ref, x))], device=x.device)
    dist.all_reduce(same, op=dist.ReduceOp.MIN)
    return bool(same.item())


@contextlib.contextmanager
def timed_all_reduces():
    """Counts every torch.distributed.all_reduce inside (the step's, their
    backward's included), with the bytes, each synchronized before and
    after on the host clock.  Yields {calls, bytes, ms}."""
    rec = {"calls": 0, "bytes": 0, "ms": 0.0}
    original = dist.all_reduce

    def all_reduce(tensor, *args, **kw):
        rec["calls"] += 1
        rec["bytes"] += tensor.numel() * tensor.element_size()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            return original(tensor, *args, **kw)
        finally:
            torch.cuda.synchronize()
            rec["ms"] += 1e3 * (time.perf_counter() - t0)

    dist.all_reduce = all_reduce
    try:
        yield rec
    finally:
        dist.all_reduce = original


def sharded_full_width(dev, rank: int, ranks: int) -> dict:
    """PARALLEL_STEPS GSC train steps at 256 px, n_res=6, bf16, random VGG,
    PARALLEL_VIEWS views split over `ranks` (this rank's rows of the same
    seeded batch), inside `with mesh:`; after each step, the losses and
    every parameter and statistic bitwise rank 0's.  Then one step with
    every all-reduce timed.  Returns the record."""
    torch.backends.cudnn.allow_tf32 = True     # PyTorch's defaults
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("train", batch_size=PARALLEL_VIEWS // 2,
                     compute_dtype="bfloat16", vgg_dtype="bfloat16")
    trainer = Trainer(cfg, device=dev)
    state = trainer.init_state(seed=0)
    views = PARALLEL_VIEWS // ranks
    batch = {k: v[rank * views:(rank + 1) * views].contiguous() for k, v in
             synthetic_train_batch(PARALLEL_VIEWS, cfg.img_size,
                                   dev).items()}
    gen = torch.Generator(device=dev).manual_seed(0)
    mesh = distributed.global_mesh((ranks, 1), device=dev)
    rec = {"step_ms": [], "equal": [], "losses": None}
    torch.cuda.reset_peak_memory_stats()
    nonlocal_attention.launches = 0
    nonlocal_attention_bwd.launches = 0
    with mesh:
        for _ in range(PARALLEL_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, losses, _ = trainer.train_step(state, batch, gen)
            torch.cuda.synchronize()
            rec["step_ms"].append(1e3 * (time.perf_counter() - t0))
            vals = torch.stack([losses[k] for k in LOSS_NAMES])
            rec["equal"].append(same_on_every_rank(vals)
                                and same_on_every_rank(flat_state(state)))
            rec["losses"] = vals.tolist()
        rec["launches"] = (nonlocal_attention.launches,
                           nonlocal_attention_bwd.launches)
        rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        with timed_all_reduces() as ar:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.train_step(state, batch, gen)
            torch.cuda.synchronize()
            rec["timed_step_ms"] = 1e3 * (time.perf_counter() - t0)
        rec["all_reduce"] = ar
    return rec


def rank_f32_step(dev, rank: int) -> dict:
    """Phase 9's f32 step (64 px, n_res=2, 8 views, TF32 off) with its own
    randomness, sharded over the ranks; rank 0 also runs it in one process
    on the whole batch from the same state and generator seed and holds
    the two to PARALLEL_LOSS_TOL and PARALLEL_STATE_TOL."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("train", **CHECK_CFG)
    views = 2 * cfg.batch_size
    batch = synthetic_train_batch(views, cfg.img_size, dev, seed=1)
    per = views // PARALLEL_RANKS
    mesh = distributed.global_mesh((PARALLEL_RANKS, 1), device=dev)

    def step(b, sharded: bool):
        trainer = Trainer(cfg, device=dev)
        state = trainer.init_state(seed=0)
        gen = torch.Generator(device=dev).manual_seed(3)
        with mesh if sharded else contextlib.nullcontext():
            state, losses, _ = trainer.train_step(state, b, gen)
        return state, {k: float(v) for k, v in losses.items()}

    nonlocal_attention.launches = 0
    nonlocal_attention_bwd.launches = 0
    state, losses = step({k: v[rank * per:(rank + 1) * per]
                          for k, v in batch.items()}, True)
    rec = {"launches": (nonlocal_attention.launches,
                        nonlocal_attention_bwd.launches),
           "equal": same_on_every_rank(flat_state(state))
           and same_on_every_rank(torch.tensor(
               [losses[k] for k in LOSS_NAMES], device=dev))}
    if rank == 0:
        one_state, one_losses = step(batch, False)
        rec["loss_rel"] = max(abs(losses[k] - one_losses[k])
                              / max(abs(one_losses[k]), 1e-6)
                              for k in LOSS_NAMES)
        rec["loss_ok"] = all(np.isclose(losses[k], one_losses[k],
                                        **PARALLEL_LOSS_TOL)
                             for k in LOSS_NAMES)
        worst, bad = 0.0, []
        for net in ("gen", "disc"):
            want = getattr(one_state, net).state_dict()
            for name, v in getattr(state, net).state_dict().items():
                a, b = v.float(), want[name].float()
                worst = max(worst, float((a - b).abs().max()))
                if not torch.allclose(a, b, **PARALLEL_STATE_TOL):
                    bad.append(f"{net}.{name}")
        rec.update(state_max_abs=worst, state_bad=bad)
    return rec


def rank_tsm_video(dev, rank: int) -> dict:
    """The TSM forward of one VIDEO_FRAMES-frame group at 256 px, f32 (TF32
    off), the TF-golden weights: this rank's frames through
    TSMGenerator(axis_name="frame") inside a (1, ranks) mesh, against the
    local-mode forward of the whole group on the card."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    sd = golden_weights("tsm")
    rng = np.random.default_rng(4)
    img = torch.from_numpy(rng.uniform(
        0.05, 0.95, (VIDEO_FRAMES, 256, 256, 3)).astype(np.float32)).to(dev)
    uv = torch.from_numpy(np.broadcast_to(
        generate_uv_map(LM_REF, 256), (VIDEO_FRAMES, 256, 256, 3)).astype(
        np.float32)).to(dev)
    reg = torch.from_numpy(rng.uniform(
        -0.02, 0.02, (VIDEO_FRAMES, 256, 256, 6)).astype(np.float32)).to(dev)
    per = VIDEO_FRAMES // PARALLEL_RANKS
    mine = slice(rank * per, (rank + 1) * per)
    coll = TSMGenerator(n_res=6, axis_name="frame")
    coll.load_state_dict(sd)
    coll = coll.eval().to(dev)
    local = build_generator(get_config(variant="tsm",
                                       compute_dtype="float32"), sd, dev)
    mesh = distributed.global_mesh((1, PARALLEL_RANKS), device=dev)
    with torch.no_grad():
        nonlocal_attention.launches = 0
        with mesh:
            outs = coll(img[mine], uv[mine], reg[mine], frame=per)
        launches = nonlocal_attention.launches
        refs = local(img, uv, reg, frame=VIDEO_FRAMES)
    err = max(float((o - r[mine]).abs().max()) for o, r in zip(outs, refs))
    return {"max_abs_err": err, "launches": launches,
            "finite": all(bool(torch.isfinite(o).all()) for o in outs)}


def parallel_rank(addr: str, rank: str, work: str) -> int:
    """One gloo rank of phase 16 (`python3 chip_smoke.py --parallel-rank
    ADDR RANK WORK`): the full-width sharded step, the f32 step against the
    one-process step and the TSM video forward with the collective
    ShareLayer, every (wrapper, shape, dtype) of K1 and K2 that they launch
    recorded; the record goes to WORK/rank<RANK>.json."""
    rank = int(rank)
    dev = torch.device("cuda", 0)
    missing = [n for n in _build.SOURCES
               if not _build.library_path(n).is_file()]
    if missing:
        print(f"rank {rank}: kernels not built before the ranks: {missing}",
              file=sys.stderr)
        return 1
    distributed.initialize(addr, PARALLEL_RANKS, rank, backend="gloo",
                           device=dev)
    rec = {}
    seen, stop_recording = record_attention_shapes()
    try:
        rec["train"] = sharded_full_width(dev, rank, PARALLEL_RANKS)
        torch.cuda.empty_cache()
        rec["f32"] = rank_f32_step(dev, rank)
        rec["video"] = rank_tsm_video(dev, rank)
        dist.barrier()
    finally:
        stop_recording()
        rec["shapes"] = [[name, list(shape), str(dtype)]
                         for name, shape, dtype in sorted(seen, key=str)]
        with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
            json.dump(rec, f)
        dist.destroy_process_group()
    return 0


def parallel_path(dev, smi: str, work: str) -> dict:
    """Phase 16: the service over a mesh of two entries on the card, one
    NCCL rank driving the full-width sharded step, then PARALLEL_RANKS gloo
    ranks in processes of their own (`parallel_rank`), every one joined
    before this returns; then K1 and K2 at every shape that these runs
    gave them against their plain versions, and timed at the per-rank
    shape."""
    t_phase = time.perf_counter()
    launches = {}
    seen, stop_recording = record_attention_shapes()

    # --- the service over a mesh of two entries on the card, f32, TF32 off
    with no_tf32():
        sd = golden_weights()
        cfg = get_config(compute_dtype="float32")
        images, lms = synthetic_requests(MESH_SERVICE_REQUESTS, seed=3)
        one = ShadowRemovalService(cfg, sd, batch_size=MESH_SERVICE_BATCH,
                                   device=dev)
        two = ShadowRemovalService(
            cfg, sd, batch_size=MESH_SERVICE_BATCH,
            mesh=make_mesh((2,), ("data",), devices=[dev, dev]))
        ref = one.remove_shadows(images, lms)
        nonlocal_attention.launches = 0
        out = two.remove_shadows(images, lms)
        launches["mesh service"] = nonlocal_attention.launches
    err = max(float(np.abs(o[k] - r[k]).max()) for o, r in zip(out, ref)
              for k in ("pred", "mask_pred"))
    print(f"service over a (2,) mesh on one card, {MESH_SERVICE_REQUESTS} "
          f"requests at batch {MESH_SERVICE_BATCH}, f32: max |diff| against "
          f"the one-device service {err:.3e} (limit {MESH_SERVICE_ATOL:g}); "
          f"K1 launches {launches['mesh service']}", flush=True)
    want = ATTN_CALLS_PER_FORWARD * 2 * -(-MESH_SERVICE_REQUESTS
                                          // MESH_SERVICE_BATCH)
    if len(out) != MESH_SERVICE_REQUESTS or not err <= MESH_SERVICE_ATOL:
        raise SystemExit("the service over a mesh disagrees")
    if launches["mesh service"] != want:
        raise SystemExit(f"the mesh service launched K1 "
                         f"{launches['mesh service']} times, expected {want}")
    del one, two, out, ref
    torch.cuda.empty_cache()

    # --- one NCCL rank: the full-width sharded step through NCCL
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        nccl = sharded_full_width(torch.device("cuda", 0), 0, 1)
    finally:
        dist.destroy_process_group()
        stop_recording()
    torch.cuda.empty_cache()
    launches["nccl train"] = nccl["launches"]
    ar = nccl["all_reduce"]
    print(f"one NCCL rank, {PARALLEL_VIEWS} views of 256 px a step, bf16: "
          f"steps {', '.join(f'{t:.1f}' for t in nccl['step_ms'])} ms, peak "
          f"{nccl['peak_gib']:.2f} GiB; {ar['calls']} all-reduces a step "
          f"through NCCL, {ar['bytes'] / 2**20:.1f} MiB; with each "
          f"synchronized: {nccl['timed_step_ms']:.1f} ms, of which "
          f"all-reduces {ar['ms']:.1f} ms; K1, K2 launches "
          f"{nccl['launches']} ({smi})", flush=True)
    want = (ATTN_CALLS_PER_FORWARD * PARALLEL_STEPS,) * 2
    if (tuple(nccl["launches"]) != want or not all(nccl["equal"])
            or not np.isfinite(nccl["losses"]).all() or ar["calls"] < 1):
        raise SystemExit("the NCCL rank's sharded step failed")

    # --- PARALLEL_RANKS gloo ranks on the card, each a process
    addr = f"127.0.0.1:{free_port()}"
    logs = [open(os.path.join(work, f"rank{r}.log"), "w")
            for r in range(PARALLEL_RANKS)]
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--parallel-rank",
         addr, str(r), work], cwd=ROOT, stdout=logs[r],
        stderr=subprocess.STDOUT) for r in range(PARALLEL_RANKS)]
    t0 = time.perf_counter()
    try:
        for p in procs:
            p.wait(timeout=max(1.0, PARALLEL_TIMEOUT_S
                               - (time.perf_counter() - t0)))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    ranks_s = time.perf_counter() - t0
    recs = []
    for r, p in enumerate(procs):
        with open(os.path.join(work, f"rank{r}.log")) as f:
            log = f.read()
        path = os.path.join(work, f"rank{r}.json")
        if p.returncode != 0 or not os.path.exists(path):
            print(log[-4000:], flush=True)
            raise SystemExit(f"gloo rank {r} failed (exit {p.returncode})")
        with open(path) as f:
            recs.append(json.load(f))
    print(f"{PARALLEL_RANKS} gloo ranks joined after {ranks_s:.1f} s, every "
          f"process exited", flush=True)
    ok = True
    for r, rec in enumerate(recs):
        tr, f32, video = rec["train"], rec["f32"], rec["video"]
        ar = tr["all_reduce"]
        launches[f"gloo train rank {r}"] = tr["launches"]
        launches[f"gloo f32 step rank {r}"] = f32["launches"]
        launches[f"video rank {r}"] = video["launches"]
        print(f"rank {r}: {PARALLEL_VIEWS // PARALLEL_RANKS} views a step, "
              f"steps {', '.join(f'{t:.1f}' for t in tr['step_ms'])} ms, "
              f"peak {tr['peak_gib']:.2f} GiB, bitwise equal across ranks "
              f"after each step {tr['equal']}; with every all-reduce "
              f"synchronized {tr['timed_step_ms']:.1f} ms, all-reduces "
              f"{ar['ms']:.1f} ms ({100 * ar['ms'] / tr['timed_step_ms']:.1f}"
              f"%, {ar['calls']} calls, {ar['bytes'] / 2**20:.1f} MiB); "
              f"K1, K2 launches {tr['launches']} ({smi}; two ranks share "
              f"one card: a record, no scaling figure)", flush=True)
        print(f"rank {r}: f32 step (phase 9's size) bitwise equal across "
              f"ranks {f32['equal']}"
              + (f"; against the one-process step: worst relative loss "
                 f"difference {f32['loss_rel']:.3e} (bars rtol/atol 2e-4: "
                 f"{'ok' if f32['loss_ok'] else 'FAIL'}), worst |state "
                 f"diff| {f32['state_max_abs']:.3e} (rtol 5e-4, atol 2e-4; "
                 f"{len(f32['state_bad'])} tensors outside: "
                 f"{f32['state_bad'][:5]})" if r == 0 else "")
              + f"; K1, K2 launches {f32['launches']}", flush=True)
        print(f"rank {r}: TSM video, {VIDEO_FRAMES // PARALLEL_RANKS} of "
              f"{VIDEO_FRAMES} frames, collective ShareLayer vs local mode: "
              f"max abs err {video['max_abs_err']:.3e} (limit "
              f"{SHARE_ATOL:g}); K1 launches {video['launches']}", flush=True)
        ok = ok and all(tr["equal"]) and f32["equal"] and video["finite"] \
            and video["max_abs_err"] <= SHARE_ATOL \
            and np.isfinite(tr["losses"]).all() \
            and tuple(tr["launches"]) == want \
            and tuple(f32["launches"]) == (CHECK_CFG["n_res"],) * 2 \
            and video["launches"] == ATTN_CALLS_PER_FORWARD
        if r == 0:
            ok = ok and f32["loss_ok"] and not f32["state_bad"]
    if not ok:
        raise SystemExit("phase 16: a sharded check failed")
    if recs[0]["train"]["losses"] != recs[1]["train"]["losses"]:
        raise SystemExit("phase 16: the ranks' losses differ")

    # --- K1 and K2 at every shape the service, the NCCL rank and the gloo
    # ranks gave them, against their plain versions (launches not counted)
    dtypes = {str(d): d for d in (torch.float32, torch.bfloat16)}
    for rec in recs:
        seen |= {(name, tuple(shape), dtypes[dtype])
                 for name, shape, dtype in rec["shapes"]}
    for name in ("nonlocal_attention", "nonlocal_attention_bwd"):
        if (name, PARALLEL_ATTN_SHAPE, torch.bfloat16) not in seen:
            raise SystemExit(f"phase 16: the sharded step launched no {name}"
                             f" at {PARALLEL_ATTN_SHAPE} bf16")
    print("K1 and K2 at the shapes phase 16's runs gave them, against their "
          "plain versions:", flush=True)
    check_gen = torch.Generator(device=dev).manual_seed(16)
    k1_err = k2_err = 0.0
    for name, shape, dtype in sorted(seen, key=str):
        if name == "nonlocal_attention":
            k1_err = max(k1_err, check_k1(check_gen, shape, dtype))
        else:
            k2_err = max(k2_err, check_k2_case(check_gen, shape, dtype))

    # --- K1 and K2 at the per-rank shape, timed on the card alone
    print(f"K1 and K2 at the per-rank shape {PARALLEL_ATTN_SHAPE}, timed "
          f"with the ranks gone ({smi}):", flush=True)
    gen = torch.Generator(device=dev).manual_seed(17)
    k1 = time_k1(gen, PARALLEL_ATTN_SHAPE, with_lse=True)
    k2 = time_k2(gen, PARALLEL_ATTN_SHAPE)
    print(f"phase 16: {time.perf_counter() - t_phase:.1f} s ({smi})",
          flush=True)
    return {"launches": launches, "k1": k1, "k2": k2,
            "k1_err": k1_err, "k2_err": k2_err}


# the rest of the port (phase 17): the TF bundle reader on the committed
# fixture, the native loader, the fused UCB step over a mesh, and the
# opt-in space-to-depth and packed convs, timed
TF_BUNDLE = ROOT / "tests" / "goldens" / "tf_bundle" / "ckpt-1"
BUNDLE_GEN_LAYERS = ("generator/conv1/", "generator/conv2/",
                     "generator/conv3/", "generator/up3/")
NATIVE_CROPS = 32
NATIVE_ATOL = 1e-5                  # tests/test_native.py:33-38
MESH_UCB_IMAGES = 8
PACKED_CIN, PACKED_CMID = 128, 64   # tools/bench_packed_tail.py's segment
PACKED_ATOL = 1e-3                  # its f32 check
S2D_BAR_DB = 40.0                   # bench.py's bf16 production bar


def bundle_reader(dev) -> tuple[dict, int]:
    """The committed TF bundle read without TensorFlow, bitwise against
    synthetic_tf_weights; the discriminator trio and the generator's
    covered layers loaded from it, the latter into the TF-golden generator,
    whose f32 forward on the card must meet phase 4's bar.  Returns ({label:
    verify_against_index counts}, K1 launches of the bundle forward)."""
    gen_map = [e for e in generator_mapping("gsc", 6)
               if e[1].startswith(BUNDLE_GEN_LAYERS)]
    disc_sd = MultiScaleDiscriminators().state_dict()
    want = synthetic_tf_weights(disc_sd, discriminator_mapping(), 0)
    want.update(synthetic_tf_weights(GENERATORS["gsc"](6).state_dict(),
                                     gen_map, 0))
    prefix = str(TF_BUNDLE)
    t0 = time.perf_counter()
    got = read_bundle(prefix)
    read_s = time.perf_counter() - t0
    bad = [n for n, v in want.items()
           if not np.array_equal(got.get(n + VAL_SUFFIX), v)]
    if bad or len(got) != len(want) + 1:     # + save_counter
        raise SystemExit(f"the TF bundle reader: {len(bad)} tensors differ "
                         f"from synthetic_tf_weights ({bad[:3]})")
    counts = {}
    for label, sd, mapping in (
            ("discriminators", disc_sd, discriminator_mapping()),
            ("generator", GENERATORS["gsc"](6).state_dict(),
             generator_mapping("gsc", 6))):
        r = verify_against_index(prefix, sd, mapping)
        counts[label] = {k: v if isinstance(v, int) else len(v)
                         for k, v in r.items()}
    print(f"TF bundle (no TensorFlow): {len(list_variables(prefix))} "
          f"entries, {len(got)} numeric tensors read in {read_s:.3f} s, "
          f"bitwise equal to synthetic_tf_weights; verify_against_index: "
          + "; ".join(f"{k} {v}" for k, v in counts.items()), flush=True)
    if (counts["discriminators"]["matched"] != len(discriminator_mapping())
            or counts["generator"]["matched"] != len(gen_map)
            or any(c["shape_mismatch"] for c in counts.values())):
        raise SystemExit("the TF bundle does not verify against the models")
    # the trio from the bundle, on the card: the loaded model runs
    discs = MultiScaleDiscriminators().to(dev).eval()
    discs.load_state_dict(load_tf_checkpoint(prefix, discriminator_mapping()))
    x = torch.rand(2, 256, 256, 6, generator=torch.Generator().manual_seed(0))
    with torch.inference_mode(), no_tf32():
        logits = discs(x.to(dev))
    if not all(torch.isfinite(t).all() for pair in logits for t in pair):
        raise SystemExit("the bundle's discriminators gave non-finite logits")
    # the generator's covered layers from the bundle, bitwise the golden
    # weights' own, in the TF-golden generator: phase 4's f32 bar
    sd = golden_weights()
    loaded = load_tf_checkpoint(prefix, gen_map)
    if not all(torch.equal(t, sd[k]) for k, t in loaded.items()):
        raise SystemExit("the bundle's generator layers differ from "
                         "synthetic_tf_weights'")
    golden = np.load(GOLDEN)
    img = torch.from_numpy(golden["ffhq_input"].astype(np.float32))[None]
    uv = torch.from_numpy(golden["ffhq_uv"].astype(np.float32))[None]
    model = build_generator(get_config(compute_dtype="float32"),
                            {**sd, **loaded}, dev)
    nonlocal_attention.launches = 0
    with torch.inference_mode(), no_tf32():
        out = model(img.to(dev), uv.to(dev))[1]
    launches = nonlocal_attention.launches
    score = psnr(out[0].clamp(0, 1).cpu().numpy(),
                 golden["ffhq_pred"].astype(np.float32))
    print(f"the bundle's conv1, heads and up3 ({len(loaded)} tensors, "
          f"bitwise the golden weights') in the TF-golden generator: PSNR "
          f"{score:.2f} dB vs the TF reference (bar 45 dB); the trio's "
          f"logits finite; K1 launches {launches}", flush=True)
    if not score >= 45.0:
        raise SystemExit(f"the generator from the bundle: {score:.2f} dB")
    return counts, launches


def native_loader(smi: str) -> None:
    """The g++ loader must load here; it against numpy on NATIVE_CROPS
    crops to 256 px, and both timed."""
    t0 = time.perf_counter()
    if native.get_lib() is None:
        raise SystemExit("the native loader did not load on this machine")
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(17)
    imgs = rng.uniform(size=(NATIVE_CROPS, 720, 720, 3)).astype(np.float32)
    x0 = rng.integers(-60, 300, size=(NATIVE_CROPS, 2))
    side = rng.integers(260, 480, size=(NATIVE_CROPS, 1))
    boxes = np.concatenate([x0, x0 + side], axis=1).astype(np.int32)
    turns = {"native": [], "numpy": []}
    for _ in range(3):
        t0 = time.perf_counter()
        lib_out = native.batch_crop_resize(imgs, boxes, 256)
        turns["native"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        np_out = np.stack([native._crop_resize_np(imgs[i], boxes[i], 256)
                           for i in range(NATIVE_CROPS)])
        turns["numpy"].append(time.perf_counter() - t0)
    err = float(np.abs(lib_out - np_out).max())
    single = native.crop_resize(imgs[0], boxes[0], 256)
    print(f"native loader: loaded ({native.library_path().name}, "
          f"{build_s:.2f} s to build and load); {NATIVE_CROPS} crops of "
          f"720x720 to 256x256: batch_crop_resize "
          + ", ".join(f"{1e3 * t:.1f}" for t in turns["native"])
          + f" ms ({os.cpu_count()} threads), numpy "
          + ", ".join(f"{1e3 * t:.1f}" for t in turns["numpy"])
          + f" ms (host CPU, {smi}); max |native - numpy| {err:.2e} (limit "
          f"{NATIVE_ATOL:g})", flush=True)
    if not (err <= NATIVE_ATOL and np.array_equal(single, lib_out[0])):
        raise SystemExit("the native loader disagrees with numpy")


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN restricted to its deterministic algorithms inside, the
    process's setting restored after."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved


def mesh_ucb_inputs(dev, sd: dict, work: str):
    """(two UCBEvaluators on `dev`, each with its generator; the batch,
    sizes and PartInputs of MESH_UCB_IMAGES images of a synthetic UCB tree
    at 256 px, f32, device geometry) for the fused step."""
    root = synthetic_ucb_tree(os.path.join(work, "ucb"))
    cfg = get_config("ucb", checkpoint_dir=os.path.join(work, "ucb_out"),
                     compute_dtype="float32", device_geometry=True,
                     part_mask_root=root,
                     data_dirs_test=(os.path.join(root, "input", "*"),))
    evs = [UCBEvaluator(cfg, sd, device=dev) for _ in range(2)]
    ev, params, s = evs[0], PostprocessParams(), cfg.img_size
    jbs, sizes, pis = [], [], []
    for step, (batch, box, name) in zip(range(MESH_UCB_IMAGES),
                                        Dataset(cfg, "test")):
        parts = ev._load_part_masks(root, step, sample_name=name)
        size = int(min(box[3] - box[1], s))
        pis.append(prep_part_inputs(ev._resized_parts(parts, size), params))
        jbs.append(ev._ingress(batch, to_device=False))
        sizes.append(size)
    _, stacked, sizes, pi = ev._stack_chunk([], jbs, sizes, pis,
                                            MESH_UCB_IMAGES)
    batch = {k: ev._tensor(v) for k, v in stacked.items()}
    return evs, batch, ev._tensor(sizes), pi.to(dev)


def mesh_ucb(dev, sd: dict, smi: str, work: str) -> dict:
    """The fused UCB step of MESH_UCB_IMAGES images over a (2,) mesh of
    two entries on the card (a replica each) against the one-device step,
    f32 with TF32 off and cuDNN deterministic: every output identical to
    the one-device step run on each shard's images, and within phase 10's
    f32 bars of it on all the images at once (detected identical).
    Returns {one-device K1 launches, mesh K1 launches}."""
    evs, batch, size_t, pi = mesh_ucb_inputs(dev, sd, work)
    ev, params, s = evs[0], PostprocessParams(), evs[0].config.img_size
    mesh = make_mesh((2,), ("data",), devices=[dev, dev])
    one = build_fused_ucb_batch_step(ev._fused_fwd(), params, s)
    two = build_fused_ucb_batch_step([e._fused_fwd() for e in evs], params,
                                     s, mesh=mesh)
    launches, reports, outs = {}, {}, {}
    # cuDNN's default f32 algorithms are not reproducible from call to
    # call (two calls of the one-device step moved a composite value by a
    # u8 step and SSIM by 6e-8); its deterministic ones are, batch for batch
    with no_tf32(), deterministic_cudnn():
        for label, step_fn in (("one device", one), ("mesh", two)):
            reports[label] = {}
            nonlocal_attention.launches = 0
            outs[label] = [o.cpu() for o in step_fn(batch, size_t, pi,
                                                    reports[label])]
            launches[label] = nonlocal_attention.launches
        # the one-device step on each shard's images alone: the mesh's
        # arithmetic, batch for batch
        half = MESH_UCB_IMAGES // 2
        shards = [[o.cpu() for o in one(
            {key: t[lo:lo + half] for key, t in batch.items()},
            size_t[lo:lo + half],
            PartInputs(**{f.name: getattr(pi, f.name)[lo:lo + half]
                          for f in dataclasses.fields(PartInputs)}))]
            for lo in (0, half)]
    with no_tf32():           # timed with cuDNN's default algorithms
        ms = {label: cuda_ms(lambda f=f: f(batch, size_t, pi), iters=2,
                             warmup=1)
              for label, f in (("one device", one), ("mesh", two))}
    by_shard = [torch.cat(parts) for parts in zip(*shards)]
    same = [torch.equal(a, b) for a, b in zip(outs["mesh"], by_shard)]
    ref = outs["one device"]
    det_same = torch.equal(outs["mesh"][0], ref[0])
    steps = [(outs["mesh"][i].int() - ref[i].int()).abs() for i in (1, 2)]
    d_psnr, d_ssim = ((outs["mesh"][i] - ref[i]).abs().max().item()
                      for i in (3, 4))
    k, v = batch["img"].shape[:2]
    print(f"fused UCB step over a (2,) mesh on one card, {k} images x {v} "
          f"views at {s} px, f32, TF32 off, cuDNN deterministic: "
          f"detected, composite, shadow "
          f"map, PSNR, SSIM identical to the one-device step run on each "
          f"shard's images: {same}; against the one-device step on all "
          f"{k}: detected identical {det_same}, composite and shadow map "
          f"u8 steps at most {steps[0].max().item()}, "
          f"{steps[1].max().item()} ({int((steps[0] > 0).sum())}, "
          f"{int((steps[1] > 0).sum())} values differ), max |dPSNR| "
          f"{d_psnr:.3e} dB, max |dSSIM| {d_ssim:.3e}; label iterations "
          f"{reports['mesh']['label_iterations']} (one device "
          f"{reports['one device']['label_iterations']}); mean PSNR "
          f"{outs['mesh'][3].mean().item():.3f} dB; a step "
          + ", ".join(f"{label} {t:.1f} ms" for label, t in ms.items())
          + f" ({smi}; the two replicas share the card: no scaling "
          f"figure); K1 launches " + ", ".join(
              f"{k} {v}" for k, v in launches.items()), flush=True)
    # batch for batch the arithmetic is the same: identical.  Against the
    # whole k, cuDNN picks its algorithms by batch size (40 views alone
    # against inside 80: 4.2e-7): phase 10's f32 bars for two batchings
    if not all(same) or reports["mesh"]["label_iterations"] != \
            reports["one device"]["label_iterations"]:
        raise SystemExit("the fused UCB step over the mesh differs from "
                         "the one-device step on the same shards")
    if not (det_same and max(t.max().item() for t in steps) <= 1
            and d_psnr <= 0.01 and d_ssim <= 1e-4):
        raise SystemExit("the fused UCB step over the mesh misses the "
                         "one-device step's bars")
    if launches["mesh"] != 2 * ATTN_CALLS_PER_FORWARD:
        raise SystemExit(f"the mesh step launched K1 {launches['mesh']} "
                         f"times, expected {2 * ATTN_CALLS_PER_FORWARD}")
    return launches


def s2d_and_packed(dev, sd: dict, smi: str) -> int:
    """bench.py's forward (256 px, B=128, bf16, folded BN) with s2d_convs
    off and on, in turns, and the packed decoder tail against the direct
    one at B=128 (tools/bench_packed_tail.py's segment), in turns.
    Returns the K1 launches of the s2d forward."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.uniform(0.0, 0.9, (BENCH_BATCH, 256, 256, 3))
                         .astype(np.float32)).to(dev)
    u = torch.from_numpy(rng.uniform(size=(BENCH_BATCH, 256, 256, 3))
                         .astype(np.float32)).to(dev)
    kw = dict(compute_dtype="bfloat16", fold_bn=True, egress_dtype="bfloat16")
    models = {"direct": build_generator(get_config(**kw), sd, dev),
              "s2d": build_generator(get_config(s2d_convs=True, **kw), sd,
                                     dev)}
    with torch.inference_mode():
        outs = {}
        for label, m in models.items():
            nonlocal_attention.launches = 0
            outs[label] = m(x, u)[1].float().clamp(0, 1)
            if label == "s2d":
                launches = nonlocal_attention.launches
        db = psnr(outs["s2d"].cpu().numpy(), outs["direct"].cpu().numpy())
        diff = (outs["s2d"] - outs["direct"]).abs().max().item()
        del outs
        turns = alternate_ms({label: lambda m=m: m(x, u)
                              for label, m in models.items()},
                             reps=3, iters=5)
    med = {k: float(np.median(v)) for k, v in turns.items()}
    print(f"GSC forward, B={BENCH_BATCH} 256 px bf16 folded: direct "
          f"{med['direct']:.2f} ms, s2d_convs {med['s2d']:.2f} ms "
          f"(s2d / direct {med['s2d'] / med['direct']:.3f}; by turn direct "
          + ", ".join(f"{t:.2f}" for t in turns["direct"]) + ", s2d "
          + ", ".join(f"{t:.2f}" for t in turns["s2d"])
          + f"; {smi}); outputs {db:.2f} dB apart (bar {S2D_BAR_DB} dB), "
          f"max |diff| {diff:.3e}; K1 launches {launches}", flush=True)
    if not db >= S2D_BAR_DB:
        raise SystemExit(f"s2d_convs moved the bf16 forward: {db:.2f} dB")
    if launches != ATTN_CALLS_PER_FORWARD:
        raise SystemExit(f"the s2d forward launched K1 {launches} times")
    del models, x, u
    torch.cuda.empty_cache()

    # the packed decoder tail: ConvT(128 -> 64, s2) + bias + affine + leaky
    # + 7x7 head (64 -> 2), direct at 256 px against packed at 128 px
    g = torch.Generator().manual_seed(0)
    seg = torch.randn(BENCH_BATCH, PACKED_CIN, 128, 128, generator=g)
    wt = 0.05 * torch.randn(PACKED_CIN, PACKED_CMID, 3, 3, generator=g)
    bt, shift = (0.1 * torch.randn(PACKED_CMID, generator=g)
                 for _ in range(2))
    scale = 0.5 + torch.rand(PACKED_CMID, generator=g)
    wh = 0.05 * torch.randn(2, PACKED_CMID, 7, 7, generator=g)
    bh = 0.1 * torch.randn(2, generator=g)

    def tails(dt):
        """(direct, packed) segment functions with every operand on the
        card in dtype `dt`, the packed kernels made once."""
        w_t, b_t, sh, sc, w_h, b_h = (t.to(dev, dt) for t in (
            wt, bt, shift, scale, wh, bh))
        col = [v[None, :, None, None] for v in (b_t, sc, sh)]
        wt_p = packed.convt_packed_kernel(w_t)
        wh_p = packed.conv_same_packed_kernel(w_h)
        tiled = [packed.tile_phase(v)[None, :, None, None]
                 for v in (b_t, sc, sh, b_h)]

        def direct(xs):
            y = F.conv_transpose2d(xs, w_t, stride=2)[..., :256, :256]
            y = F.leaky_relu((y + col[0]) * col[1] + col[2], 0.3)
            return F.conv2d(y, w_h, b_h, padding=3)

        def packed_tail(xs):
            y = packed.convt_packed(xs, wt_p) + tiled[0]
            y = F.leaky_relu(y * tiled[1] + tiled[2], 0.3)
            return packed.unpack_image(
                packed.conv_same_packed(y, wh_p) + tiled[3], 2)

        return direct, packed_tail

    with torch.inference_mode(), no_tf32():
        direct, packed_tail = tails(torch.float32)
        xs = seg[:2].to(dev)
        err = (direct(xs) - packed_tail(xs)).abs().max().item()
    seg = seg.to(dev, torch.bfloat16)
    with torch.inference_mode():
        direct, packed_tail = tails(torch.bfloat16)
        turns = alternate_ms({"direct": lambda: direct(seg),
                              "packed": lambda: packed_tail(seg)},
                             reps=3, iters=10)
    med = {k: float(np.median(v)) for k, v in turns.items()}
    print(f"decoder tail (ConvT {PACKED_CIN}->{PACKED_CMID} + affine + "
          f"leaky + 7x7 head), B={BENCH_BATCH}, bf16: direct "
          f"{med['direct']:.3f} ms, packed {med['packed']:.3f} ms (packed / "
          f"direct {med['packed'] / med['direct']:.3f}; by turn direct "
          + ", ".join(f"{t:.3f}" for t in turns["direct"]) + ", packed "
          + ", ".join(f"{t:.3f}" for t in turns["packed"])
          + f"; {smi}); f32 packed vs direct max |diff| {err:.2e} (limit "
          f"{PACKED_ATOL:g})", flush=True)
    if not err <= PACKED_ATOL:
        raise SystemExit(f"the packed tail disagrees with the direct one: "
                         f"{err}")
    return launches


def rest_path(dev, smi: str, work: str) -> dict:
    """Phase 17: the TF bundle reader, the native loader, the fused UCB
    step over a mesh and the s2d and packed timings; then K1 at every
    (shape, dtype) these runs gave it, against its plain version."""
    t_phase = time.perf_counter()
    seen, stop_recording = record_attention_shapes()
    try:
        counts, bundle_launches = bundle_reader(dev)
        native_loader(smi)
        mesh_launches = mesh_ucb(dev, golden_weights(), smi, work)
        s2d_launches = s2d_and_packed(dev, golden_weights(), smi)
    finally:
        stop_recording()
    print("K1 at the shapes phase 17's runs gave it, against its plain "
          "version:", flush=True)
    gen = torch.Generator(device=dev).manual_seed(18)
    k1_err = max(check_k1(gen, shape, dtype)
                 for _, shape, dtype in sorted(seen, key=str))
    launches = {"tf bundle forward": bundle_launches,
                "ucb one device": mesh_launches["one device"],
                "ucb mesh": mesh_launches["mesh"],
                "s2d forward": s2d_launches}
    print(f"phase 17: {time.perf_counter() - t_phase:.1f} s ({smi})",
          flush=True)
    return {"launches": launches, "k1_err": k1_err, "verify": counts}


# the tools (phase 18): each measuring function of
# blindshadowremoval_tpu_torch/tools/ once on the card, bench at full
# width, bench_train at phase 8's batch, the rest at small counts on
# phase 10's UCB tree, phase 13's training tree and the fixture bundle
TOOLS_BENCH_ITERS = 20
TOOLS_SWEEP = [2, 16]         # queued (B < 16) and by events
TOOLS_TRAIN_STEPS = 2
TOOLS_FLOP_RTOL = 1e-2        # the kernel route's FLOPs against the plain's
# the keys of each tool's record (the JAX tool's JSON keys where it prints
# JSON, the port's record where it prints text), "device" in each
TOOL_KEYS = {
    "bench": ("metric", "value", "unit", "vs_baseline"),
    "bench_sweep": ("batch", "faces_per_sec", "timing"),
    "roofline_infer": (
        "config", "batch", "gflops_per_face", "mb_accessed_per_face",
        "arithmetic_intensity_flop_per_byte", "measured_ms_per_batch",
        "faces_per_sec", "t_compute_ms", "t_bandwidth_ms", "bound",
        "speed_of_light_ms", "fraction_of_speed_of_light"),
    "profile_infer": ("device_ms_per_fwd", "us_per_face", "kinds", "top"),
    "profile_train": ("device_ms_per_step", "us_per_view", "kinds", "top"),
    "bench_train": (
        "batch_size", "views_per_step", "compute_dtype", "vgg_dtype",
        "remat", "s2d", "step_time_ms", "steps_per_sec", "views_per_sec",
        "step_tflops", "mfu_pct_vs_bf16_peak"),
    "bench_fit": ("loader_ms_per_sample", "upload_mb_per_s",
                  "fit_ms_per_step", "views_per_sec"),
    "bench_ucb_eval": ("bench", "views", "dtype", "compact_ingress", "host",
                       "fused"),
    "bench_serving_frontend": ("batch_api_req_per_s", "frontend_req_per_s",
                               "batches", "latency_mean_ms",
                               "latency_p95_ms"),
    "bench_e2e": ("detect_images_per_s", "acd_images_per_s",
                  "e2e_images_per_s", "run_dir"),
    "bench_landmarks": ("fan_faces_per_s", "sfd_images_per_s",
                        "host_decode_ms"),
    "bench_packed_tail": ("us_per_face", "max_err"),
    "bench_packed_tail --grad": ("us_per_face", "max_err"),
    "bench_int8_decoder": ("tail_rel_err", "us_per_face"),
    "calibrate_int8_head": ("absmax", "suggested_bound", "checkpoint_bounds",
                            "psnr_dynamic_db", "psnr_static_db"),
    "parity_serving": tuple(k for k in tools_parity.CONFIGS if k != "f32"),
}


def kernel_cells(gen, seen) -> tuple[list, list]:
    """K1 and K2 at every (wrapper, shape, dtype) in `seen`, each with its
    plain version, the SDPA library call (flash for bf16, the
    memory-efficient backend for f32, the math backend where either
    refuses the shape) and the bound: device time a call with the calls
    queued ahead, SDPA's backward as `sdpa_backward`'s replay.  The wrapper
    "nonlocal_attention_lse" is K1 writing the row logsumexp too, against
    the plain version that computes it.  Returns ([K1 cells], [K2
    cells])."""
    k1_cells, k2_cells = [], []
    for name, shape, dtype in sorted(seen, key=str):
        b, n, d = shape
        t, p, g, do = k2_operands(gen, shape, dtype)
        q4, k4, v4 = (x[:, None].clone().requires_grad_() for x in (t, p, g))
        do4 = do[:, None].contiguous()
        fwd = name != "nonlocal_attention_bwd"
        with_lse = name == "nonlocal_attention_lse"

        def library(backend):
            with sdpa_kernel(backend):
                if fwd:
                    with torch.no_grad():
                        return device_ms(lambda: F.scaled_dot_product_attention(
                            q4, k4, v4, scale=1.0), 20), []
                replay, ops = sdpa_backward(q4, k4, v4, do4)
            return device_ms(replay, 20), ops

        backend = (SDPBackend.FLASH_ATTENTION if dtype == torch.bfloat16
                   else SDPBackend.EFFICIENT_ATTENTION)
        with no_tf32():
            try:
                lib_ms, lib_ops = library(backend)
            except _timing.HostSyncError:
                raise
            except RuntimeError:         # the backend refuses the shape
                backend = SDPBackend.MATH
                lib_ms, lib_ops = library(backend)
            with torch.no_grad():
                if fwd:
                    plain = (nonlocal_attention_lse_reference if with_lse
                             else nonlocal_attention_reference)
                    ms = device_ms(lambda: _launch_fwd(t, p, g, with_lse),
                                   20)
                    plain_ms = device_ms(lambda: plain(t, p, g), 20)
                    bound_ms, bound_by = attention_bound_ms(b, n, d, dtype,
                                                            with_lse)
                else:
                    out, lse = _launch_fwd(t, p, g, with_lse=True)
                    ms = device_ms(lambda: nonlocal_attention_bwd(
                        t, p, g, out, lse, do), 20)
                    plain_ms = device_ms(
                        lambda: nonlocal_attention_bwd_reference(t, p, g, do),
                        20)
                    bound_ms, bound_by = attention_bwd_bound_ms(b, n, d,
                                                                dtype)
        cell = dict(shape=list(shape), dtype=str(dtype).split(".")[-1],
                    ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                    library_backend=backend.name.lower(), bound_ms=bound_ms,
                    library_ops=lib_ops,
                    bound_by=bound_by, path="phases 9-18")
        if with_lse:
            cell.update(lse=True, path="f32 train step at full width")
        elif shape in F32_TRAIN_SHAPES and dtype == torch.float32 and not fwd:
            cell.update(path="f32 train step at full width")
        print(f"{'K1+lse' if with_lse else 'K1' if fwd else 'K2'} {shape} "
              f"{cell['dtype']}: kernel "
              f"{ms:.4f} ms ({100 * bound_ms / ms:.1f}% of the bound "
              f"{bound_ms:.4f} ms, {bound_by}), plain {plain_ms:.4f} ms, "
              f"sdpa {cell['library_backend']} {lib_ms:.4f} ms", flush=True)
        (k1_cells if fwd else k2_cells).append(cell)
    return k1_cells, k2_cells


def tool_record(name: str, result: dict, seconds: float,
                launches: tuple) -> None:
    """Prints one tool's record as a JSON line; exits on a missing key."""
    missing = [k for k in TOOL_KEYS[name] + ("device",) if k not in result]
    if missing:
        raise SystemExit(f"tool {name}: keys {missing} missing from its "
                         "record")
    print(json.dumps({"tool": name, "seconds": round(seconds, 2),
                      "launches": list(launches), **result}), flush=True)


def roofline_plain_flops(dev) -> int:
    """FLOPs of bench's forward at B=2 with the attention's ops run as
    their plain versions (`PlainRoute`), counted by FlopCounterMode, which
    then sees the plain version's two matrix products in place of the
    op."""
    from torch.utils.flop_counter import FlopCounterMode

    model = tools_bench.make_gen(device=dev)
    img, uv, reg = tools_bench.make_inputs(2, tools_bench.SIZE, 0, dev)
    with torch.inference_mode(), FlopCounterMode(display=False) as fc, \
            PlainRoute():
        model(img, uv, reg)
    return fc.get_total_flops()


def tools_path(dev, smi: str, work: str, bench_faces: float) -> dict:
    """Phase 18: every tool's measuring function on the card, one JSON
    record each; fails on an exception (a stale timed result among them),
    a missing key, a profile that names no K1 (and for training no K2),
    or roofline_infer's FLOPs more than TOOLS_FLOP_RTOL from the plain
    route's.  Then K1 and K2 at every shape the tools gave them against
    their plain versions."""
    t_phase = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = True      # PyTorch's defaults
    torch.backends.cuda.matmul.allow_tf32 = False
    ucb = synthetic_ucb_tree(os.path.join(work, "ucb"))
    train_glob, _, _ = synthetic_train_tree(os.path.join(work, "train"))
    bundle = str(TF_BUNDLE)
    launches, records = {}, {}

    def run(name, fn, *args, **kwargs):
        k1, k2 = nonlocal_attention.launches, nonlocal_attention_bwd.launches
        t0 = time.perf_counter()
        result = fn(*args, **kwargs)
        seconds = time.perf_counter() - t0
        launches[name] = (nonlocal_attention.launches - k1,
                          nonlocal_attention_bwd.launches - k2)
        for r in result if isinstance(result, list) else [result]:
            tool_record(name, r, seconds, launches[name])
        records[name] = result
        return result

    seen, stop_recording = record_attention_shapes()
    try:
        run("bench", tools_bench.run, iters=TOOLS_BENCH_ITERS, device=dev)
        run("bench_sweep", lambda: list(tools_sweep.sweep(
            TOOLS_SWEEP, iters=10, device=dev)))
        run("roofline_infer", tools_roofline.roofline, batch=2, iters=10,
            device=dev)
        run("profile_infer", tools_profile_infer.profile, batch=8, iters=2,
            out=os.path.join(work, "infer_trace"), device=dev)
        run("profile_train", tools_profile_train.profile, batch=2, iters=1,
            out=os.path.join(work, "train_trace"), device=dev)
        run("bench_train", tools_bench_train.bench_config, TRAIN_BATCH,
            TOOLS_TRAIN_STEPS, "bfloat16", "bfloat16", device=dev)
        torch.cuda.empty_cache()
        run("bench_fit", tools_bench_fit.bench_fit, train_glob, batch=4,
            steps=2, warm=1, loader_samples=8, compact=True, u8=True,
            device_darken=True, prefetch=True, device=dev)
        run("bench_ucb_eval", tools_ucb.bench_ucb_eval,
            os.path.join(ucb, "input", "*"), ucb, images=3, device=dev)
        run("bench_serving_frontend", tools_frontend.bench_frontend,
            requests=32, clients=4, batch_size=16, device=dev)
        run("bench_e2e", tools_e2e.bench_e2e, images=8, det_batch=4,
            fan_batch=8, serve_batch=4, device=dev)
        # FAN-4's forward overflows the device's launch queue: by events
        run("bench_landmarks", tools_landmarks.bench_landmarks, batch=16,
            det_batch=2, iters=3, device=dev)
        run("bench_packed_tail", tools_packed.bench_tail, batch=16, iters=5,
            device=dev)
        run("bench_packed_tail --grad", tools_packed.bench_tail, batch=16,
            iters=3, grad=True, device=dev)
        run("bench_int8_decoder", tools_int8.bench_decoder, batch=16,
            iters=5, device=dev)
        run("calibrate_int8_head", tools_calibrate.calibrate, bundle,
            os.path.join(ucb, "input", "*"), images=2, device=dev)
        run("parity_serving", tools_parity.parity, bundle,
            os.path.join(ucb, "input", "*"), ucb, ucb_images=1, device=dev)
    finally:
        stop_recording()

    for name, kinds in (("profile_infer", ("K1",)),
                        ("profile_train", ("K1", "K2"))):
        named = records[name]["kinds"]
        if any(named.get(k, [0.0, 0])[1] == 0 for k in kinds):
            raise SystemExit(f"{name} names no {' or '.join(kinds)} among "
                             f"the kernels: {sorted(named)}")
    rf = records["roofline_infer"]
    counted = rf["gflops_per_face"] * rf["batch"] * 1e9
    plain = roofline_plain_flops(dev)
    print(f"roofline_infer at B=2: {counted:.6g} FLOPs on the kernel route "
          f"(the op's formula), {plain:.6g} on the plain route "
          f"(its products counted), apart {abs(counted / plain - 1):.2e} "
          f"(limit {TOOLS_FLOP_RTOL:g})", flush=True)
    if not abs(counted / plain - 1) <= TOOLS_FLOP_RTOL:
        raise SystemExit("roofline_infer's FLOPs depend on the route")
    print(f"bench: {records['bench']['value']} faces/s against phase 6's "
          f"{bench_faces:.1f} ({smi})", flush=True)

    print("K1 and K2 at the shapes phase 18's tools gave them, against "
          "their plain versions:", flush=True)
    gen = torch.Generator(device=dev).manual_seed(19)
    k1_err = k2_err = 0.0
    for name, shape, dtype in sorted(seen, key=str):
        if name == "nonlocal_attention":
            k1_err = max(k1_err, check_k1(gen, shape, dtype))
        else:
            k2_err = max(k2_err, check_k2_case(gen, shape, dtype))
    print(f"phase 18: {time.perf_counter() - t_phase:.1f} s ({smi})",
          flush=True)
    return {"launches": launches, "k1_err": k1_err, "k2_err": k2_err}


if __name__ == "__main__":
    if sys.argv[1:2] == ["--parallel-rank"]:
        sys.exit(parallel_rank(*sys.argv[2:5]))
    sys.exit(main())
