"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's hand-written kernels from the sources in this checkout,
holds each against its plain PyTorch version on the card, runs the GSC
generator against the TF-reference golden, serves a batch of requests
through `ShadowRemovalService` (the main path, counting kernel launches),
times the bench.py configuration, and prints one JSON line per kernel and,
last, `{"ok": true, "device": {...}}`.  Any failure ends the run with a
non-zero exit and no result line.  Exits 1 at once when CUDA is absent.
Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel

from blindshadowremoval_tpu_torch.config import get_config
from blindshadowremoval_tpu_torch.eval.serving import ShadowRemovalService
from blindshadowremoval_tpu_torch.geometry.landmarks import LM_REF
from blindshadowremoval_tpu_torch.geometry.triangulation import (
    device_geometry_maps,
)
from blindshadowremoval_tpu_torch.models import build_generator
from blindshadowremoval_tpu_torch.models.generator import GSCGenerator
from blindshadowremoval_tpu_torch.models.weights import (
    generator_mapping,
    load_tf_weights,
    synthetic_tf_weights,
)
from blindshadowremoval_tpu_torch.ops import _build
from blindshadowremoval_tpu_torch.ops.nonlocal_attn import (
    KERNEL_TOLERANCE,
    nonlocal_attention,
    nonlocal_attention_reference,
)

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "goldens" / "tf_ref" / "e2e_eval.npz"

# H100 SXM published dense peaks (NVIDIA H100 datasheet)
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

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
              ((2, 1024, 256), torch.bfloat16)]     # RGB's width


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


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = float(np.mean((np.asarray(a, np.float32)
                         - np.asarray(b, np.float32)) ** 2))
    return float("inf") if mse == 0 else 10.0 * np.log10(1.0 / mse)


def attention_bound_ms(b: int, n: int, d: int, dtype: torch.dtype):
    """(least ms, "operations" | "bytes") for one attention call: two
    N x N x D products per batch element, and three inputs read and one
    output written once."""
    flops = 4.0 * b * n * n * d
    nbytes = 4.0 * b * n * d * torch.tensor([], dtype=dtype).element_size()
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def golden_weights() -> dict:
    """The TF-golden weights: synthetic_tf_weights(seed=0) with the RGB
    head bias lifted by 0.5, as tests/goldens/tf_ref/e2e_eval.npz was made."""
    mapping = generator_mapping()
    weights = synthetic_tf_weights(GSCGenerator().state_dict(), mapping, 0)
    weights["generator/clr_conv3/conv/bias"] += 0.5
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
    log = _build.build("nonlocal_attn")
    print(f"built nonlocal_attn in {time.perf_counter() - t0:.1f} s -> "
          f"{_build.library_path('nonlocal_attn')}")
    print("\n".join(ln for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln))

    phase("3 kernel K1 vs its plain version")
    gen = torch.Generator(device=dev).manual_seed(0)
    max_err = 0.0
    for shape, dtype in ATTN_CASES:
        atol, rtol = KERNEL_TOLERANCE[dtype]
        t, p, g = ((0.3 * torch.randn(*shape, generator=gen, device=dev)
                    ).to(dtype) for _ in range(3))
        with torch.no_grad():
            out = nonlocal_attention(t, p, g)
            torch.cuda.synchronize()
            ref = nonlocal_attention_reference(t, p, g)
            torch.cuda.synchronize()
        diff = (out.float() - ref.float()).abs()
        err = diff.max().item()
        # the largest |out - ref| - rtol * |ref|, held against atol
        excess = (diff - rtol * ref.float().abs()).max().item()
        ok = bool(torch.isfinite(out).all()) and excess <= atol
        print(f"{shape} {str(dtype):15s} max_abs_err {err:.3e}, mean |ref| "
              f"{ref.float().abs().mean().item():.3e}, max(err - {rtol:.3g}"
              f"|ref|) {excess:.3e} (atol {atol:g}) {'ok' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            raise SystemExit(f"K1 disagrees with its plain version at {shape}")
        max_err = max(max_err, err)
    b, n, d = ATTN_CASES[0][0]
    t, p, g = ((0.3 * torch.randn(b, n, d, generator=gen, device=dev)
                ).to(torch.bfloat16) for _ in range(3))
    with torch.no_grad():
        k1_ms = cuda_ms(lambda: nonlocal_attention(t, p, g))
        plain_ms = cuda_ms(lambda: nonlocal_attention_reference(t, p, g))
        # yardstick only: the port never calls it.  [B, 1, N, D] (one
        # head), with the flash backend forced, so the run fails rather than
        # time the unfused math fallback
        t4, p4, g4 = t[:, None], p[:, None], g[:, None]
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                t4, p4, g4, scale=1.0))
            sdpa = F.scaled_dot_product_attention(t4, p4, g4, scale=1.0)[:, 0]
        sdpa_err = (sdpa.float() - nonlocal_attention_reference(
            t, p, g).float()).abs().max().item()
    bound_ms, bound_by = attention_bound_ms(b, n, d, torch.bfloat16)
    print(f"({b},{n},{d}) bf16: kernel {k1_ms:.4f} ms, plain {plain_ms:.4f} "
          f"ms, flash sdpa {sdpa_ms:.4f} ms (max_abs_err vs plain "
          f"{sdpa_err:.3e}), bound {bound_ms:.4f} ms ({bound_by}); kernel at "
          f"{100 * bound_ms / k1_ms:.1f}% of the bound", flush=True)

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
                     egress_dtype="bfloat16", device_geometry=True)
    svc = ShadowRemovalService(cfg, sd, batch_size=SERVE_BATCH, device=dev)
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
    model = svc.gen
    rng = np.random.default_rng(0)
    s = cfg.img_size
    x = torch.from_numpy(rng.uniform(0.0, 0.9, (BENCH_BATCH, s, s, 3)).astype(
        np.float32)).to(dev)
    u = torch.from_numpy(rng.uniform(size=(BENCH_BATCH, s, s, 3)).astype(
        np.float32)).to(dev)
    sums = []

    def step(k: int):
        # perturbed input per call; the scalar sum is kept to show the
        # outputs change from call to call
        _, rgb, _, dif = model(x + 4e-3 * (k % 16), u)
        sums.append(rgb.float().mean() + dif.float().mean())

    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        for k in range(3):
            step(k)
        before = nonlocal_attention.launches
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for k in range(BENCH_ITERS):
            step(k + 3)
        end.record()
        torch.cuda.synchronize()
    bench_ms = start.elapsed_time(end) / BENCH_ITERS
    bench_launches = nonlocal_attention.launches - before
    vals = torch.stack(sums[3:]).cpu().numpy()
    if not (np.isfinite(vals).all() and np.all(vals[1:] != vals[:-1])):
        raise SystemExit("benchmark outputs did not change between calls")
    if bench_launches != ATTN_CALLS_PER_FORWARD * BENCH_ITERS:
        raise SystemExit(f"bench: {bench_launches} K1 launches")
    faces = BENCH_BATCH * 1e3 / bench_ms
    print(f"B={BENCH_BATCH} {s}x{s} bf16 folded: {bench_ms:.2f} ms/forward, "
          f"{faces:.1f} faces/s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"({smi})", flush=True)
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
    by_block: dict[str, float] = {}
    for e in events:
        if e.key.startswith("block:"):
            name = e.key[len("block:"):]
            by_block[name] = max(by_block.get(name, 0.0),
                                 e.device_time_total / 1e3 / 2)
    print("device time by generator block (ms/forward, share of kernels):")
    for name, ms in sorted(by_block.items(), key=lambda kv: -kv[1]):
        print(f"  {ms:8.3f} ms  {100 * ms / busy_ms:5.1f}%  {name}")

    phase("7 kernels")
    print(json.dumps({"kernels": [{
        "name": "nonlocal_attn_fwd",
        "route": "cuda",
        "source": "blindshadowremoval_tpu_torch/csrc/nonlocal_attn.cu",
        "replaces": "blindshadowremoval_tpu/ops/pallas/nonlocal_attn.py:70",
        "launches": main_launches,
        "max_abs_err": max_err,
        "ms": k1_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": sdpa_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
