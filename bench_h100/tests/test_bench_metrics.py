"""The metric arithmetic on hand-made traces and shapes: the idle share
over the union of device intervals, device time under a host range, the
idle gaps' names, the attention's bounds, the per-layer readers, and the
reference's FLOP count against the program's own count."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from bench_h100.harness import trace as tr
from bench_h100.harness import work
from bench_h100.harness.device import PEAK_BF16_FLOPS, PEAK_BYTES, \
    PEAK_TF32_FLOPS

HERE = Path(__file__).resolve().parents[1]
MS = 1_000_000     # ns


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        "m_" + name.replace(".", "_"), HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _trace():
    # device: [0,10) and [5,20) overlap (one stream's copy under another's
    # kernel), then [30,40) and [60,70) ms; window 100 ms
    device = [("attn_fwd_bf16<128>", 0, 10 * MS, 1),
              ("Memcpy DtoH", 5 * MS, 20 * MS, 2),
              ("elementwise_kernel", 30 * MS, 40 * MS, 3),
              ("elementwise_kernel", 60 * MS, 70 * MS, 4)]
    launches = {1: 1 * MS, 2: 2 * MS, 3: 25 * MS, 4: 55 * MS}
    ranges = {"geometry": [(24 * MS, 26 * MS), (54 * MS, 56 * MS)],
              "preprocess": [(41 * MS, 53 * MS)],
              "fetch": [(20 * MS, 29 * MS)]}
    ops = [("bsr::nonlocal_attn", [[128, 1024, 128]] * 3,
            ["c10::BFloat16"] * 3)]
    return tr.Trace(0.1, device, launches, ranges, ops)


def test_idle_is_the_window_less_the_union():
    t = _trace()
    assert t.busy_intervals() == [(0, 20 * MS), (30 * MS, 40 * MS),
                                  (60 * MS, 70 * MS)]
    assert t.busy_s() == pytest.approx(0.040)
    assert t.idle_pct() == pytest.approx(60.0)


def test_device_time_under_a_range():
    t = _trace()
    assert t.calls("geometry") == 2
    assert t.seconds_under("geometry") == pytest.approx(0.020)
    assert t.seconds_under("fetch") == pytest.approx(0.010)   # holds 25 ms
    assert t.seconds_under("preprocess") == 0.0
    reader = _reader("geometry.device_ms")
    assert reader.read(SimpleNamespace(trace=t)) == pytest.approx(10.0)


def test_idle_gaps_named_by_the_host_range_at_their_middle():
    gaps = dict(_trace().idle_gaps())
    # [20,30): its middle, 25, lies in fetch and in geometry, which
    # opened later and so is the innermost; [40,60): preprocess
    assert gaps == {"geometry": pytest.approx(0.010),
                    "preprocess": pytest.approx(0.020)}


def test_kernel_kinds():
    ops = dict(_trace().device_ops())
    assert ops["K1"] == pytest.approx(0.010)
    assert ops["other elementwise"] == pytest.approx(0.020)
    assert tr.kernel_kind("bwd_hopper_bf16<128>") == "K2"
    assert tr.kernel_kind("cutlass_80_wgmma_gemm") == "matrix products"


@pytest.mark.parametrize("b,n,d", [(128, 1024, 128), (10, 1024, 128),
                                   (2, 64, 256)])
def test_attention_bounds_against_the_formulas(b, n, d):
    flops = 4.0 * b * n * n * d
    assert work.attention_bound_s(b, n, d, "bf16") == pytest.approx(max(
        flops / PEAK_BF16_FLOPS, 4.0 * b * n * d * 2 / PEAK_BYTES))
    assert work.attention_bound_s(b, n, d, "f32", lse=True) == \
        pytest.approx(max(3 * flops / PEAK_TF32_FLOPS,
                          (4.0 * b * n * d * 4 + 4.0 * b * n) / PEAK_BYTES))
    assert work.attention_bwd_bound_s(b, n, d, "bf16") == pytest.approx(max(
        2.5 * flops / PEAK_BF16_FLOPS,
        (8.0 * b * n * d * 2 + 4.0 * b * n) / PEAK_BYTES))


def test_k1_bound_at_the_served_shape():
    """(128, 1024, 128) bf16: 0.0695 ms, compute-bound."""
    assert work.attention_bound_s(128, 1024, 128, "bf16") * 1e3 == \
        pytest.approx(0.0695, abs=5e-5)


def test_k1_roofline_reader():
    t = _trace()
    k1 = _reader("k1.roofline_pct.serve").read(SimpleNamespace(trace=t))
    assert k1 == pytest.approx(100 * work.attention_bound_s(
        128, 1024, 128, "bf16") / 0.010)
    empty = tr.Trace(0.1, t.device, t.launches, t.ranges, [])
    assert _reader("k1.roofline_pct.serve").read(
        SimpleNamespace(trace=empty)) is None


def test_mfu_reader():
    run = SimpleNamespace(
        window={"units": 100, "window_s": 2.0},
        cell=SimpleNamespace(driver=SimpleNamespace(
            flops_per_unit=lambda run: 18.12e9)))
    assert _reader("mfu_pct.serve").read(run) == pytest.approx(
        100 * 18.12e9 * 50 / PEAK_BF16_FLOPS)


def test_collect_reads_a_chrome_trace(tmp_path):
    events = [
        {"ph": "X", "cat": "kernel", "name": "attn_fwd_bf16", "ts": 10.0,
         "dur": 5.0, "args": {"correlation": 7}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 2.0, "dur": 1.0, "args": {"correlation": 7}},
        {"ph": "X", "cat": "user_annotation", "name": "geometry",
         "ts": 1.0, "dur": 3.0},
        {"ph": "X", "cat": "cpu_op", "name": "bsr::nonlocal_attn",
         "ts": 1.5, "dur": 1.0,
         "args": {"Input Dims": [[2, 64, 128]] * 3,
                  "Input type": ["float"] * 3}}]

    class Prof:
        def export_chrome_trace(self, path):
            Path(path).write_text(json.dumps({"traceEvents": events}))

    t = tr.collect(Prof(), 1e-4, tmp_path / "t.json")
    assert t.seconds_under("geometry") == pytest.approx(5e-6)
    assert t.ops[0][1][0] == [2, 64, 128]
    with pytest.raises(RuntimeError):
        events[:] = events[1:]
        tr.collect(Prof(), 1e-4, tmp_path / "u.json")


def test_reference_flops_match_the_programs_count():
    """The reference's GSC forward at 256 px counts what the program's
    plain route counts (its roofline tool read 18.12 GFLOP a face)."""
    from bench_h100.harness import cells, serve
    from bench_h100.reference import generator as ref
    from blindshadowremoval_tpu_torch.config import get_config
    from blindshadowremoval_tpu_torch.models import build_generator

    cfg = get_config("in_the_wild", compute_dtype="float32")
    sd = serve.seeded_weights(cells.load("gsc-serve-batch").config, cfg, 5,
                              "cpu")
    x = torch.zeros((1, 256, 256, 3))
    ours = work.count_flops(lambda: ref.generator(ref.Net(sd), x, x, 6))
    gen = build_generator(cfg, sd, "cpu")
    with torch.no_grad():
        theirs = work.count_flops(lambda: gen(x, x))
    assert ours == pytest.approx(theirs, rel=0.01)
    assert ours / 1e9 == pytest.approx(18.12, rel=0.01)


def _run_module():
    spec = importlib.util.spec_from_file_location("bench_run",
                                                  HERE / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["gsc-serve-batch", "tsm-video-f10",
                                  "gsc-serve-open-half"])
def test_every_listed_metric_reads_or_the_run_fails(name):
    """Each cell's per-layer metrics read from a trace that holds their
    spans, kernels and counters; a trace without them leaves every one
    unread, and `run.py` refuses to print a result for such a run."""
    from bench_h100.harness import cells

    cell = cells.load(name)
    cell.driver = SimpleNamespace(flops_per_unit=lambda run: 18.12e9)
    run = _run_module().Run(cell, 1, 1.0, True, torch.device("cpu"))
    run.trace = _trace()
    run.spans = SimpleNamespace(durations_ms=lambda span: [6.0, 6.5])
    run.window = {"units": 100, "window_s": 2.0, "batches": 4,
                  "served": 66, "threads": {"collector_busy": 0.5},
                  "latency_ms": torch.arange(1.0, 101.0).numpy()}
    metrics, unread = _run_module().read_per_layer(run)
    assert not unread and set(metrics) == {m["name"]
                                           for m in cell.per_layer}
    if "frontend.latency_p95_ms" in metrics:
        assert metrics["frontend.latency_p95_ms"]["value"] == \
            pytest.approx(95.05)
    t = run.trace
    run.trace = tr.Trace(0.1, t.device, t.launches, {}, [])
    run.spans = SimpleNamespace(durations_ms=lambda span: [])
    run.window = {"units": 0, "window_s": 2.0, "batches": 0, "served": 0}
    metrics, unread = _run_module().read_per_layer(run)
    readers_of_the_device_alone = {"device.idle_pct.serve"}
    assert set(unread) == {m["name"] for m in cell.per_layer} \
        - readers_of_the_device_alone


def test_far_share_counts_values_outside_the_envelope():
    """A value inside the gate envelope, or within TAU of it, is not far;
    one more than TAU outside it on either side is, and the envelope spans
    the reference at the model's gate and DELTA either side."""
    import numpy as np

    from bench_h100.harness import compare as cmp

    assert cmp.gates((0.04,)) == (0.1, 0.1 - 0.04, 0.1 + 0.04)
    ref = np.zeros((3, 1, 8), np.float32)     # [gate, answer, values]
    ref[1, 0, :2] = 0.3                       # a patch the gate moves
    lo, hi = cmp.envelope(ref, 0.04, (0.04,))
    got = np.zeros(8, np.float32)
    got[0] = 0.3                              # inside the envelope
    got[2] = cmp.TAU * 0.9                    # within TAU of it
    got[3] = cmp.TAU * 1.5                    # above it
    got[4] = -cmp.TAU * 1.5                   # below it
    far = cmp.far_shares([got], [lo[0]], [hi[0]], "cpu", (cmp.TAU, 1.0))
    assert far.tolist() == [[2 / 8, 0.0]]
    mae, tmae = cmp.gaps([got], [ref[0, 0]], "cpu")
    assert mae[0] == pytest.approx(np.abs(got).mean())


def _collector_records():
    """Two batches: the first preprocesses two requests (8 ms each) and
    stages in 4 ms, its forward starts 5 ms later and takes 40 ms; the
    second preprocesses one (8 ms), stages in 2 ms, and waits 30 ms for
    the dispatcher.  Listed as the threads would finish them, out of start
    order."""
    return [("preprocess", 0, 8 * MS), ("preprocess", 8 * MS, 16 * MS),
            ("stage", 16 * MS, 20 * MS), ("preprocess", 30 * MS, 38 * MS),
            ("stage", 38 * MS, 40 * MS), ("forward_staged", 25 * MS, 65 * MS),
            ("forward_staged", 70 * MS, 100 * MS)][::-1]


def test_host_clock_batches_and_busy_shares():
    from bench_h100.harness import clock

    s = clock.summarize(_collector_records(), 0.2)
    assert s["collector"].tolist() == [20.0, 10.0]
    assert s["handoff"].tolist() == [5.0, 30.0]
    assert s["forward"].tolist() == [40.0, 30.0]
    assert s["collector_busy"] == pytest.approx(30 / 200)
    assert s["preprocess_busy"] == pytest.approx(24 / 200)
    assert s["stage_busy"] == pytest.approx(6 / 200)
    assert s["dispatcher_busy"] == pytest.approx(70 / 200)
    assert s["preprocess_ms"] == pytest.approx(8.0)
    lines = clock.notes(s)
    assert lines[0].startswith("collector busy share 0.15")
    assert lines[1] == ("collector ms a batch: p50 15.0 p95 19.5 p99 19.9 "
                        "max 20.0 over 2 batches")
    reader = _reader("frontend.collector_busy_pct")
    assert reader.read(SimpleNamespace(window={"threads": s})) == \
        pytest.approx(15.0)
    assert reader.read(SimpleNamespace(window={})) is None


def test_host_clock_wraps_and_restores():
    """The host-clock spans time each call under the method's name, open no
    profiler range and return its result; `restore` leaves the instance as
    it was, its class's method showing through again."""
    from bench_h100.harness import clock

    class Service:
        def preprocess(self, x):
            return x + 1

        def stage(self, chunk):
            return chunk

        def forward_staged(self, staged, chunk):
            return [staged]

    svc = Service()
    host = clock.time_service(svc)
    assert set(vars(svc)) == {"preprocess", "stage", "forward_staged"}
    with torch.autograd.profiler.record_function("outside"):
        assert svc.preprocess(1) == 2 and svc.forward_staged(3, []) == [3]
    assert [n for n, _, _ in host.records] == ["preprocess",
                                                "forward_staged"]
    host.clear()
    assert host.records == []
    host.restore()
    assert vars(svc) == {}
    assert svc.preprocess(1) == 2 and host.records == []


def test_malloc_settings_apply_and_undo():
    """Each named tunable goes to mallopt once, `undo` puts mallopt(3)'s
    defaults back, and an unknown name or a refused value raises."""
    from bench_h100.harness import malloc

    calls = []

    def mallopt(param, value):
        calls.append((param, value))
        return 1

    undo = malloc.apply({"M_MMAP_THRESHOLD": 32 << 20, "M_TOP_PAD": 1 << 28},
                        mallopt)
    assert calls == [(-3, 32 << 20), (-2, 1 << 28)]
    undo()
    assert calls[2:] == [(-3, 128 * 1024), (-2, 128 * 1024)]
    with pytest.raises(ValueError):
        malloc.apply({"M_ARENA_MAX": 1}, mallopt)
    with pytest.raises(RuntimeError):
        malloc.apply({"M_TRIM_THRESHOLD": 1}, lambda p, v: 0)
    malloc.apply({}, lambda p, v: 0)()      # nothing named: no call
