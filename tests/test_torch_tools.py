"""The port's measurement tools (blindshadowremoval_tpu_torch/tools/) on
the CPU, at 32-128 px, n_res=2 (bench's FLOP count at n_res=6), B=1-2:
bench's inputs and forward against the repository root's bench.py, the
harness's staleness check, the FLOP count against XLA's cost analysis and
its independence from how the attention runs, the trace parser, every
tool's command line with the JAX tool's printed keys, and the int8 head's
calibration against ops/calibration.py."""

import importlib
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import chip_smoke
from blindshadowremoval_tpu.config import get_config as jax_config
from blindshadowremoval_tpu.data.dataset import Dataset as JaxDataset
from blindshadowremoval_tpu.eval import evaluators as jax_ev
from blindshadowremoval_tpu.models.folding import fold_batch_norm
from blindshadowremoval_tpu.models.generator import GSCGenerator as JaxGSC
from blindshadowremoval_tpu.models.tf_checkpoint import (
    generator_mapping as jax_generator_mapping,
    load_weights_dict,
)
from blindshadowremoval_tpu.ops import calibration as jax_calibration
from blindshadowremoval_tpu.ops.quant import int8_conv as jax_int8_conv
from blindshadowremoval_tpu.train.trainer import (
    build_generator as jax_build_generator,
)
from blindshadowremoval_tpu_torch.config import get_config
from blindshadowremoval_tpu_torch.models import build_generator
from blindshadowremoval_tpu_torch.models.tf_checkpoint import (
    VAL_SUFFIX,
    read_bundle,
)
from blindshadowremoval_tpu_torch.models.weights import (
    from_jax_variables,
    generator_mapping,
)
from blindshadowremoval_tpu_torch.ops import nonlocal_attn
from blindshadowremoval_tpu_torch.ops.calibration import head_input_bounds
from blindshadowremoval_tpu_torch.ops.nonlocal_attn import PlainRoute
from blindshadowremoval_tpu_torch.tools import (
    _timing,
    bench,
    bench_e2e,
    bench_fit,
    bench_landmarks,
    bench_serving_frontend,
    bench_train,
    bench_ucb_eval,
    calibrate_int8_head,
    parity_serving,
    roofline_infer,
)

ROOT = Path(__file__).resolve().parent.parent
BUNDLE = str(ROOT / "tests" / "goldens" / "tf_bundle" / "ckpt-1")
TOOLS = ("_timing", "bench", "bench_sweep", "roofline_infer",
         "profile_infer", "profile_train", "bench_train", "bench_fit",
         "bench_ucb_eval", "bench_serving_frontend", "bench_e2e",
         "bench_landmarks", "bench_packed_tail", "bench_int8_decoder",
         "calibrate_int8_head", "parity_serving")


def _jax_bench():
    """The repository root's bench.py (a module of its own name would
    shadow the port's tools.bench)."""
    spec = importlib.util.spec_from_file_location("jax_bench",
                                                  ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def small(monkeypatch):
    """The tools at 64 px (the train tools at 32), n_res=2, one-stack FAN."""
    for mod in (bench, bench_fit, bench_ucb_eval, bench_serving_frontend,
                bench_e2e, calibrate_int8_head, parity_serving):
        monkeypatch.setattr(mod, "SIZE", 64)
        monkeypatch.setattr(mod, "N_RES", 2)
    monkeypatch.setattr(bench_train, "SIZE", 32)
    monkeypatch.setattr(bench_train, "N_RES", 2)
    monkeypatch.setattr(bench_fit, "SIZE", 32)
    monkeypatch.setattr(bench_e2e, "FAN_MODULES", 1)
    monkeypatch.setattr(bench_landmarks, "FAN_MODULES", 1)


@pytest.fixture(scope="module")
def ucb_tree(tmp_path_factory):
    """phase 10's synthetic UCB tree, 3 images."""
    root = str(tmp_path_factory.mktemp("ucb"))
    return chip_smoke.synthetic_ucb_tree(root, n_images=3)


# ---------------------------------------------------------------- (a), (b)


@pytest.mark.parametrize("batch,size,seed", [(2, 64, 0), (3, 128, 7)])
def test_make_inputs_bit_equal_to_bench_py(batch, size, seed):
    ours = bench.make_inputs(batch, size, seed)
    theirs = _jax_bench().make_inputs(batch, size, seed)
    for a, b in zip(ours, theirs):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _psnr(a, b):
    return float(10.0 * np.log10(1.0 / np.mean(
        (np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)))


def test_timed_step_matches_bench_py_serving_forward(monkeypatch):
    """bench's generator (bf16, folded BN, bf16 egress) with the weights
    of bench.py's init_serving_variables, carried by models/weights.py, on
    bench.py's inputs: the timed step's outputs against bench.py's forward
    at 128 px, n_res=2, B=2."""
    jb = _jax_bench()
    monkeypatch.setattr(bench, "SIZE", 128)
    monkeypatch.setattr(bench, "N_RES", 2)
    gen = jb.make_gen().clone(n_res=2)
    img, uv, reg = jb.make_inputs(batch=2, size=128)
    gen, folded = jb.init_serving_variables(gen, img, uv, reg)
    # the unfolded variables init_serving_variables folded (its own init)
    base = gen.clone(int8_head=False, fold_bn=False)
    unfolded = jax.jit(base.init)(jax.random.PRNGKey(0), img[:1], uv[:1],
                                  reg[:1])
    _, rgb_ref, _, dif_ref = gen.apply(folded, img, uv, reg)
    model = bench.make_gen(state_dict=from_jax_variables(
        jax.tree.map(np.asarray, unfolded)), device="cpu")
    x = bench.make_inputs(2, 128, 0)
    with torch.inference_mode():
        rgb, dif = bench.step_outputs(model, *x)
        scalar = float(bench.step(model)(*x))
    assert rgb.dtype == torch.bfloat16 and dif.dtype == torch.bfloat16
    rgb_ref = np.asarray(rgb_ref.astype(jnp.float32))
    dif_ref = np.asarray(dif_ref.astype(jnp.float32))
    # bench.py's production bar for the bf16 serving configuration, 40 dB
    # (tests/test_torch_generator.py:test_tf_golden_in_the_wild, and the
    # card's bf16 service against the CPU's f32 in chip_smoke.py phase 5)
    assert _psnr(rgb.float().numpy(), rgb_ref) >= 40.0
    assert _psnr(dif.float().numpy(), dif_ref) >= 40.0
    ref = float(np.mean(rgb_ref) + np.mean(dif_ref))
    assert abs(scalar - ref) <= 1e-2 * max(1.0, abs(ref))


# --------------------------------------------------------------------- (c)


@pytest.mark.parametrize("planted", ["ignores its input", "not finite"])
def test_harness_rejects_a_planted_step(planted):
    x = torch.rand(2, 8)
    if planted == "ignores its input":
        def step(v):
            return torch.tensor(1.0)
    else:
        def step(v):
            return v.sum() * float("nan")
    with pytest.raises(_timing.StaleResultError):
        _timing.timed_fn(step, x, iters=3, trials=2)


def test_harness_times_a_step_that_reads_its_input():
    calls = []

    def step(v):
        calls.append(v)
        return v.sum()

    x = torch.zeros(4)
    seconds = _timing.timed_fn(step, x, iters=3, trials=2)
    assert seconds > 0.0 and _timing.timing_mode(x.device, 4) == "host"
    # one warm-up chain and two trials of 3 calls; every call's input moved
    assert len(calls) == 9
    firsts = [float(c[0]) for c in calls]
    assert len(set(firsts)) == 9
    assert firsts[4] == pytest.approx(_timing.STEP_EPS + _timing.TRIAL_EPS)


# ---------------------------------------------------------------- (d), (e)


@pytest.fixture(scope="module")
def xla_flops():
    """XLA's cost analysis of bench.py's forward in f32 at 128 px, B=2
    (GSCGenerator's defaults: n_res=6)."""
    jb = _jax_bench()
    img, uv, reg = jb.make_inputs(batch=2, size=128)
    gen = JaxGSC()
    v = jax.jit(gen.init)(jax.random.PRNGKey(0), img[:1], uv[:1], reg[:1])

    def fwd(v, i, u, r):
        _, rgb, _, dif = gen.apply(v, i, u, r)
        return jnp.mean(rgb) + jnp.mean(dif)

    ca = jax.jit(fwd).lower(v, img, uv, reg).compile().cost_analysis()
    ca = ca[0] if isinstance(ca, (list, tuple)) else ca
    return float(ca["flops"])


def _f32_model(n_res):
    return build_generator(get_config(img_size=128, n_res=n_res,
                                      compute_dtype="float32"), device="cpu")


def test_roofline_flops_match_xla_cost_analysis(xla_flops):
    work = roofline_infer.count(_f32_model(6), *bench.make_inputs(2, 128))
    assert len(work.attention_calls) == 6
    # FlopCounterMode counts convolutions and products, XLA every op: 1.07%
    # apart when measured (7.849e9 against 7.766e9)
    assert abs(work.flops / xla_flops - 1.0) <= 0.03
    assert work.bytes > 0


def _numpy_attention(theta, phi, g):
    """softmax(theta phi^T) g through numpy: no dispatch mode sees it."""
    _numpy_attention.calls += 1
    t, p, v = (x.detach().float().numpy() for x in (theta, phi, g))
    s = t @ p.transpose(0, 2, 1)
    w = np.exp(s - s.max(-1, keepdims=True))
    w /= w.sum(-1, keepdims=True)
    return torch.from_numpy(w @ v).to(g.dtype)


def test_flop_count_is_the_same_when_the_attention_is_unseen(monkeypatch):
    """The attention op's count does not depend on what runs inside it:
    the plain version (whose products a mode would see) and a numpy
    stand-in (which no mode sees) count alike, and as FlopCounterMode
    counts the plain version's products where they run op by op
    (PlainRoute)."""
    model = _f32_model(2)
    x = bench.make_inputs(2, 128)
    seen = roofline_infer.count(model, *x)
    with torch.inference_mode(), FlopCounterMode(display=False) as fc, \
            PlainRoute():
        model(*x)
    # the op's formula: the plain version's two products, 4*B*N^2*D
    b, n, d = seen.attention_calls[0][:3]
    t = torch.randn(b, n, d)
    with FlopCounterMode(display=False) as op_fc:
        torch.ops.bsr.nonlocal_attn(t, t, t)
    with FlopCounterMode(display=False) as plain_fc, PlainRoute():
        torch.ops.bsr.nonlocal_attn(t, t, t)
    assert op_fc.get_total_flops() == plain_fc.get_total_flops() == \
        4 * b * n * n * d
    _numpy_attention.calls = 0
    monkeypatch.setattr(nonlocal_attn, "nonlocal_attention_reference",
                        _numpy_attention)
    unseen = roofline_infer.count(model, *x)
    assert _numpy_attention.calls == len(seen.attention_calls) == 2
    assert unseen.flops == seen.flops == fc.get_total_flops()
    assert unseen.bytes == seen.bytes
    assert unseen.attention_calls == seen.attention_calls


def test_count_work_counts_the_training_attention_once():
    """Forward and backward under autograd: the tool's count against
    FlopCounterMode on the plain route (the plain forward's two products,
    the plain backward's five: 10*B*N^2*D)."""
    model = _f32_model(2).train()
    x = [t.requires_grad_() for t in bench.make_inputs(2, 64)]

    def step():
        out = model(*x)
        torch.autograd.grad(out[1].float().mean(),
                            list(model.parameters()), allow_unused=True)

    with _timing.count_work() as work:
        step()
    with FlopCounterMode(display=False) as fc, PlainRoute():
        step()
    kinds = [c[3] for c in work.attention_calls]
    assert kinds.count("fwd") == kinds.count("bwd") == 2
    assert work.flops == fc.get_total_flops()


# --------------------------------------------------------------------- (f)


def _trace(tmp_path, events):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


def _x(name, cat, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid,
            "ts": ts, "dur": dur}


def test_trace_parser_sums_device_kernels_once(tmp_path):
    events = [
        # nested ATen ops enclosing the launches, and a device-side range
        # enclosing the kernels: none of them is device work of its own
        _x("aten::conv2d", "cpu_op", 0.0, 100.0),
        _x("aten::convolution", "cpu_op", 1.0, 98.0),
        _x("aten::cudnn_convolution", "cpu_op", 2.0, 96.0),
        _x("block:res.0", "gpu_user_annotation", 10.0, 500.0, tid=7),
        _x("cudaLaunchKernel", "cuda_runtime", 3.0, 5.0),
        _x("sm90_xmma_fprop_implicit_gemm", "kernel", 10.0, 40.0, tid=7),
        _x("attn_fwd_bf16", "kernel", 60.0, 25.0, tid=7),
        _x("attn_fwd_bf16", "kernel", 90.0, 25.0, tid=7),
        _x("bwd_hopper_bf16", "kernel", 120.0, 60.0, tid=7),
        _x("Memcpy HtoD", "gpu_memcpy", 200.0, 10.0, tid=7),
        {"ph": "M", "name": "process_name", "pid": 1,
         "args": {"name": "python"}},
    ]
    agg, cnt, total = _timing.parse_trace(_trace(tmp_path, events))
    assert agg == {"sm90_xmma_fprop_implicit_gemm": 40.0,
                   "attn_fwd_bf16": 50.0, "bwd_hopper_bf16": 60.0,
                   "Memcpy HtoD": 10.0}
    assert cnt["attn_fwd_bf16"] == 2 and total == 160.0
    kinds = _timing.by_kind(agg, cnt)
    assert kinds["K1"] == [50.0, 2] and kinds["K2"] == [60.0, 1]
    assert kinds["convolutions"] == [40.0, 1]
    # the CPU lane: the outermost op of each thread only
    agg, cnt, total = _timing.parse_trace(_trace(tmp_path, events), "cpu")
    assert agg == {"aten::conv2d": 100.0} and total == 100.0


def test_trace_parser_raises_without_a_device_lane(tmp_path, capsys):
    path = _trace(tmp_path, [_x("aten::add", "cpu_op", 0.0, 5.0),
                             _x("cudaLaunchKernel", "cuda_runtime", 1.0, 2.0)])
    with pytest.raises(ValueError, match="refusing to report 0"):
        _timing.parse_trace(path)
    with pytest.raises(ValueError, match="refusing to report 0"):
        _timing.main([path])
    assert _timing.main([path, "--lane", "cpu"]) == 0
    assert "aten::add" in capsys.readouterr().out


def test_kernel_kinds_name_k1_and_k2():
    assert _timing.kernel_kind("attn_fwd_bf16") == "K1"
    assert _timing.kernel_kind("attn_fwd_f32") == "K1"
    for name in ("bwd_hopper_bf16", "bwd_prep_bf16", "bwd_dq_cast",
                 "bwd_f32", "bwd_dq_sum_f32"):
        assert _timing.kernel_kind(name) == "K2"
    assert _timing.kernel_kind("void at::native::elementwise_kernel") == \
        "other elementwise"


# --------------------------------------------------------------------- (g)

# the JAX tools' printed keys: JSON keys where the JAX tool prints JSON,
# else the labels of its lines
JAX_KEYS = {
    # bench.py:161-166
    "bench": ("metric", "value", "unit", "vs_baseline"),
    # tools/roofline_infer.py:86-99
    "roofline_infer": ("config", "batch", "gflops_per_face",
                       "mb_accessed_per_face",
                       "arithmetic_intensity_flop_per_byte",
                       "measured_ms_per_batch", "faces_per_sec",
                       "t_compute_ms", "t_bandwidth_ms", "bound",
                       "speed_of_light_ms", "fraction_of_speed_of_light"),
    # tools/bench_sweep.py:43-44
    "bench_sweep": ("batch", "faces_per_sec"),
    # tools/profile_infer.py:58,64,67-69; tools/trace_utils.py:76-77
    "profile_infer": ("warmup:", "traced 1 forwards; acc",
                      "total device time", "us/face", "device time:"),
    # tools/profile_train.py:87,94,98-101
    "profile_train": ("warmup loss:", "traced 1 steps; acc",
                      "batch 1 (x2 views), remat=False:", "ms/step",
                      "us/view", "device time:"),
    # tools/bench_train.py:118-131
    "bench_train": ("batch_size", "views_per_step", "compute_dtype",
                    "vgg_dtype", "remat", "s2d", "step_time_ms",
                    "steps_per_sec", "views_per_sec", "step_tflops",
                    "mfu_pct_vs_bf16_peak"),
    # tools/bench_fit.py:81-83,96-99,111-112,160-165
    "bench_fit": ("corpus:", "identities; loader workers:", "loader-only:",
                  "ms/sample", "upload-only:", "MB/batch",
                  "end-to-end fit() loop:", "ms/step at batch",
                  "decomposition per step: host parse"),
    # tools/bench_ucb_eval.py:82-83,87-89
    "bench_ucb_eval": ("bench", "views", "dtype", "compact_ingress", "host",
                       "fused", "compile_s", "per_image_s"),
    # tools/bench_serving_frontend.py:95-104
    "bench_serving_frontend": ("raw batch API   :", "dynamic frontend:",
                               "mean occupancy", "request latency : mean",
                               "p95"),
    # tools/bench_e2e.py:97-99,106-109,112-114,155-160
    "bench_e2e": ("detect:", "boxes kept", "align+crop+deshadow:",
                  "e2e composed (stage sums):", "run_dir serial: wall",
                  "run_dir overlapped: wall", "written"),
    # tools/bench_landmarks.py:121-129
    "bench_landmarks": ("FAN align (batch 1, 256x256, float32):",
                        "faces/s", "S3FD detect trunk (batch 1, 128x128, "
                        "float32):", "images/s", "S3FD host decode+NMS:"),
    # tools/bench_packed_tail.py:115,144-150
    "bench_packed_tail": ("packed-vs-direct f32 max err:", "direct bf16 ",
                          "direct bf16+int8head", "s2d-head bf16",
                          "packed bf16 ", "packed bf16+int8head",
                          "us/face"),
    # tools/bench_packed_tail.py:227-235
    "bench_packed_tail --grad": ("s2d grad-vs-direct: dloss",
                                 "packed grad-vs-direct: dloss",
                                 "dgrad(wh)", "us/face (fwd+bwd)"),
    # tools/bench_int8_decoder.py:95-96,119-122
    "bench_int8_decoder": ("tail int8-vs-bf16 rel err:",
                           "up3 bf16 + int8s head", "up3 int8s + int8s head",
                           "conv1 bf16", "conv1 int8s", "us/face"),
    # tools/calibrate_int8_head.py:76,79-80,108-109,110-111
    "calibrate_int8_head": ("head-input absmax", "observed max",
                            "suggested static bound",
                            "head output parity vs f32: dynamic",
                            "set: get_config(..., int8_head=True, "
                            "int8_head_scale="),
    # tools/parity_serving.py:174-187,190
    "parity_serving": ("wild_pred_psnr_db", "wild_mask_psnr_db",
                       "ucb_composite_psnr_db_min",
                       "ucb_composite_psnr_db_mean",
                       "ucb_detected_mask_disagree_max",
                       "ucb_metric_psnr_delta_max_db", "JSON:"),
}


def _argv(name, tmp_path, ucb):
    inputs = os.path.join(ucb, "input", "*")
    return {
        "bench": [],
        "roofline_infer": ["--batch", "2", "--iters", "1"],
        "bench_sweep": ["--batches", "2"],
        "profile_infer": ["--batch", "2", "--iters", "1", "--out",
                          str(tmp_path / "trace")],
        "profile_train": ["--batch", "1", "--iters", "1", "--compute-dtype",
                          "float32", "--vgg-dtype", "float32"],
        "bench_train": ["--batches", "1", "--steps", "1", "--compute-dtype",
                        "float32"],
        "bench_fit": ["--batch", "1", "--steps", "1", "--warm", "1",
                      "--loader-samples", "2", "--compute-dtype", "float32",
                      "--vgg-dtype", "float32"],
        "bench_ucb_eval": ["--data", inputs, "--part-mask-root", ucb,
                           "--images", "2", "--dtype", "float32"],
        "bench_serving_frontend": ["--requests", "3", "--clients", "2",
                                   "--batch-size", "2"],
        "bench_e2e": ["--images", "2", "--size", "160", "200", "--det-size",
                      "128", "--det-batch", "2", "--fan-batch", "2",
                      "--serve-batch", "2"],
        "bench_landmarks": ["--batch", "1", "--det-batch", "1", "--det-size",
                            "128", "--iters", "1", "--dtype", "float32"],
        "bench_packed_tail": ["--batch", "1", "--iters", "1"],
        "bench_packed_tail --grad": ["--batch", "1", "--iters", "1",
                                     "--grad"],
        "bench_int8_decoder": ["--batch", "1", "--iters", "1"],
        "calibrate_int8_head": ["--ckpt", BUNDLE, "--data", inputs,
                                "--images", "2"],
        "parity_serving": ["--ckpt", BUNDLE, "--data", inputs,
                           "--part-mask-root", ucb, "--ucb-images", "1",
                           "--configs", "bf16+fold+bf16egress"],
    }[name]


@pytest.mark.parametrize("name", sorted(JAX_KEYS))
def test_tool_main_on_the_cpu_prints_the_jax_keys(name, small, ucb_tree,
                                                  tmp_path, monkeypatch,
                                                  capsys):
    argv = _argv(name, tmp_path, ucb_tree)
    monkeypatch.setattr(bench, "BATCH", 2)
    monkeypatch.setattr(bench, "ITERS", 2)
    if name == "bench_fit":
        monkeypatch.setattr(chip_smoke, "FIT_IMAGE", 160)
        monkeypatch.setattr(chip_smoke, "FIT_IDENTITIES", 3)
        train, _, _ = chip_smoke.synthetic_train_tree(str(tmp_path / "t"))
        argv += ["--data", train]
    module = importlib.import_module(
        f"blindshadowremoval_tpu_torch.tools.{name.split()[0]}")
    assert module.main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for key in JAX_KEYS[name]:
        assert key in out, f"{name} printed no {key!r}"
    if name == "roofline_infer":        # one indented JSON object
        record = json.loads(out)
    else:
        record = json.loads(out.strip().splitlines()[-1].removeprefix(
            "JSON: "))
    assert record["device"] == "cpu"


def test_tools_raise_without_a_card(ucb_tree, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for name in TOOLS[1:]:
        argv = {"bench_fit": ["--data", "x/*"],
                "bench_ucb_eval": ["--data", "x/*", "--part-mask-root", "x"],
                "calibrate_int8_head": ["--data", "x/*"],
                "parity_serving": ["--data", "x/*", "--part-mask-root",
                                   "x"]}.get(name, [])
        module = importlib.import_module(
            f"blindshadowremoval_tpu_torch.tools.{name}")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            module.main(argv)


@pytest.fixture(scope="module")
def help_outputs():
    """Each tool's `--help` as `python -m`, in one process with jax, flax,
    cv2, PIL and the JAX package made unimportable."""
    code = f"""
import contextlib, io, json, runpy, sys
for name in ("jax", "flax", "cv2", "PIL", "blindshadowremoval_tpu"):
    sys.modules[name] = None
out = {{}}
for tool in {list(TOOLS)!r}:
    name = "blindshadowremoval_tpu_torch.tools." + tool
    sys.argv = [name, "--help"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        try:
            runpy.run_module(name, run_name="__main__")
            code = None
        except SystemExit as e:
            code = e.code
    out[tool] = [code, buf.getvalue()]
print(json.dumps(out))
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("name", TOOLS)
def test_tool_help_runs_as_module_without_jax(name, help_outputs):
    code, text = help_outputs[name]
    assert code == 0
    assert f"python -m blindshadowremoval_tpu_torch.tools.{name}" in text


def test_bench_train_help_names_the_dropped_xla_flags(capsys):
    with pytest.raises(SystemExit):
        bench_train.main(["--help"])
    assert "--no-donate" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        bench_train.main(["--no-donate", "--device", "cpu"])


# --------------------------------------------------------------------- (h)


def test_calibrate_bounds_are_ops_calibration_on_the_same_activations(
        small, ucb_tree):
    """The tool's checkpoint bounds are ops/calibration.py's on the weights
    it restored, and its per-image abs-max is that of the head's own input
    on those weights and images (the statistic those bounds model)."""
    data = os.path.join(ucb_tree, "input", "*")
    result = calibrate_int8_head.calibrate(BUNDLE, data, images=2,
                                           device="cpu")
    cfg = get_config("ucb", img_size=64, n_res=2, data_dirs_test=(data,),
                     eval_views=1, compute_dtype="float32")
    sd = calibrate_int8_head.restore_generator(BUNDLE, cfg)
    assert tuple(result["checkpoint_bounds"]) == head_input_bounds(sd)
    gen = build_generator(cfg, sd, "cpu")
    heads = []
    gen.head.register_forward_pre_hook(
        lambda mod, args: heads.append(float(args[0].abs().max())))
    from blindshadowremoval_tpu_torch.data.dataset import Dataset
    for _, (batch, _, _) in zip(range(2), Dataset(cfg, "test")):
        with torch.inference_mode():
            gen(*(torch.from_numpy(np.ascontiguousarray(batch[k]))
                  for k in ("img", "uv", "reg")))
    assert result["absmax"] == heads
    assert result["suggested_bound"] == pytest.approx(1.25 * max(heads))
    assert result["channels"] == len(head_input_bounds(sd))


def test_restore_generator_takes_the_bundle_layers_over_the_seed():
    cfg = get_config("ucb", img_size=64, n_res=2, compute_dtype="float32")
    sd = calibrate_int8_head.restore_generator(BUNDLE, cfg)
    from blindshadowremoval_tpu_torch.models.tf_checkpoint import (
        load_tf_checkpoint,
    )
    from blindshadowremoval_tpu_torch.models.weights import generator_mapping
    held = [e for e in generator_mapping("gsc", 2)
            if e[1].startswith(("generator/conv1/", "generator/conv2/",
                                "generator/conv3/", "generator/up3/"))]
    for k, v in load_tf_checkpoint(BUNDLE, held).items():
        assert torch.equal(sd[k], v), k
    with pytest.raises(ValueError, match="no generator tensor"):
        calibrate_int8_head.restore_generator(
            str(ROOT / "tests" / "goldens" / "tf_bundle" / "many-1"), cfg)


def test_roofline_plain_route_counts_the_same(monkeypatch, small):
    """chip_smoke.py phase 18's route check, on the CPU: FlopCounterMode
    alone on the plain route against roofline_infer's count."""
    plain = chip_smoke.roofline_plain_flops("cpu")
    model = bench.make_gen(device="cpu")
    counted = roofline_infer.count(model, *bench.make_inputs(2, 64)).flops
    assert counted == plain


@pytest.mark.parametrize("losses,stale", [
    ([0.5, 0.4, 0.45], False),
    ([0.5, 0.5], True),                 # the first step repeats the warm-up
    ([0.5, 0.4, 0.4], True),            # a later step repeats its own
    ([0.5, float("nan")], True),
])
def test_bench_train_loss_check(losses, stale):
    if stale:
        with pytest.raises(_timing.StaleResultError):
            bench_train.check_losses(losses)
    else:
        bench_train.check_losses(losses)


def test_bench_train_rejects_a_step_that_leaves_its_state(monkeypatch):
    """A train step that returns its state as it was repeats its loss:
    bench_config raises, whatever the number of timed steps."""
    class Frozen:
        def train_step(self, state, batch, gen):
            loss = batch["gt"].mean() * 0.0 + 0.25
            return state, {"recon_c": loss}, None

    monkeypatch.setattr(bench_train, "SIZE", 8)
    monkeypatch.setattr(bench_train, "trainer_for",
                        lambda *a, **k: (Frozen(), {}))
    for steps in (1, 3):
        with pytest.raises(_timing.StaleResultError):
            bench_train.bench_config(1, steps, "float32", "float32",
                                     device="cpu")


# --------------------------------- calibrate and parity against the JAX side

JAX_SIZE = 64
JAX_N_RES = 2


@pytest.fixture(scope="module")
def bundle_variables():
    """The JAX GSCGenerator's variables at 64 px, n_res=2: its seed-0 init
    with every generator tensor of the fixture bundle restored over it
    by the JAX package's bridge (`load_weights_dict`), as numpy."""
    cfg = jax_config("ucb", img_size=JAX_SIZE, n_res=JAX_N_RES,
                     compute_dtype="float32")
    z = np.zeros((1, JAX_SIZE, JAX_SIZE, 3), np.float32)
    v = jax.jit(jax_build_generator(cfg).init)(
        jax.random.PRNGKey(0), z, z,
        np.zeros((1, JAX_SIZE, JAX_SIZE, 6), np.float32))
    bundle = read_bundle(BUNDLE)
    mapping = [e for e in jax_generator_mapping(n_res=JAX_N_RES)
               if e[1] + VAL_SUFFIX in bundle]
    assert mapping
    weights = {e[1]: bundle[e[1] + VAL_SUFFIX] for e in mapping}
    return jax.tree.map(np.asarray, load_weights_dict(weights, v, mapping))


@pytest.fixture
def jax_restored(bundle_variables, monkeypatch, small):
    """The tools restore `bundle_variables` (carried by models/weights.py)
    where they would read the bundle over their own seed-0 draw; the
    bundle's own tensors are the same either way."""
    sd = from_jax_variables(bundle_variables)
    cfg = get_config("ucb", img_size=JAX_SIZE, n_res=JAX_N_RES,
                     compute_dtype="float32")
    own = calibrate_int8_head.restore_generator(BUNDLE, cfg)
    held = [k for k in own if not torch.equal(own[k], sd[k])]
    bundle = read_bundle(BUNDLE)
    bundle_keys = {k for k, tf, *_ in generator_mapping("gsc", JAX_N_RES)
                   if tf + VAL_SUFFIX in bundle}
    # only the layers the bundle lacks differ (the two packages' seed-0
    # draws), never one it holds
    assert held and not set(held) & bundle_keys
    for mod in (calibrate_int8_head, parity_serving):
        monkeypatch.setattr(mod, "restore_generator", lambda ckpt, cfg: sd)
    return sd


def _jax_ucb_config(data, **kw):
    return jax_config("ucb", img_size=JAX_SIZE, n_res=JAX_N_RES,
                      data_dirs_test=(data,), compute_dtype="float32", **kw)


def test_calibrate_matches_the_jax_tool(jax_restored, bundle_variables,
                                        ucb_tree):
    """calibrate_int8_head against the JAX tool's computation
    (tools/calibrate_int8_head.py:56-111) on the same weights and images:
    the head input captured at up3 (per-image abs-max within 1e-5
    relative, f32 against f32), ops/calibration.py's bounds (numpy on the
    same f32 BatchNorm parameters: exact), and the int8 PSNRs (within
    0.05 dB)."""
    data = os.path.join(ucb_tree, "input", "*")
    result = calibrate_int8_head.calibrate(BUNDLE, data, images=2,
                                           device="cpu")
    cfg = _jax_ucb_config(data, eval_views=1)
    import dataclasses
    gen = jax_build_generator(dataclasses.replace(
        cfg, fold_bn=False, egress_dtype="float32"))

    @jax.jit
    def head_input(v, img, uv, reg):
        _, inter = gen.apply(v, img, uv, reg, capture_intermediates=lambda
                             m, _: m.name == "up3")
        return inter["intermediates"]["up3"]["__call__"][0]

    acts = [np.asarray(head_input(bundle_variables, batch["img"],
                                  batch["uv"], batch["reg"]))
            for _, (batch, _, _) in zip(range(2),
                                        JaxDataset(cfg, "test"))]
    maxes = [float(np.abs(a).max()) for a in acts]
    np.testing.assert_allclose(result["absmax"], maxes, rtol=1e-5)
    assert result["suggested_bound"] == pytest.approx(1.25 * max(maxes),
                                                      rel=1e-5)
    assert tuple(result["checkpoint_bounds"]) == \
        jax_calibration.head_input_bounds(bundle_variables)
    kernel = bundle_variables["params"]["head"]["Conv_0"]["kernel"]
    bias = bundle_variables["params"]["head"]["Conv_0"]["bias"]
    bound = 1.25 * max(maxes)
    f32, dyn, stat = [], [], []
    for y in acts:
        f32.append(np.asarray(jax.lax.conv_general_dilated(
            y, kernel, (1, 1), "SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC")) + bias))
        dyn.append(np.asarray(jax_int8_conv(y, kernel, bias)))
        stat.append(np.asarray(jax_int8_conv(y, kernel, bias,
                                             static_scale=float(bound))))
    f32, dyn, stat = (np.concatenate(x) for x in (f32, dyn, stat))
    assert result["psnr_dynamic_db"] == pytest.approx(
        calibrate_int8_head.psnr(f32, dyn), abs=0.05)
    assert result["psnr_static_db"] == pytest.approx(
        calibrate_int8_head.psnr(f32, stat), abs=0.05)


def _jax_serve(variables, data, root, configs, tmp_path):
    """tools/parity_serving.py:120-156's loop on the JAX package, with the
    data and part masks given (the JAX tool reads the reference's)."""
    import dataclasses
    base = _jax_ucb_config(data, part_mask_root=root,
                           checkpoint_dir=str(tmp_path), fold_bn=False,
                           egress_dtype="float32", int8_head=False)
    ev0 = jax_ev.UCBEvaluator(base, variables)
    batches = [(batch, box, name, ev0._load_part_masks(root, i,
                                                       sample_name=name))
               for i, (batch, box, name) in zip(range(1),
                                                JaxDataset(base, "test"))]
    wild_cfg = jax_config(
        "in_the_wild", img_size=JAX_SIZE, n_res=JAX_N_RES,
        data_dirs_test=(data,), checkpoint_dir=str(tmp_path),
        compute_dtype="float32", fold_bn=False, egress_dtype="float32",
        int8_head=False, eval_views=1)
    wild = next(iter(JaxDataset(wild_cfg, "test")))
    results = {}
    for cname, overrides in configs.items():
        overrides = dict(overrides)
        precision = overrides.pop("precision", "default")
        cfg = jax_calibration.calibrate_config(
            dataclasses.replace(base, **overrides), variables)
        v = fold_batch_norm(variables) if cfg.fold_bn else variables
        with jax.default_matmul_precision(precision):
            ev = jax_ev.UCBEvaluator(cfg, v)
            ucb_out = [ev.run_one_fused(b, box, name, parts)
                       for b, box, name, parts in batches]
            wout = jax_ev.InTheWildEvaluator(
                dataclasses.replace(wild_cfg, **overrides), v).run_one(*wild)
        results[cname] = {"ucb": ucb_out, "wild": wout}
    return results


def test_parity_serving_matches_the_jax_tool(jax_restored, bundle_variables,
                                             ucb_tree, tmp_path):
    """parity_serving's f32 reference and its bf16 serving configuration
    against the JAX tool's loop on the same weights, image and masks: each
    configuration's final outputs against the JAX package's (f32: the
    evaluators' parity bars of tests/test_torch_eval_ucb.py and
    tests/test_torch_evaluators.py; bf16: bench's 40 dB bar, as two bf16
    programs round apart), and the tool's report against the report of
    the JAX results (the detected mask and the PSNR metric within those
    bars; the final-output PSNRs within 3 dB, as each side's own bf16
    rounding moves them)."""
    configs = {k: parity_serving.CONFIGS[k]
               for k in ("f32", "bf16+fold+bf16egress")}
    data = os.path.join(ucb_tree, "input", "*")
    ours = parity_serving.serve_configs(BUNDLE, data, ucb_tree, 1, configs,
                                        device="cpu")
    theirs = _jax_serve(bundle_variables, data, ucb_tree, configs, tmp_path)
    for cname in configs:
        a, b = ours[cname], theirs[cname]
        if cname == "f32":
            np.testing.assert_allclose(a["wild"]["pred"], b["wild"]["pred"],
                                       atol=1e-4)
            np.testing.assert_allclose(a["wild"]["mask_pred"],
                                       b["wild"]["mask_pred"], atol=1e-4)
            for u, v in zip(a["ucb"], b["ucb"]):
                assert np.mean(u["detected"] != v["detected"]) <= 1e-3
                assert abs(u["psnr"] - v["psnr"]) <= 0.01
        else:
            psnr = parity_serving.psnr       # 99 dB where identical
            assert psnr(a["wild"]["pred"], b["wild"]["pred"]) >= 40.0
            for u, v in zip(a["ucb"], b["ucb"]):
                assert psnr(u["pred"], v["pred"]) >= 40.0
    got = parity_serving.report(ours)["bf16+fold+bf16egress"]
    want = parity_serving.report(theirs)["bf16+fold+bf16egress"]
    assert set(got) == set(want)
    for key in ("wild_pred_psnr_db", "wild_mask_psnr_db",
                "ucb_composite_psnr_db_min", "ucb_composite_psnr_db_mean"):
        assert abs(got[key] - want[key]) <= 3.0, (key, got, want)
    assert abs(got["ucb_detected_mask_disagree_max"]
               - want["ucb_detected_mask_disagree_max"]) <= 1e-3
