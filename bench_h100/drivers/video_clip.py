"""SFW video: one clip of `frames` aligned faces a call through the
program's `SFWVideoEvaluator.forward(clip, frame=frames)`, the clip one
group of the TSM ShareLayer, with the geometry rasterized on the device
(the command line's `sfw-video --device-geometry`, with its uint16
ingress).  The clips cycle through a seeded pool; the Delaunay topologies
of each frame are the benchmark's, as the data parser would ship them.
The result strips are not written.

Window: clips back to back until `seconds` have passed; it closes when the
clip in flight returns, and `faces_per_s` is every frame returned over the
whole window.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from bench_h100.harness import inputs, serve
from bench_h100.harness.cells import HERE
from bench_h100.harness import compare as cmp
from bench_h100.reference import serve as ref_serve
from bench_h100.reference.geometry import triangles
from bench_h100.reference.landmarks import ANCHOR_POINTS, forehead_points

WORK = HERE / "_work"


def _views(clip: dict) -> dict:
    """The batch the evaluator takes: the uint16 frames, the landmarks,
    the forehead-extended points and the three Delaunay topologies."""
    lms = clip["lm"]
    face_pts = [np.concatenate([lm, forehead_points(lm, 0.8)]) for lm in lms]

    def tris(pts):
        return np.stack([triangles(p) for p in pts]).astype(np.int32)

    return {"img": clip["img"], "lm": lms,
            "face_pts": np.stack(face_pts).astype(np.float32),
            "uv_tris": tris(lms), "face_tris": tris(face_pts),
            "reg_tris": tris([np.concatenate([lm, ANCHOR_POINTS])
                              for lm in lms])}


def setup(run) -> None:
    from blindshadowremoval_tpu_torch.eval.evaluators import SFWVideoEvaluator

    config, traffic = run.cell.config, run.cell.traffic
    cfg = serve.program_config(config, "video",
                               checkpoint_dir=str(WORK / "checkpoints"),
                               device_geometry=True)
    sd = serve.seeded_weights(config, cfg, run.seed, run.device)
    ev = SFWVideoEvaluator(cfg, sd, device=run.device)
    clips = inputs.video_clips(run.seed, traffic["clips"], traffic["frames"],
                               config["img_size"], traffic["drift"],
                               traffic["jitter"], run.device)
    for c in clips:
        c["img"] = np.rint(np.clip(c["img"], 0.0, 1.0) * 65535.0).astype(
            np.uint16)
    batches = [_views(c) for c in clips]
    run.state.update(ev=ev, sd=sd, clips=clips, batches=batches)
    ev.forward(batches[0], frame=traffic["frames"])


def install_spans(run, spans) -> None:
    from blindshadowremoval_tpu_torch.eval import evaluators

    ev = run.state["ev"]
    spans.wrap(ev, "forward", "forward")
    spans.wrap(evaluators, "device_geometry_maps", "geometry")
    spans.wrap(ev.gen, "forward", "generator")
    spans.wrap(evaluators, "_host", "fetch")


def release(run) -> None:
    run.state.pop("ev", None)


def window(run, seconds: float) -> dict:
    frames = run.cell.traffic["frames"]
    ev, batches = run.state["ev"], run.state["batches"]
    answers, calls = [], 0
    t0 = time.perf_counter()
    while True:
        k = calls % len(batches)
        _, rgb, _, dif, face = ev.forward(batches[k], frame=frames)
        answers.append((k, rgb, dif, face))
        calls += 1
        if time.perf_counter() - t0 >= seconds:
            break
    elapsed = time.perf_counter() - t0
    run.state["answers"] = answers
    return {"window_s": elapsed, "attempted": calls * frames,
            "failed": 0, "units": calls * frames,
            "metrics": {"faces_per_s": calls * frames / elapsed}}


def flops_per_unit(run) -> int:
    """The TSM generator's FLOPs a frame, counted on the reference over a
    whole clip."""
    from bench_h100.harness import work
    from bench_h100.reference import generator as g

    config, frames = run.cell.config, run.cell.traffic["frames"]
    s = config["img_size"]
    x = torch.zeros((frames, s, s, 3), device=run.device)
    reg = torch.zeros((frames, s, s, 6), device=run.device)
    net = g.Net(run.state["sd"])
    return work.count_flops(lambda: g.generator(
        net, x, x, config["n_res"], reg, frames)) // frames


def _reference(run, control: bool, deltas: tuple = (cmp.DELTA,)) -> list:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return ref_serve.video_answers(
        run.state["clips"], run.state["sd"], run.cell.config["n_res"],
        run.device,
        serve.precision(run.cell.config, "video") if control else None,
        gates=cmp.gates(()) if control else cmp.gates(deltas))


# the numbers compared: (output, statistic); the worst frame's each.  The
# RGB output's trimmed mean gap is read, not compared: its control reads
# under three times the program (PERF.md)
CHECKED = (("rgb", "far"), ("face", "mae"))


def _compare(run, answers, ref: list, deltas: tuple = (cmp.DELTA,),
             look: bool = False) -> list:
    """The worst frame's readings (harness/compare.py) of the RGB output
    (the share of values more than TAU outside the gate envelope) and of
    the face region (mean gap), each against its limit.  Every reading of
    the RGB output, the gated shadow map and the face region is kept in
    `run.state["look"]`: the shadow map, the RGB output's gray less the
    input's gray in the f32 egress, gated by the face, holds no limit of
    its own (PERF.md)."""
    limits = run.cell.limits["limits"]
    taus = cmp.grid(look)[1]
    look_ = {}
    for j, name in enumerate(("rgb", "mask", "face")):
        got = [f for a in answers for f in a[1 + j]]
        frames = [len(a[1 + j]) for a in answers]
        if name == "face":          # one map: no gate acts on it
            want = [f for a in answers for f in ref[a[0]][j]]
        else:
            want = [f for a in answers for f in ref[a[0]][j][0]]
        mae, tmae = cmp.gaps(got, want, run.device)
        look_[f"{name}_mae_worst"] = float(mae.max())
        look_[f"{name}_tmae_worst"] = float(tmae.max())
        if name == "face":
            continue
        for d in deltas:
            lo, hi = [], []
            for a, n in zip(answers, frames):
                lo_c, hi_c = cmp.envelope(ref[a[0]][j], d, deltas)
                lo += list(lo_c[:n])
                hi += list(hi_c[:n])
            far = cmp.far_shares(got, lo, hi, run.device, taus)
            for k, t in enumerate(taus):
                look_[f"{name}_far_worst@d{d}t{t}"] = float(far[:, k].max())
        look_[f"{name}_far_worst"] = look_[
            f"{name}_far_worst@d{cmp.DELTA}t{cmp.TAU}"]
    run.state["look"] = look_
    return [(f"{n}_{s}_worst", look_[f"{n}_{s}_worst"],
             limits[f"{n}_{s}_worst"]) for n, s in CHECKED]


def check(run, look: bool = False) -> list:
    """Every frame of the window: its RGB output, its shadow map gated by
    its face region (as `SFWVideoEvaluator.run_one` gates it), its face
    region."""
    deltas = cmp.grid(look)[0]
    answers = [(k, rgb, dif * face, face)
               for k, rgb, dif, face in run.state["answers"]]
    return _compare(run, answers, _reference(run, False, deltas), deltas,
                    look)


def control(run, look: bool = False) -> list:
    deltas = cmp.grid(look)[0]
    ctl = _reference(run, True)
    answers = [(k, rgb[0], mask[0], face) for k, (rgb, mask, face)
               in enumerate(ctl)]
    return _compare(run, answers, _reference(run, False, deltas), deltas,
                    look)
