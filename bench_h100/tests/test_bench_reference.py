"""The plain reference against the program's plain CPU route at a tiny size
(64 px, n_res 2), and the comparison that decides `correct` shown to
fail: a run of each cell at a tiny size on the CPU (the harness's look for
a card skipped) comes out correct, and comes out not correct with the
control in the program's place or with a fault planted in the timed path.
"""

from __future__ import annotations

import copy
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from bench_h100.harness import cells, serve
from bench_h100.reference import generator as ref
from bench_h100.reference import geometry as ref_geo

ROOT = Path(__file__).resolve().parents[2]
SEED = 2 ** 31 + 5
SIZE, N_RES = 64, 2


def _run_module():
    spec = importlib.util.spec_from_file_location(
        "bench_run", ROOT / "bench_h100" / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tiny(name: str):
    """The cell at 64 px with 2 residual blocks, a pool of 4 small photos
    and batches of 4, on the CPU: the same code, a size a test can hold."""
    cell = cells.load(name)
    cell.config = dict(cell.config, img_size=SIZE, n_res=N_RES)
    cell.traffic = copy.deepcopy(cell.traffic)
    if "pool" in cell.traffic:
        cell.traffic["pool"].update(count=4, sizes=[[160, 160], [180, 320]],
                                    face_px=[300, 400], margin=5)
        cell.traffic.update(batch_size=4)
    if "requests_per_call" in cell.traffic:
        cell.traffic.update(requests_per_call=8)
    if "rate_per_s" in cell.traffic:
        # batches that fill within their delay, so a fault in a batch's
        # second half meets live requests
        cell.traffic.update(rate_per_s=12.0, max_delay_ms=500.0)
    if "frames" in cell.traffic:
        cell.traffic.update(frames=4, clips=2)
    return cell


@pytest.fixture(autouse=True)
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(before)


CELL_OF = {"gsc": "gsc-serve-batch", "tsm": "tsm-video-f10"}


@pytest.mark.parametrize("variant", ["gsc", "tsm"])
def test_generator_matches_the_programs_plain_route(variant):
    from blindshadowremoval_tpu_torch.config import get_config
    from blindshadowremoval_tpu_torch.models import build_generator

    cfg = get_config("in_the_wild", img_size=SIZE, n_res=N_RES,
                     variant=variant, compute_dtype="float32")
    sd = serve.seeded_weights(_tiny(CELL_OF[variant]).config, cfg, SEED,
                              "cpu")
    gen = build_generator(cfg, sd, "cpu")
    g = torch.Generator().manual_seed(0)
    img = torch.rand(4, SIZE, SIZE, 3, generator=g)
    uv = torch.rand(4, SIZE, SIZE, 3, generator=g)
    reg = (torch.rand(4, SIZE, SIZE, 6, generator=g) - 0.5) * 0.05
    with torch.no_grad():
        if variant == "tsm":
            theirs = gen(img, uv, reg, frame=4, share=True)
            ours = ref.generator(ref.Net(sd), img, uv, N_RES, reg, 4)
        else:
            theirs = gen(img, uv)
            ours = ref.generator(ref.Net(sd), img, uv, N_RES)
    for a, b in zip(theirs, ours):
        assert torch.allclose(a, b, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("name", ["gsc-serve-batch", "tsm-video-f10"])
def test_a_width_the_program_narrows_fails_setup(name, monkeypatch):
    """The weights follow the configuration file's widths, not the
    program's: a program whose attention projections are narrowed from
    128 to 64 is refused at set-up, before any window."""
    from blindshadowremoval_tpu_torch import models

    original = models.new_generator

    def narrowed(cfg):
        gen = original(cfg)
        for blk in gen.res:
            for m in ("theta", "phi"):
                setattr(blk.non_local, m, torch.nn.Conv2d(
                    getattr(blk.non_local, m).in_channels, 64, 1))
        return gen

    monkeypatch.setattr(models, "new_generator", narrowed)
    with pytest.raises(RuntimeError, match="published widths"):
        _execute(_tiny(name))


def test_geometry_matches_the_programs():
    from blindshadowremoval_tpu_torch.data.dataset import (
        _geometry_primitives,
    )
    from blindshadowremoval_tpu_torch.geometry.crop import (
        face_crop_and_resize,
    )
    from blindshadowremoval_tpu_torch.geometry.triangulation import (
        device_geometry_maps,
    )
    from bench_h100.harness import inputs

    photos, lms = inputs.photo_pool(SEED, 3, [[300, 400]], [300, 400], 5,
                                    1.5, "cpu")
    crops, norms, views = [], [], []
    for p, lm in zip(photos, lms):
        crop, norm = ref_geo.face_crop(p, lm, SIZE)
        theirs, lm_t, _, _ = face_crop_and_resize(p, lm, SIZE)
        assert np.allclose(crop, theirs, atol=1e-5)
        assert np.allclose(norm, lm_t, atol=1e-6)
        crops.append(crop)
        norms.append(norm)
        views.append(_geometry_primitives(lm_t))
    ours = ref_geo.geometry_maps(norms, SIZE, "cpu")
    keys = ("lm", "face_pts", "uv_tris", "face_tris", "reg_tris")
    theirs = device_geometry_maps(*(torch.from_numpy(np.stack(
        [v[k] for v in views])) for k in keys), SIZE)
    for k in ("uv", "reg", "face"):
        assert torch.allclose(ours[k], theirs[k], atol=1e-6), k


def _execute(cell, monkeypatch=None):
    run = _run_module()
    return run.execute(cell, SEED, 1.5, False, torch.device("cpu"))


CELLS = ["gsc-serve-batch", "gsc-serve-open-half", "tsm-video-f10"]


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    result = _execute(_tiny(name))
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert list(result)[-3:] == ["notes", "checks", "unread"]


def test_open_loop_times_the_frontend_and_release_unwraps():
    """The open-loop driver sets the mix's malloc tunables, times the
    service's three calls from outside in an untraced window, prints each
    batch's collector, hand-off and forward quantiles and the busy shares
    in the result's notes, and takes its wrappers and tunables off in
    `release`."""
    cell = _tiny("gsc-serve-open-half")
    run = _run_module().Run(cell, SEED, 1.0, False, torch.device("cpu"))
    cell.driver.setup(run)
    svc = run.state["svc"]
    assert {"preprocess", "stage", "forward_staged"} <= set(vars(svc))
    assert callable(run.state["malloc"])   # glibc took the mix's tunables
    run.window = cell.driver.window(run, 1.0)
    cell.driver.release(run)
    assert not {"preprocess", "stage", "forward_staged"} & set(vars(svc))
    assert "malloc" not in run.state
    threads, notes = run.window["threads"], run.window["notes"]
    assert len(threads["collector"]) == len(threads["forward"]) == \
        len(threads["handoff"]) == run.window["batches"] > 0
    assert 0 < threads["collector_busy"] < 1
    assert (threads["handoff"] >= 0).all()
    for what in ("submitter lateness ms", "collector busy share",
                 "collector ms a batch", "hand-off wait ms a batch",
                 "forward ms a batch"):
        assert any(n.startswith(what) for n in notes), what


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    """The reference a precision lower than the configuration's, in the
    program's place, fails one of the cell's numbers."""
    cell = _tiny(name)
    run = _run_module().Run(cell, SEED, 1.0, False, torch.device("cpu"))
    cell.driver.setup(run)
    run.window = cell.driver.window(run, 1.0)
    cell.driver.release(run)
    readings = cell.driver.control(run)
    assert any(v > lim for _, v, lim in readings), readings


def _identity(self, gen, staged):
    """The forward returns its input unchanged."""
    from blindshadowremoval_tpu_torch.ops.image import dequantize

    img = dequantize(staged[0])
    rgb = torch.round(img.clamp(0, 1) * 255).to(torch.uint8)
    return rgb, torch.zeros(img.shape[:-1] + (1,), dtype=torch.float16)


def _half_batch(original):
    """Half the batch computed; its other half answered by the first."""
    def forward(self, gen, staged):
        rgb, dif = original(self, gen, staged)
        h = rgb.shape[0] // 2
        return (torch.cat([rgb[:h], rgb[:rgb.shape[0] - h]]),
                torch.cat([dif[:h], dif[:dif.shape[0] - h]]))
    return forward


def _altered(original):
    """The first answer of every batch altered where it is produced."""
    def forward(self, gen, staged):
        rgb, dif = original(self, gen, staged)
        rgb, dif = rgb.clone(), dif.clone()
        rgb[0] = 255 - rgb[0]
        dif[0] = dif[0] + 0.25
        return rgb, dif
    return forward


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
@pytest.mark.parametrize("name", ["gsc-serve-batch", "gsc-serve-open-half"])
def test_served_faults_are_not_correct(name, fault, monkeypatch):
    from blindshadowremoval_tpu_torch.eval.serving import ShadowRemovalService

    original = ShadowRemovalService._forward_on
    planted = {"unchanged": _identity, "half_batch": _half_batch(original),
               "altered": _altered(original)}[fault]
    monkeypatch.setattr(ShadowRemovalService, "_forward_on", planted)
    result = _execute(_tiny(name))
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
def test_video_faults_are_not_correct(fault, monkeypatch):
    from blindshadowremoval_tpu_torch.eval.evaluators import Evaluator

    original = Evaluator._apply_gen

    def planted(self, img, uv, reg, frame, share):
        gs, rgb, mask22, dif = original(self, img, uv, reg, frame, share)
        if fault == "unchanged":
            return gs, img, mask22, torch.zeros_like(dif)
        if fault == "half_batch":
            h = rgb.shape[0] // 2
            return gs, torch.cat([rgb[:h], rgb[:h]]), mask22, \
                torch.cat([dif[:h], dif[:h]])
        rgb = rgb.clone()
        rgb[0] = 1.0 - rgb[0]
        return gs, rgb, mask22, dif

    monkeypatch.setattr(Evaluator, "_apply_gen", planted)
    result = _execute(_tiny("tsm-video-f10"))
    assert not result["correct"], result["checks"]


def _drop_largest_triangle(original):
    """The rasterizer with each view's largest triangle left out: a local
    fault that moves a few hundredths of an answer's values."""
    def rasterize(pts, tris, vals, size):
        tris = tris.clone()
        view = torch.arange(tris.shape[0])[:, None]
        t = tris.clamp(min=0).long()
        a, b, c = (pts.float()[view, t[..., i]] for i in range(3))
        area = ((b - a)[..., 0] * (c - a)[..., 1]
                - (b - a)[..., 1] * (c - a)[..., 0]).abs()
        area[(tris < 0).any(-1)] = -1.0
        tris[torch.arange(tris.shape[0]), area.argmax(1)] = -1
        return original(pts, tris, vals, size)
    return rasterize


@pytest.mark.parametrize("name", CELLS)
def test_a_dropped_triangle_is_not_correct(name, monkeypatch):
    """One triangle a view left out of the device geometry maps changes
    under a tenth of an answer's values, which the trimmed means leave
    out; the share of values outside the reference's gate envelope (or,
    in the video cell, the face region's untrimmed gap) sees it."""
    from blindshadowremoval_tpu_torch.geometry import triangulation

    monkeypatch.setattr(triangulation, "rasterize_linear",
                        _drop_largest_triangle(
                            triangulation.rasterize_linear))
    result = _execute(_tiny(name))
    assert not result["correct"], result["checks"]
