"""The port's command line (cli.py, __main__.py) against the JAX package's
on the CPU: the same subcommands, options, defaults and choices; the same
preset and overrides handed to `get_config` for each argv; the same
crops and landmarks from `preprocess` and `landmarks`; and `train` then
`infer` on its checkpoint end to end."""

import argparse
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from blindshadowremoval_tpu import cli as jax_cli
from blindshadowremoval_tpu import config as jax_config_module
from blindshadowremoval_tpu.utils import compilecache
from blindshadowremoval_tpu_torch import cli
from blindshadowremoval_tpu_torch import config as config_module
from blindshadowremoval_tpu_torch.models.weights import (
    synthetic_fan_weights,
    synthetic_sfd_weights,
)
from blindshadowremoval_tpu_torch.utils.imageio import read_png

ROOT = Path(__file__).resolve().parent.parent
SFW_FRAMES = ROOT / "tests" / "goldens" / "tf_ref" / "sfw_synth" / "*"


@pytest.fixture(autouse=True)
def two_threads():
    """Six test workers share the machine."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _subcommands(parser):
    sub = next(a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction))
    return sub.choices


def _options(parser):
    """{dest: what argparse knows of the option} of one subcommand."""
    return {a.dest: (tuple(a.option_strings), type(a).__name__, a.default,
                     None if a.choices is None else tuple(a.choices),
                     a.nargs, a.required, a.type, a.const)
            for a in parser._actions if a.dest != "help"}


def test_parser_matches_jax():
    """Every subcommand of JAX's build_parser, with the same options,
    defaults and choices; `--device` is the one option added, to each."""
    port, ref = _subcommands(cli.build_parser()), _subcommands(
        jax_cli.build_parser())
    assert list(port) == list(ref) == ["infer", "ucb", "sfw", "sfw-video",
                                       "train", "preprocess", "e2e",
                                       "landmarks"]
    for name in ref:
        got, want = _options(port[name]), _options(ref[name])
        device = got.pop("device")
        assert device[0] == ("--device",) and device[2] == "cuda"
        assert device[3] == ("cuda", "cpu")
        assert got == want, name


ARGVS = [
    ["infer", "--data", "d/*"],
    ["infer", "--data", "d/*", "--engine", "serving", "--int8-head",
     "--fold-bn", "--eval-views", "1", "--device-geometry", "--seed", "3"],
    ["infer", "--data", "d/*", "--variant", "rgb", "--img-size", "128",
     "--int8-head-scale", "-1", "--ckpt", "c"],
    ["ucb", "--data", "u/*", "--part-masks", "p"],
    ["ucb", "--data", "u/*", "--part-masks", "p", "--no-compact-ingress",
     "--variant", "tsm", "--images-per-call", "1"],
    ["ucb", "--data", "u/*", "--part-masks", "p", "--eval-views", "3",
     "--variant", "rgb", "--rgb-heuristics"],
    ["ucb", "--data", "u/*", "--part-masks", "p", "--eval-views", "2",
     "--variant", "tsm"],
    ["ucb", "--data", "u/*", "--part-masks", "p", "--eval-views", "0"],
    ["sfw", "--data", "s/*", "--int8-head", "--int8-head-scale", "2.5"],
    ["sfw-video", "--data", "s/*", "--variant", "gsc", "--export-bbox", "b"],
    ["train", "--data", "a/*", "b/*", "--val", "v/*"],
    ["train", "--data", "a/*", "--no-compact-ingress", "--no-device-darken",
     "--device-geometry", "--lr", "3e-4", "--lr-decay", "0.9",
     "--lr-decay-epochs", "2", "--batch-size", "4", "--steps-per-epoch",
     "10", "--max-epoch", "2", "--log-every", "5", "--fold-bn",
     "--int8-head"],
    ["train", "--data", "a/*", "--select-best", "--probe-data", "p/*",
     "--probe-part-masks", "m", "--no-u8-ingress", "--shadow-masks", "s"],
    ["train", "--data", "a/*", "--select-best", "--probe-data", "p/*",
     "--probe-metric", "auc"],
    ["train", "--data", "a/*", "--select-best"],
    ["e2e", "--input", "i", "--output", "o", "--int8-head", "--fold-bn",
     "--variant", "tsm", "--img-size", "128"],
    ["e2e", "--input", "i", "--output", "o", "--int8-head-scale", "3"],
]


class _Captured(Exception):
    pass


def _capture(monkeypatch, module, main, argv):
    """(return code or None, (preset, overrides) handed to get_config or
    None) of `main(argv)`, stopped at its get_config call."""
    seen = []

    def fake(preset="in_the_wild", **overrides):
        seen.append((preset, overrides))
        raise _Captured

    monkeypatch.setattr(module, "get_config", fake)
    try:
        rc = main(argv)
    except _Captured:
        rc = None
    return rc, (seen[0] if seen else None)


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: " ".join(a))
def test_main_builds_the_config_jax_builds(argv, monkeypatch):
    """The port's main hands JAX's main's preset and overrides to
    get_config (JAX's get_config captured by monkeypatch), or refuses the
    same argv with the same exit code before it."""
    monkeypatch.setattr(compilecache, "enable_persistent_cache",
                        lambda path=None: "")
    want = _capture(monkeypatch, jax_config_module, jax_cli.main, argv)
    got = _capture(monkeypatch, config_module, cli.main,
                   argv + ["--device", "cpu"])
    assert got == want
    if argv[-1] == "0" or argv[-1] == "--select-best":
        assert got[0] == 2 and got[1] is None


def test_refuses_without_a_card_unless_asked_for_the_cpu(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert cli.main(["preprocess", "--input", "i", "--output", "o"]) == 2
    assert "--device cpu" in capsys.readouterr().err


def test_help_runs_as_module_from_the_repo_root():
    out = subprocess.run(
        [sys.executable, "-m", "blindshadowremoval_tpu_torch", "--help"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    for name in ("infer", "ucb", "sfw", "sfw-video", "train", "preprocess",
                 "e2e", "landmarks"):
        assert name in out.stdout


def _photos(root):
    """Two uncropped photos with landmarks and one without (phase 14's
    generator, at its full canvas sizes)."""
    paths = chip_smoke.uncropped_photos(str(root), n=3)
    # photo 2 has no landmarks; 0 and 1 do
    assert [os.path.isfile(p[:-4] + ".npy") for p in paths] == [
        True, True, False]
    return paths


def test_preprocess_writes_jax_crops(tmp_path):
    """The same crops (within one uint8 step where the f32 crop, which
    matches JAX's to 1e-6 of its range, lies that close to an integer) and
    the same landmarks as JAX's CLI, on the same PNGs."""
    _photos(tmp_path / "in")
    args = ["preprocess", "--input", str(tmp_path / "in"), "--size", "128"]
    assert jax_cli.main(args + ["--output", str(tmp_path / "jax")]) == 0
    assert cli.main(args + ["--output", str(tmp_path / "port"),
                            "--device", "cpu"]) == 0
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) == ["00", "01"]
    for n in names:
        a = read_png(str(tmp_path / "port" / n / f"{n}.png")).astype(int)
        b = read_png(str(tmp_path / "jax" / n / f"{n}.png")).astype(int)
        assert a.shape == b.shape == (128, 128, 3)
        assert np.abs(a - b).max() <= 1 and (a != b).mean() < 1e-3
        np.testing.assert_array_equal(
            np.load(tmp_path / "port" / n / f"{n}.npy"),
            np.load(tmp_path / "jax" / n / f"{n}.npy"))


@pytest.mark.parametrize("locate", ["face box", "detector"])
def test_landmarks_match_jax_cli(locate, tmp_path):
    """`landmarks` with seeded FAN (one stack) and S3FD npz weights, on
    the CPU, against JAX's CLI on the same PNG: landmarks within 1e-4 px
    (tests/test_torch_fan.py's bar) from an explicit box.  From the
    detector's best box, which tests/test_torch_sfd.py holds within 2e-3
    px of JAX's: box coordinates moved by d move the crop's centre by at
    most 1.24 d and its side h = 200 * semiperimeter / 195 by at most
    4.1 d (box_to_center_scale), so a landmark, p * h / 64 + c - h / 2
    with p in [0, 64], by at most 1.24 d + 2.05 d < 3.3 d; the bar is
    1e-4 + 3.3 * 2e-3."""
    rng = np.random.default_rng(3)
    photo = rng.integers(0, 256, (240, 320, 3), dtype=np.uint8)
    np.savez(tmp_path / "fan.npz", **synthetic_fan_weights(0, num_modules=1))
    np.savez(tmp_path / "sfd.npz", **synthetic_sfd_weights(0))
    extra = (["--face-box", "80,40,320,280"] if locate == "face box"
             else ["--sfd-weights", str(tmp_path / "sfd.npz")])
    out = {}
    for side, main, dev in (("jax", jax_cli.main, []),
                            ("port", cli.main, ["--device", "cpu"])):
        d = tmp_path / side
        d.mkdir()
        chip_smoke.write_png(str(d / "face.png"), photo)
        rc = main(["landmarks", "--input", str(d), "--fan-weights",
                   str(tmp_path / "fan.npz")] + extra + dev)
        assert rc == 0
        out[side] = np.load(d / "face.npy")
    assert out["port"].shape == (68, 2)
    atol = 1e-4 if locate == "face box" else 1e-4 + 3.3 * 2e-3
    np.testing.assert_allclose(out["port"], out["jax"], rtol=0, atol=atol)


def test_landmarks_without_weights_needs_face_alignment(tmp_path, capsys):
    try:
        import face_alignment  # noqa: F401
        pytest.skip("face_alignment is installed")
    except ImportError:
        pass
    assert cli.main(["landmarks", "--input", str(tmp_path),
                     "--device", "cpu"]) == 2
    assert "face_alignment is not installed" in capsys.readouterr().err


def test_train_then_infer_on_the_cpu(tmp_path, monkeypatch, capsys):
    """One train step at 64 px (the CLI's n_res 6) writes a checkpoint;
    `infer` restores it through both engines, the serving one folded with
    the int8 head, and writes a result strip per sample."""
    monkeypatch.setattr(chip_smoke, "FIT_IMAGE", 160)
    monkeypatch.setattr(chip_smoke, "FIT_IDENTITIES", 3)
    monkeypatch.setattr(chip_smoke, "FIT_FRAMES", 2)
    tr, val, masks = chip_smoke.synthetic_train_tree(str(tmp_path / "data"))
    ckpt = str(tmp_path / "ckpt")
    assert cli.main(["train", "--data", tr, "--shadow-masks", masks,
                     "--img-size", "64", "--steps-per-epoch", "1",
                     "--max-epoch", "1", "--ckpt", ckpt,
                     "--device", "cpu"]) == 0
    assert os.path.isfile(os.path.join(ckpt, "1.pt"))
    for engine in (["--eval-views", "2"],
                   ["--engine", "serving", "--fold-bn", "--int8-head"]):
        out = str(tmp_path / engine[1])
        os.makedirs(out)
        os.symlink(os.path.join(ckpt, "1.pt"), os.path.join(out, "1.pt"))
        assert cli.main(["infer", "--data", str(SFW_FRAMES), "--ckpt", out,
                         "--img-size", "64", "--device", "cpu"]
                        + engine) == 0
        strip = read_png(os.path.join(out, "test", "vid0_0-result.png"))
        assert strip.shape[1] == 3 * strip.shape[0]
    printed = capsys.readouterr().out
    assert printed.count("Restore from step 1") == 2
    assert "wrote 1 result strips to" in printed
