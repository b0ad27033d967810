"""The port over several processes (parallel/), on the CPU: 2 and 4 gloo
ranks, each a process running this file as a script, against the JAX
package and the port's own one-process paths.

The ranks of both worlds start together, run every case below, write
their results and leave the process group; the tests read the results.

* The helpers: `host_local_batch`, `global_mesh` and its process groups,
  `make_global_array`, the errors for a wrong shape.
* The collective ShareLayer, frames over the ranks of the "frame" axis,
  against the local ShareLayer (torch and JAX) and its gradient; then
  `TSMGenerator(axis_name="frame")` with frame=4 over the ranks against
  the local forward.
* The sharded GAN train step, GSC over a (n, 1) mesh and TSM over
  (n / 2, 2), 8 views at 32 px, n_res=2, f32, randomness pinned as in
  tests/test_torch_train_step.py (a fixed compositor output, which differs
  from view to view, no saturation jitter, no mirror swap, the TSM gate
  on), both sides from one seeded state, against JAX's pinned one-device
  step at tests/test_sharding.py:203-220's bars; losses and state bitwise
  equal across the ranks; the val step.
* The step's own randomness: the sharded step on the device-darkening
  wire against the one-process step on the whole batch, same seed.
* Three planted faults on 2 ranks, each of which the bars must reject:
  per-rank BatchNorm moments, per-rank loss denominators, per-rank draws.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
S = 32
VIEWS = 8                    # 4 samples of 2 mirrored views
CFG = dict(img_size=S, n_res=2, batch_size=VIEWS // 2,
           compute_dtype="float32", vgg_dtype="float32")
WORLDS = (2, 4)
FRAMES = 4                   # TSM frames a group, split over the ranks
GROUPS = 2
# tests/test_sharding.py:203-220: the JAX step sharded against one device
LOSS_TOL = dict(rtol=2e-4, atol=2e-4)
STATE_TOL = dict(rtol=5e-4, atol=2e-4)
# Adam's first moments too (0.1 x the step's gradients; after one step
# every parameter moves by about +-lr, so the parameters alone hold the
# gradients loosely): relative Frobenius error per tensor.  The step's own
# sensitivity at 8 views sets the limit: the one-process port step on the
# batch times 1 + 1e-6 noise moves them by up to 1.8e-3 (pinned) and 9.9e-3
# (the device-darkening wire, unpinned) on the CPU
# (test_moment_limit_sits_above_the_steps_own_noise prints both), so GSC
# takes chip_smoke.py's CHECK_MOMENT_RTOL, 3e-2, and TSM with the
# ShareLayer on tests/test_torch_variants_train.py's 5e-2 (the JAX step's
# own noise reaches 1.6e-2 there)
MOMENT_LIMIT = {"gsc": 3e-2, "tsm": 5e-2}
FAULTS = ("bn_moments", "denominators", "draws")
FAULT_WORLD = 2              # the planted faults run on 2 ranks (each step
                             # is ~100 lock-step all-reduces, slow on a
                             # loaded machine)


@pytest.fixture(autouse=True)
def _threads():
    """Six test workers share the machine: the comparisons and the
    one-process steps run on one thread (more spin on a loaded machine)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------------ inputs
def _batch(seed=0, views=VIEWS):
    rng = np.random.default_rng(seed)
    return {
        "img_dark": rng.uniform(size=(views, S, S, 3)).astype(np.float32),
        "gt": rng.uniform(size=(views, S, S, 3)).astype(np.float32),
        "mask": (rng.uniform(size=(views, S, S, 1)) > 0.7).astype(
            np.float32),
        "uv": rng.uniform(size=(views, S, S, 3)).astype(np.float32),
        "reg": rng.uniform(-0.02, 0.02, (views, S, S, 6)).astype(np.float32),
        "face": rng.uniform(size=(views, S, S, 1)).astype(np.float32),
    }


def _pinned(seed=1, views=VIEWS):
    """A fixed (img, mask_sv): a soft blob of shadow of its own place and
    size in each view, so each rank's share of the mask sums differs."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:S, :S] / S
    cy, cx = rng.uniform(0.3, 0.7, (2, views, 1, 1))
    width = rng.uniform(0.01, 0.08, (views, 1, 1))
    blob = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / width)
    mask_sv = blob[..., None] * np.array([0.6, 0.5, 0.4])
    img = rng.uniform(size=(views, S, S, 3)) * (1.0 - 0.5 * mask_sv)
    return img.astype(np.float32), mask_sv.astype(np.float32)


def _share_inputs(seed=2, c=4, h=8):
    rng = np.random.default_rng(seed)
    n = GROUPS * FRAMES
    return {"x": rng.uniform(size=(n, c, h, h)).astype(np.float32),
            "reg": rng.uniform(-0.05, 0.05, (n, S, S, 6)).astype(np.float32),
            "w": rng.normal(size=(n, 2 * c, h, h)).astype(np.float32)}


def _frame_rows(world, rank):
    """The global rows of this rank's frames: frames [rank * f, (rank +
    1) * f) of every group, f = FRAMES / world."""
    f = FRAMES // world
    return [g * FRAMES + rank * f + i for g in range(GROUPS)
            for i in range(f)]


# ------------------------------------------------------------------ worker
def _step_case(inputs, variant, shape, rows, fault=None, pinned=True,
               train=True):
    """One sharded step on this rank's `rows` inside a mesh of `shape`;
    returns {losses, gen, disc, mu} (and `unchanged` for a val step)."""
    from blindshadowremoval_tpu_torch.config import get_config
    from blindshadowremoval_tpu_torch.models import blocks
    from blindshadowremoval_tpu_torch.parallel import distributed
    from blindshadowremoval_tpu_torch.train import losses as losses_module
    from blindshadowremoval_tpu_torch.train import trainer as tm

    saved = {"compose": tm.compose_shadow_image,
             "sat": tm.Trainer._saturation_aug,
             "mirror": tm.Trainer._mirror_consistency,
             "gate": tm.Trainer.share_gate,
             "rows": vars(tm.Trainer)["_rows"],     # the staticmethod
             "bn": blocks.batch_group, "den": losses_module.batch_group}
    img, mask_sv = (torch.from_numpy(a) for a in inputs["pinned"])
    try:
        if pinned:
            def compose(gen, mask, gt, dark, face, rows=None):
                first = rows[1]
                sl = slice(first, first + gt.shape[0])
                return img[sl], mask_sv[sl], None

            tm.compose_shadow_image = compose
            tm.Trainer._saturation_aug = \
                lambda self, gen, gt, dark, rows=None: (gt, dark)
            tm.Trainer._mirror_consistency = lambda self, gen, x: x
            tm.Trainer.share_gate = \
                lambda self, gen, train: torch.tensor(True)
        if fault == "bn_moments":
            blocks.batch_group = lambda: None
        elif fault == "denominators":
            losses_module.batch_group = lambda: None
        elif fault == "draws":
            tm.Trainer._rows = staticmethod(lambda views: None)
        init = inputs["init"][variant]
        trainer = tm.Trainer(get_config("train", variant=variant, **CFG),
                             vgg_weights=init["vgg"], device="cpu")
        state = trainer.init_state(gen_state=init["gen"],
                                   disc_state=init["disc"])
        before = {k: v.clone() for k, v in
                  {**state.gen.state_dict(),
                   **state.disc.state_dict()}.items()}
        batch = inputs["batch"] if pinned else inputs["raw_batch"]
        local = {k: torch.from_numpy(v[rows]) for k, v in batch.items()}
        mesh = distributed.global_mesh(shape)
        with mesh:
            state, losses, _ = trainer.train_step(
                state, local, torch.Generator().manual_seed(7), train=train)
    finally:
        tm.compose_shadow_image = saved["compose"]
        tm.Trainer._saturation_aug = saved["sat"]
        tm.Trainer._mirror_consistency = saved["mirror"]
        tm.Trainer.share_gate = saved["gate"]
        tm.Trainer._rows = saved["rows"]
        blocks.batch_group = saved["bn"]
        losses_module.batch_group = saved["den"]
    out = {"losses": {k: float(v) for k, v in losses.items()},
           "gen": state.gen.state_dict(), "disc": state.disc.state_dict(),
           "step": state.step}
    if train:
        out["mu"] = {f"{net}.{n}": opt.state[p]["exp_avg"]
                     for net, module, opt in (("G", state.gen, state.gen_opt),
                                              ("D", state.disc,
                                               state.disc_opt))
                     for n, p in module.named_parameters()}
    else:
        now = {**state.gen.state_dict(), **state.disc.state_dict()}
        out["unchanged"] = all(torch.equal(now[k], v)
                               for k, v in before.items())
    return out


def _worker(addr: str, world: int, rank: int, work: Path,
            inputs_path: Path) -> None:
    import torch.distributed as dist

    from blindshadowremoval_tpu_torch.models.generator_tsm import (
        ShareLayer,
        TSMGenerator,
    )
    from blindshadowremoval_tpu_torch.parallel import distributed, mesh

    torch.set_num_threads(1)
    inputs = torch.load(inputs_path, weights_only=False)
    distributed.initialize(addr, world, rank, device="cpu")
    out: dict = {}
    try:
        # ---- the helpers
        gm = distributed.global_mesh((world // 2, 2))
        member = torch.tensor([float(rank)])
        out["helpers"] = {
            "host_local_batch": [distributed.host_local_batch(b)
                                 for b in (8, 12)],
            "shape": gm.shape, "rank": gm.rank,
            "device": str(gm.local_device),
            # the ranks sharing this rank's "data" and "frame" groups
            "data_sum": float(distributed.all_sum(member, gm.group("data"))),
            "frame_sum": float(distributed.all_sum(member,
                                                   gm.group("frame"))),
            "all_sum": float(distributed.all_sum(
                member, gm.group(("data", "frame")))),
            "offsets": [(s.offset, s.global_rows) for s in (
                distributed.make_global_array(np.zeros((3, 2)), gm, spec)
                for spec in (mesh.P("data"), mesh.P(("data", "frame")),
                             mesh.P("frame")))],
        }
        for bad in (lambda: distributed.host_local_batch(world + 1),
                    lambda: distributed.global_mesh((world, 2))):
            try:
                bad()
            except ValueError as e:
                out["helpers"].setdefault("errors", []).append(str(e))
        mean = distributed.mean_gradients(
            [torch.full((3,), float(rank)), torch.full((2, 2), 1.0 + rank)],
            dist.group.WORLD)
        out["helpers"]["mean_gradients"] = [m.tolist() for m in mean]

        # ---- the collective ShareLayer: frames over the "frame" axis
        fm = distributed.global_mesh((1, world))
        rows = _frame_rows(world, rank)
        sh = {k: torch.from_numpy(v[rows]) for k, v in
              inputs["share"].items()}
        x = sh["x"].clone().requires_grad_()
        with fm:
            y = ShareLayer(axis_name="frame")(x, sh["reg"],
                                              frame=FRAMES // world)
            (grad,) = torch.autograd.grad((y * sh["w"]).sum(), x)
        out["share"] = {"rows": rows, "out": y.detach(), "grad": grad}

        # ---- TSMGenerator(axis_name="frame"), f32, frames over the ranks
        gen = TSMGenerator(n_res=2, axis_name="frame")
        gen.load_state_dict(inputs["tsm_forward"]["state"])
        gen.eval()
        v = inputs["tsm_forward"]
        with fm, torch.no_grad():
            outs = gen(*(torch.from_numpy(v[k][rows])
                         for k in ("img", "uv", "reg")),
                       frame=FRAMES // world)
        out["tsm_forward"] = {"rows": rows, "out": [o for o in outs]}

        # ---- the sharded train steps
        n = VIEWS // world
        mine = list(range(rank * n, (rank + 1) * n))
        out["gsc"] = _step_case(inputs, "gsc", (world, 1), mine)
        out["tsm"] = _step_case(inputs, "tsm", (world // 2, 2), mine)
        out["val"] = _step_case(inputs, "gsc", (world, 1), mine,
                                train=False)
        out["unpinned"] = _step_case(inputs, "gsc", (world, 1), mine,
                                     pinned=False)
        if world == FAULT_WORLD:
            for fault in FAULTS:
                out[fault] = _step_case(inputs, "gsc", (world, 1), mine,
                                        fault=fault,
                                        pinned=fault != "draws")
        else:
            # a layout that splits a mirrored pair: one view a rank
            try:
                _step_case(inputs, "gsc", (world, 1), [rank])
            except ValueError as e:
                out["split_pair"] = str(e)
    finally:
        torch.save(out, work / f"rank{rank}.pt")
        dist.destroy_process_group()


# ------------------------------------------------------------------ parent
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _key_with_gate(share: bool):
    """The first PRNGKey(i) whose JAX TSM step draws this share gate
    (tests/test_torch_variants_train.py)."""
    import jax

    for i in range(100):
        key = jax.random.PRNGKey(i)
        if bool(jax.random.uniform(jax.random.split(key, 4)[3]) > 0.5) \
                == share:
            return key
    raise AssertionError("no key draws the gate")


def _jax_inputs():
    """Initial JAX states of both variants, as numpy trees: the shapes of
    `Trainer._init_state` (traced, not compiled: its compile took ~30 s
    of this file) filled from a seed, Glorot-uniform kernels, zero biases
    and means, unit BatchNorm scales and variances, zero Adam states."""
    import jax

    from blindshadowremoval_tpu.config import get_config as jax_config
    from blindshadowremoval_tpu.train import trainer as jtrainer

    rng = np.random.default_rng(0)

    def fill(path, leaf):
        name = jax.tree_util.keystr(path)
        if "opt_state" not in name and name.endswith("['kernel']"):
            *window, fan_in, fan_out = leaf.shape
            k = int(np.prod(window))
            limit = np.sqrt(6.0 / (k * (fan_in + fan_out)))
            return rng.uniform(-limit, limit, leaf.shape).astype(leaf.dtype)
        ones = "opt_state" not in name and name.endswith(("['scale']",
                                                          "['var']"))
        return (np.ones if ones else np.zeros)(leaf.shape, leaf.dtype)

    states = {}
    for variant in ("gsc", "tsm"):
        trainer = jtrainer.Trainer(jax_config("train", variant=variant,
                                              **CFG))
        shapes = jax.eval_shape(trainer._init_state, jax.random.PRNGKey(0))
        states[variant] = jax.tree_util.tree_map_with_path(fill, shapes)
    return states


def _jax_step(variant, state):
    """JAX's pinned one-device step on the whole batch: (new state as
    numpy trees, losses)."""
    import jax

    from blindshadowremoval_tpu.config import get_config as jax_config
    from blindshadowremoval_tpu.train import trainer as jtrainer

    img, mask_sv = _pinned()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrainer, "compose_shadow_image",
                   lambda key, mask, gt, dark, face: (img, mask_sv, None))
        mp.setattr(jtrainer.Trainer, "_saturation_aug",
                   lambda self, key, gt, dark: (gt, dark))
        mp.setattr(jtrainer.Trainer, "_mirror_consistency",
                   lambda self, key, x: x)
        trainer = jtrainer.Trainer(jax_config("train", variant=variant,
                                              **CFG))
        new, losses, _ = trainer.train_step(state, _batch(),
                                            _key_with_gate(True), train=True)
    return (jax.tree.map(np.asarray, new),
            {k: float(v) for k, v in losses.items()})


def _torch_state(jstate):
    from blindshadowremoval_tpu_torch.models.weights import (
        discriminator_from_jax,
        from_jax_variables,
        vgg_from_jax,
    )

    return {"gen": from_jax_variables({"params": jstate.gen_params,
                                       "batch_stats": jstate.gen_stats}),
            "disc": discriminator_from_jax({"params": jstate.disc_params,
                                            "batch_stats":
                                            jstate.disc_stats}),
            "vgg": vgg_from_jax(jstate.vgg_params)}


def _jax_mu(jnew, variant):
    """JAX's Adam first moments after the step, by the port's names."""
    import jax

    from blindshadowremoval_tpu_torch.models.weights import (
        discriminator_from_jax,
        from_jax_variables,
    )

    mu = {}
    for net, opt, stats, convert in (
            ("G", jnew.gen_opt_state, jnew.gen_stats, from_jax_variables),
            ("D", jnew.disc_opt_state, jnew.disc_stats,
             discriminator_from_jax)):
        sd = convert({"params": jax.tree.map(np.asarray, opt[0].mu),
                      "batch_stats": stats})
        mu.update({f"{net}.{k}": v for k, v in sd.items()
                   if not k.endswith(("running_mean", "running_var",
                                      "num_batches_tracked"))})
    return mu


def _one_process_step(inputs, train=True, pinned=False, batch=None):
    """The port's own step on the whole batch in this process (the same
    seed and initial state as the ranks); `pinned` as the ranks pin it."""
    from blindshadowremoval_tpu_torch.config import get_config
    from blindshadowremoval_tpu_torch.train import trainer as tm

    init = inputs["init"]["gsc"]
    trainer = tm.Trainer(get_config("train", **CFG),
                         vgg_weights=init["vgg"], device="cpu")
    state = trainer.init_state(gen_state=init["gen"],
                               disc_state=init["disc"])
    if batch is None:
        batch = inputs["batch"] if pinned else inputs["raw_batch"]
    with pytest.MonkeyPatch.context() as mp:
        if pinned:
            img, mask_sv = (torch.from_numpy(a) for a in inputs["pinned"])
            mp.setattr(tm, "compose_shadow_image",
                       lambda gen, mask, gt, dark, face: (img, mask_sv,
                                                          None))
            mp.setattr(tm.Trainer, "_saturation_aug",
                       lambda self, gen, gt, dark: (gt, dark))
            mp.setattr(tm.Trainer, "_mirror_consistency",
                       lambda self, gen, x: x)
        state, losses, _ = trainer.train_step(
            state, {k: torch.from_numpy(v) for k, v in batch.items()},
            torch.Generator().manual_seed(7), train=train)
    return {"losses": {k: float(v) for k, v in losses.items()},
            "gen": state.gen.state_dict(), "disc": state.disc.state_dict(),
            "mu": {f"{net}.{n}": opt.state[p]["exp_avg"]
                   for net, module, opt in (("G", state.gen, state.gen_opt),
                                            ("D", state.disc,
                                             state.disc_opt))
                   for n, p in module.named_parameters()} if train else {}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both worlds' results by rank, and the references: JAX's pinned
    steps, the port's one-process steps, the local ShareLayers and the
    local TSM forward."""
    work = tmp_path_factory.mktemp("ranks")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)          # six test workers share the machine
    try:
        return _run_ranks(work)
    finally:
        torch.set_num_threads(threads)


def _run_ranks(work: Path) -> dict:
    """The body of `runs`, with the references it names."""
    from blindshadowremoval_tpu.models import generator_tsm as jtsm
    from blindshadowremoval_tpu_torch.models.generator_tsm import (
        ShareLayer,
        TSMGenerator,
    )

    jstates = _jax_inputs()
    batch = _batch()
    raw = {k: v for k, v in batch.items() if k != "img_dark"}
    gen = TSMGenerator(n_res=2)
    torch.manual_seed(0)
    for m in gen.modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
            torch.nn.init.xavier_uniform_(m.weight)
            torch.nn.init.uniform_(m.bias, -0.1, 0.1)
        elif isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.uniform_(-0.2, 0.2)
            m.running_var.uniform_(0.5, 1.5)
    fwd = _batch(3, GROUPS * FRAMES)
    inputs = {
        "init": {v: _torch_state(s) for v, s in jstates.items()},
        "batch": batch, "raw_batch": raw, "pinned": _pinned(),
        "share": _share_inputs(),
        "tsm_forward": {"state": gen.state_dict(), "img": fwd["gt"],
                        "uv": fwd["uv"], "reg": fwd["reg"]},
    }
    torch.save(inputs, work / "inputs.pt")
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = {}
    for world in WORLDS:
        (work / str(world)).mkdir()
        addr = f"127.0.0.1:{_free_port()}"
        procs[world] = [subprocess.Popen(
            [sys.executable, __file__, addr, str(world), str(rank),
             str(work / str(world)), str(work / "inputs.pt")],
            env=env, cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
            for rank in range(world)]
    try:
        # the references, while the ranks run
        refs = {v: _jax_step(v, jstates[v]) for v in ("gsc", "tsm")}
        share = inputs["share"]
        local = ShareLayer()
        x = torch.from_numpy(share["x"]).requires_grad_()
        y = local(x, torch.from_numpy(share["reg"]), frame=FRAMES)
        (grad,) = torch.autograd.grad((y * torch.from_numpy(
            share["w"])).sum(), x)
        jax_share = np.asarray(jtsm.ShareLayer().apply(
            {}, share["x"].transpose(0, 2, 3, 1), share["reg"], FRAMES,
            True)).transpose(0, 3, 1, 2)
        gen.eval()
        with torch.no_grad():
            tsm_local = gen(*(torch.from_numpy(inputs["tsm_forward"][k])
                              for k in ("img", "uv", "reg")), frame=FRAMES)
        one = {"unpinned": _one_process_step(inputs),
               "val": _one_process_step(inputs, train=False, pinned=True)}
        logs, codes = {}, {}
        deadline = time.monotonic() + 600
        for world, ps in procs.items():
            for rank, p in enumerate(ps):
                logs[world, rank] = p.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))[0]
                codes[world, rank] = p.returncode
    finally:
        for ps in procs.values():
            for p in ps:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    results = {}
    for world in WORLDS:
        for rank in range(world):
            f = work / str(world) / f"rank{rank}.pt"
            results[world, rank] = (torch.load(f, weights_only=False)
                                    if f.exists() else {})
    return {"results": results, "codes": codes, "logs": logs,
            "procs": procs, "jax": refs, "one": one, "inputs": inputs,
            "share": (y.detach(), grad, jax_share), "tsm_local": tsm_local,
            "mu": {v: _jax_mu(refs[v][0], v) for v in refs},
            "jstates": {v: _torch_state(refs[v][0]) for v in refs}}


def _ranks(runs, world, key):
    _check_exit(runs, world)
    return [runs["results"][world, r][key] for r in range(world)]


def _check_exit(runs, world):
    for rank in range(world):
        assert runs["codes"][world, rank] == 0, runs["logs"][world, rank][
            -3000:]


def _violations(got, want_losses, want_state, want_mu, variant) -> list:
    """Where `got` (one rank's result) misses the bars against the
    reference: the losses, every parameter and BatchNorm statistic of
    both networks, and Adam's first moments."""
    bad = []
    for name, v in want_losses.items():
        if not np.isclose(got["losses"][name], v, **LOSS_TOL):
            bad.append(f"loss {name}: {got['losses'][name]!r} vs {v!r}")
    for net in ("gen", "disc"):
        for name, w in want_state[net].items():
            g = got[net][name]
            if not torch.allclose(g.float(), w.float(), **STATE_TOL):
                err = float((g.float() - w.float()).abs().max())
                bad.append(f"{net}.{name}: max abs err {err:.3e}")
    limit = MOMENT_LIMIT[variant]
    top = max(float(m.abs().max()) for m in want_mu.values())
    for name, w in want_mu.items():
        m = got["mu"][name]
        if float(w.abs().max()) < 1e-5 * top:
            # a bias feeding a train-mode BatchNorm: zero in exact
            # arithmetic (tests/test_torch_train_step.py)
            if float(m.abs().max()) >= 1e-5 * top:
                bad.append(f"moment {name}: not zero")
            continue
        err = float((m - w).norm() / w.norm())
        if err >= limit:
            bad.append(f"moment {name}: relative error {err:.2e}")
    return bad


def _jax_reference(runs, variant):
    """(losses, new state, Adam's first moments) of JAX's pinned step."""
    return runs["jax"][variant][1], runs["jstates"][variant], \
        runs["mu"][variant]


@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_exits_cleanly(runs, world):
    _check_exit(runs, world)
    for p in runs["procs"][world]:
        assert p.poll() == 0
    for rank in range(world):
        assert "Traceback" not in runs["logs"][world, rank]


@pytest.mark.parametrize("world", WORLDS)
def test_helpers_across_processes(runs, world):
    helpers = _ranks(runs, world, "helpers")
    d, f = world // 2, 2
    for rank, h in enumerate(helpers):
        # as JAX's host_local_batch over `world` processes
        assert h["host_local_batch"] == [(8 // world, rank * 8 // world),
                                         (12 // world, rank * 12 // world)]
        assert h["shape"] == {"data": d, "frame": f}
        assert h["rank"] == rank and h["device"] == "cpu"
        # rank r sits at (r // 2, r % 2): its data group is its column,
        # its frame group its row
        col = [r for r in range(world) if r % f == rank % f]
        row = [r for r in range(world) if r // f == rank // f]
        assert h["data_sum"] == sum(col)
        assert h["frame_sum"] == sum(row)
        assert h["all_sum"] == sum(range(world))
        # 3 local rows: offsets by the shard index along each spec
        assert h["offsets"] == [((rank // f) * 3, 3 * d),
                                (rank * 3, 3 * world),
                                ((rank % f) * 3, 3 * f)]
        assert h["errors"] == [
            f"global batch {world + 1} not divisible by {world} processes",
            f"mesh shape {(world, 2)} != {world} global devices"]
        mean = (world - 1) / 2
        assert h["mean_gradients"] == [[mean] * 3, [[1 + mean] * 2] * 2]


@pytest.mark.parametrize("world", WORLDS)
def test_collective_share_layer_matches_local(runs, world):
    out, grad, jax_out = runs["share"]
    for res in _ranks(runs, world, "share"):
        rows = res["rows"]
        np.testing.assert_allclose(res["out"].numpy(), out[rows].numpy(),
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(res["out"].numpy(), jax_out[rows],
                                   rtol=0, atol=1e-5)
        # the gradient through the all-reduced max and mean
        np.testing.assert_allclose(res["grad"].numpy(), grad[rows].numpy(),
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("world", WORLDS)
def test_tsm_forward_with_frames_over_ranks_matches_local(runs, world):
    for res in _ranks(runs, world, "tsm_forward"):
        for got, want in zip(res["out"], runs["tsm_local"]):
            np.testing.assert_allclose(got.numpy(), want[res["rows"]].numpy(),
                                       rtol=0, atol=1e-5)


@pytest.mark.parametrize("variant", ["gsc", "tsm"])
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_step_matches_jax_one_device_step(runs, world, variant):
    losses, state, mu = _jax_reference(runs, variant)
    for rank, res in enumerate(_ranks(runs, world, variant)):
        assert res["step"] == 1
        bad = _violations(res, losses, state, mu, variant)
        assert not bad, f"rank {rank}: " + "; ".join(bad[:5])


@pytest.mark.parametrize("case", ["gsc", "tsm", "unpinned", "val"])
@pytest.mark.parametrize("world", WORLDS)
def test_losses_and_state_bitwise_equal_across_ranks(runs, world, case):
    res = _ranks(runs, world, case)
    for other in res[1:]:
        assert other["losses"] == res[0]["losses"]
        for key in ("gen", "disc", "mu"):
            for name, v in res[0].get(key, {}).items():
                assert torch.equal(other[key][name], v), f"{key}.{name}"


@pytest.mark.parametrize("world", WORLDS)
def test_val_step_updates_nothing_and_matches_one_process(runs, world):
    want = runs["one"]["val"]["losses"]
    for res in _ranks(runs, world, "val"):
        assert res["unchanged"] and res["step"] == 0
        for name, v in want.items():
            np.testing.assert_allclose(res["losses"][name], v, **LOSS_TOL)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_draws_match_the_one_process_step(runs, world):
    """The device-darkening wire, unpinned: the saturation jitter, the
    tone-curve gains, the compositor and the mirror swap drawn for the
    whole batch on every rank."""
    ref = runs["one"]["unpinned"]
    for rank, res in enumerate(_ranks(runs, world, "unpinned")):
        bad = _violations(res, ref["losses"], ref, ref["mu"], "gsc")
        assert not bad, f"rank {rank}: " + "; ".join(bad[:5])


@pytest.mark.parametrize("pinned", [True, False])
def test_moment_limit_sits_above_the_steps_own_noise(runs, pinned):
    """MOMENT_LIMIT["gsc"]'s ground: the one-process step on the batch
    times 1 + 1e-6 noise moves Adam's first moments by less than it, and
    its losses and state stay within the bars."""
    inputs = runs["inputs"]
    rng = np.random.default_rng(5)
    key = "batch" if pinned else "raw_batch"
    noisy = {k: (v * (1.0 + 1e-6 * rng.standard_normal(v.shape))).astype(
        v.dtype) for k, v in inputs[key].items()}
    ref = _one_process_step(inputs, pinned=pinned)
    got = _one_process_step(inputs, pinned=pinned, batch=noisy)
    bad = _violations(got, ref["losses"], ref, ref["mu"], "gsc")
    top = max(float(m.abs().max()) for m in ref["mu"].values())
    worst = max(float((got["mu"][n] - m).norm() / m.norm())
                for n, m in ref["mu"].items()
                if float(m.abs().max()) >= 1e-5 * top)
    print(f"pinned={pinned}: worst first-moment change {worst:.2e}")
    assert not bad, "; ".join(bad[:5])


@pytest.mark.parametrize("fault", FAULTS)
def test_planted_fault_fails_the_bars(runs, fault):
    world = FAULT_WORLD
    if fault == "draws":
        ref = runs["one"]["unpinned"]
        want = ref["losses"], ref, ref["mu"]
    else:
        want = _jax_reference(runs, "gsc")
    for res in _ranks(runs, world, fault):
        bad = _violations(res, *want, "gsc")
        # the losses alone reject it, before the state and the moments
        assert any(b.startswith("loss") for b in bad), fault
        assert len(bad) > 1


def test_a_rank_must_hold_whole_pairs(runs):
    for msg in _ranks(runs, 4, "split_pair"):
        assert msg.startswith("1 views a rank (4 over 4 ranks) split a "
                              "mirrored pair")
        assert "at most 2 ranks" in msg


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    _addr, _world, _rank, _work, _inputs = sys.argv[1:6]
    _worker(_addr, int(_world), int(_rank), Path(_work), Path(_inputs))
