"""What the served cells share: the service built from the configuration's
file with seeded weights, the request pool, the spans around the served
path's layers, and the check of every answer of the window against the
plain reference."""

from __future__ import annotations

import numpy as np
import torch

from bench_h100.harness import inputs, work
from bench_h100.harness import compare as cmp
from bench_h100.harness.weights import draw_state_dict, layout_mismatch
from bench_h100.reference import generator as ref_generator
from bench_h100.reference import layout
from bench_h100.reference import serve as ref_serve


def program_config(config: dict, path: str, **extra):
    """The program's Config of the configuration file's `path` settings."""
    from blindshadowremoval_tpu_torch.config import get_config

    settings = {k: v for k, v in config[path].items()
                if k not in ("preset", "device_geometry")}
    return get_config(config[path]["preset"], img_size=config["img_size"],
                      n_res=config["n_res"], variant=config["variant"],
                      **settings, **extra)


def seeded_weights(config: dict, cfg, seed: int, device) -> dict:
    """The generator's unfolded state dict, drawn on `device` at the
    shapes the configuration file's widths give (reference/layout.py).
    Raises when the program's generator for `cfg` is laid out otherwise:
    a width the program changed is not the published model."""
    from blindshadowremoval_tpu_torch.models import new_generator

    entries, transposed = layout.generator_layout(config)
    counters = layout.bn_counters(entries)
    with torch.device("meta"):
        template = new_generator(cfg).state_dict()
    wrong = layout_mismatch(template, entries, counters)
    if wrong:
        raise RuntimeError(
            f"the program's {config['name']} generator departs from the "
            f"published widths of {config['name']}.json: "
            + "; ".join(wrong[:8]))
    return draw_state_dict(entries, transposed, counters, seed, device)


def build(run, batch_size: int):
    """(service, state dict, photos, landmarks) of a served cell."""
    from blindshadowremoval_tpu_torch.eval.serving import ShadowRemovalService

    config, pool = run.cell.config, run.cell.traffic["pool"]
    cfg = program_config(config, "serve")
    sd = seeded_weights(config, cfg, run.seed, run.device)
    svc = ShadowRemovalService(
        cfg, sd, batch_size=batch_size, device=run.device,
        device_geometry=config["serve"]["device_geometry"])
    photos, lms = inputs.photo_pool(
        run.seed, pool["count"], pool["sizes"], pool["face_px"],
        pool["margin"], pool["jitter_px"], run.device)
    run.state.update(svc=svc, sd=sd, photos=photos, lms=lms)
    return svc, sd, photos, lms


def install_spans(run, spans) -> None:
    from blindshadowremoval_tpu_torch.eval import serving

    svc = run.state["svc"]
    spans.wrap(svc, "preprocess", "preprocess")
    spans.wrap(svc, "stage", "stage")
    spans.wrap(svc, "forward_staged", "forward")
    spans.wrap(serving, "device_geometry_maps", "geometry")
    spans.wrap(svc.gen, "forward", "generator")
    spans.wrap(serving, "_to_host", "fetch")


def release(run) -> None:
    """Drop the program's state; the answers and the inputs stay."""
    run.state.pop("svc", None)
    run.state.pop("frontend", None)


def flops_per_face(run) -> int:
    """The generator's FLOPs for one face, counted on the reference."""
    config = run.cell.config
    s = config["img_size"]
    net = ref_generator.Net(run.state["sd"])
    x = torch.zeros((1, s, s, 3), device=run.device)
    return work.count_flops(lambda: ref_generator.generator(
        net, x, x, config["n_res"]))


def precision(config: dict, path: str) -> dict:
    """The dtypes the configuration's `path` states: compute and egress."""
    return {"compute": config[path].get("compute_dtype", "bfloat16"),
            "egress": config[path].get("egress_dtype", "float32")}


def reference(run, control: bool = False,
              deltas: tuple = (cmp.DELTA,)) -> tuple[np.ndarray, np.ndarray]:
    """The reference's (pred, mask_pred) [gate, photo, ...] of every photo
    of the pool at the shadow gates of `cmp.gates(deltas)`, or the
    control's at the model's gate alone."""
    config = run.cell.config
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return ref_serve.answers(
        run.state["photos"], run.state["lms"], run.state["sd"],
        config["img_size"], config["n_res"], config["variant"], run.device,
        control=precision(config, "serve") if control else None,
        gates=cmp.gates(()) if control else cmp.gates(deltas))


def compare(run, answers, pred_ref: np.ndarray, mask_ref: np.ndarray,
            deltas: tuple = (cmp.DELTA,), look: bool = False) -> list:
    """[(name, worst reading, limit)] over (pool index, answer) pairs, for
    pred and mask_pred each (harness/compare.py): the trimmed mean absolute
    gap from its photo's reference, and the share of its values more than
    TAU outside the reference's gate envelope; the worst answer's.  The
    untrimmed worst, and with `look` the worst share at every envelope of
    `deltas` and distance of LOOK_TAUS, go to `run.state["look"]`."""
    limits = run.cell.limits["limits"]
    idx = [i for i, _ in answers]
    taus = cmp.grid(look)[1]
    out, look_ = [], {}
    for key, ref, name in (("pred", pred_ref, "pred"),
                           ("mask_pred", mask_ref, "mask")):
        got = [r[key] for _, r in answers]
        mae, tmae = cmp.gaps(got, [ref[0][i] for i in idx], run.device)
        look_[f"{name}_mae_worst"] = float(mae.max())
        for d in deltas:
            lo, hi = cmp.envelope(ref, d, deltas)
            far = cmp.far_shares(got, [lo[i] for i in idx],
                                 [hi[i] for i in idx], run.device, taus)
            for j, t in enumerate(taus):
                look_[f"{name}_far_worst@d{d}t{t}"] = float(far[:, j].max())
        out += [(f"{name}_tmae_worst", float(tmae.max()),
                 limits[f"{name}_tmae_worst"]),
                (f"{name}_far_worst",
                 look_[f"{name}_far_worst@d{cmp.DELTA}t{cmp.TAU}"],
                 limits[f"{name}_far_worst"])]
    run.state["look"] = look_
    return out


def check(run, look: bool = False) -> list:
    """Every answer of the window against its photo's reference."""
    deltas = cmp.grid(look)[0]
    pred_ref, mask_ref = reference(run, deltas=deltas)
    return compare(run, run.state["answers"], pred_ref, mask_ref, deltas,
                   look)


def control(run, look: bool = False) -> list:
    """The control's readings: the reference in float8 in the program's
    place, an answer a photo of the pool, by the same comparison."""
    deltas = cmp.grid(look)[0]
    pred_c, mask_c = reference(run, control=True)
    pred_r, mask_r = reference(run, deltas=deltas)
    answers = [(i, {"pred": pred_c[0][i], "mask_pred": mask_c[0][i]})
               for i in range(pred_c.shape[1])]
    return compare(run, answers, pred_r, mask_r, deltas, look)
