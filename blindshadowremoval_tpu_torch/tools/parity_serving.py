"""Final-output parity of serving configurations against the f32 path
(counterpart of `tools/parity_serving.py`).

bench's headline configuration must hold >= 40 dB PSNR on its final
outputs (the in-the-wild prediction and the UCB heuristic composite)
against the f32 path on a trained checkpoint; head-output parity is not
enough, since the `dif > 0.1` hole binarization and the heuristic mask
thresholds turn small head deltas into other holes and components.  This
tool restores a generator once (a port checkpoint directory or a TF
checkpoint prefix, as `calibrate_int8_head.py` reads them) and scores
each configuration against the f32 one:

  * in-the-wild: PSNR of clip(con_rgb) and of the face-gated shadow map
    (the first sample of `--wild-data`, by default the first UCB image);
  * UCB (N images, the fused step): PSNR of the heuristic composite, the
    pixel disagreement of the detected mask, and the change of the
    reported PSNR metric itself.

"precision" is the JAX tool's matmul precision, mapped onto
`torch.set_float32_matmul_precision` for the run ("highest" f32,
"high" TF32, "default" "medium", bf16): it reaches cuBLAS's f32 matrix
products; the generators' f32 convolutions run in true f32 whatever it is
(`models/generator.py:f32_convs`).  The figures are a quality result only
on a trained checkpoint and real images.  `--data` and
`--part-mask-root` are required (the JAX tool reads the reference's UCB
images); `--cpu` is `--device cpu`.

    python -m blindshadowremoval_tpu_torch.tools.parity_serving --ckpt CKPT \
        --data 'ucb/input/*' --part-mask-root ucb [--ucb-images 5]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import tempfile

import numpy as np
import torch

from blindshadowremoval_tpu_torch.config import get_config, resolve_device
from blindshadowremoval_tpu_torch.tools import _timing
from blindshadowremoval_tpu_torch.tools.calibrate_int8_head import (
    restore_generator,
)

SIZE = 256
N_RES = 6
_PRECISION = {"highest": "highest", "high": "high", "default": "medium"}

# candidate serving configurations, as overrides on the eval config (the
# JAX tool's); f32 at "highest" is the reference
CONFIGS = {
    "f32": dict(compute_dtype="float32", fold_bn=False,
                egress_dtype="float32", int8_head=False,
                precision="highest"),
    "f32+fold": dict(compute_dtype="float32", fold_bn=True,
                     egress_dtype="float32", int8_head=False,
                     precision="highest"),
    "f32+fold@high": dict(compute_dtype="float32", fold_bn=True,
                          egress_dtype="float32", int8_head=False,
                          precision="high"),
    "f32+fold@default": dict(compute_dtype="float32", fold_bn=True,
                             egress_dtype="float32", int8_head=False,
                             precision="default"),
    "bf16": dict(compute_dtype="bfloat16", fold_bn=False,
                 egress_dtype="float32", int8_head=False,
                 precision="default"),
    "bf16+fold+bf16egress": dict(compute_dtype="bfloat16", fold_bn=True,
                                 egress_dtype="bfloat16", int8_head=False,
                                 precision="default"),
    "bf16+fold+int8head": dict(compute_dtype="bfloat16", fold_bn=True,
                               egress_dtype="bfloat16", int8_head=True,
                               int8_head_scale=0.0,   # 0.0 = AUTO
                               precision="default"),
    # int8 only for the `con` offset channel, bf16 for the tanh gain that
    # feeds the dif > 0.1 holes
    "bf16+fold+int8split": dict(compute_dtype="bfloat16", fold_bn=True,
                                egress_dtype="bfloat16", int8_head=False,
                                int8_head_split=True,
                                int8_head_scale=0.0,   # 0.0 = AUTO
                                precision="default"),
}


def psnr(a: np.ndarray, b: np.ndarray, peak: float = 1.0) -> float:
    mse = float(np.mean((np.asarray(a, np.float64)
                         - np.asarray(b, np.float64)) ** 2))
    return 10 * np.log10(peak * peak / mse) if mse else 99.0


@contextlib.contextmanager
def matmul_precision(precision: str):
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision(_PRECISION[precision])
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved)


def serve_configs(ckpt: str, data: str, part_mask_root: str,
                  ucb_images: int = 5, configs=None,
                  wild_data: str | None = None, device=None) -> dict:
    """{config: {"ucb": [the fused UCB step's result an image], "wild":
    the in-the-wild result}}, each configuration served from the one
    restored generator on the same batches."""
    from blindshadowremoval_tpu_torch.data.dataset import Dataset
    from blindshadowremoval_tpu_torch.eval.evaluators import (
        InTheWildEvaluator,
        UCBEvaluator,
    )
    from blindshadowremoval_tpu_torch.ops.calibration import calibrate_config

    dev = resolve_device(device)
    configs = CONFIGS if configs is None else configs
    with tempfile.TemporaryDirectory(prefix="parity_") as work:
        base = get_config(
            "ucb", img_size=SIZE, n_res=N_RES, data_dirs_test=(data,),
            part_mask_root=part_mask_root, checkpoint_dir=work,
            compute_dtype="float32", fold_bn=False, egress_dtype="float32",
            int8_head=False)
        raw_sd = restore_generator(ckpt, base)     # live-BN f32 weights
        ev0 = UCBEvaluator(base, raw_sd, device=dev)   # reads the masks
        ucb_batches = [
            (batch, box, name, ev0._load_part_masks(part_mask_root, i,
                                                    sample_name=name))
            for i, (batch, box, name) in zip(range(ucb_images),
                                             Dataset(base, "test"))]
        del ev0
        wild_cfg = get_config(
            "in_the_wild", img_size=SIZE, n_res=N_RES,
            data_dirs_test=(wild_data or data,), checkpoint_dir=work,
            compute_dtype="float32", fold_bn=False, egress_dtype="float32",
            int8_head=False, eval_views=1)
        wild = next(iter(Dataset(wild_cfg, "test")))

        results = {}
        for cname, overrides in configs.items():
            overrides = dict(overrides)
            precision = overrides.pop("precision", "default")
            cfg = calibrate_config(dataclasses.replace(base, **overrides),
                                   raw_sd)
            wcfg = calibrate_config(dataclasses.replace(wild_cfg,
                                                        **overrides), raw_sd)
            with matmul_precision(precision):
                ev = UCBEvaluator(cfg, raw_sd, device=dev)
                ucb_out = [ev.run_one_fused(b, box, name, parts)
                           for b, box, name, parts in ucb_batches]
                wout = InTheWildEvaluator(wcfg, raw_sd,
                                          device=dev).run_one(*wild)
            results[cname] = {"ucb": ucb_out, "wild": wout}
            del ev
    return results


def report(results: dict) -> dict:
    """{config: the JAX tool's six figures} of `serve_configs`'s results
    against "f32", each printed as it is scored."""
    ref = results["f32"]
    report = {}
    for cname in results:
        if cname == "f32":
            continue
        r = results[cname]
        comp_psnr = [psnr(a["pred"], b["pred"])
                     for a, b in zip(r["ucb"], ref["ucb"])]
        mask_dis = [float(np.mean(a["detected"] != b["detected"]))
                    for a, b in zip(r["ucb"], ref["ucb"])]
        metric_delta = [abs(a["psnr"] - b["psnr"])
                        for a, b in zip(r["ucb"], ref["ucb"])]
        report[cname] = {
            "wild_pred_psnr_db": round(
                psnr(r["wild"]["pred"], ref["wild"]["pred"]), 1),
            "wild_mask_psnr_db": round(
                psnr(r["wild"]["mask_pred"], ref["wild"]["mask_pred"]), 1),
            "ucb_composite_psnr_db_min": round(min(comp_psnr), 1),
            "ucb_composite_psnr_db_mean": round(
                float(np.mean(comp_psnr)), 1),
            "ucb_detected_mask_disagree_max": round(max(mask_dis), 4),
            "ucb_metric_psnr_delta_max_db": round(max(metric_delta), 3),
        }
        print(cname, json.dumps(report[cname]), flush=True)
    return report


def parity(ckpt: str, data: str, part_mask_root: str, ucb_images: int = 5,
           configs=None, wild_data: str | None = None, device=None) -> dict:
    """{config: the JAX tool's six figures} against "f32", each printed as
    it is scored, and "device"."""
    results = serve_configs(ckpt, data, part_mask_root, ucb_images, configs,
                            wild_data, device)
    return {**report(results),
            "device": _timing.device_label(resolve_device(device))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m blindshadowremoval_tpu_torch.tools.parity_serving",
        description="Final-output parity of each serving configuration "
                    "against the f32 path")
    ap.add_argument("--ckpt", default="runs/demo_gsc",
                    help="a port checkpoint directory or a TF checkpoint "
                         "prefix (ckpt-N)")
    ap.add_argument("--ucb-images", type=int, default=5)
    ap.add_argument("--data", required=True,
                    help="glob of the UCB input folders")
    ap.add_argument("--part-mask-root", required=True,
                    help="root of the seven UCB part-mask directories")
    ap.add_argument("--wild-data", default=None,
                    help="glob of in-the-wild sample folders (default: "
                         "--data)")
    ap.add_argument("--cpu", action="store_true",
                    help="the same as --device cpu")
    ap.add_argument("--configs", default=None,
                    help="comma-separated subset of configurations to "
                         "score (f32 is always included as the reference); "
                         "default: all")
    _timing.add_device_arg(ap)
    args = ap.parse_args(argv)
    configs = CONFIGS
    if args.configs:
        wanted = set(args.configs.split(",")) | {"f32"}
        unknown = wanted - set(CONFIGS)
        if unknown:
            ap.error(f"unknown configs {sorted(unknown)}; "
                     f"available: {', '.join(CONFIGS)}")
        configs = {k: v for k, v in CONFIGS.items() if k in wanted}
    report = parity(args.ckpt, args.data, args.part_mask_root,
                    args.ucb_images, configs, args.wild_data,
                    "cpu" if args.cpu else args.device)
    print("\nJSON:", json.dumps(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
