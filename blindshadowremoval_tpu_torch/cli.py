"""Command-line interface (port of `blindshadowremoval_tpu/cli.py`): every
mode of the reference is a subcommand over the config presets, with the
JAX package's names, options, defaults, exit codes and printed lines.

  python -m blindshadowremoval_tpu_torch infer --data 'sample_imgs/*' --ckpt DIR
  python -m blindshadowremoval_tpu_torch ucb   --data 'UCB/train/input/*' \\
      --part-masks . --ckpt DIR
  python -m blindshadowremoval_tpu_torch sfw   --data 'SFW/*' --ckpt DIR
  python -m blindshadowremoval_tpu_torch sfw-video --data 'SFW/*' --ckpt DIR
  python -m blindshadowremoval_tpu_torch train --data 'Helen/bin/*' --val ... \\
      --ckpt DIR
  python -m blindshadowremoval_tpu_torch preprocess --input DIR --output DIR
  python -m blindshadowremoval_tpu_torch e2e --input DIR --output DIR
  python -m blindshadowremoval_tpu_torch landmarks --input DIR --fan-weights F

One option is added to every subcommand: `--device {cuda,cpu}`, CUDA by
default.  Without a card and without `--device cpu` the CLI stops with a
message; it never goes on on the CPU by itself.  On CUDA, `main` builds
(or loads from `_build/`) the attention kernels a subcommand runs before
its first forward, so a failed build stops the run at once.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import glob
import os
import sys

import numpy as np


def _add_common(p):
    p.add_argument("--ckpt", default="./checkpoints",
                   help="checkpoint directory (restore-latest)")
    p.add_argument("--img-size", type=int, default=256)
    p.add_argument("--variant", default=None,
                   choices=[None, "gsc", "tsm", "rgb"])
    p.add_argument("--int8-head", action="store_true",
                   help="run the 7x7 output head on int8 codes "
                        "(ops/quant.py; gsc and tsm). Activation bounds "
                        "are auto-calibrated per channel from the restored "
                        "checkpoint's BatchNorm statistics")
    p.add_argument("--int8-head-scale", type=float, default=0.0,
                   help="override the auto-calibrated int8 activation bound "
                        "with one scalar; negative = dynamic per-sample max "
                        "(an extra pass over the head's input). Default 0 = "
                        "auto per-channel from the checkpoint")
    p.add_argument("--fold-bn", action="store_true",
                   help="fold eval-mode BatchNorms into the conv kernels "
                        "at restore time (identical math, fewer elementwise "
                        "passes; serving/eval only — models/folding.py)")
    p.add_argument("--seed", type=int, default=0)


def _add_device(p):
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the subcommand runs: the CUDA card "
                        "(default), or the CPU with the kernels' plain "
                        "PyTorch versions")


def build_parser():
    ap = argparse.ArgumentParser(
        prog="blindshadowremoval_tpu_torch",
        description="blind facial shadow removal on the GPU (PyTorch/CUDA)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    for name, helptext in [
        ("infer", "in-the-wild inference (reference: testFFHQ)"),
        ("ucb", "UCB quantitative eval (reference: test)"),
        ("sfw", "SFW shadow segmentation eval (reference: testsfw)"),
        ("sfw-video", "SFW per-frame video removal (reference: testsfw_video)"),
    ]:
        p = sub.add_parser(name, help=helptext)
        p.add_argument("--data", required=True, help="glob of test dirs")
        p.add_argument("--device-geometry", action="store_true",
                       help="rasterize UV/offset/face maps on the device "
                            "from landmarks instead of on the host "
                            "(numerically identical)")
        _add_common(p)
        if name == "infer":
            p.add_argument(
                "--engine", choices=("evaluator", "serving"),
                default="evaluator",
                help="'evaluator' mirrors the reference's per-image "
                     "testFFHQ loop; 'serving' batches all images through "
                     "ShadowRemovalService (device-rasterized geometry, "
                     "compact wires)")
        if name in ("infer", "ucb"):
            p.add_argument(
                "--eval-views", type=int, default=None,
                help="views per sample: anchor + N-1 random same-folder refs "
                     "(reference protocol and default: 10); does not apply "
                     "to the tsm ucb protocol (fixed anchor+mirror pair)")
        if name == "ucb":
            p.add_argument("--part-masks", required=True,
                           help="root containing the UCB_input_images_* dirs")
            p.add_argument("--no-compact-ingress", action="store_true",
                           help="upload eval views as f32 instead of uint16 "
                                "fixed point (compact ingress is on by "
                                "default for the CLI)")
            p.add_argument("--images-per-call", type=int, default=8,
                           help="images per fused device call (tail padded; "
                                "identical metrics to per-image); 1 restores "
                                "the per-image path. Forced to 1 for the rgb "
                                "simple-composite protocol")
            p.add_argument("--rgb-heuristics", action="store_true",
                           help="with --variant rgb, run the generalized "
                                "heuristic post-processor instead of the "
                                "reference's simple face-mask composite "
                                "(train_RGB_test.py:403-505)")
        if name == "sfw-video":
            p.add_argument("--export-bbox", default=None)
        _add_device(p)

    p = sub.add_parser("train", help="GAN training (reference: train)")
    p.add_argument("--data", required=True, nargs="+")
    p.add_argument("--val", default=None, nargs="+")
    p.add_argument("--shadow-masks", default="",
                   help="external shadow PNG library for ShadowMaker")
    p.add_argument("--device-geometry", action="store_true",
                   help="rasterize UV/offset/face maps on the device "
                        "instead of on the host")
    p.add_argument("--device-darken", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="derive the jittered (gt, img_dark) pair in the "
                        "train step on the device instead of on the host "
                        "(ON by default; --no-device-darken restores the "
                        "host f32 darkening, see config.device_darken)")
    p.add_argument("--steps-per-epoch", type=int, default=2000)
    p.add_argument("--max-epoch", type=int, default=300)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--lr-decay", type=float, default=1.0,
                   help="staircase LR decay factor applied every "
                        "--lr-decay-epochs epochs (1.0 = constant). Changes "
                        "the optimizer state — use a fresh checkpoint dir")
    p.add_argument("--lr-decay-epochs", type=float, default=10.0)
    p.add_argument("--log-every", type=int, default=1,
                   help="fetch/print losses every N steps; each fetch syncs "
                        "the device")
    p.add_argument("--vgg-weights", default=None,
                   help="npz of pretrained VGG-19 weights for the perceptual "
                        "loss (tools/convert_vgg_weights.py). Without it the "
                        "perceptual term uses a RANDOM-init VGG — a valid "
                        "feature loss, but not the reference's")
    p.add_argument("--select-best", action="store_true",
                   help="after each epoch, probe quality and retain the "
                        "best checkpoint under <ckpt>/best. Needs "
                        "--probe-data (and --probe-part-masks for psnr)")
    p.add_argument("--probe-data", default=None,
                   help="UCB input image glob for the --select-best probe")
    p.add_argument("--probe-part-masks", default=None,
                   help="root containing the UCB_input_images_* dirs for "
                        "the --select-best probe")
    p.add_argument("--probe-images", type=int, default=20,
                   help="images in the --select-best probe subset")
    p.add_argument("--no-compact-ingress", action="store_true",
                   help="upload train batches as f32 instead of uint16/8 "
                        "fixed point (compact ingress is on by default for "
                        "the CLI)")
    p.add_argument("--u8-ingress", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="quantize the compact train wire at 1/255 (uint8) "
                        "instead of 1/65535; --no-u8-ingress keeps the "
                        "uint16 wire")
    p.add_argument("--probe-metric", default="psnr",
                   choices=["psnr", "auc"],
                   help="quality axis for --select-best: 'psnr' probes a "
                        "UCB subset (needs --probe-part-masks); 'auc' probes "
                        "SFW shadow-segmentation ROC-AUC (--probe-data "
                        "points at an SFW-format dir glob)")
    _add_common(p)
    _add_device(p)

    p = sub.add_parser("preprocess",
                       help="offline crop/align (reference: dataprocess.py)")
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--size", type=int, default=256)
    _add_device(p)

    p = sub.add_parser(
        "e2e",
        help="raw uncropped images -> deshadowed faces, one warm pass "
             "(detect + align + crop + deshadow)")
    p.add_argument("--input", required=True,
                   help="dir of raw PNGs; a sibling <name>.npy 68x2 "
                        "landmark file skips the neural detect+align stages "
                        "for that image")
    p.add_argument("--output", required=True)
    p.add_argument("--fan-weights", default=None,
                   help="npz of converted 2D-FAN weights for the align "
                        "stage (tools/convert_fan_weights.py)")
    p.add_argument("--sfd-weights", default=None,
                   help="npz of converted S3FD weights for the detect "
                        "stage (tools/convert_sfd_weights.py)")
    p.add_argument("--det-size", type=int, default=640,
                   help="canonical detector input (host letterbox)")
    p.add_argument("--det-batch", type=int, default=4)
    p.add_argument("--fan-batch", type=int, default=16)
    p.add_argument("--serve-batch", type=int, default=16,
                   help="generator batch in the deshadow stage")
    p.add_argument("--batch-files", type=int, default=16,
                   help="images read from disk per pipeline call")
    p.add_argument("--overlap", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="run the read/detect/align/crop/deshadow stages as "
                        "a depth-1 thread pipeline over file chunks; "
                        "--no-overlap restores strictly serial stages")
    p.add_argument("--min-face", type=int, default=250,
                   help="reject faces below this crop side "
                        "(dataprocess.py:66)")
    _add_common(p)
    _add_device(p)

    p = sub.add_parser("landmarks",
                       help="offline landmark detection "
                            "(reference: bmvc2022-dataprocess.py)")
    p.add_argument("--input", required=True)
    p.add_argument("--fan-weights", default=None,
                   help="npz of converted 2D-FAN weights "
                        "(tools/convert_fan_weights.py) — runs the port's "
                        "FAN (models/fan.py). Without it the optional "
                        "face_alignment package is used instead")
    p.add_argument("--sfd-weights", default=None,
                   help="npz of converted S3FD detector weights "
                        "(tools/convert_sfd_weights.py) — detect the face "
                        "box (models/sfd.py) before the FAN pass")
    p.add_argument("--face-box", default=None,
                   help="x1,y1,x2,y2 face box applied to every image on the "
                        "FAN path (overrides detection; default without "
                        "--sfd-weights: whole frame)")
    _add_device(p)
    return ap


# the attention kernels each subcommand launches on CUDA
_KERNELS = {"infer": ("nonlocal_attn",), "ucb": ("nonlocal_attn",),
            "sfw": ("nonlocal_attn",), "sfw-video": ("nonlocal_attn",),
            "e2e": ("nonlocal_attn",),
            "train": ("nonlocal_attn", "nonlocal_attn_bwd")}


def _imread_rgb(path: str) -> np.ndarray:
    """uint8 RGB of a PNG, as cv2.cvtColor(cv2.imread(p), BGR2RGB)."""
    from blindshadowremoval_tpu_torch.utils.imageio import imread

    return np.ascontiguousarray(imread(path)[..., ::-1])


def _restore(cfg):
    """(the generator's state dict, the manager, the calibrated config)
    of the newest checkpoint under cfg.checkpoint_dir: only the
    generator's tensors are read, into a template of the live-BatchNorm
    f32-egress generator; the int8 head is calibrated from them (folding,
    which consumes the BatchNorm statistics, comes after, in
    `build_generator`)."""
    from blindshadowremoval_tpu_torch.ops.calibration import calibrate_config
    from blindshadowremoval_tpu_torch.train.trainer import init_generator_vars
    from blindshadowremoval_tpu_torch.utils.checkpoint import CheckpointManager

    base = dataclasses.replace(cfg, fold_bn=False, egress_dtype="float32")
    _, template = init_generator_vars(base)
    mgr = CheckpointManager(cfg.checkpoint_dir)
    state_dict, step = mgr.restore_eval(template)
    print(f"Restore from step {step}")
    return state_dict, mgr, calibrate_config(cfg, state_dict)


def main(argv=None):
    args = build_parser().parse_args(argv)

    from blindshadowremoval_tpu_torch.config import resolve_device
    from blindshadowremoval_tpu_torch.data.dataset import stop_parse_servers

    try:
        dev = resolve_device(args.device)
    except RuntimeError:
        print("no CUDA device is available: pass --device cpu to run on "
              "the CPU", file=sys.stderr)
        return 2
    if dev.type == "cuda":
        from blindshadowremoval_tpu_torch.ops import _build

        for name in _KERNELS.get(args.cmd, ()):
            _build.load(name)
    try:
        return _run(args, dev)
    finally:
        # the train iterator's forkserver and resource tracker would
        # outlive the command by the time they take to see it gone; the
        # iterators (held in cycles by their datasets) close first
        gc.collect()
        stop_parse_servers()


def _run(args, dev):
    from blindshadowremoval_tpu_torch.config import get_config

    if args.cmd == "preprocess":
        return run_preprocess(args)
    if args.cmd == "landmarks":
        return run_landmarks(args, dev)
    if args.cmd == "e2e":
        return run_e2e(args, dev)

    preset = {"infer": "in_the_wild", "ucb": "ucb", "sfw": "sfw",
              "sfw-video": "sfw_video", "train": "train"}[args.cmd]
    overrides = dict(img_size=args.img_size, checkpoint_dir=args.ckpt)
    if args.variant:
        overrides["variant"] = args.variant
    if getattr(args, "int8_head", False):
        overrides["int8_head"] = True
    if getattr(args, "int8_head_scale", 0.0):
        overrides["int8_head_scale"] = args.int8_head_scale
    if getattr(args, "fold_bn", False) and args.cmd != "train":
        overrides["fold_bn"] = True
    if args.cmd == "train":
        overrides.update(
            data_dirs=tuple(args.data),
            data_dirs_val=tuple(args.val or ()),
            shadow_mask_dir=args.shadow_masks,
            steps_per_epoch=args.steps_per_epoch,
            max_epoch=args.max_epoch, batch_size=args.batch_size,
            learning_rate=args.lr,
            lr_decay_factor=args.lr_decay,
            lr_decay_epochs=args.lr_decay_epochs,
            log_every_steps=args.log_every,
            device_geometry=args.device_geometry,
            device_darken=args.device_darken)
        if not args.no_compact_ingress:
            overrides["compact_ingress"] = True
            if args.u8_ingress:
                overrides["ingress_u8"] = True
        if args.select_best:
            needs_masks = args.probe_metric == "psnr"
            if not args.probe_data or (needs_masks
                                       and not args.probe_part_masks):
                print("--select-best needs --probe-data"
                      + (" and --probe-part-masks"
                         if needs_masks else " (an SFW-format dir glob)"),
                      file=sys.stderr)
                return 2
            overrides["data_dirs_test"] = (args.probe_data,)
            if args.probe_part_masks:
                overrides["part_mask_root"] = args.probe_part_masks
    else:
        overrides["data_dirs_test"] = (args.data,)
        if getattr(args, "eval_views", None) is not None:
            if args.eval_views < 1:
                print(f"--eval-views must be >= 1, got {args.eval_views}",
                      file=sys.stderr)
                return 2
            overrides["eval_views"] = args.eval_views
        if getattr(args, "device_geometry", False):
            overrides["device_geometry"] = True
        if args.cmd == "ucb" and not args.no_compact_ingress:
            overrides["compact_ingress"] = True
    cfg = get_config(preset, **overrides)

    # the TSM UCB protocol forwards a fixed anchor + mirror pair, so
    # --eval-views does not apply there: refused rather than ignored
    if cfg.variant == "tsm" and args.cmd == "ucb" and \
            getattr(args, "eval_views", None) is not None:
        print("--eval-views does not apply to --variant tsm ucb eval: the "
              "TSM protocol always forwards the anchor + mirrored pair "
              "(train_with_TSM.py:431-433)", file=sys.stderr)
        return 2

    from blindshadowremoval_tpu_torch.data.dataset import Dataset

    if args.cmd == "train":
        return run_train(cfg, args, dev)

    state_dict, _, cfg = _restore(cfg)
    from blindshadowremoval_tpu_torch.eval.evaluators import (
        InTheWildEvaluator,
        SFWEvaluator,
        SFWVideoEvaluator,
        UCBEvaluator,
    )

    def _check(ds):
        if not ds.name_list:
            print(f"no samples matched {cfg.data_dirs_test} "
                  "(need <name>.png + <name>.npy landmark pairs)",
                  file=sys.stderr)
        return ds

    if args.cmd == "infer":
        if args.engine == "serving":
            return run_infer_serving(cfg, state_dict, args, dev)
        ds = _check(Dataset(cfg, "test", seed=args.seed))
        InTheWildEvaluator(cfg, state_dict, device=dev).run(ds)
    elif args.cmd == "ucb":
        ds = Dataset(cfg, "test", seed=args.seed)
        ipc = args.images_per_call
        if cfg.variant == "rgb" and not args.rgb_heuristics:
            ipc = 1   # the simple-composite protocol has no fused step
        results = UCBEvaluator(cfg, state_dict, device=dev).run(
            ds, args.part_masks, rgb_heuristics=args.rgb_heuristics,
            images_per_call=ipc)
        ps = [r["psnr"] for r in results]
        ss = [r["ssim"] for r in results]
        print(f"UCB mean PSNR {np.mean(ps):.3f}  mean SSIM {np.mean(ss):.4f}")
    elif args.cmd == "sfw":
        ds = Dataset(cfg, "test", dset="sfw", seed=args.seed)
        results = SFWEvaluator(cfg, state_dict, device=dev).run(ds)
        print(f"SFW mean AUC {np.mean([r['auc'] for r in results]):.4f}")
    elif args.cmd == "sfw-video":
        ds = Dataset(cfg, "test", dset="sfw", seed=args.seed)
        SFWVideoEvaluator(cfg, state_dict, device=dev).run(
            ds, args.export_bbox)
    return 0


def run_infer_serving(cfg, state_dict, args, dev):
    """In-the-wild inference through the batched serving engine: the
    evaluator path's inputs and result strips, all images through one
    ShadowRemovalService with device-rasterized geometry and compact
    wires (uint16 ingress, uint8 / f16 egress)."""
    from blindshadowremoval_tpu_torch.eval.serving import ShadowRemovalService
    from blindshadowremoval_tpu_torch.utils.logging import TrainLogger

    names, images, lms = [], [], []
    for pattern in cfg.data_dirs_test:
        for folder in sorted(glob.glob(pattern)):
            for lm_path in sorted(glob.glob(folder + "/*.npy")):
                png = lm_path.rsplit(".", 1)[0] + ".png"
                if not os.path.isfile(png):
                    continue
                names.append(lm_path)
                images.append(_imread_rgb(png) / 255.0)
                lms.append(np.load(lm_path))
    if not names:
        print(f"no samples matched {cfg.data_dirs_test} "
              "(need <name>.png + <name>.npy landmark pairs)",
              file=sys.stderr)
        return 1
    svc = ShadowRemovalService(
        dataclasses.replace(cfg, compact_output=True, compact_ingress=True),
        state_dict, batch_size=min(64, max(1, len(names))), device=dev)
    results = svc.remove_shadows(images, lms)
    log = TrainLogger(cfg.checkpoint_dir)
    for name, r in zip(names, results):
        log.save_result_image(
            [r["img"][None], r["pred"][None], r["mask_pred"][None] * 2.0],
            name)
    print(f"wrote {len(results)} result strips to "
          f"{cfg.checkpoint_dir}/test/")
    return 0


def run_train(cfg, args, dev):
    from blindshadowremoval_tpu_torch.data.dataset import Dataset
    from blindshadowremoval_tpu_torch.train.loop import fit
    from blindshadowremoval_tpu_torch.train.trainer import Trainer

    vgg_weights = None
    if args.vgg_weights:
        from blindshadowremoval_tpu_torch.models.vgg import load_weights_npz

        vgg_weights = load_weights_npz(args.vgg_weights)
        print(f"Perceptual loss: pretrained VGG-19 from {args.vgg_weights}")
    trainer = Trainer.shared(cfg, vgg_weights, device=dev)
    ds_train = Dataset(cfg, "train", seed=args.seed)
    ds_val = (Dataset(cfg, "val", seed=args.seed + 1)
              if cfg.data_dirs_val else None)
    fit(cfg, ds_train, ds_val, trainer=trainer,
        select_best=args.select_best, probe_images=args.probe_images,
        probe_metric=args.probe_metric, device=dev)
    return 0


def _fan_modules(state_dict: dict) -> int:
    """The hourglass stacks of a FAN state dict (its `m<i>.` modules)."""
    return 1 + max(int(k.split(".")[0][1:]) for k in state_dict
                   if k.startswith("m") and k.split(".")[0][1:].isdigit())


def run_e2e(args, dev):
    """Raw images -> deshadowed faces (eval/e2e.py): detect + align + crop
    + deshadow, every neural stage warm and batched on one device."""
    from blindshadowremoval_tpu_torch.config import get_config
    from blindshadowremoval_tpu_torch.eval.e2e import DeshadowPipeline

    overrides = dict(img_size=args.img_size, checkpoint_dir=args.ckpt,
                     device_geometry=True)
    if args.variant:
        overrides["variant"] = args.variant
    if args.int8_head:
        overrides["int8_head"] = True
    if args.int8_head_scale:
        overrides["int8_head_scale"] = args.int8_head_scale
    if args.fold_bn:
        overrides["fold_bn"] = True
    cfg = get_config("in_the_wild", **overrides)
    state_dict, _, cfg = _restore(cfg)

    fan_sd = sfd_sd = None
    if args.fan_weights:
        from blindshadowremoval_tpu_torch.models.fan import load_fan_npz

        fan_sd = load_fan_npz(args.fan_weights)
    if args.sfd_weights:
        from blindshadowremoval_tpu_torch.models.sfd import load_sfd_npz

        sfd_sd = load_sfd_npz(args.sfd_weights)
    pipe = DeshadowPipeline(
        dataclasses.replace(cfg, compact_output=True, compact_ingress=True),
        state_dict, fan_weights=fan_sd, sfd_weights=sfd_sd,
        det_size=args.det_size, det_batch=args.det_batch,
        fan_batch=args.fan_batch,
        fan_modules=4 if fan_sd is None else _fan_modules(fan_sd),
        min_face=args.min_face, device=dev, batch_size=args.serve_batch)
    stats = pipe.run_dir(args.input, args.output,
                         batch_files=args.batch_files, overlap=args.overlap)
    print("e2e:", {k: (round(v, 4) if isinstance(v, float) else v)
                   for k, v in stats.items()})
    return 0


def run_preprocess(args):
    """Offline crop (dataprocess.py contract): for every <name>.png with
    <name>.npy landmarks under --input, write the crop and its rescaled
    landmarks to --output/<name>/.  Host work only."""
    from blindshadowremoval_tpu_torch.geometry.crop import offline_crop
    from blindshadowremoval_tpu_torch.utils.imageio import write_png

    n_ok = 0
    for png in sorted(glob.glob(os.path.join(args.input, "*.png"))):
        npy = png.rsplit(".", 1)[0] + ".npy"
        if not os.path.isfile(npy):
            continue
        res = offline_crop(_imread_rgb(png), np.load(npy),
                           out_size=args.size)
        if res is None:
            print(f"skip (face too small): {png}")
            continue
        crop, lm = res
        name = os.path.splitext(os.path.basename(png))[0]
        outdir = os.path.join(args.output, name)
        os.makedirs(outdir, exist_ok=True)
        write_png(os.path.join(outdir, name + ".png"), crop.astype(np.uint8))
        np.save(os.path.join(outdir, name + ".npy"), lm)
        n_ok += 1
    print(f"preprocessed {n_ok} faces -> {args.output}")
    return 0


def run_landmarks(args, dev):
    """Offline 68-point landmark detection (bmvc2022-dataprocess.py
    contract).  With --fan-weights: the port's 2D-FAN, one call an image,
    optionally after the S3FD face detector (--sfd-weights) or with an
    explicit --face-box.  Otherwise the optional `face_alignment`
    package."""
    if args.fan_weights:
        from blindshadowremoval_tpu_torch.models import fan

        fan_sd = fan.load_fan_npz(args.fan_weights)
        net = fan.build_fan(fan_sd, _fan_modules(fan_sd), device=dev)
        box = (tuple(float(v) for v in args.face_box.split(","))
               if args.face_box else None)
        detector = None
        if box is None and args.sfd_weights:
            from blindshadowremoval_tpu_torch.models import sfd

            s3fd = sfd.build_s3fd(sfd.load_sfd_npz(args.sfd_weights),
                                  device=dev)
            detector = lambda img: sfd.detect_faces(s3fd, img)  # noqa: E731
        for png in sorted(glob.glob(os.path.join(args.input, "*.png"))):
            img = _imread_rgb(png)
            img_box = box
            if detector is not None:
                dets = detector(img)
                if not len(dets):
                    print(f"no face: {png}")
                    continue
                img_box = tuple(dets[0, :4])   # best-scoring box, like fa
            pts = fan.landmarks_from_image(net, img, box=img_box)
            np.save(png.rsplit(".", 1)[0] + ".npy", pts)
            print(f"landmarks: {png}")
        return 0

    try:
        import face_alignment
    except ImportError:
        print("no --fan-weights given and face_alignment is not installed; "
              "landmark detection needs the FAN CNN (bmvc2022-dataprocess."
              "py:10). Convert a 2DFAN checkpoint with "
              "tools/convert_fan_weights.py, or provide 68x2 .npy landmarks "
              "from any detector.", file=sys.stderr)
        return 2

    fa = face_alignment.FaceAlignment(
        face_alignment.LandmarksType.TWO_D, flip_input=False,
        device=str(dev))
    for png in sorted(glob.glob(os.path.join(args.input, "*.png"))):
        preds = fa.get_landmarks(_imread_rgb(png))
        if not preds:
            print(f"no face: {png}")
            continue
        np.save(png.rsplit(".", 1)[0] + ".npy", preds[0])
        print(f"landmarks: {png}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
