"""Evaluation harnesses: in-the-wild, UCB (PSNR/SSIM), SFW (AUC), SFW video
(port of `blindshadowremoval_tpu/eval/evaluators.py`), for the gsc, tsm
and rgb generator variants.

Re-design of the reference's eval loops (train_test_GSC.py:360-932):

  * `InTheWildEvaluator`  - testFFHQ: forward, face-gate the mask, save a
    result strip (no metrics, gt unknown);
  * `UCBEvaluator`        - test(): forward with 10 reference views, resize
    the anchor prediction into the original crop box, run the heuristic
    post-processor (eval/postprocess.py, or on the device eval/fused.py),
    composite, report PSNR/SSIM; the TSM variant's protocol (anchor + mirror,
    frame=1, heuristics at full resolution, `run_one_tsm`) and the RGB
    ablation's simple face-mask composite (`run_one_simple`) beside it;
  * `SFWEvaluator`        - testsfw: shadow-mask PSNR/SSIM + pixel ROC-AUC
    against `*_label.png` (label==2 is the shadow class,
    train_test_GSC.py:820);
  * `SFWVideoEvaluator`   - testsfw_video: per-frame removal outputs +
    optional bbox export.

Each builds the port's generator from a `state_dict` (models/weights.py
makes one from JAX variables or TF-named arrays) on `device`: CUDA unless
the caller passes "cpu", and never the CPU on its own.  Forwards run under
`torch.inference_mode`; the metrics run on the same device.  Every variant
gives the GSC 4-tuple (gs, rgb, mask22, dif): RGB's single output is
wrapped as (gray, out, 0, gray - gray(img)).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional

import numpy as np
import torch

from blindshadowremoval_tpu_torch.config import Config, resolve_device
from blindshadowremoval_tpu_torch.data.dataset import prefetch
from blindshadowremoval_tpu_torch.eval.fused import (
    PartInputs,
    build_fused_ucb_batch_step,
    build_fused_ucb_step,
    prep_part_inputs,
)
from blindshadowremoval_tpu_torch.eval.postprocess import (
    TSM_PARAMS,
    PostprocessParams,
    composite,
    ucb_postprocess,
)
from blindshadowremoval_tpu_torch.eval.serving import _to_host as _host
from blindshadowremoval_tpu_torch.geometry.triangulation import (
    device_geometry_maps,
)
from blindshadowremoval_tpu_torch.models import build_generator
from blindshadowremoval_tpu_torch.ops.auc import roc_auc_with_sentinels
from blindshadowremoval_tpu_torch.ops.image import dequantize, rgb_to_grayscale
from blindshadowremoval_tpu_torch.ops.image import psnr as psnr_fn
from blindshadowremoval_tpu_torch.ops.image import ssim as ssim_fn
from blindshadowremoval_tpu_torch.utils.imageio import imread, resize_linear
from blindshadowremoval_tpu_torch.utils.logging import TrainLogger

# the keys the generator's forward reads, by geometry mode
_GEOMETRY_KEYS = ("lm", "face_pts", "uv_tris", "face_tris", "reg_tris")


def _resize_np(img: np.ndarray, size: int) -> np.ndarray:
    out = resize_linear(img, (size, size))
    return out[..., None] if out.ndim == 2 else out


def _pad_to(img: np.ndarray, size: int) -> np.ndarray:
    return np.pad(img, ((0, size - img.shape[0]), (0, size - img.shape[1]),
                        (0, 0)))


@dataclasses.dataclass
class Evaluator:
    """Shared forward machinery."""

    config: Config
    state_dict: Any = None         # the generator's unfolded weights
    logger: Optional[TrainLogger] = None
    device: Any = None

    def __post_init__(self):
        cfg = self.config
        self.device = resolve_device(self.device)
        self.gen = build_generator(cfg, self.state_dict, self.device)
        if self.logger is None:
            self.logger = TrainLogger(cfg.checkpoint_dir)
        self._devgeo = cfg.device_geometry

    def _tensor(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _apply_gen(self, img, uv, reg, frame: int, share: bool) -> tuple:
        """The variant's forward as the GSC 4-tuple (evaluators.py:76-89):
        TSM takes the offset maps, `frame` and `share`; RGB's output is
        wrapped as (gray, out, 0, gray - gray(img))."""
        variant = self.config.variant
        if variant == "tsm":
            return self.gen(img, uv, reg, frame=frame, share=share)
        out = self.gen(img, uv)
        if variant == "rgb":
            gray = rgb_to_grayscale(out)
            return gray, out, torch.zeros_like(out), \
                gray - rgb_to_grayscale(img)
        return out

    def _gen_views(self, views: dict, frame: int = 1,
                   share: bool = True) -> tuple:
        """Generator 4-tuple and face map of device views [B, S, S, C]:
        geometry rasterized on the device under config.device_geometry,
        the host-rasterized maps otherwise (no face map then; only the TSM
        forward reads the offset maps, model.py:221)."""
        img = dequantize(views["img"])
        if self._devgeo:
            maps = device_geometry_maps(
                *(views[k] for k in _GEOMETRY_KEYS), self.config.img_size)
            return self._apply_gen(img, maps["uv"], maps["reg"], frame,
                                   share), maps["face"]
        return self._apply_gen(img, dequantize(views["uv"]), views.get("reg"),
                               frame, share), None

    def metrics(self, gt: np.ndarray, out: np.ndarray) -> tuple[float, float]:
        """(SSIM, PSNR) of a single [H,W,C] pair, on the device."""
        a, b = self._tensor(gt)[None].float(), self._tensor(out)[None].float()
        return float(ssim_fn(a, b)[0]), float(psnr_fn(a, b)[0])

    def _view_keys(self) -> tuple:
        """The batch keys the forward reads."""
        if self._devgeo:
            return ("img",) + _GEOMETRY_KEYS
        return ("img", "uv") + (("reg",) if self.config.variant == "tsm"
                                else ())

    @torch.inference_mode()
    def forward(self, batch: dict, frame: int = 1, share: bool = True) -> tuple:
        """batch: dict of [V,S,S,C] views.  Returns (gs, rgb, mask22, dif,
        face) as numpy arrays; `dif` is the shadow-probability map
        `mask_pred`, `face` the soft face region (from the batch, or
        rasterized on the device under config.device_geometry).  `frame`
        and `share` reach the TSM ShareLayer only."""
        out, face = self._gen_views(
            {k: self._tensor(batch[k]) for k in self._view_keys()}, frame,
            share)
        face = _host(face) if face is not None else np.asarray(batch["face"])
        return tuple(_host(o) for o in out) + (face,)


class InTheWildEvaluator(Evaluator):
    """testFFHQ (train_test_GSC.py:840-890)."""

    def run_one(self, batch: dict, box: np.ndarray, name: str):
        _, rgb, _, mask_pred, face = self.forward(batch)
        mask_pred = mask_pred * face
        rgb = np.clip(rgb, 0.0, 1.0)
        figs = [batch["img"][:1], rgb[:1], mask_pred[:1] * 2.0]
        path = self.logger.save_result_image(figs, name)
        return {"result_path": path, "pred": rgb[0], "mask_pred": mask_pred[0]}

    def run(self, dataset):
        return [self.run_one(batch, box, name)
                for batch, box, name in prefetch(iter(dataset))]


class UCBEvaluator(Evaluator):
    """test() with heuristic post-processing (train_test_GSC.py:360-748)."""

    PART_DIRS = {
        "face_hair": "UCB_input_images_face_masks_cropped_and_padded_with_hair",
        "face_no_hair": "UCB_input_images_face_masks_cropped_and_padded",
        "mouth": "UCB_input_images_mouth_masks_cropped_and_padded",
        "nose": "UCB_input_images_nose_masks_cropped_and_padded",
        "eyebrow": "UCB_input_images_eyebrow_masks_cropped_and_padded",
        "eye": "UCB_input_images_eye_masks_cropped_and_padded",
        "glasses": "UCB_input_images_glasses_masks_cropped_and_padded",
    }

    def _load_part_masks(self, root: str, index: int,
                         sample_name: Optional[str] = None) -> dict:
        """Load the 7 per-image part masks ([H, W, 3] f64 in [0, 1], cv2's
        BGR order, as the JAX package reads them).

        With `sample_name` (the image's landmark path) pairing is keyed by
        file name, `<id>_<stem>-result.png` (the reference's own mask
        fixtures' scheme), raising when a mask is missing.  Without it
        pairing is positional, `sorted(listdir)[index]` against the
        natsorted sample list, as the reference does
        (train_test_GSC.py:372,387-393); it silently misaligns if the mask
        directory and the image set diverge, so `run()` keys by name."""
        if sample_name is not None:
            folder = os.path.basename(os.path.dirname(sample_name))
            stem = os.path.basename(sample_name).split(".")[0]
            fname = f"{folder}_{stem}-result.png"
        else:
            names = sorted(
                os.listdir(os.path.join(root, self.PART_DIRS["face_hair"])))
            fname = names[index]
        out = {}
        for key, d in self.PART_DIRS.items():
            path = os.path.join(root, d, fname)
            if not os.path.isfile(path):   # missing in ANY of the 7 dirs
                hint = (" (name-keyed pairing; pass key_masks_by_name=False "
                        "for the reference's positional pairing if your mask "
                        "dirs use a different naming scheme)"
                        if sample_name else "")
                raise FileNotFoundError(
                    f"part mask {path!r} missing"
                    + (f" for sample {sample_name!r}" if sample_name else "")
                    + hint)
            out[key] = imread(path) / 255.0
        return out

    def _resized_parts(self, parts: dict, size: int) -> dict:
        s = self.config.img_size
        return {k: _pad_to(np.round(_resize_np(v, size)), s)
                for k, v in parts.items()}

    def _fused_fwd(self):
        """The 4-tuple forward the fused step wraps, on flattened views
        (frame=1: TSM forwards anchor and mirror as groups of one)."""
        return lambda views: self._gen_views(views)[0]

    @property
    def _is_tsm(self) -> bool:
        return self.config.variant == "tsm"

    def _protocol(self, params: Optional[PostprocessParams]):
        """(params, protocol) of the variant's fused UCB step: the TSM
        protocol runs the heuristics at full resolution with TSM_PARAMS by
        default (evaluators.py:294-303)."""
        if params is None:
            params = TSM_PARAMS if self._is_tsm else PostprocessParams()
        return params, "tsm" if self._is_tsm else "gsc"

    def _part_inputs(self, parts: dict, size: int, params) -> PartInputs:
        """The TSM protocol takes the unresized part masks; the others
        resize them into the crop box."""
        return prep_part_inputs(
            parts if self._is_tsm else self._resized_parts(parts, size),
            params)

    def _ingress(self, batch: dict, to_device: bool = True) -> dict:
        """Host->device payload for the fused step: only the keys it reads
        (`reg` only for TSM with host maps, and the part-mask face replaces
        `face`); under `config.compact_ingress` the [0,1] planes go as
        uint16 fixed point, dequantized on the device."""
        needed = {"gt", *self._view_keys()}
        out = {}
        for k, v in batch.items():
            if k not in needed:
                continue
            if self.config.compact_ingress and k in ("img", "gt", "uv"):
                v = np.rint(np.clip(np.asarray(v), 0.0, 1.0)
                            * 65535.0).astype(np.uint16)
            out[k] = self._tensor(v) if to_device else np.asarray(v)
        return out

    def _panels(self, img0, gt0, size: int, kept, out_u8, mp_u8, name: str):
        """Finish one fused result on the host: the 5-panel strip (input,
        composite, 2x shadow map, gt, detected) and the result dict's
        arrays."""
        s = self.config.img_size
        pred = np.asarray(out_u8, np.float32) / 255.0
        detected = np.repeat(np.asarray(kept, np.float32), 3, axis=2)
        mp = np.repeat(np.asarray(mp_u8, np.float32) / 255.0, 3, axis=2)
        # TSM shows the unresized input: its composite ran at full size
        tmp = img0 if self._is_tsm else _pad_to(_resize_np(img0, size), s)
        gt_sc = _pad_to(_resize_np(gt0, size), s)
        self.logger.save_result_image(
            [tmp[None], pred[None], mp[None] * 2, gt_sc[None],
             detected[None]], name)
        return pred, detected

    def run_one_fused(self, batch: dict, box: np.ndarray, name: str,
                      parts: dict,
                      params: Optional[PostprocessParams] = None):
        """One device pass an image: forward (with the geometry rasterized
        on the device under config.device_geometry) + resize-into-box +
        heuristics + connected components + composite + PSNR/SSIM
        (eval/fused.py)."""
        s = self.config.img_size
        size = int(min(box[3] - box[1], s))
        params, protocol = self._protocol(params)
        pi = self._part_inputs(parts, size, params)
        step = build_fused_ucb_step(self._fused_fwd(), params, s,
                                    protocol)
        kept, out_u8, mp_u8, psnr, ssim = step(
            self._ingress(batch), float(size), pi.to(self.device))
        pred, detected = self._panels(
            batch["img"][0], batch["gt"][0], size, _host(kept),
            _host(out_u8), _host(mp_u8), name)
        return {"ssim": float(ssim), "psnr": float(psnr),
                "pred": pred, "detected": detected}

    def _stack_chunk(self, metas, jbs, sizes, pis, k):
        """Pad a tail chunk to k (repeating its last image) and stack the
        per-image pieces into one device payload.  `metas` stays unpadded:
        padded lanes are never drained."""
        pad = k - len(jbs)
        jbs = jbs + [jbs[-1]] * pad
        sizes = sizes + [sizes[-1]] * pad
        pis = pis + [pis[-1]] * pad
        stacked = {key: np.stack([b[key] for b in jbs]) for key in jbs[0]}
        return metas, stacked, np.asarray(sizes, np.float32), \
            PartInputs.stack(pis)

    def _drain_fused_chunk(self, metas, out, results: list, total: int):
        """Fetch one batched fused call's outputs and finish the real (not
        padded) lanes on the host: panels, figure strip, metric display."""
        kept, out_u8, mp_u8, psnr, ssim = (_host(o) for o in out)
        for j, (step, name, size, img0, gt0) in enumerate(metas):
            pred, detected = self._panels(img0, gt0, size, kept[j],
                                          out_u8[j], mp_u8[j], name)
            r = {"ssim": float(ssim[j]), "psnr": float(psnr[j]),
                 "pred": pred, "detected": detected}
            self.logger.display({"ssim": r["ssim"], "psnr": r["psnr"]},
                                0, step, False, total)
            results.append(r)

    def run_fused_batched(self, dataset, part_mask_root: str,
                          params: Optional[PostprocessParams] = None,
                          images_per_call: int = 8,
                          key_masks_by_name: bool = True) -> list:
        """The k-image UCB eval: every `images_per_call` images run as one
        fused device pass (eval/fused.py:build_fused_ucb_batch_step), the
        next chunk's host parse overlapping it (prefetch thread); the tail
        chunk is padded to k.  Metrics and masks equal the per-image fused
        path's: the same arithmetic with a leading image axis.  Records
        each pass's label-propagation iterations in
        `self.label_iterations`."""
        s = self.config.img_size
        params, protocol = self._protocol(params)
        k = images_per_call
        self.label_iterations = []
        step_fn = build_fused_ucb_batch_step(self._fused_fwd(), params,
                                             s, protocol)

        def chunks():
            metas, jbs, sizes, pis = [], [], [], []
            for step, (batch, box, name) in enumerate(iter(dataset)):
                parts = self._load_part_masks(
                    part_mask_root, step,
                    sample_name=name if key_masks_by_name else None)
                size = int(min(box[3] - box[1], s))
                pis.append(self._part_inputs(parts, size, params))
                metas.append((step, name, size,
                              np.asarray(batch["img"][0]),
                              np.asarray(batch["gt"][0])))
                jbs.append(self._ingress(batch, to_device=False))
                sizes.append(size)
                if len(jbs) == k:
                    yield self._stack_chunk(metas, jbs, sizes, pis, k)
                    metas, jbs, sizes, pis = [], [], [], []
            if jbs:
                yield self._stack_chunk(metas, jbs, sizes, pis, k)

        results: list = []
        for metas, stacked, sizes, pi in prefetch(chunks()):
            report: dict = {}
            out = step_fn({kk: self._tensor(v) for kk, v in stacked.items()},
                          self._tensor(sizes), pi.to(self.device), report)
            self.label_iterations.append(report["label_iterations"])
            self._drain_fused_chunk(metas, out, results,
                                    len(dataset.name_list))
        return results

    def run_one_simple(self, batch: dict, box: np.ndarray, name: str,
                       parts: dict):
        """The RGB ablation's protocol (train_RGB_test.py:403-505): no
        heuristic detection; the raw prediction (not clipped before the
        resize) is composited through the rounded face(+hair) part mask and
        clipped after, then scored against the box-resized gt."""
        s = self.config.img_size
        size = int(min(box[3] - box[1], s))
        _, rgb, _, _, _ = self.forward(batch)
        gt_sc = _pad_to(_resize_np(batch["gt"][0], size), s)
        tmp = _pad_to(_resize_np(batch["img"][0], size), s)
        pred = _pad_to(_resize_np(rgb[0], size), s)
        mask = _pad_to(np.round(_resize_np(parts["face_hair"], size)), s)
        out = np.clip(pred * mask + tmp * (1.0 - mask), 0.0, 1.0)
        ssim, psnr = self.metrics(gt_sc, out)
        self.logger.save_result_image([tmp[None], out[None], gt_sc[None]],
                                      name)
        return {"ssim": ssim, "psnr": psnr, "pred": out, "detected": mask}

    def run_one_tsm(self, batch: dict, box: np.ndarray, name: str,
                    parts: dict, params: PostprocessParams = TSM_PARAMS):
        """The TSM variant's protocol (train_with_TSM.py:369-617): anchor +
        mirror forwarded with frame=1; the heuristics run at full size
        against the unresized part masks; the raw prediction is composited
        at full size and clipped, then resized into the box and padded."""
        s = self.config.img_size
        size = int(min(box[3] - box[1], s))
        _, rgb, _, mask_pred, _ = self.forward(batch, frame=1)
        gt_sc = _pad_to(_resize_np(batch["gt"][0], size), s)
        tmp = batch["img"][0]
        mp = mask_pred[0]
        mp = np.repeat(mp, 3, axis=2) if mp.shape[2] == 1 else mp
        detected, mp_gated = ucb_postprocess(
            mp, tmp, parts["face_hair"], parts["face_no_hair"],
            parts["mouth"], parts["nose"], parts["eyebrow"], parts["eye"],
            parts["glasses"], params, device=self.device)
        out = np.clip(rgb[0] * detected + tmp * (1.0 - detected), 0.0, 1.0)
        out = _pad_to(_resize_np(out, size), s)
        ssim, psnr = self.metrics(gt_sc, out)
        self.logger.save_result_image(
            [tmp[None], out[None], mp_gated[None] * 2, gt_sc[None],
             detected[None]], name)
        return {"ssim": ssim, "psnr": psnr, "pred": out, "detected": detected}

    def run_one(self, batch: dict, box: np.ndarray, name: str, parts: dict,
                params: PostprocessParams = PostprocessParams()):
        """The host-orchestrated form: forward on the device, resize and
        gates on the host, components on the device, metrics on the
        device."""
        s = self.config.img_size
        size = int(min(box[3] - box[1], s))
        _, rgb, _, mask_pred, _ = self.forward(batch)

        # anchor view, resized into the crop box then padded back to 256
        # (train_test_GSC.py:435-476)
        gt_sc = _pad_to(_resize_np(batch["gt"][0], size), s)
        tmp = _pad_to(_resize_np(batch["img"][0], size), s)
        pred = _pad_to(_resize_np(np.clip(rgb[0], 0, 1), size), s)
        mp = _pad_to(_resize_np(mask_pred[0], size), s)
        mp = np.repeat(mp, 3, axis=2) if mp.shape[2] == 1 else mp

        part = self._resized_parts(parts, size)

        detected, _ = ucb_postprocess(
            mp, tmp, part["face_hair"], part["face_no_hair"], part["mouth"],
            part["nose"], part["eyebrow"], part["eye"], part["glasses"],
            params, device=self.device)
        out = composite(pred, tmp, detected)

        ssim, psnr = self.metrics(gt_sc, out)
        figs = [tmp[None], out[None], mp[None] * 2, gt_sc[None],
                detected[None]]
        self.logger.save_result_image(figs, name)
        return {"ssim": ssim, "psnr": psnr, "pred": out, "detected": detected}

    def run(self, dataset, part_mask_root: str,
            params: Optional[PostprocessParams] = None,
            fused: Optional[bool] = None, key_masks_by_name: bool = True,
            rgb_heuristics: bool = False, images_per_call: int = 1):
        """fused=None selects the fused path (run_one_fused; the same
        detected masks as the host-orchestrated run_one, or run_one_tsm for
        the TSM variant).  variant="rgb" runs the simple face-mask
        composite (run_one_simple) unless rgb_heuristics=True opts into the
        heuristic pipeline on its grayscale-difference map.  params=None
        takes the variant's constants (TSM_PARAMS for tsm).  Part masks
        pair by file name by default and raise on a missing mask;
        key_masks_by_name=False restores the reference's positional
        pairing.  images_per_call > 1 runs the fused path k images a pass
        (run_fused_batched)."""
        simple = self.config.variant == "rgb" and not rgb_heuristics
        if images_per_call > 1:
            if simple or fused is False:
                raise ValueError(
                    "images_per_call > 1 requires the fused path (gsc/tsm "
                    "protocols, or rgb with rgb_heuristics=True)")
            return self.run_fused_batched(
                dataset, part_mask_root, params=params,
                images_per_call=images_per_call,
                key_masks_by_name=key_masks_by_name)
        if simple:
            if params is not None:
                raise ValueError(
                    "params has no effect on the RGB simple-composite "
                    "protocol; pass rgb_heuristics=True to run the "
                    "heuristic pipeline with custom params")

            def runner(batch, box, name, parts, params):
                return self.run_one_simple(batch, box, name, parts)
        else:
            params = self._protocol(params)[0]
            host = self.run_one_tsm if self._is_tsm else self.run_one
            runner = host if fused is False else self.run_one_fused

        def items():
            for step, (batch, box, name) in enumerate(dataset):
                parts = self._load_part_masks(
                    part_mask_root, step,
                    sample_name=name if key_masks_by_name else None)
                yield step, batch, box, name, parts

        results = []
        # host parse + mask IO for image i+1 overlaps image i's device work
        for step, batch, box, name, parts in prefetch(items()):
            r = runner(batch, box, name, parts, params)
            self.logger.display({"ssim": r["ssim"], "psnr": r["psnr"]},
                                0, step, False, len(dataset.name_list))
            results.append(r)
        return results


class SFWEvaluator(Evaluator):
    """testsfw (train_test_GSC.py:798-838): shadow segmentation metrics."""

    def run_one(self, batch: dict, box: np.ndarray, name: str,
                frame: int = 2, share: bool = True):
        """frame=2: the TSM variant's sample is the frame and its mirror."""
        _, rgb, _, mask_pred, face = self.forward(batch, frame, share)
        mask_pred = mask_pred * face
        rgb = np.clip(rgb, 0.0, 1.0)

        label_raw = batch["label"][0]
        pred0 = mask_pred[0]
        ssim, psnr = self.metrics(label_raw, pred0)
        shadow_gt = (label_raw == 2).astype(np.float32)   # label==2 is shadow
        auc = float(roc_auc_with_sentinels(self._tensor(shadow_gt),
                                           self._tensor(pred0)))
        figs = [batch["img"][:1], rgb[:1], mask_pred[:1] * 2,
                shadow_gt[None]]
        self.logger.save_result_image(figs, name)
        return {"ssim": ssim, "psnr": psnr, "auc": auc,
                "pred": rgb[0], "mask_pred": pred0}

    def run(self, dataset):
        results = []
        for step, (batch, box, name) in enumerate(prefetch(iter(dataset))):
            r = self.run_one(batch, box, name)
            self.logger.display(
                {"ssim": r["ssim"], "psnr": r["psnr"], "auc": r["auc"]},
                0, step, False, len(dataset.name_list))
            results.append(r)
        return results


class SFWVideoEvaluator(Evaluator):
    """testsfw_video (train_test_GSC.py:772-796,892-932)."""

    def run_one(self, batch: dict, box: np.ndarray, name: str,
                export_bbox_dir: Optional[str] = None):
        # the 10 frames are one TSM group
        _, rgb, _, mask_pred, face = self.forward(batch, frame=10)
        mask_pred = mask_pred * face
        rgb = np.clip(rgb, 0.0, 1.0)
        figs = [batch["img"][:1], rgb[:1], mask_pred[:1] * 2]
        self.logger.save_result_image(figs, name)
        if export_bbox_dir:
            import scipy.io

            os.makedirs(export_bbox_dir, exist_ok=True)
            parts = name.replace("\\", "/").split("/")
            scipy.io.savemat(
                os.path.join(export_bbox_dir,
                             f"{parts[-2]}_{parts[-1]}.mat"),
                {"bbox": np.asarray(box)})
        return {"pred": rgb, "mask_pred": mask_pred}

    def run(self, dataset, export_bbox_dir: Optional[str] = None):
        return [self.run_one(batch, box, name, export_bbox_dir)
                for batch, box, name in prefetch(iter(dataset))]
