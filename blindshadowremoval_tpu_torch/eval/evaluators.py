"""Evaluation harnesses: in-the-wild, UCB (PSNR/SSIM), SFW (AUC), SFW video
(port of `blindshadowremoval_tpu/eval/evaluators.py`, GSC variant).

Re-design of the reference's eval loops (train_test_GSC.py:360-932):

  * `InTheWildEvaluator`  - testFFHQ: forward, face-gate the mask, save a
    result strip (no metrics, gt unknown);
  * `UCBEvaluator`        - test(): forward with 10 reference views, resize
    the anchor prediction into the original crop box, run the heuristic
    post-processor (eval/postprocess.py, or on the device eval/fused.py),
    composite, report PSNR/SSIM;
  * `SFWEvaluator`        - testsfw: shadow-mask PSNR/SSIM + pixel ROC-AUC
    against `*_label.png` (label==2 is the shadow class,
    train_test_GSC.py:820);
  * `SFWVideoEvaluator`   - testsfw_video: per-frame removal outputs +
    optional bbox export.

Each builds the port's generator from a `state_dict` (models/weights.py
makes one from JAX variables or TF-named arrays) on `device`: CUDA unless
the caller passes "cpu", and never the CPU on its own.  Forwards run under
`torch.inference_mode`; the metrics run on the same device.  Not ported:
the TSM protocol (`run_one_tsm`, ROADMAP D1) and the RGB ablation's simple
composite (`run_one_simple`, ROADMAP D2).
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
from blindshadowremoval_tpu_torch.ops.image import dequantize
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

    def _gen_views(self, views: dict) -> tuple:
        """Generator 4-tuple and face map of device views [B, S, S, C]:
        geometry rasterized on the device under config.device_geometry,
        the host-rasterized maps otherwise (no face map then; the GSC
        forward reads no offset map, model.py:221)."""
        img = dequantize(views["img"])
        if self._devgeo:
            maps = device_geometry_maps(
                *(views[k] for k in _GEOMETRY_KEYS), self.config.img_size)
            return self.gen(img, maps["uv"], maps["reg"]), maps["face"]
        return self.gen(img, dequantize(views["uv"])), None

    def metrics(self, gt: np.ndarray, out: np.ndarray) -> tuple[float, float]:
        """(SSIM, PSNR) of a single [H,W,C] pair, on the device."""
        a, b = self._tensor(gt)[None].float(), self._tensor(out)[None].float()
        return float(ssim_fn(a, b)[0]), float(psnr_fn(a, b)[0])

    @torch.inference_mode()
    def forward(self, batch: dict) -> tuple:
        """batch: dict of [V,S,S,C] views.  Returns (gs, rgb, mask22, dif,
        face) as numpy arrays; `dif` is the shadow-probability map
        `mask_pred`, `face` the soft face region (from the batch, or
        rasterized on the device under config.device_geometry)."""
        keys = ("img",) + (_GEOMETRY_KEYS if self._devgeo else ("uv",))
        out, face = self._gen_views({k: self._tensor(batch[k]) for k in keys})
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
        """The 4-tuple forward the fused step wraps, on flattened views."""
        return lambda views: self._gen_views(views)[0]

    def _ingress(self, batch: dict, to_device: bool = True) -> dict:
        """Host->device payload for the fused step: only the keys it reads
        (the GSC forward ignores `reg`, and the part-mask face replaces
        `face`); under `config.compact_ingress` the [0,1] planes go as
        uint16 fixed point, dequantized on the device."""
        needed = {"img", "gt"} | (set(_GEOMETRY_KEYS) if self._devgeo
                                  else {"uv"})
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
        tmp = _pad_to(_resize_np(img0, size), s)
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
        params = PostprocessParams() if params is None else params
        pi = prep_part_inputs(self._resized_parts(parts, size), params)
        step = build_fused_ucb_step(self._fused_fwd(), params, s)
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
        params = PostprocessParams() if params is None else params
        k = images_per_call
        self.label_iterations = []
        step_fn = build_fused_ucb_batch_step(self._fused_fwd(), params, s)

        def chunks():
            metas, jbs, sizes, pis = [], [], [], []
            for step, (batch, box, name) in enumerate(iter(dataset)):
                parts = self._load_part_masks(
                    part_mask_root, step,
                    sample_name=name if key_masks_by_name else None)
                size = int(min(box[3] - box[1], s))
                pis.append(prep_part_inputs(
                    self._resized_parts(parts, size), params))
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

    def run_one_simple(self, *args, **kwargs):
        raise NotImplementedError(
            "the RGB ablation's UCB protocol is not ported yet (ROADMAP D2)")

    def run_one_tsm(self, *args, **kwargs):
        raise NotImplementedError(
            "the TSM variant's UCB protocol is not ported yet (ROADMAP D1)")

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
            images_per_call: int = 1):
        """fused=None selects the fused path (run_one_fused; the same
        detected masks as the host-orchestrated run_one).  Part masks pair
        by file name by default and raise on a missing mask;
        key_masks_by_name=False restores the reference's positional
        pairing.  images_per_call > 1 runs the fused path k images a pass
        (run_fused_batched)."""
        if images_per_call > 1:
            if fused is False:
                raise ValueError("images_per_call > 1 requires the fused path")
            return self.run_fused_batched(
                dataset, part_mask_root, params=params,
                images_per_call=images_per_call,
                key_masks_by_name=key_masks_by_name)
        params = PostprocessParams() if params is None else params
        runner = self.run_one if fused is False else self.run_one_fused

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

    def run_one(self, batch: dict, box: np.ndarray, name: str):
        _, rgb, _, mask_pred, face = self.forward(batch)
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
        _, rgb, _, mask_pred, face = self.forward(batch)
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
