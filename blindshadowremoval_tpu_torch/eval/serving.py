"""Batched inference service (port of
`blindshadowremoval_tpu/eval/serving.py:ShadowRemovalService`).

Requests (a face image and its 68 landmarks) are cropped and aligned on
the host, stacked into fixed-size batches (the tail batch padded), sent to
the device, run through the generator, clipped and face-gated there, and
fetched back.

Usage:
    svc = ShadowRemovalService(cfg, state_dict, batch_size=64)
    outputs = svc.remove_shadows(images, landmarks)   # N images in, N out

Not ported yet: the `mesh` option (ROADMAP F1), int8 calibration (F4) and
the `BatchingFrontend` (A6's second half).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

from blindshadowremoval_tpu_torch.config import Config, resolve_device
from blindshadowremoval_tpu_torch.data.dataset import _geometry_primitives
from blindshadowremoval_tpu_torch.geometry.crop import face_crop_and_resize
from blindshadowremoval_tpu_torch.geometry.landmarks import LM_REF
from blindshadowremoval_tpu_torch.geometry.triangulation import (
    device_geometry_maps,
    generate_face_region,
    generate_offset_map,
    generate_uv_map,
)
from blindshadowremoval_tpu_torch.models import build_generator


@dataclasses.dataclass
class ShadowRemovalService:
    """Batched inference over the GSC generator.

    The wires come from the config: `device_geometry` rasterizes the UV,
    offset and face maps on the device from landmarks and Delaunay
    topologies (the host ships only those); `compact_ingress` sends the
    cropped [0,1] image (and the UV map in host-maps mode) as uint16 fixed
    point, dequantized on the device; `compact_output` returns uint8
    predictions and f16 shadow maps.  `state_dict` holds unfolded weights
    (see `models/build_generator`)."""

    config: Config
    state_dict: Any = None
    batch_size: int = 64
    device: Any = None

    def __post_init__(self):
        cfg = self.config
        self.device = resolve_device(self.device)
        self.gen = build_generator(cfg, self.state_dict, self.device)
        # snapshot the wires: the call paths below read these, even if a
        # caller replaces the config afterwards
        self._compact = cfg.compact_output
        self._devgeo = cfg.device_geometry
        self._compact_in = cfg.compact_ingress

    # ----------------------------------------------------------- pipeline
    def preprocess(self, image: np.ndarray, landmarks: np.ndarray) -> dict:
        """Host side of one request: crop/align, then either the geometry
        primitives (device geometry) or the host-rasterized maps."""
        s = self.config.img_size
        crop, lm, _, box = face_crop_and_resize(image, landmarks, s)
        crop = np.asarray(crop, np.float32)
        if self._devgeo:
            return {"img": crop, "box": box, **_geometry_primitives(lm)}
        return {
            "img": crop,
            "uv": generate_uv_map(lm, s),
            "reg": np.concatenate([generate_offset_map(lm, LM_REF, s),
                                   generate_offset_map(LM_REF, lm, s)], 2),
            "face": generate_face_region(lm, s),
            "box": box,
        }

    def stage(self, chunk: Sequence[dict]) -> tuple:
        """Stack one chunk of preprocessed views (at most batch_size, the
        tail padded to batch_size) and send it to the device.  Returns the
        device tensors `forward_staged` takes."""
        n = len(chunk)
        bs = self.batch_size
        if n > bs:
            raise ValueError(f"chunk of {n} exceeds batch_size {bs}")

        def stack(key, fill=0.0):
            arr = np.stack([v[key] for v in chunk])
            if self._compact_in and key in ("img", "uv"):
                # [0,1] fixed-point wire format, dequantized on the device
                arr = np.rint(np.clip(arr, 0.0, 1.0)
                              * 65535.0).astype(np.uint16)
            elif not np.issubdtype(arr.dtype, np.integer):
                arr = arr.astype(np.float32)
            if n < bs:   # pad the tail batch to the batch shape
                pad = np.full((bs - n,) + arr.shape[1:], fill, arr.dtype)
                arr = np.concatenate([arr, pad])
            return torch.from_numpy(arr).to(self.device)

        if self._devgeo:
            return (stack("img"), stack("lm"), stack("face_pts"),
                    stack("uv_tris", -1), stack("face_tris", -1),
                    stack("reg_tris", -1))
        return (stack("img"), stack("uv"), stack("reg"))

    @torch.inference_mode()
    def _forward(self, staged: tuple) -> tuple[torch.Tensor, torch.Tensor]:
        """Device side of one batch: maps, generator, clip, face gate and
        the egress cast."""
        s = self.config.img_size
        if self._devgeo:
            img, lm, face_pts, uv_tris, face_tris, reg_tris = staged
            maps = device_geometry_maps(lm, face_pts, uv_tris, face_tris,
                                        reg_tris, s)
            uv, reg, face = maps["uv"], maps["reg"], maps["face"]
        else:
            (img, uv, reg), face = staged, None
        _, rgb, _, dif = self.gen(_dequant(img), _dequant(uv), reg)
        rgb = rgb.clamp(0.0, 1.0)
        if face is not None:
            dif = dif * face
        if self._compact:
            return (torch.round(rgb * 255.0).to(torch.uint8),
                    dif.to(torch.float16))
        return rgb, dif

    def forward_staged(self, staged: tuple,
                       chunk: Sequence[dict]) -> list[dict]:
        """Run the forward on `stage()`'s product and unpack the per-view
        result dicts (the device-to-host fetch happens here)."""
        n = len(chunk)
        rgb, dif = self._forward(staged)
        rgb, dif = _to_host(rgb)[:n], _to_host(dif)[:n]
        if self._compact:
            rgb = rgb.astype(np.float32) / 255.0
            dif = dif.astype(np.float32)
        results: list[dict] = []
        for i, v in enumerate(chunk):
            results.append({
                # device geometry gates mask_pred by the face map on the
                # device; the host-maps path multiplies here
                "pred": rgb[i],
                "mask_pred": dif[i] if self._devgeo else dif[i] * v["face"],
                "box": v["box"],
                "img": v["img"],        # the cropped/aligned input
            })
        return results

    def remove_shadows(self, images: Sequence[np.ndarray],
                       landmarks: Sequence[np.ndarray]) -> list[dict]:
        """N (image, 68x2 landmarks) pairs -> N {'pred', 'mask_pred', 'box',
        'img'} dicts, in batches of batch_size."""
        views = [self.preprocess(im, lm) for im, lm in zip(images, landmarks)]
        results: list[dict] = []
        bs = self.batch_size
        for start in range(0, len(views), bs):
            chunk = views[start:start + bs]
            results.extend(self.forward_staged(self.stage(chunk), chunk))
        return results


def _dequant(x: torch.Tensor) -> torch.Tensor:
    """uint16 [0,1] fixed point -> f32 on the device; anything else as is.
    uint16 takes few torch ops, so it is converted before any arithmetic."""
    if x.dtype == torch.uint16:
        return x.to(torch.float32) / 65535.0
    return x


def _to_host(t: torch.Tensor) -> np.ndarray:
    # numpy has no bfloat16: a bf16 egress arrives on the host as f32
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()
