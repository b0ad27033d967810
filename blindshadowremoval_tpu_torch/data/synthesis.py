"""Shadow synthesis: supervised pairs from clean faces (port of
`blindshadowremoval_tpu/data/synthesis.py`).

On the device, in the train step:

  * `compose_shadow_image`, the reference's `process_mask`
    (train_test_GSC.py:81-105).  Per sample: keep the external shadow mask
    (60%) or draw a face-gated Perlin mask; soften it by subsurface
    scattering (75%) or plain inversion; draw a brightness field with
    floor 0.3 or 0.5 (50/50); composite
    img = gt * mask_ss + img_dark * mask_sv * intensity.  The JAX package
    computes one `lax.cond` branch per vmapped sample; here each branch
    runs once, batched over the samples that chose it.
  * `derive_darkened_views`, the `device_darken` wire: the tone-curve
    jitter and darkened twin of each mirrored pair (ops/tonecurve.py).

On the host, in the train parser (utils.py:902-1055 in the reference):

  * `ShadowMaker`, the external occluder: a mask from a PNG library (or a
    procedural Perlin mask from a pool), scaled, rotated, blurred and
    placed over the face, with the motion parameters of the reference;
  * `shadow_synthesis_host`: the tone curve (unless the step derives it)
    and the occluder of one training crop.

The host half takes the caller's numpy Generator and makes exactly the
JAX package's numpy draws in its order, so one seed leaves both streams
aligned; where the JAX package seeds a jax key from the stream (the tone
curve, the Perlin render), the port seeds a CPU `torch.Generator` from the
same draw.  Images are read, resized and blurred with the port's own code
(utils/imageio.py, ops/filters.py), not cv2.
"""

from __future__ import annotations

import glob as _glob
from typing import Optional

import numpy as np
import torch

from blindshadowremoval_tpu_torch.geometry.crop import rotate_center
from blindshadowremoval_tpu_torch.geometry.landmarks import forehead_points
from blindshadowremoval_tpu_torch.geometry.triangulation import (
    generate_face_region,
)
from blindshadowremoval_tpu_torch.ops.filters import box_blur
from blindshadowremoval_tpu_torch.ops.perlin import (
    _take,
    brightness_mask,
    draw_brightness,
    draw_perlin_mask,
    render_perlin_mask,
)
from blindshadowremoval_tpu_torch.ops.ssscatter import apply_ss_shadow_map, draw_ss
from blindshadowremoval_tpu_torch.ops.tonecurve import (
    draw_face_darken,
    face_darken_from_draws,
)
from blindshadowremoval_tpu_torch.utils.imageio import imread, resize_linear


def darkened_views_from_draws(g1: torch.Tensor, g2: torch.Tensor,
                              gt_raw: torch.Tensor):
    """`gt_raw`: [2P, S, S, 3] raw crops with each mirrored pair adjacent
    (even rows unflipped, the parse_train layout); g1, g2: [P, 3] tone
    gains, one draw per pair, shared by its mirror as the host parser
    shares one face_darken result.  Returns (gt, img_dark), both clamped
    to [0, 1] and interleaved back: the compact wire clamps the host pair
    alike, and unclamped CTM excursions (~[-0.25, 1.3]) destabilize the
    bf16 step."""
    img_aug, img_dark, _ = face_darken_from_draws(gt_raw[0::2], g1, g2)

    def interleave(x):
        x = x.clamp(0.0, 1.0)
        return torch.stack([x, x.flip(2)], dim=1).reshape(gt_raw.shape)

    return interleave(img_aug), interleave(img_dark)


def derive_darkened_views(gen: torch.Generator, gt_raw: torch.Tensor,
                          rows: tuple[int, int] | None = None):
    """The `device_darken` wire (synthesis.py:45-70): the tone-curve pair
    of every mirrored pair of `gt_raw`, its gains drawn from `gen` on the
    device.  `rows` (global views, first view of `gt_raw`): the gains are
    drawn for the global batch and `gt_raw`'s pairs keep theirs."""
    total, first = rows or (gt_raw.shape[0], 0)
    g1, g2 = draw_face_darken(gen, total // 2, gt_raw.device)
    pairs = slice(first // 2, (first + gt_raw.shape[0]) // 2)
    return darkened_views_from_draws(g1[pairs], g2[pairs], gt_raw)


def draw_compose(gen: torch.Generator, b: int, device) -> dict:
    """Every random draw of `compose_from_draws` for a batch of b samples."""
    keep = torch.rand((b,), generator=gen, device=device) > 0.4
    use_ss = torch.rand((b,), generator=gen, device=device) > 0.25
    low_floor = torch.rand((b,), generator=gen, device=device) > 0.5
    min_val = torch.where(low_floor, 0.3, 0.5).to(torch.float32)
    return {"keep_ext": keep, "perlin": draw_perlin_mask(gen, b, device),
            "use_ss": use_ss, "ss": draw_ss(gen, b, device),
            "brightness": draw_brightness(gen, min_val, device)}


def compose_from_draws(draws: dict, mask: torch.Tensor, gt: torch.Tensor,
                       img_dark: torch.Tensor, face: torch.Tensor):
    """The deterministic compositor.  mask/face [B,S,S,1], gt/img_dark
    [B,S,S,3].  Returns (img, mask_sv, mask_edge), each [B,S,S,3]."""
    s = gt.shape[1]
    mask = mask.clone()
    fresh = (~draws["keep_ext"]).nonzero().flatten()
    if fresh.numel():
        mask[fresh] = face[fresh] * render_perlin_mask(
            _take(draws["perlin"], fresh), (s, s))
    inv = 1.0 - mask
    mask_ss = inv.expand(-1, -1, -1, 3).clone()
    ss = draws["use_ss"].nonzero().flatten()
    if ss.numel():
        mask_ss[ss] = apply_ss_shadow_map(_take(draws["ss"], ss), inv[ss])
    mask_sv = 1.0 - mask_ss
    intensity = brightness_mask(draws["brightness"], (s, s))[..., None]
    img = gt * mask_ss + img_dark * mask_sv * intensity
    img = torch.clamp(img, 0.0, 1.0)
    mask_edge = (mask_sv - mask).abs()
    return img, mask_sv, mask_edge


def compose_shadow_image(gen: torch.Generator, mask: torch.Tensor,
                         gt: torch.Tensor, img_dark: torch.Tensor,
                         face: torch.Tensor,
                         rows: tuple[int, int] | None = None):
    """Batched compositor with its draws taken from `gen` (on the inputs'
    device).  Returns (img, mask_sv, mask_edge), each [B,S,S,3].  `rows`
    (global batch size, first row of these B): the draws are made for the
    global batch and these rows keep theirs, so a batch split over ranks
    gets the noise of the whole batch in one process."""
    b = gt.shape[0]
    total, first = rows or (b, 0)
    draws = _take(draw_compose(gen, total, gt.device), slice(first, first + b))
    return compose_from_draws(draws, mask, gt, img_dark, face)


def _host_generator(rng: np.random.Generator) -> torch.Generator:
    """A CPU torch.Generator seeded by one draw of `rng`: the draw the JAX
    package makes to seed its jax key."""
    return torch.Generator().manual_seed(int(rng.integers(0, 2 ** 31)))


class ShadowMaker:
    """External-occluder shadow mask generator (utils.py:902-1013).

    Draws a mask from a PNG library (else a procedural Perlin mask), places
    it relative to a random facial landmark, with per-instance motion
    (translate/shake), rotation, scale and blur; `compute_mask(t)` renders
    it at time t, so video frames get coherent moving shadows.  `face=None`
    (with `size`) skips the face gating: `compute_mask` returns the raw
    canvas, and the device-geometry train step gates it by the face it
    rasterizes.
    """

    # a process-wide pool of procedural masks: each is scaled, rotated,
    # blurred and moved downstream, so a slowly refreshed pool is close in
    # distribution to a fresh render a sample, at a fraction of the cost;
    # one draw in 16 renders a random slot anew
    _MASK_POOL: list = []
    _MASK_POOL_SIZE = 32

    @classmethod
    def reset_pool(cls) -> None:
        """Empty the procedural-mask pool (it outlives every instance)."""
        cls._MASK_POOL.clear()

    def __init__(self, face: Optional[np.ndarray], lm: np.ndarray,
                 mask_dir: Optional[str] = None,
                 rng: Optional[np.random.Generator] = None,
                 size: Optional[int] = None):
        self.rng = rng if rng is not None else np.random.default_rng()
        self.face = face
        self.size = face.shape[0] if face is not None else int(size)
        self.lm = lm
        self.motion = self.rng.integers(1, 3)          # 1 trans, 2 shake
        self.spd_x = self.rng.uniform(0.1, 10.0)
        self.spd_y = self.rng.uniform(0.1, 10.0)
        self.scale = self.rng.uniform(1.0, 2.5)
        self.rot = self.rng.uniform(0.0, 365.0)
        self.blur = int(self.rng.integers(10, 15))
        self.mask_dir = mask_dir
        self._compile_mask()

    # -- internals -----------------------------------------------------
    def _load_library_mask(self) -> Optional[np.ndarray]:
        if not self.mask_dir:
            return None
        files = sorted(_glob.glob(self.mask_dir.rstrip("/") + "/*.png"))
        if not files:
            return None
        path = files[int(self.rng.integers(0, len(files)))]
        return (imread(path, gray=True) / 255.0).astype(np.float32)

    def _render_mask(self) -> np.ndarray:
        gen = _host_generator(self.rng)
        pm = render_perlin_mask(draw_perlin_mask(gen, 1, "cpu"), (256, 256))
        return (pm[0, ..., 0].numpy() > 0.5).astype(np.float32)

    def _procedural_mask(self) -> np.ndarray:
        pool = ShadowMaker._MASK_POOL
        if len(pool) < ShadowMaker._MASK_POOL_SIZE:
            pool.append(self._render_mask())
            return pool[-1]
        if self.rng.uniform() < 1.0 / 16.0:
            slot = int(self.rng.integers(0, len(pool)))
            pool[slot] = self._render_mask()
            return pool[slot]
        return pool[int(self.rng.integers(0, len(pool)))]

    @staticmethod
    def _blur(mask: np.ndarray, k: int) -> np.ndarray:
        """`cv2.blur(mask, (k, k))` of a 2-D mask."""
        t = torch.from_numpy(np.ascontiguousarray(mask))[None, :, :, None]
        return box_blur(t, k)[0, :, :, 0].numpy()

    def _compile_mask(self):
        mask = self._load_library_mask()
        if mask is None:
            mask = self._procedural_mask()
        if self.rng.uniform(0.0, 1.0) > 0.75:
            mask = 1.0 - mask

        lm = self.lm * self.size
        lm = np.concatenate([lm, forehead_points(lm, 0.6)], axis=0)

        length = max((lm[:, 0].max() - lm[:, 0].min()) / 2,
                     (lm[:, 1].max() - lm[:, 1].min()) / 2)
        start_center = np.array(lm[int(self.rng.integers(17, 67)), :])
        if self.rng.uniform(-1.0, 1.0) > 0:
            # face-covering placement (utils.py:954-963)
            start_center[0] = (lm[:, 0].max() + lm[:, 0].min()) / 2
            start_center[1] = (lm[:, 1].max() + lm[:, 1].min()) / 2
            shape = max(int(length * 2), 10)
            mask = resize_linear(mask, (shape, shape))
            mask = self._blur(mask, self.blur // 2)
        else:
            # landmark-anchored placement (utils.py:964-975)
            start_center[0] += length * self.rng.uniform(-0.05, 0.05)
            start_center[1] += length * self.rng.uniform(-0.05, 0.05)
            shape = max(int(length * self.scale * 2), 10)
            mask = resize_linear(mask, (shape, shape))
            mask = self._blur(rotate_center(mask, self.rot), self.blur)
        self.mask = mask[..., None]
        self.mask_shape = shape
        self.mask_center = start_center

    # -- api -----------------------------------------------------------
    def compute_mask(self, time: float):
        """The (mask * face, face) pair at time step `time`
        (utils.py:981-1013); with face=None the ungated canvas and None."""
        face = self.face
        fh = fw = self.size
        ms = self.mask_shape
        cx = int(self.mask_center[0] + self.spd_x * time)
        cy = int(self.mask_center[1] + self.spd_y * time)

        box = [cx - ms // 2, cy - ms // 2,
               cx + ms - ms // 2, cy + ms - ms // 2]
        mbox = [0, 0, ms, ms]
        if box[0] < 0:
            mbox[0] = -box[0]
        if box[2] > fw:
            mbox[2] = ms - (box[2] - fw)
        if box[1] < 0:
            mbox[1] = -box[1]
        if box[3] > fh:
            mbox[3] = ms - (box[3] - fh)
        box = [max(box[0], 0), max(box[1], 0), min(box[2], fw),
               min(box[3], fh)]

        canvas = np.zeros(
            (fh, fw, face.shape[2] if face is not None else 1), np.float32)
        canvas[box[1]:box[3], box[0]:box[2], :] = \
            self.mask[mbox[1]:mbox[3], mbox[0]:mbox[2], :]
        if face is None:
            return canvas, None
        return canvas * face, face


def shadow_synthesis_host(gt: np.ndarray, lm: np.ndarray, time: float = 0.0,
                          mask_dir: Optional[str] = None,
                          rng: Optional[np.random.Generator] = None,
                          seed: Optional[int] = None,
                          rasterize_face: bool = True,
                          darken: bool = True):
    """Host pair synthesis of one crop (utils.py:1025-1055).

    Returns (img, img_dark, mask, color_matrix, face): the colour-jittered
    face, its darkened twin, the external shadow mask, the 3x3 CTM and the
    soft face region.  `rasterize_face=False` returns the UNGATED mask and
    no face (the device-geometry wire gates by the face it rasterizes);
    `darken=False` returns the raw crop and no twin (the device-darken wire
    derives the pair in the step).
    """
    rng = rng if rng is not None else np.random.default_rng(seed)
    width = gt.shape[0]
    face = generate_face_region(lm, width) if rasterize_face else None
    if darken:
        g1, g2 = draw_face_darken(_host_generator(rng), 1, "cpu")
        img, img_dark, ctm = (t[0].numpy() for t in face_darken_from_draws(
            torch.from_numpy(np.asarray(gt, np.float32))[None], g1, g2))
    else:
        img, img_dark, ctm = np.asarray(gt, np.float32), None, None

    maker = ShadowMaker(face, lm, mask_dir=mask_dir, rng=rng, size=width)
    mask, face = maker.compute_mask(time)
    return (img, img_dark, mask.astype(np.float32), ctm,
            face.astype(np.float32) if face is not None else None)
