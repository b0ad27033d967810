"""UCB evaluation step on the device, k images a call (port of
`blindshadowremoval_tpu/eval/fused.py`).

The host-orchestrated UCB pipeline (eval/postprocess.py) fetches the
forward's outputs, resizes and gates them on the host and runs the
components on the device in between.  This module keeps everything after
the upload on the device:

    forward -> dynamic resize/pad into the crop box -> face gating ->
    mustache/mouth suppression -> spatially varying threshold (the
    data-dependent band gates as per-image selects) -> connected components
    -> hair veto -> nose veto -> composite -> PSNR/SSIM

Every input has an explicit leading image axis (the JAX package vmaps a
per-image step instead): the k*V views go through the generator as one
batch, and the scalar gates the reference computes with host `if`s on
mask-derived scalars (train_test_GSC.py:541-663) become [k,1,1,1] selects,
so nothing waits on the host between the forward and the metrics except the
components' convergence test.  Geometry that depends only on the part masks
(bounding boxes, region rectangles) is precomputed on the host by
`prep_part_inputs`: it is input data, not control flow.

The crop-box resize (`tf.image.resize(x, [size, size])` + pad to 256,
train_test_GSC.py:438-476) has a data-dependent size; as a product
out = A @ x @ A^T with a bilinear matrix A built from the per-image size
(rows >= size zero, the pad), shapes stay fixed.  The products run in f64
and round once to f32, so no TF32 setting of the process can reach them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from blindshadowremoval_tpu_torch.eval.postprocess import (
    PostprocessParams,
    _bbox,
)
from blindshadowremoval_tpu_torch.ops.components import (
    filter_components,
    label_components_batched,
)
from blindshadowremoval_tpu_torch.ops.image import dequantize
from blindshadowremoval_tpu_torch.ops.image import psnr as psnr_fn
from blindshadowremoval_tpu_torch.ops.image import ssim as ssim_fn
from blindshadowremoval_tpu_torch.parallel.mesh import (
    batch_sharding,
    gather,
    shard_batch,
)


def dynamic_resize_matrix(size, n: int = 256) -> torch.Tensor:
    """[..., n, n] f32 bilinear matrix equivalent to resize(n -> size) +
    zero pad, for each entry of `size` (a scalar or a tensor of sizes).

    Row i < size samples the input at the half-pixel source coordinate
    (i + 0.5) * n/size - 0.5, placed in f32 as the JAX package places it
    (tf.image.resize / cv2.INTER_LINEAR convention, coordinates clamped);
    rows i >= size are zero."""
    size = torch.as_tensor(size, dtype=torch.float32)[..., None]
    i = torch.arange(n, dtype=torch.float32, device=size.device)
    src = ((i + 0.5) * (n / size) - 0.5).clamp(0.0, n - 1.0)
    j0 = torch.floor(src)
    frac = src - j0
    j0i = j0.long()
    j1i = torch.clamp(j0i + 1, max=n - 1)
    a = ((1.0 - frac)[..., None] * F.one_hot(j0i, n).float()
         + frac[..., None] * F.one_hot(j1i, n).float())
    return a * (i < size)[..., None]


def resize_into_box(img: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Apply the dynamic resize matrix a [..., n, n] on both spatial axes of
    img [..., H, W, C]; the products run in f64, the result is f32."""
    x = img.double()
    ad = a.double()
    rows = torch.einsum("...ij,...jwc->...iwc", ad, x)
    return torch.einsum("...wl,...ilc->...iwc", ad, rows).float()


@dataclasses.dataclass
class PartInputs:
    """Host-precomputed, part-mask-derived inputs to the fused step: [S,S,1]
    f32 maps (numpy from `prep_part_inputs`), [k,S,S,1] after `stack`,
    tensors after `to`.  Nothing here depends on the model's outputs."""

    face_hair: np.ndarray
    hair_region: np.ndarray
    mustache_rect: np.ndarray
    mouth_rect: np.ndarray
    below_mouth_roi: np.ndarray     # below-mouth rectangle * face_no_hair
    forehead_rect: np.ndarray       # zeros when the eyebrow gate is off
    brow_edge_gate: np.ndarray      # zeros when the left-brow gate is off
    nose_mask: np.ndarray
    nose_veto_short: np.ndarray     # rectangle for the dark-image reach
    nose_veto_long: np.ndarray

    @staticmethod
    def stack(items: list["PartInputs"]) -> "PartInputs":
        """k per-image PartInputs -> one with a leading image axis."""
        return PartInputs(**{
            f.name: np.stack([getattr(p, f.name) for p in items])
            for f in dataclasses.fields(PartInputs)})

    def to(self, device) -> "PartInputs":
        """The same fields as f32 tensors on `device`."""
        return PartInputs(**{
            f.name: torch.as_tensor(np.asarray(getattr(self, f.name)),
                                    dtype=torch.float32).to(device)
            for f in dataclasses.fields(PartInputs)})


def prep_part_inputs(part: dict, params: PostprocessParams) -> PartInputs:
    """Build PartInputs from resized/rounded/padded part masks (the same
    dict UCBEvaluator feeds ucb_postprocess).  Mirrors the host-side
    geometry of eval/postprocess.py exactly."""
    p = params
    s = part["face_hair"].shape[0]

    def rect(r0, r1, c0, c1):
        m = np.zeros((s, s, 1), np.float32)
        m[int(r0):int(r1), int(c0):int(c1)] = 1.0
        return m

    zeros = np.zeros((s, s, 1), np.float32)
    nose_box = _bbox(part["nose"][..., 0])
    mouth_box = _bbox(part["mouth"][..., 0])

    mustache_rect, mouth_rect, below_roi = zeros, zeros, zeros
    if nose_box and mouth_box:
        mid_nose_h = (nose_box[0] + nose_box[1]) / 2.0
        mustache_rect = rect(mid_nose_h, mouth_box[0],
                             mouth_box[2], mouth_box[3])
        mouth_rect = rect(mouth_box[0], mouth_box[1],
                          mouth_box[2], mouth_box[3])
    if mouth_box:
        below = rect(mouth_box[0], s, 0, s)
        below_roi = below * part["face_no_hair"][..., :1]

    forehead_rect = zeros
    # all-channel sum, like the reference's np.sum(curr_eyebrow_mask)
    # (train_test_GSC.py:528) and the host twin (eval/postprocess.py)
    if part["eyebrow"].sum() > p.forehead_min_eyebrow:
        brow_box = _bbox(part["eyebrow"][..., 0])
        fh = np.array(part["face_no_hair"], copy=True)
        fh[brow_box[0]:s, :, :] = 0
        fh_box = _bbox(fh[..., 0])
        if fh_box:
            forehead_rect = rect(fh_box[0] + 20, brow_box[0] - 40,
                                 fh_box[2] + 40, fh_box[3] - 40)

    brow_edge_gate = zeros
    if part["eyebrow"][..., 0].sum() > 0:
        brow_box = _bbox(part["eyebrow"][..., 0])
        face_box = _bbox(part["face_no_hair"][..., 0])
        if brow_box and face_box and (brow_box[2] - face_box[2]) == 0:
            mid_face = face_box[2] * 0.8 + face_box[3] * 0.2
            left = rect(0, s, 0, mid_face)
            brow_edge_gate = part["eyebrow"][..., :1] * left

    nose_short, nose_long = zeros, zeros
    if nose_box:
        mid_nose_h = (nose_box[0] + nose_box[1]) / 2.0
        mid_nose_w = (nose_box[2] + nose_box[3]) / 2.0
        nose_short = rect(mid_nose_h, nose_box[1] + p.nose_veto_short,
                          mid_nose_w - p.nose_veto_halfwidth,
                          mid_nose_w + p.nose_veto_halfwidth)
        nose_long = rect(mid_nose_h, nose_box[1] + p.nose_veto_long,
                         mid_nose_w - p.nose_veto_halfwidth,
                         mid_nose_w + p.nose_veto_halfwidth)

    return PartInputs(
        face_hair=part["face_hair"][..., :1].astype(np.float32),
        hair_region=(part["face_hair"][..., :1]
                     - part["face_no_hair"][..., :1]).astype(np.float32),
        mustache_rect=mustache_rect, mouth_rect=mouth_rect,
        below_mouth_roi=below_roi.astype(np.float32),
        forehead_rect=forehead_rect.astype(np.float32),
        brow_edge_gate=brow_edge_gate.astype(np.float32),
        nose_mask=part["nose"][..., :1].astype(np.float32),
        nose_veto_short=nose_short, nose_veto_long=nose_long)


def _sum3(x: torch.Tensor) -> torch.Tensor:
    """Per-image sum over the trailing [S, S, C] axes, kept as [..., 1, 1, 1]."""
    return x.sum(dim=(-3, -2, -1), keepdim=True)


def fused_postprocess(mask_pred: torch.Tensor, tmp: torch.Tensor,
                      pi: PartInputs, params: PostprocessParams,
                      report: dict | None = None) -> torch.Tensor:
    """On-device twin of eval/postprocess.py:ucb_postprocess.

    mask_pred: [k,S,S,1] resized/padded shadow maps (before face gating);
    tmp: [k,S,S,3] resized/padded inputs; pi: PartInputs of [k,S,S,1]
    tensors.  Returns detected [k,S,S,1] f32.  With a `report` dict,
    records "label_iterations", the iterations the components took."""
    p = params
    mp = mask_pred * pi.face_hair
    intensity = tmp.mean(dim=-1, keepdim=True)

    if p.mustache_mouth_suppression:
        # mustache / mouth false-positive suppression (:480-497)
        mp = mp * ~((mp < p.mustache_prob) & (pi.mustache_rect == 1))
        mp = mp * ~((mp < p.mouth_prob) & (pi.mouth_rect == 1))

    # spatially varying threshold (:518-539); the TSM protocol runs the
    # flat base threshold only (train_with_TSM.py:495-517)
    thr = torch.full_like(mp, p.base_threshold)
    one = torch.ones_like(mp)
    if p.adaptive_thresholds:
        thr = torch.where(pi.hair_region > 0, p.hair_threshold, thr)
        thr = torch.where((pi.hair_region > 0)
                          & (intensity < p.dark_hair_intensity),
                          p.dark_hair_threshold, thr)
        thr = torch.where((pi.forehead_rect > 0)
                          & (intensity < p.forehead_intensity),
                          p.forehead_threshold, thr)

        # mouth-and-below false-positive bands (:541-557): the reference's
        # host `if`s on mask-derived scalars, as per-image selects
        roi = pi.below_mouth_roi
        over = (mp > p.base_threshold).float()
        roi_sum = (_sum3(roi) * 3.0).clamp_min(1e-6)   # 3-channel ref sums
        frac = _sum3(over * roi) * 3.0 / roi_sum
        denom = _sum3(roi * over).clamp_min(1e-6)
        mean_mnb = _sum3(roi * over * intensity) / denom
        band_hit = torch.zeros_like(frac, dtype=torch.bool)
        for lo, hi, min_int in p.mouth_frac_bands:
            hit = (frac > lo) & (frac < hi)
            if min_int is not None:
                hit = hit & (mean_mnb > min_int)
            band_hit = band_hit | hit
        thr = torch.where(band_hit & (roi > 0), one, thr)

        # left-eyebrow-at-face-edge gate (:558-572)
        thr = torch.where((pi.brow_edge_gate > 0) & (intensity > 0.1), one,
                          thr)

    detected = (mp > thr).float()

    # connected components + hair veto (:585-611), every image at once
    det = detected[..., 0]
    labels, iterations = label_components_batched(
        det.reshape((-1,) + det.shape[-2:]))
    kept = filter_components(
        det, labels.reshape(det.shape), p.min_frac_of_max,
        veto_region=pi.hair_region[..., 0],
        veto_max_overlap=p.hair_veto_overlap)[..., None]
    if report is not None:
        report["label_iterations"] = iterations

    # nose veto (:647-663)
    shadow_img = kept * intensity
    mean_int = _sum3(shadow_img) / _sum3(kept).clamp_min(1e-6)
    frac_nose = _sum3(((pi.nose_mask * shadow_img) > 0).float()) / \
        _sum3(pi.nose_mask).clamp_min(1e-6)
    nose_hit = torch.zeros_like(frac_nose, dtype=torch.bool)
    for lo, hi in p.nose_frac_bands:
        nose_hit = nose_hit | ((frac_nose > lo) & (frac_nose < hi))
    veto_rect = torch.where(mean_int < p.nose_dark_intensity,
                            pi.nose_veto_short, pi.nose_veto_long)
    return torch.where(nose_hit & (veto_rect > 0), 0.0, kept)


def _make_ucb_step(forward_fn, params: PostprocessParams, img_size: int,
                   protocol: str):
    """The k-image step: fn(batch, size, pi, report=None) with batch leaves
    [k,V,S,S,C] on the device, size [k] and pi a PartInputs of [k,S,S,1]
    tensors -> (detected [k,S,S,1] bool, composite [k,S,S,3] uint8, shadow
    map [k,S,S,1] uint8, psnr [k], ssim [k]).  `forward_fn(views)` takes the
    dict with its view axes flattened ([k*V,S,S,C]) and returns the
    generator 4-tuple (gs, rgb, mask22, dif)."""
    if protocol not in ("gsc", "tsm"):
        raise ValueError(f"unknown protocol {protocol!r}")
    s = img_size

    @torch.inference_mode()
    def step(batch: dict, size: torch.Tensor, pi: PartInputs,
             report: dict | None = None):
        # compact ingress (config.compact_ingress): uint16 arrays are [0,1]
        # fixed point, dequantized here (UCBEvaluator._ingress quantizes)
        batch = {key: dequantize(v) for key, v in batch.items()}
        k, v = batch["img"].shape[:2]
        views = {key: t.reshape((k * v,) + t.shape[2:])
                 for key, t in batch.items() if key != "gt"}
        _, rgb, _, mask_pred = forward_fn(views)
        rgb = rgb.reshape((k, v) + rgb.shape[1:])[:, 0].float()
        mask_pred = mask_pred.reshape(
            (k, v) + mask_pred.shape[1:])[:, 0].float()
        a = dynamic_resize_matrix(size.to(batch["img"].device), s)
        gt_sc = resize_into_box(batch["gt"][:, 0].float(), a)

        if protocol == "tsm":
            tmp = batch["img"][:, 0].float()
            mp = mask_pred
            kept = fused_postprocess(mp, tmp, pi, params, report)
            out = (rgb * kept + tmp * (1.0 - kept)).clamp(0.0, 1.0)
            out = resize_into_box(out, a)
            mp = mp * pi.face_hair   # the diagnostic panel (gated map)
        else:
            tmp = resize_into_box(batch["img"][:, 0].float(), a)
            pred = resize_into_box(rgb.clamp(0.0, 1.0), a)
            mp = resize_into_box(mask_pred, a)
            kept = fused_postprocess(mp, tmp, pi, params, report)
            out = (pred * kept + tmp * (1.0 - kept)).clamp(0.0, 1.0)
        psnr = psnr_fn(gt_sc, out)
        ssim = ssim_fn(gt_sc, out)
        # metrics come from the f32 composite; only the fetched arrays
        # quantize (uint8 pred, written as 8-bit images anyway, and a bool
        # mask); the resized shadow map rides along for the 5-panel strip
        out_u8 = torch.round(out * 255.0).to(torch.uint8)
        mp_u8 = torch.round(mp.clamp(0.0, 1.0) * 255.0).to(torch.uint8)
        return kept.bool(), out_u8, mp_u8, psnr, ssim

    return step


def build_fused_ucb_batch_step(forward_fn, params: PostprocessParams,
                               img_size: int = 256, protocol: str = "gsc",
                               mesh=None):
    """fn(batch, size, pi, report=None) -> (detected, composite uint8,
    shadow map uint8, psnr, ssim), each with a leading image axis [k]: one
    device pass for k images (batch leaves [k,V,S,S,C], size [k], PartInputs
    leaves [k,S,S,1]).  The k*V generator forwards run as one batch; the
    label propagation iterates until the slowest image converges.

    protocol="tsm" runs the structurally different TSM pipeline
    (train_with_TSM.py:420-617): heuristics at full resolution against the
    unresized part masks, composite before the resize into the box.

    `mesh` (parallel/mesh.py): the k images are split over its "data"
    axis, k/n a device (a k the n devices do not divide raises
    ValueError), and `forward_fn` is then a sequence of forwards, the i-th
    on the i-th device of `batch_sharding(mesh)` (each over its own
    replica of the generator, the weights replicated, as
    __graft_entry__.py:209-262 shards the JAX step).  Each device runs its
    shard of the batch, the sizes and the PartInputs through the step; the
    outputs come back in image order on the device of the caller's
    batch.  `report["label_iterations"]` is the largest over the shards:
    the one-device loop runs until its slowest image converges, and an
    iteration at a fixed point changes no label."""
    if mesh is None:
        return _make_ucb_step(forward_fn, params, img_size, protocol)
    sharding = batch_sharding(mesh)
    forwards = list(forward_fn)
    if len(forwards) != sharding.num_shards:
        raise ValueError(f"{len(forwards)} forwards for the "
                         f"{sharding.num_shards} shards of the mesh")
    steps = [_make_ucb_step(f, params, img_size, protocol)
             for f in forwards]

    def sharded(batch: dict, size: torch.Tensor, pi: PartInputs,
                report: dict | None = None):
        home = batch["img"].device
        leaves = {key: shard_batch(t, sharding) for key, t in batch.items()}
        sizes = shard_batch(size, sharding)
        pis = {f.name: shard_batch(getattr(pi, f.name), sharding)
               for f in dataclasses.fields(PartInputs)}
        outs, iterations = [], []
        for i, shard_step in enumerate(steps):
            rep: dict = {}
            outs.append(shard_step(
                {key: parts[i] for key, parts in leaves.items()}, sizes[i],
                PartInputs(**{name: parts[i] for name, parts in pis.items()}),
                rep))
            iterations.append(rep["label_iterations"])
        if report is not None:
            report["label_iterations"] = max(iterations)
        return tuple(gather(list(o), home) for o in zip(*outs))

    return sharded


def build_fused_ucb_step(forward_fn, params: PostprocessParams,
                         img_size: int = 256, protocol: str = "gsc"):
    """The one-image form of `build_fused_ucb_batch_step`: fn(batch, size,
    pi, report=None) with batch leaves [V,S,S,C], a scalar size and pi of
    [S,S,1] tensors -> (detected [S,S,1], composite [S,S,3] uint8, shadow
    map [S,S,1] uint8, psnr, ssim)."""
    step = _make_ucb_step(forward_fn, params, img_size, protocol)

    def one(batch: dict, size, pi: PartInputs, report: dict | None = None):
        pi1 = PartInputs(**{f.name: getattr(pi, f.name)[None]
                            for f in dataclasses.fields(PartInputs)})
        out = step({key: t[None] for key, t in batch.items()},
                   torch.as_tensor(size, dtype=torch.float32).reshape(1),
                   pi1, report)
        return tuple(o[0] for o in out)

    return one
