"""S3FD face detector (port of `blindshadowremoval_tpu/models/sfd.py`).

The detection half of the landmark step: `face_alignment` runs the S3FD
single-shot detector (Zhang et al., ICCV'17) before its FAN landmark CNN
(`models/fan.py`), so image -> box -> crop -> heatmaps -> 68x2 runs here.

Architecture: VGG16 conv1_1..conv5_3, fc6/fc7 as convolutions (fc6 padded
by 3), two extra conv stages, a channel-wise L2Norm on the conv3_3, conv4_3
and conv5_3 taps, and six (conf, loc) heads at strides 4..128; the first
conf head takes the max of its three background channels.  The network is
NCHW and its module names are `face_alignment`'s, so a published
`s3fd-*.pth` state dict loads as is; `models/weights.py:sfd_from_jax`
carries the JAX package's variables (or the npz that
`tools/convert_sfd_weights.py` writes) across.

The numeric contract is face_alignment's `detection/sfd/detect.py`: the
[104, 117, 123] mean subtracted from the RGB frame as is, SSD decoding with
variances (0.1, 0.2) and square priors of side 4 * stride, greedy NMS at
IoU 0.3 with the +1-pixel area convention, and the 0.5 score filter.
`FaceDetector` letterboxes every frame to one square size on the host
(cv2's uint8 bilinear, bit for bit), runs the trunk batched on the device
with each scale's top-k candidates taken there, and decodes, suppresses
and rescales on the host.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from blindshadowremoval_tpu_torch.config import resolve_device
from blindshadowremoval_tpu_torch.models.generator import f32_convs
from blindshadowremoval_tpu_torch.utils.imageio import (
    resize_linear,
    resize_linear_u8,
)

# (name, width, convs in the block) of the VGG16 trunk
_TRUNK = (("conv1", 64, 2), ("conv2", 128, 2), ("conv3", 256, 3),
          ("conv4", 512, 3), ("conv5", 512, 3))
_L2NORM_TAPS = {"conv3_3": 256, "conv4_3": 512, "conv5_3": 512}
# the six head taps, strides 4, 8, ..., 128, and their widths
_HEADS = (("conv3_3", 256), ("conv4_3", 512), ("conv5_3", 512),
          ("fc7", 1024), ("conv6_2", 512), ("conv7_2", 256))
_MEAN = (104.0, 117.0, 123.0)   # subtracted from the RGB frame as is
_VARIANCES = (0.1, 0.2)


class L2Norm(nn.Module):
    """Channel-wise L2 normalization with a learned per-channel scale:
    x / (sqrt(sum x^2) + 1e-10) * weight, the norm taken in f32."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        norm = xf.square().sum(dim=1, keepdim=True).sqrt() + 1e-10
        return (xf / norm * self.weight.float().view(1, -1, 1, 1)).to(x.dtype)


def _head_name(tap: str) -> str:
    return tap + "_norm" if tap in _L2NORM_TAPS else tap


class S3FD(nn.Module):
    """Input [B, 3, H, W]: the RGB frame minus `_MEAN`.  Returns six (conf
    [B, 2, h, w], loc [B, 4, h, w]) f32 pairs, conf softmaxed over its two
    channels (background, face), with the stride-4 head's background the
    max of its three background channels.  The convolutions run in
    `dtype` (the parameters' dtype once the caller casts the module); the
    head outputs, the max-out and the softmax in f32."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        c_in = 3
        for block, width, n in _TRUNK:
            for i in range(1, n + 1):
                self.add_module(f"{block}_{i}", nn.Conv2d(c_in, width, 3, 1, 1))
                c_in = width
        self.fc6 = nn.Conv2d(512, 1024, 3, 1, 3)
        self.fc7 = nn.Conv2d(1024, 1024, 1)
        self.conv6_1 = nn.Conv2d(1024, 256, 1)
        self.conv6_2 = nn.Conv2d(256, 512, 3, 2, 1)
        self.conv7_1 = nn.Conv2d(512, 128, 1)
        self.conv7_2 = nn.Conv2d(128, 256, 3, 2, 1)
        for tap, width in _L2NORM_TAPS.items():
            self.add_module(_head_name(tap), L2Norm(width))
        for i, (tap, width) in enumerate(_HEADS):
            name = _head_name(tap)
            self.add_module(f"{name}_mbox_conf",
                            nn.Conv2d(width, 4 if i == 0 else 2, 3, 1, 1))
            self.add_module(f"{name}_mbox_loc", nn.Conv2d(width, 4, 3, 1, 1))

    def forward(self, x: torch.Tensor) -> list[tuple[torch.Tensor, torch.Tensor]]:
        m = self._modules
        with f32_convs(self.dtype):
            x = x.to(self.dtype)
            taps = {}
            for block, _, n in _TRUNK:
                for i in range(1, n + 1):
                    x = F.relu(m[f"{block}_{i}"](x))
                    if f"{block}_{i}" in _L2NORM_TAPS:
                        taps[f"{block}_{i}"] = x
                x = F.max_pool2d(x, 2, 2)
            x = F.relu(self.fc6(x))
            x = taps["fc7"] = F.relu(self.fc7(x))
            x = F.relu(self.conv6_1(x))
            x = taps["conv6_2"] = F.relu(self.conv6_2(x))
            x = F.relu(self.conv7_1(x))
            taps["conv7_2"] = F.relu(self.conv7_2(x))

            outs = []
            for i, (tap, _) in enumerate(_HEADS):
                name = _head_name(tap)
                t = taps[tap]
                if tap in _L2NORM_TAPS:
                    t = m[name](t)
                conf = m[f"{name}_mbox_conf"](t).float()
                loc = m[f"{name}_mbox_loc"](t).float()
                if i == 0:   # max-out background: 3 bg channels vs face
                    bg = conf[:, :3].amax(dim=1, keepdim=True)
                    conf = torch.cat([bg, conf[:, 3:]], dim=1)
                outs.append((torch.softmax(conf, dim=1), loc))
        return outs


def build_s3fd(state_dict: dict, dtype: torch.dtype = torch.float32,
               device=None) -> S3FD:
    """An S3FD in eval mode on `device` (CUDA unless "cpu"), with its
    parameters in `dtype`."""
    net = S3FD(dtype)
    net.load_state_dict(state_dict)
    return net.eval().to(device=resolve_device(device), dtype=dtype)


def preprocess(rgb: np.ndarray) -> np.ndarray:
    """uint8/float RGB frame -> the detector's input, [H, W, 3] f32 (fa's
    detect.py: the means subtracted without a channel reorder)."""
    return np.asarray(rgb, np.float32) - np.asarray(_MEAN, np.float32)


def _boxes(stride: int, hi: np.ndarray, wi: np.ndarray, l: np.ndarray,
           score: np.ndarray) -> np.ndarray:
    """SSD decoding of the anchors at grid cells (hi, wi) of one head."""
    acx = stride / 2.0 + wi * stride
    acy = stride / 2.0 + hi * stride
    side = stride * 4.0
    cx = acx + l[:, 0] * _VARIANCES[0] * side
    cy = acy + l[:, 1] * _VARIANCES[0] * side
    w = side * np.exp(l[:, 2] * _VARIANCES[1])
    h = side * np.exp(l[:, 3] * _VARIANCES[1])
    return np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2, score],
                    axis=1)


def _host(t) -> np.ndarray:
    if torch.is_tensor(t):
        return t.detach().float().cpu().numpy()
    return np.asarray(t)


def decode_detections(outs, score_thresh: float = 0.05,
                      index: int = 0) -> np.ndarray:
    """Six softmaxed (conf [B, 2, h, w], loc [B, 4, h, w]) head pairs ->
    [N, 5] (x1, y1, x2, y2, score) candidates above `score_thresh`, of
    batch element `index`, in canonical order (host numpy, vectorized over
    the anchor grid)."""
    boxes = []
    for i, (conf, loc) in enumerate(outs):
        score = _host(conf)[index, 1]
        reg = _host(loc)[index]
        hi, wi = np.nonzero(score > score_thresh)
        if hi.size == 0:
            continue
        boxes.append(_boxes(2 ** (i + 2), hi, wi, reg[:, hi, wi].T,
                            score[hi, wi]))
    if not boxes:
        return np.zeros((0, 5), np.float32)
    return _canonical_order(np.concatenate(boxes, axis=0))


def _canonical_order(boxes: np.ndarray) -> np.ndarray:
    """Candidates by (score desc, x1, y1): greedy NMS breaks EXACT score
    ties (constant letterbox padding makes them) by input order, so the
    dense and top-k decoders impose one order."""
    order = np.lexsort((boxes[:, 1], boxes[:, 0], -boxes[:, 4]))
    return boxes[order].astype(np.float32)


def nms(dets: np.ndarray, thresh: float = 0.3) -> np.ndarray:
    """Greedy NMS with the reference stack's +1-pixel area convention;
    returns the kept rows' indices."""
    if len(dets) == 0:
        return np.zeros(0, np.int64)
    x1, y1, x2, y2, scores = dets.T
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    order = scores.argsort()[::-1]
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(i)
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        inter = (np.maximum(0.0, xx2 - xx1 + 1)
                 * np.maximum(0.0, yy2 - yy1 + 1))
        iou = inter / (areas[i] + areas[order[1:]] - inter)
        order = order[1:][iou <= thresh]
    return np.asarray(keep, np.int64)


@torch.inference_mode()
def detect_faces(weights, image: np.ndarray, filter_threshold: float = 0.5,
                 device=None) -> np.ndarray:
    """One RGB frame at its own size -> [N, 5] face boxes (x1, y1, x2, y2,
    score), best first: the trunk on the device, then the dense decode, NMS
    and the score filter on the host (face_alignment's SFDDetector).
    `weights` is an S3FD (on its own device) or a state dict, built on
    `device` (CUDA unless "cpu")."""
    net = (weights if isinstance(weights, S3FD)
           else build_s3fd(weights, device=device))
    dev = next(net.parameters()).device
    inp = torch.from_numpy(preprocess(image)).permute(2, 0, 1)[None]
    dets = decode_detections(net(inp.to(dev)))
    dets = dets[nms(dets)]
    return dets[dets[:, 4] > filter_threshold]


def letterbox(image: np.ndarray, det_size: int) -> tuple[np.ndarray, float]:
    """Scale the frame to fit a `det_size` square (aspect kept), zero-pad
    bottom and right.  Returns (canvas [det_size, det_size, 3] in the
    input's dtype for uint8, else f32; scale), with original coordinates
    = canvas coordinates / scale.  The resize is cv2's INTER_LINEAR, its
    fixed-point uint8 path for uint8 frames."""
    h, w = image.shape[:2]
    scale = det_size / max(h, w)
    nw, nh = max(1, round(w * scale)), max(1, round(h * scale))
    image = np.asarray(image)
    if image.dtype == np.uint8:
        resized = resize_linear_u8(image, (nw, nh))
    else:
        resized = resize_linear(image.astype(np.float32), (nw, nh))
    canvas = np.zeros((det_size, det_size, 3), resized.dtype)
    canvas[:nh, :nw] = resized[..., :3]
    return canvas, scale


class FaceDetector:
    """Batched S3FD at one square input size, on `device` (CUDA unless
    "cpu").

    Every frame is letterboxed to `det_size` on the host and uploaded raw
    (uint8 frames as uint8); the device subtracts the means, runs the
    trunk in `dtype` on a batch padded to `batch_size`, and keeps each
    scale's `topk` best anchors, ties in index order (the order of
    `jax.lax.top_k`), so only those cross to the host.  The host decodes
    the candidates above `score_thresh`, suppresses, filters at
    `filter_threshold` and rescales the boxes to the original frame.  The
    top-k decode equals the dense one whenever fewer than `topk` anchors of
    a scale clear `score_thresh`.

    bf16 moves the scores by ~1e-2 against f32 (a box within that of the
    filter may flip), and the boxes by well under a pixel at 640."""

    def __init__(self, state_dict: dict, det_size: int = 640,
                 batch_size: int = 4, dtype: torch.dtype = torch.float32,
                 filter_threshold: float = 0.5, score_thresh: float = 0.05,
                 topk: int = 256, device=None):
        self.device = resolve_device(device)
        self.det_size = det_size
        self.batch_size = batch_size
        self.filter_threshold = filter_threshold
        self.score_thresh = score_thresh
        self.topk = topk
        self.net = build_s3fd(state_dict, dtype, self.device)
        self._mean = torch.tensor(_MEAN, dtype=torch.float32,
                                  device=self.device)

    @torch.inference_mode()
    def candidates(self, batch: torch.Tensor) -> tuple[torch.Tensor, list]:
        """[B, S, S, 3] canvases (uint8 or f32, on the device) -> ([B, K, 6]
        f32 (score, flat index h * w_head + w, loc 4) of every scale's
        top-k, concatenated by scale; each scale's (k, head width))."""
        x = (batch.float() - self._mean).permute(0, 3, 1, 2)
        cands, spans = [], []
        for conf, loc in self.net(x):
            b, _, _, w = conf.shape
            score = conf[:, 1].reshape(b, -1)
            k = min(self.topk, score.shape[1])
            val, idx = torch.sort(score, dim=1, descending=True, stable=True)
            val, idx = val[:, :k], idx[:, :k]
            sel = torch.gather(loc.permute(0, 2, 3, 1).reshape(b, -1, 4), 1,
                               idx[..., None].expand(-1, -1, 4))
            cands.append(torch.cat([val[..., None], idx[..., None].float(),
                                    sel], dim=-1))
            spans.append((k, w))
        return torch.cat(cands, dim=1), spans

    def _decode_topk(self, cands: np.ndarray, spans: list) -> np.ndarray:
        """One image's [K, 6] top-k candidates -> [N, 5] boxes above
        score_thresh: decode_detections' anchor math on the candidates."""
        boxes, start = [], 0
        for i, (k, w) in enumerate(spans):
            c = cands[start:start + k]
            start += k
            c = c[c[:, 0] > self.score_thresh]
            if len(c) == 0:
                continue
            flat = c[:, 1].astype(np.int64)
            boxes.append(_boxes(2 ** (i + 2), flat // w, flat % w, c[:, 2:],
                                c[:, 0]))
        if not boxes:
            return np.zeros((0, 5), np.float32)
        return _canonical_order(np.concatenate(boxes, axis=0))

    def __call__(self, images: Sequence[np.ndarray]) -> list[np.ndarray]:
        """RGB frames of any sizes -> per image [N, 5] boxes (x1, y1, x2,
        y2, score) in the frame's own coordinates, best first."""
        results: list[np.ndarray] = []
        bs = self.batch_size
        for start in range(0, len(images), bs):
            chunk = images[start:start + bs]
            n = len(chunk)
            pairs = [letterbox(im, self.det_size) for im in chunk]
            batch = np.stack([c for c, _ in pairs])
            if n < bs:   # pad the tail to the batch shape
                batch = np.concatenate(
                    [batch, np.zeros((bs - n,) + batch.shape[1:],
                                     batch.dtype)])
            cands, spans = self.candidates(
                torch.from_numpy(batch).to(self.device))
            cands = cands.cpu().numpy()
            for i in range(n):
                dets = self._decode_topk(cands[i], spans)
                dets = dets[nms(dets)]
                dets = dets[dets[:, 4] > self.filter_threshold]
                dets[:, :4] /= pairs[i][1]     # back to the frame's pixels
                results.append(dets)
        return results


def load_sfd_npz(path: str) -> dict:
    """The port's S3FD state dict from the npz that
    tools/convert_sfd_weights.py writes."""
    from blindshadowremoval_tpu_torch.models.weights import sfd_from_jax

    raw = np.load(path)
    return sfd_from_jax({k: raw[k] for k in raw.files})
