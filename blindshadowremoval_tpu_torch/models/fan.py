"""2D-FAN facial-landmark network (port of
`blindshadowremoval_tpu/models/fan.py`).

The stacked-hourglass Face Alignment Network of Bulat & Tzimiropoulos
("How far are we from solving the 2D & 3D Face Alignment problem?",
ICCV'17), which the reference's offline preprocessing runs through
`face_alignment` to make the 68x2 landmark files (`bmvc2022-dataprocess.py:
10-29`).  NCHW, with face_alignment's module names, so a published
`2DFAN4-*.pth.tar` state dict loads as is; `models/weights.py:fan_from_jax`
carries the JAX package's variables (or the npz that
`tools/convert_fan_weights.py` writes) across.  BatchNorm is inference
mode (running statistics, eps 1e-5).

The host crops the face window from a box (`box_to_center_scale`,
`crop_for_fan`); the device runs the network and decodes the last
heatmaps (`decode_heatmaps`: the first argmax, a quarter-pixel nudge toward
the larger neighbour for maxima interior in both axes, +0.5); the host maps
the points back to the image.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from blindshadowremoval_tpu_torch.config import resolve_device
from blindshadowremoval_tpu_torch.models.generator import f32_convs
from blindshadowremoval_tpu_torch.utils.imageio import resize_linear

# face_alignment's box -> center/scale convention: the scale divides the
# box's semiperimeter by this reference extent, and the centre moves up by
# 12% of the box height
_REFERENCE_SCALE = 195.0
_CENTER_SHIFT = 0.12
INPUT_RES = 256      # network input resolution
HEATMAP_RES = 64     # heatmap resolution
N_LANDMARKS = 68


def _conv3(c_in: int, c_out: int) -> nn.Conv2d:
    return nn.Conv2d(c_in, c_out, 3, 1, 1, bias=False)


class FANConvBlock(nn.Module):
    """FAN's residual block: three BN-ReLU-conv3x3 stages at C/2, C/4, C/4
    channels, concatenated, plus a BN-ReLU-conv1x1 projection shortcut
    (`downsample`) when the channel count changes."""

    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.bn1 = nn.BatchNorm2d(c_in)
        self.conv1 = _conv3(c_in, c_out // 2)
        self.bn2 = nn.BatchNorm2d(c_out // 2)
        self.conv2 = _conv3(c_out // 2, c_out // 4)
        self.bn3 = nn.BatchNorm2d(c_out // 4)
        self.conv3 = _conv3(c_out // 4, c_out // 4)
        self.downsample = None
        if c_in != c_out:
            self.downsample = nn.Sequential(
                nn.BatchNorm2d(c_in), nn.ReLU(),
                nn.Conv2d(c_in, c_out, 1, bias=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out1 = self.conv1(F.relu(self.bn1(x)))
        out2 = self.conv2(F.relu(self.bn2(out1)))
        out3 = self.conv3(F.relu(self.bn3(out2)))
        out = torch.cat([out1, out2, out3], dim=1)
        return out + (x if self.downsample is None else self.downsample(x))


class HourGlass(nn.Module):
    """The recursive hourglass: at each level a full-resolution branch and
    an average-pooled one that recurses, upsampled (nearest, x2) and
    added."""

    def __init__(self, depth: int = 4, features: int = 256):
        super().__init__()
        self.depth = depth
        for lvl in range(1, depth + 1):
            self.add_module(f"b1_{lvl}", FANConvBlock(features, features))
            self.add_module(f"b2_{lvl}", FANConvBlock(features, features))
            if lvl == 1:
                self.add_module(f"b2_plus_{lvl}",
                                FANConvBlock(features, features))
            self.add_module(f"b3_{lvl}", FANConvBlock(features, features))

    def _level(self, lvl: int, inp: torch.Tensor) -> torch.Tensor:
        m = self._modules
        up1 = m[f"b1_{lvl}"](inp)
        low = m[f"b2_{lvl}"](F.avg_pool2d(inp, 2, 2))
        low2 = (self._level(lvl - 1, low) if lvl > 1
                else m[f"b2_plus_{lvl}"](low))
        low3 = m[f"b3_{lvl}"](low2)
        return up1 + F.interpolate(low3, scale_factor=2, mode="nearest")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._level(self.depth, x)


class FAN(nn.Module):
    """Stacked-hourglass landmark network (2DFAN-4 by default).

    Input [B, 3, 256, 256] RGB in [0, 1].  Returns `num_modules` f32
    heatmaps [B, 68, 64, 64]; the last one is the prediction.  The
    convolutions run in `dtype` (the parameters' dtype once the caller
    casts the module)."""

    def __init__(self, num_modules: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_modules = num_modules
        self.dtype = dtype
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3)
        self.bn1 = nn.BatchNorm2d(64)
        self.conv2 = FANConvBlock(64, 128)
        self.conv3 = FANConvBlock(128, 128)
        self.conv4 = FANConvBlock(128, 256)
        for i in range(num_modules):
            self.add_module(f"m{i}", HourGlass(4, 256))
            self.add_module(f"top_m_{i}", FANConvBlock(256, 256))
            self.add_module(f"conv_last{i}", nn.Conv2d(256, 256, 1))
            self.add_module(f"bn_end{i}", nn.BatchNorm2d(256))
            self.add_module(f"l{i}", nn.Conv2d(256, N_LANDMARKS, 1))
            if i < num_modules - 1:
                self.add_module(f"bl{i}", nn.Conv2d(256, 256, 1))
                self.add_module(f"al{i}", nn.Conv2d(N_LANDMARKS, 256, 1))

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        m = self._modules
        with f32_convs(self.dtype):
            x = F.relu(self.bn1(self.conv1(x.to(self.dtype))))
            x = F.avg_pool2d(self.conv2(x), 2, 2)
            x = self.conv4(self.conv3(x))
            previous, outputs = x, []
            for i in range(self.num_modules):
                ll = m[f"top_m_{i}"](m[f"m{i}"](previous))
                ll = F.relu(m[f"bn_end{i}"](m[f"conv_last{i}"](ll)))
                tmp = m[f"l{i}"](ll)
                outputs.append(tmp.float())
                if i < self.num_modules - 1:
                    previous = previous + m[f"bl{i}"](ll) + m[f"al{i}"](tmp)
        return outputs


def build_fan(state_dict: dict, num_modules: int = 4,
              dtype: torch.dtype = torch.float32, device=None) -> FAN:
    """A FAN in eval mode on `device` (CUDA unless "cpu"), parameters and
    BatchNorm statistics in `dtype`."""
    net = FAN(num_modules, dtype)
    net.load_state_dict(state_dict)
    return net.eval().to(device=resolve_device(device), dtype=dtype)


# ---------------------------------------------------------------------------
# box -> centre/scale, the crop, and the heatmap decode
# ---------------------------------------------------------------------------

def box_to_center_scale(box: Sequence[float]) -> tuple[np.ndarray, float]:
    """[x1, y1, x2, y2] face box -> (centre [2], scale), face_alignment's
    convention: the centre raised by 12% of the box height, the scale the
    semiperimeter over 195."""
    x1, y1, x2, y2 = (float(v) for v in box)
    center = np.array([x2 - (x2 - x1) / 2.0, y2 - (y2 - y1) / 2.0])
    center[1] -= (y2 - y1) * _CENTER_SHIFT
    return center, (x2 - x1 + y2 - y1) / _REFERENCE_SCALE


def crop_for_fan(image: np.ndarray, center: np.ndarray, scale: float,
                 resolution: int = INPUT_RES) -> np.ndarray:
    """The face window (side 200 * scale px about `center`, zero outside
    the frame) resized to the network input with cv2's f32 bilinear, on
    the host.  uint8/float RGB in; [resolution, resolution, 3] f32 RGB out,
    divided by 255 for uint8 frames and for frames above 2.0."""
    h = 200.0 * scale
    # the window's corners in the frame
    ul = np.floor(np.array([center[0] - h / 2.0, center[1] - h / 2.0]))
    br = ul + np.ceil(h)
    ul, br = ul.astype(int), br.astype(int)
    side = br[0] - ul[0]
    out = np.zeros((side, side, 3), dtype=np.float32)
    ih, iw = image.shape[:2]
    sx0, sy0 = max(ul[0], 0), max(ul[1], 0)
    sx1, sy1 = min(br[0], iw), min(br[1], ih)
    if sx1 > sx0 and sy1 > sy0:
        out[sy0 - ul[1]:sy1 - ul[1], sx0 - ul[0]:sx1 - ul[0]] = \
            np.asarray(image, np.float32)[sy0:sy1, sx0:sx1, :3]
    out = resize_linear(out, (resolution, resolution))
    if image.dtype == np.uint8 or np.asarray(image).max() > 2.0:
        out /= 255.0
    return out


def decode_heatmaps(hm: torch.Tensor) -> torch.Tensor:
    """[B, 68, H, W] heatmaps -> [B, 68, 2] (x, y) f32 heatmap coordinates,
    face_alignment's decode: the first argmax of each map, +/-0.25 toward
    the larger 4-neighbour along each axis where the maximum lies inside
    the map in both axes (no nudge at sign 0), then +0.5."""
    b, c, hgt, wid = hm.shape
    flat = hm.reshape(b, c, hgt * wid)
    idx = torch.argmax(flat, dim=2)                      # [B, 68]
    px, py = idx % wid, idx // wid

    def at(dy: int, dx: int) -> torch.Tensor:
        yy = (py + dy).clamp(0, hgt - 1)
        xx = (px + dx).clamp(0, wid - 1)
        return torch.gather(flat, 2, (yy * wid + xx)[..., None])[..., 0]

    dx = at(0, 1) - at(0, -1)
    dy = at(1, 0) - at(-1, 0)
    interior = (px > 0) & (px < wid - 1) & (py > 0) & (py < hgt - 1)
    zero = torch.zeros((), dtype=torch.float32, device=hm.device)
    fx = px.float() + torch.where(interior, torch.sign(dx).float() * 0.25,
                                  zero)
    fy = py.float() + torch.where(interior, torch.sign(dy).float() * 0.25,
                                  zero)
    return torch.stack([fx + 0.5, fy + 0.5], dim=-1)


def heatmap_to_image_coords(pts: np.ndarray, center, scale: float,
                            resolution: int = HEATMAP_RES) -> np.ndarray:
    """Heatmap (x, y) -> image pixels by the inverse of the centre/scale
    similarity (window side 200 * scale), in f32."""
    h = 200.0 * scale
    c = np.asarray(center, np.float32)
    return (np.asarray(pts, np.float32) * np.float32(h / resolution)
            + (c - np.float32(h / 2.0)))


@torch.inference_mode()
def landmarks_from_image(weights, image: np.ndarray,
                         box: Sequence[float] | None = None,
                         num_modules: int = 4, device=None) -> np.ndarray:
    """One image (+ an optional face box; the whole frame without one) ->
    68x2 landmarks in image pixels, f32.  `weights` is a FAN (on its own
    device) or a state dict of `num_modules` stacks, built on `device`
    (CUDA unless "cpu").  The reference's `.npy` files hold these
    truncated to int."""
    net = (weights if isinstance(weights, FAN)
           else build_fan(weights, num_modules, device=device))
    ih, iw = np.asarray(image).shape[:2]
    if box is None:
        box = (0.0, 0.0, float(iw), float(ih))
    center, scale = box_to_center_scale(box)
    inp = torch.from_numpy(crop_for_fan(np.asarray(image), center, scale))
    dev = next(net.parameters()).device
    hm = net(inp.permute(2, 0, 1)[None].to(dev))[-1]
    pts = decode_heatmaps(hm)[0].cpu().numpy()
    return heatmap_to_image_coords(pts, center, scale)


class LandmarkAligner:
    """Batched FAN on `device` (CUDA unless "cpu"): K face boxes -> K 68x2
    landmark sets, `batch_size` crops a call (the tail padded).

    The host crops (`crop_for_fan`); the device runs the network in
    `dtype` and decodes the last heatmaps; the host maps the points back
    through the centre/scale similarity.  `ingress_u8` sends the crops as
    uint8 (1/255 steps, divided on the device): 4x fewer bytes up, at the
    cost of input quantization that can move a sub-pixel nudge, so the
    exact contract is the f32 default."""

    def __init__(self, state_dict: dict, num_modules: int = 4,
                 batch_size: int = 16, dtype: torch.dtype = torch.float32,
                 ingress_u8: bool = False, device=None):
        self.device = resolve_device(device)
        self.batch_size = batch_size
        self.ingress_u8 = ingress_u8
        self.net = build_fan(state_dict, num_modules, dtype, self.device)

    @torch.inference_mode()
    def heatmaps(self, crops: torch.Tensor) -> torch.Tensor:
        """[B, 256, 256, 3] crops on the device (f32 in [0, 1], or uint8
        with `ingress_u8`) -> the last [B, 68, 64, 64] f32 heatmaps."""
        x = crops.float() / 255.0 if crops.dtype == torch.uint8 else crops
        return self.net(x.permute(0, 3, 1, 2))[-1]

    @torch.inference_mode()
    def _points(self, crops: torch.Tensor) -> np.ndarray:
        return decode_heatmaps(self.heatmaps(crops)).cpu().numpy()

    def crops(self, images: Sequence[np.ndarray], cs: Sequence) -> np.ndarray:
        """The host's crops of one chunk, on the wire's dtype."""
        crops = np.stack([crop_for_fan(np.asarray(im), c, s)
                          for im, (c, s) in zip(images, cs)])
        if self.ingress_u8:
            crops = np.rint(np.clip(crops, 0.0, 1.0) * 255.0).astype(np.uint8)
        return crops

    def __call__(self, images: Sequence[np.ndarray],
                 boxes: Sequence[Sequence[float]]) -> list[np.ndarray]:
        """Per-face (image, [x1, y1, x2, y2] box) pairs -> 68x2 f32
        landmark arrays in image pixels."""
        cs = [box_to_center_scale(b) for b in boxes]
        out: list[np.ndarray] = []
        bs = self.batch_size
        for start in range(0, len(images), bs):
            chunk_cs = cs[start:start + bs]
            n = len(chunk_cs)
            crops = self.crops(images[start:start + bs], chunk_cs)
            if n < bs:
                crops = np.concatenate(
                    [crops, np.zeros((bs - n,) + crops.shape[1:],
                                     crops.dtype)])
            pts = self._points(torch.from_numpy(crops).to(self.device))[:n]
            for (c, s), p in zip(chunk_cs, pts):
                h = 200.0 * s    # heatmap -> image similarity, host numpy
                out.append((p * (h / HEATMAP_RES)
                            + (np.asarray(c) - h / 2.0)).astype(np.float32))
        return out


def load_fan_npz(path: str) -> dict:
    """The port's FAN state dict from the npz that
    tools/convert_fan_weights.py writes."""
    from blindshadowremoval_tpu_torch.models.weights import fan_from_jax

    raw = np.load(path)
    return fan_from_jax({k: raw[k] for k in raw.files})
