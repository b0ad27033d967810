"""Triangulated landmark interpolation as batched barycentric rasterization.

Port of `blindshadowremoval_tpu/geometry/triangulation.py`.  The host
extracts only the Delaunay topology (scipy/qhull over at most 85 points);
the rasterization — find the first triangle that holds each pixel, then
barycentric-weight its per-vertex values — is plain PyTorch on whatever
device the inputs live on, batched over images.  Pixels outside the convex
hull are 0.

Numerics follow the JAX function term by term (same expression order, the
same eps 1e-7 and the same guard on near-zero triangle areas), and the
triangle a pixel takes is the FIRST one, in topology order, whose three
barycentric weights are >= -eps.  A pixel on a shared edge can still land
in the other triangle when the two frameworks round a weight differently;
piecewise-linear interpolation is continuous across the edge, so only the
hull boundary (hit versus miss) moves a value by more than float noise.

`device_geometry_maps` takes the CUDA kernel (csrc/rasterize.cu) on CUDA
inputs: one launch for the four maps of every view, the same weights,
values and coverage as this plain path on the card, bit for bit.  Other
inputs take the plain path, which stays the CPU route and the reference
that the card's tests hold the kernel to.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import threading

import numpy as np
import torch
import torch.nn.functional as F

from blindshadowremoval_tpu_torch.geometry.landmarks import (
    ANCHOR_POINTS,
    LM_REF,
    UV_TABLE,
    forehead_points,
)
from blindshadowremoval_tpu_torch.ops import _build
from blindshadowremoval_tpu_torch.ops.filters import box_blur

# Fixed triangle-count pad so topologies stack into one batch tensor
# (68+16 anchor points yield ~160 triangles).
_MAX_TRIANGLES = 192
# triangles tested at once: bounds the [B, chunk, S*S] temporaries
_TRI_CHUNK = 16


@dataclasses.dataclass(frozen=True)
class Triangulation:
    """Host-extracted Delaunay topology over a 2D point set; `triangles` is
    padded to `_MAX_TRIANGLES` rows of (-1, -1, -1) that hold no pixel."""

    points: np.ndarray     # (P, 2) float32
    triangles: np.ndarray  # (T_max, 3) int32, padded with -1


def build_triangulation(points: np.ndarray) -> Triangulation:
    """Delaunay-triangulate `points` (host side, scipy/qhull)."""
    from scipy.spatial import Delaunay

    points = np.asarray(points, dtype=np.float32)
    simplices = Delaunay(points.astype(np.float64)).simplices.astype(np.int32)
    if simplices.shape[0] > _MAX_TRIANGLES:
        raise ValueError(
            f"{simplices.shape[0]} triangles exceeds pad size {_MAX_TRIANGLES}")
    pad = np.full((_MAX_TRIANGLES - simplices.shape[0], 3), -1, np.int32)
    return Triangulation(points=points,
                         triangles=np.concatenate([simplices, pad]))


def rasterize_linear(points: torch.Tensor, triangles: torch.Tensor,
                     values: torch.Tensor, size: int) -> torch.Tensor:
    """Piecewise-linear interpolation onto a (size, size, K) grid, batched.

    points [B, P, 2] in normalized (x, y); triangles [B, T, 3] int (-1
    padded); values [B, P, K].  Returns [B, size, size, K] float32.  Grid
    point (r, c) sits at (x, y) = (c, r) / (size - 1), the reference's
    `np.meshgrid(np.linspace(0, 1, size))` sampling (warp.py:200).
    """
    eps = 1e-7
    s = size
    dev = points.device
    b, t_max = triangles.shape[:2]
    points = points.to(torch.float32)
    values = values.to(torch.float32)
    triangles = triangles.to(device=dev, dtype=torch.long)
    lin = _grid(s, dev)
    xs = lin.repeat(s)                                   # (N,) column coord
    ys = lin.repeat_interleave(s)                        # (N,) row coord

    valid = triangles[..., 0] >= 0                       # (B, T)
    tri_idx = triangles.clamp(min=0)
    tv = torch.gather(points, 1, tri_idx.reshape(b, -1, 1).expand(-1, -1, 2)
                      ).reshape(b, t_max, 3, 2)          # (B, T, 3, 2)
    ax, ay = tv[..., 0, 0], tv[..., 0, 1]
    bx, by = tv[..., 1, 0], tv[..., 1, 1]
    cx, cy = tv[..., 2, 0], tv[..., 2, 1]
    # signed doubled area; qhull emits CCW simplices but guard both signs
    den = (by - cy) * (ax - cx) + (cx - bx) * (ay - cy)
    den = torch.where(den.abs() < 1e-12, torch.full_like(den, 1e-12), den)

    corners = (ax, ay, bx, by, cx, cy, den)

    def weights(t_sel, x, y):
        """Barycentric (w0, w1, w2) of pixels (x, y) in the triangles that
        `t_sel` picks; the picked corners get trailing unit dims so they
        broadcast against x and y."""
        shape = tuple(t_sel.shape) + (1,) * (x.dim() - t_sel.dim())
        gax, gay, gbx, gby, gcx, gcy, gden = (
            torch.gather(v, 1, t_sel).view(shape) for v in corners)
        w0 = ((gby - gcy) * (x - gcx) + (gcx - gbx) * (y - gcy)) / gden
        w1 = ((gcy - gay) * (x - gcx) + (gax - gcx) * (y - gcy)) / gden
        return w0, w1, 1.0 - w0 - w1

    found = torch.full((b, s * s), -1, dtype=torch.long, device=dev)
    for t0 in range(0, t_max, _TRI_CHUNK):
        t1 = min(t0 + _TRI_CHUNK, t_max)
        t_sel = torch.arange(t0, t1, device=dev).expand(b, -1)
        # (B, chunk, N)
        w0, w1, w2 = weights(t_sel, xs.view(1, 1, -1), ys.view(1, 1, -1))
        inside = ((w0 >= -eps) & (w1 >= -eps) & (w2 >= -eps)
                  & valid[:, t0:t1, None])
        # first triangle of the chunk that holds the pixel (argmax of a
        # bool returns the first maximum)
        first = inside.to(torch.uint8).argmax(dim=1) + t0
        hit_now = inside.any(dim=1) & (found < 0)
        found = torch.where(hit_now, first, found)

    hit = found >= 0
    t = found.clamp(min=0)                               # (B, N)
    # recompute barycentric weights for the chosen triangle only
    w0, w1, w2 = weights(t, xs.expand(b, -1), ys.expand(b, -1))
    vidx = torch.gather(tri_idx, 1, t.unsqueeze(-1).expand(-1, -1, 3))
    k = values.shape[-1]

    def vert(j):
        return torch.gather(values, 1, vidx[..., j:j + 1].expand(-1, -1, k))

    out = (w0[..., None] * vert(0) + w1[..., None] * vert(1)
           + w2[..., None] * vert(2))
    out = torch.where(hit[..., None], out, torch.zeros_like(out))
    return out.reshape(b, s, s, k)


def _with_anchors(lm: np.ndarray) -> np.ndarray:
    return np.concatenate([np.asarray(lm, np.float32), ANCHOR_POINTS], axis=0)


def _rasterize_host(tri: Triangulation, values: np.ndarray,
                    size: int) -> np.ndarray:
    out = rasterize_linear(torch.from_numpy(tri.points)[None],
                           torch.from_numpy(tri.triangles)[None],
                           torch.from_numpy(np.asarray(values, np.float32))[None],
                           size)
    return out[0].numpy()


def generate_offset_map(source_lm, target_lm, size: int) -> np.ndarray:
    """Offset field warping `target` geometry onto `source` geometry
    (warp.py:194-213): both landmark sets get the 16 border anchors, the
    target positions are triangulated, and the per-landmark delta (source -
    target) is interpolated; channels are (row delta, col delta, 0)."""
    src = _with_anchors(source_lm)
    tgt = _with_anchors(target_lm)
    tri = build_triangulation(tgt)
    delta = src - tgt
    values = np.stack([delta[:, 1], delta[:, 0], np.zeros_like(delta[:, 0])], 1)
    return _rasterize_host(tri, values, size)


def generate_uv_map(lm, size: int) -> np.ndarray:
    """Canonical face-UV map from landmarks (warp.py:215-232): the 68
    landmarks alone are triangulated, channels are (v, u, z)."""
    lm = np.asarray(lm, np.float32)
    return _rasterize_host(build_triangulation(lm), _UV_VALUES, size)


def generate_face_region(lm, size: int) -> np.ndarray:
    """Soft face-region mask (utils.py:255-276): hull of the landmarks plus
    the jaw reflected upward, rasterized, then 5x5 Gaussian blur.  Returns
    (size, size, 1) float32 in [0, 1]."""
    lm = np.asarray(lm, np.float32)
    pts = np.concatenate([lm, forehead_points(lm, 0.8)], axis=0)
    tri = build_triangulation(pts)
    mask = _rasterize_host(tri, np.ones((pts.shape[0], 1), np.float32), size)
    mask = torch.from_numpy((mask > 0).astype(np.float32))[None]
    return _gauss5(mask)[0].numpy()


def generate_face_region2(lm, size: int) -> np.ndarray:
    """The box-blurred face region (utils.py:278-294): the landmarks' hull
    with the jaw reflected upward at fold 0.6, rasterized, blurred by a
    45x45 box (cv2.blur, reflect-101 borders) and max-normalized.  Returns
    (size, size, 1) float32."""
    lm = np.asarray(lm, np.float32)
    pts = np.concatenate([lm, forehead_points(lm, 0.6)], axis=0)
    tri = build_triangulation(pts)
    mask = _rasterize_host(tri, np.ones((pts.shape[0], 1), np.float32), size)
    mask = torch.from_numpy((mask > 0).astype(np.float32))[None]
    mask = box_blur(mask, 45)[0].numpy()
    return mask / (mask.max() + 1e-6)


@functools.lru_cache(maxsize=1)
def _reg_in_static() -> tuple[np.ndarray, np.ndarray]:
    """LM_REF + anchors and their (static) Delaunay topology: the canonical
    target geometry of every reg_in map."""
    pts = _with_anchors(LM_REF)
    return pts, build_triangulation(pts).triangles


_UV_VALUES = np.stack(
    [UV_TABLE[:, 1], UV_TABLE[:, 0], UV_TABLE[:, 2]], 1).astype(np.float32)

# the geometry maps made, by path: "kernel" (one launch of
# csrc/rasterize.cu, counted where `geometry_maps_kernel` launches it) or
# "plain" (`geometry_maps_plain`); one count a `device_geometry_maps` call
RASTER_CALLS = {"kernel": 0, "plain": 0}
_calls_lock = threading.Lock()


@functools.lru_cache(maxsize=16)
def _constants(device: torch.device) -> dict:
    """The maps' constant operands on `device`, uploaded once: reg_in's
    canonical points (LM_REF + anchors) and their int32 topology, the
    anchors, the UV values and `_gauss5`'s taps.  A host-to-device copy
    from pageable memory waits on the stream, so a call that made its
    constants each time would hold the host until the card caught up.
    Made outside inference mode, so that autograd may save them."""
    with torch.inference_mode(False):
        ref_pts, ref_tris = _reg_in_static()
        return {"ref_pts": torch.from_numpy(ref_pts).to(device),
                "ref_tris": torch.from_numpy(ref_tris).to(device),
                "anchors": torch.from_numpy(ANCHOR_POINTS).to(device),
                "uv_vals": torch.from_numpy(_UV_VALUES).to(device),
                "taps": _gauss5_taps(device)}


@functools.lru_cache(maxsize=16)
def _grid(size: int, device: torch.device) -> torch.Tensor:
    """The grid coordinate of each row or column, (0..size-1) / (size-1),
    computed on `device` once.  `rasterize_linear` and the kernel both
    take these very values, so that the kernel's pixels sit where the plain
    path's do, whichever way the device's division by a scalar rounds."""
    with torch.inference_mode(False):
        return torch.arange(size, dtype=torch.float32,
                            device=device) / (size - 1)


def device_geometry_maps(lm: torch.Tensor, face_pts: torch.Tensor,
                         uv_tris: torch.Tensor, face_tris: torch.Tensor,
                         reg_tris: torch.Tensor, size: int) -> dict:
    """All per-view geometry maps rasterized on the inputs' device.

    lm [B,68,2] normalized, face_pts [B,85,2] (lm + forehead reflection),
    uv_tris/face_tris/reg_tris [B,T,3] int (-1 padded; reg_tris
    triangulates lm + anchors).  Returns {"uv" [B,S,S,3], "reg" [B,S,S,6]
    (reg_in ∥ reg_out), "face" [B,S,S,1]}, the same maps as
    generate_uv_map / generate_offset_map / generate_face_region.  CUDA
    inputs take the kernel (`geometry_maps_kernel`), others the plain path
    (`geometry_maps_plain`); `RASTER_CALLS` counts each.
    """
    maps = (geometry_maps_kernel if lm.device.type == "cuda"
            else geometry_maps_plain)
    return maps(lm, face_pts, uv_tris, face_tris, reg_tris, size)


def _count(path: str) -> None:
    with _calls_lock:
        RASTER_CALLS[path] += 1


def geometry_maps_plain(lm: torch.Tensor, face_pts: torch.Tensor,
                        uv_tris: torch.Tensor, face_tris: torch.Tensor,
                        reg_tris: torch.Tensor, size: int) -> dict:
    """`device_geometry_maps` in plain PyTorch, on any device: four calls
    of `rasterize_linear` and `_gauss5`."""
    dev = lm.device
    b = lm.shape[0]
    lm = lm.to(torch.float32)
    const = _constants(dev)
    ref_pts = const["ref_pts"]
    anchors = const["anchors"].expand(b, -1, -1)
    lm_anch = torch.cat([lm, anchors], dim=1)            # (B, 84, 2)

    def stack_vals(delta):
        return torch.cat([delta[..., 1:2], delta[..., 0:1],
                          torch.zeros_like(delta[..., :1])], dim=-1)

    uv_vals = const["uv_vals"].expand(b, -1, -1)
    uv = rasterize_linear(lm, uv_tris, uv_vals, size)
    # reg_in: target = canonical (static topology), values = lm - ref
    reg_in = rasterize_linear(ref_pts.expand(b, -1, -1),
                              const["ref_tris"].expand(b, -1, -1),
                              stack_vals(lm_anch - ref_pts), size)
    # reg_out: target = per-sample landmarks, values = ref - lm
    reg_out = rasterize_linear(lm_anch, reg_tris,
                               stack_vals(ref_pts - lm_anch), size)
    ones = torch.ones((b, face_pts.shape[1], 1), dtype=torch.float32,
                      device=dev)
    face = rasterize_linear(face_pts, face_tris, ones, size)
    face = _gauss5((face > 0).to(torch.float32))
    _count("plain")
    return {"uv": uv, "reg": torch.cat([reg_in, reg_out], dim=-1),
            "face": face}


@functools.lru_cache(maxsize=1)
def _raster_kernel():
    """(library, its launch function) of csrc/rasterize.cu, built at the
    first call."""
    lib = _build.load("rasterize")
    fn = lib.bsr_geometry_maps
    fn.argtypes = ([ctypes.c_void_p] * 14 + [ctypes.c_int] * 9
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


def geometry_maps_kernel(lm: torch.Tensor, face_pts: torch.Tensor,
                         uv_tris: torch.Tensor, face_tris: torch.Tensor,
                         reg_tris: torch.Tensor, size: int) -> dict:
    """`device_geometry_maps` on a CUDA device in one launch of the kernel
    (csrc/rasterize.cu), on the current stream of the inputs' device.  The
    inputs' shapes are `device_geometry_maps`'s; the topologies are read
    as int32 (the staged wires' type: converted otherwise), their indices
    in [-1, points).  Raises on inputs the kernel does not take."""
    dev = lm.device
    if dev.type != "cuda":
        raise ValueError(f"geometry_maps_kernel: the inputs must lie on a "
                         f"CUDA device, got {dev}")
    const = _constants(dev)
    lm = lm.to(dtype=torch.float32).contiguous()
    face_pts = face_pts.to(device=dev, dtype=torch.float32).contiguous()
    tris = [t.to(device=dev, dtype=torch.int32).contiguous()
            for t in (uv_tris, face_tris, reg_tris)]
    b, n_lm = lm.shape[:2]
    if (lm.shape != (b, len(_UV_VALUES), 2)
            or face_pts.shape[0] != b or face_pts.shape[2:] != (2,)
            or any(t.dim() != 3 or t.shape[0] != b or t.shape[2] != 3
                   for t in tris)):
        raise ValueError(
            f"geometry_maps_kernel: expected lm [B,{len(_UV_VALUES)},2], "
            f"face_pts [B,P,2] and topologies [B,T,3]; got "
            f"{[tuple(x.shape) for x in (lm, face_pts, *tris)]}")
    uv = torch.empty((b, size, size, 3), dtype=torch.float32, device=dev)
    reg = torch.empty((b, size, size, 6), dtype=torch.float32, device=dev)
    face = torch.empty((b, size, size, 1), dtype=torch.float32, device=dev)
    lib, fn = _raster_kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(lm.data_ptr(), face_pts.data_ptr(),
                 *(t.data_ptr() for t in tris),
                 const["ref_pts"].data_ptr(), const["ref_tris"].data_ptr(),
                 const["anchors"].data_ptr(), const["uv_vals"].data_ptr(),
                 _grid(size, dev).data_ptr(), const["taps"].data_ptr(),
                 uv.data_ptr(), reg.data_ptr(), face.data_ptr(),
                 b, size, n_lm, len(ANCHOR_POINTS), face_pts.shape[1],
                 *(t.shape[1] for t in tris),
                 const["ref_tris"].shape[0], stream)
    _build.raise_on_error(err, lib, "device_geometry_maps")
    _count("kernel")
    return {"uv": uv, "reg": reg, "face": face}


@functools.lru_cache(maxsize=16)
def _gauss5_taps(device: torch.device) -> torch.Tensor:
    """The 5 taps of `_gauss5` on `device` (OpenCV's sigma-from-ksize
    convention, sigma=1.1), computed there once."""
    with torch.inference_mode(False):
        n = torch.arange(-2, 3, dtype=torch.float32, device=device)
        sigma = 0.3 * ((5 - 1) * 0.5 - 1) + 0.8
        k = torch.exp(-0.5 * (n / sigma) ** 2)
        return k / k.sum()


def _gauss5(x: torch.Tensor) -> torch.Tensor:
    """5x5 Gaussian blur of [B,H,W,C] with OpenCV's sigma-from-ksize
    convention (sigma=1.1) and edge padding."""
    k = _gauss5_taps(x.device)
    return _separable(x, k, k)


def _separable(x: torch.Tensor, kr: torch.Tensor,
               kc: torch.Tensor) -> torch.Tensor:
    """Separable filter along H then W of [B,H,W,C], edge ("replicate")
    padding."""
    c = x.shape[-1]
    rr, rc = kr.shape[0] // 2, kc.shape[0] // 2
    xn = x.permute(0, 3, 1, 2)
    xn = F.pad(xn, (0, 0, rr, rr), mode="replicate")
    xn = F.conv2d(xn, kr.view(1, 1, -1, 1).expand(c, 1, -1, 1), groups=c)
    xn = F.pad(xn, (rc, rc, 0, 0), mode="replicate")
    xn = F.conv2d(xn, kc.view(1, 1, 1, -1).expand(c, 1, 1, -1), groups=c)
    return xn.permute(0, 2, 3, 1)
