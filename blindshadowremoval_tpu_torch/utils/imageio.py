"""Image files and resampling on the host, with numpy and zlib only.

The JAX package reads and writes images with cv2 and PIL; this port uses
neither.  Here:

  * `read_png` decodes 8-bit non-interlaced PNGs (gray, gray+alpha, RGB,
    RGBA) with all five row filters;
  * `imread` returns what `cv2.imread` returns for such a file: BGR uint8
    with gray expanded to 3 channels and alpha dropped, or one gray plane
    with `gray=True`;
  * `write_png` writes uint8 gray, RGB or RGBA arrays as given;
  * `resize_linear` is `cv2.resize(img, (w, h), interpolation=INTER_LINEAR)`
    on float arrays: half-pixel centres, clamped edges, two taps an axis
    in f64.
"""

from __future__ import annotations

import functools
import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples per pixel (8-bit depths only)
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _chunks(data: bytes):
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        yield kind, data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IEND":
            return


def _unfilter_slow(kind: int, row: bytearray, prev: bytes, bpp: int) -> None:
    """Average (3) and Paeth (4) rows: each byte depends on the decoded byte
    bpp to its left, so they decode byte by byte, in place."""
    n = len(row)
    if kind == 3:
        for x in range(n):
            left = row[x - bpp] if x >= bpp else 0
            row[x] = (row[x] + ((left + prev[x]) >> 1)) & 0xFF
        return
    for x in range(n):
        a = row[x - bpp] if x >= bpp else 0
        b = prev[x]
        c = prev[x - bpp] if x >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        row[x] = (row[x] + pred) & 0xFF


def read_png(path: str) -> np.ndarray:
    """[H, W, C] uint8 in the file's own channel order (gray C=1, gray +
    alpha C=2, RGB C=3, RGBA C=4).  Raises ValueError on anything else:
    other bit depths, palettes, interlacing."""
    with open(path, "rb") as fh:
        data = fh.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    width, height, depth, colour, _, _, interlace = header
    if depth != 8 or colour not in _CHANNELS or interlace != 0:
        raise ValueError(f"{path}: only 8-bit non-interlaced gray, gray+alpha,"
                         f" RGB and RGBA PNGs are supported (bit depth "
                         f"{depth}, colour type {colour}, interlace "
                         f"{interlace})")
    bpp = _CHANNELS[colour]
    stride = width * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (stride + 1):
        raise ValueError(f"{path}: image data holds {raw.size} bytes, "
                         f"expected {height * (stride + 1)}")
    rows = raw.reshape(height, stride + 1)
    out = np.empty((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for r in range(height):
        kind, line = int(rows[r, 0]), rows[r, 1:]
        if kind == 0:
            out[r] = line
        elif kind == 1:    # Sub: a running sum mod 256 along each channel
            out[r] = np.cumsum(line.reshape(width, bpp), axis=0,
                               dtype=np.uint8).reshape(-1)
        elif kind == 2:    # Up
            out[r] = line + prev
        elif kind in (3, 4):
            buf = bytearray(line.tobytes())
            _unfilter_slow(kind, buf, prev.tobytes(), bpp)
            out[r] = np.frombuffer(bytes(buf), np.uint8)
        else:
            raise ValueError(f"{path}: row {r} has filter type {kind}")
        prev = out[r]
    return out.reshape(height, width, bpp)


def _gray_from_rgb(rgb: np.ndarray) -> np.ndarray:
    """libpng's 8-bit RGB -> gray with the weights cv2 asks it for, as
    `cv2.imread(path, 0)` does: 0.299 and 0.587 truncated to 15-bit fixed
    point, blue the rest of 32768, the sum truncated."""
    r, g, b = (rgb[..., i].astype(np.uint32) for i in range(3))
    return ((r * 9797 + g * 19234 + b * 3737) >> 15).astype(np.uint8)


def imread(path: str, gray: bool = False) -> np.ndarray:
    """What `cv2.imread(path)` returns for an 8-bit PNG: [H, W, 3] BGR
    uint8, gray expanded to 3 channels and alpha dropped; with `gray=True`
    what `cv2.imread(path, 0)` returns: [H, W] uint8."""
    img = read_png(path)
    c = img.shape[2]
    if gray:
        return img[..., 0] if c <= 2 else _gray_from_rgb(img[..., :3])
    if c <= 2:
        return np.repeat(img[..., :1], 3, axis=2)
    return np.ascontiguousarray(img[..., 2::-1])


def write_png(path: str, img: np.ndarray, level: int = 6) -> None:
    """Write uint8 [H, W] / [H, W, 1] gray, [H, W, 3] RGB or [H, W, 4] RGBA
    as an 8-bit PNG, channels in the order given (no row filter)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"write_png takes uint8 arrays, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    height, width, c = img.shape
    colour = {1: 0, 3: 2, 4: 6}.get(c)
    if colour is None:
        raise ValueError(f"write_png takes 1, 3 or 4 channels, got {c}")
    rows = np.concatenate(
        [np.zeros((height, 1), np.uint8),
         np.ascontiguousarray(img).reshape(height, width * c)], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    header = struct.pack(">IIBBBBB", width, height, 8, colour, 0, 0, 0)
    with open(path, "wb") as fh:
        fh.write(_SIGNATURE + chunk(b"IHDR", header)
                 + chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
                 + chunk(b"IEND", b""))


@functools.lru_cache(maxsize=64)
def _linear_taps(out_size: int, in_size: int):
    """cv2's INTER_LINEAR along one axis: output i samples the input at
    (i + 0.5) * in/out - 0.5, placed in f64 as cv2 places it, clamped to
    [0, in - 1]; returns the two source indices and the weight of the
    second."""
    src = ((np.arange(out_size) + 0.5) * (in_size / out_size) - 0.5)
    src = np.clip(src, 0.0, in_size - 1.0)
    j0 = np.floor(src).astype(np.int64)
    return j0, np.minimum(j0 + 1, in_size - 1), src - j0


def _lerp(x: np.ndarray, axis: int, out_size: int) -> np.ndarray:
    j0, j1, frac = _linear_taps(out_size, x.shape[axis])
    frac = frac.reshape((-1,) + (1,) * (x.ndim - 1 - axis))
    a = np.take(x, j0, axis=axis)
    return a + frac * (np.take(x, j1, axis=axis) - a)


def resize_linear(img: np.ndarray, dsize: tuple[int, int]) -> np.ndarray:
    """`cv2.resize(img, dsize, interpolation=cv2.INTER_LINEAR)` of a float
    [H, W] or [H, W, C] array; dsize is (width, height), as in cv2.
    Returns f32 ([H', W'] for a 2-D input, as cv2 does).  Two-tap gathers
    in f64, rows then columns: no BLAS call, whose thread pool would spin
    in every parse worker process."""
    x = np.asarray(img).astype(np.float64)
    w, h = int(dsize[0]), int(dsize[1])
    return _lerp(_lerp(x, 0, h), 1, w).astype(np.float32)
