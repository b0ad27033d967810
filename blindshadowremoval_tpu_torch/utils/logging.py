"""Training/eval logging: running-mean losses, figure grids, result PNGs
(port of `blindshadowremoval_tpu/utils/logging.py`).

Re-design of the reference `Logging` class (utils.py:127-253): running-average
loss lines per step, periodic PNG figure grids of intermediate tensors, and
per-image `<id>-result.png` dumps (with the RGB->BGR swap handled by the
image writer rather than manual channel shuffling).  Images are resized and
written by the port's own codec (utils/imageio.py), not cv2 or PIL.
"""

from __future__ import annotations

import os
import time
from typing import Mapping, Sequence

import numpy as np
import torch

from blindshadowremoval_tpu_torch.utils.imageio import resize_linear, write_png


def _host(x) -> np.ndarray:
    """A numpy array, or a tensor (on any device) fetched as f32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x)


def _to_uint8(img01: np.ndarray) -> np.ndarray:
    return (np.clip(img01, 0.0, 1.0) * 255.0).astype(np.uint8)


def _ensure_rgb3(img: np.ndarray) -> np.ndarray:
    if img.shape[-1] == 1:
        return np.concatenate([img] * 3, axis=-1)
    return img[..., :3]


def _resize(img: np.ndarray, size: int) -> np.ndarray:
    """Bilinear resize of a uint8 [H, W, 3] image to size x size, rounded
    back to uint8 (cv2 rounds its fixed-point sums alike, to within one
    grey level)."""
    if img.shape[:2] == (size, size):
        return img
    out = resize_linear(img.astype(np.float32), (size, size))
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def save_png(path: str, img01: np.ndarray) -> None:
    write_png(path, _to_uint8(img01))


class TrainLogger:
    """Running-mean loss display + figure writer (utils.py:127-253)."""

    def __init__(self, checkpoint_dir: str, img_log_freq: int = 100,
                 txt_log_freq: int = 1000, fig_size: int = 128):
        self.dir = checkpoint_dir
        self.img_log_freq = img_log_freq
        self.txt_log_freq = txt_log_freq
        self.fig_size = fig_size
        os.makedirs(self.dir, exist_ok=True)
        os.makedirs(os.path.join(self.dir, "test"), exist_ok=True)
        self._sums: dict[str, list] = {}
        self._sums_val: dict[str, list] = {}
        self._text = ""
        self._t0 = time.time()

    # ----------------------------------------------------------- losses
    def update(self, losses: Mapping[str, float], training: bool) -> None:
        store = self._sums if training else self._sums_val
        for name, value in losses.items():
            v = float(value)
            if name in store:
                store[name][0] += v
                store[name][1] += 1
            else:
                store[name] = [v, 1]

    def display(self, losses: Mapping[str, float], epoch: int, step: int,
                training: bool, all_steps: int) -> str:
        self.update(losses, training)
        store = self._sums if training else self._sums_val
        tag = "Train" if training else " Val "
        parts = [f"{k}:{v[0] / v[1]:.3g}" for k, v in store.items()]
        text = (f"Epoch ({tag}) {epoch + 1}-{step + 1}/{all_steps}: "
                + ", ".join(parts))
        print(text)
        self._text = text
        self._epoch, self._step = epoch, step
        return text

    def reset(self) -> None:
        self._sums = {}
        self._sums_val = {}

    # ---------------------------------------------------------- figures
    def figure_grid(self, figs: Sequence[np.ndarray],
                    size: int | None = None) -> np.ndarray:
        """Stack [B,H,W,C] arrays or tensors into a (len*size, B*size, 3)
        grid (utils.py:235-253, without the BGR swap)."""
        size = size or self.fig_size
        rows = []
        for f in figs:
            f = _host(f)
            f = _ensure_rgb3(np.clip(f, 0.0, 1.0))
            row = np.concatenate(
                [_resize(_to_uint8(f[i]), size) for i in range(f.shape[0])],
                axis=1)
            rows.append(row)
        return np.concatenate(rows, axis=0)

    def save_figures(self, figs: Sequence[np.ndarray], training: bool) -> None:
        step = self._step
        tag = "Train" if training else "Val"
        freq = self.img_log_freq if training else max(self.img_log_freq // 10, 1)
        if step % freq == 0:
            fname = os.path.join(
                self.dir, f"epoch-{self._epoch + 1}-{tag}-{step + 1}.png")
            grid = self.figure_grid(figs)
            save_png(fname, grid.astype(np.float32) / 255.0)
        tfreq = self.txt_log_freq if training else max(self.txt_log_freq // 10, 1)
        if step % tfreq == 0:
            with open(os.path.join(self.dir, "log.txt"), "a") as fh:
                fh.write(self._text + "\n")

    def save_result_image(self, figs: Sequence[np.ndarray],
                          name: str, img_size: int = 256) -> str:
        """Per-image result strip `<dir>/test/<id>-result.png`
        (utils.py:196-204)."""
        parts = name.replace("\\", "/").split("/")
        stem = (parts[-2] + "_" if len(parts) >= 2 else "") + \
            parts[-1].split(".")[0]
        fname = os.path.join(self.dir, "test", stem + "-result.png")
        row = np.concatenate(
            [_resize(_to_uint8(_ensure_rgb3(np.clip(np.asarray(f)[0], 0, 1))),
                     img_size) for f in figs], axis=1)
        save_png(fname, row.astype(np.float32) / 255.0)
        return fname
