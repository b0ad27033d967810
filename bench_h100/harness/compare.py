"""How an answer is held against the reference: two numbers an answer.

The generators gate their RGB half by a hard threshold (dif > 0.1, at the
32 x 32 bottleneck), so where the reference's gate input lies near the
threshold, bf16 can fall on the other side and move a patch of the output
by up to ~0.2: the model's own reaction to rounding, and no fault.

- `tmae`: the mean absolute gap from the reference over the share `KEEP`
  of an answer's values nearest it (trimmed).  It leaves the gate's
  patches out and keeps every other value: a wrong answer, a batch half
  left out or a precision lower than the configuration's moves far more
  than a tenth of an answer's values.
- `far`: the share of an answer's values that lie more than `TAU` outside
  the reference's gate envelope, the range that the reference's answer
  spans when its gate threshold moves by `DELTA` either way (the reference
  run at 0.1 - DELTA, 0.1 and 0.1 + DELTA).  Nothing is trimmed: a gate
  that rounding can flip widens the envelope where it acts, and a local
  fault anywhere else, such as a triangle the rasterizer drops or a face
  gate that misses the border, shows as values outside it.
"""

from __future__ import annotations

import numpy as np
import torch

from bench_h100.reference.generator import GATE

KEEP = 0.9
DELTA = 0.02
TAU = 0.02
# the envelopes and distances that `control.py` reads besides, to choose
# DELTA and TAU from
LOOK_DELTAS = (0.02, 0.04, 0.08)
LOOK_TAUS = (0.01, 0.02, 0.03, 0.05, 0.1)
BLOCK = 128


def _stack(arrays: list, device) -> torch.Tensor:
    return torch.from_numpy(np.stack([np.asarray(a, np.float32).ravel()
                                      for a in arrays])).to(device)


def gaps(got: list, want: list, device) -> tuple[np.ndarray, np.ndarray]:
    """(mean absolute gap, trimmed mean absolute gap) of each pair of
    arrays in `got` and `want`, computed on `device` in blocks."""
    means, trimmed = [], []
    for s in range(0, len(got), BLOCK):
        err = (_stack(got[s:s + BLOCK], device)
               - _stack(want[s:s + BLOCK], device)).abs()
        k = max(1, int(KEEP * err.shape[1]))
        means.append(err.mean(1).cpu().numpy())
        trimmed.append(err.sort(dim=1).values[:, :k].mean(1).cpu().numpy())
    return np.concatenate(means), np.concatenate(trimmed)


def far_shares(got: list, lo: list, hi: list, device,
               taus: tuple = (TAU,)) -> np.ndarray:
    """[answers, len(taus)]: the share of each answer's values that lie
    more than each tau outside its envelope [lo, hi]."""
    out = []
    for s in range(0, len(got), BLOCK):
        a = _stack(got[s:s + BLOCK], device)
        outside = torch.maximum(_stack(lo[s:s + BLOCK], device) - a,
                                a - _stack(hi[s:s + BLOCK], device))
        out.append(torch.stack([(outside > t).float().mean(1) for t in taus],
                               1).cpu().numpy())
    return np.concatenate(out)


def grid(look: bool) -> tuple[tuple, tuple]:
    """(deltas, taus) that a check reads: the compared ones, or with
    `look` the whole grid that `control.py` reads."""
    return ((LOOK_DELTAS, LOOK_TAUS) if look else ((DELTA,), (TAU,)))


def gates(deltas: tuple = (DELTA,)) -> tuple:
    """The shadow gate's thresholds that the reference runs at for
    envelopes `deltas` wide: the model's own first."""
    return (GATE,) + tuple(g for d in deltas for g in (GATE - d, GATE + d))


def envelope(ref: np.ndarray, delta: float,
             deltas: tuple) -> tuple[np.ndarray, np.ndarray]:
    """(lo, hi) over the reference's answers [gate, ...] (in `gates(deltas)`'s
    order) at the model's gate and `delta` either side of it."""
    i = 1 + 2 * deltas.index(delta)
    band = ref[[0, i, i + 1]]
    return band.min(0), band.max(0)
