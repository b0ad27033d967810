"""Activation bounds of the int8 output head from the checkpoint itself
(port of `blindshadowremoval_tpu/ops/calibration.py`).

The head's input is LeakyReLU(BatchNorm(ConvT(...))), the generator's
`up3` block.  In eval mode the BatchNorm maps its input to mean beta_c and
scale |gamma_c| per channel, so a K-sigma envelope through the LeakyReLU
bounds the head's input from checkpoint tensors alone:

    hi_c = beta_c + K*|gamma_c|,  lo_c = beta_c - K*|gamma_c|
    bound_c = max(|lrelu(hi_c)|, |lrelu(lo_c)|, floor)

It reads the unfolded state dict (`up3.bn.weight`, `up3.bn.bias`):
folding consumes those statistics, so every restore path calibrates
first, then folds.
"""

from __future__ import annotations

import dataclasses

import numpy as np

LEAKY_SLOPE = 0.3   # models/blocks.py (Keras default)


def _lrelu(x: np.ndarray) -> np.ndarray:
    return np.where(x > 0, x, LEAKY_SLOPE * x)


def _numpy(t) -> np.ndarray:
    return np.asarray(t.detach().cpu().float().numpy() if hasattr(t, "detach")
                      else t, np.float32)


def head_input_bounds(state_dict: dict, k_sigma: float = 8.0,
                      floor: float = 0.05) -> tuple[float, ...]:
    """Per-channel int8 bounds of the head's input, a tuple (hashable, for
    the frozen Config) for `int8_head_scale`.  `floor` keeps a channel
    whose BatchNorm collapsed (gamma ~ 0) off a zero bound."""
    gamma = _numpy(state_dict["up3.bn.weight"])
    beta = _numpy(state_dict["up3.bn.bias"])
    hi = _lrelu(beta + k_sigma * np.abs(gamma))
    lo = _lrelu(beta - k_sigma * np.abs(gamma))
    bound = np.maximum(np.maximum(np.abs(hi), np.abs(lo)), floor)
    return tuple(float(b) for b in bound)


def calibrate_config(config, state_dict: dict):
    """With the int8 head (or the split head) on and `int8_head_scale` at
    its 0.0 auto default, the config with per-channel bounds from the
    state dict's own BatchNorm; the config unchanged otherwise (and for
    rgb, which has no such head)."""
    if ((config.int8_head or config.int8_head_split)
            and config.int8_head_scale == 0.0 and config.variant != "rgb"):
        config = dataclasses.replace(
            config, int8_head_scale=head_input_bounds(state_dict))
    return config
