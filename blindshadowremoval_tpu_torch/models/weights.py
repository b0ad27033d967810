"""Weight bridges into the port's `state_dict`s.

Two sources, both plain numpy, so neither needs JAX or TensorFlow:

  * `from_jax_variables`: the JAX package's generator variables
    (`{params, batch_stats}`, or a folded `{params}` tree), as numpy;
    `discriminator_from_jax` and `vgg_from_jax` do the same for the
    discriminator trio and VGG-19, so tests start both packages from one
    JAX initialization; `train_state_from_jax` carries a whole JAX
    `TrainState` (weights, statistics, both optax Adam states, the LR
    schedule's count) into a `TrainState.state_dict()`, so a JAX run
    continues in the port.
  * `load_tf_weights`: a `{tf_name: array}` dict in the reference's TF
    checkpoint naming, through the name mapping of a generator variant (a
    port of `blindshadowremoval_tpu/models/tf_checkpoint.py:
    generator_mapping`).
    `synthetic_tf_weights` makes such a dict deterministically from a seed,
    value for value as the JAX package's function does, so the TF-reference
    goldens in tests/goldens/tf_ref/ can be reproduced without JAX.

Kernel layouts: Flax and Keras Conv2D kernels are HWIO, torch Conv2d is
OIHW.  Flax ConvTranspose kernels are [kh, kw, IN, OUT] applied as a
fractionally-strided correlation; torch ConvTranspose2d is [IN, OUT, kh,
kw] applied as the gradient of a conv, so the Flax kernel is flipped
spatially.  Keras Conv2DTranspose ([kh, kw, OUT, IN], gradient semantics)
needs no flip: it maps to torch by the same axis permutation as a conv.
"""

from __future__ import annotations

import zlib
from typing import Any

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))   # a writable copy


# ------------------------------------------------------------------ JAX tree
def _conv_from_flax(sd: dict, name: str, node: dict, transpose: bool) -> None:
    k = np.asarray(node["kernel"], np.float32)
    # Flax [kh,kw,in,out] -> torch Conv2d [out,in,kh,kw] or, flipped,
    # ConvTranspose2d [in,out,kh,kw]
    sd[f"{name}.weight"] = _t(k[::-1, ::-1].transpose(2, 3, 0, 1) if transpose
                              else k.transpose(3, 2, 0, 1))
    sd[f"{name}.bias"] = _t(node["bias"])


def _bn_from_flax(sd: dict, name: str, params: dict, stats: dict) -> None:
    sd[f"{name}.weight"] = _t(params["scale"])
    sd[f"{name}.bias"] = _t(params["bias"])
    sd[f"{name}.running_mean"] = _t(stats["mean"])
    sd[f"{name}.running_var"] = _t(stats["var"])
    sd[f"{name}.num_batches_tracked"] = torch.tensor(0)


_CONV_BLOCK = {"Conv_0": "conv", "ConvTranspose_0": "conv", "BatchNorm_0": "bn"}
_NONLOCAL_BLOCK = {"g": "g", "phi": "phi", "theta": "theta", "w": "w",
                   "BatchNorm_0": "bn"}
_RES_BLOCK = {"Conv_0": "conv1", "Conv_1": "conv2", "Conv_2": "conv3",
              "BatchNorm_0": "bn1", "BatchNorm_1": "bn2", "BatchNorm_2": "bn3",
              "NonLocalBlock_0": "non_local"}
_BLOCK_NAMES = {"conv": _CONV_BLOCK, "nonlocal": _NONLOCAL_BLOCK,
                "res": _RES_BLOCK}


def block_from_jax(params: dict, stats: dict, kind: str,
                   prefix: str = "") -> dict[str, torch.Tensor]:
    """One Flax block's variables -> its torch state_dict.  `kind` is
    "conv" (ConvBlock / ConvTBlock), "nonlocal" or "res"."""
    names = _BLOCK_NAMES[kind]
    sd: dict[str, torch.Tensor] = {}
    for flax_name, node in params.items():
        name = prefix + names[flax_name]
        if flax_name.startswith("BatchNorm_"):
            _bn_from_flax(sd, name, node, stats[flax_name])
        elif flax_name == "NonLocalBlock_0":
            sd.update(block_from_jax(node, stats.get(flax_name, {}),
                                     "nonlocal", name + "."))
        else:
            _conv_from_flax(sd, name, node,
                            transpose=flax_name.startswith("ConvTranspose"))
    return sd


def from_jax_variables(tree: Any) -> dict[str, torch.Tensor]:
    """JAX generator variables of any variant (numpy leaves;
    `{params, batch_stats}` or folded `{params}`) -> a state_dict of the
    port's generator of that variant (built with `fold_bn=True` for a
    folded tree)."""
    params = tree["params"]
    stats = tree.get("batch_stats", {})
    sd: dict[str, torch.Tensor] = {}
    for top, node in params.items():
        if top.startswith("res"):
            sd.update(block_from_jax(node, stats.get(top, {}), "res",
                                     f"res.{int(top[3:])}."))
        else:
            sd.update(block_from_jax(node, stats.get(top, {}), "conv",
                                     f"{top}."))
    return sd


def discriminator_from_jax(tree: Any) -> dict[str, torch.Tensor]:
    """JAX MultiScaleDiscriminators variables (`{params, batch_stats}`,
    numpy leaves) -> a state_dict of the port's MultiScaleDiscriminators."""
    params = tree["params"]
    stats = tree.get("batch_stats", {})
    sd: dict[str, torch.Tensor] = {}
    for top, disc in params.items():           # disc1, disc2, disc3
        k = int(top[len("disc"):]) - 1
        for name, node in disc.items():         # conv0.., head
            prefix = (f"discs.{k}.head." if name == "head" else
                      f"discs.{k}.convs.{int(name[len('conv'):])}.")
            sd.update(block_from_jax(node, stats.get(top, {}).get(name, {}),
                                     "conv", prefix))
    return sd


def vgg_from_jax(params: Any) -> dict[str, torch.Tensor]:
    """JAX VGG19Features params (`{block1_conv1: {kernel, bias}, ...}`) ->
    a state_dict of the port's VGG19Features; the layers the port does not
    run (past block5_conv1) are dropped."""
    from blindshadowremoval_tpu_torch.models.vgg import conv_names

    sd: dict[str, torch.Tensor] = {}
    for name in conv_names():
        _conv_from_flax(sd, f"convs.{name}", params[name], transpose=False)
    return sd


_BUFFERS = ("running_mean", "running_var", "num_batches_tracked")


def _param_tree(convert, params: Any, stats: Any) -> dict[str, torch.Tensor]:
    """A tree shaped like `params` (an optax moment) -> {parameter name:
    tensor}, through the converter of its network."""
    sd = convert({"params": params, "batch_stats": stats})
    return {k: v for k, v in sd.items() if not k.endswith(_BUFFERS)}


def _adam_from_optax(opt_state: Any, convert, stats: Any) -> dict:
    """optax `adam(lr, eps)` state, (ScaleByAdamState(count, mu, nu),
    EmptyState | ScaleByScheduleState(count)), -> the port's Adam state by
    parameter name.  optax's count is torch's step: both bias-correct
    with the count after the update, and both add eps outside the square
    root."""
    adam = opt_state[0]
    return {"count": int(np.asarray(adam.count)),
            "exp_avg": _param_tree(convert, adam.mu, stats),
            "exp_avg_sq": _param_tree(convert, adam.nu, stats)}


def train_state_from_jax(state: Any) -> dict:
    """A JAX `TrainState` (numpy leaves: step, gen_params/gen_stats,
    disc_params/disc_stats, vgg_params, gen_opt_state, disc_opt_state) ->
    the port's `TrainState.state_dict()`; load it with
    `TrainState.load_state_dict` into a state of the same config."""
    # ScaleByScheduleState(count) under LR decay, else EmptyState(): both
    # are NamedTuples, and a tuple has a `count` method, so ask its fields
    sched = state.gen_opt_state[1]
    decays = "count" in getattr(sched, "_fields", ())
    return {
        "step": int(np.asarray(state.step)),
        "gen": from_jax_variables({"params": state.gen_params,
                                   "batch_stats": state.gen_stats}),
        "disc": discriminator_from_jax({"params": state.disc_params,
                                        "batch_stats": state.disc_stats}),
        "vgg": vgg_from_jax(state.vgg_params),
        "gen_opt": _adam_from_optax(state.gen_opt_state, from_jax_variables,
                                    state.gen_stats),
        "disc_opt": _adam_from_optax(state.disc_opt_state,
                                     discriminator_from_jax,
                                     state.disc_stats),
        "lr_count": int(np.asarray(sched.count)) if decays else None,
    }


# ------------------------------------------------------------------- TF names
def _bn_entries(torch_prefix: str, tf_prefix: str):
    return [(f"{torch_prefix}.weight", f"{tf_prefix}/gamma", None),
            (f"{torch_prefix}.bias", f"{tf_prefix}/beta", None),
            (f"{torch_prefix}.running_mean", f"{tf_prefix}/moving_mean", None),
            (f"{torch_prefix}.running_var", f"{tf_prefix}/moving_variance",
             None)]


def _conv_entries(torch_prefix: str, tf_prefix: str, has_bn: bool):
    entries = [(f"{torch_prefix}.conv.weight", f"{tf_prefix}/conv/kernel", None),
               (f"{torch_prefix}.conv.bias", f"{tf_prefix}/conv/bias", None)]
    if has_bn:
        entries += _bn_entries(f"{torch_prefix}.bn", f"{tf_prefix}/bnorm")
    return entries


def generator_mapping(variant: str = "gsc", n_res: int = 6):
    """[(torch_name, tf_name, channel_slice)] for a generator variant
    (tf_checkpoint.py:117-176).

    `channel_slice` = (start, stop) lands the TF tensor in an output-channel
    slice of the torch tensor: the reference's gsc/tsm conv2/conv3 heads
    (two 7x7 convs to one channel each) are the fused 2-channel `head` conv
    here.  "tsm" has the gsc names (its ShareLayer has no weights and only
    widens res0, res3, up1 and clr_up1); "rgb" has no clr_* layers, its
    conv2/conv3 are sequential 3-channel convs, and only res_stack
    0..n_res//2-1 exist.
    """
    if variant not in ("gsc", "tsm", "rgb"):
        raise ValueError(f"unknown generator variant {variant!r}")
    rgb = variant == "rgb"
    entries = _conv_entries("conv1", "generator/conv1", True)
    if rgb:
        entries += _conv_entries("conv2", "generator/conv2", False)
        entries += _conv_entries("conv3", "generator/conv3", False)
    else:
        for i, tf_layer in enumerate(("conv2", "conv3")):
            for leaf, tname in (("kernel", "weight"), ("bias", "bias")):
                entries.append((f"head.conv.{tname}",
                                f"generator/{tf_layer}/conv/{leaf}",
                                (i, i + 1)))
    for i in (1, 2, 3):
        entries += _conv_entries(f"down{i}", f"generator/down{i}", True)
        entries += _conv_entries(f"up{i}", f"generator/up{i}", True)
        if not rgb:
            entries += _conv_entries(f"clr_up{i}", f"generator/clr_up{i}",
                                     True)
    if not rgb:
        entries += _conv_entries("clr_conv1", "generator/clr_conv1", True)
        entries += _conv_entries("clr_conv2", "generator/clr_conv2", True)
        entries += _conv_entries("clr_conv3", "generator/clr_conv3", False)
    for i in range(n_res // 2 if rgb else n_res):
        tp, tf = f"res.{i}", f"generator/res_stack/{i}"
        for j in (1, 2, 3):
            entries += [(f"{tp}.conv{j}.weight", f"{tf}/conv{j}/kernel", None),
                        (f"{tp}.conv{j}.bias", f"{tf}/conv{j}/bias", None)]
            entries += _bn_entries(f"{tp}.bn{j}", f"{tf}/bnorm{j}")
        for name in ("g", "phi", "theta", "w"):
            entries += [
                (f"{tp}.non_local.{name}.weight",
                 f"{tf}/non_local/{name}/kernel", None),
                (f"{tp}.non_local.{name}.bias", f"{tf}/non_local/{name}/bias",
                 None)]
        entries += _bn_entries(f"{tp}.non_local.bn", f"{tf}/non_local/bnorm")
    return entries


def _tf_shape(torch_shape: tuple) -> tuple:
    """TF layout of a torch tensor shape: Conv2d [O,I,H,W] -> HWIO and
    ConvTranspose2d [I,O,H,W] -> Keras [H,W,O,I] are the same permutation."""
    if len(torch_shape) == 4:
        return (torch_shape[2], torch_shape[3], torch_shape[1], torch_shape[0])
    return tuple(torch_shape)


def _to_torch_layout(value: np.ndarray) -> np.ndarray:
    value = np.asarray(value, np.float32)
    return value.transpose(3, 2, 0, 1) if value.ndim == 4 else value


def synthetic_tf_weights(state_dict: dict, mapping, seed: int = 0) -> dict:
    """Deterministic random {tf_name: float32 array} covering `mapping`,
    shaped from `state_dict` (an unfolded generator's of the mapping's
    variant).  Value for value
    the JAX package's `tf_checkpoint.synthetic_tf_weights`: each tensor is a
    pure function of (tf_name, seed), sized so 40+ stacked conv+BN layers
    stay sane (glorot-ish kernels, near-identity BN statistics)."""
    out = {}
    for torch_name, tf_name, dst in mapping:
        shape = tuple(state_dict[torch_name].shape)
        if dst is not None:
            shape = (dst[1] - dst[0],) + shape[1:]
        shape = _tf_shape(shape)
        rng = np.random.default_rng((zlib.crc32(tf_name.encode()) << 8) ^ seed)
        leafname = tf_name.rsplit("/", 1)[-1]
        if leafname == "kernel" and len(shape) == 4:
            fan_in = shape[0] * shape[1] * shape[2]
            fan_out = shape[0] * shape[1] * shape[3]
            val = rng.normal(0.0, np.sqrt(2.0 / (fan_in + fan_out)), shape)
        elif leafname == "gamma":
            val = 1.0 + rng.normal(0.0, 0.05, shape)
        elif leafname == "moving_variance":
            val = rng.uniform(0.5, 1.5, shape)
        else:  # bias / beta / moving_mean
            val = rng.normal(0.0, 0.05, shape)
        out[tf_name] = val.astype(np.float32)
    return out


def load_tf_weights(weights: dict, mapping) -> dict[str, torch.Tensor]:
    """{tf_name: array} -> a state_dict of the (unfolded) port generator."""
    sd: dict[str, torch.Tensor] = {}
    slices: dict[str, list] = {}
    for torch_name, tf_name, dst in mapping:
        value = _to_torch_layout(weights[tf_name])
        if dst is None:
            sd[torch_name] = _t(value)
        else:
            slices.setdefault(torch_name, []).append((dst[0], value))
    for torch_name, parts in slices.items():
        sd[torch_name] = _t(np.concatenate([v for _, v in sorted(
            parts, key=lambda p: p[0])], axis=0))
    for name in [k for k in sd if k.endswith(".running_var")]:
        sd[name[:-len("running_var")] + "num_batches_tracked"] = torch.tensor(0)
    return sd
