"""Models of the port: the GSC, TSM and RGB generators, the discriminators
and VGG."""

from __future__ import annotations

import torch

from blindshadowremoval_tpu_torch.config import Config, resolve_device
from blindshadowremoval_tpu_torch.models.folding import fold_batch_norm
from blindshadowremoval_tpu_torch.models.generator import GSCGenerator
from blindshadowremoval_tpu_torch.models.generator_rgb import RGBGenerator
from blindshadowremoval_tpu_torch.models.generator_tsm import TSMGenerator

GENERATORS = {"gsc": GSCGenerator, "tsm": TSMGenerator, "rgb": RGBGenerator}


def _glorot_init(model: torch.nn.Module, seed: int) -> None:
    """Glorot-uniform kernels and zero biases (the Flax/Keras defaults),
    drawn from a seeded generator."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
                torch.nn.init.xavier_uniform_(mod.weight, generator=gen)
                torch.nn.init.zeros_(mod.bias)


def new_generator(config: Config) -> torch.nn.Module:
    """An untrained generator of `config.variant` (f32 parameters, on the
    CPU), computing in the config's compute dtype, with its space-to-depth
    convs when `s2d_convs` is set; gsc and tsm with the config's int8 head
    (trainer.py:build_generator in the JAX package)."""
    kw = dict(n_res=config.n_res, egress_dtype=config.torch_egress_dtype,
              dtype=config.torch_compute_dtype, remat=config.remat,
              s2d_convs=config.s2d_convs)
    if config.variant != "rgb":
        kw.update(int8_head=config.int8_head,
                  int8_head_scale=config.int8_head_scale)
    if config.variant == "gsc":
        kw.update(int8_head_split=config.int8_head_split)
    return GENERATORS[config.variant](**kw)


def build_generator(config: Config, state_dict: dict | None = None,
                    device: str | torch.device | None = None,
                    seed: int = 0) -> torch.nn.Module:
    """The generator of `config.variant` in eval mode, on `device` (CUDA unless
    the caller passes "cpu"), computing in the config's compute dtype, with
    its BatchNorms folded when `config.fold_bn` is set.

    `state_dict` holds unfolded weights (`models/weights.py` makes one from
    JAX variables or TF-named arrays); without it the weights are
    Glorot-uniform from `seed`.  Parameters and BatchNorm statistics stay
    f32, as Flax keeps them; a folded model has no BatchNorm left, so its
    weights are stored in the compute dtype (folded in f32 first), which
    spares every serving call the casts (but for an int8 head's, which
    quantizes them from f32)."""
    dev = resolve_device(device)
    model = new_generator(config)
    if state_dict is None:
        _glorot_init(model, seed)
    else:
        model.load_state_dict(state_dict)
    model.eval()
    if config.fold_bn:
        fold_batch_norm(model)
        int8 = config.int8_head or config.int8_head_split
        for name, child in model.named_children():
            # an int8 head quantizes its f32 weights, folded or not
            child.to(torch.float32 if int8 and name == "head"
                     else config.torch_compute_dtype)
    return model.to(dev)
