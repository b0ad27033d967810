"""Generator models of the port."""

from __future__ import annotations

import torch

from blindshadowremoval_tpu_torch.config import Config, resolve_device
from blindshadowremoval_tpu_torch.models.folding import fold_batch_norm
from blindshadowremoval_tpu_torch.models.generator import GSCGenerator


def _glorot_init(model: torch.nn.Module, seed: int) -> None:
    """Glorot-uniform kernels and zero biases (the Flax/Keras defaults),
    drawn from a seeded generator."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
                torch.nn.init.xavier_uniform_(mod.weight, generator=gen)
                torch.nn.init.zeros_(mod.bias)


def build_generator(config: Config, state_dict: dict | None = None,
                    device: str | torch.device | None = None,
                    seed: int = 0) -> GSCGenerator:
    """The GSC generator of `config` in eval mode, on `device` (CUDA unless
    the caller passes "cpu"), in the config's compute dtype, with its
    BatchNorms folded when `config.fold_bn` is set.

    `state_dict` holds unfolded weights (`models/weights.py` makes one from
    JAX variables or TF-named arrays); without it the weights are
    Glorot-uniform from `seed`.  Folding runs in float32 before the cast."""
    dev = resolve_device(device)
    model = GSCGenerator(n_res=config.n_res,
                         egress_dtype=config.torch_egress_dtype)
    if state_dict is None:
        _glorot_init(model, seed)
    else:
        model.load_state_dict(state_dict)
    model.eval()
    if config.fold_bn:
        fold_batch_norm(model)
    return model.to(device=dev, dtype=config.torch_compute_dtype)
