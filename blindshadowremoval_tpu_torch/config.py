"""Configuration of the ported paths: GSC serving, the GSC GAN train step
and GSC evaluation (UCB, SFW, SFW video, in-the-wild).

Port of `blindshadowremoval_tpu/config.py`, cut to the fields those paths
read.  Options whose code paths are not ported yet raise
`NotImplementedError` naming the ROADMAP.md item that ports them, so a
caller never silently gets another configuration than it asked for.
"""

from __future__ import annotations

import dataclasses

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}

_PRESETS = {
    # in-the-wild single-image inference, the serving path
    "in_the_wild": dict(mode="in_the_wild"),
    # UCB eval with part-mask post-processing; the evaluation presets ship
    # host-rasterized maps, as the JAX package's evaluators do by default
    "ucb": dict(mode="ucb", part_mask_root=".", device_geometry=False),
    # SFW shadow-segmentation eval and SFW per-frame video removal.  Both
    # default to the TSM variant, as in the JAX package, so they raise
    # (ROADMAP D1) unless the caller asks for variant="gsc"
    "sfw": dict(mode="sfw", variant="tsm", device_geometry=False),
    "sfw_video": dict(mode="sfw_video", variant="tsm",
                      device_geometry=False),
    # GAN training; the train pipeline ships host-rasterized maps unless
    # asked otherwise, as in the JAX package
    "train": dict(mode="train", device_geometry=False),
}


@dataclasses.dataclass(frozen=True)
class Config:
    """Hyper-parameters of the ported paths (defaults as in the JAX
    package's `Config`, except the serving wires marked below, which the
    JAX package keeps on `ShadowRemovalService` with these same defaults)."""

    img_size: int = 256                # IMG_SIZE (train_test_GSC.py:31)
    n_res: int = 6                     # ResBottleneck count in the generator
    variant: str = "gsc"               # only 'gsc' is ported
    compute_dtype: str = "bfloat16"    # activations / conv dtype
    fold_bn: bool = False              # fold eval BatchNorm into the convs
    egress_dtype: str = "float32"      # dtype of the generator's outputs
    mode: str = "in_the_wild"          # preset name of the run
    # evaluation (eval/evaluators.py, data/dataset.py)
    eval_views: int = 10               # views per UCB / in-the-wild sample:
                                       # the anchor + eval_views-1 random
                                       # same-folder references
    data_dirs_test: tuple = ("sample_imgs/*",)   # globs of sample folders
    part_mask_root: str = ""           # root of the UCB part-mask dirs
    checkpoint_dir: str = "./checkpoints"        # result strips go to
                                                 # <checkpoint_dir>/test/
    # training (train/trainer.py)
    batch_size: int = 1                # samples per step, 2 mirrored views each
    learning_rate: float = 1e-4        # Adam, both networks
    lr_decay_factor: float = 1.0       # staircase decay; 1.0 = constant
    lr_decay_epochs: float = 10.0      # epochs between decay steps
    steps_per_epoch: int = 2000
    n_layer_d: int = 4                 # discriminator depth
    vgg_dtype: str = "bfloat16"        # perceptual-backbone compute dtype
    remat: bool = False                # recompute ResBottlenecks in backward
    # serving wires (eval/serving.py); device_geometry also selects the
    # train step's geometry branch (a batch with "lm" rasterizes in-step)
    device_geometry: bool = True       # rasterize UV/offset/face maps on
                                       # the device from landmarks
    compact_output: bool = False       # uint8 pred + f16 mask_pred egress
    compact_ingress: bool = False      # uint16 fixed-point image ingress
    # not ported: must stay at their defaults
    device_darken: bool = False        # ROADMAP C1 (the tone curve)
    ingress_u8: bool = False           # ROADMAP C5 (the train loop's uint8
                                       # wire; the step itself decodes a
                                       # batch by its dtype)
    int8_head: bool = False            # ROADMAP F4
    s2d_convs: bool = False            # ROADMAP F4

    def __post_init__(self):
        if self.variant != "gsc":
            item = {"tsm": "D1", "rgb": "D2"}.get(self.variant)
            if item is None:
                raise ValueError(f"unknown variant {self.variant!r}")
            raise NotImplementedError(
                f"variant {self.variant!r} is not ported yet (ROADMAP {item})")
        if self.device_darken:
            raise NotImplementedError(
                "device_darken is not ported: it needs the tone curve "
                "(ops/tonecurve.py, derive_darkened_views; ROADMAP C1)")
        if self.ingress_u8:
            raise NotImplementedError(
                "ingress_u8 is not ported: the train loop that ships the "
                "uint8 wire waits (ROADMAP C5)")
        if self.int8_head:
            raise NotImplementedError("int8_head is not ported (ROADMAP F4)")
        if self.s2d_convs:
            raise NotImplementedError("s2d_convs is not ported (ROADMAP F4)")
        for name in ("compute_dtype", "egress_dtype", "vgg_dtype"):
            if getattr(self, name) not in _DTYPES:
                raise ValueError(f"{name}={getattr(self, name)!r}; choose "
                                 f"from {sorted(_DTYPES)}")

    @property
    def torch_compute_dtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]

    @property
    def torch_egress_dtype(self) -> torch.dtype:
        return _DTYPES[self.egress_dtype]

    @property
    def torch_vgg_dtype(self) -> torch.dtype:
        return _DTYPES[self.vgg_dtype]


def get_config(preset: str = "in_the_wild", **overrides) -> Config:
    """Build a config from a named preset plus keyword overrides."""
    if preset not in _PRESETS:
        raise ValueError(f"unknown preset {preset!r}")
    return Config(**{**_PRESETS[preset], **overrides})


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU.  Raises when CUDA is asked for (or defaulted to) and absent —
    the port never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
