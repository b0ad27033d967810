"""Configuration of the ported paths: serving, training (the train data
pipeline, the GAN train step, `fit`) and evaluation (UCB, SFW, SFW video,
in-the-wild) of the three generator variants (gsc, tsm, rgb).

Port of `blindshadowremoval_tpu/config.py`, with every field of it.  The
mesh fields are accepted as the JAX package accepts them and, as there,
read by no code: a mesh takes its shape from the caller
(`parallel/mesh.py:make_mesh(cfg.mesh_shape, cfg.mesh_axis_names)`, or
`distributed.py:global_mesh`), which checks it against the devices.  The
option whose code path is not ported (the space-to-depth convs, ROADMAP
F4) raises `NotImplementedError` naming the item, so a caller never
silently gets another configuration than it asked for.
"""

from __future__ import annotations

import dataclasses

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}

_PRESETS = {
    # in-the-wild single-image inference
    "in_the_wild": dict(mode="in_the_wild"),
    # UCB eval with part-mask post-processing
    "ucb": dict(mode="ucb", part_mask_root="."),
    # SFW shadow-segmentation eval and SFW per-frame video removal, on the
    # TSM variant, as in the JAX package
    "sfw": dict(mode="sfw", variant="tsm"),
    "sfw_video": dict(mode="sfw_video", variant="tsm"),
    # GAN training
    "train": dict(mode="train"),
}

VARIANTS = ("gsc", "tsm", "rgb")


@dataclasses.dataclass(frozen=True)
class Config:
    """Hyper-parameters of the ported paths (defaults as in the JAX
    package's `Config`; `compact_output`, which the JAX package keeps on
    `ShadowRemovalService`, has the service's default)."""

    img_size: int = 256                # IMG_SIZE (train_test_GSC.py:31)
    map_size: int = 32                 # MAP_SIZE, the bottleneck's side: the
                                       # generators derive it (img_size / 8);
                                       # another value than that or the
                                       # default is refused
    n_res: int = 6                     # ResBottleneck count in the generator
    variant: str = "gsc"               # 'gsc' | 'tsm' | 'rgb'
    compute_dtype: str = "bfloat16"    # activations / conv dtype
    fold_bn: bool = False              # fold eval BatchNorm into the convs
    egress_dtype: str = "float32"      # dtype of the generator's outputs
    mode: str = "in_the_wild"          # preset name of the run
    # data (data/dataset.py)
    data_dirs: tuple = ()              # train identity-folder globs
    data_dirs_val: tuple = ()          # val identity-folder globs
    shadow_mask_dir: str = ""          # occluder PNG library (ShadowMaker);
                                       # empty: procedural Perlin masks
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
    max_epoch: int = 300
    # logging (train/loop.py, utils/logging.py)
    img_log_freq: int = 100            # figure grid every n logged steps
    txt_log_freq: int = 1000           # log.txt line every n logged steps
    log_every_steps: int = 1           # loss-fetch cadence (each fetch is a
                                       # host sync)
    fig_size: int = 128                # figure-grid tile size
    n_layer_d: int = 4                 # discriminator depth
    vgg_dtype: str = "bfloat16"        # perceptual-backbone compute dtype
    remat: bool = False                # recompute ResBottlenecks in backward
    # wires; the service takes device_geometry as a field of its own
    # (default on), as in the JAX package
    device_geometry: bool = False      # the test datasets ship landmarks and
                                       # topologies, and the evaluators
                                       # rasterize UV/offset/face maps on
                                       # the device (the train step branches
                                       # on the batch: "lm" rasterizes)
    compact_output: bool = False       # serving: uint8 pred + f16 mask_pred
    compact_ingress: bool = False      # [0,1] image planes on the wire as
                                       # uint16 fixed point (1/65535),
                                       # clamped to [0,1] first; the step
                                       # dequantizes on the device
    ingress_u8: bool = False           # with compact_ingress: uint8 (1/255),
                                       # the 8-bit source's own step
    device_darken: bool = False        # the train step derives the tone-
                                       # curve pair (gt, img_dark) on the
                                       # device (derive_darkened_views) and
                                       # the parser ships the raw crop; the
                                       # derived pair is clamped to [0,1],
                                       # as the compact wire clamps the
                                       # host pair
    # the int8 output head (ops/quant.py), gsc and tsm only
    int8_head: bool = False            # the 7x7 head conv on int8 codes
    int8_head_scale: object = 0.0      # its activation bound(s): 0.0 = auto,
                                       # per channel from the checkpoint's
                                       # BatchNorm (ops/calibration.py, at
                                       # every restore); a tuple = per input
                                       # channel; > 0 = one scalar; < 0 =
                                       # the dynamic per-sample max
    int8_head_split: bool = False      # gsc: int8 for the offset channel
                                       # `con` only, the tanh gain exact
    # devices: inert, as in JAX; pass them to parallel/mesh.py:make_mesh
    mesh_shape: tuple = (1, 1)         # (data, frame) mesh axes
    mesh_axis_names: tuple = ("data", "frame")
    param_dtype: str = "float32"       # the parameters' dtype; the only one
                                       # either package makes them in
    # not ported: must stay at its default
    s2d_convs: bool = False            # ROADMAP F4

    def __post_init__(self):
        if self.variant not in VARIANTS:
            raise ValueError(f"unknown variant {self.variant!r}; choose "
                             f"from {VARIANTS}")
        # sequences as the JAX package takes them, kept hashable
        object.__setattr__(self, "mesh_shape", tuple(self.mesh_shape))
        object.__setattr__(self, "mesh_axis_names",
                           tuple(self.mesh_axis_names))
        if self.param_dtype != "float32":
            raise NotImplementedError(
                f"param_dtype={self.param_dtype!r}: parameters are float32 "
                "(the JAX package reads this field nowhere either)")
        # the default stands at any img_size, as the JAX package never
        # reads it; another value must be the bottleneck the generators make
        if self.map_size not in (32, self.img_size // 8):
            raise ValueError(f"map_size={self.map_size}: the bottleneck of "
                             f"img_size {self.img_size} is "
                             f"{self.img_size // 8}")
        if self.variant == "rgb" and (self.int8_head or self.int8_head_split):
            raise ValueError("the rgb generator has no int8 head (nor has "
                             "the JAX package's)")
        if self.variant == "tsm" and self.int8_head_split:
            raise ValueError("int8_head_split is a gsc option (the JAX "
                             "package's TSM generator has no split head)")
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
