"""The GAN train step of the three generator variants (port of
`blindshadowremoval_tpu/train/trainer.py`, the reference's
FSRNet.train_step, train_test_GSC.py:117-358).

One step: dequantize the batch, augment (per-pair saturation jitter, the
shadow compositor, the mirror-consistency swap), run the generator, the
1x/2x/4x discriminators and the frozen VGG-19, assemble

    g_total = recon * 400 + gan + perceptual * 0.005 + grad * 2
    d_total = hinge(real, 1) + hinge(fake, -1), summed over the 3 scales

and update both networks with Adam (eps 1e-7, as Keras), each from its own
loss, both from the pre-step parameters.

Semantics kept from the JAX step, which eager PyTorch does not give by
default:
  * in the generator pass the discriminators run in training mode on the
    batch statistics of the real||fake stack, and the running statistics
    they would move are thrown away; the discriminator pass starts from the
    pre-step statistics and keeps its own;
  * the generator's gradient does not reach the discriminators' `.grad`
    (`torch.autograd.grad` on the generator's parameters), and the
    discriminator pass takes the same forward's output, detached;
  * the real half of the VGG pass runs without autograd;
  * the val pass (`train=False`) feeds the clean image, uses the running
    statistics and updates nothing.

Variants: TSM forwards with frame=1 and a random ShareLayer gate in
training (one draw a step, `share_gate`), always on in the val pass
(train_with_TSM.py:216-221); RGB's single output `con` is the RGB
prediction, its grayscale the `gs` of the losses, the reconstruction loss
is recon_c alone and the mask map is zeros (train_RGB_test.py).

Wires: a batch without `img_dark` is the `device_darken` wire, whose raw
crops the step turns into the tone-curve pair (one draw a mirrored pair,
data/synthesis.py:derive_darkened_views); a batch with `lm` is the
device-geometry wire.  Randomness comes from an explicit `torch.Generator`
on the step's device.

Data parallel (parallel/): called inside `with mesh:` of a mesh over
processes, each rank passes its rows of the batch (split over every rank,
as the JAX step's P(("data", "frame"))) and the same generator state.
Every rank draws the noise of the whole batch and keeps its rows, so the
step sees what one process sees on the whole batch; a rank holds whole
mirrored pairs (the swap and the saturation gate are per pair).  The
BatchNorm moments and the masked losses' denominators reduce over the
ranks (models/blocks.py, train/losses.py); each network's gradients are
averaged in one flat all-reduce before its update (`torch.autograd.grad`
sets `.grad` by hand, so DDP's hooks would never fire), and the returned
losses are the whole batch's, bitwise the same on every rank.
`TrainState.state_dict` / `load_state_dict` give the
whole state as plain tensors (utils/checkpoint.py saves it;
models/weights.py:train_state_from_jax makes one from a JAX state).
"""

from __future__ import annotations

import dataclasses
import sys

import torch
import torch.distributed as dist

from blindshadowremoval_tpu_torch.config import Config, resolve_device
from blindshadowremoval_tpu_torch.data.synthesis import (
    compose_shadow_image,
    derive_darkened_views,
)
from blindshadowremoval_tpu_torch.geometry.triangulation import (
    device_geometry_maps,
)
from blindshadowremoval_tpu_torch.models import _glorot_init, new_generator
from blindshadowremoval_tpu_torch.models.blocks import frozen_stats
from blindshadowremoval_tpu_torch.models.discriminator import (
    MultiScaleDiscriminators,
)
from blindshadowremoval_tpu_torch.models.vgg import (
    VGG19Features,
    init_vgg,
    preprocess,
)
from blindshadowremoval_tpu_torch.ops.filters import find_edge
from blindshadowremoval_tpu_torch.ops.image import (
    adjust_saturation,
    dequantize,
    flip_left_right,
    rgb_to_grayscale,
)
from blindshadowremoval_tpu_torch.parallel.distributed import (
    all_sum,
    mean_gradients,
)
from blindshadowremoval_tpu_torch.parallel.mesh import batch_group
from blindshadowremoval_tpu_torch.train.losses import (
    hinge_loss,
    l1_loss,
    multi_scale_gradient_loss,
    reconstruction_losses,
    style_content_loss_pair,
)

LOSS_NAMES = ("recon_gs", "recon_c", "grad", "gen", "per", "mask",
              "disc_real", "disc_fake")


def _adam_state(module: torch.nn.Module, opt: torch.optim.Adam) -> dict:
    """Adam's state by parameter name: {count, exp_avg, exp_avg_sq}."""
    out = {"count": 0, "exp_avg": {}, "exp_avg_sq": {}}
    for name, p in module.named_parameters():
        st = opt.state.get(p)
        if st:
            out["count"] = int(st["step"])
            out["exp_avg"][name] = st["exp_avg"]
            out["exp_avg_sq"][name] = st["exp_avg_sq"]
    return out


def _load_adam_state(module: torch.nn.Module, opt: torch.optim.Adam,
                     st: dict) -> None:
    opt.state.clear()
    for name, p in module.named_parameters():
        if name in st["exp_avg"]:
            opt.state[p] = {
                "step": torch.tensor(float(st["count"]), dtype=torch.float32),
                "exp_avg": st["exp_avg"][name].to(p.device, p.dtype).clone(),
                "exp_avg_sq": st["exp_avg_sq"][name].to(
                    p.device, p.dtype).clone()}


def _set_lr_count(sched: torch.optim.lr_scheduler.LambdaLR,
                  count: int) -> None:
    """Put a staircase scheduler (and its optimizer's learning rate) at
    `count` updates."""
    sd = sched.state_dict()
    lrs = [base * fn(count) for base, fn in zip(sched.base_lrs,
                                                 sched.lr_lambdas)]
    sd.update(last_epoch=count, _step_count=count + 1, _last_lr=lrs)
    sched.load_state_dict(sd)
    for group, lr in zip(sched.optimizer.param_groups, lrs):
        group["lr"] = lr


@dataclasses.dataclass
class TrainState:
    """Modules and optimizers of a run; `train_step` updates it in place."""

    step: int
    gen: torch.nn.Module                  # the config's generator variant
    disc: MultiScaleDiscriminators
    vgg: VGG19Features                    # frozen
    gen_opt: torch.optim.Adam
    disc_opt: torch.optim.Adam
    gen_sched: torch.optim.lr_scheduler.LambdaLR | None = None
    disc_sched: torch.optim.lr_scheduler.LambdaLR | None = None

    def state_dict(self) -> dict:
        """The whole state as plain tensors (references, as a module's
        state_dict): {step, gen, disc, vgg, gen_opt, disc_opt, lr_count};
        each optimizer's state is keyed by parameter name ({count,
        exp_avg, exp_avg_sq}), and lr_count is the staircase's update
        count, None at a constant learning rate."""
        return {
            "step": int(self.step),
            "gen": self.gen.state_dict(),
            "disc": self.disc.state_dict(),
            "vgg": self.vgg.state_dict(),
            "gen_opt": _adam_state(self.gen, self.gen_opt),
            "disc_opt": _adam_state(self.disc, self.disc_opt),
            "lr_count": (None if self.gen_sched is None
                         else int(self.gen_sched.last_epoch)),
        }

    def load_state_dict(self, sd: dict) -> None:
        """Load a `state_dict()` in place.  A staircase state loads only
        into a staircase config and a constant one only into a constant
        one (as the JAX package's optimizer trees differ);
        `CheckpointManager.restore_eval` reads the generator alone."""
        if (sd["lr_count"] is None) != (self.gen_sched is None):
            raise ValueError(
                "the state's learning-rate schedule differs from the "
                "config's (lr_decay_factor): restore the generator alone "
                "(CheckpointManager.restore_eval), or match the config")
        self.step = int(sd["step"])
        for name in ("gen", "disc", "vgg"):
            getattr(self, name).load_state_dict(sd[name])
        _load_adam_state(self.gen, self.gen_opt, sd["gen_opt"])
        _load_adam_state(self.disc, self.disc_opt, sd["disc_opt"])
        if sd["lr_count"] is not None:
            _set_lr_count(self.gen_sched, sd["lr_count"])
            _set_lr_count(self.disc_sched, sd["lr_count"])


_SHARED_TRAINERS: dict = {}   # (config, VGG weights' id, device) -> Trainer


def init_generator_vars(config: Config, seed: int = 0):
    """(generator module on the CPU, its state_dict) of `config`, the
    weights `Trainer.init_state(seed)` starts the generator from: the
    template of every generator-only consumer (restore, serving, tools)."""
    gen = new_generator(config)
    _glorot_init(gen, seed)
    return gen, gen.state_dict()


@dataclasses.dataclass(eq=False)
class Trainer:
    """Builds the modules of `config` and runs the fused G+D step on
    `device` (CUDA unless the caller passes "cpu")."""

    config: Config
    vgg_weights: dict | None = None     # a VGG19Features state_dict
    device: object = None

    def __post_init__(self):
        self.device = resolve_device(self.device)

    @classmethod
    def shared(cls, config: Config, vgg_weights: dict | None = None,
               device=None) -> "Trainer":
        """The process's Trainer for (config, VGG weights, device): built
        once, then reused.  Explicit `vgg_weights` are keyed by identity;
        the cache entry keeps them alive, so the id is not recycled."""
        dev = resolve_device(device)
        key = (config, id(vgg_weights) if vgg_weights is not None else None,
               str(dev))
        t = _SHARED_TRAINERS.get(key)
        if t is None:
            t = _SHARED_TRAINERS[key] = cls(config, vgg_weights, dev)
        return t

    # ------------------------------------------------------------- state
    def init_state(self, seed: int = 0, gen_state: dict | None = None,
                   disc_state: dict | None = None) -> TrainState:
        """Modules in f32 parameters on the device, and two Adam optimizers
        (lr, eps 1e-7), with a staircase LR decay when
        `config.lr_decay_factor` != 1.  Weights come from the given
        state_dicts, else Glorot-uniform (G, D) and LeCun-normal (VGG,
        without `vgg_weights`) from `seed`."""
        cfg = self.config
        gen = new_generator(cfg)
        disc = MultiScaleDiscriminators(num_layers=cfg.n_layer_d,
                                        dtype=cfg.torch_compute_dtype)
        vgg = VGG19Features(dtype=cfg.torch_vgg_dtype)
        for model, sd, s in ((gen, gen_state, seed), (disc, disc_state,
                                                      seed + 1)):
            if sd is None:
                _glorot_init(model, s)
            else:
                model.load_state_dict(sd)
        if self.vgg_weights is not None:
            vgg.load_state_dict(self.vgg_weights)
        else:
            if cfg.mode == "train":
                print("WARNING: no pretrained VGG-19 weights supplied; the "
                      "perceptual loss uses a RANDOM-init backbone, not the "
                      "reference's ImageNet VGG (models/vgg.py:"
                      "load_weights_npz reads converted weights).",
                      file=sys.stderr, flush=True)
            init_vgg(vgg, seed + 2)
        gen, disc, vgg = (m.to(self.device) for m in (gen, disc, vgg))
        gen_opt = torch.optim.Adam(gen.parameters(), lr=cfg.learning_rate,
                                   eps=1e-7)
        disc_opt = torch.optim.Adam(disc.parameters(), lr=cfg.learning_rate,
                                    eps=1e-7)
        state = TrainState(0, gen, disc, vgg.eval(), gen_opt, disc_opt)
        if cfg.lr_decay_factor != 1.0:
            every = max(1, int(cfg.lr_decay_epochs * cfg.steps_per_epoch))

            def staircase(count: int) -> float:
                return cfg.lr_decay_factor ** (count // every)

            state.gen_sched = torch.optim.lr_scheduler.LambdaLR(gen_opt,
                                                                staircase)
            state.disc_sched = torch.optim.lr_scheduler.LambdaLR(disc_opt,
                                                                 staircase)
        return state

    # ------------------------------------------------------- augmentation
    def _saturation_aug(self, gen: torch.Generator, gt, img_dark,
                        rows: tuple[int, int] | None = None):
        """Per-pair random saturation (train_test_GSC.py:220-238): one gate
        per pair, independent factors in [0.5, 2) for gt and its dark
        twin.  `rows` (global views, first view): drawn for the global
        batch, these pairs keep theirs."""
        total, first = rows or (gt.shape[0], 0)
        mine = slice(first // 2, (first + gt.shape[0]) // 2)

        def draw():
            return torch.rand((total // 2,), generator=gen,
                              device=gt.device)[mine]

        keep = draw() > 0.5
        fg = 0.5 + 1.5 * draw()
        fd = 0.5 + 1.5 * draw()

        def per_view(v):                   # [pairs] -> [2*pairs, 1, 1]
            return v.repeat_interleave(2).reshape(-1, 1, 1)

        k = per_view(keep)[..., None]
        gt = torch.where(k, gt, adjust_saturation(gt, per_view(fg)))
        img_dark = torch.where(k, img_dark,
                               adjust_saturation(img_dark, per_view(fd)))
        return gt, img_dark

    def _mirror_consistency(self, gen: torch.Generator, img):
        """With probability 0.65 (one draw for the whole batch), replace each
        pair by (view0, flip(view0)) (train_test_GSC.py:240-250)."""
        swap = torch.rand((), generator=gen, device=img.device) > 0.35
        left = img[0::2]
        mirrored = torch.stack([left, flip_left_right(left)], dim=1).reshape(
            img.shape)
        return torch.where(swap, mirrored, img)   # no host sync

    def share_gate(self, gen: torch.Generator, train: bool):
        """The TSM ShareLayer gate of one step: a 0-d bool tensor on the
        device, True with probability 0.5 in training (no host sync), and
        True in the val pass."""
        if not train:
            return True
        return torch.rand((), generator=gen, device=self.device) > 0.5

    @staticmethod
    def _rows(views: int) -> tuple[int, int] | None:
        """(global views, this rank's first view) of a rank's `views` under
        a mesh over processes; None on one process."""
        group = batch_group()
        if group is None:
            return None
        n = dist.get_world_size(group)
        if views % 2:
            raise ValueError(
                f"{views} views a rank ({views * n} over {n} ranks) split a "
                "mirrored pair: each rank must hold whole pairs, so a batch "
                f"of {views * n} views runs on at most {views * n // 2} "
                "ranks, with an even number of views each")
        return views * n, dist.get_rank(group) * views

    # -------------------------------------------------------------- step
    def train_step(self, state: TrainState, batch: dict,
                   generator: torch.Generator, train: bool = True):
        """One fused G+D step; returns (state, losses, figs).  `batch` keys:
        img_dark, gt [B2,S,S,3], mask [B2,S,S,1], and either uv [B2,S,S,3],
        reg [B2,S,S,6], face [B2,S,S,1] or the device-geometry primitives
        (lm, face_pts, uv_tris, face_tris, reg_tris).  Without img_dark,
        gt holds the raw crops (the device_darken wire) and the step
        derives the pair.  Image planes may come as uint16 (/65535) or
        uint8 (/255) fixed point.  Losses are 0-d tensors on the device
        (fetching them is the caller's sync)."""
        cfg = self.config
        batch = {k: dequantize(v.to(self.device)) for k, v in batch.items()}
        group = batch_group()
        rows = self._rows(batch["gt"].shape[0])
        # under a mesh, the draws cover the global batch (see the header)
        sharded = {} if rows is None else {"rows": rows}
        if "img_dark" in batch:
            gt, img_dark = batch["gt"], batch["img_dark"]
        else:
            gt, img_dark = derive_darkened_views(generator, batch["gt"],
                                                 **sharded)
        if train:
            gt, img_dark = self._saturation_aug(generator, gt, img_dark,
                                                **sharded)
        if "lm" in batch:
            maps = device_geometry_maps(
                batch["lm"], batch["face_pts"], batch["uv_tris"],
                batch["face_tris"], batch["reg_tris"], cfg.img_size)
            uv, reg, face = maps["uv"], maps["reg"], maps["face"]
            # the device-geometry wire ships the occluder mask ungated
            ext_mask = batch["mask"] * face
        else:
            uv, reg, face = batch["uv"], batch["reg"], batch["face"]
            ext_mask = batch["mask"]
        img, mask_sv, _ = compose_shadow_image(generator, ext_mask, gt,
                                               img_dark, face, **sharded)
        img = self._mirror_consistency(generator, img) if train else gt
        mask_bi = (mask_sv > 0.01).float()
        mask_edge = find_edge(mask_sv)
        gray_gt = rgb_to_grayscale(gt)

        gen, disc, vgg = state.gen, state.disc, state.vgg
        gen.train(train)
        disc.train(train)
        with torch.set_grad_enabled(train):
            # ---------------- generator loss --------------------------
            if cfg.variant == "tsm":
                out = gen(img, uv, reg, frame=1,
                          share=self.share_gate(generator, train))
            else:
                out = gen(img, uv, reg)
            if cfg.variant == "rgb":
                # the single-branch ablation: a direct RGB output
                rgb = out
                gs = rgb_to_grayscale(rgb)
                mask22 = torch.zeros_like(rgb)
            else:
                gs, rgb, mask22, _ = out
            d_in = torch.cat([torch.cat([gt, rgb], 0),
                              torch.cat([mask_sv, mask_sv], 0)], 3)
            with frozen_stats(disc):
                d_outs = disc(d_in)
            recon_gs, recon_c = reconstruction_losses(
                gs, rgb, gt, gray_gt, mask_bi, mask_edge)
            recon = (recon_c if cfg.variant == "rgb"
                     else (recon_gs + recon_c) / 2.0)
            gan = -sum(fake.mean() for _, fake in d_outs)
            with torch.no_grad():
                feats_real = vgg(preprocess(gt))
            feats_fake = vgg(preprocess(rgb))
            per = style_content_loss_pair(feats_real, feats_fake)
            grad_l = multi_scale_gradient_loss(rgb, gt, mask_bi, mask_edge)
            g_total = recon * 400.0 + gan + per * 0.005 + grad_l * 2.0
            gen_params = list(gen.parameters())
            g_grads = (torch.autograd.grad(g_total, gen_params) if train
                       else None)

            # ---------------- discriminator loss ----------------------
            fake = rgb.detach()
            d_in = torch.cat([torch.cat([gt, fake], 0),
                              torch.cat([mask_sv, mask_sv], 0)], 3)
            d_outs = disc(d_in)
            d_real = sum(hinge_loss(r, 1.0) for r, _ in d_outs)
            d_fake = sum(hinge_loss(f, -1.0) for _, f in d_outs)
            if train:
                disc_params = list(disc.parameters())
                d_grads = torch.autograd.grad(d_real + d_fake, disc_params)

        if train:
            if group is not None:
                g_grads = mean_gradients(g_grads, group)
                d_grads = mean_gradients(d_grads, group)
            for params, grads, opt, sched in (
                    (gen_params, g_grads, state.gen_opt, state.gen_sched),
                    (disc_params, d_grads, state.disc_opt, state.disc_sched)):
                for p, g in zip(params, grads):
                    p.grad = g
                opt.step()
                opt.zero_grad(set_to_none=True)
                if sched is not None:
                    sched.step()
            state.step += 1

        losses = {"recon_gs": recon_gs, "recon_c": recon_c, "grad": grad_l,
                  "gen": gan, "per": per, "mask": l1_loss(mask22, mask_bi),
                  "disc_real": d_real, "disc_fake": d_fake}
        losses = {k: v.detach() for k, v in losses.items()}
        if group is not None:
            # each rank's share has the ranks' mean as the batch's value
            mean = all_sum(torch.stack([losses[k].float()
                                        for k in LOSS_NAMES]),
                           group) / dist.get_world_size(group)
            losses = dict(zip(LOSS_NAMES, mean.unbind()))
        figs = {"img": img, "gt": gt, "pred": rgb.detach(), "gs": gs.detach(),
                "mask_edge": mask_edge}
        return state, losses, figs

