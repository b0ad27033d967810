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

Randomness comes from an explicit `torch.Generator` on the step's device.
Not ported yet
(ROADMAP C1/C5): the tone-curve darkening wire (`device_darken`), `fit`,
checkpoints, the train parser and the native loader.
"""

from __future__ import annotations

import dataclasses
import sys

import torch

from blindshadowremoval_tpu_torch.config import Config, resolve_device
from blindshadowremoval_tpu_torch.data.synthesis import compose_shadow_image
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
from blindshadowremoval_tpu_torch.train.losses import (
    hinge_loss,
    l1_loss,
    multi_scale_gradient_loss,
    reconstruction_losses,
    style_content_loss_pair,
)

LOSS_NAMES = ("recon_gs", "recon_c", "grad", "gen", "per", "mask",
              "disc_real", "disc_fake")


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


@dataclasses.dataclass(eq=False)
class Trainer:
    """Builds the modules of `config` and runs the fused G+D step on
    `device` (CUDA unless the caller passes "cpu")."""

    config: Config
    vgg_weights: dict | None = None     # a VGG19Features state_dict
    device: object = None

    def __post_init__(self):
        self.device = resolve_device(self.device)

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
    def _saturation_aug(self, gen: torch.Generator, gt, img_dark):
        """Per-pair random saturation (train_test_GSC.py:220-238): one gate
        per pair, independent factors in [0.5, 2) for gt and its dark
        twin."""
        pairs = gt.shape[0] // 2
        dev = gt.device
        keep = torch.rand((pairs,), generator=gen, device=dev) > 0.5
        fg = 0.5 + 1.5 * torch.rand((pairs,), generator=gen, device=dev)
        fd = 0.5 + 1.5 * torch.rand((pairs,), generator=gen, device=dev)

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

    # -------------------------------------------------------------- step
    def train_step(self, state: TrainState, batch: dict,
                   generator: torch.Generator, train: bool = True):
        """One fused G+D step; returns (state, losses, figs).  `batch` keys:
        img_dark, gt [B2,S,S,3], mask [B2,S,S,1], and either uv [B2,S,S,3],
        reg [B2,S,S,6], face [B2,S,S,1] or the device-geometry primitives
        (lm, face_pts, uv_tris, face_tris, reg_tris).  Image planes may
        come as uint16 (/65535) or uint8 (/255) fixed point.  Losses are
        0-d tensors on the device (fetching them is the caller's sync)."""
        cfg = self.config
        batch = {k: dequantize(v.to(self.device)) for k, v in batch.items()}
        if "img_dark" not in batch:
            raise NotImplementedError(
                "a batch without img_dark needs in-step darkening "
                "(derive_darkened_views, the tone curve; ROADMAP C1)")
        gt, img_dark = batch["gt"], batch["img_dark"]
        if train:
            gt, img_dark = self._saturation_aug(generator, gt, img_dark)
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
                                               img_dark, face)
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
        figs = {"img": img, "gt": gt, "pred": rgb.detach(), "gs": gs.detach(),
                "mask_edge": mask_edge}
        return state, losses, figs

