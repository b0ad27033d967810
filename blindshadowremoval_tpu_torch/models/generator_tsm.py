"""TSM (temporal sharing module) generator for video and multi-view inputs
(port of `blindshadowremoval_tpu/models/generator_tsm.py`).

The GSC generator with a ShareLayer at both bottleneck concats.  The
ShareLayer warps the 32x32 features into canonical face space (the first
three channels of the offset field `reg`), takes the max and the mean over
each group of `frame` consecutive views, broadcasts them back to every view
and warps them out again (the last three channels).  So res0 takes
96 + 192 + 3 = 291 channels and the RGB half 291 + 1 + 582 + 3 = 877; the
NonLocal blocks stay at 257 channels (D=128).  Parameter names are the GSC
generator's, so the weight bridges and the folding serve both.

Only the local mode is ported: the frames of a group lie in one batch.  The
collective mode (frames spread over devices, `axis_name`) waits for the
multi-device port (ROADMAP F1).
"""

from __future__ import annotations

import torch
from torch import nn

from blindshadowremoval_tpu_torch.geometry.warp import batch_map_offsets
from blindshadowremoval_tpu_torch.models.generator import GSCGenerator


class ShareLayer(nn.Module):
    """Cross-frame max+mean pooling in canonical face space
    (generator_tsm.py:28-75), on NCHW features; no parameters."""

    def __init__(self, axis_name: str | None = None):
        super().__init__()
        if axis_name is not None:
            raise NotImplementedError(
                "the collective ShareLayer (frames over devices) is not "
                "ported yet (ROADMAP F1)")

    def forward(self, x: torch.Tensor, reg: torch.Tensor, frame: int,
                share: bool | torch.Tensor = True) -> torch.Tensor:
        """x [G*F, C, h, w], reg [G*F, S, S, 6] -> [G*F, 2C, h, w].  A bool
        `share` picks a branch; a 0-d bool tensor (the train step's random
        gate) selects between both on the device, with no host sync, and
        the gradient flows through the chosen branch only."""
        if isinstance(share, bool):
            return self._shared(x, reg, frame) if share else \
                torch.cat([x, x], dim=1)
        return torch.where(share, self._shared(x, reg, frame),
                           torch.cat([x, x], dim=1))

    @staticmethod
    def _shared(x: torch.Tensor, reg: torch.Tensor, frame: int):
        # the f32 offset field promotes the first warp to f32, so the max,
        # the mean and the second warp run in f32; only the result returns
        # to the compute dtype (generator_tsm.py:64-69)
        x_reg = batch_map_offsets(x.permute(0, 2, 3, 1), reg[..., :3])
        gf, h, w, c = x_reg.shape
        grouped = x_reg.reshape(gf // frame, frame, h, w, c)
        # amax splits the gradient evenly between ties, as jnp.max does
        x_share = torch.cat([grouped.amax(dim=1), grouped.mean(dim=1)], dim=3)
        x_share = x_share[:, None].expand(-1, frame, -1, -1, -1).reshape(
            gf, h, w, 2 * c)
        out = batch_map_offsets(x_share, reg[..., 3:]).to(x.dtype)
        return out.permute(0, 3, 1, 2)


class TSMGenerator(GSCGenerator):
    """GSC generator + two ShareLayer insertions (model_with_TSM.py:261-325).

    forward(inputs, uv, reg, frame=1, share=True): `reg` [B,S,S,6] holds
    the offset fields into (0:3) and out of (3:6) canonical face space;
    the batch is groups of `frame` views of one face."""

    SHARE_WIDTH = 2

    def __init__(self, n_res: int = 6, fold_bn: bool = False,
                 egress_dtype: torch.dtype = torch.float32,
                 dtype: torch.dtype = torch.float32, remat: bool = False,
                 axis_name: str | None = None):
        super().__init__(n_res=n_res, fold_bn=fold_bn,
                         egress_dtype=egress_dtype, dtype=dtype, remat=remat)
        self.info_share = ShareLayer(axis_name)

    def forward(self, inputs: torch.Tensor, uv: torch.Tensor,
                reg: torch.Tensor, frame: int = 1,
                share: bool | torch.Tensor = True):
        return self._run(inputs, uv,
                         lambda x: (self.info_share(x, reg, frame, share),))
