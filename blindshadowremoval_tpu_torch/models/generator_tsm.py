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

In the local mode the frames of a group lie in one batch.  In the
collective mode (`axis_name`, generator_tsm.py:31-60) the frames of every
group are spread over the ranks of the mesh axis `axis_name`: each rank
holds its slice of every group's frames, reduces it, and the max and the
mean are then all-reduced over that axis's process group (parallel/), so
N frames over N ranks cost two all-reduces a ShareLayer.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

from blindshadowremoval_tpu_torch.geometry.warp import batch_map_offsets
from blindshadowremoval_tpu_torch.models.generator import GSCGenerator
from blindshadowremoval_tpu_torch.parallel.distributed import all_max, all_sum
from blindshadowremoval_tpu_torch.parallel.mesh import active_mesh


class ShareLayer(nn.Module):
    """Cross-frame max+mean pooling in canonical face space
    (generator_tsm.py:28-75), on NCHW features; no parameters.

    Local mode (`axis_name=None`): [G*F, C, h, w] is G groups of `frame`
    views, reduced over the views.  Collective mode (`axis_name="frame"`):
    run inside `with mesh:` of a mesh over processes; `frame` is the views
    of a group on this rank, and the max is all-reduced (MAX) and the mean
    of the local means all-reduced (SUM) and divided by the axis size, as
    JAX's pmax and pmean of the local reductions: the same result as all
    frames on one device.  Both reductions carry their gradients across
    the ranks."""

    def __init__(self, axis_name: str | None = None):
        super().__init__()
        self.axis_name = axis_name

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

    def _shared(self, x: torch.Tensor, reg: torch.Tensor, frame: int):
        # the f32 offset field promotes the first warp to f32, so the max,
        # the mean and the second warp run in f32; only the result returns
        # to the compute dtype (generator_tsm.py:64-69)
        x_reg = batch_map_offsets(x.permute(0, 2, 3, 1), reg[..., :3])
        gf, h, w, c = x_reg.shape
        grouped = x_reg.reshape(gf // frame, frame, h, w, c)
        # amax splits the gradient evenly between ties, as jnp.max does
        x_max, x_mean = grouped.amax(dim=1), grouped.mean(dim=1)
        if self.axis_name is not None:
            mesh = active_mesh()
            if mesh is None or mesh.ranks is None:
                raise RuntimeError(
                    f"ShareLayer(axis_name={self.axis_name!r}) reduces over "
                    "a mesh axis: call it inside `with mesh:` of a mesh over "
                    "processes (parallel/distributed.py:global_mesh)")
            group = mesh.group(self.axis_name)
            if group is not None:          # None: one process, no group
                x_max = all_max(x_max, group)
                x_mean = all_sum(x_mean, group) / dist.get_world_size(group)
        x_share = torch.cat([x_max, x_mean], dim=3)
        x_share = x_share[:, None].expand(-1, frame, -1, -1, -1).reshape(
            gf, h, w, 2 * c)
        out = batch_map_offsets(x_share, reg[..., 3:]).to(x.dtype)
        return out.permute(0, 3, 1, 2)


class TSMGenerator(GSCGenerator):
    """GSC generator + two ShareLayer insertions (model_with_TSM.py:261-325).

    forward(inputs, uv, reg, frame=1, share=True): `reg` [B,S,S,6] holds
    the offset fields into (0:3) and out of (3:6) canonical face space;
    the batch is groups of `frame` views of one face (with `axis_name`,
    this rank's `frame` views of each group)."""

    SHARE_WIDTH = 2

    def __init__(self, n_res: int = 6, fold_bn: bool = False,
                 egress_dtype: torch.dtype = torch.float32,
                 dtype: torch.dtype = torch.float32, remat: bool = False,
                 axis_name: str | None = None, int8_head: bool = False,
                 int8_head_scale: float | tuple = 0.0,
                 s2d_convs: bool = False):
        # the int8 head as GSC's, without the split (generator_tsm.py:84-85)
        super().__init__(n_res=n_res, fold_bn=fold_bn,
                         egress_dtype=egress_dtype, dtype=dtype, remat=remat,
                         int8_head=int8_head, int8_head_scale=int8_head_scale,
                         s2d_convs=s2d_convs)
        self.info_share = ShareLayer(axis_name)

    def forward(self, inputs: torch.Tensor, uv: torch.Tensor,
                reg: torch.Tensor, frame: int = 1,
                share: bool | torch.Tensor = True):
        return self._run(inputs, uv,
                         lambda x: (self.info_share(x, reg, frame, share),))
