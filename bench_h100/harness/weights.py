"""Seeded weights made on the device, in the unfolded state-dict names the
program's generator takes, at the shapes of the benchmark's own layout of
the published model (reference/layout.py).

All of a network's numbers come from one normal draw of a `torch.Generator`
on the device, then are scaled by kind: convolution kernels He-scaled for
LeakyReLU 0.3 on their fan-in, small biases, BatchNorm affines near 1 and 0
and running statistics near a unit normal, so the served outputs span
[0, 1] and the shadow gate (dif > 0.1) holds on part of each face.  The
RGB head's bias is lifted by 0.5, as the repository's golden weights are.
"""

from __future__ import annotations

import math

import torch

SLOPE = 0.3
HEAD_GAIN = 0.1
RES_GAIN = 0.25


def _scale(name: str, shape: tuple, z: torch.Tensor,
           transposed: set) -> torch.Tensor:
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "weight" and len(shape) == 4:
        # a stride-2 transposed 3x3 [in, out, 3, 3] sums ~9/4 taps an output
        fan_in = (shape[0] * 9 / 4 if name in transposed
                  else shape[1] * shape[2] * shape[3])
        return z * (math.sqrt(2.0 / (1.0 + SLOPE ** 2)) / math.sqrt(fan_in))
    is_bn = ".bn" in name
    if leaf == "bias" and not is_bn:      # a convolution's bias
        return z * 0.02
    if leaf == "weight":            # a BatchNorm's gain
        return 1.0 + 0.1 * z
    if leaf == "bias":              # a BatchNorm's shift
        return 0.05 * z
    if leaf == "running_mean":
        return 0.05 * z
    if leaf == "running_var":
        return torch.exp(0.2 * z)
    raise ValueError(f"no draw for {name}")


def draw_state_dict(entries: list[tuple[str, tuple]], transposed: set[str],
                    counters: list[str], seed: int,
                    device) -> dict[str, torch.Tensor]:
    """{name: f32 tensor on `device`} for every (name, shape) of `entries`
    (reference/layout.py), drawn from `seed` in one call, and a zero int64
    for each BatchNorm step counter of `counters`."""
    total = sum(math.prod(s) for _, s in entries)
    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    flat = torch.randn(total, generator=gen, device=device)
    out, ofs = {}, 0
    for name, shape in entries:
        n = math.prod(shape)
        out[name] = _scale(name, shape, flat[ofs:ofs + n].view(shape),
                           transposed).contiguous()
        ofs += n
    # the residual branches' last convolutions and the output heads below
    # the He scale, so the activations keep their size through the six
    # residual blocks and the outputs spread over [0, 1]
    for name in out:
        if name.endswith(("conv3.weight", "non_local.w.weight")) \
                and name.startswith("res."):
            out[name] = out[name] * RES_GAIN
    for head in ("head.conv.weight", "clr_conv3.conv.weight"):
        if head in out:
            out[head] = out[head] * HEAD_GAIN
    if "clr_conv3.conv.bias" in out:
        out["clr_conv3.conv.bias"] = out["clr_conv3.conv.bias"] + 0.5
    for name in counters:
        out[name] = torch.zeros((), dtype=torch.int64, device=device)
    return out


def layout_mismatch(template: dict, entries: list[tuple[str, tuple]],
                    counters: list[str]) -> list[str]:
    """How the program's state dict `template` ({name: tensor}, which may
    live on the meta device) departs from the benchmark's layout: a line
    for each name missing on one side or of another shape."""
    ours = {n: tuple(s) for n, s in entries}
    ours.update((n, ()) for n in counters)
    theirs = {n: tuple(t.shape) for n, t in template.items()}
    return ([f"{n}: the program has {theirs[n]}, the published layout "
             f"{ours[n]}" for n in ours if n in theirs
             and theirs[n] != ours[n]]
            + [f"{n}: not in the program" for n in ours if n not in theirs]
            + [f"{n}: not in the published layout" for n in theirs
               if n not in ours])
