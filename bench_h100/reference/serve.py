"""The plain reference of a served answer: from a raw photo and its 68
landmarks to the deshadowed face and its shadow map, as the published
method computes them, in f32 (or in the control's lower precision).

crop and align -> UV, offset and face maps -> generator -> the RGB output
clipped to [0, 1] (`pred`) and the shadow map gated by the face region
(`mask_pred`).
"""

from __future__ import annotations

import numpy as np
import torch

from bench_h100.reference.generator import (
    GATE,
    LOWER,
    Net,
    generator,
    identity,
)
from bench_h100.reference.geometry import face_crop, geometry_maps


def net(state_dict: dict, device, precision: dict | None) -> Net:
    """The reference network on `device`: f32, or with `precision` (the
    configuration's {"compute": dtype, "egress": dtype}) the control,
    each rounded to the next precision below."""
    sd = {k: v.to(device) for k, v in state_dict.items()
          if v.is_floating_point()}
    if precision is None:
        return Net(sd)
    return Net(sd, LOWER[precision["compute"]], LOWER[precision["egress"]])


@torch.no_grad()
def answers(photos: list, lms: list, state_dict: dict, img_size: int,
            n_res: int, variant: str, device, control: dict | None = None,
            gates: tuple = (GATE,),
            block: int = 16) -> tuple[np.ndarray, np.ndarray]:
    """(pred [G,N,S,S,3], mask_pred [G,N,S,S,1]) as f32 numpy of N served
    requests, with the shadow gate's threshold at each of `gates`, `block`
    requests at a time on `device`; `control` (the configuration's
    precisions) computes them a precision lower (`net`)."""
    ref = net(state_dict, device, control)
    preds, masks = [], []
    for s in range(0, len(photos), block):
        crops, norm = zip(*(face_crop(p, lm, img_size) for p, lm in
                            zip(photos[s:s + block], lms[s:s + block])))
        maps = geometry_maps(list(norm), img_size, device)
        img = torch.from_numpy(np.stack(crops)).to(device)
        pred, mask = [], []
        for g in gates:
            _, rgb, _, dif = generator(
                ref, img, maps["uv"], n_res,
                maps["reg"] if variant == "tsm" else None, gate=g)
            pred.append(rgb.clamp(0.0, 1.0).cpu().numpy())
            mask.append((dif * maps["face"]).cpu().numpy())
        preds.append(np.stack(pred))
        masks.append(np.stack(mask))
    return np.concatenate(preds, 1), np.concatenate(masks, 1)


@torch.no_grad()
def video_answers(clips: list, state_dict: dict, n_res: int, device,
                  control: dict | None = None,
                  gates: tuple = (GATE,)) -> list:
    """[(rgb [G,F,S,S,3], mask_pred [G,F,S,S,1], face [F,S,S,1])] of clips
    {"img": [F,S,S,3] uint16 (/65535), "lm": [F,68,2] normalized} of
    aligned faces, each clip one group of the TSM generator's ShareLayer,
    with the shadow gate's threshold at each of `gates`; mask_pred is the
    shadow map gated by the face region.  With `control` every output is a
    precision lower (the face map, f32 in the configuration, in bf16)."""
    ref = net(state_dict, device, control)
    face_out = LOWER["float32"] if control is not None else identity
    out = []
    for clip in clips:
        img = torch.from_numpy(clip["img"].astype(np.float32) / 65535.0)
        size = img.shape[1]
        maps = geometry_maps(list(clip["lm"]), size, device)
        face = face_out(maps["face"])
        rgbs, masks = [], []
        for g in gates:
            _, rgb, _, dif = generator(ref, img.to(device), maps["uv"], n_res,
                                       maps["reg"], len(img), gate=g)
            rgbs.append(rgb.cpu().numpy())
            masks.append((dif * face).cpu().numpy())
        out.append((np.stack(rgbs), np.stack(masks), face.cpu().numpy()))
    return out
