"""Shared helpers for heuristic-branch-coverage goldens (port of
`blindshadowremoval_tpu/eval/branch_probes.py`).

The UCB post-processor's magic-number gates (train_test_GSC.py:480-663) are
load-bearing, but only a few fire on any given image — 3 golden images
cannot exercise them all.  The branch goldens therefore use real UCB images
plus *part-mask synthesis*: deterministic rectangle edits to the 7 part
masks (painted at full 256² BEFORE anything resizes them) that steer the
scalar gates into their bands.  Both sides consume the identical tweaked
masks — the reference's own `FSRNet.test_step` when generating the fixture
(tools/make_tf_ref_branch_goldens.py) and this framework's `UCBEvaluator`
in the test (tests/test_branch_goldens.py) — so output equality on a case
where branch B changes the output proves the reference fired B too.

A rectangle edit is (key_index, r0, r1, c0, c1, value): paint
parts[PART_KEYS[key_index]][r0:r1, c0:c1] = value.  Serialized as an int32
[K, 6] array in the fixture npz.

`disable_branch` doubles as a documented map from branch names to the
single PostprocessParams knob that neutralizes each gate.  The port's
tests (tests/test_torch_postprocess.py) steer synthetic cases into every
gate with `apply_rects` and hold each branch's effect to the JAX
package's.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from blindshadowremoval_tpu_torch.eval.postprocess import PostprocessParams

# canonical part-mask order (matches UCBEvaluator.PART_DIRS keys and the
# reference test_step's positional arguments)
PART_KEYS = ("face_hair", "face_no_hair", "mouth", "nose", "eyebrow",
             "eye", "glasses")


def apply_rects(parts: dict, rects: np.ndarray) -> dict:
    """Apply [K,6] rectangle edits to a copy of the part-mask dict."""
    out = {k: np.array(v, copy=True) for k, v in parts.items()}
    for key_idx, r0, r1, c0, c1, value in np.asarray(rects, np.int32):
        out[PART_KEYS[key_idx]][r0:r1, c0:c1] = float(value)
    return out


def disable_branch(params: PostprocessParams,
                   branch: str) -> PostprocessParams:
    """Params with exactly one heuristic branch made a no-op.

    Used for liveness proofs: a case's output differing between the full
    params and the branch-disabled params shows the branch changed the
    output — and since the full-params output equals the reference golden,
    the reference must have taken the same branch."""
    p = params
    if branch == "mustache_suppress":
        return dataclasses.replace(p, mustache_prob=-1e9)
    if branch == "mouth_suppress":
        return dataclasses.replace(p, mouth_prob=-1e9)
    if branch == "hair_threshold":
        return dataclasses.replace(p, hair_threshold=p.base_threshold)
    if branch == "dark_hair":
        return dataclasses.replace(p, dark_hair_threshold=p.hair_threshold)
    if branch == "forehead":
        return dataclasses.replace(p, forehead_min_eyebrow=1e9)
    if branch.startswith("mouth_band_"):
        k = int(branch.rsplit("_", 1)[1])
        bands = tuple(b for i, b in enumerate(p.mouth_frac_bands) if i != k)
        return dataclasses.replace(p, mouth_frac_bands=bands)
    if branch == "eyebrow_edge":
        return dataclasses.replace(p, eyebrow_edge_gate=False)
    if branch == "minfrac_drop":
        return dataclasses.replace(p, min_frac_of_max=0.0)
    if branch == "hair_veto":
        return dataclasses.replace(p, hair_veto_overlap=2.0)
    if branch.startswith("nose_band_"):
        k = int(branch.rsplit("_", 1)[1])
        bands = tuple(b for i, b in enumerate(p.nose_frac_bands) if i != k)
        return dataclasses.replace(p, nose_frac_bands=bands)
    if branch == "nose_veto_short":
        # force the LONG reach instead: output differs iff short genuinely
        # fired (the reach difference moves pixels)
        return dataclasses.replace(p, nose_dark_intensity=-1.0)
    if branch == "nose_veto_long":
        return dataclasses.replace(p, nose_dark_intensity=1e9)
    raise ValueError(f"unknown branch {branch!r}")
