"""Host-side face crop/align (port of
`blindshadowremoval_tpu/geometry/crop.py:face_crop_and_resize`).

Box convention (utils.py:387-400 in the reference): a square window of
side 2L centred on the landmark extent, shifted up by 0.2L, where L = 1.4 x
half the larger landmark extent.  Landmarks are returned normalized by the
box side (2L).  Only the inference path is ported: the rotation
augmentation waits for the training slice (ROADMAP C5).
"""

from __future__ import annotations

import numpy as np

from blindshadowremoval_tpu_torch.geometry.landmarks import mirror_landmarks
from blindshadowremoval_tpu_torch.utils.native import crop_resize


def face_crop_and_resize(img: np.ndarray, lm: np.ndarray, fsize: int):
    """Crop the face box, resize to `fsize`, normalize landmarks.

    Returns (img, lm_norm, lm_mirror_norm, box); `box` is the crop window
    in original image coordinates (before zero padding).
    """
    img = np.asarray(img)
    # keep the caller's FLOAT landmark dtype: the box corners go through
    # int() truncation, so f32-vs-f64 rounding of the centre/length (e.g.
    # 128.0f vs 127.99999809) shifts the crop window by a whole pixel.
    # Integer landmarks promote to float32.
    lm = np.array(lm, copy=True)
    if not np.issubdtype(lm.dtype, np.floating):
        lm = lm.astype(np.float32)
    cols = img.shape[1]
    lm_mirror = mirror_landmarks(lm, cols)

    cx = (lm[:, 0].min() + lm[:, 0].max()) / 2
    cy = (lm[:, 1].min() + lm[:, 1].max()) / 2
    length = max((lm[:, 0].max() - lm[:, 0].min()) / 2,
                 (lm[:, 1].max() - lm[:, 1].min()) / 2) * 1.4

    box = [int(cx) - int(length), int(cy) - int(length * 1.2),
           int(cx) + int(length),
           int(cy) + int(length) + int(length) - int(length * 1.2)]
    box_m = [cols - box[2], box[1], cols - box[0], box[3]]

    lm[:, 0] -= box[0]
    lm[:, 1] -= box[1]
    lm_mirror[:, 0] -= box_m[0]
    lm_mirror[:, 1] -= box_m[1]

    if (box[3] - box[1]) == (box[2] - box[0]) and (box[3] - box[1]) > 0:
        img = crop_resize(img.astype(np.float32), box, fsize)
    else:
        img = np.zeros((fsize, fsize, img.shape[2]), np.float32)

    # degenerate landmark sets (zero extent) would divide by zero; guard so
    # landmarks stay finite
    side = max(length * 2, 1e-6)
    return (img.astype(np.float32), (lm / side).astype(np.float32),
            (lm_mirror / side).astype(np.float32),
            np.asarray(box, np.float32))
