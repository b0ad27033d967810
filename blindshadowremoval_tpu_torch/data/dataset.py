"""Per-view geometry primitives (port of
`blindshadowremoval_tpu/data/dataset.py:_geometry_primitives`).

The rest of the dataset (parsers, prefetch) waits for ROADMAP items B4
and C5.
"""

from __future__ import annotations

import numpy as np

from blindshadowremoval_tpu_torch.geometry.landmarks import forehead_points
from blindshadowremoval_tpu_torch.geometry.triangulation import (
    _with_anchors,
    build_triangulation,
)


def _geometry_primitives(lm: np.ndarray) -> dict:
    """Landmarks + Delaunay topologies instead of rasterized maps: with
    device geometry the serving forward rasterizes UV/offset/face maps on
    the device (`triangulation.device_geometry_maps`), and the host ships
    only these small arrays."""
    lm = np.asarray(lm, np.float32)
    fp = np.concatenate([lm, forehead_points(lm, 0.8)], axis=0)
    return {
        "lm": lm,
        "face_pts": fp.astype(np.float32),
        "uv_tris": build_triangulation(lm).triangles,
        "face_tris": build_triangulation(fp).triangles,
        "reg_tris": build_triangulation(_with_anchors(lm)).triangles,
    }
