"""Connected components by iterative label propagation (port of
`blindshadowremoval_tpu/ops/components.py`).

The reference keeps shadow blobs >= 0.45x the largest with OpenCV's
`connectedComponentsWithStats` on the host (train_test_GSC.py:590).  Here
the labelling runs on the tensor's device: every foreground pixel starts
with its own linear index as label, and each iteration takes the minimum
over the 4- (or 8-) neighbourhood, then jumps each label to the label of
the pixel it points to (pointer jumping, which contracts long chains
geometrically), until nothing changes.  The JAX package's `lax.while_loop`
becomes a Python loop of tensor ops whose convergence test reads one bool
an iteration.  Labels equal the JAX package's: the minimum linear index in
the component, -1 for background.

`connected_components_host` is a `scipy.ndimage.label` oracle.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def label_components_batched(masks: torch.Tensor, max_iters: int = 4096,
                             connectivity: int = 4
                             ) -> tuple[torch.Tensor, int]:
    """Label the components of each of k binary masks [k, H, W].

    Returns (labels [k, H, W] int64, iterations): labels are per image (the
    minimum linear index within the image, -1 for background), and the loop
    runs until every image has converged, as the JAX package's vmap of its
    while_loop does; a converged image stays as it is."""
    if connectivity not in (4, 8):
        raise ValueError(f"connectivity must be 4 or 8, got {connectivity}")
    k, h, w = masks.shape
    fg = masks.bool()
    big = h * w
    idx = torch.arange(big, device=masks.device).reshape(1, h, w)
    labels = torch.where(fg, idx, big)
    it = 0
    while it < max_iters:
        padded = F.pad(labels, (1, 1, 1, 1), value=big)
        m = labels
        shifts = [(0, 1), (2, 1), (1, 0), (1, 2)]
        if connectivity == 8:
            shifts += [(0, 0), (0, 2), (2, 0), (2, 2)]
        for dy, dx in shifts:
            m = torch.minimum(m, padded[:, dy:dy + h, dx:dx + w])
        new = torch.where(fg, m, big).reshape(k, big)
        # pointer jumping; one `big` entry appended makes the gather total
        ext = torch.cat([new, new.new_full((k, 1), big)], dim=1)
        jumped = torch.minimum(new, ext.gather(1, new))
        jumped = torch.where(fg, jumped.reshape(k, h, w), big)
        it += 1
        changed = bool((jumped != labels).any())
        labels = jumped
        if not changed:
            break
    return torch.where(fg, labels, -1), it


def label_components(mask: torch.Tensor, max_iters: int = 4096,
                     connectivity: int = 4) -> torch.Tensor:
    """Label the 4- (or 8-) connected components of a binary mask [H, W].
    Returns [H, W] int64: -1 for background, else the minimum linear index
    in the component (stable and order-free, but not dense)."""
    return label_components_batched(mask[None], max_iters, connectivity)[0][0]


def component_sizes(labels: torch.Tensor) -> torch.Tensor:
    """Pixel count per component id of labels [..., H, W] -> [..., H*W]:
    entry i is the size of the component whose id is i (0 where there is
    none).  Integer counts, so the sum order cannot move them."""
    flat = labels.reshape(-1, labels.shape[-2] * labels.shape[-1])
    fg = flat >= 0
    sizes = torch.zeros_like(flat).scatter_add_(
        1, torch.where(fg, flat, 0), fg.long())
    return sizes.reshape(labels.shape[:-2] + (flat.shape[1],))


def filter_components(mask: torch.Tensor, labels: torch.Tensor,
                      min_frac_of_max: float,
                      veto_region: torch.Tensor | None = None,
                      veto_max_overlap: float | None = None) -> torch.Tensor:
    """Keep components >= min_frac_of_max x the largest size, optionally
    dropping those that overlap `veto_region` by veto_max_overlap or more
    (train_test_GSC.py:593-611: 0.45x the largest, hair overlap < 0.8).

    labels [..., H, W] from `label_components`; each image of the leading
    axes is filtered on its own.  Returns f32 [..., H, W] in {0, 1}."""
    del mask   # the labels carry it; kept for the JAX package's signature
    shape = labels.shape
    flat = labels.reshape(-1, shape[-2] * shape[-1])
    fg = flat >= 0
    safe = torch.where(fg, flat, 0)
    sizes = component_sizes(labels).reshape(flat.shape)
    max_size = sizes.amax(dim=1, keepdim=True)
    px_size = torch.where(fg, sizes.gather(1, safe), 0)
    # f32 products and comparisons, as in the JAX package
    frac = torch.tensor(min_frac_of_max, dtype=torch.float32,
                        device=labels.device)
    keep = px_size.float() >= frac * max_size.float()
    if veto_region is not None:
        veto = (veto_region.reshape(flat.shape) > 0) & fg
        overlap = torch.zeros_like(flat).scatter_add_(1, safe, veto.long())
        share = overlap.gather(1, safe).float() / px_size.clamp_min(1).float()
        keep = keep & (share < torch.tensor(veto_max_overlap,
                                            dtype=torch.float32,
                                            device=labels.device))
    return (keep & fg).float().reshape(shape)


def connected_components_host(mask: np.ndarray, connectivity: int = 4):
    """scipy oracle: (num_labels incl. background, labels [H, W] with 0 for
    background, sizes [num_labels]), as OpenCV's
    connectedComponentsWithStats reports them."""
    from scipy import ndimage

    structure = (np.ones((3, 3), bool) if connectivity == 8
                 else ndimage.generate_binary_structure(2, 1))
    lab, n = ndimage.label(np.asarray(mask) > 0, structure=structure)
    return n + 1, lab, np.bincount(lab.reshape(-1), minlength=n + 1)
