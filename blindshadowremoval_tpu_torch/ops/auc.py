"""Pixel ROC-AUC by the rank-sum identity (port of
`blindshadowremoval_tpu/ops/auc.py`).

The reference flattens masks to pixels and calls sklearn's `roc_auc_score`
on the host (train_test_GSC.py:820-832), with two sentinel pixels (one
positive scored 1, one negative scored 0) prepended so both classes are
present.  The identity

    AUC = (sum of positive midranks - P(P+1)/2) / (P N)

equals sklearn's trapezoidal ROC integral exactly.  One sort on the device;
each tie group's midrank is (first + last rank) / 2 from integer counts,
and the positive rank sum accumulates in f64.  A face-gated SFW map holds
one tie group of tens of thousands of exact zeros: the JAX package sums
their f32 ranks with `segment_sum`, and such float scatter-adds land in
another order on every CUDA run; the closed form does not depend on it.
"""

from __future__ import annotations

import torch


def roc_auc(labels: torch.Tensor, scores: torch.Tensor) -> torch.Tensor:
    """Pixel-level AUC, an f64 scalar.  labels: {0, 1}; scores: floats; any
    shapes with the same number of elements."""
    labels = labels.reshape(-1).to(torch.float64)
    scores = scores.reshape(-1).to(torch.float32)
    n = scores.shape[0]
    sorted_scores, order = torch.sort(scores)
    sorted_labels = labels[order]
    new_group = torch.ones(n, dtype=torch.bool, device=scores.device)
    new_group[1:] = sorted_scores[1:] != sorted_scores[:-1]
    group_id = torch.cumsum(new_group.long(), 0) - 1
    count = torch.bincount(group_id, minlength=1)
    before = torch.cumsum(count, 0) - count        # ranks ahead of a group
    # 1-based ranks before+1 .. before+count: their mean
    midrank = (before.double() + (count.double() + 1.0) / 2.0)[group_id]
    pos = sorted_labels.sum()
    neg = n - pos
    rank_sum_pos = (midrank * sorted_labels).sum()
    return (rank_sum_pos - pos * (pos + 1) / 2.0) / (pos * neg).clamp_min(1.0)


def roc_auc_with_sentinels(mask: torch.Tensor,
                           pred: torch.Tensor) -> torch.Tensor:
    """The reference's recipe (train_test_GSC.py:824-832): flatten, prepend
    the sentinel pixels (label 1 score 1, label 0 score 0)."""
    sentinel = torch.tensor([1.0, 0.0], device=pred.device)
    labels = torch.cat([sentinel, mask.reshape(-1).float()])
    scores = torch.cat([sentinel, pred.reshape(-1).float()])
    return roc_auc(labels, scores)
