"""Chamfer distance between two point sets, the point-cloud generation loss.

Counterpart of mla_tpu/ops/chamfer.py: one pairwise distance matrix and two
min-reductions, differentiable through autograd.
"""

from __future__ import annotations

import torch

from mla_tpu_torch.ops.pointops import square_distance


def chamfer_distance_l2(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """pred [B, N, 3], gt [B, M, 3] -> scalar: the batch mean of (mean
    nearest distance pred -> gt + mean nearest distance gt -> pred), the
    distances euclidean, sqrt(max(d2, 0) + 1e-12)."""
    d = torch.sqrt(square_distance(pred, gt).clamp_min(0.0) + 1e-12)
    return (d.amin(dim=2).mean(dim=1) + d.amin(dim=1).mean(dim=1)).mean()


def chamfer_distance_sq(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """The same with squared distances."""
    d2 = square_distance(pred, gt).clamp_min(0.0)
    return (d2.amin(dim=2).mean(dim=1) + d2.amin(dim=1).mean(dim=1)).mean()
