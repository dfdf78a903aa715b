"""Batched k-nearest-neighbour search over padded point sets.

Port of the reference's `match/neighbors.py` (its KD-tree replacement): an
all-pairs squared-distance matrix as one matmul (||a||^2 + ||b||^2 -
2 a.b) followed by a top-k that breaks ties by index, like
`jax.lax.top_k`. Every function takes leading batch dimensions.
"""

from __future__ import annotations

import torch

from spim_registration_tpu_torch.ops.topk import top_k

_INF = 3.4e38


def pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., N, 3) x (..., M, 3) -> (..., N, M) squared distances."""
    a2 = (a * a).sum(dim=-1)[..., :, None]
    b2 = (b * b).sum(dim=-1)[..., None, :]
    ab = a @ b.mT
    return torch.clamp(a2 + b2 - 2.0 * ab, min=0.0)


def _nearest(d2: torch.Tensor, k: int):
    neg, idx = top_k(-d2, k)
    return idx, torch.sqrt(torch.clamp(-neg, min=0.0))


def knn(points: torch.Tensor, valid: torch.Tensor, k: int,
        exclude_self: bool = True):
    """k nearest valid neighbours of each point within the same set.

    Returns (idx (..., N, k) int64, dist (..., N, k)). Invalid query rows
    get arbitrary (masked-at-use) results; invalid neighbours are never
    chosen while enough valid points exist."""
    d2 = pairwise_sqdist(points, points)
    d2 = torch.where(valid[..., None, :], d2, torch.full_like(d2, _INF))
    if exclude_self:
        n = points.shape[-2]
        d2 = d2 + torch.eye(n, dtype=d2.dtype, device=d2.device) * _INF
    return _nearest(d2, k)


def cross_knn(a: torch.Tensor, a_valid: torch.Tensor, b: torch.Tensor,
              b_valid: torch.Tensor, k: int):
    """k nearest valid points of set b for each point of set a."""
    d2 = pairwise_sqdist(a, b)
    d2 = torch.where(b_valid[..., None, :], d2, torch.full_like(d2, _INF))
    return _nearest(d2, k)
