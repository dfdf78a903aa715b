"""Iterative Closest Point refinement for nearly-aligned views.

Port of the reference's `match/icp.py` (`icp/IterativeClosestPointPairwise`
and its parameters: max distance ~5 px, at most ~100 iterations):
repeatedly assign each point of A to its nearest neighbour in B within
`max_distance`, fit the model to the assignments and transform, until the
mean residual stops improving.

The assignment is the batched cross kNN (one distance matmul); the
reference's device `while_loop` is a Python loop on one synced flag per
iteration.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from spim_registration_tpu_torch.match.neighbors import cross_knn
from spim_registration_tpu_torch.models.affine import apply_affine, fit_model
from spim_registration_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ICPParameters:
    model: str = "affine"
    max_distance: float = 5.0
    max_iterations: int = 100
    min_delta: float = 1e-4   # stop when mean error improves less than this


def _icp(pa, va, pb, vb, A, params: ICPParameters):
    def assign(cur):
        idx, dist = cross_knn(apply_affine(cur, pa), va, pb, vb, 1)
        idx, dist = idx[:, 0], dist[:, 0]
        return idx, va & (dist <= params.max_distance)

    it, err = 0, float("inf")
    while it < params.max_iterations:
        idx, ok = assign(A)
        w = ok.to(pa.dtype)
        A = fit_model(params.model, pa, pb[idx], w)
        d = torch.linalg.norm(apply_affine(A, pa) - pb[idx], dim=1)
        new = (d * w).sum() / torch.clamp(w.sum(), min=1.0)
        done = bool(torch.abs(err - new) < params.min_delta) \
            if np.isfinite(err) else False
        err = float(new)
        it += 1
        if done:
            break
    idx, ok = assign(A)
    return A, idx, ok, err, it


def icp_refine(points_a: np.ndarray, points_b: np.ndarray,
               initial_model: np.ndarray | None = None,
               params: ICPParameters = ICPParameters(),
               max_points: int = 1024, device=None):
    """Refine the A->B transform by ICP; A is assumed roughly aligned.

    Returns (model (3,4), matches (K,2) index pairs, mean_error, iters).
    `device`: default CUDA; "cpu" runs on the host."""
    dev = resolve_device(device)
    n = max_points
    pa = np.zeros((n, 3), np.float32)
    pb = np.zeros((n, 3), np.float32)
    va = np.zeros(n, bool)
    vb = np.zeros(n, bool)
    ma, mb = min(len(points_a), n), min(len(points_b), n)
    pa[:ma], va[:ma] = points_a[:ma], True
    pb[:mb], vb[:mb] = points_b[:mb], True
    init = (np.asarray(initial_model, np.float32)
            if initial_model is not None
            else np.concatenate([np.eye(3), np.zeros((3, 1))],
                                axis=1).astype(np.float32))
    A, idx, ok, err, it = _icp(
        *(torch.from_numpy(x).to(dev) for x in (pa, va, pb, vb, init)),
        params)
    idx, ok = idx.cpu().numpy(), ok.cpu().numpy()
    ia = np.nonzero(ok)[0]
    matches = np.stack([ia, idx[ia]], axis=1)
    return A.cpu().numpy(), matches, err, it
