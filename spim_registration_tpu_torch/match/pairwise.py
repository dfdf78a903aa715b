"""Pairwise view matching: descriptors -> candidates -> RANSAC -> inliers.

Port of the reference's `match/pairwise.py` (`GeometricHashingPairwise` /
`RGLDMPairwise`): candidate correspondences come from descriptor matching
with a best-vs-second-best ratio test, then RANSAC keeps the inliers and
the fitted model. The device functions take a leading pair axis (B, P, 3),
so `match_pair` (B = 1) and `match.batched.match_pairs_batched` share
them; the host only compacts results.
"""

from __future__ import annotations

import dataclasses
from typing import Literal, Sequence

import numpy as np
import torch

from spim_registration_tpu_torch.match.descriptors import (
    local_coordinate_descriptors,
    rgldm_candidate_scores,
    rgldm_descriptors,
)
from spim_registration_tpu_torch.models.ransac import (
    RansacParameters,
    RansacResult,
    filter_ransac_batched,
)
from spim_registration_tpu_torch.ops.topk import top_k
from spim_registration_tpu_torch.utils.device import resolve_device

MatchingMethod = Literal["geometric_hashing", "rgldm"]

_INF = 3.4e38


@dataclasses.dataclass(frozen=True)
class PairwiseParameters:
    """Matching knobs (GeometricHashingParameters / RGLDMParameters).

    ratio_of_distance: best descriptor distance must be this factor
    smaller than the second best (reference defaults: 10 for geometric
    hashing, 3 for RGLDM)."""

    method: MatchingMethod = "geometric_hashing"
    model: str = "affine"
    ratio_of_distance: float = 10.0
    difference_threshold: float = 3.4e37  # absolute descriptor distance cap
    num_neighbors: int = 3
    redundancy: int = 1
    ransac: RansacParameters = RansacParameters()
    max_points: int = 1024  # padded per-view point budget on device
    # RGLDM: rigid-fit residuals only against this many signature-
    # prefiltered candidates per point
    prefilter_k: int = 16


@dataclasses.dataclass
class PairwiseResult:
    """Host-side compacted result of one view-pair match."""

    model: np.ndarray              # (3,4) B<-A affine (maps A points onto B)
    candidates: np.ndarray         # (C,2) int indices (idxA, idxB)
    inliers: np.ndarray            # (I,2) int indices (idxA, idxB)
    num_candidates: int
    num_inliers: int
    mean_error: float
    max_error: float
    valid: bool

    def __repr__(self):
        pct = 100.0 * self.num_inliers / max(self.num_candidates, 1)
        return (f"PairwiseResult({self.num_candidates} candidates -> "
                f"{self.num_inliers} inliers ({pct:.0f}%), "
                f"err {self.mean_error:.3f}/{self.max_error:.3f} px, "
                f"valid={self.valid})")


def _pad(points: np.ndarray, n: int):
    p = np.zeros((n, 3), np.float32)
    v = np.zeros(n, bool)
    m = min(len(points), n)
    p[:m] = points[:m]
    v[:m] = True
    return p, v


def _candidates_geometric_hashing(pa, va, pb, vb,
                                  params: PairwiseParameters):
    da, oka = local_coordinate_descriptors(pa, va)
    db, okb = local_coordinate_descriptors(pb, vb)
    d2 = ((da * da).sum(-1)[..., :, None] + (db * db).sum(-1)[..., None, :]
          - 2.0 * (da @ db.mT))
    inf = torch.full_like(d2, _INF)
    d2 = torch.where(okb[..., None, :], torch.clamp(d2, min=0.0), inf)
    d2 = torch.where(oka[..., :, None], d2, inf)
    neg, idx = top_k(-d2, 2)
    # ratio test on distances (not squared), like the reference's
    # Matcher.getBestMatch best * ratio < secondBest comparison
    bd = torch.sqrt(torch.clamp(-neg[..., 0], min=0.0))
    sd = torch.sqrt(torch.clamp(-neg[..., 1], min=0.0))
    ok = (oka & (bd * params.ratio_of_distance <= sd)
          & (bd < params.difference_threshold))
    return idx[..., 0], ok


def _candidates_rgldm(pa, va, pb, vb, params: PairwiseParameters):
    ca, oka = rgldm_descriptors(pa, va, params.num_neighbors,
                                params.redundancy)
    cb, okb = rgldm_descriptors(pb, vb, params.num_neighbors,
                                params.redundancy)
    scores, cand_idx = rgldm_candidate_scores(
        pa, ca, oka, pb, cb, okb, k=max(params.prefilter_k, 2))
    neg, kbest = top_k(-scores, 2)
    best, second = -neg[..., 0], -neg[..., 1]
    j = torch.gather(cand_idx, -1, kbest[..., :1])[..., 0]
    ok = (oka & (best * params.ratio_of_distance <= second)
          & (best < params.difference_threshold))
    return j, ok


def _match_device(seeds: Sequence[int], pa, va, pb, vb,
                  params: PairwiseParameters):
    """Candidates + RANSAC for B pairs: pa, pb (B, P, 3), va, vb (B, P).
    Returns (j (B, P) index into B's points, ok (B, P), RansacResult)."""
    if params.method == "geometric_hashing":
        j, ok = _candidates_geometric_hashing(pa, va, pb, vb, params)
    elif params.method == "rgldm":
        j, ok = _candidates_rgldm(pa, va, pb, vb, params)
    else:
        raise ValueError(f"unknown matching method {params.method!r}")
    qb = torch.gather(pb, 1, j[..., None].expand(j.shape + (3,)))
    res = filter_ransac_batched(seeds, pa, qb, ok, model=params.model,
                                params=params.ransac)
    return j, ok, res


def _results(j: torch.Tensor, ok: torch.Tensor, res: RansacResult,
             n: int) -> list:
    """The first `n` rows of a device batch as host PairwiseResults (one
    copy per field for the whole batch)."""
    j, ok, inl = j.cpu().numpy(), ok.cpu().numpy(), \
        res.inlier_mask.cpu().numpy()
    model, n_cand, n_in, mean_e, max_e, valid = (
        t.cpu().numpy() for t in (res.model, res.num_candidates,
                                  res.num_inliers, res.mean_error,
                                  res.max_error, res.valid))
    out = []
    for k in range(n):
        cand_idx = np.nonzero(ok[k])[0]
        inlier_idx = np.nonzero(inl[k])[0]
        out.append(PairwiseResult(
            model=model[k],
            candidates=np.stack([cand_idx, j[k][cand_idx]], axis=1),
            inliers=np.stack([inlier_idx, j[k][inlier_idx]], axis=1),
            num_candidates=int(n_cand[k]),
            num_inliers=int(n_in[k]),
            mean_error=float(mean_e[k]),
            max_error=float(max_e[k]),
            valid=bool(valid[k])))
    return out


def match_pair(points_a: np.ndarray, points_b: np.ndarray,
               params: PairwiseParameters = PairwiseParameters(),
               seed: int = 0, device=None) -> PairwiseResult:
    """Match two views' interest points; returns a compacted
    PairwiseResult whose model maps view-A coordinates onto view B. The
    RANSAC draws come from a generator seeded with `seed`. Runs on CUDA
    unless `device` names another device."""
    dev = resolve_device(device)
    n = params.max_points
    pa, va = (torch.from_numpy(x[None]).to(dev)
              for x in _pad(points_a, n))
    pb, vb = (torch.from_numpy(x[None]).to(dev)
              for x in _pad(points_b, n))
    j, ok, res = _match_device([seed], pa, va, pb, vb, params)
    return _results(j, ok, res, 1)[0]
