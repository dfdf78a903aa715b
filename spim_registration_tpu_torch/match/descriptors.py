"""Rotation-invariant local point descriptors.

Port of the reference's `match/descriptors.py` (mpicbg `pointdescriptor`):

- `local_coordinate_descriptors`: a point + its 3 nearest neighbours in a
  local orthonormal frame built from them — the 6D rotation-invariant
  vector of geometric hashing;
- RGLDM (`rgldm_*`): descriptor similarity = RMS residual after the best
  proper rigid alignment of two neighbour constellations, minimized over
  neighbour subsets.

The closed forms are the reference's (no SVD or LAPACK per fit), written
batched: every function takes leading batch dimensions (view pairs), and
the constellation fits run over (pairs, points, candidates, subsets) in
one tensor expression.

One deliberate difference: `_constellation_residual` evaluates in float64
(its result is returned in the input dtype). In float32 the closed form
loses most of its digits on ill-conditioned constellations — the
trigonometric eigenvalue formula amplifies a last-bit difference in
arccos's argument near +-1 — so the ratio test of a few RGLDM candidates
is decided by rounding: float32 runs of the same closed form on two
devices, or in two XLA programs, disagree on those rows. In float64 the
decision is the exact one, and the card and the CPU agree.
"""

from __future__ import annotations

import itertools
import math

import torch

from spim_registration_tpu_torch.match.neighbors import knn
from spim_registration_tpu_torch.models.affine import _det3
from spim_registration_tpu_torch.ops.topk import top_k

_BIG = 3.4e38


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(dim=-1)


def _norm(a: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(_dot(a, a))


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]],
                       dim=-1)


def _local_frame_descriptor(p, n1, n2, n3):
    """6D rotation-invariant descriptor from 3 distance-ordered
    neighbours: [|u1|, u2.e1, u2.e2, u3.e1, u3.e2, u3.e3]."""
    u1 = n1 - p
    u2 = n2 - p
    u3 = n3 - p
    d1 = _norm(u1) + 1e-12
    e1 = u1 / d1[..., None]
    v2 = u2 - _dot(u2, e1)[..., None] * e1
    e2 = v2 / (_norm(v2) + 1e-12)[..., None]
    e3 = _cross(e1, e2)
    return torch.stack([d1, _dot(u2, e1), _dot(u2, e2),
                        _dot(u3, e1), _dot(u3, e2), _dot(u3, e3)], dim=-1)


def _gather_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points (..., P, 3), idx (..., P, k) -> (..., P, k, 3)."""
    lead = idx.shape[:-2]
    flat = idx.reshape(lead + (-1,))
    out = torch.gather(points, -2, flat[..., None].expand(
        flat.shape + (3,)))
    return out.reshape(idx.shape + (3,))


def local_coordinate_descriptors(points: torch.Tensor, valid: torch.Tensor):
    """Geometric-hashing descriptors for every point.

    Returns (desc (..., P, 6), ok (..., P) bool); points with fewer than 3
    valid neighbours are invalid."""
    idx, dist = knn(points, valid, 3)
    n = _gather_points(points, idx)
    desc = _local_frame_descriptor(points, n[..., 0, :], n[..., 1, :],
                                   n[..., 2, :])
    enough = valid.sum(dim=-1, keepdim=True) >= 4
    ok = valid & torch.isfinite(desc).all(dim=-1) & enough \
        & (dist < 1e30).all(dim=-1)
    return torch.where(ok[..., None], desc, torch.zeros_like(desc)), ok


def neighbor_subsets(num_neighbors: int, redundancy: int):
    """The ordered neighbour index subsets of the reference's
    SubsetMatcher: all ways of choosing `num_neighbors` of the nearest
    `num_neighbors + redundancy`, keeping distance order."""
    pool = range(num_neighbors + redundancy)
    return tuple(itertools.combinations(pool, num_neighbors))


def _sym3_eigvalsh(A: torch.Tensor) -> torch.Tensor:
    """Closed-form eigenvalues of symmetric (..., 3, 3) (trigonometric
    formula), sorted descending."""
    q = A.diagonal(dim1=-2, dim2=-1).sum(-1) / 3.0
    Aq = A - q[..., None, None] * torch.eye(3, dtype=A.dtype,
                                             device=A.device)
    p2 = (Aq * Aq).sum(dim=(-2, -1))
    p = torch.sqrt(torch.clamp(p2, min=1e-30) / 6.0)
    B = Aq / p[..., None, None]
    r = _det3(B) / 2.0
    phi = torch.arccos(torch.clamp(r, -1.0, 1.0)) / 3.0
    e1 = q + 2.0 * p * torch.cos(phi)
    e3 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    e2 = 3.0 * q - e1 - e3
    return torch.stack([e1, e2, e3], dim=-1)


def _with_center(p: torch.Tensor, nb: torch.Tensor) -> torch.Tensor:
    """(..., n + 1, 3) = center p (..., 3) then neighbours nb (..., n, 3),
    broadcast over their leading dims."""
    lead = torch.broadcast_shapes(p.shape[:-1], nb.shape[:-2])
    return torch.cat([p.expand(lead + (3,))[..., None, :],
                      nb.expand(lead + nb.shape[-2:])], dim=-2)


def _constellation_residual(pa, na, pb, nb):
    """RMS distance after the best proper rigid alignment of the
    constellations (center + neighbours), batched over leading dims:
    pa, pb (..., 3); na, nb (..., n, 3). Closed form: with centred sets
    pc, qc and H = pc^T qc,
        min_R sum ||R pc - qc||^2
          = sum|pc|^2 + sum|qc|^2 - 2 (s1 + s2 + sign(det H) s3),
    s_i the singular values of H = sqrt(eig(H^T H)) descending.
    Evaluated in float64 (see the module docstring), returned in pa's
    dtype."""
    dtype = pa.dtype
    A = _with_center(pa, na).double()
    B = _with_center(pb, nb).double()
    m = A.shape[-2]
    pc = A - A.sum(dim=-2, keepdim=True) / m
    qc = B - B.sum(dim=-2, keepdim=True) / m
    H = (pc[..., :, :, None] * qc[..., :, None, :]).sum(dim=-3)
    G = (H[..., :, :, None] * H[..., :, None, :]).sum(dim=-3)  # H^T H
    s = torch.sqrt(torch.clamp(_sym3_eigvalsh(G), min=0.0))
    det = (H[..., 0, 0] * (H[..., 1, 1] * H[..., 2, 2]
                           - H[..., 1, 2] * H[..., 2, 1])
           - H[..., 0, 1] * (H[..., 1, 0] * H[..., 2, 2]
                             - H[..., 1, 2] * H[..., 2, 0])
           + H[..., 0, 2] * (H[..., 1, 0] * H[..., 2, 1]
                             - H[..., 1, 1] * H[..., 2, 0]))
    d = torch.sign(det)
    tr = s[..., 0] + s[..., 1] + d * s[..., 2]
    ss = (pc * pc).sum(dim=(-2, -1)) + (qc * qc).sum(dim=(-2, -1)) - 2.0 * tr
    return torch.sqrt(torch.clamp(ss, min=0.0) / m).to(dtype)


def _constellation_signature(p, nb):
    """Rotation/translation-invariant signature of constellations: all
    pairwise distances among {center} + neighbours, in neighbour order.
    p (..., 3), nb (..., n, 3) -> (..., m(m-1)/2)."""
    pts = _with_center(p, nb)
    m = pts.shape[-2]
    d = _norm(pts[..., :, None, :] - pts[..., None, :, :])
    iu, ju = torch.triu_indices(m, m, offset=1, device=p.device)
    return d[..., iu, ju]


def rgldm_descriptors(points: torch.Tensor, valid: torch.Tensor,
                      num_neighbors: int = 3, redundancy: int = 1):
    """Neighbour constellations for RGLDM matching.

    Returns (subsets (..., P, S, n, 3) neighbour coords per subset,
    ok (..., P))."""
    k = num_neighbors + redundancy
    idx, dist = knn(points, valid, k)
    nb = _gather_points(points, idx)                        # (..., P, k, 3)
    sub = torch.tensor(neighbor_subsets(num_neighbors, redundancy),
                       device=points.device)                # (S, n)
    constellations = nb[..., sub, :]                        # (..., P, S, n, 3)
    enough = valid.sum(dim=-1, keepdim=True) >= k + 1
    ok = valid & enough & (dist < 1e30).all(dim=-1)
    return constellations, ok


def _best_over_subsets(pa, ca, pb, cb):
    """min over (subset of b, subset of a) of the constellation residual:
    pa (..., 3), ca (..., SA, n, 3), pb (..., 3), cb (..., SB, n, 3)."""
    SA, SB = ca.shape[-3], cb.shape[-3]
    r = _constellation_residual(
        pa[..., None, None, :], ca[..., None, :, :, :],
        pb[..., None, None, :], cb[..., :, None, :, :])     # (..., SB, SA)
    return r.reshape(r.shape[:-2] + (SB * SA,)).amin(dim=-1)


def rgldm_similarity_matrix(points_a, const_a, ok_a,
                            points_b, const_b, ok_b):
    """(..., PA, PB) best-over-subsets constellation residuals (dense):
    PA * PB * SA * SB fits — the exact twin of `rgldm_candidate_scores`
    used by tests and small problems."""
    r = _best_over_subsets(points_a[..., :, None, :],
                           const_a[..., :, None, :, :, :],
                           points_b[..., None, :, :],
                           const_b[..., None, :, :, :, :])
    ok = ok_a[..., :, None] & ok_b[..., None, :]
    return torch.where(ok, r, torch.full_like(r, _BIG))


def rgldm_candidate_scores(points_a, const_a, ok_a,
                           points_b, const_b, ok_b, k: int = 16):
    """Two-stage RGLDM scoring: (scores (..., PA, k), idx (..., PA, k)).

    Stage 1, prefilter: the pairwise-distance signatures of every subset
    constellation; cross squared distances as one matmul ((PA*SA, D) x
    (D, PB*SB)), min over subsets -> (PA, PB); the top-k B points per A
    point. Stage 2, exact: the rigid-fit residual only for those k
    candidates x SA x SB subset combinations. Memory O(PA*PB +
    PA*k*SA*SB) instead of O(PA*PB*SA*SB)."""
    sig_a = _constellation_signature(points_a[..., None, :], const_a)
    sig_b = _constellation_signature(points_b[..., None, :], const_b)
    PA, SA, D = sig_a.shape[-3:]
    PB, SB, _ = sig_b.shape[-3:]
    lead = sig_a.shape[:-3]
    fa = sig_a.reshape(lead + (PA * SA, D))
    fb = sig_b.reshape(lead + (PB * SB, D))
    d2 = ((fa * fa).sum(-1)[..., :, None] + (fb * fb).sum(-1)[..., None, :]
          - 2.0 * fa @ fb.mT)
    d2 = d2.reshape(lead + (PA, SA, PB, SB)).amin(dim=-1).amin(dim=-2)
    big = torch.full_like(d2, _BIG)
    d2 = torch.where(ok_b[..., None, :], torch.clamp(d2, min=0.0), big)
    d2 = torch.where(ok_a[..., :, None], d2, big)
    k = min(k, PB)
    neg, idx = top_k(-d2, k)                                # (..., PA, k)

    cand_pts = _gather_points(points_b, idx)                # (..., PA, k, 3)
    cand_const = torch.gather(
        const_b, -4,
        idx.reshape(lead + (PA * k, 1, 1, 1)).expand(
            lead + (PA * k,) + const_b.shape[-3:])
    ).reshape(lead + (PA, k) + const_b.shape[-3:])          # (..., PA, k, SB, n, 3)
    r = _best_over_subsets(points_a[..., :, None, :],
                           const_a[..., :, None, :, :, :],
                           cand_pts, cand_const)            # (..., PA, k)
    scores = torch.where(-neg < _BIG, r, torch.full_like(r, _BIG))
    return scores, idx
