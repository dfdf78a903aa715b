"""(3, 4) affine transforms and closed-form model fits on tensors.

Port of the reference's `models/affine.py` (mpicbg `TranslationModel3D`,
`RigidModel3D`, `SimilarityModel3D`, `AffineModel3D` fits). A transform
``A`` acts on points ``p`` of shape (..., 3) in (z, y, x) order as
``A[:, :3] @ p + A[:, 3]``.

The fits are weighted (padding rows carry weight 0) and batched: every
fit, `residuals` and `_solve3x3` take any leading batch dimensions, so
RANSAC fits all hypotheses of all pairs in one call — the reference's
`jax.vmap`-ed `fit_*_batch` variants are the same functions here.
"""

from __future__ import annotations

import torch

# Minimum number of point correspondences each model needs (mpicbg
# Model.getMinNumMatches()).
MODEL_MIN_POINTS = {
    "translation": 1,
    "rigid": 3,
    "similarity": 3,
    "affine": 4,
}

_EPS = 1e-12


def identity_affine(dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.cat([torch.eye(3, dtype=dtype, device=device),
                      torch.zeros((3, 1), dtype=dtype, device=device)], dim=1)


def apply_affine(A: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Apply (3,4) affine to points (..., 3)."""
    return p @ A[:, :3].T + A[:, 3]


def compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Return the affine equal to applying B first, then A (A o B)."""
    R = A[:, :3] @ B[:, :3]
    t = A[:, :3] @ B[:, 3] + A[:, 3]
    return torch.cat([R, t[:, None]], dim=1)


def invert_affine(A: torch.Tensor) -> torch.Tensor:
    Rinv = torch.linalg.inv(A[:, :3])
    t = -Rinv @ A[:, 3]
    return torch.cat([Rinv, t[:, None]], dim=1)


def matrix_4x4(A: torch.Tensor) -> torch.Tensor:
    """Lift a (3,4) affine to homogeneous (4,4)."""
    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=A.dtype,
                          device=A.device)
    return torch.cat([A, bottom], dim=0)


def residuals(A: torch.Tensor, p: torch.Tensor,
              q: torch.Tensor) -> torch.Tensor:
    """Euclidean distances ||A p - q|| per correspondence: A (..., 3, 4),
    p and q (..., N, 3) -> (..., N)."""
    d = p @ A[..., :3].mT + A[..., None, :, 3] - q
    return torch.sqrt((d * d).sum(dim=-1))


def _matvec(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (M @ v[..., None])[..., 0]


def _with_translation(M: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return torch.cat([M, t[..., None]], dim=-1)


def _weighted_centroids(p, q, w):
    wsum = torch.clamp(w.sum(dim=-1), min=_EPS)
    cp = (p * w[..., None]).sum(dim=-2) / wsum[..., None]
    cq = (q * w[..., None]).sum(dim=-2) / wsum[..., None]
    return cp, cq, wsum


def fit_translation(p: torch.Tensor, q: torch.Tensor,
                    w: torch.Tensor) -> torch.Tensor:
    """Weighted translation fit: t = mean(q) - mean(p)."""
    cp, cq, _ = _weighted_centroids(p, q, w)
    eye = torch.eye(3, dtype=p.dtype, device=p.device).expand(
        cp.shape[:-1] + (3, 3))
    return _with_translation(eye, cq - cp)


def _cross_covariance(p, q, w):
    cp, cq, wsum = _weighted_centroids(p, q, w)
    pc = p - cp[..., None, :]
    qc = q - cq[..., None, :]
    H = (pc * w[..., None]).mT @ qc / wsum[..., None, None]
    return H, cp, cq, pc, qc, wsum


def _det3(a: torch.Tensor) -> torch.Tensor:
    """Determinant of (..., 3, 3) in the closed form (and term order) that
    `jnp.linalg.det` evaluates for 3x3 matrices."""
    return (a[..., 0, 0] * a[..., 1, 1] * a[..., 2, 2]
            + a[..., 0, 1] * a[..., 1, 2] * a[..., 2, 0]
            + a[..., 0, 2] * a[..., 1, 0] * a[..., 2, 1]
            - a[..., 0, 2] * a[..., 1, 1] * a[..., 2, 0]
            - a[..., 0, 0] * a[..., 1, 2] * a[..., 2, 1]
            - a[..., 0, 1] * a[..., 1, 0] * a[..., 2, 2])


def _kabsch_rotation(H: torch.Tensor) -> torch.Tensor:
    """SVD orthogonal Procrustes with the reflection fix. The singular
    vectors' signs may differ between LAPACKs; R does not when the
    singular values are distinct."""
    U, _, Vh = torch.linalg.svd(H)
    V = Vh.mT
    d = torch.sign(_det3(V @ U.mT))
    D = torch.diag_embed(torch.stack([torch.ones_like(d),
                                      torch.ones_like(d), d], dim=-1))
    return V @ D @ U.mT


def fit_rigid(p: torch.Tensor, q: torch.Tensor,
              w: torch.Tensor) -> torch.Tensor:
    """Weighted rigid (rotation + translation) fit, Kabsch algorithm."""
    H, cp, cq, _, _, _ = _cross_covariance(p, q, w)
    R = _kabsch_rotation(H)
    return _with_translation(R, cq - _matvec(R, cp))


def fit_similarity(p: torch.Tensor, q: torch.Tensor,
                   w: torch.Tensor) -> torch.Tensor:
    """Weighted similarity (uniform scale + rotation + translation) fit;
    Umeyama scale trace(R H) / var_p."""
    H, cp, cq, pc, qc, wsum = _cross_covariance(p, q, w)
    R = _kabsch_rotation(H)
    var_p = (w[..., None] * pc * pc).sum(dim=(-2, -1)) / wsum
    s = (R @ H).diagonal(dim1=-2, dim2=-1).sum(-1) \
        / torch.clamp(var_p, min=_EPS)
    t = cq - s[..., None] * _matvec(R, cp)
    return _with_translation(s[..., None, None] * R, t)


def _solve3x3(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Closed-form 3x3 solve X = A^-1 B via the adjugate (Cramer). A
    degenerate A (a collinear minimal set) gives a huge X, as LU's
    garbage would: such a hypothesis loses the RANSAC vote either way."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    C00 = e * i - f * h
    C01 = f * g - d * i
    C02 = d * h - e * g
    det = a * C00 + b * C01 + c * C02
    adj = torch.stack([
        torch.stack([C00, c * h - b * i, b * f - c * e], dim=-1),
        torch.stack([C01, a * i - c * g, c * d - a * f], dim=-1),
        torch.stack([C02, b * g - a * h, a * e - b * d], dim=-1),
    ], dim=-2)
    inv_det = 1.0 / torch.where(det.abs() > 0, det,
                                torch.full_like(det, _EPS))
    return (adj @ B) * inv_det[..., None, None]


def fit_affine(p: torch.Tensor, q: torch.Tensor,
               w: torch.Tensor) -> torch.Tensor:
    """Weighted full-affine least squares via the centred 3x3 normal
    equations (with a 1e-8 ridge for degenerate minimal sets)."""
    cp, cq, wsum = _weighted_centroids(p, q, w)
    pc = p - cp[..., None, :]
    qc = q - cq[..., None, :]
    PtWP = (pc * w[..., None]).mT @ pc / wsum[..., None, None]
    QtWP = (qc * w[..., None]).mT @ pc / wsum[..., None, None]
    PtWP = PtWP + 1e-8 * torch.eye(3, dtype=p.dtype, device=p.device)
    M = _solve3x3(PtWP.mT, QtWP.mT).mT
    return _with_translation(M, cq - _matvec(M, cp))


_FITTERS = {
    "translation": fit_translation,
    "rigid": fit_rigid,
    "similarity": fit_similarity,
    "affine": fit_affine,
}


def fit_model(model: str, p: torch.Tensor, q: torch.Tensor,
              w: torch.Tensor | None = None) -> torch.Tensor:
    """Fit the named model to (..., N, 3) correspondences."""
    if model not in _FITTERS:
        raise ValueError(f"unknown model {model!r}; one of {sorted(_FITTERS)}")
    if w is None:
        w = torch.ones(p.shape[:-1], dtype=p.dtype, device=p.device)
    return _FITTERS[model](p, q, w)


def fit_regularized(model: str, reg_model: str, lam: float,
                    p: torch.Tensor, q: torch.Tensor,
                    w: torch.Tensor | None = None) -> torch.Tensor:
    """Interpolated-model fit (mpicbg `InterpolatedAffineModel3D`):
    (1 - lam) * fit(model) + lam * fit(reg_model)."""
    A = fit_model(model, p, q, w)
    B = fit_model(reg_model, p, q, w)
    return (1.0 - lam) * A + lam * B
