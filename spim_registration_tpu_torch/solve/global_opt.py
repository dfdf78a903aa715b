"""Global alignment of all views as a pose-graph least-squares problem.

Port of the reference's `solve/global_opt.py` (mpicbg `Tile` /
`TileConfiguration`, solved through the normal equations): affine and
translation corrections are linear in the parameters, so one regularized
solve is exact; rigid corrections use Gauss-Newton on se(3) increments
with exact SO(3) retraction. Corrections B_g are solved per tile (= view
group) and applied on top of each view's current transform:
A_v <- B_{g(v)} o A_v. Correspondence points are passed already mapped
through their views' current transforms.

The solve is host float64 numpy, as in the reference. For large
correspondence counts the normal equations are assembled on the device
(`solve/assembly.py`, float32, deterministic) and solved on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from spim_registration_tpu_torch.solve.assembly import (
    assemble_normal_equations,
)
from spim_registration_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class PairMatches:
    """Inlier correspondences between two views (already in world coords)."""

    view_i: int
    view_j: int
    p: np.ndarray  # (N,3) points of view_i mapped by its current transform
    q: np.ndarray  # (N,3) matching points of view_j, likewise
    w: Optional[np.ndarray] = None  # (N,) weights


@dataclasses.dataclass(frozen=True)
class GlobalOptParameters:
    model: str = "affine"            # translation | rigid | affine
    max_iterations: int = 20         # GN iterations (rigid); 1 for linear
    damping: float = 1e-6            # Tikhonov on the normal matrix
    convergence_tol: float = 1e-6    # stop when mean residual improves less
    # None = auto: device assembly (solve/assembly.py) for >= 2000
    # correspondences, host float64 loop for fewer
    device_assembly: Optional[bool] = None
    # post-solve outlier pruning (the "remove wrong links" pass between
    # optimize rounds): after each solve, drop correspondences with
    # residual > max(k * median, floor_px) and re-solve. Each pair always
    # retains at least `outlier_trim_min_matches` of its best matches so
    # the pose graph stays connected. Default 0 rounds (one solve);
    # `pipeline.run.RegistrationConfig` opts in with 2.
    outlier_trim_rounds: int = 0
    outlier_trim_k: float = 4.0
    outlier_trim_floor_px: float = 0.5
    outlier_trim_min_matches: int = 4


@dataclasses.dataclass
class GlobalOptResult:
    corrections: Dict[int, np.ndarray]  # tile -> (3,4) correction affine
    mean_error: float
    max_error: float
    per_pair_error: Dict[tuple, float]
    iterations: int
    # the view pair contributing the max single-match residual
    max_error_pair: tuple = ()
    # outlier pruning bookkeeping (see GlobalOptParameters.outlier_trim_*)
    trimmed: int = 0
    trimmed_per_pair: Dict[tuple, int] = dataclasses.field(
        default_factory=dict)


def _stack_matches(matches: Sequence[PairMatches], tile_of: Dict[int, int]):
    ps, qs, ws, ti, tj, pair_id = [], [], [], [], [], []
    for k, m in enumerate(matches):
        n = len(m.p)
        if n == 0:
            continue
        ps.append(np.asarray(m.p, np.float64))
        qs.append(np.asarray(m.q, np.float64))
        ws.append(np.ones(n) if m.w is None else np.asarray(m.w, np.float64))
        ti.append(np.full(n, tile_of[m.view_i], np.int32))
        tj.append(np.full(n, tile_of[m.view_j], np.int32))
        pair_id.append(np.full(n, k, np.int32))
    if not ps:
        raise ValueError("no correspondences given to solve_global")
    return (np.concatenate(ps), np.concatenate(qs), np.concatenate(ws),
            np.concatenate(ti), np.concatenate(tj), np.concatenate(pair_id))


def _linear_design(model: str, pts: np.ndarray):
    """Design matrix rows X (N,3,P) such that residual contribution of a
    point p under parameter vector theta is X(p) @ theta (+ p itself for
    the identity part, handled via initial residual)."""
    n = pts.shape[0]
    if model == "translation":
        X = np.zeros((n, 3, 3))
        X[:, 0, 0] = X[:, 1, 1] = X[:, 2, 2] = 1.0
        return X
    if model == "affine":
        # theta = vec(dM (row-major 9), dt (3)); correction B = I + dM, t = dt
        X = np.zeros((n, 3, 12))
        for r in range(3):
            X[:, r, 3 * r:3 * r + 3] = pts
            X[:, r, 9 + r] = 1.0
        return X
    if model == "rigid":
        # theta = (omega (3), u (3)); linearized correction p + omega x p + u
        X = np.zeros((n, 3, 6))
        z, y, x = pts[:, 0], pts[:, 1], pts[:, 2]
        # d(omega x p)/d(omega) with (z, y, x) as the 3-vector components:
        # omega x p = (w2*x - w3*y, w3*z - w1*x, w1*y - w2*z)
        X[:, 0, 1] = x
        X[:, 0, 2] = -y
        X[:, 1, 0] = -x
        X[:, 1, 2] = z
        X[:, 2, 0] = y
        X[:, 2, 1] = -z
        X[:, 0, 3] = X[:, 1, 4] = X[:, 2, 5] = 1.0
        return X
    raise ValueError(f"unsupported global model {model!r}")


def _param_count(model: str) -> int:
    return {"translation": 3, "affine": 12, "rigid": 6}[model]


def _theta_to_affine(model: str, theta: np.ndarray) -> np.ndarray:
    if model == "translation":
        return np.concatenate([np.eye(3), theta.reshape(3, 1)], axis=1)
    if model == "affine":
        M = np.eye(3) + theta[:9].reshape(3, 3)
        return np.concatenate([M, theta[9:].reshape(3, 1)], axis=1)
    if model == "rigid":
        om, u = theta[:3], theta[3:]
        th = np.linalg.norm(om)
        if th < 1e-12:
            R = np.eye(3)
        else:
            k = om / th
            K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]],
                          [-k[1], k[0], 0]])
            R = np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)
        return np.concatenate([R, u.reshape(3, 1)], axis=1)
    raise ValueError(model)


def solve_global(
    matches: Sequence[PairMatches],
    fixed_views: Sequence[int],
    params: GlobalOptParameters = GlobalOptParameters(),
    groups: Optional[Sequence[Sequence[int]]] = None,
    device=None,
) -> GlobalOptResult:
    """Solve for per-tile corrections minimizing sum ||B_i p - B_j q||^2.

    Args:
      matches: pairwise inlier correspondences in current world coords.
      fixed_views: views whose tiles stay identity (gauge; the reference's
        fixed reference tile(s)).
      groups: optional list of view-id groups that share one tile (the
        reference's GlobalOptimizationSubset grouping). Ungrouped views get
        their own tile.
      device: where the normal equations are assembled when the device
        assembly runs (`params.device_assembly`, or >= 2000
        correspondences when it is None): CUDA unless another device is
        named.
    """
    views = sorted({m.view_i for m in matches} | {m.view_j for m in matches}
                   | set(fixed_views))
    tile_of: Dict[int, int] = {}
    if groups:
        for g, members in enumerate(groups):
            for v in members:
                tile_of[v] = g
        next_tile = len(groups)
    else:
        next_tile = 0
    for v in views:
        if v not in tile_of:
            tile_of[v] = next_tile
            next_tile += 1
    T = next_tile

    fixed_tiles = sorted({tile_of[v] for v in fixed_views})
    free_tiles = [t for t in range(T) if t not in set(fixed_tiles)]
    if not free_tiles:
        raise ValueError("all tiles are fixed")
    col_of = {t: i for i, t in enumerate(free_tiles)}

    p0, q0, w_all, ti, tj, pair_id = _stack_matches(matches, tile_of)
    keep = np.ones(len(p0), bool)
    B = [np.concatenate([np.eye(3), np.zeros((3, 1))], axis=1)
         for _ in range(T)]

    n_iter = 1 if params.model in ("translation", "affine") else params.max_iterations
    it_done = 0
    # initial residuals — defined even if n_iter == 0 (e.g. a rigid solve
    # with max_iterations=0 used to probe the starting error)
    errs = np.linalg.norm(p0 - q0, axis=1)
    mean_err = (float(np.average(errs, weights=w_all)) if len(errs)
                else 0.0)
    for _round in range(max(params.outlier_trim_rounds, 0) + 1):
        w = w_all * keep
        errs, mean_err, it_done = _solve_rounds(
            B, p0, q0, w, ti, tj, tile_of, col_of, free_tiles, params,
            n_iter, device)
        if _round >= params.outlier_trim_rounds or not len(errs):
            break
        kept_errs = errs[keep]
        if not len(kept_errs):
            break
        thr = max(params.outlier_trim_k * float(np.median(kept_errs)),
                  params.outlier_trim_floor_px)
        new_keep = keep & (errs <= thr)
        # retention guard: every pair keeps >= min_matches best matches
        mk = params.outlier_trim_min_matches
        for k_p in range(len(matches)):
            sel = pair_id == k_p
            if keep[sel].any() and new_keep[sel].sum() < mk:
                idx = np.where(sel & keep)[0]
                new_keep[idx[np.argsort(errs[idx])][:mk]] = True
        if new_keep.sum() == keep.sum():
            break  # nothing left to trim
        keep = new_keep

    per_pair: Dict[tuple, float] = {}
    trimmed_per_pair: Dict[tuple, int] = {}
    for k, m in enumerate(matches):
        sel = (pair_id == k) & keep
        if np.any(sel):
            per_pair[(m.view_i, m.view_j)] = float(np.mean(errs[sel]))
        n_cut = int(((pair_id == k) & ~keep).sum())
        if n_cut:
            trimmed_per_pair[(m.view_i, m.view_j)] = n_cut

    corrections = {}
    for v in views:
        corrections[v] = B[tile_of[v]]
    kept_idx = np.where(keep)[0]
    if len(kept_idx):
        kmax_n = kept_idx[int(np.argmax(errs[kept_idx]))]
        k_max = int(pair_id[kmax_n])
        max_err = float(errs[kmax_n])
        max_pair = (matches[k_max].view_i, matches[k_max].view_j)
        mean_err = float(np.average(errs[kept_idx],
                                    weights=w_all[kept_idx]))
    else:
        max_err, max_pair, mean_err = 0.0, (), 0.0
    return GlobalOptResult(
        corrections=corrections,
        mean_error=mean_err,
        max_error=max_err,
        per_pair_error=per_pair,
        iterations=it_done,
        max_error_pair=max_pair,
        trimmed=int((~keep).sum()),
        trimmed_per_pair=trimmed_per_pair,
    )


def _solve_rounds(B, p0, q0, w, ti, tj, tile_of, col_of, free_tiles,
                  params, n_iter, device=None):
    """The inner (Gauss-)Newton loop on the CURRENT correspondence
    weights; mutates the per-tile corrections `B` in place and returns
    (per-match residuals, weighted mean residual, iterations run)."""
    P = _param_count(params.model)
    prev_err = np.inf
    it_done = 0
    errs = np.linalg.norm(p0 - q0, axis=1)
    mean_err = float(np.average(errs, weights=w)) if len(errs) else 0.0
    for it in range(n_iter):
        # current transformed points
        Bi = np.stack([B[t] for t in ti])
        Bj = np.stack([B[t] for t in tj])
        pc = np.einsum("nrc,nc->nr", Bi[:, :, :3], p0) + Bi[:, :, 3]
        qc = np.einsum("nrc,nc->nr", Bj[:, :, :3], q0) + Bj[:, :, 3]
        r0 = pc - qc  # residual at theta = 0

        dim = len(free_tiles) * P
        use_device = (params.device_assembly
                      if params.device_assembly is not None
                      else len(p0) >= 2000)
        if use_device:
            dev = resolve_device(device)
            col_i = np.asarray([col_of.get(int(t), -1) for t in ti],
                               np.int64)
            col_j = np.asarray([col_of.get(int(t), -1) for t in tj],
                               np.int64)

            def on(a, dt=torch.float32):
                return torch.as_tensor(np.asarray(a), dtype=dt, device=dev)

            Hd, gd = assemble_normal_equations(
                params.model, len(free_tiles), on(pc), on(qc), on(w),
                on(col_i, torch.int64), on(col_j, torch.int64))
            H = Hd.cpu().numpy().astype(np.float64)
            g = gd.cpu().numpy().astype(np.float64)
        else:
            Xi = _linear_design(params.model, pc)
            Xj = _linear_design(params.model, qc)
            H = np.zeros((dim, dim))
            g = np.zeros(dim)

            # accumulate normal equations blockwise
            XtXi = np.einsum("nrp,nrq,n->npq", Xi, Xi, w)
            XtXj = np.einsum("nrp,nrq,n->npq", Xj, Xj, w)
            XtXij = np.einsum("nrp,nrq,n->npq", Xi, Xj, w)
            gi = np.einsum("nrp,nr,n->np", Xi, r0, w)
            gj = np.einsum("nrp,nr,n->np", Xj, r0, w)

            for n in range(len(p0)):
                a, b = ti[n], tj[n]
                fa, fb = a in col_of, b in col_of
                if fa:
                    ca = col_of[a] * P
                    H[ca:ca + P, ca:ca + P] += XtXi[n]
                    g[ca:ca + P] += gi[n]
                if fb:
                    cb = col_of[b] * P
                    H[cb:cb + P, cb:cb + P] += XtXj[n]
                    g[cb:cb + P] -= gj[n]
                if fa and fb:
                    H[ca:ca + P, cb:cb + P] -= XtXij[n]
                    H[cb:cb + P, ca:ca + P] -= XtXij[n].T
        H += params.damping * np.eye(dim)
        theta = np.linalg.solve(H, -g)

        # retraction: B_t <- delta(theta_t) o B_t
        for t in free_tiles:
            th = theta[col_of[t] * P:(col_of[t] + 1) * P]
            D = _theta_to_affine(params.model, th)
            B4 = np.vstack([B[t], [0, 0, 0, 1]])
            D4 = np.vstack([D, [0, 0, 0, 1]])
            B[t] = (D4 @ B4)[:3]

        # convergence check on residuals
        Bi = np.stack([B[t] for t in ti])
        Bj = np.stack([B[t] for t in tj])
        pc = np.einsum("nrc,nc->nr", Bi[:, :, :3], p0) + Bi[:, :, 3]
        qc = np.einsum("nrc,nc->nr", Bj[:, :, :3], q0) + Bj[:, :, 3]
        errs = np.linalg.norm(pc - qc, axis=1)
        mean_err = float(np.average(errs, weights=w))
        it_done = it + 1
        if abs(prev_err - mean_err) < params.convergence_tol:
            break
        prev_err = mean_err
    return errs, mean_err, it_done
