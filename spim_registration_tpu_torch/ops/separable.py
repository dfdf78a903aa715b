"""Low-rank separable 3D convolution: CP factors and folded conv matrices.

Port of the reference's `ops/separable.py`. A measured bead PSF is close
to separable, so the kernel is approximated in CP form

    kernel  ~=  sum_{r<R}  a_r (x) b_r (x) c_r

(greedy rank-1 deflation with alternating power iterations, refined by
joint CP-ALS) and the convolution runs as R separable passes. The host
side (decomposition, escalation, trim, the on-disk factor cache and the
mirror-folded conv matrices) is a verbatim numpy copy, so the factors and
matrices are bit-identical to the reference's. The device side is torch:
`conv_separable_lowrank` (pad + valid tap passes) and the plain chain
`conv_lowrank_folded`; on the card the lowrank RL engine runs the folded
conv through the CUDA kernels of `ops/kernels/lowrank_conv.py` instead.
"""

from __future__ import annotations

import hashlib
import os
from pathlib import Path
from typing import Tuple

import numpy as np
import torch

from spim_registration_tpu_torch.ops.gaussian import (
    conv_axis_valid,
    mirror_pad,
)

# rank-chunked folded conv (see conv_lowrank_folded): chunk size and the
# volume size above which the (R, n^3) intermediates justify chunking
_RANK_CHUNK = 4
_RANK_CHUNK_MIN_VOXELS = 10 ** 8


def lowrank_decompose(kernel: np.ndarray, rank: int,
                      n_iter: int = 500, tol: float = 1e-12
                      ) -> Tuple[np.ndarray, np.ndarray,
                                 np.ndarray, float]:
    """Greedy CP decomposition of a 3D kernel.

    Returns (az, ay, ax) with shapes (R, kz), (R, ky), (R, kx) — the CP
    weight is folded into az — plus the relative Frobenius error of the
    reconstruction. Greedy rank-1 deflation initializes the factors;
    joint CP-ALS sweeps refine them.
    """
    K = np.asarray(kernel, np.float64)
    norm0 = np.linalg.norm(K) or 1.0
    azs, ays, axs = [], [], []
    resid = K.copy()
    for _ in range(rank):
        wa, b, c = _power_iter_term(resid, n_iter)
        azs.append(wa)
        ays.append(b)
        axs.append(c)
        resid = resid - np.einsum("z,y,x->zyx", wa, b, c)

    A = np.stack(azs, axis=1)
    B = np.stack(ays, axis=1)
    C = np.stack(axs, axis=1)
    A, B, C, err = _als_refine(K, A, B, C, n_iter, tol, norm0)
    return (A.T.astype(np.float32), B.T.astype(np.float32),
            C.T.astype(np.float32), err)


def _power_iter_term(resid: np.ndarray, n_iter: int,
                     stall_tol: float = 1e-12):
    """Dominant rank-1 term of `resid` by alternating power iteration.

    Returns (w*a, b, c) with b, c unit and the weight folded into the
    first factor. Early-stops when the singular-value estimate stalls."""
    a = np.abs(resid).sum(axis=(1, 2))
    b = np.abs(resid).sum(axis=(0, 2))
    c = np.abs(resid).sum(axis=(0, 1))
    for arr in (a, b, c):
        n = np.linalg.norm(arr)
        if n > 0:
            arr /= n
    prev = None
    for _ in range(n_iter):
        a = np.einsum("zyx,y,x->z", resid, b, c)
        na = np.linalg.norm(a)
        if na == 0:
            break
        a /= na
        b = np.einsum("zyx,z,x->y", resid, a, c)
        b /= np.linalg.norm(b) or 1.0
        c = np.einsum("zyx,z,y->x", resid, a, b)
        nc = np.linalg.norm(c)
        if nc == 0:
            break
        c /= nc
        if prev is not None and abs(nc - prev) <= stall_tol * max(nc, 1.0):
            break
        prev = nc
    w = float(np.einsum("zyx,z,y,x->", resid, a, b, c))
    return w * a, b, c


def _als_refine(K: np.ndarray, A: np.ndarray, B: np.ndarray, C: np.ndarray,
                n_iter: int, tol: float, norm0: float):
    """Joint CP-ALS sweeps until the error improvement drops below tol."""
    prev = np.inf
    for _ in range(n_iter):
        A = _als_update(K, B, C, mode=0)
        B = _als_update(K, A, C, mode=1)
        C = _als_update(K, A, B, mode=2)
        err = np.linalg.norm(
            K - np.einsum("zr,yr,xr->zyx", A, B, C)) / norm0
        if prev - err < tol:
            break
        prev = err
    err = float(np.linalg.norm(
        K - np.einsum("zr,yr,xr->zyx", A, B, C)) / norm0)
    return A, B, C, err


def _als_update(K: np.ndarray, F1: np.ndarray, F2: np.ndarray,
                mode: int) -> np.ndarray:
    """One CP-ALS step: least-squares factor for `mode` given the others.

    F1/F2 are the factors of the other two modes IN AXIS ORDER (e.g. for
    mode=1, F1 is the z factor and F2 the x factor)."""
    order = {0: (0, 1, 2), 1: (1, 0, 2), 2: (2, 0, 1)}[mode]
    Km = np.transpose(K, order).reshape(K.shape[mode], -1)
    # Khatri-Rao product of the other factors, rows ordered to match Km
    R = F1.shape[1]
    KR = (F1[:, None, :] * F2[None, :, :]).reshape(-1, R)
    G = (F1.T @ F1) * (F2.T @ F2)
    if not np.all(np.isfinite(G)):
        return np.full((K.shape[mode], R), np.nan)
    # ridge keeps degenerate (duplicate/zero) factor columns solvable
    G = G + (1e-12 * max(np.trace(G), 1.0)) * np.eye(R)
    try:
        return np.linalg.solve(G, (Km @ KR).T).T
    except np.linalg.LinAlgError:
        return Km @ KR @ np.linalg.pinv(G, hermitian=True)


def conv_separable_lowrank(vol: torch.Tensor, az: torch.Tensor,
                           ay: torch.Tensor, ax: torch.Tensor) -> torch.Tensor:
    """Same-size mirror-boundary CONVOLUTION with a sum-of-separable kernel.

    az/ay/ax: (R, taps) per-axis factor banks (odd taps), the CP factors of
    the kernel itself. `conv_axis_valid` computes correlation, so each 1D
    factor is flipped for true convolution."""
    az = torch.flip(az, dims=(1,))
    ay = torch.flip(ay, dims=(1,))
    ax = torch.flip(ax, dims=(1,))
    total = None
    for kz, ky, kx in zip(az, ay, ax):
        out = vol
        for axis, k in enumerate((kz, ky, kx)):
            r = (k.shape[0] - 1) // 2
            if r > 0:
                out = conv_axis_valid(mirror_pad(out, r, axis), k, axis)
            else:
                out = out * k[0]
        total = out if total is None else total + out
    return total


def mirror_indices(n: int, rad: int) -> np.ndarray:
    """Source index for each position of a mirror-padded axis (length
    n + 2*rad). Single-boundary mirror (no edge repeat), valid for any rad
    via the 2(n-1) period."""
    if n == 1:
        return np.zeros(n + 2 * rad, np.int64)
    m = np.mod(np.arange(-rad, n + rad), 2 * n - 2)
    return np.where(m < n, m, 2 * n - 2 - m)


def folded_conv_matrices(az: np.ndarray, ay: np.ndarray, ax: np.ndarray,
                         shape, dtype=np.float32):
    """Per-axis (R, n, n) conv matrices with the mirror boundary FOLDED IN.

    Row i of matrix r: out[i] = sum_j factor_r[j] * x[mirror(i + j - rad)]
    with the factor FLIPPED so the product is true convolution. Applying
    the three axes in sequence (`conv_lowrank_folded`) is a padless
    same-size mirror-boundary convolution with sum_r az_r (x) ay_r (x) ax_r.
    The matrices are band matrices: row i's nonzeros lie in columns
    [i - rad, i + rad] (mirror folds stay inside the half-support).
    """
    out = []
    for bank, n in zip((az, ay, ax), shape):
        bank = np.asarray(bank, np.float64)[:, ::-1]  # flip: convolution
        R, taps = bank.shape
        rad = (taps - 1) // 2
        src = mirror_indices(n, rad)
        M = np.zeros((R, n, n), np.float64)
        rows = np.arange(n)
        for j in range(taps):
            np.add.at(M, (slice(None), rows, src[rows + j]),
                      bank[:, j][:, None])
        out.append(M.astype(dtype))
    return tuple(out)


def _lowrank_chain(vm: torch.Tensor, mz: torch.Tensor, my: torch.Tensor,
                   mx: torch.Tensor) -> torch.Tensor:
    """The z, y, x folded passes for one rank bank: every contraction
    accumulates in f32, `a` and `b` are rounded once to the matrix dtype,
    the x pass and the rank sum stay in f32."""
    mid = mz.dtype
    R, N, P = mz.shape
    Z, Y, X = vm.shape
    a = (mz.float().reshape(R * N, P) @ vm.float().reshape(P, Y * X))
    a = a.to(mid).reshape(R, N, Y, X)
    b = (my.float()[:, None] @ a.float()).to(mid)          # (R, Z, Yo, X)
    c = b.float() @ mx.float().transpose(1, 2)[:, None]    # (R, Z, Yo, Xo)
    return c.sum(dim=0)


def conv_lowrank_folded(vol: torch.Tensor, Mz: torch.Tensor,
                        My: torch.Tensor, Mx: torch.Tensor) -> torch.Tensor:
    """Mirror-boundary convolution via stacked folded conv matrices, as a
    plain chain of torch matmuls.

    Mz/My/Mx: (R, n_axis, n_axis) from `folded_conv_matrices`, in bf16 or
    f32 (the matrix dtype is also the dtype of the two intermediates).
    Large volumes (>= `_RANK_CHUNK_MIN_VOXELS`) run the rank axis in
    chunks of `_RANK_CHUNK`, accumulating the chunk sums in f32, so the
    (R, n^3) intermediates stay bounded."""
    mid = Mz.dtype
    R = Mz.shape[0]
    Z, Y, X = vol.shape
    vm = vol.to(mid)
    if R > _RANK_CHUNK and Z * Y * X >= _RANK_CHUNK_MIN_VOXELS:
        out = torch.zeros((Z, My.shape[1], Mx.shape[1]), dtype=torch.float32,
                          device=vol.device)
        for s in range(0, R, _RANK_CHUNK):
            e = s + _RANK_CHUNK
            out = out + _lowrank_chain(vm, Mz[s:e], My[s:e], Mx[s:e])
        return out.to(vol.dtype)
    return _lowrank_chain(vm, Mz, My, Mx).to(vol.dtype)


def decompose_for_rl(kernel: np.ndarray, rank: int,
                     max_error: float = 0.05, adapt_tol: float = 5e-4,
                     rank_hard: int | None = None,
                     factors=None):
    """Decompose an RL kernel; raise if the low-rank form is too lossy.

    Rank is ADAPTIVE: the smallest rank r <= `rank` whose relative error
    is <= `adapt_tol` is used. If `adapt_tol` is not met at `rank`, growth
    escalates up to `rank_hard` (default: 2*rank) before giving up;
    callers that cannot tolerate the final error check the returned err
    (the RL engine falls back to FFT per kernel).

    `factors`: optional exact CP factors (az, ay, ax) of this kernel (e.g.
    from `condition_psf(..., return_factors=True)`); used when they
    reproduce the kernel to `adapt_tol`.

    The reconstruction is renormalized so its sum matches the kernel's
    (flux preservation in the multiplicative RL update).

    Results are cached on disk keyed by the kernel bytes and parameters
    (`SPIM_FACTOR_CACHE_DIR`, default ~/.cache/spim_tpu_factors; disable
    with SPIM_FACTOR_CACHE=0) — the same cache and format the reference
    uses, so either package's entry serves the other.
    """
    K = np.asarray(kernel, np.float64)
    norm0 = np.linalg.norm(K) or 1.0

    if factors is not None:
        az, ay, ax = [np.asarray(f, np.float64) for f in factors]
        err = float(np.linalg.norm(
            K - np.einsum("rz,ry,rx->zyx", az, ay, ax)) / norm0)
        if err <= adapt_tol:
            return _renorm_mass(kernel, az.astype(np.float32),
                                ay.astype(np.float32),
                                ax.astype(np.float32), err)

    limit = int(rank_hard) if rank_hard is not None else 2 * int(rank)
    limit = max(limit, int(rank))

    cache_path = None
    if os.environ.get("SPIM_FACTOR_CACHE", "1") != "0":
        h = hashlib.sha256()
        h.update(np.ascontiguousarray(K).tobytes())
        h.update(f"{K.shape}|{rank}|{adapt_tol}|{limit}".encode())
        cdir = Path(os.environ.get(
            "SPIM_FACTOR_CACHE_DIR",
            Path.home() / ".cache" / "spim_tpu_factors"))
        cache_path = cdir / (h.hexdigest() + ".npz")
        if cache_path.exists():
            try:
                d = np.load(cache_path)
                hit = (d["az"], d["ay"], d["ax"], float(d["err"]))
            except Exception:
                hit = None  # unreadable entry: recompute and overwrite
            if hit is not None:
                # max_error is NOT part of the key: re-apply the
                # caller's acceptance check on the cached error
                if hit[3] > max_error:
                    raise ValueError(
                        f"PSF rank-{rank} separable approximation too "
                        f"lossy (rel err {hit[3]:.3f} > {max_error}); "
                        "use conv_backend='fft' or raise psf_rank")
                return hit

    # 1) GROW: greedy rank-1 deflation until the residual meets the
    # tolerance (with headroom) or the hard limit
    terms = []
    resid = K.copy()
    g_errs = []
    for r in range(1, limit + 1):
        wa, b, c = _power_iter_term(resid, 150)
        terms.append((wa, b, c))
        resid = resid - np.einsum("z,y,x->zyx", wa, b, c)
        g_errs.append(np.linalg.norm(resid) / norm0)
        if g_errs[-1] <= 0.5 * adapt_tol:
            break
    A = np.stack([t[0] for t in terms], axis=1)
    B = np.stack([t[1] for t in terms], axis=1)
    C = np.stack([t[2] for t in terms], axis=1)

    # 2) REFINE: one strong joint-ALS polish at the grown rank.
    A, B, C, err = _als_refine(K, A, B, C, 500, 1e-12, norm0)

    # 3) TRIM: bisect to the smallest rank still meeting the achieved
    # error (err is monotone in rank).
    target = max(err * 1.05, adapt_tol)
    lo, hi = 1, A.shape[1]          # hi always meets target
    best = (A, B, C, err)
    while lo < hi:
        mid = (lo + hi) // 2
        A2, B2, C2, e2 = _als_refine(K, A[:, :mid].copy(),
                                     B[:, :mid].copy(), C[:, :mid].copy(),
                                     150, 1e-12, norm0)
        if e2 <= target:
            best = (A2, B2, C2, e2)
            hi = mid
        else:
            lo = mid + 1
    A, B, C, err = best
    if not np.isfinite(err):
        raise ValueError(
            "PSF decomposition produced non-finite factors (degenerate or "
            "non-finite kernel); use conv_backend='fft'")
    az, ay, ax = A.T.astype(np.float32), B.T.astype(np.float32), \
        C.T.astype(np.float32)
    if err > max_error:
        raise ValueError(
            f"PSF rank-{rank} separable approximation too lossy "
            f"(rel err {err:.3f} > {max_error}); use conv_backend='fft' "
            f"or raise psf_rank")
    out = _renorm_mass(kernel, az, ay, ax, err)
    if cache_path is not None:
        try:
            cache_path.parent.mkdir(parents=True, exist_ok=True)
            tmp = cache_path.with_suffix(".tmp%d" % os.getpid())
            np.savez(tmp, az=out[0], ay=out[1], ax=out[2],
                     err=np.float64(out[3]))
            os.replace(str(tmp) + ".npz" if not str(tmp).endswith(".npz")
                       else str(tmp), cache_path)
        except Exception:
            pass  # cache is best-effort
    return out


def _renorm_mass(kernel, az, ay, ax, err):
    """Scale the factor bank so the reconstruction's total mass matches the
    kernel's (flux preservation in the RL multiplicative update)."""
    total = float(np.asarray(kernel, np.float64).sum())
    approx = float(sum(
        float(az[r].sum()) * float(ay[r].sum()) * float(ax[r].sum())
        for r in range(az.shape[0])))
    if abs(approx) > 1e-12:
        az = az * np.float32(total / approx)
    return az, ay, ax, err
