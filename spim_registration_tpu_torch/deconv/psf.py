"""PSF extraction from matched beads.

Port of the reference's `deconv/psf.py`: the per-view PSF is the average
of bead-centred patches sampled THROUGH the view transform — on the
world-aligned grid around each bead's world position — so every view's
PSF lives in the common output orientation. The beads are one batch
dimension of a single trilinear gather. `gaussian_psf` and
`condition_psf` are host numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from spim_registration_tpu_torch.models.affine import (
    apply_affine,
    invert_affine,
)
from spim_registration_tpu_torch.ops.resample import trilinear_sample
from spim_registration_tpu_torch.utils.device import resolve_device


def gaussian_psf(shape=(17, 17, 17), sigma=(2.0, 1.5, 1.5),
                 dtype=np.float32) -> np.ndarray:
    """Synthetic anisotropic Gaussian PSF (lightsheet-like: worse in z)."""
    grids = np.meshgrid(*[np.arange(s) - s // 2 for s in shape],
                        indexing="ij")
    q = sum((g / s) ** 2 for g, s in zip(grids, sigma))
    psf = np.exp(-0.5 * q)
    return (psf / psf.sum()).astype(dtype)


def condition_psf(psf: np.ndarray, taper_radius: float | None = None,
                  floor: float = 0.0,
                  denoise_rank: int | None = None,
                  return_factors: bool = False):
    """Extracted-PSF conditioning: a soft cosine taper beyond
    `taper_radius`, a relative floor (zero out values < floor * max), and
    optional low-rank projection denoising (reconstruct the kernel from
    its rank-`denoise_rank` CP decomposition). Renormalizes to sum 1.

    `return_factors=True` (requires `denoise_rank`) also returns the CP
    factor bank (az, ay, ax) of the returned kernel, scaled so that
    sum_r az_r (x) ay_r (x) ax_r == the returned psf (f64); pass them as
    `DeconvolutionViews.psf_factors` so the lowrank conv uses the
    kernel's own factors."""
    psf = np.asarray(psf, np.float64)
    factors = None
    if taper_radius is not None:
        grids = np.meshgrid(*[np.arange(s) - s // 2 for s in psf.shape],
                            indexing="ij")
        r = np.sqrt(sum(g.astype(float) ** 2 for g in grids))
        edge = min(s // 2 for s in psf.shape)
        t = np.clip((r - taper_radius) / max(edge - taper_radius, 1e-6),
                    0.0, 1.0)
        psf = psf * (0.5 * (1.0 + np.cos(np.pi * t)))
    if floor > 0:
        psf = np.where(psf < floor * psf.max(), 0.0, psf)
    if denoise_rank is not None:
        from spim_registration_tpu_torch.ops.separable import decompose_for_rl

        # rank_hard pins the cap: denoise_rank is the projection rank
        az, ay, ax, _err = decompose_for_rl(
            psf, denoise_rank, max_error=1.0, adapt_tol=1e-4,
            rank_hard=denoise_rank)
        az, ay, ax = (az.astype(np.float64), ay.astype(np.float64),
                      ax.astype(np.float64))
        psf = np.einsum("rz,ry,rx->zyx", az, ay, ax)
        factors = (az, ay, ax)
        # deliberately NOT clamped to >= 0: clamping would break the exact
        # low-rank representation the lowrank conv relies on
    s = psf.sum()
    if s > 0:
        psf = psf / s
        if factors is not None:
            factors = (factors[0] / s, factors[1], factors[2])
    out = psf.astype(np.float32)
    if return_factors:
        if factors is None:
            raise ValueError("return_factors requires denoise_rank")
        return out, factors
    return out


def _extract(vol, view_to_world, points_world, psf_shape):
    """Average the world-oriented patches of all beads whose patch lies
    fully inside the view; returns (normalized psf, beads used)."""
    world_to_view = invert_affine(view_to_world)
    offs = torch.stack(torch.meshgrid(
        *[torch.arange(s, dtype=torch.float32, device=vol.device) - s // 2
          for s in psf_shape], indexing="ij"), dim=-1)     # (sz,sy,sx,3)
    coords = apply_affine(world_to_view,
                          points_world[:, None, None, None, :] + offs)
    patches, inside = trilinear_sample(vol, coords)      # (B, sz, sy, sx)
    w = inside.reshape(inside.shape[0], -1).all(dim=1).to(torch.float32)
    acc = torch.einsum("b...,b->...", patches, w)
    n = torch.clamp(w.sum(), min=1.0)
    psf = acc / n
    psf = torch.clamp(psf - psf.min(), min=0.0)
    return psf / torch.clamp(psf.sum(), min=1e-12), w.sum()


def extract_psf(vol: np.ndarray, view_to_world: np.ndarray,
                points_view: np.ndarray, psf_shape=(19, 19, 19),
                device=None):
    """Extract a world-oriented PSF for one view.

    Args:
      vol: raw view image (z,y,x).
      view_to_world: the view's (3,4) model.
      points_view: bead positions in VIEW coordinates.
      psf_shape: odd patch size in world voxels.
      device: where the extraction runs (default CUDA; "cpu" for the host).

    Returns (psf (psf_shape,) float32 normalized to sum 1, n_used)."""
    dev = resolve_device(device)
    A = torch.as_tensor(np.asarray(view_to_world, np.float32), device=dev)
    pv = torch.as_tensor(np.asarray(points_view, np.float32), device=dev)
    pw = apply_affine(A, pv.reshape(-1, 3))
    psf, n = _extract(torch.as_tensor(np.asarray(vol, np.float32),
                                      device=dev),
                      A, pw, tuple(psf_shape))
    return psf.cpu().numpy(), int(n)
