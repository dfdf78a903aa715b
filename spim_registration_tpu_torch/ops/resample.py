"""Trilinear affine resampling — the fusion inner loop.

Port of the reference's `ops/resample.py` (`output_grid_coords`,
`trilinear_sample`, `_hat_matrix`, `separable_resample`,
`is_axis_aligned`). Samples outside the volume are 0 with inside=False.

`trilinear_sample` reads the eight corners of each sample's cell with
plain clamped gathers. The reference instead gathers one row of a rolled
all-corners copy (a TPU gather trick); its rolled rows wrap at the top
edges, so a sample on a top face also reads a voxel of the next row or
slab with weight 0 — harmless for finite data, but a NaN there turns the
sample into NaN. The port never reads outside the sample's clamped cell:
a NaN voxel reaches exactly the samples whose cell holds it (NaN * 0 is
still NaN there), and no others.
"""

from __future__ import annotations

import numpy as np
import torch


def output_grid_coords(shape, offset=(0.0, 0.0, 0.0), dtype=torch.float32,
                       device=None) -> torch.Tensor:
    """World coordinates (Z,Y,X,3) of an output block's voxel centres."""
    axes = [torch.arange(n, dtype=dtype, device=device) + float(o)
            for n, o in zip(shape, offset)]
    zz, yy, xx = torch.meshgrid(*axes, indexing="ij")
    return torch.stack([zz, yy, xx], dim=-1)


def trilinear_sample(vol: torch.Tensor, coords: torch.Tensor):
    """Sample `vol` at float (z,y,x) `coords` (..., 3) with trilinear interp.

    Returns (values (...,), inside (...,) bool); outside samples are 0."""
    shape = torch.tensor(vol.shape, dtype=coords.dtype, device=coords.device)
    inside = torch.all((coords >= 0.0) & (coords <= shape - 1.0), dim=-1)
    c = torch.minimum(torch.clamp(coords, min=0.0), shape - 1.0)
    c0 = torch.floor(c)
    frac = c - c0
    c0i = c0.to(torch.int64)
    top = torch.tensor(vol.shape, dtype=torch.int64, device=coords.device) - 1
    # per-axis step to the +1 corner (0 at the top edge, where frac = 0)
    step = torch.minimum(c0i + 1, top) - c0i
    YX = vol.shape[1] * vol.shape[2]
    X = vol.shape[2]
    flat = vol.reshape(-1)
    base = c0i[..., 0] * YX + c0i[..., 1] * X + c0i[..., 2]
    sz = step[..., 0] * YX
    sy = step[..., 1] * X
    sx = step[..., 2]
    fz, fy, fx = frac[..., 0], frac[..., 1], frac[..., 2]
    v = 0.0
    for dz in (0, 1):
        wz = (1 - fz) if dz == 0 else fz
        oz = base if dz == 0 else base + sz
        for dy in (0, 1):
            wy = (1 - fy) if dy == 0 else fy
            oy = oz if dy == 0 else oz + sy
            for dx in (0, 1):
                wx = (1 - fx) if dx == 0 else fx
                idx = oy if dx == 0 else oy + sx
                v = v + wz * wy * wx * flat[idx]
    return torch.where(inside, v, torch.zeros((), dtype=v.dtype,
                                              device=v.device)), inside


def _hat_matrix(n_out, n_in, scale, shift, dtype=torch.float32,
                nearest=False, device=None):
    """(n_out, n_in) linear-interpolation matrix for p(i) = scale*i + shift.

    Row i holds the 2-tap lerp weights of the clipped position p(i); rows
    whose unclipped position is outside [0, n_in-1] are still valid (edge
    clamp) — callers mask with the `inside` flags."""
    p = torch.arange(n_out, dtype=dtype, device=device) * scale + shift
    if nearest:
        p = torch.round(p)
    inside = (p >= 0.0) & (p <= n_in - 1.0)
    pc = torch.clamp(p, 0.0, n_in - 1.0)
    j = torch.arange(n_in, dtype=dtype, device=device)
    W = torch.clamp(1.0 - torch.abs(pc[:, None] - j[None, :]), min=0.0)
    return W, inside


def separable_resample(vol: torch.Tensor, scale, shift, out_shape,
                       nearest: bool = False):
    """Exact trilinear resample for an AXIS-ALIGNED map: output voxel i
    samples vol at (scale*i + shift) per axis; three f32 matmuls.

    Returns (values (out_shape,), inside (out_shape,) bool) — the same
    semantics as `trilinear_sample` on the same coordinates."""
    scale = torch.as_tensor(scale, dtype=vol.dtype, device=vol.device)
    shift = torch.as_tensor(shift, dtype=vol.dtype, device=vol.device)
    Wz, iz = _hat_matrix(out_shape[0], vol.shape[0], scale[0], shift[0],
                         vol.dtype, nearest, vol.device)
    Wy, iy = _hat_matrix(out_shape[1], vol.shape[1], scale[1], shift[1],
                         vol.dtype, nearest, vol.device)
    Wx, ix = _hat_matrix(out_shape[2], vol.shape[2], scale[2], shift[2],
                         vol.dtype, nearest, vol.device)
    a = torch.einsum("zi,iyx->zyx", Wz, vol)
    a = torch.einsum("yj,zjx->zyx", Wy, a)
    a = torch.einsum("xk,zyk->zyx", Wx, a)
    inside = iz[:, None, None] & iy[None, :, None] & ix[None, None, :]
    return torch.where(inside, a, torch.zeros((), dtype=a.dtype,
                                              device=a.device)), inside


def is_axis_aligned(world_to_view: np.ndarray, tol: float = 1e-9) -> bool:
    """True if the (3,4) world->view matrix has negligible off-diagonals
    (so trilinear sampling separates into per-axis interpolation)."""
    M = np.asarray(world_to_view, np.float64)[:, :3]
    off = M - np.diag(np.diag(M))
    return bool(np.all(np.abs(off) <= tol * max(1.0, np.abs(M).max())))
