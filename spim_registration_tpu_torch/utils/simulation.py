"""Synthetic multi-view SPIM data simulation (host numpy).

A copy of the reference's `utils/simulation.py`: ground-truth bead clouds
rendered into views through known affines, with per-view PSF blur and
noise — the inputs of the tests and of `chip_smoke.py`. The same seed
gives the same scene as the reference.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np


def random_rotation(rng, max_angle_deg=15.0) -> np.ndarray:
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    angle = np.deg2rad(rng.uniform(-max_angle_deg, max_angle_deg))
    K = np.array([[0, -axis[2], axis[1]],
                  [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * (K @ K)


def rotation_about_axis(axis_idx: int, angle_deg: float) -> np.ndarray:
    """Rotation about a coordinate axis (z=0, y=1, x=2) — SPIM views are
    typically equally spaced rotations about the y axis."""
    a = np.deg2rad(angle_deg)
    c, s = np.cos(a), np.sin(a)
    if axis_idx == 0:
        return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], float)
    if axis_idx == 1:
        return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], float)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], float)


def render_beads(points: np.ndarray, shape, sigma=1.7,
                 amplitude=1.0) -> np.ndarray:
    """Render gaussian beads at float (z,y,x) positions into a volume."""
    vol = np.zeros(shape, np.float32)
    r = int(np.ceil(3 * sigma))
    for c in points:
        ci = np.round(c).astype(int)
        lo = np.maximum(ci - r, 0)
        hi = np.minimum(ci + r + 1, shape)
        if np.any(lo >= hi):
            continue
        zz, yy, xx = np.meshgrid(*[np.arange(l, h) for l, h in zip(lo, hi)],
                                 indexing="ij")
        vol[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]] += amplitude * np.exp(
            -(((zz - c[0]) ** 2 + (yy - c[1]) ** 2 + (xx - c[2]) ** 2)
              / (2 * sigma ** 2))
        )
    return vol


def _fft_blur(vol: np.ndarray, psf: np.ndarray) -> np.ndarray:
    """Host-side circular FFT convolution (beads sit >= margin from the
    edge, so wrap-around is negligible)."""
    import numpy.fft as nfft

    axes = (0, 1, 2)
    kp = np.zeros(vol.shape, np.float32)
    kp[: psf.shape[0], : psf.shape[1], : psf.shape[2]] = psf
    kp = np.roll(kp, [-(s // 2) for s in psf.shape], axis=axes)
    out = nfft.irfftn(nfft.rfftn(vol, axes=axes) * nfft.rfftn(kp, axes=axes),
                      vol.shape, axes=axes)
    return out.astype(np.float32)


@dataclasses.dataclass
class MultiViewScene:
    """Ground truth + per-view data for a simulated acquisition."""

    world_points: np.ndarray            # (B, 3) bead positions, world
    volumes: List[np.ndarray]           # per-view images (view space)
    view_points: List[np.ndarray]       # (B, 3) bead positions per view
    models: List[np.ndarray]            # true (3,4) view -> world affines
    psfs: List[Optional[np.ndarray]]    # per-view PSF actually applied
    shape: Tuple[int, int, int]


def make_multiview_scene(
    rng,
    n_views: int = 6,
    shape: Tuple[int, int, int] = (96, 96, 96),
    n_beads: int = 100,
    rotation_axis: int = 1,
    max_perturb_deg: float = 3.0,
    max_shift: float = 4.0,
    noise: float = 0.01,
    bead_sigma: float = 1.7,
    psf_sigmas: Optional[Sequence[Tuple[float, float, float]]] = None,
    full_circle: bool = False,
) -> MultiViewScene:
    """Simulate an n-view SPIM acquisition of one bead cloud.

    View v's nominal pose is a rotation about `rotation_axis` by
    v * (360/n if full_circle else small spread), perturbed by a random
    small rotation + shift; all views rotate about the volume centre so
    they overlap. When `psf_sigmas` is given, view v is blurred with an
    anisotropic Gaussian PSF."""
    margin = max(12, int(min(shape) * 0.15))
    world = rng.uniform(margin, np.array(shape, float) - margin,
                        size=(n_beads, 3))
    center = np.array(shape, float) / 2.0

    volumes, view_points, models, psfs = [], [], [], []
    for v in range(n_views):
        if v == 0:
            R = np.eye(3)
            t = np.zeros(3)
        else:
            base = (360.0 / n_views * v) if full_circle else \
                rng.uniform(-25.0, 25.0)
            R = rotation_about_axis(rotation_axis, base) @ \
                random_rotation(rng, max_perturb_deg)
            t = rng.uniform(-max_shift, max_shift, 3)
        A = np.concatenate([R, (center + t - R @ center)[:, None]], axis=1)
        A4 = np.vstack([A, [0, 0, 0, 1]])
        inv = np.linalg.inv(A4)[:3]
        pts_v = world @ inv[:, :3].T + inv[:, 3]
        vol = render_beads(pts_v, shape, bead_sigma)
        psf = None
        if psf_sigmas is not None:
            from spim_registration_tpu_torch.deconv.psf import gaussian_psf
            psf = gaussian_psf((13, 13, 13), psf_sigmas[v % len(psf_sigmas)])
            vol = _fft_blur(vol, psf)
        if noise:
            vol = vol + rng.normal(0, noise, shape).astype(np.float32)
        volumes.append(vol.astype(np.float32))
        view_points.append(pts_v)
        models.append(A)
        psfs.append(psf)

    return MultiViewScene(
        world_points=world, volumes=volumes, view_points=view_points,
        models=models, psfs=psfs, shape=tuple(shape),
    )
