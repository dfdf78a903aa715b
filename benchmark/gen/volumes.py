"""The benchmark's inputs, made on the device from the run's seed.

Bead volumes are rendered analytically: every bead is a Gaussian summed
into a cube of half-width ceil(3 sigma) around its rounded centre, as the
port's `utils/simulation.render_beads` renders it, here in one scatter for
all beads (summed in float64, so that the order of the sums cannot change
the float32 result). Blurs are circular FFT convolutions on the device,
as the bench's phantom was blurred on the host. Imports nothing of the
port.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def generator(seed: int, device, stream: int) -> torch.Generator:
    """A generator on `device` for one stream of the run's draws: the
    same seed and stream give the same numbers."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % (1 << 63))
    return g


def uniform(g: torch.Generator, shape, lo, hi, device) -> torch.Tensor:
    lo = torch.as_tensor(lo, dtype=torch.float64, device=device)
    hi = torch.as_tensor(hi, dtype=torch.float64, device=device)
    return lo + (hi - lo) * torch.rand(shape, generator=g, device=device,
                                       dtype=torch.float64)


def render_gaussians(points: torch.Tensor, shape, cov, amplitude: float,
                     device) -> torch.Tensor:
    """Sum of Gaussians exp(-d^T cov^-1 d / 2) * amplitude at float (z, y,
    x) `points` into a float32 volume of `shape`; `cov` is a 3 x 3
    covariance (voxels^2) shared by all beads."""
    cov = np.asarray(cov, np.float64)
    r = int(math.ceil(3.0 * math.sqrt(float(np.max(np.diag(cov))))))
    ax = torch.arange(-r, r + 1, device=device, dtype=torch.int64)
    offs = torch.stack(torch.meshgrid(ax, ax, ax, indexing="ij"),
                       dim=-1).reshape(-1, 3)
    pts = points.to(device=device, dtype=torch.float64)
    idx = torch.round(pts).to(torch.int64)[:, None, :] + offs[None]
    d = idx.to(torch.float64) - pts[:, None, :]
    prec = torch.as_tensor(np.linalg.inv(cov), device=device)
    q = torch.einsum("bki,ij,bkj->bk", d, prec, d)
    val = amplitude * torch.exp(-0.5 * q)
    dims = torch.as_tensor(shape, device=device)
    inside = ((idx >= 0) & (idx < dims)).all(dim=-1)
    flat = (idx[..., 0] * shape[1] + idx[..., 1]) * shape[2] + idx[..., 2]
    vol = torch.zeros(int(np.prod(shape)), dtype=torch.float64,
                      device=device)
    vol.index_put_((flat[inside],), val[inside], accumulate=True)
    return vol.view(tuple(shape)).to(torch.float32)


def fft_blur(vol: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """Circular convolution of `vol` with a centred kernel (beads sit
    further than the kernel's half-width from every face)."""
    k = torch.as_tensor(np.asarray(kernel, np.float32), device=vol.device)
    kp = torch.zeros(vol.shape, dtype=torch.float32, device=vol.device)
    kp[:k.shape[0], :k.shape[1], :k.shape[2]] = k
    kp = torch.roll(kp, [-(s // 2) for s in k.shape], dims=(0, 1, 2))
    out = torch.fft.irfftn(torch.fft.rfftn(vol) * torch.fft.rfftn(kp),
                           s=vol.shape)
    return out.to(torch.float32)


def ramp_1d(n: int, range_px: float) -> np.ndarray:
    x = np.arange(n, dtype=np.float64)
    dd = np.minimum(x, n - 1 - x)
    return np.where(dd >= range_px, 1.0,
                    (1.0 - np.cos(np.pi * dd / range_px)) * 0.5)


def ramp_weights(shape, n_views: int, range_px: float, binary: bool,
                 device) -> torch.Tensor:
    """(V, Z, Y, X) float32 blending weights, the same for every view:
    the product of cosine ramps over `range_px` from each face, over
    `n_views`. `binary` keeps only where that product is nonzero (the
    bench's form: 1 / n_views inside, 0 on the faces)."""
    r = [torch.as_tensor(ramp_1d(n, range_px), device=device)
         for n in shape]
    prod = r[0][:, None, None] * r[1][None, :, None] * r[2][None, None, :]
    w = (prod > 0).to(torch.float64) if binary else prod
    w = (w / n_views).to(torch.float32)
    return w.expand((n_views,) + tuple(shape)).contiguous()


def gaussian_kernel(size: int, cov) -> np.ndarray:
    """A size^3 Gaussian of covariance `cov` (voxels^2) centred on the
    middle voxel, summing to 1 (float32)."""
    h = size // 2
    g = np.arange(size, dtype=np.float64) - h
    d = np.stack(np.meshgrid(g, g, g, indexing="ij"), axis=-1)
    q = np.einsum("...i,ij,...j->...", d, np.linalg.inv(cov), d)
    k = np.exp(-0.5 * q)
    return (k / k.sum()).astype(np.float32)
