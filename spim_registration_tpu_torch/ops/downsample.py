"""Downsampling for detection (per-axis powers of two).

Port of the reference's `ops/downsample.py`: each halving step averages 2
adjacent samples along one axis (not a strided subsample), and the z, y
and x factors are chosen independently.
"""

from __future__ import annotations

import torch


def _halve_axis(x: torch.Tensor, axis: int) -> torch.Tensor:
    n = x.shape[axis] - (x.shape[axis] % 2)
    x = x.narrow(axis, 0, n)
    idx_a = torch.arange(0, n, 2, device=x.device)
    a = x.index_select(axis, idx_a)
    b = x.index_select(axis, idx_a + 1)
    return 0.5 * (a + b)


def downsample(vol: torch.Tensor, factors) -> torch.Tensor:
    """Downsample by per-axis power-of-two `factors` = (fz, fy, fx)."""
    out = vol
    for axis, f in enumerate(factors):
        if f & (f - 1):
            raise ValueError(f"downsample factor {f} is not a power of two")
        while f > 1:
            out = _halve_axis(out, axis)
            f //= 2
    return out


def upscale_coords(coords: torch.Tensor, factors) -> torch.Tensor:
    """Map detected (z, y, x) coords in downsampled space back to full
    resolution: s halvings per axis give scale f and offset (f - 1) / 2."""
    f = torch.as_tensor(factors, dtype=coords.dtype, device=coords.device)
    return coords * f + (f - 1.0) * 0.5
