"""Separable 3D Gaussian smoothing and the mirror boundary.

Port of the reference's `ops/gaussian.py` (`gaussian_kernel_1d`,
`mirror_pad`, `conv_axis_valid`, `gaussian_blur_3d`). Each axis
convolution is a matmul of the (other axes x axis) view with a banded
convolution matrix, as in the reference. Mirror padding is ImgLib's
"single boundary" mirror (the edge sample is not repeated). The
difference-of-Gaussian detector comes with the detection slice.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def gaussian_kernel_1d(sigma: float, dtype=np.float32) -> np.ndarray:
    """Sampled, normalized 1D Gaussian of radius max(1, ceil(3 sigma))."""
    if sigma <= 0:
        return np.ones((1,), dtype=dtype)
    radius = max(1, int(math.ceil(3.0 * sigma)))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k /= k.sum()
    return k.astype(dtype)


def mirror_pad(x: torch.Tensor, pad: int, axis: int) -> torch.Tensor:
    """Mirror padding without repeating the edge sample."""
    if pad == 0:
        return x
    n = x.shape[axis]
    if pad > n - 1:
        # symmetric tiling for very small axes
        reps = int(math.ceil(pad / max(n - 1, 1))) + 1
        for _ in range(reps):
            x = mirror_pad(x, min(pad, x.shape[axis] - 1), axis)
            if x.shape[axis] >= n + 2 * pad:
                break
        start = (x.shape[axis] - (n + 2 * pad)) // 2
        return x.narrow(axis, start, n + 2 * pad)
    lo = x.narrow(axis, 1, pad).flip(axis)
    hi = x.narrow(axis, n - pad - 1, pad).flip(axis)
    return torch.cat([lo, x, hi], dim=axis)


def conv_axis_valid(x: torch.Tensor, kernel: torch.Tensor,
                    axis: int) -> torch.Tensor:
    """'valid' 1D correlation along `axis` via a banded matrix matmul:
    out[i] = sum_j x[i + j] k[j]; length n_in - 2r for 2r+1 taps."""
    r = (kernel.shape[0] - 1) // 2
    n_in = x.shape[axis]
    n_out = n_in - 2 * r
    i = torch.arange(n_out, device=x.device)[:, None]
    j = torch.arange(n_in, device=x.device)[None, :]
    band = j - i
    C = torch.where((band >= 0) & (band <= 2 * r),
                    kernel.to(x.dtype)[band.clamp(0, 2 * r)],
                    torch.zeros((), dtype=x.dtype, device=x.device))
    xm = x.movedim(axis, -1)
    return (xm @ C.T).movedim(-1, axis)


def gaussian_blur_3d(vol: torch.Tensor, sigmas) -> torch.Tensor:
    """Separable Gaussian blur with mirror boundary; `sigmas` = (sz, sy, sx)."""
    out = vol
    for axis, s in enumerate(sigmas):
        k = torch.as_tensor(gaussian_kernel_1d(float(s)), dtype=vol.dtype,
                            device=vol.device)
        if k.shape[0] > 1:
            r = (k.shape[0] - 1) // 2
            out = conv_axis_valid(mirror_pad(out, r, axis), k, axis)
    return out
