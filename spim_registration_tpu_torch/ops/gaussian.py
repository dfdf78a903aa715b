"""Separable 3D Gaussian smoothing and Difference-of-Gaussian.

Port of the reference's `ops/gaussian.py` (`gaussian_kernel_1d`,
`mirror_pad`, `conv_axis_valid`, `gaussian_blur_3d`, `dog_sigmas`,
`difference_of_gaussian`, `difference_of_gaussian_bf16`). Each axis
convolution is a matmul of the (other axes x axis) view with a banded
convolution matrix, as in the reference (plain products, left to cuBLAS
as the reference left them to XLA). Mirror padding is ImgLib's "single
boundary" mirror (the edge sample is not repeated).
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
                    axis: int, accum_dtype=None) -> torch.Tensor:
    """'valid' 1D correlation along `axis` via a banded matrix matmul:
    out[i] = sum_j x[i + j] k[j]; length n_in - 2r for 2r+1 taps.

    `accum_dtype` (the reference's `preferred_element_type`): the matrix
    is built in x's dtype, both operands are widened to `accum_dtype` and
    multiplied there, and the output stays in `accum_dtype`. For bf16
    inputs and float32 this equals a bf16 MMA accumulating in f32: a
    product of two bf16 values is exact in f32 (`torch.matmul` on bf16
    would round its output to bf16)."""
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
    if accum_dtype is not None:
        xm, C = xm.to(accum_dtype), C.to(accum_dtype)
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


def dog_sigmas(sigma: float, threshold: float, k: float | None = None,
               steps_per_octave: int = 4):
    """The reference's DoG parameterization: sigma1 = sigma, sigma2 =
    sigma * k with k = 2^(1/steps), and the response normalization
    1/(k-1). Returns (sigma1, sigma2, norm)."""
    if k is None:
        k = 2.0 ** (1.0 / steps_per_octave)
    return sigma, sigma * k, 1.0 / (k - 1.0)


def _per_axis(s) -> tuple:
    return tuple(s) if isinstance(s, (tuple, list)) else (s,) * 3


def difference_of_gaussian_bf16(vol: torch.Tensor, sigma1,
                                sigma2) -> torch.Tensor:
    """DoG with bf16 matmul inputs and f32 accumulation, restructured so
    no large-value cancellation happens in reduced precision:

        DoG = Z1 Y1 (X1-X2) + Z1 (Y1-Y2) X2 + (Z1-Z2) Y2 X2

    Each chain applies its difference kernel first, so every
    intermediate is already DoG-scale. Inputs re-round to bf16 per pass;
    9 banded matmuls. Returns float32."""
    ks1 = [gaussian_kernel_1d(float(s), np.float64) for s in _per_axis(sigma1)]
    ks2 = [gaussian_kernel_1d(float(s), np.float64) for s in _per_axis(sigma2)]

    def diff_kernel(a, b):  # a - b, centered on the longer support
        if a.shape[0] < b.shape[0]:
            p = (b.shape[0] - a.shape[0]) // 2
            a = np.pad(a, (p, p))
        elif b.shape[0] < a.shape[0]:
            p = (a.shape[0] - b.shape[0]) // 2
            b = np.pad(b, (p, p))
        return a - b

    bf = torch.bfloat16

    def conv(x, k_np, axis):
        if k_np.shape[0] == 1:
            return (x.float() * np.float32(k_np[0])
                    if k_np[0] != 1.0 else x.float())
        k = torch.from_numpy(k_np).to(device=x.device).to(bf)
        r = (k.shape[0] - 1) // 2
        return conv_axis_valid(mirror_pad(x.to(bf), r, axis), k, axis,
                               accum_dtype=torch.float32)

    dkz, dky, dkx = (diff_kernel(a, b) for a, b in zip(ks1, ks2))
    v = vol.to(bf)
    c = conv(v, ks2[2], 2)                       # X2 v   (image-scale)
    t3 = conv(conv(c, ks2[1], 1), dkz, 0)        # dZ Y2 X2 v
    t2 = conv(conv(c, dky, 1), ks1[0], 0)        # Z1 dY X2 v
    a1 = conv(v, dkx, 2)                         # dX v   (DoG-scale)
    t1 = conv(conv(a1, ks1[1], 1), ks1[0], 0)    # Z1 Y1 dX v
    return (t1 + t2 + t3).float()


def difference_of_gaussian(vol: torch.Tensor, sigma1,
                           sigma2) -> torch.Tensor:
    """DoG response = blur(sigma1) - blur(sigma2) (bright blobs positive);
    each sigma a scalar or per-axis (sz, sy, sx)."""
    return (gaussian_blur_3d(vol, _per_axis(sigma1))
            - gaussian_blur_3d(vol, _per_axis(sigma2)))
