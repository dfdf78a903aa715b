"""FFT-based 3D convolution on `torch.fft` (cuFFT on the card).

Port of the reference's `ops/fftconv.py`. The image is expanded by the
kernel half-support with the mirror boundary, the kernel is zero-padded to
the expanded size and circularly shifted so its centre sits at the origin.

FFT sizes are plain 2*3*5*7-smooth. The reference skips 288 and 576 on
large transforms to dodge a nondeterministic XLA-TPU inverse transform;
cuFFT has no such fault, so the port does not carry that list. The
cropped result does not depend on the FFT size as long as the mirror pad
on each side is at least the kernel radius, so the port and the reference
agree at float tolerance with different padded shapes.

`overlap_save_convolve` is the slab form with which the out-of-core and
sharded RL engines convolve halo-extended z-slabs. `direct_convolve` is
the reference's direct form (one `conv3d`); as in the reference, no
engine calls it.
"""

from __future__ import annotations

import numpy as np
import torch

from spim_registration_tpu_torch.ops.gaussian import mirror_pad


def _fft_size(n: int) -> int:
    """Next 2*3*5*7-smooth size (sizes cuFFT transforms with its fast
    radix kernels)."""
    if n <= 1:
        return 1
    m = n
    while True:
        k = m
        for p in (2, 3, 5, 7):
            while k % p == 0:
                k //= p
        if k == 1:
            return m
        m += 1


def fft_shape_for(lengths) -> tuple:
    """Smooth FFT sizes for already-padded lengths."""
    return tuple(_fft_size(int(n)) for n in lengths)


def pad_shape_for(img_shape, kernel_shape) -> tuple:
    """Expanded FFT shape: image + kernel support, rounded to smooth sizes."""
    return fft_shape_for(i + 2 * (k // 2)
                         for i, k in zip(img_shape, kernel_shape))


def prepare_kernel_fft(kernel: torch.Tensor, fft_shape) -> torch.Tensor:
    """Zero-pad kernel to fft_shape, circular-shift centre to origin, rfftn."""
    kp = torch.zeros(tuple(fft_shape), dtype=kernel.dtype,
                     device=kernel.device)
    kp[:kernel.shape[0], :kernel.shape[1], :kernel.shape[2]] = kernel
    kp = torch.roll(kp, [-(k // 2) for k in kernel.shape], dims=(0, 1, 2))
    return torch.fft.rfftn(kp)


def fft_convolve(img: torch.Tensor, kernel: torch.Tensor | None,
                 kernel_fft: torch.Tensor | None = None,
                 fft_shape=None, boundary: str = "mirror") -> torch.Tensor:
    """Convolve img with kernel (same-size output).

    With `kernel_fft`/`fft_shape` precomputed by
    `prepare_kernel_fft(kernel, pad_shape_for(img.shape, kernel.shape))`
    the kernel transform is reused (the per-iteration path in RL)."""
    if fft_shape is None:
        fft_shape = pad_shape_for(img.shape, kernel.shape)
    if kernel_fft is None:
        kernel_fft = prepare_kernel_fft(kernel.to(torch.float32), fft_shape)

    lo = [(fs - s) // 2 for fs, s in zip(fft_shape, img.shape)]
    hi = [fs - s - l for fs, s, l in zip(fft_shape, img.shape, lo)]
    x = img
    for ax in range(3):
        if lo[ax] == 0 and hi[ax] == 0:
            continue
        if boundary == "mirror":
            pad = max(lo[ax], hi[ax])
            x = mirror_pad(x, pad, ax)
            x = x.narrow(ax, pad - lo[ax], img.shape[ax] + lo[ax] + hi[ax])
        else:
            widths = [0] * 6          # F.pad order: last axis first
            widths[2 * (2 - ax)] = lo[ax]
            widths[2 * (2 - ax) + 1] = hi[ax]
            x = torch.nn.functional.pad(x, widths)
    f = torch.fft.rfftn(x)
    out = torch.fft.irfftn(f * kernel_fft, s=x.shape)
    return out[lo[0]:lo[0] + img.shape[0], lo[1]:lo[1] + img.shape[1],
               lo[2]:lo[2] + img.shape[2]].to(img.dtype)


def overlap_save_convolve(x: torch.Tensor, kernel_fft: torch.Tensor, z0: int,
                          n: int, ry: int, rx: int, fft_shape) -> torch.Tensor:
    """Overlap-save convolution of a z-slab `x` read with halo rows: mirror
    padded by (ry, rx) in y/x, zero padded to `fft_shape`, and rows
    [z0, z0 + n) of the circular result, which are the true convolution's
    as long as the kernel's z half-support is at most z0 and at most the
    rows of `x` past z0 + n. `kernel_fft` is `prepare_kernel_fft(kernel,
    fft_shape)`. Returns a crop view (unit innermost stride)."""
    Y, X = x.shape[1], x.shape[2]
    xp = mirror_pad(mirror_pad(x, ry, 1), rx, 2)
    xp = torch.nn.functional.pad(xp, (0, fft_shape[2] - xp.shape[2],
                                      0, fft_shape[1] - xp.shape[1],
                                      0, fft_shape[0] - xp.shape[0]))
    out = torch.fft.irfftn(torch.fft.rfftn(xp) * kernel_fft,
                           s=tuple(fft_shape))
    return out[z0:z0 + n, ry:ry + Y, rx:rx + X]


def direct_convolve(img: torch.Tensor, kernel: torch.Tensor,
                    boundary: str = "mirror") -> torch.Tensor:
    """Direct 3D convolution: `conv3d` (cuDNN on the card) of the volume
    padded by the kernel radius `k // 2` on both sides of each axis, with
    `mirror_pad` or zeros, against the flipped kernel; float32
    accumulation, cast back to img's dtype.

    As in the reference, an even-length kernel axis gives an output one
    longer than the image on that axis. bf16 operands are widened to f32
    (their products are exact there), so the result agrees with the
    reference's bf16 products summed in f32 within one bf16 ulp. TF32 is
    off for the call whatever the global setting, so f32 stays full f32.
    Not a backend of the RL engines (nor in the reference)."""
    r = [k // 2 for k in kernel.shape]
    x = img.to(torch.float32)
    if boundary == "mirror":
        for ax in range(3):
            x = mirror_pad(x, r[ax], ax)
    else:
        x = torch.nn.functional.pad(x, (r[2], r[2], r[1], r[1], r[0], r[0]))
    w = kernel.to(device=x.device, dtype=torch.float32).flip((0, 1, 2))
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        out = torch.nn.functional.conv3d(x[None, None], w[None, None])
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    return out[0, 0].to(img.dtype)


def direct_convolve_np(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """O(N*K) numpy reference for tests (reflect boundary)."""
    from numpy.lib.stride_tricks import sliding_window_view

    r = [k // 2 for k in kernel.shape]
    pad = np.pad(img, [(r[0], kernel.shape[0] - 1 - r[0]),
                       (r[1], kernel.shape[1] - 1 - r[1]),
                       (r[2], kernel.shape[2] - 1 - r[2])], mode="reflect")
    win = sliding_window_view(pad, kernel.shape)
    kf = kernel[::-1, ::-1, ::-1]
    return np.einsum("zyxijk,ijk->zyx", win, kf)
