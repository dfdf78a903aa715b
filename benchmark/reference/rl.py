"""Plain multi-view Richardson-Lucy, the reference of the RL cells.

Efficient-Bayesian multi-view deconvolution (Preibisch et al., Nat Methods
11:645, 2014) with sequential (OSEM) view updates, written from the paper
and the port's documented semantics in plain torch, float32, with exact
FFT convolutions and no kernels, cache or batching. It imports nothing of
the port and takes nothing the port made: it works out the compound
kernels and the starting estimate again from the images, weights and PSFs
that the benchmark made.

    psi0  = sum_v w_v img_v / sum_v w_v  (the mean where no view weighs),
            floored at min_value * mean
    per iteration, per view v:
        q    = clamp(img_v / max(psi (x) P_v, 1e-12), 0, 1e4)
        psi <- psi * (1 + osem * w_v * (q (x) K_v - 1))
        psi <- max(psi / (1 + lambda psi), min_value * mean)

with `(x)` a convolution under the mirror boundary (reflection without
repeating the edge sample) and K_v = P_v* . prod_{w != v} (P_v* (x) P_w
(x) P_w*), each term cropped to P_v's support, clamped at 0 and
renormalised to sum 1 (`*` mirrors the kernel through its centre).

`round_to` makes the control: the same arithmetic with every volume it
produces (estimate, both convolutions, quotient) rounded to a lower
precision, the nearest below the one the cell states (`jobs/rl.py`):
bfloat16 below float32, fp8 e4m3 with a per-volume scale below the
lowrank backend's bfloat16.
"""

from __future__ import annotations

import numpy as np
import torch


def smooth_size(n: int) -> int:
    """The next size whose only prime factors are 2, 3, 5 and 7."""
    m = max(int(n), 1)
    while True:
        k = m
        for p in (2, 3, 5, 7):
            while k % p == 0:
                k //= p
        if k == 1:
            return m
        m += 1


def _full_conv(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    shape = [x + y - 1 for x, y in zip(a.shape, b.shape)]
    axes = (0, 1, 2)
    return np.fft.irfftn(np.fft.rfftn(a, shape, axes)
                         * np.fft.rfftn(b, shape, axes), shape, axes)


def conv_same(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The linear convolution of two kernels cropped, centred, to
    a.shape."""
    full = _full_conv(a, b)
    sl = tuple(slice((f - s) // 2, (f - s) // 2 + s)
               for f, s in zip(full.shape, a.shape))
    return full[sl]


def mirror(k: np.ndarray) -> np.ndarray:
    return k[::-1, ::-1, ::-1]


def compound_kernels(psfs, psf_type: str) -> list:
    """K_v for every view (float64)."""
    psfs = [np.asarray(p, np.float64) for p in psfs]
    out = []
    for v, p in enumerate(psfs):
        pm = mirror(p)
        k = pm.copy()
        if psf_type == "efficient_bayesian":
            for w, pw in enumerate(psfs):
                if w != v:
                    k = k * np.maximum(conv_same(conv_same(pm, pw),
                                                 mirror(pw)), 0.0)
        elif psf_type != "independent":
            raise ValueError(f"the reference has no psf_type {psf_type!r}")
        k = np.maximum(k, 0.0)
        out.append(k / k.sum())
    return out


class MirrorConv:
    """Convolution of (Z, Y, X) float32 volumes with one kernel under the
    mirror boundary: reflect-pad by the kernel's half-support, zero-pad to
    smooth FFT sizes, multiply spectra, crop."""

    def __init__(self, kernel: np.ndarray, shape, device):
        self.r = [s // 2 for s in kernel.shape]
        self.shape = tuple(shape)
        self.fft = tuple(smooth_size(n + 2 * r)
                         for n, r in zip(shape, self.r))
        kp = np.zeros(self.fft, np.float64)
        kp[:kernel.shape[0], :kernel.shape[1], :kernel.shape[2]] = kernel
        kp = np.roll(kp, [-r for r in self.r], axis=(0, 1, 2))
        self.spectrum = torch.fft.rfftn(
            torch.as_tensor(kp.astype(np.float32), device=device))

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        rz, ry, rx = self.r
        xp = torch.nn.functional.pad(x[None, None], (rx, rx, ry, ry, rz, rz),
                                     mode="reflect")[0, 0]
        y = torch.fft.irfftn(torch.fft.rfftn(xp, s=self.fft) * self.spectrum,
                             s=self.fft)
        Z, Y, X = self.shape
        return y[rz:rz + Z, ry:ry + Y, rx:rx + X].contiguous()


def round_volume(x: torch.Tensor, dtype) -> torch.Tensor:
    """`x` (float32) rounded to `dtype` and back. An 8-bit float takes a
    per-volume scale (its largest magnitude onto the type's largest
    finite value), as fp8 arithmetic is used."""
    if dtype.itemsize == 1:
        s = float(x.abs().max()) / torch.finfo(dtype).max
        if s > 0:
            return (x / s).to(dtype).to(torch.float32) * s
    return x.to(dtype).to(torch.float32)


def richardson_lucy(images: torch.Tensor, weights: torch.Tensor, psfs,
                    osem: float, iterations: int,
                    psf_type: str = "efficient_bayesian",
                    tikhonov_lambda: float = 0.0006,
                    min_value: float = 0.0001,
                    round_to=None) -> torch.Tensor:
    """The estimate after `iterations` sequential efficient-Bayesian
    iterations (module docstring)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = images.device
    shape = tuple(images.shape[1:])

    def rnd(x):
        return x if round_to is None else round_volume(x, round_to)

    k1 = [MirrorConv(np.asarray(p, np.float64), shape, dev) for p in psfs]
    k2 = [MirrorConv(k, shape, dev)
          for k in compound_kernels(psfs, psf_type)]
    wsum = weights.sum(dim=0, dtype=torch.float64)
    iw = (images.to(torch.float64) * weights).sum(dim=0)
    mean = float(iw.sum() / max(float(wsum.sum()), 1e-9))
    psi = torch.where(wsum > 1e-9, iw / wsum.clamp(min=1e-9),
                      torch.full((), mean, dtype=torch.float64, device=dev))
    floor = float(np.float32(min_value * mean))
    psi = rnd(psi.clamp(min=floor).to(torch.float32))
    del iw, wsum
    for _ in range(iterations):
        for v in range(images.shape[0]):
            c1 = rnd(k1[v](psi))
            q = rnd((images[v] / c1.clamp(min=1e-12)).clamp(0.0, 1e4))
            c2 = rnd(k2[v](q))
            psi = psi * (1.0 + osem * weights[v] * (c2 - 1.0))
            if tikhonov_lambda > 0:
                psi = psi / (1.0 + tikhonov_lambda * psi)
            psi = rnd(psi.clamp(min=floor))
    return psi


def compare(got: torch.Tensor, want: torch.Tensor) -> dict:
    """nrmse (rms difference over the reference's range) and the largest
    difference over that range, in float64."""
    w = want.to(torch.float64)
    d = got.to(w.device, torch.float64) - w
    span = float(w.max() - w.min())
    return {"nrmse": float(torch.sqrt((d * d).mean())) / span,
            "max_err": float(d.abs().max()) / span}
