"""Plain multi-view Richardson-Lucy streamed through one device, the
reference of a cell whose stack does not fit on one card.

The equations, arithmetic and control rounding of `reference/rl.py`
(whose plain helpers it imports), in plain float32 torch with exact FFT
convolutions under the mirror boundary and TF32 off, sized to fit one
card: the estimate lives on the device; each view's image and weight come
from where the stack is (the host) for its view update, a weight shared
by consecutive views once; each kernel's spectrum is made when it is used
and dropped after; the starting estimate's sums are taken in float64
over z-chunks. `compare` reads a result held as z-blocks on several
devices, in chunks. Imports nothing of the port.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import rl

# z rows a chunk of the starting estimate's sums and of `compare`
CHUNK = 64


def spectrum(kernel: np.ndarray, fft, device) -> torch.Tensor:
    """The spectrum of `kernel` centred on the origin of an `fft`-sized
    grid (`rl.MirrorConv`'s), the kernel placed on the device."""
    kp = torch.zeros(fft, dtype=torch.float32, device=device)
    idx = [torch.as_tensor((np.arange(s) - s // 2) % n, device=device)
           for s, n in zip(kernel.shape, fft)]
    kp[idx[0][:, None, None], idx[1][None, :, None],
       idx[2][None, None, :]] = torch.as_tensor(
        np.asarray(kernel, np.float32), device=device)
    return torch.fft.rfftn(kp)


def mirror_conv(x: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """`rl.MirrorConv(kernel, x.shape, x.device)(x)`, its spectrum made
    for the call alone."""
    rz, ry, rx = (s // 2 for s in kernel.shape)
    fft = tuple(rl.smooth_size(n + 2 * r)
                for n, r in zip(x.shape, (rz, ry, rx)))
    xp = torch.nn.functional.pad(x[None, None], (rx, rx, ry, ry, rz, rz),
                                 mode="reflect")[0, 0]
    f = torch.fft.rfftn(xp, s=fft)
    del xp
    f *= spectrum(kernel, fft, x.device)
    y = torch.fft.irfftn(f, s=fft)
    del f
    Z, Y, X = x.shape
    return y[rz:rz + Z, ry:ry + Y, rx:rx + X].contiguous()


def start(images, weights, min_value: float, device) -> tuple:
    """rl.py's starting estimate (float32, floored) and floor: the sums
    over views in float64, z-chunk by z-chunk."""
    V, Z, Y, X = images.shape
    psi = torch.empty((Z, Y, X), dtype=torch.float32, device=device)
    iw_sum = w_sum = 0.0
    for z0 in range(0, Z, CHUNK):
        z1 = min(z0 + CHUNK, Z)
        wsum = iw = None
        for v in range(V):
            w = weights[v, z0:z1].to(device, torch.float64)
            t = images[v, z0:z1].to(device, torch.float64) * w
            wsum = w if wsum is None else wsum + w
            iw = t if iw is None else iw + t
        iw_sum += float(iw.sum())
        w_sum += float(wsum.sum())
        # NaN marks where no view weighs: the mean, once it is known
        psi[z0:z1] = torch.where(wsum > 1e-9, iw / wsum.clamp(min=1e-9),
                                 float("nan")).to(torch.float32)
    mean = iw_sum / max(w_sum, 1e-9)
    floor = float(np.float32(min_value * mean))
    psi = torch.where(torch.isnan(psi), float(np.float32(mean)), psi)
    return psi.clamp(min=floor), floor


def richardson_lucy(images, weights, psfs, osem: float, iterations: int,
                    psf_type: str = "efficient_bayesian",
                    tikhonov_lambda: float = 0.0006,
                    min_value: float = 0.0001, round_to=None,
                    device=None) -> torch.Tensor:
    """`rl.richardson_lucy` on (V, Z, Y, X) `images` and `weights` held
    anywhere (the host), with the estimate on `device` (default: the
    images' device)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device) if device is not None else images.device

    def rnd(x):
        return x if round_to is None else rl.round_volume(x, round_to)

    k1 = [np.asarray(p, np.float64) for p in psfs]
    k2 = rl.compound_kernels(psfs, psf_type)
    psi, floor = start(images, weights, min_value, dev)
    psi = rnd(psi)
    held = [None, None]             # the weight on the device, its source

    def weight(v):
        src = weights[v]
        key = (src.data_ptr(), src.stride(), src.shape)
        if held[1] != key:
            held[0] = None
            held[0], held[1] = src.to(dev, non_blocking=True), key
        return held[0]

    for _ in range(iterations):
        for v in range(images.shape[0]):
            img = images[v].to(dev, non_blocking=True)
            c1 = rnd(mirror_conv(psi, k1[v]))
            q = rnd((img / c1.clamp(min=1e-12)).clamp(0.0, 1e4))
            del c1, img
            c2 = rnd(mirror_conv(q, k2[v]))
            del q
            psi = psi * (1.0 + osem * weight(v) * (c2 - 1.0))
            del c2
            if tikhonov_lambda > 0:
                psi = psi / (1.0 + tikhonov_lambda * psi)
            psi = rnd(psi.clamp(min=floor))
    return psi


def compare(got, want: torch.Tensor, seams=()) -> dict:
    """`rl.compare`'s nrmse and max_err of `got` against `want` (Z, Y,
    X), in float64 over z-chunks, where `got` is a tensor or a list of
    z-blocks in order (on any devices; rows past Z are left out); with
    `seams`, (start, stop) row ranges, also `nrmse_seams`: the rms
    difference over those rows, over the same range."""
    blocks = [got] if isinstance(got, torch.Tensor) else list(got)
    Z = want.shape[0]
    span = float(want.max().double() - want.min().double())
    in_seam = torch.zeros(Z, dtype=torch.bool)
    for s, e in seams:
        in_seam[max(s, 0):min(e, Z)] = True
    sq = sq_seam = 0.0
    n = n_seam = 0
    worst = 0.0
    z0 = 0
    for b in blocks:
        for c0 in range(0, b.shape[0], CHUNK):
            lo = z0 + c0
            hi = min(lo + min(CHUNK, b.shape[0] - c0), Z)
            if hi <= lo:
                break
            w = want[lo:hi].double()
            d = b[c0:c0 + hi - lo].to(w.device, torch.float64) - w
            d2 = (d * d).sum(dim=(1, 2))
            sq += float(d2.sum())
            n += d.numel()
            worst = max(worst, float(d.abs().max()))
            rows = in_seam[lo:hi].to(d2.device)
            sq_seam += float(d2[rows].sum())
            n_seam += int(rows.sum()) * d.shape[1] * d.shape[2]
        z0 += b.shape[0]
    out = {"nrmse": (sq / n) ** 0.5 / span, "max_err": worst / span}
    if seams:
        out["nrmse_seams"] = (sq_seam / max(n_seam, 1)) ** 0.5 / span
    return out
