"""Plain content-based multi-view fusion, the reference of the fuse cell.

Weighted-average fusion with cosine blending and content-based weights
(Preibisch, Saalfeld, Rohlfing & Tomancak 2008, Proc. SPIE 6914:69140E),
written from the paper and the port's documented semantics in plain
torch: float32 views, float64 coordinates and weights, no chunk plan, no
separable path, no kernels. It imports nothing of the port. For each
output voxel i of the box:

    world     = box.min + i
    c_v       = A_v^-1 world                (view v's own frame)
    value_v   = trilinear sample of view v at c_v, 0 outside [0, n - 1]
    blend_v   = prod over axes of 0.5 (1 - cos(pi frac)),
                frac = clamp((min(c, n - 1 - c) - border) / range, 0, 1),
                0 where min(c, n - 1 - c) - border <= 0
    content_v = trilinear sample of C_v at c_v
    w_v       = blend_v content_v
    fused     = sum_v w_v value_v / sum_v w_v where sum_v w_v > 1e-9, else 0

The content weight of a view I is C = G_s2 * (I - G_s1 * I)^2 (the 2008
definition), each G a separable Gaussian sampled at the integers,
truncated at max(1, ceil(3 s)) and normalised to sum 1, under the mirror
boundary (reflection that does not repeat the edge sample, periodic where
the half-width passes the axis). As the port does, C is divided by its
maximum over the view, so that the weights of views with more structure
count for more only through their content. Each 1-D blur is a float64
FFT of a batch of rows, rounded to float32 between axes.

`round_to` makes the control: the views, and the content weights made
from them, stored in a lower precision (bfloat16 below float32) and
sampled from there.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# a voxel's summed weight below which its quotient is ill-conditioned:
# its only weights are blending ramps within ~0.02 px of a view's face,
# where the float32 ramp 0.5 (1 - cos(pi frac)) has lost most of its
# digits, and the port and the reference fall on either side of the 1e-9
# cut (ROADMAP queue 3 item 12); the comparison leaves such voxels out
WEIGHT_FLOOR = 1e-6
# the cut below which a voxel's sum of weights writes 0
WEIGHT_CUT = 1e-9


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


def maximal_box(shape, models) -> tuple:
    """The smallest integer box (min, max exclusive) that holds every
    view's corners in the world: floor of the least corner, ceil of the
    greatest plus one."""
    z, y, x = (float(n) - 1.0 for n in shape)
    corners = np.array([[a, b, c] for a in (0.0, z) for b in (0.0, y)
                        for c in (0.0, x)])
    pts = np.concatenate([corners @ np.asarray(A, np.float64)[:, :3].T
                          + np.asarray(A, np.float64)[:, 3]
                          for A in models])
    lo = np.floor(pts.min(axis=0)).astype(int)
    hi = np.ceil(pts.max(axis=0)).astype(int) + 1
    return tuple(int(v) for v in lo), tuple(int(v) for v in hi)


def gaussian_taps(sigma: float) -> np.ndarray:
    r = max(1, int(math.ceil(3.0 * sigma)))
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def reflect_index(n: int, r: int, device) -> torch.Tensor:
    """Indices of an axis of length n extended by r on each side by
    reflection without repeating the edge sample (periodic in 2 (n - 1))."""
    k = torch.arange(-r, n + r, device=device)
    if n == 1:
        return torch.zeros_like(k)
    period = 2 * (n - 1)
    m = torch.remainder(k, period)
    return torch.where(m >= n, period - m, m)


def blur_axis(x: torch.Tensor, taps: np.ndarray, axis: int,
              batch_bytes: int = 1 << 29) -> torch.Tensor:
    """`x` (float32) blurred along `axis` by the centred `taps`, mirror
    boundary; float64 FFTs over batches of rows."""
    n = x.shape[axis]
    r = (len(taps) - 1) // 2
    L = n + 2 * r
    Lf = smooth_size(L)
    k = torch.zeros(Lf, dtype=torch.float64, device=x.device)
    k[:len(taps)] = torch.as_tensor(taps, device=x.device)
    kf = torch.fft.rfft(k)
    idx = reflect_index(n, r, x.device)
    xm = x.movedim(axis, -1)
    out = torch.empty_like(x)
    om = out.movedim(axis, -1)
    rows = max(1, batch_bytes // (16 * Lf * max(1, xm[0].numel() // n)))
    for a0 in range(0, xm.shape[0], rows):
        seg = xm[a0:a0 + rows].to(torch.float64).index_select(-1, idx)
        y = torch.fft.irfft(torch.fft.rfft(seg, n=Lf) * kf, n=Lf)
        om[a0:a0 + rows] = y[..., 2 * r:2 * r + n].to(x.dtype)
    return out


def blur_3d(x: torch.Tensor, sigma: float) -> torch.Tensor:
    taps = gaussian_taps(sigma)
    for axis in range(3):
        x = blur_axis(x, taps, axis)
    return x


def content_weight(vol: torch.Tensor, sigma1: float,
                   sigma2: float) -> torch.Tensor:
    """G_s2 * (I - G_s1 * I)^2 over its maximum (float32)."""
    resid = (vol - blur_3d(vol, sigma1)) ** 2
    ent = blur_3d(resid, sigma2)
    del resid
    return ent / ent.max().clamp(min=1e-12)


def trilinear(vol: torch.Tensor, c: list) -> torch.Tensor:
    """`vol` sampled at the float64 view coordinates `c` ([z, y, x], one
    tensor an axis), float64; 0 outside [0, n - 1] on any axis."""
    n = vol.shape
    inside = torch.ones(c[0].shape, dtype=torch.bool, device=vol.device)
    lo, hi, frac = [], [], []
    for k in range(3):
        inside &= (c[k] >= 0) & (c[k] <= n[k] - 1)
        ck = c[k].clamp(0, n[k] - 1)
        f = torch.floor(ck)
        frac.append(ck - f)
        i0 = f.to(torch.int64)
        lo.append(i0)
        hi.append(torch.clamp(i0 + 1, max=n[k] - 1))
    strides = (n[1] * n[2], n[2], 1)
    flat = vol.reshape(-1)
    out = torch.zeros(c[0].shape, dtype=torch.float64, device=vol.device)
    for corner in range(8):
        bits = [(corner >> (2 - k)) & 1 for k in range(3)]
        idx = sum((hi[k] if b else lo[k]) * strides[k]
                  for k, b in enumerate(bits))
        w = 1.0
        for k, b in enumerate(bits):
            w = w * (frac[k] if b else 1.0 - frac[k])
        out += w * flat[idx].to(torch.float64)
    return torch.where(inside, out, torch.zeros((), dtype=out.dtype,
                                                device=out.device))


def blend(c: list, shape, rng, border) -> torch.Tensor:
    """The product over axes of the cosine ramps at view coordinates `c`
    (float64)."""
    w = None
    for k in range(3):
        d = torch.minimum(c[k], (shape[k] - 1) - c[k]) - float(border[k])
        frac = (d / max(float(rng[k]), 1e-6)).clamp(0.0, 1.0)
        ramp = 0.5 * (1.0 - torch.cos(math.pi * frac))
        ramp = torch.where(d <= 0, torch.zeros_like(ramp), ramp)
        w = ramp if w is None else w * ramp
    return w


class Fusion:
    """The reference's views, their content weights and world-to-view
    maps on `device`, fused slab by slab into the box [lo, hi).

    `params`: the configuration's `fusion` group (`blending_range`,
    `border`, `use_content_based`, `sigma1`, `sigma2`)."""

    def __init__(self, views, models, lo, hi, params: dict, device,
                 round_to=None):
        self.device = torch.device(device)
        self.lo = tuple(int(v) for v in lo)
        self.shape = tuple(int(b) - int(a) for a, b in zip(lo, hi))
        self.range = params["blending_range"]
        self.border = params["border"]
        self.views = []
        for vol, A in zip(views, models):
            v = torch.as_tensor(vol).to(self.device, torch.float32)
            if round_to is not None:
                v = v.to(round_to).to(torch.float32)
            cw = (content_weight(v, params["sigma1"], params["sigma2"])
                  if params["use_content_based"] else None)
            if round_to is not None:
                v = v.to(round_to)
                cw = None if cw is None else cw.to(round_to)
            A4 = np.vstack([np.asarray(A, np.float64), [0, 0, 0, 1]])
            self.views.append((v, cw, np.linalg.inv(A4)[:3]))

    def slab(self, z0: int, z1: int) -> tuple:
        """(fused float32, summed weight float64) of output rows z0..z1."""
        dev, f64 = self.device, torch.float64
        _, Y, X = self.shape
        axes = [torch.arange(a, b, dtype=f64, device=dev) + o
                for a, b, o in ((z0, z1, self.lo[0]), (0, Y, self.lo[1]),
                                (0, X, self.lo[2]))]
        world = [axes[0][:, None, None], axes[1][None, :, None],
                 axes[2][None, None, :]]
        acc_v = torch.zeros((z1 - z0, Y, X), dtype=f64, device=dev)
        acc_w = torch.zeros_like(acc_v)
        for v, cw, inv in self.views:
            c = [(world[0] * float(inv[k, 0]) + world[1] * float(inv[k, 1])
                  + world[2] * float(inv[k, 2]) + float(inv[k, 3])
                  ).expand(acc_v.shape) for k in range(3)]
            w = blend(c, v.shape, self.range, self.border)
            if cw is not None:
                w = w * trilinear(cw, c)
            acc_v += w * trilinear(v, c)
            acc_w += w
        fused = torch.where(acc_w > WEIGHT_CUT,
                            acc_v / acc_w.clamp(min=WEIGHT_CUT),
                            torch.zeros((), dtype=f64, device=dev))
        return fused.to(torch.float32), acc_w

    def slabs(self, voxels: int = 1 << 23):
        """(z0, z1, fused, summed weight) over the box, slab by slab."""
        Z, Y, X = self.shape
        dz = max(1, voxels // (Y * X))
        for z0 in range(0, Z, dz):
            z1 = min(Z, z0 + dz)
            yield (z0, z1) + self.slab(z0, z1)


class Comparison:
    """An answer against the reference, slab by slab, over the box's
    voxels whose reference summed weight is 0 or at least `WEIGHT_FLOOR`:
    `nrmse`, the rms difference over the reference's range, and
    `max_err`, the largest difference over that range. The voxels left
    out (summed weight in (0, WEIGHT_FLOOR)) are a thin shell on the
    views' faces whose quotient is ill-conditioned: the few of them that
    fall on either side of the 1e-9 cut differ by their whole value,
    which would outweigh in the rms everything else that the comparison
    can see. Where they are more than `max_left_out` of the box, the
    comparison sees too little of it and both numbers read NaN; so they
    do for an answer with a voxel that is not finite, anywhere in the
    box."""

    def __init__(self, max_left_out: float):
        self.max_left_out = max_left_out
        self.n = self.left_out = 0
        self.ss = self.max_abs = 0.0
        self.lo, self.hi = math.inf, -math.inf
        self.finite = True

    def add(self, got: torch.Tensor, want: torch.Tensor,
            wsum: torch.Tensor) -> None:
        d = got.to(want.device, torch.float64) - want.to(torch.float64)
        self.finite &= bool(torch.isfinite(d).all())
        out = (wsum > 0) & (wsum < WEIGHT_FLOOR)
        d = torch.where(out, torch.zeros_like(d), d)
        self.n += d.numel()
        self.left_out += int(out.sum())
        self.ss += float((d * d).sum())
        self.max_abs = max(self.max_abs, float(d.abs().max()))
        self.lo = min(self.lo, float(want.min()))
        self.hi = max(self.hi, float(want.max()))

    def left_out_share(self) -> float:
        return self.left_out / self.n

    def numbers(self) -> dict:
        span = self.hi - self.lo
        kept = self.n - self.left_out
        seen = self.finite and self.left_out_share() <= self.max_left_out
        bad = 0.0 if seen else math.nan
        return {"nrmse": math.sqrt(self.ss / max(kept, 1)) / span + bad,
                "max_err": self.max_abs / span + bad}
