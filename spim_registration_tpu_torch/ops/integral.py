"""Integral images and box means (Difference-of-Mean support).

Port of the reference's `ops/integral.py`: the DoM response is
mean(box r1) - mean(box r2), r1 < r2 — a cheaper, coarser blob detector
than DoG. The integral image is three chained f32 cumsums and a box sum is
eight shifted slices of it. The cumsums add in another order than XLA's
(a sequential scan here), so responses agree with the reference to f32
rounding of the integral values, not bit for bit.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def integral_image(vol: torch.Tensor) -> torch.Tensor:
    """Zero-padded 3D integral image: I[z,y,x] = sum(vol[:z,:y,:x])."""
    acc = vol.float().cumsum(0).cumsum(1).cumsum(2)
    return F.pad(acc, (1, 0, 1, 0, 1, 0))


def box_mean(vol: torch.Tensor, radius: int) -> torch.Tensor:
    """Mean over a (2r+1)^3 box, clamped at borders (edge-padded)."""
    z, y, x = vol.shape
    r = int(radius)
    padded = F.pad(vol.float()[None, None], (r,) * 6,
                   mode="replicate")[0, 0] if r > 0 else vol.float()
    ii = integral_image(padded)
    s = 2 * r + 1

    def sh(dz, dy, dx):
        return ii[dz:dz + z, dy:dy + y, dx:dx + x]

    total = (sh(s, s, s) - sh(0, s, s) - sh(s, 0, s) - sh(s, s, 0)
             + sh(0, 0, s) + sh(0, s, 0) + sh(s, 0, 0) - sh(0, 0, 0))
    return total / float(s ** 3)


def difference_of_mean(vol: torch.Tensor, r1: int, r2: int) -> torch.Tensor:
    """DoM response (bright blobs positive); r1 < r2."""
    v = vol.float()
    return box_mean(v, r1) - box_mean(v, r2)
