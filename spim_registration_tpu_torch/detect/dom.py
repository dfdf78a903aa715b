"""Difference-of-Mean interest-point detection (integral-image variant).

Port of the reference's `detect/dom.py` (ImgLib1 `ProcessDOM` / headless
`DoM`): box means with radii r1 < r2 on an integral image, then the same
peak machinery as the DoG (`ops.extrema.find_peaks`, `subpixel_localize`);
faster and coarser than DoG.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from spim_registration_tpu_torch.ops.downsample import (
    downsample,
    upscale_coords,
)
from spim_registration_tpu_torch.ops.extrema import (
    find_peaks,
    subpixel_localize,
)
from spim_registration_tpu_torch.ops.integral import difference_of_mean
from spim_registration_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class DoMParameters:
    """Reference GUI defaults: radius1=2, radius2=3, threshold ~0.005."""

    radius1: int = 2
    radius2: int = 3
    threshold: float = 0.005
    max_peaks: int = 8192
    find_minima: bool = False
    downsample_xy: int = 1
    downsample_z: int = 1
    normalize: bool = True


def detect_beads_dom(vol, params: DoMParameters = DoMParameters(),
                     device=None):
    """DoM detection of one view volume (numpy or tensor); returns
    (points (N, 3) float32 full-res (z, y, x), responses (N,)) valid rows.
    Runs on CUDA unless `device` names another device."""
    dev = resolve_device(device)
    v = torch.as_tensor(vol).to(dev).float()
    if params.normalize:
        lo, hi = v.min(), v.max()
        v = (v - lo) / torch.clamp(hi - lo, min=1e-12)
    factors = (params.downsample_z, params.downsample_xy,
               params.downsample_xy)
    if any(f > 1 for f in factors):
        v = downsample(v, factors)
    dom = difference_of_mean(v, params.radius1, params.radius2)
    coords, _, valid = find_peaks(dom, params.threshold, params.max_peaks,
                                  params.find_minima)
    pos, val, ok = subpixel_localize(dom, coords, valid)
    pos = upscale_coords(pos, factors)
    keep = ok.cpu().numpy()
    return (pos.cpu().numpy()[keep].astype(np.float32),
            val.cpu().numpy()[keep].astype(np.float32))
