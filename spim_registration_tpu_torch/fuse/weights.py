"""Per-view fusion weights: boundary blending and content-based.

Port of the reference's `fuse/weights.py`. `Blending` is a cosine ramp to
0 near the view boundary: per axis, the distance to the nearer face
(minus a border inset) feeds a half-cosine ramp over `blending_range`
px, and the per-axis factors multiply. `ContentBased` is the local
information measure Gaussian(sigma2) of (I - Gaussian(sigma1) I)^2,
normalized to a maximum of 1. Weights are evaluated in view coordinates.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from spim_registration_tpu_torch.ops.gaussian import gaussian_blur_3d


@dataclasses.dataclass(frozen=True)
class BlendingParameters:
    border: tuple = (0.0, 0.0, 0.0)    # inset of the ramp start, per axis
    blending_range: tuple = (15.0, 15.0, 15.0)  # ramp width in px, per axis


@dataclasses.dataclass(frozen=True)
class ContentBasedParameters:
    sigma1: float = 20.0
    sigma2: float = 40.0


def blending_weight(view_coords: torch.Tensor, view_size,
                    params: BlendingParameters = BlendingParameters()
                    ) -> torch.Tensor:
    """Blending weight at view-space positions (..., 3) for a view of
    `view_size` (z, y, x). Returns (...,) in [0, 1]."""
    w = torch.ones(view_coords.shape[:-1], dtype=view_coords.dtype,
                   device=view_coords.device)
    for ax in range(3):
        c = view_coords[..., ax]
        dist = torch.minimum(c, view_size[ax] - 1 - c) - params.border[ax]
        rng = max(params.blending_range[ax], 1e-6)
        frac = torch.clamp(dist / rng, 0.0, 1.0)
        ramp = 0.5 * (1.0 - torch.cos(frac * math.pi))
        ramp = torch.where(dist <= 0.0, torch.zeros_like(ramp), ramp)
        w = w * ramp
    return w


def content_based_weight(vol: torch.Tensor,
                         params: ContentBasedParameters = ContentBasedParameters()
                         ) -> torch.Tensor:
    """Content-based weight volume in VIEW space (sampled by fusion like
    the image itself)."""
    approx = gaussian_blur_3d(vol, (params.sigma1,) * 3)
    resid = (vol - approx) ** 2
    entropy = gaussian_blur_3d(resid, (params.sigma2,) * 3)
    return entropy / torch.clamp(entropy.max(), min=1e-12)
