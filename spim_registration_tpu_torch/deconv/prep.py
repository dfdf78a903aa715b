"""Deconvolution input preparation.

Port of the reference's `deconv/prep.py`: transform each view and its
blending weights into the bounding-box grid, normalize the per-voxel
weight sum across views, and compute the OSEM acceleration factor (the
average number of views covering a voxel). Images and weights stay on
the device as tensors, where the RL engine reads them.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from spim_registration_tpu_torch.core.dataset import BoundingBox
from spim_registration_tpu_torch.fuse.weights import (
    BlendingParameters,
    blending_weight,
)
from spim_registration_tpu_torch.models.affine import apply_affine
from spim_registration_tpu_torch.ops.resample import (
    output_grid_coords,
    trilinear_sample,
)
from spim_registration_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class DeconvolutionViews:
    """Aligned inputs for the RL engine: everything on the bbox grid."""

    images: torch.Tensor   # (V, Z, Y, X) transformed view images
    weights: torch.Tensor  # (V, Z, Y, X) normalized weights (sum_v <= 1)
    psfs: List[np.ndarray]  # per-view world-oriented PSFs
    osem_factor: float     # OSEM speedup (avg overlapping views)
    # optional per-view exact CP factor banks (az, ay, ax) of `psfs`
    # (condition_psf(return_factors=True)); the lowrank conv uses them
    psf_factors: Optional[List] = None


def prepare_views_for_deconvolution(
    volumes: Sequence[np.ndarray],
    models: Sequence[np.ndarray],
    psfs: Sequence[np.ndarray],
    bbox: BoundingBox,
    blending: BlendingParameters = BlendingParameters(
        border=(0.0, 0.0, 0.0), blending_range=(40.0, 40.0, 40.0)),
    osem_factor: Optional[float] = None,
    device=None,
) -> DeconvolutionViews:
    """Transform views + weights into the bbox grid (a 40 px blending ramp
    by default, as the reference uses for deconvolution). `device`: where
    the views are resampled and kept (default CUDA; "cpu" for the host)."""
    dev = resolve_device(device)
    grid = output_grid_coords(bbox.shape, offset=bbox.min, device=dev)

    imgs, ws = [], []
    for vol, model in zip(volumes, models):
        A4 = np.vstack([np.asarray(model, np.float64), [0, 0, 0, 1]])
        inv = torch.as_tensor(np.linalg.inv(A4)[:3], dtype=torch.float32,
                              device=dev)
        vc = apply_affine(inv, grid)
        vals, inside = trilinear_sample(
            torch.as_tensor(np.asarray(vol, np.float32), device=dev), vc)
        imgs.append(vals)
        ws.append(inside.to(torch.float32)
                  * blending_weight(vc, np.shape(vol), blending))
        del vc

    images = torch.stack(imgs)
    raw = torch.stack(ws)
    del imgs, ws
    wsum = raw.sum(dim=0)
    # normalize so weights of overlapping views sum to 1 where covered
    weights = torch.where(wsum > 1e-9, raw / torch.clamp(wsum, min=1e-9),
                          torch.zeros((), device=dev))

    if osem_factor is None:
        covered = (raw > 1e-9).sum(dim=0)
        osem_factor = (float(covered[covered > 0].double().mean())
                       if bool((covered > 0).any()) else 1.0)

    return DeconvolutionViews(
        images=images,
        weights=weights,
        psfs=[np.asarray(p, np.float32) for p in psfs],
        osem_factor=osem_factor,
    )
