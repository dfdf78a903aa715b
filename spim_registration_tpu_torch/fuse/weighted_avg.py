"""Weighted-average multi-view fusion.

Port of the reference's `fuse/weighted_avg.py` (`FusionParameters`,
`fuse_views`): for every output voxel in the bounding box, inverse-transform
into each view, interpolate, weight (blending x content) and write
sum(w*v)/sum(w). Per view, on the concrete world->view matrix:
- axis-aligned maps: exact separable trilinear as three matmuls
  (`ops.resample.separable_resample`) with 1D-outer-product blending;
- general affine: 8-corner gathers (`ops.resample.trilinear_sample`).

Output rows go through in z-chunks (~16M voxels unless pinned); each
chunk accumulates all views on the device and is copied to the host.
The reference groups views so its compiled program does not grow with
the view count; eager PyTorch needs no such grouping.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np
import torch

from spim_registration_tpu_torch.core.dataset import BoundingBox
from spim_registration_tpu_torch.fuse.weights import (
    BlendingParameters,
    ContentBasedParameters,
    blending_weight,
    content_based_weight,
)
from spim_registration_tpu_torch.models.affine import apply_affine
from spim_registration_tpu_torch.ops.resample import (
    is_axis_aligned,
    output_grid_coords,
    separable_resample,
    trilinear_sample,
)
from spim_registration_tpu_torch.utils.device import resolve_device

_AUTO_CHUNK_VOXELS = 1 << 24


@dataclasses.dataclass(frozen=True)
class FusionParameters:
    use_blending: bool = True
    use_content_based: bool = False
    blending: BlendingParameters = BlendingParameters()
    content: ContentBasedParameters = ContentBasedParameters()
    downsample: int = 1           # output downsampling factor
    z_chunk: Optional[int] = None  # output z rows per device step (None=auto)
    interpolation: str = "linear"  # linear | nearest


def _ramp_1d(c, size, border, rng_):
    dist = torch.minimum(c, size - 1 - c) - border
    rng_ = max(rng_, 1e-6)
    frac = torch.clamp(dist / rng_, 0.0, 1.0)
    ramp = 0.5 * (1.0 - torch.cos(frac * math.pi))
    return torch.where(dist <= 0.0, torch.zeros_like(ramp), ramp)


def _blending_separable(scale, shift, chunk_shape, view_size,
                        params: BlendingParameters):
    """Blending weight for an axis-aligned view map: the cosine ramp
    separates into three 1D ramps whose outer product is exact."""
    ws = []
    for ax in range(3):
        c = (torch.arange(chunk_shape[ax], dtype=torch.float32,
                          device=scale.device) * scale[ax] + shift[ax])
        ws.append(_ramp_1d(c, view_size[ax], params.border[ax],
                           params.blending_range[ax]))
    return (ws[0][:, None, None] * ws[1][None, :, None]
            * ws[2][None, None, :])


def _view_maps(volumes, models, bbox: BoundingBox, params: FusionParameters,
               device):
    """Per view: (vol tensor, content weight or None, world->view map of
    OUTPUT voxels (3,4) f64, axis-aligned flag)."""
    ds = params.downsample
    views = []
    for vol, model in zip(volumes, models):
        v = torch.as_tensor(np.asarray(vol, np.float32), device=device)
        cw = (content_based_weight(v, params.content)
              if params.use_content_based else None)
        A4 = np.vstack([np.asarray(model, np.float64), [0, 0, 0, 1]])
        # output voxel (i) -> world = bbox.min + ds * i ; then world -> view
        S = np.array([[ds, 0, 0, bbox.min[0]],
                      [0, ds, 0, bbox.min[1]],
                      [0, 0, ds, bbox.min[2]],
                      [0, 0, 0, 1.0]])
        M = (np.linalg.inv(A4) @ S)[:3]
        views.append((v, cw, M, is_axis_aligned(M)))
    return views


def _fuse_chunk(views, z0: int, chunk_shape, params: FusionParameters,
                device) -> torch.Tensor:
    """All views' contributions to one output chunk (rows z0..)."""
    nearest = params.interpolation == "nearest"
    acc_v = torch.zeros(chunk_shape, dtype=torch.float32, device=device)
    acc_w = torch.zeros(chunk_shape, dtype=torch.float32, device=device)
    offset = torch.tensor([float(z0), 0.0, 0.0], device=device)
    grid = None
    for vol, cw, M, aligned in views:
        view_size = tuple(vol.shape)
        if aligned:
            scale = torch.tensor(np.diag(M[:, :3]), dtype=torch.float32,
                                 device=device)
            shift = torch.tensor(M[:, 3], dtype=torch.float32, device=device)
            sh = shift + scale * offset
            vals, inside = separable_resample(vol, scale, sh, chunk_shape,
                                              nearest=nearest)
            w = inside.to(torch.float32)
            if params.use_blending:
                w = w * _blending_separable(scale, sh, chunk_shape,
                                            view_size, params.blending)
            if cw is not None:
                w = w * separable_resample(cw, scale, sh, chunk_shape)[0]
        else:
            if grid is None:
                grid = output_grid_coords(chunk_shape, device=device) \
                    + offset
            inv = torch.as_tensor(M, dtype=torch.float32, device=device)
            vc = apply_affine(inv, grid)
            vals, inside = trilinear_sample(
                vol, torch.round(vc) if nearest else vc)
            w = inside.to(torch.float32)
            if params.use_blending:
                w = w * blending_weight(vc, view_size, params.blending)
            if cw is not None:
                w = w * trilinear_sample(cw, vc)[0]
        acc_v += w * vals
        acc_w += w
    return torch.where(acc_w > 1e-9, acc_v / torch.clamp(acc_w, min=1e-9),
                       torch.zeros((), device=device))


def fuse_views(
    volumes: Sequence[np.ndarray],
    models: Sequence[np.ndarray],
    bbox: BoundingBox,
    params: FusionParameters = FusionParameters(),
    device=None,
) -> np.ndarray:
    """Fuse registered views into the bounding box; returns (Z,Y,X) f32 on
    the host. `models[i]` maps view-i voxel coords to world coords.
    `device`: where the fusion runs (default CUDA; "cpu" to run on the
    host)."""
    dev = resolve_device(device)
    ds = params.downsample
    out_shape = tuple(s // ds for s in bbox.shape)
    if any(s == 0 for s in out_shape):
        raise ValueError(f"empty bounding box {bbox}")
    views = _view_maps(volumes, models, bbox, params, dev)
    out = np.zeros(out_shape, np.float32)
    zc = params.z_chunk or max(
        1, min(out_shape[0], _AUTO_CHUNK_VOXELS
               // max(1, out_shape[1] * out_shape[2])))
    for z0 in range(0, out_shape[0], zc):
        z1 = min(z0 + zc, out_shape[0])
        chunk = _fuse_chunk(views, z0, (z1 - z0,) + out_shape[1:], params,
                            dev)
        out[z0:z1] = chunk.cpu().numpy()
    return out
