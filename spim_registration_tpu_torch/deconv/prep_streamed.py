"""Streamed (out-of-core) deconvolution input preparation.

Port of the reference's `deconv/prep_streamed.py`
(`ProcessForDeconvolution#fuseStacksAndGetPSFs` for volumes whose
transformed views do not fit in host or device memory): the transform and
blending-weight math of `deconv.prep.prepare_views_for_deconvolution`, run
per z-slab of the bounding box with one source view resident at a time,
writing per-view image/weight `RawVolumeStore`s. The result plugs into
`BlockedDeconvolutionRunner` (CLI `deconvolve --out-of-core`).

Two passes:
  1. per view: transform + raw blending weight per slab -> img_v / w_v
     stores; accumulate the weight-sum store and the coverage count (for
     the OSEM factor);
  2. per slab: normalize every view's weights by the weight sum
     (sum_v w_v <= 1 where covered, as the in-memory prep) and count
     covered voxels.

Disk footprint: (2V + 1) float32 volumes under `workdir`.
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from spim_registration_tpu_torch.core.dataset import BoundingBox
from spim_registration_tpu_torch.deconv.blocked import (
    BlockedDeconvolutionInputs,
)
from spim_registration_tpu_torch.fuse.weights import (
    BlendingParameters,
    blending_weight,
)
from spim_registration_tpu_torch.models.affine import apply_affine
from spim_registration_tpu_torch.native_blocks import RawVolumeStore
from spim_registration_tpu_torch.ops.resample import (
    output_grid_coords,
    trilinear_sample,
)
from spim_registration_tpu_torch.utils.device import resolve_device


def prepare_views_streamed(
    get_volume: Callable[[int], np.ndarray],
    models: Sequence[np.ndarray],
    psfs: Sequence[np.ndarray],
    bbox: BoundingBox,
    workdir: str,
    blending: BlendingParameters = BlendingParameters(
        border=(0.0, 0.0, 0.0), blending_range=(40.0, 40.0, 40.0)),
    slab_z: int = 64,
    osem_factor: Optional[float] = None,
    psf_factors: Optional[List] = None,
    device=None,
) -> BlockedDeconvolutionInputs:
    """Build disk-resident `BlockedDeconvolutionInputs` for `bbox`.

    `get_volume(v)` loads source view v (called once; only one source
    view plus one output slab are resident at a time). Matches
    `prepare_views_for_deconvolution` voxel for voxel. `device`: where
    the slabs are resampled (default CUDA; "cpu" for the host)."""
    dev = resolve_device(device)
    os.makedirs(workdir, exist_ok=True)
    Z, Y, X = bbox.shape
    shape = (Z, Y, X)
    V = len(models)

    def store(name):
        return RawVolumeStore(os.path.join(workdir, name), shape,
                              create=True)

    img_stores = [store(f"prep_img{v}.raw") for v in range(V)]
    w_stores = [store(f"prep_w{v}.raw") for v in range(V)]
    wsum = store("prep_wsum.raw")
    slabs = [(z0, min(slab_z, Z - z0)) for z0 in range(0, Z, slab_z)]
    for z0, zn in slabs:
        wsum.write_block((z0, 0, 0), np.zeros((zn, Y, X), np.float32))

    sum_counts = 0.0
    for v in range(V):
        vol = torch.as_tensor(np.asarray(get_volume(v), np.float32),
                              device=dev)
        A4 = np.vstack([np.asarray(models[v], np.float64), [0, 0, 0, 1]])
        inv = torch.as_tensor(np.linalg.inv(A4)[:3], dtype=torch.float32,
                              device=dev)
        for z0, zn in slabs:
            grid = output_grid_coords(
                (zn, Y, X), offset=(bbox.min[0] + z0, bbox.min[1],
                                    bbox.min[2]), device=dev)
            vc = apply_affine(inv, grid)
            vals, inside = trilinear_sample(vol, vc)
            w = inside.to(torch.float32) * blending_weight(
                vc, tuple(vol.shape), blending)
            w_np = w.cpu().numpy()
            img_stores[v].write_block((z0, 0, 0), vals.cpu().numpy())
            w_stores[v].write_block((z0, 0, 0), w_np)
            acc = wsum.read_block((z0, 0, 0), (z0 + zn, Y, X))
            wsum.write_block((z0, 0, 0), acc + w_np)
            sum_counts += float((w_np > 1e-9).sum())
        del vol

    covered = 0.0
    for z0, zn in slabs:
        ws = wsum.read_block((z0, 0, 0), (z0 + zn, Y, X))
        covered += float((ws > 1e-9).sum())
        denom = np.maximum(ws, 1e-9)
        mask = ws > 1e-9
        for v in range(V):
            wv = w_stores[v].read_block((z0, 0, 0), (z0 + zn, Y, X))
            w_stores[v].write_block(
                (z0, 0, 0), np.where(mask, wv / denom, 0.0)
                .astype(np.float32))

    if osem_factor is None:
        osem_factor = (sum_counts / covered) if covered > 0 else 1.0

    return BlockedDeconvolutionInputs(
        image_stores=img_stores,
        weight_stores=w_stores,
        psfs=[np.asarray(p, np.float32) for p in psfs],
        osem_factor=float(osem_factor),
        psf_factors=psf_factors,
    )
