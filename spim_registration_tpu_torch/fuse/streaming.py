"""Streaming (larger-than-memory) fusion over the block store.

Port of the reference's `fuse/streaming.py` (the virtual/lazy fusion
variants `ProcessVirtual`, `TransformedRealRandomAccessibleInterval`): the
fused output never exists in memory as a whole — it is produced block by
block into a `RawVolumeStore`, and each block reads only the sub-regions
of the source views its world extent maps into (from the inverse
transforms; the store does the strided reads).

Content-based weights use a two-pass low-res pyramid: pass 1 streams
each view once, computing the full-resolution residual
(I - G_sigma1 I)^2 per z-slab (sigma1-support halos re-read from the
store) and accumulating it downsampled; the wide G_sigma2 blur then runs
once on the small pyramid. The content weight is smooth by construction
(a sigma ~40 blur), so a 4x pyramid loses little, and pass 2 (fusion)
samples it as the in-memory path samples the full-res weight volume.

Streaming fusion runs on one device: its wall time is disk IO (every
source view streams through the block reader once; the per-block device
work is a few gathers and products).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from spim_registration_tpu_torch.core.dataset import BoundingBox
from spim_registration_tpu_torch.fuse.weighted_avg import (
    FusionParameters,
    _accumulate_view_chunk,
)
from spim_registration_tpu_torch.fuse.weights import ContentBasedParameters
from spim_registration_tpu_torch.native_blocks import decompose, read_mirror_z
from spim_registration_tpu_torch.ops.downsample import downsample
from spim_registration_tpu_torch.ops.gaussian import (
    conv_axis_valid,
    gaussian_blur_3d,
    gaussian_kernel_1d,
    mirror_pad,
)
from spim_registration_tpu_torch.utils.device import resolve_device


def streaming_content_lowres(store, params: ContentBasedParameters,
                             ds: int = 4, slab: int = 64,
                             device=None) -> np.ndarray:
    """Pass 1: low-res content weight of a disk-resident view.

    Returns a ((Z//ds), (Y//ds), (X//ds)) float32 volume normalized to
    max 1 — sample it at view_coords / ds during fusion. Residuals are
    computed at full resolution (z-slabs with sigma1-support halos re-read
    from the store, mirror at the volume edges), so the measure matches
    `content_based_weight` up to the pyramid interpolation. `device`:
    default CUDA; "cpu" for the host."""
    dev = resolve_device(device)
    Z, Y, X = store.shape
    zc = (Z // ds) * ds
    slab = max(ds, (min(slab, zc) // ds) * ds)
    k1 = torch.as_tensor(gaussian_kernel_1d(float(params.sigma1)),
                         device=dev)
    r1 = (k1.shape[0] - 1) // 2
    # anti-alias prefilter before downsampling the (high-frequency)
    # squared residual; its width is folded out of the sigma2 budget so
    # the total blur matches the full-res path
    sa = ds / 2.0
    ka = torch.as_tensor(gaussian_kernel_1d(sa), device=dev)
    ra = (ka.shape[0] - 1) // 2
    s2_eff = float(np.sqrt(max(params.sigma2 ** 2 - sa ** 2,
                               (0.5 * ds) ** 2)))

    r_ds = torch.zeros((zc // ds, Y // ds, X // ds), dtype=torch.float32,
                       device=dev)
    for z0 in range(0, zc, slab):
        z1 = min(z0 + slab, zc)
        xj = torch.from_numpy(read_mirror_z(
            store, z0 - r1 - ra, z1 + r1 + ra)).to(dev)
        g = conv_axis_valid(xj, k1, 0)   # valid z -> (z1-z0+2ra, ...)
        for ax in (1, 2):
            g = conv_axis_valid(mirror_pad(g, r1, ax), k1, ax)
        resid = (xj[r1: r1 + (z1 - z0) + 2 * ra] - g) ** 2
        aa = conv_axis_valid(resid, ka, 0)      # valid z -> (z1-z0, ...)
        for ax in (1, 2):
            aa = conv_axis_valid(mirror_pad(aa, ra, ax), ka, ax)
        r_ds[z0 // ds: z1 // ds] = downsample(aa, (ds, ds, ds))

    ent = gaussian_blur_3d(r_ds, (s2_eff / ds,) * 3)
    ent = ent / torch.clamp(ent.max(), min=1e-12)
    return ent.cpu().numpy().astype(np.float32)


def _quantize_range(vlo, vhi, shape, q=(16, 32, 32)):
    """Snap [vlo, vhi) outward to quantum multiples; returns
    (lo, hi_clamped, zero_pad_amounts) with hi - lo + pad a multiple of
    q. Kept from the reference, where it bounds the number of compiled
    programs; here it fixes the sub-region shapes the same way."""
    vlo = np.asarray(vlo)
    vhi = np.asarray(vhi)
    q = np.asarray(q)
    lo = (vlo // q) * q
    hi_q = lo + ((vhi - lo + q - 1) // q) * q
    hi = np.minimum(hi_q, shape)
    return lo, hi, hi_q - hi


def _view_subregion(model_inv: np.ndarray, world_lo, world_hi, view_shape,
                    margin: int = 2):
    """View-space AABB that the world block [lo, hi) maps into."""
    corners = np.array([[a, b, c]
                        for a in (world_lo[0], world_hi[0])
                        for b in (world_lo[1], world_hi[1])
                        for c in (world_lo[2], world_hi[2])], float)
    vc = corners @ model_inv[:, :3].T + model_inv[:, 3]
    lo = np.floor(vc.min(axis=0)).astype(int) - margin
    hi = np.ceil(vc.max(axis=0)).astype(int) + margin + 1
    lo = np.maximum(lo, 0)
    hi = np.minimum(hi, view_shape)
    return lo, hi


def fuse_views_streaming(
    view_stores: Sequence,
    models: Sequence[np.ndarray],
    bbox: BoundingBox,
    out_store,
    params: FusionParameters = FusionParameters(),
    block: Sequence[int] = (64, 128, 128),
    device=None,
) -> None:
    """Fuse disk-resident views into a disk-resident output, block-wise.

    `out_store` must have shape == bbox.shape. Content-based weights run
    through the two-pass low-res pyramid (`streaming_content_lowres`);
    blending is evaluated in full-view coordinates as always. `device`:
    default CUDA; "cpu" for the host."""
    dev = resolve_device(device)
    out_shape = bbox.shape
    if tuple(out_store.shape) != tuple(out_shape):
        raise ValueError(f"out store shape {out_store.shape} != bbox "
                         f"{out_shape}")

    content_ds = 4
    contents = []
    if params.use_content_based:
        for store in view_stores:
            contents.append(torch.from_numpy(streaming_content_lowres(
                store, params.content, ds=content_ds, device=dev)).to(dev))

    invs = []
    for model in models:
        A4 = np.vstack([np.asarray(model, np.float64), [0, 0, 0, 1]])
        invs.append(np.linalg.inv(A4)[:3])

    zero3 = torch.zeros(3, dtype=torch.float32, device=dev)
    for blk in decompose(out_shape, tuple(block), (0, 0, 0)):
        blk_shape = tuple(h - l for l, h in zip(blk.out_lo, blk.out_hi))
        acc_v = torch.zeros(blk_shape, dtype=torch.float32, device=dev)
        acc_w = torch.zeros(blk_shape, dtype=torch.float32, device=dev)
        world_lo = [bbox.min[d] + blk.out_lo[d] for d in range(3)]
        world_hi = [bbox.min[d] + blk.out_hi[d] for d in range(3)]
        for vi, (store, inv) in enumerate(zip(view_stores, invs)):
            vlo, vhi = _view_subregion(inv, world_lo, world_hi, store.shape)
            if np.any(vlo >= vhi):
                continue
            if params.use_blending:
                # out-of-bounds quanta are zero-filled: the blending ramp
                # is 0 outside the full view
                vlo, vhi, pad = _quantize_range(vlo, vhi, store.shape)
                sub = store.read_block(vlo, vhi)
                if any(p for p in pad):
                    sub = np.pad(sub, [(0, int(p)) for p in pad])
            else:
                sub = store.read_block(vlo, vhi)
            # the world->view map in sub-volume coordinates: out voxel i
            # -> world = world_lo + i -> view -> minus vlo
            S = np.vstack([inv, [0, 0, 0, 1]])
            T = np.array([[1, 0, 0, world_lo[0]],
                          [0, 1, 0, world_lo[1]],
                          [0, 0, 1, world_lo[2]],
                          [0, 0, 0, 1.0]])
            Mfull = (S @ T)[:3]
            M = Mfull.copy()
            M[:, 3] -= vlo
            content_vol = content_aff = None
            if params.use_content_based:
                # block voxel -> low-res content index: downsampled cell
                # i sits at full coords ds*i + (ds-1)/2
                Mc = Mfull / content_ds
                Mc[:, 3] -= (content_ds - 1) / (2.0 * content_ds)
                content_vol = contents[vi]
                content_aff = torch.as_tensor(Mc, dtype=torch.float32,
                                              device=dev)
            acc_v, acc_w = _accumulate_view_chunk(
                acc_v, acc_w, torch.from_numpy(np.ascontiguousarray(
                    sub, np.float32)).to(dev), content_vol,
                torch.as_tensor(M, dtype=torch.float32, device=dev),
                zero3, tuple(sub.shape), params, blk_shape,
                blend_size=tuple(int(s) for s in store.shape),
                blend_offset=torch.as_tensor(vlo, dtype=torch.float32,
                                             device=dev),
                content_affine=content_aff)
        out = torch.where(acc_w > 1e-9, acc_v / torch.clamp(acc_w, min=1e-9),
                          torch.zeros((), device=dev))
        out_store.write_block(blk.out_lo, out.cpu().numpy())
