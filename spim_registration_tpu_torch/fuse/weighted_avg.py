"""Weighted-average multi-view fusion.

Port of the reference's `fuse/weighted_avg.py` (`FusionParameters`,
`fuse_views`): for every output voxel in the bounding box, inverse-transform
into each view, interpolate, weight (blending x content) and write
sum(w*v)/sum(w). Per view, on the concrete world->view matrix:
- axis-aligned maps: exact separable trilinear as three matmuls
  (`ops.resample.separable_resample`) with 1D-outer-product blending;
- general affine: 8-corner gathers (`ops.resample.trilinear_sample`).

Output rows go through in z-chunks (~16M voxels unless pinned); each
chunk accumulates all views on the device and is copied straight into its
rows of the host array: a new one, or the caller's `out`. `TimelapseFusion`
(the CLI's `fuse`) passes one array for every timepoint, page-locked where
the device is to write into it at the link's rate.
The reference groups views so its compiled program does not grow with
the view count; eager PyTorch needs no such grouping.

Tracing: `COUNTERS` counts what `fuse_views` did in the process (always
on: chunks, view-chunks by path, bytes to and from the device). While a
torch profiler runs, a `fuse_views` call is the span `spim/fuse.run`
with its phases (`utils/profiling.py` `PhaseTimer`, stream order):
`upload` (each view onto the device), `content` (each view's content
weight), `sample` (each chunk's views sampled, weighted and summed) and
`download` (each chunk to the host array).
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
from spim_registration_tpu_torch.utils.profiling import (
    FUSE_CONTENT,
    FUSE_DOWNLOAD,
    FUSE_RUN,
    FUSE_SAMPLE,
    FUSE_UPLOAD,
    RECORDER,
    PhaseTimer,
    profiler_active,
)

_AUTO_CHUNK_VOXELS = 1 << 24

# what `fuse_views` did in this process: output chunks, view-chunks on
# the separable (axis-aligned) and on the gather (affine) path, and the
# bytes of the views put on the device and of the chunks brought back
COUNTERS = dict.fromkeys(("fuse.chunks", "fuse.aligned_view_chunks",
                          "fuse.affine_view_chunks", "fuse.h2d_bytes",
                          "fuse.d2h_bytes"), 0)


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
               device, phases: Optional[PhaseTimer] = None):
    """Per view: (vol tensor, content weight or None, world->view map of
    OUTPUT voxels (3,4) f64, axis-aligned flag). `phases`: None, or the
    run's `PhaseTimer`, lapped after each view's upload and content
    weight."""
    ds = params.downsample
    views = []
    for vol, model in zip(volumes, models):
        v = torch.as_tensor(np.asarray(vol, np.float32), device=device)
        if phases is not None:
            phases.lap(FUSE_UPLOAD)
        cw = (content_based_weight(v, params.content)
              if params.use_content_based else None)
        if phases is not None and cw is not None:
            phases.lap(FUSE_CONTENT)
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


def _accumulate_view_chunk(acc_v, acc_w, vol, weight_vol, world_to_view,
                           chunk_offset, view_size, params: FusionParameters,
                           chunk_shape, blend_size=None, blend_offset=None,
                           content_affine=None):
    """Add one view's contribution to one output chunk; returns the new
    (acc_v, acc_w).

    `blend_size`/`blend_offset`: when `vol` is a sub-region of the full
    view (streaming mode), the blending ramp is still evaluated in
    full-view coordinates: full = sampled + blend_offset, ramp over
    blend_size.

    `content_affine`: when given, `weight_vol` is a low-res content-weight
    volume sampled at content_affine @ (chunk voxel) — the streaming
    content path (coordinates clamped: the low-res pyramid may be a voxel
    short at the far faces, where content is smooth)."""
    dev = vol.device
    grid = output_grid_coords(chunk_shape, device=dev) \
        + torch.as_tensor(chunk_offset, dtype=torch.float32, device=dev)
    vc = apply_affine(world_to_view.to(torch.float32), grid)
    if params.interpolation == "nearest":
        vals, inside = trilinear_sample(vol, torch.round(vc))
    else:
        vals, inside = trilinear_sample(vol, vc)
    w = inside.to(torch.float32)
    if params.use_blending:
        bc = vc if blend_offset is None else vc + blend_offset
        w = w * blending_weight(
            bc, view_size if blend_size is None else blend_size,
            params.blending)
    if params.use_content_based and weight_vol is not None:
        if content_affine is not None:
            cc = apply_affine(content_affine.to(torch.float32), grid)
            top = torch.tensor(weight_vol.shape, dtype=torch.float32,
                               device=dev) - 1.0
            cc = torch.minimum(torch.clamp(cc, min=0.0), top)
            cw, _ = trilinear_sample(weight_vol, cc)
        else:
            cw, _ = trilinear_sample(weight_vol, vc)
        w = w * cw
    return acc_v + w * vals, acc_w + w


def fuse_views(
    volumes: Sequence[np.ndarray],
    models: Sequence[np.ndarray],
    bbox: BoundingBox,
    params: FusionParameters = FusionParameters(),
    device=None,
    out: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Fuse registered views into the bounding box; returns (Z,Y,X) f32 on
    the host. `models[i]` maps view-i voxel coords to world coords.
    `device`: where the fusion runs (default CUDA; "cpu" to run on the
    host). `out`: a writeable float32 host array of the output's shape
    that every voxel is written into and that is returned (None: a new
    array)."""
    dev = resolve_device(device)
    ds = params.downsample
    out_shape = tuple(s // ds for s in bbox.shape)
    if any(s == 0 for s in out_shape):
        raise ValueError(f"empty bounding box {bbox}")
    if out is None:
        out = np.zeros(out_shape, np.float32)
    elif (out.shape != out_shape or out.dtype != np.float32
          or not out.flags.writeable):
        raise ValueError(f"out is {out.dtype} {out.shape} (writeable: "
                         f"{out.flags.writeable}), fusion writes float32 "
                         f"{out_shape}")
    if not profiler_active():
        return _fuse(volumes, models, bbox, params, dev, out)
    # traced: the run's span, and its phases timed in stream order
    phases = PhaseTimer(dev, RECORDER.new_run_id(),
                        (FUSE_UPLOAD, FUSE_CONTENT, FUSE_SAMPLE,
                         FUSE_DOWNLOAD), (None, FUSE_RUN))
    try:
        with phases.view():
            return _fuse(volumes, models, bbox, params, dev, out, phases)
    finally:
        phases.close()


def _fuse(volumes, models, bbox: BoundingBox, params: FusionParameters,
          dev, out: np.ndarray, phases: Optional[PhaseTimer] = None
          ) -> np.ndarray:
    """`fuse_views`' work into `out`, counted in `COUNTERS`; `phases`
    (None, or the run's `PhaseTimer`) is lapped after each stage."""
    views = _view_maps(volumes, models, bbox, params, dev, phases)
    COUNTERS["fuse.h2d_bytes"] += sum(v.numel() * v.element_size()
                                      for v, *_ in views)
    n_aligned = sum(aligned for *_, aligned in views)
    out_shape = out.shape
    zc = params.z_chunk or max(
        1, min(out_shape[0], _AUTO_CHUNK_VOXELS
               // max(1, out_shape[1] * out_shape[2])))
    for z0 in range(0, out_shape[0], zc):
        z1 = min(z0 + zc, out_shape[0])
        chunk = _fuse_chunk(views, z0, (z1 - z0,) + out_shape[1:], params,
                            dev)
        if phases is not None:
            phases.lap(FUSE_SAMPLE)
        torch.from_numpy(out[z0:z1]).copy_(chunk)
        if phases is not None:
            phases.lap(FUSE_DOWNLOAD)
        COUNTERS["fuse.chunks"] += 1
        COUNTERS["fuse.aligned_view_chunks"] += n_aligned
        COUNTERS["fuse.affine_view_chunks"] += len(views) - n_aligned
        COUNTERS["fuse.d2h_bytes"] += chunk.numel() * chunk.element_size()
    return out


class TimelapseFusion:
    """`fuse_views` for the timepoints of a timelapse, one after another,
    into one host array (the CLI's `fuse`): `fusion(volumes, models,
    bbox)` returns the fused timepoint in that array, which the next call
    overwrites. The array is made at the first call and again only for a
    larger box (a smaller one is a view of its first voxels), page-locked
    where the fusion runs on a card: each chunk then goes to the host at
    the link's rate, and no timepoint pays for faulting in the pages of a
    new array (4 bytes a voxel)."""

    def __init__(self, params: FusionParameters = FusionParameters(),
                 device=None):
        self.params = params
        self.device = device
        self._flat: Optional[np.ndarray] = None

    def __call__(self, volumes: Sequence, models: Sequence,
                 bbox: BoundingBox) -> np.ndarray:
        dev = resolve_device(self.device)
        shape = tuple(s // self.params.downsample for s in bbox.shape)
        n = math.prod(shape)
        if self._flat is None or self._flat.size < n:
            self._flat = None           # the old array goes first
            self._flat = torch.empty(
                n, dtype=torch.float32,
                pin_memory=dev.type == "cuda").numpy()
        return fuse_views(volumes, models, bbox, self.params, dev,
                          out=self._flat[:n].reshape(shape))


def fuse_dataset(dataset, view_ids, bbox_name: Optional[str] = None,
                 params: FusionParameters = FusionParameters(),
                 device=None) -> np.ndarray:
    """Fusion over a `Dataset` (the Image_Fusion plugin analog): the named
    bounding box when the dataset has it, else the maximal box of the
    transformed views."""
    from spim_registration_tpu_torch.fuse.bounding_box import (
        maximal_bounding_box,
    )

    vols = [dataset.get_image(v) for v in view_ids]
    models = [dataset.views[v].model() for v in view_ids]
    if bbox_name is not None and bbox_name in dataset.bounding_boxes:
        bbox = dataset.bounding_boxes[bbox_name]
    else:
        bbox = maximal_bounding_box([v.shape for v in vols], models)
    return fuse_views(vols, models, bbox, params, device)
