"""Difference-of-Gaussian interest-point detection.

Port of the reference's `detect/dog.py` (ImgLib1 `ProcessDOG` /
`DoGParameters`). Per view: optional min/max normalization -> optional
per-axis downsample -> DoG (sigma, sigma * k) -> strict 26-neighbourhood
extrema above threshold -> iterative sub-pixel quadratic localization ->
coordinates mapped back to full resolution. All voxel work runs on the
entry point's device; the peak budget is static (`max_peaks` rows with a
validity mask) and the host keeps the valid rows.

The reference's truncated transfer (`HOT_ROWS`, its in-band candidate
count and the packed single transfer) saved round trips of its remote
TPU and is not carried over: each view's rows come back in one copy.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from spim_registration_tpu_torch.ops.downsample import (
    downsample,
    upscale_coords,
)
from spim_registration_tpu_torch.ops.extrema import find_peaks_localized
from spim_registration_tpu_torch.ops.gaussian import (
    difference_of_gaussian,
    difference_of_gaussian_bf16,
    dog_sigmas,
)
from spim_registration_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class DoGParameters:
    """Headless detection parameters (the reference's `DoGParameters`).

    sigma/threshold defaults follow the reference GUI defaults (sigma
    ~1.8, threshold ~0.008 on normalized images)."""

    sigma: float = 1.8
    threshold: float = 0.008
    max_peaks: int = 8192
    find_minima: bool = False
    downsample_xy: int = 1          # power of two
    downsample_z: int = 1
    steps_per_octave: int = 4       # fixes k = 2^(1/steps)
    normalize: bool = True          # min/max normalize image first
    min_intensity: float | None = None
    max_intensity: float | None = None
    # anisotropic z: explicit z sigma, or derived from the voxel
    # calibration (a blob sigma wide in xy voxels spans
    # sigma * (xy_spacing / z_spacing) z voxels)
    sigma_z: float | None = None
    calibration_zyx: tuple | None = None  # (z, y, x) voxel spacing
    # "bfloat16": the telescoping difference-first DoG with bf16 matmul
    # inputs and f32 accumulation (ops.gaussian.difference_of_gaussian_bf16)
    conv_dtype: str = "float32"


def effective_sigmas(params: DoGParameters) -> tuple:
    """Per-axis base sigma (sz, sy, sx): explicit sigma_z >
    calibration-derived > isotropic."""
    s = float(params.sigma)
    if params.sigma_z is not None:
        sz = float(params.sigma_z)
    elif params.calibration_zyx is not None:
        cz, cy, _cx = (float(c) for c in params.calibration_zyx)
        sz = s * cy / cz
    else:
        sz = s
    return (sz, s, s)


def dog_response(v: torch.Tensor, params: DoGParameters) -> torch.Tensor:
    """The detection's response field of one view in v's dtype:
    optional min/max normalization, optional downsampling, then the DoG
    at the effective sigmas times the response scale 1/(k-1)."""
    if params.normalize:
        if params.min_intensity is not None \
                and params.max_intensity is not None:
            lo = torch.tensor(params.min_intensity, dtype=v.dtype,
                              device=v.device)
            hi = torch.tensor(params.max_intensity, dtype=v.dtype,
                              device=v.device)
        else:
            lo = v.min()
            hi = v.max()
        v = (v - lo) / torch.clamp(hi - lo, min=1e-12)

    factors = (params.downsample_z, params.downsample_xy,
               params.downsample_xy)
    if any(f > 1 for f in factors):
        v = downsample(v, factors)

    _, _, norm = dog_sigmas(params.sigma, params.threshold,
                            steps_per_octave=params.steps_per_octave)
    k = 2.0 ** (1.0 / params.steps_per_octave)
    s1 = effective_sigmas(params)
    s2 = tuple(s * k for s in s1)
    dog_fn = (difference_of_gaussian_bf16
              if params.conv_dtype == "bfloat16"
              else difference_of_gaussian)
    return dog_fn(v, s1, s2) * np.float32(norm)


def _detect_core(vol: torch.Tensor, params: DoGParameters):
    """One view on its device: (pos (P, 3) full-res, val (P,), ok (P,),
    cand_count)."""
    dog = dog_response(vol.float(), params)
    pos, val, ok, cand_count = find_peaks_localized(
        dog, params.threshold, params.max_peaks, params.find_minima)
    factors = (params.downsample_z, params.downsample_xy,
               params.downsample_xy)
    return upscale_coords(pos, factors), val, ok, cand_count


def _unpack(pos: torch.Tensor, val: torch.Tensor, ok: torch.Tensor):
    """The valid rows on the host: (points (N, 3) float32, responses)."""
    rows = torch.cat([pos, val[:, None], ok[:, None].to(pos.dtype)],
                     dim=1).cpu().numpy()
    keep = rows[:, 4] > 0.5
    return (rows[keep, :3].astype(np.float32),
            rows[keep, 3].astype(np.float32))


def _on(x, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(x).to(dev)


def detect_beads(vol, params: DoGParameters = DoGParameters(),
                 device=None):
    """Detect interest points in one view volume (numpy or tensor).

    Returns (points (N, 3) np.float32 full-res (z, y, x), responses (N,))
    with only the valid rows, sorted by |response| descending. Runs on
    CUDA unless `device` names another device (`utils.device`)."""
    dev = resolve_device(device)
    pos, val, ok, _ = _detect_core(_on(vol, dev), params)
    return _unpack(pos, val, ok)


def detect_beads_batch(vols, params: DoGParameters = DoGParameters(),
                       device=None):
    """Detect interest points in a (V, Z, Y, X) batch of same-shape views,
    one view after another on the device. Returns a list of (points,
    responses) per view, as repeated `detect_beads` calls would."""
    dev = resolve_device(device)
    vols = _on(vols, dev)
    return [_unpack(*_detect_core(vols[i], params)[:3])
            for i in range(vols.shape[0])]


def detect_beads_dataset(dataset, view_ids=None, label: str = "beads",
                         params: DoGParameters = DoGParameters(),
                         max_batch_views: int = 8, device=None,
                         mesh=None) -> None:
    """Detect interest points in dataset views and store them as
    `InterestPoints` under `label` (the reference's `detect_beads_dataset`,
    stage 1 of the pipeline). Views are grouped by their declared shape;
    each group runs through `detect_beads_batch`, loading at most
    `max_batch_views` images at once. Views whose declared size is missing
    or differs from the image go one at a time through `detect_beads`.

    `mesh`: a `parallel.Mesh` routes each view through the z-sharded
    detection engine (`parallel.sharded_detect_beads`, over the mesh's
    last axis), one view at a time, on the mesh's devices."""
    if view_ids is None:
        view_ids = sorted(dataset.views)
    param_str = (f"DoG s={params.sigma} t={params.threshold} "
                 f"ds=xy{params.downsample_xy}/z{params.downsample_z}")
    if mesh is not None:
        from spim_registration_tpu_torch.parallel.sharded_detect import (
            sharded_detect_beads,
        )

        for vid in view_ids:
            pts, resp = sharded_detect_beads(
                dataset.get_image(vid), params, mesh,
                axis_name=mesh.axis_names[-1])
            dataset.set_interest_points(vid, label, pts, resp,
                                        parameters=param_str)
        return
    by_shape: dict = {}
    for vid in view_ids:
        size = dataset.views[vid].size
        by_shape.setdefault(tuple(size) if size else None, []).append(vid)

    for shape, vids in by_shape.items():
        for i in range(0, len(vids), max_batch_views):
            chunk = vids[i:i + max_batch_views]
            imgs = [np.asarray(dataset.get_image(v)) for v in chunk]
            if shape is None or any(im.shape != imgs[0].shape
                                    for im in imgs):
                results = [detect_beads(im, params, device) for im in imgs]
            elif len(chunk) == 1:
                results = [detect_beads(imgs[0], params, device)]
            else:
                results = detect_beads_batch(np.stack(imgs), params, device)
            for vid, (pts, resp) in zip(chunk, results):
                dataset.set_interest_points(vid, label, pts, resp,
                                            parameters=param_str)
            del imgs
