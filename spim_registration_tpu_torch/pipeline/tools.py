"""Dataset utility operations: the reference's small plugins.

Port of the reference's `pipeline/tools.py` (SURVEY.md section 2.2 rows
"Transform utilities", "Detection utilities", "Display"):
- Apply_Transformation      -> apply_transformation
- Duplicate_Transformation  -> duplicate_transformation
- Specify_Calibration       -> specify_calibration
- ThinOut_Detections        -> thin_out_detections
- Remove_Detections         -> remove_detections (by label)
- Visualize_Detections      -> visualize_detections (render into a volume)
- Display_View              -> display_view (transformed view block)
- Max_Project               -> max_project

All but `display_view` are host numpy on the dataset model; `display_view`
resamples on the entry point's device (CUDA unless another is named).
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

import numpy as np

from spim_registration_tpu_torch.core.dataset import (
    Dataset,
    ViewId,
    ViewTransform,
)
from spim_registration_tpu_torch.ops.resample import resample_affine_auto
from spim_registration_tpu_torch.utils.simulation import render_beads


def apply_transformation(dataset: Dataset, view_ids: Iterable[ViewId],
                         affine: np.ndarray, name: str = "manual",
                         replace: bool = False) -> None:
    """Prepend (or replace) a named transform on selected views."""
    for vid in view_ids:
        dataset.views[vid].set_transform(name, affine, replace=replace)


def duplicate_transformation(dataset: Dataset, source: ViewId,
                             targets: Iterable[ViewId]) -> None:
    """Copy the source view's whole transform chain onto the targets."""
    src = dataset.views[source].transforms
    for vid in targets:
        dataset.views[vid].transforms = [
            type(t)(t.name, t.affine.copy()) for t in src]


def specify_calibration(dataset: Dataset, voxel_size: Tuple[float, float, float],
                        view_ids: Optional[Iterable[ViewId]] = None) -> None:
    """Set voxel size and (re)write the 'calibration' transform scaling the
    anisotropic z axis into isotropic world units (the reference encodes
    calibration as the innermost ViewTransform, so it is appended at the
    end of the newest-first chain)."""
    ids = list(view_ids) if view_ids is not None else list(dataset.views)
    ref = min(voxel_size)
    scale = np.diag([v / ref for v in voxel_size])
    A = np.concatenate([scale, np.zeros((3, 1))], axis=1)
    for vid in ids:
        vd = dataset.views[vid]
        vd.voxel_size = tuple(voxel_size)
        vd.transforms = [t for t in vd.transforms if t.name != "calibration"]
        vd.transforms.append(ViewTransform("calibration", A))


def thin_out_detections(dataset: Dataset, view_ids: Iterable[ViewId],
                        label: str, min_distance: float,
                        new_label: Optional[str] = None) -> None:
    """Drop detections closer than min_distance to a kept neighbor
    (greedy, by descending |intensity| — ThinOut_Detections). The order is
    numpy's default (unstable) argsort, as in the reference: among tied
    intensities it decides which point is kept."""
    for vid in view_ids:
        ips = dataset.views[vid].interest_points[label]
        pts = np.asarray(ips.points)
        inten = (np.asarray(ips.intensities)
                 if ips.intensities is not None
                 else np.zeros(len(pts)))
        order = np.argsort(-np.abs(inten))
        kept_idx = []
        for i in order:
            p = pts[i]
            if all(np.linalg.norm(p - pts[j]) >= min_distance
                   for j in kept_idx):
                kept_idx.append(i)
        kept_idx = sorted(kept_idx)
        dataset.set_interest_points(
            vid, new_label or label, pts[kept_idx], inten[kept_idx],
            parameters=ips.parameters + f" thinned>{min_distance}")


def remove_detections(dataset: Dataset, view_ids: Iterable[ViewId],
                      label: str) -> None:
    for vid in view_ids:
        dataset.views[vid].interest_points.pop(label, None)


def visualize_detections(dataset: Dataset, view_id: ViewId, label: str,
                         sigma: float = 1.5,
                         shape: Optional[Tuple[int, int, int]] = None
                         ) -> np.ndarray:
    """Render detections as Gaussian spots in view space."""
    vd = dataset.views[view_id]
    pts = np.asarray(vd.interest_points[label].points)
    shp = shape or vd.size
    if shp is None:
        raise ValueError("view has no size; pass shape=")
    return render_beads(pts, tuple(shp), sigma=sigma)


def display_view(dataset: Dataset, view_id: ViewId,
                 out_shape: Optional[Tuple[int, int, int]] = None,
                 out_offset=(0.0, 0.0, 0.0), device=None) -> np.ndarray:
    """Render a view through its current transform chain into world space
    (Display_View: "open transformed view"), on `device` (default CUDA)."""
    vol = dataset.get_image(view_id)
    A = dataset.views[view_id].model()
    A4 = np.vstack([A, [0, 0, 0, 1]])
    inv = np.linalg.inv(A4)[:3]
    shp = out_shape or vol.shape
    out, _ = resample_affine_auto(vol, inv, tuple(shp), out_offset,
                                  device=device)
    return out.cpu().numpy()


def max_project(vol: np.ndarray, axis: int = 0) -> np.ndarray:
    """Maximum-intensity projection (Max_Project)."""
    return np.asarray(vol).max(axis=axis)
