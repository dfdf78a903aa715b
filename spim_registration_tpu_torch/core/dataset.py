"""The dataset model: views, transform chains, interest points, bounding boxes.

Copy of the reference's `core/dataset.py` (host numpy only), the analog of
the BDV `SpimData2` tree:

- `Dataset` holds `ViewDescription`s keyed by `ViewId` (timepoint,
  setup), named `BoundingBox`es and the image loader;
- `ViewDescription.transforms` is the view's registration chain of named
  `ViewTransform`s, newest first: the FIRST entry is applied LAST
  (BDV's convention, where the newest transform is prepended);
- `InterestPoints` per (view, label), with cross-view correspondences.

Point coordinates are (z, y, x) float64 in full-resolution voxel units of
their view.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

ViewId = Tuple[int, int]  # (timepoint, setup_id)


def identity_transform() -> np.ndarray:
    return np.concatenate([np.eye(3), np.zeros((3, 1))], axis=1)


@dataclasses.dataclass
class ViewTransform:
    """One named affine in a view's transform chain."""

    name: str
    affine: np.ndarray  # (3, 4), acts on (z, y, x, 1)

    def __post_init__(self):
        self.affine = np.asarray(self.affine, dtype=np.float64).reshape(3, 4)


@dataclasses.dataclass
class InterestPoints:
    """Detected points for one (view, label), plus correspondences
    (own_point_id, other_view, other_label, other_point_id); point ids are
    row indices."""

    label: str
    points: np.ndarray  # (N, 3) float64, (z, y, x) full-res voxel coords
    intensities: Optional[np.ndarray] = None  # (N,) detection response
    parameters: str = ""  # human-readable detection parameter summary
    correspondences: List[Tuple[int, ViewId, str, int]] = dataclasses.field(
        default_factory=list
    )

    def __post_init__(self):
        self.points = np.asarray(self.points, dtype=np.float64).reshape(-1, 3)


@dataclasses.dataclass
class ViewDescription:
    """One view = image at (timepoint, angle, channel, illumination, tile)."""

    view_id: ViewId
    angle: int = 0
    channel: int = 0
    illumination: int = 0
    tile: int = 0
    size: Optional[Tuple[int, int, int]] = None  # (z, y, x)
    voxel_size: Tuple[float, float, float] = (1.0, 1.0, 1.0)  # (z, y, x) um
    present: bool = True
    # newest-first chain; effective transform = chain[0] o chain[1] o ...
    transforms: List[ViewTransform] = dataclasses.field(default_factory=list)
    interest_points: Dict[str, InterestPoints] = dataclasses.field(
        default_factory=dict
    )

    @property
    def timepoint(self) -> int:
        return self.view_id[0]

    @property
    def setup_id(self) -> int:
        return self.view_id[1]

    def model(self) -> np.ndarray:
        """Concatenated (3, 4) affine: full view -> world transform."""
        A = identity_transform()
        for t in self.transforms:
            A4 = np.vstack([A, [0, 0, 0, 1]])
            B4 = np.vstack([t.affine, [0, 0, 0, 1]])
            A = (A4 @ B4)[:3]
        return A

    def set_transform(self, name: str, affine: np.ndarray,
                      replace: bool = True) -> None:
        """Prepend (or replace same-named) transform, newest-first."""
        if replace:
            self.transforms = [t for t in self.transforms if t.name != name]
        self.transforms.insert(0, ViewTransform(name, affine))


@dataclasses.dataclass
class BoundingBox:
    """Named fusion ROI in world coordinates (inclusive min, exclusive max)."""

    name: str
    min: Tuple[int, int, int]  # (z, y, x)
    max: Tuple[int, int, int]  # (z, y, x) exclusive

    @property
    def shape(self) -> Tuple[int, int, int]:
        return tuple(int(b - a) for a, b in zip(self.min, self.max))


@dataclasses.dataclass
class Dataset:
    """Root object; the single source of truth between pipeline stages."""

    views: Dict[ViewId, ViewDescription] = dataclasses.field(
        default_factory=dict)
    bounding_boxes: Dict[str, BoundingBox] = dataclasses.field(
        default_factory=dict)
    base_path: str = "."
    # image loader: (view_id) -> np.ndarray (z, y, x)
    loader: Optional[Callable[[ViewId], np.ndarray]] = None

    def add_view(self, vd: ViewDescription) -> None:
        self.views[vd.view_id] = vd

    def timepoints(self) -> List[int]:
        return sorted({tp for (tp, _s) in self.views})

    def setups(self) -> List[int]:
        return sorted({s for (_tp, s) in self.views})

    def views_of_timepoint(self, tp: int) -> List[ViewDescription]:
        return [v for (t, _s), v in sorted(self.views.items()) if t == tp]

    def get_image(self, view_id: ViewId) -> np.ndarray:
        if self.loader is None:
            raise RuntimeError("dataset has no image loader attached")
        return np.asarray(self.loader(view_id))

    def set_interest_points(self, view_id: ViewId, label: str,
                            points: np.ndarray,
                            intensities: Optional[np.ndarray] = None,
                            parameters: str = "") -> None:
        self.views[view_id].interest_points[label] = InterestPoints(
            label=label, points=points, intensities=intensities,
            parameters=parameters,
        )

    def get_interest_points(self, view_id: ViewId,
                            label: str) -> InterestPoints:
        return self.views[view_id].interest_points[label]
