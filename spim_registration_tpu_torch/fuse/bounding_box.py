"""Fusion bounding-box estimation in world coordinates.

Copy of the reference's `fuse/bounding_box.py` (host numpy): maximal
(union of transformed view intervals), intersection, define-from-interest-
points (`AutomaticBoundingBox` uses detections) and the PCA
reorientation. All return integer (min, max-exclusive) (z, y, x) tuples.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from spim_registration_tpu_torch.core.dataset import BoundingBox


def _transformed_corners(size, model: np.ndarray) -> np.ndarray:
    z, y, x = size
    corners = np.array([
        [a, b, c]
        for a in (0.0, z - 1.0)
        for b in (0.0, y - 1.0)
        for c in (0.0, x - 1.0)
    ])
    return corners @ model[:, :3].T + model[:, 3]


def maximal_bounding_box(sizes: Sequence[Tuple[int, int, int]],
                         models: Sequence[np.ndarray],
                         name: str = "max") -> BoundingBox:
    """Union of all transformed view intervals (the reference's 'Maximal
    Bounding Box' / BoundingBoxMaximal)."""
    mins = np.full(3, np.inf)
    maxs = np.full(3, -np.inf)
    for size, model in zip(sizes, models):
        c = _transformed_corners(size, model)
        mins = np.minimum(mins, c.min(axis=0))
        maxs = np.maximum(maxs, c.max(axis=0))
    lo = np.floor(mins).astype(int)
    hi = np.ceil(maxs).astype(int) + 1
    return BoundingBox(name, tuple(lo), tuple(hi))


def intersect_bounding_box(sizes: Sequence[Tuple[int, int, int]],
                           models: Sequence[np.ndarray],
                           name: str = "overlap") -> BoundingBox:
    """Intersection of transformed view intervals — the region seen by all
    views (used by deconvolution preparation)."""
    mins = np.full(3, -np.inf)
    maxs = np.full(3, np.inf)
    for size, model in zip(sizes, models):
        c = _transformed_corners(size, model)
        mins = np.maximum(mins, c.min(axis=0))
        maxs = np.minimum(maxs, c.max(axis=0))
    if np.any(mins >= maxs):
        raise ValueError("views do not overlap; empty intersection box")
    lo = np.floor(mins).astype(int)
    hi = np.ceil(maxs).astype(int) + 1
    return BoundingBox(name, tuple(lo), tuple(hi))


def bounding_box_from_points(points_world: np.ndarray, margin: int = 10,
                             name: str = "points") -> BoundingBox:
    """Box around transformed interest points plus a margin (the
    reference's AutomaticBoundingBox from detections)."""
    lo = np.floor(points_world.min(axis=0)).astype(int) - margin
    hi = np.ceil(points_world.max(axis=0)).astype(int) + margin + 1
    return BoundingBox(name, tuple(lo), tuple(hi))


def automatic_reorientation(points_world: np.ndarray, margin: int = 10):
    """Minimal-volume reorientation (the reference's
    `AutomaticReorientation`): PCA of the interest-point cloud gives a
    rotation that axis-aligns the sample; returns (rotation (3,4) affine
    to prepend to every view, BoundingBox in the rotated frame).
    """
    pts = np.asarray(points_world, float)
    c = pts.mean(axis=0)
    cov = np.cov((pts - c).T)
    _w, V = np.linalg.eigh(cov)
    R = V.T[::-1]  # principal axis first (z)
    if np.linalg.det(R) < 0:
        R[2] *= -1
    rot = np.concatenate([R, (c - R @ c)[:, None]], axis=1)
    moved = (pts - c) @ R.T + c
    lo = np.floor(moved.min(axis=0)).astype(int) - margin
    hi = np.ceil(moved.max(axis=0)).astype(int) + margin + 1
    return rot, BoundingBox("reoriented", tuple(lo), tuple(hi))
