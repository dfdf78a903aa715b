"""Bounding boxes and the identity view transform.

Copy of the reference's `core/dataset.py` `BoundingBox` and
`identity_transform` (host numpy only). The `Dataset` tree and its XML
layer belong to the CLI slice.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


def identity_transform() -> np.ndarray:
    return np.concatenate([np.eye(3), np.zeros((3, 1))], axis=1)


@dataclasses.dataclass
class BoundingBox:
    """Named fusion ROI in world coordinates (inclusive min, exclusive max)."""

    name: str
    min: Tuple[int, int, int]  # (z, y, x)
    max: Tuple[int, int, int]  # (z, y, x) exclusive

    @property
    def shape(self) -> Tuple[int, int, int]:
        return tuple(int(b - a) for a, b in zip(self.min, self.max))
