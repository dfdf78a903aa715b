"""Center-of-mass pairwise alignment (translation only).

Port of the reference's `match/centerofmass.py`
(`centerofmass/CenterOfMassPairwise`): align two views by the difference
of their detections' mean (or median), the crudest but most robust
initializer.
"""

from __future__ import annotations

import numpy as np


def center_of_mass_translation(points_a: np.ndarray, points_b: np.ndarray,
                               use_median: bool = False) -> np.ndarray:
    """(3,4) translation mapping A's center onto B's."""
    agg = np.median if use_median else np.mean
    t = agg(np.asarray(points_b), axis=0) - agg(np.asarray(points_a), axis=0)
    return np.concatenate([np.eye(3), np.asarray(t)[:, None]], axis=1)
