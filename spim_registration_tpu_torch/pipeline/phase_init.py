"""Phase-correlation translation initialization for a set of views.

Port of the reference's `pipeline/phase_init.py`: pairwise shifts from
the normalized cross-power spectrum, reconciled into per-view
translations by a least-squares graph solve (t_j - t_i = shift_ij), for
use as initial models (tile stitching, ICP seeds).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from spim_registration_tpu_torch.ops.phase_correlation import (
    phase_correlation_shift,
)
from spim_registration_tpu_torch.utils.log import get_logger

logger = get_logger("phase_init")


def translation_init(
    volumes: Sequence[np.ndarray],
    pairs: Optional[Sequence[Tuple[int, int]]] = None,
    fixed_view: int = 0,
    min_correlation: float = 0.1,
    device=None,
) -> List[np.ndarray]:
    """Per-view (3,4) translation models from pairwise phase correlation.

    Solves min over t of sum_(i,j) ||(t_j - t_i) - shift_ij||^2 with
    t_fixed = 0, weighting each pair by its overlap correlation.
    `device`: where the correlations run (default CUDA; "cpu")."""
    V = len(volumes)
    if pairs is None:
        pairs = [(i, j) for i in range(V) for j in range(i + 1, V)]

    rows, rhs, wts = [], [], []
    for (i, j) in pairs:
        # shift s such that view_j(x) ~= view_i(x - s): then t_j - t_i = s
        s, corr = phase_correlation_shift(volumes[i], volumes[j],
                                          subpixel=True, device=device)
        logger.info("phase pair (%d,%d): shift=%s corr=%.3f", i, j,
                    np.round(s, 2), corr)
        if corr < min_correlation:
            continue
        row = np.zeros(V)
        row[j] = 1.0
        row[i] = -1.0
        rows.append(row)
        rhs.append(s)
        wts.append(max(corr, 1e-3))

    t = np.zeros((V, 3))
    if rows:
        A = np.asarray(rows)
        b = np.asarray(rhs)
        w = np.sqrt(np.asarray(wts))[:, None]
        # gauge: drop the fixed view's column
        free = [v for v in range(V) if v != fixed_view]
        sol, *_ = np.linalg.lstsq(A[:, free] * w, b * w, rcond=None)
        t[free] = sol
    return [np.concatenate([np.eye(3), t[v][:, None]], axis=1)
            for v in range(V)]
