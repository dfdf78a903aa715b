"""Timelapse registration + stabilization.

Port of the reference's `pipeline/timelapse.py` (SURVEY.md sections 0.6,
2.9 timelapse row, 2.4 `ReferenceTimepointRegistration`): register each
timepoint's views internally, then stabilize the whole series by matching
every timepoint's detections against a reference timepoint and applying
the per-timepoint correction to all of its views. Quality statistics per
timepoint mirror `RegistrationStatistics` (min/avg/max residual, inlier
counts).

Per-timepoint detection and matching run on the entry point's device
(`register_views`, `match_pair`); the pools of registered points and
their dedupe stay on the host (a few KB a timepoint).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from spim_registration_tpu_torch.match.pairwise import match_pair
from spim_registration_tpu_torch.pipeline.run import (
    RegistrationConfig,
    RegistrationResult,
    register_views,
)
from spim_registration_tpu_torch.utils.device import resolve_device
from spim_registration_tpu_torch.utils.log import get_logger

logger = get_logger("timelapse")


def _dedupe(points: np.ndarray, min_distance: float = 1.0) -> np.ndarray:
    """Merge near-duplicate points (the same bead seen by several already-
    registered views) — duplicates at ~0 distance would degenerate the
    kNN descriptor constellations. Greedy in input order over a grid hash
    whose cells are `p // cell` (floored, negative coordinates included)."""
    if len(points) == 0:
        return points
    kept: List[int] = []
    cell = max(min_distance, 1e-6)
    grid: Dict[tuple, List[int]] = {}
    for i, p in enumerate(points):
        key = tuple((p // cell).astype(int))
        dup = False
        for dz in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    for j in grid.get((key[0] + dz, key[1] + dy,
                                       key[2] + dx), []):
                        if np.linalg.norm(points[j] - p) < min_distance:
                            dup = True
                            break
        if not dup:
            kept.append(i)
            grid.setdefault(key, []).append(i)
    return points[kept]


@dataclasses.dataclass
class TimepointStatistics:
    """RegistrationStatistics analog: per-timepoint quality numbers."""

    timepoint: int
    num_candidates: int
    num_inliers: int
    mean_error: float
    max_error: float
    valid: bool


@dataclasses.dataclass
class TimelapseResult:
    per_timepoint: Dict[int, RegistrationResult]
    stabilization: Dict[int, np.ndarray]   # tp -> (3,4) correction
    statistics: List[TimepointStatistics]
    models: Dict[Tuple[int, int], np.ndarray]  # (tp, view) -> final affine


def register_timeseries(
    volumes_by_tp: Dict[int, Sequence[np.ndarray]],
    config: RegistrationConfig = RegistrationConfig(),
    reference_tp: Optional[int] = None,
    stabilize: bool = True,
    device=None,
) -> TimelapseResult:
    """Per-timepoint registration + optional series stabilization.

    Args:
      volumes_by_tp: tp -> list of view volumes.
      reference_tp: stabilization target (default: middle timepoint, like
        the reference's default choice of a good reference).
      device: where detection and matching run: CUDA unless another
        device is named.
    """
    dev = resolve_device(device)
    tps = sorted(volumes_by_tp)
    if reference_tp is None:
        reference_tp = tps[len(tps) // 2]

    per_tp: Dict[int, RegistrationResult] = {}
    for tp in tps:
        logger.info("registering timepoint %d", tp)
        per_tp[tp] = register_views(volumes_by_tp[tp], config, device=dev)

    stabilization: Dict[int, np.ndarray] = {}
    stats: List[TimepointStatistics] = []
    ident = np.concatenate([np.eye(3), np.zeros((3, 1))], axis=1)

    if stabilize:
        # Pool each timepoint's detections in its REGISTERED world frame,
        # then match each tp's pool against the reference tp's pool.
        pools: Dict[int, np.ndarray] = {}
        for tp in tps:
            res = per_tp[tp]
            parts = []
            for v, pts in enumerate(res.points):
                A = res.models[v]
                parts.append(pts @ A[:, :3].T + A[:, 3])
            pool = (np.concatenate(parts, axis=0) if parts
                    else np.zeros((0, 3)))
            pools[tp] = _dedupe(pool, min_distance=1.0)

        ref_pool = pools[reference_tp]
        for tp in tps:
            if tp == reference_tp or len(pools[tp]) == 0:
                stabilization[tp] = ident.copy()
                stats.append(TimepointStatistics(tp, 0, 0, 0.0, 0.0,
                                                 tp == reference_tp))
                continue
            res = match_pair(pools[tp], ref_pool, config.pairwise,
                             seed=1000 + tp, device=dev)
            logger.info("stabilize tp=%d vs ref=%d: %s", tp, reference_tp,
                        res)
            stabilization[tp] = res.model if res.valid else ident.copy()
            stats.append(TimepointStatistics(
                tp, res.num_candidates, res.num_inliers, res.mean_error,
                res.max_error, res.valid))
    else:
        for tp in tps:
            stabilization[tp] = ident.copy()

    models: Dict[Tuple[int, int], np.ndarray] = {}
    for tp in tps:
        S4 = np.vstack([stabilization[tp], [0, 0, 0, 1]])
        for v, A in enumerate(per_tp[tp].models):
            A4 = np.vstack([A, [0, 0, 0, 1]])
            models[(tp, v)] = (S4 @ A4)[:3]

    return TimelapseResult(per_timepoint=per_tp, stabilization=stabilization,
                           statistics=stats, models=models)
