"""End-to-end registration orchestration.

Port of the reference's `pipeline/run.py` (`Interest_Point_Detection` +
`Interest_Point_Registration`): detect per view, match selected pairs,
global-optimize, concatenate with each view's initial (calibration)
transform. Detection and matching run on the entry point's device; the
global solve is host float64 with device assembly for large match counts.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from spim_registration_tpu_torch.detect.dog import DoGParameters, detect_beads
from spim_registration_tpu_torch.match.batched import match_pairs_batched
from spim_registration_tpu_torch.match.pairwise import (
    PairwiseParameters,
    PairwiseResult,
    match_pair,
)
from spim_registration_tpu_torch.solve.global_opt import (
    GlobalOptParameters,
    GlobalOptResult,
    PairMatches,
    solve_global,
)
from spim_registration_tpu_torch.utils.device import resolve_device
from spim_registration_tpu_torch.utils.log import get_logger
from spim_registration_tpu_torch.utils.profiling import stage_timer

logger = get_logger("pipeline")


@dataclasses.dataclass(frozen=True)
class RegistrationConfig:
    detection: DoGParameters = DoGParameters()
    pairwise: PairwiseParameters = PairwiseParameters()
    # the pipeline opts in to post-solve wrong-link trimming (2 rounds);
    # bare solve_global defaults to 0
    global_opt: GlobalOptParameters = GlobalOptParameters(
        outlier_trim_rounds=2)
    # retry invalid pairs with this matching method (the manual
    # GH-vs-RGLDM method switch of the reference GUI, automated);
    # None disables the fallback
    fallback_method: Optional[str] = "rgldm"
    fallback_ratio_of_distance: float = 2.0


@dataclasses.dataclass
class RegistrationResult:
    models: List[np.ndarray]            # final (3,4) view -> world affines
    points: List[np.ndarray]            # detected points per view
    pair_results: Dict[Tuple[int, int], PairwiseResult]
    global_result: Optional[GlobalOptResult]
    mean_error: float
    max_error: float
    timings: Dict[str, float]


def register_views(
    volumes: Sequence[np.ndarray],
    config: RegistrationConfig = RegistrationConfig(),
    pairs: Optional[Sequence[Tuple[int, int]]] = None,
    fixed_views: Sequence[int] = (0,),
    initial_models: Optional[Sequence[np.ndarray]] = None,
    points: Optional[Sequence[np.ndarray]] = None,
    device=None,
    mesh=None,
) -> RegistrationResult:
    """Register N views: detect -> pairwise match -> global solve.

    Args:
      volumes: per-view 3D images.
      pairs: view-index pairs to match (default all-to-all).
      fixed_views: gauge-fixed views (default view 0).
      initial_models: per-view starting transforms (default identity) —
        the calibration the reference pre-concatenates.
      points: pre-detected per-view interest points (skips detection).
      device: where detection, matching and the solve's device assembly
        run: CUDA unless another device is named.
      mesh: a `parallel.Mesh`: detection runs z-sharded over its last axis
        (`parallel.sharded_detect_beads`) and batched matching shards its
        pair axis over every position; the single-pair match, the
        fallback matches and the solve run on the mesh's first device (of
        this process, where the mesh spans processes).
    """
    dev = mesh.first_device() if mesh is not None else resolve_device(device)
    V = len(volumes) if volumes is not None else len(points)
    timings: Dict[str, float] = {}
    ident = np.concatenate([np.eye(3), np.zeros((3, 1))], axis=1)
    init = ([np.asarray(m, np.float64) for m in initial_models]
            if initial_models is not None else [ident.copy() for _ in range(V)])

    with stage_timer("detect", timings):
        if points is None:
            points = []
            for i, vol in enumerate(volumes):
                if mesh is not None:
                    from spim_registration_tpu_torch.parallel.sharded_detect \
                        import sharded_detect_beads

                    pts, _ = sharded_detect_beads(
                        np.asarray(vol), config.detection, mesh,
                        axis_name=mesh.axis_names[-1])
                else:
                    pts, _ = detect_beads(vol, config.detection, device=dev)
                logger.info("detect view=%d points=%d", i, len(pts))
                points.append(pts)
        else:
            points = [np.asarray(p) for p in points]

    if pairs is None:
        pairs = [(i, j) for i in range(V) for j in range(i + 1, V)]

    with stage_timer("match", timings):
        matches: List[PairMatches] = []

        def _map(init_m, pts):
            return pts @ init_m[:, :3].T + init_m[:, 3]

        # Match in CALIBRATED space: descriptors are rotation-invariant, so
        # the initial transforms (calibration / phase-corr init) must be
        # applied to the points first — the reference likewise transforms
        # interest points with the current model before pairwise matching
        # (TransformationTools, SURVEY.md section 2.4).
        cal_points = [_map(init[v], np.asarray(points[v])) for v in range(V)]

        if len(pairs) > 1:
            pair_results = match_pairs_batched(cal_points, pairs,
                                               config.pairwise, device=dev,
                                               mesh=mesh)
        else:
            pair_results = {
                (i, j): match_pair(cal_points[i], cal_points[j],
                                   config.pairwise, seed=i * V + j, device=dev)
                for (i, j) in pairs}

        failed = [p for p in pairs if not pair_results[p].valid]
        if failed and config.fallback_method is not None \
                and config.fallback_method != config.pairwise.method:
            fb = dataclasses.replace(
                config.pairwise, method=config.fallback_method,
                ratio_of_distance=config.fallback_ratio_of_distance)
            logger.info("retrying %d invalid pairs with %s", len(failed),
                        config.fallback_method)
            for (i, j) in failed:
                res = match_pair(cal_points[i], cal_points[j], fb,
                                 seed=i * V + j + 7, device=dev)
                if res.valid:
                    pair_results[(i, j)] = res

        for (i, j) in pairs:
            res = pair_results[(i, j)]
            logger.info("match pair=(%d,%d) %s", i, j, res)
            if not res.valid or len(res.inliers) == 0:
                continue
            matches.append(PairMatches(
                view_i=i, view_j=j,
                p=cal_points[i][res.inliers[:, 0]],
                q=cal_points[j][res.inliers[:, 1]]))

    if not matches:
        return RegistrationResult(
            models=init, points=list(points), pair_results=pair_results,
            global_result=None, mean_error=float("nan"),
            max_error=float("nan"), timings=timings)

    with stage_timer("solve", timings):
        gres = solve_global(matches, fixed_views=list(fixed_views),
                            params=config.global_opt, device=dev)
    logger.info("global solve: mean=%.4f max=%.4f px (%d iters)",
                gres.mean_error, gres.max_error, gres.iterations)

    models = []
    for v in range(V):
        B = gres.corrections.get(
            v, np.concatenate([np.eye(3), np.zeros((3, 1))], axis=1))
        B4 = np.vstack([B, [0, 0, 0, 1]])
        A4 = np.vstack([init[v], [0, 0, 0, 1]])
        models.append((B4 @ A4)[:3])

    return RegistrationResult(
        models=models, points=list(points), pair_results=pair_results,
        global_result=gres, mean_error=gres.mean_error,
        max_error=gres.max_error, timings=timings)
