"""Headless detection-parameter tuning.

Port of the reference's `detect/tune.py` (the `InteractiveDoG` slider
window replaced by a batch sweep): the DoG response is evaluated once per
sigma and its peaks counted for a grid of thresholds, so a user or an
auto-tuner can pick parameters without a GUI.

The reference masks strict 26-neighbourhood maxima off the border
(`local_extrema_mask`), sets every other voxel to 0 and counts responses
>= t. For t > 0 the voxels off the mask never count, and the port takes
the maxima from `ops.extrema.find_peaks` (the segment top-k kernel on the
card): its valid rows are the interior strict maxima with |response| >=
its threshold, so with the budget set to the candidate count and the
smallest positive threshold of the grid, the maxima with response >= t
are exactly the valid rows whose response is >= t. For t <= 0 every
voxel off the mask counts as well, so the port counts as the reference
does: the masked maxima with response >= t plus the voxels off the mask.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from spim_registration_tpu_torch.ops.extrema import (
    candidate_score,
    find_peaks,
    local_extrema_mask,
)
from spim_registration_tpu_torch.ops.gaussian import (
    difference_of_gaussian,
    dog_sigmas,
)
from spim_registration_tpu_torch.utils.device import resolve_device

# the smallest positive float32: |dog| >= it is |dog| > 0
_TINY = float(np.nextafter(np.float32(0), np.float32(1)))


def _normalized(vol, device) -> torch.Tensor:
    v = torch.as_tensor(np.asarray(vol, np.float32), device=device)
    lo, hi = v.min(), v.max()
    return (v - lo) / torch.clamp(hi - lo, min=1e-12)


def _dog(v: torch.Tensor, sigma: float) -> torch.Tensor:
    s1, s2, norm = dog_sigmas(float(sigma), 0.0)
    return difference_of_gaussian(v, s1, s2) * np.float32(norm)


def _maxima_responses(dog: torch.Tensor, threshold: float) -> torch.Tensor:
    """Responses of all interior strict DoG maxima with |response| >=
    `threshold` (any order)."""
    n = int(torch.isfinite(candidate_score(dog, threshold)).sum())
    if n == 0:
        return dog.new_zeros((0,))
    _, resp, valid = find_peaks(dog, threshold, max_peaks=n)
    return resp[valid]


def sweep_detection(vol: np.ndarray,
                    sigmas: Sequence[float] = (1.4, 1.8, 2.2, 2.8),
                    thresholds: Sequence[float] = (0.002, 0.005, 0.008,
                                                   0.012, 0.02),
                    normalize: bool = True,
                    device=None) -> Dict[Tuple[float, float], int]:
    """Peak counts for every (sigma, threshold) combination. `device`:
    default CUDA; "cpu" runs on the host."""
    dev = resolve_device(device)
    if normalize:
        v = _normalized(vol, dev)
    else:
        v = torch.as_tensor(np.asarray(vol, np.float32), device=dev)
    positive = [t for t in thresholds if t > 0]
    out: Dict[Tuple[float, float], int] = {}
    for s in sigmas:
        dog = _dog(v, s)
        if positive:
            resp = _maxima_responses(dog, max(min(positive), _TINY))
        if len(positive) < len(thresholds):
            mask = local_extrema_mask(dog)
            off_mask = int((~mask).sum())
        for t in thresholds:
            if t > 0:
                n = int((resp >= t).sum())
            else:
                n = int((mask & (dog >= t)).sum()) + off_mask
            out[(float(s), float(t))] = n
    return out


def suggest_threshold(vol: np.ndarray, sigma: float = 1.8,
                      expected_points: int | None = None,
                      quantile: float = 0.999, device=None) -> float:
    """Suggest a threshold: either the response level yielding roughly
    `expected_points` peaks, or a high quantile of the extremum responses
    (robust to the noise floor). `device`: default CUDA; "cpu"."""
    resp = _maxima_responses(
        _dog(_normalized(vol, resolve_device(device)), sigma), _TINY)
    resp = resp[resp > 0].cpu().numpy()
    if len(resp) == 0:
        return 0.0
    if expected_points is not None and expected_points < len(resp):
        return float(np.partition(resp, -expected_points)[-expected_points])
    return float(np.quantile(resp, quantile))
