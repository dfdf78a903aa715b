"""Batched multi-pair matching: all view pairs in one batch.

Port of the reference's `match/batched.py` (one vmapped program for all
pairs): here the pair axis is the leading batch axis of the device
functions in `match/pairwise.py`. The reference's `mesh` sharding of the
pair axis waits for the multi-device port.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from spim_registration_tpu_torch.match.pairwise import (
    PairwiseParameters,
    PairwiseResult,
    _match_device,
    _results,
)
from spim_registration_tpu_torch.utils.device import resolve_device


def _bucket_pairs(n_pairs: int) -> int:
    """Round the pair count up to the next power of two (min 8), the
    reference's batch layout: the batch's tensor shapes stay in a
    logarithmic set across calls with different pair counts (so the CUDA
    caching allocator reuses its blocks), and slot k is the slot the
    reference's k-th key drives. Excess slots carry no valid points and
    are dropped on the host."""
    b = 8
    while b < n_pairs:
        b *= 2
    return b


def _slot_seed(seed: int, k: int) -> int:
    """The RANSAC seed of batch slot k: seed * 2^20 + k (the port's fixed
    rule in place of the reference's `jax.random.split`)."""
    return seed * (1 << 20) + k


def match_pairs_batched(
    points: Sequence[np.ndarray],
    pairs: Sequence[Tuple[int, int]],
    params: PairwiseParameters = PairwiseParameters(),
    seed: int = 0,
    device=None,
) -> Dict[Tuple[int, int], PairwiseResult]:
    """Match many view pairs in one batch on the device.

    Args:
      points: per-view (N_v, 3) interest points.
      pairs: list of (i, j) view-index pairs.
      seed: slot k of the batch draws its RANSAC hypotheses from a
        generator seeded with `_slot_seed(seed, k)`.
      device: CUDA unless another device is named.

    Returns {pair: PairwiseResult} like repeated `match_pair` calls."""
    dev = resolve_device(device)
    n = params.max_points
    V = len(points)
    padded = np.zeros((V, n, 3), np.float32)
    valid = np.zeros((V, n), bool)
    for v, pts in enumerate(points):
        m = min(len(pts), n)
        padded[v, :m] = pts[:m]
        valid[v, :m] = True

    B = _bucket_pairs(len(pairs))
    ia = np.zeros(B, np.int64)
    ib = np.zeros(B, np.int64)
    ia[:len(pairs)] = [p[0] for p in pairs]
    ib[:len(pairs)] = [p[1] for p in pairs]
    va = valid[ia]
    vb = valid[ib]
    va[len(pairs):] = False  # bucket-padding slots match nothing
    vb[len(pairs):] = False
    seeds = [_slot_seed(seed, k) for k in range(B)]
    j, ok, res = _match_device(
        seeds, torch.from_numpy(padded[ia]).to(dev),
        torch.from_numpy(va).to(dev), torch.from_numpy(padded[ib]).to(dev),
        torch.from_numpy(vb).to(dev), params)
    return dict(zip(pairs, _results(j, ok, res, len(pairs))))
