"""Batched-hypothesis RANSAC for 3D point-correspondence model fitting.

Port of the reference's `models/ransac.py` (mpicbg `Model.filterRansac`
reformulated): all hypotheses are drawn at once, fitted with the batched
closed-form fits, scored against every candidate, and the best one is
refitted on its inlier set. Here the batch also spans view pairs:
`filter_ransac_batched` runs (B, N) candidate sets in one call.

Sampling is split in two so that tests can feed the reference's own
draws: `_draw_uniforms` makes the uniforms on the CPU from one
`torch.Generator` per batch row (so the card and the CPU draw the same
hypotheses), and the deterministic `floor(u * max(num_valid, 1))`,
clipped, turns them into candidate indices on the device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch

from spim_registration_tpu_torch.models import affine as _aff


@dataclasses.dataclass(frozen=True)
class RansacParameters:
    """Mirrors the reference's RANSACParameters defaults."""

    num_hypotheses: int = 1024
    max_epsilon: float = 5.0          # px
    min_inlier_ratio: float = 0.1
    min_inlier_factor: float = 3.0    # inliers >= factor * model min points
    refit_rounds: int = 2             # inlier refit iterations after the vote
    # adaptive hypothesis count: hypotheses run in chunks of
    # `hypothesis_chunk` until N >= log(1 - confidence) / log(1 - w^m)
    # for the best inlier ratio w seen; `num_hypotheses` is then the cap
    adaptive: bool = False
    hypothesis_chunk: int = 128
    adaptive_confidence: float = 0.999


@dataclasses.dataclass
class RansacResult:
    model: torch.Tensor        # (..., 3, 4) best-fit affine
    inlier_mask: torch.Tensor  # (..., N) bool over the padded candidates
    num_inliers: torch.Tensor  # (...) int32
    num_candidates: torch.Tensor  # (...) int32 (valid candidates)
    mean_error: torch.Tensor   # (...) mean residual over inliers
    max_error: torch.Tensor    # (...) max residual over inliers
    valid: torch.Tensor        # (...) bool — the reference's acceptance


def _draw_uniforms(seeds: Sequence[int], shape) -> torch.Tensor:
    """(len(seeds), *shape) float32 uniforms in [0, 1) on the CPU, row b
    drawn from a `torch.Generator` seeded with seeds[b]."""
    rows = []
    for s in seeds:
        g = torch.Generator().manual_seed(int(s))
        rows.append(torch.rand(tuple(shape), generator=g,
                               dtype=torch.float32))
    return torch.stack(rows)


def _sample_indices(u: torch.Tensor, num_valid: torch.Tensor,
                    n_pad: int) -> torch.Tensor:
    """Candidate indices in [0, num_valid) from uniforms u (B, H, m).
    Duplicates within a hypothesis are harmless: such fits lose the vote."""
    nv = torch.clamp(num_valid, min=1).to(u.dtype)
    idx = torch.floor(u * nv[:, None, None]).to(torch.int64)
    return idx.clamp(0, n_pad - 1)


def filter_ransac_batched(seeds: Sequence[int], p: torch.Tensor,
                          q: torch.Tensor, valid: torch.Tensor,
                          model: str = "affine",
                          params: RansacParameters = RansacParameters()
                          ) -> RansacResult:
    """RANSAC-filter B padded candidate sets p[b, i] -> q[b, i] at once.

    p, q (B, N, 3); valid (B, N) bool; seeds: one int per row (the draws
    of row b come from `_draw_uniforms` with seeds[b]). Runs on p's
    device. Returns a RansacResult with a leading B axis."""
    B, n_pad, _ = p.shape
    dev = p.device
    m = _aff.MODEL_MIN_POINTS[model]
    # a couple of extra points per hypothesis for stability, as the
    # reference samples (minimal affine sets are often ill-conditioned)
    sample = m if model == "translation" else m + 1
    wvalid = valid.to(p.dtype)
    num_valid = valid.sum(dim=1, dtype=torch.int32)
    rows = torch.arange(B, device=dev)

    def chunk_best(u):
        """Fit + vote the hypotheses of uniforms u (B, H, m): the best
        count and model per row (first hypothesis among equal counts)."""
        idx = _sample_indices(u, num_valid, n_pad)
        r3 = rows[:, None, None]
        hyps = _aff.fit_model(model, p[r3, idx], q[r3, idx],
                              wvalid[r3, idx])              # (B, H, 3, 4)
        res = _aff.residuals(hyps, p[:, None], q[:, None])   # (B, H, N)
        inl = (res <= params.max_epsilon) & valid[:, None, :]
        counts = inl.sum(dim=2, dtype=torch.int32)
        b = torch.argmax(counts, dim=1)
        return counts[rows, b], hyps[rows, b]

    if not params.adaptive:
        u = _draw_uniforms(seeds, (params.num_hypotheses, sample)).to(dev)
        best_count, best_model = chunk_best(u)
    else:
        C = min(params.hypothesis_chunk, params.num_hypotheses)
        n_chunks = -(-params.num_hypotheses // C)
        u = _draw_uniforms(seeds, (n_chunks, C, sample)).to(dev)
        log1mp = math.log(max(1.0 - params.adaptive_confidence, 1e-12))
        best_count = torch.full((B,), -1, dtype=torch.int32, device=dev)
        best_model = torch.zeros((B, 3, 4), dtype=p.dtype, device=dev)
        nv = torch.clamp(num_valid, min=1).to(p.dtype)
        for k in range(n_chunks):
            # classic adaptive stop, per row: seen >= log(1-conf)/log(1-w^m)
            w = best_count.to(p.dtype) / nv
            miss = torch.clamp(1.0 - torch.clamp(w, min=0.0) ** sample,
                               1e-6, 1.0 - 1e-6)
            needed = log1mp / torch.log(miss)
            active = torch.tensor(float(k * C), dtype=p.dtype,
                                  device=dev) < needed
            if not bool(active.any()):
                break
            c, m_ = chunk_best(u[:, k])
            better = active & (c > best_count)
            best_count = torch.where(better, c, best_count)
            best_model = torch.where(better[:, None, None], m_, best_model)

    mask = (_aff.residuals(best_model, p, q) <= params.max_epsilon) & valid
    A = best_model
    for _ in range(max(params.refit_rounds, 1)):
        A = _aff.fit_model(model, p, q, mask.to(p.dtype))
        mask = (_aff.residuals(A, p, q) <= params.max_epsilon) & valid

    r = _aff.residuals(A, p, q)
    n_in = mask.sum(dim=1, dtype=torch.int32)
    mean_err = (r * mask.to(p.dtype)).sum(dim=1) \
        / torch.clamp(n_in, min=1).to(p.dtype)
    max_err = torch.where(mask, r, torch.zeros_like(r)).amax(dim=1)
    ok = ((n_in >= int(params.min_inlier_factor * m))
          & (n_in.to(p.dtype) >= params.min_inlier_ratio
             * torch.clamp(num_valid, min=1).to(p.dtype))
          & (num_valid >= m))
    return RansacResult(model=A, inlier_mask=mask, num_inliers=n_in,
                        num_candidates=num_valid, mean_error=mean_err,
                        max_error=max_err, valid=ok)


def filter_ransac(seed: int, p: torch.Tensor, q: torch.Tensor,
                  valid: torch.Tensor, model: str = "affine",
                  params: RansacParameters = RansacParameters()
                  ) -> RansacResult:
    """RANSAC-filter one padded candidate set p[i] -> q[i] (N, 3) with
    validity mask (N,); the draws come from a generator seeded with
    `seed`. `.valid` is the reference's acceptance rule (enough inliers
    in absolute and ratio terms)."""
    res = filter_ransac_batched([seed], p[None], q[None], valid[None],
                                model, params)
    return RansacResult(**{f.name: getattr(res, f.name)[0]
                           for f in dataclasses.fields(res)})
