"""The truth that a registration pass is held to, in plain numpy.

A simulated acquisition knows every view's true view -> world affine and
every bead's position. Two numbers judge a registered timepoint:

- `model_err_px`: for each view, the mean distance between the true beads
  of the timepoint mapped into the world by the registered model and by
  the true one; the worst view.
- `point_err_px`: for each view, the detected points mapped into the
  world by the true model, each one's distance to the nearest true bead;
  the median per view, the worst view.

The control puts the truth, rounded to bfloat16 (the nearest precision
below the float32 of the acquisition), in the program's place.
Imports nothing of the port.
"""

from __future__ import annotations

import numpy as np


def apply(A: np.ndarray, pts: np.ndarray) -> np.ndarray:
    return pts @ A[:, :3].T + A[:, 3]


def view_points(models, world: np.ndarray) -> list:
    out = []
    for A in models:
        inv = np.linalg.inv(np.vstack([A, [0, 0, 0, 1]]))[:3]
        out.append(apply(inv, world))
    return out


def model_err_px(got_models, true_models, world: np.ndarray) -> float:
    errs = []
    for g, t, p in zip(got_models, true_models,
                       view_points(true_models, world)):
        d = apply(np.asarray(g, np.float64), p) - apply(t, p)
        errs.append(float(np.mean(np.linalg.norm(d, axis=1))))
    return max(errs)


def point_err_px(got_points, true_models, world: np.ndarray) -> float:
    """Inf for a view without a detected point."""
    errs = []
    for pts, A in zip(got_points, true_models):
        pts = np.asarray(pts, np.float64).reshape(-1, 3)
        if len(pts) == 0:
            return float("inf")
        w = apply(A, pts)
        d = np.sqrt(((w[:, None, :] - world[None, :, :]) ** 2).sum(-1))
        errs.append(float(np.median(d.min(axis=1))))
    return max(errs)


def bf16(x: np.ndarray) -> np.ndarray:
    """Round float values to the nearest bfloat16 (ties to even)."""
    f = np.asarray(x, np.float32)
    u = f.view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32).astype(np.float64)


def control_answer(true_models, world: np.ndarray) -> tuple:
    """The truth in bfloat16 in the program's place: (models, points in
    each view's frame)."""
    return ([bf16(A) for A in true_models],
            [bf16(p) for p in view_points(true_models, world)])
