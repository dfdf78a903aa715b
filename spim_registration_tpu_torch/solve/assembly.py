"""Device-side assembly of the pose-graph normal equations.

Port of the reference's `solve/assembly.py` (`_design`,
`assemble_normal_equations`). The reference scatter-adds per-match blocks
into H and g; on CUDA a scatter-add (`index_add_`, `index_put_` with
accumulate) uses float atomics whose order changes from run to run, so the
solve would not repeat bit for bit. Here the assembly is deterministic:
each match's Jacobian rows are lifted into the free-parameter columns with
one-hot tile matrices, J (N*3, n_free*P), and H = J^T W J, g = J^T W r0 are
two matrix products. `n_free` <= views - 1 and P <= 12, so J has at most
84 columns for 8 views. `assemble_normal_equations_sharded` splits the
matches over a mesh axis and sums the per-shard (H, g) (`mesh.psum`).
"""

from __future__ import annotations

import numpy as np
import torch

_PARAMS = {"translation": 3, "rigid": 6, "affine": 12}


def _design(model: str, pts: torch.Tensor) -> torch.Tensor:
    """(N, 3, P) design matrices; see solve.global_opt._linear_design."""
    z, y, x = pts[:, 0], pts[:, 1], pts[:, 2]
    zero = torch.zeros_like(z)
    one = torch.ones_like(z)
    if model == "translation":
        rows = [
            [one, zero, zero],
            [zero, one, zero],
            [zero, zero, one],
        ]
    elif model == "rigid":
        rows = [
            [zero, x, -y, one, zero, zero],
            [-x, zero, z, zero, one, zero],
            [y, -z, zero, zero, zero, one],
        ]
    elif model == "affine":
        rows = [
            [z, y, x] + [zero] * 6 + [one, zero, zero],
            [zero] * 3 + [z, y, x] + [zero] * 3 + [zero, one, zero],
            [zero] * 6 + [z, y, x] + [zero, zero, one],
        ]
    else:
        raise ValueError(model)
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=1)


def assemble_normal_equations(model: str, n_free: int, pc: torch.Tensor,
                              qc: torch.Tensor, w: torch.Tensor,
                              col_i: torch.Tensor, col_j: torch.Tensor):
    """Assemble H (dim, dim) and g (dim,) for residuals r = pc - qc.

    Args:
      pc, qc: (N, 3) corresponding points already mapped by the current
        tile transforms (the linearization point).
      w: (N,) weights (0 for padding rows).
      col_i, col_j: (N,) free-column index of each side's tile, or -1 for
        fixed tiles (their rows drop out of H and g).
    """
    P = _PARAMS[model]
    dim = n_free * P

    def lifted(pts, col):
        onehot = (col[:, None] == torch.arange(
            n_free, device=col.device)[None, :]).to(pts.dtype)
        X = _design(model, pts)                              # (N, 3, P)
        return (onehot[:, None, :, None] * X[:, :, None, :]).reshape(
            -1, dim)                                         # (N*3, dim)

    J = lifted(pc, col_i) - lifted(qc, col_j)
    r0 = (pc - qc).reshape(-1)
    JW = J * w.repeat_interleave(3)[:, None]
    return JW.T @ J, JW.T @ r0


def assemble_normal_equations_sharded(mesh, axis: str, model: str,
                                      n_free: int, pc, qc, w, col_i, col_j):
    """Assembly over a mesh: the matches split over `axis` (rows padded to
    a multiple of its size with weight 0, which adds nothing), each shard
    assembled on its device and (H, g) summed over the axis (`psum`).
    Inputs are host arrays; returns (H, g) on the device of this
    process's first position (across processes every process holds the
    sum)."""
    from spim_registration_tpu_torch.parallel.mesh import (
        psum,
        shard,
        shard_map,
    )

    pad = (-len(pc)) % mesh.shape[axis]

    def padded(a, fill=0):
        a = np.asarray(a)
        return np.pad(a, ((0, pad),) + ((0, 0),) * (a.ndim - 1),
                      constant_values=fill)

    f32 = [shard(padded(a), mesh, (axis,)) for a in (pc, qc, w)]
    cols = [shard(padded(c, -1), mesh, (axis,), torch.int64)
            for c in (col_i, col_j)]
    parts = shard_map(lambda p, *a: assemble_normal_equations(
        model, n_free, *a), mesh, *f32, *cols)
    H = psum(shard_map(lambda p, hg: hg[0], mesh, parts), mesh, axis)
    g = psum(shard_map(lambda p, hg: hg[1], mesh, parts), mesh, axis)
    return mesh.first(H), mesh.first(g)
