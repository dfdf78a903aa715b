"""Device-side assembly of the pose-graph normal equations.

Port of the reference's `solve/assembly.py` (`_design`,
`assemble_normal_equations`). The reference scatter-adds per-match blocks
into H and g; on CUDA a scatter-add (`index_add_`, `index_put_` with
accumulate) uses float atomics whose order changes from run to run, so the
solve would not repeat bit for bit. Here the assembly is deterministic:
each match's Jacobian rows are lifted into the free-parameter columns with
one-hot tile matrices, J (N*3, n_free*P), and H = J^T W J, g = J^T W r0 are
two matrix products. `n_free` <= views - 1 and P <= 12, so J has at most
84 columns for 8 views. The reference's sharded form waits for the
multi-device port.
"""

from __future__ import annotations

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
