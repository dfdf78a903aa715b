"""(3, 4) affine transforms on tensors.

Port of the reference's `models/affine.py` transform utilities. A
transform ``A`` acts on points ``p`` of shape (..., 3) in (z, y, x) order
as ``A[:, :3] @ p + A[:, 3]``.
"""

from __future__ import annotations

import torch


def identity_affine(dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.cat([torch.eye(3, dtype=dtype, device=device),
                      torch.zeros((3, 1), dtype=dtype, device=device)], dim=1)


def apply_affine(A: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Apply (3,4) affine to points (..., 3)."""
    return p @ A[:, :3].T + A[:, 3]


def compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Return the affine equal to applying B first, then A (A o B)."""
    R = A[:, :3] @ B[:, :3]
    t = A[:, :3] @ B[:, 3] + A[:, 3]
    return torch.cat([R, t[:, None]], dim=1)


def invert_affine(A: torch.Tensor) -> torch.Tensor:
    Rinv = torch.linalg.inv(A[:, :3])
    t = -Rinv @ A[:, 3]
    return torch.cat([Rinv, t[:, None]], dim=1)


def matrix_4x4(A: torch.Tensor) -> torch.Tensor:
    """Lift a (3,4) affine to homogeneous (4,4)."""
    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=A.dtype,
                          device=A.device)
    return torch.cat([A, bottom], dim=0)
