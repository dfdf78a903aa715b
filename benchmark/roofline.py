"""The least time an NVIDIA H100 could take for a kernel's work.

Peaks are NVIDIA's published figures for the H100 SXM (80 GB HBM3) at its
700 W limit; a card set below that limit runs slower, so every result
carries the card's name. A launch's bound is the larger of its bytes over
the memory bandwidth and its operations over the tensor cores' dense bf16
rate; bytes count each input read once and each output written once,
whatever the kernel reads again, and a band matrix counts its nonzeros.
"""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12      # HBM3
PEAK_BF16_OPS_PER_S = 989e12    # dense tensor-core bf16
PEAK_F32_OPS_PER_S = 67e12      # float32 outside the tensor cores


def bound_s(n_bytes: float, n_ops: float,
            peak_ops: float = PEAK_BF16_OPS_PER_S) -> float:
    return max(n_bytes / PEAK_BYTES_PER_S, n_ops / peak_ops)


def zpass_work(nnz_mz: float, R: int, N: int, P: int, J: int) -> tuple:
    """(bytes, operations) of one z pass a[r, n] = Mz[r, n, :] @ vm over
    J = Y * X columns, bf16 in and out: Mz's band nonzeros, the volume
    (P, J) and `a` (R, N, J) once each; two operations a nonzero and
    column."""
    return (nnz_mz + P * J + R * N * J) * 2.0, 2.0 * nnz_mz * J


def sl_rows_work(R: int, Z: int, Y: int, X: int, Yo: int, Xo: int,
                 nnz_my: float, nnz_mx: float) -> tuple:
    """(bytes, operations) of one fused y/x rows pass with its rank sum:
    `a` (R, Z, Y, X) bf16, My's and Mx's band nonzeros (bf16) read once,
    the (Z, Yo, Xo) float32 output written once; the band's products on
    both axes and the sum over ranks."""
    n_bytes = (R * Z * Y * X + nnz_my + nnz_mx) * 2.0 + Z * Yo * Xo * 4.0
    n_ops = 2.0 * Z * (nnz_my * X + Yo * nnz_mx) + float(R) * Z * Yo * Xo
    return n_bytes, n_ops
