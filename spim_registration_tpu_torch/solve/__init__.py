"""Global view alignment (pose-graph least squares)."""

from spim_registration_tpu_torch.solve.global_opt import (  # noqa: F401
    GlobalOptParameters,
    GlobalOptResult,
    PairMatches,
    solve_global,
)
