"""Global view alignment (pose-graph least squares)."""

from spim_registration_tpu_torch.solve.global_opt import (  # noqa: F401
    GlobalOptParameters,
    GlobalOptResult,
    PairMatches,
    solve_global,
)
from spim_registration_tpu_torch.solve.optimization_types import (  # noqa: F401
    all_to_all_pairs,
    all_to_all_pairs_with_range,
    individual_timepoint_pairs,
    reference_timepoint_pairs,
)
