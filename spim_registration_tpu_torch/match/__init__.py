"""Descriptor-based correspondence finding and pairwise matching."""

from spim_registration_tpu_torch.match.batched import (  # noqa: F401
    match_pairs_batched,
)
from spim_registration_tpu_torch.match.pairwise import (  # noqa: F401
    MatchingMethod,
    PairwiseParameters,
    PairwiseResult,
    match_pair,
)
