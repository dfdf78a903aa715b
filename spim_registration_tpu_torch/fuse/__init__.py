"""Fusion: weights and weighted-average fusion."""

from spim_registration_tpu_torch.fuse.weighted_avg import (  # noqa: F401
    FusionParameters,
    fuse_views,
)
from spim_registration_tpu_torch.fuse.weights import (  # noqa: F401
    BlendingParameters,
    ContentBasedParameters,
    blending_weight,
    content_based_weight,
)
