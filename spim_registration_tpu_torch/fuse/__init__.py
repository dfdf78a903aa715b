"""Fusion: bounding boxes, weights and weighted-average fusion."""

from spim_registration_tpu_torch.fuse.bounding_box import (  # noqa: F401
    bounding_box_from_points,
    intersect_bounding_box,
    maximal_bounding_box,
)
from spim_registration_tpu_torch.fuse.weighted_avg import (  # noqa: F401
    FusionParameters,
    TimelapseFusion,
    fuse_dataset,
    fuse_views,
)
from spim_registration_tpu_torch.fuse.weights import (  # noqa: F401
    BlendingParameters,
    ContentBasedParameters,
    blending_weight,
    content_based_weight,
)
