"""The dataset model, its XML persistence and the image loaders."""

from spim_registration_tpu_torch.core.dataset import (  # noqa: F401
    BoundingBox,
    Dataset,
    InterestPoints,
    ViewDescription,
    ViewId,
    ViewTransform,
    identity_transform,
)
