"""Dataset model pieces the deconvolution slice needs."""

from spim_registration_tpu_torch.core.dataset import (  # noqa: F401
    BoundingBox,
    identity_transform,
)
