"""Stage orchestration: registration of views."""

from spim_registration_tpu_torch.pipeline.run import (  # noqa: F401
    RegistrationConfig,
    RegistrationResult,
    register_views,
)
