"""Interest-point detection (Difference-of-Gaussian)."""

from spim_registration_tpu_torch.detect.dog import (  # noqa: F401
    DoGParameters,
    detect_beads,
    detect_beads_batch,
    effective_sigmas,
)
