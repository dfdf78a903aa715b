"""Interest-point detection (Difference-of-Gaussian, Difference-of-Mean)."""

from spim_registration_tpu_torch.detect.dog import (  # noqa: F401
    DoGParameters,
    detect_beads,
    detect_beads_batch,
    detect_beads_dataset,
    effective_sigmas,
)
from spim_registration_tpu_torch.detect.dom import (  # noqa: F401
    DoMParameters,
    detect_beads_dom,
)
