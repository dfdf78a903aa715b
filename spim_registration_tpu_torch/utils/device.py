"""Device selection for the port's entry points.

Counterpart of the reference's `utils/backend.py` (`is_tpu_backend`): the
reference decides between Pallas kernels and XLA chains from the platform
it traces for; the port decides from the device its tensors live on. Entry
points default to the CUDA card and refuse to run elsewhere unless the
caller names the CPU explicitly, so a run never drifts onto the host
without being asked to.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA when `device` is None.

    Raises RuntimeError when CUDA is asked for (explicitly or by default)
    and no card is present; pass `device="cpu"` to run on the host. On
    CUDA it also turns TF32 off (`set_exact_float32`)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the host")
        set_exact_float32()
    return dev


def set_exact_float32() -> None:
    """Keep float32 matmuls and convolutions in full float32 on the card
    (the reference's f32 math); TF32 would keep ~3 decimal digits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
