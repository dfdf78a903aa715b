"""Device selection for the port's entry points.

Counterpart of the reference's `utils/backend.py` (`is_tpu_backend`): the
reference decides between Pallas kernels and XLA chains from the platform
it traces for; the port decides from the device its tensors live on. Entry
points default to the CUDA card and refuse to run elsewhere unless the
caller names the CPU explicitly, so a run never drifts onto the host
without being asked to.
"""

from __future__ import annotations

import contextlib
import functools

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


def local_cards() -> list:
    """This process's cards, cuda:0 .. cuda:n-1 of the cards it sees
    (`CUDA_VISIBLE_DEVICES` picks them): the devices a mesh puts this
    process's positions on. Raises as `resolve_device` without a card."""
    resolve_device("cuda")
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


def on_device(dev: torch.device):
    """The context work on `dev` runs in: its card current on CUDA (the
    hand-written kernels launch on the current device's stream)."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device (asked once per device:
    `dog_fused` plans its grid from it at every launch)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def set_exact_float32() -> None:
    """Keep float32 matmuls and convolutions in full float32 on the card
    (the reference's f32 math); TF32 would keep ~3 decimal digits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
