"""Profiling helpers.

Port of the reference's `utils/profiling.py`: stage timers that wait for
the device before they stop the clock (`device_fence`), and `trace`, a
`torch.profiler` trace of a block written as a Chrome trace (the
counterpart of the reference's `xla_trace`; the CLI's `--profile DIR`).
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import torch

from spim_registration_tpu_torch.utils.log import get_logger

logger = get_logger("profile")


def device_fence(x: torch.Tensor) -> None:
    """Wait for `x` to be computed: a synchronize of its CUDA device (a
    CPU tensor is computed when the call that made it returns)."""
    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)


@contextlib.contextmanager
def stage_timer(name: str, timings: Optional[Dict[str, float]] = None):
    """Time a stage; pass its output tensor to the yielded setter to wait
    for the device before the clock stops."""
    holder = {}

    def set_fence(t):
        holder["out"] = t
        return t

    t0 = time.time()
    try:
        yield set_fence
    finally:
        if "out" in holder:
            device_fence(holder["out"])
        dt = time.time() - t0
        logger.info("%s: %.3fs", name, dt)
        if timings is not None:
            timings[name] = timings.get(name, 0.0) + dt


@contextlib.contextmanager
def trace(log_dir: str):
    """`torch.profiler` trace of the block: host operators, and the CUDA
    kernels and copies where a card is present, written into `log_dir` as
    `<host>_<pid>.<time>.pt.trace.json` (Chrome trace format: Perfetto,
    chrome://tracing or TensorBoard's profiler plugin read it)."""
    from torch.profiler import (
        ProfilerActivity,
        profile,
        tensorboard_trace_handler,
    )

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
