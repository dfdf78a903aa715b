"""Faults of the `mesh` kind's timed path, planted in the port's sharded
engine (`parallel/sharded.py`). `FAULTS` names each, with the module it
is planted in, the attribute and a function that makes the broken
attribute from the original."""

import functools

import numpy as np
import torch

SHARDED = "spim_registration_tpu_torch.parallel.sharded"


def _mirrored(x: torch.Tensor, h: int) -> torch.Tensor:
    """A shard extended by h rows on each side from its own rows alone,
    mirrored (reflect without the edge row, as often as h needs)."""
    n = x.shape[0]
    k = np.arange(-h, n + h)
    period = max(2 * n - 2, 1)
    src = (n - 1) - np.abs(k % period - (n - 1)) if n > 1 else 0 * k
    return x[torch.as_tensor(src, device=x.device)]


def halo_left_out(orig):
    """The exchange between cards left out: every shard's halo is its own
    rows mirrored."""
    def f(xs, h, mesh, axis_name="z", boundary="mirror"):
        if h == 0:
            return list(xs)
        return [None if x is None else _mirrored(x, h) for x in xs]
    return f


def view_skipped(orig):
    """One view's update left out: the last view weighs nothing."""
    def f(prep, *a, **k):
        w = torch.as_tensor(prep.weights).clone()
        w[-1] = 0.0
        return orig(type(prep)(prep.images, w, prep.psfs, prep.osem_factor,
                               prep.psf_factors), *a, **k)
    return f


def seam_altered(orig):
    """10% off on the rows beside the boundary between the first two
    shards: the last two of the first and the first two of the second."""
    def f(*a, **k):
        execute = orig(*a, **k)

        @functools.wraps(execute)
        def run():
            out = execute()
            out[0][-2:] *= 1.1
            out[1][:2] *= 1.1
            return out
        return run
    return f


FAULTS = {"halo_left_out": (SHARDED, "halo_exchange_z", halo_left_out),
          "view_skipped": (SHARDED, "_stage_runner", view_skipped),
          "seam_altered": (SHARDED, "_stage_runner", seam_altered)}
