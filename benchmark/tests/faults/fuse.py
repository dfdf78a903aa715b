"""Faults of the `fuse` kind's timed path, planted in the port's fusion
(`fuse/weighted_avg.py`; `FAULTS` as in `rl.py`)."""

import dataclasses

import numpy as np

FUSE = "spim_registration_tpu_torch.fuse.weighted_avg"


def view_left_out(orig):
    """The last view left out of the fusion."""
    def f(*a, **k):
        return orig(*a, **k)[:-1]
    return f


def content_off(orig):
    """No content weights: blending alone."""
    def f(*a, **k):
        return [(vol, None, M, aligned)
                for vol, _, M, aligned in orig(*a, **k)]
    return f


def blending_off(orig):
    """No blending ramps: every sample inside a view weighs in full."""
    def f(views, z0, chunk_shape, params, device):
        return orig(views, z0, chunk_shape,
                    dataclasses.replace(params, use_blending=False), device)
    return f


def rows_shifted(orig):
    """The first chunk's rows fused one row further down the box."""
    def f(views, z0, chunk_shape, params, device):
        return orig(views, z0 + 1 if z0 == 0 else z0, chunk_shape, params,
                    device)
    return f


def last_row_unwritten(orig):
    """The box's last row left as the output array held it."""
    def f(volumes, models, bbox, params, dev, out, phases=None):
        whole = orig(volumes, models, bbox, params, dev, np.empty_like(out),
                     phases)
        out[:-1] = whole[:-1]
        return out
    return f


FAULTS = {"view_left_out": (FUSE, "_view_maps", view_left_out),
          "content_off": (FUSE, "_view_maps", content_off),
          "blending_off": (FUSE, "_fuse_chunk", blending_off),
          "rows_shifted": (FUSE, "_fuse_chunk", rows_shifted),
          "last_row_unwritten": (FUSE, "_fuse", last_row_unwritten)}
