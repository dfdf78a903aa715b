"""The inputs of a configuration too large for one card's memory (the
`mvd6x1024` configuration): the bead law of `gen/phantom.py`, the same
draws, render, blur and weights, with each view made on the device and
copied into a host stack (pinned where the device is a card), so the
whole stack is never on one card. Every view weighs the same, so the
weights are one volume on the host seen as a stack of views. Imports
nothing of the port.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.gen import phantom
from benchmark.gen import volumes as gv


def view_weights(shape, n_views: int, range_px: float,
                 device) -> torch.Tensor:
    """One view's weights as `volumes.ramp_weights(..., binary=True)`
    gives each: 1 / n_views where the cosine ramps from the faces are
    nonzero, 0 on the faces."""
    r = [torch.as_tensor(gv.ramp_1d(n, range_px), device=device)
         for n in shape]
    prod = r[0][:, None, None] * r[1][None, :, None] * r[2][None, None, :]
    return ((prod > 0).to(torch.float64) / n_views).to(torch.float32)


def rl_inputs(cfg: dict, traffic: dict, seed: int, device) -> dict:
    shape = tuple(cfg["shape"])
    psfs, factors = phantom.fixture_psfs(cfg)
    g = gv.generator(seed, device, 0)
    m = cfg["margin_px"]
    pts = gv.uniform(g, (cfg["beads"], 3), m, [n - m for n in shape],
                     device)
    truth = gv.render_gaussians(pts, shape,
                                np.eye(3) * cfg["bead_sigma"] ** 2, 1.0,
                                device)
    V = len(psfs)
    pin = torch.device(device).type == "cuda"
    images = torch.empty((V,) + shape, dtype=torch.float32, pin_memory=pin)
    for v, p in enumerate(psfs):
        images[v].copy_(gv.fft_blur(truth, p))
    del truth
    w = torch.empty(shape, dtype=torch.float32, pin_memory=pin)
    w.copy_(view_weights(shape, V, cfg["ramp_px"], device))
    return {"images": images, "weights": w.expand((V,) + shape),
            "psfs": psfs, "factors": factors, "osem": float(V)}
