"""The bench's deconvolution input (the `mvd6x256` configuration), made on
the device: a bead phantom blurred by each of the fixture PSFs, identity
registration, the same weights for every view, OSEM factor = the number
of views. The PSFs and their CP factors are a byte-identical copy of the
bench's fixture file under `benchmark/data/`. Imports nothing of the
port.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from benchmark.gen import volumes as gv

DATA = Path(__file__).resolve().parents[1] / "data"


def fixture_psfs(cfg: dict) -> tuple:
    """The configuration's PSFs (float32) and their CP factor banks (az,
    ay, ax) from the fixture file."""
    d = np.load(DATA / cfg["psf_file"])
    idx = cfg["psf_indices"]
    psfs = [np.asarray(d["psfs"][i], np.float32) for i in idx]
    factors = [(d[f"az_{i}"], d[f"ay_{i}"], d[f"ax_{i}"]) for i in idx]
    return psfs, factors


def rl_inputs(cfg: dict, traffic: dict, seed: int, device) -> dict:
    shape = tuple(cfg["shape"])
    psfs, factors = fixture_psfs(cfg)
    g = gv.generator(seed, device, 0)
    m = cfg["margin_px"]
    pts = gv.uniform(g, (cfg["beads"], 3), m, [n - m for n in shape],
                     device)
    truth = gv.render_gaussians(pts, shape,
                                np.eye(3) * cfg["bead_sigma"] ** 2, 1.0,
                                device)
    V = len(psfs)
    return {"images": torch.stack([gv.fft_blur(truth, p) for p in psfs]),
            "weights": gv.ramp_weights(shape, V, cfg["ramp_px"],
                                       True, device),
            "psfs": psfs, "factors": factors, "osem": float(V)}
