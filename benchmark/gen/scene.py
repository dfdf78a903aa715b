"""A simulated multi-view bead acquisition (the `sim6x256` configuration).

The view poses follow the port's `utils/simulation.make_multiview_scene`:
view 0 fixed, every other view turned about the y axis by up to
`max_angle_deg`, then by a random rotation of up to `max_perturb_deg`
about a random axis, and shifted by up to `max_shift_px`, all about the
volume's centre. The poses come from the configuration's own
`pose_seed`, so every run seed measures the same geometry (and the same
kernel ranks); the run's seed draws the beads of the deconvolution pass
and the drift and noise of the registration pass.

Views are rendered in their own frames analytically: a bead of sigma s
blurred by the view's axis-aligned Gaussian PSF of sigmas p is a Gaussian
of variances s^2 + p^2 and the same integral. Imports nothing of the port.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.gen import volumes as gv


def rotation_about_axis(axis: int, angle_deg: float) -> np.ndarray:
    a = np.deg2rad(angle_deg)
    c, s = np.cos(a), np.sin(a)
    if axis == 0:
        return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], float)
    if axis == 1:
        return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], float)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], float)


def random_rotation(rng, max_angle_deg: float) -> np.ndarray:
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    angle = np.deg2rad(rng.uniform(-max_angle_deg, max_angle_deg))
    K = np.array([[0, -axis[2], axis[1]],
                  [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * (K @ K)


def poses(cfg: dict) -> list:
    """The true (3, 4) view -> world affines."""
    rng = np.random.default_rng(cfg["pose_seed"])
    center = np.array(cfg["shape"], float) / 2.0
    out = []
    for v in range(cfg["views"]):
        if v == 0:
            R, t = np.eye(3), np.zeros(3)
        else:
            R = rotation_about_axis(
                cfg["rotation_axis"],
                rng.uniform(-cfg["max_angle_deg"], cfg["max_angle_deg"])) \
                @ random_rotation(rng, cfg["max_perturb_deg"])
            t = rng.uniform(-cfg["max_shift_px"], cfg["max_shift_px"], 3)
        out.append(np.concatenate([R, (center + t - R @ center)[:, None]],
                                  axis=1))
    return out


def to_view(models: list, world: np.ndarray) -> list:
    """World points in each view's own frame."""
    out = []
    for A in models:
        inv = np.linalg.inv(np.vstack([A, [0, 0, 0, 1]]))[:3]
        out.append(world @ inv[:, :3].T + inv[:, 3])
    return out


def world_beads(cfg: dict, seed: int, device) -> np.ndarray:
    g = gv.generator(seed, device, 1)
    m = cfg["margin_px"]
    hi = [n - m for n in cfg["shape"]]
    return gv.uniform(g, (cfg["beads"], 3), m, hi, device).cpu().numpy()


def render_view(cfg: dict, points: np.ndarray, v: int, g, device
                ) -> torch.Tensor:
    """View v's image (float32 on `device`) of beads at its own-frame
    `points`, blurred by its PSF, with the acquisition's noise."""
    s2 = cfg["bead_sigma"] ** 2
    p2 = np.square(cfg["psf_sigmas"][v])
    var = s2 + p2
    amp = cfg["bead_sigma"] ** 3 / float(np.prod(np.sqrt(var)))
    vol = gv.render_gaussians(torch.as_tensor(points), cfg["shape"],
                              np.diag(var), amp, device)
    return vol + cfg["noise"] * torch.randn(
        vol.shape, generator=g, device=device, dtype=torch.float32)


def timepoints(cfg: dict, traffic: dict, seed: int, device) -> dict:
    """`traffic["timepoints"]` timepoints of one sample, its beads drawn
    from `traffic["sample_seed"]` (every run images the same sample, so
    that the seed does not change how many beads each view holds): the
    whole sample drifted by a uniform +-`drift_px` in the world drawn from
    the run's seed, every view rendered afresh with fresh noise. Returns
    the true models, each timepoint's world beads and its views as host
    float32 arrays."""
    models = poses(cfg)
    world = world_beads(cfg, traffic["sample_seed"], device)
    g = gv.generator(seed, device, 2)
    n, d = traffic["timepoints"], traffic["drift_px"]
    drift = gv.uniform(g, (n, 3), -d, d, device).cpu().numpy()
    tps = []
    for t in range(n):
        w = world + drift[t]
        views = [render_view(cfg, p, v, g, device).cpu().numpy()
                 for v, p in enumerate(to_view(models, w))]
        tps.append({"world": w, "views": views})
    return {"models": models, "timepoints": tps}


def rl_inputs(cfg: dict, traffic: dict, seed: int, device) -> dict:
    """The deconvolution pass of the acquisition on its registered box:
    the beads (sigma `bead_sigma`) rendered in the box's world frame,
    blurred by each view's PSF turned into the world frame (a psf_size^3
    Gaussian), with the acquisition's noise; cosine-ramp weights over
    the views; OSEM factor = the number of views."""
    lo, hi = cfg["box"]["min"], cfg["box"]["max"]
    shape = tuple(h - l for l, h in zip(lo, hi))
    world = world_beads(cfg, seed, device) - np.asarray(lo, float)
    truth = gv.render_gaussians(torch.as_tensor(world), shape,
                                np.eye(3) * cfg["bead_sigma"] ** 2, 1.0,
                                device)
    g = gv.generator(seed, device, 3)
    psfs, images = [], []
    for v, A in enumerate(poses(cfg)):
        R = A[:, :3]
        cov = R @ np.diag(np.square(cfg["psf_sigmas"][v])) @ R.T
        psf = gv.gaussian_kernel(cfg["psf_size"], cov)
        psfs.append(psf)
        images.append(gv.fft_blur(truth, psf) + cfg["noise"] * torch.randn(
            shape, generator=g, device=device, dtype=torch.float32))
    V = len(psfs)
    return {"images": torch.stack(images),
            "weights": gv.ramp_weights(shape, V, cfg["ramp_px"],
                                       False, device),
            "psfs": psfs, "factors": None, "osem": float(V)}
