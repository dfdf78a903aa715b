"""Z-sharded interest-point detection (DoG and DoM).

Port of the reference's `parallel/sharded_detect.py`: the volume is
z-sharded; each shard downsamples its own slab (the 2-sample bins never
cross a shard boundary when the shard depth divides by the factor),
computes the response on a block extended by the convolution halo plus a
refinement margin (one `halo_exchange_z`), finds the extrema it owns and
refines them sub-pixel locally. No shard sees the whole volume. On the
host the per-shard peak lists (padded (pos, val, ok), all-gathered first
where the mesh spans processes, as the reference's `process_allgather`)
are joined and a global top-k by |response| caps them, matching the
single-device `detect_beads` / `detect_beads_dom` output (anisotropic
sigmas and downsampling included). Each shard's peaks come from `ops.extrema.find_peaks`, which
takes the segment top-k kernel (`segment_topk`) on a card wherever
`max_peaks_per_shard` <= 4 rounds x the field's 512-segments.
"""

from __future__ import annotations

import numpy as np
import torch

from spim_registration_tpu_torch.detect.dog import (
    DoGParameters,
    effective_sigmas,
)
from spim_registration_tpu_torch.ops.downsample import (
    downsample,
    upscale_coords,
)
from spim_registration_tpu_torch.ops.extrema import (
    find_peaks,
    subpixel_localize,
)
from spim_registration_tpu_torch.ops.gaussian import (
    conv_axis_valid,
    dog_sigmas,
    gaussian_kernel_1d,
    mirror_pad,
)
from spim_registration_tpu_torch.ops.integral import box_mean
from spim_registration_tpu_torch.parallel.halo import halo_exchange_z
from spim_registration_tpu_torch.parallel.mesh import (
    Mesh,
    allgather,
    shard,
    shard_map,
)

# margin so the iterative sub-pixel walk (<= max_iterations steps) stays
# inside the extended block
_REFINE_MARGIN = 6


def _pad_depth(vol: np.ndarray, step: int, mode: str, what: str):
    """Extend the depth to a multiple of `step` (mirror for DoG, edge for
    DoM); returns (volume, padded depth)."""
    Z = vol.shape[0]
    Zp = -(-Z // step) * step
    if Zp - Z > Z - 1:
        raise ValueError(
            f"volume depth {Z} too thin to {what} over a "
            f"{step}-row mesh grid (needs {Zp - Z} rows)")
    if Zp != Z:
        vol = np.pad(vol, ((0, Zp - Z), (0, 0), (0, 0)), mode=mode)
    return vol, Zp


def _normalized_shards(vol: np.ndarray, normalize: bool, mesh: Mesh,
                       axis_name: str) -> list:
    """The z shards of the volume, min/max-normalized over the whole
    volume (the reference normalizes before it shards)."""
    xs = shard(vol, mesh, (axis_name,))
    if not normalize:
        return xs
    lo = np.float32(vol.min())
    hi = np.float32(vol.max())
    span = float(max(hi - lo, np.float32(1e-12)))
    return shard_map(lambda p, x: (x - float(lo)) / span, mesh, xs)


def _peaks(resp, params, max_peaks, z0, m, zl_ds, Zds, factors):
    """One shard's owned, refined peaks: (pos (P, 3) full-res global, val,
    ok). `resp` holds the zl_ds owned rows with m margin rows each side."""
    coords, _, valid = find_peaks(resp, params.threshold, max_peaks,
                                  params.find_minima)
    gz = coords[:, 0] + z0 - m
    own = ((coords[:, 0] >= m) & (coords[:, 0] < m + zl_ds)
           & (gz >= 1) & (gz <= Zds - 2))
    pos, val, ok = subpixel_localize(resp, coords, valid & own)
    pos = pos.clone()
    pos[:, 0] += np.float32(z0 - m)
    # global-z bound check (downsampled space) after the refinement walk
    ok = ok & (pos[:, 0] >= 0) & (pos[:, 0] <= Zds - 1)
    return upscale_coords(pos, factors), val, ok


def _collect(results, max_peaks: int):
    """Join the shards' peaks on the host and keep the max_peaks largest
    |response| (the reference's global cap)."""
    pos = np.concatenate([r[0].cpu().numpy() for r in results])
    val = np.concatenate([r[1].cpu().numpy() for r in results])
    ok = np.concatenate([r[2].cpu().numpy() for r in results])
    pos, val = pos[ok], val[ok]
    if len(val) > max_peaks:
        keep = np.argsort(-np.abs(val))[:max_peaks]
        pos, val = pos[keep], val[keep]
    return pos.astype(np.float32), val.astype(np.float32)


def _one_per_shard(mesh: Mesh, axis_name: str, results: list) -> list:
    """The results of the positions with coordinate 0 on every other axis
    (the others hold the same shards), from every process."""
    results = allgather(results, mesh)
    out = []
    for p in range(mesh.size):
        coords = np.unravel_index(p, mesh.devices.shape)
        if all(c == 0 for k, c in enumerate(coords)
               if mesh.axis_names[k] != axis_name):
            out.append(results[p])
    return out


def _dog_shards(vol, params: DoGParameters, mesh: Mesh, axis_name: str):
    """The DoG response of each z shard (downsampled space) over its
    owned rows and `_REFINE_MARGIN` rows each side, from the halo-extended
    shard. Returns (responses, owned rows a shard, true downsampled
    depth)."""
    vol = np.asarray(vol, np.float32)
    Z = vol.shape[0]
    nz = mesh.shape[axis_name]
    dz, dxy = params.downsample_z, params.downsample_xy
    factors = (dz, dxy, dxy)
    vol, Zp = _pad_depth(vol, nz * dz, "reflect", "mirror-extend")
    zl_ds = Zp // nz // dz
    Zds = -(-Z // dz)   # the true downsampled depth (ownership, bounds)

    sz, sy, sx = effective_sigmas(params)
    _, _, norm = dog_sigmas(params.sigma, params.threshold,
                            steps_per_octave=params.steps_per_octave)
    kf = 2.0 ** (1.0 / params.steps_per_octave)
    k1 = [gaussian_kernel_1d(float(s)) for s in (sz, sy, sx)]
    k2 = [gaussian_kernel_1d(float(s * kf)) for s in (sz, sy, sx)]
    r = (k2[0].shape[0] - 1) // 2   # the larger z kernel radius (ds space)
    m = _REFINE_MARGIN
    h = r + m

    def local_blur(xp, ks):
        # trim excess z halo so the valid conv lands on (zl_ds + 2m) rows
        rk = (ks[0].shape[0] - 1) // 2
        trim = h - m - rk
        out = xp[trim: xp.shape[0] - trim] if trim else xp
        out = conv_axis_valid(out, ks[0], 0) if rk else out
        for ax in (1, 2):
            ra = (ks[ax].shape[0] - 1) // 2
            if ra:
                out = conv_axis_valid(mirror_pad(out, ra, ax), ks[ax], ax)
        return out

    xs = _normalized_shards(vol, params.normalize, mesh, axis_name)
    if any(f > 1 for f in factors):   # local bins, shard-exact
        xs = shard_map(lambda p, x: downsample(x, factors), mesh, xs)
    xps = halo_exchange_z(xs, h, mesh, axis_name)   # (zl_ds + 2h, ...)

    def f(p, xp):
        dev = xp.device
        g1 = local_blur(xp, [torch.as_tensor(k, device=dev) for k in k1])
        g2 = local_blur(xp, [torch.as_tensor(k, device=dev) for k in k2])
        return (g1 - g2) * np.float32(norm)     # (zl_ds + 2m, Yds, Xds)

    return shard_map(f, mesh, xps), zl_ds, Zds


def sharded_detect_beads(vol, params: DoGParameters, mesh: Mesh,
                         axis_name: str = "z",
                         max_peaks_per_shard: int = 2048):
    """Detect beads on a z-sharded volume; returns (points, responses)
    like `detect_beads` (host arrays, full-resolution coordinates).

    A depth that does not split over the mesh is mirror-extended: the
    Gaussians are symmetric, so the DoG of the extension is the mirror of
    the true DoG, and its duplicate peaks fail the ownership bounds,
    which use the true depth."""
    dogs, zl_ds, Zds = _dog_shards(vol, params, mesh, axis_name)
    factors = (params.downsample_z, params.downsample_xy,
               params.downsample_xy)
    results = shard_map(
        lambda p, dog: _peaks(dog, params, max_peaks_per_shard,
                              mesh.index(p, axis_name) * zl_ds,
                              _REFINE_MARGIN, zl_ds, Zds, factors),
        mesh, dogs)
    return _collect(_one_per_shard(mesh, axis_name, results),
                    params.max_peaks)


def sharded_detect_beads_dom(vol, params, mesh: Mesh, axis_name: str = "z",
                             max_peaks_per_shard: int = 2048):
    """Z-sharded Difference-of-Mean detection (`detect.dom` on a mesh).

    Each shard computes box means on a halo-extended block and keeps only
    the rows whose whole (r2 + margin) support lies in exchanged rows, so
    the edge-clamped block borders never leak in; rows beyond the true
    volume are re-pinned to the clamped edge row (the single-device
    `box_mean` clamps at the edges, where the DoG mirrors)."""
    vol = np.asarray(vol, np.float32)
    Z = vol.shape[0]
    nz = mesh.shape[axis_name]
    dz, dxy = params.downsample_z, params.downsample_xy
    factors = (dz, dxy, dxy)
    # the extension's content is irrelevant (re-pinned below); edge
    # padding keeps it finite
    vol, Zp = _pad_depth(vol, nz * dz, "edge", "extend")
    zl_ds = Zp // nz // dz
    Zds = -(-Z // dz)
    m = _REFINE_MARGIN
    h = params.radius2 + m
    if Zp // dz - Zds > zl_ds + h - 1:
        raise ValueError("volume too thin for sharded DoM edge clamp")

    xs = _normalized_shards(vol, params.normalize, mesh, axis_name)
    if any(f > 1 for f in factors):
        xs = shard_map(lambda p, x: downsample(x, factors), mesh, xs)
    xps = halo_exchange_z(xs, h, mesh, axis_name)   # (zl_ds + 2h, ...)

    def f(p, xp):
        z0 = mesh.index(p, axis_name) * zl_ds
        # rows beyond the true (downsampled) volume -> its edge row
        g = z0 - h + np.arange(xp.shape[0])
        out = np.nonzero((g < 0) | (g > Zds - 1))[0]
        if out.size:
            li = np.clip(np.clip(g[out], 0, Zds - 1) - (z0 - h), 0,
                         xp.shape[0] - 1)
            xp = xp.clone()
            xp[torch.as_tensor(out, device=xp.device)] = \
                xp[torch.as_tensor(li, device=xp.device)]
        dom = box_mean(xp, params.radius1) - box_mean(xp, params.radius2)
        dom = dom[h - m: xp.shape[0] - (h - m)]   # (zl_ds + 2m, ...)
        return _peaks(dom, params, max_peaks_per_shard, z0, m, zl_ds, Zds,
                      factors)

    results = shard_map(f, mesh, xps)
    return _collect(_one_per_shard(mesh, axis_name, results),
                    params.max_peaks)
