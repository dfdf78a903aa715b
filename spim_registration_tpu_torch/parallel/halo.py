"""Halo exchange for z-sharded volumes.

Port of the reference's `parallel/halo.py`: each shard receives `h`
boundary slices from its mesh neighbours (`mesh.ppermute`), and the
global volume edges are mirror-padded (reflect without the edge sample,
the reference's out-of-bounds mirror) or zero-padded. Halos deeper than a
shard come from several hops of whole neighbour blocks (thin shards x wide
PSF supports). Every step runs at this process's positions only
(`shard_map`); a hop across processes is `ppermute`'s.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from spim_registration_tpu_torch.parallel.mesh import (
    Mesh,
    ppermute,
    shard_map,
)


@functools.lru_cache(maxsize=256)
def _edge_rows(z0: int, n: int, Z: int, boundary: str,
              device: torch.device):
    """The rows of an extended block whose global z (z0 + row) lies
    outside [0, Z) and, for the mirror, the block rows they copy (reflect
    without the edge sample), as index tensors on `device`; None where no
    row is outside. Cached: an engine exchanges the same shapes every
    step, and each new index tensor is a host-to-device copy."""
    g = z0 + np.arange(n)
    out = np.nonzero((g < 0) | (g > Z - 1))[0]
    if out.size == 0:
        return None
    src = np.abs(g[out])
    src = np.where(src > Z - 1, 2 * (Z - 1) - src, src) - z0
    return (torch.as_tensor(out, device=device),
            torch.as_tensor(src, device=device) if boundary == "mirror"
            else None)


def halo_exchange_z(xs: list, h: int, mesh: Mesh, axis_name: str = "z",
                    boundary: str = "mirror") -> list:
    """Each position's (zl, ...) shard extended to (zl + 2h, ...).

    Interior shard boundaries receive the neighbours' rows (multi-hop when
    h > zl); the global top and bottom h rows are mirror images
    (`boundary="mirror"`) or zeros ("zero"). Requires h <= Z - 1, Z the
    depth over the axis. Counters: `halo_exchange_z.exchanges` (calls
    with h > 0) and `halo_exchange_z.peer_bytes` (the bytes their
    `ppermute` hops moved between positions: h * Y * X * 4 a boundary and
    direction for float32 shards of h <= zl rows)."""
    if h == 0:
        return list(xs)
    if boundary not in ("mirror", "zero"):
        raise ValueError(f"unknown boundary {boundary!r}")
    zl = mesh.first(xs).shape[0]
    n = mesh.shape[axis_name]
    Z = n * zl
    if h > Z - 1:
        raise ValueError(f"halo {h} exceeds volume depth {Z} - 1")
    halo_exchange_z.exchanges += 1
    moved = ppermute.peer_bytes

    hops = -(-h // zl)
    r = h - (hops - 1) * zl      # rows taken from the outermost block
    below, above = [xs], [xs]    # blocks from shards i-k and i+k
    for k in range(1, hops + 1):
        lo = below[-1] if k < hops else shard_map(
            lambda p, b: b[-r:], mesh, below[-1])
        hi = above[-1] if k < hops else shard_map(
            lambda p, b: b[:r], mesh, above[-1])
        if n == 1:
            below.append(shard_map(lambda p, b: torch.zeros_like(b), mesh,
                                   lo))
            above.append(shard_map(lambda p, b: torch.zeros_like(b), mesh,
                                   hi))
        else:
            below.append(ppermute(lo, mesh, axis_name, 1))
            above.append(ppermute(hi, mesh, axis_name, -1))

    def extend(p, *parts):
        ext = torch.cat(parts, dim=0)            # global rows z0 - h ...
        edge = _edge_rows(mesh.index(p, axis_name) * zl - h, zl + 2 * h, Z,
                         boundary, ext.device)
        if edge is not None:
            rows, src = edge
            ext[rows] = 0 if src is None else ext[src]
        return ext

    halo_exchange_z.peer_bytes += ppermute.peer_bytes - moved
    blocks = below[:0:-1] + [xs] + above[1:]
    return shard_map(extend, mesh, *blocks)


halo_exchange_z.exchanges = 0
halo_exchange_z.peer_bytes = 0
