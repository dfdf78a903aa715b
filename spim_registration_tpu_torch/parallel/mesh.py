"""Device mesh and the cross-shard steps of the multi-device layer.

Port of the reference's `parallel/mesh.py` (a `jax.sharding.Mesh` over
`jax.devices()`). Here one process drives a grid of `torch.device`s: a
`Mesh` names the grid's axes, a sharded array is a plain list holding one
tensor per mesh position (row-major over `Mesh.devices`), and every step
that crosses positions is one of the functions below:

- `shard` / `gather`: a host array to per-position shards and back
  (`jax.device_put` with a `NamedSharding`, `np.asarray`);
- `shard_map`: a function applied at every position on its device
  (`shard_map`'s body; `axis_index` is `Mesh.index`);
- `ppermute`: each position receives its neighbour's tensor along an
  axis (`lax.ppermute` with a shift permutation);
- `psum`: the sum over an axis, in axis order (`lax.psum`).

The engines (`parallel/halo.py`, `sharded.py`, `sharded_detect.py`) cross
positions only through these. A copy between two devices is
`tensor.to(dst, non_blocking=True)` (a peer copy between two cards, none
at all on one device).

Standard meshes, as in the reference: ("z",) z-shards volumes (the
convolution axis); ("view", "z") runs views data-parallel x z-sharded. A
mesh may name one device at several positions (`[cuda:0] * 4`, or the
host eight times in the tests): that is the counterpart of the
reference's virtual devices, and its shards then run one after another
on that device. The reference's ("host", "z") mesh across processes is
not here; it needs `torch.distributed` behind these same functions.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from spim_registration_tpu_torch.utils.device import (
    on_device,
    resolve_device,
)


class Mesh:
    """Named axes over an ndarray of `torch.device` (the reference's
    `jax.sharding.Mesh`). Positions are numbered row-major over
    `devices`."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        if devices.ndim != len(self.axis_names):
            raise ValueError(f"{devices.ndim}-d device grid for axes "
                             f"{self.axis_names}")

    @property
    def shape(self) -> dict:
        """Axis name -> size, in axis order."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def device(self, p: int) -> torch.device:
        return self.devices.flat[p]

    def index(self, p: int, axis: str) -> int:
        """Position p's coordinate along `axis` (`lax.axis_index`)."""
        coords = np.unravel_index(p, self.devices.shape)
        return int(coords[self.axis_names.index(axis)])

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, devices="
                f"{[str(d) for d in self.devices.flat]})")


def make_mesh(axis_names: Sequence[str] = ("z",),
              axis_sizes: Optional[Sequence[int]] = None,
              devices=None) -> Mesh:
    """Build a Mesh over `devices` (default: every visible CUDA card, in
    order; raises without one, as the entry points do).

    With no `axis_sizes`, all devices go to the last axis and leading axes
    get size 1. The first prod(axis_sizes) devices are used; fewer raise
    the reference's ValueError. An explicit list may name one device more
    than once (`[torch.device("cuda:0")] * 4`)."""
    if devices is None:
        resolve_device("cuda")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if axis_sizes is None:
        axis_sizes = [1] * (len(axis_names) - 1) + [n]
    total = int(np.prod(axis_sizes))
    if total > n:
        raise ValueError(f"mesh needs {total} devices, have {n}")
    grid = np.empty(total, dtype=object)
    for i, d in enumerate(devices[:total]):
        grid[i] = d
    return Mesh(grid.reshape(tuple(int(s) for s in axis_sizes)), axis_names)


def mesh_from_spec(spec: Optional[str], device=None) -> Optional[Mesh]:
    """Parse the CLI's `--mesh` flag into a Mesh (or None).

    Accepted: None / "" / "none" / "1" -> single device (no mesh);
    "auto" -> every visible card on a ("z",) axis (None if only one);
    "z=8" / "view=2,z=4" -> explicit axis names and sizes. `device` is the
    stage's device (default CUDA): on CUDA the positions go over
    cuda:0..n-1 in order, and a mesh larger than the cards present raises
    "mesh needs N devices, have M". On the CPU every position is the
    host, so "z=8" is eight shards run one after another there and "auto"
    is None (the reference's CPU has 8 virtual devices, the port's one
    host)."""
    if spec is None or spec in ("", "none", "1"):
        return None
    dev = resolve_device(device)
    if spec == "auto":
        if dev.type != "cuda":
            return None
        n = torch.cuda.device_count()
        return make_mesh(("z",), (n,)) if n > 1 else None
    names, sizes = [], []
    for part in spec.split(","):
        k, _, v = part.partition("=")
        if not v:
            raise ValueError(f"bad --mesh component {part!r} "
                             "(want e.g. z=8 or view=2,z=4)")
        names.append(k.strip())
        sizes.append(int(v))
    if dev.type == "cuda":
        return make_mesh(tuple(names), tuple(sizes))
    return make_mesh(tuple(names), tuple(sizes),
                     devices=[dev] * int(np.prod(sizes)))


# ------------------------------------------------------------ cross-shard

def shard_map(fn, mesh: Mesh, *shards) -> list:
    """[fn(p, shards[0][p], shards[1][p], ...) for every position p], each
    on p's device."""
    out = []
    for p in range(mesh.size):
        with on_device(mesh.device(p)):
            out.append(fn(p, *(s[p] for s in shards)))
    return out


def _axis_group(mesh: Mesh, p: int, axis: str) -> list:
    """The positions that differ from p only along `axis`, in axis
    order."""
    k = mesh.axis_names.index(axis)
    coords = list(np.unravel_index(p, mesh.devices.shape))
    out = []
    for i in range(mesh.devices.shape[k]):
        coords[k] = i
        out.append(int(np.ravel_multi_index(coords, mesh.devices.shape)))
    return out


def ppermute(xs: list, mesh: Mesh, axis: str, shift: int) -> list:
    """Each position receives the tensor of the position `shift` before
    it along `axis` (i <- i - shift); positions without a source get
    zeros, as `lax.ppermute` gives them."""
    out = []
    for p in range(mesh.size):
        group = _axis_group(mesh, p, axis)
        src = mesh.index(p, axis) - shift
        dev = mesh.device(p)
        if 0 <= src < len(group):
            out.append(xs[group[src]].to(dev, non_blocking=True))
        else:
            out.append(torch.zeros_like(xs[p], device=dev))
    return out


def psum(xs: list, mesh: Mesh, axis: str) -> list:
    """The sum over `axis` at every position (x_0 + x_1 + ... in axis
    order), computed once per group and device."""
    done = {}
    out = []
    for p in range(mesh.size):
        group = _axis_group(mesh, p, axis)
        dev = mesh.device(p)
        key = (group[0], dev)
        if key not in done:
            with on_device(dev):
                acc = xs[group[0]].to(dev, non_blocking=True)
                for q in group[1:]:
                    acc = acc + xs[q].to(dev, non_blocking=True)
            done[key] = acc
        out.append(done[key])
    return out


def _local_index(mesh: Mesh, p: int, spec, shape) -> tuple:
    """Position p's slices of an array of `shape` whose leading dims are
    split over the mesh axes named in `spec` (None: not split)."""
    idx = []
    for d, name in enumerate(spec):
        if name is None:
            idx.append(slice(None))
            continue
        n = mesh.shape[name]
        if shape[d] % n:
            raise ValueError(f"dimension {d} of size {shape[d]} does not "
                             f"split over mesh axis {name!r} of size {n}")
        m = shape[d] // n
        i = mesh.index(p, name)
        idx.append(slice(i * m, (i + 1) * m))
    return tuple(idx)


def shard(array, mesh: Mesh, spec=(), dtype=torch.float32) -> list:
    """Per-position shards of a host array (or tensor): the leading dims
    split over the axes named in `spec` (None: replicated), the rest whole
    (`jax.device_put(a, NamedSharding(mesh, P(*spec)))`). Positions on one
    device that hold the same slice share one tensor, so shards are never
    changed in place."""
    if isinstance(array, np.ndarray):
        array = torch.from_numpy(np.ascontiguousarray(array))
    array = array.to(dtype)
    done = {}
    out = []
    for p in range(mesh.size):
        idx = _local_index(mesh, p, spec, array.shape)
        dev = mesh.device(p)
        key = (str(idx), dev)
        if key not in done:
            done[key] = array[idx].contiguous().to(dev, non_blocking=True)
        out.append(done[key])
    return out


def gather(xs: list, mesh: Mesh, spec=()) -> np.ndarray:
    """The host array whose shards `xs` are (the inverse of `shard`): each
    block is read from the first position that holds it."""
    first = xs[0]
    shape = list(first.shape)
    for d, name in enumerate(spec):
        if name is not None:
            shape[d] *= mesh.shape[name]
    out = np.empty(shape, dtype=np.dtype(str(first.dtype).split(".")[-1]))
    seen = set()
    for p in range(mesh.size):
        idx = _local_index(mesh, p, spec, shape)
        key = str(idx)
        if key not in seen:
            seen.add(key)
            out[idx] = xs[p].cpu().numpy()
    return out
