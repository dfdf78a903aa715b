"""Device mesh and the cross-shard steps of the multi-device layer.

Port of the reference's `parallel/mesh.py` (a `jax.sharding.Mesh` over
`jax.devices()`). Here each process drives a grid of `torch.device`s: a
`Mesh` names the grid's axes, a sharded array is a plain list holding one
tensor per mesh position (row-major over `Mesh.devices`), and every step
that crosses positions is one of the functions below:

- `shard` / `gather`: a host array to per-position shards and back
  (`jax.device_put` with a `NamedSharding`; `np.asarray`, or across
  processes `process_allgather(tiled=True)`: every process receives the
  whole array);
- `shard_map`: a function applied at every position on its device
  (`shard_map`'s body; `axis_index` is `Mesh.index`);
- `ppermute`: each position receives its neighbour's tensor along an
  axis (`lax.ppermute` with a shift permutation);
- `psum`: the sum over an axis, in axis order (`lax.psum`);
- `allgather`: every position's tensors on every process (the
  reference's `process_allgather` of per-shard results).

The engines (`parallel/halo.py`, `sharded.py`, `sharded_detect.py`) cross
positions only through these. A copy between two devices is
`tensor.to(dst, non_blocking=True)` (a peer copy between two cards, none
at all on one device).

Standard meshes, as in the reference: ("z",) z-shards volumes (the
convolution axis); ("view", "z") runs views data-parallel x z-sharded. A
mesh may name one device at several positions (`[cuda:0] * 4`, or the
host eight times in the tests): that is the counterpart of the
reference's virtual devices, and its shards then run one after another
on that device.

Once processes are joined (`parallel/multihost.py`), a mesh spans them:
positions are process-major (process r owns positions [r L, (r + 1) L),
L a process), a process holds tensors only at its own positions (the
others are None in its lists), `shard_map` runs there only, and
`ppermute`, `psum`, `gather` and `allgather` reach the other processes
through `multihost.exchange` / `multihost.all_gather`. A sum over an
axis that crosses processes gathers the partials first and adds them in
axis order, so it equals the one-process sum. Without a group every
function works within the process, as before.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from spim_registration_tpu_torch.parallel import multihost
from spim_registration_tpu_torch.utils.device import (
    local_cards,
    on_device,
    resolve_device,
)


class Mesh:
    """Named axes over an ndarray of `torch.device` (the reference's
    `jax.sharding.Mesh`). Positions are numbered row-major over
    `devices`. `owners`, where given, holds the rank of the process that
    owns each position; the devices of other processes' positions are
    None. Without it every position is this process's."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str],
                 owners: Optional[np.ndarray] = None):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.owners = owners
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

    @property
    def spans_processes(self) -> bool:
        return self.owners is not None and len(set(self.owners.flat)) > 1

    def owner(self, p: int) -> int:
        """The rank of the process that owns position p."""
        if self.owners is None:
            return multihost.process_index()
        return int(self.owners.flat[p])

    def is_local(self, p: int) -> bool:
        return self.owner(p) == multihost.process_index()

    @property
    def local_positions(self) -> list:
        return [p for p in range(self.size) if self.is_local(p)]

    def device(self, p: int) -> torch.device:
        return self.devices.flat[p]

    def first_device(self) -> torch.device:
        """The device of this process's first position (where a stage
        that runs once a process stages its tensors)."""
        return self.device(self.local_positions[0])

    def first(self, xs: list):
        """This process's first position's entry of a sharded list."""
        return xs[self.local_positions[0]]

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
    """Build a Mesh over `devices`, this process's devices (default:
    every card it sees, in order; raises without one, as the entry points
    do).

    With no `axis_sizes`, all positions go to the last axis and leading
    axes get size 1. An explicit list may name one device more than once
    (`[torch.device("cuda:0")] * 4`). Once processes are joined the mesh
    spans them: its positions split evenly over the processes (process-
    major), each process puts its share on its `devices` in order, and
    with no `axis_sizes` the last axis holds every process's devices.
    Fewer devices than positions raise the reference's ValueError
    ("mesh needs N devices, have M", counted over every process)."""
    if devices is None:
        devices = local_cards()
    devices = [torch.device(d) for d in devices]
    world = multihost.process_count()
    n = len(devices)
    if axis_sizes is None:
        axis_sizes = [1] * (len(axis_names) - 1) + [n * world]
    total = int(np.prod(axis_sizes))
    if total % world:
        raise ValueError(f"a mesh of {total} positions does not split "
                         f"over {world} processes")
    per = total // world
    if per > n:
        raise ValueError(f"mesh needs {total} devices, have {n * world}")
    rank = multihost.process_index()
    grid = np.empty(total, dtype=object)
    for i in range(per):
        grid[rank * per + i] = devices[i]
    shape = tuple(int(s) for s in axis_sizes)
    owners = (np.repeat(np.arange(world), per).reshape(shape)
              if world > 1 else None)
    return Mesh(grid.reshape(shape), axis_names, owners)


def mesh_from_spec(spec: Optional[str], device=None) -> Optional[Mesh]:
    """Parse the CLI's `--mesh` flag into a Mesh (or None).

    Accepted: None / "" / "none" / "1" -> single device (no mesh);
    "auto" -> every card on a ("z",) axis (None if only one);
    "z=8" / "view=2,z=4" -> explicit axis names and sizes. `device` is the
    stage's device (default CUDA): on CUDA the positions go over
    cuda:0..n-1 in order, and a mesh larger than the cards present raises
    "mesh needs N devices, have M". On the CPU every position is the
    host, so "z=8" is eight shards run one after another there and "auto"
    is None (the reference's CPU has 8 virtual devices, the port's one
    host). Once processes are joined the mesh spans them (`make_mesh`):
    "auto" is every process's cards, or one position a process on the
    CPU, and an explicit spec splits evenly over the processes."""
    if spec is None or spec in ("", "none", "1"):
        return None
    dev = resolve_device(device)
    world = multihost.process_count()
    if spec == "auto":
        if dev.type != "cuda":
            return make_mesh(("z",), (world,), [dev]) if world > 1 else None
        n = torch.cuda.device_count() * world
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
                     devices=[dev] * (int(np.prod(sizes)) // world))


# ------------------------------------------------------------ cross-shard

def shard_map(fn, mesh: Mesh, *shards) -> list:
    """[fn(p, shards[0][p], shards[1][p], ...) for every position p of
    this process], each on p's device; None at other processes'
    positions."""
    out = []
    for p in range(mesh.size):
        if not mesh.is_local(p):
            out.append(None)
            continue
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
    zeros, as `lax.ppermute` gives them. Sources of another process
    arrive in one `multihost.exchange` a call. `ppermute.peer_bytes`
    counts the bytes this process's positions received from another
    position (from another card where each position has its own)."""
    out = [None] * mesh.size
    sends, recvs, remote = [], [], []
    me = multihost.process_index()
    for p in range(mesh.size):
        group = _axis_group(mesh, p, axis)
        i = mesh.index(p, axis) - shift
        q = group[i] if 0 <= i < len(group) else None
        if q is None or mesh.owner(q) == mesh.owner(p):
            if mesh.is_local(p):
                dev = mesh.device(p)
                out[p] = (torch.zeros_like(xs[p], device=dev) if q is None
                          else xs[q].to(dev, non_blocking=True))
                if q is not None:
                    ppermute.peer_bytes += out[p].nbytes
        elif mesh.owner(q) == me:        # q -> p, p on another process
            sends.append((xs[q], mesh.owner(p), p))
        elif mesh.is_local(p):
            recvs.append((xs[p], mesh.owner(q), mesh.device(p), p))
            remote.append(p)
    for p, t in zip(remote, multihost.exchange(sends, recvs)):
        out[p] = t
        ppermute.peer_bytes += t.nbytes
    return out


ppermute.peer_bytes = 0


def _crosses(mesh: Mesh, axis: str) -> bool:
    """Whether some group along `axis` holds positions of two
    processes (the same answer on every process)."""
    if not mesh.spans_processes:
        return False
    return any(len({mesh.owner(q) for q in _axis_group(mesh, p, axis)}) > 1
               for p in range(mesh.size))


def psum(xs: list, mesh: Mesh, axis: str) -> list:
    """The sum over `axis` at every position of this process (x_0 + x_1
    + ... in axis order), computed once per group and device. Where the
    axis crosses processes the partials are gathered first
    (`allgather`), so the order and the result stay the one-process
    ones."""
    if _crosses(mesh, axis):
        xs = allgather(xs, mesh)
    done = {}
    out = []
    for p in range(mesh.size):
        if not mesh.is_local(p):
            out.append(None)
            continue
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


def allgather(xs: list, mesh: Mesh) -> list:
    """Every position's entry of a sharded list on this process, each a
    tensor or a tuple of tensors (`process_allgather` of per-shard
    results): this process's as they are, the others' received on the
    host (gloo) or on this process's first device (NCCL). Without other
    processes, `xs` itself."""
    if not mesh.spans_processes:
        return list(xs)
    local = mesh.local_positions
    first = xs[local[0]]
    if isinstance(first, tuple):
        parts = [allgather([None if x is None else x[k] for x in xs], mesh)
                 for k in range(len(first))]
        return [tuple(part[p] for part in parts) for p in range(mesh.size)]
    got = multihost.all_gather([xs[p] for p in local])
    per = len(local)
    return [xs[p] if mesh.is_local(p) else got[mesh.owner(p)][p % per]
            for p in range(mesh.size)]


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
    """This process's shards of a host array (or tensor), the others None:
    the leading dims split over the axes named in `spec` (None:
    replicated), the rest whole (`jax.device_put(a, NamedSharding(mesh,
    P(*spec)))`). Positions on one device that hold the same slice share
    one tensor, so shards are never changed in place."""
    if isinstance(array, np.ndarray):
        array = torch.from_numpy(np.ascontiguousarray(array))
    array = array.to(dtype)
    done = {}
    out = []
    for p in range(mesh.size):
        idx = _local_index(mesh, p, spec, array.shape)
        if not mesh.is_local(p):
            out.append(None)
            continue
        dev = mesh.device(p)
        key = (str(idx), dev)
        if key not in done:
            done[key] = array[idx].contiguous().to(dev, non_blocking=True)
        out.append(done[key])
    return out


def gather(xs: list, mesh: Mesh, spec=()) -> np.ndarray:
    """The host array whose shards `xs` are (the inverse of `shard`), on
    every process (`process_allgather(tiled=True)`): each block is read
    from the first position that holds it."""
    xs = allgather(xs, mesh)
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
