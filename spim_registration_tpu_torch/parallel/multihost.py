"""Multi-process execution: processes joined by `torch.distributed`.

Port of the reference's `parallel/multihost.py` (`jax.distributed` and a
("host", "z") mesh). `initialize_multihost` joins the processes named by
COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID; after it a `Mesh` of
`parallel/mesh.py` spans them (positions process-major, as `jax.devices()`
orders them), and the cross-position functions there (`ppermute`,
`psum`, `gather`) reach the other processes through the two transports
below. Nothing else in the engines knows of processes.

Transport, fixed once at start:
- the default group is gloo: it carries host tensors and small objects;
- CUDA tensors go over an NCCL group only where every rank holds cards
  no other rank holds (NCCL refuses two ranks on one card). Otherwise
  (several processes on one card) they are staged through the host and
  go over gloo. `initialize_multihost` decides this from every rank's
  (hostname, card UUID) list, logs it and returns it; nothing switches
  routes later.

`traffic` counts the bytes this process received from other processes
and the host seconds spent in those exchanges (staging copies included).
"""

from __future__ import annotations

import datetime
import os
import socket
import time
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from spim_registration_tpu_torch.utils.device import local_cards
from spim_registration_tpu_torch.utils.log import get_logger

logger = get_logger("multihost")

# a peer that does not answer within this fails the call instead of
# waiting forever
TIMEOUT_S = 120

_nccl_group = None

# bytes received from other processes and host seconds spent exchanging
traffic = {"bytes": 0, "seconds": 0.0, "exchanges": 0}


def _joined() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    """This process's rank (`jax.process_index`); 0 without a group."""
    return dist.get_rank() if _joined() else 0


def process_count() -> int:
    """The number of joined processes (`jax.process_count`); 1 without a
    group."""
    return dist.get_world_size() if _joined() else 1


def route() -> Optional[str]:
    """How CUDA tensors cross processes, "nccl" or "gloo"; None without
    a group."""
    if not _joined():
        return None
    return "nccl" if _nccl_group is not None else "gloo"


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None) -> Optional[str]:
    """Join the processes from the arguments or the environment
    (COORDINATOR_ADDRESS as host:port, NUM_PROCESSES, PROCESS_ID).

    With one process, or no address, does nothing, says so and returns
    None. Otherwise calls `init_process_group` (gloo, `tcp://<address>`,
    TIMEOUT_S), decides the route of CUDA tensors and returns it ("nccl"
    or "gloo")."""
    global _nccl_group
    coordinator_address = coordinator_address or os.environ.get(
        "COORDINATOR_ADDRESS")
    if num_processes is None:
        num_processes = int(os.environ.get("NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("PROCESS_ID", "0"))
    if num_processes <= 1 or coordinator_address is None:
        logger.info("single-process run (no torch.distributed)")
        return None
    timeout = datetime.timedelta(seconds=TIMEOUT_S)
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id,
                            timeout=timeout)
    host = socket.gethostname()
    cards = ([str(torch.cuda.get_device_properties(d).uuid)
              for d in local_cards()] if torch.cuda.is_available() else [])
    every = [None] * num_processes
    dist.all_gather_object(every, (host, cards))
    held = [(h, c) for h, cs in every for c in cs]
    if all(cs for _, cs in every) and len(set(held)) == len(held):
        torch.cuda.set_device(local_cards()[0])
        _nccl_group = dist.new_group(backend="nccl", timeout=timeout)
        warm = torch.ones(1, device=local_cards()[0])
        dist.all_reduce(warm, group=_nccl_group)
    logger.info("torch.distributed joined: process %d/%d on %s, %d local "
                "card(s); CUDA tensors cross processes over %s",
                process_id, num_processes, host, len(cards), route())
    return route()


def shutdown_multihost() -> None:
    """Wait for every process, then leave the group (no-op without
    one)."""
    global _nccl_group
    if not _joined():
        return
    dist.barrier()
    dist.destroy_process_group()
    _nccl_group = None


def host_z_mesh(z_per_host: Optional[int] = None, device=None):
    """Mesh ("host", "z") = (processes, positions a process), positions
    process-major, so z-sharding over the whole mesh crosses processes
    only at the host boundaries.

    `z_per_host` (unused by the reference) is the number of local
    positions: by default the process's cards; more than the cards puts
    positions on them in turn. On the CPU (`device="cpu"`) every
    position is the host and `z_per_host` must be given."""
    from spim_registration_tpu_torch.parallel.mesh import make_mesh
    from spim_registration_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        cards = local_cards()
        n = len(cards) if z_per_host is None else int(z_per_host)
        devices = [cards[i % len(cards)] for i in range(n)]
    else:
        if z_per_host is None:
            raise ValueError("host_z_mesh on the CPU needs z_per_host")
        n = int(z_per_host)
        devices = [dev] * n
    return make_mesh(("host", "z"), (process_count(), n), devices)


def shard_timepoints(timepoints: Sequence[int]) -> list:
    """This process's share of the timepoints: timepoints[p::P]."""
    return list(timepoints)[process_index()::process_count()]


# ------------------------------------------------------------ transport

def _group(t: torch.Tensor):
    """The group a tensor crosses processes in: NCCL for a CUDA tensor
    where it was set up, else the default gloo group (None), from the
    host."""
    return _nccl_group if t.is_cuda and _nccl_group is not None else None


def _staged(t: torch.Tensor) -> torch.Tensor:
    if _group(t) is not None:
        return t.contiguous()
    return t.detach().cpu().contiguous()


def exchange(sends: List[tuple], recvs: List[tuple]) -> list:
    """One `batch_isend_irecv`: sends are (tensor, rank, tag), recvs are
    (like, rank, device, tag) with `like` a tensor of the shape and dtype
    to receive. A send and its recv carry one tag (gloo matches on it),
    and both sides list the pairs of a peer in one order (NCCL matches on
    that). Returns the received tensors on their devices."""
    if not sends and not recvs:
        return []
    t0 = time.perf_counter()
    ops, bufs = [], []
    for t, peer, tag in sends:
        ops.append(dist.P2POp(dist.isend, _staged(t), peer, group=_group(t),
                              tag=tag))
    for like, peer, dev, tag in recvs:
        group = _group(like)
        buf = torch.empty(like.shape, dtype=like.dtype,
                          device=dev if group is not None else "cpu")
        ops.append(dist.P2POp(dist.irecv, buf, peer, group=group, tag=tag))
        bufs.append((buf, dev))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    out = [buf.to(dev, non_blocking=True) for buf, dev in bufs]
    traffic["bytes"] += sum(b.numel() * b.element_size() for b, _ in bufs)
    traffic["seconds"] += time.perf_counter() - t0
    traffic["exchanges"] += 1
    return out


def all_gather(local: List[torch.Tensor]) -> List[List[torch.Tensor]]:
    """Every process's list of local tensors (each process holds as many,
    of one shape and dtype), indexed [rank][i]; on the device of this
    process's first tensor (NCCL) or on the host (gloo)."""
    t0 = time.perf_counter()
    first = local[0]
    group = _group(first)
    stack = _staged(torch.stack([t.to(first.device) for t in local]))
    world = process_count()
    bufs = [torch.empty_like(stack) for _ in range(world)]
    dist.all_gather(bufs, stack, group=group)
    traffic["bytes"] += (world - 1) * stack.numel() * stack.element_size()
    traffic["seconds"] += time.perf_counter() - t0
    traffic["exchanges"] += 1
    return [list(b.unbind(0)) for b in bufs]
