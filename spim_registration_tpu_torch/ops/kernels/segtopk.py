"""Per-segment top-`rounds` extraction on a hand-written CUDA kernel.

Port of the reference's `ops/pallas/segtopk.py` (`segment_topk`, whose
`_seg_topk_kernel` it replaces): one read of a -inf-padded score field
seen as (S, seg) segments gives, per segment, `rounds` (value, flat index)
pairs of (max, first index of the max, mask that index) and the count of
finite entries — the input of the overflow guard in
`ops.extrema._segmented_compact_topk`.

`segment_topk_reference` is the plain PyTorch version (the reference's XLA
round loop plus the counts). The wrapper takes it only for tensors on the
CPU; for CUDA tensors it launches `csrc/segtopk.cu` (a persistent grid
of the blocks resident on the card at once) or raises — there is no
fallback. Launches are counted in `segment_topk.launches`. Past a segment's count every round
gives (-inf, s * seg): the kernel writes those rounds without running
them.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from spim_registration_tpu_torch.ops.kernels import build

# segment widths the kernel is compiled for (32 lanes x 4/8/16 values)
SEGMENTS = (128, 256, 512)


def segment_topk_reference(tiles: torch.Tensor, rounds: int = 4):
    """Plain version of `segment_topk` on (S, seg) tiles: `rounds` passes
    of argmax (first index among equal maxima; 0 for an all--inf row)
    and mask-by-index. Returns (vals (S, rounds), idx (S, rounds) int32
    flat, counts (S,) int32)."""
    S, seg = tiles.shape
    tiles = tiles.clone()
    rows = torch.arange(S, device=tiles.device)
    base = rows.to(torch.int32) * seg
    counts = (tiles > -torch.inf).sum(dim=1, dtype=torch.int32)
    vals, idxs = [], []
    for _ in range(rounds):
        am = torch.argmax(tiles, dim=1)
        vals.append(tiles[rows, am])
        idxs.append(base + am.to(torch.int32))
        tiles[rows, am] = -torch.inf
    return torch.stack(vals, 1), torch.stack(idxs, 1), counts


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("segtopk")
    lib.spim_segtopk.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.spim_segtopk.restype = ctypes.c_int
    return lib


def segment_topk(tiles: torch.Tensor, rounds: int = 4):
    """(vals (S, rounds) f32, idx (S, rounds) int32 flat = segment * seg +
    position, counts (S,) int32) of a (S, seg) float32 field, segment-major
    as the reference's Pallas call lays them out. CPU tensors take
    `segment_topk_reference`; CUDA tensors launch the kernel."""
    if tiles.device.type == "cpu":
        return segment_topk_reference(tiles, rounds)
    if tiles.device.type != "cuda":
        raise ValueError(f"segment_topk: tensor on {tiles.device}")
    if tiles.dim() != 2 or tiles.dtype != torch.float32:
        raise ValueError(f"segment_topk: needs a (S, seg) float32 tensor, "
                         f"got {tuple(tiles.shape)} {tiles.dtype}")
    if not tiles.is_contiguous() or tiles.data_ptr() % 16:
        raise ValueError("segment_topk: tiles must be contiguous and "
                         "16-byte aligned")
    S, seg = tiles.shape
    if seg not in SEGMENTS or S == 0 or S * seg >= 2 ** 31 or rounds < 1:
        raise ValueError(f"segment_topk: cannot take S={S}, seg={seg}, "
                         f"rounds={rounds} (seg in {SEGMENTS}, S * seg "
                         f"< 2^31)")
    dev = tiles.device
    vals = torch.empty((S, rounds), dtype=torch.float32, device=dev)
    idx = torch.empty((S, rounds), dtype=torch.int32, device=dev)
    counts = torch.empty((S,), dtype=torch.int32, device=dev)
    err = _lib().spim_segtopk(
        tiles.data_ptr(), vals.data_ptr(), idx.data_ptr(), counts.data_ptr(),
        S, seg, rounds, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"segment_topk: CUDA launch failed with error "
                           f"{err}")
    segment_topk.launches += 1
    return vals, idx, counts


segment_topk.launches = 0
