"""Fused Difference-of-Gaussian on a hand-written CUDA kernel.

Port of the reference's `ops/pallas/dog.py` (`dog_pallas`, whose inner
kernel `csrc/dog.cu` replaces): both Gaussian blurs and their difference
in one pass over the volume, the input read once with its halo, the DoG
written once, the mirror boundary reflected inside the kernel (no padded
copy of the volume).

`dog_reference` is the plain PyTorch version (`ops.gaussian`'s
`difference_of_gaussian`, the reference kernel's contract). `dog_fused`
takes it only for tensors on the CPU; for CUDA tensors it launches the
kernel, sized by `dog_plan` (tile, z chunk), or raises —
there is no fallback. Launches are counted in `dog_fused.launches`. The
detection path keeps `difference_of_gaussian`, as the reference's does.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from spim_registration_tpu_torch.ops.gaussian import (
    _per_axis,
    difference_of_gaussian,
    gaussian_kernel_1d,
)
from spim_registration_tpu_torch.ops.kernels import build
from spim_registration_tpu_torch.utils.device import sm_count

# taps per sigma and axis of csrc/dog.cu's table (radius <= 15)
MAX_TAPS = 32
# the radii csrc/dog.cu is compiled for (taps zero-padded to the next)
RADII = (2, 4, 7, 11, 15)
# csrc/dog.cu's block: 512 threads in 16 row groups of V rows x 32 columns
_TILE_X = 32
_ROW_GROUPS = 16
_STAGES = 4
_ALIGN = 128


class DogPlan(NamedTuple):
    """A launch of csrc/dog.cu: the (ty, 32) output tile, tz output planes
    a block and the block's shared bytes."""
    ty: int
    tz: int
    smem: int


def _smem(R: int) -> int:
    """csrc/dog.cu's `smem_bytes`: alignment, the ring of 4 plane windows
    ((ty + 2R) x (32 + 2H) floats, H = R rounded up to 4, each slot
    rounded to 128 bytes), two x-pass buffers of both sigmas, an mbarrier
    a slot and the reflected row and column tables."""
    wy = _ROW_GROUPS * (4 if R <= 7 else 2) + 2 * R
    wx = _TILE_X + 2 * ((R + 3) & ~3)
    slot = -(-wy * wx * 4 // _ALIGN) * _ALIGN
    return _ALIGN + _STAGES * slot + 4 * wy * _TILE_X * 4 + _STAGES * 8 \
        + (wy + wx) * 4


@functools.lru_cache(maxsize=256)
def dog_plan(Z: int, Y: int, X: int, R: int, sms: int) -> DogPlan:
    """The launch of csrc/dog.cu for a (Z, Y, X) volume at compiled radius
    R on a card of `sms` streaming multiprocessors. A block (one per SM:
    512 threads with (2R + 1) x V accumulators each) owns a (16 V) x 32
    tile, V = 4 rows a thread up to R = 7 and 2 above; the z chunks split
    the volume until the grid fills the card once, but no chunk is
    thinner than its 2R halo (each chunk re-reads 2R planes)."""
    if R not in RADII:
        raise ValueError(f"dog_plan: radius {R} is not one of {RADII}")
    if min(Z, Y, X) < 1 or sms < 1:
        raise ValueError(f"dog_plan: cannot take {(Z, Y, X)}, sms={sms}")
    ty = _ROW_GROUPS * (4 if R <= 7 else 2)
    nx, ny = -(-X // _TILE_X), -(-Y // ty)
    chunks = max(1, min(sms // (nx * ny), Z // (2 * R)))
    return DogPlan(ty, -(-Z // chunks), _smem(R))


def dog_reference(vol: torch.Tensor, sigma1, sigma2) -> torch.Tensor:
    """Plain version of `dog_fused`: blur(sigma1) - blur(sigma2)."""
    return difference_of_gaussian(vol, sigma1, sigma2)


def dog_taps(sigma1, sigma2):
    """The kernel's tap table: (taps (2, 3, MAX_TAPS) float32 centred at
    each radius, radii (2, 3) int32) for per-axis (z, y, x) sigmas — the
    1-D kernels of `gaussian_kernel_1d` (radius max(1, ceil(3 sigma)),
    normalised in float64 and rounded to float32)."""
    taps = np.zeros((2, 3, MAX_TAPS), np.float32)
    radii = np.zeros((2, 3), np.int32)
    for s, sig in enumerate((_per_axis(sigma1), _per_axis(sigma2))):
        for a, sv in enumerate(sig):
            k = gaussian_kernel_1d(float(sv))
            if k.shape[0] > MAX_TAPS - 1:
                raise ValueError(f"dog_fused: sigma {sv} needs {k.shape[0]} "
                                 f"taps; the kernel takes at most "
                                 f"{MAX_TAPS - 1}")
            taps[s, a, :k.shape[0]] = k
            radii[s, a] = (k.shape[0] - 1) // 2
    return taps, radii


@functools.lru_cache(maxsize=64)
def _launch_taps(sigma1: tuple, sigma2: tuple):
    """`dog_taps` of per-axis sigmas and the host addresses a launch
    passes (the arrays stay alive in the cache): made once per sigma pair
    instead of in front of every launch."""
    taps, radii = dog_taps(sigma1, sigma2)
    return taps, radii, taps.ctypes.data, radii.ctypes.data


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("dog")
    lib.spim_dog_max_taps.argtypes = []
    lib.spim_dog_max_taps.restype = ctypes.c_int
    lib.spim_dog_radius.argtypes = [ctypes.c_int]
    lib.spim_dog_radius.restype = ctypes.c_int
    lib.spim_dog_tile_rows.argtypes = [ctypes.c_int]
    lib.spim_dog_tile_rows.restype = ctypes.c_int
    lib.spim_dog_smem.argtypes = [ctypes.c_int]
    lib.spim_dog_smem.restype = ctypes.c_int
    lib.spim_dog.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p] * 3
    lib.spim_dog.restype = ctypes.c_int
    if lib.spim_dog_max_taps() != MAX_TAPS:
        raise RuntimeError("csrc/dog.cu taps differ from MAX_TAPS")
    for R in RADII:
        plan = dog_plan(1, 1, 1, R, 1)
        if lib.spim_dog_tile_rows(R) != plan.ty \
                or lib.spim_dog_smem(R) != plan.smem:
            raise RuntimeError("csrc/dog.cu's block differs from dog_plan")
    return lib


def dog_fused(vol: torch.Tensor, sigma1, sigma2) -> torch.Tensor:
    """DoG = blur(sigma1) - blur(sigma2) of a (Z, Y, X) volume, float32;
    each sigma a scalar or per-axis (sz, sy, sx). Counterpart of the
    reference's `ops/pallas/dog.py:70` `dog_pallas`. CPU tensors take
    `dog_reference`; CUDA tensors launch `csrc/dog.cu`."""
    if vol.device.type == "cpu":
        return dog_reference(vol, sigma1, sigma2)
    if vol.device.type != "cuda":
        raise ValueError(f"dog_fused: tensor on {vol.device}")
    if vol.dim() != 3 or vol.dtype != torch.float32:
        raise ValueError(f"dog_fused: needs a (Z, Y, X) float32 volume, got "
                         f"{tuple(vol.shape)} {vol.dtype}")
    if not vol.is_contiguous() or vol.numel() == 0 \
            or vol.numel() >= 2 ** 31:
        raise ValueError("dog_fused: the volume must be contiguous, "
                         "non-empty and below 2^31 voxels")
    _, radii, taps_p, radii_p = _launch_taps(
        tuple(map(float, _per_axis(sigma1))),
        tuple(map(float, _per_axis(sigma2))))
    lib = _lib()
    r = lib.spim_dog_radius(int(radii.max()))
    if r < 0:
        raise ValueError(f"dog_fused: the kernel takes radii up to 15, "
                         f"got {radii.tolist()}")
    Z, Y, X = vol.shape
    out = torch.empty_like(vol)
    plan = dog_plan(Z, Y, X, r, sm_count(vol.device))
    tma = X % 4 == 0 and vol.data_ptr() % 16 == 0
    err = lib.spim_dog(
        vol.data_ptr(), out.data_ptr(), Z, Y, X, plan.tz, int(tma), taps_p,
        radii_p,
        torch.cuda.current_stream(vol.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"dog_fused: CUDA launch failed with error {err}")
    dog_fused.launches += 1
    return out


dog_fused.launches = 0
