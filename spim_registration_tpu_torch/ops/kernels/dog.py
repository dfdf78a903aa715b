"""Fused Difference-of-Gaussian on a hand-written CUDA kernel.

Port of the reference's `ops/pallas/dog.py` (`dog_pallas`, whose inner
kernel `csrc/dog.cu` replaces): both Gaussian blurs and their difference
in one pass over the volume, the input read once with its halo, the DoG
written once, the mirror boundary reflected inside the kernel (no padded
copy of the volume).

`dog_reference` is the plain PyTorch version (`ops.gaussian`'s
`difference_of_gaussian`, the reference kernel's contract). `dog_fused`
takes it only for tensors on the CPU; for CUDA tensors it launches the
kernel or raises — there is no fallback. Launches are counted in
`dog_fused.launches`. The detection path keeps `difference_of_gaussian`,
as the reference's does.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from spim_registration_tpu_torch.ops.gaussian import (
    _per_axis,
    difference_of_gaussian,
    gaussian_kernel_1d,
)
from spim_registration_tpu_torch.ops.kernels import build

# taps per sigma and axis of csrc/dog.cu's table (radius <= 15)
MAX_TAPS = 32
# blocks the z chunking aims for per streaming multiprocessor (512
# threads each): more z chunks re-read more halo planes from L2 but keep
# more plane loads in flight
_BLOCKS_PER_SM = 4
# (y, x) tile of one block in csrc/dog.cu
_TILE_YX = 32


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


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("dog")
    lib.spim_dog_max_taps.argtypes = []
    lib.spim_dog_max_taps.restype = ctypes.c_int
    lib.spim_dog_radius.argtypes = [ctypes.c_int]
    lib.spim_dog_radius.restype = ctypes.c_int
    lib.spim_dog.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p] * 3
    lib.spim_dog.restype = ctypes.c_int
    if lib.spim_dog_max_taps() != MAX_TAPS:
        raise RuntimeError("csrc/dog.cu taps differ from MAX_TAPS")
    return lib


def _z_chunk(Z: int, Y: int, X: int, r: int, device) -> int:
    """Output planes per block: enough z chunks to give every SM
    `_BLOCKS_PER_SM` blocks, but no chunk thinner than its 2 r halo."""
    tiles = -(-Y // _TILE_YX) * -(-X // _TILE_YX)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    chunks = max(1, min(-(-_BLOCKS_PER_SM * sms // tiles),
                        Z // max(2 * r, 1)))
    return -(-Z // chunks)


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
    taps, radii = dog_taps(sigma1, sigma2)
    lib = _lib()
    r = lib.spim_dog_radius(int(radii.max()))
    if r < 0:
        raise ValueError(f"dog_fused: the kernel takes radii up to 15, "
                         f"got {radii.tolist()}")
    Z, Y, X = vol.shape
    out = torch.empty_like(vol)
    tz = _z_chunk(Z, Y, X, r, vol.device)
    err = lib.spim_dog(
        vol.data_ptr(), out.data_ptr(), Z, Y, X, tz,
        taps.ctypes.data, radii.ctypes.data,
        torch.cuda.current_stream(vol.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"dog_fused: CUDA launch failed with error {err}")
    dog_fused.launches += 1
    return out


dog_fused.launches = 0
