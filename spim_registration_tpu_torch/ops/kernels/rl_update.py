"""The RL update law: the elementwise work around the two convolutions of
an RL view update, for every RL engine (`deconv/lucy_richardson.py`,
`deconv/blocked.py`, `parallel/sharded.py`) and both schemes. Two passes
run as kernels (csrc/rl_update.cu), each one pass over memory; the
parallel scheme's update is `regularize_` of psi times its factor:

- `rl_quotient`: q = clamp(image / clamp_min(conv1, 1e-12), 0, 1e4), less
  1 in the delta form, written once in the dtype the second convolution
  reads (bf16 for the lowrank kernels' bf16 matrices);
- `rl_update`: psi = clamp_min(reg(psi * (1 + (osem * w) * d)), min_value)
  in place, with d = conv2 in the delta form and conv2 - 1 otherwise and
  reg(x) = x / (1 + lam x) where lam is set; optionally also the bf16 copy
  of the new psi that the next convolution reads.

Beside each wrapper sits its plain PyTorch version (`rl_quotient_reference`,
`rl_update_reference`): the chain the engines ran before, which is the
kernels' numerics contract (bit-identical results). A wrapper takes the
plain version only for tensors on the CPU; for CUDA tensors it launches
its kernel or raises — there is no fallback. Each wrapper counts its
launches in a plain integer attribute (`rl_quotient.launches`,
`rl_update.launches`).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from spim_registration_tpu_torch.ops.kernels import build
from spim_registration_tpu_torch.ops.kernels.lowrank_conv import _raise_on
from spim_registration_tpu_torch.utils.device import sm_count

# csrc/rl_update.cu: threads a block, voxels a thread's chunk
_THREADS = 256
_VEC = 8
# resident blocks an SM the grid-stride launch asks for (2048 threads)
_BLOCKS_PER_SM = 8


def regularize_(psi: torch.Tensor, lam, min_value: float) -> torch.Tensor:
    """In place: psi / (1 + lam psi) where `lam` is not None, then clamped
    below at `min_value`."""
    if lam is not None:
        psi.div_(1.0 + lam * psi)
    return psi.clamp_(min=min_value)


def rl_quotient_reference(image: torch.Tensor, conv1: torch.Tensor,
                          delta: bool = False,
                          bf16: bool = False) -> torch.Tensor:
    """Plain version of `rl_quotient`: image / conv1 clamped like the
    reference (no explosive updates), less 1 where `delta`, cast to bf16
    where `bf16`."""
    q = image / torch.clamp(conv1, min=1e-12)
    q = q.clamp_(0.0, 1e4)
    if delta:
        q = q - 1.0
    return q.to(torch.bfloat16) if bf16 else q


def rl_update_reference(psi: torch.Tensor, conv2: torch.Tensor,
                        weight: torch.Tensor, osem: float, lam,
                        min_value: float, delta: bool = False,
                        bf16_copy: bool = False) -> torch.Tensor:
    """Plain version of `rl_update`: psi *= 1 + osem * weight * d (d =
    conv2 where `delta`, else conv2 - 1), then `regularize_`, in place.
    Returns the next convolution's operand: a bf16 copy of the new psi
    where `bf16_copy`, else psi itself."""
    d = conv2 if delta else conv2 - 1.0
    psi.mul_(1.0 + osem * weight * d)
    regularize_(psi, lam, min_value)
    return psi.to(torch.bfloat16) if bf16_copy else psi


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("rl_update")
    lib.spim_rl_quotient.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_longlong] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.spim_rl_quotient.restype = ctypes.c_int
    lib.spim_rl_update.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong] * 5 + [ctypes.c_int, ctypes.c_float, ctypes.c_int,
                                  ctypes.c_float, ctypes.c_float,
                                  ctypes.c_int, ctypes.c_void_p]
    lib.spim_rl_update.restype = ctypes.c_int
    return lib


def _rows(name: str, conv: torch.Tensor, *dense: torch.Tensor) -> tuple:
    """Checks shared by the wrappers, and the kernels' view of `conv`:
    (Z, Y, X, s0, s1), one flat row where `conv` is contiguous. `dense`
    are the contiguous float32 operands; `conv` is a float32 volume of
    their shape with unit innermost stride (it may be a crop view)."""
    every = (conv,) + dense
    for t in every:
        if t.device != conv.device or t.device.type != "cuda":
            raise ValueError(f"{name}: all inputs must be on one CUDA device "
                             f"(got {[str(x.device) for x in every]})")
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: inputs must be float32 (got {t.dtype})")
        if t.shape != conv.shape or t.dim() != 3 or t.numel() == 0:
            raise ValueError(f"{name}: needs non-empty (Z, Y, X) volumes of "
                             f"one shape (got "
                             f"{[tuple(x.shape) for x in every]})")
    if not all(t.is_contiguous() for t in dense):
        raise ValueError(f"{name}: inputs other than the convolution must "
                         f"be contiguous")
    if conv.is_contiguous():
        return 1, 1, conv.numel(), 0, 0
    if conv.stride(2) != 1:
        raise ValueError(f"{name}: the convolution needs unit innermost "
                         f"stride (got strides {conv.stride()})")
    return (*conv.shape, conv.stride(0), conv.stride(1))


def _launch(conv: torch.Tensor, rows: tuple) -> tuple:
    """(blocks, stream) of a grid-stride launch over the chunks of `rows`:
    at most the blocks resident on the card at once."""
    Z, Y, X = rows[:3]
    chunks = Z * Y * -(-X // _VEC)
    blocks = min(-(-chunks // _THREADS),
                 _BLOCKS_PER_SM * sm_count(conv.device))
    return blocks, torch._C._cuda_getCurrentRawStream(conv.get_device())


def rl_quotient(image: torch.Tensor, conv1: torch.Tensor, delta: bool = False,
                bf16: bool = False) -> torch.Tensor:
    """clamp(image / clamp_min(conv1, 1e-12), 0, 1e4), less 1 where
    `delta`, as a new contiguous volume in bf16 where `bf16`, else float32.
    `conv1` may be a strided view with unit innermost stride; it is read in
    place. CPU tensors take `rl_quotient_reference`."""
    if image.device.type == "cpu" and conv1.device.type == "cpu":
        return rl_quotient_reference(image, conv1, delta, bf16)
    rows = _rows("rl_quotient", conv1, image)
    out = torch.empty(image.shape, device=image.device,
                      dtype=torch.bfloat16 if bf16 else torch.float32)
    err = _lib().spim_rl_quotient(
        image.data_ptr(), conv1.data_ptr(), out.data_ptr(), *rows,
        int(delta), int(bf16), *_launch(conv1, rows))
    _raise_on(err, "rl_quotient")
    rl_quotient.launches += 1
    return out


rl_quotient.launches = 0


def rl_update(psi: torch.Tensor, conv2: torch.Tensor, weight: torch.Tensor,
              osem: float, lam, min_value: float, delta: bool = False,
              bf16_copy: bool = False) -> torch.Tensor:
    """psi = clamp_min(reg(psi * (1 + (osem * weight) * d)), min_value) in
    place, d = conv2 where `delta`, else conv2 - 1, reg(x) = x / (1 + lam
    x) where `lam` is not None. Returns the next convolution's operand: a
    new bf16 copy of psi, written in the same pass, where `bf16_copy`,
    else psi itself. `conv2` may be a strided view with unit innermost
    stride. CPU tensors take `rl_update_reference`."""
    if all(t.device.type == "cpu" for t in (psi, conv2, weight)):
        return rl_update_reference(psi, conv2, weight, osem, lam, min_value,
                                   delta, bf16_copy)
    rows = _rows("rl_update", conv2, psi, weight)
    copy = (torch.empty(psi.shape, dtype=torch.bfloat16, device=psi.device)
            if bf16_copy else None)
    err = _lib().spim_rl_update(
        psi.data_ptr(), conv2.data_ptr(), weight.data_ptr(),
        None if copy is None else copy.data_ptr(), *rows, int(delta), osem,
        int(lam is not None), 0.0 if lam is None else lam, min_value,
        *_launch(conv2, rows))
    _raise_on(err, "rl_update")
    rl_update.launches += 1
    return psi if copy is None else copy


rl_update.launches = 0
