"""The lowrank (folded-matrix) convolution on hand-written CUDA kernels.

Port of the reference's `ops/pallas/lowrank_conv.py` main path. The
convolution of a volume with a CP-factored kernel is three stacked
folded-matrix passes (`ops/separable.py`); here they run as two kernels:

- `zpass` (csrc/zpass.cu): a[r, n, y, x] = sum_p Mz[r, n, p] vm[p, y, x]
  over each 64-row tile's band window (`band_blocks`), f32 accumulation,
  one rounding to the matrix dtype. Replaces `_zpass_banded_kernel` and
  `_zpass_kernel`.
- `sl_rows` (csrc/sl_rows.cu): o[z] = sum_r round(My[r] @ a[r, z]) @ Mx[r]^T,
  the rank loop inside the block, `o` written once in f32. Replaces
  `_sl_rows_kernel`.

Beside each wrapper sits its plain PyTorch version (`zpass_reference`,
`fused_sl_reference`) with the same numerics. A wrapper takes the plain
version only for tensors on the CPU; for CUDA tensors it launches its
kernel or raises — there is no fallback. Each wrapper counts its kernel
launches in a plain integer attribute (`zpass.launches`,
`sl_rows.launches`).

The TPU-only planning of the reference (VMEM plans, the X % 128 lane
requirement, the y/x banding gate) has no counterpart: the CUDA kernels
take any shape, mask the ragged edges, and their wrappers raise on what
they cannot take.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from spim_registration_tpu_torch.ops.kernels import build

# Output rows per band-window tile; equals TM in csrc/zpass.cu (checked
# against the library when it loads).
ZPASS_TILE_ROWS = 64
# Band windows start on multiples of the bf16 MMA depth.
_MMA_DEPTH = 16
# Cap on the z-pass intermediate `a` (R, Z, Y, X); above it the conv runs
# in z-slabs at full rank. 4 GiB keeps 512^3 x rank-20 convs (5.4 GB of
# `a`) to two slabs while leaving room for 4-8 views on an 80 GB card.
_A_SLAB_BYTES = 4 << 30

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}


def band_blocks(N: int, P: int, rad: int, off: int = 0):
    """Per-tile contraction windows of a band matrix for the CUDA z pass.

    Output row i of an (N, P) band matrix with half-support `rad` and band
    centre i + off (off = the slab's first row for z-slabs) has its
    nonzeros in columns [i + off - rad, i + off + rad]. A tile of
    `ZPASS_TILE_ROWS` rows starting at s therefore needs columns
    [s + off - rad, s + off + len + rad), here widened to multiples of the
    MMA depth and clipped to [0, P). Returns one (k0, k1) per tile, or
    None when every window is the whole of [0, P) (dense)."""
    wins = []
    for s in range(0, N, ZPASS_TILE_ROWS):
        ln = min(ZPASS_TILE_ROWS, N - s)
        k0 = max((s + off - rad) // _MMA_DEPTH * _MMA_DEPTH, 0)
        k1 = min(-(-(s + off + ln + rad) // _MMA_DEPTH) * _MMA_DEPTH, P)
        wins.append((min(k0, k1), k1))
    if all(k0 == 0 and k1 == P for k0, k1 in wins):
        return None
    return tuple(wins)


def zpass_reference(Mz: torch.Tensor, vm: torch.Tensor) -> torch.Tensor:
    """Plain version of `zpass`: one dense f32 matmul, rounded once to the
    matrix dtype. Mz (R, N, P), vm (P, Y, X) -> (R, N, Y, X)."""
    R, N, P = Mz.shape
    _, Y, X = vm.shape
    a = Mz.float().reshape(R * N, P) @ vm.float().reshape(P, Y * X)
    return a.to(Mz.dtype).reshape(R, N, Y, X)


def fused_sl_reference(a: torch.Tensor, My: torch.Tensor,
                       Mx: torch.Tensor) -> torch.Tensor:
    """Plain version of `sl_rows` (a copy of the reference's
    `fused_sl_reference`): f32 contractions, the y product cast back to
    the matrix dtype, the rank sum in f32. Returns (Z, Yo, Xo) f32."""
    b = torch.einsum("rzyx,rny->rznx", a.float(), My.float())
    b = b.to(My.dtype)
    c = torch.einsum("rzyx,rxn->rzyn", b.float(),
                     Mx.transpose(1, 2).float())
    return c.sum(dim=0)


@functools.lru_cache(maxsize=None)
def _zpass_lib():
    lib = build.load("zpass")
    lib.spim_zpass_tile_rows.argtypes = []
    lib.spim_zpass_tile_rows.restype = ctypes.c_int
    lib.spim_zpass.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_void_p]
    lib.spim_zpass.restype = ctypes.c_int
    if lib.spim_zpass_tile_rows() != ZPASS_TILE_ROWS:
        raise RuntimeError("csrc/zpass.cu tile rows differ from "
                           "ZPASS_TILE_ROWS")
    return lib


@functools.lru_cache(maxsize=None)
def _sl_rows_lib():
    lib = build.load("sl_rows")
    lib.spim_sl_rows_smem.argtypes = [ctypes.c_int] * 4
    lib.spim_sl_rows_smem.restype = ctypes.c_int
    lib.spim_sl_rows.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p]
    lib.spim_sl_rows.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=256)
def _window_table(wins: tuple, device: torch.device) -> torch.Tensor:
    return torch.tensor(wins, dtype=torch.int32, device=device).reshape(-1)


def _check_cuda(name: str, *tensors: torch.Tensor) -> int:
    """Device, dtype and contiguity checks shared by the wrappers; returns
    the kernel's dtype code."""
    dev = tensors[0].device
    dt = tensors[0].dtype
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: all inputs must be on one CUDA "
                             f"device (got {[str(x.device) for x in tensors]})")
        if t.dtype != dt or dt not in _DTYPE_CODE:
            raise ValueError(f"{name}: inputs must share one dtype of "
                             f"bfloat16/float32 "
                             f"(got {[x.dtype for x in tensors]})")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
        if t.numel() == 0:
            raise ValueError(f"{name}: empty input")
    return _DTYPE_CODE[dt]


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def zpass(Mz: torch.Tensor, vm: torch.Tensor, windows=None) -> torch.Tensor:
    """Stacked z pass a[r, n] = Mz[r, n, :] @ vm, (R, N, Y, X) in the matrix
    dtype. `windows`: per-tile (k0, k1) from `band_blocks`, or None for
    the dense contraction. CPU tensors take `zpass_reference`."""
    if Mz.device.type == "cpu" and vm.device.type == "cpu":
        return zpass_reference(Mz, vm)
    code = _check_cuda("zpass", Mz, vm)
    R, N, P = Mz.shape
    P2, Y, X = vm.shape
    if P2 != P:
        raise ValueError(f"zpass: Mz {tuple(Mz.shape)} vs vm {tuple(vm.shape)}")
    n_tiles = -(-N // ZPASS_TILE_ROWS)
    if windows is None:
        windows = ((0, P),) * n_tiles
    windows = tuple((int(k0), int(k1)) for k0, k1 in windows)
    if len(windows) != n_tiles or any(
            k0 % _MMA_DEPTH or not 0 <= k0 <= k1 <= P for k0, k1 in windows):
        raise ValueError(f"zpass: bad window table for N={N}, P={P}")
    rows = R * (n_tiles if code == 0 else N)
    if rows > 65535:
        raise ValueError(f"zpass: R x rows = {rows} exceeds the grid limit")
    table = _window_table(windows, Mz.device)
    out = torch.empty((R, N, Y, X), dtype=Mz.dtype, device=Mz.device)
    err = _zpass_lib().spim_zpass(
        Mz.data_ptr(), vm.data_ptr(), out.data_ptr(), table.data_ptr(),
        R, N, P, Y * X, code, torch.cuda.current_stream(Mz.device).cuda_stream)
    _raise_on(err, "zpass")
    zpass.launches += 1
    return out


zpass.launches = 0


def sl_rows(a: torch.Tensor, My: torch.Tensor, Mx: torch.Tensor
            ) -> torch.Tensor:
    """Fused y/x passes and rank sum: a (R, Z, Y, X), My (R, Yo, Y),
    Mx (R, Xo, X) -> (Z, Yo, Xo) f32. CPU tensors take
    `fused_sl_reference`."""
    if all(t.device.type == "cpu" for t in (a, My, Mx)):
        return fused_sl_reference(a, My, Mx)
    code = _check_cuda("sl_rows", a, My, Mx)
    R, Z, Y, X = a.shape
    Yo, Xo = My.shape[1], Mx.shape[1]
    if My.shape != (R, Yo, Y) or Mx.shape != (R, Xo, X):
        raise ValueError(f"sl_rows: a {tuple(a.shape)}, My "
                         f"{tuple(My.shape)}, Mx {tuple(Mx.shape)}")
    if Z > 65535:
        raise ValueError(f"sl_rows: Z={Z} exceeds the grid limit")
    lib = _sl_rows_lib()
    if lib.spim_sl_rows_smem(Y, X, Xo, code) < 0:
        raise ValueError(f"sl_rows: the kernel cannot take Y={Y}, X={X}, "
                         f"Xo={Xo} in {a.dtype}")
    out = torch.empty((Z, Yo, Xo), dtype=torch.float32, device=a.device)
    err = lib.spim_sl_rows(
        a.data_ptr(), My.data_ptr(), Mx.data_ptr(), out.data_ptr(),
        R, Z, Y, X, Yo, Xo, code,
        torch.cuda.current_stream(a.device).cuda_stream)
    _raise_on(err, "sl_rows")
    sl_rows.launches += 1
    return out


sl_rows.launches = 0


def conv_lowrank_folded_fused(vol: torch.Tensor, Mz: torch.Tensor,
                              My: torch.Tensor, Mx: torch.Tensor,
                              rad_z: int | None = None) -> torch.Tensor:
    """Mirror-boundary lowrank convolution through `zpass` + `sl_rows`
    (the twin of `ops.separable.conv_lowrank_folded`).

    `rad_z`: the kernel's z half-support; when given, the z pass
    contracts only each tile's band window. Volumes whose `a` would exceed
    `_A_SLAB_BYTES` run in z-slabs at full rank: the z-pass matrix rows
    are sliced to the slab and the band centre shifts by the slab's first
    row."""
    Z, Y, X = vol.shape
    R = Mz.shape[0]
    vm = vol.to(Mz.dtype).contiguous()

    def run(mz: torch.Tensor, off: int) -> torch.Tensor:
        win = (band_blocks(mz.shape[1], Z, rad_z, off)
               if rad_z is not None else None)
        return sl_rows(zpass(mz.contiguous(), vm, win), My, Mx)

    per_row = R * Y * X * Mz.element_size()
    if per_row * Z > _A_SLAB_BYTES:
        sl = max(1, _A_SLAB_BYTES // per_row)
        out = torch.empty((Z, My.shape[1], Mx.shape[1]), dtype=torch.float32,
                          device=vol.device)
        for s in range(0, Z, sl):
            out[s:s + sl] = run(Mz[:, s:s + sl], s)
        return out.to(vol.dtype)
    return run(Mz, 0).to(vol.dtype)
