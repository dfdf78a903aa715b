"""The lowrank (folded-matrix) convolution on hand-written CUDA kernels.

Port of the reference's `ops/pallas/lowrank_conv.py` main path. The
convolution of a volume with a CP-factored kernel is three stacked
folded-matrix passes (`ops/separable.py`); here they run as two kernels:

- `zpass` (csrc/zpass.cu): a[r, n, y, x] = sum_p Mz[r, n, p] vm[p, y, x]
  over each 64-row tile's band window (`band_blocks`), f32 accumulation,
  one rounding to the matrix dtype; the rank loop inside the block, the
  volume window read once for all ranks (`zpass_plan` sizes its tile).
  Replaces `_zpass_banded_kernel` and `_zpass_kernel`.
- `sl_rows` (csrc/sl_rows.cu): o[z] = sum_r round(My[r] @ a[r, z]) @ Mx[r]^T
  over each 64 x 64 output tile's y and x band windows (`band_blocks`
  on both axes), the rank loop inside the block, `o` written once in f32
  (`sl_rows_plan` cuts windows wider than a block holds into pieces).
  Replaces `_sl_rows_kernel`.

and, off the RL engine's path, the whole chain as one kernel:

- `zfused` (csrc/zfused.cu): z, y and x passes and the rank sum per
  output tile, the tile's volume window read once and reused across all
  ranks, no intermediate in device memory (`zfused_plan` sizes its tile
  and windows). Replaces `_zfused_kernel`; `conv_lowrank_folded_zfused`
  is its public entry point.

Beside each wrapper sits its plain PyTorch version (`zpass_reference`,
`fused_sl_reference`, `ops.separable.conv_lowrank_folded`) with the same
numerics. A wrapper takes the plain version only for tensors on the CPU;
for CUDA tensors it launches its kernel or raises — there is no fallback.
Each wrapper counts its kernel launches in a plain integer attribute
(`zpass.launches`, `sl_rows.launches`, `zfused.launches`); `zpass` also
counts its launches that read Mz at a row stride past P, the padded rows
of `zpass_mz_rows` (`zpass.mz_padded`).

The TPU-only planning of the reference (VMEM plans, the X % 128 lane
requirement, the y/x banding gate at 384, the XLA chain for what the plan
refuses) has no counterpart: the CUDA kernels mask the ragged edges, band
wherever the window table is not dense, and `sl_rows` takes windows of
any width in pieces; what is still out of reach (a z window wider than
`zpass_plan` takes, Z > 65535) raises ValueError.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from spim_registration_tpu_torch.ops.kernels import build
from spim_registration_tpu_torch.ops.separable import conv_lowrank_folded

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

# The bf16 z pass's (column tile, column tiles a block, shared-memory
# limit) choices, in the order `zpass_plan` tries them. Column tiles are
# template instances of csrc/zpass.cu; a block may take a block's maximum
# on sm_90, or at most what still lets two blocks share an SM (half the
# SM's 228 KB, less the 1 KB the runtime keeps a block).
_SMEM_MAX = 232448
_SMEM_TWO_PER_SM = 233472 // 2 - 1024
_ZPASS_SHAPES = ((128, 2, _SMEM_TWO_PER_SM), (128, 1, _SMEM_TWO_PER_SM),
                 (128, 2, _SMEM_MAX), (128, 1, _SMEM_MAX), (64, 1, _SMEM_MAX))


def _zpass_smem(tn: int, kpad: int, ct: int) -> int:
    """Shared-memory bytes of a bf16 z-pass block (csrc/zpass.cu
    `smem_bytes`): 1 KB of alignment, two 64 x tn output tiles, ct
    kpad x tn volume windows and two 64 x kpad matrix tiles."""
    tm = ZPASS_TILE_ROWS
    return 1024 + 2 * (2 * tm * tn + ct * kpad * tn + 2 * tm * kpad)


# The widest window (in columns of P, a multiple of the MMA depth) that
# some shape of _ZPASS_SHAPES takes within its limit.
ZPASS_MAX_WINDOW = max(
    (limit - _zpass_smem(tn, 0, ct))
    // (_zpass_smem(tn, 1, ct) - _zpass_smem(tn, 0, ct))
    // _MMA_DEPTH * _MMA_DEPTH for tn, ct, limit in _ZPASS_SHAPES)


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


def _widest(P: int, windows) -> int:
    return P if windows is None else max(k1 - k0 for k0, k1 in windows)


def _round_up(n: int, m: int) -> int:
    return max(m, -(-n // m) * m)


def _zpass_fit(P: int, windows):
    """`zpass_plan`'s plan, or None where no instance takes the window."""
    kpad = _round_up(_widest(P, windows), _MMA_DEPTH)
    for tn, ct, limit in _ZPASS_SHAPES:
        smem = _zpass_smem(tn, kpad, ct)
        if smem <= limit:
            return tn, kpad, ct, smem
    return None


def zpass_plan(P: int, windows=None) -> tuple:
    """The bf16 z-pass launch for a window table: (tn, kpad, ct, smem
    bytes). kpad is the widest window rounded up to the MMA depth; (tn, ct)
    the first of `_ZPASS_SHAPES` whose block fits its limit: two column
    tiles of 128 a block, two blocks an SM, where the window allows.
    `windows` None means the dense [0, P). Raises ValueError beyond
    ZPASS_MAX_WINDOW columns."""
    plan = _zpass_fit(P, windows)
    if plan is None:
        raise ValueError(f"zpass: the kernel cannot take a window of "
                         f"{_widest(P, windows)} columns (at most "
                         f"{ZPASS_MAX_WINDOW})")
    return plan


# The bf16 sl_rows kernel: y and x pieces pad to its 32-column swizzle
# slab and stage-1 chunk (XC in csrc/sl_rows.cu, checked against the
# library when it loads); a y piece has at most SL_ROWS_PIECE columns (a
# TMA box's rows, MAX_KP there). Its z-slices a block, in the order
# `sl_rows_plan` tries them: four share each rank's matrix tiles where the
# windows allow.
SL_ROWS_CHUNK = 32
SL_ROWS_PIECE = 256
_SL_ROWS_SLICES = (4, 2, 1)


def _sl_rows_smem(kp: int, xp: int, tz: int) -> int:
    """Shared-memory bytes of a bf16 sl_rows block (csrc/sl_rows.cu
    `spim_sl_rows_smem`): 1024 bytes of alignment, 16 of mbarriers and two
    ring slots of a 64 x kp My tile, tz kp x xp pieces of `a` (one a
    z-slice) and a 64 x xp Mx tile, all bf16."""
    t = ZPASS_TILE_ROWS
    return 1040 + 4 * (t * kp + tz * kp * xp + t * xp)


def sl_rows_plan(Y: int, X: int, Yo: int, Xo: int, y_windows=None,
                 x_windows=None) -> tuple:
    """The bf16 sl_rows launch for its window tables: (kp, xp, tz, smem
    bytes). `y_windows` has one (k0, k1) window of Y per 64-row tile of Yo
    and `x_windows` one window of X per 64-column tile of Xo (from
    `band_blocks`); None is the dense [0, Y) / [0, X). The kernel walks
    each tile's windows in pieces of kp y columns and xp x columns (its
    ring's unit) with tz z-slices a block. A piece is the whole window
    (the widest y and x windows rounded up to the 32-column slab) where a
    block of four, two or one slices holds it, the first that does.
    Otherwise four slices a block, y in pieces of at most SL_ROWS_PIECE
    columns and x in the widest pieces that still fit (one 32-column
    chunk where y is cut). Every window is planned; a bad table raises
    ValueError."""
    for name, n, tiles, wins in (("y", Y, Yo, y_windows),
                                 ("x", X, Xo, x_windows)):
        if wins is not None and (
                len(wins) != -(-tiles // ZPASS_TILE_ROWS) or any(
                    k0 % _MMA_DEPTH or not 0 <= k0 <= k1 <= n
                    for k0, k1 in wins)):
            raise ValueError(f"sl_rows: bad {name} window table for "
                             f"{tiles} rows of {n}")
    kyp = _round_up(_widest(Y, y_windows), SL_ROWS_CHUNK)
    xwp = _round_up(_widest(X, x_windows), SL_ROWS_CHUNK)
    if kyp <= SL_ROWS_PIECE:
        for tz in _SL_ROWS_SLICES:
            smem = _sl_rows_smem(kyp, xwp, tz)
            if smem <= _SMEM_MAX:
                return kyp, xwp, tz, smem
    kp, tz = min(kyp, SL_ROWS_PIECE), _SL_ROWS_SLICES[0]
    xp = SL_ROWS_CHUNK
    if kp == kyp:
        per_col = _sl_rows_smem(kp, 1, tz) - _sl_rows_smem(kp, 0, tz)
        xp = ((_SMEM_MAX - _sl_rows_smem(kp, 0, tz)) // per_col
              // SL_ROWS_CHUNK * SL_ROWS_CHUNK)
    return kp, xp, tz, _sl_rows_smem(kp, xp, tz)


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
    lib.spim_zpass_smem.argtypes = [ctypes.c_int] * 3
    lib.spim_zpass_smem.restype = ctypes.c_int
    lib.spim_zpass.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_longlong] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.spim_zpass.restype = ctypes.c_int
    if lib.spim_zpass_tile_rows() != ZPASS_TILE_ROWS:
        raise RuntimeError("csrc/zpass.cu tile rows differ from "
                           "ZPASS_TILE_ROWS")
    for tn, ct, _ in _ZPASS_SHAPES:
        for kpad in (16, 96, ZPASS_MAX_WINDOW):
            want = _zpass_smem(tn, kpad, ct)
            if lib.spim_zpass_smem(tn, kpad, ct) != (
                    want if want <= _SMEM_MAX else -1):
                raise RuntimeError("csrc/zpass.cu shared memory differs "
                                   "from zpass_plan")
    return lib


@functools.lru_cache(maxsize=None)
def _sl_rows_lib():
    lib = build.load("sl_rows")
    for fn in (lib.spim_sl_rows_tile, lib.spim_sl_rows_chunk):
        fn.argtypes = []
        fn.restype = ctypes.c_int
    lib.spim_sl_rows_smem.argtypes = [ctypes.c_int] * 3
    lib.spim_sl_rows_smem.restype = ctypes.c_int
    lib.spim_sl_rows.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 12 \
        + [ctypes.c_void_p]
    lib.spim_sl_rows.restype = ctypes.c_int
    if (lib.spim_sl_rows_tile() != ZPASS_TILE_ROWS
            or lib.spim_sl_rows_chunk() != SL_ROWS_CHUNK):
        raise RuntimeError("csrc/sl_rows.cu tile or chunk differ from "
                           "ZPASS_TILE_ROWS / SL_ROWS_CHUNK")
    for tz in _SL_ROWS_SLICES:
        for kp, xp in ((32, 32), (96, 96), (SL_ROWS_PIECE, 32),
                       (SL_ROWS_PIECE, 256), (SL_ROWS_PIECE + 32, 32)):
            want = _sl_rows_smem(kp, xp, tz)
            if lib.spim_sl_rows_smem(kp, xp, tz) != (
                    want if want <= _SMEM_MAX and kp <= SL_ROWS_PIECE
                    else -1):
                raise RuntimeError("csrc/sl_rows.cu shared memory differs "
                                   "from sl_rows_plan")
    return lib


@functools.lru_cache(maxsize=256)
def _sl_rows_setup(Y: int, X: int, Yo: int, Xo: int, rad_y, rad_x,
                   bf16: bool, device: torch.device) -> tuple:
    """The y and x window tables (dense where a half-support is None or
    the band covers the axis) as one int32 tensor on `device`, with the
    bf16 plan (kp, xp, tz, and 1 where some window is cut into pieces;
    zeros for float32): work shared by every launch on the same shapes."""
    tables = [band_blocks(tiles, n, rad) if rad is not None else None
              for n, tiles, rad in ((Y, Yo, rad_y), (X, Xo, rad_x))]
    plan = (0,) * 4
    if bf16:
        kp, xp, tz, _ = sl_rows_plan(Y, X, Yo, Xo, *tables)
        plan = (kp, xp, tz, int(kp < _widest(Y, tables[0])
                                or xp < _widest(X, tables[1])))
    flat = []
    for (n, tiles), wins in zip(((Y, Yo), (X, Xo)), tables):
        flat += wins or ((0, n),) * -(-tiles // ZPASS_TILE_ROWS)
    table = torch.tensor(flat, dtype=torch.int32, device=device)
    return (table.reshape(-1),) + plan


def sl_rows_tma_load(a: torch.Tensor, My: torch.Tensor,
                     Mx: torch.Tensor) -> bool:
    """Whether the bf16 sl_rows kernel loads its tiles by TMA (one thread
    a block, through tensor maps whose boxes are the padded pieces): rows
    of Y and X a multiple of 16 bytes and 16-byte aligned bases. A box may
    run past an axis (the card fills zeros). Other inputs take every
    thread's cp.async copies; tensor maps that should exist but cannot be
    built raise."""
    Y, X = a.shape[2], a.shape[3]
    return (Y % 8 == 0 and X % 8 == 0
            and all(t.data_ptr() % 16 == 0 for t in (a, My, Mx)))


@functools.lru_cache(maxsize=256)
def _zpass_setup(windows, N: int, P: int, bf16: bool,
                 device: torch.device) -> tuple:
    """One window table checked and on `device`, with the bf16 plan
    (tn, kpad, ct; zeros for float32): work shared by every launch on the
    same table."""
    n_tiles = -(-N // ZPASS_TILE_ROWS)
    if windows is None:
        windows = ((0, P),) * n_tiles
    windows = tuple((int(k0), int(k1)) for k0, k1 in windows)
    if len(windows) != n_tiles or any(
            k0 % _MMA_DEPTH or not 0 <= k0 <= k1 <= P for k0, k1 in windows):
        raise ValueError(f"zpass: bad window table for N={N}, P={P}")
    plan = zpass_plan(P, windows)[:3] if bf16 else (0, 0, 0)
    table = torch.tensor(windows, dtype=torch.int32, device=device)
    return (table.reshape(-1),) + plan


# The bf16 z pass copies its matrix tiles by 16-byte cp.async: every row
# of Mz it reads starts on 16 bytes (8 elements).
_MZ_ROW_ALIGN = 8


def zpass_mz_row_stride(shape, strides, ptr: int, bf16: bool):
    """The row stride (in elements) at which the z pass reads an Mz of
    `shape` (R, N, P) and `strides` from address `ptr` as it lies, or None
    where it reads a copy (`zpass_mz_rows`). The kernels read rank r's row
    n at (r * N + n) * stride, so Mz has to be contiguous; the bf16
    kernel's copies also need every row on a 16-byte boundary: a 16-byte
    aligned base and P a multiple of 8 (a band matrix over a slab's halo
    rows has P = n + taps - 1, P % 8 == 2 at 19 taps), or a single row
    (R = N = 1), whose stride is never used and is given as P rounded up
    to 8."""
    R, N, P = shape
    if any(n > 1 and st != want
           for n, st, want in zip(shape, strides, (N * P, P, 1))):
        return None
    if not bf16:
        return P
    if ptr % (2 * _MZ_ROW_ALIGN):
        return None
    if R * N == 1:
        return _round_up(P, _MZ_ROW_ALIGN)
    return P if P % _MZ_ROW_ALIGN == 0 else None


def zpass_mz_rows(Mz: torch.Tensor) -> tuple:
    """(mz, ldm): Mz (R, N, P) as the z pass reads it and its row stride
    in elements. Mz itself where its layout allows
    (`zpass_mz_row_stride`), else a contiguous (R, N, ldm) copy with Mz in
    its first P columns, ldm being P rounded up to 8 for bfloat16 (the
    padding lies outside every window and is never read) and P for
    float32. Mz's rows have to be contiguous, as a z-slab's rows of a
    contiguous Mz are; other layouts raise ValueError."""
    R, N, P = Mz.shape
    if P > 1 and Mz.stride(2) != 1:
        raise ValueError("zpass: inputs must be contiguous (Mz: each row)")
    bf16 = Mz.dtype == torch.bfloat16
    ldm = zpass_mz_row_stride(Mz.shape, Mz.stride(), Mz.data_ptr(), bf16)
    if ldm is not None:
        return Mz, ldm
    ldm = _round_up(P, _MZ_ROW_ALIGN) if bf16 else P
    rows = torch.empty((R, N, ldm), dtype=Mz.dtype, device=Mz.device)
    rows[:, :, :P] = Mz
    return rows, ldm


def zpass_tma_store(out: torch.Tensor) -> bool:
    """Whether the bf16 z pass writes `out` (R, N, Y, X) through a TMA
    tensor map: rows of a multiple of 16 bytes from a 16-byte aligned
    base. Other outputs take per-thread stores; a map that should exist
    but cannot be built raises."""
    return out.shape[2] * out.shape[3] % 8 == 0 and out.data_ptr() % 16 == 0


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
    the dense contraction. CPU tensors take `zpass_reference`. The bf16
    kernel takes any R, N, P and Y * X with windows of at most
    ZPASS_MAX_WINDOW (560) columns, and raises ValueError beyond
    (`zpass_plan`); the f32 kernel takes any window. vm is contiguous; Mz
    has contiguous rows, and the kernel reads it as `zpass_mz_rows` gives
    it (a copy where Mz is not contiguous, or for bfloat16 where its rows
    do not start on 16 bytes)."""
    if Mz.device.type == "cpu" and vm.device.type == "cpu":
        return zpass_reference(Mz, vm)
    mz, ldm = zpass_mz_rows(Mz)
    code = _check_cuda("zpass", mz, vm)
    R, N, P = Mz.shape
    P2, Y, X = vm.shape
    if P2 != P:
        raise ValueError(f"zpass: Mz {tuple(Mz.shape)} vs vm {tuple(vm.shape)}")
    if windows is not None and not isinstance(windows, tuple):
        windows = tuple(tuple(w) for w in windows)
    table, tn, kpad, ct = _zpass_setup(windows, N, P, code == 0, Mz.device)
    out = torch.empty((R, N, Y, X), dtype=Mz.dtype, device=Mz.device)
    err = _zpass_lib().spim_zpass(
        mz.data_ptr(), vm.data_ptr(), out.data_ptr(), table.data_ptr(),
        R, N, P, ldm, Y * X, code, tn, kpad, ct, int(zpass_tma_store(out)),
        # the current stream's handle, without building a Stream object
        torch._C._cuda_getCurrentRawStream(Mz.get_device()))
    _raise_on(err, "zpass")
    zpass.launches += 1
    zpass.mz_padded += int(ldm > P)
    return out


zpass.launches = 0
# launches that read Mz at a row stride past P (the padded rows of
# `zpass_mz_rows`)
zpass.mz_padded = 0


def sl_rows(a: torch.Tensor, My: torch.Tensor, Mx: torch.Tensor,
            rad_y: int | None = None, rad_x: int | None = None
            ) -> torch.Tensor:
    """Fused y/x passes and rank sum: a (R, Z, Y, X), My (R, Yo, Y),
    Mx (R, Xo, X) -> (Z, Yo, Xo) f32. `rad_y` / `rad_x`: the half-supports
    of the band matrices My / Mx (taken as given, as `zpass` takes its
    windows); when given, each 64 x 64 output tile contracts only its
    y and x band windows (`band_blocks`), otherwise the dense [0, Y) and
    [0, X). CPU tensors take `fused_sl_reference`. Both kernels take any
    Y, X, Yo, Xo and window (the bf16 one walks wide windows in pieces,
    `sl_rows_plan`) and Z <= 65535; a larger Z raises ValueError."""
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
    table, kp, xp, tz, pieces = _sl_rows_setup(Y, X, Yo, Xo, rad_y, rad_x,
                                               code == 0, a.device)
    out = torch.empty((Z, Yo, Xo), dtype=torch.float32, device=a.device)
    err = _sl_rows_lib().spim_sl_rows(
        a.data_ptr(), My.data_ptr(), Mx.data_ptr(), out.data_ptr(),
        table.data_ptr(), R, Z, Y, X, Yo, Xo, code, kp, xp, tz, pieces,
        int(code == 0 and sl_rows_tma_load(a, My, Mx)),
        torch._C._cuda_getCurrentRawStream(a.get_device()))
    _raise_on(err, "sl_rows")
    sl_rows.launches += 1
    return out


sl_rows.launches = 0


def _z_slabs(Z: int, R: int, Y: int, X: int, itemsize: int) -> list:
    """The (start, stop) slabs of the Z output rows of
    `conv_lowrank_folded_fused`: one when the z pass's `a` (R, Z, Y, X)
    stays within `_A_SLAB_BYTES`, else as many rows a slab as fit it."""
    per_row = R * Y * X * itemsize
    sl = Z if per_row * Z <= _A_SLAB_BYTES else max(1, _A_SLAB_BYTES
                                                     // per_row)
    return [(s, min(s + sl, Z)) for s in range(0, Z, sl)]


def conv_lowrank_folded_fused(vol: torch.Tensor, Mz: torch.Tensor,
                              My: torch.Tensor, Mx: torch.Tensor,
                              rad_z: int | None = None,
                              rad_y: int | None = None,
                              rad_x: int | None = None,
                              z_off: int = 0) -> torch.Tensor:
    """Mirror-boundary lowrank convolution through `zpass` + `sl_rows`
    (the twin of `ops.separable.conv_lowrank_folded`).

    `rad_z` / `rad_y` / `rad_x`: the kernel's half-supports; each one
    given makes its pass contract only each tile's band window on that
    axis. Mz is (R, N, P) with row i's band centred at column i + z_off:
    square (N = P, z_off 0) for a whole volume, or a block's (R, n_out,
    n_out + 2 rz) band over its halo rows (z_off = rz); the output has
    N rows. Where `a` would exceed `_A_SLAB_BYTES` the output rows run in
    slabs at full rank: the z-pass matrix rows are sliced to the slab and
    the band centre shifts by the slab's first row.

    The kernels read `vol` in `operand_dtype`, the matrices' dtype (an
    operand already in it is not cast); the output is their float32 sum."""
    P, Y, X = vol.shape
    N = Mz.shape[1]
    vm = vol.to(Mz.dtype).contiguous()

    def run(mz: torch.Tensor, off: int) -> torch.Tensor:
        win = (band_blocks(mz.shape[1], P, rad_z, z_off + off)
               if rad_z is not None else None)
        return sl_rows(zpass(mz, vm, win), My, Mx, rad_y, rad_x)

    slabs = _z_slabs(N, Mz.shape[0], Y, X, Mz.element_size())
    if len(slabs) == 1:
        return run(Mz, 0)
    out = torch.empty((N, My.shape[1], Mx.shape[1]), dtype=torch.float32,
                      device=vol.device)
    for s, e in slabs:
        out[s:e] = run(Mz[:, s:e], s)
    return out


def operand_dtype(entry: dict):
    """The dtype in which `conv_lowrank_folded_fused` reads the operand of
    an RL engine's kernel entry: its matrices' dtype, or None for an entry
    without matrices (an FFT fallback)."""
    return entry["mat"][0].dtype if "mat" in entry else None


def band_radius(M: torch.Tensor) -> int:
    """The half-support of a stack of (R, n, n) band matrices: the largest
    |column - row| over their nonzeros (0 for an all-zero stack)."""
    nz = (M != 0).any(dim=0)
    if not bool(nz.any()):
        return 0
    i, j = torch.nonzero(nz, as_tuple=True)
    return int((j - i).abs().max())


# csrc/zfused.cu's tiles: the z and y stages compute at most ZFUSED_ROWS
# z and y rows a tile (their wgmma N), the x stage nx of _ZFUSED_NX x rows,
# in the order `zfused_plan` tries them; windows are multiples of the MMA
# depth and at most a TMA box's rows; three ring slots of band tiles and
# two staging slots of their TMA boxes.
ZFUSED_ROWS = 16
_ZFUSED_NX = (24, 16)
_ZFUSED_MAX_WINDOW = 256
_ZFUSED_SLOTS = 3
_ZFUSED_STAGES = 2


class ZfusedAxis(NamedTuple):
    """One axis of a `zfused` plan: length n, band half-support h, window
    w (columns of the band a tile contracts), tile rows t, and the origin
    offset c: tile k holds rows [k t - c, k t - c + t)."""
    n: int
    h: int
    w: int
    t: int
    c: int = 0

    @property
    def tiles(self) -> int:
        return -(-(self.n + self.c) // self.t)

    def start(self, t0: int) -> int:
        """The window's first column for the tile whose rows start at t0:
        t0 - h clamped into the axis (0 where the axis is one window)."""
        if self.n <= self.w:
            return 0
        return min(max(t0 - self.h, 0), self.n - self.w)


class ZfusedPlan(NamedTuple):
    """The `zfused` launch: the z, y and x axes, the x stage's rows nx and
    the block's shared-memory bytes."""
    z: ZfusedAxis
    y: ZfusedAxis
    x: ZfusedAxis
    nx: int
    smem: int

    def macs_per_rank(self) -> int:
        """The tensor-core MACs a tile and rank: the z stage over every
        8 x 8 patch of the y/x window (16 z rows, K = wz), the y stage over
        each x group's z rows in groups of 8 (K = wy), the x stage over
        64-row chunks of (z row, y row) pairs (K = wx)."""
        z, y, x, n = self.z, self.y, self.x, ZFUSED_ROWS
        return (y.w * x.w * n * z.w + -(-z.t // 8) * x.w * 8 * n * y.w
                + -(-z.t * n // 64) * 64 * self.nx * x.w)

    def macs_per_voxel(self) -> float:
        """`macs_per_rank` over a whole tile's output voxels."""
        return self.macs_per_rank() / (self.z.t * self.y.t * self.x.t)


def _zfused_smem(wz: int, wy: int, wx: int, nx: int) -> int:
    """Shared-memory bytes of a zfused block (csrc/zfused.cu
    `smem_bytes`): 1024 bytes of alignment, 64 of mbarriers, the volume
    window (wz x wy x wx), `a` (16 z rows x (wy + 1) x wx: each 8-column
    group of each z row padded by one row), `b` (16 z rows x 16 y rows x
    wx), three ring slots of band tiles (16 x wz, 16 x wy, nx x wx) and
    two staging slots of their TMA boxes (16 x (wz + 8), 16 x (wy + 8),
    nx x wx), all bf16."""
    n = ZFUSED_ROWS
    return 1088 + 2 * (wz * wy * wx + n * (wy + 1) * wx + n * n * wx
                       + _ZFUSED_SLOTS * (n * wz + n * wy + nx * wx)
                       + _ZFUSED_STAGES * (n * (wz + 8) + n * (wy + 8)
                                           + nx * wx))


def _zfused_windows(n: int, h: int, rows: int, step: int = 1) -> list:
    """The (window, tile rows, origin offset) choices of one axis, the
    largest tile first: the whole axis as one window where that is no
    wider than the widest window; otherwise windows of the MMA depth from
    the narrowest whose tile holds `rows` rows (rows - 2 with step 1) down,
    each with min(rows, w - 2h) rows cut to a multiple of `step`. With
    step 8 (the x axis) the tiles start at an offset c = -h mod 8, so that
    every window starts on an 8-column group, as a TMA box must."""
    full = _round_up(2 * h + rows - (2 if step == 1 else 0), _MMA_DEPTH)
    whole = _round_up(n, _MMA_DEPTH)
    if whole <= full:
        return [(whole, rows, 0)]
    c = -h % step
    return [(w, min(rows, w - 2 * h) // step * step, c)
            for w in range(full, 2 * h, -_MMA_DEPTH)
            if min(rows, w - 2 * h) >= step]


def zfused_plan(Z: int, Y: int, X: int, hz: int, hy: int,
                hx: int) -> ZfusedPlan | None:
    """The `zfused` launch for a (Z, Y, X) volume and band half-supports:
    for each nx of _ZFUSED_NX, the largest window of each axis
    (`_zfused_windows`: z and y with 16 rows, x tiles of multiples of 8),
    narrowing the widest window one step at a time until the block fits
    shared memory; None where nothing fits (or a window exceeds a TMA box
    or a grid axis its limit)."""
    for nx in _ZFUSED_NX:
        opts = [_zfused_windows(Z, hz, ZFUSED_ROWS),
                _zfused_windows(Y, hy, ZFUSED_ROWS),
                _zfused_windows(X, hx, nx, 8)]
        pick = [0, 0, 0]
        while all(opts):
            ws = [o[i][0] for o, i in zip(opts, pick)]
            smem = _zfused_smem(*ws, nx)
            if smem <= _SMEM_MAX and max(ws) <= _ZFUSED_MAX_WINDOW:
                axes = [ZfusedAxis(n, h, *o[i]) for (n, h), o, i in
                        zip(((Z, hz), (Y, hy), (X, hx)), opts, pick)]
                if max(axes[0].tiles, axes[1].tiles) > 65535:
                    break
                return ZfusedPlan(*axes, nx, smem)
            narrow = [a for a in range(3) if pick[a] + 1 < len(opts[a])]
            if not narrow:
                break
            a = max(narrow, key=lambda k: ws[k])
            pick[a] += 1
    return None


def zfused_tma_load(vm: torch.Tensor, Mz: torch.Tensor, My: torch.Tensor,
                    Mx: torch.Tensor, plan: ZfusedPlan) -> bool:
    """Whether the zfused kernel loads by TMA: rows of Z, Y and X a
    multiple of 16 bytes (so that every x window, which starts on an
    8-column group, starts a box on 16 bytes), 16-byte aligned bases, and
    every axis at least as long as the boxes that read it (the volume
    window on z and y, the band tiles' rows). Other inputs take every
    thread's element copies into the same layouts."""
    Z, Y, X = vm.shape
    return (Z % 8 == 0 and Y % 8 == 0 and X % 8 == 0
            and Z >= max(plan.z.w, ZFUSED_ROWS)
            and Y >= max(plan.y.w, ZFUSED_ROWS) and X >= plan.nx
            and all(t.data_ptr() % 16 == 0 for t in (vm, Mz, My, Mx)))


@functools.lru_cache(maxsize=None)
def _zfused_lib():
    lib = build.load("zfused")
    lib.spim_zfused_smem.argtypes = [ctypes.c_int] * 4
    lib.spim_zfused_smem.restype = ctypes.c_int
    lib.spim_zfused.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 16 \
        + [ctypes.c_void_p]
    lib.spim_zfused.restype = ctypes.c_int
    for ws in ((32, 32, 48), (32, 48, 32), (64, 64, 64), (96, 96, 96)):
        for nx in _ZFUSED_NX:
            want = _zfused_smem(*ws, nx)
            if lib.spim_zfused_smem(*ws, nx) != (
                    want if want <= _SMEM_MAX else -1):
                raise RuntimeError("csrc/zfused.cu shared memory differs "
                                   "from zfused_plan")
    return lib


def zfused(vm: torch.Tensor, Mz: torch.Tensor, My: torch.Tensor,
           Mx: torch.Tensor, hz: int, hy: int, hx: int) -> torch.Tensor:
    """The fully fused lowrank conv of a (Z, Y, X) volume in the matrix
    dtype with square band matrices of half-supports (hz, hy, hx):
    (Z, Y, X) float32, the rank sum before the cast to the volume's dtype.
    The half-supports must cover every nonzero of their band (as
    `band_radius` measures it): this launch wrapper takes them as given,
    as `zpass` takes its windows; `conv_lowrank_folded_zfused` checks them.
    CPU tensors take `ops.separable.conv_lowrank_folded` (in float32);
    CUDA tensors launch `csrc/zfused.cu` (bfloat16 only) on `zfused_plan`,
    and raise ValueError where no plan fits."""
    if all(t.device.type == "cpu" for t in (vm, Mz, My, Mx)):
        return conv_lowrank_folded(vm.float(), Mz, My, Mx)
    code = _check_cuda("zfused", vm, Mz, My, Mx)
    if code != 0:
        raise ValueError("zfused: the kernel takes bfloat16 matrices only")
    Z, Y, X = vm.shape
    R = Mz.shape[0]
    if Mz.shape != (R, Z, Z) or My.shape != (R, Y, Y) \
            or Mx.shape != (R, X, X):
        raise ValueError(f"zfused: vm {tuple(vm.shape)}, Mz "
                         f"{tuple(Mz.shape)}, My {tuple(My.shape)}, Mx "
                         f"{tuple(Mx.shape)}: needs square (R, n, n) "
                         f"matrices per axis")
    plan = zfused_plan(Z, Y, X, hz, hy, hx)
    if plan is None:
        raise ValueError(f"zfused: the kernel cannot take {(Z, Y, X)} with "
                         f"half-supports {(hz, hy, hx)} (shared memory)")
    lib = _zfused_lib()
    out = torch.empty((Z, Y, X), dtype=torch.float32, device=vm.device)
    err = lib.spim_zfused(
        vm.data_ptr(), Mz.data_ptr(), My.data_ptr(), Mx.data_ptr(),
        out.data_ptr(), R, Z, Y, X, hz, hy, hx, plan.z.w, plan.y.w,
        plan.x.w, plan.z.t, plan.y.t, plan.x.t, plan.x.c, plan.nx,
        int(zfused_tma_load(vm, Mz, My, Mx, plan)),
        torch._C._cuda_getCurrentRawStream(vm.get_device()))
    _raise_on(err, "zfused")
    zfused.launches += 1
    return out


zfused.launches = 0


def conv_lowrank_folded_zfused(vol: torch.Tensor, Mz: torch.Tensor,
                               My: torch.Tensor, Mx: torch.Tensor, hz: int,
                               tz: int = 16) -> torch.Tensor:
    """Fully z+y+x-fused twin of `ops.separable.conv_lowrank_folded`
    (the reference's `ops/pallas/lowrank_conv.py:493`): mirror-boundary
    lowrank convolution of `vol` with the folded matrices, the output in
    `vol`'s dtype. `hz`: the kernel's z half-support, as the reference
    takes it; a value below the band of `Mz` raises (the kernel's window
    would drop band columns). The y/x half-supports are measured from the
    matrices (the kernel windows every axis). `tz` is the reference's
    z-block hint; the CUDA kernel picks its own tiles."""
    del tz
    hz, rz = int(hz), band_radius(Mz)
    if hz < rz:
        raise ValueError(f"conv_lowrank_folded_zfused: hz={hz} is below the "
                         f"z band's half-support {rz}")
    vm = vol.to(Mz.dtype).contiguous()
    return zfused(vm, Mz, My, Mx, hz, band_radius(My),
                  band_radius(Mx)).to(vol.dtype)
