"""Block decomposition and a raw float32 volume store on disk.

Port of the reference's `native_blocks.py`: `Block` / `decompose` (the
reference's `BlockGeneratorFixedSizePrecise` semantics: interior blocks,
halos clamped to the volume, per-face pad amounts) and `RawVolumeStore`,
strided block reads and writes against a raw float32 volume with
threaded `pread`/`pwrite` — the streaming store of the out-of-core
deconvolution and fusion.

The C++ runtime is the repository's `native/spimblocks.cpp`. The port
compiles its own copy of the library from that source with `g++` at first
use, into `_build/` beside the package (gitignored; named by a hash of the
source and flags, so an edited source rebuilds), and never writes into
`native/`. A machine without a compiler takes numpy (memmap for the
store, a Python loop for `decompose`): host IO either way, not a device
kernel. `native_path()` says which of the two runs.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

_PKG = Path(__file__).resolve().parent
SRC_PATH = _PKG.parent / "native" / "spimblocks.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_tried = False


def _target() -> Path:
    h = hashlib.sha256(SRC_PATH.read_bytes()
                       + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libspimblocks_{h}.so"


def _build(out: Path) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    try:
        subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SRC_PATH),
                        "-lpthread"], check=True, capture_output=True,
                       timeout=120)
    except (subprocess.SubprocessError, OSError):
        return False
    os.replace(tmp, out)
    return True


def get_lib() -> Optional[ctypes.CDLL]:
    """The native library (built on first use), or None where it cannot
    be built or loaded."""
    global _lib, _lib_tried
    with _lock:
        if _lib is not None or _lib_tried:
            return _lib
        _lib_tried = True
        if not SRC_PATH.exists():
            return None
        out = _target()
        if not out.exists() and not _build(out):
            return None
        try:
            lib = ctypes.CDLL(str(out))
        except OSError:
            return None
        i64p = ctypes.POINTER(ctypes.c_int64)
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.spim_block_decompose.restype = ctypes.c_int64
        lib.spim_block_decompose.argtypes = [i64p, i64p, i64p,
                                             ctypes.c_void_p, ctypes.c_int64]
        for fn in (lib.spim_read_block_f32, lib.spim_write_block_f32):
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_char_p, i64p, i64p, i64p, f32p,
                           ctypes.c_int]
        lib.spim_create_raw_f32.restype = ctypes.c_int
        lib.spim_create_raw_f32.argtypes = [ctypes.c_char_p, i64p]
        _lib = lib
        return _lib


def native_path() -> str:
    """"native" when block IO runs in the C++ library, "numpy" when it
    takes the memmap path."""
    return "native" if get_lib() is not None else "numpy"


def _i64(v) -> "ctypes.Array":
    return (ctypes.c_int64 * 3)(*[int(x) for x in v])


@dataclasses.dataclass
class Block:
    """One decomposition block (BlockGeneratorFixedSizePrecise record)."""

    out_lo: Tuple[int, int, int]   # interior (exclusive ownership)
    out_hi: Tuple[int, int, int]
    in_lo: Tuple[int, int, int]    # clamped padded read range
    in_hi: Tuple[int, int, int]
    pad_lo: Tuple[int, int, int]   # halo clipped at volume faces
    pad_hi: Tuple[int, int, int]


def _decompose_rows(dims, block, halo) -> np.ndarray:
    """The (n, 18) block records in numpy (the library's loop)."""
    rows = []
    nb = [-(-d // b) for d, b in zip(dims, block)]
    for bz in range(nb[0]):
        for by in range(nb[1]):
            for bx in range(nb[2]):
                rec = []
                for d, bi in zip(range(3), (bz, by, bx)):
                    lo = bi * block[d]
                    hi = min(lo + block[d], dims[d])
                    wl, wh = lo - halo[d], hi + halo[d]
                    il, ih = max(wl, 0), min(wh, dims[d])
                    rec.append((lo, hi, il, ih, il - wl, wh - ih))
                rows.append([r[i] for i in range(6) for r in rec])
    return np.asarray(rows, np.int64).reshape(-1, 18)


def decompose(dims, block, halo) -> List[Block]:
    """Split `dims` into interior blocks of `block` with `halo` overlap."""
    lib = get_lib()
    if lib is not None:
        n = lib.spim_block_decompose(_i64(dims), _i64(block), _i64(halo),
                                     None, 0)
        rows = np.zeros((n, 18), np.int64)
        rc = lib.spim_block_decompose(
            _i64(dims), _i64(block), _i64(halo),
            rows.ctypes.data_as(ctypes.c_void_p), n)
        if rc != n:
            raise RuntimeError(f"spim_block_decompose returned {rc} of {n}")
    else:
        rows = _decompose_rows(dims, block, halo)
    return [Block(*(tuple(int(v) for v in r[i:i + 3])
                    for i in range(0, 18, 3))) for r in rows]


class RawVolumeStore:
    """Raw float32 volume on disk with threaded strided block IO (the
    reference's file format: C order, z slowest)."""

    def __init__(self, path: str, shape, create: bool = False,
                 n_threads: int = 8):
        self.path = str(path)
        self.shape = tuple(int(s) for s in shape)
        self.n_threads = n_threads
        self._lib = get_lib()
        if create:
            if self._lib is not None:
                rc = self._lib.spim_create_raw_f32(self.path.encode(),
                                                   _i64(self.shape))
                if rc != 0:
                    raise OSError(f"create failed rc={rc}")
            else:
                with open(self.path, "wb") as f:
                    f.truncate(int(np.prod(self.shape)) * 4)

    def _check_range(self, lo, hi):
        for d in range(3):
            if not (0 <= lo[d] < hi[d] <= self.shape[d]):
                raise ValueError(
                    f"invalid block range axis {d}: [{lo[d]}, {hi[d]}) "
                    f"for volume of shape {self.shape}")

    def _native_args(self, lo, hi):
        """The library's (dims, lo, hi) for a block. It reads and writes
        one x row a call; where the block spans whole x rows, consecutive
        y rows are one contiguous run of the file, so the volume is seen
        as (Z, 1, Y * X) and each call moves the block's whole y range of
        one plane (a z-slab of whole planes: one call a plane)."""
        Z, Y, X = self.shape
        if lo[2] == 0 and hi[2] == X:
            return ((Z, 1, Y * X), (lo[0], 0, lo[1] * X),
                    (hi[0], 1, hi[1] * X))
        return self.shape, lo, hi

    def read_block(self, lo, hi) -> np.ndarray:
        lo = tuple(int(v) for v in lo)
        hi = tuple(int(v) for v in hi)
        self._check_range(lo, hi)
        if self._lib is not None:
            dst = np.empty(tuple(h - l for l, h in zip(lo, hi)), np.float32)
            dims, nlo, nhi = self._native_args(lo, hi)
            rc = self._lib.spim_read_block_f32(
                self.path.encode(), _i64(dims), _i64(nlo), _i64(nhi),
                dst.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                self.n_threads)
            if rc != 0:
                raise OSError(f"read failed rc={rc}")
            return dst
        mm = np.memmap(self.path, np.float32, "r", shape=self.shape)
        return np.array(mm[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]])

    def write_block(self, lo, data: np.ndarray) -> None:
        lo = tuple(int(v) for v in lo)
        hi = tuple(l + s for l, s in zip(lo, data.shape))
        self._check_range(lo, hi)
        data = np.ascontiguousarray(data, np.float32)
        if self._lib is not None:
            dims, nlo, nhi = self._native_args(lo, hi)
            rc = self._lib.spim_write_block_f32(
                self.path.encode(), _i64(dims), _i64(nlo), _i64(nhi),
                data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                self.n_threads)
            if rc != 0:
                raise OSError(f"write failed rc={rc}")
            return
        mm = np.memmap(self.path, np.float32, "r+", shape=self.shape)
        mm[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]] = data
        mm.flush()

    def read_block_padded(self, blk: Block, mode: str = "reflect"
                          ) -> np.ndarray:
        """Read a decomposition block including halos, mirror-filling the
        clipped faces (the reference's OOB-mirror semantics)."""
        core = self.read_block(blk.in_lo, blk.in_hi)
        pads = tuple((int(a), int(b))
                     for a, b in zip(blk.pad_lo, blk.pad_hi))
        if any(a or b for a, b in pads):
            core = np.pad(core, pads, mode=mode)
        return core


def read_mirror_z(store, z_lo: int, z_hi: int) -> np.ndarray:
    """Rows [z_lo, z_hi) of a (Z, Y, X) store (any object with `.shape`
    and `.read_block`), rows outside the volume mirror-filled
    (single-boundary mirror, as the in-memory engines pad)."""
    Z = store.shape[0]
    il, ih = max(z_lo, 0), min(z_hi, Z)
    core = store.read_block((il, 0, 0), (ih,) + tuple(store.shape[1:]))
    pl, ph = il - z_lo, z_hi - ih
    if pl or ph:
        core = np.pad(core, ((pl, ph), (0, 0), (0, 0)), mode="reflect")
    return core
