"""Zarr / BDV-N5 chunked volume stores, read and written with numpy alone.

Port of the reference's `core/zarr_store.py`. The reference goes through
TensorStore; the port reads and writes the two formats itself (numpy,
`json`, `zlib`), so they work on a machine without `tensorstore`:

- **zarr v2**: `.zarray` (`zarr_format` 2, C order); chunk `i.j.k` holds
  the C-order bytes of a full-size chunk (edge chunks padded); a missing
  chunk reads as `fill_value` (null reads as 0).
- **n5**: `attributes.json` lists `dimensions` and `blockSize` fastest
  axis first, which is the order of this module's indices (TensorStore's
  n5 driver keeps it too); block `i/j/k` is a big-endian header (uint16
  mode, uint16 ndim, ndim x uint32 sizes) and the big-endian data, first
  axis fastest; edge blocks are truncated to their true size.

The port writes chunks uncompressed (zarr `"compressor": null`, n5
`{"type": "raw"}`); the reference writes TensorStore's default, blosc.
Raw, zlib and gzip chunks are decoded here; a container in another codec
(the reference's blosc) is opened through `tensorstore` where that
package is installed, and raises an ImportError naming the codec and the
package where it is not.

- `TSVolume`: a chunked on-disk volume with the blockwise interface of
  `native_blocks.RawVolumeStore` (`shape`, `read_block`, `write_block`),
  so streaming fusion writes into it unchanged.
- `resave_zarr` / `zarr_loader`: the multi-resolution layout
  `t{tp:05d}/s{setup:02d}/{level}` in (z, y, x) order, with per-setup
  `resolutions` in `meta.json`.
- `resave_n5_bdv` / `n5_bdv_loader`: the BigDataViewer bdv.n5 layout
  (`setup{s}/timepoint{t}/s{level}`, x/y/z dimension order, per-setup
  `downsamplingFactors` / `dataType` attributes).
- `ZarrCheckpointer`: psi checkpoints for long deconvolutions.

The pyramids are downsampled on the entry point's device (CUDA unless
another is named) with `ops/downsample.py`, as the reference does on its
accelerator.
"""

from __future__ import annotations

import itertools
import json
import os
import shutil
import struct
import threading
import zlib
from typing import Callable, Optional, Sequence, Tuple

import numpy as np

from spim_registration_tpu_torch.core.dataset import Dataset, ViewId
from spim_registration_tpu_torch.core.imgloaders import _optional

_N5_TYPES = ("uint8", "uint16", "uint32", "uint64", "int8", "int16",
             "int32", "int64", "float32", "float64")
# codecs decoded with the standard library; any other goes to tensorstore
_STDLIB_CODECS = ("raw", "zlib", "gzip")


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _write_json(path: str, obj: dict) -> None:
    with open(path, "w") as f:
        json.dump(obj, f)


def _fill_value(meta: dict, dtype: np.dtype):
    fv = meta.get("fill_value")
    if fv is None:
        return dtype.type(0)
    return dtype.type(float(fv) if isinstance(fv, str) else fv)


def _zarr_codec(meta: dict) -> Tuple[str, int]:
    comp = meta.get("compressor")
    if meta.get("filters"):
        return "filters " + json.dumps(meta["filters"]), 0
    if comp is None:
        return "raw", 0
    return comp.get("id", "?"), comp.get("level", 1)


def _n5_codec(meta: dict) -> Tuple[str, int]:
    comp = meta.get("compression", {"type": "raw"})
    name = comp.get("type", "?")
    if name == "gzip" and comp.get("useZlib"):
        name = "zlib"
    return name, comp.get("level", -1)


def _decode(codec: str, data: bytes) -> bytes:
    if codec == "raw":
        return data
    return zlib.decompress(data, 47)      # zlib or gzip header


def _encode(codec: str, level: int, data: bytes) -> bytes:
    if codec == "raw":
        return data
    c = zlib.compressobj(level, zlib.DEFLATED, 31 if codec == "gzip" else 15)
    return c.compress(data) + c.flush()


class TSVolume:
    """Chunked on-disk volume (zarr v2 or n5) with blockwise IO.

    Duck-type compatible with `native_blocks.RawVolumeStore`: `.shape`,
    `.read_block(lo, hi)`, `.write_block(lo, block)`; adds whole-array
    `read()` / `write()` and numpy-style slicing. A `write_block` that
    covers part of a chunk reads, updates and rewrites that chunk; each
    chunk is written to a temporary name and renamed into place. (The
    name is the reference's, whose class wraps a TensorStore handle.)
    """

    def __init__(self, path: str, driver: str = "zarr"):
        if driver not in ("zarr", "n5"):
            raise ValueError(f"unknown volume driver {driver!r}")
        self.path, self.driver = path, driver
        if driver == "zarr":
            meta = _read_json(os.path.join(path, ".zarray"))
            if meta.get("zarr_format") != 2:
                raise ValueError(f"{path}: not a zarr v2 array")
            self._disk_dtype = np.dtype(meta["dtype"])
            self.chunks = tuple(int(c) for c in meta["chunks"])
            self._order = meta.get("order", "C")
            self._sep = meta.get("dimension_separator", ".")
            codec = _zarr_codec(meta)
        else:
            meta = _read_json(os.path.join(path, "attributes.json"))
            if meta.get("dataType") not in _N5_TYPES:
                raise ValueError(f"{path}: n5 dataType "
                                 f"{meta.get('dataType')!r} not supported")
            self._disk_dtype = np.dtype(meta["dataType"]).newbyteorder(">")
            self.chunks = tuple(int(c) for c in meta["blockSize"])
            codec = _n5_codec(meta)
        self.shape = tuple(int(s) for s in (meta["shape"] if driver == "zarr"
                                            else meta["dimensions"]))
        self.dtype = self._disk_dtype.newbyteorder("=")
        self._fill = _fill_value(meta, self.dtype) if driver == "zarr" \
            else self.dtype.type(0)
        self._codec, self._level = codec
        self._lock = threading.Lock()
        self._ts = None
        if self._codec not in _STDLIB_CODECS:
            ts = _optional("tensorstore",
                           f"reading a {driver} container compressed with "
                           f"{self._codec!r} ({path})",
                           instead="a raw, zlib or gzip container")
            self._ts = ts.open({"driver": driver, "kvstore": {
                "driver": "file", "path": path}}).result()

    # -- chunk files -----------------------------------------------------
    def _chunk_path(self, idx) -> str:
        if self.driver == "zarr":
            return os.path.join(self.path,
                                self._sep.join(str(i) for i in idx))
        return os.path.join(self.path, *(str(i) for i in idx))

    def _chunk_box(self, idx):
        lo = tuple(i * c for i, c in zip(idx, self.chunks))
        hi = tuple(min(a + c, s) for a, c, s in zip(lo, self.chunks,
                                                    self.shape))
        return lo, hi

    def _read_chunk(self, idx) -> Optional[np.ndarray]:
        """The chunk's values inside the volume (read-only where no byte
        swap was needed), or None where the chunk was never written."""
        try:
            with open(self._chunk_path(idx), "rb") as f:
                raw = f.read()
        except FileNotFoundError:
            return None
        lo, hi = self._chunk_box(idx)
        if self.driver == "zarr":
            arr = np.frombuffer(_decode(self._codec, raw),
                                self._disk_dtype).reshape(self.chunks,
                                                          order=self._order)
        else:
            mode, ndim = struct.unpack(">HH", raw[:4])
            sizes = struct.unpack(f">{ndim}I", raw[4:4 + 4 * ndim])
            start = 4 + 4 * ndim + (4 if mode == 1 else 0)
            if mode not in (0, 1):
                raise ValueError(f"{self._chunk_path(idx)}: n5 block mode "
                                 f"{mode} not supported")
            arr = np.frombuffer(_decode(self._codec, raw[start:]),
                                self._disk_dtype)[:int(np.prod(sizes))]
            arr = arr.reshape(sizes, order="F")
        return arr[tuple(slice(0, b - a) for a, b in zip(lo, hi))].astype(
            self.dtype, copy=False)

    def _write_chunk(self, idx, values: np.ndarray) -> None:
        """Write one chunk's values (its box inside the volume)."""
        if self.driver == "zarr":
            if values.shape != self.chunks:
                full = np.full(self.chunks, self._fill, self.dtype)
                full[tuple(slice(0, s) for s in values.shape)] = values
                values = full
            data = _encode(self._codec, self._level, np.asarray(
                values, self._disk_dtype).tobytes(order=self._order))
        else:
            data = (struct.pack(f">HH{values.ndim}I", 0, values.ndim,
                                *values.shape)
                    + _encode(self._codec, self._level, np.asarray(
                        values, self._disk_dtype).tobytes(order="F")))
        path = self._chunk_path(idx)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)

    def _chunks_in(self, lo, hi):
        return itertools.product(*(range(a // c, (b - 1) // c + 1)
                                   for a, b, c in zip(lo, hi, self.chunks)))

    # -- blockwise interface (RawVolumeStore parity) --------------------
    def read_block(self, lo, hi) -> np.ndarray:
        lo = tuple(int(a) for a in lo)
        hi = tuple(int(b) for b in hi)
        if self._ts is not None:
            sl = tuple(slice(a, b) for a, b in zip(lo, hi))
            return np.asarray(self._ts[sl].read().result())
        out = np.full(tuple(b - a for a, b in zip(lo, hi)), self._fill,
                      self.dtype)
        if any(b <= a for a, b in zip(lo, hi)):
            return out
        for idx in self._chunks_in(lo, hi):
            chunk = self._read_chunk(idx)
            if chunk is None:
                continue
            clo, chi = self._chunk_box(idx)
            a = [max(x, y) for x, y in zip(lo, clo)]
            b = [min(x, y) for x, y in zip(hi, chi)]
            out[tuple(slice(p - q, r - q) for p, r, q in zip(a, b, lo))] = \
                chunk[tuple(slice(p - q, r - q) for p, r, q in zip(a, b, clo))]
        return out

    def write_block(self, lo, block) -> None:
        block = np.asarray(block, self.dtype)
        lo = tuple(int(a) for a in lo)
        hi = tuple(a + s for a, s in zip(lo, block.shape))
        if any(a < 0 for a in lo) or any(b > s for b, s in zip(hi,
                                                               self.shape)):
            raise ValueError(f"block [{lo}, {hi}) outside the volume "
                             f"{self.shape}")
        if self._ts is not None:
            sl = tuple(slice(a, b) for a, b in zip(lo, hi))
            self._ts[sl].write(block).result()
            return
        if block.size == 0:
            return
        with self._lock:
            for idx in self._chunks_in(lo, hi):
                clo, chi = self._chunk_box(idx)
                a = [max(x, y) for x, y in zip(lo, clo)]
                b = [min(x, y) for x, y in zip(hi, chi)]
                src = block[tuple(slice(p - q, r - q)
                                  for p, r, q in zip(a, b, lo))]
                if tuple(a) != clo or tuple(b) != chi:
                    chunk = self._read_chunk(idx)
                    chunk = (np.full(tuple(y - x for x, y in zip(clo, chi)),
                                     self._fill, self.dtype)
                             if chunk is None else chunk.copy())
                    chunk[tuple(slice(p - q, r - q)
                                for p, r, q in zip(a, b, clo))] = src
                    src = chunk
                self._write_chunk(idx, src)

    # -- convenience -----------------------------------------------------
    def read(self) -> np.ndarray:
        return self.read_block((0,) * len(self.shape), self.shape)

    def write(self, arr) -> None:
        arr = np.asarray(arr, self.dtype)
        if arr.shape != self.shape:
            raise ValueError(f"write of {arr.shape} into {self.shape}")
        self.write_block((0,) * len(self.shape), arr)

    def __getitem__(self, sl) -> np.ndarray:
        sl = sl if isinstance(sl, tuple) else (sl,)
        if any(s is Ellipsis for s in sl):
            i = sl.index(Ellipsis)
            sl = (sl[:i] + (slice(None),) * (len(self.shape) - len(sl) + 1)
                  + sl[i + 1:])
        sl = sl + (slice(None),) * (len(self.shape) - len(sl))
        lo, hi, rest = [], [], []
        for s, n in zip(sl, self.shape):
            if isinstance(s, slice):
                a, b, step = s.indices(n)
                if step < 1:
                    raise IndexError("negative slice steps are not "
                                     "supported")
                lo.append(a)
                hi.append(max(a, b))
                rest.append(slice(0, max(a, b) - a, step))
            else:
                i = int(s) + (n if int(s) < 0 else 0)
                if not 0 <= i < n:
                    raise IndexError(f"index {s} out of range for {n}")
                lo.append(i)
                hi.append(i + 1)
                rest.append(0)
        return self.read_block(lo, hi)[tuple(rest)]


def create_volume(path: str, shape: Sequence[int],
                  dtype=np.float32,
                  chunks: Sequence[int] = (64, 64, 64),
                  driver: str = "zarr") -> TSVolume:
    """Create a chunked volume at `path` (zarr by default), replacing
    whatever was there; chunks are clipped to the shape."""
    dtype = np.dtype(dtype)
    shape = [int(s) for s in shape]
    chunks = [max(1, min(int(c), s)) for c, s in zip(chunks, shape)]
    if os.path.isdir(path):
        shutil.rmtree(path)
    os.makedirs(path)
    if driver == "zarr":
        _write_json(os.path.join(path, ".zarray"), {
            "zarr_format": 2, "shape": shape, "chunks": chunks,
            "dtype": dtype.newbyteorder("<").str, "order": "C",
            "compressor": None, "fill_value": 0, "filters": None,
            "dimension_separator": "."})
    elif driver == "n5":
        if dtype.name not in _N5_TYPES:
            raise ValueError(f"n5 cannot store {dtype}")
        _write_json(os.path.join(path, "attributes.json"), {
            "dimensions": shape, "blockSize": chunks,
            "dataType": dtype.name, "compression": {"type": "raw"}})
    else:
        raise ValueError(f"unknown volume driver {driver!r}")
    return TSVolume(path, driver)


def open_volume(path: str, driver: str = "zarr") -> TSVolume:
    return TSVolume(path, driver)


# ---------------------------------------------------------------- resave


def _mipmap_levels(shape, max_levels=4):
    levels = [(1, 1, 1)]
    f = np.array([1, 1, 1])
    while len(levels) < max_levels:
        nxt = f * 2
        if any(s // x < 32 for s, x in zip(shape, nxt)):
            break
        f = nxt
        levels.append(tuple(int(v) for v in f))
    return levels


def _pyramid(vol: np.ndarray, levels, dtype, device=None):
    """Yield (level_index, factors, level_volume): float32 halvings on
    `device` (CUDA unless another is named), each level copied to the host
    and cast to `dtype` there (a truncating cast for integer types, as the
    reference's `np.asarray(level, dtype=dtype)`)."""
    import torch

    from spim_registration_tpu_torch.ops.downsample import downsample
    from spim_registration_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    cur = torch.from_numpy(np.array(vol, np.float32)).to(dev)
    prev = (1, 1, 1)
    for li, factor in enumerate(levels):
        step = tuple(f2 // f1 for f1, f2 in zip(prev, factor))
        if any(s > 1 for s in step):
            cur = downsample(cur, step)
            prev = factor
        yield li, factor, cur.cpu().numpy().astype(dtype)


def resave_zarr(dataset: Dataset, base_path: str, view_ids=None,
                max_levels: int = 4,
                chunk: Tuple[int, int, int] = (16, 64, 64),
                dtype=np.float32, device=None) -> None:
    """Write views (+pyramids) as zarr arrays; attach a zarr loader.

    Layout mirrors the HDF5 resave tree (`core/resave.py`):
    `{base}/t{tp:05d}/s{setup:02d}/{level}` arrays in (z, y, x) order,
    with per-setup `resolutions` recorded in `{base}/meta.json`.
    """
    if view_ids is None:
        view_ids = sorted(dataset.views)
    meta = {"format": "spim-zarr", "setups": {}}
    for vid in view_ids:
        tp, setup = vid
        vol = np.asarray(dataset.get_image(vid))
        levels = _mipmap_levels(vol.shape, max_levels)
        meta["setups"].setdefault(
            str(setup), {"resolutions": [list(lv) for lv in levels]})
        for li, _factor, arr in _pyramid(vol, levels, dtype, device):
            path = os.path.join(base_path, f"t{tp:05d}", f"s{setup:02d}",
                                str(li))
            create_volume(path, arr.shape, dtype=dtype,
                          chunks=chunk).write(arr)
    os.makedirs(base_path, exist_ok=True)
    with open(os.path.join(base_path, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
    dataset.loader = zarr_loader(base_path)


def zarr_loader(base_path: str, level: int = 0
                ) -> Callable[[ViewId], np.ndarray]:
    """Loader seam over a `resave_zarr` tree."""

    def load(view_id: ViewId) -> np.ndarray:
        tp, setup = view_id
        path = os.path.join(base_path, f"t{tp:05d}", f"s{setup:02d}",
                            str(level))
        return open_volume(path).read()

    return load


def _merge_attributes(dataset_dir: str, extra: dict) -> None:
    """Merge keys into an n5 group's or dataset's attributes.json (BDV
    reads custom attributes beside the array metadata)."""
    p = os.path.join(dataset_dir, "attributes.json")
    attrs = _read_json(p) if os.path.exists(p) else {}
    attrs.update(extra)
    _write_json(p, attrs)


def resave_n5_bdv(dataset: Dataset, base_path: str, view_ids=None,
                  max_levels: int = 4,
                  chunk: Tuple[int, int, int] = (16, 64, 64),
                  dtype=np.uint16, scale: Optional[float] = None,
                  device=None) -> None:
    """Write views as a BigDataViewer **bdv.n5** container.

    Layout (bigdataviewer-core's N5ImageLoader):
    `setup{s}/timepoint{t}/s{level}` datasets with x/y/z dimension order,
    per-setup attributes `{downsamplingFactors, dataType}`, per-dataset
    `downsamplingFactors`. `scale` rescales float data into the uint16
    range (auto: 65535 / global max when dtype is uint16); the volume is
    scaled and clipped in float32, pyramided, and only then cast.
    """
    if view_ids is None:
        view_ids = sorted(dataset.views)
    dtype = np.dtype(dtype)
    if scale is None and dtype == np.uint16:
        gmax = max(float(np.asarray(dataset.get_image(v)).max())
                   for v in view_ids) or 1.0
        scale = 65535.0 / gmax
    os.makedirs(base_path, exist_ok=True)
    _merge_attributes(base_path, {"n5": "2.0.0"})
    done_setups = set()
    for vid in view_ids:
        tp, setup = vid
        vol = np.asarray(dataset.get_image(vid), np.float32)
        if scale is not None and dtype != np.float32:
            vol = np.clip(vol * scale, 0,
                          np.iinfo(dtype).max if dtype.kind in "ui"
                          else np.inf)
        levels = _mipmap_levels(vol.shape, max_levels)
        setup_dir = os.path.join(base_path, f"setup{setup}")
        if setup not in done_setups:
            os.makedirs(setup_dir, exist_ok=True)
            _merge_attributes(setup_dir, {
                # BDV lists factors in x,y,z order
                "downsamplingFactors": [list(lv[::-1]) for lv in levels],
                "dataType": dtype.name,
            })
            done_setups.add(setup)
        for li, factor, arr in _pyramid(vol, levels, dtype, device):
            path = os.path.join(setup_dir, f"timepoint{tp}", f"s{li}")
            # N5 dimension order is x,y,z (fastest first): store the
            # transposed volume so BDV reads the geometry correctly.
            v = create_volume(path, arr.T.shape, dtype=dtype,
                              chunks=chunk[::-1], driver="n5")
            v.write(arr.T)
            _merge_attributes(path, {
                "downsamplingFactors": list(factor[::-1])})
    dataset.loader = n5_bdv_loader(base_path)


def n5_bdv_loader(base_path: str, level: int = 0
                  ) -> Callable[[ViewId], np.ndarray]:
    """Loader over a bdv.n5 tree; returns (z, y, x) float32."""

    def load(view_id: ViewId) -> np.ndarray:
        tp, setup = view_id
        path = os.path.join(base_path, f"setup{setup}", f"timepoint{tp}",
                            f"s{level}")
        return np.ascontiguousarray(
            open_volume(path, driver="n5").read().T).astype(np.float32)

    return load


# ------------------------------------------------------------ checkpoints


class ZarrCheckpointer:
    """psi checkpoints for long RL runs (pass `.save` as `checkpoint_fn`
    to `DeconvolutionRunner.run_checkpointed`); `.load_latest()` resumes.
    """

    def __init__(self, base_path: str,
                 chunks: Sequence[int] = (32, 128, 128)):
        self.base = base_path
        self.chunks = tuple(chunks)
        os.makedirs(base_path, exist_ok=True)
        self._state_path = os.path.join(base_path, "state.json")

    def save(self, iteration: int, psi: np.ndarray) -> None:
        vol = create_volume(os.path.join(self.base, "psi"), psi.shape,
                            dtype=np.float32, chunks=self.chunks)
        vol.write(psi)
        with open(self._state_path, "w") as f:
            json.dump({"iteration": int(iteration),
                       "shape": list(psi.shape)}, f)

    def load_latest(self):
        """Returns (iteration, psi) or (0, None) when no checkpoint."""
        if not os.path.exists(self._state_path):
            return 0, None
        with open(self._state_path) as f:
            state = json.load(f)
        psi = open_volume(os.path.join(self.base, "psi")).read()
        return int(state["iteration"]), psi
