"""Zeiss CZI (Lightsheet Z1) reading — pure-numpy segment-stream parser.

The port's copy of the reference's `core/czi.py` (numpy and the standard
library only), the analog of the `LightSheetZ1ImgLoader` /
`LightSheetZ1` dataset manager, which read Zeiss Lightsheet Z1
acquisitions through Bio-Formats; the CZI container is parsed directly
(no Java). Only the subset the Z1 writes is supported: uncompressed
subblocks, pixel types Gray8/Gray16/Gray32Float, dimensions
X/Y/Z/C/T/S/I/V/M/B/R/H.

CZI container layout (public Zeiss "CZI File Format" spec):
  file = sequence of 32-byte-aligned segments, each
    [ Id: 16 bytes ASCII | AllocatedSize: int64 | UsedSize: int64 | data ]
  segment kinds used here:
    ZISRAWFILE      — file header (512 bytes; directory/metadata offsets)
    ZISRAWMETADATA  — [xml_size:i32, attach_size:i32, 248 spare] + XML
    ZISRAWSUBBLOCK  — [meta_size:i32, attach_size:i32, data_size:i64,
                       DirectoryEntryDV, pad to max(256, 16+entry_size),
                       metadata, pixel data, attachments]
    ZISRAWDIRECTORY — [entry_count:i32, 124 spare] + DirectoryEntryDV list
  DirectoryEntryDV = [ "DV" | pixel_type:i32 | file_pos:i64 | file_part:i32
                       | compression:i32 | pyramid:u8 | 5 spare |
                       dim_count:i32 | dim_count x DimensionEntryDV1 ]
  DimensionEntryDV1 = [ dim: 4 bytes ASCII | start:i32 | size:i32 |
                        start_coordinate:f32 | stored_size:i32 ]  (20 bytes)

A companion `write_czi` produces spec-conformant files (used for tests and
as an interop escape hatch); reading was validated against it.

The Z1 multiview mapping (matching what Bio-Formats exposes to the
reference): T -> timepoint, V (fallback S) -> angle, C -> channel,
I -> illumination, M -> tile, B/R/H ignored.
"""

from __future__ import annotations

import dataclasses
import io
import os
import struct
import uuid
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

_SEG_HEADER = struct.Struct("<16sqq")
_DV_FIXED = struct.Struct("<2siqiiB5si")
_DIM_ENTRY = struct.Struct("<4siifi")

# CZI PixelType -> numpy dtype (subset; all the Z1 emits)
_PIXEL_DTYPES = {
    0: np.dtype("uint8"),     # Gray8
    1: np.dtype("uint16"),    # Gray16
    2: np.dtype("float32"),   # Gray32Float
    12: np.dtype("int32"),    # Gray32
    13: np.dtype("float64"),  # Gray64
}
_DTYPE_PIXELS = {v: k for k, v in _PIXEL_DTYPES.items()}


@dataclasses.dataclass
class CziSubBlock:
    """One subblock: a (usually 2D, one z-plane) tile of the acquisition."""

    pixel_type: int
    compression: int
    dims: Dict[str, Tuple[int, int]]  # dim letter -> (start, size)
    data_offset: int                  # absolute file offset of pixel data
    data_size: int

    def index(self, dim: str, default: int = 0) -> int:
        return self.dims.get(dim, (default, 1))[0]

    @property
    def plane_shape(self) -> Tuple[int, int]:
        return (self.dims["Y"][1], self.dims["X"][1])

    @property
    def dtype(self) -> np.dtype:
        try:
            return _PIXEL_DTYPES[self.pixel_type]
        except KeyError:
            raise ValueError(f"unsupported CZI pixel type {self.pixel_type}")


class CziFile:
    """Parsed CZI: subblock index + metadata XML. Opens lazily per read."""

    def __init__(self, path: str):
        self.path = path
        self.subblocks: List[CziSubBlock] = []
        self.metadata_xml: Optional[str] = None
        with open(path, "rb") as f:
            self._scan(f)
        if not self.subblocks:
            raise ValueError(f"{path}: no image subblocks found")

    # -- parsing ----------------------------------------------------------
    def _scan(self, f) -> None:
        f.seek(0, os.SEEK_END)
        end = f.tell()
        pos = 0
        while pos + 32 <= end:
            f.seek(pos)
            raw = f.read(32)
            if len(raw) < 32:
                break
            sid, alloc, used = _SEG_HEADER.unpack(raw)
            sid = sid.rstrip(b"\x00").decode("ascii", "replace")
            if alloc <= 0 or pos + 32 + alloc > end:
                if not sid.startswith("ZISRAW"):
                    break
                alloc = max(alloc, used)
                if alloc <= 0:
                    break
            if sid == "ZISRAWSUBBLOCK":
                self._parse_subblock(f, pos + 32)
            elif sid == "ZISRAWMETADATA":
                self._parse_metadata(f, pos + 32, used or alloc)
            pos += 32 + alloc
            pos = (pos + 31) // 32 * 32

    def _parse_subblock(self, f, data_start: int) -> None:
        f.seek(data_start)
        meta_size, _attach_size, data_size = struct.unpack("<iiq", f.read(16))
        (schema, pixel_type, _fpos, _fpart, compression, _pyr, _sp,
         dim_count) = _DV_FIXED.unpack(f.read(_DV_FIXED.size))
        if schema != b"DV":
            return  # DE (legacy) entries unsupported; skip
        dims: Dict[str, Tuple[int, int]] = {}
        for _ in range(dim_count):
            d, start, size, _coord, _stored = _DIM_ENTRY.unpack(
                f.read(_DIM_ENTRY.size))
            dims[d.rstrip(b"\x00").decode("ascii")] = (start, size)
        entry_size = _DV_FIXED.size + dim_count * _DIM_ENTRY.size
        payload = data_start + max(256, 16 + entry_size)
        self.subblocks.append(CziSubBlock(
            pixel_type=pixel_type, compression=compression, dims=dims,
            data_offset=payload + meta_size, data_size=data_size))

    def _parse_metadata(self, f, data_start: int, used: int) -> None:
        f.seek(data_start)
        xml_size, _attach = struct.unpack("<ii", f.read(8))
        f.seek(data_start + 256)
        self.metadata_xml = f.read(xml_size).decode("utf-8", "replace")

    # -- queries ----------------------------------------------------------
    def dimension_range(self, dim: str) -> List[int]:
        vals = set()
        for sb in self.subblocks:
            start, size = sb.dims.get(dim, (0, 1))
            vals.update(range(start, start + size))
        return sorted(vals)

    @property
    def angle_dim(self) -> str:
        """Z1 stores angles in V; fall back to S (scenes) if V is absent."""
        if any("V" in sb.dims for sb in self.subblocks):
            return "V"
        return "S"

    def voxel_size_um(self) -> Optional[Tuple[float, float, float]]:
        """(z, y, x) scaling from the metadata XML (meters -> um)."""
        if not self.metadata_xml:
            return None
        import xml.etree.ElementTree as ET

        try:
            root = ET.fromstring(self.metadata_xml)
        except ET.ParseError:
            return None
        out = {}
        for item in root.iter("Distance"):
            axis = item.get("Id")
            val = item.findtext("Value")
            if axis in ("X", "Y", "Z") and val:
                out[axis] = float(val) * 1e6
        if set(out) == {"X", "Y", "Z"}:
            return (out["Z"], out["Y"], out["X"])
        return None

    # -- reading ----------------------------------------------------------
    def read_view(self, timepoint: int = 0, angle: int = 0, channel: int = 0,
                  illumination: int = 0, tile: int = 0) -> np.ndarray:
        """Assemble the (z, y, x) volume of one view from its subblocks."""
        adim = self.angle_dim
        sel = [sb for sb in self.subblocks
               if sb.index("T") == timepoint and sb.index(adim) == angle
               and sb.index("C") == channel and sb.index("I") == illumination
               and sb.index("M") == tile]
        if not sel:
            raise KeyError(
                f"no subblocks for T={timepoint} {adim}={angle} C={channel} "
                f"I={illumination} M={tile} in {self.path}")
        zs = self.dimension_range("Z")
        z0 = zs[0] if zs else 0
        nz = (zs[-1] - z0 + 1) if zs else 1
        h, w = sel[0].plane_shape
        vol = np.zeros((nz, h, w), dtype=sel[0].dtype)
        with open(self.path, "rb") as f:
            for sb in sel:
                if sb.compression != 0:
                    raise ValueError(
                        f"{self.path}: compressed subblocks not supported "
                        f"(compression={sb.compression})")
                zstart, zsize = sb.dims.get("Z", (0, 1))
                f.seek(sb.data_offset)
                buf = f.read(sb.data_size)
                block = np.frombuffer(buf, dtype=sb.dtype).reshape(
                    (zsize,) + sb.plane_shape)
                vol[zstart - z0:zstart - z0 + zsize] = block
        return vol


# -- writer (tests / interop) ---------------------------------------------

def _pad32(n: int) -> int:
    return (n + 31) // 32 * 32


def _segment(sid: bytes, data: bytes) -> bytes:
    alloc = _pad32(len(data))
    return (_SEG_HEADER.pack(sid.ljust(16, b"\x00"), alloc, len(data))
            + data + b"\x00" * (alloc - len(data)))


def _dir_entry(pixel_type: int, file_pos: int,
               dims: Sequence[Tuple[str, int, int, int]]) -> bytes:
    out = [_DV_FIXED.pack(b"DV", pixel_type, file_pos, 0, 0, 0, b"\x00" * 5,
                          len(dims))]
    for d, start, size, stored in dims:
        out.append(_DIM_ENTRY.pack(d.encode().ljust(4, b"\x00"), start, size,
                                   float(start), stored))
    return b"".join(out)


def write_czi(path: str,
              volumes: Dict[Tuple[int, int, int, int], np.ndarray],
              voxel_size_um: Tuple[float, float, float] = (1.0, 1.0, 1.0),
              angle_dim: str = "V") -> None:
    """Write a minimal spec-conformant CZI.

    `volumes` maps (timepoint, angle, channel, illumination) -> (z, y, x)
    array; one subblock is written per z-plane (like the Z1). For tests and
    as an export path for BDV/Zen interop.
    """
    z_um, y_um, x_um = voxel_size_um
    xml = (
        '<ImageDocument><Metadata><Scaling><Items>'
        f'<Distance Id="X"><Value>{x_um * 1e-6:.9g}</Value></Distance>'
        f'<Distance Id="Y"><Value>{y_um * 1e-6:.9g}</Value></Distance>'
        f'<Distance Id="Z"><Value>{z_um * 1e-6:.9g}</Value></Distance>'
        '</Items></Scaling></Metadata></ImageDocument>'
    ).encode()

    buf = io.BytesIO()
    # file header: version 1.0, GUIDs, directory/metadata positions patched
    # after layout is known
    hdr = bytearray(512)
    struct.pack_into("<ii", hdr, 0, 1, 0)
    hdr[16:32] = uuid.uuid4().bytes
    hdr[32:48] = hdr[16:32]
    buf.write(_segment(b"ZISRAWFILE", bytes(hdr)))

    meta_pos = buf.tell()
    mdata = struct.pack("<ii", len(xml), 0) + b"\x00" * 248 + xml
    buf.write(_segment(b"ZISRAWMETADATA", mdata))

    dir_entries: List[bytes] = []
    for (t, v, c, i), vol in sorted(volumes.items()):
        vol = np.ascontiguousarray(vol)
        if vol.dtype not in _DTYPE_PIXELS:
            raise ValueError(f"unsupported dtype {vol.dtype} for CZI")
        ptype = _DTYPE_PIXELS[vol.dtype]
        nz, h, w = vol.shape
        for z in range(nz):
            plane = vol[z].tobytes()
            dims = [("X", 0, w, w), ("Y", 0, h, h), ("Z", z, 1, 1),
                    ("C", c, 1, 1), ("T", t, 1, 1), (angle_dim, v, 1, 1),
                    ("I", i, 1, 1)]
            file_pos = buf.tell()
            entry = _dir_entry(ptype, file_pos, dims)
            dir_entries.append(entry)
            pad = max(256, 16 + len(entry)) - (16 + len(entry))
            data = (struct.pack("<iiq", 0, 0, len(plane)) + entry
                    + b"\x00" * pad + plane)
            buf.write(_segment(b"ZISRAWSUBBLOCK", data))

    dir_pos = buf.tell()
    ddata = (struct.pack("<i", len(dir_entries)) + b"\x00" * 124
             + b"".join(dir_entries))
    buf.write(_segment(b"ZISRAWDIRECTORY", ddata))

    out = bytearray(buf.getvalue())
    # header data layout: Major/Minor/2 reserved (16) + 2 GUIDs (32) +
    # FilePart (4) -> DirectoryPosition @52, MetadataPosition @60
    struct.pack_into("<q", out, 32 + 52, dir_pos)
    struct.pack_into("<q", out, 32 + 60, meta_pos)
    with open(path, "wb") as f:
        f.write(out)


# -- Dataset integration ---------------------------------------------------

def czi_loader(path: str) -> Callable:
    """Loader seam: (tp, setup) -> volume, with setup enumerating the
    (angle, channel, illumination, tile) combinations present (sorted) —
    the order the reference's LightSheetZ1 dataset manager generates."""
    czi = CziFile(path)
    combos = czi_setups(czi)

    def load(view_id):
        tp, setup = view_id
        a, c, i, m = combos[setup]
        return czi.read_view(timepoint=tp, angle=a, channel=c,
                             illumination=i, tile=m)

    load.czi = czi
    return load


def czi_setups(czi: CziFile) -> List[Tuple[int, int, int, int]]:
    """Sorted distinct (angle, channel, illumination, tile) combos."""
    adim = czi.angle_dim
    combos = sorted({(sb.index(adim), sb.index("C"), sb.index("I"),
                      sb.index("M")) for sb in czi.subblocks})
    return combos


def define_dataset_czi(path: str):
    """Build a Dataset from a CZI acquisition (LightSheetZ1 analog)."""
    from spim_registration_tpu_torch.core.dataset import (
        Dataset,
        ViewDescription,
    )

    czi = CziFile(path)
    combos = czi_setups(czi)
    zs = czi.dimension_range("Z")
    nz = (zs[-1] - zs[0] + 1) if zs else 1
    h, w = czi.subblocks[0].plane_shape
    vox = czi.voxel_size_um() or (1.0, 1.0, 1.0)
    ds = Dataset(base_path=os.path.dirname(os.path.abspath(path)))
    for tp in czi.dimension_range("T") or [0]:
        for s, (a, c, i, m) in enumerate(combos):
            ds.add_view(ViewDescription(
                view_id=(tp, s), angle=a, channel=c, illumination=i,
                tile=m, size=(nz, h, w), voxel_size=vox))
    ds.loader = czi_loader(path)
    if vox != (1.0, 1.0, 1.0):
        from spim_registration_tpu_torch.pipeline.tools import (
            specify_calibration,
        )

        specify_calibration(ds, vox)
    return ds
