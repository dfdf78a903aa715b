"""MicroManager dataset reading.

The port's copy of the reference's `core/micromanager.py`, the analog of
`MicroManagerImgLoader` and the `MicroManager` dataset manager. A
MicroManager acquisition is a directory of per-position multi-page
OME-TIFF stacks (`<prefix>_MMStack_Pos<n>.ome.tif`, read through
`imageio`) with JSON metadata in the first page's ImageDescription and/or
a `metadata.txt` sidecar; the Summary block gives the (Frames, Slices,
Channels, Positions) geometry and the page interleaving order
(`SlicesFirst`).

Mapping: Frame -> timepoint, Position -> tile, Channel -> channel; each
(position, channel) pair becomes one view setup.
"""

from __future__ import annotations

import glob
import json
import os
import re
from typing import Callable, Dict, List

from spim_registration_tpu_torch.core.imgloaders import _optional


def _read_summary(tif_path: str) -> dict:
    """Summary metadata from the TIFF description or metadata.txt."""
    iio = _optional("imageio.v3", "reading MicroManager stacks")
    try:
        desc = iio.immeta(tif_path).get("description", "")
        meta = json.loads(desc)
        if "Summary" in meta:
            return meta["Summary"]
    except (json.JSONDecodeError, OSError, ValueError):
        pass
    base = os.path.dirname(os.path.abspath(tif_path))
    for cand in (os.path.join(base, "metadata.txt"),
                 re.sub(r"\.ome\.tif+$|\.tif+$", "_metadata.txt", tif_path)):
        if os.path.exists(cand):
            with open(cand) as f:
                meta = json.load(f)
            if "Summary" in meta:
                return meta["Summary"]
    return {}


def _position_files(base_path: str) -> List[str]:
    files = sorted(
        glob.glob(os.path.join(base_path, "*_MMStack_Pos*.ome.tif"))
        + glob.glob(os.path.join(base_path, "*_MMStack_Pos*.tif")))
    if not files:
        files = sorted(glob.glob(os.path.join(base_path, "*.ome.tif")))
    if not files:
        raise FileNotFoundError(
            f"no MicroManager stacks (*_MMStack_Pos*.tif) in {base_path}")
    # dedupe (.ome.tif matches both globs)
    seen, out = set(), []
    for f in files:
        if f not in seen:
            seen.add(f)
            out.append(f)
    return out


class MicroManagerStacks:
    """Lazy reader over the per-position stacks of one acquisition."""

    def __init__(self, base_path: str):
        self.files = _position_files(base_path)
        self.summary = _read_summary(self.files[0])
        self.frames = int(self.summary.get("Frames", 1))
        self.slices = int(self.summary.get("Slices", 0))
        self.channels = int(self.summary.get("Channels", 1))
        self.slices_first = bool(self.summary.get("SlicesFirst", False))
        self._cache: Dict[str, "object"] = {}

    def _pages(self, pos: int):
        import numpy as np

        iio = _optional("imageio.v3", "reading MicroManager stacks")
        path = self.files[pos]
        if path not in self._cache:
            arr = np.asarray(iio.imread(path))
            if arr.ndim == 2:
                arr = arr[None]
            self._cache = {path: arr}  # keep only the latest file
        return self._cache[path]

    def read(self, frame: int, channel: int, pos: int):
        """(z, y, x) stack of one (timepoint, channel, position)."""
        import numpy as np

        pages = self._pages(pos)
        S = self.slices or max(1, len(pages) // max(
            1, self.frames * self.channels))
        C = self.channels
        base = frame * S * C
        if self.slices_first:
            idx = [base + channel * S + s for s in range(S)]
        else:
            idx = [base + s * C + channel for s in range(S)]
        return np.stack([pages[i] for i in idx])


def micromanager_loader(base_path: str) -> Callable:
    """Loader seam: (tp, setup) -> volume with
    setup = position * n_channels + channel."""
    mm = MicroManagerStacks(base_path)

    def load(view_id):
        tp, setup = view_id
        pos, channel = divmod(setup, mm.channels)
        return mm.read(tp, channel, pos)

    load.mm = mm
    return load


def define_dataset_micromanager(base_path: str):
    """Build a Dataset from a MicroManager acquisition directory."""
    from spim_registration_tpu_torch.core.dataset import (
        Dataset,
        ViewDescription,
    )

    mm = MicroManagerStacks(base_path)
    vol0 = mm.read(0, 0, 0)
    vox = (1.0, 1.0, 1.0)
    pz = mm.summary.get("z-step_um")
    pxy = mm.summary.get("PixelSize_um")
    if pz and pxy:
        vox = (abs(float(pz)), float(pxy), float(pxy))
    ds = Dataset(base_path=os.path.abspath(base_path))
    for tp in range(mm.frames):
        for pos in range(len(mm.files)):
            for c in range(mm.channels):
                ds.add_view(ViewDescription(
                    view_id=(tp, pos * mm.channels + c),
                    channel=c, tile=pos, size=vol0.shape, voxel_size=vox))
    ds.loader = micromanager_loader(base_path)
    if vox != (1.0, 1.0, 1.0):
        from spim_registration_tpu_torch.pipeline.tools import (
            specify_calibration,
        )

        specify_calibration(ds, vox)
    return ds
