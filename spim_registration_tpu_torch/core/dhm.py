"""DHM (digital holographic microscopy) dataset reading.

The port's copy of the reference's `core/dhm.py`, the analog of
`DHMImgLoader` and the `DHM` dataset manager. A DHM export is a master
directory holding one subdirectory per modality (amplitude / phase), each
containing one image (or stack) per timepoint (`.npy`, or TIFF / PNG
through `imageio`), plus an optional `timestamps.txt`.

Mapping: file index (sorted) -> timepoint, modality subdirectory ->
channel; a 2D image becomes a 1-plane stack.
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional, Sequence

from spim_registration_tpu_torch.core.imgloaders import _optional

_IMG_EXT = (".tif", ".tiff", ".png", ".npy")


def _channel_dirs(base_path: str,
                  channel_dirs: Optional[Sequence[str]]) -> List[str]:
    if channel_dirs is not None:
        dirs = list(channel_dirs)
    else:
        dirs = sorted(
            d for d in os.listdir(base_path)
            if os.path.isdir(os.path.join(base_path, d))
            and any(f.lower().endswith(_IMG_EXT)
                    for f in os.listdir(os.path.join(base_path, d))))
    if not dirs:
        raise FileNotFoundError(
            f"no DHM modality subdirectories with images in {base_path}")
    return dirs


def _files_of(base_path: str, sub: str) -> List[str]:
    d = os.path.join(base_path, sub)
    return sorted(os.path.join(d, f) for f in os.listdir(d)
                  if f.lower().endswith(_IMG_EXT))


def _read(path: str):
    import numpy as np

    if path.endswith(".npy"):
        vol = np.load(path)
    else:
        iio = _optional("imageio.v3", "reading a DHM image")
        vol = np.asarray(iio.imread(path))
    return vol[None] if vol.ndim == 2 else vol


def dhm_loader(base_path: str,
               channel_dirs: Optional[Sequence[str]] = None) -> Callable:
    """Loader seam: (tp, setup) -> stack; setup indexes the modality."""
    dirs = _channel_dirs(base_path, channel_dirs)
    files = [_files_of(base_path, d) for d in dirs]

    def load(view_id):
        tp, setup = view_id
        return _read(files[setup][tp])

    load.channel_dirs = dirs
    return load


def read_timestamps(base_path: str) -> Optional[List[float]]:
    """Per-timepoint acquisition times from timestamps.txt, if present."""
    for name in ("timestamps.txt", "timestamps.csv"):
        p = os.path.join(base_path, name)
        if os.path.exists(p):
            out = []
            with open(p) as f:
                for line in f:
                    parts = line.replace(",", " ").split()
                    if parts:
                        try:
                            out.append(float(parts[-1]))
                        except ValueError:
                            continue
            return out or None
    return None


def define_dataset_dhm(base_path: str,
                       channel_dirs: Optional[Sequence[str]] = None):
    """Build a Dataset from a DHM export directory."""
    from spim_registration_tpu_torch.core.dataset import (
        Dataset,
        ViewDescription,
    )

    dirs = _channel_dirs(base_path, channel_dirs)
    files = [_files_of(base_path, d) for d in dirs]
    n_tp = min(len(f) for f in files)
    shape = _read(files[0][0]).shape
    ds = Dataset(base_path=os.path.abspath(base_path))
    for tp in range(n_tp):
        for c in range(len(dirs)):
            ds.add_view(ViewDescription(view_id=(tp, c), channel=c,
                                        size=shape))
    ds.loader = dhm_loader(base_path, dirs)
    return ds
