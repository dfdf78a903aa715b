"""Pluggable image loaders.

Copy of the reference's `core/imgloaders.py`: a loader is
`(view_id) -> np.ndarray (z, y, x)` and `Dataset.loader` holds one.
`.npy` volumes (and CZI files, zarr and n5 containers: `core/czi.py`,
`core/zarr_store.py`) need nothing beyond numpy; TIFF stacks need
`imageio` and BDV HDF5 needs `h5py`, both imported when a volume is read
or written, so a machine without them runs everything on the other
formats and raises a clear ImportError on these.
"""

from __future__ import annotations

import importlib
import os
from typing import Callable, Dict, Tuple

import numpy as np

ViewId = Tuple[int, int]


def _optional(module: str, what: str, instead: str = ".npy volumes"):
    try:
        return importlib.import_module(module)
    except ImportError as e:
        raise ImportError(f"{what} needs the `{module.split('.')[0]}` "
                          f"package, which is not installed; use "
                          f"{instead} instead") from e


def memory_loader(volumes: Dict[ViewId, np.ndarray]) -> Callable:
    """Views held in RAM (tests / simulation)."""

    def load(view_id: ViewId) -> np.ndarray:
        return volumes[view_id]

    return load


def npy_loader(base_path: str, pattern: str = "tp{tp}_setup{setup}.npy"
               ) -> Callable:
    def load(view_id: ViewId) -> np.ndarray:
        tp, setup = view_id
        return np.load(os.path.join(base_path,
                                    pattern.format(tp=tp, setup=setup)))

    return load


def tiff_stack_loader(base_path: str,
                      pattern: str = "tp{tp}_setup{setup}.tif") -> Callable:
    """3D multi-page TIFF per view (the StackImgLoaderIJ layout)."""

    def load(view_id: ViewId) -> np.ndarray:
        iio = _optional("imageio.v3", "reading a TIFF stack")
        tp, setup = view_id
        path = os.path.join(base_path, pattern.format(tp=tp, setup=setup))
        vol = np.asarray(iio.imread(path))
        if vol.ndim == 2:
            vol = vol[None]
        return vol

    return load


def save_tiff_stack(path: str, vol: np.ndarray) -> None:
    """Write a (z, y, x) volume as a multi-page TIFF (Save3dTIFF analog)."""
    iio = _optional("imageio.v3", "writing a TIFF stack")
    iio.imwrite(path, np.asarray(vol))


def hdf5_loader(h5_path: str, level: int = 0) -> Callable:
    """Read views from a BDV-style HDF5
    (`t{tp:05d}/s{setup:02d}/{level}/cells`)."""

    def load(view_id: ViewId) -> np.ndarray:
        h5py = _optional("h5py", "reading BDV HDF5")
        tp, setup = view_id
        with h5py.File(h5_path, "r") as f:
            return f[f"t{tp:05d}/s{setup:02d}/{level}/cells"][()]

    return load
