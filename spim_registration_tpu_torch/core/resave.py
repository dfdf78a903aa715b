"""Resave a dataset to multi-resolution BDV-style HDF5.

Port of the reference's `core/resave.py` (`Resave_HDF5` /
`Generic_Resave_HDF5`, `AppendSpimData2HDF5`): every view is written as a
mipmap pyramid `t{tp:05d}/s{setup:02d}/{level}/cells` (chunked, gzip
level 1) with per-level subsampling factors under
`s{setup:02d}/resolutions` and chunk sizes under `subdivisions`, both in
(x, y, z) order: the layout BigDataViewer reads. Needs `h5py`; the
pyramids are downsampled on the entry point's device (CUDA unless another
is named), as in `core/zarr_store.py`.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from spim_registration_tpu_torch.core.dataset import Dataset
from spim_registration_tpu_torch.core.imgloaders import _optional
from spim_registration_tpu_torch.core.zarr_store import (
    _mipmap_levels,
    _pyramid,
)

_NO_H5PY = "zarr or n5 (`resave --format zarr|n5`)"


def _write_setup_meta(f, setup, levels, chunk) -> None:
    if f"s{setup:02d}" not in f:
        g = f.require_group(f"s{setup:02d}")
        # BDV stores resolutions as (x, y, z) per level
        g.create_dataset(
            "resolutions",
            data=np.asarray([lv[::-1] for lv in levels], np.float64))
        g.create_dataset(
            "subdivisions",
            data=np.asarray([chunk[::-1]] * len(levels), np.int32))


def _write_view_pyramid(f, tp, setup, vol, levels, chunk, dtype,
                        device) -> None:
    for li, _factor, arr in _pyramid(vol, levels, dtype, device):
        ck = tuple(min(c, s) for c, s in zip(chunk, arr.shape))
        f.create_dataset(
            f"t{tp:05d}/s{setup:02d}/{li}/cells", data=arr,
            chunks=ck, compression="gzip", compression_opts=1)


def resave_hdf5(dataset: Dataset, h5_path: str,
                view_ids=None, max_levels: int = 4,
                chunk: Tuple[int, int, int] = (16, 64, 64),
                dtype=np.float32, device=None) -> None:
    """Write views (+pyramids) to HDF5; attach an hdf5 loader to dataset."""
    from spim_registration_tpu_torch.core.imgloaders import hdf5_loader

    h5py = _optional("h5py", "resaving to BDV HDF5", instead=_NO_H5PY)
    if view_ids is None:
        view_ids = sorted(dataset.views)
    with h5py.File(h5_path, "w") as f:
        for vid in view_ids:
            tp, setup = vid
            vol = np.asarray(dataset.get_image(vid))
            levels = _mipmap_levels(vol.shape, max_levels)
            _write_setup_meta(f, setup, levels, chunk)
            _write_view_pyramid(f, tp, setup, vol, levels, chunk, dtype,
                                device)
    dataset.loader = hdf5_loader(h5_path)


def append_fused_hdf5(dataset: Dataset, h5_path: str, volume: np.ndarray,
                      timepoint: int, bbox=None, setup_id=None,
                      max_levels: int = 4,
                      chunk: Tuple[int, int, int] = (16, 64, 64),
                      dtype=np.float32, xml_path=None, device=None):
    """Append a fused/deconvolved volume as a NEW view setup of an
    EXISTING BDV-HDF5 dataset (the reference's `AppendSpimData2HDF5`):
    its pyramid goes into the same HDF5 (append mode), a new view is
    registered in the dataset with a translation placing the volume at
    `bbox.min` in world coordinates, the XML is saved when `xml_path` is
    given, and the dataset's loader serves the appended setup from the
    HDF5 and every other view through the loader it had.

    Returns the new (timepoint, setup_id) view id.
    """
    from spim_registration_tpu_torch.core.dataset import (
        ViewDescription,
        ViewTransform,
    )
    from spim_registration_tpu_torch.core.imgloaders import hdf5_loader

    h5py = _optional("h5py", "appending to BDV HDF5", instead=_NO_H5PY)
    volume = np.asarray(volume)
    if setup_id is None:
        existing = set(dataset.setups())
        with h5py.File(h5_path, "a") as f:
            for k in f:
                if k.startswith("s") and k[1:].isdigit():
                    existing.add(int(k[1:]))
        setup_id = max(existing, default=-1) + 1
    vid = (int(timepoint), int(setup_id))

    levels = _mipmap_levels(volume.shape, max_levels)
    with h5py.File(h5_path, "a") as f:
        _write_setup_meta(f, setup_id, levels, chunk)
        _write_view_pyramid(f, timepoint, setup_id, volume, levels, chunk,
                            dtype, device)

    offset = np.zeros(3) if bbox is None else np.asarray(bbox.min, float)
    A = np.concatenate([np.eye(3), offset[:, None]], axis=1)
    vd = ViewDescription(
        view_id=vid, size=tuple(int(s) for s in volume.shape),
        transforms=[ViewTransform("fused bounding box offset", A)])
    dataset.add_view(vd)

    # composite loader: appended setup from the HDF5, everything else
    # through the previous loader (the original dataset may be TIFF/CZI)
    prev = dataset.loader
    new_load = hdf5_loader(h5_path)
    appended = {vid}

    def load(view_id):
        if view_id in appended or prev is None:
            return new_load(view_id)
        return prev(view_id)

    dataset.loader = load

    if xml_path is not None:
        from spim_registration_tpu_torch.core.xml_io import save_dataset

        save_dataset(dataset, xml_path)
    return vid
