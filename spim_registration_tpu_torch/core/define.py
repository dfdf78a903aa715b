"""Dataset definition from raw files on disk.

The port's copy of the reference's `core/define.py`, the analog of
`Define_Multi_View_Dataset` and the `StackList*` dataset managers: build
the dataset XML from a filename pattern with {tp}/{setup} or the full
attribute set {angle}/{channel}/{illum}/{tile} (one view setup per
distinct attribute combination, like StackList's angle x channel x
illumination x tile grid), probing each file for its size. Supports .npy
volumes, and .tif stacks through `imageio`.
Format-specific managers (LightSheetZ1 CZI, MicroManager, DHM) live in
`core/czi.py`, `core/micromanager.py`, `core/dhm.py`.
"""

from __future__ import annotations

import itertools
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from spim_registration_tpu_torch.core.dataset import (
    Dataset,
    ViewDescription,
)
from spim_registration_tpu_torch.core.imgloaders import (
    _optional,
    npy_loader,
    tiff_stack_loader,
)

_ATTRS = ("angle", "channel", "illum", "tile")


def _probe_shape(path: str) -> Tuple[int, int, int]:
    if path.endswith(".npy"):
        # the header alone (a memory map reads no data); the reference
        # calls numpy's private header reader, which not every numpy has
        return tuple(np.load(path, mmap_mode="r").shape)
    iio = _optional("imageio.v3", "reading a TIFF stack")
    vol = iio.imread(path)
    return tuple(vol.shape) if vol.ndim == 3 else (1,) + tuple(vol.shape)


def _discover(base_path: str, pattern: str,
              fields: Sequence[str]) -> List[Dict[str, int]]:
    """All files matching `pattern`; returns their field values."""
    rx = re.escape(pattern)
    for f in fields:
        rx = rx.replace(re.escape("{%s}" % f), r"(?P<%s>\d+)" % f)
    out = []
    for name in os.listdir(base_path):
        m = re.fullmatch(rx, name)
        if m:
            out.append({k: int(v) for k, v in m.groupdict().items()})
    return out


def define_dataset(
    base_path: str,
    pattern: str,
    timepoints: Optional[Sequence[int]] = None,
    setups: Optional[Sequence[int]] = None,
    angles: Optional[Dict[int, int]] = None,
    voxel_size: Tuple[float, float, float] = (1.0, 1.0, 1.0),
) -> Dataset:
    """Build a Dataset from files matching `pattern`.

    Pattern placeholders: {tp} plus either {setup} or any of
    {angle}/{channel}/{illum}/{tile}. Undiscovered values default from
    explicit `timepoints`/`setups` arguments ({tp}/{setup} mode only).
    """
    fields = ["tp"] + [f for f in ("setup",) + _ATTRS
                       if "{%s}" % f in pattern]
    if "{tp}" not in pattern:
        raise ValueError("pattern must contain {tp}")
    attr_mode = any(f in fields for f in _ATTRS)
    if attr_mode and "setup" in fields:
        raise ValueError("use either {setup} or attribute placeholders, "
                         "not both")

    ds = Dataset(base_path=base_path)

    if attr_mode:
        found = _discover(base_path, pattern, fields)
        if not found:
            raise FileNotFoundError(
                f"no files matching {pattern!r} in {base_path}")
        tps = sorted({f["tp"] for f in found})
        combos = sorted({tuple(f.get(a, 0) for a in _ATTRS) for f in found})
        setup_of = {c: s for s, c in enumerate(combos)}
        for f in found:
            combo = tuple(f.get(a, 0) for a in _ATTRS)
            path = os.path.join(base_path, pattern.format(**f))
            ds.add_view(ViewDescription(
                view_id=(f["tp"], setup_of[combo]),
                angle=combo[0], channel=combo[1], illumination=combo[2],
                tile=combo[3], size=_probe_shape(path),
                voxel_size=voxel_size))
        # mark absent (tp x setup) grid holes
        for tp, (combo, s) in itertools.product(tps, setup_of.items()):
            if (tp, s) not in ds.views:
                ds.add_view(ViewDescription(view_id=(tp, s), present=False))

        combo_args = {s: dict(zip(_ATTRS, c)) for c, s in setup_of.items()}

        def _fmt(view_id):
            tp, s = view_id
            return pattern.format(tp=tp, **{k: v for k, v in
                                            combo_args[s].items()
                                            if "{%s}" % k in pattern})

        if pattern.endswith(".npy"):
            def load(view_id):
                return np.load(os.path.join(base_path, _fmt(view_id)))
        else:
            def load(view_id):
                iio = _optional("imageio.v3", "reading a TIFF stack")
                vol = np.asarray(iio.imread(
                    os.path.join(base_path, _fmt(view_id))))
                return vol[None] if vol.ndim == 2 else vol

        ds.loader = load
    else:
        if timepoints is None or setups is None:
            found = _discover(base_path, pattern, fields)
            if not found:
                raise FileNotFoundError(
                    f"no files matching {pattern!r} in {base_path}")
            if timepoints is None:
                timepoints = sorted({f["tp"] for f in found})
            if setups is None:
                setups = sorted({f.get("setup", 0) for f in found})
        for tp, s in itertools.product(timepoints, setups):
            path = os.path.join(base_path, pattern.format(tp=tp, setup=s))
            if not os.path.exists(path):
                ds.add_view(ViewDescription(view_id=(tp, s), present=False))
                continue
            ds.add_view(ViewDescription(
                view_id=(tp, s),
                angle=(angles or {}).get(s, s),
                size=_probe_shape(path), voxel_size=voxel_size))
        if pattern.endswith(".npy"):
            ds.loader = npy_loader(base_path, pattern)
        else:
            ds.loader = tiff_stack_loader(base_path, pattern)

    if voxel_size != (1.0, 1.0, 1.0):
        from spim_registration_tpu_torch.pipeline.tools import (
            specify_calibration,
        )

        specify_calibration(ds, voxel_size)
    return ds
