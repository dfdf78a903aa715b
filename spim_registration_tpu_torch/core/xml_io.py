"""SpimData2-compatible XML persistence.

Copy of the reference's `core/xml_io.py` (the BDV spim_data XML schema):
`<SpimData>` with SequenceDescription (ViewSetups with angle / channel /
illumination / tile attributes, Timepoints), ViewRegistrations (transform
chains), ViewInterestPoints (sidecar files) and BoundingBoxes. Saving
after every stage is the checkpoint system; numbered backups (`~1`, `~2`)
as the reference keeps them. The writer is deterministic and writes the
reference's bytes, so either package reads the other's files.

Coordinate convention: BDV XML affines act on (x, y, z, 1) row-major;
internally (z, y, x) — `affine_zyx_to_xyz` converts by reversing rows and
columns.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Dict

import numpy as np

from spim_registration_tpu_torch.core.dataset import (
    BoundingBox,
    Dataset,
    InterestPoints,
    ViewDescription,
    ViewTransform,
)


def affine_zyx_to_xyz(A: np.ndarray) -> np.ndarray:
    """Reverse row and column axis order of the linear part + translation
    (an involution — the same op converts xyz -> zyx)."""
    A = np.asarray(A)
    return np.concatenate([A[::-1, :3][:, ::-1], A[::-1, 3:4]], axis=1)


def affine_xyz_to_zyx(A: np.ndarray) -> np.ndarray:
    # same involution
    return affine_zyx_to_xyz(A)


def _indent(elem, level=0):
    i = "\n" + level * "  "
    if len(elem):
        if not elem.text or not elem.text.strip():
            elem.text = i + "  "
        for child in elem:
            _indent(child, level + 1)
        if not child.tail or not child.tail.strip():
            child.tail = i
        if not elem.tail or not elem.tail.strip():
            elem.tail = i
    else:
        if level and (not elem.tail or not elem.tail.strip()):
            elem.tail = i


def _ip_filename(tp: int, setup: int, label: str) -> str:
    return f"tpId_{tp}_viewSetupId_{setup}.{label}"


def save_interest_points(base_path: str, tp: int, setup: int,
                         ips: InterestPoints) -> str:
    """Write `interestpoints/<file>.ip.txt` (id z y x intensity) and
    `.corr.txt` (id other_tp other_setup other_label other_id)."""
    d = os.path.join(base_path, "interestpoints")
    os.makedirs(d, exist_ok=True)
    stem = os.path.join(d, _ip_filename(tp, setup, ips.label))
    with open(stem + ".ip.txt", "w") as f:
        f.write("id\tz\ty\tx\tintensity\n")
        inten = (ips.intensities if ips.intensities is not None
                 else np.zeros(len(ips.points)))
        for i, (p, s) in enumerate(zip(ips.points, inten)):
            f.write(f"{i}\t{p[0]:.6f}\t{p[1]:.6f}\t{p[2]:.6f}\t{s:.6f}\n")
    with open(stem + ".corr.txt", "w") as f:
        f.write("id\tother_tp\tother_setup\tother_label\tother_id\n")
        for (pid, (otp, osetup), olabel, oid) in ips.correspondences:
            f.write(f"{pid}\t{otp}\t{osetup}\t{olabel}\t{oid}\n")
    return stem


def load_interest_points(base_path: str, tp: int, setup: int,
                         label: str, parameters: str = "") -> InterestPoints:
    stem = os.path.join(base_path, "interestpoints",
                        _ip_filename(tp, setup, label))
    pts, inten = [], []
    with open(stem + ".ip.txt") as f:
        next(f)
        for line in f:
            parts = line.split()
            pts.append([float(parts[1]), float(parts[2]), float(parts[3])])
            inten.append(float(parts[4]))
    corr = []
    corr_path = stem + ".corr.txt"
    if os.path.exists(corr_path):
        with open(corr_path) as f:
            next(f)
            for line in f:
                parts = line.split()
                corr.append((int(parts[0]), (int(parts[1]), int(parts[2])),
                             parts[3], int(parts[4])))
    return InterestPoints(
        label=label,
        points=np.asarray(pts, np.float64).reshape(-1, 3),
        intensities=np.asarray(inten),
        parameters=parameters,
        correspondences=corr,
    )


def save_dataset(dataset: Dataset, xml_path: str,
                 img_format: str = "spim.tpu.memory") -> None:
    """Write the dataset XML (+ interest point sidecars) with backups."""
    base = os.path.dirname(os.path.abspath(xml_path)) or "."
    os.makedirs(base, exist_ok=True)

    root = ET.Element("SpimData", version="0.2")
    ET.SubElement(root, "BasePath", type="relative").text = "."
    seq = ET.SubElement(root, "SequenceDescription")
    il = ET.SubElement(seq, "ImageLoader", format=img_format)

    setups_el = ET.SubElement(seq, "ViewSetups")
    setups: Dict[int, ViewDescription] = {}
    for (tp, s), vd in sorted(dataset.views.items()):
        setups.setdefault(s, vd)
    attr_values: Dict[str, set] = {"illumination": set(), "channel": set(),
                                   "tile": set(), "angle": set()}
    for s, vd in sorted(setups.items()):
        vs = ET.SubElement(setups_el, "ViewSetup")
        ET.SubElement(vs, "id").text = str(s)
        ET.SubElement(vs, "name").text = str(s)
        if vd.size is not None:
            # BDV size order is x y z
            ET.SubElement(vs, "size").text = " ".join(
                str(int(v)) for v in vd.size[::-1])
        vox = ET.SubElement(vs, "voxelSize")
        ET.SubElement(vox, "unit").text = "um"
        ET.SubElement(vox, "size").text = " ".join(
            f"{v:g}" for v in vd.voxel_size[::-1])
        attrs = ET.SubElement(vs, "attributes")
        for name, val in (("illumination", vd.illumination),
                          ("channel", vd.channel), ("tile", vd.tile),
                          ("angle", vd.angle)):
            ET.SubElement(attrs, name).text = str(val)
            attr_values[name].add(val)
    for name, vals in attr_values.items():
        at = ET.SubElement(setups_el, "Attributes", name=name)
        tag = name.capitalize()
        for v in sorted(vals):
            el = ET.SubElement(at, tag)
            ET.SubElement(el, "id").text = str(v)
            ET.SubElement(el, "name").text = str(v)

    tps = sorted({tp for (tp, _s) in dataset.views})
    tp_el = ET.SubElement(seq, "Timepoints", type="pattern")
    ET.SubElement(tp_el, "integerpattern").text = ", ".join(
        str(t) for t in tps)
    missing = ET.SubElement(seq, "MissingViews")
    for (tp, s), vd in sorted(dataset.views.items()):
        if not vd.present:
            ET.SubElement(missing, "MissingView", timepoint=str(tp),
                          setup=str(s))

    regs = ET.SubElement(root, "ViewRegistrations")
    for (tp, s), vd in sorted(dataset.views.items()):
        vr = ET.SubElement(regs, "ViewRegistration", timepoint=str(tp),
                           setup=str(s))
        for t in vd.transforms:
            vt = ET.SubElement(vr, "ViewTransform", type="affine")
            ET.SubElement(vt, "Name").text = t.name
            A = affine_zyx_to_xyz(t.affine)
            ET.SubElement(vt, "affine").text = " ".join(
                f"{v:.12g}" for v in A.reshape(-1))

    vip = ET.SubElement(root, "ViewInterestPoints")
    for (tp, s), vd in sorted(dataset.views.items()):
        for label, ips in sorted(vd.interest_points.items()):
            save_interest_points(base, tp, s, ips)
            el = ET.SubElement(
                vip, "ViewInterestPointsFile", timepoint=str(tp),
                setup=str(s), label=label, params=ips.parameters)
            el.text = "interestpoints/" + _ip_filename(tp, s, label)

    bbs = ET.SubElement(root, "BoundingBoxes")
    for name, bb in sorted(dataset.bounding_boxes.items()):
        el = ET.SubElement(bbs, "BoundingBoxDefinition", name=name)
        # BDV order x y z; max inclusive in the reference schema
        ET.SubElement(el, "min").text = " ".join(
            str(int(v)) for v in bb.min[::-1])
        ET.SubElement(el, "max").text = " ".join(
            str(int(v) - 1) for v in bb.max[::-1])

    # numbered backups like the reference (~1 newest, up to ~5)
    if os.path.exists(xml_path):
        for i in range(4, 0, -1):
            src = xml_path + f"~{i}"
            if os.path.exists(src):
                os.replace(src, xml_path + f"~{i + 1}")
        os.replace(xml_path, xml_path + "~1")

    _indent(root)
    ET.ElementTree(root).write(xml_path, encoding="unicode",
                               xml_declaration=True)


def load_dataset(xml_path: str) -> Dataset:
    """Load a dataset XML written by `save_dataset` (or a compatible BDV
    SpimData XML without our extensions)."""
    base = os.path.dirname(os.path.abspath(xml_path)) or "."
    tree = ET.parse(xml_path)
    root = tree.getroot()
    ds = Dataset(base_path=base)

    seq = root.find("SequenceDescription")
    setups_meta: Dict[int, dict] = {}
    for vs in seq.find("ViewSetups").findall("ViewSetup"):
        sid = int(vs.findtext("id"))
        meta = {"size": None, "voxel_size": (1.0, 1.0, 1.0),
                "angle": 0, "channel": 0, "illumination": 0, "tile": 0}
        size = vs.findtext("size")
        if size:
            xyz = [int(float(v)) for v in size.split()]
            meta["size"] = tuple(xyz[::-1])
        vox = vs.find("voxelSize")
        if vox is not None and vox.findtext("size"):
            xyz = [float(v) for v in vox.findtext("size").split()]
            meta["voxel_size"] = tuple(xyz[::-1])
        attrs = vs.find("attributes")
        if attrs is not None:
            for name in ("angle", "channel", "illumination", "tile"):
                t = attrs.findtext(name)
                if t is not None:
                    meta[name] = int(t)
        setups_meta[sid] = meta

    tp_el = seq.find("Timepoints")
    pattern = tp_el.findtext("integerpattern") or "0"
    tps = []
    for part in pattern.replace(",", " ").split():
        if "-" in part and not part.startswith("-"):
            a, b = part.split("-")[:2]
            tps.extend(range(int(a), int(b) + 1))
        else:
            tps.append(int(part))
    tps = sorted(set(tps))

    missing = set()
    mv = seq.find("MissingViews")
    if mv is not None:
        for el in mv.findall("MissingView"):
            missing.add((int(el.get("timepoint")), int(el.get("setup"))))

    for tp in tps:
        for sid, meta in sorted(setups_meta.items()):
            vd = ViewDescription(
                view_id=(tp, sid), angle=meta["angle"],
                channel=meta["channel"], illumination=meta["illumination"],
                tile=meta["tile"], size=meta["size"],
                voxel_size=meta["voxel_size"],
                present=(tp, sid) not in missing)
            ds.add_view(vd)

    regs = root.find("ViewRegistrations")
    if regs is not None:
        for vr in regs.findall("ViewRegistration"):
            key = (int(vr.get("timepoint")), int(vr.get("setup")))
            if key not in ds.views:
                continue
            chain = []
            for vt in vr.findall("ViewTransform"):
                name = vt.findtext("Name") or "transform"
                vals = [float(v) for v in vt.findtext("affine").split()]
                A = affine_xyz_to_zyx(np.asarray(vals).reshape(3, 4))
                chain.append(ViewTransform(name, A))
            ds.views[key].transforms = chain

    vip = root.find("ViewInterestPoints")
    if vip is not None:
        for el in vip.findall("ViewInterestPointsFile"):
            tp = int(el.get("timepoint"))
            s = int(el.get("setup"))
            label = el.get("label")
            if (tp, s) in ds.views:
                try:
                    ips = load_interest_points(base, tp, s, label,
                                               el.get("params", ""))
                    ds.views[(tp, s)].interest_points[label] = ips
                except FileNotFoundError:
                    pass

    bbs = root.find("BoundingBoxes")
    if bbs is not None:
        for el in bbs.findall("BoundingBoxDefinition"):
            name = el.get("name")
            mn = [int(v) for v in el.findtext("min").split()][::-1]
            mx = [int(v) + 1 for v in el.findtext("max").split()][::-1]
            ds.bounding_boxes[name] = BoundingBox(name, tuple(mn), tuple(mx))

    return ds
