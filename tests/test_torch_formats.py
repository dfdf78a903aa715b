"""The port's format readers and `define` (spim_registration_tpu_torch/
core/{czi,micromanager,dhm,define}.py and the CLI verb `define`) against
the reference's on the same files on the CPU.

Tolerances: none. Every array, every XML byte and every refusal is held
exactly: both packages parse the same bytes with the same numpy code.
"""

import filecmp
import json
import os
import sys

import imageio.v3 as iio
import numpy as np
import pytest

from spim_registration_tpu import cli as ref_cli
from spim_registration_tpu.core import czi as ref_czi
from spim_registration_tpu.core import define as ref_define
from spim_registration_tpu.core import dhm as ref_dhm
from spim_registration_tpu.core import micromanager as ref_mm
from spim_registration_tpu.core import xml_io as ref_xml
from spim_registration_tpu_torch import cli
from spim_registration_tpu_torch.core import czi, define, dhm, micromanager
from spim_registration_tpu_torch.core import xml_io


@pytest.fixture(autouse=True)
def _no_compile_cache(monkeypatch):
    """The reference's CLI keeps no compilation cache in these tests."""
    monkeypatch.setenv("SPIM_COMPILE_CACHE", "0")


def _same_xml(tmp_path, ref_ds, port_ds):
    """Both datasets saved by their own package give the same bytes, and
    every present view loads the same array."""
    ref_xml.save_dataset(ref_ds, str(tmp_path / "ref.xml"))
    xml_io.save_dataset(port_ds, str(tmp_path / "port.xml"))
    assert filecmp.cmp(tmp_path / "ref.xml", tmp_path / "port.xml",
                       shallow=False)
    assert sorted(ref_ds.views) == sorted(port_ds.views)
    for vid, vd in ref_ds.views.items():
        assert port_ds.views[vid].present == vd.present
        if vd.present:
            a, b = ref_ds.get_image(vid), port_ds.get_image(vid)
            assert a.dtype == b.dtype and np.array_equal(a, b), vid


# -- CZI -------------------------------------------------------------------

def _czi_volumes(dtype, n_tp=2, n_angles=3, n_channels=2, shape=(5, 16, 12)):
    rng = np.random.default_rng(0)
    vols = {}
    for t in range(n_tp):
        for v in range(n_angles):
            for c in range(n_channels):
                vols[(t, v, c, 0)] = (
                    rng.integers(0, 1000, size=shape).astype(dtype)
                    if np.issubdtype(dtype, np.integer)
                    else rng.random(shape).astype(dtype))
    return vols


@pytest.mark.parametrize("writer", ["port", "reference"])
@pytest.mark.parametrize("dtype,angle_dim", [(np.uint16, "V"),
                                             (np.float32, "S"),
                                             (np.uint8, "V")])
def test_czi_written_by_one_package_reads_in_the_other(tmp_path, writer,
                                                       dtype, angle_dim):
    vols = _czi_volumes(dtype)
    path = str(tmp_path / "acq.czi")
    write = czi.write_czi if writer == "port" else ref_czi.write_czi
    write(path, vols, voxel_size_um=(2.0, 0.5, 0.5), angle_dim=angle_dim)
    got, want = czi.CziFile(path), ref_czi.CziFile(path)
    assert got.angle_dim == want.angle_dim == angle_dim
    for d in "TVSCZ":
        assert got.dimension_range(d) == want.dimension_range(d)
    assert got.voxel_size_um() == want.voxel_size_um()
    assert got.metadata_xml == want.metadata_xml
    assert czi.czi_setups(got) == ref_czi.czi_setups(want)
    for (t, v, c, i), truth in vols.items():
        a = got.read_view(timepoint=t, angle=v, channel=c, illumination=i)
        assert a.dtype == truth.dtype and np.array_equal(a, truth)
    with pytest.raises(KeyError):
        got.read_view(timepoint=5)


@pytest.mark.parametrize("field,value,match", [
    (34, 1, "compressed subblocks not supported"),
    (18, 7, "unsupported CZI pixel type"),
])
def test_czi_refusals_match_the_reference(tmp_path, field, value, match):
    """A compressed subblock or an unknown pixel type is refused, as the
    reference refuses it (the field's offset in a subblock segment's
    data: 16 bytes of sizes, then the DV entry)."""
    path = str(tmp_path / "bad.czi")
    czi.write_czi(path, {(0, 0, 0, 0): np.ones((2, 4, 4), np.uint16)})
    raw = bytearray(open(path, "rb").read())
    pos = raw.find(b"ZISRAWSUBBLOCK")
    while pos >= 0:
        raw[pos + 32 + field:pos + 32 + field + 4] = \
            value.to_bytes(4, "little")
        pos = raw.find(b"ZISRAWSUBBLOCK", pos + 1)
    open(path, "wb").write(bytes(raw))
    for mod in (czi, ref_czi):
        with pytest.raises(ValueError, match=match):
            mod.CziFile(path).read_view()


def test_define_czi_gives_the_reference_dataset(tmp_path):
    vols = _czi_volumes(np.uint16, n_tp=2)
    path = str(tmp_path / "acq.czi")
    czi.write_czi(path, vols, voxel_size_um=(2.0, 0.5, 0.5))
    port_ds = czi.define_dataset_czi(path)
    ref_ds = ref_czi.define_dataset_czi(path)
    assert len(port_ds.setups()) == 6
    assert any(t.name == "calibration"
               for t in port_ds.views[(0, 0)].transforms)
    _same_xml(tmp_path, ref_ds, port_ds)


# -- MicroManager ----------------------------------------------------------

def _mm_dataset(base, slices_first, frames=2, slices=4, channels=2,
                positions=2, sidecar=True):
    rng = np.random.default_rng(2)
    base.mkdir()
    summary = {"Summary": {
        "Frames": frames, "Slices": slices, "Channels": channels,
        "Positions": positions, "SlicesFirst": slices_first,
        "z-step_um": 1.5, "PixelSize_um": 0.5}}
    for pos in range(positions):
        pages = []
        for _f in range(frames):
            planes = [rng.integers(0, 4000, size=(slices, 10, 12)).astype(
                np.uint16) for _c in range(channels)]
            if slices_first:
                for c in range(channels):
                    pages.extend(planes[c])
            else:
                for s in range(slices):
                    for c in range(channels):
                        pages.append(planes[c][s])
        iio.imwrite(str(base / f"acq_MMStack_Pos{pos}.ome.tif"),
                    np.stack(pages))
    if sidecar:
        (base / "metadata.txt").write_text(json.dumps(summary))
    return str(base)


@pytest.mark.parametrize("slices_first", [False, True])
def test_define_micromanager_gives_the_reference_dataset(tmp_path,
                                                         slices_first):
    base = _mm_dataset(tmp_path / "mm", slices_first)
    port_ds = micromanager.define_dataset_micromanager(base)
    ref_ds = ref_mm.define_dataset_micromanager(base)
    assert port_ds.timepoints() == [0, 1] and len(port_ds.setups()) == 4
    assert port_ds.views[(0, 0)].voxel_size == (1.5, 0.5, 0.5)
    _same_xml(tmp_path, ref_ds, port_ds)
    mm = micromanager.MicroManagerStacks(base)
    assert (mm.frames, mm.slices, mm.channels, mm.slices_first) == (
        2, 4, 2, slices_first)


def test_micromanager_without_summary_takes_the_page_count(tmp_path):
    """No description JSON and no sidecar: one frame, one channel, the
    pages as slices; both packages read the same."""
    base = _mm_dataset(tmp_path / "mm", False, frames=1, channels=1,
                       positions=1, sidecar=False)
    assert micromanager.MicroManagerStacks(base).summary == {}
    _same_xml(tmp_path, ref_mm.define_dataset_micromanager(base),
              micromanager.define_dataset_micromanager(base))


# -- DHM -------------------------------------------------------------------

@pytest.mark.parametrize("ext", [".tif", ".npy"])
def test_define_dhm_gives_the_reference_dataset(tmp_path, ext):
    rng = np.random.default_rng(3)
    base = tmp_path / "dhm"
    for sub in ("Amplitude", "Phase"):
        (base / sub).mkdir(parents=True)
        for tp in range(3):
            img = rng.integers(0, 255, size=(9, 11)).astype(np.uint8)
            p = str(base / sub / f"frame_{tp:04d}{ext}")
            np.save(p, img) if ext == ".npy" else iio.imwrite(p, img)
    (base / "timestamps.txt").write_text("0 0.0\n1 2.5\nbad x\n2 5.0\n")
    port_ds = dhm.define_dataset_dhm(str(base))
    assert port_ds.setups() == [0, 1]
    assert port_ds.get_image((2, 1)).shape == (1, 9, 11)
    _same_xml(tmp_path, ref_dhm.define_dataset_dhm(str(base)), port_ds)
    assert dhm.read_timestamps(str(base)) == ref_dhm.read_timestamps(
        str(base)) == [0.0, 2.5, 5.0]
    assert dhm.read_timestamps(str(tmp_path)) is None


# -- attribute-pattern define ---------------------------------------------

def _write(path, vol):
    if path.endswith(".npy"):
        np.save(path, vol)
    else:
        iio.imwrite(path, vol)


@pytest.mark.parametrize("ext", [".npy", ".tif"])
@pytest.mark.parametrize("pattern,combos", [
    # {angle}/{channel} grid over two timepoints, a hole at (1, a90 c1)
    ("spim_tp{tp}_a{angle}_c{channel}", [
        dict(tp=tp, angle=a, channel=c) for tp in range(2)
        for a in (0, 90) for c in range(2) if (tp, a, c) != (1, 90, 1)]),
    # {setup} mode, a hole at (1, 1)
    ("tp{tp}_setup{setup}", [dict(tp=0, setup=0), dict(tp=0, setup=1),
                             dict(tp=1, setup=0)]),
    # illumination and tile attributes
    ("v_tp{tp}_i{illum}_t{tile}", [
        dict(tp=0, illum=0, tile=0), dict(tp=0, illum=1, tile=0),
        dict(tp=0, illum=0, tile=1), dict(tp=1, illum=1, tile=1)]),
])
def test_define_pattern_gives_the_reference_dataset(tmp_path, ext, pattern,
                                                    combos):
    rng = np.random.default_rng(4)
    base = tmp_path / "raw"
    base.mkdir()
    for combo in combos:
        _write(str(base / (pattern.format(**combo) + ext)),
               rng.random((4, 6, 8)).astype(np.float32))
    port_ds = define.define_dataset(str(base), pattern + ext)
    ref_ds = ref_define.define_dataset(str(base), pattern + ext)
    assert not all(v.present for v in port_ds.views.values())
    _same_xml(tmp_path, ref_ds, port_ds)


def test_define_npy_with_calibration_gives_the_reference_dataset(tmp_path):
    rng = np.random.default_rng(5)
    for tp in range(2):
        for s in range(3):
            np.save(str(tmp_path / f"tp{tp}_setup{s}.npy"),
                    rng.uniform(size=(8, 10, 12)).astype(np.float32))
    args = (str(tmp_path), "tp{tp}_setup{setup}.npy")
    port_ds = define.define_dataset(*args, voxel_size=(2.0, 0.5, 0.5))
    assert abs(port_ds.views[(1, 2)].model()[0, 0] - 4.0) < 1e-9
    _same_xml(tmp_path, ref_define.define_dataset(
        *args, voxel_size=(2.0, 0.5, 0.5)), port_ds)
    with pytest.raises(ValueError, match="must contain"):
        define.define_dataset(str(tmp_path), "setup{setup}.npy")
    with pytest.raises(ValueError, match="not both"):
        define.define_dataset(str(tmp_path), "tp{tp}_{setup}_{angle}.npy")
    with pytest.raises(FileNotFoundError):
        define.define_dataset(str(tmp_path), "x{tp}_a{angle}.npy")


# -- the `define` verb, both CLIs ------------------------------------------

def _raw_dirs(root):
    """One directory per `define` format, each with its files."""
    rng = np.random.default_rng(6)
    dirs = {}
    d = root / "pattern"
    d.mkdir()
    for s in range(2):
        np.save(str(d / f"tp0_setup{s}.npy"),
                rng.random((6, 8, 10)).astype(np.float32))
    dirs["pattern"] = (str(d), [])
    d = root / "czi"
    d.mkdir()
    czi.write_czi(str(d / "acq.czi"), _czi_volumes(np.uint16, n_tp=1),
                  voxel_size_um=(2.0, 0.5, 0.5))
    dirs["czi"] = (str(d), [])
    dirs["micromanager"] = (_mm_dataset(root / "mm", True), [])
    d = root / "dhm"
    for c, sub in enumerate(("Amplitude", "Phase")):
        (d / sub).mkdir(parents=True)
        for tp in range(2):
            iio.imwrite(str(d / sub / f"f{tp}.tif"),
                        rng.integers(0, 255, (9, 11)).astype(np.uint8))
    dirs["dhm"] = (str(d), ["--format", "dhm"])
    return dirs


@pytest.mark.parametrize("fmt", ["pattern", "czi", "micromanager", "dhm"])
def test_cli_define_writes_the_reference_xml(tmp_path, fmt, capsys):
    base, extra = _raw_dirs(tmp_path)[fmt]
    xml = os.path.join(base, "dataset.xml")
    assert ref_cli.main(["define", base, *extra]) == 0
    want = capsys.readouterr().out
    os.replace(xml, tmp_path / "ref.xml")
    assert cli.main(["define", base, *extra]) == 0
    assert capsys.readouterr().out == want
    assert filecmp.cmp(xml, tmp_path / "ref.xml", shallow=False)
    # the port's loader dispatch reads the defined dataset as the
    # reference's does; neither has a DHM branch, so both look for TIFF
    # stacks there and find none (ROADMAP.md section 3)
    port_ds = cli._dataset_with_loader(xml)
    ref_ds = ref_cli._dataset_with_loader(xml)
    for vid in ref_ds.views:
        if fmt == "dhm":
            for ds in (port_ds, ref_ds):
                with pytest.raises(FileNotFoundError):
                    ds.get_image(vid)
            continue
        assert np.array_equal(port_ds.get_image(vid), ref_ds.get_image(vid))


def test_detect_format_matches_the_reference(tmp_path):
    dirs = _raw_dirs(tmp_path)
    for fmt, (base, _extra) in dirs.items():
        want = "pattern" if fmt == "dhm" else fmt
        assert cli._detect_format(base, "auto") == want == \
            ref_cli._detect_format(base, "auto")
        assert cli._detect_format(base, "dhm") == "dhm"
    path = os.path.join(dirs["czi"][0], "acq.czi")
    assert cli._detect_format(path, "auto") == "czi"


def test_cli_verbs_without_optional_packages_exit_2(tmp_path, monkeypatch,
                                                    capsys):
    """Without `imageio` or `h5py` (the card's machine has neither), the
    verbs that need them exit 2 and name the package, before any compute;
    `.npy`, CZI, zarr and n5 need neither."""
    dirs = _raw_dirs(tmp_path)
    xml = os.path.join(dirs["pattern"][0], "dataset.xml")
    tif = tmp_path / "tif"
    tif.mkdir()
    iio.imwrite(str(tif / "tp0_setup0.tif"), np.zeros((2, 3, 4), np.uint8))
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v3", None)
    monkeypatch.setitem(sys.modules, "h5py", None)
    assert cli.main(["define", dirs["pattern"][0]]) == 0
    assert cli.main(["define", dirs["czi"][0]]) == 0
    assert cli.main(["resave", xml, "--format", "zarr", "--device",
                     "cpu"]) == 0
    capsys.readouterr()
    for argv, pkg in (
            (["resave", xml, "--format", "hdf5", "--device", "cpu"], "h5py"),
            (["fuse", xml, "--append-hdf5", str(tmp_path / "x.h5"),
              "--device", "cpu"], "h5py"),
            (["deconvolve", xml, "--append-hdf5", str(tmp_path / "x.h5"),
              "--device", "cpu"], "h5py"),
            (["define", str(tif), "--pattern", "tp{tp}_setup{setup}.tif"],
             "imageio"),
            (["define", dirs["micromanager"][0]], "imageio"),
            (["define", dirs["dhm"][0], "--format", "dhm"], "imageio")):
        assert cli.main(argv) == 2, argv
        assert f"`{pkg}` package, which is not installed" \
            in capsys.readouterr().err, argv
