"""The port's chunked stores and resave (spim_registration_tpu_torch/
core/{zarr_store,resave}.py, utils/profiling.py and the CLI verbs
`resave`, `fuse --out *.zarr|*.n5`, `--append-hdf5`, `--profile`)
against the reference's on the CPU.

The port reads and writes zarr v2 and n5 itself; the reference goes
through TensorStore (blosc chunks). Each package's containers are read by
the other's code, so the formats are held byte-compatible, not only
round-trip-compatible.

Tolerances: stored arrays, pyramid levels (float32 halvings of the same
values in the same order, and the same truncating cast to uint16), HDF5
datasets, `meta.json`, n5 attributes and XML bytes exactly; streaming
fusion into port zarr volumes against the reference's `fuse_views` atol
2e-4 (as tests/test_zarr_store.py); fused volumes of the two CLIs nrmse <
1e-5 and detected points as tests/test_torch_cli.py holds them (peak
sets exact, positions 1e-4 px, responses 1e-5 relative).
"""

import filecmp
import io
import json
import logging
import os
import shutil
import sys

import h5py
import numpy as np
import pytest
import tensorstore as ts
import torch

from spim_registration_tpu import cli as ref_cli
from spim_registration_tpu.core import resave as ref_resave
from spim_registration_tpu.core import xml_io as ref_xml
from spim_registration_tpu.core import zarr_store as ref_zs
from spim_registration_tpu.core.dataset import BoundingBox as RefBoundingBox
from spim_registration_tpu.core.dataset import Dataset as RefDataset
from spim_registration_tpu.core.dataset import (
    ViewDescription as RefViewDescription,
)
from spim_registration_tpu.core.imgloaders import (
    memory_loader as ref_memory_loader,
)
from spim_registration_tpu.fuse import FusionParameters as RefFusionParams
from spim_registration_tpu.fuse import fuse_views as ref_fuse_views
from spim_registration_tpu.utils.simulation import (
    make_multiview_scene as ref_scene,
)
from spim_registration_tpu_torch import cli
from spim_registration_tpu_torch.core import resave, xml_io, zarr_store
from spim_registration_tpu_torch.core.dataset import (
    BoundingBox,
    Dataset,
    ViewDescription,
)
from spim_registration_tpu_torch.core.imgloaders import memory_loader
from spim_registration_tpu_torch.deconv import (
    DeconvolutionRunner,
    prepare_views_for_deconvolution,
)
from spim_registration_tpu_torch.fuse import FusionParameters
from spim_registration_tpu_torch.fuse.streaming import fuse_views_streaming

torch.set_num_threads(2)

ODD = (40, 36, 28)       # edge chunks and truncated n5 blocks in 16^3


@pytest.fixture(autouse=True)
def _no_compile_cache(monkeypatch):
    """The reference's CLI keeps no compilation cache in these tests."""
    monkeypatch.setenv("SPIM_COMPILE_CACHE", "0")


def _odd_volume(dtype):
    vol = np.random.default_rng(1).random(ODD) * 1000
    return vol.astype(dtype)


def _nrmse(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.sqrt(np.mean((a - b) ** 2)) / (b.max() - b.min())


# -- the stores ------------------------------------------------------------

@pytest.mark.parametrize("driver", ["zarr", "n5"])
@pytest.mark.parametrize("dtype", [np.float32, np.uint16])
def test_port_volume_opens_in_tensorstore(tmp_path, driver, dtype):
    vol = _odd_volume(dtype)
    path = str(tmp_path / "v")
    v = zarr_store.create_volume(path, ODD, dtype=dtype, chunks=(16, 16, 16),
                                 driver=driver)
    v.write(vol)
    got = ref_zs.open_volume(path, driver=driver)
    assert got.shape == ODD and got.dtype == np.dtype(dtype)
    assert np.array_equal(got.read(), vol)
    meta = json.load(open(os.path.join(
        path, ".zarray" if driver == "zarr" else "attributes.json")))
    if driver == "zarr":
        assert meta["compressor"] is None and meta["chunks"] == [16, 16, 16]
        # edge chunks are stored at full size
        assert os.path.getsize(os.path.join(path, "2.2.1")) \
            == 16 ** 3 * vol.itemsize
    else:
        assert meta["compression"] == {"type": "raw"}
        assert meta["dimensions"] == list(ODD)
        # edge blocks are truncated: header (4 + 3 x 4 bytes) + 8 x 4 x 12
        assert os.path.getsize(os.path.join(path, "2", "2", "1")) \
            == 16 + 8 * 4 * 12 * vol.itemsize


@pytest.mark.parametrize("driver", ["zarr", "n5"])
@pytest.mark.parametrize("dtype", [np.float32, np.uint16])
def test_reference_blosc_volume_reads_in_the_port(tmp_path, driver, dtype):
    vol = _odd_volume(dtype)
    path = str(tmp_path / "v")
    ref_zs.create_volume(path, ODD, dtype=dtype, chunks=(16, 16, 16),
                         driver=driver).write(vol)
    got = zarr_store.open_volume(path, driver=driver)
    assert got._codec == "blosc"
    assert got.shape == ODD and got.dtype == np.dtype(dtype)
    assert np.array_equal(got.read(), vol)
    assert np.array_equal(got.read_block((3, 17, 5), (39, 36, 20)),
                          vol[3:39, 17:36, 5:20])


@pytest.mark.parametrize("driver,compression", [
    ("zarr", {"id": "zlib", "level": 3}),
    ("zarr", {"id": "gzip", "level": 1}),
    ("n5", {"type": "gzip", "level": 1}),
    ("n5", {"type": "gzip", "level": 2, "useZlib": True}),
])
def test_stdlib_codecs_read_and_write(tmp_path, driver, compression):
    """zlib and gzip containers written by TensorStore decode with the
    standard library; blocks the port writes into them read back in
    TensorStore."""
    vol = _odd_volume(np.float32)
    path = str(tmp_path / "v")
    key = "compressor" if driver == "zarr" else "compression"
    store = ts.open({"driver": driver, "kvstore": {"driver": "file",
                                                   "path": path},
                     "metadata": {key: compression}},
                    create=True, dtype=ts.float32, shape=list(ODD),
                    chunk_layout=ts.ChunkLayout(chunk_shape=[16, 16, 16]),
                    ).result()
    store.write(vol).result()
    got = zarr_store.open_volume(path, driver=driver)
    assert got._ts is None
    assert np.array_equal(got.read(), vol)
    blk = np.full((5, 7, 9), -3.0, np.float32)
    got.write_block((13, 28, 18), blk)
    vol[13:18, 28:35, 18:27] = blk
    assert np.array_equal(store.read().result(), vol)


@pytest.mark.parametrize("driver", ["zarr", "n5"])
def test_blosc_without_tensorstore_raises(tmp_path, monkeypatch, driver):
    path = str(tmp_path / "v")
    ref_zs.create_volume(path, (8, 8, 8), driver=driver).write(
        np.ones((8, 8, 8), np.float32))
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    with pytest.raises(ImportError, match="blosc.*`tensorstore` package"):
        zarr_store.open_volume(path, driver=driver)


@pytest.mark.parametrize("driver", ["zarr", "n5"])
def test_partial_chunk_write_block(tmp_path, driver):
    """A block over parts of several chunks (edge ones included) rewrites
    only its voxels; never-written chunks read as 0."""
    path = str(tmp_path / "v")
    v = zarr_store.create_volume(path, ODD, chunks=(16, 16, 16),
                                 driver=driver)
    want = np.zeros(ODD, np.float32)
    rng = np.random.default_rng(2)
    for lo, shape in (((13, 28, 18), (5, 8, 10)), ((0, 0, 0), (3, 3, 3)),
                      ((14, 2, 1), (20, 10, 4))):
        blk = rng.random(shape).astype(np.float32)
        v.write_block(lo, blk)
        want[tuple(slice(a, a + s) for a, s in zip(lo, shape))] = blk
    assert not os.path.exists(os.path.join(
        path, "2.0.1" if driver == "zarr" else os.path.join("2", "0", "1")))
    for got in (v.read(), ref_zs.open_volume(path, driver=driver).read()):
        assert np.array_equal(got, want)
    assert np.array_equal(v[14:34, 2], want[14:34, 2])
    assert v[0, 0, 0] == want[0, 0, 0] and v[-1, -1, -1] == 0.0
    assert np.array_equal(v[..., 1::3], want[..., 1::3])
    with pytest.raises(ValueError, match="outside the volume"):
        v.write_block((30, 30, 20), np.zeros((11, 1, 1), np.float32))
    assert not [f for _r, _d, fs in os.walk(path) for f in fs
                if f.endswith(".tmp")]


def test_zarr_checkpointer_resume(tmp_path):
    """`run_checkpointed` into a `ZarrCheckpointer` every 2 iterations:
    `load_latest` gives the last segment's psi, in the port and in the
    reference's checkpointer."""
    ck = zarr_store.ZarrCheckpointer(str(tmp_path / "ckpt"),
                                     chunks=(8, 16, 16))
    assert ck.load_latest() == (0, None)
    rng = np.random.default_rng(3)
    vols = [rng.random((20, 24, 28)).astype(np.float32) + 0.1
            for _ in range(2)]
    ident = np.concatenate([np.eye(3), np.zeros((3, 1))], axis=1)
    psf = np.ones((3, 3, 3), np.float32) / 27
    bbox = BoundingBox("b", (0, 0, 0), (20, 24, 28))
    prep = prepare_views_for_deconvolution(vols, [ident] * 2, [psf] * 2,
                                           bbox, device="cpu")
    psi = DeconvolutionRunner(prep, device="cpu").run_checkpointed(
        2, ck.save, num_iterations=5).numpy()
    it, restored = ck.load_latest()
    assert it == 5 and np.array_equal(restored, psi)
    it, restored = ref_zs.ZarrCheckpointer(str(tmp_path / "ckpt")
                                           ).load_latest()
    assert it == 5 and np.array_equal(restored, psi)


def test_streaming_fusion_into_port_zarr(tmp_path):
    """Streaming fusion reads and writes port zarr volumes through the
    RawVolumeStore interface and gives the reference's in-memory fusion."""
    scene = ref_scene(np.random.default_rng(42), n_views=2,
                      shape=(48, 48, 48), n_beads=20, noise=0.0)
    ref = ref_fuse_views(scene.volumes, scene.models,
                         RefBoundingBox("b", (8, 8, 8), (40, 40, 40)),
                         RefFusionParams())
    stores = []
    for i, vol in enumerate(scene.volumes):
        st = zarr_store.create_volume(str(tmp_path / f"v{i}"), vol.shape,
                                      chunks=(16, 16, 16))
        st.write(vol)
        stores.append(st)
    bbox = BoundingBox("b", (8, 8, 8), (40, 40, 40))
    out = zarr_store.create_volume(str(tmp_path / "fused"), bbox.shape,
                                   chunks=(12, 16, 16))
    fuse_views_streaming(stores, scene.models, bbox, out, FusionParameters(),
                         block=(16, 32, 32), device="cpu")
    np.testing.assert_allclose(out.read(), ref, atol=2e-4)


# -- resave, the two packages on one dataset --------------------------------

def _datasets(shape=(64, 64, 64), n_setup=2, tps=(0,)):
    rng = np.random.default_rng(4)
    vols = {(tp, s): (rng.random(shape) * 100).astype(np.float32)
            for tp in tps for s in range(n_setup)}
    out = []
    for D, V, load in ((Dataset, ViewDescription, memory_loader),
                       (RefDataset, RefViewDescription, ref_memory_loader)):
        ds = D(base_path=".", loader=load(vols))
        for vid in sorted(vols):
            ds.add_view(V(view_id=vid, angle=vid[1] * 45, size=shape))
        out.append(ds)
    return out[0], out[1], vols


def _tree(path):
    return sorted(os.path.relpath(os.path.join(r, f), path)
                  for r, _d, fs in os.walk(path) for f in fs)


@pytest.mark.parametrize("shape", [(64, 64, 64), (33, 70, 64)])
def test_resave_zarr_matches_reference(tmp_path, shape):
    port_ds, ref_ds, vols = _datasets(shape, tps=(0, 1))
    zarr_store.resave_zarr(port_ds, str(tmp_path / "p"), device="cpu")
    ref_zs.resave_zarr(ref_ds, str(tmp_path / "r"))
    assert filecmp.cmp(tmp_path / "p" / "meta.json",
                       tmp_path / "r" / "meta.json", shallow=False)
    meta = json.load(open(tmp_path / "p" / "meta.json"))
    n_levels = len(meta["setups"]["0"]["resolutions"])
    assert n_levels == (2 if shape == (64, 64, 64) else 1)
    for vid in vols:
        for li in range(n_levels):
            a = zarr_store.zarr_loader(str(tmp_path / "p"), li)(vid)
            b = ref_zs.zarr_loader(str(tmp_path / "r"), li)(vid)
            assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)
            # and across: each package reads the other's tree
            assert np.array_equal(
                ref_zs.zarr_loader(str(tmp_path / "p"), li)(vid), a)
            assert np.array_equal(
                zarr_store.zarr_loader(str(tmp_path / "r"), li)(vid), b)
        assert np.array_equal(port_ds.get_image(vid), vols[vid])


@pytest.mark.parametrize("dtype", [np.uint16, np.float32])
def test_resave_n5_bdv_matches_reference(tmp_path, dtype):
    port_ds, ref_ds, vols = _datasets((64, 64, 96))
    zarr_store.resave_n5_bdv(port_ds, str(tmp_path / "p"), dtype=dtype,
                             device="cpu")
    ref_zs.resave_n5_bdv(ref_ds, str(tmp_path / "r"), dtype=dtype)
    for rel in ("attributes.json", "setup0/attributes.json",
                "setup1/attributes.json"):
        assert json.load(open(tmp_path / "p" / rel)) \
            == json.load(open(tmp_path / "r" / rel))
    for vid in vols:
        for li in range(2):
            rel = f"setup{vid[1]}/timepoint{vid[0]}/s{li}"
            pa = json.load(open(tmp_path / "p" / rel / "attributes.json"))
            ra = json.load(open(tmp_path / "r" / rel / "attributes.json"))
            assert pa.pop("compression") == {"type": "raw"}
            assert ra.pop("compression")["type"] == "blosc"
            assert pa == ra
            a = zarr_store.open_volume(str(tmp_path / "p" / rel), "n5")
            b = ref_zs.open_volume(str(tmp_path / "r" / rel), "n5")
            assert a.dtype == b.dtype == np.dtype(dtype)
            assert np.array_equal(a.read(), b.read())
            assert np.array_equal(
                ref_zs.open_volume(str(tmp_path / "p" / rel), "n5").read(),
                b.read())
        assert np.array_equal(
            zarr_store.n5_bdv_loader(str(tmp_path / "p"))(vid),
            ref_zs.n5_bdv_loader(str(tmp_path / "r"))(vid))


def _h5_items(path):
    out = {}
    with h5py.File(path, "r") as f:
        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                out[name] = (obj[()], obj.chunks, obj.compression,
                             obj.compression_opts, obj.dtype)
        f.visititems(visit)
    return out


def test_resave_hdf5_matches_reference(tmp_path):
    port_ds, ref_ds, vols = _datasets((64, 64, 64), tps=(0, 1))
    resave.resave_hdf5(port_ds, str(tmp_path / "p.h5"), device="cpu")
    ref_resave.resave_hdf5(ref_ds, str(tmp_path / "r.h5"))
    got, want = _h5_items(tmp_path / "p.h5"), _h5_items(tmp_path / "r.h5")
    assert sorted(got) == sorted(want)
    assert "s01/resolutions" in got and "t00001/s01/1/cells" in got
    for k, (arr, *attrs) in want.items():
        assert got[k][1:] == tuple(attrs), k
        assert np.array_equal(got[k][0], arr), k
    for vid in vols:
        assert np.array_equal(port_ds.get_image(vid), vols[vid])


def test_append_fused_hdf5_matches_reference(tmp_path):
    port_ds, ref_ds, vols = _datasets((64, 64, 64))
    resave.resave_hdf5(port_ds, str(tmp_path / "p.h5"), device="cpu")
    ref_resave.resave_hdf5(ref_ds, str(tmp_path / "r.h5"))
    fused = np.random.default_rng(5).random((64, 40, 36)).astype(np.float32)
    vid = resave.append_fused_hdf5(
        port_ds, str(tmp_path / "p.h5"), fused, timepoint=0,
        bbox=BoundingBox("f", (4, 8, 8), (68, 48, 44)),
        xml_path=str(tmp_path / "p.xml"), device="cpu")
    ref_vid = ref_resave.append_fused_hdf5(
        ref_ds, str(tmp_path / "r.h5"), fused, timepoint=0,
        bbox=RefBoundingBox("f", (4, 8, 8), (68, 48, 44)),
        xml_path=str(tmp_path / "r.xml"))
    assert vid == ref_vid == (0, 2)
    assert filecmp.cmp(tmp_path / "p.xml", tmp_path / "r.xml", shallow=False)
    got, want = _h5_items(tmp_path / "p.h5"), _h5_items(tmp_path / "r.h5")
    assert sorted(got) == sorted(want)
    for k, (arr, *attrs) in want.items():
        assert got[k][1:] == tuple(attrs) and np.array_equal(got[k][0], arr)
    assert np.array_equal(port_ds.get_image(vid), fused)
    assert np.array_equal(port_ds.get_image((0, 1)), vols[(0, 1)])


# -- the verbs, both CLIs -----------------------------------------------------

SIM = ["--views", "2", "--shape", "64", "64", "64", "--beads", "60",
       "--blur", "--seed", "3"]


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    """A simulated dataset's `.npy` views, without its XML."""
    root = tmp_path_factory.mktemp("raw")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SPIM_COMPILE_CACHE", "0")
        assert cli.main(["simulate", "--out", str(root), *SIM]) == 0
    os.remove(root / "dataset.xml")
    return root


def _copy_raw(raw, dst):
    dst.mkdir()
    for f in os.listdir(raw):
        if f.startswith("tp"):
            shutil.copy(raw / f, dst / f)
    return str(dst / "dataset.xml")


@pytest.mark.parametrize("fmt", ["zarr", "n5", "hdf5"])
def test_cli_define_resave_detect_matches_reference(raw, tmp_path, fmt):
    xp = _copy_raw(raw, tmp_path / "port")
    xr = _copy_raw(raw, tmp_path / "ref")
    assert cli.main(["define", str(tmp_path / "port")]) == 0
    assert ref_cli.main(["define", str(tmp_path / "ref")]) == 0
    assert cli.main(["resave", xp, "--format", fmt, "--device", "cpu"]) == 0
    assert ref_cli.main(["resave", xr, "--format", fmt]) == 0
    assert filecmp.cmp(xp, xr, shallow=False)
    out = {"zarr": "data.zarr", "n5": "data.n5", "hdf5": "data.h5"}[fmt]
    if fmt == "hdf5":
        got, want = (_h5_items(tmp_path / d / out) for d in ("port", "ref"))
        assert sorted(got) == sorted(want)
        for k, (arr, *_attrs) in want.items():
            assert np.array_equal(got[k][0], arr), k
    else:
        assert _tree(tmp_path / "port" / out) == _tree(tmp_path / "ref" / out)
    # the port's loader dispatch picks the new container, as the
    # reference's does, and both read the same views
    port_ds = cli._dataset_with_loader(xp)
    ref_ds = ref_cli._dataset_with_loader(xr)
    for vid in ref_ds.views:
        assert np.array_equal(port_ds.get_image(vid), ref_ds.get_image(vid))
    assert cli.main(["detect", xp, "--device", "cpu"]) == 0
    assert ref_cli.main(["detect", xr]) == 0
    got, want = xml_io.load_dataset(xp), ref_xml.load_dataset(xr)
    for vid, w in want.views.items():
        wi = w.interest_points["beads"]
        gi = got.views[vid].interest_points["beads"]
        assert len(wi.points) >= 20
        assert np.array_equal(np.round(gi.points), np.round(wi.points))
        np.testing.assert_allclose(gi.points, wi.points, atol=1e-4, rtol=0)
        np.testing.assert_allclose(gi.intensities, wi.intensities,
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("suffix", [".zarr", ".n5"])
def test_cli_fuse_exports_chunked_volumes(raw, tmp_path, suffix):
    xml = _copy_raw(raw, tmp_path / "ds")
    assert cli.main(["define", str(tmp_path / "ds")]) == 0
    p, r = str(tmp_path / f"port{suffix}"), str(tmp_path / f"ref{suffix}")
    assert cli.main(["fuse", xml, "--out", p, "--device", "cpu"]) == 0
    assert ref_cli.main(["fuse", xml, "--out", r]) == 0
    driver = suffix[1:]
    got = zarr_store.open_volume(p, driver)
    want = ref_zs.open_volume(r, driver).read()
    assert got.dtype == np.float32 and got.shape == want.shape
    assert got.chunks == tuple(json.load(open(os.path.join(
        r, ".zarray" if driver == "zarr" else "attributes.json")))[
            "chunks" if driver == "zarr" else "blockSize"])
    assert _nrmse(got.read(), want) < 1e-5
    assert np.array_equal(ref_zs.open_volume(p, driver).read(), got.read())
    assert np.array_equal(zarr_store.open_volume(r, driver).read(), want)


def test_cli_append_hdf5_matches_reference(raw, tmp_path):
    xp = _copy_raw(raw, tmp_path / "port")
    xr = _copy_raw(raw, tmp_path / "ref")
    for main, xml, dev in ((cli.main, xp, ["--device", "cpu"]),
                           (ref_cli.main, xr, [])):
        assert main(["define", os.path.dirname(xml)]) == 0
        assert main(["resave", xml, "--levels", "1", *dev]) == 0
        assert main(["fuse", xml, "--append-hdf5",
                     os.path.join(os.path.dirname(xml), "data.h5"),
                     *dev]) == 0
    assert filecmp.cmp(xp, xr, shallow=False)
    got = cli._dataset_with_loader(xp).get_image((0, 2))
    want = ref_cli._dataset_with_loader(xr).get_image((0, 2))
    assert got.shape == want.shape and _nrmse(got, want) < 1e-5


def test_cli_profile_writes_a_trace(raw, tmp_path):
    xml = _copy_raw(raw, tmp_path / "ds")
    assert cli.main(["define", str(tmp_path / "ds")]) == 0
    prof = tmp_path / "prof"
    out = io.StringIO()
    handler = logging.StreamHandler(out)
    log = logging.getLogger("spim.profile")
    log.addHandler(handler)
    try:
        assert cli.main(["detect", xml, "--device", "cpu", "--profile",
                         str(prof)]) == 0
    finally:
        log.removeHandler(handler)
    (trace,) = os.listdir(prof)
    assert trace.endswith(".pt.trace.json")
    events = json.load(open(prof / trace))["traceEvents"]
    assert any("conv" in e.get("name", "") or "matmul" in e.get("name", "")
               for e in events)
    # the trace's exit logs each span recorded inside it
    assert "span spim/detect: 1, " in out.getvalue()
