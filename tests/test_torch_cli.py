"""The port's CLI path (spim_registration_tpu_torch/cli.py over
core/{dataset,xml_io,imgloaders}.py, utils/manifest.py, ops/integral.py,
detect/{dog,dom}.py, ops/resample.py, fuse/{bounding_box,weighted_avg}.py,
pipeline/config.py) against the reference's CLI on the CPU: the same
verbs on the same simulated dataset, the port's through `--device cpu`.

Tolerances: simulated volumes, truth models and XML bytes identical (both
writers are deterministic copies); DoG peak sets exact, sub-pixel
positions 1e-4 px and responses 1e-5 relative (tests/test_torch_detect.py;
the interest-point files keep 6 decimals); registered models within 1e-3
px on the bead positions (tests/test_torch_register.py, with the
reference's RANSAC draws fed to the port); fused and deconvolved volumes
(same XML, fft, 2 iterations) nrmse < 1e-5 (f32 summation order); DoM
point counts equal and positions within 0.05 px: the integral image's
f32 cumsums add in another order than XLA's, a box sum is a difference of
integral values four orders above it, and the quadratic fit on the flat
box-mean response moves a position by ~1e-2 px for such a change.
"""

import dataclasses
import filecmp
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from spim_registration_tpu import cli as ref_cli
from spim_registration_tpu.core import xml_io as ref_xml
from spim_registration_tpu.core.dataset import Dataset as RefDataset
from spim_registration_tpu.core.dataset import (
    ViewDescription as RefViewDescription,
)
from spim_registration_tpu.fuse import bounding_box as ref_bb
from spim_registration_tpu.ops import resample as ref_rs
from spim_registration_tpu.pipeline import config as ref_config
from spim_registration_tpu_torch import cli, convert
from spim_registration_tpu_torch.core import xml_io
from spim_registration_tpu_torch.core.dataset import (
    BoundingBox,
    Dataset,
    ViewDescription,
)
from spim_registration_tpu_torch.core.imgloaders import memory_loader
from spim_registration_tpu_torch.fuse import bounding_box as bb
from spim_registration_tpu_torch.match import batched
from spim_registration_tpu_torch.models import ransac
from spim_registration_tpu_torch.ops import resample as rs
from spim_registration_tpu_torch.pipeline import config

torch.set_num_threads(2)

V = 3
SIM = ["--views", str(V), "--shape", "64", "64", "64", "--beads", "110",
       "--blur", "--seed", "5"]
ROI = ["--min", "10", "10", "10", "--max", "54", "54", "54"]


def _ref_draws(n_slots, base_seed=0):
    """The reference's RANSAC uniforms for the port's batch slots (see
    tests/test_torch_register.py)."""
    keys = jax.random.split(jax.random.PRNGKey(base_seed), n_slots)
    slot = {batched._slot_seed(base_seed, k): keys[k] for k in range(n_slots)}

    def draw(seeds, shape):
        return torch.from_numpy(np.stack([np.asarray(jax.random.uniform(
            slot.get(s, jax.random.PRNGKey(s)), tuple(shape)))
            for s in seeds]))
    return draw


def _nrmse(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.sqrt(np.mean((a - b) ** 2)) / (b.max() - b.min())


def _port(*argv):
    return cli.main([*argv])


def _port_dev(*argv):
    return cli.main([*argv, "--device", "cpu"])


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """Both CLIs through simulate -> detect -> register -> define-bbox on
    their own copy of one simulated dataset; then fuse and deconvolve on
    the reference's XML with each CLI."""
    root = tmp_path_factory.mktemp("cli")
    ref, port = str(root / "ref"), str(root / "port")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SPIM_COMPILE_CACHE", "0")
        mp.setattr(ransac, "_draw_uniforms",
                   _ref_draws(batched._bucket_pairs(V * (V - 1) // 2)))
        assert ref_cli.main(["simulate", "--out", ref, *SIM]) == 0
        assert _port("simulate", "--out", port, *SIM) == 0
        xr, xp = ref + "/dataset.xml", port + "/dataset.xml"
        shutil.copy(xp, root / "simulated.xml")
        assert ref_cli.main(["detect", xr]) == 0
        assert _port_dev("detect", xp) == 0
        assert ref_cli.main(["register", xr]) == 0
        assert _port_dev("register", xp) == 0
        assert ref_cli.main(["define-bbox", xr, "roi", *ROI]) == 0
        assert ref_cli.main(["define-bbox", xr, "pts", "--from-points",
                             "beads", "--margin", "4"]) == 0
        assert _port("define-bbox", xp, "roi", *ROI) == 0
        assert _port("define-bbox", xp, "pts", "--from-points", "beads",
                     "--margin", "4") == 0
        deconv = ["--bbox", "roi", "--set", "deconvolution.num_iterations=2"]
        assert ref_cli.main(["fuse", xr, "--bbox", "pts", "--out",
                             str(root / "fused_ref.npy")]) == 0
        assert _port_dev("fuse", xr, "--bbox", "pts", "--out",
                         str(root / "fused_port.npy")) == 0
        assert ref_cli.main(["deconvolve", xr, *deconv, "--out",
                             str(root / "psi_ref.npy")]) == 0
        assert _port_dev("deconvolve", xr, *deconv, "--out",
                         str(root / "psi_port.npy")) == 0
    return {"root": root, "ref": ref, "port": port,
            "ref_ds": ref_xml.load_dataset(xr),
            "port_ds": xml_io.load_dataset(xp)}


def test_simulate_writes_the_reference_dataset(work):
    ref, port = work["ref"], work["port"]
    for s in range(V):
        for name in (f"tp0_setup{s}.npy", f"truth_tp0_setup{s}.npy"):
            a = np.load(os.path.join(ref, name))
            b = np.load(os.path.join(port, name))
            assert a.dtype == b.dtype and np.array_equal(a, b), name
    # the reference's simulate XML, byte for byte (its writer is
    # deterministic, and the port's is a copy)
    sim = work["root"] / "simulated.xml"
    ds = RefDataset(base_path=ref)
    for s in range(V):
        ds.add_view(RefViewDescription(view_id=(0, s), angle=s,
                                       size=(64, 64, 64)))
    ref_xml.save_dataset(ds, str(work["root"] / "ref_sim.xml"))
    assert filecmp.cmp(sim, work["root"] / "ref_sim.xml", shallow=False)


def test_detect_gives_the_reference_peaks(work):
    for vid, w in work["ref_ds"].views.items():
        wi = w.interest_points["beads"]
        gi = work["port_ds"].views[vid].interest_points["beads"]
        assert len(wi.points) >= 20, (vid, len(wi.points))
        assert np.array_equal(np.round(gi.points), np.round(wi.points)), vid
        np.testing.assert_allclose(gi.points, wi.points, atol=1e-4, rtol=0)
        np.testing.assert_allclose(gi.intensities, wi.intensities,
                                   rtol=1e-5, atol=1e-6)
        assert gi.parameters == wi.parameters


def test_register_gives_the_reference_models(work):
    ref = work["ref_ds"]
    for vid, w in ref.views.items():
        g = work["port_ds"].views[vid]
        assert [t.name for t in g.transforms] == ["registration"]
        pts = w.interest_points["beads"].points
        A, B = g.model(), w.model()
        np.testing.assert_allclose(pts @ A[:, :3].T + A[:, 3],
                                   pts @ B[:, :3].T + B[:, 3], atol=1e-3,
                                   rtol=0)
        truth = np.load(os.path.join(work["ref"],
                                     f"truth_tp0_setup{vid[1]}.npy"))
        err = np.abs(pts @ A[:, :3].T + A[:, 3]
                     - (pts @ truth[:, :3].T + truth[:, 3])).max()
        assert err < 0.5, (vid, err)


@pytest.mark.parametrize("name", ["roi", "pts"])
def test_define_bbox_gives_the_reference_box(work, name):
    g = work["port_ds"].bounding_boxes[name]
    w = work["ref_ds"].bounding_boxes[name]
    assert (tuple(g.min), tuple(g.max)) == (tuple(w.min), tuple(w.max))


def test_fuse_matches_the_reference(work):
    want = np.load(work["root"] / "fused_ref.npy")
    got = np.load(work["root"] / "fused_port.npy")
    assert got.shape == want.shape == work["ref_ds"].bounding_boxes[
        "pts"].shape
    assert _nrmse(got, want) < 1e-5


def test_deconvolve_matches_the_reference(work):
    want = np.load(work["root"] / "psi_ref.npy")
    got = np.load(work["root"] / "psi_port.npy")
    assert got.shape == want.shape == (44, 44, 44)
    assert np.all(np.isfinite(got))
    assert _nrmse(got, want) < 1e-5


def test_fuse_out_of_core_matches_the_reference(work, tmp_path):
    """`fuse --out-of-core` (views staged into raw stores, streaming
    fusion block by block) gives the in-memory verb's volume and the
    reference's `fuse --out-of-core` (nrmse < 1e-5)."""
    xr = os.path.join(work["ref"], "dataset.xml")
    got_p, ref_p = str(tmp_path / "f_port.npy"), str(tmp_path / "f_ref.npy")
    assert _port_dev("fuse", xr, "--bbox", "pts", "--out", got_p,
                     "--out-of-core") == 0
    assert ref_cli.main(["fuse", xr, "--bbox", "pts", "--out", ref_p,
                         "--out-of-core"]) == 0
    assert os.path.exists(got_p + ".ooc_tp0/fused.raw")
    got = np.load(got_p)
    assert _nrmse(got, np.load(work["root"] / "fused_port.npy")) < 1e-5
    assert _nrmse(got, np.load(ref_p)) < 1e-5


def test_deconvolve_out_of_core_matches_the_reference(work, tmp_path):
    """`deconvolve --out-of-core` (streamed prep, blocked runner) within
    nrmse 2e-3 of the in-memory verb (the reference test's bound: block-
    sized FFTs) and 1e-5 of the reference's `--out-of-core`; with an
    `.raw` output the psi store is the result, here at `--block-z 22`."""
    xr = os.path.join(work["ref"], "dataset.xml")
    deconv = ["--bbox", "roi", "--set", "deconvolution.num_iterations=2",
              "--out-of-core"]
    got_p, ref_p = str(tmp_path / "d_port.npy"), str(tmp_path / "d_ref.npy")
    raw_p = str(tmp_path / "d_port.raw")
    assert _port_dev("deconvolve", xr, *deconv, "--out", got_p) == 0
    assert ref_cli.main(["deconvolve", xr, *deconv, "--out", ref_p]) == 0
    assert _port_dev("deconvolve", xr, *deconv, "--out", raw_p,
                     "--block-z", "22", "--ooc-workdir",
                     str(tmp_path / "wd")) == 0
    got = np.load(got_p)
    assert got.shape == (44, 44, 44) and np.all(np.isfinite(got))
    assert _nrmse(got, np.load(work["root"] / "psi_port.npy")) < 2e-3
    assert _nrmse(got, np.load(ref_p)) < 1e-5
    raw = np.fromfile(raw_p, np.float32).reshape(44, 44, 44)
    assert _nrmse(raw, got) < 1e-5
    assert os.path.exists(tmp_path / "wd" / "prep_img0.raw")


def test_tune_prints_the_reference_table(work, capsys):
    """`tune`: the same peak-count table and suggested threshold."""
    xr = os.path.join(work["ref"], "dataset.xml")
    out = {}
    for name, run in (("ref", lambda *a: ref_cli.main([*a])),
                      ("port", _port_dev)):
        assert run("tune", xr, "--view", "0", "1",
                   "--expected-points", "30") == 0
        out[name] = capsys.readouterr().out
    assert out["port"] == out["ref"]
    assert "suggested threshold" in out["port"]


def test_icp_refine_gives_the_reference_models(work, tmp_path, capsys):
    """`icp-refine` on copies of the registered XML: the same "icp"
    transforms (1e-4) and match counts."""
    xml = {}
    for name in ("ref", "port"):
        shutil.copytree(work["ref"], tmp_path / name)
        xml[name] = str(tmp_path / name / "dataset.xml")
    assert ref_cli.main(["icp-refine", xml["ref"]]) == 0
    ref_out = capsys.readouterr().out
    assert _port_dev("icp-refine", xml["port"]) == 0
    port_out = capsys.readouterr().out

    def counts(text):
        return [ln.split(" matches")[0] for ln in text.splitlines()
                if "icp " in ln]
    assert counts(port_out) == counts(ref_out) and len(counts(port_out)) == 2
    got, want = (xml_io.load_dataset(xml["port"]),
                 ref_xml.load_dataset(xml["ref"]))
    for vid, w in want.views.items():
        g = got.views[vid]
        assert [t.name for t in g.transforms] == [t.name for t in
                                                  w.transforms]
        np.testing.assert_allclose(g.model(), w.model(), atol=1e-4, rtol=0)
    assert [t.name for t in got.views[(0, 1)].transforms] == [
        "icp", "registration"]


def test_detect_dom_gives_the_reference_points(work, tmp_path, monkeypatch):
    monkeypatch.setenv("SPIM_COMPILE_CACHE", "0")
    xr = str(tmp_path / "ref" / "dataset.xml")
    xp = str(tmp_path / "port" / "dataset.xml")
    for src, dst in ((work["ref"], xr), (work["ref"], xp)):
        os.makedirs(os.path.dirname(dst))
        for s in range(V):
            shutil.copy(os.path.join(src, f"tp0_setup{s}.npy"),
                        os.path.dirname(dst))
        shutil.copy(os.path.join(work["root"], "simulated.xml"), dst)
    dom = ["--method", "dom", "--set", "dom.threshold=0.003"]
    assert ref_cli.main(["detect", xr, *dom]) == 0
    assert _port_dev("detect", xp, *dom) == 0
    got, want = xml_io.load_dataset(xp), ref_xml.load_dataset(xr)
    for vid, w in want.views.items():
        wp = w.interest_points["beads"].points
        gp = got.views[vid].interest_points["beads"].points
        assert len(wp) >= 10 and len(gp) == len(wp), (vid, len(gp), len(wp))
        d = np.linalg.norm(gp[:, None] - wp[None], axis=-1).min(axis=1)
        assert d.max() < 0.05, (vid, d.max())
        assert "DoM" in got.views[vid].interest_points["beads"].parameters


def _rich_dataset(cls_ds, cls_vd, rng):
    """Two timepoints x two setups with transform chains, a missing view,
    voxel sizes, interest points with correspondences and boxes."""
    ds = cls_ds(base_path=".")
    for tp in (0, 3):
        for s in (0, 1):
            vd = cls_vd(view_id=(tp, s), angle=10 * s, channel=s,
                        illumination=1, tile=2, size=(20, 30, 40),
                        voxel_size=(2.0, 0.5, 0.5),
                        present=(tp, s) != (3, 1))
            vd.set_transform("calibration", np.concatenate(
                [np.diag([2.0, 1.0, 1.0]), np.zeros((3, 1))], axis=1))
            vd.set_transform("registration",
                             rng.normal(0, 0.1, (3, 4)) + np.eye(3, 4))
            ds.add_view(vd)
            ds.set_interest_points((tp, s), "beads",
                                   rng.uniform(0, 20, (7, 3)),
                                   rng.random(7), parameters="DoG s=1.8")
            ds.views[(tp, s)].interest_points["beads"].correspondences = [
                (1, (tp, 1 - s), "beads", 4), (5, (tp, 1 - s), "beads", 0)]
    return ds


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_xml_reads_across_packages(tmp_path, writer):
    rng = np.random.default_rng(7)
    if writer == "port":
        ds = _rich_dataset(Dataset, ViewDescription, rng)
        ds.bounding_boxes["b"] = BoundingBox("b", (1, 2, 3), (10, 20, 30))
        xml_io.save_dataset(ds, str(tmp_path / "d.xml"))
        back = ref_xml.load_dataset(str(tmp_path / "d.xml"))
    else:
        ds = _rich_dataset(RefDataset, RefViewDescription, rng)
        from spim_registration_tpu.core.dataset import BoundingBox as RefBB

        ds.bounding_boxes["b"] = RefBB("b", (1, 2, 3), (10, 20, 30))
        ref_xml.save_dataset(ds, str(tmp_path / "d.xml"))
        back = xml_io.load_dataset(str(tmp_path / "d.xml"))
    assert sorted(back.views) == sorted(ds.views)
    for vid, vd in ds.views.items():
        b = back.views[vid]
        for f in ("angle", "channel", "illumination", "tile", "size",
                  "voxel_size", "present"):
            assert getattr(b, f) == getattr(vd, f), (vid, f)
        assert [t.name for t in b.transforms] == [t.name
                                                  for t in vd.transforms]
        for t1, t2 in zip(b.transforms, vd.transforms):
            np.testing.assert_allclose(t1.affine, t2.affine, rtol=1e-11,
                                       atol=1e-12)
        p1, p2 = b.interest_points["beads"], vd.interest_points["beads"]
        np.testing.assert_allclose(p1.points, p2.points, atol=5e-7)
        np.testing.assert_allclose(p1.intensities, p2.intensities,
                                   atol=5e-7)
        assert p1.correspondences == p2.correspondences
        assert p1.parameters == p2.parameters
    b = back.bounding_boxes["b"]
    assert (tuple(b.min), tuple(b.max)) == ((1, 2, 3), (10, 20, 30))


def test_xml_writers_write_the_same_bytes(tmp_path):
    rng = np.random.default_rng(8)
    port = _rich_dataset(Dataset, ViewDescription, rng)
    ref = _rich_dataset(RefDataset, RefViewDescription,
                        np.random.default_rng(8))
    os.makedirs(tmp_path / "a")
    os.makedirs(tmp_path / "b")
    xml_io.save_dataset(port, str(tmp_path / "a" / "d.xml"))
    ref_xml.save_dataset(ref, str(tmp_path / "b" / "d.xml"))
    cmp = filecmp.dircmp(tmp_path / "a", tmp_path / "b")
    assert not cmp.left_only and not cmp.right_only
    assert filecmp.cmp(tmp_path / "a" / "d.xml", tmp_path / "b" / "d.xml",
                       shallow=False)
    names = os.listdir(tmp_path / "a" / "interestpoints")
    assert len(names) == 8
    for n in names:
        assert filecmp.cmp(tmp_path / "a" / "interestpoints" / n,
                           tmp_path / "b" / "interestpoints" / n,
                           shallow=False), n


def test_run_config_json_is_the_reference_text(tmp_path):
    assert config.to_json(config.RunConfig()) == ref_config.to_json(
        ref_config.RunConfig())
    ref_cfg = ref_config.apply_overrides(ref_config.RunConfig(), {
        "detection.sigma": 2.5, "pairwise.ransac.max_epsilon": 3.0,
        "fusion.blending.border": [1.0, 2.0, 3.0], "label": "x"})
    got = convert.run_config(ref_cfg)
    assert config.to_json(got) == ref_config.to_json(ref_cfg)
    assert got.fusion.blending.border == (1.0, 2.0, 3.0)
    path = str(tmp_path / "c.json")
    ref_config.to_json(ref_cfg, path)
    assert config.from_json(path) == got
    assert cli._load_config(type("A", (), {
        "config": path, "set": ["detection.threshold=0.02"]})()
    ).detection.threshold == 0.02


@pytest.mark.parametrize("key", ["detection.nope", "nope.sigma",
                                 "detection.sigma.x"])
def test_apply_overrides_rejects_unknown_keys(key):
    with pytest.raises(KeyError, match="unknown config key"):
        config.apply_overrides(config.RunConfig(), {key: 1})


def test_cli_errors_exit_2(work, tmp_path, capsys, monkeypatch):
    import sys

    from spim_registration_tpu.core import zarr_store as ref_zs

    xml = os.path.join(work["ref"], "dataset.xml")
    assert _port_dev("fuse", xml, "--bbox", "nope", "--out",
                     str(tmp_path / "f.npy")) == 2
    assert "not in dataset" in capsys.readouterr().err
    assert cli.NOT_PORTED == ()
    # `--multihost` without COORDINATOR_ADDRESS runs as one process, whose
    # errors exit 2 as any verb's; a `--mesh` the grammar refuses exits 2
    # (tests/test_torch_cli_mesh.py runs the mesh, test_torch_multihost.py
    # the processes)
    monkeypatch.delenv("COORDINATOR_ADDRESS", raising=False)
    assert _port_dev("fuse", xml, "--multihost", "--bbox", "nope", "--out",
                     str(tmp_path / "f.npy")) == 2
    assert "not in dataset" in capsys.readouterr().err
    assert _port_dev("detect", xml, "--mesh", "z") == 2
    assert "bad --mesh component" in capsys.readouterr().err
    # a dataset resaved by the reference (blosc zarr) on a machine
    # without tensorstore
    ds = tmp_path / "blosc"
    ds.mkdir()
    np.save(ds / "tp0_setup0.npy", np.ones((8, 8, 8), np.float32))
    assert _port("define", str(ds)) == 0
    ref_zs.create_volume(str(ds / "data.zarr" / "t00000" / "s00" / "0"),
                         (8, 8, 8)).write(np.ones((8, 8, 8), np.float32))
    (ds / "data.zarr" / "meta.json").write_text("{}")
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    assert _port_dev("detect", str(ds / "dataset.xml")) == 2
    err = capsys.readouterr().err
    assert "'blosc'" in err and "`tensorstore` package" in err
    assert _port_dev("detect", xml, "--set", "dom.nope=1") == 2
    assert _port("info", xml) == 0
    assert "transforms=['registration']" in capsys.readouterr().out


def test_missing_optional_packages_raise_clearly(tmp_path, monkeypatch):
    import sys

    from spim_registration_tpu_torch.core import imgloaders

    monkeypatch.setitem(sys.modules, "imageio.v3", None)
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="not installed"):
        imgloaders.save_tiff_stack(str(tmp_path / "a.tif"),
                                   np.zeros((2, 2, 2)))
    with pytest.raises(ImportError, match="not installed"):
        imgloaders.tiff_stack_loader(str(tmp_path))((0, 0))
    with pytest.raises(ImportError, match="not installed"):
        imgloaders.hdf5_loader(str(tmp_path / "d.h5"))((0, 0))


def test_tiff_round_trip(tmp_path):
    from spim_registration_tpu_torch.core import imgloaders

    vol = np.random.default_rng(0).random((3, 4, 5)).astype(np.float32)
    imgloaders.save_tiff_stack(str(tmp_path / "tp0_setup1.tif"), vol)
    back = imgloaders.tiff_stack_loader(str(tmp_path))((0, 1))
    np.testing.assert_array_equal(back, vol)


def test_detect_beads_dataset_equals_batch(work):
    """Grouping by shape and batching by `max_batch_views` gives the
    points of one `detect_beads_batch` call on the whole stack."""
    from spim_registration_tpu_torch.detect import (
        DoGParameters,
        detect_beads_batch,
        detect_beads_dataset,
    )

    vols = {(0, s): np.load(os.path.join(work["ref"], f"tp0_setup{s}.npy"))
            for s in range(V)}
    params = DoGParameters(sigma=1.6, threshold=0.01)
    want = detect_beads_batch(np.stack([vols[k] for k in sorted(vols)]),
                              params, device="cpu")
    for batch in (1, 2, 8):
        ds = Dataset(loader=memory_loader(vols))
        for vid in vols:
            ds.add_view(ViewDescription(view_id=vid, size=(64, 64, 64)))
        ds.add_view(ViewDescription(view_id=(1, 0)))    # no declared size
        vols[(1, 0)] = vols[(0, 0)][:40]
        detect_beads_dataset(ds, label="b", params=params,
                             max_batch_views=batch, device="cpu")
        for k, (pts, resp) in zip(sorted(vols)[:V], want):
            got = ds.views[k].interest_points["b"]
            np.testing.assert_array_equal(got.points, pts.astype(np.float64))
            np.testing.assert_array_equal(got.intensities, resp)
        assert len(ds.views[(1, 0)].interest_points["b"].points) > 0
        del vols[(1, 0)]


def test_bounding_boxes_match_reference():
    rng = np.random.default_rng(4)
    sizes = [(20, 30, 40), (25, 30, 35)]
    models = [np.eye(3, 4) + rng.normal(0, 0.05, (3, 4)) for _ in sizes]
    models[1][:, 3] += 3.0
    pts = rng.normal(50, 10, (40, 3)) * np.array([1.0, 2.0, 0.5])
    for name in ("maximal_bounding_box", "intersect_bounding_box"):
        g = getattr(bb, name)(sizes, models)
        w = getattr(ref_bb, name)(sizes, models)
        assert dataclasses.astuple(g) == dataclasses.astuple(w), name
    g = bb.bounding_box_from_points(pts, margin=3)
    w = ref_bb.bounding_box_from_points(pts, margin=3)
    assert dataclasses.astuple(g) == dataclasses.astuple(w)
    (gr, gb), (wr, wb) = (bb.automatic_reorientation(pts),
                          ref_bb.automatic_reorientation(pts))
    np.testing.assert_array_equal(gr, wr)
    assert dataclasses.astuple(gb) == dataclasses.astuple(wb)
    with pytest.raises(ValueError, match="overlap"):
        far = [models[0], models[0] + np.array([[0, 0, 0, 500.0]] * 3)]
        bb.intersect_bounding_box(sizes, far)


@pytest.mark.parametrize("aligned", [True, False])
def test_resample_affine_auto_matches_reference(aligned):
    rng = np.random.default_rng(5)
    vol = rng.random((20, 24, 28)).astype(np.float32)
    M = np.eye(3, 4) * np.array([[1.1], [0.9], [1.0]])
    M[:, 3] = [-1.5, 2.25, 0.5]
    if not aligned:
        M[:, :3] += rng.normal(0, 0.05, (3, 3))
    out_shape, off = (18, 22, 26), (1.0, -2.0, 0.5)
    wv, wi = ref_rs.resample_affine_auto(vol, M, out_shape, off)
    gv, gi = rs.resample_affine_auto(vol, M, out_shape, off, device="cpu")
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), atol=1e-5)


def test_fuse_dataset_matches_reference(work):
    from spim_registration_tpu.fuse.weighted_avg import (
        fuse_dataset as ref_fuse_dataset,
    )
    from spim_registration_tpu_torch.fuse import fuse_dataset

    ref_ds = ref_cli._dataset_with_loader(
        os.path.join(work["ref"], "dataset.xml"))
    port_ds = cli._dataset_with_loader(
        os.path.join(work["ref"], "dataset.xml"))
    vids = sorted(ref_ds.views)[:2]
    want = np.asarray(ref_fuse_dataset(ref_ds, vids, "roi"))
    got = fuse_dataset(port_ds, vids, "roi", device="cpu")
    assert got.shape == want.shape == (44, 44, 44)
    assert _nrmse(got, want) < 1e-5
