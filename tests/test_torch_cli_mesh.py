"""The port's CLI on a device mesh (`--mesh`, `parallel.mesh_from_spec`)
against the same verbs on one device, on the CPU (`--device cpu`, where
every mesh position is the host): the reference's tests/test_cli_mesh.py
for the port, on a ragged simulated dataset (52 x 48 x 48, 3 views).

Equalities as there: DoG and DoM peak sets the same, positions within
1e-3 px; fused volumes atol 2e-6; deconvolved volumes (3 FFT iterations)
nrmse < 2e-5; registered models within 1e-5; the out-of-core
deconvolution with its blocks round the mesh nrmse < 1e-6 (the same
block updates, in another order of devices); `cluster-job`'s points and
models as without the mesh.
"""

import shutil

import numpy as np
import pytest
import torch

from spim_registration_tpu_torch.cli import main
from spim_registration_tpu_torch.core.xml_io import load_dataset
from spim_registration_tpu_torch.parallel import mesh_from_spec

torch.set_num_threads(2)

CPU = ["--device", "cpu"]


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("mesh_ds"))
    assert main(["simulate", "--out", out, "--views", "3", "--shape",
                 "52", "48", "48", "--beads", "80"]) == 0
    return out


@pytest.fixture(scope="module")
def registered(dataset, tmp_path_factory):
    """The dataset detected and registered on one device."""
    d = tmp_path_factory.mktemp("registered") / "ds"
    shutil.copytree(dataset, d)
    xml = str(d / "dataset.xml")
    assert main(["detect", xml, *CPU]) == 0
    assert main(["register", xml, *CPU]) == 0
    return xml


def _copies(dataset, tmp_path, *names):
    out = []
    for n in names:
        shutil.copytree(dataset, tmp_path / n)
        out.append(str(tmp_path / n / "dataset.xml"))
    return out


def _same_points(xml_a, xml_b, atol=1e-3):
    ds_a, ds_b = load_dataset(xml_a), load_dataset(xml_b)
    for vid in ds_a.views:
        pa = np.asarray(ds_a.views[vid].interest_points["beads"].points)
        pb = np.asarray(ds_b.views[vid].interest_points["beads"].points)
        pa, pb = pa[np.lexsort(pa.T)], pb[np.lexsort(pb.T)]
        assert pa.shape == pb.shape, (vid, pa.shape, pb.shape)
        np.testing.assert_allclose(pa, pb, atol=atol)


def _nrmse(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)) / (a.max() - a.min()))


@pytest.mark.parametrize("method", ["dog", "dom"])
def test_cli_detect_mesh_matches_single(method, dataset, tmp_path):
    single, meshed = _copies(dataset, tmp_path, "single", "mesh")
    args = (["--method", "dom", "--set=dom.threshold=0.003"]
            if method == "dom" else [])
    assert main(["detect", single, *CPU, *args]) == 0
    assert main(["detect", meshed, *CPU, "--mesh", "z=8", *args]) == 0
    _same_points(single, meshed)
    if method == "dog":   # register on the mesh-detected points
        assert main(["register", meshed, *CPU]) == 0


def test_cli_fuse_deconvolve_mesh_matches_single(registered, tmp_path):
    out = {}
    for name, mesh in (("single", []), ("mesh", ["--mesh", "z=8"])):
        f = str(tmp_path / f"fused_{name}.npy")
        assert main(["fuse", registered, "--out", f, *CPU, *mesh]) == 0
        d = str(tmp_path / f"psi_{name}.npy")
        assert main(["deconvolve", registered, "--out", d, *CPU, *mesh,
                     "--set=deconvolution.num_iterations=3"]) == 0
        out[name] = np.load(f), np.load(d)
    (fa, da), (fb, db) = out["single"], out["mesh"]
    assert fa.shape == fb.shape and da.shape == db.shape
    np.testing.assert_allclose(fa, fb, atol=2e-6)
    assert _nrmse(da, db) < 2e-5


def test_cli_deconvolve_view_axis_and_out_of_core_mesh(registered,
                                                       tmp_path, capsys):
    """`--mesh view=3,z=2` runs the views data-parallel (parallel scheme)
    against the single-device parallel scheme; `--out-of-core --mesh z=4`
    against `--out-of-core`; `fuse --out-of-core --mesh` says it stays on
    one device."""
    par = ["--set=deconvolution.num_iterations=2",
           '--set=deconvolution.scheme="parallel"']
    a, b = str(tmp_path / "a.npy"), str(tmp_path / "b.npy")
    assert main(["deconvolve", registered, "--out", a, *CPU, *par]) == 0
    assert main(["deconvolve", registered, "--out", b, *CPU, *par,
                 "--mesh", "view=3,z=2"]) == 0
    assert _nrmse(np.load(a), np.load(b)) < 2e-5
    ooc = ["--out-of-core", "--set=deconvolution.num_iterations=2"]
    c, d = str(tmp_path / "c.npy"), str(tmp_path / "d.npy")
    assert main(["deconvolve", registered, "--out", c, *CPU, *ooc]) == 0
    assert main(["deconvolve", registered, "--out", d, *CPU, *ooc,
                 "--mesh", "z=4"]) == 0
    assert _nrmse(np.load(c), np.load(d)) < 1e-6
    capsys.readouterr()
    e = str(tmp_path / "e.npy")
    assert main(["fuse", registered, "--out", e, *CPU, "--out-of-core",
                 "--mesh", "z=4"]) == 0
    assert "runs single-device" in capsys.readouterr().err


def test_register_mesh_pair_sharded_matches_single(dataset, tmp_path):
    """`register --mesh` shards the matching batch's pair axis; the port's
    slot seeds do not depend on the bucket size, so the transforms equal
    the single-device run's."""
    a, b = _copies(dataset, tmp_path, "a", "b")
    assert main(["detect", a, *CPU]) == 0
    shutil.rmtree(tmp_path / "b")
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    assert main(["register", a, *CPU]) == 0
    assert main(["register", b, *CPU, "--mesh", "z=8"]) == 0
    ds_a, ds_b = load_dataset(a), load_dataset(b)
    for vid in ds_a.views:
        np.testing.assert_allclose(ds_a.views[vid].model(),
                                   ds_b.views[vid].model(), atol=1e-5)


def test_cli_cluster_job_mesh_matches_single(dataset, tmp_path):
    a, b = _copies(dataset, tmp_path, "a", "b")
    ja, jb = str(tmp_path / "ja.xml"), str(tmp_path / "jb.xml")
    assert main(["cluster-job", a, "--tp", "0", "--out", ja, *CPU]) == 0
    assert main(["cluster-job", b, "--tp", "0", "--out", jb, *CPU,
                 "--mesh", "z=4"]) == 0
    _same_points(ja, jb)
    ds_a, ds_b = load_dataset(ja), load_dataset(jb)
    for vid in ds_a.views:
        np.testing.assert_allclose(ds_a.views[vid].model(),
                                   ds_b.views[vid].model(), atol=1e-4)


def test_mesh_from_spec(monkeypatch):
    for spec in (None, "", "none", "1"):
        assert mesh_from_spec(spec, "cpu") is None
    assert mesh_from_spec("auto", "cpu") is None   # one host
    m = mesh_from_spec("view=2,z=4", "cpu")
    assert m.shape == {"view": 2, "z": 4}
    assert all(d == torch.device("cpu") for d in m.devices.flat)
    assert mesh_from_spec(" z=8", "cpu").shape == {"z": 8}
    for bad in ("bogus", "z", "z=4,view"):
        with pytest.raises(ValueError, match="bad --mesh component"):
            mesh_from_spec(bad, "cpu")
    # on CUDA the positions are the cards: none, one, or too few
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mesh_from_spec("z=2")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert mesh_from_spec("auto") is None
    with pytest.raises(ValueError, match="mesh needs 2 devices, have 1"):
        mesh_from_spec("z=2", "cuda")
    m = mesh_from_spec("z=1", "cuda")
    assert m.shape == {"z": 1} and m.device(0) == torch.device("cuda", 0)


def test_cli_mesh_larger_than_the_cards_exits_2(dataset, tmp_path,
                                                monkeypatch, capsys):
    """A mesh of more cards than present exits 2 with the reference's
    message; the verb does not run on one device instead."""
    (xml,) = _copies(dataset, tmp_path, "a")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    for verb in ("detect", "register", "fuse", "deconvolve"):
        assert main([verb, xml, "--mesh", "z=2"]) == 2
        assert "mesh needs 2 devices, have 1" in capsys.readouterr().err
    assert main(["cluster-job", xml, "--tp", "0", "--mesh", "z=2"]) == 2
    assert "mesh needs 2 devices, have 1" in capsys.readouterr().err
    assert not load_dataset(xml).views[(0, 0)].interest_points
