"""The port's timelapse stabilization, cluster jobs and dataset tools
(spim_registration_tpu_torch/pipeline/{timelapse,cluster,tools}.py and the
verbs `cluster-job` / `cluster-merge`) against the reference on the CPU,
on the same seeded numpy inputs.

Tolerances: `register_timeseries` stabilization matrices and final models
within 1e-4, candidate and inlier counts and validity exact, mean and max
errors within 1e-4 relative (the reference's RANSAC draws fed to the port,
tests/test_torch_register.py); `_dedupe`, `thin_out_detections` and
every other host tool exact (the same numpy arithmetic); `display_view`
within 1e-5 (f32 resampling); job and merged XMLs byte for byte where
their contents are host numpy, and the CLI's registered models within
1e-3 px on the bead positions (tests/test_torch_cli.py).
"""

import filecmp
import os
import shutil

import numpy as np
import pytest
import torch

from spim_registration_tpu import cli as ref_cli
from spim_registration_tpu.core import dataset as ref_dataset
from spim_registration_tpu.core import imgloaders as ref_loaders
from spim_registration_tpu.core import xml_io as ref_xml
from spim_registration_tpu.detect import DoGParameters as RefDoG
from spim_registration_tpu.match import PairwiseParameters as RefPW
from spim_registration_tpu.pipeline import RegistrationConfig as RefConfig
from spim_registration_tpu.pipeline import cluster as ref_cluster
from spim_registration_tpu.pipeline import timelapse as ref_timelapse
from spim_registration_tpu.pipeline import tools as ref_tools
from spim_registration_tpu_torch import cli, convert
from spim_registration_tpu_torch.core import dataset
from spim_registration_tpu_torch.core import imgloaders
from spim_registration_tpu_torch.core import xml_io
from spim_registration_tpu_torch.match import batched
from spim_registration_tpu_torch.models import ransac
from spim_registration_tpu_torch.pipeline import cluster, timelapse, tools
from spim_registration_tpu_torch.utils.simulation import (
    make_multiview_scene,
    render_beads,
    rotation_about_axis,
)
from tests.test_torch_register import _ref_draws_by_seed

torch.set_num_threads(2)

SHAPE = (64, 64, 64)


@pytest.fixture(scope="module")
def series():
    """3 timepoints x 2 views at 64^3: timepoint 0 is the scene, each
    later one the whole sample drifted by a seeded +-3 px translation and
    re-rendered (tests/test_timelapse_cluster.py, its 110 beads at
    64^3)."""
    rng = np.random.default_rng(21)
    base = make_multiview_scene(rng, n_views=2, shape=SHAPE, n_beads=110,
                                max_perturb_deg=4.0, noise=0.003)
    vols = {0: base.volumes}
    drifts = {0: np.zeros(3)}
    for tp in (1, 2):
        drifts[tp] = rng.uniform(-3, 3, 3)
        vols[tp] = [render_beads(base.view_points[v] - drifts[tp], SHAPE,
                                 1.7)
                    + rng.normal(0, 0.003, SHAPE).astype(np.float32)
                    for v in range(2)]
    return vols, drifts


@pytest.mark.parametrize("reference_tp,stabilize", [
    (None, True), (0, True), (None, False)])
def test_register_timeseries_matches_reference(series, reference_tp,
                                               stabilize, monkeypatch):
    vols, drifts = series
    ref_cfg = RefConfig(detection=RefDoG(sigma=1.8, threshold=0.008),
                        pairwise=RefPW(model="affine", max_points=256))
    want = ref_timelapse.register_timeseries(
        vols, ref_cfg, reference_tp=reference_tp, stabilize=stabilize)
    # 2 views: one `match_pair` a timepoint (seed 1), stabilization seeds
    # 1000 + tp, RGLDM retries 8: all plain PRNGKey(seed) draws
    monkeypatch.setattr(ransac, "_draw_uniforms", _ref_draws_by_seed(1))
    got = timelapse.register_timeseries(
        vols, convert.registration_config(ref_cfg),
        reference_tp=reference_tp, stabilize=stabilize, device="cpu")

    # RANSAC samples its hypotheses from the first num_candidates padded
    # rows, valid or not (both packages; ROADMAP.md section 3); with fewer
    # than an affine sample's 5 valid rows there, every hypothesis is a
    # singular fit whose float32 rounding picks the winner, and no two
    # implementations agree. Every pair of this scene has enough.
    for tp, res in got.per_timepoint.items():
        for pair, r in res.pair_results.items():
            window = int(np.sum(r.candidates[:, 0] < r.num_candidates))
            assert window >= 5, (tp, pair, window)
    assert sorted(got.stabilization) == sorted(want.stabilization)
    for tp, S in want.stabilization.items():
        np.testing.assert_allclose(got.stabilization[tp], S, atol=1e-4,
                                   rtol=0)
    assert sorted(got.models) == sorted(want.models)
    for key, A in want.models.items():
        np.testing.assert_allclose(got.models[key], A, atol=1e-4, rtol=0)
    assert len(got.statistics) == len(want.statistics)
    for g, w in zip(got.statistics, want.statistics):
        assert (g.timepoint, g.num_candidates, g.num_inliers, g.valid) == (
            w.timepoint, w.num_candidates, w.num_inliers, w.valid)
        np.testing.assert_allclose([g.mean_error, g.max_error],
                                   [w.mean_error, w.max_error], rtol=1e-4,
                                   atol=0)
    if not stabilize:
        assert not got.statistics
        return
    ref_tp = 1 if reference_tp is None else reference_tp
    # the truth: S maps timepoint tp's frame onto the reference's
    for tp in (0, 1, 2):
        st = [s for s in got.statistics if s.timepoint == tp][0]
        np.testing.assert_allclose(got.stabilization[tp][:, 3],
                                   drifts[tp] - drifts[ref_tp], atol=0.3)
        assert st.valid and (tp == ref_tp or st.mean_error < 0.5)


def _planted_pool(seed, min_distance, n=300):
    """Random points over negative and positive coordinates, with planted
    duplicates: copies at a tenth of min_distance, at exactly
    min_distance (kept: the test is strict), and points on cell edges."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-20, 20, (n, 3))
    near = pts[:60] + rng.normal(0, 1, (60, 3)) / np.sqrt(3) \
        * 0.1 * min_distance
    unit = rng.normal(0, 1, (40, 3))
    unit /= np.linalg.norm(unit, axis=1, keepdims=True)
    exact = pts[60:100] + unit * min_distance
    edge = np.round(rng.uniform(-10, 10, (40, 3))) * min_distance
    edge_dup = edge + np.array([0.0, 0.0, -0.5]) * min_distance
    out = np.concatenate([pts, near, exact, edge, edge_dup])
    return out[rng.permutation(len(out))]


@pytest.mark.parametrize("seed,min_distance", [(0, 1.0), (1, 1.5),
                                               (2, 0.7)])
def test_dedupe_keeps_the_reference_points(seed, min_distance):
    pool = _planted_pool(seed, min_distance)
    want = ref_timelapse._dedupe(pool, min_distance)
    got = timelapse._dedupe(pool, min_distance)
    assert len(want) < len(pool)
    np.testing.assert_array_equal(got, want)
    assert len(timelapse._dedupe(pool[:0], min_distance)) == 0


def _mini_datasets(tmp_path, n_tp=2, n_views=2):
    """The same 48^3 mini dataset in both packages' models, each with its
    own base directory."""
    scene = make_multiview_scene(np.random.default_rng(3), n_views=n_views,
                                 shape=(48, 48, 48), n_beads=30,
                                 noise=0.003)
    vols = {(tp, s): scene.volumes[s] for tp in range(n_tp)
            for s in range(n_views)}
    out = {}
    for name, mod, loaders in (("ref", ref_dataset, ref_loaders),
                               ("port", dataset, imgloaders)):
        ds = mod.Dataset(base_path=str(tmp_path / name))
        for tp, s in vols:
            ds.add_view(mod.ViewDescription(view_id=(tp, s),
                                            size=(48, 48, 48), angle=s))
        ds.loader = loaders.memory_loader(vols)
        out[name] = ds
    return out, vols


def _stand_in_process(dataset_, tp):
    """A per-timepoint stage stand-in: a transform and seeded detections
    per view, and on timepoint 1 a view the master lacks."""
    rng = np.random.default_rng(100 + tp)
    for s in range(2):
        dataset_.views[(tp, s)].set_transform(
            "registration", np.concatenate(
                [np.eye(3), np.full((3, 1), float(tp + s))], axis=1))
        dataset_.set_interest_points((tp, s), "beads",
                                     rng.uniform(0, 48, (5, 3)),
                                     rng.uniform(0, 1, 5), parameters="p")
    if tp == 1:
        vd = type(dataset_.views[(tp, 0)])(view_id=(tp, 7), angle=7,
                                           size=(48, 48, 48))
        dataset_.add_view(vd)
        dataset_.set_interest_points((tp, 7), "beads",
                                     rng.uniform(0, 48, (3, 3)))


def test_cluster_round_trip_is_the_reference_xml(tmp_path):
    """split_timepoints -> run_job per timepoint -> find_job_xmls ->
    merge_cluster_jobs in both packages: job XMLs, the merged master and
    the interest point files byte for byte, the master's `~1` backup, and
    the view only a job had."""
    dss, _ = _mini_datasets(tmp_path)
    xml, jobs = {}, {}
    for name, io_, cl in (("ref", ref_xml, ref_cluster),
                          ("port", xml_io, cluster)):
        ds = dss[name]
        xml[name] = os.path.join(ds.base_path, "master.xml")
        io_.save_dataset(ds, xml[name])
        jobs[name] = [cl.run_job(xml[name], tp, _stand_in_process)
                      for tp in cl.split_timepoints(ds)]
        assert cl.find_job_xmls(ds.base_path) == sorted(jobs[name])
        assert jobs[name][0] == cl.job_xml_path(ds.base_path, 0)
    assert [os.path.basename(j) for j in jobs["port"]] == [
        os.path.basename(j) for j in jobs["ref"]]
    for a, b in zip(jobs["port"], jobs["ref"]):
        assert filecmp.cmp(a, b, shallow=False), a

    want = ref_cluster.merge_cluster_jobs(xml["ref"], jobs["ref"])
    got = cluster.merge_cluster_jobs(xml["port"], jobs["port"])
    assert filecmp.cmp(xml["port"], xml["ref"], shallow=False)
    assert filecmp.cmp(xml["port"] + "~1", xml["ref"] + "~1",
                       shallow=False)
    ip = os.path.join(dss["port"].base_path, "interestpoints")
    names = sorted(os.listdir(ip))
    assert names == sorted(os.listdir(os.path.join(dss["ref"].base_path,
                                                   "interestpoints")))
    for f in names:
        assert filecmp.cmp(os.path.join(ip, f), os.path.join(
            dss["ref"].base_path, "interestpoints", f), shallow=False), f
    assert sorted(got.views) == sorted(want.views)
    assert (1, 7) in got.views and (1, 7) not in dss["port"].views
    for tp in range(2):
        for s in range(2):
            np.testing.assert_array_equal(got.views[(tp, s)].model(),
                                          want.views[(tp, s)].model())
            np.testing.assert_allclose(got.views[(tp, s)].model()[:, 3],
                                       [tp + s] * 3)


def test_cluster_merge_into_another_file_keeps_the_master(tmp_path):
    """`out_xml`: the merge goes to a new file, the master is untouched,
    and the bounding boxes of the jobs join the merged dataset."""
    dss, _ = _mini_datasets(tmp_path, n_tp=1)
    out = {}
    for name, mod, io_, cl in (("ref", ref_dataset, ref_xml, ref_cluster),
                               ("port", dataset, xml_io, cluster)):
        ds = dss[name]
        ds.bounding_boxes["roi"] = mod.BoundingBox("roi", (1, 2, 3),
                                                   (40, 41, 42))
        master = os.path.join(ds.base_path, "master.xml")
        io_.save_dataset(ds, master)
        before = open(master).read()
        job = cl.run_job(master, 0, _stand_in_process,
                         out_xml=os.path.join(ds.base_path, "j.xml"))
        out[name] = os.path.join(ds.base_path, "merged.xml")
        merged = cl.merge_cluster_jobs(master, [job], out_xml=out[name])
        assert open(master).read() == before
        assert not os.path.exists(master + "~1")
        assert merged.bounding_boxes["roi"].shape == (39, 39, 39)
    assert filecmp.cmp(out["port"], out["ref"], shallow=False)


def _tool_case(name, dss, vols):
    """Run one tool family on a dataset of each package; returns what to
    compare, per package."""
    res = {}
    A = np.concatenate([rotation_about_axis(1, 20.0), np.ones((3, 1))],
                       axis=1)
    pts = np.array([[10.0, 10, 10], [10, 10, 11], [30, 30, 30],
                    [30, 31, 30], [5, 40, 7], [5.5, 40, 7],
                    [20, 20, 20]])
    for pkg, mod in (("ref", ref_tools), ("port", tools)):
        ds = dss[pkg]
        if name == "apply_transformation":
            mod.apply_transformation(ds, [(0, 0), (0, 1)], A, name="shift")
            mod.apply_transformation(ds, [(0, 0)], 2 * A, name="shift")
            mod.apply_transformation(ds, [(0, 1)], 3 * A, name="shift",
                                     replace=True)
            res[pkg] = [[(t.name, t.affine) for t in ds.views[v].transforms]
                        for v in ((0, 0), (0, 1))]
        elif name == "duplicate_transformation":
            ds.views[(0, 0)].set_transform("a", A)
            ds.views[(0, 0)].set_transform("b", 2 * A)
            mod.duplicate_transformation(ds, (0, 0), [(0, 1)])
            ds.views[(0, 0)].transforms[0].affine[0, 0] = 9.0
            res[pkg] = [(t.name, t.affine) for t in ds.views[(0, 1)].transforms]
        elif name == "specify_calibration":
            ds.views[(0, 0)].set_transform("shift", A)
            mod.specify_calibration(ds, (2.0, 0.5, 0.5))
            mod.specify_calibration(ds, (3.0, 1.0, 1.5), view_ids=[(0, 1)])
            res[pkg] = [([(t.name, t.affine) for t in ds.views[v].transforms],
                         ds.views[v].voxel_size, ds.views[v].model())
                        for v in ((0, 0), (0, 1))]
        elif name.startswith("thin_out_detections"):
            inten = {"ties": np.array([1.0, 1.0, 2.0, 2.0, 0.5, -0.5, 1.0]),
                     "none": None}[name.split("-")[1]]
            ds.set_interest_points((0, 0), "beads", pts, inten,
                                   parameters="DoG")
            mod.thin_out_detections(ds, [(0, 0)], "beads", 2.0,
                                    new_label="thin")
            ips = ds.views[(0, 0)].interest_points["thin"]
            res[pkg] = (ips.points, ips.intensities, ips.parameters,
                        len(ds.views[(0, 0)].interest_points["beads"].points))
        elif name == "remove_detections":
            ds.set_interest_points((0, 0), "beads", pts)
            ds.set_interest_points((0, 1), "beads", pts)
            ds.set_interest_points((0, 1), "other", pts)
            mod.remove_detections(ds, [(0, 0), (0, 1)], "beads")
            mod.remove_detections(ds, [(0, 0)], "missing")
            res[pkg] = [sorted(ds.views[v].interest_points)
                        for v in ((0, 0), (0, 1))]
        elif name == "visualize_detections":
            ds.set_interest_points((0, 0), "beads", pts)
            res[pkg] = (mod.visualize_detections(ds, (0, 0), "beads"),
                        mod.visualize_detections(ds, (0, 0), "beads",
                                                 sigma=2.0,
                                                 shape=(32, 48, 40)))
        elif name.startswith("display_view"):
            M = A if name.endswith("rotated") else np.concatenate(
                [np.diag([2.0, 1.0, 1.0]), np.array([[3.0], [-2], [1]])],
                axis=1)
            ds.views[(0, 0)].set_transform("m", M)
            kw = {} if pkg == "ref" else {"device": "cpu"}
            res[pkg] = (np.asarray(mod.display_view(ds, (0, 0), **kw)),
                        np.asarray(mod.display_view(
                            ds, (0, 0), out_shape=(40, 30, 50),
                            out_offset=(-4.0, 2.5, 1.0), **kw)))
        elif name == "max_project":
            res[pkg] = [mod.max_project(vols[(0, 0)], axis=a)
                        for a in (0, 1, 2)]
    return res


def _assert_equal(got, want):
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_equal(g, w)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", [
    "apply_transformation", "duplicate_transformation",
    "specify_calibration", "thin_out_detections-ties",
    "thin_out_detections-none", "remove_detections",
    "visualize_detections", "display_view-rotated", "display_view-scaled",
    "max_project"])
def test_tools_match_reference(tmp_path, name):
    dss, vols = _mini_datasets(tmp_path, n_tp=1)
    res = _tool_case(name, dss, vols)
    if name == "visualize_detections":
        for g, w in zip(res["port"], res["ref"]):
            np.testing.assert_allclose(g, w, atol=1e-6, rtol=0)
            assert g.max() > 0.5
    elif name.startswith("display_view"):
        for g, w in zip(res["port"], res["ref"]):
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)
            assert w.max() > 0.3
    else:
        _assert_equal(res["port"], res["ref"])
    if name.startswith("thin_out"):
        # 7 points, three pairs within 2 px of each other
        assert len(res["port"][0]) == 4 and res["port"][3] == 7


def test_display_view_refuses_a_missing_loader():
    ds = dataset.Dataset()
    ds.add_view(dataset.ViewDescription(view_id=(0, 0), size=(4, 4, 4)))
    with pytest.raises(RuntimeError, match="no image loader"):
        tools.display_view(ds, (0, 0), device="cpu")
    ds.views[(0, 0)].size = None
    ds.set_interest_points((0, 0), "b", np.zeros((1, 3)))
    with pytest.raises(ValueError, match="no size"):
        tools.visualize_detections(ds, (0, 0), "b")


@pytest.fixture(scope="module")
def simulated(tmp_path_factory):
    """One simulated 3-view 64^3 dataset (the port's `simulate`, which
    writes the reference's bytes: tests/test_torch_cli.py)."""
    root = tmp_path_factory.mktemp("cluster_cli")
    src = str(root / "sim")
    assert cli.main(["simulate", "--out", src, "--views", "3", "--shape",
                     "64", "64", "64", "--beads", "110", "--blur",
                     "--seed", "5"]) == 0
    return root, src


@pytest.mark.parametrize("stages", ["detect", "detect,register"])
def test_cluster_verbs_match_reference(simulated, stages, monkeypatch):
    """`cluster-job XML --tp 0 --out JOB` then `cluster-merge XML JOB`
    through both CLIs on copies of one dataset (the port's on the CPU).
    Detection alone writes the reference's job and merged XMLs byte for
    byte; with registration the models agree within 1e-3 px."""
    root, src = simulated
    tag = stages.replace(",", "_")
    dirs = {k: str(root / f"{k}_{tag}") for k in ("ref", "port")}
    for d in dirs.values():
        shutil.copytree(src, d)
    monkeypatch.setattr(ransac, "_draw_uniforms",
                        _ref_draws_by_seed(batched._bucket_pairs(3)))
    for name, main, extra in (("ref", ref_cli.main, []),
                              ("port", cli.main, ["--device", "cpu"])):
        xml = os.path.join(dirs[name], "dataset.xml")
        job = os.path.join(dirs[name], "job.xml")
        assert main(["cluster-job", xml, "--tp", "0", "--stages", stages,
                     "--out", job, *extra]) in (0, None)
        assert main(["cluster-merge", xml, job]) in (0, None)
        assert os.path.exists(xml + "~1")
    files = ["job.xml", "dataset.xml", "dataset.xml~1"]
    if stages == "detect":
        for f in files:
            assert filecmp.cmp(os.path.join(dirs["port"], f),
                               os.path.join(dirs["ref"], f),
                               shallow=False), f
    want = ref_xml.load_dataset(os.path.join(dirs["ref"], "dataset.xml"))
    got = xml_io.load_dataset(os.path.join(dirs["port"], "dataset.xml"))
    assert sorted(got.views) == sorted(want.views) == [(0, s)
                                                       for s in range(3)]
    for vid, w in want.views.items():
        g = got.views[vid]
        wi, gi = w.interest_points["beads"], g.interest_points["beads"]
        assert len(wi.points) >= 20
        assert np.array_equal(np.round(gi.points), np.round(wi.points))
        np.testing.assert_allclose(gi.points, wi.points, atol=1e-4, rtol=0)
        assert [t.name for t in g.transforms] == [t.name
                                                  for t in w.transforms]
        A, B = g.model(), w.model()
        pts = wi.points
        np.testing.assert_allclose(pts @ A[:, :3].T + A[:, 3],
                                   pts @ B[:, :3].T + B[:, 3], atol=1e-3,
                                   rtol=0)
    if stages != "detect":
        assert [t.name for t in got.views[(0, 1)].transforms] == [
            "registration"]


def test_cluster_merge_without_jobs_returns_1(tmp_path, capsys):
    ds = dataset.Dataset(base_path=str(tmp_path))
    ds.add_view(dataset.ViewDescription(view_id=(0, 0), size=(8, 8, 8)))
    xml = str(tmp_path / "dataset.xml")
    xml_io.save_dataset(ds, xml)
    assert ref_cli.main(["cluster-merge", xml]) == 1
    assert "no job XMLs found" in capsys.readouterr().err
    assert cli.main(["cluster-merge", xml]) == 1
    assert "no job XMLs found" in capsys.readouterr().err
    assert not os.path.exists(xml + "~1")
