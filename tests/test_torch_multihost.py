"""The port's multi-process layer (`parallel/multihost.py`, a `Mesh` that
spans processes, `--multihost` and `_is_primary` in the CLI) on the CPU,
after tests/test_multihost_multiprocess.py.

Two processes join over gloo (`initialize_multihost`, a free localhost
port), each with 4 host positions: 8 positions across 2 processes, as the
reference's worker has 4 virtual devices a process. They run (a) the flat
8-way z-sharded FFT RL, (b) the ("host", "z") parallel scheme with the
views data-parallel across the processes (`host_z_mesh(4)`), (c) the
lowrank RL, (d) the sharded fusion, and the cross-process steps of
detection, matching, the normal-equation assembly and `parallel/mesh.py`
itself, on the reference worker's inputs (rebuilt here from the same
seeds). This file is its own worker: `python tests/test_torch_multihost.py
RANK WORLD PORT DIR` reads DIR/inputs.npz, imports only the port, and
writes DIR/out_RANK.npz; every gathered result is held on both processes.

Tolerances: the reference's own (RL rtol 5e-4 and atol 1e-4 x max, fusion
2e-6 with the box-face voxels of ROADMAP queue 3 item 12 named, CLI psi
nrmse < 5e-5, points 1e-3 after a lexsort); against the port's one-process
8-position mesh 1e-6 x max, and detection and matching exactly: the
cross-process steps move data and add no arithmetic. The CLI runs
`detect`, `register` and `deconvolve --multihost --mesh z=8 --device cpu`
as two processes through COORDINATOR_ADDRESS / NUM_PROCESSES /
PROCESS_ID; process 1 reads its own copy of the dataset, which must stay
as it was (process 1 writes nothing), and prints no results.
"""

import os
import shutil
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
WORLD, LOCAL = 2, 4
CPU = torch.device("cpu")
SHAPE = (64, 32, 32)
# each spawn's limit: a hung peer fails the test, not the suite
SPAWN_TIMEOUT_S = 240

RL = {"a": dict(num_iterations=2, psf_type="independent"),
      "b": dict(num_iterations=2, psf_type="independent",
                scheme="parallel"),
      "c": dict(num_iterations=2, psf_type="independent",
                conv_backend="lowrank", psf_rank=4, psf_rank_tol=1e-3,
                psf_rank_hard=8)}
FUSE_BOX = (23, 24, 24)
PAIRS = [(0, 1), (0, 2), (1, 2)]


# ----------------------------------------------------- cases (port only)

def _cases(inp, flat, hz, vz) -> dict:
    """Every case on the port's meshes: `flat` ("z",) of 8 positions,
    `hz` ("host", "z") = (2, 4), `vz` ("view", "z") = (2, 4). Returns
    host arrays, each whole on every process."""
    from spim_registration_tpu_torch import convert
    from spim_registration_tpu_torch.core.dataset import BoundingBox
    from spim_registration_tpu_torch.deconv import DeconvolutionParameters
    from spim_registration_tpu_torch.detect import DoGParameters
    from spim_registration_tpu_torch.fuse.weighted_avg import (
        FusionParameters,
    )
    from spim_registration_tpu_torch.match.batched import (
        match_pairs_batched,
    )
    from spim_registration_tpu_torch.match.pairwise import (
        PairwiseParameters,
    )
    from spim_registration_tpu_torch.parallel import (
        halo_exchange_z,
        sharded_deconvolve,
        sharded_detect_beads,
        sharded_fuse_views,
    )
    from spim_registration_tpu_torch.parallel import mesh as pm
    from spim_registration_tpu_torch.solve.assembly import (
        assemble_normal_equations_sharded,
    )

    def every(xs, mesh):
        return np.stack([t.numpy() for t in pm.allgather(xs, mesh)])

    prep = convert.views_from_numpy(inp["images"], inp["weights"],
                                    list(inp["psfs"]), float(inp["osem"]),
                                    device="cpu")
    out = {
        "a": sharded_deconvolve(prep, DeconvolutionParameters(**RL["a"]),
                                flat),
        "b": sharded_deconvolve(prep, DeconvolutionParameters(**RL["b"]),
                                hz, axis_name="z", view_axis="host"),
        "c": sharded_deconvolve(prep, DeconvolutionParameters(**RL["c"]),
                                flat),
        "d": sharded_fuse_views(list(inp["fuse_vols"]),
                                list(inp["fuse_models"]),
                                BoundingBox("b", (0, 0, 0), FUSE_BOX),
                                FusionParameters(), mesh=flat)}
    pts, resp = sharded_detect_beads(
        inp["detect_vol"], DoGParameters(sigma=1.8, threshold=0.01), flat)
    out["detect_points"], out["detect_resp"] = pts, resp
    res = match_pairs_batched(list(inp["match_views"]), PAIRS,
                              PairwiseParameters(max_points=256), seed=3,
                              mesh=flat)
    for (i, j), r in res.items():
        out[f"match_{i}{j}_inliers"] = r.inliers
        out[f"match_{i}{j}_model"] = r.model
    H, g = assemble_normal_equations_sharded(
        flat, "z", "affine", 3, inp["asm_pc"], inp["asm_qc"], inp["asm_w"],
        inp["asm_ci"], inp["asm_cj"])
    out["asm_H"], out["asm_g"] = H.numpy(), g.numpy()

    a = np.arange(2 * 8 * 3, dtype=np.float32).reshape(2, 8, 3)
    xs = pm.shard(a, vz, ("view", "z"))
    out["coll_gather"] = pm.gather(xs, vz, ("view", "z"))
    out["coll_psum_view"] = every(pm.psum(xs, vz, "view"), vz)
    out["coll_psum_z"] = every(pm.psum(xs, vz, "z"), vz)
    zs = pm.shard(np.arange(32 * 4 * 4, dtype=np.float32).reshape(32, 4, 4),
                  flat, ("z",))
    out["coll_ppermute"] = every(pm.ppermute(zs, flat, "z", 1), flat)
    out["coll_halo"] = every(halo_exchange_z(zs, 6, flat), flat)
    return out


def _worker(rank: int, world: int, port: str, d: str) -> None:
    torch.set_num_threads(1)
    from spim_registration_tpu_torch.deconv import DeconvolutionParameters
    from spim_registration_tpu_torch.deconv.blocked import (
        ArrayStore,
        BlockedDeconvolutionInputs,
        BlockedDeconvolutionRunner,
    )
    from spim_registration_tpu_torch.parallel import (
        host_z_mesh,
        initialize_multihost,
        shard_timepoints,
    )
    from spim_registration_tpu_torch.parallel import multihost
    from spim_registration_tpu_torch.parallel.mesh import make_mesh

    route = initialize_multihost(f"localhost:{port}", world, rank)
    assert route == "gloo", route
    assert (multihost.process_index(), multihost.process_count()) == (
        rank, world)
    inp = dict(np.load(os.path.join(d, "inputs.npz")))
    flat = make_mesh(("z",), (LOCAL * world,), devices=[CPU] * LOCAL)
    assert flat.spans_processes
    assert flat.local_positions == list(range(rank * LOCAL,
                                              (rank + 1) * LOCAL))
    hz = host_z_mesh(LOCAL, device="cpu")
    assert hz.shape == {"host": world, "z": LOCAL}
    vz = make_mesh(("view", "z"), (world, LOCAL), devices=[CPU] * LOCAL)
    out = _cases(inp, flat, hz, vz)
    out["timepoints"] = np.asarray(shard_timepoints(list(range(10))))
    imgs = inp["images"]
    inputs = BlockedDeconvolutionInputs(
        [ArrayStore(v) for v in imgs], [ArrayStore(w)
                                        for w in inp["weights"]],
        list(inp["psfs"]), float(inp["osem"]))
    try:
        BlockedDeconvolutionRunner(
            inputs, ArrayStore(np.zeros(SHAPE, np.float32)),
            DeconvolutionParameters(**RL["a"]), block_z=8, device="cpu",
            mesh=flat)
        out["blocked"] = np.asarray("ran")
    except ValueError as e:
        out["blocked"] = np.asarray(str(e))
    out["traffic_bytes"] = np.asarray(multihost.traffic["bytes"])
    np.savez(os.path.join(d, f"out_{rank}.npz"), **out)
    multihost.shutdown_multihost()
    print(f"worker {rank}: OK", flush=True)


# ------------------------------------------------------------- spawning

def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env() -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "COORDINATOR_ADDRESS",
                        "NUM_PROCESSES", "PROCESS_ID")}
    env["PYTHONPATH"] = str(ROOT)
    env["OMP_NUM_THREADS"] = "1"
    return env


def _spawn(argvs, envs) -> list:
    """Run one process per argv, all at once, and return their outputs;
    on a timeout every one is killed and the test fails."""
    procs = [subprocess.Popen(a, env=e, cwd=str(ROOT),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for a, e in zip(argvs, envs)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=SPAWN_TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        raise
    return [(p.returncode, o) for p, o in zip(procs, outs)]


def _spawn_group(make_argv, make_env=None) -> list:
    """`_spawn` of WORLD ranks on a free port, once more on a new port
    when the first one was taken meanwhile."""
    for attempt in range(2):
        port = _free_port()
        res = _spawn([make_argv(r, port) for r in range(WORLD)],
                     [(make_env or (lambda r, p: _env()))(r, port)
                      for r in range(WORLD)])
        taken = any(rc != 0 and "ddress already in use" in o
                    for rc, o in res)
        if not taken or attempt == 1:
            return res
    return res


# ------------------------------------------------------------ fixtures

def _ref_prep():
    """The reference worker's `tiny_prep((64, 32, 32))`."""
    from spim_registration_tpu.core.dataset import BoundingBox as RefBBox
    from spim_registration_tpu.deconv import (
        gaussian_psf,
        prepare_views_for_deconvolution,
    )
    from spim_registration_tpu.ops.fftconv import direct_convolve_np
    from spim_registration_tpu.utils.simulation import render_beads

    rng = np.random.default_rng(0)
    pts = rng.uniform(6, SHAPE[0] - 6, size=(12, 3))
    truth = render_beads(pts, SHAPE, sigma=1.0)
    sigmas = [(2.5, 1.0, 1.0), (1.0, 1.0, 2.5)]
    psfs = [gaussian_psf((9, 9, 9), sigmas[v % 2]) for v in range(2)]
    views = [direct_convolve_np(truth, p).astype(np.float32) for p in psfs]
    ident = np.concatenate([np.eye(3), np.zeros((3, 1))], axis=1)
    return prepare_views_for_deconvolution(views, [ident] * 2, psfs,
                                           RefBBox("b", (0, 0, 0), SHAPE))


def _inputs() -> dict:
    from spim_registration_tpu.utils.simulation import (
        make_multiview_scene,
        random_rotation,
        render_beads,
    )

    prep = _ref_prep()
    scene = make_multiview_scene(np.random.default_rng(3), n_views=2,
                                 shape=(24, 24, 24), n_beads=8, noise=0.002)
    rng = np.random.default_rng(5)
    det = render_beads(rng.uniform(6, 42, size=(20, 3)), (48, 40, 40),
                       sigma=1.6) + rng.normal(0, 0.003, (48, 40, 40))
    rng = np.random.default_rng(8)
    base = rng.uniform(0, 100, (140, 3))
    views = []
    for _ in range(3):
        R = random_rotation(rng, 15.0)
        views.append((base @ R.T + rng.uniform(-4, 4, 3)
                      + rng.normal(0, 0.05, base.shape)).astype(np.float32))
    rng = np.random.default_rng(42)
    N = 1003
    pc = rng.normal(size=(N, 3))
    return {"images": np.asarray(prep.images, np.float32),
            "weights": np.asarray(prep.weights, np.float32),
            "psfs": np.stack([np.asarray(p, np.float32) for p in prep.psfs]),
            "osem": np.float32(prep.osem_factor),
            "fuse_vols": np.stack([np.asarray(v, np.float32)
                                   for v in scene.volumes]),
            "fuse_models": np.stack(scene.models),
            "detect_vol": det.astype(np.float32),
            "match_views": np.stack(views),
            "asm_pc": pc,
            "asm_qc": pc + rng.normal(scale=0.1, size=(N, 3)),
            "asm_w": rng.uniform(0.5, 1.0, N),
            "asm_ci": rng.integers(-1, 3, N),
            "asm_cj": rng.integers(-1, 3, N)}


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """Both workers' outputs, the inputs, and the same cases on the
    port's one-process 8-position meshes."""
    from spim_registration_tpu_torch.parallel.mesh import make_mesh

    d = tmp_path_factory.mktemp("multihost")
    inp = _inputs()
    np.savez(d / "inputs.npz", **inp)
    res = _spawn_group(lambda r, port: [
        sys.executable, str(Path(__file__).resolve()), str(r), str(WORLD),
        str(port), str(d)])
    for r, (rc, out) in enumerate(res):
        assert rc == 0 and f"worker {r}: OK" in out, out[-4000:]
    outs = [dict(np.load(d / f"out_{r}.npz")) for r in range(WORLD)]
    one = _cases(inp,
                 make_mesh(("z",), (8,), devices=[CPU] * 8),
                 make_mesh(("host", "z"), (WORLD, LOCAL),
                           devices=[CPU] * 8),
                 make_mesh(("view", "z"), (WORLD, LOCAL),
                           devices=[CPU] * 8))
    return {"inputs": inp, "outs": outs, "one": one}


def _ref_rl(case):
    from spim_registration_tpu.deconv import (
        DeconvolutionParameters as RefParams,
        deconvolve as ref_deconvolve,
    )

    return np.asarray(ref_deconvolve(_ref_prep(), RefParams(**RL[case])))


# --------------------------------------------------------------- engines

@pytest.mark.parametrize("case", ["a", "b", "c"])
def test_rl_across_processes_matches_reference(engines, case):
    """(a) flat z, FFT; (b) ("host", "z") parallel scheme with the view
    axis across the processes; (c) lowrank: against the reference's
    single-process `deconvolve` (its tolerance)."""
    want = _ref_rl(case)
    for out in engines["outs"]:
        got = out[case]
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=5e-4,
                                   atol=1e-4 * want.max())


@pytest.mark.parametrize("case", ["a", "b", "c", "d"])
def test_across_processes_equals_one_process_mesh(engines, case):
    """Each case on 2 processes x 4 positions against the port's
    one-process 8-position mesh, on both processes: within 1e-6 x max."""
    want = engines["one"][case]
    for out in engines["outs"]:
        np.testing.assert_allclose(out[case], want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())


def test_fusion_across_processes_matches_reference(engines):
    """(d) the output-z-sharded fusion (ragged 23 over 8) against the
    reference's `fuse_views` at 2e-6, except box-face voxels whose only
    weight is a blending ramp (ROADMAP queue 3 item 12), named here."""
    from spim_registration_tpu.core.dataset import BoundingBox as RefBBox
    from spim_registration_tpu.fuse.weighted_avg import (
        FusionParameters as RefFusionParams,
        fuse_views as ref_fuse_views,
    )

    inp = engines["inputs"]
    want = np.asarray(ref_fuse_views(
        list(inp["fuse_vols"]), list(inp["fuse_models"]),
        RefBBox("b", (0, 0, 0), FUSE_BOX), RefFusionParams()))
    for out in engines["outs"]:
        got = out["d"]
        assert got.shape == want.shape == FUSE_BOX
        apart = np.abs(got - want) > 2e-6
        faces = np.argwhere(apart)
        assert len(faces) <= 2 and all(
            (c == 0).any() or (c == np.array(FUSE_BOX) - 1).any()
            for c in faces), faces
        np.testing.assert_allclose(got[~apart], want[~apart], atol=2e-6)


def test_detection_across_processes_equals_one_process(engines):
    """The z-sharded DoG over 8 positions on 2 processes: the padded peak
    lists are all-gathered, so both processes hold the one-process
    mesh's points and responses exactly."""
    one = engines["one"]
    assert len(one["detect_points"]) >= 10
    for out in engines["outs"]:
        np.testing.assert_array_equal(out["detect_points"],
                                      one["detect_points"])
        np.testing.assert_array_equal(out["detect_resp"],
                                      one["detect_resp"])


def test_matching_across_processes_equals_one_process(engines):
    """`match_pairs_batched(mesh=)`: the slots of the other process's
    positions arrive by all-gather; candidates' inliers and models equal
    the one-process mesh's, and each pair is valid."""
    one = engines["one"]
    for i, j in PAIRS:
        assert len(one[f"match_{i}{j}_inliers"]) >= 40
        for out in engines["outs"]:
            for k in ("inliers", "model"):
                np.testing.assert_array_equal(out[f"match_{i}{j}_{k}"],
                                              one[f"match_{i}{j}_{k}"])


def test_assembly_across_processes_equals_one_process(engines):
    """`assemble_normal_equations_sharded`: the psum over a z axis that
    crosses the processes adds the partials in axis order, so (H, g)
    equal the one-process mesh's."""
    one = engines["one"]
    for out in engines["outs"]:
        for k in ("asm_H", "asm_g"):
            np.testing.assert_allclose(out[k], one[k], rtol=0,
                                       atol=1e-6 * np.abs(one[k]).max())


@pytest.mark.parametrize("what", ["coll_gather", "coll_psum_view",
                                  "coll_psum_z", "coll_ppermute",
                                  "coll_halo"])
def test_mesh_steps_across_processes_equal_one_process(engines, what):
    """`gather`, `psum` over an axis that crosses the processes ("view")
    and one that does not ("z"), `ppermute` and a two-hop
    `halo_exchange_z` across the process boundary: every position's
    tensor equals the one-process mesh's, bit for bit."""
    for out in engines["outs"]:
        np.testing.assert_array_equal(out[what], engines["one"][what])
    if what == "coll_gather":
        np.testing.assert_array_equal(
            engines["one"][what],
            np.arange(48, dtype=np.float32).reshape(2, 8, 3))


def test_shard_timepoints_and_blocked_refusal(engines):
    """`shard_timepoints` gives tps[rank::2]; the blocked engine refuses a
    mesh that spans processes (so does the reference's, which cannot read
    its group's output back there); the halos and gathers crossed the
    process boundary."""
    for r, out in enumerate(engines["outs"]):
        assert list(out["timepoints"]) == list(range(10))[r::WORLD]
        assert "spans processes" in str(out["blocked"])
        assert int(out["traffic_bytes"]) > 0


# ------------------------------------------------------------------ CLI

@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """simulate (2 views, 44 x 48 x 48, 40 beads) once, then `detect`,
    `register` and `deconvolve --multihost --mesh z=8 --device cpu` as
    two processes each. Process 0 works on `work`; process 1 on a fresh
    copy of it for every verb, which must be left as it was."""
    from spim_registration_tpu_torch.cli import main

    d = tmp_path_factory.mktemp("multihost_cli")
    work = d / "work"
    assert main(["simulate", "--out", str(work), "--views", "2", "--shape",
                 "44", "48", "48", "--beads", "40"]) == 0
    verbs = {"detect": [], "register": [],
             "deconvolve": ["--out", "psi.npy",
                            "--set=deconvolution.num_iterations=2"]}
    logs, untouched = {}, {}
    for verb, extra in verbs.items():
        mirror = d / f"rank1_{verb}"
        shutil.copytree(work, mirror)
        before = _snapshot(mirror)
        dirs = [work, mirror]

        def argv(r, port, verb=verb, extra=extra, dirs=dirs):
            xtra = [str(dirs[r] / a) if a == "psi.npy" else a
                    for a in extra]
            return [sys.executable, "-m", "spim_registration_tpu_torch.cli",
                    verb, str(dirs[r] / "dataset.xml"), "--multihost",
                    "--mesh", "z=8", "--device", "cpu", *xtra]

        def env(r, port):
            e = _env()
            e.update(COORDINATOR_ADDRESS=f"localhost:{port}",
                     NUM_PROCESSES=str(WORLD), PROCESS_ID=str(r))
            return e

        res = _spawn_group(argv, env)
        for rc, out in res:
            assert rc == 0, out[-4000:]
        logs[verb] = [o for _, o in res]
        untouched[verb] = _snapshot(mirror) == before
    return {"dir": d, "work": work, "logs": logs, "untouched": untouched}


def _snapshot(d: Path) -> dict:
    return {str(p.relative_to(d)): p.read_bytes()
            for p in sorted(d.rglob("*")) if p.is_file()}


def test_cli_multihost_deconvolve_matches_single_process(cli_run, tmp_path):
    """The two-process `deconvolve` equals a single-process port
    `deconvolve` of the same XML (nrmse < 5e-5, the reference's)."""
    from spim_registration_tpu_torch.cli import main

    single = tmp_path / "single"
    shutil.copytree(cli_run["work"], single)
    (single / "psi.npy").unlink()
    out = single / "psi_single.npy"
    assert main(["deconvolve", str(single / "dataset.xml"), "--out",
                 str(out), "--device", "cpu",
                 "--set=deconvolution.num_iterations=2"]) == 0
    a = np.load(out)
    b = np.load(cli_run["work"] / "psi.npy")
    assert a.shape == b.shape
    assert np.sqrt(np.mean((a - b) ** 2)) / (a.max() - a.min()) < 5e-5


def test_cli_multihost_detection_matches_single_device(cli_run):
    """The points of the two-process `detect` against single-device
    `detect_beads` on the same images: within 1e-3 after a lexsort."""
    from spim_registration_tpu_torch.cli import _dataset_with_loader
    from spim_registration_tpu_torch.detect.dog import detect_beads

    ds = _dataset_with_loader(str(cli_run["work"] / "dataset.xml"))
    for vid, vd in sorted(ds.views.items()):
        pm = np.asarray(vd.interest_points["beads"].points)
        ps, _ = detect_beads(np.asarray(ds.get_image(vid)), device="cpu")
        ps, pm = ps[np.lexsort(ps.T)], pm[np.lexsort(pm.T)]
        assert ps.shape == pm.shape and len(ps) >= 10, (vid, ps.shape,
                                                        pm.shape)
        np.testing.assert_allclose(ps, pm, atol=1e-3)


def test_cli_multihost_register_matches_single_process(cli_run, tmp_path):
    """`register --multihost` stores the models a single-process
    `register` gives on the same points."""
    from spim_registration_tpu_torch.cli import main
    from spim_registration_tpu_torch.core.xml_io import load_dataset

    single = tmp_path / "single"
    shutil.copytree(cli_run["dir"] / "rank1_register", single)
    xml = str(single / "dataset.xml")
    assert main(["register", xml, "--device", "cpu"]) == 0
    a = load_dataset(xml)
    b = load_dataset(str(cli_run["work"] / "dataset.xml"))
    for vid in a.views:
        np.testing.assert_allclose(a.views[vid].model(),
                                   b.views[vid].model(), atol=1e-5)


@pytest.mark.parametrize("verb", ["detect", "register", "deconvolve"])
def test_cli_multihost_process_1_writes_and_prints_nothing(cli_run, verb):
    """Process 0 prints the verb's results; process 1 prints none and
    leaves its copy of the dataset as it was."""
    log0, log1 = cli_run["logs"][verb]
    said = {"detect": "points", "register": "residual",
            "deconvolve": "deconvolved"}[verb]
    assert said in log0
    assert said not in log1 and "view (" not in log1
    assert cli_run["untouched"][verb]


# ------------------------------------------------- one process, no group

def test_no_group_bookkeeping(monkeypatch):
    """Without a group: rank 0 of 1, `initialize_multihost` does nothing
    (no address, or one process), every timepoint is this process's,
    `host_z_mesh` is one host row, and a mesh is this process's alone."""
    from spim_registration_tpu_torch.parallel import multihost
    from spim_registration_tpu_torch.parallel.mesh import make_mesh

    assert multihost.process_index() == 0
    assert multihost.process_count() == 1
    assert multihost.route() is None
    for k in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    assert multihost.initialize_multihost() is None
    monkeypatch.setenv("COORDINATOR_ADDRESS", "localhost:1")
    assert multihost.initialize_multihost() is None     # NUM_PROCESSES 1
    assert multihost.shard_timepoints([3, 1, 4]) == [3, 1, 4]
    m = multihost.host_z_mesh(4, device="cpu")
    assert m.shape == {"host": 1, "z": 4} and not m.spans_processes
    assert m.local_positions == [0, 1, 2, 3]
    with pytest.raises(ValueError, match="needs z_per_host"):
        multihost.host_z_mesh(device="cpu")
    m = make_mesh(("z",), (3,), devices=[CPU] * 3)
    assert m.owners is None and m.owner(2) == 0 and m.first_device() == CPU
    multihost.shutdown_multihost()                      # no-op


def test_cli_accepts_multihost_and_implies_auto(monkeypatch):
    """`--multihost` parses on every verb that takes `--mesh` and implies
    `--mesh auto`: one position a process on the CPU, so None without a
    group; an explicit `--mesh` wins."""
    from spim_registration_tpu_torch.cli import (
        _is_primary,
        _mesh_from_args,
        build_parser,
    )

    p = build_parser()
    for verb in ("detect", "register", "fuse", "deconvolve", "tune",
                 "icp-refine", "cluster-job"):
        extra = ["--tp", "0"] if verb == "cluster-job" else []
        args = p.parse_args([verb, "x.xml", "--multihost", "--device",
                             "cpu", *extra])
        assert args.multihost and args.mesh is None
        assert _mesh_from_args(args) is None
    args = p.parse_args(["detect", "x.xml", "--multihost", "--mesh", "z=4",
                         "--device", "cpu"])
    assert _mesh_from_args(args).shape == {"z": 4}
    assert _is_primary()
    with pytest.raises(SystemExit):
        p.parse_args(["simulate", "--out", "x", "--multihost"])


def test_mesh_from_spec_unchanged_without_group():
    from spim_registration_tpu_torch.parallel.mesh import mesh_from_spec

    assert mesh_from_spec("auto", "cpu") is None
    m = mesh_from_spec("view=2,z=4", "cpu")
    assert m.shape == {"view": 2, "z": 4} and not m.spans_processes
    assert all(d == CPU for d in m.devices.flat)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
