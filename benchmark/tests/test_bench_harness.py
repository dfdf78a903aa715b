"""CPU tests of the benchmark's harness: lookup by name, the metrics'
arithmetic, the roofline's byte counts, the plain reference against the
port, and the import rules."""

from __future__ import annotations

import ast
import json
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from benchmark.tests.cells import REPO, tiny_checkout, write_json
from benchmark import harness, roofline
from benchmark.reference import rl as ref

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
CPU = torch.device("cpu")


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_finds_its_files(workload):
    cell = harness.Cell(workload)
    assert cell.kind in ("rl", "register")
    assert cell.job_module().setup
    assert cell.limits["numbers"]
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(cell.metric_reader(m["name"]).read)


def test_new_config_traffic_and_metric_need_only_files_and_entries(tmp_path):
    """A configuration, a traffic mix, a cell and a per-layer metric added
    as files and entries alone run through the unchanged harness."""
    root = tiny_checkout(tmp_path)
    bench = root / "benchmark"
    cfg = json.loads((bench / "configs" / "mvd6x256.json").read_text())
    write_json(bench / "configs" / "mvd2x24.json",
               {**cfg, "name": "mvd2x24", "shape": [24, 24, 24]})
    write_json(bench / "traffic" / "fft3.json",
               {"job": "rl", "deconvolution": {"conv_backend": "fft",
                                               "num_iterations": 3},
                "sample": 1, "trace_jobs": 1})
    write_json(bench / "limits" / "mvd2x24.fft3.json",
               {"numbers": {"nrmse": {"limit": 1e-5, "better": "lower"}}})
    (bench / "metrics" / "jobs_traced.py").write_text(
        "def read(trace):\n    return float(trace.jobs)\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "mvd2x24", "source": "a test",
                            "file": "benchmark/configs/mvd2x24.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "mvd2x24.fft3", "config": "mvd2x24",
                              "traffic": "fft3", "chips": 1, "why": "a test"})
    spec["per_layer"].append({"name": "jobs_traced", "unit": "jobs",
                              "better": "higher", "source": "program_counter",
                              "layer": "device", "moves": "rl_vupd_per_s",
                              "workloads": ["mvd2x24.fft3"]})
    for m in spec["end_to_end"]:
        if "workloads" in m and "mvd6x256.fft" in m["workloads"]:
            m["workloads"].append("mvd2x24.fft3")
    write_json(root / "BENCHMARK.json", spec)

    cell = harness.Cell("mvd2x24.fft3", root=root, bench=bench)
    assert cell.config["shape"] == [24, 24, 24]
    r = harness.run_cell(cell, 2**31 + 11, 0.3, False, time.perf_counter(),
                         device=CPU)
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"rl_vupd_per_s", "job_p95_s", "setup_s"}
    r = harness.run_cell(cell, 2**31 + 11, 0.3, True, time.perf_counter(),
                         device=CPU)
    assert r["metrics"]["jobs_traced"]["value"] == 1.0
    assert list(r)[-1] == "checks"


def test_rate_and_p95_over_the_window():
    log = [(0.1 * i, 0.1 * i + w) for i, w in enumerate(
        [0.05] * 18 + [0.09, 0.1])]
    m = harness.end_to_end(
        log, window_s=2.0, setup_s=7.5, work={"rl_vupd_per_s": 1e6},
        wanted=[{"name": n, "unit": u} for n, u in (
            ("rl_vupd_per_s", "vupd/s"), ("job_p95_s", "s"),
            ("job_p95_s.reg", "s"), ("setup_s", "s"))])
    assert m["rl_vupd_per_s"]["value"] == pytest.approx(20 * 1e6 / 2.0)
    walls = [e - s for s, e in log]
    assert m["job_p95_s"]["value"] == pytest.approx(
        float(np.percentile(walls, 95)))
    assert m["job_p95_s.reg"]["value"] == m["job_p95_s"]["value"]
    assert m["setup_s"]["value"] == 7.5


def test_fp8_rounding_keeps_a_volumes_scale():
    x = torch.linspace(0.0, 3000.0, 4097)
    y = ref.round_volume(x, torch.float8_e4m3fn)
    assert torch.isfinite(y).all()
    assert float(y.max()) == pytest.approx(3000.0, rel=1e-6)
    rel = ((y - x).abs() / x.clamp(min=1e-9))[x > 3000.0 / 64]
    assert 0.01 < float(rel.max()) <= 2.0 ** -4
    assert torch.equal(ref.round_volume(x, torch.bfloat16),
                       x.to(torch.bfloat16).float())


@pytest.mark.parametrize("backend,lowrank_dtype,lower", [
    ("fft", "bfloat16", torch.bfloat16),
    ("lowrank", "bfloat16", torch.float8_e4m3fn),
    ("lowrank", "float32", torch.bfloat16)])
def test_control_is_one_precision_below_the_stated_one(backend,
                                                       lowrank_dtype,
                                                       lower):
    from benchmark.jobs import rl

    params = {"conv_backend": backend, "lowrank_dtype": lowrank_dtype}
    assert rl.LOWER[rl.stated_precision(params)] == lower


def band(R: int, n: int, rad: int) -> torch.Tensor:
    i = torch.arange(n)
    m = ((i[:, None] - i[None, :]).abs() <= rad).float()
    return m.expand(R, n, n)


def test_zpass_and_sl_rows_bytes_at_the_main_paths_shapes():
    """Rank 22, 256^3, half-support 9: bytes are the tensors' sizes, and
    the bounds are the 0.2304 and 0.2405 ms of the kernel table."""
    R, n, rad = 22, 256, 9
    M = band(R, n, rad)
    nnz = float((M != 0).sum())
    assert nnz == R * (n * (2 * rad + 1) - rad * (rad + 1))
    J = n * n
    zb, zo = roofline.zpass_work(nnz, R, n, n, J)
    vm_bytes, a_bytes = n ** 3 * 2, R * n * J * 2
    assert zb == nnz * 2 + vm_bytes + a_bytes
    assert zo == 2 * nnz * J
    assert roofline.bound_s(zb, zo) * 1e3 == pytest.approx(0.2304, rel=2e-3)
    sb, so = roofline.sl_rows_work(R, n, n, n, n, n, nnz, nnz)
    assert sb == a_bytes + 2 * nnz * 2 + n ** 3 * 4
    assert so == 2 * n * (nnz * n + n * nnz) + R * n ** 3
    assert roofline.bound_s(sb, so) * 1e3 == pytest.approx(0.2405, rel=2e-3)


def test_plain_reference_against_the_ports_fft_rl():
    from spim_registration_tpu_torch.deconv import (
        DeconvolutionParameters, DeconvolutionRunner, DeconvolutionViews)
    from benchmark.gen import phantom

    cfg = json.loads((REPO / "benchmark/configs/mvd6x256.json").read_text())
    cfg.update(shape=[32, 32, 32], psf_indices=[1, 3], beads=12,
               margin_px=8, ramp_px=6)
    inp = phantom.rl_inputs(cfg, {}, 5, CPU)
    p = cfg["deconvolution"]
    prep = DeconvolutionViews(images=inp["images"].clone(),
                              weights=inp["weights"].clone(),
                              psfs=inp["psfs"], osem_factor=inp["osem"])
    got = DeconvolutionRunner(prep, DeconvolutionParameters(
        **{**p, "conv_backend": "fft", "num_iterations": 6}),
        device="cpu").run()
    want = ref.richardson_lucy(inp["images"], inp["weights"], inp["psfs"],
                               inp["osem"], 6, p["psf_type"],
                               p["tikhonov_lambda"], p["min_value"])
    assert ref.compare(got, want)["nrmse"] < 1e-6


def imported_modules(path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module)
    return out


@pytest.mark.parametrize("folder", ["reference", "gen"])
def test_reference_and_generators_import_nothing_of_the_port(folder):
    for path in sorted((REPO / "benchmark" / folder).glob("*.py")):
        tops = {m.split(".")[0] for m in imported_modules(path)}
        assert not tops & {"spim_registration_tpu_torch",
                           "spim_registration_tpu", "jax", "jaxlib",
                           "flax"}, path


def test_forbidden_modules_are_matched_by_whole_top_level_names(
        monkeypatch):
    for name in ("spim_registration_tpu_torch", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "spim_registration_tpu.ops", sys)
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    assert harness.forbidden_modules() == ["jaxlib", "spim_registration_tpu"]


def test_a_run_loads_nothing_of_jax():
    """Every job kind and metric reader of the benchmark and what they
    import, in a fresh process: no top-level name of JAX or of the JAX
    package."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from pathlib import Path\n"
        "from benchmark import harness\n"
        "for p in sorted(Path(%r).glob('*/*.py')):\n"
        "    if p.parent.name in ('jobs', 'metrics'):\n"
        "        harness.load_module(p, 'm_' + p.stem.replace('.', '_'))\n"
        "print(harness.forbidden_modules())\n"
    ) % (str(REPO), str(REPO / "benchmark"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=REPO)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def run_py(cwd):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         SPEC["workloads"][0]["name"], "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=cwd)


def test_run_py_exits_nonzero_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = run_py(REPO)
    assert out.returncode != 0 and out.stdout == ""
    assert "cuda" in out.stderr.lower()


def test_run_py_exits_nonzero_with_only_the_benchmarks_files(tmp_path):
    """A directory that holds BENCHMARK.json and `benchmark/` alone has no
    program to measure: no result, a nonzero exit (on the card too)."""
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = run_py(tmp_path)
    assert out.returncode != 0 and out.stdout == ""
