"""CPU tests of the benchmark's harness: lookup by name, the metrics'
arithmetic, the roofline's byte counts, the plain reference against the
port, and the import rules."""

from __future__ import annotations

import ast
import bisect
import contextlib
import json
import random
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from benchmark.tests.cells import (
    REPO,
    TOY_CELL,
    checkout,
    cut_sizes,
    cut_to_test_size,
    faults_module,
    planted,
    read_cut,
    tiny_checkout,
    write_json,
)
from benchmark import harness, roofline
from benchmark.reference import rl as ref

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
CPU = torch.device("cpu")


def assert_finds_its_files(cell: harness.Cell) -> None:
    """The cell's job kind, limits, metric readers and cuts are found by
    name, and it reports `setup_s`, another end-to-end metric and a
    per-layer metric."""
    assert (cell.bench / "jobs" / f"{cell.kind}.py").is_file()
    mod = cell.job_module()
    assert callable(mod.setup) and callable(mod.control)
    assert cell.limits["numbers"]
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(cell.metric_reader(m["name"]).read)
    for group, name in (("configs", cell.workload["config"]),
                        ("traffic", cell.workload["traffic"])):
        assert "tiny" in read_cut(cell.bench, group, name)


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_finds_its_files(workload):
    assert_finds_its_files(harness.Cell(workload))


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
                         devices=[CPU])
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"rl_vupd_per_s", "job_p95_s", "setup_s"}
    r = harness.run_cell(cell, 2**31 + 11, 0.3, True, time.perf_counter(),
                         devices=[CPU])
    assert r["metrics"]["jobs_traced"]["value"] == 1.0
    assert list(r)[-1] == "checks"


def test_new_kind_and_a_two_card_cell_need_only_files_and_entries(
        tmp_path, monkeypatch):
    """A configuration, a job kind with its faults, cuts and a metric, and
    a cell of two cards (`tests/toy/`), added as files and entries alone:
    every lookup finds them, and the unchanged harness runs the cell on
    two CPU devices, untraced and traced, hands the kind both, and waits
    for and frees both; each fault of the kind comes out not correct."""
    root = tiny_checkout(tmp_path, toy=True)
    bench = root / "benchmark"
    cell = harness.Cell(TOY_CELL, root=root, bench=bench)
    assert (cell.chips, cell.kind) == (2, "toy")
    assert_finds_its_files(cell)
    assert cell.config["n"] == 32                   # its cut, found by name
    assert cut_sizes(cell)[0]["n"] == 32
    assert set(faults_module(bench, "toy").FAULTS) == {"unchanged",
                                                       "altered"}
    mod = cell.job_module()
    handed, waited, freed = [], [], []

    def setup(*a, **k):
        handed.append(k.get("devices"))
        return orig_setup(*a, **k)
    orig_setup = mod.setup
    monkeypatch.setattr(mod, "setup", setup)
    monkeypatch.setattr(harness, "sync", waited.append)
    monkeypatch.setattr(harness, "free_cache", freed.append)
    two = [CPU, CPU]
    r = harness.run_cell(cell, 2**31 + 13, 0.3, False, time.perf_counter(),
                         devices=two)
    assert r["correct"], r["checks"]
    m = r["metrics"]
    assert set(m) == {"toy_products_per_s", "job_p95_s.toy", "setup_s"}
    assert m["toy_products_per_s"]["value"] > 0
    assert m["job_p95_s.toy"]["value"] > 0
    assert r["device"] == {"platform": "cpu", "kind": "cpu", "count": 2,
                           "memory_peak_bytes": 0,
                           "memory_peak_bytes_per_card": [0, 0]}
    r = harness.run_cell(cell, 2**31 + 13, 0.3, True, time.perf_counter(),
                         devices=two)
    assert r["correct"], r["checks"]
    assert r["metrics"] == {"toy_cards": {"value": 2.0, "unit": "cards"}}
    assert r["device"]["busy_s_per_card"] == [0.0, 0.0]
    assert r["device"]["busy_s"] == 0.0
    assert handed == [two, two]
    assert waited and all(d == two for d in waited)
    assert freed == [two, two]
    for fault in ("unchanged", "altered"):
        with planted(cell, fault):
            r = harness.run_cell(cell, 2**31 + 13, 0.2, False,
                                 time.perf_counter(), devices=two)
        assert r["correct"] is False, (fault, r["checks"])


def test_a_cell_without_a_cut_fails_naming_the_file(tmp_path):
    root = checkout(tmp_path, toy=True)
    (root / "benchmark/tests/cuts/configs/toy2.json").unlink()
    with pytest.raises(FileNotFoundError,
                       match=r"cuts/configs/toy2\.json"):
        cut_to_test_size(root)


def test_every_card_is_waited_for_reset_read_and_freed(monkeypatch):
    """`sync`, `reset_peaks`, `read_peaks` and `free_cache` act on each
    card of a cell (torch.cuda faked: the CPU build has no card)."""
    cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
    seen = []

    @contextlib.contextmanager
    def on(d):
        seen.append(("current", d))
        yield

    for name in ("synchronize", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name,
                            lambda d, name=name: seen.append((name, d)))
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda d: 100 + d.index)
    monkeypatch.setattr(torch.cuda, "empty_cache",
                        lambda: seen.append(("empty_cache", None)))
    monkeypatch.setattr(torch.cuda, "device", on)
    monkeypatch.setattr(torch, "empty",
                        lambda *a, device: seen.append(("empty", device)))
    harness.sync(cards)
    harness.reset_peaks(cards)
    assert harness.read_peaks(cards) == [100, 101]
    harness.free_cache(cards)
    assert seen == [("synchronize", cards[0]), ("synchronize", cards[1]),
                    ("empty", cards[0]),
                    ("reset_peak_memory_stats", cards[0]),
                    ("empty", cards[1]),
                    ("reset_peak_memory_stats", cards[1]),
                    ("current", cards[0]), ("empty_cache", None),
                    ("current", cards[1]), ("empty_cache", None)]
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d: "card")
    assert harness.device_info(cards, [100, 101]) == {
        "platform": "gpu", "kind": "card", "count": 2,
        "memory_peak_bytes": 101, "memory_peak_bytes_per_card": [100, 101]}


def parent_arithmetic(device_ops, host_ops, top: int = 10) -> tuple:
    """`busy_s` and `breakdown()` as the harness took them before it told
    the cards apart: the union of every device operation."""
    intervals = harness.merge_intervals((s, s + d) for _, s, d in device_ops)
    busy_s = sum(e - s for s, e in intervals) / 1e6
    by_op: dict = {}
    for n, _, d in device_ops:
        by_op[n] = by_op.get(n, 0.0) + d / 1e6
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    host = sorted(host_ops, key=lambda h: h[1])
    starts = [h[1] for h in host]
    gaps: dict = {}
    for (_, e0), (s1, _) in zip(intervals, intervals[1:]):
        i = bisect.bisect_right(starts, e0)
        name = "(no host operation)"
        for n, s, d in reversed(host[max(0, i - 400):i]):
            if s + d > e0:
                name = n
                break
        gaps[name] = gaps.get(name, 0.0) + (s1 - e0) / 1e6
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
    return busy_s, {"device_ops": [[n[:160], v] for n, v in ops],
                    "idle_gaps": [[n[:160], v] for n, v in idle]}


def test_busy_and_idle_gaps_are_each_cards_own():
    """Card 0 busy the whole stretch, card 1 its first and last quarter:
    the cards' mean idle share is 25%, and card 1's gap is named by the
    innermost host operation running as it began."""
    dev = [("k0", 0.0, 600e3, 0), ("k0", 600e3, 400e3, 0),
           ("k1", 0.0, 250e3, 1), ("k1", 750e3, 250e3, 1)]
    host = [("spim/rl.view", 200e3, 100e3), ("aten::copy_", 240e3, 30e3)]
    tr = harness.Trace(dev, host, 1.0, 1, {}, {}, [], cards=2)
    assert tr.busy_s_by_card == [1.0, 0.5]
    assert tr.busy_s == 0.75
    assert tr.device_ops == [op[:3] for op in dev]
    idle = harness.load_module(REPO / "benchmark/metrics/idle_share.rl.py",
                               "test_metric_idle_share_rl").read(tr)
    assert idle == pytest.approx(25.0)
    assert tr.breakdown() == {"device_ops": [["k0", 1.0], ["k1", 0.5]],
                              "idle_gaps": [["aten::copy_", 0.5]]}
    # read as one card, the union of both is busy the whole stretch
    assert harness.Trace(dev, host, 1.0, 1, {}, {}, []).busy_s == 1.0


def test_one_card_trace_is_the_parents_arithmetic():
    rng = random.Random(5)
    dev = [(rng.choice("abcd"), rng.uniform(0, 1e6), rng.uniform(1, 3e3), 0)
           for _ in range(400)]
    host = [(rng.choice("xyz"), rng.uniform(0, 1e6), rng.uniform(1, 2e4))
            for _ in range(200)]
    busy_s, breakdown = parent_arithmetic([op[:3] for op in dev], host)
    tr = harness.Trace(dev, host, 1.0, 3, {}, {}, [])
    assert tr.busy_s == busy_s and tr.busy_s_by_card == [busy_s]
    assert tr.breakdown() == breakdown
    assert breakdown["idle_gaps"]


@pytest.mark.cuda
def test_the_toy_cell_runs_on_two_cards(tmp_path):
    """The two-card toy cell at its own size on cuda:0 and cuda:1."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    root = checkout(tmp_path, toy=True)
    cell = harness.Cell(TOY_CELL, root=root, bench=root / "benchmark")
    for trace in (False, True):
        r = harness.run_cell(cell, 2**31 + 17, 2.0, trace,
                             time.perf_counter())
        print(json.dumps({k: r[k] for k in ("metrics", "device", "checks")}))
        assert r["correct"], r["checks"]
        dev = r["device"]
        assert dev["count"] == 2
        assert min(dev["memory_peak_bytes_per_card"]) > 0
        assert dev["memory_peak_bytes"] == max(
            dev["memory_peak_bytes_per_card"])
    assert min(dev["busy_s_per_card"]) > 0
    assert dev["busy_s"] == pytest.approx(sum(dev["busy_s_per_card"]) / 2)


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
