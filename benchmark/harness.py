"""One run of one cell of the port's benchmark.

A cell (an entry of `workloads` in BENCHMARK.json) names a configuration
and a traffic mix. Everything else is found by name:

- `configs/<config>.json` (the file that BENCHMARK.json gives): the
  acquisition, its sizes, `assumed` and `reduced`;
- `traffic/<traffic>.json`: the job kind (`"job"`) and its parameters;
- `jobs/<kind>.py`: `setup(config, traffic, seed, device)` returns the
  cell's job (see `jobs/__init__.py` for what a job offers);
- `limits/<cell>.json`: each number that decides `correct`, its limit and
  the readings the limit was set from;
- `metrics/<name>.py`: `read(trace)` turns a traced run into one
  per-layer number, or None where the cell has nothing to read.

The loop is closed: each job starts when the one before it has returned,
as a user's script works through the timepoints of a timelapse. The window
starts jobs until `seconds` have passed; a rate is all the work of the
jobs completed over the window's whole wall time, and the tail is taken
over all of them.
"""

from __future__ import annotations

import bisect
import gc
import importlib.util
import json
import math
import random
import sys
import time
import traceback
from pathlib import Path

import numpy as np

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# top-level module names that no run may load (compared whole: the port's
# name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "spim_registration_tpu")
# jobs of the window that run before the traced stretch starts
TRACE_SKIP = 2


class CellError(Exception):
    """The run cannot be made: no card, a missing file, a forbidden
    import. The result line is not printed."""


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """A module of the benchmark by its file (metric files carry dots in
    their names, so they are not importable by name)."""
    if not path.is_file():
        raise CellError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A workload of BENCHMARK.json with its files, found by name under
    `bench` (the benchmark's folder) and `root` (the checkout)."""

    def __init__(self, name: str, root: Path = ROOT, bench: Path = BENCH):
        spec_path = root / "BENCHMARK.json"
        if not spec_path.is_file():
            raise CellError(f"no {spec_path}")
        self.spec = load_json(spec_path)
        cells = {w["name"]: w for w in self.spec["workloads"]}
        if name not in cells:
            raise CellError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.workload = cells[name]
        self.chips = int(self.workload["chips"])
        cfg = {c["name"]: c for c in self.spec["configs"]}[
            self.workload["config"]]
        self.bench = bench
        self.config = load_json(root / cfg["file"])
        self.traffic = load_json(bench / "traffic"
                                 / f"{self.workload['traffic']}.json")
        self.kind = self.traffic["job"]
        self._job = None
        self.limits = load_json(bench / "limits" / f"{name}.json")
        self.end_to_end = [m for m in self.spec["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in self.spec["per_layer"]
                          if name in m["workloads"]]

    def job_module(self):
        if self._job is None:
            self._job = load_module(self.bench / "jobs" / f"{self.kind}.py",
                                    f"bench_job_{self.kind}")
        return self._job

    def metric_reader(self, name: str):
        return load_module(self.bench / "metrics" / f"{name}.py",
                           f"bench_metric_{name.replace('.', '_')}")


# --- the arithmetic of the end-to-end metrics ------------------------------

def end_to_end(log: list, window_s: float, setup_s: float,
               work: dict, wanted) -> dict:
    """The cell's end-to-end metrics from the window's job log.

    `log`: one (start_s, end_s) per completed job, from the window's
    start; `window_s`: from the window's start to the end of its last
    job; `work`: each rate metric's units in one job. `setup_s` and
    `job_p95_s` (also `job_p95_s.<kind>`: the same tail under a bound of
    its own) are the same for every kind of job; any other metric is a
    rate: its units in all completed jobs over `window_s`."""
    out = {}
    for m in wanted:
        name = m["name"]
        if name == "setup_s":
            v = setup_s
        elif name.split(".")[0] == "job_p95_s":
            v = float(np.percentile([e - s for s, e in log], 95))
        else:
            v = work[name] * len(log) / window_s
        out[name] = {"value": v, "unit": m["unit"]}
    return out


# --- the traced stretch ----------------------------------------------------

class Trace:
    """What a per-layer reader reads: the device operations of the traced
    stretch (name, start and length in microseconds on the profiler's
    clock), its wall (`window_s`) and the device's busy seconds, the jobs
    it held, the job's facts (`job.facts()`), the launch counters' growth
    over the stretch and every window job's spans (`job.spans`)."""

    def __init__(self, device_ops, host_ops, window_s, jobs, facts,
                 counters, spans):
        self.device_ops = device_ops
        self.host_ops = host_ops
        self.window_s = window_s
        self.jobs = jobs
        self.facts = facts
        self.counters = counters
        self.spans = spans
        self.intervals = merge_intervals(
            (s, s + d) for _, s, d in device_ops)
        self.busy_s = sum(e - s for s, e in self.intervals) / 1e6

    def kernel_seconds(self, pattern: str) -> float:
        return sum(d for n, _, d in self.device_ops if pattern in n) / 1e6

    def kernel_count(self, pattern: str = "") -> int:
        return sum(1 for n, _, _ in self.device_ops
                   if pattern in n and not n.startswith(("Memcpy",
                                                         "Memset")))

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle gaps
        between them summed by the innermost host operation that was
        running when each gap began."""
        by_op: dict = {}
        for n, _, d in self.device_ops:
            by_op[n] = by_op.get(n, 0.0) + d / 1e6
        ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
        host = sorted(self.host_ops, key=lambda h: h[1])
        starts = [h[1] for h in host]
        gaps: dict = {}
        for (_, e0), (s1, _) in zip(self.intervals, self.intervals[1:]):
            i = bisect.bisect_right(starts, e0)
            name = "(no host operation)"
            for n, s, d in reversed(host[max(0, i - 400):i]):
                if s + d > e0:
                    name = n
                    break
            gaps[name] = gaps.get(name, 0.0) + (s1 - e0) / 1e6
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:160], v] for n, v in ops],
                "idle_gaps": [[n[:160], v] for n, v in idle]}


def merge_intervals(intervals) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def profiler_events(prof):
    """(device operations, host operations) of a finished
    torch.profiler session as (name, start_us, length_us) lists."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in prof.events():
        rng = (e.name, float(e.time_range.start),
               float(e.time_range.elapsed_us()))
        if e.device_type == DeviceType.CUDA:
            dev.append(rng)
        elif e.device_type == DeviceType.CPU:
            host.append(rng)
    return dev, host


# --- one run ---------------------------------------------------------------

def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def forbidden_modules() -> list:
    loaded = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(loaded.intersection(FORBIDDEN))


def check_numbers(numbers: dict, limits: dict) -> tuple:
    """Each number with a limit against it: (all held, [(name, value,
    limit, held)]). A number the check did not produce fails."""
    rows = []
    for name, lim in limits["numbers"].items():
        v = numbers.get(name)
        if v is None or not math.isfinite(v):
            held = False
        elif lim["better"] == "lower":
            held = v <= lim["limit"]
        else:
            held = v >= lim["limit"]
        rows.append((name, v, lim["limit"], held))
    return all(r[3] for r in rows), rows


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             t_start: float, device=None, log=sys.stderr,
             control: bool = False) -> dict:
    """Set up, warm up, run the window and check one cell; returns the
    result line (as a dict, its `checks` key last). `device` None means
    the card the cell asks for; tests pass a CPU device. `control` adds
    every number of the check (`readings`) and the control's numbers on
    the same inputs (`control`), as `calibrate.py` reads them."""
    import torch

    if device is None:
        if not torch.cuda.is_available():
            raise CellError("torch.cuda.is_available() is false")
        if torch.cuda.device_count() < cell.chips:
            raise CellError(f"{torch.cuda.device_count()} card(s), the cell "
                            f"asks for {cell.chips}")
        device = torch.device("cuda", 0)
        torch.empty(1, device=device)       # starts the caching allocator
        torch.cuda.reset_peak_memory_stats(device)
    job = cell.job_module().setup(cell.config, cell.traffic, seed, device)
    job.warm_up()
    sync(device)
    t0 = time.perf_counter()
    setup_s = t0 - t_start

    sample = job.sample
    pick = random.Random(seed * 7919 + 17)
    kept, spans, jobs_log = [], [], []
    failed = attempted = 0
    prof = None
    traced = None
    trace_end = TRACE_SKIP + job.trace_jobs
    deadline = t0 + seconds
    i = 0
    while time.perf_counter() < deadline or (trace and i < trace_end):
        if trace and i == TRACE_SKIP:
            prof, traced = start_profile(device, job)
        attempted += 1
        s = time.perf_counter() - t0
        try:
            answer = job.run(i)
        except Exception:       # a failed job is counted, the loop goes on
            failed += 1
            if failed == 1:
                traceback.print_exc(file=log)
            answer = None
        e = time.perf_counter() - t0
        if answer is not None:
            jobs_log.append((s, e))
            spans.append(job.spans(answer))
            rec = job.keep(i, answer)
            n = len(jobs_log) - 1
            if sample is None or len(kept) < sample:
                kept.append(rec)
            else:
                j = pick.randrange(n + 1)
                if j < sample:
                    kept[j] = rec
        del answer
        i += 1
        if prof is not None and i == trace_end:
            traced = stop_profile(prof, traced, device, job)
            prof = None
    window_s = (jobs_log[-1][1] if jobs_log else
                time.perf_counter() - t0)
    if jobs_log:
        walls = [e - s for s, e in jobs_log]
        print(f"benchmark: {len(walls)} jobs in {window_s:.3f} s, job wall "
              f"min {min(walls):.4f} median {np.median(walls):.4f} "
              f"max {max(walls):.4f} s", file=log)

    mem = (torch.cuda.max_memory_allocated(device)
           if device.type == "cuda" else 0)
    result = {"correct": False, "attempted": attempted, "failed": failed}
    if trace:
        tr = Trace(*traced[:2], traced[2], job.trace_jobs, job.facts(),
                   traced[3], spans)
        metrics = {}
        for m in cell.per_layer:
            v = cell.metric_reader(m["name"]).read(tr)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = end_to_end(jobs_log, window_s, setup_s, job.work,
                             cell.end_to_end)
    result["metrics"] = metrics
    result["device"] = device_info(device, cell.chips, mem)
    if trace:
        result["device"]["busy_s"] = tr.busy_s
        result["device"]["window_s"] = tr.window_s
        result["breakdown"] = tr.breakdown()

    job.free()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = job.check(kept)
    if control:
        result["readings"] = numbers
        result["control"] = cell.job_module().control(job)
    del job, kept
    held, rows = check_numbers(numbers, cell.limits)
    result["correct"] = bool(held and failed == 0 and jobs_log)
    result["checks"] = {n: {"value": v, "limit": lim, "held": h}
                        for n, v, lim, h in rows}
    return result


def start_profile(device, job):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.__enter__()
    sync(device)
    return prof, (time.perf_counter(), job.counters())


def stop_profile(prof, started, device, job):
    sync(device)
    t1 = time.perf_counter()
    counts = job.counters()
    prof.__exit__(None, None, None)
    t0, c0 = started
    dev, host = profiler_events(prof)
    grown = {k: counts[k] - c0.get(k, 0) for k in counts}
    return dev, host, t1 - t0, grown


def device_info(device, chips: int, mem: int) -> dict:
    import torch

    if device.type == "cuda":
        return {"platform": "gpu",
                "kind": torch.cuda.get_device_name(device),
                "count": chips, "memory_peak_bytes": int(mem)}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": 0}


def report(result: dict, out=sys.stdout, err=sys.stderr) -> None:
    """The checks as the last lines of standard error, then the result as
    the last line of standard output."""
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} limit {c['limit']!r} "
              f"{'held' if c['held'] else 'FAILED'}", file=err)
    err.flush()
    print(json.dumps(result), file=out, flush=True)
