"""One run of one cell of the port's benchmark.

A cell (an entry of `workloads` in BENCHMARK.json) names a configuration
and a traffic mix. Everything else is found by name:

- `configs/<config>.json` (the file that BENCHMARK.json gives): the
  acquisition, its sizes, `assumed` and `reduced`;
- `traffic/<traffic>.json`: the job kind (`"job"`) and its parameters;
- `jobs/<kind>.py`: `setup(config, traffic, seed, device)` returns the
  cell's job (see `jobs/__init__.py` for what a job offers); a cell of
  `chips` n > 1 gets `setup(config, traffic, seed, device=cuda:0,
  devices=[cuda:0, ..., cuda:n-1])`;
- `limits/<cell>.json`: each number that decides `correct`, its limit and
  the readings the limit was set from;
- `metrics/<name>.py`: `read(trace)` turns a traced run into one
  per-layer number, or None where the cell has nothing to read.

The CPU tests under `tests/` find a cell's cut to test size by the same
names: `tests/cuts/configs/<config>.json` (`tiny`: the configuration at
test size; `cpu`: at the size the control runs at on the CPU, where the
traffic's cut has a `cpu` key too), `tests/cuts/traffic/<traffic>.json`
(`tiny`, and `cpu` where the control runs the cell's own traffic),
`tests/cuts/limits/<cell>.json` (a limit that does not hold at test
size), and the faults that a kind's timed path can have in
`tests/faults/<kind>.py` (`FAULTS`; see `tests/faults/rl.py`).

To add a configuration and a cell: the configuration's file and its
entry in `configs`; a traffic file (and a job kind where no kind fits,
with its faults file); `limits/<cell>.json`; a reader for each new
per-layer metric; the cut files; the cell's entry in `workloads` and
its name in the `workloads` of each metric it reports (a new metric's
entry where it reports one). `tests/toy/` is such an addition, a job
kind and a cell of two cards, that the tests add to a checkout.

The loop is closed: each job starts when the one before it has returned,
as a user's script works through the timepoints of a timelapse. The window
starts jobs until `seconds` have passed; a rate is all the work of the
jobs completed over the window's whole wall time, and the tail is taken
over all of them. A cell of several cards is synchronised, traced and
read for its peak memory on each of them.
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
    over the stretch and every window job's spans (`job.spans`).

    `device_ops` come as `profiler_events` gives them, each with its card
    as a fourth entry. Over `cards` > 1, `busy_s_by_card` is the union of
    each card's own operations and `busy_s` their mean, so that 1 - busy /
    wall is the cards' mean idle share; on one card every operation is
    the card's."""

    def __init__(self, device_ops, host_ops, window_s, jobs, facts,
                 counters, spans, cards: int = 1):
        self.device_ops = [op[:3] for op in device_ops]
        self.host_ops = host_ops
        self.window_s = window_s
        self.jobs = jobs
        self.facts = facts
        self.counters = counters
        self.spans = spans
        by_card = [[] for _ in range(cards)]
        for op in device_ops:
            card = op[3] if cards > 1 else 0
            if 0 <= card < cards:
                by_card[card].append((op[1], op[1] + op[2]))
        self.intervals_by_card = [merge_intervals(c) for c in by_card]
        self.busy_s_by_card = [sum(e - s for s, e in iv) / 1e6
                               for iv in self.intervals_by_card]
        self.busy_s = sum(self.busy_s_by_card) / cards

    def kernel_seconds(self, pattern: str) -> float:
        return sum(d for n, _, d in self.device_ops if pattern in n) / 1e6

    def kernel_count(self, pattern: str = "") -> int:
        return sum(1 for n, _, _ in self.device_ops
                   if pattern in n and not n.startswith(("Memcpy",
                                                         "Memset")))

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle gaps
        between them summed by the innermost host operation that was
        running when each gap began (each card's gaps between its own
        operations, summed over the cards)."""
        by_op: dict = {}
        for n, _, d in self.device_ops:
            by_op[n] = by_op.get(n, 0.0) + d / 1e6
        ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
        host = sorted(self.host_ops, key=lambda h: h[1])
        starts = [h[1] for h in host]
        gaps: dict = {}
        for iv in self.intervals_by_card:
            for (_, e0), (s1, _) in zip(iv, iv[1:]):
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
    torch.profiler session as (name, start_us, length_us) lists, each
    device operation with its card's index as a fourth entry."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in prof.events():
        rng = (e.name, float(e.time_range.start),
               float(e.time_range.elapsed_us()))
        if e.device_type == DeviceType.CUDA:
            dev.append((*rng, int(e.device_index)))
        elif e.device_type == DeviceType.CPU:
            host.append(rng)
    return dev, host


# --- one run ---------------------------------------------------------------

def sync(devices) -> None:
    """Waits for every card of `devices`."""
    import torch

    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def reset_peaks(devices) -> None:
    """Starts each card's caching allocator and resets its peak memory."""
    import torch

    for d in devices:
        if d.type == "cuda":
            torch.empty(1, device=d)
            torch.cuda.reset_peak_memory_stats(d)


def read_peaks(devices) -> list:
    """Each device's peak memory in bytes since `reset_peaks` (0 off a
    card)."""
    import torch

    return [int(torch.cuda.max_memory_allocated(d)) if d.type == "cuda"
            else 0 for d in devices]


def free_cache(devices) -> None:
    """Empties each card's caching allocator."""
    import torch

    for d in devices:
        if d.type == "cuda":
            with torch.cuda.device(d):
                torch.cuda.empty_cache()


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


def start_job(cell: Cell, seed: int, devices, config: dict = None,
              traffic: dict = None):
    """The cell's job set up on `devices`, the cell's cards in order (the
    cell's own configuration and traffic unless others are given): one
    card's kind is called as `setup(config, traffic, seed, device)`,
    several cards' as `setup(..., device=devices[0], devices=devices)`."""
    mod = cell.job_module()
    config = cell.config if config is None else config
    traffic = cell.traffic if traffic is None else traffic
    if len(devices) == 1:
        return mod.setup(config, traffic, seed, devices[0])
    return mod.setup(config, traffic, seed, device=devices[0],
                     devices=list(devices))


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             t_start: float, devices=None, log=sys.stderr,
             control: bool = False) -> dict:
    """Set up, warm up, run the window and check one cell; returns the
    result line (as a dict, its `checks` key last). `devices` None means
    the cards the cell asks for, cuda:0 to cuda:n-1; tests pass CPU
    devices, one for each card. `control` adds every number of the check
    (`readings`) and the control's numbers on the same inputs
    (`control`), as `calibrate.py` reads them."""
    import torch

    if devices is None:
        if not torch.cuda.is_available():
            raise CellError("torch.cuda.is_available() is false")
        if torch.cuda.device_count() < cell.chips:
            raise CellError(f"{torch.cuda.device_count()} card(s), the cell "
                            f"asks for {cell.chips}")
        devices = [torch.device("cuda", i) for i in range(cell.chips)]
    if len(devices) != cell.chips:
        raise CellError(f"{len(devices)} device(s) given, the cell asks "
                        f"for {cell.chips}")
    reset_peaks(devices)
    job = start_job(cell, seed, devices)
    job.warm_up()
    sync(devices)
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
            prof, traced = start_profile(devices, job)
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
            traced = stop_profile(prof, traced, devices, job)
            prof = None
    window_s = (jobs_log[-1][1] if jobs_log else
                time.perf_counter() - t0)
    if jobs_log:
        walls = [e - s for s, e in jobs_log]
        print(f"benchmark: {len(walls)} jobs in {window_s:.3f} s, job wall "
              f"min {min(walls):.4f} median {np.median(walls):.4f} "
              f"max {max(walls):.4f} s", file=log)

    mems = read_peaks(devices)
    result = {"correct": False, "attempted": attempted, "failed": failed}
    if trace:
        tr = Trace(*traced[:2], traced[2], job.trace_jobs, job.facts(),
                   traced[3], spans, cards=len(devices))
        metrics = {}
        for m in cell.per_layer:
            v = cell.metric_reader(m["name"]).read(tr)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = end_to_end(jobs_log, window_s, setup_s, job.work,
                             cell.end_to_end)
    result["metrics"] = metrics
    result["device"] = device_info(devices, mems)
    if trace:
        result["device"]["busy_s"] = tr.busy_s
        result["device"]["window_s"] = tr.window_s
        if len(devices) > 1:
            result["device"]["busy_s_per_card"] = tr.busy_s_by_card
        result["breakdown"] = tr.breakdown()

    job.free()
    gc.collect()
    free_cache(devices)
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


def start_profile(devices, job):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if any(d.type == "cuda" for d in devices):
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.__enter__()
    sync(devices)
    return prof, (time.perf_counter(), job.counters())


def stop_profile(prof, started, devices, job):
    sync(devices)
    t1 = time.perf_counter()
    counts = job.counters()
    prof.__exit__(None, None, None)
    t0, c0 = started
    dev, host = profiler_events(prof)
    grown = {k: counts[k] - c0.get(k, 0) for k in counts}
    return dev, host, t1 - t0, grown


def device_info(devices, mems: list) -> dict:
    """The result's `device`: the fullest card's peak memory, and over
    several cards each card's (`memory_peak_bytes_per_card`)."""
    import torch

    if devices[0].type == "cuda":
        info = {"platform": "gpu",
                "kind": torch.cuda.get_device_name(devices[0]),
                "count": len(devices), "memory_peak_bytes": max(mems)}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": len(devices),
                "memory_peak_bytes": 0}
    if len(devices) > 1:
        info["memory_peak_bytes_per_card"] = mems
    return info


def report(result: dict, out=sys.stdout, err=sys.stderr) -> None:
    """The checks as the last lines of standard error, then the result as
    the last line of standard output."""
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} limit {c['limit']!r} "
              f"{'held' if c['held'] else 'FAILED'}", file=err)
    err.flush()
    print(json.dumps(result), file=out, flush=True)
