"""Profiling helpers: spans, stage timers and traces.

Port of the reference's `utils/profiling.py` (stage timers that wait for
the device before they stop the clock, `device_fence`; `trace`, a
`torch.profiler` trace of a block written as a Chrome trace, the
counterpart of the reference's `xla_trace` and the CLI's `--profile DIR`)
and the port's spans:

- `span(name)`: an interval on `time.perf_counter`, kept by the
  process-wide recorder (totals by name and the last records) with its
  parent span and run id. While a torch profiler runs, it also opens a
  profiler range of the same name, which lands among the profiler's host
  events on the clock of its device trace.
- `PhaseTimer`: the phases of every Richardson-Lucy view update of one
  run (conv and update; halo, conv and update on each card of the
  sharded engine's mesh), or of one fusion run (upload, content, sample
  and download), marked with CUDA events in stream order (the host clock
  for CPU tensors) and resolved only when the recorder is read; the
  recorder sums a phase over the cards and counts them.
- `read_spans()` / `reset_spans()`: the recorder's totals and records.

Span names carry the prefix `spim/`.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import Dict, NamedTuple, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

from spim_registration_tpu_torch.utils.log import get_logger

logger = get_logger("profile")

PREFIX = "spim/"
# the engine's spans (while a profiler runs) and its two phases
RL_RUN = "spim/rl.run"
RL_ITERATION = "spim/rl.iteration"
RL_VIEW = "spim/rl.view"
CONV = "spim/rl.conv"
UPDATE = "spim/rl.update"
# the sharded engine (parallel/sharded.py): its staging (always on), its
# spans while a profiler runs, and its three phases on each card
MESH_STAGE = "spim/mesh.stage"
MESH_DECOMPOSE = "spim/mesh.decompose"
MESH_RUN = "spim/mesh.run"
MESH_ITERATION = "spim/mesh.iteration"
MESH_VIEW = "spim/mesh.view"
MESH_HALO = "spim/mesh.halo"
MESH_CONV = "spim/mesh.conv"
MESH_UPDATE = "spim/mesh.update"
# fusion (fuse/weighted_avg.py fuse_views), while a profiler runs: the run
# and its four phases
FUSE_RUN = "spim/fuse.run"
FUSE_UPLOAD = "spim/fuse.upload"
FUSE_CONTENT = "spim/fuse.content"
FUSE_SAMPLE = "spim/fuse.sample"
FUSE_DOWNLOAD = "spim/fuse.download"


def device_fence(x: torch.Tensor) -> None:
    """Wait for `x` to be computed: a synchronize of its CUDA device (a
    CPU tensor is computed when the call that made it returns)."""
    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)


def profiler_active() -> bool:
    """Whether a torch profiler is recording (a global's read: cheap
    enough for a hot path)."""
    return _autograd_profiler._is_profiler_enabled


def _open_range(name: str):
    """A profiler range around the caller's block, entered: an op-scoped
    `_RecordFunctionFast`. (The user-scoped range of `record_function` is
    mirrored on the device timeline as an annotation over the kernels it
    covers, which a trace's device operations would then count as
    work.)"""
    rng = torch._C._profiler._RecordFunctionFast(name)
    rng.__enter__()
    return rng


class SpanRecord(NamedTuple):
    """One closed span or phase. `start` / `end`: `time.perf_counter`
    seconds (None for a phase timed on the device); `device_ms`: a
    phase's summed device time."""
    name: str
    start: Optional[float]
    end: Optional[float]
    parent: Optional[str]
    run_id: Optional[int]
    device_ms: Optional[float] = None


class Recorder:
    """Spans of the process: totals by name (count, host seconds, device
    ms, and for a phase recorded on named cards the number of cards) and
    the last `keep` records. Device phases wait unresolved until the
    recorder is read, or until `max_pending` of them wait (then the
    newest is waited for)."""

    def __init__(self, keep: int = 4096, max_pending: int = 8192):
        self.keep = keep
        self.max_pending = max_pending
        self._lock = threading.Lock()
        self._local = threading.local()
        self._run_ids = itertools.count(1)
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self._totals: Dict[str, list] = {}
            self._cards: Dict[str, set] = {}
            self._records = collections.deque(maxlen=self.keep)
            self._pending: list = []

    def stack(self) -> list:
        """The open spans of the calling thread, innermost last."""
        s = getattr(self._local, "stack", None)
        if s is None:
            s = self._local.stack = []
        return s

    def new_run_id(self) -> int:
        return next(self._run_ids)

    def add(self, rec: SpanRecord, host_s: float,
            device_ms: float = 0.0, card: Optional[str] = None) -> None:
        with self._lock:
            t = self._totals.setdefault(rec.name, [0, 0.0, 0.0])
            t[0] += 1
            t[1] += host_s
            t[2] += device_ms
            if card is not None:
                self._cards.setdefault(rec.name, set()).add(card)
            self._records.append(rec)

    def add_pending(self, name: str, pairs: list, parent: Optional[str],
                    run_id: Optional[int], card: Optional[str] = None
                    ) -> None:
        """A device phase: `pairs` of recorded CUDA events, its
        intervals; `card` names the card they were recorded on."""
        with self._lock:
            self._pending.append((name, pairs, parent, run_id, card))
            full = len(self._pending) >= self.max_pending
        if full:
            self._resolve()

    def _resolve(self) -> None:
        with self._lock:
            pending, self._pending = self._pending, []
        for name, pairs, parent, run_id, card in pending:
            pairs[-1][1].synchronize()
            ms = sum(a.elapsed_time(b) for a, b in pairs)
            self.add(SpanRecord(name, None, None, parent, run_id, ms),
                     0.0, ms, card)

    def read(self) -> dict:
        """{"totals": {name: {"count", "host_s", "device_ms"[, "cards"]}},
        "records": [SpanRecord, ...]} (oldest record first); "cards" is
        there for a phase recorded on named cards."""
        self._resolve()
        with self._lock:
            totals = {n: {"count": c, "host_s": h, "device_ms": d}
                      for n, (c, h, d) in self._totals.items()}
            for n, cards in self._cards.items():
                totals[n]["cards"] = len(cards)
            return {"totals": totals, "records": list(self._records)}


RECORDER = Recorder()


def read_spans() -> dict:
    """The process recorder's totals and last records (`Recorder.read`)."""
    return RECORDER.read()


def reset_spans() -> None:
    RECORDER.reset()


class span:
    """Context manager: the block as a span `name` (prefix `spim/`) of
    the process recorder; its parent is the thread's innermost open span,
    whose run id it takes unless given one. After the block, `seconds`
    holds its length."""

    __slots__ = ("name", "run_id", "seconds", "_parent", "_range", "_t0")

    def __init__(self, name: str, run_id: Optional[int] = None):
        self.name = name
        self.run_id = run_id
        self.seconds = 0.0

    def __enter__(self) -> "span":
        stack = RECORDER.stack()
        parent = stack[-1] if stack else None
        self._parent = parent.name if parent is not None else None
        if self.run_id is None and parent is not None:
            self.run_id = parent.run_id
        stack.append(self)
        self._range = _open_range(self.name) if profiler_active() else None
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        t1 = time.perf_counter()
        if self._range is not None:
            self._range.__exit__(None, None, None)
        RECORDER.stack().pop()
        self.seconds = t1 - self._t0
        RECORDER.add(SpanRecord(self.name, self._t0, t1, self._parent,
                                self.run_id), self.seconds)


class PhaseTimer:
    """The phases of every view update of one RL run, on each device it
    runs on: by default `conv` and `update` under the RL engine's
    iteration and view spans; the sharded engine gives its mesh's cards
    and `halo`, `conv` and `update` under its own spans. Fusion opens one
    unit, its run span, and laps `upload`, `content`, `sample` and
    `download` in it.

    `lap(phase)` closes, on every device, the interval since that
    device's last lap, in stream order, and gives it to `phase` of the
    open view; the laps run on without a gap from the first view's start,
    so what follows a view's last lap (the parallel scheme's update of the
    estimate) belongs to that view. A view's records, one a phase and
    device, go to the recorder when the next view opens or the timer
    closes; the recorder counts the cards a phase was recorded on. On a
    CUDA device each lap records an event on its current stream and
    nothing waits for the device until the recorder is read; elsewhere
    the host clock. A card's phases are its stream time: its kernels, its
    copies, and on a mesh where it waits for the host thread that drives
    the other cards."""

    def __init__(self, devices, run_id: int, phases=(CONV, UPDATE),
                 spans=(RL_ITERATION, RL_VIEW)):
        if isinstance(devices, (str, torch.device)):
            devices = [devices]
        self.devices = list(dict.fromkeys(torch.device(d) for d in devices))
        self._streams = {d: torch.cuda.current_stream(d)
                         for d in self.devices if d.type == "cuda"}
        self.run_id = run_id
        self.phases = tuple(phases)
        self._iteration, self._view = spans
        self._laps: Optional[dict] = None
        self._last: dict = {}

    def _mark(self, d: torch.device):
        stream = self._streams.get(d)
        if stream is None:
            return time.perf_counter()
        e = torch.cuda.Event(enable_timing=True)
        e.record(stream)
        return e

    def lap(self, phase: str) -> None:
        for d in self.devices:
            now = self._mark(d)
            self._laps[d][phase].append((self._last[d], now))
            self._last[d] = now

    def iteration(self) -> span:
        return span(self._iteration)

    def view(self) -> span:
        self._flush()
        self._laps = {d: {p: [] for p in self.phases} for d in self.devices}
        if not self._last:              # the laps start with the first view
            self._last = {d: self._mark(d) for d in self.devices}
        return span(self._view, self.run_id)

    def close(self) -> None:
        self._flush()

    def _flush(self) -> None:
        if self._laps is None:
            return
        for d, phases in self._laps.items():
            for phase, pairs in phases.items():
                if not pairs:
                    continue
                if d in self._streams:
                    RECORDER.add_pending(phase, pairs, self._view,
                                         self.run_id, str(d))
                else:
                    RECORDER.add(SpanRecord(phase, pairs[0][0],
                                            pairs[-1][1], self._view,
                                            self.run_id),
                                 sum(b - a for a, b in pairs), card=str(d))
        self._laps = None


@contextlib.contextmanager
def stage_timer(name: str, timings: Optional[Dict[str, float]] = None):
    """Time a stage as the span `spim/<name>`; pass its output tensor to
    the yielded setter to wait for the device before the clock stops.
    Logs the stage's seconds and adds them to `timings[name]`."""
    holder = {}

    def set_fence(t):
        holder["out"] = t
        return t

    s = span(PREFIX + name)
    try:
        with s:
            try:
                yield set_fence
            finally:
                if "out" in holder:
                    device_fence(holder["out"])
    finally:
        logger.info("%s: %.3fs", name, s.seconds)
        if timings is not None:
            timings[name] = timings.get(name, 0.0) + s.seconds


@contextlib.contextmanager
def trace(log_dir: str):
    """`torch.profiler` trace of the block: host operators, and the CUDA
    kernels and copies where a card is present, written into `log_dir` as
    `<host>_<pid>.<time>.pt.trace.json` (Chrome trace format: Perfetto,
    chrome://tracing or TensorBoard's profiler plugin read it). On exit,
    logs each span name recorded in the block: its count, host seconds
    and device ms."""
    from torch.profiler import (
        ProfilerActivity,
        profile,
        tensorboard_trace_handler,
    )

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    before = read_spans()["totals"]
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    zero = {"count": 0, "host_s": 0.0, "device_ms": 0.0}
    for name, t in sorted(read_spans()["totals"].items()):
        b = before.get(name, zero)
        n = t["count"] - b["count"]
        if n:
            logger.info("span %s: %d, %.3f s host, %.3f ms device", name, n,
                        t["host_s"] - b["host_s"],
                        t["device_ms"] - b["device_ms"])
