"""Milliseconds a fusion job moving data between the host and the card:
the `spim/fuse.upload` phases (each view from the host onto the card) and
the `spim/fuse.download` phases (each fused chunk into the host array)
that `fuse_views` marks with CUDA events while a profiler runs, over the
traced jobs. Both copies are synchronous, so a phase holds the copy and
the host's part of it. Nothing to read where the port's spans and
counters do not fit the traced jobs
(`fuse_sample_ms_per_job.fuse_phase_ms`)."""

from pathlib import Path

from benchmark.harness import load_module


def read(trace):
    sample = load_module(Path(__file__).with_name("fuse_sample_ms_per_job.py"),
                         "bench_metric_fuse_sample_ms_per_job")
    return sample.fuse_phase_ms(trace, ["spim/fuse.upload",
                                        "spim/fuse.download"])
