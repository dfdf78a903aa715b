"""Device milliseconds of one view's content weight in fusion (two
separable Gaussian blurs and the normalisation, `fuse/weights.py`
`content_based_weight`): the `spim/fuse.content` phases that `fuse_views`
marks with CUDA events while a profiler runs, over the traced jobs'
views. Nothing to read where the port's spans and counters do not fit the
traced jobs (`fuse_sample_ms_per_job.fuse_phase_ms`)."""

from pathlib import Path

from benchmark.harness import load_module


def read(trace):
    sample = load_module(Path(__file__).with_name("fuse_sample_ms_per_job.py"),
                         "bench_metric_fuse_sample_ms_per_job")
    ms = sample.fuse_phase_ms(trace, ["spim/fuse.content"])
    return None if ms is None else ms / trace.facts["views"]
