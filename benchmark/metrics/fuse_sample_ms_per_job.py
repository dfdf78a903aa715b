"""Device milliseconds a fusion job in sampling: the `spim/fuse.sample`
phases (each output chunk's views sampled, weighted and summed) that
`fuse_views` marks with CUDA events while a profiler runs
(`fuse/weighted_avg.py`, `utils/profiling.py` `PhaseTimer`), over the
traced jobs. Nothing to read unless the port counted exactly the traced
jobs (one `spim/fuse.run` a job, and `fuse.h2d_bytes`, `fuse.d2h_bytes`
and the view-chunks those jobs move), or where no phase was timed on the
device."""


def fuse_phase_ms(trace, names):
    """The summed device ms of the phases `names` over the traced jobs,
    a job; None where the port's spans and counters do not fit them."""
    from spim_registration_tpu_torch.utils import profiling

    read_spans = getattr(profiling, "read_spans", None)
    f, c, jobs = trace.facts, trace.counters, trace.jobs
    if read_spans is None or not f.get("views") or not jobs:
        return None
    if (c.get("fuse.h2d_bytes") != f["h2d_bytes_per_job"] * jobs
            or c.get("fuse.d2h_bytes") != f["d2h_bytes_per_job"] * jobs
            or c.get("fuse.aligned_view_chunks", 0)
            + c.get("fuse.affine_view_chunks", 0)
            != f["views"] * c.get("fuse.chunks", -1)):
        return None
    totals = read_spans()["totals"]
    if totals.get("spim/fuse.run", {}).get("count", 0) != jobs:
        return None
    ms = sum(totals.get(n, {}).get("device_ms", 0.0) for n in names)
    return ms / jobs if ms > 0 else None


def read(trace):
    return fuse_phase_ms(trace, ["spim/fuse.sample"])
