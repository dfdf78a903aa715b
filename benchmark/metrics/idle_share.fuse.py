"""The device's idle share over the traced fusion jobs, in %: 100 (1 -
busy / wall), where wall is the summed host-clock length of the
`spim/fuse.run` ranges that `fuse_views` opens while a profiler runs
(`fuse/weighted_avg.py`; the profiler's clock, as the device
operations'), and busy the union of the device operations within them.
A job waits on the host link and the host's copies, which show here; the
harness's own work between jobs does not. Nothing to read unless there
is one such range a traced job."""

RUN = "spim/fuse.run"


def read(trace):
    runs = sorted((s, s + d) for n, s, d in trace.host_ops if n == RUN)
    wall = sum(e - s for s, e in runs)
    if len(runs) != trace.jobs or wall <= 0:
        return None
    busy = sum(max(0.0, min(e, re) - max(s, rs))
               for rs, re in runs for s, e in trace.intervals_by_card[0])
    return 100.0 * (1.0 - busy / wall)
