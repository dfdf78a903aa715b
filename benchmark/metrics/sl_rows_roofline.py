"""The sl_rows kernel's share of its roofline, in %: the sum of its launches'
bounds (`roofline.py`, each launch at its own rank and band, from the
staged matrices) over the traced jobs, over its summed device time;
nothing to read unless the port's launch counter grew by exactly the
launches those bounds count."""


def read(trace):
    bound = trace.facts.get("bound_s", {}).get("sl_rows", 0.0)
    t = trace.kernel_seconds("sl_rows")
    per_job = trace.facts.get("launches_per_job", {}).get("sl_rows", 0)
    want = per_job * trace.jobs
    if bound <= 0 or t <= 0 or trace.counters.get("sl_rows") != want:
        return None
    return 100.0 * bound * trace.jobs / t
