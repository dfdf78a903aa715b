"""The device's idle share over the traced stretch, in %: 100 (1 - busy /
wall), where busy is the union of the profiler's device operations and
wall the stretch's host-clock length (it starts and ends synchronised)."""


def read(trace):
    if trace.busy_s <= 0 or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
