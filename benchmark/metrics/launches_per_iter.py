"""Device kernels a Richardson-Lucy iteration: the profiler's kernel count
over the traced jobs (copies and fills left out) over their iterations."""


def read(trace):
    iters = trace.facts.get("iterations")
    n = trace.kernel_count()
    if not iters or not n:
        return None
    return n / (trace.jobs * iters)
