"""Device milliseconds a Richardson-Lucy iteration in operations other than
the zpass and sl_rows kernels (the update, the quotient, the casts), over
the traced jobs; nothing to read where no zpass kernel ran."""


def read(trace):
    iters = trace.facts.get("iterations")
    if not iters or trace.kernel_count("zpass") == 0:
        return None
    rest = sum(d for n, _, d in trace.device_ops
               if "zpass" not in n and "sl_rows" not in n) / 1e6
    return 1e3 * rest / (trace.jobs * iters)
