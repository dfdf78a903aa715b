"""Device milliseconds a Richardson-Lucy iteration in the `conv` phase of
the view updates (each call into a convolution: the lowrank kernels with
their bf16 cast, cuFFT with its padding, an FFT fallback entry): the
`spim/rl.conv` phases that `DeconvolutionRunner.run` marks with CUDA
events while a profiler runs (`utils/profiling.py`), over the traced
jobs' iterations. Nothing to read unless the port counted exactly the
traced jobs' runs, or where no phase was timed on the device."""


def read(trace):
    from spim_registration_tpu_torch.utils import profiling

    read_spans = getattr(profiling, "read_spans", None)
    iters = trace.facts.get("iterations")
    if read_spans is None or not iters:
        return None
    totals = read_spans()["totals"]
    runs = totals.get("spim/rl.run", {}).get("count", 0)
    ms = totals.get("spim/rl.conv", {}).get("device_ms", 0.0)
    if runs != trace.jobs or ms <= 0:
        return None
    return ms / (runs * iters)
