"""Seconds of the port's host staging of a `DeconvolutionRunner`: its
`spim/deconv.stage` span (`utils/profiling.py`) over the process's
stagings; nothing to read where the port records no such span."""


def read(trace):
    from spim_registration_tpu_torch.utils import profiling

    read_spans = getattr(profiling, "read_spans", None)
    if read_spans is None:
        return None
    stage = read_spans()["totals"].get("spim/deconv.stage")
    if not stage or not stage["count"]:
        return None
    return stage["host_s"] / stage["count"]
