"""Seconds of the sharded engine's staging: its `spim/mesh.stage` span
(`parallel/sharded.py` `sharded_deconvolution_runner`: each card's slabs
copied from the host and the start computed there, the kernels'
decomposition and matrices; `utils/profiling.py`) over the process's
stagings; nothing to read where the port records no such span."""


def read(trace):
    from spim_registration_tpu_torch.utils import profiling

    read_spans = getattr(profiling, "read_spans", None)
    if read_spans is None:
        return None
    stage = read_spans()["totals"].get("spim/mesh.stage")
    if not stage or not stage["count"]:
        return None
    return stage["host_s"] / stage["count"]
