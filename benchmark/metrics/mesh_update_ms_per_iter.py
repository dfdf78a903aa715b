"""Device milliseconds a Richardson-Lucy iteration in the sharded engine's
update phase (all but the exchanges and convolutions: the quotient and
its clamp, `q - 1`, the estimate's update and regularization), the mean
over the cards: the `spim/mesh.update` phases that each card marks with
CUDA events while a profiler runs (`parallel/sharded.py`,
`utils/profiling.py` `PhaseTimer`), summed over the cards, over the cards
and the traced jobs' iterations. Nothing to read unless the port counted
exactly the traced jobs' runs and their halo exchanges
(`halo.exchanges`), or where no phase was timed on a card."""


def phase_ms_per_iter(trace, name: str):
    from spim_registration_tpu_torch.utils import profiling

    read_spans = getattr(profiling, "read_spans", None)
    iters = trace.facts.get("iterations")
    per_job = trace.facts.get("halo_exchanges_per_job")
    if read_spans is None or not iters or not per_job:
        return None
    if trace.counters.get("halo.exchanges") != per_job * trace.jobs:
        return None
    totals = read_spans()["totals"]
    runs = totals.get("spim/mesh.run", {}).get("count", 0)
    phase = totals.get(name, {})
    ms, cards = phase.get("device_ms", 0.0), phase.get("cards", 0)
    if runs != trace.jobs or ms <= 0 or not cards:
        return None
    return ms / (cards * runs * iters)


def read(trace):
    return phase_ms_per_iter(trace, "spim/mesh.update")
