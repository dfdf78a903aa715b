"""Seconds of the global solve a job: `RegistrationResult.timings["solve"]`
over the window's jobs that solved."""


def read(trace):
    spans = [s for s in trace.spans if "solve" in s.get("timings", {})]
    if not spans:
        return None
    return sum(s["timings"]["solve"] for s in spans) / len(spans)
