"""Seconds of matching a view pair: `RegistrationResult.timings["match"]`
summed over the window's jobs, over their pairs."""


def read(trace):
    spans = [s for s in trace.spans if "match" in s.get("timings", {})]
    if not spans:
        return None
    return (sum(s["timings"]["match"] for s in spans)
            / sum(s["pairs"] for s in spans))
