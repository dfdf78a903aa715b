"""Seconds of detection a view: `RegistrationResult.timings["detect"]`
summed over the window's jobs, over their views."""


def read(trace):
    spans = [s for s in trace.spans if "detect" in s.get("timings", {})]
    if not spans:
        return None
    return (sum(s["timings"]["detect"] for s in spans)
            / sum(s["views"] for s in spans))
