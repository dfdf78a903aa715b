"""Faults of the `register` kind's timed path, planted in the port's
registration pass (`FAULTS` as in `rl.py`)."""

RUN = "spim_registration_tpu_torch.pipeline.run"


def solve_unchanged(orig):
    """The global solve returns its starting state (no correction)."""
    def f(*a, **k):
        res = orig(*a, **k)
        res.corrections = {}
        return res
    return f


def detect_half(orig):
    """Half of the views' detections left out."""
    calls = []

    def f(vol, *a, **k):
        pts, rest = orig(vol, *a, **k)
        calls.append(1)
        return (pts[:0] if len(calls) % 2 == 0 else pts), rest
    return f


def solve_altered(orig):
    """An answer altered where it is produced: view 1 moved by 1 px."""
    def f(*a, **k):
        res = orig(*a, **k)
        if 1 in res.corrections:
            res.corrections[1] = res.corrections[1].copy()
            res.corrections[1][:, 3] += 1.0
        return res
    return f


FAULTS = {"unchanged": (RUN, "solve_global", solve_unchanged),
          "half_views": (RUN, "detect_beads", detect_half),
          "altered": (RUN, "solve_global", solve_altered)}
