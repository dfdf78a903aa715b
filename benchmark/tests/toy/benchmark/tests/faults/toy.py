"""Faults of the toy kind's timed path: `FAULTS` names each, with the
module it is planted in ("job": the cell's job module), the attribute
and a function that makes the broken attribute from the original."""


def toy_unchanged(orig):
    """Each step returns its state unchanged."""
    def f(y, m):
        return y
    return f


def toy_altered(orig):
    """Each step's answer altered where it is produced: 10% off."""
    def f(y, m):
        return orig(y, m) * 1.1
    return f


FAULTS = {"unchanged": ("job", "step", toy_unchanged),
          "altered": ("job", "step", toy_altered)}
