"""Faults of the `rl` kind's timed path, planted in the port's RL
iteration. `FAULTS` names each, with the module it is planted in (a
dotted module name, or "job" for the cell's job module), the attribute
and a function that makes the broken attribute from the original."""

ITERATE = "spim_registration_tpu_torch.deconv.lucy_richardson"


def rl_unchanged(orig):
    """Each iteration returns its state unchanged."""
    def f(psi, *a, **k):
        return psi
    return f


def rl_half_views(orig):
    """Half of the views left out of every iteration."""
    def f(psi, images, weights, k1, k2, *a, **k):
        h = images.shape[0] // 2
        return orig(psi, images[:h], weights[:h] * 2, k1[:h], k2[:h],
                    *a, **k)
    return f


def rl_altered(orig):
    """The estimate altered where it is produced: 10% off on the middle
    eighth of its z rows."""
    def f(*a, **k):
        psi = orig(*a, **k)
        Z = psi.shape[0]
        psi[Z // 2 - Z // 16:Z // 2 + max(1, Z // 16)] *= 1.1
        return psi
    return f


FAULTS = {"unchanged": (ITERATE, "_rl_iterate", rl_unchanged),
          "half_views": (ITERATE, "_rl_iterate", rl_half_views),
          "altered": (ITERATE, "_rl_iterate", rl_altered)}
