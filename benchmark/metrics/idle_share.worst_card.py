"""The idle share of the card that was idle longest over the traced
stretch, in %: 100 (1 - least busy / wall), where a card's busy is the
union of its own device operations (`Trace.busy_s_by_card`) and wall the
stretch's host-clock length. The ledger's idle share is the cards' mean,
which hides one card starved while the others work."""


def read(trace):
    busy = getattr(trace, "busy_s_by_card", None)
    if not busy or max(busy) <= 0 or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - min(busy) / trace.window_s)
