"""The devices a toy job ran on, from the job's facts."""


def read(trace):
    cards = trace.facts.get("cards")
    return None if cards is None else float(cards)
