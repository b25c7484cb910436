"""The share of the traced stretch (a round of the window) in which no
operation ran on the card."""


def read(rec):
    st = rec.stretch
    return None if not st else 100.0 * (1.0 - st["busy_s"] / st["window_s"])
