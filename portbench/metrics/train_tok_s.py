"""Trained tokens over the whole window, per second of the host's clock."""


def read(rec):
    return rec.tokens / rec.window_s
