"""Output tokens of every session over the whole window, per second of
the host's clock: prefills, decode steps and every gap between them
included."""


def read(rec):
    return rec.tokens / rec.window_s
