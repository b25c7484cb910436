"""Seconds from the process's start to the window's first timed step:
imports, the kernels' build (a checkout's first run only), the weights
made on the card, the cache or optimizer state, and the warm-up of the
cell's own shapes (a train cell's first checked steps)."""


def read(rec):
    return rec.setup_s
