"""The mean host time of a train step's loss and gradients, from the
step's start to the optimizer's call (synchronised at both ends; untraced
steps where there are any)."""


def read(rec):
    return rec.span_mean_ms("fwd_bwd")
