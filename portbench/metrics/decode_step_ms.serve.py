"""The median host time of a ``Model.decode_step`` with its token copied
to the host, over the window (untraced steps)."""


def read(rec):
    return rec.span_median_ms("decode_step")
