"""The mean host time of ``Model.prefill`` over the window's rounds
(synchronised; untraced rounds where there are any)."""


def read(rec):
    return rec.span_mean_ms("prefill")
