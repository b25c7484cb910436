"""The mean host time of ``optim/adamw.py``'s ``adamw_update`` within a
train step (synchronised at both ends; untraced steps where there are
any)."""


def read(rec):
    return rec.span_mean_ms("optimizer")
