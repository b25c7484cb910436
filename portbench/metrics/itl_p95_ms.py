"""The 95th percentile of the gap between two consecutive output tokens of
a session, over every decode step in the window (host clock, each token
on the host)."""
import numpy as np


def read(rec):
    return float(np.percentile(rec.itl_s, 95)) * 1e3 if rec.itl_s else None
