"""Device ms a traced train step spends computing forwards again inside
the backward: every span's ``recompute`` phase (``RunConfig.remat``'s
blocks and the loss's checkpointed chunks), each counted once."""
from portbench import spans


def read(rec):
    got = spans.per_step("train")
    return None if got is None else got.recompute_ms()
