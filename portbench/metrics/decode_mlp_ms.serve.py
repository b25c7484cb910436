"""Device ms a traced decode step spends in ``models/layers.py``
``apply_mlp`` over every layer (the ``decode/mlp`` spans)."""
from portbench import spans


def read(rec):
    got = spans.per_step("decode")
    return None if got is None else got.device_ms("decode/mlp")
