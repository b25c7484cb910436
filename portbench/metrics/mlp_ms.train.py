"""Device ms a traced train step spends in ``models/layers.py``
``apply_mlp`` (``apply_moe`` alike): the ``train/mlp`` spans' forward,
recompute and backward (less the block's recompute that runs inside the
MLP's backward, which ``recompute_ms.train`` counts)."""
from portbench import spans


def read(rec):
    got = spans.per_step("train")
    return None if got is None else got.all_phases_ms("train/mlp")
