"""Device ms a traced train step spends in the head and its
cross-entropy (``models/transformer.py`` ``_xent_chunk``, each chunk of
``_chunked_xent``): the ``train/head`` spans' forward, their recompute in
the backward, and their backward less that recompute."""
from portbench import spans


def read(rec):
    got = spans.per_step("train")
    return None if got is None else got.all_phases_ms("train/head")
