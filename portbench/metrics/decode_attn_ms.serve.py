"""Device ms a traced decode step spends in ``models/attention.py``
``decode_attention`` over every layer: the ``decode/attn.core`` spans'
timing events, whatever implements the layer (the port's own spans,
``portbench/spans.py``)."""
from portbench import spans


def read(rec):
    got = spans.per_step("decode")
    return None if got is None else got.device_ms("decode/attn.core")
