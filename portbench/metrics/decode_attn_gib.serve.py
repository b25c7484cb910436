"""GiB the card's caching allocator hands out inside ``decode_attention``
in a traced decode step, over every layer: the running total of its
allocated bytes read before and after each ``decode/attn.core`` span (the
``decode/attn.core.bytes`` counter), whatever the layer allocates."""
from portbench import spans


def read(rec):
    got = spans.per_step("decode")
    if got is None or got.device_ms("decode/attn.core") is None:
        return None
    nbytes = got.counter("decode/attn.core.bytes")
    return None if nbytes is None else nbytes / 2 ** 30
