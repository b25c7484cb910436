"""The whole serve step's share of the card's bf16 peak: the model FLOPs
of every prefill and decode step in the window (``work.prefill_flops``,
``work.decode_flops``: the layers' active weights, the head for the rows
that reach it, causal attention over the positions written) over the
window's host seconds."""


def read(rec):
    if not rec.peaks or not rec.window_s:
        return None
    w = rec.work
    flops = sum(w.prefill_flops(rec.config, s, p) for s, p in rec.prefills)
    flops += sum(w.decode_flops(rec.config, s, p) for s, p in rec.decodes)
    return 100.0 * flops / rec.window_s / rec.peaks["bfloat16"]
