"""The whole train step's share of the card's float32 peak (3xTF32): the
model FLOPs of every step in the window (``work.train_flops``: forward
and backward of the active weights, the head and causal attention,
recompute not counted) over the window's host seconds."""


def read(rec):
    if not rec.peaks or not rec.window_s:
        return None
    tr = rec.traffic
    flops = rec.steps * rec.work.train_flops(rec.config, tr["batch"],
                                             tr["seq_len"])
    return 100.0 * flops / rec.window_s / rec.peaks["float32"]
