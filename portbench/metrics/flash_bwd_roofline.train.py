"""The f32 flash-attention backward kernels' share of their roofline in
the traced steps: the least time of one causal attention backward a
layer a step (``work.flash_bwd``: the four gradient products, at the
float32 peak of 3xTF32 or the memory rate), times the layers and the
traced steps by the harness's own count, over the device seconds of the
kernels named here."""
KERNELS = ("flash_bwd_",)


def read(rec):
    _, secs = rec.kernel_s(*KERNELS, part="steps")
    if not secs or not rec.traced_steps or not rec.peaks:
        return None
    tr = rec.traffic
    flops, nbytes = rec.work.flash_bwd(rec.config, tr["batch"],
                                       tr["seq_len"], 4)
    least = max(flops / rec.peaks["float32"],
                nbytes / rec.peaks["hbm_bytes_s"])
    calls = rec.traced_steps * rec.work.attn_layers(rec.config)
    return 100.0 * calls * least / secs
