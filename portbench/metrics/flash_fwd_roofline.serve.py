"""The flash-attention forward kernels' share of their roofline in the
traced round's prefill: the least time of the attention that the traced
prefills hold by the harness's own record (each prefill's sessions and
prompt length, causal, over every layer's heads: ``work.flash_fwd`` at
the bf16 peak or the memory rate) over the device seconds of the kernels
named here inside the prefill part of the trace. Decode steps are traced
apart, so a decode kernel of any name is not counted here."""
KERNELS = ("flash_fwd_",)


def read(rec):
    _, secs = rec.kernel_s(*KERNELS, part="prefill")
    if not secs or not rec.traced_prefills or not rec.peaks:
        return None
    least = 0.0
    for sessions, prompt in rec.traced_prefills:
        flops, nbytes = rec.work.flash_fwd(rec.config, sessions, prompt, 2)
        least += max(flops / rec.peaks["bfloat16"],
                     nbytes / rec.peaks["hbm_bytes_s"])
    return 100.0 * least * rec.work.attn_layers(rec.config) / secs
