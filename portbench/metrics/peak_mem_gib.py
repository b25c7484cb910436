"""The card's peak allocated memory over set-up and window
(``torch.cuda.max_memory_allocated``), in GiB: capacity left for more
sessions or a larger batch."""


def read(rec):
    return None if rec.peak_bytes is None else rec.peak_bytes / 2 ** 30
