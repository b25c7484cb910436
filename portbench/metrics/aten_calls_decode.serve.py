"""The aten calls the host dispatches in one decode step of the model
(``portbench.aten.Count`` around one ``Model.decode_step`` after the
window)."""


def read(rec):
    return rec.counters.get("aten_calls_decode")
