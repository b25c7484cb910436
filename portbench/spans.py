"""The port's own spans (``repro_torch.core.obs_model.model_spans``),
read per traced step for the per-layer metrics in ``metrics/``. They
record while ``torch.profiler`` records, so in a ``--trace 1`` run's
stretch alone. Every figure is a mean over the ``<mode>/step`` spans
recorded in the process, so that runs repeated in one process average.
A port without the spans, a run that recorded none, or one without
device times (on the CPU) reads None."""
from __future__ import annotations

from typing import Optional

PHASES = ("fwd", "recompute", "bwd")


class Steps:
    """The spans of one mode over its traced steps."""

    def __init__(self, got: dict, mode: str, steps: int):
        self.spans = got["spans"]
        self.counters = got["counters"]
        self.mode = mode
        self.steps = steps

    def _get(self, name: str, phase: str, key: str):
        return self.spans.get(name, {}).get(phase, {}).get(key)

    def device_ms(self, name: str, phase: str = "fwd") -> Optional[float]:
        """Device ms a step of the span ``name`` in ``phase``."""
        v = self._get(name, phase, "device_ms")
        return None if v is None else v / self.steps

    def all_phases_ms(self, name: str) -> Optional[float]:
        """Device ms a step of ``name``'s forward, recompute and backward
        (the backward less the recompute that ran inside it)."""
        got = [self._get(name, p, "device_ms") for p in PHASES]
        if got[0] is None:
            return None
        return sum(v for v in got if v is not None) / self.steps

    def recompute_ms(self) -> Optional[float]:
        """Device ms a step of every recompute span of the mode, each
        counted once (the self times of all of them)."""
        own = [ph["recompute"]["self_device_ms"]
               for name, ph in self.spans.items()
               if name.startswith(self.mode + "/") and "recompute" in ph]
        if not own or None in own:
            return None
        return sum(own) / self.steps

    def counter(self, key: str) -> Optional[float]:
        v = self.counters.get(key)
        return None if v is None else v / self.steps


def per_step(mode: str) -> Optional[Steps]:
    """The spans of ``mode`` (``prefill``, ``decode``, ``train``), or None
    where the port keeps none or none of its steps was traced."""
    try:
        from repro_torch.core import obs_model
    except ImportError:
        return None
    got = obs_model.model_spans()
    steps = got["spans"].get(f"{mode}/step", {}).get("fwd", {}).get("count")
    return Steps(got, mode, steps) if steps else None
