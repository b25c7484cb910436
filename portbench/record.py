"""What one run measured, handed to every metric's reader
(``metrics/<name>.py``: ``read(rec) -> float | None``)."""
from __future__ import annotations

import dataclasses
import statistics
from types import ModuleType
from typing import Optional


@dataclasses.dataclass
class Record:
    cell: str
    config: dict
    traffic: dict
    work: ModuleType  # the family's counts of work
    setup_s: float = 0.0
    # seconds from the process's start at which each part of set-up ended
    setup_marks: dict = dataclasses.field(default_factory=dict)
    # host seconds from the window's start to its last step's end
    window_s: float = 0.0
    # output tokens (serve) or trained tokens (train) in the window
    tokens: int = 0
    # decode steps (serve) or train steps (train) in the window
    steps: int = 0
    # each decode step's gap between a session's two tokens
    itl_s: list = dataclasses.field(default_factory=list)
    # (name, seconds, in the traced stretch)
    spans: list = dataclasses.field(default_factory=list)
    # (sessions, prompt_len) of each prefill in the window
    prefills: list = dataclasses.field(default_factory=list)
    # (sessions, position of the new token) of each decode step
    decodes: list = dataclasses.field(default_factory=list)
    # (sessions, prompt_len) of each prefill in the traced stretch
    traced_prefills: list = dataclasses.field(default_factory=list)
    # train steps in the traced stretch
    traced_steps: int = 0
    counters: dict = dataclasses.field(default_factory=dict)
    # profiling.Stretch.summary() of a --trace 1 run
    stretch: Optional[dict] = None
    peak_bytes: Optional[int] = None
    device_name: str = ""
    power_limit_w: Optional[float] = None
    peaks: Optional[dict] = None  # peaks.for_card(device_name)

    def span_s(self, name: str) -> list:
        """Seconds of every ``name`` span outside the traced stretch, or of
        every one where the stretch held them all."""
        untraced = [s for n, s, t in self.spans if n == name and not t]
        return untraced or [s for n, s, t in self.spans if n == name]

    def span_mean_ms(self, name: str) -> Optional[float]:
        vals = self.span_s(name)
        return statistics.fmean(vals) * 1e3 if vals else None

    def span_median_ms(self, name: str) -> Optional[float]:
        vals = self.span_s(name)
        return statistics.median(vals) * 1e3 if vals else None

    def kernel_s(self, *names: str, part: str):
        """(launches, device seconds) in the traced stretch's ``part``
        ("prefill", "decode", "steps") of the device operations whose
        names contain one of ``names``."""
        n, secs = 0, 0.0
        got = (self.stretch or {}).get("parts", {}).get(part, {})
        for key, (count, s) in got.get("kernels", {}).items():
            if any(x in key for x in names):
                n, secs = n + count, secs + s
        return n, secs
