"""Traced stretches of a run's window: ``torch.profiler`` over the card's
operations and the host's, read from the raw trace events.

A ``Stretch`` is traced in named parts, each its own profiler session
entered and left after a synchronise, so that a part holds exactly the
device work of the calls made inside it (a serve round's prefill apart
from its decode steps). ``busy_s`` is the union of the intervals in which
an operation (kernel, copy or fill) ran on the device; ``window_s`` the
host's time from a part's start to its stop; ``kernels`` each device
operation's launches and seconds by name; ``idle`` the device's idle gaps
summed by the innermost host operation under way at each gap's middle
(gaps under ``SHORT_GAP_S`` are summed as one entry). The summary gives
these over all parts and, under ``parts``, for each part.
"""
from __future__ import annotations

import collections
import contextlib
import heapq
import time

import torch

SHORT_GAP_S = 20e-6
SHORT = "gaps under 20 us"


class Stretch:
    """``st = Stretch(device)``; ``with st.part("prefill"): ...`` traces
    the block (``start``/``stop`` do the same across a loop);
    ``st.summary()`` reads every part afterwards."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.done = []  # (part, profiler, window seconds)
        self.open = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self, name: str):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._sync()
        prof = profile(activities=acts)
        prof.__enter__()
        self.open = (name, prof, time.perf_counter())

    def stop(self):
        self._sync()
        name, prof, t0 = self.open
        window = time.perf_counter() - t0
        prof.__exit__(None, None, None)
        self.done.append((name, prof, window))
        self.open = None

    @contextlib.contextmanager
    def part(self, name: str):
        self.start(name)
        try:
            yield
        finally:
            self.stop()

    def summary(self) -> dict:
        parts = {}
        for name, prof, window in self.done:
            got = _read(prof, window)
            if name in parts:
                got = _merge(parts[name], got)
            parts[name] = got
        out = {"busy_s": 0.0, "window_s": 0.0, "kernels": {}, "idle": {}}
        for got in parts.values():
            out = _merge(out, got)
        out["parts"] = parts
        return out


def _merge(a: dict, b: dict) -> dict:
    kernels = dict(a["kernels"])
    for k, (n, s) in b["kernels"].items():
        n0, s0 = kernels.get(k, (0, 0.0))
        kernels[k] = (n0 + n, s0 + s)
    idle = collections.Counter(a["idle"])
    idle.update(b["idle"])
    return {"busy_s": a["busy_s"] + b["busy_s"],
            "window_s": a["window_s"] + b["window_s"],
            "kernels": kernels, "idle": dict(idle)}


def _read(prof, window_s: float) -> dict:
    events = prof.profiler.kineto_results.events()
    dev, host = [], []
    for e in events:
        kind = e.device_type()
        a = e.start_ns()
        span = (a, a + e.duration_ns(), e.name())
        if kind == torch.autograd.DeviceType.CUDA:
            dev.append(span)
        elif kind == torch.autograd.DeviceType.CPU:
            host.append(span)
    kernels = collections.defaultdict(lambda: [0, 0.0])
    for a, b, name in dev:
        kernels[name][0] += 1
        kernels[name][1] += (b - a) * 1e-9
    dev.sort()
    busy, gaps = 0.0, []
    cur_a = cur_b = None
    for a, b, _ in dev:
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                busy += (cur_b - cur_a) * 1e-9
                gaps.append((cur_b, a))
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        busy += (cur_b - cur_a) * 1e-9
    return {"busy_s": busy, "window_s": window_s,
            "kernels": {k: tuple(v) for k, v in kernels.items()},
            "idle": _attribute(gaps, host)}


def _attribute(gaps, host) -> dict:
    """Idle seconds by the innermost host operation under way at each
    gap's middle: of the operations started by then and not yet ended,
    the one started last ("host idle" where none is)."""
    out = collections.Counter()
    mids = []
    for a, b in gaps:
        if (b - a) * 1e-9 < SHORT_GAP_S:
            out[SHORT] += (b - a) * 1e-9
        else:
            mids.append(((a + b) // 2, (b - a) * 1e-9))
    mids.sort()
    host.sort()
    heap, i = [], 0  # open operations by latest start
    for mid, secs in mids:
        while i < len(host) and host[i][0] <= mid:
            heapq.heappush(heap, (-host[i][0], host[i][1], host[i][2]))
            i += 1
        while heap and heap[0][1] < mid:  # ended: ended for later gaps too
            heapq.heappop(heap)
        out[heap[0][2] if heap else "host idle"] += secs
    return dict(out)


def top(items: dict, n: int = 10) -> list:
    """[[name, seconds]] of the n largest, each name cut to 160
    characters (a kernel's demangled template arguments run longer)."""
    return [[k[:160], v] for k, v in sorted(items.items(),
                                            key=lambda kv: -kv[1])[:n]]
