"""Observability of the model path: spans and counters around its layers,
built on ``obs``'s ``MetricsRegistry`` and kept in memory.

A span (``span``) wraps a layer of a model step (the step itself,
attention, its core, the MLP, the head) and is named ``<mode>/<layer>``
(``prefill``, ``decode``, ``train``). It records only while
``torch.profiler`` records, which is the switch an operator already turns
to trace; otherwise a span is one check of that flag and a shared no-op
context: no aten call, no CUDA call, no allocation. A record carries its
parent span, the step index and the host's ``time.time_ns()`` at both
ends (the clock of the profiler's events), and on the card a pair of
timing events recorded on the current stream. Under autograd, marks at a
span's input and output record its backward (``bwd``); a span that runs
inside a backward is a ``recompute``. ``model_spans`` synchronises once
and reads every pending pair: count, host ms, device ms and self device
ms by name and phase, and the counters. Nothing is written to disk.
"""
from __future__ import annotations

import threading
import time

import torch

from repro_torch.core.obs import MetricsRegistry

_profiling = torch.autograd._profiler_enabled
_graph_task = torch._C._current_graph_task_id

# closed records a step's start reads (those the card has passed) past this
RESOLVE_AT = 1 << 16


class SpanRecord:
    """One span of the model path, and the context that records it.
    ``name`` is ``<mode>/<layer>``; ``phase`` is ``fwd``, ``recompute`` (a
    forward that runs inside a backward: a checkpointed block or loss
    chunk computed again) or ``bwd`` (the gradient's way from the span's
    output to its input). ``t0``/``t1`` are ``time.time_ns()``, the clock
    of the profiler's events. On the card ``ev0``/``ev1`` are timing
    events recorded on ``stream``; ``device_ms`` is read from them, and a
    ``bwd`` record's leaves out the recompute that ran inside it
    (``less_ms``), which the ``recompute`` records count. ``child_ms``
    sums the device time of the spans inside it. ``index`` is the device
    whose allocator an ``alloc`` span reads into ``nbytes``. ``is_step``
    marks the span of a whole step."""

    __slots__ = ("name", "mode", "phase", "parent", "step", "is_step", "t0",
                 "t1", "stream", "ev0", "ev1", "index", "nbytes",
                 "device_ms", "child_ms", "less_ms", "bwd")

    def __init__(self, name, mode, phase, parent, step, is_step=False):
        self.name = name
        self.mode = mode
        self.phase = phase
        self.parent = parent
        self.step = step
        self.is_step = is_step
        self.t0 = self.t1 = 0
        self.stream = None
        self.ev0 = self.ev1 = self.index = self.nbytes = None
        self.device_ms = None
        self.child_ms = self.less_ms = 0.0
        self.bwd = None

    @property
    def self_ms(self):
        return None if self.device_ms is None \
            else self.device_ms - self.child_ms

    def __repr__(self):
        return f"SpanRecord({self.name}, {self.phase}, step {self.step})"

    def __enter__(self):
        m = MODEL
        if self.stream is not None:
            if self.index is not None:  # completed in __exit__
                self.nbytes = -_allocated(self.index)
            self.ev0 = m.event(self.stream)
        m.stack().append(self)
        if self.is_step:
            m.step_rec, m.stream = self, self.stream
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.time_ns()
        m = MODEL
        if self.stream is not None:
            self.ev1 = m.event(self.stream)
            if self.index is not None:
                self.nbytes += _allocated(self.index)
                m.registry.inc(self.name + ".bytes", self.nbytes)
        stack = m.stack()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:  # closed out of order by an exception
            stack.remove(self)
        if m.step_rec is self:
            m.step_rec = m.stream = None
        m.close(self)
        return False

    def input(self, x):
        """``x`` marked so that the span's ``bwd`` record closes when the
        gradient leaves through it (a forward under autograd only)."""
        if self.phase != "fwd" or not (torch.is_grad_enabled()
                                       and x.requires_grad):
            return x
        if self.bwd is None:
            self.bwd = _Backward(self)
        return _Mark.apply(x, self.bwd, False)

    def output(self, y):
        """``y`` marked so that the span's ``bwd`` record opens when the
        gradient reaches it."""
        if self.bwd is None or not y.requires_grad:
            return y
        return _Mark.apply(y, self.bwd, True)


class ModelSpans:
    """The model path's spans and counters (one per process, ``MODEL``):
    totals by ``(name, phase)``, the counters in a ``MetricsRegistry``,
    and the closed records whose timing events are not read yet. Device
    times are read in one pass (``read``), after a synchronise, so that
    recording costs the card nothing but the events."""

    def __init__(self):
        self.registry = MetricsRegistry("model")
        self.totals: dict = {}  # (name, phase) -> [n, host ns, dev, self]
        self.pending: list = []  # closed records, in the order they closed
        self.pool: list = []  # timing events to reuse
        self.open_bwd: list = []  # backward intervals under way
        self.step = 0
        self.step_rec = None  # the step span open now
        self.stream = None  # its stream, which the spans inside it share
        self._tls = threading.local()

    def reset(self) -> None:
        self.__init__()

    def stack(self) -> list:
        """The spans open on this thread, innermost last."""
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def open(self, layer: str, x, mode, alloc: bool) -> SpanRecord:
        """A new record of ``span``'s arguments, its phase and parent
        taken from where it runs."""
        phase = "recompute" if _graph_task() != -1 else "fwd"
        stack = self.stack()
        parent = stack[-1] if stack else None
        if phase == "recompute" and self.open_bwd and (
                parent is None or parent.phase != "recompute"):
            parent = self.open_bwd[-1]  # the backward that asked for it
        mode = mode or (parent.mode if parent is not None else "model")
        is_step = layer == "step"
        if is_step:
            self.begin_step()
        rec = SpanRecord(f"{mode}/{layer}", mode, phase, parent, self.step,
                         is_step)
        device = x.device
        if _timed(device):
            rec.stream = self.stream or torch.cuda.current_stream(device)
            if alloc:
                rec.index = device.index or 0
        return rec

    def event(self, stream):
        """A timing event (reused) recorded now on ``stream``."""
        ev = self.pool.pop() if self.pool \
            else torch.cuda.Event(enable_timing=True)
        ev.record(stream)
        return ev

    def begin_step(self) -> None:
        self.step += 1
        self.open_bwd.clear()  # a backward that never reached its input
        if len(self.pending) >= RESOLVE_AT:
            self.resolve(wait=False)

    def close(self, rec: SpanRecord) -> None:
        if rec.ev1 is None:
            self._settle(rec)
        else:
            self.pending.append(rec)

    def resolve(self, wait: bool = True) -> None:
        """Read the device times of the closed records: all of them after
        one synchronise (``wait``), else those the card has passed."""
        pending = self.pending
        if not pending:
            return
        if wait:
            torch.cuda.synchronize()
        n = 0
        for rec in pending:
            if not wait and not rec.ev1.query():
                break
            self._settle(rec)
            n += 1
        del pending[:n]

    def _settle(self, rec: SpanRecord) -> None:
        """Fold a closed record into its parent and the totals. Records
        settle in the order they closed, so a record's children have
        settled before it."""
        if rec.ev1 is not None:
            rec.device_ms = rec.ev0.elapsed_time(rec.ev1) - rec.less_ms
            self.pool += (rec.ev0, rec.ev1)
            rec.ev0 = rec.ev1 = None
        p, dev = rec.parent, rec.device_ms
        if p is not None and dev is not None:
            if rec.phase == "recompute" and p.phase == "bwd":
                p.less_ms += dev
            elif rec.phase == "bwd" and p.phase == "bwd":
                p.child_ms += dev
                p.less_ms += rec.less_ms
            else:
                p.child_ms += dev + rec.less_ms
        t = self.totals.get((rec.name, rec.phase))
        if t is None:
            t = self.totals[(rec.name, rec.phase)] = [0, 0, None, None]
        t[0] += 1
        t[1] += rec.t1 - rec.t0
        if dev is not None:
            t[2] = (t[2] or 0.0) + dev
            t[3] = (t[3] or 0.0) + dev - rec.child_ms

    def read(self) -> dict:
        """``{"spans": {name: {phase: {count, host_ms, device_ms,
        self_device_ms}}}, "counters": {...}}`` over every span recorded
        so far; device times are None off the card."""
        self.resolve()
        spans: dict = {}
        for (name, phase), (n, host, dev, own) in sorted(
                self.totals.items()):
            spans.setdefault(name, {})[phase] = {
                "count": n, "host_ms": host / 1e6, "device_ms": dev,
                "self_device_ms": own}
        return {"spans": spans, "counters": dict(self.registry.counters)}


MODEL = ModelSpans()


def _timed(device) -> bool:
    """Whether spans on ``device`` carry timing events (on the card)."""
    return device.type == "cuda"


def _allocated(index: int) -> int:
    """The caching allocator's running total of bytes handed out on the
    card ``index`` (its nested statistics, without ``memory_stats``'
    flattening)."""
    return torch._C._cuda_memoryStats(index)[
        "allocated_bytes"]["all"]["allocated"]


class _Backward:
    """A span's ``bwd`` records: one opens when the gradient reaches the
    span's output and closes when it leaves through its input."""

    __slots__ = ("fwd", "open")

    def __init__(self, fwd: SpanRecord):
        self.fwd = fwd
        self.open = None

    def start(self) -> None:
        m, fwd = MODEL, self.fwd
        rec = SpanRecord(fwd.name, fwd.mode, "bwd",
                         m.open_bwd[-1] if m.open_bwd else m.step_rec,
                         fwd.step)
        if fwd.stream is not None:
            rec.stream = torch.cuda.current_stream()
            rec.ev0 = m.event(rec.stream)
        rec.t0 = time.time_ns()
        m.open_bwd.append(rec)
        self.open = rec

    def end(self) -> None:
        rec, self.open = self.open, None
        if rec is None:
            return
        rec.t1 = time.time_ns()
        if rec.stream is not None:
            rec.ev1 = MODEL.event(rec.stream)
        if rec in MODEL.open_bwd:
            MODEL.open_bwd.remove(rec)
        MODEL.close(rec)


class _Mark(torch.autograd.Function):
    """The identity, whose backward opens (at a span's output) or closes
    (at its input) the span's ``bwd`` record."""

    @staticmethod
    def forward(ctx, x, bwd, at_output):
        ctx.bwd, ctx.at_output = bwd, at_output
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        if ctx.at_output:
            ctx.bwd.start()
        else:
            ctx.bwd.end()
        return grad, None, None


class _NoSpan:
    """What ``span`` returns while the profiler is off: no record, no
    mark, no call into torch."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def input(self, x):
        return x

    def output(self, y):
        return y


NO_SPAN = _NoSpan()


def span(layer: str, x, mode: str = None, alloc: bool = False):
    """A span named ``<mode>/<layer>`` around a layer of the model path,
    recorded only while ``torch.profiler`` records (the switch an operator
    already turns to trace); otherwise ``NO_SPAN``. ``x`` is a tensor the
    layer works on (its device says whether to time on the card); ``mode``
    (``prefill``, ``decode``, ``train``) defaults to the enclosing span's;
    a ``step`` layer advances the step index every span inside it
    carries, and its stream is the one the spans inside it time on.
    ``alloc`` counts the bytes the allocator hands out inside the span
    (``<name>.bytes``, on the card). Use::

        with obs_model.span("mlp", h, mode) as sp:
            y = sp.output(apply_mlp(params, sp.input(h), act))

    where ``input``/``output`` add the span's ``bwd`` records under
    autograd."""
    if not _profiling():
        return NO_SPAN
    return MODEL.open(layer, x, mode, alloc)


def model_spans() -> dict:
    """Every model span recorded so far, by name and phase, with the
    counters (``MODEL.read``): one synchronise, then the device times."""
    return MODEL.read()


def reset_model_spans() -> None:
    MODEL.reset()
