"""Cluster-wide observability: tracing, metrics registry, flight recorder.

Three pillars, one module, per-node handles (DESIGN.md §5.5):

- **Op-granular tracing** (``Tracer``/``TraceCtx``): a ``trace_id`` is
  allocated at the LibFS entry points (``put``/``get``/``fsync``) and
  propagated through RPC headers exactly like the ``_epoch`` header —
  the transport pops a ``_trace`` kwarg, resolves it, and activates the
  context around the endpoint call so spans recorded inside the handler
  (including nested chain forwards) land in the caller's trace. Thread
  handoffs (group-commit flusher, chain sender, digest workers) carry
  the context object explicitly, the in-process analogue of copying the
  header into a queued message. Sampling is deterministic (every Nth
  op) so overhead is a branch and a counter when an op is not sampled.

- **Metrics registry** (``MetricsRegistry``): named counters, gauges,
  and fixed-bucket log2 latency histograms from which p50/p99/p999 are
  derivable without storing samples. ``ScopedCounters`` is a native
  dict the registry publishes under a key prefix at dump time — the
  ad-hoc ``self.stats = {...}`` dicts in store/sharedfs/groupcommit
  join the registry without changing a single increment site or its
  hot-path cost.

- **Flight recorder** (``FlightRecorder``): a lock-free-ish bounded
  ring (GIL-atomic ``deque`` appends) of recent per-node events — RPC
  arrivals, seals, digests, epoch bumps, fired crash points, injected
  faults. The ring is owned by the node's SharedFS object, which
  ``kill_node`` abandons but does not discard, so the black box of a
  killed node is readable post-mortem from the harness.

Span timestamps pair the (possibly simulated) cluster clock with a
process-global sequence number taken under one lock: a sim clock may
not advance between spans, so ordering assertions use ``seq`` while
``t`` carries the clock reading (non-decreasing in recorded order).
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import OrderedDict, deque


# ---------------------------------------------------------------------------
# Metrics registry
# ---------------------------------------------------------------------------

# log2 buckets: bucket 0 holds values < 1, bucket i holds [2^(i-1), 2^i).
# 64 buckets cover anything a latency-in-microseconds or bytes counter
# can plausibly observe; percentiles report the bucket's upper bound.
HIST_BUCKETS = 64


class Histogram:
    """Fixed-bucket log2 histogram: O(1) observe, O(buckets) quantile,
    zero stored samples. Percentiles are upper-bound estimates (within
    2x of the true value by construction), which is exactly enough to
    answer "did p99 blow up" without keeping the samples around."""

    __slots__ = ("counts", "n", "total")

    def __init__(self):
        self.counts = [0] * HIST_BUCKETS
        self.n = 0
        self.total = 0.0

    def observe(self, v: float) -> None:
        i = int(v).bit_length()
        if i >= HIST_BUCKETS:
            i = HIST_BUCKETS - 1
        self.counts[i] += 1
        self.n += 1
        self.total += v

    def percentile(self, p: float) -> float:
        """Upper bound of the bucket containing the p-quantile."""
        if self.n == 0:
            return 0.0
        rank = p * self.n
        acc = 0
        for i, c in enumerate(self.counts):
            acc += c
            if acc >= rank and c:
                return float(1 << i) if i else 1.0
        return float(1 << (HIST_BUCKETS - 1))

    @property
    def mean(self) -> float:
        return self.total / self.n if self.n else 0.0

    def to_dict(self) -> dict:
        return {
            "count": self.n,
            "mean": self.mean,
            "p50": self.percentile(0.50),
            "p99": self.percentile(0.99),
            "p999": self.percentile(0.999),
            "buckets": {i: c for i, c in enumerate(self.counts) if c},
        }


class ScopedCounters(dict):
    """Native-dict counters published into a registry under a prefix.

    The legacy ad-hoc stats dicts sat on per-op hot paths
    (``stats["k"] += 1`` twice per L1 get), so this IS a dict — every
    read/write runs at native dict speed — and the owning registry
    merely remembers the view, merging it into ``to_dict()`` under
    ``prefix+key`` names at dump time. Reading a never-written key
    returns 0 (counters are born zero), which lets new counters appear
    without re-seeding every constructor."""

    def __init__(self, registry: "MetricsRegistry", prefix: str, seed=()):
        super().__init__(dict.fromkeys(seed, 0))
        self.prefix = prefix
        registry._scoped.append(self)

    def __missing__(self, k):
        return 0

    def copy(self) -> dict:
        return dict(self)

    def __repr__(self):
        return f"ScopedCounters({self.prefix!r}, {self.copy()!r})"


class MetricsRegistry:
    """Per-node named counters / gauges / histograms — the one handle
    (``node.metrics``) behind which all of a node's stats live, dumped
    as JSON by the harness and consumed by ``benchmarks/common``."""

    def __init__(self, name: str = ""):
        self.name = name
        self.counters: dict = {}
        self.gauges: dict = {}
        self.histograms: dict = {}
        self._scoped: list = []

    # -- counters ----------------------------------------------------------
    def inc(self, name: str, n: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    def get(self, name: str, default=0):
        return self.counters.get(name, default)

    def scoped(self, prefix: str, seed=()) -> ScopedCounters:
        return ScopedCounters(self, prefix, seed)

    # -- gauges ------------------------------------------------------------
    def gauge(self, name: str, value) -> None:
        self.gauges[name] = value

    # -- histograms --------------------------------------------------------
    def histogram(self, name: str) -> Histogram:
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = Histogram()
        return h

    def observe(self, name: str, v: float) -> None:
        self.histogram(name).observe(v)

    # -- dump --------------------------------------------------------------
    def to_dict(self) -> dict:
        counters = dict(self.counters)
        for sc in self._scoped:
            for k, v in sc.items():
                counters[sc.prefix + k] = v
        return {
            "name": self.name,
            "counters": counters,
            "gauges": dict(self.gauges),
            "histograms": {k: h.to_dict()
                           for k, h in self.histograms.items()},
        }


# ---------------------------------------------------------------------------
# Tracing
# ---------------------------------------------------------------------------

_TRACE_IDS = itertools.count(1)
_SPAN_SEQ = itertools.count(1)
_NO_CTX = object()  # push() token meaning "nothing was pushed"


class Span:
    """One recorded protocol stage inside a trace."""

    __slots__ = ("seq", "t", "name", "node", "meta")

    def __init__(self, seq, t, name, node, meta):
        self.seq = seq
        self.t = t
        self.name = name
        self.node = node
        self.meta = meta

    def to_dict(self) -> dict:
        d = {"seq": self.seq, "t": self.t, "name": self.name}
        if self.node is not None:
            d["node"] = self.node
        if self.meta:
            d.update(self.meta)
        return d

    def __repr__(self):
        at = f"@{self.node}" if self.node else ""
        return f"Span({self.seq}, {self.name}{at})"


class TraceCtx:
    """Handle to one in-flight trace. ``trace_id`` is what rides the
    ``_trace`` RPC header; the object itself is what rides thread
    handoffs (queued commit requests, digest jobs, chain send queue)."""

    __slots__ = ("trace_id", "tracer", "op", "acked")

    def __init__(self, trace_id: int, tracer: "Tracer", op: str):
        self.trace_id = trace_id
        self.tracer = tracer
        self.op = op
        self.acked = False  # fsync acked; later digest spans still attach

    def annotate(self, name: str, node=None, **meta) -> None:
        self.tracer.record(self, name, node, meta or None)

    def __repr__(self):
        return f"TraceCtx({self.trace_id}, op={self.op})"


class Tracer:
    """Cluster-wide span collector with deterministic sampling and a
    thread-local active context (the in-process header register)."""

    def __init__(self, clock=time.monotonic, sampling: float = 1 / 64,
                 max_traces: int = 512):
        self.clock = clock
        self.set_sampling(sampling)
        self.max_traces = max_traces
        self._traces: "OrderedDict[int, list]" = OrderedDict()
        self._ctxs: dict = {}
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._n = 0

    def set_sampling(self, sampling: float) -> None:
        """0 disables tracing, 1.0 traces every op, 1/N traces every
        Nth op (deterministic counter, not a coin flip, so tests and
        benches see an exact traced fraction)."""
        self.sampling = sampling
        if sampling <= 0:
            self._every = 0
        elif sampling >= 1:
            self._every = 1
        else:
            self._every = max(1, round(1 / sampling))

    # -- allocation --------------------------------------------------------
    def maybe_trace(self, op: str, node=None):
        """Sampling decision at an op entry point: returns a TraceCtx
        for every Nth call, else None. The unsampled path is one
        increment and one modulo."""
        every = self._every
        if every == 0:
            return None
        self._n += 1
        if every > 1 and self._n % every:
            return None
        return self.start(op, node)

    def start(self, op: str, node=None) -> TraceCtx:
        """Unconditionally open a trace (control-path ops like fail-over
        are rare enough to always trace)."""
        ctx = TraceCtx(next(_TRACE_IDS), self, op)
        with self._lock:
            self._traces[ctx.trace_id] = []
            self._ctxs[ctx.trace_id] = ctx
            while len(self._traces) > self.max_traces:
                old, _ = self._traces.popitem(last=False)
                self._ctxs.pop(old, None)
        self.record(ctx, op, node, None)
        return ctx

    # -- propagation -------------------------------------------------------
    def current(self):
        return getattr(self._tls, "ctx", None)

    def resolve(self, trace_id):
        """Header → context, on the receiving side of an RPC."""
        return self._ctxs.get(trace_id)

    def push(self, ctx):
        """Activate ``ctx`` on this thread; returns a token for pop().
        ``push(None)`` is a no-op returning a no-op token, so hot paths
        can call push/pop unconditionally."""
        if ctx is None:
            return _NO_CTX
        prev = getattr(self._tls, "ctx", None)
        self._tls.ctx = ctx
        return prev

    def pop(self, token) -> None:
        if token is _NO_CTX:
            return
        self._tls.ctx = token

    # -- recording ---------------------------------------------------------
    def record(self, ctx: TraceCtx, name: str, node=None, meta=None) -> None:
        # seq + clock are taken under the lock so list order == seq
        # order and t is non-decreasing in list order even across
        # threads (monotonic clock) — the property trace tests assert.
        with self._lock:
            spans = self._traces.get(ctx.trace_id)
            if spans is None:
                return
            spans.append(Span(next(_SPAN_SEQ), self.clock(),
                              name, node, meta))

    # -- inspection --------------------------------------------------------
    def spans(self, trace_id) -> list:
        with self._lock:
            return list(self._traces.get(trace_id, ()))

    def traces(self) -> list:
        with self._lock:
            return list(self._traces)

    def find(self, span_name: str) -> list:
        """Trace ids containing a span with this exact name."""
        with self._lock:
            return [tid for tid, spans in self._traces.items()
                    if any(s.name == span_name for s in spans)]

    def to_dict(self) -> dict:
        with self._lock:
            return {tid: [s.to_dict() for s in spans]
                    for tid, spans in self._traces.items()}


# ---------------------------------------------------------------------------
# Flight recorder
# ---------------------------------------------------------------------------

class FlightRecorder:
    """Bounded per-node ring of recent events. Appends are GIL-atomic
    deque pushes (no lock on the record path); the ring keeps the last
    ``capacity`` events and drops the oldest — a black box, not a log.
    It lives on the SharedFS object, which ``kill_node`` abandons but
    keeps in the cluster map, so a dead node's recorder stays readable."""

    __slots__ = ("node_id", "clock", "_ring", "_seq")

    def __init__(self, node_id: str, capacity: int = 512,
                 clock=time.monotonic):
        self.node_id = node_id
        self.clock = clock
        self._ring = deque(maxlen=capacity)
        self._seq = itertools.count(1)

    def record(self, kind: str, detail="") -> None:
        self._ring.append((next(self._seq), self.clock(), kind, detail))

    def events(self, kind: str = None) -> list:
        """Snapshot of the ring, oldest first; optionally one kind."""
        evs = list(self._ring)
        if kind is not None:
            evs = [e for e in evs if e[2] == kind]
        return evs

    def to_dicts(self) -> list:
        return [{"seq": s, "t": t, "kind": k, "detail": d}
                for (s, t, k, d) in self.events()]
