"""RDMA-like transport between simulated nodes.

The container has no NICs; nodes live in one process and the transport
preserves the *semantics* Assise relies on:

- **ordered one-sided writes** into registered remote memory regions
  (RDMA RC ordering — what CC-NVM's prefix guarantee builds on),
- **one-sided reads** out of registered regions, guarded by an ``rkey``:
  a region's owner bumps its key whenever it reuses the underlying
  memory (segment compaction, slot truncation), and a read presenting a
  stale key raises ``StaleHandle`` — exactly the remote-access error a
  real NIC returns for an invalidated memory registration, so a reader
  holding an old locate handle fails loudly instead of reading
  recycled bytes,
- **RPCs** that invoke a remote endpoint method,
- failure injection: a dead node's endpoints raise ``NodeDown``,
- full accounting (ops, bytes, hops — response payloads included) so
  benchmarks can report both the measured Python time and a modeled
  wire time (``bytes / NET_BW + hops * NET_LAT``) — see
  benchmarks/common.py.

Swapping this class for a real ICI/DCN transport changes no caller code.
"""
from __future__ import annotations

import contextlib
import itertools
import random
import threading
import time

from .obs import MetricsRegistry, Tracer


class NodeDown(RuntimeError):
    pass


class StaleEpoch(RuntimeError):
    """An RPC or one-sided write arrived carrying a view epoch older
    than the receiver's. The sender is fenced: it missed a membership
    change (its chain/lease view is stale) and must refresh before any
    further mutation — retrying the same message can never succeed, so
    ``with_retries`` deliberately does NOT retry this."""


class StaleHandle(RuntimeError):
    """One-sided access with an invalidated rkey (remote memory was
    reused since the handle was resolved)."""


class RpcTimeout(RuntimeError):
    """A message was lost on the wire (injected drop / timeout). Unlike
    ``NodeDown`` this is *transient*: the peer may be healthy and the
    caller should retry with backoff (see ``with_retries``)."""


def with_retries(fn, *, attempts: int = 4, backoff_s: float = 2e-4,
                 retriable=(RpcTimeout,), stats: "TransportStats" = None,
                 jitter: float = 0.5, rng=random,
                 deadline_s: float = None):
    """Bounded retry with jittered exponential backoff for transient
    transport faults. ``fn`` must be idempotent at the receiver (chain
    appends dedup by seqno, digests re-apply cleanly, lease grants
    refresh). ``NodeDown`` is deliberately NOT retriable by default: a
    dead peer needs failure detection + chain repair, not a retry storm.
    ``StaleEpoch`` must likewise never be listed retriable: a fenced
    sender needs a view refresh, and the same bytes can never succeed.

    Each sleep is scaled by a uniform draw from ``[1-jitter, 1]``:
    concurrent callers that hit the same dead hop in the same instant
    would otherwise back off in lockstep and re-collide on every round
    (a synchronized retry storm); decorrelating the delays spreads the
    retries across the window while keeping the exponential envelope.

    ``deadline_s`` caps the *total elapsed* time across all attempts:
    during a partition every try times out after its own full wait, so
    the exponential schedule alone can stall a writer for far longer
    than any availability budget. Once the deadline is spent the last
    retriable error is re-raised immediately and each backoff sleep is
    clamped to the time remaining."""
    delay = backoff_s
    start = time.monotonic() if deadline_s is not None else None
    for k in range(attempts):
        try:
            return fn()
        except retriable:
            if k == attempts - 1:
                raise
            remaining = None
            if deadline_s is not None:
                remaining = deadline_s - (time.monotonic() - start)
                if remaining <= 0:
                    raise
            if stats is not None:
                stats.retries += 1
            if delay > 0:
                scale = 1.0 - jitter * rng.random() if jitter > 0 else 1.0
                sleep = delay * scale
                if remaining is not None:
                    sleep = min(sleep, remaining)
                time.sleep(sleep)
                delay *= 2


# Globally unique rkey generator: region owners take a fresh key at
# construction and at every memory-reuse point, so a handle resolved
# against a *previous incarnation* of a region (e.g. a SharedFS rebuilt
# on node restart) can never validate by accident.
_RKEYS = itertools.count(1)


def next_rkey() -> int:
    return next(_RKEYS)


# Modeled wire constants (Table 1: NVM-RDMA): 3us read / 8us write RPC,
# ~3.8 GB/s line rate. Used by benchmarks for modeled latency only.
NET_LAT_READ_S = 3e-6
NET_LAT_WRITE_S = 8e-6
NET_BW_BPS = 3.8e9


def modeled_wire_s(*, bytes_sent: int = 0, rpcs: int = 0,
                   one_sided_writes: int = 0,
                   one_sided_reads: int = 0) -> float:
    """Canonical modeled wire time: line-rate transfer plus a per-hop
    latency charge (writes and RPCs pay the write latency, one-sided
    reads the read latency). This is the ONE place the formula lives —
    ``TransportStats.modeled_wire_s`` and ``benchmarks/common
    .modeled_us`` both delegate here."""
    return (bytes_sent / NET_BW_BPS
            + (rpcs + one_sided_writes) * NET_LAT_WRITE_S
            + one_sided_reads * NET_LAT_READ_S)


def payload_bytes(x) -> int:
    """Wire payload bytes inside an RPC argument/return value (bytes
    nested one or two levels deep in tuples/lists count too — e.g. a
    ``(found, value)`` read reply or a batch of locate descriptors)."""
    if isinstance(x, (bytes, bytearray)):
        return len(x)
    if isinstance(x, (tuple, list)):
        return sum(payload_bytes(v) for v in x)
    return 0


class TransportStats:
    """Wire accounting, backed by a :class:`MetricsRegistry` under the
    ``wire.*`` counter namespace. The attribute API (``stats.rpcs``,
    ``stats.retries += 1`` ...) is unchanged — the attributes are
    properties over registry counters, so one JSON dump of the
    registry sees everything the transport counted."""

    _KEYS = ("rpcs", "one_sided_writes", "one_sided_reads", "bytes_sent",
             "bytes_read", "rpc_resp_bytes", "retries",
             "retrans_rpcs", "retrans_bytes")

    def __init__(self, registry: MetricsRegistry = None):
        self.registry = (registry if registry is not None
                         else MetricsRegistry("transport"))
        for k in self._KEYS:
            self.registry.counters.setdefault("wire." + k, 0)
        self.per_node = {}

    def account(self, dst, nbytes, kind):
        e = self.per_node.setdefault(dst, {"rpcs": 0, "writes": 0,
                                           "reads": 0, "bytes": 0})
        e["bytes"] += nbytes
        if kind == "rpc":
            self.rpcs += 1
            e["rpcs"] += 1
        elif kind == "read":
            self.one_sided_reads += 1
            e["reads"] += 1
        else:
            self.one_sided_writes += 1
            e["writes"] += 1
        self.bytes_sent += nbytes

    def respond(self, dst, nbytes):
        """RPC response payload: crosses the wire but is not a hop."""
        self.rpc_resp_bytes += nbytes
        self.bytes_sent += nbytes
        e = self.per_node.setdefault(dst, {"rpcs": 0, "writes": 0,
                                           "reads": 0, "bytes": 0})
        e["bytes"] += nbytes

    def modeled_wire_s(self) -> float:
        return modeled_wire_s(bytes_sent=self.bytes_sent,
                              rpcs=self.rpcs,
                              one_sided_writes=self.one_sided_writes,
                              one_sided_reads=self.one_sided_reads)


def _wire_counter(key: str) -> property:
    full = "wire." + key

    def _get(self):
        return self.registry.counters[full]

    def _set(self, v):
        self.registry.counters[full] = v

    return property(_get, _set)


for _k in TransportStats._KEYS:
    setattr(TransportStats, _k, _wire_counter(_k))
del _k


class Transport:
    """In-process transport with endpoint registry and failure injection."""

    def __init__(self):
        self._endpoints = {}
        self._regions = {}
        self._down = set()
        # directed blocked links (src, dst): a partitioned message is
        # indistinguishable from a lost one, so blocked sends raise
        # RpcTimeout (transient), never NodeDown (the peer is healthy)
        self._blocked = set()
        self._lock = threading.RLock()
        # who is sending on this thread (see act_as): partition checks
        # and epoch headers need a sender identity, and worker threads
        # must self-identify at their entry points
        self._sender = threading.local()
        self.metrics = MetricsRegistry("transport")
        self.stats = TransportStats(self.metrics)
        self.tracer = Tracer()     # harness re-installs with cluster clock
        self.recorders = {}        # node_id -> FlightRecorder (see obs.py)
        self.injector = None       # optional FaultInjector (see faults.py)
        self.on_crash = None       # callback(node_id) for crash faults

    # -- fault injection ---------------------------------------------------
    def install_faults(self, injector) -> None:
        """Install (or clear, with None) a ``FaultInjector`` consulted on
        every RPC and one-sided op."""
        self.injector = injector

    def crashpoint(self, name: str, node_id: str) -> None:
        """Named crash point in protocol code (e.g. ``chain.mid``): if
        the installed injector schedules a crash here, kill ``node_id``
        via the ``on_crash`` callback (the harness wires ``kill_node``)
        and raise ``NodeDown`` out of the interrupted operation — the
        node died with the protocol step half done."""
        inj = self.injector
        if inj is None or not inj.should_crash(name, node_id):
            return
        # black-box the crash BEFORE killing the node: the recorder of
        # the victim must contain the crash point that killed it
        rec = self.recorders.get(node_id) if self.recorders else None
        if rec is not None:
            rec.record("crash", name)
        ctx = self.tracer.current() if self.tracer is not None else None
        if ctx is not None:
            ctx.annotate("crash." + name, node=node_id)
        cb = self.on_crash
        if cb is not None:
            cb(node_id)
        else:
            self.set_down(node_id)
        raise NodeDown(f"{node_id} (crashed at {name})")

    # -- membership -------------------------------------------------------
    def register_endpoint(self, node_id: str, obj) -> None:
        with self._lock:
            self._endpoints[node_id] = obj
            self._down.discard(node_id)

    def set_down(self, node_id: str, down: bool = True) -> None:
        with self._lock:
            if down:
                self._down.add(node_id)
            else:
                self._down.discard(node_id)

    def is_down(self, node_id: str) -> bool:
        return node_id in self._down

    def has_endpoint(self, node_id: str) -> bool:
        return node_id in self._endpoints

    # -- sender identity ---------------------------------------------------
    @contextlib.contextmanager
    def act_as(self, node_id: str):
        """Declare the sending node for transport ops on this thread.
        Nested uses restore the previous identity on exit. RPC dispatch
        sets the identity to the receiving node around the endpoint
        call, so chain forwards made *inside* a handler carry the
        forwarding hop as their sender automatically."""
        prev = getattr(self._sender, "node", None)
        self._sender.node = node_id
        try:
            yield
        finally:
            self._sender.node = prev

    def sender(self):
        return getattr(self._sender, "node", None)

    # -- partitions --------------------------------------------------------
    def partition(self, a, b, mode: str = "both") -> None:
        """Block links between node sets ``a`` and ``b``. ``mode`` is
        ``both`` (symmetric), ``a_to_b`` or ``b_to_a`` (asymmetric —
        messages flow one way only, the classic one-way-link failure).
        Partial partitions (only some pairs blocked) come from calling
        this with smaller sets, or ``block_link`` for a single pair."""
        a = [a] if isinstance(a, str) else list(a)
        b = [b] if isinstance(b, str) else list(b)
        with self._lock:
            for x in a:
                for y in b:
                    if x == y:
                        continue
                    if mode in ("both", "a_to_b"):
                        self._blocked.add((x, y))
                    if mode in ("both", "b_to_a"):
                        self._blocked.add((y, x))

    def heal(self, a=None, b=None) -> None:
        """Unblock links. No arguments heals everything; with sets the
        pairs between them (both directions) are removed."""
        with self._lock:
            if a is None and b is None:
                self._blocked.clear()
                return
            a = [a] if isinstance(a, str) else list(a)
            b = [b] if isinstance(b, str) else list(b)
            for x in a:
                for y in b:
                    self._blocked.discard((x, y))
                    self._blocked.discard((y, x))

    def block_link(self, src: str, dst: str) -> None:
        with self._lock:
            self._blocked.add((src, dst))

    def link_blocked(self, src, dst: str) -> bool:
        """Is the directed link src->dst blocked? ``src=None`` (no
        declared sender) is never blocked — partition checks only bind
        once a sender identity is established."""
        if src is None or not self._blocked:
            return False
        return (src, dst) in self._blocked

    def _check_link(self, dst: str, what: str):
        # callers guard on self._blocked, so the hot path (no partition
        # anywhere) never reaches the thread-local read or the f-string
        src = getattr(self._sender, "node", None)
        if src is not None and (src, dst) in self._blocked:
            raise RpcTimeout(f"{what}@{dst} (partitioned from {src})")

    def _check(self, node_id: str):
        if node_id in self._down:
            raise NodeDown(node_id)
        if node_id not in self._endpoints:
            raise NodeDown(f"{node_id} (unregistered)")

    # -- epoch fencing -----------------------------------------------------
    @staticmethod
    def _fence(receiver, dst: str, what: str, epoch) -> None:
        """Check a message's ``_epoch`` header against the receiver's
        view. Older → StaleEpoch back to the sender. Newer → the
        receiver adopts it first (epochs propagate on every message, so
        a heal catches nodes up without waiting for a heartbeat)."""
        if epoch is None or receiver is None:
            return
        view = getattr(receiver, "view_epoch", None)
        if view is None:
            return
        if epoch < view:
            raise StaleEpoch(f"{what}@{dst}: epoch {epoch} < view {view}")
        if epoch > view:
            observe = getattr(receiver, "observe_epoch", None)
            if observe is not None:
                observe(epoch)

    # -- RPC ---------------------------------------------------------------
    def _account_rpc(self, dst: str, nbytes: int,
                     retrans: bool = False) -> None:
        """Single accounting point for an RPC request (64B header
        model). Every *delivered* request is charged to the wire totals
        exactly once; an injected duplicate delivery is a retransmission
        — charged once more and tallied under ``retrans_*`` so
        consumers can split unique traffic from retransmitted bytes. A
        dropped request is charged nothing (the drop raises before
        delivery), so a retried RPC accounts exactly once per delivery."""
        self.stats.account(dst, nbytes + 64, "rpc")
        if retrans:
            self.stats.retrans_rpcs += 1
            self.stats.retrans_bytes += nbytes + 64

    def rpc(self, dst: str, method: str, *args, **kwargs):
        self._check(dst)
        if self._blocked:
            self._check_link(dst, method)
        epoch = kwargs.pop("_epoch", None) if kwargs else None
        trace = kwargs.pop("_trace", None) if kwargs else None
        tracer = self.tracer
        ctx = None
        if tracer is not None:
            # the _trace header names the trace explicitly (thread
            # handoffs); otherwise the sender's active context rides
            # along implicitly, exactly like _epoch piggybacking
            ctx = (tracer.resolve(trace) if trace is not None
                   else tracer.current())
        rec = self.recorders.get(dst) if self.recorders else None
        inj = self.injector
        act = inj.rpc_action(dst, method) if inj is not None else None
        if act is not None and rec is not None:
            rec.record("fault", f"{act}:rpc:{method}")
        if act == "drop":
            raise RpcTimeout(f"rpc {method}@{dst} (injected drop)")
        ep = self._endpoints[dst]
        if epoch is not None:
            self._fence(ep, dst, method, epoch)
        nbytes = sum(payload_bytes(a) for a in args)
        self._account_rpc(dst, nbytes)
        if rec is not None:
            rec.record("rpc", method)
        if ctx is not None:
            ctx.annotate("rpc." + method, node=dst, nbytes=nbytes)
        prev = getattr(self._sender, "node", None)
        self._sender.node = dst  # handler-side forwards send as dst
        tok = tracer.push(ctx) if ctx is not None else None
        try:
            result = getattr(ep, method)(*args, **kwargs)
            if act == "dup":
                # retransmitted duplicate: the receiver sees the call
                # twice and the request crosses the wire once more
                self._account_rpc(dst, nbytes, retrans=True)
                result = getattr(ep, method)(*args, **kwargs)
        finally:
            if ctx is not None:
                tracer.pop(tok)
            self._sender.node = prev
        resp = payload_bytes(result)
        if resp:
            self.stats.respond(dst, resp)
        return result

    # -- one-sided writes (RDMA WRITE semantics; ordered per (src,dst)) ----
    def register_region(self, node_id: str, region_id: str, sink) -> None:
        """sink: object with .write(offset:int|None, data:bytes)."""
        self._regions[(node_id, region_id)] = sink

    def one_sided_write(self, dst: str, region_id: str, data: bytes,
                        offset=None, _epoch=None) -> None:
        self._check(dst)
        if self._blocked:
            self._check_link(dst, region_id)
        sink = self._regions.get((dst, region_id))
        if sink is None:
            raise KeyError(f"region {region_id} not registered on {dst}")
        inj = self.injector
        act = inj.write_action(dst, region_id) if inj is not None else None
        if act is not None and self.recorders:
            rec = self.recorders.get(dst)
            if rec is not None:
                rec.record("fault", f"{act}:write:{region_id}")
        if act == "drop":
            raise RpcTimeout(f"write {region_id}@{dst} (injected drop)")
        # an epoch-stamped one-sided write fences against the region
        # owner's view: RDMA can't check this NIC-side, but Assise pairs
        # every slot push with an epoch-carrying chain RPC — modeling
        # the check here keeps the slot bytes and the fence atomic
        if _epoch is not None:
            self._fence(self._endpoints.get(dst), dst, region_id, _epoch)
        self.stats.account(dst, len(data), "write")
        if self.tracer is not None:
            ctx = self.tracer.current()
            if ctx is not None:
                ctx.annotate("write." + region_id, node=dst,
                             nbytes=len(data))
        sink.write(offset, data)
        if act == "dup":
            # duplicate delivery: receivers dedup by seqno (ReplicaSlot)
            self.stats.account(dst, len(data), "write")
            self.stats.retrans_bytes += len(data)
            sink.write(offset, data)

    def one_sided_read(self, dst: str, region_id: str, offset: int,
                       size: int, rkey: int = None) -> bytes:
        """RDMA READ: pull bytes out of a registered region with zero
        server-side work. ``rkey``, when given, must match the region
        sink's current key — a mismatch means the remote memory was
        reused (compaction/truncation) since the handle was resolved
        and raises ``StaleHandle`` instead of returning recycled bytes.
        The key is validated *again after* the read (optimistic
        concurrency): a reuse that raced the read invalidates its
        result, so a torn check-then-read window can never hand back
        recycled bytes as the value."""
        self._check(dst)
        if self._blocked:
            self._check_link(dst, region_id)
        sink = self._regions.get((dst, region_id))
        if sink is None:
            raise KeyError(f"region {region_id} not registered on {dst}")
        inj = self.injector
        act = inj.read_action(dst, region_id) if inj is not None else None
        if act is not None and self.recorders:
            rec = self.recorders.get(dst)
            if rec is not None:
                rec.record("fault", f"{act}:read:{region_id}")
        if act == "drop":
            raise RpcTimeout(f"read {region_id}@{dst} (injected drop)")
        if act == "stale":
            raise StaleHandle(f"{region_id}@{dst} (injected)")
        if rkey is not None and getattr(sink, "rkey", None) != rkey:
            raise StaleHandle(f"{region_id}@{dst} rkey={rkey}")
        self.stats.bytes_read += size
        self.stats.account(dst, size, "read")
        if self.tracer is not None:
            ctx = self.tracer.current()
            if ctx is not None:
                ctx.annotate("read." + region_id, node=dst, nbytes=size)
        try:
            data = sink.read(offset, size)
        except Exception:
            if rkey is not None and getattr(sink, "rkey", None) != rkey:
                # the read faulted because the memory went away mid-
                # flight (e.g. compaction unlinked a segment file):
                # that IS the stale-handle error, surface it as such
                raise StaleHandle(f"{region_id}@{dst} rkey={rkey}")
            raise
        if rkey is not None and getattr(sink, "rkey", None) != rkey:
            raise StaleHandle(f"{region_id}@{dst} rkey={rkey}")
        if act == "corrupt" and data:
            # in-flight bit flip: the payload of a one-sided read is
            # raw memory with no protocol-level CRC, so the receiver
            # sees silently wrong bytes unless it verifies them itself
            i = inj.rng.randrange(len(data))
            data = data[:i] \
                + bytes([data[i] ^ (1 << inj.rng.randrange(8))]) \
                + data[i + 1:]
        elif act == "torn" and data:
            # torn completion: a prefix of the payload arrives
            data = data[:inj.rng.randrange(len(data))]
        return data
