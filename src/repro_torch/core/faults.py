"""Deterministic fault injection for the simulated transport (§3.4/§3.5
robustness harness).

Two composable modes, both installed via ``Transport.install_faults``:

- **scheduled faults**: explicit ``Fault`` specs that fire on the Nth
  call matching ``(op, dst, method)`` — exact, reproducible schedules
  for "drop the 3rd chain_continue to node1" style tests;
- **seeded random faults**: per-call probabilities drawn from
  ``random.Random(seed)`` — a deterministic pseudo-random adversary for
  property tests (same seed, same op sequence => same fault sequence).

Fault kinds:

- ``drop``  — the message is lost; the caller sees ``RpcTimeout``
  (retriable: see ``transport.with_retries``);
- ``dup``   — retransmitted duplicate delivery: the call executes twice
  (exercises idempotency of chain appends, digests, lease grants);
- ``delay`` — slow link: accounted (``injected['delay']``), not slept;
- ``stale`` — a one-sided read's handle is invalidated mid-flight
  (``StaleHandle``), forcing the ranged-RPC fallback path;
- ``corrupt`` — a one-sided read payload arrives with a flipped bit:
  no exception is raised; detection is entirely the reader's job
  (chunk-CRC verification, DESIGN.md §5.3);
- ``torn`` — a one-sided read payload arrives truncated (partial
  completion), again silently;
- ``crash`` — kill a node at a **named crash point** mid-protocol
  (``op`` holds the point name, e.g. ``chain.mid``); the transport
  invokes its ``on_crash`` callback (wired to ``kill_node`` by the
  harness) and raises ``NodeDown``.

Named crash points instrumented in the protocol code:

  ``chain.mid``    writer died between the one-sided slot write and the
                   chain_continue RPC (mid-chain-replication)
  ``chain.fwd``    a middle replica died while forwarding the chain
  ``digest.mid``   a replica died after applying its slot but before
                   truncating it (re-digest must be idempotent)
  ``digest.apply`` a node died mid-digest, before the area commit
  ``seal.mid``     writer died after sealing a log region but before
                   handing it to the digest worker
  ``lease.revoke`` holder died mid-revocation, before the grace flush

**Fairness guarantee**: random drops are never injected twice in a row
for the same ``(op, dst, method)`` site, so a bounded retry
(``attempts >= 2``) always makes progress. Fault injection tests
protocol *correctness* under transient faults, not liveness against an
unfair adversary; persistent failures are modeled by ``set_down`` /
``kill_node`` instead.
"""
from __future__ import annotations

import os
import random
from collections import Counter
from dataclasses import dataclass, field
from typing import List, Optional, Tuple


@dataclass
class Fault:
    """One scheduled fault. ``op`` is ``rpc`` / ``read`` / ``write`` —
    or, for ``kind='crash'``, the crash-point name. ``method`` matches
    the RPC method (or region id for one-sided ops); ``'*'`` matches
    anything. The fault fires on matching calls after skipping the
    first ``after`` of them, at most ``count`` times (-1 = always)."""

    kind: str   # drop | dup | delay | stale | corrupt | torn | crash
    op: str = "rpc"           # rpc | read | write | <crash-point name>
    dst: str = "*"
    method: str = "*"
    after: int = 0
    count: int = 1
    _seen: int = field(default=0, repr=False)
    _fired: int = field(default=0, repr=False)

    def _matches(self, dst: str, method: str) -> bool:
        return self.dst in ("*", dst) and self.method in ("*", method)

    def _try_fire(self) -> bool:
        self._seen += 1
        if self._seen <= self.after:
            return False
        if 0 <= self.count <= self._fired:
            return False
        self._fired += 1
        return True


class FaultInjector:
    """Consulted by ``Transport`` on every RPC / one-sided op. Scheduled
    faults are checked first (deterministic), then the seeded random
    adversary. ``injected`` counts fired faults by kind; ``events``
    records ``(kind, op, dst, method)`` tuples for assertions."""

    def __init__(self, faults: Tuple[Fault, ...] = (), *,
                 seed: Optional[int] = None, p_drop: float = 0.0,
                 p_dup: float = 0.0, p_delay: float = 0.0,
                 p_stale: float = 0.0, p_corrupt: float = 0.0,
                 p_torn: float = 0.0, max_random: Optional[int] = None):
        self.faults: List[Fault] = list(faults)
        self.rng = random.Random(seed)
        self.p_drop = p_drop
        self.p_dup = p_dup
        self.p_delay = p_delay
        self.p_stale = p_stale
        self.p_corrupt = p_corrupt
        self.p_torn = p_torn
        self.max_random = max_random
        self._n_random = 0
        self._no_drop = set()  # sites owed a fair retry (see module doc)
        self.injected = Counter()
        self.events: List[tuple] = []

    # -- bookkeeping -------------------------------------------------------
    def _record(self, kind: str, op: str, dst: str, method: str) -> str:
        self.injected[kind] += 1
        self.events.append((kind, op, dst, method))
        return kind

    # -- per-call decisions (called by Transport) --------------------------
    def _action(self, op: str, dst: str, method: str) -> Optional[str]:
        for f in self.faults:
            if f.kind == "crash" or f.op != op or not f._matches(dst,
                                                                 method):
                continue
            if f._try_fire():
                return self._record(f.kind, op, dst, method)
        return self._random_action(op, dst, method)

    def _random_action(self, op: str, dst: str,
                       method: str) -> Optional[str]:
        if self.max_random is not None \
                and self._n_random >= self.max_random:
            return None
        key = (op, dst, method)
        retrying = key in self._no_drop
        if retrying:
            self._no_drop.discard(key)
        # one draw per call, partitioned into kind intervals: the fault
        # sequence is a pure function of (seed, call sequence)
        r = self.rng.random()
        lo = 0.0
        for kind, p in (("drop", self.p_drop), ("dup", self.p_dup),
                        ("stale", self.p_stale), ("delay", self.p_delay),
                        ("corrupt", self.p_corrupt),
                        ("torn", self.p_torn)):
            if p <= 0.0:
                continue
            if kind == "stale" and op != "read":
                continue  # only one-sided reads carry an rkey
            if kind in ("corrupt", "torn") and op != "read":
                continue  # payload faults model one-sided read pulls
            if kind == "dup" and op == "read":
                continue  # duplicate read delivery is invisible
            if lo <= r < lo + p:
                if kind == "drop" and retrying:
                    return None  # fairness: never drop the same retry
                if kind == "drop":
                    self._no_drop.add(key)
                self._n_random += 1
                return self._record(kind, op, dst, method)
            lo += p
        return None

    def rpc_action(self, dst: str, method: str) -> Optional[str]:
        return self._action("rpc", dst, method)

    def read_action(self, dst: str, region_id: str) -> Optional[str]:
        return self._action("read", dst, region_id)

    def write_action(self, dst: str, region_id: str) -> Optional[str]:
        return self._action("write", dst, region_id)

    def should_crash(self, point: str, node_id: str) -> bool:
        """Whether a scheduled crash fault fires at this named crash
        point on this node (random mode never crashes — node loss is an
        explicit schedule decision)."""
        for f in self.faults:
            if f.kind != "crash" or f.op != point \
                    or not f._matches(node_id, "*"):
                continue
            if f._try_fire():
                self._record("crash", point, node_id, "*")
                return True
        return False


@dataclass
class PartitionSpec:
    """One partition event in a schedule: at ``start`` (inclusive, in
    whatever tick unit the driver uses — op index or clock seconds)
    block links between node sets ``a`` and ``b`` in ``mode``
    (``both`` / ``a_to_b`` / ``b_to_a`` — see ``Transport.partition``);
    at ``heal`` (if not None) unblock exactly those pairs again."""

    a: tuple
    b: tuple
    mode: str = "both"
    start: float = 0.0
    heal: Optional[float] = None


class PartitionSchedule:
    """Deterministic partition driver: ``tick(now)`` applies every
    start/heal whose time has come, in schedule order, and returns
    human-readable event strings for logging/assertions. Idempotent per
    event — re-ticking the same ``now`` does nothing new."""

    def __init__(self, transport, events: List[PartitionSpec]):
        self.transport = transport
        self.events = list(events)
        self._started: set = set()
        self._healed: set = set()

    def tick(self, now: float) -> List[str]:
        fired = []
        for i, ev in enumerate(self.events):
            if i not in self._started and now >= ev.start:
                self._started.add(i)
                self.transport.partition(ev.a, ev.b, mode=ev.mode)
                fired.append(f"partition {ev.a}~{ev.b} ({ev.mode})")
            if i in self._started and i not in self._healed \
                    and ev.heal is not None and now >= ev.heal:
                self._healed.add(i)
                self.transport.heal(ev.a, ev.b)
                fired.append(f"heal {ev.a}~{ev.b}")
        return fired

    def done(self) -> bool:
        """All events started and (where a heal is scheduled) healed."""
        return all(i in self._started
                   and (ev.heal is None or i in self._healed)
                   for i, ev in enumerate(self.events))


class BitRot:
    """Seeded **at-rest** corruptor: flips one bit in data that is
    already persisted — segment files, replica-slot region buffers, or
    group-commit journal frames — *behind the back* of the in-memory
    index and chunk-CRC tables, which keep describing the original
    bytes. That is exactly the media-corruption model: the metadata is
    the truth, the bytes rotted underneath it.

    Every flip is recorded in ``flips`` as ``(surface, detail)`` so
    tests and benches can assert that each injected corruption was
    later detected/repaired."""

    def __init__(self, seed: Optional[int] = None):
        self.rng = random.Random(seed)
        self.flips: List[tuple] = []

    def _flip_bit(self, b: int) -> int:
        return b ^ (1 << self.rng.randrange(8))

    def flip_in_store(self, store, path: str) -> bool:
        """Flip one bit inside a random needle referenced by ``path``'s
        index entry in a ``SegmentStore`` (or a shard of a
        ``ShardedSegmentStore``). Returns False when the path is absent.
        The store's in-memory index and CRCs are left untouched."""
        sh = store.shard_for(path) if hasattr(store, "shard_for") \
            else store
        with sh._lock:
            loc = sh.index.get(path)
            if loc is None:
                return False
            units = [u for u in sh._loc_units(loc) if u[2] > 0]
            if not units:
                return False
            seg_id, voff, vlen = self.rng.choice(units)
            sh.commit()  # the needle must be on disk before we rot it
            i = self.rng.randrange(vlen)
            fd = os.open(sh._seg_path(seg_id), os.O_RDWR)
            try:
                b = os.pread(fd, 1, voff + i)
                os.pwrite(fd, bytes([self._flip_bit(b[0])]), voff + i)
            finally:
                os.close(fd)
        self.flips.append(("segment", (sh.root, seg_id, path, i)))
        return True

    def flip_in_slot(self, slot, path: str) -> bool:
        """Flip one bit of ``path``'s needle inside a ``ReplicaSlot``'s
        region buffer (the memory one-sided reads are served from). The
        slot's entry mirror holds separate bytes and stays clean — the
        defined corruption surface is the region, and repair re-encodes
        the region from the mirror."""
        with slot._lock:
            loc = slot._locs.get(path)
            if loc is None or loc[1] == 0:
                return False
            boff, n = loc[0], loc[1]
            i = self.rng.randrange(n)
            slot._buf[boff + i] = self._flip_bit(slot._buf[boff + i])
        self.flips.append(("slot", (slot.path, path, i)))
        return True

    def flip_in_journal(self, journal, frame: Optional[int] = None) -> \
            Optional[int]:
        """Flip one bit inside the payload of a framed batch in a
        ``CommitJournal`` ring (frame header left intact, so the frame
        still parses but its CRC no longer matches). ``frame`` picks a
        specific frame index; None picks one at random. Returns the
        corrupted frame's index, or None when the ring holds no
        complete frames."""
        from repro_torch.core.groupcommit import _FRAME
        frames = []  # (payload_off, payload_len)
        buf = os.pread(journal._fd, journal.capacity, 0)
        off, n = 0, len(buf)
        while off + _FRAME.size <= n:
            plen, dlen, _crc = _FRAME.unpack_from(buf, off)
            if plen == 0:
                break
            end = off + _FRAME.size + plen + dlen
            if end > n:
                break
            frames.append((off + _FRAME.size, plen + dlen))
            off = end
        if not frames:
            return None
        idx = self.rng.randrange(len(frames)) if frame is None else frame
        foff, flen = frames[idx]
        i = foff + self.rng.randrange(flen)
        b = os.pread(journal._fd, 1, i)
        os.pwrite(journal._fd, bytes([self._flip_bit(b[0])]), i)
        self.flips.append(("journal", (journal.path, idx, i)))
        return idx
