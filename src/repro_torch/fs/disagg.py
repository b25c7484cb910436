"""Disaggregated baseline (Ceph/NFS-like) for the paper's comparisons.

Design mirrors what the paper measures against:
- clients and storage servers are *separate* nodes;
- client cache is a **volatile** block cache (4KB blocks — block
  amplification for small IO), lost on any crash;
- every fsync pushes dirty blocks to the (replicated) storage servers
  over the transport; metadata ops hit a central MDS;
- recovery rebuilds the client cache from the servers on demand.

All ops are accounted through the same Transport so benchmarks can
compare RPC counts / bytes / modeled wire time against Assise.
"""
from __future__ import annotations

import os
import time
from collections import OrderedDict
from typing import Dict, List, Optional

from repro_torch.core.extents import splice
from repro_torch.core.segstore import SegmentStore
from repro_torch.core.transport import Transport

BLOCK = 4096


class StorageServer:
    """Replicated object/block server (OSD analogue).

    Persistence uses the same segment-log engine as Assise's SharedFS
    areas (committed per RPC — the OSD's per-request durability), so the
    baseline comparison isolates *architecture* (disaggregation, block
    amplification, central MDS), not the storage engine underneath."""

    def __init__(self, node_id: str, root: str, transport: Transport):
        self.node_id = node_id
        self.root = root
        self.store = SegmentStore(root)
        transport.register_endpoint(node_id, self)

    def put_blocks(self, path: str, data: bytes) -> int:
        self.store.put(path, data)
        self.store.commit()
        return len(data)

    def get_blocks(self, path: str) -> Optional[bytes]:
        return self.store.get(path)

    def delete(self, path: str) -> None:
        self.store.delete(path)

    def rename(self, src: str, dst: str) -> None:
        self.store.rename(src, dst)


class MetadataServer:
    """Central MDS: namespace + block placement (the scalability choke)."""

    def __init__(self, node_id: str, transport: Transport):
        self.node_id = node_id
        self.namespace: Dict[str, int] = {}  # path -> size
        self.ops = 0
        transport.register_endpoint(node_id, self)

    def lookup(self, path: str) -> Optional[int]:
        self.ops += 1
        return self.namespace.get(path)

    def create(self, path: str, size: int) -> None:
        self.ops += 1
        self.namespace[path] = size

    def delete(self, path: str) -> None:
        self.ops += 1
        self.namespace.pop(path, None)

    def rename(self, src: str, dst: str) -> None:
        self.ops += 1
        if src in self.namespace:
            self.namespace[dst] = self.namespace.pop(src)


class DisaggClient:
    """Client with a volatile 4KB-block cache (kernel buffer cache)."""

    def __init__(self, proc_id: str, cluster: "DisaggregatedCluster",
                 cache_capacity: int = 2 << 30):
        self.proc_id = proc_id
        self.c = cluster
        self.cache = OrderedDict()  # path -> bytes (block-rounded)
        self.cache_capacity = cache_capacity
        self.cache_bytes = 0
        self.dirty: Dict[str, bytes] = {}
        self.stats = {"puts": 0, "gets": 0, "hits": 0, "misses": 0}

    def _round(self, data: bytes) -> bytes:
        pad = (-len(data)) % BLOCK
        return data + b"\x00" * pad if pad else data

    def _cache_put(self, path: str, data: bytes) -> None:
        old = self.cache.pop(path, None)
        if old is not None:
            self.cache_bytes -= len(old)
        blk = self._round(data)
        self.cache[path] = blk
        self.cache_bytes += len(blk)
        while self.cache_bytes > self.cache_capacity and self.cache:
            _, v = self.cache.popitem(last=False)
            self.cache_bytes -= len(v)

    def put(self, path: str, data: bytes) -> None:
        self.stats["puts"] += 1
        self._cache_put(path, data)
        self.dirty[path] = data

    def write(self, path: str, data: bytes, offset: int = 0) -> None:
        """Byte-range write: kernel-buffer-cache read-modify-write. The
        client must materialize the whole object (fetching it on a cache
        miss) and fsync pushes whole 4KB-rounded blocks to every replica
        — the block amplification Assise's extent path avoids."""
        self.put(path, splice(self.get(path) or b"", offset, data))

    def get(self, path: str) -> Optional[bytes]:
        self.stats["gets"] += 1
        if path in self.dirty:
            return self.dirty[path]
        v = self.cache.get(path)
        if v is not None:
            self.stats["hits"] += 1
            self.cache.move_to_end(path)
            size = self.c.transport.rpc(self.c.mds.node_id, "lookup", path)
            return v[:size] if size is not None else v
        self.stats["misses"] += 1
        size = self.c.transport.rpc(self.c.mds.node_id, "lookup", path)
        if size is None:
            return None
        v = self.c.transport.rpc(self.c.servers[0].node_id, "get_blocks",
                                 path)
        if v is None:
            return None
        self._cache_put(path, v)
        return v[:size]

    def get_range(self, path: str, offset: int,
                  length: int) -> Optional[bytes]:
        """Ranged read through a block cache: a miss fetches the WHOLE
        object from the server (kernel readahead/block granularity — the
        wire amplification Assise's locate + one-sided range read
        avoids), then slices locally."""
        full = self.get(path)
        return None if full is None else full[offset:offset + length]

    def multiget(self, paths: List[str]):
        """No batched server surface: one lookup+fetch round-trip pair
        per cold path."""
        return {p: self.get(p) for p in paths}

    def rename(self, src: str, dst: str) -> None:
        self.fsync()
        self.c.transport.rpc(self.c.mds.node_id, "rename", src, dst)
        for srv in self.c.servers:
            self.c.transport.rpc(srv.node_id, "rename", src, dst)
        if src in self.cache:
            self._cache_put(dst, self.cache.pop(src))

    def delete(self, path: str) -> None:
        self.dirty.pop(path, None)
        self.cache.pop(path, None)
        self.c.transport.rpc(self.c.mds.node_id, "delete", path)
        for srv in self.c.servers:
            self.c.transport.rpc(srv.node_id, "delete", path)

    def fsync(self) -> None:
        """Push dirty blocks to ALL replicas (Ceph replicates in parallel,
        consuming replication-factor x the client bandwidth)."""
        for path, data in self.dirty.items():
            blk = self._round(data)
            self.c.transport.rpc(self.c.mds.node_id, "create", path,
                                 len(data))
            for srv in self.c.servers:
                self.c.transport.rpc(srv.node_id, "put_blocks", path, blk)
        self.dirty.clear()

    dsync = fsync

    def crash(self) -> None:
        """Volatile cache is lost — recovery refetches from servers."""
        self.cache.clear()
        self.cache_bytes = 0
        self.dirty.clear()


class DisaggregatedCluster:
    def __init__(self, root_dir: str, n_servers: int = 2):
        self.transport = Transport()
        self.mds = MetadataServer("mds", self.transport)
        self.servers: List[StorageServer] = [
            StorageServer(f"osd{i}", os.path.join(root_dir, f"osd{i}"),
                          self.transport)
            for i in range(n_servers)]

    def open_client(self, proc_id: str, **kw) -> DisaggClient:
        return DisaggClient(proc_id, self, **kw)
