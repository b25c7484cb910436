"""Octopus-like baseline: RDMA to remote NVM but NO client cache and no
replication — every op crosses the network (the paper's Octopus rows)."""
from __future__ import annotations

import os
from typing import Optional

from repro_torch.core.extents import splice
from repro_torch.core.segstore import SegmentStore
from repro_torch.core.transport import Transport


class RemoteNVMServer:
    """Remote NVM target. Backed by the same segment-log engine as
    Assise's areas (an RDMA WRITE to NVM is durable on arrival, so each
    put commits) — baselines differ in architecture, not engine."""

    def __init__(self, node_id: str, root: str, transport: Transport):
        self.node_id = node_id
        self.store = SegmentStore(root)
        transport.register_endpoint(node_id, self)

    def put(self, path: str, data: bytes) -> None:
        self.store.put(path, data)
        self.store.commit()

    def get(self, path: str) -> Optional[bytes]:
        return self.store.get(path)

    def delete(self, path: str) -> None:
        self.store.delete(path)

    def rename(self, src: str, dst: str) -> None:
        self.store.rename(src, dst)


class NoCacheClient:
    def __init__(self, proc_id: str, cluster: "NoCacheCluster"):
        self.proc_id = proc_id
        self.c = cluster
        self.stats = {"puts": 0, "gets": 0}

    def _server_for(self, path: str) -> str:
        # distributed hashing over storage nodes (like Octopus)
        idx = hash(path) % len(self.c.servers)
        return self.c.servers[idx].node_id

    def put(self, path: str, data: bytes) -> None:
        self.stats["puts"] += 1
        self.c.transport.rpc(self._server_for(path), "put", path, data)

    def write(self, path: str, data: bytes, offset: int = 0) -> None:
        """Byte-range write without a client cache: fetch the whole
        object over the wire, patch, push the whole object back — every
        small write pays two full-object transfers (the Octopus rows)."""
        self.put(path, splice(self.get(path) or b"", offset, data))

    def get(self, path: str) -> Optional[bytes]:
        self.stats["gets"] += 1
        return self.c.transport.rpc(self._server_for(path), "get", path)

    def rename(self, src: str, dst: str) -> None:
        data = self.get(src)
        if data is None:
            return
        self.c.transport.rpc(self._server_for(src), "delete", src)
        self.put(dst, data)

    def delete(self, path: str) -> None:
        self.c.transport.rpc(self._server_for(path), "delete", path)

    def fsync(self) -> None:  # Octopus fsync is a no-op (paper §5.2)
        pass

    dsync = fsync


class NoCacheCluster:
    def __init__(self, root_dir: str, n_servers: int = 2):
        self.transport = Transport()
        self.servers = [RemoteNVMServer(f"nvm{i}",
                                        os.path.join(root_dir, f"nvm{i}"),
                                        self.transport)
                        for i in range(n_servers)]

    def open_client(self, proc_id: str) -> NoCacheClient:
        return NoCacheClient(proc_id, self)
