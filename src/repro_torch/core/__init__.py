"""CC-NVM adapted to training-state management (the paper's contribution).

Public surface:
  AssiseCluster  — simulated multi-node cluster harness
  LibState       — process-linked client (LibFS analogue)
  UpdateLog      — operation-granularity persistent log
  SharedFS       — per-node daemon (tiers, digest, leases, slots)
  ClusterManager — membership, epochs, chains, lease root
"""
from repro_torch.core.cluster import ClusterManager
from repro_torch.core.extents import ExtentOverlay, splice
from repro_torch.core.faults import (BitRot, Fault, FaultInjector, PartitionSchedule,
                               PartitionSpec)
from repro_torch.core.groupcommit import JournalCorruption
from repro_torch.core.harness import AssiseCluster
from repro_torch.core.integrity import CorruptExtent
from repro_torch.core.log import (Entry, UpdateLog, OP_DELETE, OP_PUT, OP_RENAME,
                            OP_WRITE, decode_stream)
from repro_torch.core.segstore import FileArea, SegmentStore
from repro_torch.core.sharedfs import SharedFS
from repro_torch.core.store import LibState, WriterFenced, recover_process
from repro_torch.core.transport import (Transport, NodeDown, RpcTimeout,
                                  StaleEpoch, StaleHandle, with_retries)

__all__ = ["AssiseCluster", "BitRot", "ClusterManager", "CorruptExtent",
           "Entry", "ExtentOverlay",
           "Fault", "FaultInjector", "FileArea", "JournalCorruption",
           "LibState", "NodeDown", "PartitionSchedule", "PartitionSpec",
           "RpcTimeout", "SegmentStore", "SharedFS", "StaleEpoch",
           "StaleHandle",
           "Transport", "UpdateLog", "WriterFenced",
           "OP_PUT", "OP_DELETE", "OP_RENAME",
           "OP_WRITE", "decode_stream", "recover_process", "splice",
           "with_retries"]
