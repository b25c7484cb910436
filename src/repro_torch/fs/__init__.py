from repro_torch.fs.disagg import DisaggregatedCluster, DisaggClient
from repro_torch.fs.nocache import NoCacheCluster, NoCacheClient

__all__ = ["DisaggregatedCluster", "DisaggClient", "NoCacheCluster",
           "NoCacheClient"]
