from repro_torch.ckpt.checkpoint import AssiseCheckpointer, CheckpointConfig
from repro_torch.ckpt.delta import block_delta_encode, block_delta_apply

__all__ = ["AssiseCheckpointer", "CheckpointConfig", "block_delta_encode",
           "block_delta_apply"]
