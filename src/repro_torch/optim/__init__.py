from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                                     clip_by_global_norm)
from repro_torch.optim.compress import (compress_grads, decompress_grads,
                                        CompressionConfig, init_error_state)

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "clip_by_global_norm",
           "compress_grads", "decompress_grads", "CompressionConfig",
           "init_error_state"]
