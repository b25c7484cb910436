"""Decoder models: layers, attention, Mamba, RWKV6, MoE, the transformer."""
from repro_torch.models.transformer import (Model, RunConfig, init_params,
                                            init_cache, count_params,
                                            count_active_params)

__all__ = ["Model", "RunConfig", "init_params", "init_cache", "count_params",
           "count_active_params"]
