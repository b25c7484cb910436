from repro_torch.data.pipeline import TokenPipeline, PipelineState

__all__ = ["TokenPipeline", "PipelineState"]
