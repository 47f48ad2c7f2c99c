from .pipeline import PipelineConfig, TokenPipeline

__all__ = ["PipelineConfig", "TokenPipeline"]
