"""The synthetic token pipeline (a numpy copy of the JAX package's
``data/``: batches are bitwise equal for the same seed, step and host)."""
from .pipeline import PipelineConfig, TokenPipeline, batch_for

__all__ = ["PipelineConfig", "TokenPipeline", "batch_for"]
