"""Data: the deterministic token pipeline (:mod:`repro_torch.data.pipeline`)."""

from repro_torch.data.pipeline import DataPipeline, MemmapSource, PipelineConfig, SyntheticSource

__all__ = ["DataPipeline", "MemmapSource", "PipelineConfig", "SyntheticSource"]
