"""Optimizer: AdamW (:mod:`repro_torch.optim.adamw`), learning-rate
schedules (:mod:`repro_torch.optim.schedule`) and int8 gradient compression
with error feedback (:mod:`repro_torch.optim.compression`)."""

from repro_torch.optim.adamw import AdamWConfig, adamw_update, global_norm, init_opt_state
from repro_torch.optim.compression import (
    Compressed,
    compress_with_feedback,
    compression_ratio,
    decompress,
    init_error_state,
)
from repro_torch.optim.schedule import constant, warmup_cosine

__all__ = [
    "AdamWConfig",
    "Compressed",
    "adamw_update",
    "compress_with_feedback",
    "compression_ratio",
    "constant",
    "decompress",
    "global_norm",
    "init_error_state",
    "init_opt_state",
    "warmup_cosine",
]
