"""Config schema: architectures x input shapes (the assigned 40-cell grid)."""

from __future__ import annotations

import dataclasses

from repro_torch.models.model import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}

FULL_ATTENTION_LONG_SKIP = (
    "`long_500k` skipped: pure full-attention architecture (quadratic-class "
    "decode state); runs only for SSM/hybrid archs per assignment."
)

ENCODER_ONLY_DECODE_SKIP = "no decode path: encoder-only architecture."


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    model: ModelConfig
    smoke: ModelConfig                  # reduced same-family config for CPU tests
    shapes: tuple[str, ...] = ("train_4k", "prefill_32k", "decode_32k")
    skip_notes: tuple[tuple[str, str], ...] = (
        ("long_500k", FULL_ATTENTION_LONG_SKIP),
    )
    source: str = ""

    @property
    def name(self) -> str:
        return self.model.name

    def supports(self, shape: str) -> bool:
        return shape in self.shapes
