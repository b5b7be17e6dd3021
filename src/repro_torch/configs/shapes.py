"""Assigned input-shape set (LM-family: seq_len x global_batch).

The port's copy of the JAX package's ``repro.configs.shapes`` (a module
without JAX, kept here so that the port imports nothing of the
reference).  ``train/data.py`` and ``launch/train.py`` take a
``ShapeConfig``.  decode_* / long_* are serving shapes; long_500k needs
sub-quadratic attention and applies only to archs with
``subquadratic=True`` (falcon-mamba, recurrentgemma).
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str          # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


def list_shapes():
    return list(SHAPES)


def applicable(cfg: ArchConfig, shape: str) -> bool:
    """long_500k needs sub-quadratic context handling."""
    if shape == "long_500k":
        return bool(cfg.subquadratic)
    return True


def skip_reason(cfg: ArchConfig, shape: str) -> str:
    if not applicable(cfg, shape):
        return (f"{cfg.name} is a full-attention arch; long_500k targets "
                "the sub-quadratic regime (SSM/hybrid).")
    return ""


def reduced_shape(shape: ShapeConfig) -> ShapeConfig:
    """CPU smoke-test variant."""
    return ShapeConfig(shape.name, shape.kind,
                       seq_len=min(shape.seq_len, 32),
                       global_batch=min(shape.global_batch, 2))
