"""Sharding rules a model runs with on a mesh.

The port of the part of the JAX package's ``repro.launch.steps`` that
serving and training read: :func:`rules_for`, ``SEQ_POLICY_ARCHS`` and
:func:`effective_microbatches`.  The rest of the reference module builds
abstract jit programs for its dry runs, which have no torch counterpart.
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.models.sharding import AxisRules, default_rules

SEQ_POLICY_ARCHS = {"starcoder2-7b", "paligemma-3b", "whisper-base",
                    "recurrentgemma-2b"}


def _axis_size(mesh, name: str) -> int:
    shape = dict(mesh.shape) if hasattr(mesh, "shape") else dict(mesh)
    return shape.get(name, 1)


def rules_for(cfg: ArchConfig, mesh, overrides: dict = None) -> AxisRules:
    """Arch-appropriate logical-axis rules: TP over "model" and FSDP over
    "data" (``default_rules``), the ``"seq"`` policy where the heads do not
    divide the model axis, and ``manual_tp`` from ``d_model >= 8192`` (the
    reference's measured crossover), so that the rules equal the
    reference's.  ``mesh`` is a ``launch/mesh.Mesh`` or a ``{axis: size}``
    mapping.  The port computes one partitioning with or without
    ``manual_tp`` (``models/manual_tp``), and runs the ``"seq"`` policy as
    the reference shards the queries: on each rank's block of query rows
    (``manual_tp.attn_layout``)."""
    tp = _axis_size(mesh, "model")
    r = default_rules(mesh, seq_shard_attn=cfg.n_heads % max(tp, 1) != 0)
    if cfg.d_model >= 8192:
        r.rules["manual_tp"] = True
    if overrides:
        r.rules.update(overrides)
    return r


def effective_microbatches(cfg: ArchConfig, shape: ShapeConfig,
                           mesh) -> int:
    """Largest mb <= cfg.microbatches with (B/mb) divisible by the batch
    shards of this mesh."""
    shards = _axis_size(mesh, "pod") * _axis_size(mesh, "data")
    mb = max(1, cfg.microbatches)
    B = shape.global_batch
    while mb > 1 and (B % mb or (B // mb) % shards):
        mb //= 2
    return mb
