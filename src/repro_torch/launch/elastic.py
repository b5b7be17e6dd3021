"""Elastic re-mesh: restore a checkpoint onto a different mesh.

The port of the JAX package's ``repro.launch.elastic``.  A job
checkpointed on mesh M resumes on mesh M' after ranks are lost or added.
Checkpoints hold whole leaves (``train/checkpoint.py``, whatever mesh
wrote them), so resharding is a restore that cuts each leaf to the new
mesh's block for the rank:

    state, rules, step = reshard_restore(ckpt_dir, cfg, new_mesh)

Every rank of ``new_mesh`` calls it (building rules reads the mesh's
coordinates; no collective runs).  ``mesh=None`` or a one-rank mesh gives
the whole state and no rules.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.engine import resolve_device
from repro_torch.launch.steps import rules_for
from repro_torch.models.factory import build_model
from repro_torch.models.transformer import storage_dtype
from repro_torch.train import checkpoint as ck
from repro_torch.train.optimizer import AdamState, tree_leaves
from repro_torch.train.train_step import TrainState, state_shardings


def _empty(shapes: dict, dtype_of, dev, path=()) -> dict:
    """A tree of 0-d tensors with each leaf's dtype and device: all that
    ``checkpoint.restore`` reads of a target leaf."""
    if isinstance(shapes, dict):
        return {k: _empty(v, dtype_of, dev, path + (k,))
                for k, v in shapes.items()}
    return torch.empty((), dtype=dtype_of(path), device=dev)


def reshard_restore(ckpt_dir: str, cfg: ArchConfig, mesh, *,
                    step: Optional[int] = None, device=None):
    """Restore the newest (or given) checkpoint onto ``mesh`` on ``device``
    (the card unless the caller asks for the CPU).

    Returns (TrainState of this rank's shards on the new mesh, rules,
    step).  The state is the reference's train state: the params in their
    training dtypes, float32 moments, a master copy only where a param
    is not float32, no error-feedback residual."""
    dev = resolve_device(device)
    model = build_model(cfg)
    shapes = model.param_shapes()
    params = _empty(shapes, lambda p: storage_dtype(p, cfg, True), dev)
    f32s = _empty(shapes, lambda p: torch.float32, dev)
    needs_master = any(t.dtype != torch.float32 for t in tree_leaves(params))
    scalar = torch.empty((), dtype=torch.int32, device=dev)
    target = TrainState(
        params=params,
        opt=AdamState(mu=f32s, nu=f32s, count=scalar,
                      master=f32s if needs_master else None),
        step=scalar, ef=None)
    shardings = rules = None
    if mesh is not None and mesh.size > 1:
        rules = rules_for(cfg, mesh)
        shardings = state_shardings(target._replace(params=shapes),
                                    model.param_axes(), rules)
    state, got_step, _ = ck.restore(ckpt_dir, step, target=target,
                                    shardings=shardings, rules=rules)
    return state, rules, got_step
