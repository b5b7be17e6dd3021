"""Sharding rules a model runs with on a mesh, and one rank's whole step.

The port of the JAX package's ``repro.launch.steps``: :func:`rules_for`,
``SEQ_POLICY_ARCHS`` and :func:`effective_microbatches`, which serving and
training read, and the counterparts of its ``build_train_setup``,
``build_prefill_setup`` and ``build_decode_setup``.  The reference builds
abstract jit programs from ``ShapeDtypeStruct`` arguments and their
shardings; the port builds one rank's arguments as tensors on a given
device (meta or fake ones in ``launch/dryrun.py``) and returns the port's
own step over them: :func:`build_setup` gives ``(run, inputs)``,
``run()`` taking one step.

* train: ``make_train_step(rules=, microbatches=effective_microbatches)``
  over a ``TrainState`` of the rank's shards (the params in the
  reference's training dtypes, AdamW's moments and, where a param is not
  float32, its master copy, as ``train/optimizer.AdamW.init`` holds
  them) and the whole global batch (every rank gets it and takes its
  rows); forward, backward and the optimizer's update;
* prefill: ``serve/engine.make_prefill_step(max_len=seq_len, rules=)``
  over the rank's serving params and the whole batch;
* decode: ``serve/engine.make_decode_step(mesh=, rules=)`` over the
  rank's serving params, the whole batch's tokens ``[B, 1]`` and the
  rank's shard of a decode state of ``seq_len`` slots.

With ``mesh=None`` the step is one device's (no rules).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.models import encdec as encdec_lib
from repro_torch.models.factory import Model, build_model, state_zeros
from repro_torch.models.sharding import AxisRules, default_rules, local_shape
from repro_torch.train.optimizer import AdamW, tree_map, warmup_cosine

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
    shards of this mesh (``mesh`` None: one device)."""
    shards = (1 if mesh is None
              else _axis_size(mesh, "pod") * _axis_size(mesh, "data"))
    mb = max(1, cfg.microbatches)
    B = shape.global_batch
    while mb > 1 and (B % mb or (B // mb) % shards):
        mb //= 2
    return mb


# ---------------------------------------------------------------------------
# one rank's arguments


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    """The whole batch of one (arch x shape) cell as ``{name: (shape,
    dtype)}`` (the reference's ``factory.input_specs``): decode the tokens
    ``[B, 1]``; otherwise the tokens ``[B, S]`` (a vlm's ``S -
    num_image_tokens`` text positions after its ``image_embeds``, an
    encdec's ``frames [B, N_FRAMES, D]``), and for training the labels and
    the float32 loss mask."""
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if shape.kind == "decode":
        return {"tokens": ((B, 1), i32)}
    if cfg.family == "encdec":
        base = {"tokens": ((B, S), i32),
                "frames": ((B, encdec_lib.N_FRAMES, cfg.d_model),
                           cfg.cdtype)}
    elif cfg.family == "vlm":
        base = {"tokens": ((B, S - cfg.num_image_tokens), i32),
                "image_embeds": ((B, cfg.num_image_tokens, cfg.d_model),
                                 cfg.cdtype)}
    else:
        base = {"tokens": ((B, S), i32)}
    if shape.kind == "train":
        lbl = base["tokens"][0]
        base["labels"] = (lbl, i32)
        base["loss_mask"] = (lbl, torch.float32)
    return base


def param_local_specs(model: Model, rules: Optional[AxisRules],
                      train: bool) -> dict:
    """The rank's block of every param leaf as ``(shape, dtype)``
    (``Model.param_specs`` cut by ``param_axes`` and ``rules``; whole
    without rules)."""
    def cut(spec, ax):
        if isinstance(spec, dict):
            return {k: cut(spec[k], ax[k]) for k in spec}
        shape, dtype = spec
        return (shape if rules is None else local_shape(shape, ax, rules),
                dtype)
    return cut(model.param_specs(train), model.param_axes())


def empty_tree(specs, device):
    """Uninitialised tensors on ``device`` for a dict tree of ``(shape,
    dtype)`` leaves."""
    return tree_map(lambda s: torch.empty(s[0], dtype=s[1], device=device),
                    specs)


def _ints(specs, device) -> dict:
    """A batch tree: zero integer inputs (valid token ids), the rest
    uninitialised."""
    return {k: (torch.zeros(s, dtype=d, device=device)
                if not d.is_floating_point
                else torch.empty(s, dtype=d, device=device))
            for k, (s, d) in specs.items()}


def build_train_setup(cfg: ArchConfig, shape: ShapeConfig, mesh, rules,
                      device) -> tuple:
    from repro_torch.train.train_step import TrainState, make_train_step

    model = build_model(cfg)
    opt = AdamW()
    step_fn = make_train_step(
        model, opt, warmup_cosine(3e-4, 2000, 10**5), rules=rules,
        microbatches=effective_microbatches(cfg, shape, mesh))
    params = empty_tree(param_local_specs(model, rules, True), device)
    state = TrainState(params=params, opt=opt.init(params),
                       step=torch.zeros((), dtype=torch.int32, device=device))
    batch = _ints(input_specs(cfg, shape), device)
    return (lambda: step_fn(state, batch)), (state, batch)


def build_prefill_setup(cfg: ArchConfig, shape: ShapeConfig, mesh, rules,
                        device) -> tuple:
    from repro_torch.serve.engine import make_prefill_step

    model = build_model(cfg)
    params = empty_tree(param_local_specs(model, rules, False), device)
    batch = _ints(input_specs(cfg, shape), device)
    step = make_prefill_step(model, max_len=shape.seq_len, rules=rules)
    return (lambda: step(params, batch)), (params, batch)


def build_decode_setup(cfg: ArchConfig, shape: ShapeConfig, mesh, rules,
                       device) -> tuple:
    from repro_torch.serve.engine import make_decode_step

    model = build_model(cfg)
    params = empty_tree(param_local_specs(model, rules, False), device)
    state = state_zeros(model.decode_state_local_specs(
        shape.global_batch, shape.seq_len, rules=rules), device)
    tokens = _ints(input_specs(cfg, shape), device)["tokens"]
    step = make_decode_step(model, mesh=mesh if rules is not None else None,
                            rules=rules)
    return (lambda: step(params, tokens, state)), (params, tokens, state)


def build_setup(cfg: ArchConfig, shape: ShapeConfig, mesh, device,
                rules: Optional[AxisRules] = None
                ) -> tuple[Callable, tuple]:
    """``(run, inputs)``: ``run()`` takes one step of ``shape.kind`` for the
    rank of ``mesh`` (None: one device) on ``device``, with ``rules``
    (default :func:`rules_for`); ``inputs`` are its arguments."""
    if mesh is not None and rules is None:
        rules = rules_for(cfg, mesh)
    build = {"train": build_train_setup, "prefill": build_prefill_setup,
             "decode": build_decode_setup}[shape.kind]
    return build(cfg, shape, mesh, rules, device)
