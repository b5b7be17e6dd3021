"""End-to-end training entry point.

The port of the JAX package's ``repro.launch.train``, on the card unless
``--device cpu`` is given:

    PYTHONPATH=src python -m repro_torch.launch.train --reduced \\
        --device cpu --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-7b \\
        --reduced --steps 200 --batch 8 --seq 128 --ckpt-dir ckpt

It restores from the newest checkpoint under ``--ckpt-dir`` automatically
(kill it and rerun to see the fault tolerance).  The learning rate is
``warmup_cosine(--lr, steps // 20, steps)``; the parameters start from a
generator seeded 0.  A published config at full depth does not fit one
card in float32 with AdamW's moments (starcoder2-7b: 16 bytes a
parameter, 118 GB); :func:`run` takes a config, so a caller can cut its
depth (``dataclasses.replace(cfg, n_layers=...)``) and drive the same
path.

On a mesh: :func:`run` takes a ``launch/mesh.Mesh`` (every rank of a
world calls it, e.g. under ``launch/mesh.spawn``); with more than one rank
it trains with ``rules_for(cfg, mesh)``: tensor parallel over
``"model"``, FSDP over ``"data"``, each rank building the whole
parameters in turn and keeping its shards.  ``--production-mesh`` asks
for ``make_production_mesh()``, which needs a world of 256 ranks (the
reference's pod) and raises a ``ValueError`` on any other.
"""
from __future__ import annotations

import argparse
import dataclasses

import torch


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="starcoder2-7b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--compression", action="store_true",
                    help="int8 gradient compression with error feedback")
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    return ap.parse_args(argv)


def config_for(args):
    """The arch's config, reduced with ``--reduced``, with
    ``--microbatches``."""
    from repro_torch.configs.base import get_config

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    return dataclasses.replace(cfg, microbatches=args.microbatches)


def _sharded_state(model, opt, args, dev, rules):
    """A rank's shards of the seeded initial state, the whole parameters
    built by one rank at a time (a barrier between ranks), so that only
    one whole copy is ever on a card the ranks share."""
    from repro_torch.train.optimizer import tree_map
    from repro_torch.train.train_step import TrainState

    mesh = rules.mesh
    world = mesh.size
    params = None
    for r in range(world):
        if r == mesh.rank % world:
            gen = torch.Generator(device=dev).manual_seed(0)
            params = model.shard_params(model.init(gen, dev, train=True),
                                        rules)
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        mesh.barrier()
    ef = (tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                   params) if args.compression else None)
    return TrainState(params=params, opt=opt.init(params), step=torch.zeros(
        (), dtype=torch.int32, device=dev), ef=ef)


def run(args, cfg, *, mesh=None, log_every: int = 10, log=print):
    """Train ``cfg`` as ``args`` say; returns (state, LoopStats).

    ``mesh``: a ``launch/mesh.Mesh`` every rank of the world passes
    (default: ``make_production_mesh()`` with ``--production-mesh``, else
    the one-rank host mesh); with more than one rank the state is the
    rank's shards and the batches are the whole global batch."""
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.core.engine import resolve_device
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    from repro_torch.launch.steps import rules_for
    from repro_torch.models.factory import build_model
    from repro_torch.train.data import batch_for_step
    from repro_torch.train.loop import LoopConfig, run_loop
    from repro_torch.train.optimizer import AdamW, tree_leaves, warmup_cosine
    from repro_torch.train.train_step import (init_train_state,
                                              make_train_step,
                                              state_shardings)

    if mesh is None:
        mesh = (make_production_mesh() if args.production_mesh
                else make_host_mesh())
    rules = rules_for(cfg, mesh) if mesh.size > 1 else None
    dev = resolve_device(args.device)
    shape = ShapeConfig("cli", "train", args.seq, args.batch)
    model = build_model(cfg)
    opt = AdamW()
    lr = warmup_cosine(args.lr, max(args.steps // 20, 1), args.steps)
    shardings = None
    if rules is None:
        state = init_train_state(model, torch.Generator(device=dev)
                                 .manual_seed(0), opt,
                                 compression=args.compression, device=dev)
    else:
        state = _sharded_state(model, opt, args, dev, rules)
        shardings = state_shardings(
            state._replace(params=model.param_shapes()),
            model.param_axes(), rules)
    step_fn = make_train_step(model, opt, lr, rules=rules,
                              microbatches=args.microbatches,
                              compression=args.compression)
    n_params = sum(x.numel() for x in tree_leaves(state.params))
    where = f"{dev}" if rules is None else \
        f"{dev}, mesh {dict(mesh.shape)} rank {mesh.rank} (its shards)"
    log(f"[train] {cfg.name} ({'reduced' if args.reduced else 'full'}, "
        f"{cfg.n_layers} layers) {n_params / 1e6:.1f}M params, {args.steps} "
        f"steps, batch {args.batch} x seq {args.seq} on {where}")
    lc = LoopConfig(n_steps=args.steps, ckpt_every=args.ckpt_every,
                    ckpt_dir=args.ckpt_dir, log_every=log_every)
    state, stats = run_loop(
        step_fn, state, lambda s: batch_for_step(cfg, shape, s, device=dev),
        lc, log=log, rules=rules, shardings=shardings)
    first = stats.history[0]["loss"] if stats.history else float("nan")
    last = stats.history[-1]["loss"] if stats.history else float("nan")
    log(f"[train] done: loss {first:.4f} -> {last:.4f} "
        f"({stats.steps_run} steps, {stats.straggler_events} straggler "
        f"events)")
    return state, stats


def main(argv=None):
    args = parse_args(argv)
    return run(args, config_for(args))


if __name__ == "__main__":
    main()
