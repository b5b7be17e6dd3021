"""Run the distributed backend on a world of local ranks.

    PYTHONPATH=src python -m repro_torch.launch.distributed --world 4 \\
        --backend gloo --device cpu --side 16 --block-size 32 \\
        --mesh 1x4 --mesh 2x2 --kinds sssp,bfs,ppr,cc,kreach,rw

starts ``--world`` ranks (``launch/mesh.spawn``), joined by ``--backend``:
``gloo`` where ranks share one card or run on the CPU, ``nccl`` for one
rank per card.  Without ``--device`` every rank runs on the card
``rank % device_count``.  Each rank builds the same ``grid2d`` graph and
session, and every rank runs every (mesh, kind) case through
``FPPSession.run(kind, sources, backend="distributed", mesh=...)``.  One
JSON line per case follows: the mesh, the kind, supersteps, total edges,
and each rank's device syncs, wall seconds and kernel launches; the
command fails unless every rank returned the same answer bit for bit.

:func:`run_cases` is the rank-side body (a test or a smoke run spawns it
with its own cases); :func:`decode_inputs` makes the seeded inputs of a
partitioned-decode case.  :func:`run_lm_cases` is the rank-side body of
the LM on a mesh: a model's prefill, decode, forward and
``ContinuousBatcher`` on a rank's shards of its params.
:func:`run_train_cases` is the one of training on a mesh: train steps on
a rank's shards of a state, checkpoints and reshards, or
``launch/train.run`` itself.  :func:`run_count_cases` takes one real step
of ``launch/steps.build_setup`` a case and returns what the rank counted,
which ``launch/dryrun.py``'s ``DryMesh`` must count the same.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def decode_inputs(shape, seed: int, dtype: str = "float32"):
    """Seeded ``(q [B, H, hd] float32, k, v [B, S, Hkv, hd] in dtype)`` on
    the CPU, the same in every process; ``shape = (B, S, H, Hkv, hd)``."""
    B, S, H, Hkv, hd = shape
    gen = torch.Generator().manual_seed(int(seed))
    q = torch.randn((B, H, hd), generator=gen)
    k = torch.randn((B, S, Hkv, hd), generator=gen).to(getattr(torch, dtype))
    v = torch.randn((B, S, Hkv, hd), generator=gen).to(getattr(torch, dtype))
    return q, k, v


def _kernel_modules() -> tuple:
    from repro_torch.kernels.flash_attention import ops as faops
    from repro_torch.kernels.frontier import ops as fops
    from repro_torch.kernels.fused_visit import ops as fvops
    from repro_torch.kernels.minplus import ops as mops
    from repro_torch.kernels.ppr_push import ops as pops
    from repro_torch.kernels.threefry import ops as tfops
    return mops, fops, pops, fvops, faops, tfops


def _launches() -> dict:
    """Every kernel wrapper's launch count on this rank."""
    return {k: v for m in _kernel_modules() for k, v in m.LAUNCHES.items()}


def _reset_launches() -> None:
    for m in _kernel_modules():
        m.reset_launches()


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _decode_case(case: dict, mesh, dev) -> dict:
    from repro_torch.models.attention import decode_attend_partitioned
    B, S = case["shape"][:2]
    q, k, v = decode_inputs(case["shape"], case["seed"], case["dtype"])
    nb, ns = mesh.shape["data"], mesh.shape["model"]
    if B % nb or S % ns:
        raise ValueError(f"decode batch {B} and cache {S} must divide by "
                         f"the mesh {mesh.shape}")
    b_loc, s_loc = B // nb, S // ns
    rows = slice(mesh.coords["data"] * b_loc, (mesh.coords["data"] + 1)
                 * b_loc)
    cols = slice(mesh.coords["model"] * s_loc, (mesh.coords["model"] + 1)
                 * s_loc)
    length = torch.as_tensor(np.asarray(case["lengths"], dtype=np.int32))
    q, length = q[rows].to(dev), length[rows].to(dev)
    k, v = (x[rows, cols].contiguous().to(dev) for x in (k, v))
    _sync(dev)
    t = time.perf_counter()
    out = decode_attend_partitioned(q, k, v, length, mesh,
                                    window=case.get("window"))
    out = torch.cat(list(mesh.all_gather(out, "data")), dim=0)
    _sync(dev)
    return {"out": out.float().cpu().numpy(),
            "wall_s": time.perf_counter() - t}


def run_cases(rank: int, cases: list, device=None) -> list:
    """Run ``cases`` on this rank; every rank of the world runs the same
    list (building a mesh is collective).  A case is a dict:

    * a query: ``graph`` ``(generator name, kwargs)`` of
      ``graphs/generators``, ``mesh`` ``(data, model)`` (None: the default
      mesh), ``kind``, ``sources`` (original ids), ``num_queries``,
      ``block_size`` (None: the planner's), and optional ``k``,
      ``length``, ``seed``, ``eps`` as ``FPPSession.run`` takes them;
    * a partitioned decode: ``decode`` True, ``mesh``, ``shape`` ``(B, S,
      H, Hkv, hd)``, ``seed``, ``dtype``, ``lengths`` and an optional
      ``window`` (inputs from :func:`decode_inputs`).

    Returns one dict per case: the answer (``values``, ``residual``,
    ``edges``, ``stats``; or ``out``), ``wall_s`` and this rank's kernel
    ``launches`` during the case."""
    from repro_torch.core.engine import resolve_device
    from repro_torch.fpp import FPPSession
    from repro_torch.fpp.backends import default_mesh
    from repro_torch.graphs import generators
    from repro_torch.launch.mesh import make_host_mesh

    dev = resolve_device(device)
    meshes: dict = {}
    sessions: dict = {}
    out = []
    for case in cases:
        shape = case.get("mesh")
        key = None if shape is None else tuple(shape)
        if key not in meshes:
            meshes[key] = default_mesh() if key is None else \
                make_host_mesh(*key)
        mesh = meshes[key]
        _reset_launches()
        if case.get("decode"):
            res = _decode_case(case, mesh, dev)
            res["launches"] = _launches()
            out.append(res)
            continue
        name, kw = case["graph"]
        skey = (name, tuple(sorted(kw.items())), case["num_queries"],
                case.get("block_size"))
        if skey not in sessions:
            g = getattr(generators, name)(**kw)
            sessions[skey] = FPPSession(g, device=dev).plan(
                num_queries=case["num_queries"],
                block_size=case.get("block_size"))
        sess = sessions[skey]
        opts = {k: case[k] for k in ("k", "length", "seed", "eps")
                if k in case}
        _sync(dev)
        t = time.perf_counter()
        res = sess.run(case["kind"], np.asarray(case["sources"]),
                       backend="distributed", mesh=mesh, **opts)
        _sync(dev)
        out.append({"values": res.values, "residual": res.residual,
                    "edges": res.edges_processed, "stats": res.stats,
                    "wall_s": time.perf_counter() - t,
                    "launches": _launches()})
    return out


# ---------------------------------------------------------------------------
# the LM on a mesh


def _lm_params(model, case: dict, rules, dev):
    """A rank's shards of the case's params: the whole ``arrays`` (numpy,
    the reference's tree) cut by ``convert.lm_params_from_arrays``, or
    ``Model.init`` from the generator seeded ``seed`` on ``dev``, built
    whole by one rank at a time (a barrier between ranks), so that only
    one whole copy is ever on a card that the ranks share."""
    import torch.distributed as dist

    from repro_torch.convert import lm_params_from_arrays
    if "arrays" in case:
        return lm_params_from_arrays(case["arrays"], model.cfg, dev, rules)
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    mine = None
    for r in range(world):
        if r == rank:
            gen = torch.Generator(device=dev).manual_seed(case["seed"])
            mine = model.shard_params(model.init(gen, dev), rules)
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        if world > 1:
            dist.barrier()
    return mine


def _lm_batch(tokens, extras, dev) -> dict:
    batch = {"tokens": torch.as_tensor(np.asarray(tokens, np.int64),
                                       device=dev)}
    for k, v in (extras or {}).items():
        batch[k] = torch.as_tensor(np.asarray(v, np.float32), device=dev)
    return batch


def _whole_rows(x: torch.Tensor, batch: int, mesh) -> np.ndarray:
    """A rank's rows of a ``[batch, ...]`` result -> every row (an
    all-gather over ``"data"`` when the rows are split), float32 numpy."""
    if x.shape[0] < batch:
        x = torch.cat(list(mesh.all_gather(x, "data")))
    return x.float().cpu().numpy()


def _state_arrays(state) -> dict:
    """``{"kv/k": numpy, ..., "lru/h": numpy}``: the leaves of a
    ``DecodeState`` that it has, as this rank holds them."""
    return {f"{part}/{name}": leaf.float().cpu().numpy().copy()
            for part in ("kv", "ssm", "lru")
            if getattr(state, part) is not None
            for name, leaf in zip(getattr(state, part)._fields,
                                  getattr(state, part))}


def _lm_teacher(model, params, t: dict, mesh, rules, dev) -> dict:
    """A prefill of the batch ``t["tokens"] [B, S]`` (and ``extras``) at
    ``max_len`` (``chunk``: the transformer's prefill chunk), then one
    decode step for each ``t["steps"]`` row ``[B]`` of tokens, fed as
    given (teacher forcing).  Every row's logits, the prefill's wall
    seconds, collectives and each of its attention blocks' layout
    (:class:`LayoutLog`); with ``t["state"]`` also the rank's decode state
    after the prefill (:func:`_state_arrays`)."""
    from repro_torch.models import transformer as tfm

    batch = _lm_batch(t["tokens"], t.get("extras"), dev)
    B = batch["tokens"].shape[0]
    c0 = mesh.calls
    _sync(dev)
    t0 = time.perf_counter()
    with LayoutLog() as layouts:
        if "chunk" in t:
            logits, state = tfm.prefill(params, model.cfg, batch["tokens"],
                                        max_len=t["max_len"],
                                        chunk=t["chunk"], rules=rules)
        else:
            logits, state = model.prefill(params, batch,
                                          max_len=t["max_len"], rules=rules)
    _sync(dev)
    out = {"prefill_s": time.perf_counter() - t0,
           "prefill": _whole_rows(logits, B, mesh), "decode": [],
           "prefill_collectives": mesh.calls - c0,
           "prefill_layouts": layouts.kinds}
    if t.get("state"):
        out["state"] = _state_arrays(state)
    calls = []
    for row in t.get("steps", ()):
        tok = torch.as_tensor(np.asarray(row, np.int64)[:, None], device=dev)
        c0 = mesh.calls
        logits, state = model.decode(params, tok, state, mesh=mesh,
                                     rules=rules)
        calls.append(mesh.calls - c0)
        out["decode"].append(_whole_rows(logits, B, mesh))
    out["decode"] = np.stack(out["decode"]) if out["decode"] else None
    out["collectives_per_decode_step"] = calls
    return out


def _lm_serve(model, params, s: dict, mesh, rules, dev) -> dict:
    """``ContinuousBatcher(mesh=, rules=)`` over ``s["prompts"]`` (and
    ``extras``, one per prompt) at ``batch`` and ``max_len``, ``new`` tokens
    each: the tokens, and this rank's walls, prefill times, each prefill's
    collectives and attention layouts (:class:`LayoutLog`), collectives a
    decode step (the model's, without the batcher's gather and check of
    the tokens), kernel launches and, on the card, the peak allocated
    over the first decode step alone (``decode_step_peak_bytes``: its
    peak counters are reset before it; ``peak_before_decode_bytes`` keeps
    the case's peak up to then)."""
    from repro_torch.serve.engine import (ContinuousBatcher, Request,
                                          make_decode_step,
                                          make_prefill_step)
    prefill = make_prefill_step(model, max_len=s["max_len"], rules=rules)
    decode = make_decode_step(model, mesh=mesh, rules=rules)
    prefill_s, prefill_calls, prefill_layouts, decode_calls = [], [], [], []

    def timed_prefill(p, batch):
        _sync(dev)
        c0 = mesh.calls
        t0 = time.perf_counter()
        with LayoutLog() as layouts:
            out = prefill(p, batch)
        _sync(dev)
        prefill_s.append(time.perf_counter() - t0)
        prefill_calls.append(mesh.calls - c0)
        prefill_layouts.append(layouts.kinds)
        return out

    peaks = []      # the card's peak before the first decode step, in it

    def counted_decode(p, tokens, state):
        c0 = mesh.calls
        first = dev.type == "cuda" and not peaks
        if first:
            peaks.append(torch.cuda.max_memory_allocated(dev))
            torch.cuda.reset_peak_memory_stats(dev)
        out = decode(p, tokens, state)
        if first:
            peaks.append(torch.cuda.max_memory_allocated(dev))
        decode_calls.append(mesh.calls - c0)
        return out

    b = ContinuousBatcher(model, params, s["batch"], s["max_len"], device=dev,
                          mesh=mesh, rules=rules, prefill_fn=timed_prefill,
                          decode_fn=counted_decode)
    extras = s.get("extras") or [None] * len(s["prompts"])
    for rid, (p, ex) in enumerate(zip(s["prompts"], extras)):
        b.submit(Request(rid=rid, prompt=np.asarray(p, np.int32),
                         max_new_tokens=s["new"],
                         extras=None if ex is None else dict(ex)))
    _reset_launches()
    calls0 = mesh.calls
    _sync(dev)
    t = time.perf_counter()
    tokens = b.run()
    _sync(dev)
    wall = time.perf_counter() - t
    decode_tokens = b.tokens_out - len(s["prompts"])
    return {"tokens": tokens, "wall_s": wall, "prefill_s": prefill_s,
            "prefill_collectives": prefill_calls,
            "prefill_layouts": prefill_layouts,
            "decode_s": wall - sum(prefill_s), "decode_steps": b.steps,
            "decode_tok_per_s": decode_tokens / (wall - sum(prefill_s)),
            "collectives_per_decode_step": (
                sum(decode_calls) / max(len(decode_calls), 1)),
            "collectives": mesh.calls - calls0, "launches": _launches(),
            "peak_before_decode_bytes": peaks[0] if peaks else None,
            "decode_step_peak_bytes": peaks[1] if peaks else None}


class LayoutLog:
    """While active, records the layout (``manual_tp.AttnLayout.kv``:
    ``"heads"``, ``"replicated"``, ``"full"`` or ``"seq"``) of every
    attention block that ``manual_tp.manual_attention`` runs, in call
    order (:attr:`kinds`); :meth:`counts` tallies them.  It also records
    the training forward's layer-boundary carries (:attr:`carries`,
    ``transformer.CARRY_LOG``): one ``(layout, shape)`` a layer call,
    ``"rows"`` (the rank's sequence rows under ``"act_seq"``) or
    ``"whole"``, and the shape the layer's checkpoint received."""

    def __enter__(self):
        from repro_torch.models import manual_tp as tp
        from repro_torch.models import transformer
        self.carries, self._carry_log = [], transformer.CARRY_LOG
        transformer.CARRY_LOG = self.carries
        self.kinds, self._fns = [], (tp.manual_attention, tp.attn_layout)
        attention, layout = self._fns
        open_calls = []   # per manual_attention call: its layout recorded?

        def spy_attention(*args, **kwargs):
            open_calls.append(False)
            try:
                return attention(*args, **kwargs)
            finally:
                open_calls.pop()

        def spy_layout(*args, **kwargs):
            lay = layout(*args, **kwargs)
            if open_calls and not open_calls[-1]:
                open_calls[-1] = True
                self.kinds.append(lay.kv)
            return lay
        tp.manual_attention, tp.attn_layout = spy_attention, spy_layout
        return self

    def __exit__(self, *exc):
        from repro_torch.models import manual_tp as tp
        from repro_torch.models import transformer
        tp.manual_attention, tp.attn_layout = self._fns
        transformer.CARRY_LOG = self._carry_log

    def counts(self) -> dict:
        return {k: self.kinds.count(k) for k in sorted(set(self.kinds))}


class RouteLog:
    """While active, records every moe layer's routing: the expert ids
    ``[B, S, K]`` and slots that ``models/moe.route`` returns, with the
    trash slot ``E * C`` of that call (no host read while recording)."""

    def __enter__(self):
        from repro_torch.models import moe
        self.calls, self._route = [], moe.route

        def spy(gate_idx, C, E):
            slot = self._route(gate_idx, C, E)
            self.calls.append((gate_idx, slot, E * C))
            return slot
        moe.route = spy
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe.route = self._route

    def dropped(self) -> list:
        """Each call's share of (token, choice) entries dropped."""
        return [float((slot == trash).float().mean())
                for _, slot, trash in self.calls]

    def summary(self, picks: bool = False) -> dict:
        """The calls recorded, their (token, choice) entries, the share
        dropped past capacity, and a sha1 of the picks (every call's
        expert ids in call order): ranks that routed the same rows compare
        their picks without moving them.  With ``picks``, the picks too
        (int16 numpy, one array a call)."""
        import hashlib
        h = hashlib.sha1()
        entries = dropped = 0
        for gate_idx, slot, trash in self.calls:
            h.update(gate_idx.to(torch.int64).cpu().numpy().tobytes())
            entries += slot.numel()
            dropped += int((slot == trash).sum())
        out = {"calls": len(self.calls), "entries": entries,
               "dropped": dropped,
               "dropped_share": dropped / max(entries, 1),
               "picks_sha1": h.hexdigest()}
        if picks:
            out["picks"] = [g.to(torch.int16).cpu().numpy()
                            for g, _, _ in self.calls]
        return out

    def agreement(self, other: "RouteLog") -> dict:
        """Routing decisions of two runs over the same tokens: the share of
        (layer, token, chosen expert) picks both made, and of (layer,
        token) whose whole expert set is the same."""
        picks = same_sets = n_picks = n_sets = 0
        for (a, _, _), (b, _, _) in zip(self.calls, other.calls, strict=True):
            E = int(max(a.max(), b.max())) + 1
            ha = torch.nn.functional.one_hot(a, E).sum(-2)
            hb = torch.nn.functional.one_hot(b, E).sum(-2)
            picks += int((ha * hb).sum())
            n_picks += a.numel()
            same_sets += int((ha == hb).all(-1).sum())
            n_sets += ha[..., 0].numel()
        return {"picks_agree": picks / n_picks,
                "sets_agree": same_sets / n_sets,
                "sets_differ": n_sets - same_sets, "sets": n_sets}


def run_lm_cases(rank: int, cases: list, device=None) -> list:
    """Run LM ``cases`` on this rank of a world (every rank the same list:
    building a mesh is collective).  A case is a dict:

    * ``arch``, optional ``reduced`` (``ArchConfig.reduced()``) and
      ``config`` (fields replaced after it, e.g. ``{"compute_dtype":
      "float32"}``), optional ``overrides`` (extra rules, e.g.
      ``{"manual_tp": True}``) and ``mesh`` ``(data, model)``; the rules
      are ``launch/steps.rules_for(cfg, mesh, overrides)``;
    * the weights: ``arrays`` (the reference's numpy tree) or ``seed``
      (:func:`_lm_params`);
    * any of ``teacher`` (:func:`_lm_teacher`), ``logits`` (``{"tokens",
      "extras"}``: ``Model.logits`` of that batch, with its own
      ``overrides`` on top of the case's, every ``stride``-th position's
      row; its attention blocks' layouts in ``logits_layouts``),
      ``control`` (a teacher part with its own ``overrides`` on top of the
      case's: the same prefill under other rules, e.g. ``{"seq": None}``)
      and ``serve`` (:func:`_lm_serve`), run in that order on the same
      params;
    * ``routing`` (a moe model): record the rank's routing over the parts
      (:class:`RouteLog`; ``"picks"``: its picks too).

    Returns one dict per case with each part's result (logits as float32
    numpy with every row of the batch), ``wall_s``, this rank's kernel
    ``launches`` over the parts before ``serve`` (which counts its own),
    its card's ``peak_mem_bytes`` over the case and, with ``routing``, its
    ``RouteLog.summary()``."""
    import contextlib
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.core.engine import resolve_device
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import rules_for
    from repro_torch.models.factory import build_model

    dev = resolve_device(device)
    meshes: dict = {}
    out = []
    for case in cases:
        key = tuple(case["mesh"])
        if key not in meshes:
            meshes[key] = make_host_mesh(*key)
        mesh = meshes[key]
        cfg = get_config(case["arch"])
        cfg = cfg.reduced() if case.get("reduced") else cfg
        cfg = dataclasses.replace(cfg, **case.get("config", {}))
        model = build_model(cfg)
        rules = rules_for(cfg, mesh, case.get("overrides"))
        _reset_launches()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        _sync(dev)
        t = time.perf_counter()
        params = _lm_params(model, case, rules, dev)
        _sync(dev)
        res = {"params_s": time.perf_counter() - t}
        routes = RouteLog() if case.get("routing") else \
            contextlib.nullcontext()
        with torch.inference_mode(), routes:
            if "teacher" in case:
                res["teacher"] = _lm_teacher(model, params, case["teacher"],
                                             mesh, rules, dev)
            if "logits" in case:
                lg = case["logits"]
                batch = _lm_batch(lg["tokens"], lg.get("extras"), dev)
                lrules = rules_for(cfg, mesh, {**case.get("overrides", {}),
                                               **lg.get("overrides", {})})
                with LayoutLog() as layouts:
                    logits, _ = model.logits(params, batch, rules=lrules,
                                             remat=False)
                res["logits"] = _whole_rows(
                    logits[:, ::lg.get("stride", 1)], len(lg["tokens"]), mesh)
                res["logits_layouts"] = layouts.kinds
            if "control" in case:
                ctl = case["control"]
                crules = rules_for(cfg, mesh, {**case.get("overrides", {}),
                                               **ctl["overrides"]})
                res["control"] = _lm_teacher(model, params, ctl, mesh,
                                             crules, dev)
                del logits
            res["launches"] = _launches()
            if "serve" in case:
                res["serve"] = _lm_serve(model, params, case["serve"], mesh,
                                         rules, dev)
        if case.get("routing"):
            res["routing"] = routes.summary(case["routing"] == "picks")
        res["wall_s"] = time.perf_counter() - t
        res["peak_mem_bytes"] = (max(
            torch.cuda.max_memory_allocated(dev),
            res.get("serve", {}).get("peak_before_decode_bytes") or 0)
            if dev.type == "cuda" else None)
        del params
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        out.append(res)
    return out


# ---------------------------------------------------------------------------
# training on a mesh


def _np_leaves(tree) -> dict:
    """``{path: float32-or-own-dtype numpy}`` of a train state's tensors
    (the checkpoint's path strings)."""
    from repro_torch.train.checkpoint import _flatten
    return {k: v.detach().cpu().numpy() for k, v in _flatten(tree).items()}


def _digests(tree) -> dict:
    """``{path: sha1 of the leaf's bytes}``: replicas compared bit for bit
    without moving whole leaves between processes."""
    import hashlib

    from repro_torch.train.checkpoint import _flatten
    return {k: hashlib.sha1(v.detach().reshape(-1).view(torch.uint8)
                            .cpu().numpy().tobytes()).hexdigest()
            for k, v in _flatten(tree).items()}


def _train_cfg(case: dict):
    import dataclasses

    from repro_torch.configs.base import get_config
    cfg = get_config(case["arch"])
    cfg = cfg.reduced() if case.get("reduced") else cfg
    return dataclasses.replace(cfg, **case.get("config", {}))


def _train_legs(case: dict, cfg, model, dev, meshes: dict) -> dict:
    """The steps of a case from a carried state (see
    :func:`run_train_cases`)."""
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.convert import train_state_from_arrays
    from repro_torch.launch.elastic import reshard_restore
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import rules_for
    from repro_torch.train import checkpoint as ck
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.data import batch_for_step
    from repro_torch.train.train_step import (grads_of, make_train_step,
                                              state_shardings)

    def mesh_of(shape):
        if shape is None:
            return None
        key = tuple(shape)
        if key not in meshes:
            meshes[key] = make_host_mesh(*key)
        return meshes[key]

    mesh = mesh_of(case["mesh"])
    rules = rules_for(cfg, mesh, case.get("overrides")) \
        if mesh is not None and mesh.size > 1 else None
    state = train_state_from_arrays(**case["state"], device=dev, cfg=cfg,
                                    rules=rules)
    shape = ShapeConfig("t", "train", case["seq"], case["batch"])
    name, lr_args = case["lr"]
    lr = getattr(opt_lib, name)(*lr_args)
    opt = opt_lib.AdamW()
    out = {"legs": []}
    if case.get("grads"):
        g, m = grads_of(model, state.params, batch_for_step(
            cfg, shape, 0, device=dev), rules=rules,
            microbatches=case["microbatches"])
        out["grads"] = _np_leaves(g)
        out["grad_metrics"] = {k: float(v) for k, v in m.items()}
        del g
    step = case.get("first_step", 0)
    legs = [(case["mesh"], case["steps"])] + list(case.get("reshard", ()))
    for i, (mshape, n) in enumerate(legs):
        if i:
            mesh = mesh_of(mshape)
            state, rules, got = reshard_restore(case["ckpt_dir"], cfg, mesh,
                                                device=dev)
            if got != step:
                raise RuntimeError(f"restored step {got}, want {step}")
        fn = make_train_step(model, opt, lr, rules=rules,
                             microbatches=case["microbatches"],
                             compression=case.get("compression", False))
        leg = {"mesh": mshape, "loss": [], "ce": [], "aux": [],
               "grad_norm": [], "bits": [], "calls": [], "step_s": []}
        for _ in range(n):
            batch = batch_for_step(cfg, shape, step, device=dev)
            c0 = mesh.calls if mesh is not None else 0
            _sync(dev)
            t = time.perf_counter()
            state, m = fn(state, batch)
            _sync(dev)
            leg["step_s"].append(time.perf_counter() - t)
            leg["calls"].append((mesh.calls if mesh is not None else 0) - c0)
            loss, norm = float(m["loss"]), float(m["grad_norm"])
            leg["loss"].append(loss)
            leg["ce"].append(float(m["ce"]))
            leg["aux"].append(float(m["aux"]))
            leg["grad_norm"].append(norm)
            leg["bits"].append(np.array([loss, norm], np.float32).tobytes())
            step += 1
        if case.get("ckpt_dir") and i + 1 < len(legs):
            specs = None if rules is None else state_shardings(
                state._replace(params=model.param_shapes()),
                model.param_axes(), rules)
            ck.save(case["ckpt_dir"], step, state, specs=specs,
                    mesh=None if rules is None else mesh)
        leg["state"] = _np_leaves(state)
        out["legs"].append(leg)
    return out


def _train_launch(case: dict, dev) -> dict:
    """``launch/train.run`` on the case's mesh (see
    :func:`run_train_cases`)."""
    import dataclasses

    from repro_torch.launch import steps
    from repro_torch.launch import train as tlaunch
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh(*case["mesh"])
    overrides = case.get("overrides")
    args = tlaunch.parse_args(case["argv"])
    cfg = dataclasses.replace(tlaunch.config_for(args),
                              **case.get("config", {}))
    marks = []   # (collectives, their seconds, B6 launches) at each step

    def log(msg):
        if msg.startswith("[train] ") and not marks or \
                msg.startswith("[loop] step"):
            _sync(dev)
            marks.append((mesh.calls, mesh.seconds,
                          _launches()["flash_attention"]))
    rules_for = steps.rules_for
    if overrides:
        # launch/train.run builds its rules with rules_for(cfg, mesh)
        steps.rules_for = lambda c, m: rules_for(c, m, overrides)
    try:
        state, stats = tlaunch.run(args, cfg, mesh=mesh, log_every=1,
                                   log=log)
    finally:
        steps.rules_for = rules_for
    calls, coll_s, b6 = ([b[i] - a[i] for a, b in zip(marks, marks[1:])]
                         for i in range(3))
    return {"history": stats.history, "step_s": stats.step_times,
            "restored_step": stats.restored_step, "calls": calls,
            "collective_s": coll_s, "b6": b6,
            "bits": [np.array([h["loss"], h["grad_norm"]], np.float32)
                     .tobytes() for h in stats.history],
            "digests": _digests(state), "rank": mesh.rank,
            "coords": dict(mesh.coords)}


def _psum_case(case: dict, dev) -> dict:
    """``train/compress.compressed_psum`` of the rank's row ``x[r]`` of
    ``case["x"] [world, ...]`` over ``case["axis"]`` of ``case["mesh"]``."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train.compress import compressed_psum
    mesh = make_host_mesh(*case["mesh"])
    x = torch.as_tensor(np.asarray(case["x"])[mesh.rank], device=dev)
    return {"out": compressed_psum(x, mesh, case["axis"]).cpu().numpy()}


def run_count_cases(rank: int, cases: list, device="cpu") -> list:
    """One real step a case on this rank of a world (every rank the same
    list): ``launch/steps.build_setup`` for the case's ``arch`` (reduced,
    ``config`` fields replaced), a ``ShapeConfig`` of ``shape = (kind,
    seq_len, global_batch)`` and the ``mesh`` ``(data, model)``, its float
    inputs drawn (seeded 0, ``0.02 * normal``), run under
    ``FlopCounterMode``.  Returns per case the rank's coordinates, the
    mesh's ``collectives()`` over the step, the FLOPs by op and the output
    leaves' shapes."""
    import dataclasses

    from torch.utils.flop_counter import FlopCounterMode
    from torch.utils._pytree import tree_leaves

    from repro_torch.configs import base as cfg_base
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_setup

    dev = torch.device(device)
    out = []
    for case in cases:
        cfg = dataclasses.replace(cfg_base.get_config(case["arch"]).reduced(),
                                  **case.get("config", {}))
        kind, seq, batch = case["shape"]
        shape = ShapeConfig(f"{kind}_{seq}x{batch}", kind, seq, batch)
        mesh = make_host_mesh(*case["mesh"])
        run, inputs = build_setup(cfg, shape, mesh, dev)
        gen = torch.Generator(device=dev).manual_seed(0)
        for t in tree_leaves(inputs):
            if isinstance(t, torch.Tensor) and t.is_floating_point():
                t.copy_(0.02 * torch.randn(t.shape, generator=gen,
                                           device=dev))
        mesh.reset_counts()
        with FlopCounterMode(display=False) as fc:
            res = run()
        flops = {str(k): int(v) for k, v in
                 fc.get_flop_counts()["Global"].items()}
        out.append({"coords": dict(mesh.coords),
                    "collectives": mesh.collectives(), "flops": flops,
                    "out_shapes": [tuple(t.shape) for t in tree_leaves(res)
                                   if isinstance(t, torch.Tensor)]})
    return out


def run_train_cases(rank: int, cases: list, device=None) -> list:
    """Run training ``cases`` on this rank of a world (every rank the same
    list: building a mesh is collective).  A case is a dict with ``arch``,
    optional ``reduced`` and ``config`` (fields replaced after it),
    ``mesh`` ``(data, model)``, optional ``overrides`` (``rules_for``'s, on
    the case's mesh: ``{"act_seq": None}`` keeps the carry whole), and
    either

    * ``argv``: ``launch/train.py``'s arguments, run through
      ``launch/train.run(args, cfg, mesh=)`` (``cfg`` from its
      ``config_for``, ``config`` replaced; the CLI's own state, seeded 0);
      returns the loop's history and step times, the collectives (their
      count and seconds) and B6 launches of each step, the rank's state
      digests; or
    * ``state`` (the reference's numpy train state, cut by
      ``convert.train_state_from_arrays(..., rules=)``), ``seq``,
      ``batch``, ``microbatches``, ``lr`` (``(schedule name, args)`` of
      ``train/optimizer.py``), ``steps``, optional ``compression``,
      ``grads`` (also return the first batch's gradient shards and
      metrics) and
      ``ckpt_dir`` with ``reshard`` (``[(mesh or None, steps), ...]``:
      after each leg the state is saved there and
      ``launch/elastic.reshard_restore`` puts it on the next leg's mesh),
      ``first_step`` (the data step of the first batch, default 0: a
      state carried after that many steps).
      Returns each leg's losses (and their ``ce`` and ``aux`` parts),
      grad norms, their float32 bits, collectives and seconds a step, and
      its final state's shards; or
    * ``psum``: ``{"mesh", "axis", "x" [world, ...]}``, the rank's
      ``compressed_psum`` of its row (``out``).

    Every case also returns ``wall_s``, the rank's kernel ``launches``,
    its card's ``peak_mem_bytes`` (allocated) and ``peak_reserved_bytes``
    (held by the caching allocator: what ranks sharing a card add up),
    ``layouts``, the attention blocks it ran by layout
    (``LayoutLog.counts()``: forward, recompute and every microbatch), and
    ``carries``, the layer-boundary carries of every forward
    (``LayoutLog.carries``); with ``routing`` (a moe model), the rank's
    ``RouteLog.summary()`` over the case."""
    import contextlib

    from repro_torch.core.engine import resolve_device
    from repro_torch.models.factory import build_model

    dev = resolve_device(device)
    meshes: dict = {}
    out = []
    for case in cases:
        _reset_launches()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        t = time.perf_counter()
        routes = RouteLog() if case.get("routing") else \
            contextlib.nullcontext()
        with routes, LayoutLog() as layouts:
            if "psum" in case:
                res = _psum_case(case["psum"], dev)
            elif "argv" in case:
                res = _train_launch(case, dev)
            else:
                cfg = _train_cfg(case)
                res = _train_legs(case, cfg, build_model(cfg), dev, meshes)
        if case.get("routing"):
            res["routing"] = routes.summary()
        res["layouts"] = layouts.counts()
        res["carries"] = layouts.carries
        res["wall_s"] = time.perf_counter() - t
        res["launches"] = _launches()
        res["peak_mem_bytes"] = (torch.cuda.max_memory_allocated(dev)
                                 if dev.type == "cuda" else None)
        res["peak_reserved_bytes"] = (torch.cuda.max_memory_reserved(dev)
                                      if dev.type == "cuda" else None)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        out.append(res)
    return out


def run_mesh_cases(rank: int, lm_cases: list, train_cases: list,
                   device=None) -> tuple:
    """:func:`run_lm_cases` then :func:`run_train_cases` on one world (its
    ranks start once)."""
    return (run_lm_cases(rank, lm_cases, device),
            run_train_cases(rank, train_cases, device))


def same_answers(per_rank: list) -> bool:
    """Every rank's answers bit for bit equal to rank 0's (values,
    residual, edges, supersteps; a decode's output)."""
    def key(r):
        if "out" in r:
            return (r["out"].tobytes(),)
        return (r["values"].tobytes(), None if r["residual"] is None
                else r["residual"].tobytes(), r["edges"].tobytes(),
                r["stats"]["supersteps"])
    first = [key(r) for r in per_rank[0]]
    return all([key(r) for r in rank] == first for rank in per_rank[1:])


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--backend", choices=("gloo", "nccl"), required=True)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--side", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--queries", type=int, default=64)
    ap.add_argument("--block-size", type=int, default=None)
    ap.add_argument("--mesh", action="append", default=None,
                    help="DATAxMODEL; repeatable (default: 1xWORLD)")
    ap.add_argument("--kinds", default="sssp,bfs,ppr,cc,kreach,rw")
    ap.add_argument("--timeout", type=float, default=60.0)
    return ap.parse_args(argv)


def main(argv=None) -> list:
    from repro_torch.launch.mesh import spawn

    args = parse_args(argv)
    n = args.side * args.side
    srcs = np.random.default_rng(args.seed).choice(n, args.queries,
                                                   replace=False)
    meshes = [tuple(int(x) for x in m.split("x"))
              for m in (args.mesh or [f"1x{args.world}"])]
    cases = [{"graph": ("grid2d", {"rows": args.side, "cols": args.side,
                                   "seed": args.seed}),
              "mesh": m, "kind": kind, "sources": srcs.tolist(),
              "num_queries": args.queries, "block_size": args.block_size}
             for m in meshes for kind in args.kinds.split(",")]
    per_rank = spawn(run_cases, args.world, args.backend,
                     args=(cases, args.device), timeout_s=args.timeout)
    if not same_answers(per_rank):
        raise RuntimeError("the ranks returned different answers")
    for i, case in enumerate(cases):
        r0 = per_rank[0][i]
        print(json.dumps({
            "mesh": list(case["mesh"]), "backend": args.backend,
            "kind": case["kind"], "supersteps": r0["stats"]["supersteps"],
            "edges": float(r0["edges"].sum()),
            "device_syncs": [r[i]["stats"]["device_syncs"]
                             for r in per_rank],
            "wall_s": [r[i]["wall_s"] for r in per_rank],
            "launches": [r[i]["launches"] for r in per_rank]}))
    return per_rank


if __name__ == "__main__":
    main()
