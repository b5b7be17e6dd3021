"""The canonical inventory of the port's hot graph programs, which the
``dispatch`` and ``ops`` passes run.

One small graph (``grid2d(16, 16, seed=0)``, the tier-1 workhorse), one
query batch (Q = 8, sources ``arange(8)``), K = 8 visits a chunk, walks of
16 steps, the planner's block size for it (B = 64, P = 4), the key
``PRNGKey(0)``: the reference's canonical inputs.  The keys are the
reference's 41 (``repro/analysis/programs.py``), {backend} × the six kinds:

  engine/<kind>        ``FPPEngine._megastep``: one K-visit chunk, unfused
                       (for rw the buffered walk visit,
                       ``randomwalk.make_walk_visit``)
  engine-fused/<kind>  the same with ``fused=True``: one launch of the
                       fused visit a chunk (five kinds; rw has no fused
                       visit)
  streaming/<kind>     a ``StreamingExecutor``'s pump megastep
                       (``harvest_mask=True``) over 8 admitted queries; rw
                       the ``WalkExecutor``'s visit
  engine-serve/<kind>  the serving pools' bundle
                       (``serve/compile_cache.build_warm_megastep`` at
                       ``pow2_bucket(Q)``, the visit body ``auto_fused``
                       picks: unfused for every kind until dispatch
                       yardsticks are committed)
  distributed/<kind>@d{world}
                       one superstep and its stop test
                       (``core/distributed.superstep_and_test``, what the
                       run's loop calls) on this rank of the default mesh;
                       rw one step of this rank's walkers
  baselines/<kind>     one synchronous round (``make_minplus_round``,
                       ``make_push_round``, ``make_walk_round``)

A :class:`Program` is run, not traced: each runs once on its canonical
input, which is deterministic, so every count is exact.  Besides ``fn`` and
``args`` (built on the pass's device) it carries what it declares about
itself: ``declared_reads`` (what the program reports: a chunk's
``device_syncs``, a visit's ``syncs``, 0 for a round), its exact-edge
``counters``, the ``state`` it holds (planes, buffers, metadata), the
tensors it must update ``in_place``, and ``allow64``, int64 state with a
standing reason.  Each accessor takes ``(args, out)``; ``out`` is None
before the run.

:func:`evaluate` runs the inventory under the op census and returns each
program's hygiene findings and budget row; on the CPU the ``@d4`` programs
run in a spawned world of four gloo ranks (ranks sharing one card would
measure nothing a card's rank does, so the card has no ``@d4`` rows).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, List, Optional

import numpy as np

CANONICAL_ROWS = 16
CANONICAL_COLS = 16
CANONICAL_SEED = 0
CANONICAL_Q = 8
CANONICAL_K = 8
CANONICAL_WALK_LEN = 16
#: ranks of the spawned world whose programs are keyed ``@d4``
WORLD = 4

BACKENDS = ("engine", "engine-fused", "streaming", "engine-serve",
            "distributed", "baselines")
KINDS = ("sssp", "bfs", "ppr", "cc", "kreach", "rw")

#: the walk's trajectory hash: uint32 values in an int64 tensor
THASH_REASON = ("the reference's uint32 trajectory hash, held as int64 "
                "masked to 32 bits (torch's uint32 arithmetic is partial)")


def _none(args, out):
    return {}


@dataclasses.dataclass
class Program:
    key: str                  # "engine/sssp", "distributed/bfs@d1", ...
    backend: str
    kind: str
    fn: Callable
    args: tuple
    declared_reads: Callable = lambda args, out: 0
    counters: Callable = _none      # (args, out) -> {name: exact counter}
    state: Callable = _none         # (args, out) -> {name: state tensor}
    in_place: Callable = _none      # (args, out) -> {name: tensor}
    allow64: Dict[str, str] = dataclasses.field(default_factory=dict)
    fused: bool = False             # one launch and one read a chunk
    mesh: object = None             # whose collectives the row counts


def all_keys(world: int = 1) -> List[str]:
    """The inventory's keys on a mesh of ``world`` ranks."""
    keys = []
    for kind in KINDS:
        for backend in BACKENDS:
            if backend == "engine-fused" and kind == "rw":
                continue
            suffix = f"@d{world}" if backend == "distributed" else ""
            keys.append(f"{backend}/{kind}{suffix}")
    return keys


# ---------------------------------------------------------------------------
# accessors


def _visit_state(st) -> dict:
    out = {f"plane{i}": x for i, x in enumerate(st.planes)}
    out.update(buf=st.buf, prio=st.prio, ops_count=st.ops_count,
               stamp=st.stamp)
    return out


def _chunk_state(args, out):
    return _visit_state(args[0] if out is None else out[0])


def _chunk_counters(args, out):
    ms = out[1]
    return {"eq_hi": ms.eq_hi, "eq_lo": ms.eq_lo,
            "visit_counts": ms.visit_counts, "order": ms.order}


def _chunk_reads(args, out):
    return out[1].device_syncs


def _chunk_program(key, backend, kind, fn, args, fused):
    return Program(key=key, backend=backend, kind=kind, fn=fn, args=args,
                   declared_reads=_chunk_reads, counters=_chunk_counters,
                   state=_chunk_state, in_place=_chunk_state, fused=fused)


def _walk_program(key, backend, fn, args, reads=None):
    """A walk step or visit over ``(pos, steps, part, src, thash, occ,
    ...)``: ``occ`` updated in place, ``steps`` the counter; ``pos``,
    ``part`` and ``src`` are indices."""
    return Program(
        key=key, backend=backend, kind="rw", fn=fn, args=args,
        declared_reads=reads or (lambda args, out: 0),
        counters=lambda args, out: {"steps": out[1]},
        state=lambda args, out: {"occ": args[5], "thash": (
            args[4] if out is None else out[3])},
        in_place=lambda args, out: {"occ": args[5]},
        allow64={"thash": THASH_REASON})


# ---------------------------------------------------------------------------
# the inventory


def build_programs(only: Optional[str] = None, device="cuda",
                   backends=BACKENDS) -> List[Program]:
    """The inventory on ``device`` (on the default mesh for the
    distributed programs); ``only`` substring-filters the keys and
    ``backends`` the backends, before anything is built."""
    import torch

    from repro_torch.core import baselines as _bl
    from repro_torch.core import distributed as _dist
    from repro_torch.core import prng
    from repro_torch.core import visit as _visit
    from repro_torch.core.engine import FPPEngine, resolve_device
    from repro_torch.core.queries import WEIGHT_VARIANTS
    from repro_torch.core.randomwalk import (WalkGraph, init_walk_state,
                                             make_walk_visit)
    from repro_torch.fpp.backends import _ENGINE_MODE, default_mesh
    from repro_torch.fpp.planner import (auto_fused, default_yield_config,
                                         pow2_bucket)
    from repro_torch.fpp.session import FPPSession
    from repro_torch.fpp.streaming import StreamingExecutor, WalkExecutor
    from repro_torch.graphs.generators import grid2d
    from repro_torch.serve.compile_cache import build_warm_megastep

    dev = resolve_device(device)
    Q, K, L = CANONICAL_Q, CANONICAL_K, CANONICAL_WALK_LEN
    mesh = default_mesh()
    world = int(mesh.shape["model"])
    want = [k for k in all_keys(world) if k.split("/")[0] in backends
            and (not only or only in k)]
    if not want:
        return []
    g = grid2d(CANONICAL_ROWS, CANONICAL_COLS, seed=CANONICAL_SEED)
    sess = FPPSession(g, device=dev).plan(num_queries=Q)
    srcs = np.arange(Q, dtype=np.int64)

    def key0():
        return prng.PRNGKey(0, dev)

    def engine(kind, fused=False):
        bg, _ = sess.prepared(weights=WEIGHT_VARIANTS.get(kind, "natural"))
        eng = FPPEngine(bg, mode=_ENGINE_MODE[kind], num_queries=Q,
                        yield_config=default_yield_config(kind, bg),
                        k_visits=K, fused=fused, device=dev)
        return eng, (eng.init_state(srcs), 0, K, key0())

    def pool(ex):
        ex.submit(np.arange(Q))         # original ids, as a pool admits
        return (ex.state, 0, K, ex._key)

    def walk_args(wg, n, capacity):
        return init_walk_state(wg, np.arange(capacity, dtype=np.int64) % n)

    def build(key):
        backend, rest = key.split("/")
        kind = rest.split("@")[0]
        bg, _ = sess.prepared(weights=WEIGHT_VARIANTS.get(kind, "natural"))
        if kind == "rw":
            if backend in ("engine", "streaming", "engine-serve"):
                cap = pow2_bucket(Q) if backend == "engine-serve" else Q
                if backend == "engine":
                    wg = WalkGraph.build(bg, dev)
                    visit = make_walk_visit(wg, L, CANONICAL_SEED)
                elif backend == "streaming":
                    ex = WalkExecutor(sess, capacity=cap, length=L,
                                      seed=CANONICAL_SEED)
                    wg, visit = ex.wg, ex._visit
                else:
                    wg, visit = build_warm_megastep(
                        sess, "rw", cap, length=L, walk_seed=CANONICAL_SEED)
                return _walk_program(key, backend, visit,
                                     walk_args(wg, bg.n, cap) + (0,),
                                     reads=lambda args, out: out[5])
            if backend == "distributed":
                step, st = _dist.stage_walkers(
                    bg, srcs % bg.n, mesh, L, CANONICAL_SEED,
                    mesh.axis_names, dev)

                def walk_step(pos, steps, part, src, thash, occ):
                    return step(pos, steps, part, src, thash, occ,
                                steps < L)
                prog = _walk_program(key, backend, walk_step, st)
                prog.mesh = mesh
                return prog
            wg = WalkGraph.build(bg, dev)
            return _walk_program(key, backend,
                                 _bl.make_walk_round(wg, L, CANONICAL_SEED),
                                 walk_args(wg, bg.n, Q))
        if backend in ("engine", "engine-fused"):
            eng, args = engine(kind, fused=backend == "engine-fused")
            return _chunk_program(key, "engine", kind, eng._megastep, args,
                                  eng.fused)
        if backend == "streaming":
            ex = StreamingExecutor(sess, kind, capacity=Q, k_visits=K)
            return _chunk_program(key, backend, kind, ex._megastep,
                                  pool(ex), False)
        if backend == "engine-serve":
            cap = pow2_bucket(Q)
            fused = auto_fused(kind, K, dmax=bg.nbr_part.shape[1])
            bundle = build_warm_megastep(sess, kind, cap, k_visits=K,
                                         fused=fused)
            ex = StreamingExecutor(sess, kind, capacity=cap, k_visits=K,
                                   fused=fused, megastep=bundle)
            return _chunk_program(key, "engine", kind, bundle.megastep,
                                  pool(ex), fused)
        yc = default_yield_config(kind, bg)
        if backend == "distributed":
            if kind == "ppr":
                alg, rounds = _visit.push_algebra(0.15, 1e-4), 64
            else:
                alg = _visit.minplus_algebra(yc.window(),
                                             strict=kind == "cc")
                rounds = bg.block_size
            cc = kind == "cc"
            st = _dist.stage_rank(
                alg, bg, np.empty(0, np.int64) if cc else srcs, mesh, yc,
                ("data",), "model", num_queries=Q,
                init_ops=_visit.cc_label_plane(bg) if cc else None,
                device=dev)
            fn = functools.partial(_dist.superstep_and_test, algebra=alg,
                                   max_rounds=yc.max_rounds or rounds,
                                   mesh=mesh, part_axis="model")

            def rank_state(args, out):
                s = args[0]
                return {**{f"plane{i}": x for i, x in enumerate(s.planes)},
                        "buf": s.buf, "eq_hi": s.ehi, "eq_lo": s.elo}
            return Program(
                key=key, backend=backend, kind=kind, fn=fn, args=(st,),
                declared_reads=lambda args, out: out[2],
                counters=lambda args, out: {
                    "eq": out[0], "eq_hi": args[0].ehi, "eq_lo": args[0].elo},
                state=rank_state, in_place=rank_state, mesh=mesh)
        # baselines: one round, functional (it returns fresh planes, as the
        # reference's round without donation), so nothing is in place
        dg, idx, blk_src, blk_dst = _bl._graph(bg, Q, dev)
        if kind == "cc":
            P, B = dg.num_parts, dg.block_size
            dist = torch.from_numpy(_visit.cc_label_plane(bg)).to(dev)[
                :, None, :].expand(P, Q, B).contiguous()
        else:
            dist = _bl._block_state(dg, srcs)
        if kind == "ppr":
            r = torch.where(torch.isfinite(dist), 1.0, 0.0)
            return Program(
                key=key, backend=backend, kind=kind,
                fn=_bl.make_push_round(dg, idx, blk_src, blk_dst,
                                       alpha=0.15),
                args=(torch.zeros_like(r), r,
                      _bl.push_active(dg, r, 1e-4)),
                counters=lambda args, out: {"eq": out[2]},
                state=lambda args, out: {} if out is None else {
                    "p": out[0], "r": out[1]})
        return Program(
            key=key, backend=backend, kind=kind,
            fn=_bl.make_minplus_round(dg, idx, blk_src, blk_dst),
            args=(dist, torch.isfinite(dist)),
            counters=lambda args, out: {"eq": out[2]},
            state=lambda args, out: {} if out is None else {
                "dist": out[0]})

    return [build(k) for k in want]


# ---------------------------------------------------------------------------
# running the inventory


@dataclasses.dataclass
class Evaluated:
    """One program's run: its hygiene findings and its budget row."""
    key: str
    findings: list
    row: Dict[str, int]


def evaluate_program(program: Program, device) -> Evaluated:
    """Run ``program`` once under the census; check and measure it."""
    from repro_torch.analysis import dispatch_passes, ops_passes

    m = dispatch_passes.run(program, device)
    return Evaluated(program.key, dispatch_passes.check_run(program, m),
                     ops_passes.row_of(m))


def evaluate_local(device, only: Optional[str] = None,
                   backends=BACKENDS) -> List[Evaluated]:
    """This process's programs (``@d1`` for the distributed ones)."""
    return [evaluate_program(p, device)
            for p in build_programs(only, device, backends)]


def _world_rank(rank: int, only: Optional[str]):
    """One rank of the world: its distributed programs, evaluated."""
    return [dataclasses.asdict(e)
            for e in evaluate_local("cpu", only, backends=("distributed",))]


def evaluate_world(only: Optional[str] = None,
                   world: int = WORLD) -> List[Evaluated]:
    """The distributed programs on ``world`` CPU gloo ranks: a finding of
    any rank (its location names the rank), and each metric's most over
    the ranks."""
    from repro_torch.analysis import Finding
    from repro_torch.launch.mesh import spawn

    if only and not any(only in k for k in all_keys(world)
                        if k.startswith("distributed/")):
        return []
    ranks = spawn(_world_rank, world, "gloo", args=(only,), timeout_s=120.0)
    out = []
    for i, e in enumerate(ranks[0]):
        row: Dict[str, int] = {}
        findings = []
        for r, rank in enumerate(ranks):
            mine = rank[i]
            for metric, v in mine["row"].items():
                row[metric] = max(row.get(metric, v), v)
            for f in mine["findings"]:
                if f["severity"] in ("error", "warning"):
                    f = dict(f, location=f"{f['location']} (rank {r})")
                findings.append(Finding(**f))
        seen = set()
        unique = [f for f in findings
                  if not (f in seen or seen.add(f))]
        out.append(Evaluated(e["key"], unique, row))
    return out


def evaluate(ctx) -> List[Evaluated]:
    """The inventory for ``ctx`` (cached on it): this process's programs
    and, on the CPU, the world's."""
    key = ("evaluated", ctx.device, ctx.only_programs)
    if key not in ctx.cache:
        out = evaluate_local(ctx.device, ctx.only_programs)
        if ctx.device == "cpu":
            out += evaluate_world(ctx.only_programs)
        ctx.cache[key] = out
    return ctx.cache[key]
