#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each of which fails the run on any error:

  1. build    compile every CUDA source of ``src/repro_torch/kernels/csrc``
  2. card     print the card's name and power limit (nvidia-smi)
  3. kernels  each kernel against its plain PyTorch version on the card, at
              the main path's shapes (Q=64, B=128; single and batched),
              with its time, the plain version's, a library call's where
              one exists, and the bound
  4. parity   the engine on the card against the engine on the CPU
              (grid2d(32, 32), B=32, Q=16): sssp and bfs bitwise in values,
              edges, stats and visit order; ppr at the masked-matmul
              tolerance
  5. path     ``FPPSession(grid2d(SIDE, SIDE), device="cuda")
              .plan(num_queries=64)`` runs sssp, bfs and ppr on 64 seeded
              sources; sssp/bfs are checked against scipy's Dijkstra, ppr
              against mass conservation and the residual bound; each kind
              must launch its kernel; then one K=64 chunk per algebra is
              timed and traced for the card's busy share
  6. report   the kernel table as one JSON line, then the result line

It imports nothing of JAX or of the JAX package, and exits non-zero with no
result line when there is no CUDA device or the port is not beside it.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

#: H100 SXM peaks (NVIDIA's data sheet, at a 700 W limit): HBM3 rate and
#: FP32 rate outside the tensor cores, for the bound of each kernel.  The
#: FP32 rate counts an FMA as two operations, so one FP32 instruction of
#: any kind issues at most at half of it
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
PEAK_F32_INSTR_PER_S = PEAK_F32_OPS_PER_S / 2

#: grid side of the main path's graph (a cut of the paper's road graphs,
#: see PERF.md section 4)
SIDE = 192

#: ppr's eps on every path of this script
PPR_EPS = 1e-4
#: masked-matmul tolerance against float32 matmul: sums reassociate.  The
#: card-vs-CPU ppr comparison uses it too: both sides run the port's code,
#: and only the spread's summation order differs between them
MM_RTOL, MM_ATOL = 1e-5, 2e-6


def log(msg: str) -> None:
    print(msg, flush=True)


def eager_ms(torch, fn, iters: int = 200, warmup: int = 10) -> float:
    """Mean milliseconds per call of ``fn`` issued eagerly from Python
    (CUDA events around ``iters`` back-to-back calls): on these tiny
    shapes this is the host's enqueue rate, not the card's."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def device_ms(torch, fn, iters: int = 200) -> float:
    """Mean milliseconds per call of ``fn`` on the card: ``iters`` calls
    captured in one CUDA graph, replayed between CUDA events, so the host
    does not pace the launches (inputs stay L2-warm, as the visit's
    relax rounds find them)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    graph.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def phase_kernels(torch, ops, rng) -> dict:
    """Phase 3: both kernels against their plain versions at Q=64, B=128."""
    Q, B, nblk = 64, 128, 16
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    # road-like +inf density: ~4 finite entries per block row, a sparse
    # frontier of finite distances
    w = np.where(rng.random((nblk, B, B)) < 4.0 / B,
                 rng.uniform(1.0, 11.0, (nblk, B, B)), np.inf)
    d = np.where(rng.random((Q, B)) < 0.3, rng.uniform(0.0, 50.0, (Q, B)),
                 np.inf)
    x = np.where(rng.random((Q, B)) < 0.3, rng.uniform(0.0, 1e-2, (Q, B)),
                 0.0)
    blocks = torch.tensor(w, dtype=torch.float32, device=dev)
    dt = torch.tensor(d, dtype=torch.float32, device=dev)
    xt = torch.tensor(x, dtype=torch.float32, device=dev)
    single = torch.tensor([3], dtype=torch.int64, device=dev)
    batched = torch.tensor([2, 5, 11, 7, -1], dtype=torch.int64, device=dev)

    rows = {}
    for name, inp, fn in (("minplus", dt, ops.minplus),
                          ("masked_matmul", xt, ops.masked_matmul)):
        row = {}
        for form, idx in (("single", single), ("batched", batched)):
            got = fn(inp, blocks, idx)
            want = ops.plain(name, inp, blocks, idx)
            torch.cuda.synchronize()
            if name == "minplus":
                if not torch.equal(got, want):
                    raise AssertionError(f"minplus {form} is not bitwise "
                                         f"equal to its plain version")
                err = 0.0
            else:
                torch.testing.assert_close(got, want, rtol=MM_RTOL,
                                           atol=MM_ATOL)
                err = float((got - want).abs().max())
            S = idx.shape[0]
            real = idx[idx >= 0]
            wf = torch.isfinite(blocks.index_select(0, real)).float()
            # instructions these inputs need, per (q, u, v) with a finite
            # w[u, v] and a live x[q, u]: min-plus issues an add and a min
            # (two instructions; min is taken at the add's issue rate,
            # which it does not exceed), the masked matmul one FMA
            lhs = (torch.isfinite(inp) if name == "minplus"
                   else inp != 0).float()
            pairs = float((lhs @ wf).sum())
            ninstr = pairs * (2.0 if name == "minplus" else 1.0)
            nbytes = 4.0 * (Q * B + real.numel() * B * B + S * Q * B) + 8 * S
            t_bytes = nbytes / PEAK_BYTES_PER_S
            t_ops = ninstr / PEAK_F32_INSTR_PER_S
            bound_ms = 1e3 * max(t_bytes, t_ops)
            t = {
                "max_abs_err": err,
                "ms": device_ms(torch, lambda: fn(inp, blocks, idx)),
                "plain_ms": device_ms(
                    torch, lambda: ops.plain(name, inp, blocks, idx)),
                "eager_ms": eager_ms(torch, lambda: fn(inp, blocks, idx)),
                "bound_ms": bound_ms,
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": None,
            }
            if name == "masked_matmul":
                wv = blocks.index_select(0, real)
                t["library_ms"] = device_ms(
                    torch, lambda: inp @ torch.isfinite(wv).float())
            log(f"kernel {name} {form} S={S}: " + json.dumps(t))
            row[form] = t
        rows[name] = row
    return rows


def phase_parity() -> None:
    """Phase 4: the engine on the card against the engine on the CPU."""
    from repro_torch.core.engine import FPPEngine
    from repro_torch.core.queries import WEIGHT_VARIANTS
    from repro_torch.fpp import FPPSession, planner
    from repro_torch.graphs.generators import grid2d

    g = grid2d(32, 32, seed=1)
    Q = 16
    srcs = np.random.default_rng(2).choice(g.n, Q, replace=False)
    sess = FPPSession(g, device="cpu").plan(num_queries=Q, block_size=32)
    for kind, mode in (("sssp", "minplus"), ("bfs", "minplus"),
                       ("ppr", "push")):
        bg, perm = sess.prepared(weights=WEIGHT_VARIANTS.get(kind,
                                                             "natural"))
        yc = planner.default_yield_config(kind, bg)
        res = {}
        for dev in ("cuda", "cpu"):
            eng = FPPEngine(bg, mode=mode, num_queries=Q, yield_config=yc,
                            eps=PPR_EPS, device=dev)
            res[dev] = eng.run(perm[srcs], record_order=True)
        a, b = res["cuda"], res["cpu"]
        if kind == "ppr":
            np.testing.assert_allclose(a.values, b.values, rtol=MM_RTOL,
                                       atol=MM_ATOL, err_msg="ppr values")
            np.testing.assert_allclose(a.residual, b.residual, rtol=MM_RTOL,
                                       atol=MM_ATOL, err_msg="ppr residual")
            log(f"parity ppr: max diff "
                f"{np.abs(a.values - b.values).max():.3e} (rtol {MM_RTOL}, "
                f"atol {MM_ATOL}), visits {a.stats.visits} vs "
                f"{b.stats.visits}")
            continue
        same = (np.array_equal(a.values, b.values)
                and np.array_equal(a.edges_processed, b.edges_processed)
                and a.stats == b.stats and a.visit_order == b.visit_order)
        if not same:
            raise AssertionError(f"{kind}: card run differs from CPU run "
                                 f"({a.stats} vs {b.stats})")
        log(f"parity {kind}: bitwise equal, {a.stats}")


def phase_path(torch, ops) -> dict:
    """Phase 5: the main path at 64 queries."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import dijkstra

    from repro_torch.fpp import FPPSession
    from repro_torch.graphs.generators import grid2d

    g = grid2d(SIDE, SIDE, seed=0)
    Q = 64
    t0 = time.perf_counter()
    sess = FPPSession(g, device="cuda").plan(num_queries=Q)
    srcs = np.random.default_rng(0).choice(g.n, Q, replace=False)
    plan = sess.current_plan
    csr = sp.csr_matrix((g.weights.astype(np.float64), g.indices, g.indptr),
                        shape=(g.n, g.n))
    deg = np.maximum(g.out_degree(), 1)
    launches = {}
    for kind in ("sssp", "bfs", "ppr"):
        bg, _ = sess.prepared(weights={"bfs": "unit"}.get(kind, "natural"))
        ops.reset_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = sess.run(kind, srcs, eps=PPR_EPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts = dict(ops.LAUNCHES)
        if kind == "ppr":
            mass = res.values.sum(1) + res.residual.sum(1)
            if np.abs(mass - 1.0).max() > 1e-3:
                raise AssertionError(f"ppr mass {mass}")
            if not (res.residual <= PPR_EPS * deg + 1e-6).all():
                raise AssertionError("ppr residual above eps*deg")
            need = "masked_matmul"
        else:
            want = dijkstra(csr, indices=srcs, unweighted=(kind == "bfs"))
            got = res.values.astype(np.float64)
            if kind == "bfs":
                ok = np.array_equal(got, want)
            else:
                ok = (np.array_equal(np.isinf(got), np.isinf(want))
                      and np.allclose(got[np.isfinite(want)],
                                      want[np.isfinite(want)], rtol=1e-5))
            if not (ok and np.isfinite(got).all()):
                raise AssertionError(f"{kind} disagrees with dijkstra")
            need = "minplus"
        if counts[need] <= 0:
            raise AssertionError(f"{kind} launched no {need} kernel")
        for name, c in counts.items():
            launches[name] = launches.get(name, 0) + c
        st = res.stats
        log(f"path {kind}: " + json.dumps({
            "n": g.n, "m": g.m, "P": bg.num_parts, "B": bg.block_size,
            "Q": Q, "dmax": int(bg.nbr_blk.shape[1]),
            "visits": st["visits"], "rounds": st["rounds"],
            "host_syncs": st["host_syncs"],
            "device_syncs": st["device_syncs"], "wall_s": wall,
            "visits_per_s": st["visits"] / wall, "launches": counts}))
    log(f"path setup+runs: {time.perf_counter() - t0:.1f} s, plan B="
        f"{plan.block_size}, method={plan.method}")
    bg, perm = sess.prepared()
    phase_profile(torch, bg, perm[srcs])
    return launches


def phase_profile(torch, bg, srcs) -> None:
    """Phase 5b: where a visit's time goes, over one steady K=64 chunk of
    the main path per algebra.  The chunk is timed on the host clock
    without the profiler, then a following chunk is traced with
    ``torch.profiler`` for the card's kernel time; the ratio is the card's
    busy share."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.engine import FPPEngine
    from repro_torch.core.visit import make_megastep
    from repro_torch.fpp import planner

    for kind, mode in (("sssp", "minplus"), ("ppr", "push")):
        eng = FPPEngine(bg, mode=mode, num_queries=64, eps=PPR_EPS,
                        yield_config=planner.default_yield_config(kind, bg),
                        device="cuda")
        mega = make_megastep(eng.dg, eng.algebra, eng.max_rounds, K=64)
        state, _ = mega(eng.init_state(srcs), 0, 64)          # warm-up
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, timed = mega(state, 64, 64)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            state, traced = mega(state, 128, 64)
            torch.cuda.synchronize()
        rows = sorted(((getattr(e, "self_device_time_total", None)
                        or getattr(e, "self_cuda_time_total", 0.0), e.key,
                        e.count) for e in prof.key_averages()), reverse=True)
        dev_ms = sum(r[0] for r in rows) / 1e3
        per_visit_wall = wall_ms / max(timed.visits, 1)
        per_visit_dev = dev_ms / max(traced.visits, 1)
        log(f"profile {kind}: " + json.dumps({
            "visits": [timed.visits, traced.visits],
            "rounds": [timed.rounds, traced.rounds],
            "device_syncs": [timed.device_syncs, traced.device_syncs],
            "wall_ms_per_visit": per_visit_wall,
            "device_ms_per_visit": per_visit_dev if dev_ms else None,
            "device_busy_share": (per_visit_dev / per_visit_wall
                                  if dev_ms else None),
            "top_kernels_us": [[k[:60], round(us, 1), n]
                               for us, k, n in rows[:6]]}))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch
    if not os.path.abspath(repro_torch.__file__).startswith(ROOT):
        print("chip_smoke: repro_torch is not beside this script",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels.minplus import ops
    t_start = time.perf_counter()

    t = time.perf_counter()
    built = _build.build_all()
    log(f"build: {time.perf_counter() - t:.1f} s " + json.dumps(
        {k: round(v["seconds"], 2) for k, v in built.items()}))
    for name, info in built.items():
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)}")

    rng = np.random.default_rng(0)
    krows = phase_kernels(torch, ops, rng)
    t = time.perf_counter()
    phase_parity()
    log(f"parity: {time.perf_counter() - t:.1f} s")
    launches = phase_path(torch, ops)

    replaces = {
        "minplus": "src/repro/kernels/minplus/minplus.py:105",
        "masked_matmul": "src/repro/kernels/minplus/minplus.py:135",
    }
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    table = [{"name": name, "route": "cuda",
              "source": "src/repro_torch/kernels/csrc/minplus.cu",
              "replaces": replaces[name], "launches": launches[name],
              **{k: krows[name]["single"][k] for k in keys}}
             for name in ("minplus", "masked_matmul")]
    log(json.dumps({"kernels": table}))
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
