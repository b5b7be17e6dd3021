#!/usr/bin/env python3
"""Where a fused min-plus visit's time goes on the card, phase by phase.

    python3 scripts/fused_visit_phases.py       # on a machine with a card
    python3 scripts/fused_visit_phases.py --thread-copies

Builds an instrumented copy of ``src/repro_torch/kernels/csrc/
fused_visit.cu`` into ``build/fused_visit_phases/``: thread 0 of the
cluster's first CTA reads ``clock64()`` at each phase boundary of the
min-plus kernel and sums the cycles per phase.  Then, on the smoke's main
path (``grid2d(192, 192)``, Q = 64, B = 128, sssp), it takes one K=64
fused chunk to a mid-run state and runs the next chunk as one launch at
each cluster size, printing card microseconds per visit (CUDA events) and
cycles per visit for each phase.  The marks cost a few hundred cycles a
visit; the kernel the port ships carries none of them.
``--thread-copies`` also makes the copy moves the threads' own loads and
stores instead of bulk copies (the kernel's path for rows that are not
16-byte aligned), to compare the two.

Phases (thread 0's view, so each includes waiting for the rest of the
cluster at its barriers): select, own rows in, each relax round's active
pass and exit test, each round's contraction, the emission payload, the
neighbour items (issue, wait for the copy, combine, store and reduce), the
rest of the emission, the write-back, the metadata exchange, the stats.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

PHASES = ("select", "own rows in", "active pass + exit test",
          "relax contraction", "payload", "emission, other", "write-back",
          "exchange", "stats", "item issue", "item wait", "item combine",
          "item store + reduce")

_MARKS = '''
static __shared__ long long s_t0;
static __shared__ unsigned long long s_ph[16];
__device__ unsigned long long g_ph[16];
#define PH(i) do { if (threadIdx.x == 0 && c.rank == 0) { \\
  const long long t_ = clock64(); s_ph[i] += t_ - s_t0; s_t0 = t_; } } while (0)
'''

# (anchor in the min-plus kernel or emit, instrumented replacement)
_EDITS = (
    ("namespace {\n\nconstexpr int kThreads",
     _MARKS + "namespace {\n\nconstexpr int kThreads"),
    ("    const int p = select_partition<kPolicy>(a, REDF, REDI, c);\n"
     "    if (p < 0) break;",
     "    const int p = select_partition<kPolicy>(a, REDF, REDI, c);\n"
     "    PH(0);\n    if (p < 0) break;"),
    ("    wait_own(c, MBAR);\n", "    wait_own(c, MBAR);\n    PH(1);\n"),
    ("      if (!__syncthreads_or(any)) break;",
     "      const bool go = __syncthreads_or(any);\n      PH(2);\n"
     "      if (!go) break;"),
    ("      __syncthreads();\n      ++rounds;\n    }\n",
     "      __syncthreads();\n      PH(3);\n      ++rounds;\n    }\n"),
    ("    emit<false, kSparse, C>(", "    PH(4);\n    emit<false, kSparse, C>("),
    ("    float best = INFINITY;\n    int n = 0;\n"
     "    for (int i = c.tid; i < nrb; i += kThreads) {\n"
     "      const float d = D[i];",
     "    PH(5);\n    float best = INFINITY;\n    int n = 0;\n"
     "    for (int i = c.tid; i < nrb; i += kThreads) {\n"
     "      const float d = D[i];"),
    ("    flush<C, false>(a, si, L, c, cnt);\n",
     "    PH(6);\n    flush<C, false>(a, si, L, c, cnt);\n    PH(7);\n"),
    ("    update_stats(a, c, p, k, si[L.misc], EQ, ELO, EHI);\n  }\n"
     "  edge_counters(a, c, ELO, EHI, false);\n  finish<C>(c);\n}\n\n"
     "template <int kPolicy, int C>",
     "    update_stats(a, c, p, k, si[L.misc], EQ, ELO, EHI);\n    PH(8);\n"
     "  }\n  if (threadIdx.x == 0 && c.rank == 0)\n"
     "    for (int i = 0; i < 16; ++i) atomicAdd(&g_ph[i], s_ph[i]);\n"
     "  edge_counters(a, c, ELO, EHI, false);\n  finish<C>(c);\n}\n\n"
     "template <int kPolicy, int C>"),
    ("      wait_item(c, mbar, st);\n",
     "      PH(9);\n      wait_item(c, mbar, st);\n      PH(10);\n"),
    ("    if (slot_end) pair_post<kPushAlg>(c, pair, best, n);",
     "    PH(11);\n    if (slot_end) pair_post<kPushAlg>(c, pair, best, n);"),
    ("      pair_read<kPushAlg>(c, pair, best, n);\n",
     "      PH(12);\n      pair_read<kPushAlg>(c, pair, best, n);\n"),
    ("  Cta c = make_cta<C>(a, L, MBAR);\n"
     "  edge_counters(a, c, ELO, EHI, true);\n"
     "  for (int q = c.nr",
     "  Cta c = make_cta<C>(a, L, MBAR);\n"
     "  if (threadIdx.x == 0) {\n"
     "    for (int i = 0; i < 16; ++i) s_ph[i] = 0;\n"
     "    s_t0 = clock64();\n  }\n"
     "  edge_counters(a, c, ELO, EHI, true);\n"
     "  for (int q = c.nr"),
)

_READ = '''
extern "C" int fg_phase_cycles(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_ph, sizeof(g_ph));
  if (e != cudaSuccess) return (int)e;
  unsigned long long z[16] = {};
  return (int)cudaMemcpyToSymbol(g_ph, z, sizeof(z));
}
'''


_THREAD_COPIES = ("  args.bulk = (a->B % 4 == 0", "  args.bulk = 0 && (a->B % 4 == 0")


def build(thread_copies: bool):
    """The instrumented library, loaded; raises if an anchor is missing."""
    from repro_torch.kernels import _build
    src = (_build.CSRC / "fused_visit.cu").read_text()
    for old, new in _EDITS + ((_THREAD_COPIES,) if thread_copies else ()):
        if src.count(old) < 1:
            raise RuntimeError(f"anchor not found in fused_visit.cu:\n{old}")
        src = src.replace(old, new, 1)
    out = os.path.join(ROOT, "build", "fused_visit_phases")
    os.makedirs(out, exist_ok=True)
    for hdr in _build.CSRC.glob("*.cuh"):
        shutil.copy(hdr, out)
    cu, lib = os.path.join(out, "fused_visit.cu"), os.path.join(out, "lib.so")
    with open(cu, "w") as f:
        f.write(src + _READ)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib, cu],
                   check=True, capture_output=True)
    return ctypes.CDLL(lib)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("fused_visit_phases: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core.engine import FPPEngine
    from repro_torch.core.visit import VisitState
    from repro_torch.fpp import FPPSession, planner
    from repro_torch.graphs.generators import grid2d
    from repro_torch.kernels.fused_visit import ops

    thread_copies = "--thread-copies" in sys.argv[1:]
    lib = build(thread_copies)
    i, p = ctypes.c_int, ctypes.c_void_p
    lib.fg_fused_visit.argtypes = [ctypes.POINTER(ops._Args), i, i, i, i, p]
    lib.fg_fused_visit.restype = i
    lib.fg_fused_visit_smem.argtypes = [i, i, i, i]
    lib.fg_fused_visit_smem.restype = ctypes.c_longlong
    lib.fg_phase_cycles.argtypes = [p]
    lib.fg_phase_cycles.restype = i
    ops._fns.update(launch=lib.fg_fused_visit, smem=lib.fg_fused_visit_smem)

    g = grid2d(192, 192, seed=0)
    Q, K = 64, 64
    bg, perm = FPPSession(g, device="cuda").plan(num_queries=Q).prepared()
    srcs = np.random.default_rng(0).choice(g.n, Q, replace=False)
    eng = FPPEngine(bg, num_queries=Q, fused=True, device="cuda",
                    yield_config=planner.default_yield_config("sssp", bg))
    state, _ = eng._megastep(eng.init_state(perm[srcs]), 0, K)
    fv = ops.make_fused_visit(eng.dg, eng.algebra, eng.max_rounds, K=K)
    cycles = np.zeros(16, dtype=np.uint64)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    print("copies:", "the threads' own" if thread_copies else "bulk")
    for c in reversed(ops.CLUSTER_SIZES):
        st = VisitState(tuple(x.clone() for x in state.planes),
                        state.buf.clone(), state.prio.clone(),
                        state.ops_count.clone(), state.stamp.clone())
        stats = fv.new_stats(st)
        fv.launch(st, stats, K, 0, c)            # loads the kernel, no visit
        torch.cuda.synchronize()
        lib.fg_phase_cycles(cycles.ctypes.data)            # reset
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fv.launch(st, stats, K, K, c)
        b.record()
        b.synchronize()
        if lib.fg_phase_cycles(cycles.ctypes.data) != 0:
            raise RuntimeError("reading the phase counters failed")
        v = int(stats[0])
        per = cycles[:len(PHASES)].astype(np.float64) / v
        print(f"cluster {c}: {1e3 * a.elapsed_time(b) / v:.2f} us per visit "
              f"(instrumented), {int(stats[1]) / v:.2f} rounds per visit, "
              f"{per.sum():.0f} cycles per visit:")
        for name, x in zip(PHASES, per):
            print(f"  {name:26s} {x:8.0f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
