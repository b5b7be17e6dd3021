// Hopper (sm_90a) kernel for the Δ-window frontier selection of a visit.
//
//   fg_frontier  buf, dist [Q, B] -> d1 [Q, B], srcs [Q, B], prio_rows [Q]
//                the consolidation that starts a min-plus visit: buffered
//                ops folded into the distances, the active sources under
//                the Δ-window, and each query row's best pending value.
//                Replaces the TPU kernel frontier_pallas_call
//                (src/repro/kernels/frontier/frontier.py, body
//                _frontier_kernel, tile frontier_tile) and the +inf Q
//                padding of its ops wrapper.
//
// The tile itself is fg::frontier_row (visit_tiles.cuh), which the fused
// visit kernel (fused_visit.cu) runs for its own consolidation; on the
// engine's path this entry is not launched, its tile runs inside
// fg_fused_visit.
//
// Layout: one warp per query row, 8 rows per block; each lane walks the
// row's columns with stride 32, so every read and write is coalesced, and
// the row minimum is a warp shuffle reduction.  Ragged Q and B are masked.
//
// Numerics: min and compare are exact, and alpha + delta is one IEEE f32
// add, so the kernel is bitwise equal to its plain version.
//
// Bound, at the slice's shapes (Q = 64, B = 128): 160 KB moved (buf and
// dist in, d1 and srcs out, 32 KB each, prio 256 B), ~0.05 us at 3.35 TB/s,
// and ~10 f32 instructions per cell (~0.003 us at 33.5 T instructions/s):
// bytes bound it, and at this size a launch's latency dominates either
// (chip_smoke.py measured ~0.0017 ms per launch on an H100 80GB HBM3 at
// 700 W).  The design answer is not to launch it on the path at all: its
// tile runs inside the fused visit, where the rows are read once from HBM.
#include "visit_tiles.cuh"

namespace {

constexpr int kWarps = 8;

__global__ void __launch_bounds__(kWarps * 32)
frontier_kernel(const float* __restrict__ buf,
                const float* __restrict__ dist, float* __restrict__ d1,
                float* __restrict__ srcs, float* __restrict__ prio, int Q,
                int B, float delta, bool strict) {
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (q >= Q) return;  // warp-uniform
  const int64_t o = static_cast<int64_t>(q) * B;
  const float alpha = fg::frontier_row(buf + o, dist + o, d1 + o, nullptr,
                                       srcs + o, B, delta, strict, lane);
  if (lane == 0) prio[q] = alpha;
}

}  // namespace

extern "C" int fg_frontier(const void* buf, const void* dist, void* d1,
                           void* srcs, void* prio, int Q, int B, float delta,
                           int strict, void* stream) {
  if (Q <= 0 || B <= 0) return 0;
  const dim3 grid((Q + kWarps - 1) / kWarps);
  frontier_kernel<<<grid, kWarps * 32, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(buf), static_cast<const float*>(dist),
      static_cast<float*>(d1), static_cast<float*>(srcs),
      static_cast<float*>(prio), Q, B, delta, strict != 0);
  return static_cast<int>(cudaGetLastError());
}
