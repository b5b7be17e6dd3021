// Device code shared by the visit kernels: the frontier tile, the push
// round and its per-cell update, and the list contraction.  frontier.cu,
// ppr_push.cu, minplus.cu and fused_visit.cu include it, so each standalone
// entry and the fused visit run the same instructions, as the reference's
// standalone Pallas calls and its fused kernel share frontier_tile,
// push_tile and minplus_tile.
//
// Numerics: every expression is evaluated in the order of the port's plain
// PyTorch versions (kernels/frontier/ref.py, kernels/ppr_push/ref.py,
// kernels/minplus/ref.py and core/visit.py's algebras) with explicitly
// rounded f32 operations (__fadd_rn, __fmul_rn, __fdiv_rn), and the sources
// build with -fmad=false, so no product is contracted into a following
// add.  The push spread (spread_tile) sums u = 0..B-1 in order with one
// fmaf per term starting from 0; the list contraction (contract_list) sums
// only the finite entries, in the same order, which gives the same bits
// (see contract_list).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace fg {

__device__ __forceinline__ float warp_min(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fminf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ int warp_sum(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The frontier tile (reference kernels/frontier/frontier.py frontier_tile)
// over one query row of B values, run by one whole warp:
//   pending = isfinite(buf) & (strict ? buf < dist : buf <= dist)
//   d1      = min(dist, pending ? buf : +inf)
//   alpha   = min over the row of (pending ? d1 : +inf)      (returned)
//   srcs    = (pending & d1 <= alpha + delta) ? d1 : +inf   (if srcs)
// `pend` and `srcs` may be null.  Pointers may be global or shared.
__device__ inline float frontier_row(const float* buf, const float* dist,
                                     float* d1, uint8_t* pend, float* srcs,
                                     int B, float delta, bool strict,
                                     int lane) {
  float best = INFINITY;
  for (int v = lane; v < B; v += 32) {
    const float b = buf[v], d = dist[v];
    const bool pe = isfinite(b) && (strict ? b < d : b <= d);
    const float x = fminf(d, pe ? b : INFINITY);
    d1[v] = x;
    if (pend) pend[v] = pe;
    if (pe) best = fminf(best, x);
  }
  const float alpha = warp_min(best);
  if (srcs) {
    const float thr = __fadd_rn(alpha, delta);
    for (int v = lane; v < B; v += 32) {
      const float b = buf[v], d = dist[v];
      const bool pe = isfinite(b) && (strict ? b < d : b <= d);
      const float x = fminf(d, pe ? b : INFINITY);
      srcs[v] = (pe && x <= thr) ? x : INFINITY;
    }
  }
  return alpha;
}

// bits[u][w] bit b = isfinite(blk[u][32 w + b]) (0 past B); one warp per
// word, each lane reading one column, so the reads are coalesced.
__device__ inline void load_mask_bits(uint32_t* bits, const float* blk,
                                      int B, int bw, int warp, int nwarps,
                                      int lane) {
  for (int i = warp; i < B * bw; i += nwarps) {
    const int u = i / bw, v = (i % bw) * 32 + lane;
    const bool f = v < B && isfinite(blk[static_cast<int64_t>(u) * B + v]);
    const uint32_t word = __ballot_sync(0xffffffffu, f);
    if (lane == 0) bits[i] = word;
  }
}

// One 4x4 output tile of the push spread: rows q0..q0+3 of X [.., ldx]
// against block columns v0..v0+3 (v0 a multiple of 4), u = 0..B-1 in order:
//   acc = fmaf(x[q, u], finite(W[u, v]), acc)        bits [.., ldw] u32
__device__ __forceinline__ void spread_tile(float (&acc)[4][4], const float* X,
                                            int ldx, int q0,
                                            const uint32_t* bits, int ldw,
                                            int v0, int B) {
  for (int u = 0; u < B; ++u) {
    float x[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) x[r] = X[(q0 + r) * ldx + u];
    const uint32_t nib = bits[u * ldw + (v0 >> 5)] >> (v0 & 31);
    float m[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) m[c] = ((nib >> c) & 1u) ? 1.0f : 0.0f;
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(x[r], m[c], acc[r][c]);
  }
}

// The push-mode active test of one cell (push_algebra.active without the
// budget lane): r >= eps * max(deg, 1) on a vertex with out-edges.
__device__ __forceinline__ bool push_active(float r, float thresh,
                                            bool has_edges) {
  return r >= thresh && has_edges;
}

// The elementwise half of one push round on one cell, in
// push_algebra.step's expression order:
//   af = act;  p += alpha*r*af;  x = (1-alpha)*r*af/degc;  acc += x;
//   r = r*(1-af)                       (the spread is added to r after)
// `c1` is the f32 value of 1 - alpha.
__device__ __forceinline__ void push_cell(float& p, float& r, float& acc,
                                          float& x, bool act, float degc,
                                          float alpha, float c1) {
  const float af = act ? 1.0f : 0.0f;
  const float rv = r;
  p = __fadd_rn(p, __fmul_rn(__fmul_rn(alpha, rv), af));
  const float pushed = __fdiv_rn(__fmul_rn(__fmul_rn(c1, rv), af), degc);
  x = pushed;
  r = __fmul_rn(rv, __fsub_rn(1.0f, af));
  acc = __fadd_rn(acc, pushed);
}

// One ACL push round (reference kernels/ppr_push/push.py push_tile) over
// rows [0, rows) of the [rows_pad, ld] shared tiles p, r, acc, with the
// active set `act` given: push_cell on every cell, then
//   r  = r + x @ finite(W)                  (W as mask bits [B, bw])
// x is scratch; its rows in [rows, rows_pad) must hold 0.  Every thread of
// the block calls it; it ends with a barrier.
__device__ inline void push_round(float* p, float* r, float* acc, float* x,
                                  const uint8_t* act, const float* degc,
                                  const uint32_t* bits, int bw, int rows,
                                  int rows_pad, int B, int ld, float alpha,
                                  float c1, int tid, int nt) {
  for (int i = tid; i < rows * B; i += nt) {
    const int q = i / B, v = i % B, o = q * ld + v;
    push_cell(p[o], r[o], acc[o], x[o], act[o], degc[v], alpha, c1);
  }
  __syncthreads();
  const int nvt = ld / 4, ntiles = (rows_pad / 4) * nvt;
  for (int t = tid; t < ntiles; t += nt) {
    const int q0 = (t / nvt) * 4, v0 = (t % nvt) * 4;
    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[a][c] = 0.0f;
    spread_tile(s, x, ld, q0, bits, bw, v0, B);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int q = q0 + a, v = v0 + c;
        if (q < rows && v < B) r[q * ld + v] = __fadd_rn(r[q * ld + v],
                                                         s[a][c]);
      }
  }
  __syncthreads();
}

// A block's column lists in global memory (core/engine.column_lists:
// col_u, col_w), read through the read-only path.
struct GlobalEntries {
  const int* u;
  const float* w;
  __device__ __forceinline__ int row(int e) const { return __ldg(u + e); }
  __device__ __forceinline__ float weight(int e) const {
    return __ldg(w + e);
  }
};

// acc[r] over the list entries [e0, e1) of one output column, read through
// `list` (row(e) = u, weight(e) = w), for the query rows x[r * ldx],
// r < nq:
//   min-plus       acc = fminf(acc, x[u] + w)                 from +inf
//   masked matmul  acc = fmaf(x[u], 1, acc)   (ascending u)   from +0
// Min-plus over a column's finite entries is the dense min_u x[u] + w[u, v]
// bit for bit: an absent entry adds +inf to an exact, order-free min.  The
// dense masked matmul sums u = 0..B-1 as fmaf(x, m, acc), m = finite(w);
// an absent term is fmaf(x, 0, acc) = acc exactly (x finite, acc never
// -0), so one fmaf(x, 1, acc) per present entry in ascending u gives the
// same bits.  On a non-finite x the dense form turns inf * 0 into NaN in
// every column and the list form does not: the masked matmul's callers
// pass finite x.  The walk is unrolled by four, so a long list's entry
// loads and x reads overlap instead of each waiting on the one before.
template <bool kMinPlus, int kRows, class Entries>
__device__ __forceinline__ void contract_list(float (&acc)[kRows],
                                              const float* x, int ldx,
                                              int nq, int e0, int e1,
                                              const Entries& list) {
#pragma unroll 4
  for (int e = e0; e < e1; ++e) {
    const int u = list.row(e);
    const float w = kMinPlus ? list.weight(e) : 0.0f;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < nq) {
        const float xv = x[r * ldx + u];
        acc[r] = kMinPlus ? fminf(acc[r], __fadd_rn(xv, w))
                          : fmaf(xv, 1.0f, acc[r]);
      }
    }
  }
}

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

}  // namespace fg
