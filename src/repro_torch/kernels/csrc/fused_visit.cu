// Hopper (sm_90a) kernel for a whole partition visit: one launch = one
// iteration of the engine's K-visit loop.
//
//   fg_fused_visit  select the partition (priority / fifo / max_ops, first
//                   index on ties), consolidate its buffer, relax until no
//                   op is active or max_rounds, emit into every neighbour's
//                   buffer row, refresh the scheduler metadata of every row
//                   it touched, and update the chunk's stats -- with no
//                   read back to the host.  When no partition holds a
//                   pending op the launch does nothing: that is the loop's
//                   exit, and the host reads the stats once per chunk.
//                   Replaces the TPU kernel of make_fused_visit
//                   (src/repro/kernels/fused_visit/fused.py, pallas_call in
//                   `visit`) and the while_loop around it
//                   (src/repro/core/visit.py make_megastep(fused=True)).
//
// Design.  The TPU kernel runs the visit as grid steps 0..dmax over a VMEM
// copy of the partition's whole adjacency row ([1+dmax, B+1, B], over
// 600 KB at B = 128) plus parking scratch.  A Hopper block has 227 KB of
// shared memory, so here one thread block of 512 threads runs the visit
// as a loop and streams the blocks one at a time:
//   * the visited rows ([Q, B] values and masks) stay in shared memory for
//     the whole visit, with the diagonal block (min-plus: f32; push: its
//     finite mask as bits);
//   * the relax loop's exit test is a block-wide __syncthreads_or;
//   * each valid neighbour slot in turn: its block is loaded into shared
//     memory, its contribution is combined into the neighbour's buffer row
//     in global memory (neighbour lists are unique and diagonal-free, so
//     the read-modify-write is exact), and a block reduction refreshes that
//     row's prio / ops_count / stamp;
//   * padded slots (nbr_blk < 0) are skipped, so the trash row P is never
//     touched.
// The contraction is fg::contract_tile: each thread owns 4x4 output tiles;
// the weight row is one float4 load, the sources warp broadcasts.  With
// sparse = 1 (min-plus only) each contraction walks only the source
// columns u that hold a finite source in some query row.
//
// Bound.  At the main path's shapes (Q = 64, B = 128, dmax = 4) a visit
// moves ~0.8 MB (own rows in and out, the diagonal block, the neighbour
// blocks and the neighbours' rows read and written), ~0.25 us at
// 3.35 TB/s.  The dense contractions are larger: (rounds + emission slots)
// x Q B^2 cells at two f32 instructions each (min-plus), ~12 M
// instructions for a typical visit, ~0.35 us at the card's 33.5 T
// instructions/s but ~50 us on the one SM this design uses.  So the
// kernel is bound by its own single-SM issue rate, not by the card.
// Measured by chip_smoke.py on an H100 80GB HBM3 at 700 W: 0.148 ms per
// sssp visit and 0.182 ms per ppr visit, while the road grid's data needs
// only ~20-40 live (q, u, v) pairs per visit.  The answers after this
// slice: contract over each block's finite entries only, then split a
// visit's query rows over a thread block cluster (rows are independent
// through the relax).
//
// Numerics: the expressions of visit_tiles.cuh, in the plain version's
// order; min-plus is bitwise equal to the plain version, push to the
// unfused card path (same spread order as fg_masked_matmul).
#include <limits.h>

#include "visit_tiles.cuh"

// Mirrors the ctypes Structure in kernels/fused_visit/ops.py field by
// field.  It lives outside the anonymous namespace: the exported entry
// takes a pointer to it, and a parameter type with internal linkage would
// give the entry internal linkage too.
struct FusedArgs {
  float* plane0;             // [P, Q, B] dist (min-plus) or p (push)
  float* plane1;             // [P, Q, B] r (push); unused for min-plus
  float* buf;                // [P+1, Q, B] buffered ops
  float* prio;               // [P+1]
  int* ops;                  // [P+1]
  int* stamp;                // [P+1]
  int* stats;                // [2 + 2Q + P + K]: k, rounds, eq_hi, eq_lo,
                             //   visit_counts, order
  const float* blocks;       // [nblk, B, B]
  const int* row_nnz;        // [nblk, B]
  const int64_t* nbr_blk;    // [P, dmax], -1 = padded slot
  const int64_t* nbr_dst;    // [P, dmax]
  const int* nbr_nnz;        // [P, B]
  const int64_t* diag_blk;   // [P]
  const int* deg;            // [P, B]
  const float* budget;       // [P]
  long long nblk;
  int P, Q, B, dmax, K, max_rounds, counter, strict;
  float window, alpha, c1, eps;
  int smem_bytes;
};

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kBigStamp = INT_MAX - 1;
constexpr int kEdgeShift = 20;
constexpr int kErrSmem = -1;  // smem_bytes below what the layout needs

enum { kMinplus = 0, kPush = 1 };
enum { kPriority = 0, kFifo = 1, kMaxOps = 2 };

// Shared-memory layout, in 4-byte words then bytes.  kernels/fused_visit/
// ops.py asks fg_fused_visit_smem for the total, and
// fpp/planner.MemoryModel.fused_working_set computes the same number.
struct Layout {
  int Qp, Bp, bw;
  // word offsets
  int v0, v1, v2, v3;        // [Qp, Bp] planes (see the kernels)
  int w;                     // min-plus: [Bp, Bp] f32; push: [B, bw] bits
  int degc, thresh, degi;    // [Bp] (push)
  int nnz, nnz2, ulist;      // [Bp]
  int alpha, eq;             // [Qp]
  int red, misc;             // [4 kWarps], [4]
  int words;
  // byte offsets from the start of shared memory
  int m0, m1, live;          // [Qp, Bp] masks, [Bp] live columns
  size_t total;
};

__host__ __device__ inline Layout layout(int algebra, int Q, int B) {
  Layout L{};
  L.Qp = fg::round4(Q);
  L.Bp = fg::round4(B);
  L.bw = (L.Bp + 31) / 32;
  const int QB = L.Qp * L.Bp;
  int o = 0;
  L.v0 = o; o += QB;
  L.v1 = o; o += QB;
  if (algebra == kPush) {
    L.v2 = o; o += QB;
    L.v3 = o; o += QB;
    L.w = o; o += L.Bp * L.bw;
    L.degc = o; o += L.Bp;
    L.thresh = o; o += L.Bp;
    L.degi = o; o += L.Bp;
  } else {
    L.v2 = L.v3 = L.degc = L.thresh = L.degi = -1;
    L.w = o; o += L.Bp * L.Bp;
  }
  L.nnz = o; o += L.Bp;
  L.nnz2 = o; o += L.Bp;
  if (algebra == kPush) {
    L.ulist = L.alpha = -1;
  } else {
    L.ulist = o; o += L.Bp;
    L.alpha = o; o += L.Qp;
  }
  L.eq = o; o += L.Qp;
  L.red = o; o += 4 * kWarps;
  L.misc = o; o += 4;
  L.words = o;
  int b = 4 * o;
  L.m0 = b; b += QB;
  if (algebra == kPush) {
    L.m1 = L.live = -1;
  } else {
    L.m1 = b; b += QB;
    L.live = b; b += L.Bp;
  }
  L.total = static_cast<size_t>((b + 15) & ~15);
  return L;
}

template <typename T>
__device__ __forceinline__ void take(T& bk, int& bi, T k, int i) {
  if (k < bk || (k == bk && i < bi)) {
    bk = k;
    bi = i;
  }
}

// First index of the least key over the block; every thread gets it.
template <typename T>
__device__ int block_argmin(T key, int idx, T* red_k, int* red_i, int lane,
                            int warp) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const T k2 = __shfl_xor_sync(0xffffffffu, key, o);
    const int i2 = __shfl_xor_sync(0xffffffffu, idx, o);
    take(key, idx, k2, i2);
  }
  if (lane == 0) {
    red_k[warp] = key;
    red_i[warp] = idx;
  }
  __syncthreads();
  T bk = red_k[0];
  int bi = red_i[0];
  for (int w = 1; w < kWarps; ++w) take(bk, bi, red_k[w], red_i[w]);
  __syncthreads();
  return bi;
}

// device_select (core/visit.py) over prio/stamp/ops [0, P): the partition
// to visit, or -1 when no priority is finite.
template <int kPolicy>
__device__ int select_partition(const FusedArgs& a, float* redf, int* redi,
                                int tid, int lane, int warp) {
  bool any = false;
  float bf = INFINITY;
  int bk = INT_MAX, bi = INT_MAX;
  for (int i = tid; i < a.P; i += kThreads) {
    const float pr = a.prio[i];
    const bool fin = isfinite(pr);
    any |= fin;
    if (kPolicy == kPriority) take(bf, bi, pr, i);
    else if (kPolicy == kFifo) take(bk, bi, fin ? a.stamp[i] : INT_MAX, i);
    else take(bk, bi, fin ? -a.ops[i] : 1, i);  // argmax of ops, or -1
  }
  if (!__syncthreads_or(any)) return -1;
  if (kPolicy == kPriority)
    return block_argmin(bf, bi, redf, redi, lane, warp);
  return block_argmin(bk, bi, redi + kWarps, redi, lane, warp);
}

__device__ __forceinline__ float block_min(float v, float* red, int lane,
                                           int warp) {
  v = fg::warp_min(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < kWarps; ++w) r = fminf(r, red[w]);
  __syncthreads();
  return r;
}

__device__ __forceinline__ float block_max(float v, float* red, int lane,
                                           int warp) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < kWarps; ++w) r = fmaxf(r, red[w]);
  __syncthreads();
  return r;
}

__device__ __forceinline__ int block_sum(int v, int* red, int lane,
                                         int warp) {
  v = fg::warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  int r = 0;
  for (int w = 0; w < kWarps; ++w) r += red[w];
  __syncthreads();
  return r;
}

// The columns u with live[u] set, ascending, into list; live is cleared.
// Warp 0 compacts with ballots; returns the count to every thread.
__device__ int compact_live(uint8_t* live, int* list, int* misc, int B,
                            int lane, int warp) {
  if (warp == 0) {
    int n = 0;
    for (int u0 = 0; u0 < B; u0 += 32) {
      const int u = u0 + lane;
      const bool on = u < B && live[u];
      const unsigned m = __ballot_sync(0xffffffffu, on);
      if (on) {
        list[n + __popc(m & ((1u << lane) - 1u))] = u;
        live[u] = 0;
      }
      n += __popc(m);
    }
    if (lane == 0) misc[0] = n;
  }
  __syncthreads();
  return misc[0];
}

// The visit's chunk bookkeeping: k, rounds, the exact (hi, lo) edge
// counters, visits per partition and the visit order.
__device__ void update_stats(const FusedArgs& a, int p, int k, int rounds,
                             const int* eq, int tid) {
  int* st = a.stats;
  int* hi = st + 2;
  int* lo = hi + a.Q;
  int* counts = lo + a.Q;
  int* order = counts + a.P;
  for (int q = tid; q < a.Q; q += kThreads) {
    int l = lo[q] + eq[q];
    const int spill = l >> kEdgeShift;
    hi[q] += spill;
    lo[q] = l - (spill << kEdgeShift);
  }
  if (tid == 0) {
    st[0] = k + 1;
    st[1] += rounds;
    counts[p] += 1;
    order[k] = p;
  }
}

template <int kPolicy, bool kSparse>
__global__ void __launch_bounds__(kThreads)
fused_minplus_kernel(const FusedArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(kMinplus, a.Q, a.B);
  float* sf = reinterpret_cast<float*>(smem);
  int* si = reinterpret_cast<int*>(smem);
  float* D = sf + L.v0;        // the row's values
  float* X = sf + L.v1;        // contraction sources
  float* W = sf + L.w;         // the current block
  float* ALPHA = sf + L.alpha;
  int* EQ = si + L.eq;
  int* NNZ = si + L.nnz;       // diagonal block's row counts
  int* NNZ2 = si + L.nnz2;     // row counts into all neighbour blocks
  int* ULIST = si + L.ulist;
  float* REDF = sf + L.red;
  int* REDI = si + L.red + kWarps;
  int* MISC = si + L.misc;
  uint8_t* PEND = smem + L.m0;
  uint8_t* EMIT = smem + L.m1;
  uint8_t* LIVE = smem + L.live;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int Q = a.Q, B = a.B, Bp = L.Bp, Qp = L.Qp;
  const int nvt = Bp / 4, ntiles = (Qp / 4) * nvt;
  const bool strict = a.strict != 0;
  const int k = a.stats[0];
  if (k >= a.K) return;
  const int p = select_partition<kPolicy>(a, REDF, REDI, tid, lane, warp);
  if (p < 0) return;
  const int cnt = a.counter + k;
  const int64_t kd = a.diag_blk[p];
  const float budget = a.budget[p];
  const int64_t QB = static_cast<int64_t>(Q) * B;
  float* dist_p = a.plane0 + p * QB;
  float* buf_p = a.buf + p * QB;

  // consolidate: the frontier tile, one warp per query row
  for (int q = warp; q < Q; q += kWarps) {
    const float al = fg::frontier_row(buf_p + q * B, dist_p + q * B,
                                      D + q * Bp, PEND + q * Bp, nullptr, B,
                                      a.window, strict, lane);
    if (lane == 0) {
      ALPHA[q] = al;
      EQ[q] = 0;
    }
  }
  for (int i = Q * Bp + tid; i < Qp * Bp; i += kThreads) X[i] = INFINITY;
  for (int i = tid; i < Qp * Bp; i += kThreads) EMIT[i] = 0;
  for (int u = tid; u < Bp; u += kThreads) LIVE[u] = 0;
  for (int u = tid; u < B; u += kThreads) {
    NNZ[u] = a.row_nnz[kd * B + u];
    NNZ2[u] = a.nbr_nnz[static_cast<int64_t>(p) * B + u];
  }
  fg::load_weights(W, a.blocks + kd * B * B, B, Bp, tid, kThreads);
  __syncthreads();

  // relax until no op is active or max_rounds
  int rounds = 0;
  while (rounds < a.max_rounds) {
    bool any = false;
    for (int q = warp; q < Q; q += kWarps) {
      const bool lane_ok = __int2float_rn(EQ[q]) < budget;
      const float thr = __fadd_rn(ALPHA[q], a.window);
      int inc = 0;
      for (int u = lane; u < B; u += 32) {
        const int o = q * Bp + u;
        const float d = D[o];
        const bool act = PEND[o] && d <= thr && lane_ok;
        X[o] = act ? d : INFINITY;
        if (act) {
          PEND[o] = 0;
          EMIT[o] = 1;
          inc += NNZ[u];
          any = true;
          if (kSparse) LIVE[u] = 1;
        }
      }
      inc = fg::warp_sum(inc);
      if (lane == 0) EQ[q] += inc;
    }
    if (!__syncthreads_or(any)) break;
    int nu = B;
    const int* us = nullptr;
    if (kSparse) {
      nu = compact_live(LIVE, ULIST, MISC, B, lane, warp);
      us = ULIST;
    }
    for (int t = tid; t < ntiles; t += kThreads) {
      const int q0 = (t / nvt) * 4, v0 = (t % nvt) * 4;
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = INFINITY;
      fg::contract_tile<true>(acc, X, Bp, q0, W, nullptr, Bp, v0, us, nu);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int q = q0 + r, v = v0 + c;
          if (q < Q && v < B) {
            const int o = q * Bp + v;
            const float d = D[o], nd = acc[r][c];
            if (nd < d) PEND[o] = 1;
            D[o] = fminf(d, nd);
          }
        }
    }
    __syncthreads();
    ++rounds;
  }

  // emission payload (emit ? d : +inf) and its edge count
  for (int q = warp; q < Q; q += kWarps) {
    int inc = 0;
    for (int u = lane; u < B; u += 32) {
      const int o = q * Bp + u;
      const bool e = EMIT[o];
      X[o] = e ? D[o] : INFINITY;
      if (e) {
        inc += NNZ2[u];
        if (kSparse) LIVE[u] = 1;
      }
    }
    inc = fg::warp_sum(inc);
    if (lane == 0) EQ[q] += inc;
  }
  __syncthreads();
  int nu = B;
  const int* us = nullptr;
  if (kSparse) {
    nu = compact_live(LIVE, ULIST, MISC, B, lane, warp);
    us = ULIST;
  }
  for (int s = 0; s < a.dmax; ++s) {
    const int64_t blk = a.nbr_blk[static_cast<int64_t>(p) * a.dmax + s];
    if (blk < 0) continue;  // padded slot: block-uniform
    const int64_t j = a.nbr_dst[static_cast<int64_t>(p) * a.dmax + s];
    fg::load_weights(W, a.blocks + blk * B * B, B, Bp, tid, kThreads);
    __syncthreads();
    float* buf_j = a.buf + j * QB;
    const float* dist_j = a.plane0 + j * QB;
    float best = INFINITY;
    int n = 0;
    for (int t = tid; t < ntiles; t += kThreads) {
      const int q0 = (t / nvt) * 4, v0 = (t % nvt) * 4;
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = INFINITY;
      fg::contract_tile<true>(acc, X, Bp, q0, W, nullptr, Bp, v0, us, nu);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int q = q0 + r, v = v0 + c;
          if (q < Q && v < B) {
            const int o = q * B + v;
            const float nv = fminf(buf_j[o], acc[r][c]);
            buf_j[o] = nv;
            const float d = dist_j[o];
            if (isfinite(nv) && (strict ? nv < d : nv <= d)) {
              best = fminf(best, nv);
              ++n;
            }
          }
        }
    }
    best = block_min(best, REDF, lane, warp);
    n = block_sum(n, REDI, lane, warp);
    if (tid == 0) {
      const bool was_empty = !isfinite(a.prio[j]);
      a.prio[j] = best;
      a.ops[j] = n;
      if (was_empty && isfinite(best)) a.stamp[j] = cnt;
    }
  }

  // write back the row, keep its unrelaxed ops, refresh its own metadata
  float best = INFINITY;
  int n = 0;
  for (int i = tid; i < Q * B; i += kThreads) {
    const int q = i / B, v = i % B, o = q * Bp + v;
    const float d = D[o];
    const float keep = PEND[o] ? d : INFINITY;
    dist_p[i] = d;
    buf_p[i] = keep;
    if (isfinite(keep) && (strict ? keep < d : keep <= d)) {
      best = fminf(best, keep);
      ++n;
    }
  }
  best = block_min(best, REDF, lane, warp);
  n = block_sum(n, REDI, lane, warp);
  if (tid == 0) {
    a.prio[p] = best;
    a.ops[p] = n;
    a.stamp[p] = isfinite(best) ? cnt : kBigStamp;
  }
  update_stats(a, p, k, rounds, EQ, tid);
}

template <int kPolicy>
__global__ void __launch_bounds__(kThreads)
fused_push_kernel(const FusedArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(kPush, a.Q, a.B);
  float* sf = reinterpret_cast<float*>(smem);
  int* si = reinterpret_cast<int*>(smem);
  float* PP = sf + L.v0;       // PPR mass
  float* R = sf + L.v1;        // residual
  float* ACC = sf + L.v2;      // pushed mass (the emission payload)
  float* X = sf + L.v3;        // this round's pushed values
  uint32_t* BITS = reinterpret_cast<uint32_t*>(si + L.w);
  float* DEGC = sf + L.degc;
  float* TH = sf + L.thresh;
  int* DEGI = si + L.degi;
  int* NNZ = si + L.nnz;
  int* NNZ2 = si + L.nnz2;
  int* EQ = si + L.eq;
  float* REDF = sf + L.red;
  int* REDI = si + L.red + kWarps;
  uint8_t* ACT = smem + L.m0;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int Q = a.Q, B = a.B, Bp = L.Bp, Qp = L.Qp, bw = L.bw;
  const int nvt = Bp / 4, ntiles = (Qp / 4) * nvt;
  const int k = a.stats[0];
  if (k >= a.K) return;
  const int p = select_partition<kPolicy>(a, REDF, REDI, tid, lane, warp);
  if (p < 0) return;
  const int cnt = a.counter + k;
  const int64_t kd = a.diag_blk[p];
  const float budget = a.budget[p];
  const int64_t QB = static_cast<int64_t>(Q) * B;
  float* p_p = a.plane0 + p * QB;
  float* r_p = a.plane1 + p * QB;
  float* buf_p = a.buf + p * QB;

  // begin: r += buf, acc = 0 (pad rows of acc and x stay 0)
  for (int i = tid; i < Qp * Bp; i += kThreads) {
    ACC[i] = 0.0f;
    X[i] = 0.0f;
  }
  for (int i = tid; i < Q * B; i += kThreads) {
    const int o = (i / B) * Bp + i % B;
    PP[o] = p_p[i];
    R[o] = __fadd_rn(r_p[i], buf_p[i]);
  }
  for (int u = tid; u < B; u += kThreads) {
    const int dg = a.deg[static_cast<int64_t>(p) * B + u];
    DEGI[u] = dg;
    DEGC[u] = static_cast<float>(max(dg, 1));
    TH[u] = __fmul_rn(a.eps, DEGC[u]);
    NNZ[u] = a.row_nnz[kd * B + u];
    NNZ2[u] = a.nbr_nnz[static_cast<int64_t>(p) * B + u];
  }
  for (int q = tid; q < Q; q += kThreads) EQ[q] = 0;
  fg::load_mask_bits(BITS, a.blocks + kd * B * B, B, bw, warp, kWarps, lane);
  __syncthreads();

  // push rounds until no op is active or max_rounds
  int rounds = 0;
  while (rounds < a.max_rounds) {
    bool any = false;
    for (int q = warp; q < Q; q += kWarps) {
      const bool lane_ok = __int2float_rn(EQ[q]) < budget;
      int inc = 0;
      for (int u = lane; u < B; u += 32) {
        const int o = q * Bp + u;
        const bool act =
            fg::push_active(R[o], TH[u], DEGI[u] > 0) && lane_ok;
        ACT[o] = act;
        if (act) {
          inc += NNZ[u];
          any = true;
        }
      }
      inc = fg::warp_sum(inc);
      if (lane == 0) EQ[q] += inc;
    }
    if (!__syncthreads_or(any)) break;
    fg::push_round(PP, R, ACC, X, ACT, DEGC, BITS, bw, Q, Qp, B, Bp, a.alpha,
                   a.c1, tid, kThreads);
    ++rounds;
  }

  // emission edge count (acc > 0 marks the rows that cost edges)
  for (int q = warp; q < Q; q += kWarps) {
    int inc = 0;
    for (int u = lane; u < B; u += 32)
      if (ACC[q * Bp + u] > 0.0f) inc += NNZ2[u];
    inc = fg::warp_sum(inc);
    if (lane == 0) EQ[q] += inc;
  }
  for (int s = 0; s < a.dmax; ++s) {
    const int64_t blk = a.nbr_blk[static_cast<int64_t>(p) * a.dmax + s];
    if (blk < 0) continue;  // padded slot: block-uniform
    const int64_t j = a.nbr_dst[static_cast<int64_t>(p) * a.dmax + s];
    __syncthreads();  // the previous slot's bits are no longer read
    fg::load_mask_bits(BITS, a.blocks + blk * B * B, B, bw, warp, kWarps,
                       lane);
    __syncthreads();
    float* buf_j = a.buf + j * QB;
    const float* r_j = a.plane1 + j * QB;
    const int* deg_j = a.deg + j * B;
    float best = -INFINITY;
    int n = 0;
    for (int t = tid; t < ntiles; t += kThreads) {
      const int q0 = (t / nvt) * 4, v0 = (t % nvt) * 4;
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;
      fg::contract_tile<false>(acc, ACC, Bp, q0, nullptr, BITS, bw, v0,
                               nullptr, B);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int q = q0 + r, v = v0 + c;
          if (q < Q && v < B) {
            const int o = q * B + v;
            const float nb = __fadd_rn(buf_j[o], acc[r][c]);
            buf_j[o] = nb;
            const int dg = deg_j[v];
            const float th =
                __fmul_rn(a.eps, static_cast<float>(max(dg, 1)));
            const float ratio = __fdiv_rn(__fadd_rn(r_j[o], nb), th);
            if (dg > 0) {
              best = fmaxf(best, ratio);
              if (ratio >= 1.0f) ++n;
            }
          }
        }
    }
    best = block_max(best, REDF, lane, warp);
    n = block_sum(n, REDI, lane, warp);
    if (tid == 0) {
      const float np = n > 0 ? -best : INFINITY;
      const bool was_empty = !isfinite(a.prio[j]);
      a.prio[j] = np;
      a.ops[j] = n;
      if (was_empty && isfinite(np)) a.stamp[j] = cnt;
    }
  }

  // write back p and r, empty the buffer, refresh own metadata
  float best = -INFINITY;
  int n = 0;
  for (int i = tid; i < Q * B; i += kThreads) {
    const int v = i % B, o = (i / B) * Bp + v;
    const float rv = R[o];
    p_p[i] = PP[o];
    r_p[i] = rv;
    buf_p[i] = 0.0f;
    const float ratio = __fdiv_rn(__fadd_rn(rv, 0.0f), TH[v]);
    if (DEGI[v] > 0) {
      best = fmaxf(best, ratio);
      if (ratio >= 1.0f) ++n;
    }
  }
  best = block_max(best, REDF, lane, warp);
  n = block_sum(n, REDI, lane, warp);
  if (tid == 0) {
    const float np = n > 0 ? -best : INFINITY;
    a.prio[p] = np;
    a.ops[p] = n;
    a.stamp[p] = isfinite(np) ? cnt : kBigStamp;
  }
  update_stats(a, p, k, rounds, EQ, tid);
}

using Kernel = void (*)(const FusedArgs);

Kernel pick(int algebra, int policy, int sparse) {
  static const Kernel minplus[3][2] = {
      {fused_minplus_kernel<kPriority, false>,
       fused_minplus_kernel<kPriority, true>},
      {fused_minplus_kernel<kFifo, false>, fused_minplus_kernel<kFifo, true>},
      {fused_minplus_kernel<kMaxOps, false>,
       fused_minplus_kernel<kMaxOps, true>}};
  static const Kernel push[3] = {fused_push_kernel<kPriority>,
                                 fused_push_kernel<kFifo>,
                                 fused_push_kernel<kMaxOps>};
  if (policy < 0 || policy > 2) return nullptr;
  if (algebra == kMinplus) return minplus[policy][sparse ? 1 : 0];
  if (algebra == kPush && !sparse) return push[policy];
  return nullptr;
}

}  // namespace

// Dynamic shared-memory bytes one launch needs for (algebra, Q, B).
extern "C" long long fg_fused_visit_smem(int algebra, int Q, int B) {
  return static_cast<long long>(layout(algebra, Q, B).total);
}

// One visit (or nothing, when no partition holds a pending op), on one
// thread block with a->smem_bytes of dynamic shared memory.  Returns a
// CUDA error code, or -1 when a->smem_bytes is below what the layout needs.
extern "C" int fg_fused_visit(const FusedArgs* a, int algebra, int policy,
                              int sparse, void* stream) {
  if (a->P <= 0 || a->Q <= 0 || a->B <= 0 || a->K <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<size_t>(a->smem_bytes) < layout(algebra, a->Q, a->B).total)
    return kErrSmem;
  const Kernel k = pick(algebra, policy, sparse);
  if (k == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  // raise the kernel's dynamic shared-memory cap once per size
  static int configured[2][3][2] = {};
  int& cap = configured[algebra][policy][sparse ? 1 : 0];
  if (a->smem_bytes > cap) {
    const cudaError_t e = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, a->smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    cap = a->smem_bytes;
  }
  k<<<1, kThreads, a->smem_bytes, static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}
