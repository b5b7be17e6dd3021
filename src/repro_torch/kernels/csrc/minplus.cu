// Hopper (sm_90a) kernels for the intra-partition contraction of a visit.
//
//   fg_minplus        out[s, q, v] = min_u x[q, u] + W_s[u, v]
//                     the tropical relax and the minplus neighbour contrib.
//                     Replaces the TPU kernel minplus_pallas_call
//                     (src/repro/kernels/minplus/minplus.py, body
//                     _minplus_kernel, tile minplus_tile) and the +inf Q
//                     padding of ops._pad_q.
//   fg_masked_matmul  out[s, q, v] = sum_u x[q, u] * isfinite(W_s[u, v])
//                     the PPR residual spread and the push contrib.
//                     Replaces masked_matmul_pallas_call (same file, body
//                     _masked_matmul_kernel) and its zero Q padding.
//
// Both take a batched form: x [Q, B], blocks [nblk, B, B], idx [S] ->
// out [S, Q, B] with W_s = blocks[idx[s]], read in place.  A visit's
// emission over its dmax neighbour blocks is one launch that gathers no
// [dmax, B, B] copy; the single relax is S = 1.  idx[s] < 0 (the -1 padding
// of a neighbour list) yields the identity plane (+inf / 0); an index past
// nblk yields NaN so a corrupt index cannot pass for a result.
//
// Layout: one thread per output column v (128 along x), each thread owning
// kRQ query rows (4 thread rows along y, so 16 rows per block).  The x rows
// of a u-chunk sit in shared memory and are read as warp broadcasts;
// W_s[u, v] is read once per u, coalesced along v, and reused for all the
// thread's rows.  The ragged Q and B edges are masked in the kernel.
//
// Numerics: every min-plus candidate is the same IEEE f32 add x + w as in
// the plain version, and min is order-free, so fg_minplus is bitwise equal
// to it (no fast-math: +inf + w must stay +inf, denormals must not flush).
// fg_masked_matmul sums in the fixed order u = 0..B-1 with FMAs on the FP32
// cores (no tensor cores, no TF32); it agrees with a float32 matmul to
// rounding, not bitwise.
//
// Bound, at the slice's shapes (Q = 64, B = 128, one block): 128 KB moved
// (x 32 KB, W 64 KB, out 32 KB), ~0.04 us at an H100 SXM's data-sheet
// 3.35 TB/s (700 W limit).  Dense, the work is Q B^2 = 1.05 M (q, u, v)
// pairs: two FP32 instructions each for min-plus (add, then min), one FMA
// for the masked matmul.  One FP32 instruction issues at most at half the
// data sheet's 67 TFLOP/s (which counts an FMA as two operations), so the
// dense min-plus needs >= ~0.06 us and the masked matmul >= ~0.03 us; with
// the path's +inf density the pairs that need work are a few percent of
// that, and the bytes bound it.  Either way it is far below one launch's
// latency, so on this path the kernels are launch-bound.  The design answer
// is the batched form above (one launch for all of a visit's neighbour
// blocks).  Measured by chip_smoke.py on an H100 80GB HBM3 at 700 W, one
// launch takes ~10 us on the card: with Q = 64 only 4 blocks run, and each
// thread walks a serial chain of B loads of W.  Splitting u across warps,
// staging W in shared memory, TMA and a persistent visit are later work.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTV = 128;          // threads along v
constexpr int kTY = 4;            // thread rows
constexpr int kRQ = 4;            // query rows per thread
constexpr int kTQ = kTY * kRQ;    // query rows per block
constexpr int kUC = 32;           // u chunk held in shared memory

template <bool kMinPlus>
__global__ void __launch_bounds__(kTV * kTY)
contract_kernel(const float* __restrict__ x, const float* __restrict__ blocks,
                const int64_t* __restrict__ idx, float* __restrict__ out,
                int Q, int B, int64_t nblk) {
  __shared__ float xs[kTQ][kUC];
  const float ident = kMinPlus ? INFINITY : 0.0f;
  const int v = blockIdx.x * kTV + threadIdx.x;
  const int q0 = blockIdx.y * kTQ;
  const int row0 = threadIdx.y * kRQ;
  const int s = blockIdx.z;
  const int64_t k = idx[s];
  float* o = out + static_cast<int64_t>(s) * Q * B;

  if (k < 0 || k >= nblk) {       // whole block takes the same branch
    if (v < B) {
      const float fill = k < 0 ? ident : NAN;
      for (int r = 0; r < kRQ; ++r) {
        const int q = q0 + row0 + r;
        if (q < Q) o[static_cast<int64_t>(q) * B + v] = fill;
      }
    }
    return;
  }

  const float* w = blocks + k * B * B;
  float acc[kRQ];
#pragma unroll
  for (int r = 0; r < kRQ; ++r) acc[r] = ident;

  const int tid = threadIdx.y * kTV + threadIdx.x;
  for (int u0 = 0; u0 < B; u0 += kUC) {
    for (int i = tid; i < kTQ * kUC; i += kTV * kTY) {
      const int qq = i / kUC, uu = i % kUC;
      const int q = q0 + qq, u = u0 + uu;
      xs[qq][uu] = (q < Q && u < B) ? x[static_cast<int64_t>(q) * B + u]
                                    : ident;
    }
    __syncthreads();
    if (v < B) {
      const int ulim = min(kUC, B - u0);
      for (int uu = 0; uu < ulim; ++uu) {
        const float wv = w[static_cast<int64_t>(u0 + uu) * B + v];
        if (kMinPlus) {
#pragma unroll
          for (int r = 0; r < kRQ; ++r)
            acc[r] = fminf(acc[r], __fadd_rn(xs[row0 + r][uu], wv));
        } else {
          const float m = isfinite(wv) ? 1.0f : 0.0f;
#pragma unroll
          for (int r = 0; r < kRQ; ++r)
            acc[r] = fmaf(xs[row0 + r][uu], m, acc[r]);
        }
      }
    }
    __syncthreads();
  }
  if (v < B) {
#pragma unroll
    for (int r = 0; r < kRQ; ++r) {
      const int q = q0 + row0 + r;
      if (q < Q) o[static_cast<int64_t>(q) * B + v] = acc[r];
    }
  }
}

template <bool kMinPlus>
int launch(const void* x, const void* blocks, const void* idx, void* out,
           int S, int Q, int B, long long nblk, void* stream) {
  if (S <= 0 || Q <= 0 || B <= 0) return 0;
  const dim3 block(kTV, kTY);
  const dim3 grid((B + kTV - 1) / kTV, (Q + kTQ - 1) / kTQ, S);
  contract_kernel<kMinPlus><<<grid, block, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(blocks),
      static_cast<const int64_t*>(idx), static_cast<float*>(out), Q, B,
      static_cast<int64_t>(nblk));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fg_minplus(const void* x, const void* blocks, const void* idx,
                          void* out, int S, int Q, int B, long long nblk,
                          void* stream) {
  return launch<true>(x, blocks, idx, out, S, Q, B, nblk, stream);
}

extern "C" int fg_masked_matmul(const void* x, const void* blocks,
                                const void* idx, void* out, int S, int Q,
                                int B, long long nblk, void* stream) {
  return launch<false>(x, blocks, idx, out, S, Q, B, nblk, stream);
}
