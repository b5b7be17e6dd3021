// Hopper (sm_90a) kernel for the intra-partition contraction of a visit,
// over the column lists of each block's finite entries.
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
// Both take a batched form: x [Q, B], idx [S] and the lists of
// core/engine.column_lists -- col_ptr [nblk, B+1], col_u and col_w [nnz],
// the entries of column v of block k at col_ptr[k, v] .. col_ptr[k, v+1]
// in ascending u -- give out [S, Q, B], W_s being block idx[s].  A visit's
// emission over its dmax neighbour blocks is one launch; the relax is
// S = 1.  idx[s] < 0 (the -1 padding of a neighbour list) yields the
// identity plane (+inf / 0); an index past nblk yields NaN so a corrupt
// index cannot pass for a result.
//
// The gathered form: with xrow [S] (int64) given, x is [X, Q, B] and block
// idx[s] contracts x[xrow[s]].  A baselines round contracts every block of
// the graph against its source partition's rows in one launch this way
// (xrow = blk_src); an xrow outside [0, X) yields NaN like an index past
// nblk.  With xrow null every s reads the one x [Q, B].  A launch has at
// most 65,535 s-slices of CTAs (gridDim.z); in the gathered form each CTA
// walks s = blockIdx.z, blockIdx.z + gridDim.z, ... so a graph of more
// blocks still runs in one launch.  The form is a template flag: the
// visit's ungathered launches (S = 1 and S = dmax) keep a loop-free body
// with no xrow test (the loop and the test each cost those launches time,
// PERF.md section 6), and the wrapper sends an ungathered S past 65,535
// through the gathered form.
//
// Design.  On the road graphs the port serves a 128 x 128 block holds ~4
// finite entries per column, so the work is a few list entries per output
// column, and a launch is a short chain of dependent loads:
//   * One CTA per (32 output columns, 8 query rows, s): four warps, lane
//     c of each on column v0 + c, warp w on query rows 2w, 2w + 1.  At the
//     main path's Q = 64, B = 128 that is 32 CTAs for the relax (S = 1)
//     and 128 for the emission (S = 4), on 132 SMs.  32 columns keep a
//     CTA's segment of the list within its staging budget at B = 128;
//     four warps with two rows each share one staged segment and hide
//     each other's shared-memory latency on a long list (one warp holding
//     all 8 rows took 1.3x as long at the road density and 1.9x on a
//     fully finite block).
//   * The two independent reads overlap: the CTA's rows of x go into
//     shared memory by asynchronous copies (16-byte cp.async when rows are
//     16-byte aligned) while the block index and then the column bounds
//     load (coalesced along v).
//   * The CTA's columns are contiguous in the list, [col_ptr[k, v0],
//     col_ptr[k, v0 + 32]), so that segment is copied into shared memory
//     with coalesced copies when it fits (kSegCap entries: 32 full columns
//     at B = 128), and each thread walks its own column there.  A segment
//     that does not fit (B > 128 at high density) is walked in global
//     memory through L2 instead -- a size choice inside the kernel.
//     Staged entry j sits at slot j + j / 128, so the columns of a fully
//     finite 128-wide block (starts 128 apart) fall on 32 distinct banks.
//   * The walk is fg::contract_list (visit_tiles.cuh), the tile the fused
//     visit runs, on the FP32 cores (no tensor cores, no TF32).
// The chain per launch: idx -> col_ptr -> list segment -> walk in shared
// memory -> store.
//
// Numerics: min-plus over the list is the dense min bit for bit (an absent
// entry adds +inf to an exact, order-free min; no fast-math: +inf + w must
// stay +inf, denormals must not flush).  The masked matmul sums the present
// entries in ascending u with fmaf(x, 1, acc) from +0, the bits of the
// dense u = 0..B-1 fmaf(x, finite(w), acc) order for finite x, and of the
// fused visit's spread; it agrees with a float32 matmul to rounding, not
// bitwise.  Its x must be finite (see contract_list).
//
// Bound, at the main path's shapes (Q = 64, B = 128, ~4 entries a column):
// x 32 KB in, 32 KB out per block, and each block's list (8 B an entry
// for min-plus, 4 for the masked matmul, plus 129 starts of 4 B): ~70 KB,
// ~0.02 us at an H100 SXM's data-sheet 3.35 TB/s (700 W limit); a few
// tens of thousands of live (q, u, v) pairs, far less at the FP32 rate.
// Both are far below one launch's latency: the kernel is latency-bound,
// and the design shortens its chain of dependent loads.  Measured by
// chip_smoke.py (phase 3, CUDA graph, L2-warm) on an H100 80GB HBM3 at a
// 700.00 W limit: one min-plus launch takes 0.0023 ms at the road density
// (S = 1 and S = 5 alike), 0.0033 ms with 25 % of the entries finite and
// 0.0049 ms on fully finite blocks; the masked matmul 0.0022 / 0.0030 /
// 0.0043 ms; an empty launch 0.0009 ms.  The gathered form at a baselines
// round's shape (every block of the side-192 grid, S = 1,182, against its
// source partition's rows, X = 288) moves ~50 MB: a bound of ~0.015 ms,
// and ~37,800 CTAs of which ~6 fit an SM (each stages up to 4,096 entries);
// its time is in PERF.md (chip_smoke.py phase 3d).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "visit_tiles.cuh"

namespace {

constexpr int kCols = 32;        // output columns per CTA, one lane each
constexpr int kWarps = 4;        // warps per CTA, each its own query rows
constexpr int kWarpRows = 2;     // query rows of one warp
constexpr int kRows = kWarps * kWarpRows;   // query rows per CTA
constexpr int kThreads = kCols * kWarps;
constexpr int kSegCap = 4096;    // list entries a CTA may stage
constexpr int kSmemDefault = 48 * 1024;
constexpr int kMaxGridZ = 65535;  // the largest gridDim.z a launch takes

// Shared-memory slot of staged entry j: one padding word per 128 entries,
// so the 32 columns of a fully finite 128-wide block start on 32 banks.
__host__ __device__ __forceinline__ int slot(int j) { return j + (j >> 7); }

// A CTA's staged segment of the lists, indexed from the segment's start.
struct SharedEntries {
  const int* u;
  const float* w;
  __device__ __forceinline__ int row(int e) const { return u[slot(e)]; }
  __device__ __forceinline__ float weight(int e) const { return w[slot(e)]; }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One s-slice of a CTA's work: output rows [q0, q0 + kRows) and columns
// [v0, v0 + kCols) of out[s].  Every return is taken by the whole CTA or
// comes after its one __syncthreads.
template <bool kMinPlus, bool kGather>
__device__ __forceinline__ void contract_slice(
    const float* __restrict__ x,
    const int64_t* __restrict__ xrow, const int64_t* __restrict__ idx,
    const int* __restrict__ col_ptr, const int* __restrict__ col_u,
    const float* __restrict__ col_w, float* __restrict__ out, int s, int Q,
    int B, int64_t X, int64_t nblk, int seg_cap) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                                          // [kRows, B]
  int* su = reinterpret_cast<int*>(smem + kRows * B);        // staged u
  float* sw = reinterpret_cast<float*>(su + slot(seg_cap));  // staged w
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int tid = warp * kCols + lane;
  const int v0 = blockIdx.x * kCols, v = v0 + lane;
  const int nv = min(kCols, B - v0);
  const int q0 = blockIdx.y * kRows, nq = min(kRows, Q - q0);
  int64_t k = __ldg(reinterpret_cast<const long long*>(idx) + s);
  int64_t xr = 0;
  if (kGather) {
    xr = __ldg(reinterpret_cast<const long long*>(xrow) + s);
    if (k >= 0 && (xr < 0 || xr >= X)) k = nblk;  // a NaN plane, as past nblk
    if (xr < 0 || xr >= X) xr = 0;                // and no read out of x
  }

  // this CTA's rows of x, in flight while the block index and the bounds
  // load
  const float* xq = x + (xr * Q + q0) * static_cast<int64_t>(B);
  const int n = nq * B;
  if (((reinterpret_cast<uintptr_t>(x) & 15) | (B & 3)) == 0) {
    for (int i = 4 * tid; i < n; i += 4 * kThreads)
      cp_async16(xs + i, xq + i);
  } else {
    for (int i = tid; i < n; i += kThreads) cp_async4(xs + i, xq + i);
  }

  // the warp's query rows [r0, r0 + wq) of the CTA's
  const int r0 = warp * kWarpRows;
  const int wq = min(kWarpRows, nq - r0);
  float* o = out + (static_cast<int64_t>(s) * Q + q0 + r0) * B;
  if (k < 0 || k >= nblk) {          // the whole CTA takes the same branch
    const float fill = k < 0 ? (kMinPlus ? INFINITY : 0.0f) : NAN;
    if (lane < nv)
      for (int r = 0; r < wq; ++r) o[r * B + v] = fill;
    cp_async_wait_all();
    return;
  }

  // every warp loads the bounds of its lanes' columns (the same lines)
  const int* ptr = col_ptr + k * (B + 1);
  int e0 = 0, e1 = 0;
  if (lane < nv) {
    e0 = __ldg(ptr + v);
    e1 = __ldg(ptr + v + 1);
  }
  const int seg0 = __shfl_sync(0xffffffffu, e0, 0);
  const int nseg = __shfl_sync(0xffffffffu, e1, nv - 1) - seg0;
  const bool staged = nseg <= seg_cap;
  if (staged) {
    for (int j = tid; j < nseg; j += kThreads) {
      cp_async4(su + slot(j), col_u + seg0 + j);
      if (kMinPlus) cp_async4(sw + slot(j), col_w + seg0 + j);
    }
  }
  cp_async_wait_all();
  __syncthreads();

  if (lane >= nv || wq <= 0) return;
  float acc[kWarpRows];
#pragma unroll
  for (int r = 0; r < kWarpRows; ++r) acc[r] = kMinPlus ? INFINITY : 0.0f;
  const float* xw = xs + r0 * B;
  if (staged)
    fg::contract_list<kMinPlus, kWarpRows>(acc, xw, B, wq, e0 - seg0,
                                           e1 - seg0, SharedEntries{su, sw});
  else
    fg::contract_list<kMinPlus, kWarpRows>(acc, xw, B, wq, e0, e1,
                                           fg::GlobalEntries{col_u, col_w});
#pragma unroll
  for (int r = 0; r < kWarpRows; ++r) {
    if (r >= wq) break;
    o[r * B + v] = acc[r];
  }
}

template <bool kMinPlus, bool kGather>
__global__ void __launch_bounds__(kThreads)
list_contract_kernel(const float* __restrict__ x,
                     const int64_t* __restrict__ xrow,
                     const int64_t* __restrict__ idx,
                     const int* __restrict__ col_ptr,
                     const int* __restrict__ col_u,
                     const float* __restrict__ col_w, float* __restrict__ out,
                     int S, int Q, int B, int64_t X, int64_t nblk,
                     int seg_cap) {
  if (!kGather) {
    contract_slice<kMinPlus, false>(x, xrow, idx, col_ptr, col_u, col_w, out,
                                    blockIdx.z, Q, B, X, nblk, seg_cap);
    return;
  }
  for (int s = blockIdx.z; s < S; s += gridDim.z) {
    contract_slice<kMinPlus, true>(x, xrow, idx, col_ptr, col_u, col_w, out,
                                   s, Q, B, X, nblk, seg_cap);
    __syncthreads();   // the next slice's copies overwrite shared memory
  }
}

// list entries a CTA stages: no more than the lists hold (a small graph's
// CTAs stay small)
int seg_cap(long long nnz) {
  return static_cast<int>(
      nnz < kSegCap ? (nnz + kCols - 1) / kCols * kCols : kSegCap);
}

// Dynamic shared memory of one CTA: kRows rows of x, then the staged
// segment's rows (and weights, for min-plus).
size_t smem_of(bool minplus, int B, long long nnz) {
  return sizeof(float) * (static_cast<size_t>(kRows) * B +
                          slot(seg_cap(nnz)) * (minplus ? 2 : 1));
}

template <bool kMinPlus>
int launch(const void* x, const void* xrow, const void* idx,
           const void* col_ptr, const void* col_u, const void* col_w,
           void* out, int S, int Q, int B, long long X, long long nblk,
           long long nnz, void* stream) {
  if (S <= 0 || Q <= 0 || B <= 0) return 0;
  const int cap = seg_cap(nnz);
  const size_t smem = smem_of(kMinPlus, B, nnz);
  const bool gather = xrow != nullptr;
  if (!gather && S > kMaxGridZ) return cudaErrorInvalidConfiguration;
  auto kernel = gather ? list_contract_kernel<kMinPlus, true>
                       : list_contract_kernel<kMinPlus, false>;
  // ask for the largest shared-memory carveout once, so several CTAs share
  // an SM when a launch has more CTAs than the card has SMs
  static bool carveout_set[2] = {false, false};
  if (!carveout_set[gather]) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return static_cast<int>(e);
    carveout_set[gather] = true;
  }
  if (smem > kSmemDefault) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((B + kCols - 1) / kCols, (Q + kRows - 1) / kRows,
                  S < kMaxGridZ ? S : kMaxGridZ);
  kernel<<<grid, dim3(kCols, kWarps), smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int64_t*>(xrow),
      static_cast<const int64_t*>(idx), static_cast<const int*>(col_ptr),
      static_cast<const int*>(col_u), static_cast<const float*>(col_w),
      static_cast<float*>(out), S, Q, B, static_cast<int64_t>(X),
      static_cast<int64_t>(nblk), cap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Dynamic shared-memory bytes of one CTA of fg_minplus (minplus != 0) or
// fg_masked_matmul at block size B over lists of nnz entries.
extern "C" long long fg_minplus_smem(int minplus, int B, long long nnz) {
  if (B <= 0 || nnz < 0) return -1;
  return static_cast<long long>(smem_of(minplus != 0, B, nnz));
}

// xrow may be null (every s reads the one x [Q, B]); else x is [X, Q, B].
extern "C" int fg_minplus(const void* x, const void* xrow, const void* idx,
                          const void* col_ptr, const void* col_u,
                          const void* col_w, void* out, int S, int Q, int B,
                          long long X, long long nblk, long long nnz,
                          void* stream) {
  return launch<true>(x, xrow, idx, col_ptr, col_u, col_w, out, S, Q, B, X,
                      nblk, nnz, stream);
}

extern "C" int fg_masked_matmul(const void* x, const void* xrow,
                                const void* idx, const void* col_ptr,
                                const void* col_u, const void* col_w,
                                void* out, int S, int Q, int B, long long X,
                                long long nblk, long long nnz, void* stream) {
  return launch<false>(x, xrow, idx, col_ptr, col_u, col_w, out, S, Q, B, X,
                       nblk, nnz, stream);
}
