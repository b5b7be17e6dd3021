// Hopper (sm_90a) kernel for one ACL push round of personalised PageRank.
//
//   fg_ppr_push  p, r, acc [Q, B], w [B, B] (+inf absent), deg [B] f32
//                -> p1, r1, acc1 [Q, B]:
//                  active = r >= eps*max(deg, 1) & deg > 0
//                  p1     = p + alpha*r*active
//                  push   = (1-alpha)*r*active / max(deg, 1)
//                  r1     = r*(1-active) + push @ isfinite(w)
//                  acc1   = acc + push
//                Replaces the TPU kernel ppr_push_pallas_call
//                (src/repro/kernels/ppr_push/push.py, body _push_kernel,
//                tile push_tile) and the zero Q padding of its ops wrapper.
//
// The round itself is fg::push_round (visit_tiles.cuh).  The fused visit
// kernel (fused_visit.cu) runs its elementwise half (fg::push_cell) for
// every relax round of a push visit and the spread over the block's
// column lists, in the same order; on the engine's path this entry is not
// launched, its round runs inside fg_fused_visit.
//
// Layout: one block of 256 threads per 16 query rows (rows of the spread
// are independent: row q of push @ mask reads only row q of push).  The
// rows' p, r, acc sit in shared memory, and the weight block is kept as its
// finite mask, one bit per entry (2 KB at B = 128 instead of 64 KB of
// floats), built with one warp ballot per 32 columns.  Each thread then
// owns 4x4 output tiles of the spread.  Ragged Q and B are masked.
//
// Numerics: the elementwise half is the plain version's expression order
// with explicitly rounded f32 operations; the spread sums u = 0..B-1 in
// order with fmaf from 0 (the bits of fg_masked_matmul's list order, see
// fg::contract_list), and so agrees with the plain version's float32
// matmul to rounding (rtol 1e-5, atol 2e-6), not bitwise.  alpha, 1 - alpha and eps come in as the f32 values torch uses.
//
// Bound, at the slice's shapes (Q = 64, B = 128): 256 KB moved (three
// [Q, B] planes in and out, 32 KB each, the 64 KB block, the 512 B degree
// row), ~0.08 us at 3.35 TB/s; dense, the spread is Q B^2 = 1.05 M FMAs,
// ~0.03 us at 33.5 T instructions/s.  Bytes bound it, and a launch's
// latency dominates both: chip_smoke.py measured ~0.029 ms per launch on
// an H100 80GB HBM3 at 700 W (4 blocks, each thread a serial chain of B
// shared-memory loads per output tile).  As with the frontier, the design
// answer is to run the round inside the fused visit, where the tiles stay
// in shared memory across rounds.
#include "visit_tiles.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 16;

size_t smem_need(int B) {
  const int ld = fg::round4(B), bw = (ld + 31) / 32;
  return sizeof(float) * (4 * kRows * ld + 3 * ld)
         + sizeof(uint32_t) * static_cast<size_t>(B) * bw
         + static_cast<size_t>(kRows) * ld;
}

__global__ void __launch_bounds__(kThreads)
ppr_push_kernel(const float* __restrict__ p, const float* __restrict__ r,
                const float* __restrict__ acc, const float* __restrict__ w,
                const float* __restrict__ deg, float* __restrict__ po,
                float* __restrict__ ro, float* __restrict__ ao, int Q, int B,
                float alpha, float c1, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = fg::round4(B), bw = (ld + 31) / 32;
  float* P = reinterpret_cast<float*>(smem);
  float* R = P + kRows * ld;
  float* A = R + kRows * ld;
  float* X = A + kRows * ld;
  float* DEG = X + kRows * ld;
  float* DEGC = DEG + ld;
  float* TH = DEGC + ld;
  uint32_t* BITS = reinterpret_cast<uint32_t*>(TH + ld);
  uint8_t* ACT = reinterpret_cast<uint8_t*>(BITS + B * bw);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * kRows, rows = min(kRows, Q - q0);
  for (int v = tid; v < B; v += kThreads) {
    const float dg = deg[v];
    DEG[v] = dg;
    DEGC[v] = fmaxf(dg, 1.0f);
    TH[v] = __fmul_rn(eps, DEGC[v]);
  }
  for (int i = tid; i < kRows * ld; i += kThreads) X[i] = 0.0f;
  for (int i = tid; i < rows * B; i += kThreads) {
    const int q = i / B, v = i % B, o = q * ld + v;
    const int64_t g = static_cast<int64_t>(q0 + q) * B + v;
    P[o] = p[g];
    R[o] = r[g];
    A[o] = acc[g];
  }
  fg::load_mask_bits(BITS, w, B, bw, warp, kThreads / 32, lane);
  __syncthreads();
  for (int i = tid; i < rows * B; i += kThreads) {
    const int q = i / B, v = i % B, o = q * ld + v;
    ACT[o] = fg::push_active(R[o], TH[v], DEG[v] > 0.0f);
  }
  __syncthreads();
  fg::push_round(P, R, A, X, ACT, DEGC, BITS, bw, rows, kRows, B, ld, alpha,
                 c1, tid, kThreads);
  for (int i = tid; i < rows * B; i += kThreads) {
    const int q = i / B, v = i % B, o = q * ld + v;
    const int64_t g = static_cast<int64_t>(q0 + q) * B + v;
    po[g] = P[o];
    ro[g] = R[o];
    ao[g] = A[o];
  }
}

}  // namespace

// Dynamic shared-memory bytes of one CTA of fg_ppr_push at block size B.
extern "C" long long fg_ppr_push_smem(int B) {
  if (B <= 0) return -1;
  return static_cast<long long>(smem_need(B));
}

extern "C" int fg_ppr_push(const void* p, const void* r, const void* acc,
                           const void* w, const void* deg, void* po,
                           void* ro, void* ao, int Q, int B, float alpha,
                           float c1, float eps, void* stream) {
  if (Q <= 0 || B <= 0) return 0;
  const size_t smem = smem_need(B);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ppr_push_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((Q + kRows - 1) / kRows);
  ppr_push_kernel<<<grid, kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(p), static_cast<const float*>(r),
      static_cast<const float*>(acc), static_cast<const float*>(w),
      static_cast<const float*>(deg), static_cast<float*>(po),
      static_cast<float*>(ro), static_cast<float*>(ao), Q, B, alpha, c1,
      eps);
  return static_cast<int>(cudaGetLastError());
}
