// Hopper (sm_90a) kernel for the LM prefill's attention.
//
//   fg_flash_attention  out[b, i, h, :] = softmax_j(q_i . k_j / sqrt(hd)) v_j
//                       over the keys j that query i may see, with
//                       q [B, Sq, H, hd], k/v [B, Skv, Hkv, hd] (GQA:
//                       query head h reads key/value head h / (H / Hkv)).
//                       Replaces the TPU kernel flash_attention_pallas_call
//                       (src/repro/kernels/flash_attention/flash.py, body
//                       _flash_kernel) together with the per-group loop and
//                       the host-side padding of its wrapper
//                       (flash_attention/ops.py, flash_attention and _run).
//
// Masks, by absolute position: query i sits at q_offset + i, key j at j.
// Key j is seen when j < kv_len, and j <= q_pos when causal, and
// j > q_pos - window when window > 0.  Masked scores are -1e9 (never -inf,
// so exp() stays NaN-free) and take no probability mass.  The TPU kernel
// fixes q_offset = 0; the chunked prefill reaches the same attention with a
// q_offset (its second chunk attends against the cache filled so far), so
// the offset is an argument here.
//
// Layout: one block of 256 threads per (q-tile of 64 rows, query head,
// batch), all of GQA in one launch.  The block keeps its q tile (as f32,
// pre-scaled by 1/sqrt(hd) like flash.py's kernel, transposed) and its
// accumulator resident, and streams the keys and values through shared
// memory 64 rows at a time with the (m, l, acc) online-softmax carry.  Each
// thread owns 4 query rows by 4 keys of a score tile and 4 rows by hd/16
// columns of the accumulator.  The ragged Sq and Skv edges are masked in
// the kernel (zero-filled rows, no host padding); k and v may be strided
// views (a prefix of a KV cache).  Chunks that lie wholly above the causal
// diagonal, below the window or past kv_len are skipped: for a query row a
// fully masked chunk leaves m, l and acc bit-unchanged (r = exp(0) = 1,
// p = 0), so skipping is exact.  The q tiles are issued heaviest first
// (causal work grows with the tile index), so the last wave is light.
//
// Numerics: float32 math on inputs of any dtype (f32 or bf16 here); expf,
// not __expf; no fast-math and -fmad=false from the build, so the products
// and sums round where written, except the dot products and the P.V sum,
// which are explicit fmaf.  Output acc / max(l, 1e-30) in the input dtype
// (round to nearest even for bf16).  It agrees with the plain PyTorch
// version to rounding: the sums run in another order.
//
// Bound, at the serving path's shapes (starcoder2-7b prefill: H = 36,
// Hkv = 4, hd = 128, S = 4096, bf16): causal attention needs
// 4 * H * hd * S(S+1)/2 = 154.7 GFLOP against ~84 MB moved (q, k, v read
// once, out written once), ~1,840 FLOP per byte, so it is compute-bound.
// On an H100 SXM (data sheet, 700 W) the bf16 tensor cores would need
// >= 0.156 ms; this design runs on the FP32 cores (67 TFLOP/s counting an
// FMA as two), so it cannot beat ~2.3 ms.  Tensor cores (wgmma on bf16
// tiles), TMA loads and warp specialisation are later work; rounding q and
// p to bf16 for the MMA would also change the numbers.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kQT = 64;           // query rows per block
constexpr int kKC = 64;           // key/value rows per chunk
constexpr int kLD = kQT + 4;      // leading dim of the transposed tiles
constexpr int kThreads = 256;     // 16 x 16 threads
constexpr float kNeg = -1e9f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

template <int HD>
constexpr int smem_floats() {
  // q tile [HD][kLD]; k chunk [HD][kLD], reused for the v chunk
  // [kKC][HD]; probabilities [kKC][kLD]
  return 2 * HD * kLD + kKC * kLD;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 2)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int Sq, int Skv,
             int H, int group, long long q_bs, long long q_ss,
             long long kv_bs, long long kv_ss, int q_offset, int kv_len,
             int causal, int window, float scale) {
  static_assert(HD % 4 == 0, "head dim must be a multiple of 4");
  constexpr int NG = (HD / 4 + 15) / 16;   // float4 column groups / thread
  constexpr int kLoads = kKC * HD / kThreads;
  extern __shared__ float4 smem4[];
  float* const qT = reinterpret_cast<float*>(smem4);
  float* const kv = qT + HD * kLD;
  float* const pT = kv + HD * kLD;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kQT;
  const int h = blockIdx.y, b = blockIdx.z;
  const T* const qb = q + b * q_bs + static_cast<long long>(h) * HD;
  const T* const kb = k + b * kv_bs + static_cast<long long>(h / group) * HD;
  const T* const vb = v + b * kv_bs + static_cast<long long>(h / group) * HD;

#pragma unroll 8
  for (int it = 0; it < kLoads; ++it) {
    const int i = tid + it * kThreads;
    const int r = i / HD, d = i - r * HD;
    float x = 0.f;
    if (q0 + r < Sq) x = __fmul_rn(to_f32(qb[(q0 + r) * q_ss + d]), scale);
    qT[d * kLD + r] = x;
  }

  // the chunks this tile needs
  const int q_last = min(q0 + kQT, Sq) - 1;
  int kv_end = min(kv_len, Skv);
  if (causal) kv_end = min(kv_end, q_offset + q_last + 1);
  int c_begin = 0;
  if (window > 0) c_begin = max(0, q_offset + q0 - window + 1) / kKC * kKC;

  float m[4], l[4], acc[4][NG * 4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NG * 4; ++c) acc[i][c] = 0.f;
  }

  for (int c0 = c_begin; c0 < kv_end; c0 += kKC) {
    __syncthreads();   // the q tile is written; the last chunk is consumed
#pragma unroll 8
    for (int it = 0; it < kLoads; ++it) {
      const int i = tid + it * kThreads;
      const int r = i / HD, d = i - r * HD;
      const int j = c0 + r;
      kv[d * kLD + r] = j < Skv ? to_f32(kb[j * kv_ss + d]) : 0.f;
    }
    __syncthreads();

    // scores of rows ty*4 + i against keys c0 + tx*4 + j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qT + d * kLD + ty * 4);
      const float4 c = *reinterpret_cast<const float4*>(kv + d * kLD + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }

    // masks and the online-softmax update of each row
    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q_offset + q0 + ty * 4 + i;
      bool ok[4];
      float mj = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = c0 + tx * 4 + j;
        ok[j] = kp < kv_len && (!causal || kp <= qp) &&
                (window <= 0 || kp > qp - window);
        if (!ok[j]) s[i][j] = kNeg;
        mj = fmaxf(mj, s[i][j]);
      }
      mj = row_max(mj);
      const float mn = fmaxf(m[i], mj);
      const float r = expf(__fsub_rn(m[i], mn));
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[i][j] = ok[j] ? expf(__fsub_rn(s[i][j], mn)) : 0.f;
        rs = __fadd_rn(rs, p[i][j]);
      }
      rs = row_sum(rs);
      l[i] = __fadd_rn(__fmul_rn(l[i], r), rs);
#pragma unroll
      for (int c = 0; c < NG * 4; ++c) acc[i][c] = __fmul_rn(acc[i][c], r);
      m[i] = mn;
    }
    __syncthreads();   // every warp is done with the k chunk

#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(pT + (tx * 4 + j) * kLD + ty * 4) =
          make_float4(p[0][j], p[1][j], p[2][j], p[3][j]);
#pragma unroll 8
    for (int it = 0; it < kLoads; ++it) {
      const int i = tid + it * kThreads;
      const int r = i / HD, d = i - r * HD;
      const int j = c0 + r;
      kv[r * HD + d] = j < Skv ? to_f32(vb[j * kv_ss + d]) : 0.f;
    }
    __syncthreads();

    // acc += P V over the chunk's keys
#pragma unroll 4
    for (int c = 0; c < kKC; ++c) {
      const float4 a = *reinterpret_cast<const float4*>(pT + c * kLD + ty * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const int col = (tx + 16 * g) * 4;
        if (col < HD) {
          const float4 w = *reinterpret_cast<const float4*>(kv + c * HD + col);
          const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int jj = 0; jj < 4; ++jj)
              acc[i][g * 4 + jj] = fmaf(av[i], wv[jj], acc[i][g * 4 + jj]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* const o = out + ((static_cast<long long>(b) * Sq + row) * H + h) * HD;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int col = (tx + 16 * g) * 4;
      if (col < HD) {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          put(o + col + jj, __fdiv_rn(acc[i][g * 4 + jj], den));
      }
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Skv, int H, int Hkv, long long q_bs, long long q_ss,
           long long kv_bs, long long kv_ss, int q_offset, int kv_len,
           int causal, int window, float scale, cudaStream_t stream) {
  constexpr int kSmem = smem_floats<HD>() * static_cast<int>(sizeof(float));
  // the attribute is set once per device, before any launch of this
  // instantiation there (so never inside a stream capture)
  static bool configured[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(flash_kernel<T, HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured[dev] = true;
  }
  const dim3 grid((Sq + kQT - 1) / kQT, H, B);
  flash_kernel<T, HD><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Skv, H, H / Hkv,
      q_bs, q_ss, kv_bs, kv_ss, q_offset, kv_len, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(int hd, const void* q, const void* k, const void* v, void* out,
              int B, int Sq, int Skv, int H, int Hkv, long long q_bs,
              long long q_ss, long long kv_bs, long long kv_ss, int q_offset,
              int kv_len, int causal, int window, float scale,
              cudaStream_t s) {
#define FG_HD(N)                                                          \
  case N:                                                                 \
    return launch<T, N>(q, k, v, out, B, Sq, Skv, H, Hkv, q_bs, q_ss,     \
                        kv_bs, kv_ss, q_offset, kv_len, causal, window,   \
                        scale, s);
  switch (hd) {
    FG_HD(16)
    FG_HD(32)
    FG_HD(64)
    FG_HD(128)
    FG_HD(160)
    FG_HD(256)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FG_HD
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  Strides are in elements; each (heads, hd)
// row block must be contiguous.  Returns a cudaError_t (0 on success).
extern "C" int fg_flash_attention(const void* q, const void* k,
                                  const void* v, void* out, int dtype, int B,
                                  int Sq, int Skv, int H, int Hkv, int hd,
                                  long long q_bs, long long q_ss,
                                  long long kv_bs, long long kv_ss,
                                  int q_offset, int kv_len, int causal,
                                  int window, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || B > 65535 ||
      H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_hd<float>(hd, q, k, v, out, B, Sq, Skv, H, Hkv, q_bs, q_ss,
                            kv_bs, kv_ss, q_offset, kv_len, causal, window,
                            scale, s);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(hd, q, k, v, out, B, Sq, Skv, H, Hkv,
                                    q_bs, q_ss, kv_bs, kv_ss, q_offset,
                                    kv_len, causal, window, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
