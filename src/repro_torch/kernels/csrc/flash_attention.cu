// Hopper (sm_90a) kernels for the LM prefill's attention.
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
// The dtype picks the kernel, by a fixed rule: bf16 inputs run
// flash_tc_kernel on the tensor cores, float32 inputs flash_fp32_kernel on
// the FP32 cores (wgmma would take float32 as TF32).  A bf16 call the
// tensor-core kernel cannot take returns an error; nothing falls back.
//
// Masks, by absolute position (both kernels): query i sits at q_offset + i,
// key j at j.  Key j is seen when j < kv_len and either j < prefix_len (the
// prefix-LM mask: a vlm's image positions, seen by every query) or both
// j <= q_pos when causal and j > q_pos - window when window > 0 (the
// reference's ((causal and window) or prefix) and kv_len; prefix_len 0 is
// none).  Masked keys take exactly zero
// probability and a query that sees no key writes 0.  The TPU kernel fixes
// q_offset = 0; the chunked prefill attends its second chunk against the
// cache filled so far, so the offset is an argument here.  k and v may be
// strided views (a prefix of a KV cache); the ragged Sq and Skv edges need
// no host padding.  Chunks that lie wholly above the causal diagonal (and
// past prefix_len), below the window (with no prefix) or past kv_len are
// skipped: for a query row a fully masked chunk leaves m, l and acc
// bit-unchanged (r = 1 exactly, p = 0), so skipping is exact.  q tiles are
// issued heaviest first (causal work grows with the tile index), so the
// last wave is light.  One launch per call,
// all of GQA in it, and no atomics (the float32 kernel's key splits merge
// in a fixed order), so a call's bits do not depend on scheduling or on
// the strides of k and v.
//
// Bound, at the serving path's shapes (starcoder2-7b prefill: H = 36,
// Hkv = 4, hd = 128, S = 4096, bf16): causal attention needs
// 4 * H * hd * S(S+1)/2 = 154.7 GFLOP against ~84 MB moved (q, k, v read
// once, out written once), ~1,840 FLOP per byte: operation-bound.  On an
// H100 SXM (data sheet, 700 W) the bf16 tensor cores need >= 0.156 ms; the
// FP32 cores (67 TFLOP/s counting an FMA as two) >= 2.3 ms.  The hybrid
// family's window (recurrentgemma-2b: H = 10, Hkv = 1, hd = 256, window
// 2048) caps each query at 2048 keys, so its work grows linearly in S:
// about 4 * H * hd * S * 2048 FLOP, operation-bound too.
//
// flash_tc_kernel (bf16), shaped after FlashAttention-3 for this card:
//   - Persistent blocks of 384 threads, one per SM (the shared memory
//     allows no more), each walking the work tiles blockIdx.x + i *
//     gridDim.x; a tile is 128 query rows of one head and batch, and tiles
//     are numbered heaviest first.  Warpgroup 0 is the producer: after
//     setmaxnreg lowers its registers, one thread issues TMA loads
//     (cp.async.bulk.tensor, 4-D maps over (hd, heads, S, B) with the
//     tensors' own strides, encoded on the host per call): each tile's q
//     once, into a slot with its own full/empty mbarriers so the next
//     tile's q lands under this tile's last P V and store, and K and V
//     chunks of KC = 128 keys (64 at hd 256) through a ring of 3 stages (2
//     at hd 160 and 256) with
//     full/empty mbarriers, K and V apart, so a stage's K is refilled once
//     its S is done.  Warpgroups 1 and 2 are consumers with raised
//     registers, 64 query rows each.
//   - S = Q K^T is wgmma m64nKCk16 with both operands in shared memory
//     (K-major, hd split into swizzle-wide column blocks: 64 columns with
//     the 128-byte swizzle at hd 64/128, 32 with the 64-byte one at hd 160,
//     16 with the 32-byte one at hd 16, the same mode in the TMA map and
//     the wgmma descriptor).  O += P V is wgmma m64n(hd)k16 with P in
//     registers and V read MN-major through the descriptor's transpose bit
//     (no transposed copy).  The sums stay in registers.
//   - Inside a consumer, chunk j's S is issued beside chunk j-1's P V, and
//     chunk j's softmax runs while that P V is on the tensor cores; O is
//     rescaled once the P V is done.  The two consumers take turns to
//     issue their products (two named barriers), so one's softmax runs
//     under the other's products.
//   - TMA zero-fills rows past Sq or Skv; rows past Sq are never stored,
//     keys past Skv are masked (kv_len <= Skv).  The mask is applied only
//     on chunks that need it (the diagonal, the window edge, the kv_len
//     edge); interior chunks run unmasked.  A consumer drains, without
//     computing, the chunks none of its rows sees.
//   - Design limits, at hd 128: q (32 KB) plus 3 stages of K+V (3 x 64 KB)
//     is 224 KB of the 227 KB a block may use, one block per SM; a
//     consumer holds S (64 floats), O (64) and P (32 bf16 pairs) in
//     registers.  At hd 256 a 128-key stage of K+V alone is 128 KB, so the
//     chunk is 64 keys: q (64 KB) plus 2 stages of K+V (2 x 64 KB) is 192
//     KB, and a consumer holds S (32 floats), O (128: P V is m64n256k16)
//     and P (16 pairs), as many as at hd 160.
// Numerics (bf16): q . k takes the bf16 values exactly and sums in f32 on
// the tensor cores; 1/sqrt(hd) is applied to S in f32 after the product,
// folded with log2(e): p = 2^(s * c - m * c) (one fmaf, then the hardware's
// ex2.approx, relative error ~2^-22, subnormal p flushed to 0), c =
// log2(e) / sqrt(hd), m the running row max of the unscaled s; the rescale
// r = 2^(m_old * c - m_new * c) is exactly 1 while the max holds.  l sums
// the f32 p; p is rounded to bf16 (nearest even) only as the operand of
// P V.  Output acc / max(l, 1e-30), rounded to nearest even.  Against
// float32 math this moves an output by at most ~2^-9 max|v| (p's rounding)
// plus the output's own rounding.  The build keeps -fmad=false; fused
// multiply-adds are the explicit fmaf calls.
//
// flash_fp32_kernel (float32), shaped for the FP32 cores: no tensor-core
// instruction touches float32 data (wgmma would round it to TF32).  Bound:
// 2 hd FMAs per (query, key) pair the mask passes, at the FP32 cores' 67
// TFLOP/s (starcoder2-7b's 4096-token causal prefill, 36 heads of 128:
// >= 2.3 ms), far above its bytes.  So the design keeps the FMA pipes fed,
// with few instructions beside the FMAs and enough warps to hide latency:
//   - A block holds a 64-row q tile and walks 64-key chunks.  At hd 128,
//     128 threads (8 row groups x 16 lanes), 8 query rows a thread, two
//     blocks an SM; at the other head dims 256 threads (16 x 16), 4 rows a
//     thread, two blocks an SM up to hd 64 and one above.  A thread holds
//     its R rows by 4 keys of a chunk's scores and the same rows by 4 *
//     ceil(hd / 64) head-dim columns of the output: per 16-byte shared
//     load 10.7 (R = 8) or 8 FMAs in S = Q K^T, 16 or 12.8 in P V.  Row i
//     of a thread is ty + NRG i (NRG row groups), its keys 4 tx .. 4 tx +
//     3, its columns 4 (tx + 16 g) ..; an accumulator's next fmaf is R x 4
//     fmafs on.
//   - q (pre-scaled by 1/sqrt(hd), as flash.py's kernel does) and K stay
//     row-major in shared memory, each row's 16-byte units XOR-swizzled
//     (q by row & 7: a warp's two row groups read adjacent rows; K by
//     (row >> 2) & 7: a row group's lanes read rows 4 apart), so those
//     reads hit distinct banks with no padding; one xor a step of four
//     units.  V is row-major and read along its rows.  P goes through
//     shared memory as [key][row], each thread's rows in 16-byte units
//     swizzled by (key >> 2) & 7; a warp's rows are its own.
//   - K and V chunks arrive by 16-byte cp.async (4-byte where a base or a
//     stride is not 16-byte aligned; the strided views of a cache prefix
//     are read in place), zero-filled past Skv.  Two stages of each where
//     they fit (hd 16, 64, 160): chunk j + 1 lands under chunk j's
//     products, one barrier a chunk.  One of each at hd 128 (two blocks of
//     114,688 B an SM) and hd 256 (64 + 3 x 64 KB): V j lands under S j,
//     K j + 1 under P V j, two barriers a chunk.  A chunk that every row
//     of the tile sees whole skips the mask; p is selected, not branched
//     around.
//   - The grid walks (q tile, head) pairs heaviest q tile first across all
//     heads, so a causal grid's last wave holds the lightest tiles.  The
//     keys are split to fill the card: the host picks `splits` (1, 2, 4 or
//     8; kernels/flash_attention/ops.fp32_splits) from the shapes so that
//     the grid holds about two blocks for each one the SMs hold at once;
//     the splits of one pair are the CTAs of one thread-block cluster.
//     Each runs the online softmax over its fixed share of the tile's
//     chunks, then the cluster merges (m, l, acc) through distributed
//     shared memory, always in cluster-rank order, each CTA writing 64 /
//     splits rows.  One launch, no atomics, no second pass.
//   - Numerics: explicit fmaf (the build keeps -fmad=false), accurate expf,
//     masked scores held at -1e9 with p = 0.  The sums run in a fixed
//     order: q . k over d in order, a row's p over a lane's 4 keys and then
//     its 16 lanes (xor butterfly), p v over the keys in order, splits in
//     rank order.  A split that sees no key keeps m = -1e9, l = 0, acc
//     = 0 and weighs 0 in the merge; a row that sees no key writes 0.  It
//     agrees with the plain PyTorch version to the order of the sums
//     (ref.flash_attention_split_ref models the splits).
//     What is left on the table at hd 128 (about 60 % of the bound, PERF.md
//     section 6): a thread's tile is as large as its registers allow, so an
//     SM runs 8 warps, and a third of their issue slots go unused.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// float32: the FP32-core kernel

constexpr int kQT = 64;           // query rows a block
constexpr int kKC = 64;           // key/value rows per chunk
constexpr int kThreads = 256;     // threads a block: 16 row groups x 16 lanes
constexpr int kThreadsWide = 128; // at hd 128: 8 row groups of 8 rows
constexpr int kMaxSplits = 8;     // key splits: the portable cluster size
constexpr float kNeg = -1e9f;

// The float32 kernel's tiles at head dim HD.  Shared memory, in floats:
// the q tile [QT][HD] | NS stages of K [kKC][HD] | NS stages of V
// [kKC][HD] | P [kKC][QT].  114,688 B at hd 128 (two blocks an SM),
// 212,992 B at hd 256.
template <int HD>
struct F32Shape {
  static constexpr int T = HD == 128 ? kThreadsWide : kThreads;
  static constexpr int NRG = T / 16;                // row groups
  static constexpr int QT = kQT;
  static constexpr int R = QT / NRG;                // query rows a thread
  static constexpr int C = kKC / 16;                // keys a thread
  static constexpr int NG = (HD + 63) / 64;         // column blocks a thread
  static constexpr int V4 = HD / 4;                 // 16-byte units a row
  static constexpr int SW = (V4 < 8 ? V4 : 8) - 1;  // swizzle mask
  // K and V stages: two where two blocks (one at hd 160) fit an SM with
  // them, else one
  static constexpr int NS = HD == 128 || HD == 256 ? 1 : 2;
  static constexpr int PLD = QT;                    // P's leading dim
  static constexpr int kK = QT * HD;                // offsets, in floats
  static constexpr int kV = kK + NS * kKC * HD;
  static constexpr int kP = kV + NS * kKC * HD;
  static constexpr int kSmem = (kP + kKC * PLD) * 4;
  // blocks an SM: two up to hd 128, where their shared memory fits, else
  // one
  static constexpr int MB = HD <= 128 ? 2 : 1;
  static_assert(HD % 16 == 0, "head dim must be a multiple of 16");
  static_assert(kSmem <= 232448 && MB * (kSmem + 1024) <= 233472,
                "shared memory: a block's, and an SM's for MB blocks");
  static_assert(NRG % 8 == 0 && R % 4 == 0, "the swizzle and P's runs");
  // the merge's partial acc [QT][HD] fits in the K and V stages, its m, l,
  // weights and denominators in P
  static_assert(QT * HD <= kP - kK && 4 * QT <= kKC * PLD, "merge buffers");
};

// the float offset of 16-byte unit c4 of row `row` in the swizzled q tile
// (a warp's two row groups read adjacent rows) and K chunk (a row group's
// 16 lanes read 4 adjacent rows each)
template <int HD>
__device__ __forceinline__ int swz(int row, int c4) {
  return row * HD + ((c4 ^ (row & F32Shape<HD>::SW)) << 2);
}

template <int HD>
__device__ __forceinline__ int swz_k(int row, int c4) {
  return row * HD + ((c4 ^ ((row >> 2) & F32Shape<HD>::SW)) << 2);
}

__device__ __forceinline__ float lane4(const float4& x, int e) {
  return e == 0 ? x.x : (e == 1 ? x.y : (e == 2 ? x.z : x.w));
}

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// cp.async of 16 or 4 bytes; the z forms with `full` false zero-fill the
// destination (src is then not read)
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16z(float* dst, const float* src,
                                            bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4z(float* dst, const float* src,
                                           bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(full ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ unsigned cluster_ctarank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of every CTA of the cluster arrives and waits; shared-memory
// writes before it are visible to the cluster's reads after it.
__device__ __forceinline__ void cluster_sync_all() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The address of `p` (in this CTA's shared memory) in CTA `rank`'s.
__device__ __forceinline__ const float* map_rank(const float* p,
                                                 unsigned rank) {
  uint64_t r;
  asm volatile("mapa.u64 %0, %1, %2;\n"
               : "=l"(r)
               : "l"(reinterpret_cast<uint64_t>(p)), "r"(rank));
  return reinterpret_cast<const float*>(r);
}

// Keys c0 .. c0 + kKC - 1 of one head of x (row stride ss) into dst:
// swizzled rows (K, swz_k) or plain rows (V), zero past Skv.  Asynchronous: the
// caller commits the group and waits for it.
template <int HD, bool SWZ>
__device__ __forceinline__ void load_chunk(float* dst, const float* x,
                                           long long ss, int c0, int Skv,
                                           bool vec, int tid) {
  using Sh = F32Shape<HD>;
  if (vec && Sh::T % Sh::V4 == 0) {
    // a thread copies one 16-byte unit of rows r0, r0 + RP, ...: one
    // pointer step a copy, and no test while the chunk ends before Skv
    constexpr int RP = Sh::T % Sh::V4 == 0 ? Sh::T / Sh::V4 : 1;
    const int r0 = tid / Sh::V4, c4 = tid - r0 * Sh::V4;
    const float* src = x + (c0 + r0) * ss + 4 * c4;
    const long long step = RP * ss;
    if (c0 + kKC <= Skv) {
#pragma unroll
      for (int it = 0; it < kKC / RP; ++it, src += step) {
        const int r = r0 + it * RP;
        cp_async16(dst + (SWZ ? swz_k<HD>(r, c4) : r * HD + 4 * c4), src);
      }
    } else {
#pragma unroll
      for (int it = 0; it < kKC / RP; ++it, src += step) {
        const int r = r0 + it * RP;
        const bool in = c0 + r < Skv;
        cp_async16z(dst + (SWZ ? swz_k<HD>(r, c4) : r * HD + 4 * c4),
                    in ? src : x, in);
      }
    }
  } else if (vec) {
#pragma unroll
    for (int it = 0; it < kKC * Sh::V4 / Sh::T; ++it) {
      const int e = tid + it * Sh::T;
      const int r = e / Sh::V4, c4 = e - r * Sh::V4;
      const bool in = c0 + r < Skv;
      cp_async16z(dst + (SWZ ? swz_k<HD>(r, c4) : r * HD + 4 * c4),
                  x + (in ? c0 + r : c0) * ss + 4 * c4, in);
    }
  } else {
#pragma unroll 4
    for (int it = 0; it < kKC * HD / Sh::T; ++it) {
      const int e = tid + it * Sh::T;
      const int r = e / HD, c = e - r * HD;
      const bool in = c0 + r < Skv;
      cp_async4z(dst + (SWZ ? swz_k<HD>(r, c >> 2) + (c & 3) : r * HD + c),
                 x + (in ? c0 + r : c0) * ss + c, in);
    }
  }
}

// The online-softmax update of a thread's R rows over one chunk's scores
// s (masked in place when MASK), into p; a chunk every (query, key) pair of
// which the mask passes runs with MASK false.
template <int R, int C, int NA, int NRG, bool MASK>
__device__ __forceinline__ void softmax_chunk(
    float (&s)[R][C], float (&p)[R][C], float (&m)[R], float (&l)[R],
    float (&acc)[R][NA], int qp0, int kp0, int kv_len, int causal,
    int window, int prefix_len) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qp = qp0 + NRG * i;
    bool ok[C];
    float mj = kNeg;
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const int kp = kp0 + j;
      ok[j] = !MASK ||
              (kp < kv_len &&
               (kp < prefix_len || ((!causal || kp <= qp) &&
                                    (window <= 0 || kp > qp - window))));
      if (!ok[j]) s[i][j] = kNeg;
      mj = fmaxf(mj, s[i][j]);
    }
    mj = row_max16(mj);
    const float mn = fmaxf(m[i], mj);
    const float r = expf(__fsub_rn(m[i], mn));
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < C; ++j) {
      // a masked score is -1e9: its exp is 0 unless the whole row is
      // masked so far (mn = -1e9), hence the select
      const float e = expf(__fsub_rn(s[i][j], mn));
      p[i][j] = ok[j] ? e : 0.f;
      rs = __fadd_rn(rs, p[i][j]);
    }
    rs = row_sum16(rs);
    l[i] = __fadd_rn(__fmul_rn(l[i], r), rs);
#pragma unroll
    for (int c = 0; c < NA; ++c) acc[i][c] = __fmul_rn(acc[i][c], r);
    m[i] = mn;
  }
}

template <int HD>
__global__ void __launch_bounds__(F32Shape<HD>::T, F32Shape<HD>::MB)
flash_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ out,
                  int Sq, int Skv, int H, int group, long long q_bs,
                  long long q_ss, long long kv_bs, long long kv_ss,
                  int q_offset, int kv_len, int causal, int window,
                  int prefix_len, float scale, int splits, int vec) {
  using Sh = F32Shape<HD>;
  constexpr int R = Sh::R, QT = Sh::QT, C = Sh::C, NG = Sh::NG;
  constexpr int V4 = Sh::V4, NS = Sh::NS, PLD = Sh::PLD, T = Sh::T;
  constexpr int NRG = Sh::NRG;
  extern __shared__ float4 smem4[];
  float* const qs = reinterpret_cast<float*>(smem4);
  float* const ks = qs + Sh::kK;
  float* const vs = qs + Sh::kV;
  float* const ps = qs + Sh::kP;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  // blockIdx.x walks (q tile, head) pairs heaviest tile first across all
  // heads, `splits` CTAs (one cluster) a pair; blockIdx.y is the batch
  const int rank = splits > 1 ? static_cast<int>(cluster_ctarank()) : 0;
  const int pair = static_cast<int>(blockIdx.x) / splits;
  const int n_tiles = gridDim.x / splits / H;
  const int q0 = (n_tiles - 1 - pair / H) * QT;
  const int h = pair % H, b = blockIdx.y;
  const float* const qb = q + b * q_bs + static_cast<long long>(h) * HD;
  const long long kvh = static_cast<long long>(h / group) * HD;
  const float* const kb = k + b * kv_bs + kvh;
  const float* const vb = v + b * kv_bs + kvh;
  const bool kvec = vec & 1, qvec = vec & 2;

  // the chunks this tile needs (a causal tile also walks the prefix), and
  // this split's fixed share of them
  const int q_last = min(q0 + QT, Sq) - 1;
  const int kv_hi = min(kv_len, Skv);
  int kv_end = kv_hi;
  if (causal)
    kv_end = max(min(kv_hi, q_offset + q_last + 1), min(prefix_len, kv_hi));
  int c_begin = 0;
  if (window > 0 && prefix_len <= 0)
    c_begin = max(0, q_offset + q0 - window + 1) / kKC * kKC;
  const int n_chunks = kv_end > c_begin ? (kv_end - c_begin + kKC - 1) / kKC
                                        : 0;
  const int first = n_chunks * rank / splits;
  const int n_my = n_chunks * (rank + 1) / splits - first;
  const int lo = c_begin + first * kKC;

  if (n_my > 0) {
    load_chunk<HD, true>(ks, kb, kv_ss, lo, Skv, kvec, tid);
    if (NS == 2) load_chunk<HD, false>(vs, vb, kv_ss, lo, Skv, kvec, tid);
    cp_async_commit();
  }
  // the q tile, pre-scaled, zero past Sq
  if (qvec) {
#pragma unroll 4
    for (int it = 0; it < QT * V4 / T; ++it) {
      const int e = tid + it * T;
      const int r = e / V4, c4 = e - r * V4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (q0 + r < Sq) {
        x = *reinterpret_cast<const float4*>(qb + (q0 + r) * q_ss + 4 * c4);
        x = make_float4(__fmul_rn(x.x, scale), __fmul_rn(x.y, scale),
                        __fmul_rn(x.z, scale), __fmul_rn(x.w, scale));
      }
      *reinterpret_cast<float4*>(qs + swz<HD>(r, c4)) = x;
    }
  } else {
#pragma unroll 4
    for (int it = 0; it < QT * HD / T; ++it) {
      const int e = tid + it * T;
      const int r = e / HD, c = e - r * HD;
      qs[swz<HD>(r, c >> 2) + (c & 3)] =
          q0 + r < Sq ? __fmul_rn(qb[(q0 + r) * q_ss + c], scale) : 0.f;
    }
  }

  float m[R], l[R], acc[R][NG * 4];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NG * 4; ++c) acc[i][c] = 0.f;
  }
  const int sq = ty & Sh::SW, sk = tx & Sh::SW;

  for (int it = 0; it < n_my; ++it) {
    const int c0 = lo + it * kKC;
    const int slot = NS == 2 ? (it & 1) : 0;
    const float* const kc = ks + slot * kKC * HD;
    const float* const vc = vs + slot * kKC * HD;
    cp_async_wait_all();
    __syncthreads();   // chunk it landed; every warp is done with it - 1
    if (NS == 2) {
      if (it + 1 < n_my) {
        load_chunk<HD, true>(ks + (slot ^ 1) * kKC * HD, kb, kv_ss,
                             c0 + kKC, Skv, kvec, tid);
        load_chunk<HD, false>(vs + (slot ^ 1) * kKC * HD, vb, kv_ss,
                              c0 + kKC, Skv, kvec, tid);
        cp_async_commit();
      }
    } else {
      load_chunk<HD, false>(vs, vb, kv_ss, c0, Skv, kvec, tid);
      cp_async_commit();
    }

    // scores of rows ty + NRG i against keys c0 + 4 tx + j
    float s[R][C];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < C; ++j) s[i][j] = 0.f;
    // d4 = 4 m + u: the swizzled unit d4 ^ sq is 4 (m ^ (sq >> 2)) + (u ^
    // (sq & 3)), one xor a step of m and offsets fixed for each u
    const float* const qt = qs + ty * HD;
    const float* const kt = kc + 4 * tx * HD;
#pragma unroll(HD > 160 ? 2 : 1)
    for (int m4 = 0; m4 < V4 / 4; ++m4) {
      const float* const qm = qt + ((m4 ^ (sq >> 2)) << 4);
      const float* const km = kt + ((m4 ^ (sk >> 2)) << 4);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float4 a[R], w[C];
#pragma unroll
        for (int i = 0; i < R; ++i)
          a[i] = *reinterpret_cast<const float4*>(qm + NRG * i * HD +
                                                  ((u ^ (sq & 3)) << 2));
#pragma unroll
        for (int j = 0; j < C; ++j)
          w[j] = *reinterpret_cast<const float4*>(km + j * HD +
                                                  ((u ^ (sk & 3)) << 2));
        // component by component: an accumulator's next fmaf is R * C on
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int i = 0; i < R; ++i)
#pragma unroll
            for (int j = 0; j < C; ++j)
              s[i][j] = fmaf(lane4(a[i], e), lane4(w[j], e), s[i][j]);
      }
    }

    // masks and the online-softmax update of each row: a chunk that every
    // row of the tile sees whole (rows past Sq included) skips the mask
    float p[R][C];
    const bool whole =
        c0 + kKC <= kv_len &&
        (c0 + kKC <= prefix_len ||
         ((!causal || c0 + kKC - 1 <= q_offset + q0) &&
          (window <= 0 || c0 > q_offset + q0 + QT - 1 - window)));
    if (whole)
      softmax_chunk<R, C, NG * 4, NRG, false>(s, p, m, l, acc, 0, 0, 0, 0,
                                              0, 0);
    else
      softmax_chunk<R, C, NG * 4, NRG, true>(s, p, m, l, acc,
                                             q_offset + q0 + ty, c0 + 4 * tx,
                                             kv_len, causal, window,
                                             prefix_len);
    // P [key][row]: a thread's rows 4 hh .. 4 hh + 3 in 16-byte unit
    // NRG hh + ty, xor-swizzled by (key >> 2) & 7 (the 8 lanes that store
    // keys 4 tx + j hit distinct banks)
#pragma unroll
    for (int j = 0; j < C; ++j)
#pragma unroll
      for (int hh = 0; hh < R / 4; ++hh)
        *reinterpret_cast<float4*>(ps + (4 * tx + j) * PLD +
                                   4 * ((NRG * hh + ty) ^ (tx & 7))) =
            make_float4(p[4 * hh][j], p[4 * hh + 1][j], p[4 * hh + 2][j],
                        p[4 * hh + 3][j]);
    if (NS == 1) {
      cp_async_wait_all();   // V landed under S
      __syncthreads();       // ... for every warp, and all are done with K
      if (it + 1 < n_my) {
        load_chunk<HD, true>(ks, kb, kv_ss, c0 + kKC, Skv, kvec, tid);
        cp_async_commit();
      }
    } else {
      __syncwarp();   // a warp's P rows are its own (its two ty)
    }

    // acc += P V over the chunk's keys; key c's swizzle (c >> 2) & 7 is
    // sw | (k >> 2) for c = 8 c8 + k
#pragma unroll 1
    for (int c8 = 0; c8 < kKC / 8; ++c8) {
      const int sw = (2 * c8) & 7;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int c = 8 * c8 + k;
        float4 a[R / 4];
#pragma unroll
        for (int hh = 0; hh < R / 4; ++hh)
          a[hh] = *reinterpret_cast<const float4*>(
              ps + c * PLD + 4 * ((NRG * hh + ty) ^ (sw | (k >> 2))));
#pragma unroll
        for (int g = 0; g < NG; ++g) {
          const int col = (tx + 16 * g) * 4;
          if (col < HD) {
            const float4 w =
                *reinterpret_cast<const float4*>(vc + c * HD + col);
#pragma unroll
            for (int i = 0; i < R; ++i) {
              const float pi = lane4(a[i / 4], i % 4);
              acc[i][4 * g] = fmaf(pi, w.x, acc[i][4 * g]);
              acc[i][4 * g + 1] = fmaf(pi, w.y, acc[i][4 * g + 1]);
              acc[i][4 * g + 2] = fmaf(pi, w.z, acc[i][4 * g + 2]);
              acc[i][4 * g + 3] = fmaf(pi, w.w, acc[i][4 * g + 3]);
            }
          }
        }
      }
    }
  }

  if (splits == 1) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = q0 + ty + NRG * i;
      if (row >= Sq) continue;
      const float den = fmaxf(l[i], 1e-30f);
      float* const o =
          out + ((static_cast<long long>(b) * Sq + row) * H + h) * HD;
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const int col = (tx + 16 * g) * 4;
        if (col < HD)
          *reinterpret_cast<float4*>(o + col) = make_float4(
              __fdiv_rn(acc[i][4 * g], den), __fdiv_rn(acc[i][4 * g + 1], den),
              __fdiv_rn(acc[i][4 * g + 2], den),
              __fdiv_rn(acc[i][4 * g + 3], den));
      }
    }
    return;
  }

  // The merge: each CTA's (m, l, acc) into its shared memory; CTA `rank`
  // then writes rows rank * QT / splits .. of the tile, weighing split t's
  // partial by exp(m_t - M) in rank order.
  __syncthreads();   // every warp is done with the chunk buffers
  float* const pacc = ks;             // [QT][HD]
  float* const pm = ps;               // [QT]
  float* const pl = pm + QT;          // [QT]
  float* const wt = pl + QT;          // [QT / splits][splits]
  float* const den = wt + QT;         // [QT / splits]
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int rl = ty + NRG * i;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int col = (tx + 16 * g) * 4;
      if (col < HD)
        *reinterpret_cast<float4*>(pacc + rl * HD + col) =
            make_float4(acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2],
                        acc[i][4 * g + 3]);
    }
    if (tx == 0) {
      pm[rl] = m[i];
      pl[rl] = l[i];
    }
  }
  cluster_sync_all();
  const int nr = QT / splits, r0 = rank * nr;
  if (tid < nr) {
    float mx = kNeg;
    for (int t = 0; t < splits; ++t)
      mx = fmaxf(mx, map_rank(pm, t)[r0 + tid]);
    float lsum = 0.f;
    for (int t = 0; t < splits; ++t) {
      const float w = expf(__fsub_rn(map_rank(pm, t)[r0 + tid], mx));
      wt[tid * splits + t] = w;
      lsum = __fadd_rn(lsum, __fmul_rn(map_rank(pl, t)[r0 + tid], w));
    }
    den[tid] = fmaxf(lsum, 1e-30f);
  }
  __syncthreads();
  for (int e = tid; e < nr * V4; e += T) {
    const int r = e / V4, c4 = e - r * V4;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int t = 0; t < splits; ++t) {
      const float4 x = *reinterpret_cast<const float4*>(
          map_rank(pacc, t) + (r0 + r) * HD + 4 * c4);
      const float w = wt[r * splits + t];
      o = make_float4(__fadd_rn(o.x, __fmul_rn(x.x, w)),
                      __fadd_rn(o.y, __fmul_rn(x.y, w)),
                      __fadd_rn(o.z, __fmul_rn(x.z, w)),
                      __fadd_rn(o.w, __fmul_rn(x.w, w)));
    }
    const int row = q0 + r0 + r;
    if (row < Sq) {
      const float d = den[r];
      *reinterpret_cast<float4*>(
          out + ((static_cast<long long>(b) * Sq + row) * H + h) * HD +
          4 * c4) = make_float4(__fdiv_rn(o.x, d), __fdiv_rn(o.y, d),
                                __fdiv_rn(o.z, d), __fdiv_rn(o.w, d));
    }
  }
  cluster_sync_all();   // no CTA leaves while another reads its partial
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel

constexpr int kTcRows = 128;      // query rows per block (2 consumer WGs)
constexpr int kTcThreads = 384;   // producer WG + 2 consumer WGs
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

// Column blocks: the head dim is loaded and read in blocks of CB columns,
// one TMA box and one swizzle span each (CB * 2 bytes per row).
template <int HD>
struct TcShape {
  static constexpr int CB = HD % 64 == 0 ? 64 : (HD % 32 == 0 ? 32 : 16);
  static constexpr int NCB = HD / CB;
  static constexpr int RB = CB * 2;                 // bytes per tile row
  // keys per K/V chunk: 128, or 64 at hd 256, where the q tile (64 KB) and
  // two stages of 128-key K and V (4 x 64 KB) would not fit; there S is
  // m64n64 and P V m64n256
  static constexpr int KC = HD > 160 ? 64 : 128;
  static constexpr int kQBytes = kTcRows * HD * 2;  // q tile
  static constexpr int kKVBytes = KC * HD * 2;      // one K or V chunk
  // wgmma descriptor layout type: 1 = 128-byte swizzle, 2 = 64, 3 = 32
  static constexpr int kLayout = CB == 64 ? 1 : (CB == 32 ? 2 : 3);
  // K/V ring depth: 3 stages where they fit beside the q tile (hd <= 128),
  // else 2 (hd 160: 40 + 4 x 40 KB; hd 256: 64 + 4 x 32 KB)
  static constexpr int kStages =
      kQBytes + 3 * 2 * kKVBytes + 128 + 1024 <= 232448 ? 3 : 2;
  // q | K stages | V stages | barriers, every tile 1024-byte aligned (the
  // swizzle pattern repeats every 8 rows)
  static constexpr int kOffK = kQBytes;
  static constexpr int kOffV = kOffK + kStages * kKVBytes;
  static constexpr int kOffBar = kOffV + kStages * kKVBytes;
  static constexpr int kSmem = kOffBar + 128 + 1024;  // + alignment slack
  static_assert(HD % 16 == 0 && HD <= 256, "wgmma n must divide by 16");
  static_assert(kQBytes % 1024 == 0 && kKVBytes % 1024 == 0, "alignment");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Spins until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One 4-D TMA box into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (all in 16-byte units) and the swizzle layout type.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, int layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(layout) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Named barriers over the two consumer warpgroups (256 threads): one
// waits on its id, the other arrives on it.
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// Waits until at most N committed wgmma groups are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across an asynchronous wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&t);
}

// D[64 x 128] (+)= A[64 x 16] . B[128 x 16]^T, A and B K-major in shared
// memory; scale_d = 0 overwrites D
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40,"
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53,"
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 64] (+)= A[64 x 16] . B[64 x 16]^T, A and B K-major in shared
// memory; scale_d = 0 overwrites D (the 64-key chunks of head dim 256)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12,"
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
      "%26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 16] += A[64 x 16] . B[16 x 16], A in registers (bf16 pairs),
// B MN-major in shared memory (transpose bit set)
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 64] += A[64 x 16] . B[16 x 64], A in registers (bf16 pairs),
// B MN-major in shared memory (transpose bit set)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
      "%28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 128] += A[64 x 16] . B[16 x 128], A in registers (bf16 pairs),
// B MN-major in shared memory (transpose bit set)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40,"
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53,"
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 160] += A[64 x 16] . B[16 x 160], A in registers (bf16 pairs),
// B MN-major in shared memory (transpose bit set)
__device__ __forceinline__ void wgmma_rs_n160(float (&d)[80],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40,"
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53,"
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66,"
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
      "}, {%80, %81, %82, %83}, %84, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 256] += A[64 x 16] . B[16 x 256], A in registers (bf16 pairs),
// B MN-major in shared memory (transpose bit set)
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12,"
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38,"
      "%39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51,"
      "%52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64,"
      "%65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77,"
      "%78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90,"
      "%91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116,"
      "%117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (N == 16) {
    wgmma_rs_n16(d, a, db);
  } else if constexpr (N == 64) {
    wgmma_rs_n64(d, a, db);
  } else if constexpr (N == 128) {
    wgmma_rs_n128(d, a, db);
  } else if constexpr (N == 160) {
    wgmma_rs_n160(d, a, db);
  } else {
    static_assert(N == 256, "no wgmma wrapper for this head dim");
    wgmma_rs_n256(d, a, db);
  }
}

// S (+)= Q K^T over one chunk of N keys (N = 128, or 64 at hd 256)
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (N == 128) {
    wgmma_ss_n128(d, da, db, scale_d);
  } else {
    static_assert(N == 64, "no wgmma wrapper for this chunk");
    wgmma_ss_n64(d, da, db, scale_d);
  }
}

// 2^x by the special-function unit (ex2.approx, subnormal results flushed
// to 0): exact at 0 (r = 1 while the max holds) and 0 at -inf (masked p).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// The fixed arguments of one warpgroup's softmax over its 64 rows: where
// its two rows per thread sit, the masks, and the exponent scale.
struct RowCtx {
  int qp_a, qp_b;        // absolute positions of the thread's rows a, b
  int cq;                // the thread's column pair in each 8-key block
  int kv_hi, causal, window, prefix_len;
  float c;               // log2(e) / sqrt(hd)
};

// One chunk's online-softmax step on the scores sc (the m64nKC
// accumulator: slots 4j, 4j+1 are row a, 4j+2, 4j+3 row b, keys c0 + 8j +
// 2cq + {0, 1}).  Masks when `masked`; leaves p (f32) in sc, updates m
// and l, and returns the rescale of rows a and b.
template <int KC>
__device__ __forceinline__ void softmax_chunk(float (&sc)[KC / 2],
                                              const RowCtx& x, int c0,
                                              bool masked, float& m_a,
                                              float& m_b, float& l_a,
                                              float& l_b, float& ra,
                                              float& rb) {
  if (masked) {
#pragma unroll
    for (int j = 0; j < KC / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = c0 + 8 * j + 2 * x.cq + (e & 1);
        const int qp = e < 2 ? x.qp_a : x.qp_b;
        const bool ok =
            kp < x.kv_hi &&
            (kp < x.prefix_len || ((!x.causal || kp <= qp) &&
                                   (x.window <= 0 || kp > qp - x.window)));
        if (!ok) sc[4 * j + e] = -INFINITY;
      }
  }
  float mx_a = m_a, mx_b = m_b;
#pragma unroll
  for (int j = 0; j < KC / 8; ++j) {
    mx_a = fmaxf(mx_a, fmaxf(sc[4 * j], sc[4 * j + 1]));
    mx_b = fmaxf(mx_b, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
  mx_a = quad_max(mx_a);
  mx_b = quad_max(mx_b);
  const float mu_a = mx_a == -INFINITY ? 0.f : __fmul_rn(mx_a, x.c);
  const float mu_b = mx_b == -INFINITY ? 0.f : __fmul_rn(mx_b, x.c);
  ra = ex2(__fsub_rn(__fmul_rn(m_a, x.c), mu_a));
  rb = ex2(__fsub_rn(__fmul_rn(m_b, x.c), mu_b));
  m_a = mx_a;
  m_b = mx_b;
  float ps_a = 0.f, ps_b = 0.f;
#pragma unroll
  for (int j = 0; j < KC / 8; ++j) {
    sc[4 * j] = ex2(fmaf(sc[4 * j], x.c, -mu_a));
    sc[4 * j + 1] = ex2(fmaf(sc[4 * j + 1], x.c, -mu_a));
    sc[4 * j + 2] = ex2(fmaf(sc[4 * j + 2], x.c, -mu_b));
    sc[4 * j + 3] = ex2(fmaf(sc[4 * j + 3], x.c, -mu_b));
    ps_a = __fadd_rn(__fadd_rn(ps_a, sc[4 * j]), sc[4 * j + 1]);
    ps_b = __fadd_rn(__fadd_rn(ps_b, sc[4 * j + 2]), sc[4 * j + 3]);
  }
  l_a = __fadd_rn(__fmul_rn(l_a, ra), ps_a);
  l_b = __fadd_rn(__fmul_rn(l_b, rb), ps_b);
}

// P as the register operand of P V: the accumulator layout of keys
// 16kk..16kk+15 is the A-fragment layout of one k-step.
template <int KC>
__device__ __forceinline__ void pack_p(const float (&sc)[KC / 2],
                                       uint32_t (&pa)[KC / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < KC / 16; ++kk) {
    pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
    pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
    pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
    pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
  }
}

// One work tile: 128 query rows of one head and batch, and the chunks of
// keys its rows need.  Tiles are numbered heaviest first: every head and
// batch of the last q tile (the most causal work), then the one before.
struct Tile {
  int q0, h, b, c_begin, n_chunks;
};

template <int KC>
__device__ __forceinline__ Tile tile_at(int t, int n_qt, int H, int B, int Sq,
                                        int q_offset, int kv_hi, int causal,
                                        int window, int prefix_len) {
  Tile x;
  x.q0 = (n_qt - 1 - t / (H * B)) * kTcRows;
  x.h = t % H;
  x.b = t / H % B;
  const int q_last = min(x.q0 + kTcRows, Sq) - 1;
  // a causal tile also walks the chunks below prefix_len
  const int c_end = causal ? max(min(kv_hi, q_offset + q_last + 1),
                                 min(prefix_len, kv_hi))
                           : kv_hi;
  x.c_begin = window > 0 && prefix_len <= 0
                  ? max(0, q_offset + x.q0 - window + 1) / KC * KC
                  : 0;
  x.n_chunks = c_end > x.c_begin ? (c_end - x.c_begin + KC - 1) / KC : 0;
  return x;
}

template <int HD>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap,
                __nv_bfloat16* __restrict__ out, int B, int Sq, int Skv,
                int H, int group, int q_offset, int kv_len, int causal,
                int window, int prefix_len, float c) {
  using Sh = TcShape<HD>;
  constexpr int NS = Sh::kStages;
  constexpr int KC = Sh::KC;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t s0 = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = s0, k_s = s0 + Sh::kOffK, v_s = s0 + Sh::kOffV;
  // barriers, 8 bytes each: full_q, empty_q, then per stage full_k,
  // full_v, empty_k, empty_v
  const uint32_t full_q = s0 + Sh::kOffBar, empty_q = full_q + 8;
  const uint32_t full_k = full_q + 16, full_v = full_k + 8 * NS;
  const uint32_t empty_k = full_v + 8 * NS, empty_v = empty_k + 8 * NS;

  const int kv_hi = min(kv_len, Skv);
  const int n_qt = (Sq + kTcRows - 1) / kTcRows;
  const int n_tiles = n_qt * H * B;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    mbar_init(empty_q, 2 * 128);             // every consumer thread
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty_k + 8 * s, 2 * 128);
      mbar_init(empty_v + 8 * s, 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: one thread keeps the q slot and the K/V ring full, tile
    // after tile (the block's tiles are blockIdx.x + i * gridDim.x)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      int r = 0;                             // chunks loaded so far
      int ti = 0;
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x, ++ti) {
        const Tile x =
            tile_at<KC>(t, n_qt, H, B, Sq, q_offset, kv_hi, causal, window,
                        prefix_len);
        const int hk = x.h / group;
        mbar_wait(empty_q, (ti & 1) ^ 1);    // the last tile's q consumed
        mbar_expect_tx(full_q, Sh::kQBytes);
#pragma unroll
        for (int cb = 0; cb < Sh::NCB; ++cb)
          tma_load_4d(q_s + cb * kTcRows * Sh::RB, &qmap, full_q,
                      cb * Sh::CB, x.h, x.q0, x.b);
        for (int j = 0; j < x.n_chunks; ++j, ++r) {
          const int s = r % NS;
          const uint32_t free_par = ((r / NS) & 1) ^ 1;
          const int c0 = x.c_begin + j * KC;
          mbar_wait(empty_k + 8 * s, free_par);   // K of the stage consumed
          mbar_expect_tx(full_k + 8 * s, Sh::kKVBytes);
#pragma unroll
          for (int cb = 0; cb < Sh::NCB; ++cb)
            tma_load_4d(k_s + s * Sh::kKVBytes + cb * KC * Sh::RB, &kmap,
                        full_k + 8 * s, cb * Sh::CB, hk, c0, x.b);
          mbar_wait(empty_v + 8 * s, free_par);   // V of the stage consumed
          mbar_expect_tx(full_v + 8 * s, Sh::kKVBytes);
#pragma unroll
          for (int cb = 0; cb < Sh::NCB; ++cb)
            tma_load_4d(v_s + s * Sh::kKVBytes + cb * KC * Sh::RB, &vmap,
                        full_v + 8 * s, cb * Sh::CB, hk, c0, x.b);
        }
      }
    }
  } else {
    // consumers: 64 query rows per warpgroup
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int t_wg = threadIdx.x - 128 * wg;
    const int warp = t_wg / 32, lane = t_wg % 32;
    const int r0 = (wg - 1) * 64;            // the warpgroup's tile rows
    const uint32_t qa = q_s + r0 * Sh::RB;
    // the tensor cores' turn: the two consumers issue their products in
    // alternation, one chunk each (named barrier = own warpgroup index),
    // so one's softmax runs under the other's products
    auto my_turn = [&] { named_sync(wg); };
    auto your_turn = [&] { named_arrive(3 - wg); };
    // ring slot r (stage r % NS, its (r / NS)-th use)
    auto drain = [&](int r) {
      const int s = r % NS;
      const uint32_t par = (r / NS) & 1;
      mbar_wait(full_k + 8 * s, par);
      my_turn();
      your_turn();
      mbar_arrive(empty_k + 8 * s);
      mbar_wait(full_v + 8 * s, par);
      mbar_arrive(empty_v + 8 * s);
    };
    // S = Q K^T over slot r's KC keys, issued (not waited for)
    auto issue_s = [&](int r, float (&sc)[KC / 2]) {
      const int s = r % NS;
      mbar_wait(full_k + 8 * s, (r / NS) & 1);
      const uint32_t ks = k_s + s * Sh::kKVBytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t col = (kk * 16) % Sh::CB * 2;
        const uint32_t blk = (kk * 16) / Sh::CB;
        wgmma_ss<KC>(
            sc,
            make_desc(qa + blk * (kTcRows * Sh::RB) + col, 16, 8 * Sh::RB,
                      Sh::kLayout),
            make_desc(ks + blk * (KC * Sh::RB) + col, 16, 8 * Sh::RB,
                      Sh::kLayout),
            kk > 0);
      }
      wgmma_commit();
    };
    // O += P V over slot r, V read MN-major (16 keys per k-step, the
    // column blocks KC * RB bytes apart), issued (not waited for)
    auto issue_pv = [&](int r, float (&o)[HD / 2],
                        uint32_t (&pa)[KC / 16][4]) {
      const int s = r % NS;
      mbar_wait(full_v + 8 * s, (r / NS) & 1);
      const uint32_t vs = v_s + s * Sh::kKVBytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk)
        wgmma_rs<HD>(o, pa[kk],
                     make_desc(vs + kk * 16 * Sh::RB, KC * Sh::RB,
                               8 * Sh::RB, Sh::kLayout));
      wgmma_commit();
    };

    float o[HD / 2], sc[KC / 2];
    uint32_t pa[KC / 16][4];
    int r = 0;                               // ring slots consumed so far
    int ti = 0;
    if (wg == 2) your_turn();                // warpgroup 1 goes first
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x, ++ti) {
      const Tile x =
          tile_at<KC>(t, n_qt, H, B, Sq, q_offset, kv_hi, causal, window,
                      prefix_len);
      const int row_a = x.q0 + r0 + warp * 16 + lane / 4, row_b = row_a + 8;
      const RowCtx rc = {q_offset + row_a, q_offset + row_b, lane % 4,
                         kv_hi, causal, window, prefix_len, c};
      // the keys any live row of this warpgroup sees, [lo, hi), and the
      // chunks [j_lo, j_hi) that hold them; the others are only drained
      const int w_first = x.q0 + r0, w_last = min(x.q0 + r0 + 63, Sq - 1);
      const bool wg_live = w_first < Sq;
      const int lo = window > 0 && prefix_len <= 0
                         ? q_offset + w_first - window + 1
                         : 0;
      const int hi = causal ? max(min(kv_hi, q_offset + w_last + 1),
                                  min(prefix_len, kv_hi))
                            : kv_hi;
      int j_lo = 0, j_hi = 0;
      if (wg_live) {
        while (j_lo < x.n_chunks && x.c_begin + (j_lo + 1) * KC <= lo) ++j_lo;
        j_hi = j_lo;
        while (j_hi < x.n_chunks && x.c_begin + j_hi * KC < hi) ++j_hi;
      }
      // the chunk needs its mask: a key past kv_len, above the diagonal
      // or below the window for some row of the warpgroup (a prefix only
      // unmasks keys, so a chunk this passes needs no mask with one)
      auto masked = [&](int c0) {
        return c0 + KC > kv_hi ||
               (causal && c0 + KC - 1 > q_offset + w_first) ||
               (window > 0 && c0 <= q_offset + w_last - window);
      };

#pragma unroll
      for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
      float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
      float ra, rb;
      mbar_wait(full_q, ti & 1);
      for (int j = 0; j < j_lo; ++j) drain(r + j);
      if (j_lo < j_hi) {
        // the first live chunk: S, softmax, P
        my_turn();
        issue_s(r + j_lo, sc);
        your_turn();
        wgmma_wait<0>();
        fence_regs(sc);
        mbar_arrive(empty_k + 8 * ((r + j_lo) % NS));
        if (j_lo + 1 == j_hi) mbar_arrive(empty_q);   // q's last use
        const int c0 = x.c_begin + j_lo * KC;
        softmax_chunk<KC>(sc, rc, c0, masked(c0), m_a, m_b, l_a, l_b, ra, rb);
        pack_p<KC>(sc, pa);
        // steady state: chunk j's S runs on the tensor cores beside the
        // previous chunk's P V, and its softmax overlaps that P V
        for (int j = j_lo + 1; j < j_hi; ++j) {
          const int c0 = x.c_begin + j * KC;
          my_turn();
          issue_s(r + j, sc);
          issue_pv(r + j - 1, o, pa);
          your_turn();
          wgmma_wait<1>();                    // S of chunk j is done
          fence_regs(sc);
          mbar_arrive(empty_k + 8 * ((r + j) % NS));
          if (j + 1 == j_hi) mbar_arrive(empty_q);    // q's last use
          softmax_chunk<KC>(sc, rc, c0, masked(c0), m_a, m_b, l_a, l_b, ra,
                            rb);
          wgmma_wait<0>();                    // P V of chunk j - 1 is done
          fence_regs(o);
          fence_regs(pa);
          mbar_arrive(empty_v + 8 * ((r + j - 1) % NS));
#pragma unroll
          for (int i = 0; i < HD / 2; ++i)
            o[i] = __fmul_rn(o[i], (i & 2) ? rb : ra);
          pack_p<KC>(sc, pa);
        }
        issue_pv(r + j_hi - 1, o, pa);
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(pa);
        mbar_arrive(empty_v + 8 * ((r + j_hi - 1) % NS));
      } else {
        mbar_arrive(empty_q);                 // no live chunk: q unused
      }
      for (int j = j_hi; j < x.n_chunks; ++j) drain(r + j);
      r += x.n_chunks;

      if (wg_live) {
        const float den_a = fmaxf(quad_sum(l_a), 1e-30f);
        const float den_b = fmaxf(quad_sum(l_b), 1e-30f);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = half ? row_b : row_a;
          if (row >= Sq) continue;
          const float den = half ? den_b : den_a;
          __nv_bfloat16* const orow =
              out + ((static_cast<long long>(x.b) * Sq + row) * H + x.h) * HD;
#pragma unroll
          for (int j = 0; j < HD / 8; ++j)
            *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * rc.cq) =
                __floats2bfloat162_rn(
                    __fdiv_rn(o[4 * j + 2 * half], den),
                    __fdiv_rn(o[4 * j + 2 * half + 1], den));
        }
      }
    }
    if (wg == 1) my_turn();                   // the last turn handed over
  }
}

// ---------------------------------------------------------------------------
// host side

// cudaFuncSetAttribute for more than 48 KB of dynamic shared memory, once
// per device and kernel, before any launch there (so never inside a stream
// capture).
template <typename K>
int allow_smem(K kernel, int bytes, bool (&configured)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured[dev] = true;
  }
  return 0;
}

// One float32 launch: the grid (q tiles x H x splits, B), heaviest q tiles
// first, the `splits` CTAs of a (q tile, head) one cluster.
template <int HD>
int launch_fp32(const void* q, const void* k, const void* v, void* out,
                int B, int Sq, int Skv, int H, int Hkv, long long q_bs,
                long long q_ss, long long kv_bs, long long kv_ss,
                int q_offset, int kv_len, int causal, int window,
                int prefix_len, float scale, int splits,
                cudaStream_t stream) {
  using Sh = F32Shape<HD>;
  if (splits < 1 || splits > kMaxSplits)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool configured[64] = {};
  const int rc = allow_smem(flash_fp32_kernel<HD>, Sh::kSmem, configured);
  if (rc) return rc;
  // 16-byte copies where every base and stride allows them (bit 0: k and
  // v, bit 1: q); a batch stride is read only when B > 1
  const long long kvb = B > 1 ? kv_bs : 0, qbs = B > 1 ? q_bs : 0;
  const int vec =
      ((reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) %
                   16 == 0 &&
               (kvb | kv_ss) % 4 == 0
           ? 1
           : 0) |
      (reinterpret_cast<uintptr_t>(q) % 16 == 0 && (qbs | q_ss) % 4 == 0
           ? 2
           : 0);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((Sq + Sh::QT - 1) / Sh::QT * H * splits, B, 1);
  cfg.blockDim = dim3(Sh::T, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(Sh::kSmem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, flash_fp32_kernel<HD>, static_cast<const float*>(q),
      static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), Sq, Skv, H, H / Hkv, q_bs, q_ss, kv_bs,
      kv_ss, q_offset, kv_len, causal, window, prefix_len, scale, splits,
      vec);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// cuTensorMapEncodeTiled from the driver through the runtime, so the
// library needs no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D bf16 map over x [B, S, heads, hd] (strides in elements; the
// (heads, hd) dims contiguous) with boxes of `cols` head-dim columns by
// `rows` sequence rows of one head and batch.
int encode_map(CUtensorMap* map, const void* x, int B, int S, int heads,
               int hd, long long b_stride, long long s_stride, int cols,
               int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  if (B == 1) b_stride = static_cast<long long>(S) * s_stride;  // unused
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(hd) * 2,
                                 static_cast<cuuint64_t>(s_stride) * 2,
                                 static_cast<cuuint64_t>(b_stride) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(cols), 1,
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                 : (cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                               : CU_TENSOR_MAP_SWIZZLE_32B);
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(x), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int HD>
int launch_tc(const void* q, const void* k, const void* v, void* out, int B,
              int Sq, int Skv, int H, int Hkv, long long q_bs,
              long long q_ss, long long kv_bs, long long kv_ss, int q_offset,
              int kv_len, int causal, int window, int prefix_len, float scale,
              cudaStream_t stream) {
  using Sh = TcShape<HD>;
  static bool configured[64] = {};
  int rc = allow_smem(flash_tc_kernel<HD>, Sh::kSmem, configured);
  if (rc) return rc;
  // the card's SM count, read once per device
  static int sm_count[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (sm_count[dev] == 0) {
    err = cudaDeviceGetAttribute(&sm_count[dev],
                                 cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // TMA: 16-byte aligned bases and strides
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) % 16 ||
      (q_bs | q_ss | kv_bs | kv_ss) % 8)
    return static_cast<int>(cudaErrorMisalignedAddress);
  CUtensorMap qm, km, vm;
  if ((rc = encode_map(&qm, q, B, Sq, H, HD, q_bs, q_ss, Sh::CB, kTcRows)) ||
      (rc = encode_map(&km, k, B, Skv, Hkv, HD, kv_bs, kv_ss, Sh::CB,
                       Sh::KC)) ||
      (rc = encode_map(&vm, v, B, Skv, Hkv, HD, kv_bs, kv_ss, Sh::CB,
                       Sh::KC)))
    return rc;
  // c = log2(e) / sqrt(hd): the exponent's scale, folded for ex2
  const float c = static_cast<float>(static_cast<double>(scale) *
                                     1.4426950408889634);
  // persistent: one block per SM (the shared memory allows no more), each
  // walking its share of the tiles
  const int n_tiles = (Sq + kTcRows - 1) / kTcRows * H * B;
  const int grid = min(n_tiles, sm_count[dev]);
  flash_tc_kernel<HD><<<grid, kTcThreads, Sh::kSmem, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(out), B, Sq, Skv, H, H / Hkv,
      q_offset, kv_len, causal, window, prefix_len, c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Dynamic shared-memory bytes of one block of the float32 (dtype 0) or the
// bf16 tensor-core (dtype 1) kernel at head dim hd, or -1 for a head dim
// the library is not built for.
extern "C" long long fg_flash_attention_smem(int dtype, int hd) {
#define FG_SMEM(N)                                                         \
  case N:                                                                  \
    return dtype == 0 ? static_cast<long long>(F32Shape<N>::kSmem)         \
                      : static_cast<long long>(TcShape<N>::kSmem);
  if (dtype != 0 && dtype != 1) return -1;
  switch (hd) {
    FG_SMEM(16)
    FG_SMEM(64)
    FG_SMEM(128)
    FG_SMEM(160)
    FG_SMEM(256)
    default:
      return -1;
  }
#undef FG_SMEM
}

// dtype: 0 float32 (FP32-core kernel), 1 bfloat16 (tensor-core kernel).
// Strides are in elements; each (heads, hd) row block must be contiguous,
// and for bf16 every base and stride 16-byte aligned.  `splits` (float32
// only, 1..8) is the key split, the CTAs of one cluster.  Returns a
// cudaError_t (0 on success).
extern "C" int fg_flash_attention(const void* q, const void* k,
                                  const void* v, void* out, int dtype, int B,
                                  int Sq, int Skv, int H, int Hkv, int hd,
                                  long long q_bs, long long q_ss,
                                  long long kv_bs, long long kv_ss,
                                  int q_offset, int kv_len, int causal,
                                  int window, int prefix_len, float scale,
                                  int splits, void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || B > 65535 ||
      H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FG_HD(N, LAUNCH, ...)                                              \
  case N:                                                                  \
    return LAUNCH<N>(q, k, v, out, B, Sq, Skv, H, Hkv, q_bs, q_ss, kv_bs,  \
                     kv_ss, q_offset, kv_len, causal, window, prefix_len,  \
                     scale, __VA_ARGS__ s);
  if (dtype == 0) {
    switch (hd) {
      FG_HD(16, launch_fp32, splits,)
      FG_HD(64, launch_fp32, splits,)
      FG_HD(128, launch_fp32, splits,)
      FG_HD(160, launch_fp32, splits,)
      FG_HD(256, launch_fp32, splits,)
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (dtype == 1) {
    switch (hd) {
      FG_HD(16, launch_tc, )
      FG_HD(64, launch_tc, )
      FG_HD(128, launch_tc, )
      FG_HD(160, launch_tc, )
      FG_HD(256, launch_tc, )
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
#undef FG_HD
  return static_cast<int>(cudaErrorInvalidValue);
}
