// Hopper (sm_90a) kernel for the engine's K-visit loop: one launch runs one
// chunk of partition visits.
//
//   fg_fused_visit  for k = stats[0] .. min(K, stats[0] + launches) - 1:
//                   select the partition (priority / fifo / max_ops /
//                   random, first index on ties), consolidate its buffer, relax until no
//                   op is active or max_rounds, emit into every neighbour's
//                   buffer row, refresh the scheduler metadata of every row
//                   it touched and update the chunk's stats -- with no
//                   read back to the host.  The loop ends early when no
//                   partition holds a pending op, and the host reads the
//                   stats once per chunk.  Replaces the TPU kernel of
//                   make_fused_visit (src/repro/kernels/fused_visit/
//                   fused.py, pallas_call in `visit`) and the while_loop
//                   around it (src/repro/core/visit.py
//                   make_megastep(fused=True)).
//
// Design.  The TPU kernel runs a visit as grid steps 0..dmax over a VMEM
// copy of the partition's dense adjacency row.  On the road graphs the
// port serves, a 128 x 128 block holds ~4 finite entries per column, and a
// visit needs ~20-40 live (q, u, v) pairs; a dense contraction on one SM
// spent ~0.15 ms per visit on +inf.  So here:
//   * Column lists.  DeviceGraph.build keeps each block as the list of its
//     finite entries by column (col_ptr [nblk, B+1], col_u and col_w
//     [nnz], ascending u within a column).  Every output cell (q, v) of a
//     relax round or an emission slot walks only the in-list of v.  The
//     lists stay in global memory (L2-resident, read through the
//     read-only path; each thread loads its column's bounds one item ahead
//     and pulls the entries into L1), so shared memory depends on
//     (algebra, Q, B) only.
//   * A cluster per visit.  The kernel runs as one thread-block cluster of
//     C CTAs (C = 1, 4 or 8).  CTA `rank` owns query rows [rank R,
//     rank R + R) with R = ceil(Q / C) -- possibly none -- of every
//     partition for the whole launch: its rows of plane0/plane1/buf, its
//     EQ counters and its rows of the stats.  Rows are independent through
//     consolidate, relax and emission, so one exchange per visit (through
//     distributed shared memory and barrier.cluster) carries all that
//     crosses CTAs: the partial (best, count) of each metadata refresh and
//     each CTA's relax rounds.  Each CTA selects the partition itself from
//     prio / stamp / ops.
//   * The random policy.  The reference splits its threefry key once per
//     visit (key, sub = split(key)) and takes the first argmax of
//     uniform(sub, [P]) over the non-empty partitions.  Every thread of
//     every CTA holds the key in registers (read once per launch), hashes
//     the split's two counters itself and draws the uniforms of its own
//     partitions (fg::threefry2x32, threefry.cuh; ~2 hashes a thread at
//     P = 288), so every CTA picks the same partition with no exchange.
//     The key is split only when a partition is pending, as the reference
//     does, and rank 0 writes it back after the launch: the next chunk
//     continues the stream.
//   * Rounds.  Each CTA relaxes until its own rows hold no active op.  A
//     row with no active op in a round is unchanged by it, bit for bit
//     (min-plus: all its sources are +inf, so d = fminf(d, +inf) and no
//     op turns pending; push: af = 0 leaves p, r and acc as they are and
//     the spread adds +0), so idle rows stay idle and a CTA that stops
//     early computes what the cluster's remaining rounds would.  The
//     visit's round count -- the reference's, per visit -- is the largest
//     CTA's.
//   * Metadata.  Each CTA reduces the exchanged partials in rank order and
//     writes the same prio / ops / stamp values; a CTA's later reads see
//     its own writes (or another CTA's identical ones), so selection needs
//     no further barrier.  The stamp's "was empty" test is read before the
//     exchange barrier, which no CTA passes before every CTA has read it.
//   * Copies.  Own rows in and out, and each neighbour slot's buffer and
//     distance (min-plus) or residual (push) rows, move by cp.async.bulk
//     completed on mbarriers; a neighbour slot's rows are staged in chunks
//     of at most 8 rows through three stages, the next item's copy in
//     flight while the current one is combined (the first one issued at
//     the visit's start) and the last one's store still draining.  Rows
//     whose byte ranges are not 16-byte aligned (B % 4 != 0) are copied
//     by the threads instead.
//   * One launch per chunk.  The kernel loops over the chunk's visits
//     itself; the exchange ends every visit, so visit k + 1 reads what
//     visit k wrote.
//
// Numerics.  Each contraction is fg::contract_list (visit_tiles.cuh), the
// tile fg_minplus and fg_masked_matmul (minplus.cu) run too: min-plus over
// the list gives the dense contraction's bits, and push sums the present
// entries in ascending u, which gives the dense u = 0..B-1 fmaf order's
// bits.  Everything else is the expressions of visit_tiles.cuh in the
// plain version's order.  `sparse` (min-plus only) also skips the row
// groups with no live source: same bits, less work.
//
// Bound.  At the main path's shapes (Q = 64, B = 128, dmax = 4, ~4
// entries per list column) a visit must move its own rows in and out, the
// lists of the diagonal block and of each neighbour block (8 B per finite
// entry) and each neighbour's buffer row in and out and its distance row
// in: ~0.4-0.5 MB, ~0.14 us at 3.35 TB/s; its live pairs are a few dozen
// instructions.  What remains is latency: a visit is a chain of dependent
// steps (select, copy, ~2 relax rounds, ~3 slots, exchange), each a few
// hundred cycles of global-memory or barrier latency.  Times are measured
// by chip_smoke.py (PERF.md).
#include <limits.h>

#include "threefry.cuh"
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
  const int* col_ptr;        // [nblk, B+1] list start of each column
  const int* col_u;          // [nnz] source row of each finite entry
  const float* col_w;        // [nnz] its weight
  const int* row_nnz;        // [nblk, B]
  const int64_t* nbr_blk;    // [P, dmax], -1 = padded slot
  const int64_t* nbr_dst;    // [P, dmax]
  const int* nbr_nnz;        // [P, B]
  const int64_t* diag_blk;   // [P]
  const int* deg;            // [P, B]
  const float* budget;       // [P]
  int64_t* key;              // [2] threefry key (random policy), or null
  int P, Q, B, dmax, K, launches, max_rounds, counter, strict;
  float window, alpha, c1, eps;
  int smem_bytes;
  int bulk;                  // set by fg_fused_visit: rows 16-byte aligned
};

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBigStamp = INT_MAX - 1;
constexpr int kEdgeShift = 20;
constexpr int kErrSmem = -1;      // smem_bytes below what the layout needs
constexpr int kMaxCluster = 8;
constexpr int kGroup = 8;         // metadata refreshes per cluster exchange
constexpr int kStageRows = 8;     // neighbour rows per staged chunk
constexpr int kStages = 3;        // neighbour chunks in flight or in use
constexpr int kTaskRows = 4;      // query rows one contraction task covers

enum { kMinplus = 0, kPush = 1 };
enum { kPriority = 0, kFifo = 1, kMaxOps = 2, kRandom = 3 };
constexpr int kPolicies = 4;

// Shared-memory layout of one CTA, in 4-byte words then bytes.
// kernels/fused_visit/ops.py asks fg_fused_visit_smem for the total, and
// ops.smem_bytes (fpp/planner.MemoryModel.fused_working_set) computes the
// same number.  Every float plane starts on a 16-byte boundary.
struct Layout {
  int R, SR;                 // rows per CTA, rows per neighbour chunk
  int rb, sb;                // words of an [R, B] plane, an [SR, B] stage
  int v0, v1, v2, v3;        // [R, B] planes (see the kernels)
  int sbuf, sval;            // [3][SR, B]: neighbour buffer rows, and their
                             //   dist (min-plus) or r (push) rows
  int nnz, nnz2;             // [B] row counts: diagonal, all neighbours
  int degc, thresh, degi;    // [B] (push)
  int alpha, eq, elo, ehi;   // [R]: window base, this visit's edges,
                             //   the chunk's (hi, lo) edge counters
  int red, pair;             // [4 kWarps]: argmin, (best, n) pairs
  int misc;                  // [4]
  int part, ploc;            // [2][kGroup][kMaxCluster] int4, [kGroup] int4
  int ent_j, ent_was;        // [kGroup]
  int mbar;                  // 4 mbarriers: own rows, stages 0..2
  int words;
  int m0, m1, live;          // bytes: [R, B] masks, [round4(R)] row flags
                             //   (4-byte aligned, padding rows 0)
  size_t total;
};

__host__ __device__ inline Layout layout(int algebra, int Q, int B, int C) {
  Layout L{};
  const bool push = algebra == kPush;
  L.R = (Q + C - 1) / C;
  L.SR = L.R < kStageRows ? L.R : kStageRows;
  L.rb = fg::round4(L.R * B);
  L.sb = fg::round4(L.SR * B);
  const int bw = fg::round4(B), rw = fg::round4(L.R);
  int o = 0;
  L.v0 = o; o += L.rb;
  L.v1 = o; o += L.rb;
  L.v2 = L.v3 = -1;
  if (push) {
    L.v2 = o; o += L.rb;
    L.v3 = o; o += L.rb;
  }
  L.sbuf = o; o += kStages * L.sb;
  L.sval = o; o += kStages * L.sb;
  L.nnz = o; o += bw;
  L.nnz2 = o; o += bw;
  L.degc = L.thresh = L.degi = L.alpha = -1;
  if (push) {
    L.degc = o; o += bw;
    L.thresh = o; o += bw;
    L.degi = o; o += bw;
  } else {
    L.alpha = o; o += rw;
  }
  L.eq = o; o += rw;
  L.elo = o; o += rw;
  L.ehi = o; o += rw;
  L.red = o; o += 4 * kWarps;
  L.pair = o; o += 4 * kWarps;
  L.misc = o; o += 4;
  L.part = o; o += 2 * kGroup * kMaxCluster * 4;
  L.ploc = o; o += 4 * kGroup;
  L.ent_j = o; o += kGroup;
  L.ent_was = o; o += kGroup;
  L.mbar = o; o += 8;
  L.words = o;
  int b = 4 * o;
  L.m0 = b; b += L.R * B;
  L.m1 = L.live = -1;
  if (!push) {
    L.m1 = b; b += L.R * B;
    b = fg::round4(b);
    L.live = b; b += rw;
  }
  L.total = static_cast<size_t>((b + 15) & ~15);
  return L;
}

// ---------------------------------------------------------------------------
// cluster, mbarrier and bulk-copy primitives

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of every CTA of the cluster arrives and waits; writes before
// it (global, local or remote shared) are visible to reads after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The address of `p` (in this CTA's shared memory) in CTA `rank`'s.
template <typename T>
__device__ __forceinline__ T* map_rank(T* p, unsigned rank) {
  uint64_t r;
  asm volatile("mapa.u64 %0, %1, %2;\n"
               : "=l"(r)
               : "l"(reinterpret_cast<uint64_t>(p)), "r"(rank));
  return reinterpret_cast<T*>(r);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(1)
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Spins until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t b = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(b), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               ::"l"(reinterpret_cast<uint64_t>(dst)), "r"(smem_u32(src)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Until every committed bulk store but the latest has read its
// shared-memory source.
__device__ __forceinline__ void bulk_wait_read1() {
  asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
}

// Until every committed bulk store has completed its writes.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Orders this thread's shared-memory writes before a later bulk store's
// reads of them (generic proxy -> async proxy).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Pulls the line holding `p` into L1 (no register, no wait).
__device__ __forceinline__ void prefetch_l1(const void* p) {
  asm volatile("prefetch.global.L1 [%0];\n" ::"l"(reinterpret_cast<uint64_t>(p)));
}

// prio / ops / stamp are written by every CTA with the same values and
// read by all of them: strong (volatile) accesses, so no read races.
template <typename T>
__device__ __forceinline__ T ld_meta(const T* p) {
  return *reinterpret_cast<const volatile T*>(p);
}
template <typename T>
__device__ __forceinline__ void st_meta(T* p, T v) {
  *reinterpret_cast<volatile T*>(p) = v;
}

// ---------------------------------------------------------------------------
// block reductions (every thread of the CTA calls them)

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

// ---------------------------------------------------------------------------
// one CTA's part of the chunk

// What one CTA keeps across the chunk's visits.
struct Cta {
  int tid, lane, warp;
  unsigned rank;
  int r0, nr;                // its first query row and its row count
  bool bulk;                 // rows move by cp.async.bulk
  uint32_t phases;           // mbarrier parities: bit 0 own, 1 + s stage s
  int par_part, par_pair;    // which half of the exchange buffer and of
                             //   the pair scratch is next
  int ent;                   // metadata refreshes waiting for an exchange
};

template <int C>
__device__ Cta make_cta(const FusedArgs& a, const Layout& L, uint64_t* mbar) {
  Cta c;
  c.tid = threadIdx.x;
  c.lane = c.tid & 31;
  c.warp = c.tid >> 5;
  c.rank = C > 1 ? cluster_rank() : 0u;
  c.r0 = static_cast<int>(c.rank) * L.R;
  c.nr = max(0, min(a.Q - c.r0, L.R));
  c.bulk = a.bulk != 0;
  c.phases = 0;
  c.par_part = c.par_pair = 0;
  c.ent = 0;
  if (c.tid == 0) {
    for (int i = 0; i < 1 + kStages; ++i) mbar_init(mbar + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // every CTA of the cluster runs before any remote shared-memory store
  if (C > 1) cluster_sync();
  return c;
}

// A block-wide (min or max, sum) of one (best, n) pair per thread, split
// around a block barrier that the caller places (so it can share it):
// pair_post before it, pair_read after it.  The two halves of the scratch
// alternate, so the next reduction never overwrites a warp result that a
// slower thread has yet to read.
template <bool kMax>
__device__ __forceinline__ void pair_post(const Cta& c, int* pair, float b,
                                          int n) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float b2 = __shfl_xor_sync(0xffffffffu, b, o);
    b = kMax ? fmaxf(b, b2) : fminf(b, b2);
    n += __shfl_xor_sync(0xffffffffu, n, o);
  }
  if (c.lane == 0) {
    int* half = pair + c.par_pair * 2 * kWarps;
    half[c.warp] = __float_as_int(b);
    half[kWarps + c.warp] = n;
  }
}

template <bool kMax>
__device__ __forceinline__ void pair_read(Cta& c, const int* pair, float& b,
                                          int& n) {
  const int* half = pair + c.par_pair * 2 * kWarps;
  b = __int_as_float(half[0]);
  n = half[kWarps];
  for (int w = 1; w < kWarps; ++w) {
    const float b2 = __int_as_float(half[w]);
    b = kMax ? fmaxf(b, b2) : fminf(b, b2);
    n += half[kWarps + w];
  }
  c.par_pair ^= 1;
}

// The partition to visit (device_select in core/visit.py over prio/stamp/
// ops [0, P)), or -1 when no priority is finite.  Every CTA computes it
// from the same values.  kRandom: `key` is the thread's copy of the
// carried threefry key; it is split (it becomes the hash of the counter
// (0, 0), the draw's sub-key that of (0, 1)) only when a partition is
// pending.
template <int kPolicy>
__device__ int select_partition(const FusedArgs& a, float* redf, int* redi,
                                const Cta& c, uint2& key) {
  bool any = false;
  float bf = INFINITY;
  int bk = INT_MAX, bi = INT_MAX;
  const uint2 sub = kPolicy == kRandom
                        ? fg::threefry2x32(key.x, key.y, 0u, 1u)
                        : make_uint2(0u, 0u);
  for (int i = c.tid; i < a.P; i += kThreads) {
    const float pr = ld_meta(a.prio + i);
    const bool fin = isfinite(pr);
    any |= fin;
    if (kPolicy == kPriority) take(bf, bi, pr, i);
    else if (kPolicy == kFifo)
      take(bk, bi, fin ? ld_meta(a.stamp + i) : INT_MAX, i);
    else if (kPolicy == kMaxOps)
      take(bk, bi, fin ? -ld_meta(a.ops + i) : 1, i);  // argmax of ops
    else {  // first argmax of where(finite, u, -1): argmin of -u / +1
      const float u = fg::uniform_from_bits(fg::threefry2x32(
          sub.x, sub.y, 0u, static_cast<uint32_t>(i)));
      take(bf, bi, fin ? -u : 1.0f, i);
    }
  }
  if (!__syncthreads_or(any)) return -1;
  if (kPolicy == kRandom) key = fg::threefry2x32(key.x, key.y, 0u, 0u);
  if (kPolicy == kPriority || kPolicy == kRandom)
    return block_argmin(bf, bi, redf, redi, c.lane, c.warp);
  return block_argmin(bk, bi, redi + kWarps, redi, c.lane, c.warp);
}

// The carried threefry key: read by every thread at the launch's start
// (before any CTA can finish), written back by rank 0 after the last
// cluster barrier (kRandom only).
template <int kPolicy>
__device__ __forceinline__ uint2 load_key(const FusedArgs& a) {
  if (kPolicy != kRandom) return make_uint2(0u, 0u);
  return make_uint2(static_cast<uint32_t>(a.key[0]),
                    static_cast<uint32_t>(a.key[1]));
}

template <int kPolicy>
__device__ __forceinline__ void store_key(const FusedArgs& a, const Cta& c,
                                          uint2 key) {
  if (kPolicy == kRandom && c.rank == 0 && c.tid == 0) {
    a.key[0] = static_cast<int64_t>(key.x);
    a.key[1] = static_cast<int64_t>(key.y);
  }
}

// Rows [r0, r0 + nr) of N planes into shared memory: one bulk copy each,
// completing on the own-rows mbarrier, or the threads' own loads.  Thread
// 0 first waits for every earlier bulk store (the rows may be the ones it
// wrote last).
template <int N>
__device__ void load_own(const Cta& c, uint64_t* mbar, float* const (&dst)[N],
                         const float* const (&src)[N], int nrb) {
  if (c.nr == 0) return;
  if (c.bulk) {
    if (c.tid == 0) {
      bulk_wait();
      mbar_expect(mbar, static_cast<uint32_t>(N * nrb * 4));
      for (int i = 0; i < N; ++i)
        bulk_load(dst[i], src[i], static_cast<uint32_t>(nrb * 4), mbar);
    }
  } else {
    for (int i = 0; i < N; ++i)
      for (int e = c.tid; e < nrb; e += kThreads) dst[i][e] = src[i][e];
  }
}

__device__ void wait_own(Cta& c, uint64_t* mbar) {
  if (c.nr > 0 && c.bulk) {
    mbar_wait(mbar, c.phases & 1u);
    c.phases ^= 1u;
  }
  __syncthreads();
}

// The CTA's rows back to N planes (bulk: after a proxy fence and a block
// barrier, thread 0 issues the stores; the threads' own stores happen in
// the caller's loop otherwise).
template <int N>
__device__ void store_own(const Cta& c, float* const (&dst)[N],
                          const float* const (&src)[N], int nrb) {
  if (c.bulk) fence_async_smem();
  __syncthreads();
  if (c.nr == 0 || !c.bulk || c.tid != 0) return;
  for (int i = 0; i < N; ++i)
    bulk_store(dst[i], src[i], static_cast<uint32_t>(nrb * 4));
  bulk_commit();
}

// One neighbour item: rows [c0, c0 + cr) of the CTA's rows of slot s.
struct Item {
  int s, ch;
};

// A neighbour-table entry, through the read-only path.
__device__ __forceinline__ int64_t ld_idx(const int64_t* p) {
  return __ldg(reinterpret_cast<const long long*>(p));
}

__device__ __forceinline__ int next_slot(const int64_t* blks, int s,
                                         int dmax) {
  for (++s; s < dmax; ++s)
    if (ld_idx(blks + s) >= 0) break;
  return s;
}

// Issues item it's copies into stage `st`: the neighbour's buffer rows and
// its value rows (dist or r).  Bulk: thread 0, once the stage's last bulk
// store has read it -- that store is at least two groups back, so the
// latest group may stay in flight.  Otherwise every thread copies now.
__device__ void issue_item(const FusedArgs& a, const Layout& L, const Cta& c,
                           const int64_t* dsts, Item it, int st,
                           const float* vplane, float* sbuf, float* sval,
                           uint64_t* mbar) {
  const int c0 = it.ch * L.SR, cr = min(L.SR, c.nr - c0), n = cr * a.B;
  const int64_t row =
      (ld_idx(dsts + it.s) * a.Q + c.r0 + c0) * static_cast<int64_t>(a.B);
  float* db = sbuf + st * L.sb;
  float* dv = sval + st * L.sb;
  if (c.bulk) {
    if (c.tid == 0) {
      bulk_wait_read1();
      uint64_t* bar = mbar + 1 + st;
      mbar_expect(bar, static_cast<uint32_t>(2 * n * 4));
      bulk_load(db, a.buf + row, static_cast<uint32_t>(n * 4), bar);
      bulk_load(dv, vplane + row, static_cast<uint32_t>(n * 4), bar);
    }
  } else {
    for (int e = c.tid; e < n; e += kThreads) {
      db[e] = a.buf[row + e];
      dv[e] = vplane[row + e];
    }
  }
}

__device__ void wait_item(Cta& c, uint64_t* mbar, int st) {
  if (c.bulk) {
    const uint32_t bit = 2u << st;
    mbar_wait(mbar + 1 + st, (c.phases & bit) ? 1u : 0u);
    c.phases ^= bit;
  } else {
    __syncthreads();
  }
}

// The new buffer rows of an item back to the neighbour's buffer row.
__device__ void store_item(const FusedArgs& a, const Layout& L, const Cta& c,
                           const int64_t* dsts, Item it, int st,
                           const float* sbuf) {
  const int c0 = it.ch * L.SR, cr = min(L.SR, c.nr - c0), n = cr * a.B;
  const int64_t row =
      (ld_idx(dsts + it.s) * a.Q + c.r0 + c0) * static_cast<int64_t>(a.B);
  const float* sb = sbuf + st * L.sb;
  if (c.bulk) {
    fence_async_smem();
    __syncthreads();
    if (c.tid == 0) {
      bulk_store(a.buf + row, sb, static_cast<uint32_t>(n * 4));
      bulk_commit();
    }
  } else {
    __syncthreads();
    for (int e = c.tid; e < n; e += kThreads) a.buf[row + e] = sb[e];
    __syncthreads();
  }
}

// Any of the four rows q0..q0+3 (q0 a multiple of 4) flagged live: one
// word of the row flags, whose padding rows hold 0.
__device__ __forceinline__ bool rows_live(const uint8_t* live, int q0) {
  return *reinterpret_cast<const uint32_t*>(live + q0) != 0u;
}

// Appends one metadata refresh (this CTA's partial best and count) for
// row j; `was` is 1 / 0 for a neighbour row that was / was not empty
// before the visit, -1 for the visited row itself, whose entry also
// carries the CTA's relax rounds.
__device__ void append(int* si, const Layout& L, Cta& c, float best, int n,
                       int j, int was, int rounds = 0) {
  if (c.tid == 0) {
    reinterpret_cast<int4*>(si + L.ploc)[c.ent] =
        make_int4(__float_as_int(best), n, rounds, 0);
    si[L.ent_j + c.ent] = j;
    si[L.ent_was + c.ent] = was;
  }
  ++c.ent;
}

// The waiting refreshes: each CTA's partials go to every CTA, and every
// CTA reduces them in rank order and writes the same prio / ops / stamp;
// the visited row's entry also yields the visit's round count (the
// largest CTA's), left in misc[0].  Ends with a block barrier, so the
// CTA's next selection sees its writes.
template <int C, bool kPushAlg>
__device__ void flush(const FusedArgs& a, int* si, const Layout& L, Cta& c,
                      int cnt) {
  const int4* ploc = reinterpret_cast<const int4*>(si + L.ploc);
  int4* part = reinterpret_cast<int4*>(si + L.part) +
               c.par_part * kGroup * kMaxCluster;
  __syncthreads();
  if (C > 1) {
    if (c.tid < c.ent * C) {
      const int e = c.tid / C, dst = c.tid % C;
      *map_rank(part + e * kMaxCluster + c.rank, dst) = ploc[e];
    }
    cluster_sync();
  }
  if (c.tid < c.ent) {         // thread e finishes entry e
    const int e = c.tid;
    int4 v = ploc[e];
    if (C > 1) {
      const int4* pe = part + e * kMaxCluster;
      v = pe[0];
      for (int r = 1; r < C; ++r) {
        const float b = __int_as_float(pe[r].x), b0 = __int_as_float(v.x);
        v.x = __float_as_int(kPushAlg ? fmaxf(b0, b) : fminf(b0, b));
        v.y += pe[r].y;
        v.z = max(v.z, pe[r].z);
      }
    }
    const float best = __int_as_float(v.x);
    const int n = v.y;
    const float np = kPushAlg ? (n > 0 ? -best : INFINITY) : best;
    const int j = si[L.ent_j + e], was = si[L.ent_was + e];
    st_meta(a.prio + j, np);
    st_meta(a.ops + j, n);
    if (was < 0) {
      st_meta(a.stamp + j, isfinite(np) ? cnt : kBigStamp);
      si[L.misc] = v.z;
    } else if (was && isfinite(np)) {
      st_meta(a.stamp + j, cnt);
    }
  }
  c.par_part ^= 1;
  c.ent = 0;
  __syncthreads();
}

// The emission: for every valid neighbour slot in order, the contribution
// of the payload rows X through the slot's block list, combined into the
// neighbour's buffer rows, and the neighbour's metadata refresh.  Item 0
// (if any) was issued into stage 0 at the visit's start.
template <bool kPushAlg, bool kSparse, int C>
__device__ void emit(const FusedArgs& a, const Layout& L, Cta& c, int p,
                     int cnt, const float* X, const uint8_t* live,
                     float* sbuf, float* sval, uint64_t* mbar, int* pair,
                     int* si) {
  const int B = a.B;
  const bool strict = a.strict != 0;
  const int nch = (c.nr + L.SR - 1) / L.SR;   // chunks per slot
  const float* vplane = kPushAlg ? a.plane1 : a.plane0;
  const int64_t* blks = a.nbr_blk + static_cast<int64_t>(p) * a.dmax;
  const int64_t* dsts = a.nbr_dst + static_cast<int64_t>(p) * a.dmax;
  float best = kPushAlg ? -INFINITY : INFINITY;
  int n = 0, st = 0, was = 0;         // st: the item's stage
  Item it{next_slot(blks, -1, a.dmax), 0};
  // the list bounds of column vt (the thread's first task) in the current
  // and the next item's block, loaded one item ahead
  const int vt = c.tid % B;
  int cur0 = 0, cur1 = 0, nxt0 = 0, nxt1 = 0;
  if (it.s < a.dmax && nch > 0) {
    const int* pc = a.col_ptr + ld_idx(blks + it.s) * (B + 1);
    cur0 = __ldg(pc + vt);
    cur1 = __ldg(pc + vt + 1);
  }
  while (it.s < a.dmax) {
    Item nx{it.s, it.ch + 1};
    if (nx.ch >= nch) nx = Item{next_slot(blks, it.s, a.dmax), 0};
    const int st_next = st + 1 == kStages ? 0 : st + 1;
    const bool more = nx.s < a.dmax && nch > 0;
    if (more) {
      issue_item(a, L, c, dsts, nx, st_next, vplane, sbuf, sval, mbar);
      const int* pn = a.col_ptr + ld_idx(blks + nx.s) * (B + 1);
      nxt0 = __ldg(pn + vt);
      nxt1 = __ldg(pn + vt + 1);
    }
    const int j = static_cast<int>(ld_idx(dsts + it.s));
    // was row j empty before the visit?  (read early; used at the slot's
    // end, before the exchange that publishes the visit's writes)
    if (it.ch == 0 && c.tid == 0) was = !isfinite(ld_meta(a.prio + j));
    const bool slot_end = it.ch + 1 >= nch;   // at once with no rows
    if (nch > 0) {
      wait_item(c, mbar, st);
      const int c0 = it.ch * L.SR, cr = min(L.SR, c.nr - c0);
      const int64_t blk = ld_idx(blks + it.s);
      const int* ptr = a.col_ptr + blk * (B + 1);
      const int* deg_j = a.deg + static_cast<int64_t>(j) * B;
      float* sb = sbuf + st * L.sb;
      const float* sv = sval + st * L.sb;
      const int groups = (cr + kTaskRows - 1) / kTaskRows;
      for (int t = c.tid; t < groups * B; t += kThreads) {
        const int g = t / B, v = t - g * B, q0 = g * kTaskRows;
        const int nq = min(kTaskRows, cr - q0);
        float acc[kTaskRows];
#pragma unroll
        for (int r = 0; r < kTaskRows; ++r)
          acc[r] = kPushAlg ? 0.0f : INFINITY;
        if (!kSparse || rows_live(live, c0 + q0))
          fg::contract_list<!kPushAlg, kTaskRows>(
              acc, X + (c0 + q0) * B, B, nq,
              t == c.tid ? cur0 : __ldg(ptr + v),
              t == c.tid ? cur1 : __ldg(ptr + v + 1),
              fg::GlobalEntries{a.col_u, a.col_w});
#pragma unroll
        for (int r = 0; r < kTaskRows; ++r) {
          if (r >= nq) break;
          const int o = (q0 + r) * B + v;
          if (kPushAlg) {
            const float nb = __fadd_rn(sb[o], acc[r]);
            sb[o] = nb;
            const int dg = __ldg(deg_j + v);
            const float th = __fmul_rn(a.eps, static_cast<float>(max(dg, 1)));
            const float ratio = __fdiv_rn(__fadd_rn(sv[o], nb), th);
            if (dg > 0) {
              best = fmaxf(best, ratio);
              if (ratio >= 1.0f) ++n;
            }
          } else {
            const float nv = fminf(sb[o], acc[r]);
            sb[o] = nv;
            const float d = sv[o];
            if (isfinite(nv) && (strict ? nv < d : nv <= d)) {
              best = fminf(best, nv);
              ++n;
            }
          }
        }
      }
      if (more && nxt1 > nxt0) {  // the next item's entries, into L1
        prefetch_l1(a.col_u + nxt0);
        if (!kPushAlg) prefetch_l1(a.col_w + nxt0);
      }
    }
    // one block barrier serves the item's store and the slot's reduction
    if (slot_end) pair_post<kPushAlg>(c, pair, best, n);
    if (nch > 0) store_item(a, L, c, dsts, it, st, sbuf);
    else __syncthreads();
    if (slot_end) {
      pair_read<kPushAlg>(c, pair, best, n);
      append(si, L, c, best, n, j, was);
      if (c.ent == kGroup) flush<C, kPushAlg>(a, si, L, c, cnt);
      best = kPushAlg ? -INFINITY : INFINITY;
      n = 0;
    }
    it = nx;
    st = st_next;
    cur0 = nxt0;
    cur1 = nxt1;
  }
}

// The visit's first neighbour item into stage 0, issued with the own rows.
__device__ void issue_first(const FusedArgs& a, const Layout& L,
                            const Cta& c, int p, const float* vplane,
                            float* sbuf, float* sval, uint64_t* mbar) {
  if (c.nr == 0) return;
  const int64_t* blks = a.nbr_blk + static_cast<int64_t>(p) * a.dmax;
  const int s = next_slot(blks, -1, a.dmax);
  if (s < a.dmax)
    issue_item(a, L, c, a.nbr_dst + static_cast<int64_t>(p) * a.dmax,
               Item{s, 0}, 0, vplane, sbuf, sval, mbar);
}

// The chunk's stats after visit k of partition p: each CTA adds its rows'
// edges to its exact (hi, lo) counters (kept in shared memory for the
// chunk), rank 0 the rest.
__device__ void update_stats(const FusedArgs& a, const Cta& c, int p, int k,
                             int rounds, const int* eq, int* elo,
                             int* ehi) {
  for (int q = c.tid; q < c.nr; q += kThreads) {
    const int l = elo[q] + eq[q];
    const int spill = l >> kEdgeShift;
    ehi[q] += spill;
    elo[q] = l - (spill << kEdgeShift);
  }
  if (c.rank == 0 && c.tid == 0) {
    int* st = a.stats;
    int* counts = st + 2 + 2 * a.Q;
    st[0] = k + 1;
    atomicAdd(st + 1, rounds);
    atomicAdd(counts + p, 1);
    counts[a.P + k] = p;                 // the order ring
  }
}

// The chunk's (hi, lo) edge counters of the CTA's rows: in (load = true)
// or out.  The same thread handles row q in update_stats.
__device__ void edge_counters(const FusedArgs& a, const Cta& c, int* elo,
                              int* ehi, bool load) {
  int* hi = a.stats + 2 + c.r0;
  int* lo = hi + a.Q;
  for (int q = c.tid; q < c.nr; q += kThreads) {
    if (load) {
      elo[q] = lo[q];
      ehi[q] = hi[q];
    } else {
      lo[q] = elo[q];
      hi[q] = ehi[q];
    }
  }
}

// Leaves no bulk store in flight and no CTA exited while another may still
// write its shared memory.
template <int C>
__device__ void finish(const Cta& c) {
  if (c.bulk && c.tid == 0) bulk_wait();
  if (C > 1) cluster_sync();
}

template <int kPolicy, bool kSparse, int C>
__global__ void __launch_bounds__(kThreads)
fused_minplus_kernel(const FusedArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int k0 = a.stats[0];
  uint2 key = load_key<kPolicy>(a);
  const Layout L = layout(kMinplus, a.Q, a.B, C);
  float* sf = reinterpret_cast<float*>(smem);
  int* si = reinterpret_cast<int*>(smem);
  float* D = sf + L.v0;        // the CTA's rows' values
  float* X = sf + L.v1;        // buffer rows in, sources, buffer rows out
  float* SBUF = sf + L.sbuf;
  float* SVAL = sf + L.sval;
  float* ALPHA = sf + L.alpha;
  int* NNZ = si + L.nnz;       // diagonal block's row counts
  int* NNZ2 = si + L.nnz2;     // row counts into all neighbour blocks
  int* EQ = si + L.eq;
  float* REDF = sf + L.red;
  int* REDI = si + L.red + kWarps;
  int* PAIR = si + L.pair;
  int* ELO = si + L.elo;
  int* EHI = si + L.ehi;
  uint64_t* MBAR = reinterpret_cast<uint64_t*>(si + L.mbar);
  uint8_t* PEND = smem + L.m0;
  uint8_t* EMIT = smem + L.m1;
  uint8_t* LIVE = smem + L.live;

  Cta c = make_cta<C>(a, L, MBAR);
  edge_counters(a, c, ELO, EHI, true);
  for (int q = c.nr + c.tid; q < fg::round4(L.R); q += kThreads) LIVE[q] = 0;
  const int B = a.B, nrb = c.nr * B;
  const bool strict = a.strict != 0;
  const int64_t QB = static_cast<int64_t>(a.Q) * B;
  const int kend = min(a.K, k0 + a.launches);
  for (int k = k0; k < kend; ++k) {
    const int p = select_partition<kPolicy>(a, REDF, REDI, c, key);
    if (p < 0) break;
    const int cnt = a.counter + k;
    const int64_t kd = a.diag_blk[p];
    const float budget = a.budget[p];
    float* dist_p = a.plane0 + p * QB + static_cast<int64_t>(c.r0) * B;
    float* buf_p = a.buf + p * QB + static_cast<int64_t>(c.r0) * B;

    load_own<2>(c, MBAR, {D, X}, {dist_p, buf_p}, nrb);
    issue_first(a, L, c, p, a.plane0, SBUF, SVAL, MBAR);
    // the diagonal block's list bounds of column vt (the thread's first
    // task), for every round
    const int* dptr = a.col_ptr + kd * (B + 1);
    const int vt = c.tid % B;
    const int d0 = __ldg(dptr + vt), d1 = __ldg(dptr + vt + 1);
    for (int u = c.tid; u < B; u += kThreads) {
      NNZ[u] = a.row_nnz[kd * B + u];
      NNZ2[u] = a.nbr_nnz[static_cast<int64_t>(p) * B + u];
    }
    wait_own(c, MBAR);

    // consolidate: the frontier tile in place, one warp per query row
    for (int q = c.warp; q < c.nr; q += kWarps) {
      const float al = fg::frontier_row(X + q * B, D + q * B, D + q * B,
                                        PEND + q * B, nullptr, B, a.window,
                                        strict, c.lane);
      if (c.lane == 0) {
        ALPHA[q] = al;
        EQ[q] = 0;
      }
    }
    for (int i = c.tid; i < nrb; i += kThreads) EMIT[i] = 0;
    if (d1 > d0) {
      prefetch_l1(a.col_u + d0);
      prefetch_l1(a.col_w + d0);
    }
    __syncthreads();

    // relax until no op of the CTA's rows is active, or max_rounds (a CTA
    // whose rows are idle would only run no-op rounds: see the header)
    const int groups = (c.nr + kTaskRows - 1) / kTaskRows;
    int rounds = 0;
    while (rounds < a.max_rounds) {
      bool any = false;
      for (int q = c.warp; q < c.nr; q += kWarps) {
        const bool lane_ok = __int2float_rn(EQ[q]) < budget;
        const float thr = __fadd_rn(ALPHA[q], a.window);
        int inc = 0;
        bool row = false;
        for (int u = c.lane; u < B; u += 32) {
          const int o = q * B + u;
          const float d = D[o];
          const bool act = PEND[o] && d <= thr && lane_ok;
          X[o] = act ? d : INFINITY;
          if (act) {
            PEND[o] = 0;
            EMIT[o] = 1;
            inc += NNZ[u];
            row = true;
          }
        }
        inc = fg::warp_sum(inc);
        row = __any_sync(0xffffffffu, row);
        if (c.lane == 0) {
          EQ[q] += inc;
          LIVE[q] = row;
        }
        any |= row;
      }
      if (!__syncthreads_or(any)) break;
      for (int t = c.tid; t < groups * B; t += kThreads) {
        const int g = t / B, v = t - g * B, q0 = g * kTaskRows;
        const int nq = min(kTaskRows, c.nr - q0);
        if (kSparse && !rows_live(LIVE, q0)) continue;
        float acc[kTaskRows];
#pragma unroll
        for (int r = 0; r < kTaskRows; ++r) acc[r] = INFINITY;
        fg::contract_list<true, kTaskRows>(
            acc, X + q0 * B, B, nq, t == c.tid ? d0 : __ldg(dptr + v),
            t == c.tid ? d1 : __ldg(dptr + v + 1),
            fg::GlobalEntries{a.col_u, a.col_w});
#pragma unroll
        for (int r = 0; r < kTaskRows; ++r) {
          if (r >= nq) break;
          const int o = (q0 + r) * B + v;
          const float d = D[o], nd = acc[r];
          if (nd < d) PEND[o] = 1;
          D[o] = fminf(d, nd);
        }
      }
      __syncthreads();
      ++rounds;
    }

    // emission payload (emit ? d : +inf) and its edge count
    for (int q = c.warp; q < c.nr; q += kWarps) {
      int inc = 0;
      bool row = false;
      for (int u = c.lane; u < B; u += 32) {
        const int o = q * B + u;
        const bool e = EMIT[o];
        X[o] = e ? D[o] : INFINITY;
        if (e) {
          inc += NNZ2[u];
          row = true;
        }
      }
      inc = fg::warp_sum(inc);
      row = __any_sync(0xffffffffu, row);
      if (c.lane == 0) {
        EQ[q] += inc;
        LIVE[q] = row;
      }
    }
    __syncthreads();
    emit<false, kSparse, C>(a, L, c, p, cnt, X, LIVE, SBUF, SVAL, MBAR, PAIR,
                            si);

    // write back the rows, keep their unrelaxed ops, refresh own metadata
    float best = INFINITY;
    int n = 0;
    for (int i = c.tid; i < nrb; i += kThreads) {
      const float d = D[i];
      const float keep = PEND[i] ? d : INFINITY;
      X[i] = keep;
      if (!c.bulk) {
        dist_p[i] = d;
        buf_p[i] = keep;
      }
      if (isfinite(keep) && (strict ? keep < d : keep <= d)) {
        best = fminf(best, keep);
        ++n;
      }
    }
    pair_post<false>(c, PAIR, best, n);
    store_own<2>(c, {dist_p, buf_p}, {D, X}, nrb);
    pair_read<false>(c, PAIR, best, n);
    append(si, L, c, best, n, p, -1, rounds);
    flush<C, false>(a, si, L, c, cnt);
    update_stats(a, c, p, k, si[L.misc], EQ, ELO, EHI);
  }
  edge_counters(a, c, ELO, EHI, false);
  finish<C>(c);
  store_key<kPolicy>(a, c, key);
}

template <int kPolicy, int C>
__global__ void __launch_bounds__(kThreads)
fused_push_kernel(const FusedArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int k0 = a.stats[0];
  uint2 key = load_key<kPolicy>(a);
  const Layout L = layout(kPush, a.Q, a.B, C);
  float* sf = reinterpret_cast<float*>(smem);
  int* si = reinterpret_cast<int*>(smem);
  float* PP = sf + L.v0;       // PPR mass
  float* RR = sf + L.v1;       // residual
  float* ACC = sf + L.v2;      // pushed mass (the emission payload)
  float* X = sf + L.v3;        // buffer rows in, a round's pushed values
  float* SBUF = sf + L.sbuf;
  float* SVAL = sf + L.sval;
  float* DEGC = sf + L.degc;
  float* TH = sf + L.thresh;
  int* DEGI = si + L.degi;
  int* NNZ = si + L.nnz;
  int* NNZ2 = si + L.nnz2;
  int* EQ = si + L.eq;
  float* REDF = sf + L.red;
  int* REDI = si + L.red + kWarps;
  int* PAIR = si + L.pair;
  int* ELO = si + L.elo;
  int* EHI = si + L.ehi;
  uint64_t* MBAR = reinterpret_cast<uint64_t*>(si + L.mbar);
  uint8_t* ACT = smem + L.m0;

  Cta c = make_cta<C>(a, L, MBAR);
  edge_counters(a, c, ELO, EHI, true);
  const int B = a.B, nrb = c.nr * B;
  const int64_t QB = static_cast<int64_t>(a.Q) * B;
  const int kend = min(a.K, k0 + a.launches);
  for (int k = k0; k < kend; ++k) {
    const int p = select_partition<kPolicy>(a, REDF, REDI, c, key);
    if (p < 0) break;
    const int cnt = a.counter + k;
    const int64_t kd = a.diag_blk[p];
    const float budget = a.budget[p];
    const int64_t off = p * QB + static_cast<int64_t>(c.r0) * B;
    float* p_p = a.plane0 + off;
    float* r_p = a.plane1 + off;
    float* buf_p = a.buf + off;

    load_own<3>(c, MBAR, {PP, RR, X}, {p_p, r_p, buf_p}, nrb);
    issue_first(a, L, c, p, a.plane1, SBUF, SVAL, MBAR);
    const int* dptr = a.col_ptr + kd * (B + 1);
    const int vt = c.tid % B;
    const int d0 = __ldg(dptr + vt), d1 = __ldg(dptr + vt + 1);
    for (int u = c.tid; u < B; u += kThreads) {
      const int dg = a.deg[static_cast<int64_t>(p) * B + u];
      DEGI[u] = dg;
      DEGC[u] = static_cast<float>(max(dg, 1));
      TH[u] = __fmul_rn(a.eps, DEGC[u]);
      NNZ[u] = a.row_nnz[kd * B + u];
      NNZ2[u] = a.nbr_nnz[static_cast<int64_t>(p) * B + u];
    }
    for (int q = c.tid; q < c.nr; q += kThreads) EQ[q] = 0;
    wait_own(c, MBAR);

    // begin: r += buf, acc = 0
    for (int i = c.tid; i < nrb; i += kThreads) {
      RR[i] = __fadd_rn(RR[i], X[i]);
      ACC[i] = 0.0f;
    }
    if (d1 > d0) prefetch_l1(a.col_u + d0);
    __syncthreads();

    // push rounds until no op of the CTA's rows is active, or max_rounds
    const int groups = (c.nr + kTaskRows - 1) / kTaskRows;
    int rounds = 0;
    while (rounds < a.max_rounds) {
      bool any = false;
      for (int q = c.warp; q < c.nr; q += kWarps) {
        const bool lane_ok = __int2float_rn(EQ[q]) < budget;
        int inc = 0;
        for (int u = c.lane; u < B; u += 32) {
          const int o = q * B + u;
          const bool act =
              fg::push_active(RR[o], TH[u], DEGI[u] > 0) && lane_ok;
          ACT[o] = act;
          if (act) {
            inc += NNZ[u];
            any = true;
          }
        }
        inc = fg::warp_sum(inc);
        if (c.lane == 0) EQ[q] += inc;
      }
      if (!__syncthreads_or(any)) break;
      for (int i = c.tid; i < nrb; i += kThreads)
        fg::push_cell(PP[i], RR[i], ACC[i], X[i], ACT[i], DEGC[i % B],
                      a.alpha, a.c1);
      __syncthreads();
      // r += x @ finite(W), over the diagonal block's list
      for (int t = c.tid; t < groups * B; t += kThreads) {
        const int g = t / B, v = t - g * B, q0 = g * kTaskRows;
        const int nq = min(kTaskRows, c.nr - q0);
        float s[kTaskRows];
#pragma unroll
        for (int r = 0; r < kTaskRows; ++r) s[r] = 0.0f;
        fg::contract_list<false, kTaskRows>(
            s, X + q0 * B, B, nq, t == c.tid ? d0 : __ldg(dptr + v),
            t == c.tid ? d1 : __ldg(dptr + v + 1),
            fg::GlobalEntries{a.col_u, a.col_w});
#pragma unroll
        for (int r = 0; r < kTaskRows; ++r) {
          if (r >= nq) break;
          const int o = (q0 + r) * B + v;
          RR[o] = __fadd_rn(RR[o], s[r]);
        }
      }
      __syncthreads();
      ++rounds;
    }

    // emission edge count (acc > 0 marks the cells that cost edges)
    for (int q = c.warp; q < c.nr; q += kWarps) {
      int inc = 0;
      for (int u = c.lane; u < B; u += 32)
        if (ACC[q * B + u] > 0.0f) inc += NNZ2[u];
      inc = fg::warp_sum(inc);
      if (c.lane == 0) EQ[q] += inc;
    }
    __syncthreads();
    emit<true, false, C>(a, L, c, p, cnt, ACC, nullptr, SBUF, SVAL, MBAR,
                         PAIR, si);

    // write back p and r, empty the buffer rows, refresh own metadata
    float best = -INFINITY;
    int n = 0;
    for (int i = c.tid; i < nrb; i += kThreads) {
      const int v = i % B;
      const float rv = RR[i];
      X[i] = 0.0f;
      if (!c.bulk) {
        p_p[i] = PP[i];
        r_p[i] = rv;
        buf_p[i] = 0.0f;
      }
      const float ratio = __fdiv_rn(__fadd_rn(rv, 0.0f), TH[v]);
      if (DEGI[v] > 0) {
        best = fmaxf(best, ratio);
        if (ratio >= 1.0f) ++n;
      }
    }
    pair_post<true>(c, PAIR, best, n);
    store_own<3>(c, {p_p, r_p, buf_p}, {PP, RR, X}, nrb);
    pair_read<true>(c, PAIR, best, n);
    append(si, L, c, best, n, p, -1, rounds);
    flush<C, true>(a, si, L, c, cnt);
    update_stats(a, c, p, k, si[L.misc], EQ, ELO, EHI);
  }
  edge_counters(a, c, ELO, EHI, false);
  finish<C>(c);
  store_key<kPolicy>(a, c, key);
}

using Kernel = void (*)(FusedArgs);

template <int C>
Kernel pick_for(int algebra, int policy, int sparse) {
  static const Kernel minplus[kPolicies][2] = {
      {fused_minplus_kernel<kPriority, false, C>,
       fused_minplus_kernel<kPriority, true, C>},
      {fused_minplus_kernel<kFifo, false, C>,
       fused_minplus_kernel<kFifo, true, C>},
      {fused_minplus_kernel<kMaxOps, false, C>,
       fused_minplus_kernel<kMaxOps, true, C>},
      {fused_minplus_kernel<kRandom, false, C>,
       fused_minplus_kernel<kRandom, true, C>}};
  static const Kernel push[kPolicies] = {fused_push_kernel<kPriority, C>,
                                         fused_push_kernel<kFifo, C>,
                                         fused_push_kernel<kMaxOps, C>,
                                         fused_push_kernel<kRandom, C>};
  if (algebra == kMinplus) return minplus[policy][sparse];
  if (algebra == kPush && !sparse) return push[policy];
  return nullptr;
}

// The cluster sizes compiled in (kernels/fused_visit/ops.CLUSTER_SIZES).
constexpr int kClusters[3] = {1, 4, 8};

int cluster_index(int cluster) {
  for (int i = 0; i < 3; ++i)
    if (kClusters[i] == cluster) return i;
  return -1;
}

Kernel pick(int algebra, int policy, int sparse, int cluster) {
  if (policy < 0 || policy >= kPolicies || sparse < 0 || sparse > 1)
    return nullptr;
  switch (cluster) {
    case 1: return pick_for<1>(algebra, policy, sparse);
    case 4: return pick_for<4>(algebra, policy, sparse);
    case 8: return pick_for<8>(algebra, policy, sparse);
    default: return nullptr;
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// Dynamic shared-memory bytes of one CTA for (algebra, Q, B, cluster), or
// -1 for a cluster size that is not compiled in.
extern "C" long long fg_fused_visit_smem(int algebra, int Q, int B,
                                         int cluster) {
  if (cluster_index(cluster) < 0 || Q <= 0 || B <= 0) return -1;
  return static_cast<long long>(layout(algebra, Q, B, cluster).total);
}

// One chunk of up to a->launches visits (fewer when no partition holds a
// pending op, or the order ring of K is full), as one cluster of `cluster`
// CTAs with a->smem_bytes of dynamic shared memory each.  Returns a CUDA
// error code, or -1 when a->smem_bytes is below what the layout needs.
extern "C" int fg_fused_visit(const FusedArgs* a, int algebra, int policy,
                              int sparse, int cluster, void* stream) {
  if (a->P <= 0 || a->Q <= 0 || a->B <= 0 || a->K <= 0 || a->launches < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Kernel k = pick(algebra, policy, sparse, cluster);
  if (k == nullptr || (policy == kRandom && a->key == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<size_t>(a->smem_bytes) <
      layout(algebra, a->Q, a->B, cluster).total)
    return kErrSmem;
  FusedArgs args = *a;
  args.bulk = (a->B % 4 == 0 && aligned16(a->plane0) &&
               aligned16(a->plane1) && aligned16(a->buf))
                  ? 1
                  : 0;
  // raise the kernel's dynamic shared-memory cap once per size
  static int configured[3][2][kPolicies][2] = {};
  int& cap = configured[cluster_index(cluster)][algebra][policy][sparse];
  if (a->smem_bytes > cap) {
    const cudaError_t e = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, a->smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    cap = a->smem_bytes;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(a->smem_bytes);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, k, args);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
