// Hopper (sm_90a) kernel for the port's threefry stream (core/prng.py).
//
//   fg_threefry  element i < n: take the key (one shared [2] or one [2]
//                per element), fold in each of up to two words f_j[i]
//                (the key becomes the hash of the counter (0, f)), hash
//                the counter (x1[i] or 0, x2[i] or i or 0) and write the
//                two words, or jax's float32 uniform from them.
//
// Not a port of a Pallas kernel: the JAX package leaves threefry to XLA
// (jax.random).  In eager PyTorch one hash is ~140 elementwise kernels, so
// the port's fold_in / split / uniform and the random walk's tape draw
// (u = uniform(fold_in(fold_in(key, src), step)), three hashes) are one
// launch each here.  The same device function (threefry.cuh) runs inside
// the fused visit's random policy; this entry is how it is held bitwise
// against the plain version (kernels/threefry/ref.py) on the card.
//
// Words travel as int64 (the plain version's uint32-in-int64 layout), low
// 32 bits used.  Bound: per element ~79 integer operations a hash (20
// rounds of add, funnel-shift rotate and xor; the key schedule and five
// injections), against 4-32 bytes moved, so the integer rate bounds it.
#include "threefry.cuh"

struct ThreefryArgs {
  const int64_t* key;   // [2] (key_stride 0) or [n, 2] (key_stride 2)
  const int64_t* fold0; // [n] or null
  const int64_t* fold1; // [n] or null (only with fold0)
  const int64_t* x1;    // [n] counter high word, or null: 0
  const int64_t* x2;    // [n] counter low word, or null: i (iota) or 0
  int64_t* out1;        // [n] or null
  int64_t* out2;        // [n] or null
  float* u;             // [n] or null
  long long n;
  int key_stride;
  int iota;
};

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) threefry_kernel(const ThreefryArgs a) {
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) +
                     threadIdx.x;
       i < a.n; i += static_cast<long long>(gridDim.x) * kThreads) {
    const int64_t* kp = a.key + i * a.key_stride;
    uint32_t k0 = static_cast<uint32_t>(kp[0]);
    uint32_t k1 = static_cast<uint32_t>(kp[1]);
    if (a.fold0 != nullptr) {
      const uint2 k = fg::threefry2x32(k0, k1, 0u,
                                       static_cast<uint32_t>(a.fold0[i]));
      k0 = k.x;
      k1 = k.y;
      if (a.fold1 != nullptr) {
        const uint2 k2 = fg::threefry2x32(k0, k1, 0u,
                                          static_cast<uint32_t>(a.fold1[i]));
        k0 = k2.x;
        k1 = k2.y;
      }
    }
    const uint32_t hi = a.x1 != nullptr ? static_cast<uint32_t>(a.x1[i]) : 0u;
    const uint32_t lo = a.x2 != nullptr ? static_cast<uint32_t>(a.x2[i])
                        : a.iota          ? static_cast<uint32_t>(i)
                                          : 0u;
    const uint2 o = fg::threefry2x32(k0, k1, hi, lo);
    if (a.u != nullptr) a.u[i] = fg::uniform_from_bits(o);
    if (a.out1 != nullptr) {
      a.out1[i] = static_cast<int64_t>(o.x);
      a.out2[i] = static_cast<int64_t>(o.y);
    }
  }
}

}  // namespace

// One launch over a->n elements on `stream`; returns a CUDA error code.
extern "C" int fg_threefry(const ThreefryArgs* a, void* stream) {
  if (a->n <= 0) return 0;
  if (a->key == nullptr || (a->key_stride != 0 && a->key_stride != 2) ||
      (a->fold1 != nullptr && a->fold0 == nullptr) ||
      (a->u == nullptr && (a->out1 == nullptr || a->out2 == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (a->n + kThreads - 1) / kThreads;
  const int grid = static_cast<int>(blocks < 132 * 16 ? blocks : 132 * 16);
  threefry_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}
