// Threefry-2x32 (20 rounds) as a device function, bit for bit the hash of
// jax._src.prng (its unrolled lowering): rotations (13, 15, 26, 6) and
// (17, 29, 16, 24) in turn, a key injection after every four rounds, the
// parity constant 0x1BD11BDA.  Shared by fg_threefry (threefry.cu) and the
// fused visit's random policy (fused_visit.cu); the plain version is
// kernels/threefry/ref.py.
#pragma once

#include <stdint.h>

namespace fg {

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// The two output words for the counter (x0, x1) under the key (k0, k1).
__device__ __forceinline__ uint2 threefry2x32(uint32_t k0, uint32_t k1,
                                              uint32_t x0, uint32_t x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl32(x1, rot[i % 2][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
  return make_uint2(x0, x1);
}

// jax's float32 uniform in [0, 1) from one counter's output words.
__device__ __forceinline__ float uniform_from_bits(uint2 o) {
  const uint32_t bits = ((o.x ^ o.y) >> 9) | 0x3F800000u;
  return __fsub_rn(__uint_as_float(bits), 1.0f);
}

}  // namespace fg
