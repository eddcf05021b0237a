// Counter-based normals shared by K2 (chain_resident.cu) and K4 (sde_scan.cu).
//
// Philox4x32-10 (Salmon et al., SC'11) maps a 128-bit counter and a 64-bit
// key to four random words; a Box-Muller transform of the first two gives a
// pair of independent standard normals (cosine and sine halves). A draw
// depends on its counter and key only, so a stream is the same at any launch
// shape. The plain PyTorch twin of both is
// ops/kernels/chain_resident.py::{philox4x32_10, philox_normal_reference}.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace upgdm {

// Philox4x32-10, counter (c0..c3), key (k0, k1).
__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
  const uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
  const uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t hi0 = __umulhi(M0, c.x), lo0 = M0 * c.x;
    const uint32_t hi1 = __umulhi(M1, c.z), lo1 = M1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
    k.x += W0;
    k.y += W1;
  }
  return c;
}

__device__ __forceinline__ uint2 philox_key(unsigned long long seed) {
  return make_uint2((uint32_t)seed, (uint32_t)(seed >> 32));
}

// Standard normal for (row, step, feature f) by Box-Muller on Philox bits,
// in float32: counter (row low, row high, step, f / 2), cosine for even f,
// sine for odd f. K2's stream.
__device__ __forceinline__ float philox_normal(unsigned long long seed, long long row,
                                               int step, int f) {
  const uint4 c = make_uint4((uint32_t)row, (uint32_t)((unsigned long long)row >> 32),
                             (uint32_t)step, (uint32_t)(f >> 1));
  const uint4 b = philox4x32_10(c, philox_key(seed));
  // u1 in (0, 1] so log(u1) is finite; 24 bits is all a float keeps
  const float u1 = ((float)(b.x >> 8) + 1.0f) * (1.0f / 16777216.0f);
  const float u2 = (float)(b.y >> 8) * (1.0f / 16777216.0f);
  const float rad = sqrtf(-2.0f * logf(u1));
  float sn, cs;
  sincospif(2.0f * u2, &sn, &cs);
  return rad * ((f & 1) ? sn : cs);
}

// Both halves of the Box-Muller pair of Philox words b, taken in float64 and
// rounded once to float32, as philox_normal_reference takes them (so the
// twin's normals equal the kernel's but for a float64 last bit that lands
// on a float32 rounding boundary): (rad cos(2 pi u2), rad sin(2 pi u2)).
__device__ __forceinline__ float2 box_muller_f64(uint4 b) {
  const double u1 = ((double)(b.x >> 8) + 1.0) / 16777216.0;
  const double u2 = (double)(b.y >> 8) / 16777216.0;
  const double rad = sqrt(-2.0 * log(u1));
  double sn, cs;
  sincos(6.283185307179586 * u2, &sn, &cs);
  return make_float2((float)(rad * cs), (float)(rad * sn));
}

}  // namespace upgdm
