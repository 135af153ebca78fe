// Counter-mode integer hash draws: the device-function port of
// distributed_raytracer_tpu/ops/pallas/culled_bounce_kernel.py::_hash_u01.
// The JAX version is int32 arithmetic with wrapping multiplies; uint32
// gives the same bits.  The right shifts mask the sign bit first, as the
// JAX version does.  Plain version: ops/kernels/hash.py::hash_u01.
#pragma once
#include <cstdint>

__device__ __forceinline__ float hash_u01(uint32_t rid, uint32_t seed, uint32_t d) {
  uint32_t h = rid * 0x9E3779B9u + seed + d * 0xC2B2AE35u;
  h ^= (h & 0x7FFFFFFFu) >> 16;
  h *= 0x85EBCA6Bu;
  h ^= (h & 0x7FFFFFFFu) >> 13;
  h *= 0xC2B2AE35u;
  h ^= (h & 0x7FFFFFFFu) >> 16;
  float u = (float)(h & 0x007FFFFFu) * (1.0f / 8388608.0f);
  return fminf(fmaxf(u, 1e-7f), 0.99999988f);  // clip to [1e-7, f32(1 - 1e-7)]
}
