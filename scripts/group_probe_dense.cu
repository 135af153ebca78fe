// Probe variants of the dense sweeps for scripts/torch_group_probe.py: the
// arms that the package's libraries do not launch on a scene of up to
// MAX_SPHERES spheres.  K10 (csrc/fused_bounce.cu, included whole) with
// the sweep columns read from global memory, where the package stages
// them in shared memory; and K11 (csrc/intersect.cu) with the sweep
// columns staged in shared memory, where the package reads them from
// global memory.  The probe builds this file with the same
// -DDR_DENSE_GROUP and -DDR_DENSE_THREADS as the package's two sources of
// each variant.  Not built into the package.
#include "../distributed_raytracer_tpu_torch/csrc/fused_bounce.cu"

// fused_bounce_launch's arguments; always the global-memory instantiation.
extern "C" int unstaged_fused_bounce_launch(const float* sph, const float* attrs, int n,
                                            const float* o, const float* d, const uint8_t* act,
                                            const int* rid, const float* draws, int seed, int R,
                                            float* new_o, float* new_d, float* atten,
                                            float* color, int* finished, int* idx,
                                            uint8_t* hit, float* ruv, float* u,
                                            unsigned long long* stats, void* stream) {
  if (n < 1 || R < 1 || R > (INT_MAX - DR_DENSE_THREADS) / DR_DENSE_GROUP) {
    return (int)cudaErrorInvalidValue;
  }
  const Lanes L = lanes(o, d, act, rid, draws, seed, R, new_o, new_d, atten, color, finished,
                        idx, hit, ruv, u);
  const int blocks = (R * DR_DENSE_GROUP + DR_DENSE_THREADS - 1) / DR_DENSE_THREADS;
  fused_bounce_kernel<false><<<blocks, DR_DENSE_THREADS, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(sph), attrs, n, L, stats);
  return (int)cudaGetLastError();
}

// K11's kernel (csrc/intersect.cu) with each block staging the sweep
// columns in shared memory first.
__global__ void __launch_bounds__(DR_DENSE_THREADS)
staged_closest_hit_kernel(const float* __restrict__ o, const float* __restrict__ d,
                          const float4* __restrict__ sph, int n, int R,
                          float* __restrict__ t_out, int* __restrict__ idx_out,
                          unsigned long long* __restrict__ stats) {
  __shared__ float4 s_sph[MAX_SPHERES];
  for (int j = threadIdx.x; j < n; j += DR_DENSE_THREADS) s_sph[j] = sph[j];
  __syncthreads();
  const int i = (blockIdx.x * DR_DENSE_THREADS + threadIdx.x) / DR_DENSE_GROUP;
  unsigned long long near = 0;
  if (i < R) {
    const float ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
    const float dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
    const float a = dx * dx + dy * dy + dz * dz;
    int bi;
    const float t = group_sweep<DR_DENSE_GROUP>(s_sph, 0, n, ox, oy, oz, dx, dy, dz, a,
                                                1.0f / a, &bi, &near);
    if ((threadIdx.x & (DR_DENSE_GROUP - 1)) == 0) {
      t_out[i] = t;
      idx_out[i] = bi;
    }
  }
  if (stats != nullptr) add_count(near, stats);
}

// closest_hit_launch's arguments; refuses a scene of more than MAX_SPHERES.
extern "C" int staged_closest_hit_launch(const float* o, const float* d, const float* sph,
                                         int n, int R, float* t_out, int* idx_out,
                                         unsigned long long* stats, void* stream) {
  if (n < 1 || n > MAX_SPHERES || R < 1 ||
      R > (INT_MAX - DR_DENSE_THREADS) / DR_DENSE_GROUP) {
    return (int)cudaErrorInvalidValue;
  }
  const int blocks = (R * DR_DENSE_GROUP + DR_DENSE_THREADS - 1) / DR_DENSE_THREADS;
  staged_closest_hit_kernel<<<blocks, DR_DENSE_THREADS, 0, (cudaStream_t)stream>>>(
      o, d, reinterpret_cast<const float4*>(sph), n, R, t_out, idx_out, stats);
  return (int)cudaGetLastError();
}
