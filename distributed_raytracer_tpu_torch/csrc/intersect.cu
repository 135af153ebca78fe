// The dense closest hit: every ray's nearest sphere over the whole scene.
//
// Replaces K11, distributed_raytracer_tpu/ops/pallas/intersect_kernel.py::
// _intersect_kernel (:50; pallas_call :141 in _closest_hit_pallas_fwd_impl
// :117, public closest_hit_pallas :174).  Rays [R, 3] against the packed
// scene (cx, cy, cz, r2) [N, 4], r2 = -1 on padding: the half-b quadratic
// in the oc form with a strict T_MIN, giving t [R] (DR_BIG on a miss) and
// the winner's index [R] (0 on a miss).  hit = t < BIG / 2 is the caller's.
//
// What is not carried over is the TPU blocking: rays on the 128 lanes of
// (1, BR) rows and the sphere axis as a second grid dimension of
// (CHUNK, 1) VMEM columns, whose per-chunk argmin is merged into an output
// block that stays resident across the sweep.  Here one thread holds one
// ray and its running (best, index) in registers; the block stages the
// scene through shared memory in float4 tiles of TILE spheres, looping
// over tiles for any N.  Within a tile the sweep is bounce.cuh's
// (sweep_range: ascending index, strict <), and the strict < carries across
// tiles in index order, so a tie keeps the first index: what JAX's
// chunked argmin and the plain argmin give, bit for bit.
//
// Bound: FP32 throughput, 18 operations a live ray x sphere test and 8
// more when the discriminant is not negative (chip_smoke.py counts them);
// the bytes are the rays read once (24 B), t and idx written (8 B) and the
// scene (16 B a sphere).  At the wavefront engine's pool of 16,384 rays a
// launch fills about four warps of each SM, so the sweep's latency is
// exposed; the tile's shared-memory reads are broadcasts (every thread
// reads the same sphere).
//
// Built with -fmad=false (ops/kernels/_build.py), so it agrees with its
// plain version, ops/kernels/intersect_kernel.py::closest_hit_plain.
#include <cuda_runtime.h>

#include "trace.cuh"

#define THREADS 128
#define TILE 256

__global__ void __launch_bounds__(THREADS)
closest_hit_kernel(const float* __restrict__ o, const float* __restrict__ d,
                   const float4* __restrict__ sph, int n, int R, float* __restrict__ t_out,
                   int* __restrict__ idx_out, unsigned long long* __restrict__ stats) {
  __shared__ float4 tile[TILE];
  const int i = blockIdx.x * THREADS + threadIdx.x;
  const bool live = i < R;
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;
  if (live) {
    ox = o[3 * i];
    oy = o[3 * i + 1];
    oz = o[3 * i + 2];
    dx = d[3 * i];
    dy = d[3 * i + 1];
    dz = d[3 * i + 2];
  }
  const float a = dx * dx + dy * dy + dz * dz;
  const float inv_a = 1.0f / a;
  float best = DR_BIG;
  int bi = 0;
  unsigned long long near = 0;
  for (int j0 = 0; j0 < n; j0 += TILE) {
    const int len = min(TILE, n - j0);
    __syncthreads();  // the previous tile is swept
    for (int k = threadIdx.x; k < len; k += THREADS) tile[k] = sph[j0 + k];
    __syncthreads();
    if (live) sweep_range<true>(tile, 0, len, ox, oy, oz, dx, dy, dz, a, inv_a, best, bi,
                                &near, j0);
  }
  if (live) {
    t_out[i] = best;
    idx_out[i] = bi;
  }
  if (stats != nullptr) add_count(near, stats);
}

extern "C" int closest_hit_launch(const float* o, const float* d, const float* sph, int n,
                                  int R, float* t_out, int* idx_out,
                                  unsigned long long* stats, void* stream) {
  if (n < 1 || R < 1) return (int)cudaErrorInvalidValue;
  const int blocks = (R + THREADS - 1) / THREADS;
  closest_hit_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      o, d, reinterpret_cast<const float4*>(sph), n, R, t_out, idx_out, stats);
  return (int)cudaGetLastError();
}
