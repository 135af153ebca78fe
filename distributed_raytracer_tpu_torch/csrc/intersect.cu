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
// block that stays resident across the sweep.
//
// Design: DR_DENSE_GROUP consecutive threads hold one ray and sweep the
// scene together (trace.cuh group_sweep: lane q tests spheres q, q + G,
// ..., then a (t, index) minimum over the group by warp reductions), so a
// pool of 16,384 rays launches G times the warps that one thread per ray
// did (about four warps of each SM, each thread's chain of dependent
// sphere tests run at full latency), and a lane's chain is n / G tests
// long.  The lanes read the sweep columns from global memory (L1/L2-
// resident: 8 KB at 512 spheres, 131 KB at 8,193).  The shape, 16 lanes a
// ray in blocks of 512 threads, is the fastest that
// scripts/torch_group_probe.py found on the reference engine's pool batch
// and on 16,384 random rays over the 8,192-sphere field, where staging the
// columns in shared memory (scripts/group_probe_dense.cu) was no faster
// (PERF.md section 6).  The group's first thread writes t and idx.
//
// Bound: FP32 throughput, 18 operations a live ray x sphere test and 8
// more when the discriminant is not negative (chip_smoke.py counts them);
// the bytes are the rays read once (24 B), t and idx written (8 B) and the
// scene (16 B a sphere).  Known cost: a group's lanes read G distinct
// spheres at a time, where one thread per ray shared each read across a
// warp of 32 rays.
//
// Built with -fmad=false (ops/kernels/_build.py), so it agrees with its
// plain version, ops/kernels/intersect_kernel.py::closest_hit_plain.
#include <cuda_runtime.h>
#include <climits>

// the launch shape (a probe builds others with -D)
#ifndef DR_DENSE_GROUP
#define DR_DENSE_GROUP 16
#endif
#ifndef DR_DENSE_THREADS
#define DR_DENSE_THREADS 512
#endif

#include "trace.cuh"

// DR_DENSE_GROUP consecutive threads sweep ray thread / DR_DENSE_GROUP
// over the n spheres; counts the tests with disc >= 0 into *stats.
__global__ void __launch_bounds__(DR_DENSE_THREADS)
closest_hit_kernel(const float* __restrict__ o, const float* __restrict__ d,
                   const float4* __restrict__ sph, int n, int R, float* __restrict__ t_out,
                   int* __restrict__ idx_out, unsigned long long* __restrict__ stats) {
  const int i = (blockIdx.x * DR_DENSE_THREADS + threadIdx.x) / DR_DENSE_GROUP;
  unsigned long long near = 0;
  if (i < R) {
    const float ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
    const float dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
    const float a = dx * dx + dy * dy + dz * dz;
    int bi;
    const float t = group_sweep<DR_DENSE_GROUP>(sph, 0, n, ox, oy, oz, dx, dy, dz, a, 1.0f / a,
                                                &bi, &near);
    if ((threadIdx.x & (DR_DENSE_GROUP - 1)) == 0) {
      t_out[i] = t;
      idx_out[i] = bi;
    }
  }
  if (stats != nullptr) add_count(near, stats);
}

extern "C" int closest_hit_launch(const float* o, const float* d, const float* sph, int n,
                                  int R, float* t_out, int* idx_out,
                                  unsigned long long* stats, void* stream) {
  if (n < 1 || R < 1 || R > (INT_MAX - DR_DENSE_THREADS) / DR_DENSE_GROUP) {
    return (int)cudaErrorInvalidValue;
  }
  const int blocks = (R * DR_DENSE_GROUP + DR_DENSE_THREADS - 1) / DR_DENSE_THREADS;
  closest_hit_kernel<<<blocks, DR_DENSE_THREADS, 0, (cudaStream_t)stream>>>(
      o, d, reinterpret_cast<const float4*>(sph), n, R, t_out, idx_out, stats);
  return (int)cudaGetLastError();
}

// The launch shape: lanes (threads) per ray, threads per block.
extern "C" void closest_hit_shape(int* shape) {
  shape[0] = DR_DENSE_GROUP;
  shape[1] = DR_DENSE_THREADS;
}
