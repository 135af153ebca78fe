// The dense reverse tape walk: scene-parameter and primary-ray cotangents
// from the recorded tape, the winner's parameters re-read from the scene.
//
// Replaces distributed_raytracer_tpu/ops/pallas/mega_bwd_kernel.py::
// _mega_bwd_kernel (:215), the backward of the ray-table tracer
// (mega_backward :376; make_tape_tracer(use_mega=True, mega_bwd=True)).
// What it computes is the same: the reverse walk of every ray's rows,
// each row's winner parameters fetched from the scene by the recorded
// winner index (JAX: the [48, m] bf16 attribute planes times a one-hot),
// the VJP of the replay bounce (_local_f_rows, here csrc/local_f.cuh), the
// 9 parameter cotangents summed per sphere into g_pm [n + 1, 9], and the
// primary-ray cotangents (d_o, d_d) of each ray at its first row.  What it
// does not carry over is the TPU scheduling: the reverse grid over pool
// rows with scalar prefetch, the [C, B] one-hot fetch of g_color, the
// MXU one-hot contraction into bf16x3 planes, and the dense [T, 8, B]
// cotangent rows that the caller gathers at refill positions: the tape is
// per ray here, so each ray's (d_o, d_d) is written to its row of [R, 6].
//
// Design: the walk is csrc/walk_bwd.cuh, shared with K8 (csrc/
// mega_walk_bwd.cu, which reads the parameters off the tape): persistent,
// compacting blocks with a pool of reverse carries, warp-aggregated
// segment sums.  The parameter source is SceneParams: the scene staged in
// shared memory by stage_scene (trace.cuh, as K5 and K6 stage it: 22.5
// KB), read by the row's winner index, with the radius from the
// attributes (not sqrt(r2)).  With the 513-bin accumulator (18.5 KB) and
// the pool of 128 carries (5.5 KB) the block holds about 46.7 KB of
// static shared memory, under the 48 KB static limit.  On a
// tape of the same scene it computes what K8 computes on that tape,
// value for value; only the order of the atomic sums differs.
//
// Bound: K8's: bytes, the tape rows of finished rays read once (128 B
// each), the scene, g_color, lengths, g_pm and the [R, 6] ray cotangents
// (chip_smoke.py counts them on the run's tape); the scene re-read costs
// shared-memory loads, not device-memory bytes.  Known cost, as K8: 4 to
// 17 forward-mode passes per row (6 more on a ray's first row for the ray
// cotangents) and divergence by material.
//
// Built with -fmad=false (ops/kernels/_build.py), like every kernel of
// the port; its plain version is ops/kernels/mega_bwd_kernel.py::
// mega_backward_plain.
#include <cuda_runtime.h>
#include <cstdint>

#include "trace.cuh"
#include "walk_bwd.cuh"

template <bool RAY_GRADS>
__global__ void __launch_bounds__(WALK_THREADS)
mega_bwd_kernel(const float* __restrict__ cols,     // [4, n]: cx, cy, cz, r2
                const float* __restrict__ attrs,    // [11, n]: ops/kernels/bounce.py A_*
                int n, const float* __restrict__ tape,  // [max_depth, n_rays, 32]
                const int* __restrict__ lengths,        // [n_rays]
                const float* __restrict__ g_color,      // [n_rays, 3]
                const int* __restrict__ order,          // [n_rays] permutation
                int n_rays, float* __restrict__ g_pm,   // [n + 1, 9], zeroed
                float* __restrict__ g_ray,              // [n_rays, 6] zeroed, or null
                unsigned long long* __restrict__ counts) {  // [3], zeroed
  __shared__ float4 s_sph[MAX_SPHERES];
  __shared__ float s_att[ATT_ROWS * MAX_SPHERES];
  __shared__ float s_acc[(MAX_SPHERES + 1) * NPM];
  stage_scene(cols, attrs, n, nullptr, s_sph, s_att, nullptr);
  reverse_walk<RAY_GRADS>(SceneParams{s_sph, s_att}, tape, lengths, g_color, order, n_rays, n,
                          g_pm, g_ray, s_acc, counts);
}

extern "C" int mega_bwd_blocks_per_sm(int ray_grads) {
  return ray_grads ? persist_blocks_per_sm(mega_bwd_kernel<true>, WALK_THREADS)
                   : persist_blocks_per_sm(mega_bwd_kernel<false>, WALK_THREADS);
}

// g_ray null: the scene cotangents alone; else also the primary-ray
// cotangents into g_ray (zeroed by the caller).  order and grid as
// csrc/mega_walk_bwd.cu's, with mega_bwd_blocks_per_sm(ray_grads).
extern "C" int mega_bwd_launch(const float* cols, const float* attrs, const float* tape,
                               const int* lengths, const float* g_color, const int* order,
                               int n_rays, int n, int grid, float* g_pm, float* g_ray,
                               unsigned long long* counts, void* stream) {
  if (n < 1 || n > MAX_SPHERES || n_rays < 1 || grid < 1 || order == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  const int blocks = persist_blocks(grid, n_rays, WALK_THREADS);
  if (g_ray != nullptr) {
    mega_bwd_kernel<true><<<blocks, WALK_THREADS, 0, (cudaStream_t)stream>>>(
        cols, attrs, n, tape, lengths, g_color, order, n_rays, g_pm, g_ray, counts);
  } else {
    mega_bwd_kernel<false><<<blocks, WALK_THREADS, 0, (cudaStream_t)stream>>>(
        cols, attrs, n, tape, lengths, g_color, order, n_rays, g_pm, nullptr, counts);
  }
  return (int)cudaGetLastError();
}
