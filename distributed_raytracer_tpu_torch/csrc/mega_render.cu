// The mega render kernel: one whole image sample in one launch.
//
// Replaces distributed_raytracer_tpu/ops/pallas/mega_render_kernel.py::
// _mega_render_kernel (:179).  What it computes is the same: camera rays
// made in the kernel, then sweep + shade per bounce until each ray
// finishes or reaches max_depth, with every draw keyed by (rid, depth), so
// the image is a pure function of (scene, camera, seeds).  What it does
// not carry over is the TPU blocking: the bf16 hi/mid/lo MXU one-hot
// select (a thread reads its winner's attributes directly), the 128-lane
// private queues with refill, and the budget / clean-flag re-render (a
// thread loops until its ray is done, so no ray is ever truncated).
//
// Design: one thread per (sample, pixel) ray.  Each block first copies
// the scene's sweep columns (cx, cy, cz, r2) and seven winner attributes
// into shared memory (512 x 11 x 4 B = 22.5 KB at most), then every
// thread walks its ray through up to max_depth bounces (trace_ray<false>
// in trace.cuh, the loop the recording forward shares).
//
// Bound: FP32 throughput in the sweep.  Each ray x live-sphere test costs 18
// FP32 operations (oc 3, h 5, c_q 6, disc 3, the compare 1), and a test
// whose discriminant is not negative 8 more (sqrt, two roots of 2 each,
// three compares); padding spheres (r2 = -1) never hit and are not
// counted.  chip_smoke.py counts both kinds of test on the run's rays.
// Bytes are negligible (the scene stays in shared memory and each ray
// writes 12 B).  Known cost: thread-per-ray divergence, since
// the rays of a warp finish after different numbers of bounces and take
// different material branches.  Regrouping rays by state is work for a
// later kernel.
//
// Built with -fmad=false (ops/kernels/_build.py), so it agrees with its
// plain version, ops/kernels/mega_render_kernel.py::mega_render_plain,
// as closely as two programs on one card can.
#include <cuda_runtime.h>
#include <cstdint>

#include "trace.cuh"

#define THREADS 128

__global__ void __launch_bounds__(THREADS)
mega_render_kernel(const float* __restrict__ cols,   // [4, n]: cx, cy, cz, r2
                   const float* __restrict__ attrs,  // [11, n]: ops/kernels/bounce.py A_*
                   int n, const float* __restrict__ cam, uint32_t bounce_seed,
                   uint32_t cam_seed, uint32_t rid_base, int pix0, int n_valid, int n_cap,
                   int w, int max_depth, float* __restrict__ colors,
                   unsigned long long* __restrict__ bounces) {
  __shared__ float4 s_sph[MAX_SPHERES];
  __shared__ float s_att[ATT_ROWS * MAX_SPHERES];
  __shared__ float s_cam[CAM_ROW];
  stage_scene(cols, attrs, n, cam, s_sph, s_att, s_cam);

  const int local = blockIdx.x * blockDim.x + threadIdx.x;
  unsigned long long my_bounces = 0;
  if (local < n_cap) {
    float col[3] = {0.0f, 0.0f, 0.0f};
    if (local < n_valid) {
      const uint32_t pix = (uint32_t)(pix0 + local);
      const uint32_t rid = rid_base + pix;  // global ray id, wraps as int32 does
      ResidentScene sc{s_sph, s_att, n};
      my_bounces = trace_ray<false>(sc, s_cam, pix, rid, bounce_seed, cam_seed, (uint32_t)w,
                                    max_depth, col);
    }
    colors[3 * local + 0] = col[0];
    colors[3 * local + 1] = col[1];
    colors[3 * local + 2] = col[2];
  }
  add_count(my_bounces, bounces);
}

extern "C" int mega_render_launch(const float* cols, const float* attrs, int n,
                                  const float* cam, int bounce_seed, int cam_seed,
                                  unsigned int rid_base, int pix0, int n_valid, int n_cap,
                                  int w, int max_depth, float* colors,
                                  unsigned long long* bounces, void* stream) {
  if (n < 1 || n > MAX_SPHERES || n_cap < 1 || n_valid > n_cap || w < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int blocks = (n_cap + THREADS - 1) / THREADS;
  mega_render_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      cols, attrs, n, cam, (uint32_t)bounce_seed, (uint32_t)cam_seed, rid_base, pix0, n_valid,
      n_cap, w, max_depth, colors, bounces);
  return (int)cudaGetLastError();
}
