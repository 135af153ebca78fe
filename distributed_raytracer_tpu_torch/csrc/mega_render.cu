// The mega render kernel: one whole image sample in one launch.
//
// Replaces distributed_raytracer_tpu/ops/pallas/mega_render_kernel.py::
// _mega_render_kernel (:179).  What it computes is the same: camera rays
// made in the kernel, then sweep + shade per bounce until each ray
// finishes or reaches max_depth, with every draw keyed by (rid, depth), so
// the image is a pure function of (scene, camera, seeds).  What it does
// not carry over is the TPU blocking: the bf16 hi/mid/lo MXU one-hot
// select (a thread reads its winner's attributes directly), the 128-lane
// private queues and the budget / clean-flag re-render (every ray runs to
// its end, so none is ever truncated).
//
// Bound: FP32 issue in the sweep.  Each ray x live-sphere test costs 18
// FP32 operations (oc 3, h 5, c_q 6, disc 3, the compare 1), and a test
// whose discriminant is not negative 8 more (sqrt, two roots of 2 each,
// three compares); padding spheres (r2 = -1) never hit and are not
// counted.  chip_smoke.py counts both kinds of test on the run's rays.
// Bytes are negligible (the scene stays in shared memory and each ray
// writes 12 B).
//
// Design: the persistent, compacting loop of persist.cuh, so that the
// sweep's issue goes to live rays.  One thread per ray from the camera to
// the ray's end left a warp sweeping until its longest ray ended: 23% of
// the lanes did useful work on the final scene at 1200x675 depth 50.  A
// grid of (SMs x blocks per SM) blocks of 256 threads each stage the scene
// (512 x 11 x 4 B = 22.5 KB at most) and the camera row in shared memory
// once, keep a pool of 256 ray states beside it (12 KB), and run one
// bounce of every live ray per step, refilling free slots from a global
// ray counter in pixel order and repacking the live rays into whole warps
// after each bounce.  The lane use it reaches is counted (warp steps).
// The divergence inside a bounce (the disc >= 0 branch of 0.38% of the
// tests, the material branches) stays.  Tensor cores do not serve: the
// test's products have a depth of 3 in f32, and TF32 would lose the bits
// the checks compare; nor do TMA or clusters, since the scene is 22.5 KB
// read once per block and the pool is the block's own.
//
// Built with -fmad=false (ops/kernels/_build.py), so it agrees with its
// plain version, ops/kernels/mega_render_kernel.py::mega_render_plain,
// bit for bit.
#include <cuda_runtime.h>
#include <cstdint>

#include "persist.cuh"

__global__ void __launch_bounds__(PERSIST_THREADS)
mega_render_kernel(const float* __restrict__ cols,   // [4, n]: cx, cy, cz, r2
                   const float* __restrict__ attrs,  // [11, n]: ops/kernels/bounce.py A_*
                   int n, const float* __restrict__ cam, uint32_t bounce_seed,
                   uint32_t cam_seed, uint32_t rid_base, int pix0, int n_valid, int n_cap,
                   int w, int max_depth, float* __restrict__ colors,
                   unsigned long long* __restrict__ counts) {  // [3], zeroed: persist.cuh CNT_*
  __shared__ float4 s_sph[MAX_SPHERES];
  __shared__ float s_att[ATT_ROWS * MAX_SPHERES];
  __shared__ float s_cam[CAM_ROW];
  stage_scene(cols, attrs, n, cam, s_sph, s_att, s_cam);

  // rows past n_valid (all of them when max_depth < 1) are zero
  const int n_work = max_depth > 0 ? n_valid : 0;
  for (int k = n_work + blockIdx.x * PERSIST_THREADS + threadIdx.x; k < n_cap;
       k += gridDim.x * PERSIST_THREADS) {
    colors[3 * k + 0] = colors[3 * k + 1] = colors[3 * k + 2] = 0.0f;
  }
  ResidentScene sc{s_sph, s_att, n};
  const CameraRays rays{s_cam, nullptr, pix0, rid_base, cam_seed, (uint32_t)w};
  persist_trace<false>(sc, rays, (unsigned long long)n_work, bounce_seed, max_depth, colors,
                       nullptr, nullptr, counts);
}

extern "C" int mega_render_blocks_per_sm() { return persist_blocks_per_sm(mega_render_kernel); }

// grid: the most blocks to launch (the wrapper passes SMs x
// mega_render_blocks_per_sm(), or fewer).
extern "C" int mega_render_launch(const float* cols, const float* attrs, int n,
                                  const float* cam, int bounce_seed, int cam_seed,
                                  unsigned int rid_base, int pix0, int n_valid, int n_cap,
                                  int w, int max_depth, float* colors,
                                  unsigned long long* counts, int grid, void* stream) {
  if (n < 1 || n > MAX_SPHERES || n_cap < 1 || n_valid < 0 || n_valid > n_cap || w < 1 ||
      grid < 1) {
    return (int)cudaErrorInvalidValue;
  }
  mega_render_kernel<<<persist_blocks(grid, n_cap), PERSIST_THREADS, 0, (cudaStream_t)stream>>>(
      cols, attrs, n, cam, (uint32_t)bounce_seed, (uint32_t)cam_seed, rid_base, pix0, n_valid,
      n_cap, w, max_depth, colors, counts);
  return (int)cudaGetLastError();
}
