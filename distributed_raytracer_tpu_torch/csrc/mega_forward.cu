// The recording forward: one image sample (or one batch of given rays)
// that also writes the tape the backward walks.
//
// Replaces distributed_raytracer_tpu/ops/pallas/mega_kernel.py::
// _mega_kernel (:102) in both its modes: camera mode with recorded winner
// params and the packed int columns (mega_forward_camera :577, the
// forward of the scene- and pose-gradient tracers), and ray mode
// (mega_forward :512, the forward of the ray-table tracer), where the
// primary rays come from a ray table [n_rays, 3] x 2 and the ray index
// keys the bounce draws (JAX's lane_ray with no rid base).  What it
// computes is the same: camera rays made in the kernel or read from the
// table, sweep + shade per bounce until each ray finishes or reaches
// max_depth, every draw keyed by (rid, depth), and one tape row per
// bounce holding the pre-bounce state, the draws, the contribution, the
// winner's parameters and the flags.  What it does not carry over is the
// TPU scheduling: the 128-lane pool with private queues, the done flag,
// the parity padding of the row count and the budget (every ray runs to
// its end, so none is ever truncated).
//
// Bound: the render kernel's, FP32 issue in the sweep: 18 FP32
// operations per ray x live-sphere test and 8 more per test whose
// discriminant is not negative (csrc/mega_render.cu; chip_smoke.py counts
// them on the run's rays).  The tape rows written (2.93 per ray x 810,000
// rays x 128 B = 304 MB at the main path) take 0.09 ms at 3.35 TB/s, so
// bytes are not the bound.
//
// Design: the render kernel's (csrc/mega_render.cu): the persistent,
// compacting loop of persist.cuh over the scene staged in shared memory,
// instantiated with RECORD = true: the same bounce_once (trace.cuh), so at
// equal seeds the colors equal the render kernel's bit for bit, and one
// tape row written per bounce, by the thread that holds the ray at that
// step.  The lane use it reaches is counted (warp steps).  The tape is
// depth-major, [max_depth, R, 32] f32, its columns and flags named once in
// tape.cuh (JAX's row meaning); a thread writes its row as eight 16-byte
// stores.  Rows at depth >= lengths[i] are not written.  Tensor cores, TMA
// and clusters do not serve, as in the render kernel.
//
// Built with -fmad=false (ops/kernels/_build.py), so it agrees with its
// plain versions, ops/kernels/mega_kernel.py::mega_forward_camera_plain
// and mega_forward_plain, bit for bit.  The winner's parameters are
// recorded in ray mode too (JAX's ray mode leaves them off its tape), so
// K8 can walk a ray-mode tape as well as K7, which re-reads them from the
// scene.
#include <cuda_runtime.h>
#include <cstdint>

#include "persist.cuh"

template <bool RAY_MODE>
__global__ void __launch_bounds__(PERSIST_THREADS)
mega_forward_kernel(const float* __restrict__ cols,   // [4, n]: cx, cy, cz, r2
                    const float* __restrict__ attrs,  // [11, n]: ops/kernels/bounce.py A_*
                    int n, const float* __restrict__ cam,  // camera mode, else null
                    const int* __restrict__ pixel_ids,  // [n_rays] or null: pix0 + i
                    const float* __restrict__ ray_o,    // ray mode: [n_rays, 3], else null
                    const float* __restrict__ ray_d,    // ray mode: [n_rays, 3], else null
                    uint32_t bounce_seed, uint32_t cam_seed, int pix0, int n_rays, int w,
                    int max_depth, float* __restrict__ tape, int* __restrict__ lengths,
                    float* __restrict__ colors,
                    unsigned long long* __restrict__ counts) {  // [3], zeroed: persist.cuh CNT_*
  __shared__ float4 s_sph[MAX_SPHERES];
  __shared__ float s_att[ATT_ROWS * MAX_SPHERES];
  __shared__ float s_cam[CAM_ROW];
  stage_scene(cols, attrs, n, cam, s_sph, s_att, s_cam);

  ResidentScene sc{s_sph, s_att, n};
  if constexpr (RAY_MODE) {  // the ray index keys the draws
    const TableRays rays{ray_o, ray_d};
    persist_trace<true>(sc, rays, (unsigned long long)n_rays, bounce_seed, max_depth, colors,
                        lengths, tape, counts);
  } else {  // the tracer passes no rid base: rid = the pixel
    const CameraRays rays{s_cam, pixel_ids, pix0, 0u, cam_seed, (uint32_t)w};
    persist_trace<true>(sc, rays, (unsigned long long)n_rays, bounce_seed, max_depth, colors,
                        lengths, tape, counts);
  }
}

extern "C" int mega_forward_blocks_per_sm(int ray_mode) {
  return ray_mode ? persist_blocks_per_sm(mega_forward_kernel<true>)
                  : persist_blocks_per_sm(mega_forward_kernel<false>);
}

// Camera mode: cam not null, ray_o = ray_d = null.  Ray mode: cam and
// pixel_ids null, ray_o and ray_d the ray table (cam_seed, pix0 and w
// unused).  grid: the most blocks to launch (the wrapper passes SMs x
// mega_forward_blocks_per_sm(mode), or fewer).
extern "C" int mega_forward_launch(const float* cols, const float* attrs, int n, const float* cam,
                                   const int* pixel_ids, const float* ray_o, const float* ray_d,
                                   int bounce_seed, int cam_seed, int pix0, int n_rays, int w,
                                   int max_depth, float* tape, int* lengths, float* colors,
                                   unsigned long long* counts, int grid, void* stream) {
  const bool ray_mode = ray_o != nullptr && ray_d != nullptr;
  const bool cam_mode = cam != nullptr && ray_o == nullptr && ray_d == nullptr;
  if (n < 1 || n > MAX_SPHERES || n_rays < 1 || max_depth < 1 || !(ray_mode || cam_mode) ||
      (cam_mode && w < 1) || (ray_mode && (cam != nullptr || pixel_ids != nullptr)) ||
      grid < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int blocks = persist_blocks(grid, n_rays);
  // two instantiations, so camera mode does not carry ray mode's operands
  if (ray_mode) {
    mega_forward_kernel<true><<<blocks, PERSIST_THREADS, 0, (cudaStream_t)stream>>>(
        cols, attrs, n, cam, pixel_ids, ray_o, ray_d, (uint32_t)bounce_seed, (uint32_t)cam_seed,
        pix0, n_rays, w, max_depth, tape, lengths, colors, counts);
  } else {
    mega_forward_kernel<false><<<blocks, PERSIST_THREADS, 0, (cudaStream_t)stream>>>(
        cols, attrs, n, cam, pixel_ids, ray_o, ray_d, (uint32_t)bounce_seed, (uint32_t)cam_seed,
        pix0, n_rays, w, max_depth, tape, lengths, colors, counts);
  }
  return (int)cudaGetLastError();
}
