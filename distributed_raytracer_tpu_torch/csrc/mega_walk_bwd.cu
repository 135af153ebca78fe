// The reverse tape walk: scene-parameter cotangents from the recorded tape
// (and, on request, the primary-ray cotangents).
//
// Replaces distributed_raytracer_tpu/ops/pallas/mega_walk_bwd_kernel.py::
// _walk_bwd_kernel (:59), the backward of the scene- and pose-gradient
// tracers (mega_walk_backward :211, with and without ray_grads), with its
// VJP body mega_bwd_kernel.py::_local_f_rows (:72) as csrc/local_f.cuh.
// What it computes is the same: the reverse walk of every ray's rows with
// the winner's parameters read off the tape, the 9 parameter cotangents
// summed per sphere into g_pm [n + 1, 9], and with ray_grads the
// cotangents of each ray's primary (o, d) at its first row, [R, 6].  What
// it does not carry over is the TPU scheduling: the reverse grid over
// pool rows, the [C, B] one-hot fetch of g_color, the two-level factored
// MXU segment-sum and the dense [T, 8, B] primary-cotangent rows gathered
// at refill positions (the tape is per ray here, so each ray's cotangents
// are written to its own row of [R, 6]).
//
// Design: the walk is csrc/walk_bwd.cuh (shared with K7, csrc/mega_bwd.cu,
// which re-reads the parameters from the scene instead): persistent,
// compacting blocks that keep a pool of reverse carries in shared memory,
// walk one row of every live carry per step, refill free slots from a
// global ray counter and repack the carries that go on into whole warps,
// so a warp no longer waits for its longest ray; the VJP by forward mode
// (local_f_vjp: one dual-number pass per differentiable input of the row,
// skipping inputs that cannot move the row's outputs); the segment sum
// aggregated per warp by bin before its atomics, into the block's shared
// accumulator for the first 513 bins and into g_pm past them.  The
// walk's first slots are the always-swept ground and the chunks nearest
// the camera, which most rows hit, so most sums stay in shared memory
// (PERF.md section 6 has the times, from chip_smoke.py).  Without ray
// grads the first row skips its o, d and atten passes; with them it runs
// the six o and d passes (atten is the constant 1 there): two
// instantiations, so the walk without ray grads carries no ray rows.
//
// Bound: bytes, the tape rows read (2.19 M rows of finished rays x 128 B
// = 280 MB at the main path: 0.088 ms at 3.35 TB/s), against operations,
// one reverse evaluation of the replay bounce per row.  local_f's forward
// value costs, counted from local_f.cuh (+ - * / sqrt rsqrt one each): 46
// FP32 operations common to a hit, then 52 for a Lambertian row, 83
// metal, 102 dielectric (mean of the reflect and refract arms), 49
// transparent, 46 absorbing, 26 for a miss; one reverse evaluation is
// counted as 3x that (chip_smoke.py LOCAL_F_FLOPS): about 0.005 ms at
// the FP32 peak, so bytes bound it.  This kernel does 4 to 17 forward-
// mode passes per row instead of one reverse sweep, each about twice the
// forward's operations, and its threads diverge by material and path
// length: it is far from its bound by design; a hand-written reverse
// adjoint is the later speed work.
#include <cuda_runtime.h>
#include <cstdint>

#include "walk_bwd.cuh"

template <bool RAY_GRADS>
__global__ void __launch_bounds__(WALK_THREADS)
mega_walk_bwd_kernel(const float* __restrict__ tape,      // [max_depth, n_rays, 32]
                     const int* __restrict__ lengths,     // [n_rays]
                     const float* __restrict__ g_color,   // [n_rays, 3]
                     const int* __restrict__ order,       // [n_rays] permutation
                     int n_rays, int n, float* __restrict__ g_pm,  // [n + 1, 9], zeroed
                     float* __restrict__ g_ray,                    // [n_rays, 6] or null
                     unsigned long long* __restrict__ counts) {    // [3], zeroed
  __shared__ float s_acc[(MAX_SPHERES + 1) * NPM];
  reverse_walk<RAY_GRADS>(TapeParams{}, tape, lengths, g_color, order, n_rays, n, g_pm, g_ray,
                          s_acc, counts);
}

extern "C" int mega_walk_bwd_blocks_per_sm(int ray_grads) {
  return ray_grads ? persist_blocks_per_sm(mega_walk_bwd_kernel<true>, WALK_THREADS)
                   : persist_blocks_per_sm(mega_walk_bwd_kernel<false>, WALK_THREADS);
}

// g_ray null: the scene cotangents alone; else also the primary-ray
// cotangents into g_ray (zeroed by the caller).  order: the order in which
// the rays are fed, a permutation of 0 .. n_rays-1 (the wrapper passes the
// longest rays first).  grid: the most blocks to launch (the wrapper
// passes SMs x mega_walk_bwd_blocks_per_sm(ray_grads), or fewer).
extern "C" int mega_walk_bwd_launch(const float* tape, const int* lengths, const float* g_color,
                                    const int* order, int n_rays, int n, int grid, float* g_pm,
                                    float* g_ray, unsigned long long* counts, void* stream) {
  if (n < 1 || n_rays < 1 || grid < 1 || order == nullptr) return (int)cudaErrorInvalidValue;
  const int blocks = persist_blocks(grid, n_rays, WALK_THREADS);
  if (g_ray != nullptr) {
    mega_walk_bwd_kernel<true><<<blocks, WALK_THREADS, 0, (cudaStream_t)stream>>>(
        tape, lengths, g_color, order, n_rays, n, g_pm, g_ray, counts);
  } else {
    mega_walk_bwd_kernel<false><<<blocks, WALK_THREADS, 0, (cudaStream_t)stream>>>(
        tape, lengths, g_color, order, n_rays, n, g_pm, nullptr, counts);
  }
  return (int)cudaGetLastError();
}
