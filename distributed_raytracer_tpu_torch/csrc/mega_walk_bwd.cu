// The reverse tape walk: scene-parameter cotangents from the recorded tape.
//
// Replaces distributed_raytracer_tpu/ops/pallas/mega_walk_bwd_kernel.py::
// _walk_bwd_kernel (:59), the backward of the scene-gradient tracer, with
// its VJP body mega_bwd_kernel.py::_local_f_rows (:72) as csrc/local_f.cuh.
// What it computes is the same: for each ray, its rows from the last to
// the first, carrying the cotangents of (o, d, atten) from zero; at the
// finishing row g_color[i] is the cotangent of the contribution c2; the
// VJP of the replay bounce maps the row's output cotangents to its input
// cotangents; (o, d, atten)'s go to the row before, and the 9 winner-
// parameter cotangents (center 3, radius, albedo 3, fuzz, ior) are added
// into bin idx.  The carry is cut at the ray's first row (the take row),
// and the primary-ray cotangents are dropped (the camera tracer has no
// ray inputs).  What it does not carry over is the TPU scheduling: the
// reverse grid over pool rows, the [C, B] one-hot fetch of g_color and
// the two-level factored MXU segment-sum.
//
// Design: one thread per ray, in a grid-stride loop, walking its own rows
// of the depth-major tape (layout in tape.cuh).  The VJP is forward
// mode (local_f_vjp: one dual-number pass per differentiable input of
// the row, skipping inputs that cannot move the row's outputs).  Each
// block sums the cotangents of the first 513 bins (every sphere's and
// the no-hit bin up to 512 spheres: [n + 1, 9] f32, 18.5 KB) in shared
// memory with shared atomicAdd, then adds its nonzero entries to the
// global g_pm with one atomicAdd each.  Past 512 (the walk tracer's
// slots, 8,448 at the bench shape: 304 KB, more than a block's 227 KB) a
// cotangent of a later bin goes straight to g_pm with a global
// atomicAdd.  The walk's first slots are the always-swept ground and the
// chunks nearest the camera, which most rows hit, so most sums stay in
// shared memory (PERF.md section 6 has the times, from chip_smoke.py).
// Sums are taken in an order that changes from run to run.  A row that
// hit nothing has parameter cotangents that are exactly zero (its
// outputs do not depend on the winner's parameters), so the no-hit bin n
// stays zero.  A ray
// whose cotangents are all zero is skipped from there on: a ray that
// reached max_depth without finishing costs one flag read, an absorbed
// ray one row.
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

#include "local_f.cuh"
#include "tape.cuh"

#define MAX_SPHERES 512
#define THREADS 128
#define NPM 9

__global__ void __launch_bounds__(THREADS)
mega_walk_bwd_kernel(const float* __restrict__ tape,      // [max_depth, n_rays, 32]
                     const int* __restrict__ lengths,     // [n_rays]
                     const float* __restrict__ g_color,   // [n_rays, 3]
                     int n_rays, int n, float* __restrict__ g_pm) {  // [n + 1, 9], zeroed
  __shared__ float s_acc[(MAX_SPHERES + 1) * NPM];
  const int n_sh = min(n + 1, MAX_SPHERES + 1);  // the bins held in shared memory
  for (int e = threadIdx.x; e < n_sh * NPM; e += blockDim.x) s_acc[e] = 0.0f;
  __syncthreads();

  const size_t depth_stride = (size_t)n_rays * TAPE_COLS;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n_rays; i += gridDim.x * blockDim.x) {
    const int len = lengths[i];
    if (len <= 0) continue;
    const float* ray_rows = tape + (size_t)i * TAPE_COLS;
    const int last_flags = __float_as_int(ray_rows[(size_t)(len - 1) * depth_stride + T_FLG]);
    float cot[LF_OUT];
#pragma unroll
    for (int j = 0; j < 9; ++j) cot[j] = 0.0f;
    cot[9] = g_color[3 * i + 0];
    cot[10] = g_color[3 * i + 1];
    cot[11] = g_color[3 * i + 2];
    if (!(last_flags & F_FIN) || (cot[9] == 0.0f && cot[10] == 0.0f && cot[11] == 0.0f)) {
      continue;  // a depth-exhausted ray contributes black: no cotangent
    }
    for (int depth = len - 1; depth >= 0; --depth) {
      float row[TAPE_COLS];
      tape_load(ray_rows + (size_t)depth * depth_stride, row);
      float in[LF_IN];
#pragma unroll
      for (int k = 0; k < 9; ++k) in[k] = row[T_O + k];  // o, d, atten: adjacent
#pragma unroll
      for (int k = 0; k < 9; ++k) in[9 + k] = row[T_CW + k];  // c3 r albedo3 fuzz ior
      const float ru[3] = {row[T_RU], row[T_RU + 1], row[T_RU + 2]};
      const float u = row[T_U];
      const float mt = row[T_MT];
      const int idx = __float_as_int(row[T_IDX]);
      const int flags = __float_as_int(row[T_FLG]);
      const bool hit = (flags & F_HIT) != 0;
      const bool act = (flags & F_ACT) != 0;
      float cin[LF_IN];
      local_f_vjp(in, mt, ru, u, hit, act, cot, depth > 0, cin);
      if (hit) {
#pragma unroll
        for (int p = 0; p < NPM; ++p) {
          if (cin[9 + p] == 0.0f) continue;
          if (idx < n_sh) {
            atomicAdd(&s_acc[idx * NPM + p], cin[9 + p]);
          } else {
            atomicAdd(&g_pm[idx * NPM + p], cin[9 + p]);
          }
        }
      }
      bool any = false;
#pragma unroll
      for (int j = 0; j < 9; ++j) {
        cot[j] = cin[j];
        any = any || cin[j] != 0.0f;
      }
      cot[9] = cot[10] = cot[11] = 0.0f;
      if (!any) break;  // nothing flows to the rows before
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < n_sh * NPM; e += blockDim.x) {
    if (s_acc[e] != 0.0f) atomicAdd(&g_pm[e], s_acc[e]);
  }
}

extern "C" int mega_walk_bwd_launch(const float* tape, const int* lengths, const float* g_color,
                                    int n_rays, int n, int blocks, float* g_pm, void* stream) {
  if (n < 1 || n_rays < 1 || blocks < 1) return (int)cudaErrorInvalidValue;
  mega_walk_bwd_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(tape, lengths, g_color,
                                                                     n_rays, n, g_pm);
  return (int)cudaGetLastError();
}
