// One camera ray traced to its end: the bounce loop of the mega render
// kernel (csrc/mega_render.cu) and of the recording forward
// (csrc/mega_forward.cu), written once.
//
// trace_ray<false> is the render kernel's loop; trace_ray<true> runs the
// same loop with the recording shade<true> (bounce.cuh) and also writes
// one tape row per bounce (tape.cuh).  Both compute the same values in
// the same order, so at equal seeds their colors are equal bit for bit.
#pragma once
#include <cstdint>

#include "bounce.cuh"
#include "camera.cuh"
#include "tape.cuh"

#define MAX_SPHERES 512

// Copies the scene's sweep columns (cx, cy, cz, r2), its seven winner
// attributes and the camera row into the block's shared memory (512 x 11
// x 4 B = 22.5 KB at most), then syncs the block.
__device__ __forceinline__ void stage_scene(const float* __restrict__ cols,
                                            const float* __restrict__ attrs, int n,
                                            const float* __restrict__ cam, float4* s_sph,
                                            float* s_att, float* s_cam) {
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    s_sph[j] = make_float4(cols[j], cols[n + j], cols[2 * n + j], cols[3 * n + j]);
#pragma unroll
    for (int r = 0; r < ATT_ROWS; ++r) s_att[r * MAX_SPHERES + j] = attrs[(3 + r) * n + j];
  }
  if (threadIdx.x < CAM_ROW) s_cam[threadIdx.x] = cam[threadIdx.x];
  __syncthreads();
}

// Adds each thread's bounce count to *total, one atomic per warp.  Every
// thread of the block calls it.
__device__ __forceinline__ void add_bounces(unsigned long long mine,
                                            unsigned long long* total) {
  for (int off = 16; off > 0; off >>= 1) mine += __shfl_down_sync(0xFFFFFFFFu, mine, off);
  if ((threadIdx.x & 31) == 0 && mine) atomicAdd(total, mine);
}

// Traces the camera ray of pixel pix (draws keyed by rid) through sweep +
// shade until it finishes or reaches max_depth, against the staged scene
// (sph, att, cam in shared memory).  col gets its color: atten x the
// terminal color, black when it was absorbed or ran out of depth.
// Returns the bounces it ran.
//
// RECORD: bounce k also writes tape row tape[k * depth_stride] (tape
// points at the ray's depth-0 row): the pre-bounce o, d and atten, the
// four draws, the contribution (the color on the finishing row, else 0),
// the winner's parameters (zero on a miss), the winner index, the ray
// index `ray` and the flags.  So the bounces run are the rows written.
template <bool RECORD>
__device__ __forceinline__ int trace_ray(const float4* sph, const float* att, int n,
                                         const float* cam, uint32_t pix, uint32_t rid,
                                         uint32_t bounce_seed, uint32_t cam_seed, uint32_t w,
                                         int max_depth, float col[3], float* tape = nullptr,
                                         size_t depth_stride = 0, int ray = 0) {
  float o[3], d[3];
  camera_ray(cam, pix, rid, cam_seed, w, o, d);
  float atten[3] = {1.0f, 1.0f, 1.0f};
  col[0] = col[1] = col[2] = 0.0f;
  int depth = 0;
  while (depth < max_depth) {
    float row[TAPE_COLS];
    if (RECORD) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        row[T_O + k] = o[k];
        row[T_D + k] = d[k];
        row[T_AT + k] = atten[k];
      }
    }
    const float a = d[0] * d[0] + d[1] * d[1] + d[2] * d[2];
    const float inv_a = 1.0f / a;
    int bi;
    const float t = sweep_winner(sph, n, o[0], o[1], o[2], d[0], d[1], d[2], a, inv_a, &bi);
    const uint32_t seed = bounce_seed + (uint32_t)depth * 65537u;
    float at[3], co[3], rec[4];
    const bool fin =
        shade<RECORD>(o, d, a, t, sph, att, MAX_SPHERES, bi, rid, seed, at, co, rec);
    if (RECORD) {
      const bool hit = t < DR_BIG * 0.5f;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        row[T_RU + k] = rec[k];
        row[T_CO + k] = fin ? atten[k] * co[k] : 0.0f;
      }
      row[T_U] = rec[3];
      const float4 s = hit ? sph[bi] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      row[T_CW + 0] = s.x;
      row[T_CW + 1] = s.y;
      row[T_CW + 2] = s.z;
      row[T_RW] = hit ? att[ATT_RR * MAX_SPHERES + bi] : 0.0f;
      row[T_AW + 0] = hit ? att[ATT_AR * MAX_SPHERES + bi] : 0.0f;
      row[T_AW + 1] = hit ? att[ATT_AG * MAX_SPHERES + bi] : 0.0f;
      row[T_AW + 2] = hit ? att[ATT_AB * MAX_SPHERES + bi] : 0.0f;
      row[T_FW] = hit ? att[ATT_FZ * MAX_SPHERES + bi] : 0.0f;
      row[T_IW] = hit ? att[ATT_IO * MAX_SPHERES + bi] : 0.0f;
      row[T_MT] = hit ? att[ATT_MT * MAX_SPHERES + bi] : 0.0f;
      row[T_IDX] = __int_as_float(hit ? bi : 0);
      row[T_RAY] = __int_as_float(ray);
      row[T_FLG] = __int_as_float((hit ? F_HIT : 0) | F_ACT | (depth == 0 ? F_TAKE : 0) |
                                  (fin ? F_FIN : 0));
#pragma unroll
      for (int k = T_FLG + 1; k < TAPE_COLS; ++k) row[k] = 0.0f;
      tape_store(tape + (size_t)depth * depth_stride, row);
    }
    ++depth;
    if (fin) {
      col[0] = atten[0] * co[0];
      col[1] = atten[1] * co[1];
      col[2] = atten[2] * co[2];
      break;
    }
    atten[0] = atten[0] * at[0];
    atten[1] = atten[1] * at[1];
    atten[2] = atten[2] * at[2];
  }  // a ray still alive at max_depth contributes black
  return depth;
}
