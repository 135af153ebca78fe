// The reverse tape walk, written once for the two backward kernels:
// K8 (csrc/mega_walk_bwd.cu) reads each row's winner parameters off the
// tape (TapeParams), K7 (csrc/mega_bwd.cu) re-reads them from the scene
// staged in shared memory by the row's winner index (SceneParams).  The
// rows, the carries, the VJP (local_f.cuh), the segment-sum and the
// primary-ray cotangents are the same code for both, so on one tape the
// two differ only in the order of their atomic sums.
//
// For each ray, its rows from the last to the first, carrying the
// cotangents of (o, d, atten) from zero; at the finishing row g_color[i]
// is the cotangent of the contribution c2; the VJP of the replay bounce
// maps the row's output cotangents to its input cotangents; (o, d,
// atten)'s go to the row before, and the 9 winner-parameter cotangents
// (center 3, radius, albedo 3, fuzz, ior) are added into bin idx.  The
// carry is cut at the ray's first row (depth 0), whose (o, d) cotangents
// are the primary-ray cotangents: RAY_GRADS writes them to g_ray[i] (a
// ray whose cotangents all vanished earlier, one that did not finish,
// and one with no rows keep the zeros the wrapper wrote).
//
// One thread per ray, in a grid-stride loop, walking its own rows of the
// depth-major tape (layout in tape.cuh).  Each block sums the cotangents
// of the first 513 bins (every sphere's and the no-hit bin up to 512
// spheres: [n + 1, 9] f32, 18.5 KB) in shared memory with shared
// atomicAdd, then adds its nonzero entries to the global g_pm with one
// atomicAdd each.  Past 512 (the walk tracer's slots, 8,448 at the bench
// shape: 304 KB, more than a block's 227 KB) a cotangent of a later bin
// goes straight to g_pm with a global atomicAdd.  Sums are taken in an
// order that changes from run to run.  A row that hit nothing has
// parameter cotangents that are exactly zero (its outputs do not depend
// on the winner's parameters), so the no-hit bin n stays zero.  A ray
// whose cotangents are all zero is skipped from there on: a ray that
// reached max_depth without finishing costs one flag read, an absorbed
// ray one row.
#pragma once
#include "bounce.cuh"
#include "local_f.cuh"
#include "tape.cuh"

#define NPM 9

// The winner's parameters as recorded on the row (K8).
struct TapeParams {
  __device__ __forceinline__ void get(const float row[TAPE_COLS], bool hit, float p[NPM],
                                      float& mt) const {
#pragma unroll
    for (int k = 0; k < NPM; ++k) p[k] = row[T_CW + k];  // c3 r albedo3 fuzz ior
    mt = row[T_MT];
  }
};

// The winner's parameters re-read from the scene by the row's winner
// index (K7): the centers from the sweep columns, the radius (not
// sqrt(r2)), albedo, fuzz, ior and the material from the attributes,
// staged by stage_scene (trace.cuh, MAX_SPHERES columns); zeros on
// a miss, as the tape holds.
struct SceneParams {
  const float4* sph;  // [MAX_SPHERES] shared: cx cy cz r2
  const float* att;   // [ATT_ROWS, MAX_SPHERES] shared
  __device__ __forceinline__ void get(const float row[TAPE_COLS], bool hit, float p[NPM],
                                      float& mt) const {
    const int j = __float_as_int(row[T_IDX]);
    const float4 s = hit ? sph[j] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    p[0] = s.x;
    p[1] = s.y;
    p[2] = s.z;
    p[3] = hit ? att[ATT_RR * MAX_SPHERES + j] : 0.0f;
    p[4] = hit ? att[ATT_AR * MAX_SPHERES + j] : 0.0f;
    p[5] = hit ? att[ATT_AG * MAX_SPHERES + j] : 0.0f;
    p[6] = hit ? att[ATT_AB * MAX_SPHERES + j] : 0.0f;
    p[7] = hit ? att[ATT_FZ * MAX_SPHERES + j] : 0.0f;
    p[8] = hit ? att[ATT_IO * MAX_SPHERES + j] : 0.0f;
    mt = hit ? att[ATT_MT * MAX_SPHERES + j] : 0.0f;
  }
};

// The walk over rays blockIdx.x * blockDim.x + threadIdx.x, stepping by
// the grid; s_acc holds (MAX_SPHERES + 1) x NPM floats of shared
// memory.  Every thread of the block calls it.
template <bool RAY_GRADS, class Params>
__device__ __forceinline__ void reverse_walk(const Params& params,
                                             const float* __restrict__ tape,     // [depth, R, 32]
                                             const int* __restrict__ lengths,    // [R]
                                             const float* __restrict__ g_color,  // [R, 3]
                                             int n_rays, int n,
                                             float* __restrict__ g_pm,   // [n + 1, 9], zeroed
                                             float* __restrict__ g_ray,  // [R, 6], zeroed
                                             float* s_acc) {
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
      const int flags = __float_as_int(row[T_FLG]);
      const bool hit = (flags & F_HIT) != 0;
      const bool act = (flags & F_ACT) != 0;
      float in[LF_IN];
#pragma unroll
      for (int k = 0; k < 9; ++k) in[k] = row[T_O + k];  // o, d, atten: adjacent
      float mt;
      params.get(row, hit, in + 9, mt);
      const float ru[3] = {row[T_RU], row[T_RU + 1], row[T_RU + 2]};
      const float u = row[T_U];
      const int idx = __float_as_int(row[T_IDX]);
      float cin[LF_IN];
      local_f_vjp(in, mt, ru, u, hit, act, cot, depth > 0 || RAY_GRADS, depth > 0, cin);
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
      if (RAY_GRADS && depth == 0) {
#pragma unroll
        for (int k = 0; k < 6; ++k) g_ray[6 * i + k] = cin[k];
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
