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
// and one with no rows keep the zeros the wrapper wrote).  A row that hit
// nothing has parameter cotangents that are exactly zero (its outputs do
// not depend on the winner's parameters), so the no-hit bin n stays zero.
//
// Design: persistent, compacting blocks, as the forward's (persist.cuh).
// One thread per ray from its last row to its first left a warp walking
// until its longest ray was done: on the final scene's tape a ray has
// 2.93 rows on average, a warp of 32 consecutive rays 12.64, so at most a
// quarter of the lanes worked.  Here a grid of (SMs x blocks per SM)
// blocks of WALK_THREADS threads each keeps a pool of reverse carries in
// shared memory (a slot: the ray, its depth and the 9 carried cotangents,
// 11 words, a column per word).  In each step:
//
//   1. refill: the free slots take the next rays from one global counter
//      (pool_refill), in the order `order` gives: the wrappers feed the
//      longest rays first, so the pools end on short rays and drain in a
//      few steps; a ray starts at its last row with the cotangent
//      g_color[i] on the contribution; a ray that cannot contribute (no
//      rows, not finished, or a zero g_color) is dropped here, at the cost
//      of one flag read;
//   2. every live slot walks one row: the tape row, local_f_vjp, the
//      primary-ray cotangents at depth 0;
//   3. segment sum, by warp: __match_any_sync groups the lanes whose rows
//      hit the same bin, a shuffle tree sums each group's 9 cotangents
//      and the group's lowest lane adds each nonzero sum with one atomicAdd
//      (most rows hit the R = 1000 ground, so a warp's lanes used to
//      serialise on the same nine addresses): into the block's shared
//      accumulator for the first 513 bins (every sphere's and the no-hit
//      bin up to 512 spheres: [n + 1, 9] f32, 18.5 KB), straight into g_pm
//      past them (the walk tracer's slots, 8,448 at the bench shape: 304
//      KB, more than a block's 227 KB);
//   4. a carry retires after its first row or once its cotangents all
//      vanish (an absorbed ray after one row); the rest are repacked into
//      the lowest slots (pool_repack).
//
// When the counter is empty and the pool drained, the block adds its
// accumulator's nonzero entries to g_pm, one atomicAdd each.  Sums are
// taken in an order that changes from run to run; a ray's carry is not a
// sum, so its rows, its primary-ray cotangents and the rows walked are the
// same whatever the grid.  The walk counts the rows walked and the warp
// steps: lane use = rows / (32 x warp steps).
#pragma once
#include "bounce.cuh"
#include "local_f.cuh"
#include "persist.cuh"
#include "tape.cuh"

#define NPM 9
#define WALK_THREADS 128

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

// The block's pool of reverse carries, one slot per thread, a column per
// word (11 words a slot, 5.5 KB).
struct CarryPool {
  float cot[9][WALK_THREADS];  // the cotangents of (o, d, atten) carried to the row before
  int ray[WALK_THREADS];
  int depth[WALK_THREADS];     // the row walked next
  PoolSync<WALK_THREADS> sync;
};

// Adds each lane's 9 parameter cotangents v (summed in place) into bin
// key, key < 0 for nothing.  The lanes that hold one key add their sum
// once, by the group's lowest lane: into s_acc for the first n_sh bins,
// into g_pm past them; a zero sum is not added.  Every lane of the warp
// calls it.
__device__ __forceinline__ void warp_segment_sum(int key, float v[NPM], int n_sh, float* s_acc,
                                                 float* __restrict__ g_pm) {
  const int lane = threadIdx.x & 31;
  const unsigned group = __match_any_sync(0xFFFFFFFFu, key);
  const bool leader = (group & ((1u << lane) - 1u)) == 0u;
  // the shuffle tree: each round a lane adds the partial sum of the next
  // group lane above it that still holds one, and the lanes at odd ranks
  // drop out, so the lowest lane gathers the group in log2(size) rounds
  unsigned above = group & (0xFFFFFFFEu << lane);
  int rank = __popc(group & ((1u << lane) - 1u));
  while (__any_sync(0xFFFFFFFFu, above != 0u)) {
    const int next = __ffs(above);  // 1 + that lane, 0 for none
    const int src = next ? next - 1 : lane;
#pragma unroll
    for (int p = 0; p < NPM; ++p) {
      const float o = __shfl_sync(0xFFFFFFFFu, v[p], src);
      if (next) v[p] += o;
    }
    above &= ~__ballot_sync(0xFFFFFFFFu, rank & 1);
    rank >>= 1;
  }
  if (leader && key >= 0) {
    float* bin = key < n_sh ? s_acc + key * NPM : g_pm + (size_t)key * NPM;
#pragma unroll
    for (int p = 0; p < NPM; ++p) {
      if (v[p] != 0.0f) atomicAdd(bin + p, v[p]);
    }
  }
}

// The walk of rays order[0 .. n_rays-1] (a permutation of 0 .. n_rays-1)
// in persistent steps; s_acc holds (MAX_SPHERES + 1) x NPM floats of shared
// memory, counts [3] u64 (persist.cuh CNT_*: rows walked, warp steps, the
// ray counter) zeroed by the wrapper.  Every thread of the block calls it.
template <bool RAY_GRADS, class Params>
__device__ __forceinline__ void reverse_walk(const Params& params,
                                             const float* __restrict__ tape,     // [depth, R, 32]
                                             const int* __restrict__ lengths,    // [R]
                                             const float* __restrict__ g_color,  // [R, 3]
                                             const int* __restrict__ order,      // [R]
                                             int n_rays, int n,
                                             float* __restrict__ g_pm,   // [n + 1, 9], zeroed
                                             float* __restrict__ g_ray,  // [R, 6], zeroed
                                             float* s_acc,
                                             unsigned long long* __restrict__ counts) {
  __shared__ CarryPool pool;
  const int t = threadIdx.x;
  const int n_sh = min(n + 1, MAX_SPHERES + 1);  // the bins held in shared memory
  for (int e = t; e < n_sh * NPM; e += blockDim.x) s_acc[e] = 0.0f;
  __syncthreads();

  const size_t depth_stride = (size_t)n_rays * TAPE_COLS;
  int n_live = 0;
  bool drained = false;
  unsigned long long my_rows = 0, my_steps = 0;
  for (;;) {
    // 1. refill the free slots n_live .. WALK_THREADS-1
    unsigned long long base;
    const bool take = pool_refill(pool.sync, n_live, (unsigned long long)n_rays,
                                  counts + CNT_NEXT, drained, base);
    float cot[LF_OUT];
#pragma unroll
    for (int j = 0; j < LF_OUT; ++j) cot[j] = 0.0f;
    int ray = 0, depth = 0;
    bool live;
    if (t < n_live) {
#pragma unroll
      for (int j = 0; j < 9; ++j) cot[j] = pool.cot[j][t];
      ray = pool.ray[t];
      depth = pool.depth[t];
      live = true;
    } else {
      const unsigned long long k = base + (unsigned long long)(t - n_live);
      live = take && k < (unsigned long long)n_rays;
      if (live) {
        ray = order[k];
        const int len = lengths[ray];
        depth = len - 1;
        live = len > 0;
      }
      if (live) {
        const int last_flags = __float_as_int(
            tape[(size_t)depth * depth_stride + (size_t)ray * TAPE_COLS + T_FLG]);
        cot[9] = g_color[3 * ray + 0];
        cot[10] = g_color[3 * ray + 1];
        cot[11] = g_color[3 * ray + 2];
        // a depth-exhausted ray contributes black: no cotangent
        live = (last_flags & F_FIN) && (cot[9] != 0.0f || cot[10] != 0.0f || cot[11] != 0.0f);
      }
    }
    // every slot was read: from here the pool may be rewritten.  A step
    // whose new rays were all dropped goes on while the counter holds rays.
    if (!__syncthreads_or(live) && drained) break;

    // 2. one row of each live carry
    const bool stepped = __any_sync(0xFFFFFFFFu, live);
    int key = -1;
    float pv[NPM];
#pragma unroll
    for (int p = 0; p < NPM; ++p) pv[p] = 0.0f;
    bool keep = false;
    if (live) {
      float row[TAPE_COLS];
      tape_load(tape + (size_t)depth * depth_stride + (size_t)ray * TAPE_COLS, row);
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
      float cin[LF_IN];
      local_f_vjp(in, mt, ru, u, hit, act, cot, depth > 0 || RAY_GRADS, depth > 0, cin);
      if (hit) {
        key = __float_as_int(row[T_IDX]);
#pragma unroll
        for (int p = 0; p < NPM; ++p) pv[p] = cin[9 + p];
      }
      if (RAY_GRADS && depth == 0) {
#pragma unroll
        for (int k = 0; k < 6; ++k) g_ray[6 * ray + k] = cin[k];
      }
      bool any = false;
#pragma unroll
      for (int j = 0; j < 9; ++j) {
        cot[j] = cin[j];
        any = any || cin[j] != 0.0f;
      }
      keep = any && depth > 0;  // else nothing flows to the rows before
      --depth;
      ++my_rows;
    }
    if ((t & 31) == 0 && stepped) ++my_steps;

    // 3. the rows' parameter cotangents into their bins
    if (stepped) warp_segment_sum(key, pv, n_sh, s_acc, g_pm);

    // 4. repack the carries that go on into slots 0 .. n_live-1, in order
    const int slot = pool_repack(pool.sync, keep, n_live);
    if (keep) {
#pragma unroll
      for (int j = 0; j < 9; ++j) pool.cot[j][slot] = cot[j];
      pool.ray[slot] = ray;
      pool.depth[slot] = depth;
    }
    __syncthreads();
  }
  __syncthreads();
  for (int e = t; e < n_sh * NPM; e += blockDim.x) {
    if (s_acc[e] != 0.0f) atomicAdd(&g_pm[e], s_acc[e]);
  }
  add_count(my_rows, counts + CNT_BOUNCES);
  add_count(my_steps, counts + CNT_WARP_STEPS);
}
