// The bounce of the persistent loop (persist.cuh) that the mega render
// kernel (csrc/mega_render.cu), the recording forward (csrc/mega_forward.cu,
// in camera and ray mode) and the walk kernel (csrc/mega_walk.cu) run, and
// the scene accessors they share.
//
// bounce_once runs one bounce of one ray.  RECORD = false is the render
// kernels' bounce; RECORD = true runs the same bounce with the recording
// shade<true> (bounce.cuh) and also writes its tape row (tape.cuh).  Both
// compute the same values in the same order, so at equal seeds their
// colors are equal bit for bit.  The Scene accessor says where the scene
// lives and how a bounce finds its closest hit:
//
//   ResidentScene (K5, K6): the whole scene staged in shared memory, every
//     sphere swept;
//   WalkChunks (K9): the scene in global memory (L2-resident) as
//     visit-ordered chunks of slots, a chunk swept only when the ray can
//     still hit its bounding sphere closer than its best t so far.
//
// Both give sphere(j) (cx, cy, cz, r2), attr(ATT_*, j) and sweep(...),
// which returns the closest t (DR_BIG on a miss) and its index.
//
// group_sweep, a dense sweep with a group of lanes holding one ray, is the
// closest hit of the dense fused bounce (K10, csrc/fused_bounce.cu) and
// the dense closest hit (K11, csrc/intersect.cu); group_walk, the walk
// with a group of lanes holding one ray, sweeps each chunk it admits with
// group_sweep and is the closest hit of the culled fused bounce (K14,
// csrc/fused_bounce.cu) and the culled closest hit (K12/K13,
// csrc/culled_intersect.cu).
#pragma once
#include <cstdint>

#include "bounce.cuh"
#include "camera.cuh"
#include "tape.cuh"

// Copies the scene's sweep columns (cx, cy, cz, r2), its seven winner
// attributes and the camera row (when cam is not null) into the block's
// shared memory (512 x 11 x 4 B = 22.5 KB at most), then syncs the block.
__device__ __forceinline__ void stage_scene(const float* __restrict__ cols,
                                            const float* __restrict__ attrs, int n,
                                            const float* __restrict__ cam, float4* s_sph,
                                            float* s_att, float* s_cam) {
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    s_sph[j] = make_float4(cols[j], cols[n + j], cols[2 * n + j], cols[3 * n + j]);
#pragma unroll
    for (int r = 0; r < ATT_ROWS; ++r) s_att[r * MAX_SPHERES + j] = attrs[(3 + r) * n + j];
  }
  if (cam != nullptr && threadIdx.x < CAM_ROW) s_cam[threadIdx.x] = cam[threadIdx.x];
  __syncthreads();
}

// Adds each thread's count to *total, one atomic per warp.  Every thread
// of the block calls it.
__device__ __forceinline__ void add_count(unsigned long long mine, unsigned long long* total) {
  for (int off = 16; off > 0; off >>= 1) mine += __shfl_down_sync(0xFFFFFFFFu, mine, off);
  if ((threadIdx.x & 31) == 0 && mine) atomicAdd(total, mine);
}

// The scene staged by stage_scene: n spheres, all swept.
struct ResidentScene {
  const float4* sph;  // [MAX_SPHERES] shared
  const float* att;   // [ATT_ROWS, MAX_SPHERES] shared
  int n;

  __device__ __forceinline__ float4 sphere(int j) const { return sph[j]; }
  __device__ __forceinline__ float attr(int row, int j) const {
    return att[row * MAX_SPHERES + j];
  }
  __device__ __forceinline__ float sweep(float ox, float oy, float oz, float dx, float dy,
                                         float dz, float a, float inv_a, int* idx) {
    return sweep_winner(sph, n, ox, oy, oz, dx, dy, dz, a, inv_a, idx);
  }
};

// The chunk test of the walk (mega_walk_kernel.py:365-391 in the JAX
// package): can the ray (o, d; a = |d|^2) hit the bounding sphere b (bx,
// by, bz, r2) at some t > T_MIN nearer than best?  Conservative: a sphere
// inside the bound that the ray hits at t < best passes it.  An infinite
// r2 (the always-swept big chunk) admits without the arithmetic, whose
// inf - inf would not.
__device__ __forceinline__ bool chunk_admits(float4 b, float ox, float oy, float oz, float dx,
                                             float dy, float dz, float a, float inv_a,
                                             float best) {
  if (isinf(b.w)) return b.w > 0.0f;
  const float obx = b.x - ox;
  const float oby = b.y - oy;
  const float obz = b.z - oz;
  const float hb = dx * obx + dy * oby + dz * obz;
  const float cb = obx * obx + oby * oby + obz * obz - b.w;
  const float discb = hb * hb - a * cb;
  if (!(discb >= 0.0f)) return false;
  const float sq = sqrtf(discb);
  const float nearb = (hb - sq) * inv_a;
  const float farb = (hb + sq) * inv_a;
  return farb > DR_T_MIN && nearb < best;
}

// The walk pack in global memory: n_chunks chunks of `chunk` slots in
// visit order (always-swept chunks first, then front to back from the
// camera).  Chunk c sweeps its first chunk_len[c] slots (the rest are
// padding, r2 = -1, which never hit) and merges them with a strict <, so
// the winner is the dense argmin over the visit-ordered slots, ties
// included.  Counts, per thread, the chunks admitted, the slot tests they
// run and those tests whose discriminant is not negative.
//
// The lanes that sweep together (__activemask at entry) decide each chunk
// together.  Each lane admits a chunk by its own test, but a warp sweeps a
// chunk for all of its lanes when any one admits it, and the lanes that
// did not idle through that sweep.  So when few lanes admit a chunk (k of
// them, k x (its rounds + 2) < its length), the warp sweeps it for one
// admitting ray at a time, each lane testing every m-th slot (m lanes
// together), and gathers the ray's closest hit by a warp minimum of (t,
// slot): the first slot with the smallest t, what the lane's own strict-<
// sweep finds, and merged with its best t the same way, so results and
// per-lane counters are unchanged bit for bit.  The slot-test rounds the
// warp issues are counted once per chunk by the lowest lane (warp_tests;
// its length when the lanes sweep alone, k x its rounds when together),
// so sweep lane use = tests / (32 x warp_tests).
struct WalkChunks {
  const float4* sph;      // [n_slots] cx cy cz r2
  const float* att;       // [ATT_ROWS, n_slots]
  const float4* bounds;   // [n_chunks] bx by bz r2
  const int* chunk_len;   // [n_chunks]
  int n_slots, chunk, n_chunks;
  unsigned long long admitted, tests, near_tests, warp_tests;

  __device__ __forceinline__ float4 sphere(int j) const { return sph[j]; }
  __device__ __forceinline__ float attr(int row, int j) const { return att[row * n_slots + j]; }
  __device__ __forceinline__ float sweep(float ox, float oy, float oz, float dx, float dy,
                                         float dz, float a, float inv_a, int* idx) {
    float best = DR_BIG;
    int bi = 0;
    const int lane = threadIdx.x & 31;
    const unsigned together = __activemask();
    const int m = __popc(together);  // the lanes sweeping together
    const int q = __popc(together & ((1u << lane) - 1u));  // this lane's rank among them
    for (int c = 0; c < n_chunks; ++c) {
      const bool admit = chunk_admits(bounds[c], ox, oy, oz, dx, dy, dz, a, inv_a, best);
      const int j0 = c * chunk;
      const int len = chunk_len[c];
      if (admit) {
        ++admitted;
        tests += (unsigned long long)len;
      }
      const unsigned adm = __ballot_sync(together, admit);
      if (adm == 0u) continue;
      const int k = __popc(adm);
      const int rounds = (len + m - 1) / m;
      if (k * (rounds + 2) < len) {  // few admit: sweep together, one ray at a time
        if (q == 0) warp_tests += (unsigned long long)(k * rounds);
        for (unsigned todo = adm; todo != 0u; todo &= todo - 1u) {
          const int r = __ffs(todo) - 1;
          const float rox = __shfl_sync(together, ox, r);
          const float roy = __shfl_sync(together, oy, r);
          const float roz = __shfl_sync(together, oz, r);
          const float rdx = __shfl_sync(together, dx, r);
          const float rdy = __shfl_sync(together, dy, r);
          const float rdz = __shfl_sync(together, dz, r);
          const float ra = __shfl_sync(together, a, r);
          const float rinv = __shfl_sync(together, inv_a, r);
          float tb = DR_BIG;  // t > 0, so its bits order as unsigned ints
          int jb = 0;
          unsigned long long nn = 0;
          sweep_range<true>(sph, j0 + q, j0 + len, rox, roy, roz, rdx, rdy, rdz, ra, rinv, tb,
                            jb, &nn, 0, m);
          const unsigned tmin = __reduce_min_sync(together, __float_as_uint(tb));
          const unsigned jmin =
              __reduce_min_sync(together, __float_as_uint(tb) == tmin ? (unsigned)jb : ~0u);
          const unsigned n_near = __reduce_add_sync(together, (unsigned)nn);
          if (lane == r) {
            near_tests += n_near;
            if (__uint_as_float(tmin) < best) {
              best = __uint_as_float(tmin);
              bi = (int)jmin;
            }
          }
        }
        continue;
      }
      if (q == 0) warp_tests += (unsigned long long)len;
      if (!admit) continue;
      sweep_range<true>(sph, j0, j0 + len, ox, oy, oz, dx, dy, dz, a, inv_a, best, bi,
                        &near_tests);
    }
    *idx = bi;
    return best;
  }
};

// The group walk's lanes per ray and threads per block: one library has
// one shape (a probe builds others with -D).
#ifndef DR_GROUP
#define DR_GROUP 32
#endif
#ifndef DR_GROUP_THREADS
#define DR_GROUP_THREADS 128
#endif
static_assert(DR_GROUP >= 1 && DR_GROUP <= 32 && (DR_GROUP & (DR_GROUP - 1)) == 0,
              "DR_GROUP must be a power of two up to 32");
static_assert(DR_GROUP_THREADS % 32 == 0, "DR_GROUP_THREADS must be whole warps");

// The dense sweeps' launch shape (DR_DENSE_GROUP lanes per ray,
// DR_DENSE_THREADS threads per block) is set by each of their sources,
// K10's (csrc/fused_bounce.cu) and K11's (csrc/intersect.cu), before it
// includes this file.
#ifdef DR_DENSE_GROUP
static_assert(DR_DENSE_THREADS % 32 == 0, "DR_DENSE_THREADS must be whole warps");
#endif

// The lanes of this thread's group of G consecutive lanes of its warp.
template <int G>
__device__ __forceinline__ unsigned group_mask() {
  static_assert(G >= 1 && G <= 32 && (G & (G - 1)) == 0, "G must be a power of two up to 32");
  const int base = (threadIdx.x & 31) & ~(G - 1);
  return G == 32 ? 0xFFFFFFFFu : ((1u << (G & 31)) - 1u) << base;
}

// The group's least (t, slot): the least t bits over the lanes of gmask
// (t > 0, so its bits order as unsigned ints), then the least slot among
// the lanes at that t.  Each lane passes the first slot of its own least
// t, so this is the first slot of the group's least t, what one thread's
// strict-< sweep over the same slots in ascending order finds; on every
// lane.  A lane that hit nothing passes (DR_BIG, 0).
__device__ __forceinline__ float group_min(unsigned gmask, float tb, int jb, int* idx) {
  const unsigned tmin = __reduce_min_sync(gmask, __float_as_uint(tb));
  *idx = (int)__reduce_min_sync(gmask, __float_as_uint(tb) == tmin ? (unsigned)jb : ~0u);
  return __uint_as_float(tmin);
}

// The dense sweep of spheres j0 .. j1-1 of sph by a group of G
// consecutive lanes of a warp, every lane passing the ray's o, d, a and
// inv_a: lane q tests spheres j0 + q, j0 + q + G, ... with sweep_range's
// arithmetic into its own (t, index), and group_min gives every lane the
// least t (DR_BIG on a miss) and in *idx its first index (0 on a miss).
// That is what one thread's strict-< sweep of the same spheres, JAX's
// chunked argmin and the plain first argmin give, bit for bit.  Adds each
// lane's tests whose discriminant is not negative to its *n_near.
template <int G>
__device__ __forceinline__ float group_sweep(const float4* sph, int j0, int j1, float ox,
                                             float oy, float oz, float dx, float dy, float dz,
                                             float a, float inv_a, int* idx,
                                             unsigned long long* n_near) {
  float tb = DR_BIG;
  int jb = 0;
  sweep_range<true>(sph, j0 + (int)(threadIdx.x & (G - 1)), j1, ox, oy, oz, dx, dy, dz, a,
                    inv_a, tb, jb, n_near, 0, G);
  return group_min(group_mask<G>(), tb, jb, idx);
}

// Per-lane counts of a group walk.  Each lane counts the finite bound
// tests of its own prefilter positions and the disc >= 0 tests of its own
// slots; the group's first lane counts each admitted chunk, its slot tests
// and the slot-test lanes the group issued for it (G x its rounds), so
// the sums over the lanes are what the walk of one thread per ray counts,
// and group lane use = tests / issued.
struct GroupCounts {
  unsigned long long bound_tests, admitted, tests, near_tests, issued;
};

// The walk of one ray held by a group of G consecutive lanes of a warp
// (every lane passes the ray's o, d, a and inv_a) over the chunk
// positions 0 .. n_pos-1, chunk at(p) at position p (c * chunk is its
// first slot, len_of(c) the slots it sweeps).  Returns what WalkChunks'
// sweep of one thread per ray returns, on every lane: the closest t
// (DR_BIG on a miss), the winner's slot in *idx (0 on a miss).
//
// Prefilter: each lane tests one of the next G positions with
// chunk_admits against the best t at the window's start.  The test is
// monotone in best (nearb < best), and best only falls, so a position it
// rejects is one the walk of one thread would reject too.  Recheck: the
// candidates (a ballot) are taken in ascending position, and once best has
// fallen since the prefilter each is tested again with the same call, the
// same operands and the current best, so the chunks admitted are the
// sequential walk's exactly.  Sweep: group_sweep over the chunk's slots,
// its first slot of the least t merged into best with a strict <.
template <int G, class At, class Len>
__device__ __forceinline__ float group_walk(const float4* __restrict__ sph,
                                            const float4* __restrict__ bounds, int n_pos,
                                            At at, Len len_of, int chunk, float ox, float oy,
                                            float oz, float dx, float dy, float dz, float a,
                                            float inv_a, int* idx, GroupCounts& n) {
  const int q = threadIdx.x & (G - 1);
  const unsigned gmask = group_mask<G>();
  const int base = (threadIdx.x & 31) - q;
  float best = DR_BIG;
  int bi = 0;
  for (int p0 = 0; p0 < n_pos; p0 += G) {
    int c = 0;
    bool cand = false;
    if (p0 + q < n_pos) {
      c = at(p0 + q);
      const float4 b = bounds[c];
      if (!isinf(b.w)) ++n.bound_tests;
      cand = chunk_admits(b, ox, oy, oz, dx, dy, dz, a, inv_a, best);
    }
    const float stale = best;
    for (unsigned m = (__ballot_sync(gmask, cand) & gmask) >> base; m != 0u; m &= m - 1u) {
      const int ck = __shfl_sync(gmask, c, __ffs(m) - 1, G);
      if (best < stale && !chunk_admits(bounds[ck], ox, oy, oz, dx, dy, dz, a, inv_a, best)) {
        continue;
      }
      const int j0 = ck * chunk;
      const int len = len_of(ck);
      if (q == 0) {
        ++n.admitted;
        n.tests += (unsigned long long)len;
        n.issued += (unsigned long long)(G * ((len + G - 1) / G));
      }
      int jc;
      const float tc = group_sweep<G>(sph, j0, j0 + len, ox, oy, oz, dx, dy, dz, a, inv_a, &jc,
                                      &n.near_tests);
      if (tc < best) {
        best = tc;
        bi = jc;
      }
    }
  }
  *idx = bi;
  return best;
}

// One bounce of the ray (o, d) at depth `depth` with throughput atten
// (draws keyed by rid and bounce_seed + depth * 65537): sweep + shade, for
// a loop that runs one bounce per step (persist.cuh: K5, K6 and K9).
// Returns true when the ray finished, with its terminal color in co (the
// caller multiplies by atten); else o and d hold the next ray and atten
// has taken this bounce's attenuation.
//
// RECORD: also writes the bounce's tape row at row_dst (tape.cuh): the
// pre-bounce o, d and atten, the four draws, the contribution (the color
// on the finishing row, else 0), the winner's parameters (zero on a
// miss), the winner's index in the scene (the slot, for the walk), the ray
// index `ray` and the flags.
template <bool RECORD, class Scene>
__device__ __forceinline__ bool bounce_once(Scene& sc, float o[3], float d[3], float atten[3],
                                            int depth, uint32_t rid, uint32_t bounce_seed,
                                            float co[3], float* row_dst = nullptr,
                                            int ray = 0) {
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
  const float t = sc.sweep(o[0], o[1], o[2], d[0], d[1], d[2], a, inv_a, &bi);
  const uint32_t seed = bounce_seed + (uint32_t)depth * 65537u;
  float at[3], rec[4];
  if (RECORD) bounce_draws(rid, seed, rec);
  const bool fin = shade<RECORD>(o, d, a, t, sc, bi, rid, seed, at, co, rec);
  if (RECORD) {
    const bool hit = t < DR_BIG * 0.5f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      row[T_RU + k] = rec[k];
      row[T_CO + k] = fin ? atten[k] * co[k] : 0.0f;
    }
    row[T_U] = rec[3];
    const float4 s = hit ? sc.sphere(bi) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    row[T_CW + 0] = s.x;
    row[T_CW + 1] = s.y;
    row[T_CW + 2] = s.z;
    row[T_RW] = hit ? sc.attr(ATT_RR, bi) : 0.0f;
    row[T_AW + 0] = hit ? sc.attr(ATT_AR, bi) : 0.0f;
    row[T_AW + 1] = hit ? sc.attr(ATT_AG, bi) : 0.0f;
    row[T_AW + 2] = hit ? sc.attr(ATT_AB, bi) : 0.0f;
    row[T_FW] = hit ? sc.attr(ATT_FZ, bi) : 0.0f;
    row[T_IW] = hit ? sc.attr(ATT_IO, bi) : 0.0f;
    row[T_MT] = hit ? sc.attr(ATT_MT, bi) : 0.0f;
    row[T_IDX] = __int_as_float(hit ? bi : 0);
    row[T_RAY] = __int_as_float(ray);
    row[T_FLG] = __int_as_float((hit ? F_HIT : 0) | F_ACT | (depth == 0 ? F_TAKE : 0) |
                                (fin ? F_FIN : 0));
#pragma unroll
    for (int k = T_FLG + 1; k < TAPE_COLS; ++k) row[k] = 0.0f;
    tape_store(row_dst, row);
  }
  if (!fin) {
    atten[0] = atten[0] * at[0];
    atten[1] = atten[1] * at[1];
    atten[2] = atten[2] * at[2];
  }
  return fin;
}
