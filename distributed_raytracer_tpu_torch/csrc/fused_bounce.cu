// The fused bounce: one bounce (closest hit, then shading) of every lane
// of the wavefront engine's ray pool, in one launch.
//
// Replaces two kernels of the JAX package, as two kernels that share the
// lane layout and the shading tail:
//
//   K10 distributed_raytracer_tpu/ops/pallas/bounce_kernel.py::
//     _bounce_kernel (:306; pallas_call :529 in fused_bounce_rows :464):
//     the dense scene, every sphere swept.  Up to MAX_SPHERES spheres a
//     block stages its sweep columns in shared memory; above, the threads
//     read them from global memory (L2-resident).
//   K14 distributed_raytracer_tpu/ops/pallas/culled_bounce_kernel.py::
//     _culled_bounce_kernel (:136; pallas_call :355 in
//     _culled_fused_bounce_impl :305): the culled scene, walked chunk by
//     chunk (trace.cuh's group_walk) with a conservative per-ray bound
//     test against the ray's best t so far.
//
// What they compute is JAX's BounceOut for each lane: the next origin and
// direction, the bounce's attenuation, the terminal color (sky on a miss,
// black when absorbed), the finished flag, the winner's index, whether the
// ray hit (before the active mask), and the four draws used.  An inactive
// lane is swept (its index and hit are reported) but not shaded: o and d
// pass through, attenuation 1, color 0, finished 0.  Every draw is the
// (ray id, seed)-keyed hash, d = 0..4 (culled_bounce_kernel.py:278); on
// the TPU K10 drew from the on-core generator instead, which has no
// counterpart here, so the port keys K10 exactly like K14.  A caller (a
// test) may hand in the five uniforms instead.
//
// What is not carried over is the TPU blocking: the (ray block x sphere
// chunk) grid and its carried winner (a group of threads sweeps all the
// spheres), the bf16 hi/mid/lo planes and the MXU one-hot select (the
// winner's f32 attributes are read directly), K14's scalar-prefetched
// per-block visit order, its group-of-8 flag bitmasks and its
// double-buffered chunk DMA.  K14 walks the culled scene's chunks in the
// scene's own order (the always-swept big chunks, then Morton order), so
// its winner is the dense argmin over the culled scene, ties included: K10
// on that scene returns the same lanes bit for bit.
//
// Design: a group of consecutive threads holds one lane and finds its
// closest hit together, then the group's first thread draws (or reads the
// draws handed in), shades through bounce.cuh's shade<true> and writes the
// lane.  K10 runs DR_DENSE_GROUP (8) threads per lane in blocks of
// DR_DENSE_THREADS (256) through trace.cuh's group_sweep (lane q tests
// spheres q, q + G, ..., a (t, index) minimum over the group by warp
// reductions); K14 runs DR_GROUP (32) threads per lane in blocks of
// DR_GROUP_THREADS (128) through group_walk (a prefilter of DR_GROUP chunk
// positions at once, each admitted chunk swept by the whole group with
// group_sweep).  One thread per lane filled about four warps of each SM at
// the engine's pool of 16,384 lanes and left each thread a chain of
// dependent sphere tests at full latency (and, for K14, a warp sweeping
// every chunk any of its 32 incoherent rays admitted); a group launches G
// times the warps and shortens the chain G times.  Each shape is the
// fastest scripts/torch_group_probe.py found for its kernel on the
// engines' pool batches (PERF.md section 6): K10 shades every lane, and
// with 8 lanes a group a warp shades four lanes at once where 32 would
// shade one (blocks of 512 threads were 2% faster, within the probe's
// spread, but spilled).  K10's staged block holds only the sweep columns
// (16 B a sphere: 8 KB at 512 spheres, 4 MB staged by a launch of 16,384
// lanes);
// the shading thread reads its winner's seven attributes from global
// memory, once per lane.  Each launch also counts, when given a counter
// array, the lanes, the chunks swept (K10: one per lane), the sphere tests
// and the tests whose discriminant is not negative; K14 also the slot-test
// lanes its groups issued (group lane use = tests / issued).
//
// Bound: FP32 throughput in the sweep, as K5 (18 operations a live-sphere
// test, 8 more when the discriminant is not negative; for K14 also 25 a
// finite chunk bound test), counted by chip_smoke.py from the counters.
// Bytes are the pool's ray state read and written once (about 130 B a
// lane) and the scene.  Known costs: a group's lanes read G distinct
// spheres at a time where one thread per lane shared each read across a
// warp (K14: a chunk's slots once per ray); the shading runs on one thread
// of each group while the others wait; and the engine's host loop (refill,
// drain, one sync per block) sets the pace more than either kernel does.
//
// Built with -fmad=false (ops/kernels/_build.py), so it agrees with its
// plain versions, ops/kernels/bounce_kernel.py::fused_bounce_plain and
// ops/kernels/culled_bounce_kernel.py::culled_fused_bounce_plain.
#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

// K10's launch shape (a probe builds others with -D); K14's is trace.cuh's
// DR_GROUP and DR_GROUP_THREADS
#ifndef DR_DENSE_GROUP
#define DR_DENSE_GROUP 8
#endif
#ifndef DR_DENSE_THREADS
#define DR_DENSE_THREADS 256
#endif

#include "trace.cuh"

// The lanes in and out, [R] rows, xyz interleaved as [R, 3].
struct Lanes {
  const float* o;        // [R, 3]
  const float* d;        // [R, 3]
  const uint8_t* act;    // [R] bool
  const int* rid;        // [R] global ray id: the draws' key
  const float* draws;    // [5, R] given uniforms (u1, u2, u3, u4, u_choice), or null
  uint32_t seed;
  int R;
  float* new_o;          // [R, 3]
  float* new_d;          // [R, 3]
  float* atten;          // [R, 3]
  float* color;          // [R, 3]
  int* finished;         // [R]
  int* idx;              // [R]
  uint8_t* hit;          // [R] bool
  float* ruv;            // [R, 3]
  float* u;              // [R]
};

// The winner's accessor for shading: sphere(j) from the sweep columns
// (shared or global memory), attr(ATT_*, j) from the attribute rows in
// global memory, n apart.
struct DenseScene {
  const float4* sph;  // [n]
  const float* att;   // [ATT_ROWS, n]
  int n;

  __device__ __forceinline__ float4 sphere(int j) const { return sph[j]; }
  __device__ __forceinline__ float attr(int row, int j) const { return att[row * n + j]; }
};

// The shading tail of lane i's bounce, after its sweep gave (t, bi):
// the draws (made, or handed in), shade<true> through the accessor sc
// (sphere(j), attr(row, j)) for an active lane, and the nine outputs.
template <class Scene>
__device__ __forceinline__ void finish_lane(const Scene& sc, const Lanes& L, int i, float o[3],
                                            float d[3], float a, float t, int bi) {
  const uint32_t rid = (uint32_t)L.rid[i];
  float rec[4];
  if (L.draws != nullptr) {
    unit_from(L.draws[i], L.draws[L.R + i], L.draws[2 * L.R + i], L.draws[3 * L.R + i], rec);
    rec[3] = L.draws[4 * L.R + i];
  } else {
    bounce_draws(rid, L.seed, rec);
  }
  float at[3] = {1.0f, 1.0f, 1.0f};
  float co[3] = {0.0f, 0.0f, 0.0f};
  bool fin = false;
  if (L.act[i]) {
    fin = shade<true>(o, d, a, t, sc, bi, rid, L.seed, at, co, rec);
    if (fin) {  // shade left o and d as they were; the lane passes them through
      at[0] = at[1] = at[2] = 1.0f;
    } else {
      co[0] = co[1] = co[2] = 0.0f;
    }
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    L.new_o[3 * i + k] = o[k];
    L.new_d[3 * i + k] = d[k];
    L.atten[3 * i + k] = at[k];
    L.color[3 * i + k] = co[k];
    L.ruv[3 * i + k] = rec[k];
  }
  L.u[i] = rec[3];
  L.finished[i] = fin ? 1 : 0;
  L.idx[i] = bi;  // 0 on a miss
  L.hit[i] = t < DR_BIG * 0.5f ? 1 : 0;
}

// Lane i's ray: o, d and a = |d|^2.
__device__ __forceinline__ float load_lane(const Lanes& L, int i, float o[3], float d[3]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    o[k] = L.o[3 * i + k];
    d[k] = L.d[3 * i + k];
  }
  return d[0] * d[0] + d[1] * d[1] + d[2] * d[2];
}

// K10: DR_DENSE_GROUP consecutive threads sweep lane i = thread /
// DR_DENSE_GROUP's ray over the n spheres (group_sweep), then its first
// thread shades and writes it.  STAGED: the sweep columns (n <=
// MAX_SPHERES) staged in shared memory.  Counts into stats [4] (lanes,
// sweeps, sphere tests, tests with disc >= 0) when given.
template <bool STAGED>
__global__ void __launch_bounds__(DR_DENSE_THREADS)
fused_bounce_kernel(const float4* __restrict__ sph,    // [n]: cx, cy, cz, r2
                    const float* __restrict__ attrs,   // [11, n]: ops/kernels/bounce.py A_*
                    int n, Lanes L, unsigned long long* __restrict__ stats) {
  __shared__ float4 s_sph[STAGED ? MAX_SPHERES : 1];
  if (STAGED) {
    for (int j = threadIdx.x; j < n; j += DR_DENSE_THREADS) s_sph[j] = sph[j];
    __syncthreads();
  }
  const int i = (blockIdx.x * DR_DENSE_THREADS + threadIdx.x) / DR_DENSE_GROUP;
  const bool first = (threadIdx.x & (DR_DENSE_GROUP - 1)) == 0;
  unsigned long long near = 0;
  if (i < L.R) {
    float o[3], d[3];
    const float a = load_lane(L, i, o, d);
    const DenseScene sc{STAGED ? s_sph : sph, attrs + 3 * n, n};
    int bi;
    const float t = group_sweep<DR_DENSE_GROUP>(sc.sph, 0, n, o[0], o[1], o[2], d[0], d[1],
                                                d[2], a, 1.0f / a, &bi, &near);
    if (first) finish_lane(sc, L, i, o, d, a, t, bi);
  }
  if (stats != nullptr) {
    const unsigned long long lane = i < L.R && first ? 1ull : 0ull;
    add_count(lane, stats + 0);
    add_count(lane, stats + 1);
    add_count(lane * (unsigned long long)n, stats + 2);
    add_count(near, stats + 3);
  }
}

// K14's chunk positions: the scene's own order, chunk c sweeping its
// first chunk_len[c] slots.
struct ScenePos {
  __device__ __forceinline__ int operator()(int p) const { return p; }
};
struct ChunkLen {
  const int* len;
  __device__ __forceinline__ int operator()(int c) const { return len[c]; }
};

// K14: DR_GROUP consecutive threads walk lane i = thread / DR_GROUP's ray
// over the culled scene's chunks (group_walk), then its first thread
// shades and writes it.  Counts into stats [4] (lanes, chunks admitted,
// slot tests, tests with disc >= 0) and into *issued the slot-test lanes
// issued, when given.
__global__ void __launch_bounds__(DR_GROUP_THREADS)
culled_fused_bounce_kernel(const float4* __restrict__ sph,     // [n_slots]: cx, cy, cz, r2
                           const float* __restrict__ attrs,    // [11, n_slots]
                           const float4* __restrict__ bounds,  // [>= n_chunks]: bx, by, bz, r2
                           const int* __restrict__ chunk_len,  // [n_chunks]
                           int n_slots, int chunk, int n_chunks, Lanes L,
                           unsigned long long* __restrict__ stats,
                           unsigned long long* __restrict__ issued) {
  const int i = (blockIdx.x * DR_GROUP_THREADS + threadIdx.x) / DR_GROUP;
  const bool first = (threadIdx.x & (DR_GROUP - 1)) == 0;
  GroupCounts n{};
  if (i < L.R) {
    float o[3], d[3];
    const float a = load_lane(L, i, o, d);
    int bi;
    const float t = group_walk<DR_GROUP>(sph, bounds, n_chunks, ScenePos{}, ChunkLen{chunk_len},
                                         chunk, o[0], o[1], o[2], d[0], d[1], d[2], a,
                                         1.0f / a, &bi, n);
    // the winner's accessor for shading (its sweep is not called)
    const DenseScene sc{sph, attrs + 3 * n_slots, n_slots};
    if (first) finish_lane(sc, L, i, o, d, a, t, bi);
  }
  if (stats != nullptr) {
    add_count(i < L.R && first ? 1ull : 0ull, stats + 0);
    add_count(n.admitted, stats + 1);
    add_count(n.tests, stats + 2);
    add_count(n.near_tests, stats + 3);
  }
  if (issued != nullptr) add_count(n.issued, issued);
}

static Lanes lanes(const float* o, const float* d, const uint8_t* act, const int* rid,
                   const float* draws, int seed, int R, float* new_o, float* new_d,
                   float* atten, float* color, int* finished, int* idx, uint8_t* hit,
                   float* ruv, float* u) {
  return Lanes{o, d, act, rid, draws, (uint32_t)seed, R, new_o, new_d, atten, color,
               finished, idx, hit, ruv, u};
}

extern "C" int fused_bounce_launch(const float* sph, const float* attrs, int n,
                                   const float* o, const float* d, const uint8_t* act,
                                   const int* rid, const float* draws, int seed, int R,
                                   float* new_o, float* new_d, float* atten, float* color,
                                   int* finished, int* idx, uint8_t* hit, float* ruv, float* u,
                                   unsigned long long* stats, void* stream) {
  if (n < 1 || R < 1 || R > (INT_MAX - DR_DENSE_THREADS) / DR_DENSE_GROUP) {
    return (int)cudaErrorInvalidValue;
  }
  const Lanes L = lanes(o, d, act, rid, draws, seed, R, new_o, new_d, atten, color, finished,
                        idx, hit, ruv, u);
  const int blocks = (R * DR_DENSE_GROUP + DR_DENSE_THREADS - 1) / DR_DENSE_THREADS;
  const float4* s = reinterpret_cast<const float4*>(sph);
  if (n <= MAX_SPHERES) {
    fused_bounce_kernel<true><<<blocks, DR_DENSE_THREADS, 0, (cudaStream_t)stream>>>(
        s, attrs, n, L, stats);
  } else {
    fused_bounce_kernel<false><<<blocks, DR_DENSE_THREADS, 0, (cudaStream_t)stream>>>(
        s, attrs, n, L, stats);
  }
  return (int)cudaGetLastError();
}

extern "C" int culled_fused_bounce_launch(const float* sph, const float* attrs,
                                          const float* bounds, const int* chunk_len,
                                          int n_slots, int chunk, int n_chunks, const float* o,
                                          const float* d, const uint8_t* act, const int* rid,
                                          const float* draws, int seed, int R, float* new_o,
                                          float* new_d, float* atten, float* color,
                                          int* finished, int* idx, uint8_t* hit, float* ruv,
                                          float* u, unsigned long long* stats,
                                          unsigned long long* issued, void* stream) {
  if (n_chunks < 1 || chunk < 1 || n_slots != chunk * n_chunks || R < 1 ||
      R > (INT_MAX - DR_GROUP_THREADS) / DR_GROUP) {
    return (int)cudaErrorInvalidValue;
  }
  const Lanes L = lanes(o, d, act, rid, draws, seed, R, new_o, new_d, atten, color, finished,
                        idx, hit, ruv, u);
  const int blocks = (R * DR_GROUP + DR_GROUP_THREADS - 1) / DR_GROUP_THREADS;
  culled_fused_bounce_kernel<<<blocks, DR_GROUP_THREADS, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(sph), attrs, reinterpret_cast<const float4*>(bounds),
      chunk_len, n_slots, chunk, n_chunks, L, stats, issued);
  return (int)cudaGetLastError();
}

// K14's launch shape: lanes (threads) per ray, threads per block.
extern "C" void culled_fused_bounce_shape(int* shape) {
  shape[0] = DR_GROUP;
  shape[1] = DR_GROUP_THREADS;
}

// K10's launch shape: lanes (threads) per ray, threads per block.
extern "C" void fused_bounce_shape(int* shape) {
  shape[0] = DR_DENSE_GROUP;
  shape[1] = DR_DENSE_THREADS;
}
