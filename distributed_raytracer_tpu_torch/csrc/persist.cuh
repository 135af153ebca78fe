// The persistent, compacting loops of the port: the bounce loop of K5
// (csrc/mega_render.cu), K6 (csrc/mega_forward.cu, camera and ray mode)
// and K9 (csrc/mega_walk.cu, render and record), and the block-wide
// refill and repack that the reverse tape walk of K8 and K7
// (walk_bwd.cuh) shares with it.
//
// Why: with one thread per ray from the camera to the ray's end, a warp
// sweeps the scene until its longest ray ends.  On the RTiOW final scene
// at 1200x675 depth 50 a ray runs 2.93 bounces on average but a warp of
// 32 consecutive rays 12.64, so 77% of the sweep's FP32 issue went to
// lanes whose ray was already done.
//
// Design: a grid of (SMs x blocks per SM) blocks of PERSIST_THREADS
// threads, each of which stages what it reads often (the scene, when it
// fits, or the camera row) once and then runs steps until the image's
// rays are all traced.  A block keeps a pool of ray states in shared
// memory, one slot per thread.  In each step:
//
//   1. refill: the free slots take the next rays in pixel order, from one
//      global ray counter (pool_refill: one atomicAdd per block and step);
//   2. bounce: every thread that holds a live ray runs one bounce_once
//      (trace.cuh: sweep, draws, shade and, recording, the tape row); a
//      warp with no live ray skips it;
//   3. the finished rays write their colors (and lengths);
//   4. compaction: the live rays are repacked into the lowest slots, by a
//      block-wide scan of the warps' __ballot_sync counts (pool_repack),
//      so the live rays fill whole warps and the empty warps above them
//      idle.
//
// Once the counter is empty and the pool has drained, the block exits.
// Every draw is keyed by (rid, depth) and each ray's arithmetic is
// bounce_once's, step after step, so colors, tape rows, lengths and the
// bounce count are the same whatever the grid or the order in which
// blocks take rays; the counters are integer atomics.  The scene accessor
// (trace.cuh) says where the scene lives: ResidentScene staged in shared
// memory (K5, K6), WalkChunks in global memory, walked chunk by chunk (K9).
//
// Besides the bounces, the loop counts warp steps, the (warp, step) pairs
// that swept: lane use = bounces / (32 x warp steps).
#pragma once
#include <cuda_runtime.h>
#include <cstdint>

#include "trace.cuh"

#define PERSIST_THREADS 256
#define PERSIST_WARPS (PERSIST_THREADS / 32)

// The counters a launch adds to, [3] u64 zeroed by the wrapper: the
// bounces (the reverse walk: rows), the warp steps and the global ray
// counter.
#define CNT_BOUNCES 0
#define CNT_WARP_STEPS 1
#define CNT_NEXT 2

// What the threads of a block of THREADS share to refill and repack their
// pool.
template <int THREADS>
struct PoolSync {
  int warp_live[THREADS / 32];
  unsigned long long base;
};

// Step 1 of a persistent loop: the block takes the next THREADS - n_live
// items from the global counter *next, one atomicAdd by thread 0.  Returns
// whether it took any (false once it has drained the counter or its pool
// is full), with the first item taken in base; drained turns true once the
// counter has passed n_work.  Every thread of the block calls it.
template <int THREADS>
__device__ __forceinline__ bool pool_refill(PoolSync<THREADS>& ps, int n_live,
                                            unsigned long long n_work,
                                            unsigned long long* next, bool& drained,
                                            unsigned long long& base) {
  const int n_free = THREADS - n_live;
  const bool take = !drained && n_free > 0;  // block-uniform
  if (take && threadIdx.x == 0) ps.base = atomicAdd(next, (unsigned long long)n_free);
  __syncthreads();
  base = 0;
  if (take) {
    base = ps.base;
    drained = base + n_free >= n_work;
  }
  return take;
}

// Step 4: the slot of this thread's item once the live items of the block
// are repacked into slots 0 .. n_live-1 in slot order, by a scan of the
// warps' ballot counts; n_live becomes the block's live count.  Every
// thread of the block calls it, once every slot was read; the caller then
// writes its live item to the slot and syncs the block.
template <int THREADS>
__device__ __forceinline__ int pool_repack(PoolSync<THREADS>& ps, bool live, int& n_live) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned mask = __ballot_sync(0xFFFFFFFFu, live);
  if (lane == 0) ps.warp_live[warp] = __popc(mask);
  __syncthreads();
  int slot = __popc(mask & ((1u << lane) - 1u));
  n_live = 0;
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) {
    const int c = ps.warp_live[w];
    slot += w < warp ? c : 0;
    n_live += c;
  }
  return slot;
}

// A camera's primary rays: ray k is pixel pixel_ids[k] (or pix0 + k), its
// draws keyed by rid = rid_base + pixel (int32 wrap).
struct CameraRays {
  const float* cam;  // the camera row, in shared memory
  const int* __restrict__ pixel_ids;
  int pix0;
  uint32_t rid_base, cam_seed, w;

  __device__ __forceinline__ uint32_t make(int k, float o[3], float d[3]) const {
    const uint32_t pix = pixel_ids ? (uint32_t)pixel_ids[k] : (uint32_t)(pix0 + k);
    const uint32_t rid = rid_base + pix;
    camera_ray(cam, pix, rid, cam_seed, w, o, d);
    return rid;
  }
};

// A ray table's rays: ray k is (ray_o[k], ray_d[k]), its draws keyed by k.
struct TableRays {
  const float* __restrict__ ray_o;  // [n, 3]
  const float* __restrict__ ray_d;  // [n, 3]

  __device__ __forceinline__ uint32_t make(int k, float o[3], float d[3]) const {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      o[c] = ray_o[3 * k + c];
      d[c] = ray_d[3 * k + c];
    }
    return (uint32_t)k;
  }
};

// The block's pool of ray states, one slot per thread, a column per value
// so that a warp's accesses fall in distinct banks (12 words a slot, 12 KB).
struct RayPool {
  float o[3][PERSIST_THREADS];
  float d[3][PERSIST_THREADS];
  float at[3][PERSIST_THREADS];
  int depth[PERSIST_THREADS];
  int ray[PERSIST_THREADS];
  uint32_t rid[PERSIST_THREADS];
  PoolSync<PERSIST_THREADS> sync;
};

// Traces rays 0 .. n_work-1 of `rays` through the scene sc, each to its
// end or max_depth (>= 1), in persistent steps.  Ray k's color goes to
// colors[k] (black when it ran out of depth); RECORD also writes its
// bounce at depth j to tape row (j * n_work + k) and its bounce count to
// lengths[k].  Every thread of the block calls it.
template <bool RECORD, class Scene, class Rays>
__device__ __forceinline__ void persist_trace(Scene& sc, const Rays& rays,
                                              unsigned long long n_work, uint32_t bounce_seed,
                                              int max_depth, float* __restrict__ colors,
                                              int* __restrict__ lengths,
                                              float* __restrict__ tape,
                                              unsigned long long* __restrict__ counts) {
  __shared__ RayPool pool;
  const int t = threadIdx.x;
  const size_t depth_stride = (size_t)n_work * TAPE_COLS;
  int n_live = 0;
  bool drained = false;
  unsigned long long my_bounces = 0, my_steps = 0;
  for (;;) {
    // 1. refill the free slots n_live .. PERSIST_THREADS-1
    unsigned long long base;
    const bool take = pool_refill(pool.sync, n_live, n_work, counts + CNT_NEXT, drained, base);
    float o[3], d[3], atten[3];
    int depth, ray;
    uint32_t rid;
    bool live;
    if (t < n_live) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        o[c] = pool.o[c][t];
        d[c] = pool.d[c][t];
        atten[c] = pool.at[c][t];
      }
      depth = pool.depth[t];
      ray = pool.ray[t];
      rid = pool.rid[t];
      live = true;
    } else {
      const unsigned long long k = base + (unsigned long long)(t - n_live);
      live = take && k < n_work;
      ray = (int)k;
      depth = 0;
      atten[0] = atten[1] = atten[2] = 1.0f;
      rid = live ? rays.make(ray, o, d) : 0u;
    }
    // every slot was read: from here the pool may be rewritten
    if (!__syncthreads_or(live)) break;

    // 2-3. one bounce of each live ray
    const bool swept = __any_sync(0xFFFFFFFFu, live);
    if (live) {
      float co[3];
      const bool fin = bounce_once<RECORD>(
          sc, o, d, atten, depth, rid, bounce_seed, co,
          RECORD ? tape + (size_t)depth * depth_stride + (size_t)ray * TAPE_COLS : nullptr, ray);
      ++depth;
      ++my_bounces;
      if (fin || depth >= max_depth) {  // a ray alive at max_depth contributes black
        colors[3 * ray + 0] = fin ? atten[0] * co[0] : 0.0f;
        colors[3 * ray + 1] = fin ? atten[1] * co[1] : 0.0f;
        colors[3 * ray + 2] = fin ? atten[2] * co[2] : 0.0f;
        if (RECORD) lengths[ray] = depth;
        live = false;
      }
    }
    if ((t & 31) == 0 && swept) ++my_steps;

    // 4. repack the live rays into slots 0 .. n_live-1, in order
    const int slot = pool_repack(pool.sync, live, n_live);
    if (live) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        pool.o[c][slot] = o[c];
        pool.d[c][slot] = d[c];
        pool.at[c][slot] = atten[c];
      }
      pool.depth[slot] = depth;
      pool.ray[slot] = ray;
      pool.rid[slot] = rid;
    }
    __syncthreads();
  }
  add_count(my_bounces, counts + CNT_BOUNCES);
  add_count(my_steps, counts + CNT_WARP_STEPS);
}

// Blocks of `kernel` that fit on one SM at `threads` threads, by
// cudaOccupancyMaxActiveBlocksPerMultiprocessor; negative on an error.
template <class Kernel>
static int persist_blocks_per_sm(Kernel kernel, int threads = PERSIST_THREADS) {
  int per_sm = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  return err == cudaSuccess ? per_sm : -(int)err;
}

// The blocks of `threads` threads to launch for n items on a grid of at
// most `grid` blocks: no more than the items fill.
static inline int persist_blocks(int grid, long long n, int threads = PERSIST_THREADS) {
  const long long need = (n + threads - 1) / threads;
  return (int)(need < grid ? (need > 0 ? need : 1) : grid);
}
