// The block-culled closest hit: every ray's nearest sphere over a culled
// scene (ops/kernels/culled_kernel.py's CulledScene: chunks of `chunk`
// slots, each with a bounding sphere), skipping the chunks it cannot hit.
//
// Replaces two kernels of the JAX package, which compute the same function
// of the rays and differ only in their TPU schedule, as two instantiations
// of one kernel:
//
//   K12 distributed_raytracer_tpu/ops/pallas/culled_kernel.py::_culled_kernel
//     (:136; pallas_call :318 in _culled_fwd :275, make_culled_intersect
//     mode="grid"): every (ray block, visit position) a grid cell, a chunk
//     swept when some ray of the block passes its bound test.  Here
//     WALK = false: a ray visits all n_chunks positions of its block's plan.
//   K13 culled_kernel.py::_walk_kernel (:372; pallas_call :608 in
//     _culled_walk_fwd :539, mode="walk"): an in-kernel walk over the first
//     n_visit[b] positions of the plan, the chunks no ray of the block can
//     reach left out.  Here WALK = true.
//
// The plan is JAX's (_block_visit_plan, computed in tensor code by
// culled_kernel.py::block_visit_plan): ray r belongs to block b = r / br,
// and order[b, p] is the chunk it visits at position p, front to back from
// the block's mean ray, the always-swept chunks first.  Before each chunk
// the ray runs JAX's bound test for itself (trace.cuh chunk_admits: the
// bound hit at some t > T_MIN nearer than the ray's best so far; an
// infinite bound always admits); inside an admitted chunk bounce.cuh's
// sweep (ascending slot, strict <), merged into the running best with a
// strict <.  So the winner is the per-chunk first argmin reduced over the
// block's visit order with a strict <, as JAX's kernels and the plain
// version (culled_closest_hit_plain, no culling) give it.  The bounds the
// wrapper hands in are inflated as the plan's reach test inflates them
// (r2 (1 + 1e-4) + 1e-5), so a ray's own test cannot reject its winner at
// the float32 edge of a tight bound.
//
// What is not carried over: the per-block any-ray test (each ray tests
// for itself), the scalar-prefetched plan driving the DMA index maps, the
// visit-sorted [n_blocks, c_pad, 128] bound tiles (visit_sorted_bounds),
// the group-of-8 flag bitmasks computed a group ahead and the
// double-buffered chunk DMA.  The scene is read from global memory (L2-
// resident), as trace.cuh's WalkChunks reads it.
//
// Design: DR_GROUP consecutive threads hold one ray and walk its block's
// plan row through trace.cuh's group_walk (a prefilter of DR_GROUP plan
// positions at once against the best t at the window's start, an exact
// recheck of each candidate, each admitted chunk swept by the whole group
// and its (t, slot) minimum taken by warp reductions), so that a warp no
// longer sweeps every chunk any of 32 incoherent secondary rays admits,
// and a launch holds DR_GROUP times the warps; the group's first thread
// writes t and idx.
//
// Bound: FP32 throughput, over the work this run's data needs: 25
// operations a finite bound test, 18 a sphere test of an admitted chunk
// and 8 more when its discriminant is not negative, counted per launch
// into stats (rays, bound tests, chunks admitted, sphere tests, tests with
// disc >= 0) when the wrapper passes a counter, and the slot-test lanes
// the groups issued into *issued (group lane use = tests / issued).  Known
// cost: a group reads an admitted chunk's slots once per ray (from L1/L2),
// where a warp of 32 rays shared one read.
//
// Built with -fmad=false (ops/kernels/_build.py), so it agrees with its
// plain version bit for bit.
#include <cuda_runtime.h>
#include <climits>

#include "trace.cuh"

// The plan row of a ray's block: the chunk at each position; every chunk
// sweeps all its slots.
struct PlanPos {
  const int* plan;
  __device__ __forceinline__ int operator()(int p) const { return plan[p]; }
};
struct WholeChunk {
  int chunk;
  __device__ __forceinline__ int operator()(int) const { return chunk; }
};

template <bool WALK>
__global__ void __launch_bounds__(DR_GROUP_THREADS)
culled_closest_hit_kernel(const float* __restrict__ o, const float* __restrict__ d, int R,
                          const float4* __restrict__ sph,     // [n_chunks * chunk] cx cy cz r2
                          const float4* __restrict__ bounds,  // [n_chunks] bx by bz r2
                          const int* __restrict__ order,      // [n_blocks, n_chunks]
                          const int* __restrict__ n_visit,    // [n_blocks]
                          int n_chunks, int chunk, int br, float* __restrict__ t_out,
                          int* __restrict__ idx_out, unsigned long long* __restrict__ stats,
                          unsigned long long* __restrict__ issued) {
  const int i = (blockIdx.x * DR_GROUP_THREADS + threadIdx.x) / DR_GROUP;
  const bool first = (threadIdx.x & (DR_GROUP - 1)) == 0;
  GroupCounts n{};
  if (i < R) {
    const float ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
    const float dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
    const float a = dx * dx + dy * dy + dz * dz;
    const int b = i / br;
    const int nv = WALK ? n_visit[b] : n_chunks;
    int bi;
    const float t = group_walk<DR_GROUP>(sph, bounds, nv, PlanPos{order + (size_t)b * n_chunks},
                                         WholeChunk{chunk}, chunk, ox, oy, oz, dx, dy, dz, a,
                                         1.0f / a, &bi, n);
    if (first) {
      t_out[i] = t;
      idx_out[i] = bi;
    }
  }
  if (stats != nullptr) {
    add_count(i < R && first ? 1ull : 0ull, stats + 0);
    add_count(n.bound_tests, stats + 1);
    add_count(n.admitted, stats + 2);
    add_count(n.tests, stats + 3);
    add_count(n.near_tests, stats + 4);
  }
  if (issued != nullptr) add_count(n.issued, issued);
}

extern "C" int culled_closest_hit_launch(const float* o, const float* d, int R,
                                         const float* sph, const float* bounds,
                                         const int* order, const int* n_visit, int n_chunks,
                                         int chunk, int br, int walk, float* t_out,
                                         int* idx_out, unsigned long long* stats,
                                         unsigned long long* issued, void* stream) {
  if (R < 1 || n_chunks < 1 || chunk < 1 || br < 1 ||
      R > (INT_MAX - DR_GROUP_THREADS) / DR_GROUP) {
    return (int)cudaErrorInvalidValue;
  }
  const int blocks = (R * DR_GROUP + DR_GROUP_THREADS - 1) / DR_GROUP_THREADS;
  const float4* s = reinterpret_cast<const float4*>(sph);
  const float4* bd = reinterpret_cast<const float4*>(bounds);
  if (walk) {
    culled_closest_hit_kernel<true><<<blocks, DR_GROUP_THREADS, 0, (cudaStream_t)stream>>>(
        o, d, R, s, bd, order, n_visit, n_chunks, chunk, br, t_out, idx_out, stats, issued);
  } else {
    culled_closest_hit_kernel<false><<<blocks, DR_GROUP_THREADS, 0, (cudaStream_t)stream>>>(
        o, d, R, s, bd, order, n_visit, n_chunks, chunk, br, t_out, idx_out, stats, issued);
  }
  return (int)cudaGetLastError();
}

// The launch shape: lanes (threads) per ray, threads per block.
extern "C" void culled_closest_hit_shape(int* shape) {
  shape[0] = DR_GROUP;
  shape[1] = DR_GROUP_THREADS;
}
