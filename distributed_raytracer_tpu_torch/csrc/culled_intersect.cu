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
// What is not carried over: the per-block any-ray test (a thread tests for
// its own ray), the scalar-prefetched plan driving the DMA index maps, the
// visit-sorted [n_blocks, c_pad, 128] bound tiles (visit_sorted_bounds),
// the group-of-8 flag bitmasks computed a group ahead and the
// double-buffered chunk DMA.  The scene is read from global memory (L2-
// resident), as trace.cuh's WalkScene reads it.
//
// Bound: FP32 throughput, over the work this run's data needs: 25
// operations a finite bound test, 18 a sphere test of an admitted chunk
// and 8 more when its discriminant is not negative, counted per launch
// into stats (rays, bound tests, chunks admitted, sphere tests, tests with
// disc >= 0) when the wrapper passes a counter.  Known cost: incoherent
// rays in a warp diverge over which chunks they admit.
//
// Built with -fmad=false (ops/kernels/_build.py), so it agrees with its
// plain version bit for bit.
#include <cuda_runtime.h>

#include "trace.cuh"

#define THREADS 128

template <bool WALK>
__global__ void __launch_bounds__(THREADS)
culled_closest_hit_kernel(const float* __restrict__ o, const float* __restrict__ d, int R,
                          const float4* __restrict__ sph,     // [n_chunks * chunk] cx cy cz r2
                          const float4* __restrict__ bounds,  // [n_chunks] bx by bz r2
                          const int* __restrict__ order,      // [n_blocks, n_chunks]
                          const int* __restrict__ n_visit,    // [n_blocks]
                          int n_chunks, int chunk, int br, float* __restrict__ t_out,
                          int* __restrict__ idx_out, unsigned long long* __restrict__ stats) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  unsigned long long bound_tests = 0, admitted = 0, tests = 0, near = 0;
  if (i < R) {
    const float ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
    const float dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
    const float a = dx * dx + dy * dy + dz * dz;
    const float inv_a = 1.0f / a;
    const int b = i / br;
    const int* plan = order + (size_t)b * n_chunks;
    const int nv = WALK ? n_visit[b] : n_chunks;
    float best = DR_BIG;
    int bi = 0;
    for (int p = 0; p < nv; ++p) {
      const int c = plan[p];
      const float4 bd = bounds[c];
      if (!isinf(bd.w)) ++bound_tests;
      if (!chunk_admits(bd, ox, oy, oz, dx, dy, dz, a, inv_a, best)) continue;
      ++admitted;
      tests += (unsigned long long)chunk;
      sweep_range<true>(sph, c * chunk, (c + 1) * chunk, ox, oy, oz, dx, dy, dz, a, inv_a,
                        best, bi, &near);
    }
    t_out[i] = best;
    idx_out[i] = bi;
  }
  if (stats != nullptr) {
    add_count(i < R ? 1ull : 0ull, stats + 0);
    add_count(bound_tests, stats + 1);
    add_count(admitted, stats + 2);
    add_count(tests, stats + 3);
    add_count(near, stats + 4);
  }
}

extern "C" int culled_closest_hit_launch(const float* o, const float* d, int R,
                                         const float* sph, const float* bounds,
                                         const int* order, const int* n_visit, int n_chunks,
                                         int chunk, int br, int walk, float* t_out,
                                         int* idx_out, unsigned long long* stats,
                                         void* stream) {
  if (R < 1 || n_chunks < 1 || chunk < 1 || br < 1) return (int)cudaErrorInvalidValue;
  const int blocks = (R + THREADS - 1) / THREADS;
  const float4* s = reinterpret_cast<const float4*>(sph);
  const float4* bd = reinterpret_cast<const float4*>(bounds);
  if (walk) {
    culled_closest_hit_kernel<true><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        o, d, R, s, bd, order, n_visit, n_chunks, chunk, br, t_out, idx_out, stats);
  } else {
    culled_closest_hit_kernel<false><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        o, d, R, s, bd, order, n_visit, n_chunks, chunk, br, t_out, idx_out, stats);
  }
  return (int)cudaGetLastError();
}
