// The walk kernel: the mega render and the recording forward for scenes of
// any size, the scene walked chunk by chunk from global memory.
//
// Replaces distributed_raytracer_tpu/ops/pallas/mega_walk_kernel.py::
// _mega_walk_kernel (:198) at both its call sites: the render
// (mega_walk_sample :541, pallas_call :602) and the recording forward of
// the walk tracer (mega_walk_forward_camera :676, pallas_call :734).  What
// it computes is the same: camera rays made in the kernel; per bounce the
// closest hit over the visit-ordered chunks, a chunk skipped only when the
// ray cannot hit its bounding sphere closer than its best t so far (the
// big always-swept chunk, r2 = inf, is never skipped); shading with the
// (rid, depth)-keyed draws; in record mode the tape of csrc/mega_forward.cu
// (tape.cuh's 32 columns, winner params in columns 16-25), whose winner
// index is the slot.  What it does not carry over is the TPU scheduling:
// the lane pool's budget (the port's pool, below, runs every ray to its
// end), the block_rays sub-blocks whose bound tests vote for all their
// rays, the group-of-8 flag bitmasks and the double-buffered chunk DMA,
// and the bf16 hi/mid/lo attribute planes (the slots' f32 attributes are
// read directly).
//
// Design: the persistent, compacting loop of K5 and K6 (persist.cuh), with
// the WalkChunks accessor (trace.cuh): a grid of (SMs x blocks per SM)
// blocks of 256 threads, each of which keeps a pool of 256 ray states in
// shared memory (12 KB) beside the camera row, runs one bounce of every
// live ray per step, writes the rays that finished, repacks the live ones
// into whole warps and refills its free slots in pixel order from a
// global ray counter.  The scene stays in global memory, where it is L2-resident
// (8,448 slots x (16 + 28) B = 370 KB at the bench's 8,192 spheres: too
// much for a block's shared memory); each thread tests every chunk's
// bound against its own best t and sweeps the chunks it admits.  The
// chunks merge with a strict <, in visit order, so a thread's winner is
// the dense argmin over the visit-ordered slots, ties included: the plain
// version (ops/kernels/mega_walk_kernel.py) is the dense plain trace over
// the slots, and the image equals K5's at equal content.  Every draw is
// keyed by (rid, depth) and a tape row is addressed by (depth, ray), so
// the grid and the order in which blocks take rays change nothing.  Two
// instantiations: RECORD = false (render) and true (record), whose colors
// are equal bit for bit at equal seeds.  A warp sweeps a chunk for all
// its lanes when any lane admits it; with one thread per ray, or with the
// pool alone, the lanes that did not admit it idle through that sweep
// (PERF.md section 6 has the sweep lane use, below, with and without
// what follows).  So a
// chunk that few lanes admit is swept by the whole warp for one admitting
// ray at a time, a slot per lane, and a warp minimum of (t, slot) gives
// that ray what its own sweep gives (trace.cuh WalkChunks).  The
// kernel counts the bounces, the chunks admitted, their slot tests and the
// tests with disc >= 0 (per lane, as the plain version counts them), and
// the warp steps and the slot-test rounds the warps issue (lane use and
// sweep lane use, which depend on the schedule).
//
// Bound: FP32 throughput: one bound test (25 operations) for each bounce
// and finite-bound chunk, and for each slot test of an admitted chunk
// K5's 18 operations plus 8 when its discriminant is not negative
// (chip_smoke.py counts them on the run's rays from the counters).  Bytes
// (the pack read once, colors and the tape rows written once) are far
// below.  Known costs: a chunk that many lanes admit is still swept by
// all of them, lane by lane; each slot is read from L1/L2 by every warp
// that sweeps it; the pools drain after the ray counter empties.
//
// Built with -fmad=false (ops/kernels/_build.py), so it agrees with its
// plain versions, mega_walk_sample_plain and mega_walk_forward_camera_plain.
#include <cuda_runtime.h>
#include <cstdint>

#include "persist.cuh"

// counts [7] u64, zeroed by the wrapper: persist.cuh's CNT_* (bounces,
// warp steps, the ray counter), then the walk's
#define CNT_ADMITTED 3
#define CNT_TESTS 4
#define CNT_NEAR 5
#define CNT_WARP_TESTS 6

// At least 4 blocks of 256 threads per SM, as K5's and K6's grids: left
// to itself the record instantiation takes 78 registers (3 blocks) and is
// slower at its grid of 396 than at 4 blocks with 64 registers and a few
// spilled words (scripts/torch_persist_grid.py, PERF.md section 6).
template <bool RECORD>
__global__ void __launch_bounds__(PERSIST_THREADS, 4)
mega_walk_kernel(const float4* __restrict__ sph,     // [n_slots]: cx, cy, cz, r2
                 const float* __restrict__ attrs,    // [11, n_slots]: ops/kernels/bounce.py A_*
                 const float4* __restrict__ bounds,  // [>= n_chunks]: bx, by, bz, r2
                 const int* __restrict__ chunk_len,  // [n_chunks]
                 int n_slots, int chunk, int n_chunks, const float* __restrict__ cam,
                 uint32_t bounce_seed, uint32_t cam_seed, uint32_t rid_base, int pix0,
                 int n_work, int w, int max_depth, float* __restrict__ colors,
                 float* __restrict__ tape, int* __restrict__ lengths,
                 unsigned long long* __restrict__ counts) {
  __shared__ float s_cam[CAM_ROW];
  if (threadIdx.x < CAM_ROW) s_cam[threadIdx.x] = cam[threadIdx.x];
  __syncthreads();
  WalkChunks sc{sph, attrs + 3 * n_slots, bounds, chunk_len, n_slots, chunk, n_chunks,
                0, 0, 0, 0};
  const CameraRays rays{s_cam, nullptr, pix0, rid_base, cam_seed, (uint32_t)w};
  persist_trace<RECORD>(sc, rays, (unsigned long long)n_work, bounce_seed, max_depth, colors,
                        lengths, tape, counts);
  add_count(sc.admitted, counts + CNT_ADMITTED);
  add_count(sc.tests, counts + CNT_TESTS);
  add_count(sc.near_tests, counts + CNT_NEAR);
  add_count(sc.warp_tests, counts + CNT_WARP_TESTS);
}

extern "C" int mega_walk_blocks_per_sm(int record) {
  return record ? persist_blocks_per_sm(mega_walk_kernel<true>)
                : persist_blocks_per_sm(mega_walk_kernel<false>);
}

static bool bad_pack(int n_slots, int chunk, int n_chunks, int w, int grid) {
  return n_chunks < 1 || chunk < 1 || n_slots != chunk * n_chunks || w < 1 || grid < 1;
}

// Rays 0 .. n_work-1 are pixels pix0 + k; their colors go to colors[k].
// The caller zeroes the rows it holds past n_work (n_work is 0 at
// max_depth 0).  grid: the most blocks to launch (the wrapper passes SMs x
// mega_walk_blocks_per_sm(0), or fewer).
extern "C" int mega_walk_render_launch(const float* sph, const float* attrs, const float* bounds,
                                       const int* chunk_len, int n_slots, int chunk,
                                       int n_chunks, const float* cam, int bounce_seed,
                                       int cam_seed, unsigned int rid_base, int pix0,
                                       int n_work, int w, int max_depth, float* colors,
                                       unsigned long long* counts, int grid, void* stream) {
  if (bad_pack(n_slots, chunk, n_chunks, w, grid) || n_work < 0 ||
      (n_work > 0 && max_depth < 1)) {
    return (int)cudaErrorInvalidValue;
  }
  mega_walk_kernel<false><<<persist_blocks(grid, n_work), PERSIST_THREADS, 0,
                            (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(sph), attrs, reinterpret_cast<const float4*>(bounds),
      chunk_len, n_slots, chunk, n_chunks, cam, (uint32_t)bounce_seed, (uint32_t)cam_seed,
      rid_base, pix0, n_work, w, max_depth, colors, nullptr, nullptr, counts);
  return (int)cudaGetLastError();
}

// grid as mega_walk_render_launch's, with mega_walk_blocks_per_sm(1).
extern "C" int mega_walk_record_launch(const float* sph, const float* attrs, const float* bounds,
                                       const int* chunk_len, int n_slots, int chunk,
                                       int n_chunks, const float* cam, int bounce_seed,
                                       int cam_seed, int pix0, int n_rays, int w, int max_depth,
                                       float* tape, int* lengths, float* colors,
                                       unsigned long long* counts, int grid, void* stream) {
  if (bad_pack(n_slots, chunk, n_chunks, w, grid) || n_rays < 1 || max_depth < 1) {
    return (int)cudaErrorInvalidValue;
  }
  // the tracer passes no rid base: rid = the pixel, as in csrc/mega_forward.cu
  mega_walk_kernel<true><<<persist_blocks(grid, n_rays), PERSIST_THREADS, 0,
                           (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(sph), attrs, reinterpret_cast<const float4*>(bounds),
      chunk_len, n_slots, chunk, n_chunks, cam, (uint32_t)bounce_seed, (uint32_t)cam_seed, 0u,
      pix0, n_rays, w, max_depth, colors, tape, lengths, counts);
  return (int)cudaGetLastError();
}
