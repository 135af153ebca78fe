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
// the pool with refills and the budget, the block_rays sub-blocks whose
// bound tests vote for all their rays, the group-of-8 flag bitmasks and the
// double-buffered chunk DMA, and the bf16 hi/mid/lo attribute planes (the
// slots' f32 attributes are read directly).
//
// Design: one thread per ray, as in K5, and the same bounce loop,
// trace_ray (trace.cuh), with the WalkScene accessor: the scene stays in
// global memory, where it is L2-resident (8,448 slots x (16 + 28) B = 370
// KB at the bench's 8,192 spheres), each thread tests every chunk's bound
// against its own best t and sweeps the chunks it admits.  The chunks
// merge with a strict <, in visit order, so a thread's winner is the
// dense argmin over the visit-ordered slots, ties included: the plain
// version (ops/kernels/mega_walk_kernel.py) is the dense plain trace over
// the slots, and the image equals K5's at equal content.  Two
// instantiations: RECORD = false (render) and true (record), whose colors
// are equal bit for bit at equal seeds.  The kernel counts the bounces,
// the chunks admitted, their slot tests and the tests with disc >= 0.
//
// Bound: FP32 throughput: one bound test (25 operations) for each bounce
// and finite-bound chunk, and for each slot test of an admitted chunk
// K5's 18 operations plus 8 when its discriminant is not negative
// (chip_smoke.py counts them on the run's rays from the counters).  Bytes
// (the pack read once, colors and the tape rows written once) are far
// below.  Known costs: the rays of a warp admit different chunks and
// finish after different numbers of bounces, so lanes idle; each slot is
// read from L1/L2 by every thread that sweeps it.  Staging admitted chunks
// in shared memory for a block that votes on them, as the TPU kernel
// does, is the later speed work.
//
// Built with -fmad=false (ops/kernels/_build.py), so it agrees with its
// plain versions, mega_walk_sample_plain and mega_walk_forward_camera_plain.
#include <cuda_runtime.h>
#include <cstdint>

#include "trace.cuh"

#define THREADS 128

template <bool RECORD>
__global__ void __launch_bounds__(THREADS)
mega_walk_kernel(const float4* __restrict__ sph,     // [n_slots]: cx, cy, cz, r2
                 const float* __restrict__ attrs,    // [11, n_slots]: ops/kernels/bounce.py A_*
                 const float4* __restrict__ bounds,  // [>= n_chunks]: bx, by, bz, r2
                 const int* __restrict__ chunk_len,  // [n_chunks]
                 int n_slots, int chunk, int n_chunks, const float* __restrict__ cam,
                 uint32_t bounce_seed, uint32_t cam_seed, uint32_t rid_base, int pix0,
                 int n_valid, int n_cap, int w, int max_depth, float* __restrict__ colors,
                 float* __restrict__ tape, int* __restrict__ lengths,
                 unsigned long long* __restrict__ stats) {  // [4], zeroed
  __shared__ float s_cam[CAM_ROW];
  if (threadIdx.x < CAM_ROW) s_cam[threadIdx.x] = cam[threadIdx.x];
  __syncthreads();
  WalkScene sc{sph, attrs + 3 * n_slots, bounds, chunk_len, n_slots, chunk, n_chunks, 0, 0, 0};

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  unsigned long long my_bounces = 0;
  if (i < n_cap) {
    float col[3] = {0.0f, 0.0f, 0.0f};
    if (i < n_valid) {
      const uint32_t pix = (uint32_t)(pix0 + i);
      const uint32_t rid = rid_base + pix;  // global ray id, wraps as int32 does
      const int rows = trace_ray<RECORD>(sc, s_cam, pix, rid, bounce_seed, cam_seed,
                                         (uint32_t)w, max_depth, col,
                                         RECORD ? tape + (size_t)i * TAPE_COLS : nullptr,
                                         (size_t)n_valid * TAPE_COLS, i);
      my_bounces = rows;
      if (RECORD) lengths[i] = rows;
    }
    colors[3 * i + 0] = col[0];
    colors[3 * i + 1] = col[1];
    colors[3 * i + 2] = col[2];
  }
  add_count(my_bounces, stats + 0);
  add_count(sc.admitted, stats + 1);
  add_count(sc.tests, stats + 2);
  add_count(sc.near_tests, stats + 3);
}

static bool bad_pack(int n_slots, int chunk, int n_chunks, int w, int max_depth) {
  return n_chunks < 1 || chunk < 1 || n_slots != chunk * n_chunks || w < 1 || max_depth < 0;
}

extern "C" int mega_walk_render_launch(const float* sph, const float* attrs, const float* bounds,
                                       const int* chunk_len, int n_slots, int chunk,
                                       int n_chunks, const float* cam, int bounce_seed,
                                       int cam_seed, unsigned int rid_base, int pix0,
                                       int n_valid, int n_cap, int w, int max_depth,
                                       float* colors, unsigned long long* stats, void* stream) {
  if (bad_pack(n_slots, chunk, n_chunks, w, max_depth) || n_cap < 1 || n_valid < 0 ||
      n_valid > n_cap) {
    return (int)cudaErrorInvalidValue;
  }
  const int blocks = (n_cap + THREADS - 1) / THREADS;
  mega_walk_kernel<false><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(sph), attrs, reinterpret_cast<const float4*>(bounds),
      chunk_len, n_slots, chunk, n_chunks, cam, (uint32_t)bounce_seed, (uint32_t)cam_seed,
      rid_base, pix0, n_valid, n_cap, w, max_depth, colors, nullptr, nullptr, stats);
  return (int)cudaGetLastError();
}

extern "C" int mega_walk_record_launch(const float* sph, const float* attrs, const float* bounds,
                                       const int* chunk_len, int n_slots, int chunk,
                                       int n_chunks, const float* cam, int bounce_seed,
                                       int cam_seed, int pix0, int n_rays, int w, int max_depth,
                                       float* tape, int* lengths, float* colors,
                                       unsigned long long* stats, void* stream) {
  if (bad_pack(n_slots, chunk, n_chunks, w, max_depth) || n_rays < 1 || max_depth < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int blocks = (n_rays + THREADS - 1) / THREADS;
  // the tracer passes no rid base: rid = the pixel, as in csrc/mega_forward.cu
  mega_walk_kernel<true><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(sph), attrs, reinterpret_cast<const float4*>(bounds),
      chunk_len, n_slots, chunk, n_chunks, cam, (uint32_t)bounce_seed, (uint32_t)cam_seed, 0u,
      pix0, n_rays, n_rays, w, max_depth, colors, tape, lengths, stats);
  return (int)cudaGetLastError();
}
