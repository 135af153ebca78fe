// A probe variant of K13 (csrc/culled_intersect.cu, WALK = true) for
// scripts/torch_group_probe.py: the same group walk (trace.cuh group_walk)
// with the sweep columns staged in shared memory.  Persistent blocks
// (the card's SMs x the blocks that fit one) each copy the scene's slots
// into shared memory once, then take rays in turn (DR_GROUP_THREADS /
// DR_GROUP at a time, the grid's stride apart).  The group walk's reads of
// an admitted chunk then come from shared memory instead of L1/L2; if
// those reads set the pace, this variant is faster.  Not built into the
// package: the probe builds it with nvcc beside its other variants.
#include <cuda_runtime.h>

#include "../distributed_raytracer_tpu_torch/csrc/trace.cuh"

struct StagedPlanPos {
  const int* plan;
  __device__ __forceinline__ int operator()(int p) const { return plan[p]; }
};
struct StagedWholeChunk {
  int chunk;
  __device__ __forceinline__ int operator()(int) const { return chunk; }
};

__global__ void __launch_bounds__(DR_GROUP_THREADS)
staged_walk_kernel(const float* __restrict__ o, const float* __restrict__ d, int R,
                   const float4* __restrict__ sph, int n_slots,
                   const float4* __restrict__ bounds, const int* __restrict__ order,
                   const int* __restrict__ n_visit, int n_chunks, int chunk, int br,
                   float* __restrict__ t_out, int* __restrict__ idx_out) {
  extern __shared__ float4 s_sph[];
  for (int j = threadIdx.x; j < n_slots; j += DR_GROUP_THREADS) s_sph[j] = sph[j];
  __syncthreads();
  constexpr int kPerBlock = DR_GROUP_THREADS / DR_GROUP;
  const bool first = (threadIdx.x & (DR_GROUP - 1)) == 0;
  for (int i0 = blockIdx.x * kPerBlock; i0 < R; i0 += gridDim.x * kPerBlock) {
    const int i = i0 + (int)threadIdx.x / DR_GROUP;
    if (i >= R) continue;
    const float ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
    const float dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
    const float a = dx * dx + dy * dy + dz * dz;
    const int b = i / br;
    GroupCounts n{};
    int bi;
    const float t = group_walk<DR_GROUP>(s_sph, bounds, n_visit[b],
                                         StagedPlanPos{order + (size_t)b * n_chunks},
                                         StagedWholeChunk{chunk}, chunk, ox, oy, oz, dx, dy, dz,
                                         a, 1.0f / a, &bi, n);
    if (first) {
      t_out[i] = t;
      idx_out[i] = bi;
    }
  }
}

// The grid it launches (SMs x blocks per SM at this shared memory), or
// minus a CUDA error.
extern "C" int staged_walk_grid(int n_slots) {
  const size_t smem = (size_t)n_slots * sizeof(float4);
  cudaError_t e = cudaFuncSetAttribute(staged_walk_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return -(int)e;
  int per_sm = 0, dev = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, staged_walk_kernel,
                                                    DR_GROUP_THREADS, smem);
  if (e != cudaSuccess) return -(int)e;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return per_sm * sms;
}

extern "C" int staged_walk_launch(const float* o, const float* d, int R, const float* sph,
                                  int n_slots, const float* bounds, const int* order,
                                  const int* n_visit, int n_chunks, int chunk, int br,
                                  float* t_out, int* idx_out, int grid, void* stream) {
  if (R < 1 || grid < 1 || n_slots != n_chunks * chunk) return (int)cudaErrorInvalidValue;
  staged_walk_kernel<<<grid, DR_GROUP_THREADS, (size_t)n_slots * sizeof(float4),
                       (cudaStream_t)stream>>>(
      o, d, R, reinterpret_cast<const float4*>(sph), n_slots,
      reinterpret_cast<const float4*>(bounds), order, n_visit, n_chunks, chunk, br, t_out,
      idx_out);
  return (int)cudaGetLastError();
}
