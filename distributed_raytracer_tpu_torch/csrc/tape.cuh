// The tape row: one bounce of one ray, 32 f32 words (128 bytes).
//
// The one place the CUDA kernels name the row's columns: the recording
// forward (csrc/mega_forward.cu, through trace.cuh) writes rows with
// tape_store, the reverse walk (csrc/mega_walk_bwd.cu) reads them with
// tape_load.  The values equal ops/kernels/mega_kernel.py's T_* and F_*
// (tests/test_torch_tapegrad.py holds the two against each other), which
// keep JAX's row meaning (mega_kernel.py:96-99, mega_walk_bwd_kernel.py:55
// in the JAX package).
//
// The tape is depth-major, [max_depth, R, 32]: ray i's row at depth k is
// the 128 bytes at (k * R + i) * 32, so a warp's rows at one depth are
// contiguous.  A row moves as eight 16-byte words.
#pragma once

constexpr int T_O = 0;     // o, 3: the ray's origin before the bounce
constexpr int T_D = 3;     // d, 3: its direction
constexpr int T_AT = 6;    // atten, 3: the throughput so far
constexpr int T_RU = 9;    // ruv, 3: the unit-vector draw
constexpr int T_U = 12;    // u: the dielectric's choice draw
constexpr int T_CO = 13;   // contrib, 3: atten x color on the finishing row, else 0
constexpr int T_CW = 16;   // the winner's center, 3
constexpr int T_RW = 19;   // radius
constexpr int T_AW = 20;   // albedo, 3
constexpr int T_FW = 23;   // fuzz
constexpr int T_IW = 24;   // ior
constexpr int T_MT = 25;   // material code
constexpr int T_IDX = 26;  // winner index, int32 bits
constexpr int T_RAY = 27;  // ray, int32 bits
constexpr int T_FLG = 28;  // flags, int32 bits
constexpr int TAPE_COLS = 32;

constexpr int F_HIT = 1;   // the sweep hit a sphere
constexpr int F_ACT = 2;   // the row holds a live bounce
constexpr int F_TAKE = 4;  // the ray's first row
constexpr int F_FIN = 8;   // the ray finished on this row

// row[0 .. 32) to the tape; the words past T_FLG must be set (zero)
__device__ __forceinline__ void tape_store(float* __restrict__ dst, const float row[TAPE_COLS]) {
  float4* d4 = reinterpret_cast<float4*>(dst);
#pragma unroll
  for (int q = 0; q < TAPE_COLS / 4; ++q) {
    d4[q] = make_float4(row[4 * q], row[4 * q + 1], row[4 * q + 2], row[4 * q + 3]);
  }
}

__device__ __forceinline__ void tape_load(const float* __restrict__ src, float row[TAPE_COLS]) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
#pragma unroll
  for (int q = 0; q < TAPE_COLS / 4; ++q) {
    const float4 v = s4[q];
    row[4 * q] = v.x;
    row[4 * q + 1] = v.y;
    row[4 * q + 2] = v.z;
    row[4 * q + 3] = v.w;
  }
}
