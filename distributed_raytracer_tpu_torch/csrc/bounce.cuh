// One bounce of one ray: the device-function ports of
// distributed_raytracer_tpu/ops/pallas/bounce_kernel.py::_sweep_winner (:93)
// and ::_shade_vals (:150).  Plain versions: ops/kernels/bounce.py.
//
// The TPU versions compute every material's result for a row of rays and
// select; here one thread holds one ray and runs only its material's
// branch.  Each value is computed by the same expressions in the same
// order, and the draws are pure functions of (rid, seed, d), so skipping
// a branch's unused draws changes no bit of the result.
#pragma once
#include "hash.cuh"

#define DR_BIG 1e30f
#define DR_T_MIN 1e-3f
#define DR_NEAR_ZERO 1e-6f
#define DR_TWO_PI 6.2831853f

// winner-attribute rows held per sphere (ops/kernels/bounce.py
// A_RR..A_MT; the centers come from the sweep columns)
#define ATT_RR 0
#define ATT_AR 1
#define ATT_AG 2
#define ATT_AB 3
#define ATT_FZ 4
#define ATT_IO 5
#define ATT_MT 6
#define ATT_ROWS 7

// the most spheres a kernel holds in shared memory: the scene of K5, K6 and
// K7, and the g_pm bins K7 and K8 sum there
#define MAX_SPHERES 512

// Sweeps spheres j0 .. j1-1 of sph (cx, cy, cz, r2) into the running
// closest hit (best, bi), ascending index with a strict <, so the first
// minimum wins as in jnp.argmin, and a later range wins only with a
// smaller t (the walk's chunk merge).  The winner's index is base + j
// (base: where sph starts in the scene, for a tile staged in shared
// memory).  r2 = -1 marks a sphere that never hits.  COUNT also adds the
// tests whose discriminant is not negative to *n_near.  step > 1 sweeps
// every step-th sphere from j0 (a lane's share of a range that a warp
// sweeps together).
template <bool COUNT = false>
__device__ __forceinline__ void sweep_range(const float4* sph, int j0, int j1, float ox,
                                            float oy, float oz, float dx, float dy, float dz,
                                            float a, float inv_a, float& best, int& bi,
                                            unsigned long long* n_near = nullptr,
                                            int base = 0, int step = 1) {
  for (int j = j0; j < j1; j += step) {
    const float4 s = sph[j];
    const float ocx = s.x - ox;
    const float ocy = s.y - oy;
    const float ocz = s.z - oz;
    const float h = dx * ocx + dy * ocy + dz * ocz;
    const float c_q = ocx * ocx + ocy * ocy + ocz * ocz - s.w;
    const float disc = h * h - a * c_q;
    if (disc >= 0.0f) {
      if (COUNT) ++*n_near;
      const float sqrtd = sqrtf(disc);
      const float rn = (h - sqrtd) * inv_a;
      const float rf = (h + sqrtd) * inv_a;
      const float t = rn > DR_T_MIN ? rn : (rf > DR_T_MIN ? rf : DR_BIG);
      if (t < best) {
        best = t;
        bi = base + j;
      }
    }
  }
}

// Closest hit over n spheres: returns t (DR_BIG on a miss) and the
// winner's index in *idx (0 on a miss).
__device__ __forceinline__ float sweep_winner(const float4* sph, int n, float ox, float oy,
                                              float oz, float dx, float dy, float dz,
                                              float a, float inv_a, int* idx) {
  float best = DR_BIG;
  int bi = 0;
  sweep_range(sph, 0, n, ox, oy, oz, dx, dy, dz, a, inv_a, best, bi);
  *idx = bi;
  return best;
}

// The unit vector (Box-Muller gaussians, normalized) of four uniforms.
__device__ __forceinline__ void unit_from(float u1, float u2, float u3, float u4, float ru[3]) {
  const float rad1 = sqrtf(-2.0f * logf(u1));
  const float g1 = rad1 * cosf(DR_TWO_PI * u2);
  const float g2 = rad1 * sinf(DR_TWO_PI * u2);
  const float g3 = sqrtf(-2.0f * logf(u3)) * cosf(DR_TWO_PI * u4);
  const float gn = rsqrtf(g1 * g1 + g2 * g2 + g3 * g3 + 1e-20f);
  ru[0] = g1 * gn;
  ru[1] = g2 * gn;
  ru[2] = g3 * gn;
}

// The unit-vector draw of one bounce, keyed (rid, seed, 0..3).
__device__ __forceinline__ void unit_draw(uint32_t rid, uint32_t seed, float ru[3]) {
  unit_from(hash_u01(rid, seed, 0u), hash_u01(rid, seed, 1u), hash_u01(rid, seed, 2u),
            hash_u01(rid, seed, 3u), ru);
}

// All four draws of one bounce, as DRAWN shading takes them: the unit
// vector (rux, ruy, ruz) and the dielectric's choice u.
__device__ __forceinline__ void bounce_draws(uint32_t rid, uint32_t seed, float rec[4]) {
  unit_draw(rid, seed, rec);
  rec[3] = hash_u01(rid, seed, 4u);
}

// Shades one ray against the winner (index bi; its center and radius^2
// sc.sphere(bi), its attributes sc.attr(ATT_*, bi), trace.cuh's scene
// accessors).  On return either the ray finished (true; its terminal color in
// co: sky on a miss, black when absorbed) or it scattered (false; o and d
// hold the next ray, at the attenuation of this bounce).
//
// DRAWN: the caller drew the bounce's four numbers into rec (rux, ruy,
// ruz, u_choice) for every ray whatever its material, as the JAX vector
// code draws them for every lane: the recording forwards
// (csrc/mega_forward.cu and the record instantiation of csrc/mega_walk.cu,
// whose tape holds them, with bounce_draws) and the fused bounce
// (csrc/fused_bounce.cu, which returns them and may be given them).  The
// draws are pure functions of (rid, seed), so both instantiations compute
// the same values; DRAWN = false draws what its branch needs itself (the
// render kernels).
template <bool DRAWN, class Scene>
__device__ __forceinline__ bool shade(float o[3], float d[3], float a, float t,
                                      const Scene& sc, int bi, uint32_t rid, uint32_t seed,
                                      float at[3], float co[3], const float rec[4] = nullptr) {
  const float dinv = rsqrtf(a);
  if (!(t < DR_BIG * 0.5f)) {  // miss: the sky gradient
    const float uy_n = d[1] * dinv;
    const float sky_a = 0.5f * (uy_n + 1.0f);
    co[0] = (1.0f - sky_a) + sky_a * 0.5f;
    co[1] = (1.0f - sky_a) + sky_a * 0.7f;
    co[2] = (1.0f - sky_a) + sky_a * 1.0f;
    return true;
  }
  const float4 s = sc.sphere(bi);
  const float wrr = sc.attr(ATT_RR, bi);
  const float mt = sc.attr(ATT_MT, bi);
  if (mt == 3.0f) {  // ABSORB
    co[0] = co[1] = co[2] = 0.0f;
    return true;
  }
  const float px = o[0] + t * d[0];
  const float py = o[1] + t * d[1];
  const float pz = o[2] + t * d[2];
  const float saferr = wrr > 0.0f ? wrr : 1.0f;
  float nx = (px - s.x) / saferr;
  float ny = (py - s.y) / saferr;
  float nz = (pz - s.z) / saferr;
  const float d_dot_n = d[0] * nx + d[1] * ny + d[2] * nz;
  const bool front = d_dot_n < 0.0f;
  const float fs = front ? 1.0f : -1.0f;
  nx = nx * fs;
  ny = ny * fs;
  nz = nz * fs;

  if (mt == 4.0f) {  // TRANSPARENT: origin and direction unchanged
    at[0] = at[1] = at[2] = 1.0f;
    return false;
  }
  if (mt == 2.0f) {  // DIELECTRIC
    const float wio = sc.attr(ATT_IO, bi);
    const float u_choice = DRAWN ? rec[3] : hash_u01(rid, seed, 4u);
    const float ior = wio > 0.0f ? wio : 1.0f;
    const float ri = front ? 1.0f / ior : ior;
    const float ux = d[0] * dinv, uy = d[1] * dinv, uz = d[2] * dinv;
    const float cos_t = fminf(-(ux * nx + uy * ny + uz * nz), 1.0f);
    const float sin2 = fmaxf(1.0f - cos_t * cos_t, 0.0f);
    const bool cannot = ri * ri * sin2 > 1.0f;
    float r0 = (1.0f - ri) / (1.0f + ri);
    r0 = r0 * r0;
    const float omc = 1.0f - cos_t;
    const float schlick = r0 + (1.0f - r0) * omc * omc * omc * omc * omc;
    if (cannot || schlick > u_choice) {
      const float u_dot_n = ux * nx + uy * ny + uz * nz;
      d[0] = ux - 2.0f * u_dot_n * nx;
      d[1] = uy - 2.0f * u_dot_n * ny;
      d[2] = uz - 2.0f * u_dot_n * nz;
    } else {
      const float perp_x = ri * (ux + cos_t * nx);
      const float perp_y = ri * (uy + cos_t * ny);
      const float perp_z = ri * (uz + cos_t * nz);
      const float k = fabsf(1.0f - (perp_x * perp_x + perp_y * perp_y + perp_z * perp_z));
      const float para = -sqrtf(k);
      d[0] = perp_x + para * nx;
      d[1] = perp_y + para * ny;
      d[2] = perp_z + para * nz;
    }
    o[0] = px;
    o[1] = py;
    o[2] = pz;
    at[0] = at[1] = at[2] = 1.0f;
    return false;
  }

  const float war = sc.attr(ATT_AR, bi);
  const float wag = sc.attr(ATT_AG, bi);
  const float wab = sc.attr(ATT_AB, bi);
  float ndx = d[0], ndy = d[1], ndz = d[2];
  if (mt == 0.0f || mt == 1.0f) {
    float ru[3];
    if (DRAWN) {
      ru[0] = rec[0];
      ru[1] = rec[1];
      ru[2] = rec[2];
    } else {
      unit_draw(rid, seed, ru);
    }
    const float rux = ru[0], ruy = ru[1], ruz = ru[2];
    if (mt == 0.0f) {  // LAMBERTIAN
      ndx = nx + rux;
      ndy = ny + ruy;
      ndz = nz + ruz;
      if (fabsf(ndx) < DR_NEAR_ZERO && fabsf(ndy) < DR_NEAR_ZERO && fabsf(ndz) < DR_NEAR_ZERO) {
        ndx = nx;
        ndy = ny;
        ndz = nz;
      }
    } else {  // METAL: reflect about the oriented normal, then fuzz
      const float wfz = sc.attr(ATT_FZ, bi);
      const float rx = d[0] - 2.0f * d_dot_n * fs * nx;
      const float ry = d[1] - 2.0f * d_dot_n * fs * ny;
      const float rz = d[2] - 2.0f * d_dot_n * fs * nz;
      const float rinv = rsqrtf(rx * rx + ry * ry + rz * rz + 1e-20f);
      ndx = rx * rinv + wfz * rux;
      ndy = ry * rinv + wfz * ruy;
      ndz = rz * rinv + wfz * ruz;
      if (!((ndx * nx + ndy * ny + ndz * nz) > 0.0f)) {  // absorbed
        co[0] = co[1] = co[2] = 0.0f;
        return true;
      }
    }
  }
  o[0] = px;
  o[1] = py;
  o[2] = pz;
  d[0] = ndx;
  d[1] = ndy;
  d[2] = ndz;
  at[0] = war;
  at[1] = wag;
  at[2] = wab;
  return false;
}
