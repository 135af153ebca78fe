// The replay bounce and its VJP as device code: the port of
// distributed_raytracer_tpu/ops/pallas/mega_bwd_kernel.py::_local_f_rows
// (:72-212).  Plain version: ops/kernels/local_f.py::local_f_rows, which
// this follows expression for expression.
//
// local_f is written once, as a template on its scalar type S: float for
// the value, Dual (a value and one tangent) for forward-mode derivatives.
// local_f_vjp gets the VJP by forward mode: one pass per differentiable
// input (o3, d3, atten3, c3, r, albedo3, fuzz, ior: 18), each seeding that
// input's tangent with 1, and cot_in[k] = sum_j cot_out[j] * d out_j /
// d in_k.  So the derivative is of the same code that computes the value,
// and no adjoint of the five materials is derived by hand.
//
// One thread holds one row and runs only its material's branch.  The JAX
// vector code computes every branch and selects with jnp.where, whose
// derivative flows through the selected branch only, so the two agree.
// Conventions at measure-zero points follow JAX: min(x, 1) at x == 1
// passes half the tangent (jnp.minimum), |x| at x == 0 passes +tangent
// (jnp.abs).
#pragma once

#define LF_T_MIN 1e-3f
#define LF_NEAR_ZERO 1e-6f

struct Dual {
  float v, t;
  __device__ __forceinline__ Dual() : v(0.0f), t(0.0f) {}
  __device__ __forceinline__ Dual(float v_) : v(v_), t(0.0f) {}
  __device__ __forceinline__ Dual(float v_, float t_) : v(v_), t(t_) {}
};

__device__ __forceinline__ Dual operator+(Dual a, Dual b) { return Dual(a.v + b.v, a.t + b.t); }
__device__ __forceinline__ Dual operator-(Dual a, Dual b) { return Dual(a.v - b.v, a.t - b.t); }
__device__ __forceinline__ Dual operator-(Dual a) { return Dual(-a.v, -a.t); }
__device__ __forceinline__ Dual operator*(Dual a, Dual b) {
  return Dual(a.v * b.v, a.t * b.v + a.v * b.t);
}
__device__ __forceinline__ Dual operator/(Dual a, Dual b) {
  const float q = a.v / b.v;
  return Dual(q, a.t / b.v - b.t * a.v / (b.v * b.v));
}
__device__ __forceinline__ Dual operator+(Dual a, float b) { return a + Dual(b); }
__device__ __forceinline__ Dual operator+(float a, Dual b) { return Dual(a) + b; }
__device__ __forceinline__ Dual operator-(Dual a, float b) { return a - Dual(b); }
__device__ __forceinline__ Dual operator-(float a, Dual b) { return Dual(a) - b; }
__device__ __forceinline__ Dual operator*(Dual a, float b) { return Dual(a.v * b, a.t * b); }
__device__ __forceinline__ Dual operator*(float a, Dual b) { return Dual(a * b.v, a * b.t); }
__device__ __forceinline__ Dual operator/(float a, Dual b) { return Dual(a) / b; }

__device__ __forceinline__ float val(float x) { return x; }
__device__ __forceinline__ float val(Dual x) { return x.v; }

__device__ __forceinline__ float lf_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ Dual lf_sqrt(Dual x) {
  const float s = sqrtf(x.v);
  return Dual(s, x.t * 0.5f / s);
}
__device__ __forceinline__ float lf_rsqrt(float x) { return rsqrtf(x); }
__device__ __forceinline__ Dual lf_rsqrt(Dual x) {
  const float r = rsqrtf(x.v);
  return Dual(r, x.t * (-0.5f * (r / x.v)));
}
__device__ __forceinline__ float lf_abs(float x) { return x >= 0.0f ? x : -x; }
__device__ __forceinline__ Dual lf_abs(Dual x) { return x.v >= 0.0f ? x : -x; }
__device__ __forceinline__ float lf_min1(float x) { return x < 1.0f ? x : 1.0f; }
__device__ __forceinline__ Dual lf_min1(Dual x) {
  if (x.v < 1.0f) return x;
  return Dual(1.0f, x.v == 1.0f ? 0.5f * x.t : 0.0f);
}
template <typename S>
__device__ __forceinline__ S lf_pow5(S x) {  // XLA's integer_pow order
  const S x2 = x * x;
  return x * (x2 * x2);
}

// guarded normalization: v * rsqrt(|v|^2), zero for a zero vector
template <typename S>
__device__ __forceinline__ void lf_unit3(S& x, S& y, S& z) {
  const S n2 = x * x + y * y + z * z;
  const S inv = val(n2) > 0.0f ? lf_rsqrt(n2) : S(0.0f);
  x = x * inv;
  y = y * inv;
  z = z * inv;
}

// inputs (in order): o3, d3, atten3, winner center3, radius, albedo3, fuzz,
// ior; mt is the material code, ru/u the recorded draws.  Outputs: o2,
// d2, atten2, c2.
#define LF_IN 18
#define LF_OUT 12

template <typename S>
__device__ __forceinline__ void local_f(const S in[LF_IN], float mt, const float ru[3], float u,
                                        bool hit, bool act, S out[LF_OUT]) {
  const S ox = in[0], oy = in[1], oz = in[2];
  const S dx = in[3], dy = in[4], dz = in[5];
  const S ar = in[6], ag = in[7], ab = in[8];
#pragma unroll
  for (int j = 0; j < 9; ++j) out[j] = in[j];  // pass-through unless kept
  out[9] = out[10] = out[11] = S(0.0f);
  if (!act) return;
  if (!hit) {  // the sky, on the unit direction
    S ux = dx, uy = dy, uz = dz;
    lf_unit3(ux, uy, uz);
    const S sa = 0.5f * (uy + 1.0f);
    out[9] = ar * ((1.0f - sa) * 1.0f + sa * 0.5f);
    out[10] = ag * ((1.0f - sa) * 1.0f + sa * 0.7f);
    out[11] = ab * ((1.0f - sa) * 1.0f + sa * 1.0f);
    return;
  }
  const S cwx = in[9], cwy = in[10], cwz = in[11], rw = in[12];

  // the winner's t, componentwise
  const S ocx = cwx - ox, ocy = cwy - oy, ocz = cwz - oz;
  const S a = dx * dx + dy * dy + dz * dz;
  const S h = dx * ocx + dy * ocy + dz * ocz;
  const S c = ocx * ocx + ocy * ocy + ocz * ocz - rw * rw;
  const S disc = h * h - a * c;
  const S sqrtd = val(disc) > 0.0f ? lf_sqrt(disc) : S(0.0f);
  const S root_near = (h - sqrtd) / a;
  const bool near_ok = val(disc) >= 0.0f && val(root_near) > LF_T_MIN;
  const S th = near_ok ? root_near : (h + sqrtd) / a;

  // surface geometry
  const S px = ox + th * dx, py = oy + th * dy, pz = oz + th * dz;
  const S safe_r = val(rw) > 0.0f ? rw : S(1.0f);
  const S owx = (px - cwx) / safe_r, owy = (py - cwy) / safe_r, owz = (pz - cwz) / safe_r;
  const bool front = val(dx * owx + dy * owy + dz * owz) < 0.0f;
  const float fs = front ? 1.0f : -1.0f;
  const S nx = owx * fs, ny = owy * fs, nz = owz * fs;

  S ndx = dx, ndy = dy, ndz = dz;  // the "other" material: straight on
  S nox = px, noy = py, noz = pz;
  S scr = in[13], scg = in[14], scb = in[15];
  if (mt == 3.0f) return;  // ABSORB: not scattered
  if (mt == 0.0f) {        // LAMBERTIAN
    ndx = nx + ru[0];
    ndy = ny + ru[1];
    ndz = nz + ru[2];
    if (lf_abs(val(ndx)) < LF_NEAR_ZERO && lf_abs(val(ndy)) < LF_NEAR_ZERO &&
        lf_abs(val(ndz)) < LF_NEAR_ZERO) {
      ndx = nx;
      ndy = ny;
      ndz = nz;
    }
  } else if (mt == 1.0f) {  // METAL: reflect, normalize, fuzz
    const S d_dot_n = dx * nx + dy * ny + dz * nz;
    S rfx = dx - 2.0f * d_dot_n * nx;
    S rfy = dy - 2.0f * d_dot_n * ny;
    S rfz = dz - 2.0f * d_dot_n * nz;
    lf_unit3(rfx, rfy, rfz);
    const S fw = in[16];
    ndx = rfx + fw * ru[0];
    ndy = rfy + fw * ru[1];
    ndz = rfz + fw * ru[2];
    if (!(val(ndx * nx + ndy * ny + ndz * nz) > 0.0f)) return;  // absorbed
  } else if (mt == 2.0f) {  // DIELECTRIC
    const S iw = in[17];
    const S ri = front ? 1.0f / iw : iw;
    S ux = dx, uy = dy, uz = dz;
    lf_unit3(ux, uy, uz);
    const S cos_t = lf_min1(-(ux * nx + uy * ny + uz * nz));
    const S sin2 = 1.0f - cos_t * cos_t;
    const S sin_t = val(sin2) > 0.0f ? lf_sqrt(sin2) : S(0.0f);
    const bool cannot = val(ri * sin_t) > 1.0f;
    S r0 = (1.0f - ri) / (1.0f + ri);
    r0 = r0 * r0;
    const S refl = r0 + (1.0f - r0) * lf_pow5(1.0f - cos_t);
    if (cannot || val(refl) > u) {
      const S u_dot_n = ux * nx + uy * ny + uz * nz;
      ndx = ux - 2.0f * u_dot_n * nx;
      ndy = uy - 2.0f * u_dot_n * ny;
      ndz = uz - 2.0f * u_dot_n * nz;
    } else {
      const S cos_r = lf_min1(-(ux * nx + uy * ny + uz * nz));
      const S perp_x = ri * (ux + cos_r * nx);
      const S perp_y = ri * (uy + cos_r * ny);
      const S perp_z = ri * (uz + cos_r * nz);
      const S k = lf_abs(1.0f - (perp_x * perp_x + perp_y * perp_y + perp_z * perp_z));
      const S para = -(val(k) > 0.0f ? lf_sqrt(k) : S(0.0f));
      ndx = perp_x + para * nx;
      ndy = perp_y + para * ny;
      ndz = perp_z + para * nz;
    }
    scr = scg = scb = S(1.0f);
  } else if (mt == 4.0f) {  // TRANSPARENT: origin and direction unchanged
    nox = ox;
    noy = oy;
    noz = oz;
    scr = scg = scb = S(1.0f);
  }
  out[0] = nox;
  out[1] = noy;
  out[2] = noz;
  out[3] = ndx;
  out[4] = ndy;
  out[5] = ndz;
  out[6] = ar * scr;
  out[7] = ag * scg;
  out[8] = ab * scb;
}

// Whether input k can move any output of a row of material mt (a skipped
// input's cotangent is exactly zero): the winner's parameters only on a
// hit, albedo not for white or absorbing materials, fuzz only for metal,
// ior only for a dielectric.
__device__ __forceinline__ bool lf_input_used(int k, float mt, bool hit) {
  if (k < 9) return true;
  if (!hit || mt == 3.0f) return false;
  if (k >= 13 && k < 16) return mt != 2.0f && mt != 4.0f;
  if (k == 16) return mt == 1.0f;
  if (k == 17) return mt == 2.0f;
  return true;
}

// cot_in[k] = sum_j cot_out[j] * d out_j / d in_k, one forward-mode pass
// per input.  carry_od = false skips the o and d inputs, carry_at = false
// the atten inputs: at the ray's first row no cotangent is carried on,
// and o's and d's are wanted only as the primary-ray cotangents (atten is
// the constant 1 there).  A zero cotangent term is skipped rather than
// multiplied, as a reverse sweep would never reach it.
__device__ __forceinline__ void local_f_vjp(const float in[LF_IN], float mt, const float ru[3],
                                            float u, bool hit, bool act,
                                            const float cot_out[LF_OUT], bool carry_od,
                                            bool carry_at, float cot_in[LF_IN]) {
#pragma unroll 1
  for (int k = 0; k < LF_IN; ++k) {
    cot_in[k] = 0.0f;
    if ((!carry_od && k < 6) || (!carry_at && k >= 6 && k < 9) || !lf_input_used(k, mt, hit)) {
      continue;
    }
    Dual x[LF_IN];
#pragma unroll
    for (int j = 0; j < LF_IN; ++j) x[j] = Dual(in[j], j == k ? 1.0f : 0.0f);
    Dual y[LF_OUT];
    local_f<Dual>(x, mt, ru, u, hit, act, y);
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < LF_OUT; ++j) {
      if (cot_out[j] != 0.0f) s = s + cot_out[j] * y[j].t;
    }
    cot_in[k] = s;
  }
}
