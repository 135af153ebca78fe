// In-kernel primary ray: the device-function port of
// distributed_raytracer_tpu/ops/pallas/mega_render_kernel.py::camera_ray_rows.
// Pixel jitter and the sqrt-polar defocus-disk sample from the 24-float
// camera row, with draws keyed (rid, cam_seed, 8..11), in the JAX
// expression order.  Plain version: ops/kernels/mega_render_kernel.py::
// camera_ray_rows.
#pragma once
#include "hash.cuh"

// camera-row offsets (ops/camera.py)
#define CAM_CTR 0
#define CAM_P00 3
#define CAM_PDU 6
#define CAM_PDV 9
#define CAM_DDU 12
#define CAM_DDV 15
#define CAM_ANG 18
#define CAM_ROW 24
#define CAM_D0 8u

__device__ __forceinline__ void camera_ray(const float* cam, uint32_t pix, uint32_t rid,
                                           uint32_t cam_seed, uint32_t w, float o[3],
                                           float d[3]) {
  float jx = hash_u01(rid, cam_seed, CAM_D0 + 0u);
  float jy = hash_u01(rid, cam_seed, CAM_D0 + 1u);
  float u1 = hash_u01(rid, cam_seed, CAM_D0 + 2u);
  float u2 = hash_u01(rid, cam_seed, CAM_D0 + 3u);
  uint32_t j = pix / w;
  uint32_t i = pix - j * w;
  float fi = (float)i + (jx - 0.5f);
  float fj = (float)j + (jy - 0.5f);
  float rr = sqrtf(u1);
  float th = 6.2831853f * u2;
  float p_x = rr * cosf(th);
  float p_y = rr * sinf(th);
  bool use_disk = cam[CAM_ANG] > 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float ps = cam[CAM_P00 + k] + fi * cam[CAM_PDU + k] + fj * cam[CAM_PDV + k];
    float ctr = cam[CAM_CTR + k];
    o[k] = use_disk ? ctr + p_x * cam[CAM_DDU + k] + p_y * cam[CAM_DDV + k] : ctr;
    d[k] = ps - o[k];
  }
}
