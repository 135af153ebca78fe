"""The synthetic tie scene of the dense sweep tests, shared by the CPU
tests (tests/test_torch_dense_group.py) and the card tests
(tests/test_torch_cuda.py): 301 spheres (a multiple of no G above 1), the
R = 1000 ground, a sphere of radius 0 (packed with r^2 = -1) and two
identical spheres, TWINS, which fall in different lanes at every G > 1,
the lower index in the higher lane; 333 rays, grazing ones, misses and
rays at the twins among them.  numpy only: no torch setting, no JAX."""

import numpy as np

N = 301
TWINS = (7, 289)  # the same sphere; lanes 7 and 1 at G >= 8, 3 and 1 at G = 4
PAD = 150  # radius 0: packed with r^2 = -1


def tie_arrays():
    """The scene's six arrays: the ground (radius 1000) at index 0, small
    spheres of radius 0.15-0.6 over a 24 x 24 patch, sphere PAD of radius
    0, sphere TWINS[1] a copy of TWINS[0]; random materials."""
    rng = np.random.default_rng(21)
    centers = rng.uniform([-12.0, 0.2, -12.0], [12.0, 3.0, 12.0], size=(N, 3))
    radii = rng.uniform(0.15, 0.6, N)
    centers[0], radii[0] = (0.0, -1000.0, 0.0), 1000.0
    radii[PAD] = 0.0
    centers[TWINS[1]], radii[TWINS[1]] = centers[TWINS[0]], radii[TWINS[0]]
    return dict(centers=centers.astype(np.float32), radii=radii.astype(np.float32),
                albedo=rng.uniform(0.1, 0.9, (N, 3)).astype(np.float32),
                mat_type=rng.integers(0, 3, N).astype(np.int32),
                fuzz=rng.uniform(0.0, 0.5, N).astype(np.float32),
                ior=np.full(N, 1.5, np.float32))


def tie_rays(arrays):
    """[R, 3] origins and directions, R = 333: rays from above the patch at
    random points of it, grazing rays (aimed at a sphere's rim), rays at
    the twins from just above them and rays into the sky."""
    rng = np.random.default_rng(22)
    c = arrays["centers"].astype(np.float64)
    r = arrays["radii"].astype(np.float64)

    def origins(k):
        return rng.uniform([-16.0, 1.0, -16.0], [16.0, 7.0, 16.0], size=(k, 3))

    o1 = origins(192)
    d1 = rng.uniform([-12.0, 0.0, -12.0], [12.0, 3.0, 12.0], size=(192, 3)) - o1
    o2 = origins(72)
    k = rng.choice(np.setdiff1d(np.arange(1, N), [PAD]), 72)
    perp = np.cross(c[k] - o2, rng.normal(size=(72, 3)))
    perp /= np.linalg.norm(perp, axis=-1, keepdims=True)
    d2 = c[k] + r[k, None] * perp - o2
    tw = TWINS[0]
    o3 = c[tw] + rng.uniform([-1.0, 1.5, -1.0], [1.0, 2.5, 1.0], size=(48, 3))
    d3 = c[tw] + 0.3 * r[tw] * rng.normal(size=(48, 3)) - o3
    o4 = o3[:21] + [0.0, 0.5, 0.0]
    d4 = rng.normal(size=(21, 3)) * 0.2 + [0.0, 1.0, 0.0]
    o = np.concatenate([o1, o2, o3, o4]).astype(np.float32)
    d = np.concatenate([d1, d2, d3, d4]).astype(np.float32)
    return o, d
