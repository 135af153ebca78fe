"""Batched ray type: the port of distributed_raytracer_tpu/core/ray.py."""

from __future__ import annotations

from typing import NamedTuple

import torch


class Ray(NamedTuple):
    origin: torch.Tensor     # [..., 3]
    direction: torch.Tensor  # [..., 3]

    def at(self, t) -> torch.Tensor:
        """origin + t * direction, t broadcast over [...]."""
        return self.origin + torch.as_tensor(t)[..., None] * self.direction
