"""Batched 1-D interval: the port of distributed_raytracer_tpu/core/
interval.py (EMPTY/UNIVERSE, size/contains/surrounds/clamp)."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

INFINITY = math.inf


class Interval(NamedTuple):
    min: torch.Tensor
    max: torch.Tensor

    def size(self):
        return self.max - self.min

    def contains(self, x):
        return (self.min <= x) & (x <= self.max)

    def surrounds(self, x):
        return (self.min < x) & (x < self.max)  # strict, the hit-range test

    def clamp(self, x):
        return torch.clamp(torch.as_tensor(x), self.min, self.max)


EMPTY = Interval(torch.tensor(INFINITY), torch.tensor(-INFINITY))
UNIVERSE = Interval(torch.tensor(-INFINITY), torch.tensor(INFINITY))
