"""Losses for inverse rendering: the port of the loss of
distributed_raytracer_tpu/grad/diff_render.py."""

from __future__ import annotations

import torch


def image_loss(img: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean-squared error in linear color space."""
    return torch.mean((img - target.reshape(img.shape)) ** 2)
