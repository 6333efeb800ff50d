"""Weight initializers with the reference's numerics.

The reference's ``glorot_variance`` (``shared_functions.py:12-13``) is used
as a *standard deviation*: ``np.random.normal(mean, variance)`` takes the
scale as its second argument, so weights are N(0, (3/sqrt(fi+fo))^2). Kept
exactly, quirk included, as in ``relationprediction_tpu/models/
initializers.py``. Draws come from an explicit ``torch.Generator``; they are
not JAX's bits for the same seed.
"""
from __future__ import annotations

import math

import torch


def glorot_std(fan_in: int, fan_out: int) -> float:
    return 3.0 / math.sqrt(fan_in + fan_out)


def normal(generator: torch.Generator, shape, std: float) -> torch.Tensor:
    return std * torch.randn(tuple(shape), generator=generator,
                             dtype=torch.float32,
                             device=generator.device)


def zeros(shape, device=None) -> torch.Tensor:
    return torch.zeros(tuple(shape), dtype=torch.float32, device=device)
