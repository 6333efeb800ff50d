"""Negatives drawn on the device (``relationprediction_tpu/training/
device_sampling.py:48-73``).

The host ships only the padded positives; the binomial corruption (a fair
coin per slot picks the subject or the object, a uniform entity replaces
it) is drawn on the batch's device from an explicit ``torch.Generator``.
The distribution is the JAX package's; the bits are not (JAX's threefry and
torch's Philox streams differ), so the tests feed both the same draws.
"""
from __future__ import annotations

from typing import Tuple

import torch


def device_negative_parts(positives: torch.Tensor, rate: int,
                          n_entities: int, generator: torch.Generator
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The binomial corruption of ``positives`` [n, 3], without the tiled
    batch.

    Returns (values [n, rate] int32 corrupted-entity ids, uniform in
    [0, n_entities); corrupt_object [n, rate] bool, True where the object
    slot is replaced). As in the JAX package, the draws are flat
    [rate * n] (tiled row j*n + i is positive i's copy j), reshaped to
    (rate, n) and transposed to [n, rate].
    """
    n = positives.shape[0]
    device = generator.device
    corrupt_object = torch.rand(rate * n, generator=generator,
                                device=device) < 0.5
    values = torch.randint(0, n_entities, (rate * n,), generator=generator,
                           device=device, dtype=torch.int64)
    return (values.to(torch.int32).view(rate, n).t(),
            corrupt_object.view(rate, n).t())
