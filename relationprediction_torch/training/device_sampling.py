"""Negatives drawn on the device (``relationprediction_tpu/training/
device_sampling.py``).

The host ships only the padded positives; the corruptions are drawn on the
batch's device from an explicit ``torch.Generator``:

- binomial (``device_negative_parts``, ``device_negative_sample``): a fair
  coin per slot picks the subject or the object, a uniform entity
  replaces it;
- split (``device_negative_entities_split``): rate//2 uniform subjects
  and rate - rate//2 uniform objects per positive;
- shared (``device_negative_pool``): one pool of uniform entities for the
  whole batch.

The distributions are the JAX package's; the bits are not (JAX's threefry
and torch's Philox streams differ), so the tests feed both the same draws.
"""
from __future__ import annotations

from typing import Tuple

import torch


def _binomial_draws(n: int, rate: int, n_entities: int,
                    generator: torch.Generator
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(corrupt_object [rate * n] bool, values [rate * n] int32), flat in
    the tiled batch's order: row j*n + i is positive i's copy j."""
    device = generator.device
    corrupt_object = torch.rand(rate * n, generator=generator,
                                device=device) < 0.5
    values = torch.randint(0, n_entities, (rate * n,), generator=generator,
                           device=device, dtype=torch.int64)
    return corrupt_object, values.to(torch.int32)


def device_negative_parts(positives: torch.Tensor, rate: int,
                          n_entities: int, generator: torch.Generator
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The binomial corruption of ``positives`` [n, 3], without the tiled
    batch (``device_sampling.py:48-73``).

    Returns (values [n, rate] int32 corrupted-entity ids, uniform in
    [0, n_entities); corrupt_object [n, rate] bool, True where the object
    slot is replaced): the flat draws reshaped to (rate, n) and
    transposed, so the same generator state gives the corruptions of
    ``device_negative_sample``.
    """
    n = positives.shape[0]
    corrupt_object, values = _binomial_draws(n, rate, n_entities, generator)
    return values.view(rate, n).t(), corrupt_object.view(rate, n).t()


def device_negative_sample(positives: torch.Tensor, pos_mask: torch.Tensor,
                           rate: int, n_entities: int,
                           generator: torch.Generator
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """The binomial corruption as the (rate+1)-tiled batch
    (``device_sampling.py:18-45``), in ``NegativeSampler.transform``'s
    layout: the positives first, then copy j of positive i at row
    j*n + i with its subject or object replaced.

    positives [n, 3] int32 (padding rows allowed, ``pos_mask`` 0 there).
    Returns (triples [(rate+1) n, 3] int32, labels [(rate+1) n] float32,
    mask [(rate+1) n] float32).
    """
    n = positives.shape[0]
    corrupt_object, values = _binomial_draws(n, rate, n_entities, generator)
    tiled = positives.repeat(rate + 1, 1)
    neg = tiled[n:]
    s = torch.where(corrupt_object, neg[:, 0], values)
    o = torch.where(corrupt_object, values, neg[:, 2])
    triples = torch.cat([tiled[:n], torch.stack([s, neg[:, 1], o], 1)])
    labels = torch.cat([pos_mask, pos_mask.new_zeros(n * rate)])
    return triples, labels, pos_mask.repeat(rate + 1)


def device_negative_entities_split(positives: torch.Tensor, rate: int,
                                   n_entities: int,
                                   generator: torch.Generator
                                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The split protocol's corruptions (``device_sampling.py:76-93``):
    (neg_subjects [n, rate//2], neg_objects [n, rate - rate//2]) uniform
    int32 entity ids, the subjects drawn first."""
    n = positives.shape[0]
    k_s = rate // 2
    kw = dict(generator=generator, device=generator.device,
              dtype=torch.int64)
    neg_subjects = torch.randint(0, n_entities, (n, k_s), **kw)
    neg_objects = torch.randint(0, n_entities, (n, rate - k_s), **kw)
    return neg_subjects.to(torch.int32), neg_objects.to(torch.int32)


def device_negative_pool(pool_size: int, n_entities: int,
                         generator: torch.Generator) -> torch.Tensor:
    """The shared protocol's pool (``engine.py:420-424``): ``pool_size``
    uniform int32 entity ids for the whole batch, whatever the rate."""
    return torch.randint(0, n_entities, (pool_size,), generator=generator,
                         device=generator.device,
                         dtype=torch.int64).to(torch.int32)
