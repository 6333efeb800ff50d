"""The port's host-side copies (config, data readers, synthetic graphs,
initializer scales) give exactly what the JAX package gives."""
import dataclasses
import os

import jax  # noqa: F401  (conftest keeps JAX on the CPU)
import numpy as np
import pytest
import torch

from relationprediction_tpu import config as jax_config
from relationprediction_tpu.data import dataset as jax_dataset
from relationprediction_tpu.data import synthetic as jax_synthetic
from relationprediction_tpu.models import initializers as jax_init
from relationprediction_torch import config as torch_config
from relationprediction_torch.data import dataset as torch_dataset
from relationprediction_torch.data import synthetic as torch_synthetic
from relationprediction_torch.models import initializers as torch_init

ROOT = os.path.join(os.path.dirname(__file__), "..")


@pytest.mark.parametrize("name", ["gcn_block", "gcn_basis", "distmult",
                                  "complex"])
def test_settings_parse_to_the_same_config(name):
    path = os.path.join(ROOT, "settings", f"{name}.exp")
    assert (dataclasses.asdict(torch_config.load(path))
            == dataclasses.asdict(jax_config.load(path)))


def test_toy_dataset_loads_identically():
    path = os.path.join(ROOT, "data", "Toy")
    a, b = jax_dataset.load(path), torch_dataset.load(path)
    assert (a.name, a.entities, a.relations) == (b.name, b.entities,
                                                 b.relations)
    for split in ("train", "valid", "test"):
        np.testing.assert_array_equal(getattr(a, split), getattr(b, split))


@pytest.mark.parametrize("profile,seed", [("FB15k-237", 0), ("WN18", 3)])
def test_synthetic_like_gives_the_same_arrays(profile, seed):
    a = jax_synthetic.like(profile, seed=seed)
    b = torch_synthetic.like(profile, seed=seed)
    assert (a.name, a.n_entities, a.n_relations) == (b.name, b.n_entities,
                                                     b.n_relations)
    for split in ("train", "valid", "test"):
        np.testing.assert_array_equal(getattr(a, split), getattr(b, split))


def test_initializer_scales_match():
    for fi, fo in ((237, 5), (14541, 500), (500, 500)):
        assert torch_init.glorot_std(fi, fo) == jax_init.glorot_std(fi, fo)
    g = torch.Generator().manual_seed(0)
    w = torch_init.normal(g, (4000, 50), 2.0)
    assert w.dtype == torch.float32
    assert abs(float(w.std()) - 2.0) < 0.05
