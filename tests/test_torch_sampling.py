"""The port's host samplers and device negatives against the JAX
package's: the same seed or Generator state gives the same ids."""
import shutil

import numpy as np
import pytest
import torch

from relationprediction_tpu import native as jax_native
from relationprediction_tpu import sampling as jax_sampling
from relationprediction_tpu.data import synthetic as jax_synthetic
from relationprediction_torch import native, sampling
from relationprediction_torch.training.device_sampling import (
    device_negative_parts)

TRAIN = jax_synthetic.generate(300, 11, 1500, seed=0).train


def adjacencies():
    return (jax_sampling.AdjacencyIndex(TRAIN, 300),
            sampling.AdjacencyIndex(TRAIN, 300))


def test_adjacency_index_arrays_equal():
    jadj, tadj = adjacencies()
    for name in ("sorted_edges", "sorted_others", "degrees", "offsets"):
        np.testing.assert_array_equal(getattr(tadj, name),
                                      getattr(jadj, name), err_msg=name)
    assert (tadj.n_entities, tadj.n_edges) == (jadj.n_entities,
                                               jadj.n_edges)


@pytest.mark.parametrize("seed", [0, 12345, 2 ** 62 + 7])
def test_native_sampler_gives_jax_ids(seed):
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build either native sampler")
    jadj, tadj = adjacencies()
    assert native.available() and jax_native.available()
    got = native.sample_edge_neighborhood(tadj, 600, seed)
    want = jax_native.sample_edge_neighborhood(jadj, 600, seed)
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) == 600  # without replacement
    assert native.library_path().startswith(
        str(native.BUILD_DIR))  # the port's own build, not the JAX .so


def test_fast_sampler_and_split_give_jax_ids():
    jadj, tadj = adjacencies()
    jrng, trng = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(2):
        want = jax_sampling.sample_edge_neighborhood_fast(jadj, 400, jrng)
        got = sampling.sample_edge_neighborhood_fast(tadj, 400, trng)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            sampling.graph_split(got, 0.5, trng),
            jax_sampling.graph_split(want, 0.5, jrng))


def test_numpy_sampler_and_uniform_edges_give_jax_ids():
    jadj, tadj = adjacencies()
    jrng, trng = np.random.default_rng(9), np.random.default_rng(9)
    np.testing.assert_array_equal(
        sampling.sample_edge_neighborhood(tadj, 300, trng),
        jax_sampling.sample_edge_neighborhood(jadj, 300, jrng))
    np.testing.assert_array_equal(
        sampling.sample_uniform_edges(1500, 700, trng),
        jax_sampling.sample_uniform_edges(1500, 700, jrng))
    assert trng.bit_generator.state == jrng.bit_generator.state


def test_device_negative_parts_layout_and_range():
    n, rate, v = 37, 10, 300
    positives = torch.zeros(n, 3, dtype=torch.int32)
    gen = torch.Generator().manual_seed(4)
    values, co = device_negative_parts(positives, rate, v, gen)
    assert values.shape == co.shape == (n, rate)
    assert values.dtype == torch.int32 and co.dtype == torch.bool
    assert int(values.min()) >= 0 and int(values.max()) < v
    # flat [rate * n] draws (tiled row j*n + i is positive i's copy j),
    # reshaped to (rate, n) and transposed
    again = torch.Generator().manual_seed(4)
    flat_co = torch.rand(rate * n, generator=again) < 0.5
    flat_v = torch.randint(0, v, (rate * n,), generator=again)
    assert torch.equal(co, flat_co.view(rate, n).t())
    assert torch.equal(values.long(), flat_v.view(rate, n).t())
    # a fair coin and uniform values over many draws
    big_v, big_co = device_negative_parts(
        torch.zeros(20000, 3, dtype=torch.int32), rate, v,
        torch.Generator().manual_seed(5))
    assert abs(big_co.float().mean().item() - 0.5) < 0.01
    counts = torch.bincount(big_v.reshape(-1).long(), minlength=v)
    assert counts.min() > 0.8 * counts.float().mean()
