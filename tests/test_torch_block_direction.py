"""The port's block_direction (plain path on the CPU) against JAX's fused
staircase2.block_direction run in Pallas interpret mode."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relationprediction_tpu.ops import staircase2 as jax_s2
from relationprediction_torch.graph import build_csr
from relationprediction_torch.ops import staircase2 as torch_s2

V, R, E = 150, 7, 600


def edge_list(seed):
    """Random edges with weight-0 padding, phantom-target padding, a
    repeated (src, rel, tgt) and a vertex (V - 1) with no edges."""
    rng = np.random.default_rng(seed)
    senders = rng.integers(0, V - 1, E).astype(np.int32)
    relations = rng.integers(0, R, E).astype(np.int32)
    receivers = rng.integers(0, V - 1, E).astype(np.int32)
    weights = (rng.random(E) * 0.9 + 0.1).astype(np.float32)
    weights[rng.random(E) < 0.1] = 0.0
    senders[1], relations[1], receivers[1] = (senders[0], relations[0],
                                              receivers[0])
    weights[:2] = 0.5
    senders[-5:], relations[-5:], receivers[-5:] = V, 0, V
    weights[-5:] = 0.0
    return senders, relations, receivers, weights


def inputs(seed, n_blocks, dr):
    rng = np.random.default_rng(seed + 100)
    x = rng.standard_normal((V, n_blocks * dr)).astype(np.float32)
    blocks = rng.standard_normal((R, n_blocks, dr, dr)).astype(np.float32)
    return x, blocks


@pytest.mark.parametrize("direction", ["forward", "backward"])
@pytest.mark.parametrize("n_blocks,dr", [(4, 5), (8, 4)])
def test_block_direction_matches_jax(direction, n_blocks, dr):
    senders, relations, receivers, weights = edge_list(0)
    x, blocks = inputs(0, n_blocks, dr)
    pair = jax_s2.build_staircase2_pair(
        senders, relations, receivers, weights, V, direction=direction,
        rb=64, chunk=128, k=2, group=8)
    want = np.asarray(jax_s2.block_direction(
        jnp.asarray(x), jnp.asarray(blocks), pair, n_blocks, V,
        interpret=True, compute_dtype=None))

    src, tgt = ((senders, receivers) if direction == "forward"
                else (receivers, senders))
    layout, _ = build_csr(src, relations, tgt, weights, V)
    got = torch_s2.block_direction(torch.from_numpy(x),
                                   torch.from_numpy(blocks), layout, V)
    assert got.shape == (V, n_blocks * dr) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    assert not got[V - 1].any()  # the vertex with no edges gets zeros


def test_reference_orientation_is_w_times_x():
    """y[b*dr + i] = sum_j W[r, b, i, j] x[b*dr + j] on a single edge."""
    rng = np.random.default_rng(3)
    n_blocks, dr = 3, 2
    x = rng.standard_normal((2, n_blocks * dr)).astype(np.float32)
    blocks = rng.standard_normal((1, n_blocks, dr, dr)).astype(np.float32)
    layout, _ = build_csr([0], [0], [1], [0.5], 2)
    got = torch_s2.block_direction_reference(
        torch.from_numpy(x), torch.from_numpy(blocks), layout, 2).numpy()
    want = 0.5 * np.einsum("bij,bj->bi", blocks[0],
                           x[0].reshape(n_blocks, dr)).reshape(-1)
    np.testing.assert_allclose(got[1], want, rtol=1e-6, atol=1e-6)
    assert not got[0].any()


def test_launches_do_not_move_on_cpu():
    senders, relations, receivers, weights = edge_list(1)
    x, blocks = inputs(1, 4, 5)
    layout, _ = build_csr(senders, relations, receivers, weights, V)
    before = torch_s2.block_direction.launches
    torch_s2.block_direction(torch.from_numpy(x), torch.from_numpy(blocks),
                             layout, V)
    assert torch_s2.block_direction.launches == before


def test_no_fallback_for_other_devices():
    """Only a CPU tensor takes the plain path; any other device launches
    the kernel or raises."""
    layout = build_csr([0], [0], [1], [1.0], 2)[0].to("meta")
    x = torch.empty(2, 10, device="meta")
    blocks = torch.empty(1, 2, 5, 5, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        torch_s2.block_direction(x, blocks, layout, 2)
