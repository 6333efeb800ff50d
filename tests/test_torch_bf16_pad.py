"""The plain version of basis_project_bf16's pad pass
(``staircase2.bf16_pad_reference``) against numpy: X [M, K] copied into
[M, K_pad] and W [K, N] transposed into [N, K_pad], K_pad the multiple of
8 at or above K, the padding columns zero. At the main path's shape
(14,541 x 500 by 500 x 2,500: K_pad 504), at the odd shape that
chip_smoke.py runs (37 x 33 by 33 x 29: K_pad 40) and at a K already a
multiple of 8 (no padding column). The kernel on the card is held to
this version bit for bit by chip_smoke.py's kernel_bf16 phase."""
import numpy as np
import pytest
import torch

from relationprediction_torch.ops import staircase2

BF16 = torch.bfloat16
SHAPES = {"main": (14541, 500, 2500), "odd": (37, 33, 29),
          "k8": (64, 496, 40)}


def operands(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32))
    return x.to(BF16), w.to(BF16)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_pad_plain_is_numpy_pad(shape):
    m, k, n = SHAPES[shape]
    kp = -(-k // 8) * 8
    x, w = operands(m, k, n)
    xp, wt = staircase2.bf16_pad_reference(x, w, kp)
    assert xp.dtype == wt.dtype == BF16
    assert xp.shape == (m, kp) and wt.shape == (n, kp)
    want_x = np.pad(x.float().numpy(), ((0, 0), (0, kp - k)))
    want_w = np.pad(w.float().numpy().T, ((0, 0), (0, kp - k)))
    np.testing.assert_array_equal(xp.float().numpy(), want_x)
    np.testing.assert_array_equal(wt.float().numpy(), want_w)


@pytest.mark.parametrize("shape", ["odd", "k8"])
def test_padded_operands_give_the_plain_product(shape):
    """The zero columns add nothing: xp @ wt^T in f32, rounded to bf16, is
    the plain product of the unpadded operands within the one bf16
    rounding that two f32 sum orders can move."""
    m, k, n = SHAPES[shape]
    x, w = operands(m, k, n, seed=1)
    xp, wt = staircase2.bf16_pad_reference(x, w, -(-k // 8) * 8)
    got = (xp.float() @ wt.float().T).to(BF16).double()
    want = staircase2.basis_project_reference(x, w).double()
    assert ((got - want).abs() <= 2.0 ** -7 * want.abs() + 1e-6).all()
