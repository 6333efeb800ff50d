"""The frozen bound arithmetic and the model FLOPs against hand counts on
a tiny layout: 3 vertices; row 0 takes (src 1, rel 0), (src 2, rel 0),
(src 2, rel 1); row 2 takes (src 0, rel 1)."""
from types import SimpleNamespace

import pytest
import torch

from portbench import bounds, work

LAYOUT = SimpleNamespace(row_ptr=torch.tensor([0, 3, 3, 4]),
                         src=torch.tensor([1, 2, 2, 0]),
                         rel=torch.tensor([0, 0, 1, 1]))
HBM, F32 = 3.35e12, 67e12


def test_least_time_takes_the_larger():
    assert bounds.least_time(3.35e12, 1.0)["bound_s"] == pytest.approx(1.0)
    t = bounds.least_time(1.0, 67e12)
    assert t["bound_s"] == pytest.approx(1.0)
    assert t["bound_by"] == "operations"


def test_block_direction_bound():
    # B = 2 blocks of dr = 2, d = 4: 3 gathered rows, 2 relations' blocks,
    # out [3, 4], row_ptr 4, src/rel/w 3 x 4 entries; 3 (target, relation)
    # runs.
    b = bounds.block_direction_bound(LAYOUT, 3, 2, 2)
    assert b["bytes"] == 4 * (3 * 4 + 2 * 2 * 2 * 2) + 4 * (12 + 4 + 12)
    assert b["ops"] == 2 * 4 * 4 + 2 * 3 * 4 * 2
    assert b["bound_s"] == pytest.approx(max(224 / HBM, 80 / F32))


def test_combine_bound():
    b = bounds.combine_bound(LAYOUT, 3, 2, 4)
    assert b["bytes"] == 4 * 3 * 2 * 4 + 4 * (12 + 2 * 2 + 4 + 12)
    assert b["ops"] == 2 * 4 * 2 * 4 + 4 * 2


def test_project_bound_is_the_products_own_work():
    b = bounds.project_bound(2, 3, 4)
    assert (b["bytes"], b["ops"]) == (4 * (6 + 12 + 8), 48)
    assert b["bound_s"] == pytest.approx(max(104 / HBM, 48 / (495e12 / 3)))
    # FB15k-237's basis product: 0.220 ms, as chip_smoke priced 3xTF32.
    full = bounds.project_bound(14541, 500, 2500)
    assert full["bound_s"] * 1e3 == pytest.approx(0.2203, abs=1e-4)


BLOCK = {"variant": "block", "d": 4, "dr": 2, "n_blocks": 2, "n_layers": 2}
BASIS = {"variant": "basis", "d": 4, "n_bases": 2, "n_layers": 2}


def test_message_flops():
    assert work.message_flops(BLOCK) == 2 * 4 * 2 + 2 * 4
    assert work.message_flops(BASIS) == 2 * 4 * 2 * 4 + 2 * 2 * 4 + 2 * 4
    with pytest.raises(ValueError):
        work.message_flops({"variant": "diag", "d": 4})


def test_encode_and_step_flops():
    enc = 2 * (2 * 4 * 24 + 2 * 3 * 16)
    assert work.encode_flops(BLOCK, 3, 4) == enc
    assert work.train_step_flops(BLOCK, 3, 4, 5, 2) == 3 * (enc + 3 * 4 * 15)


def test_message_flops_count_the_products():
    """The block message's FLOPs are those of its einsum: B dr x dr
    products, two FLOPs a multiply-add."""
    x = torch.randn(1, 2, 2)
    w = torch.randn(1, 2, 2, 2)
    macs = w.numel()  # one multiply-add per weight
    assert 2 * macs + 2 * 4 == work.message_flops(BLOCK)
    assert torch.einsum("ebij,ebj->ebi", w, x).shape == (1, 2, 2)
