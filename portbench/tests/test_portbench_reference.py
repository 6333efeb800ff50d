"""The plain reference against the port's CPU path at a toy size, through
the cells' own runs: the port and the reference agree to float32's
rounding (other sum orders), on the train cells' checked steps of set-up
and of the window."""
import pytest
import torch

from portbench.reference import rgcn as ref
from portbench.tests.toy import toy_run

TRAIN = ["rgcn_block.fb15k237.train", "rgcn_basis.wn18.train"]


@pytest.mark.parametrize("cell", TRAIN)
@pytest.mark.parametrize("seed", [7, 2 ** 31 + 5])
def test_train_cell_matches_the_reference(cell, seed):
    outcome, _ = toy_run(cell, seed)
    c = {k: v["value"] for k, v in outcome.compared.items()}
    # f32 losses of order 1-100 summed in other orders: 1e-4 relative;
    # leaf norms of f32 sums: 1e-4 of the larger of the leaf's and the
    # median leaf's norm.
    assert c["loss_gap"] < 1e-4 and c["grad_gap"] < 1e-4
    assert c["change_gap"] < 1e-4 and c["inputs_off"] == 0
    assert c["window_loss_gap"] < 1e-4 and c["window_change_gap"] < 1e-4
    assert outcome.correct and outcome.attempted > 0
    assert outcome.end_to_end["train_triples_per_s"] > 0


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      -3.0 - 2 ** -9])
    got = ref.tf32_round(x)
    # 1 + 2^-10 is a TF32 value; 1 + 2^-11 ties to even (1.0); 1 + 3 2^-11
    # rounds up to 1 + 2^-9; negative values round by magnitude.
    assert got.tolist() == [1.0 + 2 ** -10, 1.0, 1.0 + 2 ** -9,
                            -3.0 - 2 ** -9]
