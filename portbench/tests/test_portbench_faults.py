"""A run with the timed path broken underneath comes out not correct, for
each fault a cell can have (one card: no exchange between cards to leave
out), and so does the control: the reference with TF32 products put in
the program's place. At the toy graph on the CPU, against the limits
the cells keep."""
import pytest
import torch

from portbench import study
from portbench.tests.toy import toy_run

TRAIN = ["rgcn_block.fb15k237.train", "rgcn_basis.wn18.train"]


def unchanged_state(monkeypatch):
    """A step that returns its state unchanged."""
    from relationprediction_torch.training import engine

    def step(self, params, opt_state, batch):
        self.draw(batch)
        return opt_state, torch.tensor(0.7)
    monkeypatch.setattr(engine.TrainLoop, "train_step", step)


def half_batch(monkeypatch):
    """Half of the batch left out, the mean taken over the rest."""
    from relationprediction_torch.training import engine
    inner = engine.step_loss_and_grads

    def step(model, kind, params, batch, draws, group=None):
        mask = batch.mask.clone()
        mask[mask.shape[0] // 2:] = 0
        return inner(model, kind, params, batch._replace(mask=mask), draws,
                     group)
    monkeypatch.setattr(engine, "step_loss_and_grads", step)


def altered_gradient(monkeypatch):
    """One gradient leaf altered where it is produced."""
    from relationprediction_torch.training import engine
    inner = engine.step_loss_and_grads

    def step(*args, **kwargs):
        loss, grads = inner(*args, **kwargs)
        grads["gcn_layers"][0]["W_self"] = 2 * grads["gcn_layers"][0][
            "W_self"]
        return loss, grads
    monkeypatch.setattr(engine, "step_loss_and_grads", step)


@pytest.mark.parametrize("cell", TRAIN)
@pytest.mark.parametrize("fault", [unchanged_state, half_batch,
                                   altered_gradient])
def test_train_fault_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    outcome, _ = toy_run(cell)
    assert not outcome.correct


@pytest.mark.parametrize("cell", TRAIN)
def test_train_control_is_not_correct(cell):
    """In each run of checked steps, the control and each fault put in the
    program's place fail one of the numbers the cell compares."""
    from portbench.paths import train
    _, run = toy_run(cell)
    assert sorted(run.kept) == [0, train.WINDOW_CHECK_AT]
    for at, kept in run.kept.items():
        for what, numbers in study.train_readings(kept).items():
            assert any(c["value"] > run.limits[train.prefix(at) + k]
                       for k, c in numbers.items()
                       if train.prefix(at) + k in run.limits), (at, what)
