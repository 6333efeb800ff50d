"""gcn_diag (settings/gcn_basis.exp with Name=gcn_diag) through the port on
the CPU against the JAX package: encode, all-entity scores and exact ranks;
loss and every gradient leaf for the same draws and masks; params after 1
and 3 Adam steps; the param tree through params_from_jax and a checkpoint;
the train and evaluate CLIs. Messages are x[src] * D[r], summed with
staircase_aggregate (TPU kernel 3); the layer adds its bias."""
import pytest

from test_torch_onehot_model import (CASES, case, check_adam_steps,
                                     check_checkpoint_and_evaluate_cli,
                                     check_encode_and_scores,
                                     check_loss_and_grads, check_ranks,
                                     check_train_cli, check_trees)


@pytest.mark.parametrize("name", CASES)
def test_encode_and_scores_match_jax(name):
    check_encode_and_scores("diag", name)


@pytest.mark.parametrize("name", CASES)
def test_scorer_ranks_equal_jax(name):
    check_ranks("diag", name)


@pytest.mark.parametrize("name", CASES)
def test_loss_and_every_gradient_leaf_match_jax(name):
    grads = check_loss_and_grads("diag", name)
    # every diag parameter is used, the bias included (gcn_diag.py:50)
    for layer in grads["gcn_layers"]:
        for key in ("D_types_forward", "D_types_backward", "W_self", "b"):
            assert layer[key].abs().max() > 0, key


@pytest.mark.parametrize("name", CASES)
def test_params_after_optimizer_steps_match_optax(name):
    check_adam_steps("diag", name)


def test_param_tree_has_the_diag_layers():
    """An input transform always (build.py:128-130), then diag layers of
    D_types [R, d], W_self [d, d] and b [d]."""
    check_trees("diag")
    ds, _, (tcfg, model, params, _) = case("diag", "synthetic")
    assert model.variant == "diag" and tcfg.encoder.gcn_variant == "basis"
    assert not model.first_layer_onehot
    assert "input_transform" in params
    d = tcfg.encoder.internal_dimension
    for layer in params["gcn_layers"]:
        assert {k: tuple(v.shape) for k, v in layer.items()} == {
            "D_types_forward": (ds.n_relations, d),
            "D_types_backward": (ds.n_relations, d),
            "W_self": (d, d), "b": (d,)}


def test_checkpoint_and_evaluate_cli_carry_the_tree(tmp_path, capsys):
    check_checkpoint_and_evaluate_cli(tmp_path, capsys, "diag")


def test_train_cli_runs_gcn_diag_on_cpu(tmp_path):
    check_train_cli(tmp_path, "diag")
