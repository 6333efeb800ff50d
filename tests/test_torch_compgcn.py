"""CompGCN (corr) + ConvE trained 1-N on the port's normal path, against
the plain reference ``portbench/reference/compgcn.py`` on seeded weights,
at a tiny size (V 40, R 5, d 8 -> 12, a 6 x 4 image, 4 filters of 3 x 3,
16 queries a step): the composition against its definition, one encode
and its gradients, three steps of ``TrainLoop.fit`` (losses, params and
Adam's state), a resume in the middle of a run, the test mode on
``data/Toy`` after training (the running statistics, and the energies of
tail queries and of head queries through the inverse relations), the
filtered ranking counted from the reference's energies, and the settings
the port refuses."""
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.paths.common import moving_leaves
from portbench.paths.train_kvsall import CheckedQuerySteps
from portbench.reference import compgcn as ref
from relationprediction_torch import config
from relationprediction_torch.data import dataset as dataset_lib
from relationprediction_torch.data import synthetic
from relationprediction_torch.models import encoders
from relationprediction_torch.models.build import build_model
from relationprediction_torch.params import map_tree, tree_leaves
from relationprediction_torch.train import build_scorer
from relationprediction_torch.training.engine import TrainLoop

ROOT = Path(__file__).resolve().parents[1]
SETTINGS = ROOT / "settings" / "compgcn_conve.exp"
CPU = torch.device("cpu")
# f32 sums in other orders (FFT against the circulant, CSR against edge
# order) over tiny sizes.
TOL = dict(rtol=2e-5, atol=2e-6)


def tiny_config(ds):
    cfg = config.load(str(SETTINGS))
    cfg = dataclasses.replace(
        cfg, compgcn=dataclasses.replace(
            cfg.compgcn, init_dimension=8, gcn_dimension=12, k_w=3, k_h=4,
            n_filters=4, kernel_size=3, batch_size=16),
        encoder=dataclasses.replace(cfg.encoder, internal_dimension=12,
                                    code_dimension=12),
        decoder=dataclasses.replace(cfg.decoder, code_dimension=12))
    return cfg.with_counts(ds.n_entities, ds.n_relations, len(ds.train))


def spec_of(cfg):
    c = cfg.compgcn
    return ref.Spec(d_in=c.init_dimension, k_w=c.k_w, k_h=c.k_h,
                    n_filters=c.n_filters, kernel=c.kernel_size,
                    layer_drop=c.layer_dropout, hidden_drop=c.hidden_dropout,
                    feature_drop=c.feature_dropout,
                    decoder_drop=c.decoder_dropout,
                    smoothing=c.label_smoothing, batch=c.batch_size,
                    lr=cfg.optimizer.learning_rate)


@pytest.fixture(scope="module")
def case():
    ds = synthetic.generate(40, 5, 120, 10, 10, seed=3)
    cfg = tiny_config(ds)
    model = build_model(cfg, CPU)
    params = model.init_params(torch.Generator().manual_seed(5))
    # A bias away from 0 in the scorer, as training leaves it.
    params["decoder"]["entity_bias"].normal_(0, 0.1,
                                             generator=torch.Generator()
                                             .manual_seed(6))
    return ds, cfg, model, params


def flat(tree) -> dict:
    return ref.leaves(tree)


@pytest.mark.parametrize("shape", [(5, 8), (3, 7), (2, 3, 12)])
def test_ccorr_is_the_definition(shape):
    gen = torch.Generator().manual_seed(sum(shape))
    a = torch.randn(shape, generator=gen, dtype=torch.float64)
    b = torch.randn(shape, generator=gen, dtype=torch.float64)
    d = shape[-1]
    want = torch.stack([sum(a[..., i] * b[..., (i + k) % d]
                            for i in range(d)) for k in range(d)], -1)
    assert torch.allclose(encoders.ccorr(a, b), want, rtol=1e-12,
                          atol=1e-12)
    circ = (a.unsqueeze(-2) @ ref.circulant(b)).squeeze(-2)
    assert torch.allclose(circ, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("what", ["entity_codes", "relation_codes",
                                  "gradients"])
def test_encode_matches_reference(case, what):
    """A train-mode encode (the layer, its dropouts and BatchNorm, the
    codes' dropout) and the gradients of a weighted sum of its codes."""
    ds, cfg, model, params = case
    masks = model.draw_keep_masks(torch.Generator().manual_seed(9))
    graph = model.make_graph(ds.train)
    train = torch.as_tensor(ds.train)
    spec = spec_of(cfg)
    weights = [torch.randn(model.n_entities, 12,
                           generator=torch.Generator().manual_seed(1)),
               torch.randn(2 * model.n_relations, 12,
                           generator=torch.Generator().manual_seed(2))]
    sides = []
    for fn in (lambda p: tuple(model.encode(p, graph, deterministic=False,
                                            keep_masks=masks))[:2],
               lambda p: ref.encode(p, ref.halves(train, model.n_entities,
                                                  model.n_relations),
                                    spec, masks)):
        leaves = flat(params)
        for t in leaves.values():
            t.requires_grad_(True)
        x, z = fn(params)
        loss = (x * weights[0]).sum() + (z * weights[1]).sum()
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
        for t in leaves.values():
            t.requires_grad_(False)
        sides.append({"entity_codes": x.detach(), "relation_codes":
                      z.detach(), "gradients": {
                          k: torch.zeros_like(t) if g is None else g
                          for (k, t), g in zip(leaves.items(), grads)}})
    got, want = (s[what] for s in sides)
    if what == "gradients":
        for k in want:
            assert torch.allclose(got[k], want[k], **TOL), k
    else:
        assert torch.allclose(got, want, **TOL)


def fit_checked(ds, cfg, params, steps, **fit):
    model = build_model(cfg, CPU)
    loop = TrainLoop(model, cfg, ds, seed=4, log=lambda _: None,
                     prefetch=False)
    checked = CheckedQuerySteps(loop, 0, steps)
    opt_state = loop.optimizer.init(params)
    result = loop.fit(params, opt_state, max_iterations=steps, **fit)
    checked.close()
    return checked, result, loop


@pytest.mark.parametrize("what", ["losses", "params", "adam"])
def test_fit_matches_reference(case, what):
    """Three steps of ``TrainLoop.fit`` against the reference on the same
    queries, label rows and keep-masks."""
    ds, cfg, _, params0 = case
    params = map_tree(torch.clone, params0)
    checked, result, loop = fit_checked(ds, cfg, params, 3)
    assert loop.loss_kind == "kvsall"
    want = ref.train_steps(params0, checked.steps, spec_of(cfg),
                           torch.as_tensor(ds.train), ds.n_relations)
    if what == "losses":
        assert np.allclose([s["loss"] for s in result.steps],
                           want["losses"], rtol=1e-5)
        assert [s["queries"] for s in result.steps] == [16] * 3
        assert all(s["label_entries"] >= 16 for s in result.steps)
        return
    got = flat(result.params) if what == "params" else {
        **{"mu/" + k: v for k, v in flat(result.opt_state["mu"]).items()},
        **{"nu/" + k: v for k, v in flat(result.opt_state["nu"]).items()}}
    ref_side = want["params"] if what == "params" else {
        **{"mu/" + k: v for k, v in want["mu"].items()},
        **{"nu/" + k: v for k, v in want["nu"].items()}}
    assert set(got) == set(ref_side)
    # A leaf whose gradient is nought but for rounding (bn0's shift, which
    # bn1 takes out again) moves under Adam by rounding alone.
    moving = moving_leaves(want["first_grads"])
    for k in ref_side:
        if moving[k.split("/", 1)[1] if what == "adam" else k]:
            assert torch.allclose(got[k], ref_side[k], rtol=1e-4,
                                  atol=1e-6), k
    if what == "adam":
        assert int(result.opt_state["count"]) == 3


def test_resume_mid_run_continues_the_run(case, tmp_path):
    """Four steps straight, against two, a checkpoint, and two more in a
    new loop: the same params, Adam state and running statistics, bit for
    bit."""
    ds, base, _, _ = case
    cfg = dataclasses.replace(base, optimizer=dataclasses.replace(
        base.optimizer, save_every_n=2))
    ckpt = str(tmp_path / "ck")

    def loop_of():
        model = build_model(cfg, CPU)
        return model, TrainLoop(model, cfg, ds, seed=4, log=lambda _: None,
                                prefetch=False)
    model_a, straight = loop_of()
    a = straight.fit(*straight.init_state(1), max_iterations=4)
    model_b, first = loop_of()
    first.fit(*first.init_state(1), max_iterations=2, checkpoint_path=ckpt)
    model_c, second = loop_of()
    b = second.resume(ckpt, max_iterations=4)
    assert b.iterations == 4
    for x, y in zip(tree_leaves(a.params) + tree_leaves(a.opt_state)
                    + tree_leaves(model_a.batch_stats),
                    tree_leaves(b.params) + tree_leaves(b.opt_state)
                    + tree_leaves(model_c.batch_stats)):
        assert torch.equal(x, y)


@pytest.fixture(scope="module")
def toy():
    """``data/Toy`` after three steps of ``TrainLoop.fit``, each a call of
    its own: the program's params, its running statistics and the
    test-mode energies of the test split's tail queries (s, r, ?) and head
    queries (?, r, o); and the reference's statistics and energies. The
    reference moves its statistics by each step's batch from the program's
    params before that step, since bn0's leaves, whose gradient is nought
    but for rounding, move under Adam by rounding alone, and its own params
    would part from the program's there; it scores with the program's
    params after the last step and its own statistics, a head query as
    (o, r + R, ?)."""
    ds = dataset_lib.load(str(ROOT / "data" / "Toy"))
    cfg = tiny_config(ds)
    model = build_model(cfg, CPU)
    loop = TrainLoop(model, cfg, ds, seed=4, log=lambda _: None,
                     prefetch=False)
    checked = CheckedQuerySteps(loop, 0, 3)
    params = model.init_params(torch.Generator().manual_seed(2))
    opt_state = loop.optimizer.init(params)
    before = []
    for i in range(3):
        before.append(map_tree(torch.clone, params))
        result = loop.fit(params, opt_state, start_iteration=i,
                          max_iterations=i + 1)
        params, opt_state = result.params, result.opt_state
    checked.close()
    spec, train = spec_of(cfg), torch.as_tensor(ds.train)
    stats = ref.init_stats(spec)
    for p, step in zip(before, checked.steps):
        stats = ref.train_steps(p, [step], spec, train, ds.n_relations,
                                stats=stats)["stats"]
    test = np.asarray(ds.test, dtype=np.int64)
    graph = model.make_graph(ds.train)
    with torch.no_grad():
        got = {"tails": model.score_all_objects(params, graph, test,
                                                apply_sigmoid=False),
               "heads": model.score_all_subjects(params, graph, test,
                                                 apply_sigmoid=False)}
    queries = {"tails": test[:, [0, 1]],
               "heads": test[:, [2, 1]] + [0, ds.n_relations]}
    want = {k: ref.test_energies(params, stats, spec, train, ds.n_relations,
                                 torch.as_tensor(q))
            for k, q in queries.items()}
    return ds, model, params, stats, got, want


@pytest.mark.parametrize("what", ["batch_stats", "tails", "heads"])
def test_test_mode_matches_reference(toy, what):
    """The running statistics the train steps leave (momentum 0.1, the
    unbiased variance), and the test-mode energies: BatchNorm by them, no
    dropout, a head query through the inverse relation."""
    _, model, _, stats, got, want = toy
    if what != "batch_stats":
        assert torch.allclose(got[what], want[what], rtol=1e-5, atol=1e-6)
        return
    mine = {"layer": model.batch_stats["layers"][0],
            **{k: model.batch_stats[k] for k in ("bn0", "bn1", "bn2")}}
    assert set(mine) == set(stats)
    for k in stats:
        for s in ("mean", "var"):
            assert torch.allclose(mine[k][s], stats[k][s], **TOL), (k, s)
            # Three steps moved them off their start.
            assert not torch.allclose(stats[k][s],
                                      ref.init_stats(spec_of(
                                          model.config))[k][s]), (k, s)


def test_filtered_ranking_on_toy(toy):
    """The scorer's filtered ranks on ``data/Toy``'s test split, after
    training, equal the ones counted from the reference's test-mode
    energies: each rank 1 + the entities outside the query's known
    answers scoring at least the gold's, heads then tails."""
    ds, model, params, _, _, want = toy
    scorer = build_scorer(model, ds, "MRR")
    scorer.set_params(params)
    summary = scorer.compute_scores(ds.test)
    test = np.asarray(ds.test, dtype=np.int64)
    every = np.concatenate([ds.train, ds.valid, ds.test])
    ranks = []
    for side, gold, key_cols, answer in (("heads", 0, (2, 1), 0),
                                         ("tails", 2, (0, 1), 2)):
        for row, t in zip(want[side].numpy(), test):
            known = {int(x[answer]) for x in every
                     if x[key_cols[0]] == t[key_cols[0]]
                     and x[1] == t[1]}
            outside = np.ones(len(row), dtype=bool)
            outside[list(known)] = False
            ranks.append(1 + int((row[outside] >= row[t[gold]]).sum()))
    assert summary.filtered_ranks.tolist() == ranks


@pytest.mark.parametrize("refused", ["message_bf16", "stream_bf16", "mesh",
                                     "vertex_sharded", "composition",
                                     "bias"])
def test_settings_the_port_refuses(refused, tmp_path):
    text = SETTINGS.read_text()
    if refused in ("mesh", "vertex_sharded"):
        cfg = config.load(str(SETTINGS))
        with pytest.raises(ValueError, match="one device"):
            config.require_single_card(cfg, refused == "mesh",
                                       refused == "vertex_sharded")
        return
    edit = {"message_bf16": ("\tBias=No\n",
                             "\tBias=No\n\tMessagePrecision=bfloat16\n"),
            "stream_bf16": ("\tFilterSize=7\n",
                            "\tFilterSize=7\n\tStreamPrecision=bf16\n"),
            "composition": ("Composition=corr", "Composition=sub"),
            "bias": ("Bias=No", "Bias=Yes")}[refused]
    path = tmp_path / "s.exp"
    path.write_text(text.replace(*edit))
    with pytest.raises(ValueError):
        config.load(str(path))
