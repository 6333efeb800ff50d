"""The evaluation extras, port against the JAX package on the CPU: the
score dumps (the R-GCN+ ensemble's input), the degree and frequency dumps,
the pairwise Accuracy metric, ``evaluate``'s dump flags and ``train.py``
under ``Metric=Accuracy``."""
import pathlib
import re
import shutil

import jax
import numpy as np
import pytest
import torch

from relationprediction_tpu import config as jax_config
from relationprediction_tpu import evaluate as jax_evaluate
from relationprediction_tpu.data import dataset as jax_dataset
from relationprediction_tpu.evaluation import Scorer as JaxScorer
from relationprediction_tpu.models import build_model as jax_build
from relationprediction_tpu.models.build import JittedModelView
from relationprediction_torch import config as torch_config
from relationprediction_torch import evaluate as torch_evaluate
from relationprediction_torch import train as torch_train
from relationprediction_torch.data import dataset as torch_dataset
from relationprediction_torch.data import io as torch_io
from relationprediction_torch.evaluation.scorer import Scorer
from relationprediction_torch.models.build import ModelView, build_model
from relationprediction_torch.params import params_from_jax
from relationprediction_torch.training import checkpoint

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOY = ROOT / "data" / "Toy"
CPU = torch.device("cpu")
# Each settings file cut to d = 16 (gcn_basis: 4 bases, gcn_block: 4
# blocks of 4), so that every case takes seconds.
CUTS = {"CodeDimension=500": "CodeDimension=16",
        "InternalEncoderDimension=500": "InternalEncoderDimension=16",
        "NumberOfBasisFunctions=5": "NumberOfBasisFunctions=4",
        "NumberOfBasisFunctions=100": "NumberOfBasisFunctions=4"}
# The dumps and Accuracy on an encoded model and on the embedding table;
# the CLI test takes gcn_basis, as the JAX package's does.
MODELS = ["gcn_block", "distmult"]


@pytest.fixture(autouse=True)
def one_thread():
    """torch on one CPU thread: these models are tiny, and with a thread a
    core each OpenMP's barriers stall whenever other processes hold the
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def small_settings(tmp_path, name, **keys):
    """settings/<name>.exp cut by CUTS, saving under tmp_path/m, with
    ``keys`` (e.g. Metric="Accuracy") set."""
    src = (ROOT / "settings" / f"{name}.exp").read_text()
    for a, b in CUTS.items():
        src = src.replace(a, b)
    src = re.sub(r"ExperimentName=\S+", f"ExperimentName={tmp_path / 'm'}",
                 src)
    for key, value in keys.items():
        src, n = re.subn(rf"{key}=\S+", f"{key}={value}", src)
        assert n == 1, key
    path = tmp_path / f"{name}.exp"
    path.write_text(src)
    return str(path)


def models(settings, ds):
    """(JAX model, JAX params from PRNGKey(0), port model, the same
    params) for a settings file and a dataset."""
    jmodel = jax_build(jax_config.load(settings).with_counts(
        ds.n_entities, ds.n_relations, len(ds.train)))
    jparams = jax.tree_util.tree_map(
        np.asarray, jmodel.init_params(jax.random.PRNGKey(0)))
    model = build_model(torch_config.load(settings).with_counts(
        ds.n_entities, ds.n_relations, len(ds.train)), CPU)
    return jmodel, jparams, model, params_from_jax(jparams, CPU)


def scorers(settings, ds, metric="MRR"):
    """Both packages' scorers over Toy's splits, the port's scoring in
    chunks of 2 triples."""
    jmodel, jparams, model, params = models(settings, ds)
    jgraph = jmodel.make_graph(ds.train) if jmodel.needs_graph() else None
    out = []
    for scorer, view, p, g in (
            (JaxScorer(metric=metric), JittedModelView(jmodel), jparams,
             jgraph),
            (Scorer(metric=metric, chunk_size=2), ModelView(model), params,
             model.make_graph(ds.train))):
        for t in (ds.train, ds.valid, ds.test):
            scorer.register_data(t)
        scorer.register_degrees(ds.train)
        scorer.register_model(view, p, g, n_entities=ds.n_entities)
        scorer.finalize_frequency_computation(ds.all_triples())
        out.append(scorer)
    return out


def close_scores(x, y, tol):
    """Sigmoid scores ``x`` and ``y`` equal, or their logits (the
    energies) within ``tol`` (relative and absolute): at saturated
    energies one f32 ulp of the energy moves the sigmoid by more than
    1e-6 of itself."""
    x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
    assert x.shape == y.shape
    differ = x != y
    assert ((x > 0) & (x < 1) & (y > 0) & (y < 1))[differ].all()
    np.testing.assert_allclose(
        *(np.log(v[differ]) - np.log1p(-v[differ]) for v in (x, y)),
        rtol=tol, atol=tol)


def same_dump(got_file, want_file, tol=1e-6):
    """Both files have the same lines; on each, the same count of numbers
    (split at " | ", then at tabs), held by ``close_scores``."""
    got = open(got_file).read().splitlines()
    want = open(want_file).read().splitlines()
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        close_scores(*([float(v) for part in line.split(" | ")
                        for v in part.split("\t")] for line in (a, b)),
                     tol)


# How close the dumped energies are: the embedding model computes them as
# the JAX package does; an encoder sums its messages in another order, and
# its scores are held to JAX's within tests/test_torch_encode.py's 2e-4.
ENERGY_TOL = {"distmult": 1e-6, "gcn_basis": 2e-4, "gcn_block": 2e-4}


@pytest.mark.parametrize("name", MODELS)
def test_dumps_match_jax(tmp_path, name):
    ds = jax_dataset.load(str(TOY))
    jscorer, scorer = scorers(small_settings(tmp_path, name), ds)
    jsum, summary = jscorer.compute_scores(ds.test), scorer.compute_scores(
        ds.test)
    np.testing.assert_array_equal(summary.filtered_ranks, jsum.filtered_ranks)
    for kind in ("Filtered", "Raw"):
        files = {}
        for who, s in (("jax", jsum), ("port", summary)):
            files[who] = [str(tmp_path / f"{who}_{kind}_{f}")
                          for f in ("in", "out", "vertex", "relation")]
            s.dump_degrees(*files[who][:2], filter=kind)
            s.dump_frequencies(*files[who][2:], filter=kind)
        for got, want in zip(files["port"], files["jax"]):
            assert open(got).read() == open(want).read(), got
    jscorer.dump_all_scores(ds.test, str(tmp_path / "jax_subjects"),
                            str(tmp_path / "jax_objects"))
    scorer.dump_all_scores(ds.test, str(tmp_path / "port_subjects"),
                           str(tmp_path / "port_objects"))
    for side in ("subjects", "objects"):
        same_dump(tmp_path / f"port_{side}", tmp_path / f"jax_{side}",
                  ENERGY_TOL[name])


def accuracy_pairs(triples, n_entities):
    """Even rows the positives, odd rows each with its object moved by
    one (``tests/test_scorer.py:84-94``)."""
    pairs = np.repeat(triples, 2, axis=0)
    pairs[1::2, 2] = (pairs[1::2, 2] + 1) % n_entities
    return pairs


@pytest.mark.parametrize("name", MODELS)
def test_accuracy_matches_jax(tmp_path, name):
    ds = jax_dataset.load(str(TOY))
    settings = small_settings(tmp_path, name)
    jmodel, jparams, model, params = models(settings, ds)
    pairs = accuracy_pairs(np.concatenate([ds.valid, ds.test]),
                           ds.n_entities)
    jgraph = jmodel.make_graph(ds.train) if jmodel.needs_graph() else None
    graph = model.make_graph(ds.train)
    want = np.asarray(jmodel.score(jparams, jgraph, pairs))
    close_scores(model.score(params, graph, pairs).numpy(), want,
                 ENERGY_TOL[name])
    close_scores(ModelView(model).score(params, graph, pairs).numpy(), want,
                 ENERGY_TOL[name])
    results = []
    for scorer, m, p, g in ((JaxScorer(metric="Accuracy"), jmodel, jparams,
                             jgraph),
                            (Scorer(metric="Accuracy"), ModelView(model),
                             params, graph)):
        scorer.register_model(m, p, g, n_entities=ds.n_entities)
        summary = scorer.compute_scores(pairs)
        assert summary.accuracy_string() == "Accuracy"
        assert summary.mrr_string() == "MRR"
        results.append(summary.results)
    assert results[1] == results[0]
    assert 0.0 <= results[1]["Filtered"]["Accuracy"] <= 1.0


def test_evaluate_cli_writes_the_jax_file_set(tmp_path, monkeypatch,
                                              capsys):
    """Both packages' evaluate CLIs on one port checkpoint, with every
    dump flag and --raw: the same files, the same lines."""
    ds = jax_dataset.load(str(TOY))
    settings = small_settings(tmp_path, "gcn_basis")
    _, jparams, _, _ = models(settings, ds)
    checkpoint.save(str(tmp_path / "m"), params=jparams, opt_state={},
                    step=7, rng_key=np.zeros(2, np.uint32))

    def args(out):
        return ["--settings", settings, "--dataset", str(TOY), "--cpu",
                "--split", "valid", "--dump-scores", str(out / "scores"),
                "--dump-degrees", str(out / "deg"), "--dump-frequencies",
                str(out / "freq"), "--raw"]

    torch_evaluate.main(args(tmp_path / "port"))
    port_out = capsys.readouterr().out
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cache"))
    monkeypatch.setattr("sys.argv", ["evaluate"] + args(tmp_path / "jax"))
    jax_evaluate.main()
    jax_out = capsys.readouterr().out

    def files(root):
        return sorted(str(p.relative_to(root)) for p in root.rglob("*")
                      if p.is_file())
    names = files(tmp_path / "jax")
    assert names == ["deg_in.tsv", "deg_out.tsv", "freq_relation.tsv",
                     "freq_vertex.tsv", "scores/objects.valid",
                     "scores/subjects.valid"]
    assert files(tmp_path / "port") == names
    for name in names:
        same_dump(tmp_path / "port" / name, tmp_path / "jax" / name,
                  ENERGY_TOL["gcn_basis"])
    table = [line for line in jax_out.splitlines() if line.startswith("MRR")]
    assert table and table[0] in port_out.splitlines()


def test_train_cli_stops_on_validation_accuracy(tmp_path, capsys):
    """train.py --cpu on a copy of data/Toy with pairwise accuracy splits
    and Metric=Accuracy: it checks every 5 steps, prints the test
    Accuracy, stops early and saves a checkpoint that evaluate reads."""
    data = tmp_path / "toy_accuracy"
    shutil.copytree(TOY, data)
    ds = torch_dataset.load(str(TOY))
    for split, triples in (("valid", ds.valid), ("test", ds.test)):
        torch_io.write_triplets(
            str(data / f"{split}_accuracy.txt"),
            accuracy_pairs(triples, ds.n_entities), ds.entities,
            ds.relations)
    settings = small_settings(tmp_path, "distmult", Metric="Accuracy",
                              CheckEvery=5, BurninPhaseDuration=10)
    torch_train.main(["--settings", settings, "--dataset", str(data),
                      "--cpu", "--max-iterations", "60"])
    out = capsys.readouterr().out
    scores = [float(s) for s in re.findall(
        r"Tested validation score at iteration \d+\. Result: (\S+)", out)]
    assert len(scores) >= 3 and all(0.0 <= s <= 1.0 for s in scores)
    assert re.search(r"^Accuracy\t[0-9.]+$", out, re.M), out
    assert "Final test metrics:" in out
    assert checkpoint.restore_latest(str(tmp_path / "m")) is not None
    torch_evaluate.main(["--settings", settings, "--dataset", str(data),
                         "--cpu"])
    assert re.search(r"^Accuracy\t[0-9.]+$", capsys.readouterr().out, re.M)
