"""The port's offline tools against the JAX package's on the same seeded
inputs (ensemble, make_datasets, subgraph, dictionaries), cluster's
loaders on a port checkpoint, and ``observability.trace`` on the CPU."""
import json

import numpy as np
import pytest
import torch

from relationprediction_tpu.tools import cluster as jax_cluster
from relationprediction_tpu.tools import dictionaries as jax_dictionaries
from relationprediction_tpu.tools import ensemble as jax_ensemble
from relationprediction_tpu.tools import make_datasets as jax_mk
from relationprediction_tpu.tools import subgraph as jax_subgraph
from relationprediction_torch import observability
from relationprediction_torch.params import params_to_numpy
from relationprediction_torch.tools import (cluster, dictionaries, ensemble,
                                            make_datasets, subgraph)
from relationprediction_torch.training import checkpoint

# -- ensemble (the cases of tests/test_ensemble.py) ----------------------

DEGREES = {"m1": ([(1, 0.5), (10, 0.2)], [(2, 0.25), (20, 0.1)]),
           "m2": ([(1, 0.9), (10, 0.8)], [(2, 0.7), (20, 0.6)])}
SCORES = {"m1": {"subjects.test": [(0.9, [0.1, 0.2]), (0.8, [0.0, 0.5])],
                 "objects.test": [(0.7, [0.2, 0.1])]},
          "m2": {"subjects.test": [(0.1, [0.9, 0.8]), (0.2, [0.9, 0.6])],
                 "objects.test": [(0.3, [0.8, 0.9])]}}


def write_dumps(root):
    for model in ("m1", "m2"):
        folder = root / model
        folder.mkdir(parents=True, exist_ok=True)
        for name, rows in zip(("degrees.in", "degrees.out"),
                              DEGREES[model]):
            (folder / name).write_text("".join(f"{d}\t{m}\n"
                                               for d, m in rows))
        for name, rows in SCORES[model].items():
            (folder / name).write_text("".join(
                f"{t} | " + "\t".join(str(x) for x in others) + "\n"
                for t, others in rows))
    return str(root / "m1"), str(root / "m2")


@pytest.mark.parametrize("method, arg, want", [
    # triple 0: total degree 3 < 10, model 1's MRRs; triple 1: 30, model 2's
    ("cutoff", 10, dict(mrrs=[0.5, 0.25, 0.8, 0.6],
                        hits={1: 0.0, 2: 0.75, 4: 1.0})),
    # weight 1.0: model 1 ranks every gold first; 0.0: model 2 last
    ("weighted_sum", 1.0, dict(ranks=[1, 1, 1], hits={1: 1.0})),
    ("weighted_sum", 0.0, dict(ranks=[3, 3, 3], hits={1: 0.0, 3: 1.0})),
    ("weighted_sum", 0.5, dict(ranks=None, hits={1: None, 3: None})),
])
def test_ensemble_equals_jax(tmp_path, capsys, method, arg, want):
    m1, m2 = write_dumps(tmp_path)
    if method == "cutoff":
        got, ref = (mod.CutoffEnsemble(arg, m1, m2)
                    for mod in (ensemble, jax_ensemble))
    else:
        got, ref = (mod.WeightEnsemble(arg, m1, m2)
                    for mod in (ensemble, jax_ensemble))
    got.compute_ranks()
    ref.compute_ranks()
    field = "mrrs" if method == "cutoff" else "ranks"
    np.testing.assert_array_equal(getattr(got, field), getattr(ref, field))
    if want.get(field) is not None:
        np.testing.assert_allclose(getattr(got, field), want[field])
    assert got.combined_mrr() == ref.combined_mrr()
    for k, value in want["hits"].items():
        assert got.hits_at(k) == ref.hits_at(k)
        if value is not None:
            assert got.hits_at(k) == value

    argv = ["--p1", m1, "--p2", m2, "--method", method,
            "--cutoff" if method == "cutoff" else "--weight", str(arg)]
    ensemble.main(argv)
    lines = capsys.readouterr().out.split()
    assert [float(x) for x in lines] == [
        ref.combined_mrr(), ref.hits_at(1), ref.hits_at(3), ref.hits_at(10)]


def test_read_files_equal_jax(tmp_path):
    m1, _ = write_dumps(tmp_path)
    for name in ("subjects.test", "objects.test"):
        for (t, o), (jt, jo) in zip(
                ensemble.read_score_file(f"{m1}/{name}"),
                jax_ensemble.read_score_file(f"{m1}/{name}")):
            assert t == jt
            np.testing.assert_array_equal(o, jo)
    assert ensemble.read_degree_file(f"{m1}/degrees.in") == \
        jax_ensemble.read_degree_file(f"{m1}/degrees.in")


# -- make_datasets (the cases of tests/test_make_datasets.py) ------------

def toy_triples(n=200, n_ent=40, n_rel=5, seed=0):
    rng = np.random.default_rng(seed)
    arr = np.stack([rng.integers(0, n_ent, n), rng.integers(0, n_rel, n),
                    rng.integers(0, n_ent, n)], axis=1)
    return np.array([[f"e{s}", f"r{r}", f"e{o}"] for s, r, o in arr],
                    dtype=object)


STAR = np.array([[f"l{i}", "r", "h"] for i in range(30)]
                + [["a", "r", "b"], ["b", "r", "c"], ["c", "r", "a"]],
                dtype=object)
CHAIN = np.array([["a", "r1", "b"], ["b", "r2", "c"], ["a", "r3", "d"]],
                 dtype=object)
MK_CASES = {
    "grow": ("grow_subgraph", lambda: (toy_triples(), 50), {}, 1),
    "grow_capped": ("grow_subgraph", lambda: (STAR, 100),
                    dict(degree_cap=10, start_entity="a"), 0),
    "carve": ("carve", lambda: (toy_triples(100), 20), {}, 2),
    "second_order": ("second_order_dataset", lambda: (CHAIN,),
                     dict(keep_prob=1.0), 0),
    "second_order_empty": ("second_order_dataset", lambda: (CHAIN[:2],),
                           dict(keep_prob=0.0), 0),
    "second_order_thinned": ("second_order_dataset",
                             lambda: (toy_triples(80, n_ent=20),), {}, 6),
    "split": ("split_by_entities", lambda: (toy_triples(300, n_ent=60),),
              dict(max_edges=60), 3),
    "degree": ("build_degree_dataset", lambda: (toy_triples(400, 50),),
               dict(target_edges=100, degree_cap=200, n_valid=10,
                    n_test=10), 4),
    "single_label": ("build_single_label_dataset",
                     lambda: (toy_triples(400, 50),),
                     dict(target_edges=40, n_valid=5, n_test=5), 7),
    "split_dataset": ("build_split_dataset",
                      lambda: (toy_triples(300, n_ent=80, seed=9),),
                      dict(n_valid=40, n_test=40), 5),
}


def as_list(out):
    parts = out if isinstance(out, tuple) else (out,)
    return [np.asarray(p).tolist() for p in parts]


@pytest.mark.parametrize("case", sorted(MK_CASES))
def test_make_datasets_equals_jax(case):
    fn, inputs, kwargs, seed = MK_CASES[case]
    args = inputs()
    got, want = (as_list(getattr(mod, fn)(
        *args, np.random.default_rng(seed), **kwargs))
        for mod in (make_datasets, jax_mk))
    assert got == want
    if case == "grow_capped":
        assert set(got[0]) == {30, 31, 32}


def write_source(folder, triples):
    folder.mkdir(parents=True, exist_ok=True)
    (folder / "train.txt").write_text("".join(
        f"{s}\t{r}\t{o}\n" for s, r, o in triples))
    return folder


def tree_text(root):
    return {str(p.relative_to(root)): p.read_text()
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("kind, extra", [
    ("degree", ["--edges", "100", "--valid", "10", "--test", "10"]),
    ("single-label", ["--edges", "40", "--valid", "5", "--test", "5"]),
    ("split", ["--valid", "30", "--test", "30"]),
])
def test_make_datasets_cli_equals_jax(tmp_path, monkeypatch, kind, extra):
    src = write_source(tmp_path / "src", toy_triples(300, n_ent=50))
    for who, mod in (("port", make_datasets), ("jax", jax_mk)):
        argv = ["--kind", kind, "--source", str(src), "--folder",
                str(tmp_path / who), "--seed", "0"] + extra
        if mod is make_datasets:
            mod.main(argv)
        else:
            monkeypatch.setattr("sys.argv", ["make_datasets"] + argv)
            mod.main()
    assert tree_text(tmp_path / "port") == tree_text(tmp_path / "jax")
    assert len(tree_text(tmp_path / "port")) == 3


# -- subgraph and dictionaries -------------------------------------------

@pytest.mark.parametrize("seed, target, max_degree", [(0, 60, None),
                                                      (1, 80, 12)])
def test_subgraph_equals_jax(tmp_path, monkeypatch, seed, target,
                             max_degree):
    rng = np.random.default_rng(seed)
    ints = np.stack([rng.integers(0, 50, 300), np.zeros(300, np.int64),
                     rng.integers(0, 50, 300)], axis=1)
    np.testing.assert_array_equal(
        subgraph.shrink_graph(ints, target, np.random.default_rng(seed),
                              max_degree),
        jax_subgraph.shrink_graph(ints, target, np.random.default_rng(seed),
                                  max_degree))
    src = write_source(tmp_path / "src", toy_triples(300, n_ent=50,
                                                     seed=seed))
    cap = [] if max_degree is None else ["--max-degree", str(max_degree)]
    for who, mod in (("port", subgraph), ("jax", jax_subgraph)):
        argv = ["--source", str(src), "--folder", str(tmp_path / who),
                "--edges", str(target), "--valid", "5", "--test", "5",
                "--seed", str(seed)] + cap
        if mod is subgraph:
            mod.main(argv)
        else:
            monkeypatch.setattr("sys.argv", ["subgraph"] + argv)
            mod.main()
    assert tree_text(tmp_path / "port") == tree_text(tmp_path / "jax")
    assert len(tree_text(tmp_path / "port")) == 5


def test_dictionaries_equal_jax(tmp_path, monkeypatch):
    ta, tb = toy_triples(50, n_ent=20, seed=1), toy_triples(50, n_ent=30,
                                                            seed=2)
    a, b = write_source(tmp_path / "a", ta), write_source(tmp_path / "b", tb)
    files = f"{a / 'train.txt'}#{b / 'train.txt'}"
    assert dictionaries.generate_sets(str(a / "train.txt")) == \
        jax_dictionaries.generate_sets(str(a / "train.txt"))
    for who, mod in (("port", dictionaries), ("jax", jax_dictionaries)):
        argv = ["--files", files,
                "--entity_dict", str(tmp_path / who / "entities.dict"),
                "--relation_dict", str(tmp_path / who / "relations.dict")]
        if mod is dictionaries:
            mod.main(argv)
        else:
            monkeypatch.setattr("sys.argv", ["dictionaries"] + argv)
            mod.main()
    assert tree_text(tmp_path / "port") == tree_text(tmp_path / "jax")
    both = np.concatenate([ta, tb])
    names = sorted(set(both[:, 0]) | set(both[:, 2]))
    assert (tmp_path / "port" / "entities.dict").read_text() == "".join(
        f"{i}\t{name}\n" for i, name in enumerate(names))


# -- cluster's loaders and the profiler hook -----------------------------

@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_cluster_loads_a_port_checkpoint(tmp_path, direction):
    gen = torch.Generator().manual_seed(0)
    layers = [{f"C_{d}": torch.randn(7, 3, generator=gen)
               for d in ("forward", "backward")} for _ in range(2)]
    params = {"gcn_layers": layers,
              "relation_embedding": {"W_relation": torch.zeros(7, 4)}}
    checkpoint.save(str(tmp_path / "m"), params=params_to_numpy(params),
                    opt_state={}, step=3, rng_key=np.zeros(2, np.uint32))
    for layer in (0, 1):
        got = cluster.load_coefficients_checkpoint(str(tmp_path / "m"),
                                                   layer, direction)
        np.testing.assert_array_equal(
            got, layers[layer][f"C_{direction}"].numpy())
        np.testing.assert_array_equal(
            got, jax_cluster.load_coefficients_checkpoint(
                str(tmp_path / "m"), layer, direction))
    tsv = tmp_path / "c.tsv"
    tsv.write_text("".join("\t".join(str(x) for x in row) + "\n"
                           for row in layers[0]["C_forward"].tolist()))
    np.testing.assert_array_equal(cluster.load_coefficients_tsv(str(tsv)),
                                  jax_cluster.load_coefficients_tsv(str(tsv)))
    with pytest.raises(FileNotFoundError):
        cluster.load_coefficients_checkpoint(str(tmp_path / "none"))


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    a = torch.randn(64, 64)
    with observability.trace(str(tmp_path / "trace")) as path:
        (a @ a).sum()
    events = json.loads(open(path).read())["traceEvents"]
    assert path.startswith(str(tmp_path / "trace"))
    assert any(e.get("name") == "aten::mm" for e in events)
