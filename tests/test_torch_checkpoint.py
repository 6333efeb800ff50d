"""The port reads the JAX package's checkpoints without importing JAX, and its
evaluation CLI prints the JAX scorer's metrics for them."""
import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np

from relationprediction_tpu import config as jax_config
from relationprediction_tpu.data import dataset as jax_dataset
from relationprediction_tpu.evaluation import Scorer as JaxScorer
from relationprediction_tpu.models.build import JittedModelView
from relationprediction_tpu.models.build import build_model as jax_build
from relationprediction_tpu.training import checkpoint as jax_ckpt
from relationprediction_tpu.training.optimizers import build_optimizer
from relationprediction_torch import evaluate as torch_evaluate
from relationprediction_torch.training import checkpoint as torch_ckpt

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
TOY = os.path.join(ROOT, "data", "Toy")


def small_exp(tmp_path):
    """gcn_block.exp at d=20, B=4, saving under tmp_path."""
    src = open(os.path.join(ROOT, "settings", "gcn_block.exp")).read()
    src = src.replace("CodeDimension=500", "CodeDimension=20")
    src = src.replace("InternalEncoderDimension=500",
                      "InternalEncoderDimension=20")
    src = src.replace("NumberOfBasisFunctions=100",
                      "NumberOfBasisFunctions=4")
    src = src.replace("ExperimentName=models/BlockGCN",
                      f"ExperimentName={tmp_path / 'm'}")
    path = tmp_path / "small.exp"
    path.write_text(src)
    return str(path)


def write_checkpoint(tmp_path):
    ds = jax_dataset.load(TOY)
    cfg = jax_config.load(small_exp(tmp_path)).with_counts(
        ds.n_entities, ds.n_relations, len(ds.train))
    assert (cfg.encoder.gcn_variant, cfg.encoder.n_bases) == ("block", 4)
    model = jax_build(cfg)
    params = model.init_params(jax.random.PRNGKey(0))
    opt_state = build_optimizer(cfg.optimizer).init(params)  # clip + Adam
    jax_ckpt.save(str(tmp_path / "m"), params=params, opt_state=opt_state,
                  step=7, rng_key=jax.random.PRNGKey(1))
    return ds, cfg, model, params


def test_restore_latest_reads_params_without_jax(tmp_path):
    _, _, _, params = write_checkpoint(tmp_path)
    out = tmp_path / "params.npz"
    script = textwrap.dedent(f"""
        import json, sys
        import numpy as np
        from relationprediction_torch.training import checkpoint
        state = checkpoint.restore_latest({str(tmp_path / 'm')!r})
        p = state["params"]
        flat = {{"input_W": p["input_transform"]["W"],
                 "rel": p["relation_embedding"]["W_relation"]}}
        for i, layer in enumerate(p["gcn_layers"]):
            for k, v in layer.items():
                flat[f"{{i}}_{{k}}"] = v
        np.savez({str(out)!r}, **flat)
        print(json.dumps({{"step": state["step"],
                          "opt_state": type(state["opt_state"]).__name__,
                          "jax": "jax" in sys.modules,
                          "optax": "optax" in sys.modules}}))
    """)
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report == {"step": 7, "opt_state": "tuple", "jax": False,
                      "optax": False}
    got = np.load(out)
    np.testing.assert_array_equal(got["input_W"],
                                  np.asarray(params["input_transform"]["W"]))
    np.testing.assert_array_equal(
        got["rel"], np.asarray(params["relation_embedding"]["W_relation"]))
    for i, layer in enumerate(params["gcn_layers"]):
        for k, v in layer.items():
            np.testing.assert_array_equal(got[f"{i}_{k}"], np.asarray(v))


def test_optax_state_becomes_placeholders(tmp_path):
    write_checkpoint(tmp_path)
    state = torch_ckpt.restore_latest(str(tmp_path / "m"))
    leaves = [x for x in state["opt_state"]
              if isinstance(x, torch_ckpt.Placeholder)]
    assert {type(x)._qualname.rsplit(".", 1)[1] for x in leaves} >= {
        "ScaleByAdamState"}
    assert torch_ckpt.restore_latest(str(tmp_path / "absent")) is None


def test_evaluate_cli_prints_jax_metrics(tmp_path, capsys):
    ds, cfg, model, params = write_checkpoint(tmp_path)
    scorer = JaxScorer(metric=cfg.training.metric)
    for t in (ds.train, ds.valid, ds.test):
        scorer.register_data(t)
    scorer.register_degrees(ds.train)
    graph = model.make_graph(ds.train, pad_to=-(-len(ds.train) // 128) * 128)
    scorer.register_model(JittedModelView(model), params, graph,
                          n_entities=ds.n_entities)
    scorer.finalize_frequency_computation(ds.all_triples())
    want = scorer.compute_scores(ds.test).pretty_print()
    capsys.readouterr()

    torch_evaluate.main(["--settings", small_exp(tmp_path), "--dataset", TOY,
                         "--split", "test", "--cpu"])
    printed = capsys.readouterr().out
    assert "(step 7)" in printed
    assert printed.rstrip().endswith(want)
