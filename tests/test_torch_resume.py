"""Checkpoints between the port and the JAX package, and resume: a port
checkpoint read by the JAX package, a JAX checkpoint resumed by the port,
the port's resume bit for bit on the CPU, and damaged files refused."""
import dataclasses
import json
import os
import pathlib
import struct
import subprocess
import sys
import textwrap
import zlib

import jax
import numpy as np
import pytest
import torch

from relationprediction_tpu import config as jax_config
from relationprediction_tpu.data import synthetic as jax_synthetic
from relationprediction_tpu.evaluation import Scorer as JaxScorer
from relationprediction_tpu.models.build import JittedModelView
from relationprediction_tpu.models.build import build_model as jax_build
from relationprediction_tpu.training import checkpoint as jax_ckpt
from relationprediction_tpu.training.engine import TrainLoop as JaxTrainLoop
from relationprediction_tpu.training.engine import (
    _Prefetcher as JaxPrefetcher)
from relationprediction_torch import config as torch_config
from relationprediction_torch.models.build import build_model
from relationprediction_torch.params import params_to_numpy, tree_leaves
from relationprediction_torch.train import build_scorer
from relationprediction_torch.training import checkpoint as torch_ckpt
from relationprediction_torch.training.engine import TrainLoop

from test_torch_train_step import case

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def with_optimizer(cfg, **kw):
    return dataclasses.replace(cfg, optimizer=dataclasses.replace(
        cfg.optimizer, **kw))


def quiet(line):
    pass


def test_port_checkpoint_is_read_by_the_jax_package(tmp_path):
    """gcn_block (d=20) trained 4 steps on data/Toy with saves every 2:
    the JAX package's restore reads the newest file without importing
    torch, its params are the port's bit for bit, and the JAX scorer's
    filtered MRR on them is the port's within 1e-6."""
    ds, (jcfg, jmodel, _), (tcfg, model) = case("toy")
    tcfg = with_optimizer(tcfg, early_stopping_check_every=2)
    loop = TrainLoop(model, tcfg, ds, seed=0, log=quiet)
    result = loop.fit(max_iterations=4, checkpoint_path=str(tmp_path / "m"))
    script = textwrap.dedent(f"""
        import json, sys
        from relationprediction_tpu.training import checkpoint
        state = checkpoint.restore_latest({str(tmp_path / 'm')!r})
        print(json.dumps({{"step": state["step"],
                          "keys": sorted(state),
                          "torch": "torch" in sys.modules}}))
    """)
    proc = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == {
        "step": 4, "torch": False,
        "keys": ["extra", "host_rng_state", "opt_state", "params",
                 "rng_key", "schema_version", "step"]}
    state = jax_ckpt.restore_latest(str(tmp_path / "m"))
    want = params_to_numpy(result.params)
    assert jax.tree_util.tree_structure(state["params"]) == \
        jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(state["params"]),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, b)
    assert int(state["opt_state"]["count"]) == 4

    jscorer = JaxScorer()
    for t in (ds.train, ds.valid, ds.test):
        jscorer.register_data(t)
    jscorer.register_degrees(ds.train)
    jscorer.register_model(
        JittedModelView(jmodel), state["params"],
        jmodel.make_graph(ds.train, pad_to=-(-len(ds.train) // 128) * 128),
        n_entities=ds.n_entities)
    jscorer.finalize_frequency_computation(ds.all_triples())
    scorer = build_scorer(model, ds, "MRR")
    scorer.set_params(result.params)
    got = scorer.compute_scores(ds.test).results["Filtered"]["MRR"]
    want = jscorer.compute_scores(ds.test).results["Filtered"]["MRR"]
    assert abs(got - want) <= 1e-6


def minibatch_configs():
    """distmult.exp at d=20 with BatchSize=700 of the synthetic graph's
    1,500 triples (random minibatches from the host stream), saving every
    2 steps."""
    ds = jax_synthetic.generate(300, 11, 1500, 50, 50, seed=0)
    path = str(ROOT / "settings" / "distmult.exp")
    cfgs = [dataclasses.replace(
        cfg, encoder=dataclasses.replace(cfg.encoder, code_dimension=20),
        decoder=dataclasses.replace(cfg.decoder, code_dimension=20),
        optimizer=dataclasses.replace(cfg.optimizer, batch_size=700,
                                      early_stopping_check_every=2),
    ).with_counts(ds.n_entities, ds.n_relations, len(ds.train))
        for cfg in (jax_config.load(path), torch_config.load(path))]
    return ds, cfgs


def test_port_resumes_a_jax_checkpoint(tmp_path):
    """The JAX package trains 4 steps with 2 prefetch threads and saves;
    the port restores its Adam state bit for bit, its next host batches
    are those JAX's own resume would consume, and it trains on."""
    ds, (jcfg, tcfg) = minibatch_configs()
    path = str(tmp_path / "m")
    JaxTrainLoop(jax_build(jcfg), jcfg, ds, seed=3, log=quiet,
                 prefetch_threads=2).fit(max_iterations=4,
                                         checkpoint_path=path)
    state = jax_ckpt.restore_latest(path)
    assert state["step"] == 4

    loop = TrainLoop(build_model(tcfg, CPU), tcfg, ds, seed=3, log=quiet)
    params, opt_state, step = loop.restore(path)
    assert step == 4
    adam = state["opt_state"][1]
    assert int(opt_state["count"]) == int(adam.count) == 4
    for key in ("mu", "nu"):
        for got, want in zip(tree_leaves(opt_state[key]),
                             jax.tree_util.tree_leaves(getattr(adam, key))):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for got, want in zip(tree_leaves(params),
                         jax.tree_util.tree_leaves(state["params"])):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    # JAX's own resume (engine.py:801-811): each pipeline at its
    # consumption point, the round robin at the saved index.
    jloop = JaxTrainLoop(jax_build(jcfg), jcfg, ds, seed=3, log=quiet,
                         prefetch_threads=2)
    jpipes = [jloop.pipeline] + jloop._extra_pipelines
    for p, st in zip(jpipes, state["extra"]["pipeline_states"]):
        p.set_state(st)
    jpf = JaxPrefetcher(jpipes, start_offset=state["extra"]["rr"])
    source = loop._source()
    try:
        for _ in range(4):
            np.testing.assert_array_equal(source.next()[0].triples.numpy(),
                                          jpf.next().triples)
    finally:
        jpf.close()
        source.close()

    loop = TrainLoop(build_model(tcfg, CPU), tcfg, ds, seed=3, log=quiet)
    result = loop.resume(path, max_iterations=6)
    assert result.iterations == 6 and len(result.steps) == 2
    assert np.isfinite(result.last_loss)
    assert torch_ckpt.restore_latest(path)["step"] == 6


def test_resume_is_bit_exact_on_cpu(tmp_path):
    """gcn_block (d=20) on the synthetic graph, 600-edge batches, 2
    prefetch threads, saves every 10 steps: 20 steps straight against 10
    steps and a resume to 20 in a new loop, at PyTorch's default settings
    (no deterministic algorithms). Steps 11-20 consume the same batches
    and give the same losses, and the params end equal bit for bit."""
    ds, _, (tcfg, model) = case("synthetic", 600)
    tcfg = with_optimizer(tcfg, early_stopping_check_every=10)

    def recording_loop():
        loop = TrainLoop(model, tcfg, ds, seed=1, log=quiet)
        seen, step = [], loop.train_step

        def train_step(params, opt_state, batch):
            seen.append((batch.triples.numpy().copy(), batch.edge_ids))
            return step(params, opt_state, batch)
        loop.train_step = train_step
        return loop, seen

    loop, straight = recording_loop()
    params, opt_state = loop.init_state(0)
    whole = loop.fit(params, opt_state, max_iterations=20,
                     checkpoint_path=str(tmp_path / "a"))
    loop, _ = recording_loop()
    params, opt_state = loop.init_state(0)
    loop.fit(params, opt_state, max_iterations=10,
             checkpoint_path=str(tmp_path / "b"))
    loop, resumed = recording_loop()
    tail = loop.resume(str(tmp_path / "b"), max_iterations=20)
    assert not torch.are_deterministic_algorithms_enabled()
    assert tail.iterations == 20 and len(resumed) == 10
    for (t, e), (t2, e2) in zip(straight[10:], resumed):
        np.testing.assert_array_equal(t, t2)
        np.testing.assert_array_equal(e, e2)
    assert [s["loss"] for s in whole.steps[10:]] == \
        [s["loss"] for s in tail.steps]
    for a, b in zip(tree_leaves(whole.params), tree_leaves(tail.params)):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(whole.opt_state),
                    tree_leaves(tail.opt_state)):
        assert torch.equal(a, b)


def test_damaged_checkpoints_are_refused(tmp_path):
    path = torch_ckpt.save(str(tmp_path / "m"), params={"w": np.ones(3)},
                           opt_state={}, step=1,
                           rng_key=np.zeros(2, np.uint32))
    blob = open(path, "rb").read()
    assert torch_ckpt.restore(path)["params"]["w"].tolist() == [1, 1, 1]
    header, payload = blob[:16], blob[16:]

    def write(data):
        with open(path, "wb") as f:
            f.write(data)

    write(header + payload[:-1] + bytes([payload[-1] ^ 1]))
    with pytest.raises(ValueError, match="checksum"):
        torch_ckpt.restore(path)
    write(header + payload[:len(payload) // 2])
    with pytest.raises(ValueError, match="checksum"):
        torch_ckpt.restore(path)
    write(b"RPTPUCK1" + struct.pack("<II", 2, zlib.crc32(payload))
          + payload)
    with pytest.raises(ValueError, match="version 2"):
        torch_ckpt.restore(path)
    write(b"NOTACKPT" + blob[8:])
    with pytest.raises(ValueError, match="bad magic"):
        torch_ckpt.restore(path)
    with pytest.raises(TypeError, match="numpy arrays and builtins"):
        torch_ckpt.save(str(tmp_path / "t"), params={"w": torch.ones(3)},
                        opt_state={}, step=1, rng_key=np.zeros(2))
    assert not os.path.exists(str(tmp_path / "t.latest"))
