"""The port's TrainLoop against the JAX package's on scripted validation
scores: the same early stop, best score, log lines, checkpoint steps and
metric records; and MetricLogger against the JAX package's."""
import dataclasses
import json
import os
import pathlib
import re

import numpy as np
import pytest
import torch

from relationprediction_tpu import config as jax_config
from relationprediction_tpu.data import dataset as jax_dataset
from relationprediction_tpu.models.build import build_model as jax_build
from relationprediction_tpu.observability import (
    MetricLogger as JaxMetricLogger)
from relationprediction_tpu.training.engine import TrainLoop as JaxTrainLoop
from relationprediction_torch import config as torch_config
from relationprediction_torch.models.build import build_model
from relationprediction_torch.observability import MetricLogger
from relationprediction_torch.training.engine import TrainLoop

ROOT = pathlib.Path(__file__).resolve().parents[1]
SETTINGS = str(ROOT / "settings" / "distmult.exp")

# (scores at each check, optimizer settings, max_iterations, the stop):
# a dip ignored in the burn-in, then a tie that stops; a rise until the
# cap; the same dip and tie with a save cadence of its own.
SCRIPTS = {
    "burn_in_then_stop": ([0.1, 0.2, 0.15, 0.3, 0.3, 0.5], {}, None,
                          (10, True, 0.3)),
    "rise_to_cap": ([0.1, 0.2, 0.3, 0.4, 0.5], {}, 9, (9, False, 0.4)),
    "save_every_3": ([0.1, 0.2, 0.15, 0.3, 0.3, 0.5],
                     {"save_every_n": 3}, None, (10, True, 0.3)),
}


def configs(ds, **optimizer):
    optimizer = dict(early_stopping_check_every=2, early_stopping_burnin=6,
                     report_train_loss_every=3, **optimizer)
    return [dataclasses.replace(
        cfg, encoder=dataclasses.replace(cfg.encoder, code_dimension=20),
        decoder=dataclasses.replace(cfg.decoder, code_dimension=20),
        optimizer=dataclasses.replace(cfg.optimizer, **optimizer),
    ).with_counts(ds.n_entities, ds.n_relations, len(ds.train))
        for cfg in (jax_config.load(SETTINGS), torch_config.load(SETTINGS))]


def masked(lines):
    """Log lines with the loss values (which differ: the two packages'
    device draws differ) replaced."""
    return [re.sub(r"(loss(?: for iteration \S+)?: )\S+", r"\1#", line)
            for line in lines]


def records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_stopper_and_saver_match_jax(tmp_path, script):
    scores, optimizer, max_iterations, stop = SCRIPTS[script]
    ds = jax_dataset.load(str(ROOT / "data" / "Toy"))
    jcfg, tcfg = configs(ds, **optimizer)
    runs = {}
    for side, loop_cls, model in (
            ("jax", JaxTrainLoop, jax_build(jcfg)),
            ("torch", TrainLoop, build_model(tcfg, torch.device("cpu")))):
        it = iter(scores)
        lines = []
        kwargs = {"steps_per_dispatch": 1} if side == "jax" else {}
        loop = loop_cls(model, jcfg if side == "jax" else tcfg, ds,
                        scoring_function=lambda params: next(it),
                        prefetch=False, log=lines.append,
                        metrics_path=str(tmp_path / f"{side}.jsonl"),
                        **kwargs)
        result = loop.fit(max_iterations=max_iterations,
                          checkpoint_path=str(tmp_path / side / "m"))
        loop.metrics.close()
        steps = sorted(int(re.match(r"m-(\d+)\.ckpt$", f).group(1))
                       for f in os.listdir(tmp_path / side)
                       if f.endswith(".ckpt"))
        runs[side] = ((result.iterations, result.stopped_early,
                       result.best_score), masked(lines), steps,
                      [(r["kind"], sorted(r)) for r in
                       records(tmp_path / f"{side}.jsonl")])
    assert runs["torch"][0] == runs["jax"][0] == stop
    assert runs["torch"][1] == runs["jax"][1]
    assert runs["torch"][2] == runs["jax"][2]
    every = optimizer.get("save_every_n", 2)
    assert runs["torch"][2] == [s for s in range(every, stop[0] + 1, every)
                                if not (stop[1] and s == stop[0])]
    assert runs["torch"][3] == runs["jax"][3]
    kinds = [kind for kind, _ in runs["torch"][3]]
    assert "validation" in kinds and "train_loss" in kinds
    lines = runs["torch"][1]
    assert ("Ignoring criterion while in burn-in phase." in lines) \
        == (script != "rise_to_cap")
    assert lines.count("saving...") == len(runs["torch"][2])


def test_metric_logger_matches_jax(tmp_path, capsys):
    got, want = MetricLogger(str(tmp_path / "t" / "m.jsonl")), \
        JaxMetricLogger(str(tmp_path / "j" / "m.jsonl"))
    for logger in (got, want):
        logger.log("validation", iteration=10, score=0.25)
        logger.log("train_loss", iteration=9, loss=np.float32(0.5).item(),
                   steps=9, edges_per_sec=1.5)
        logger.close()
    echoed = capsys.readouterr().out.splitlines()
    assert echoed[:2] == echoed[2:] == [
        "[validation] iteration=10 score=0.25",
        "[train_loss] iteration=9 loss=0.5 steps=9 edges_per_sec=1.5"]
    t, j = records(tmp_path / "t" / "m.jsonl"), \
        records(tmp_path / "j" / "m.jsonl")
    assert [{k: v for k, v in r.items() if k != "ts"} for r in t] == \
        [{k: v for k, v in r.items() if k != "ts"} for r in j]
    assert all(isinstance(r["ts"], float) for r in t)
    MetricLogger(None).log("quiet", x=1)  # no file: echo only
