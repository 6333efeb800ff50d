#!/usr/bin/env python
"""Train a model with the PyTorch port.

    python -m relationprediction_torch.train --settings settings/gcn_block.exp \
        --dataset synth:FB15k-237 --max-iterations 100 [--seed 0] [--cpu]

Counterpart of ``relationprediction_tpu/cli.py``: loads the settings and the
dataset (a directory, or ``synth:<profile>`` for a seeded synthetic graph
with a real dataset's counts), trains with device-drawn binomial negatives
for ``--max-iterations`` steps, printing the loss on the reference's
cadence, and prints the test metrics of the trained weights. Runs on the
CUDA card unless ``--cpu`` is given; without a card it fails rather than
fall back. Validation with early stopping, checkpoints (``--resume``),
``--mesh``, ``--vertex-sharded`` and negative modes other than binomial are
not ported yet (ROADMAP.md Queue 1 items 3, 5 and 9).
"""
from __future__ import annotations

import argparse
import time


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="Train a model on a given dataset (PyTorch port).")
    parser.add_argument("--settings", required=True,
                        help="Filepath for settings (.exp) file.")
    parser.add_argument("--dataset", required=True,
                        help="Dataset directory, or synth:<profile> "
                             "(e.g. synth:FB15k-237).")
    parser.add_argument("--max-iterations", type=int, default=None)
    parser.add_argument("--sampler", default="neighborhood",
                        choices=["neighborhood", "uniform"],
                        help="Subgraph sampler (uniform = faster host path).")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--cpu", action="store_true",
                        help="Run on the CPU instead of the CUDA card.")
    args = parser.parse_args(argv)

    from relationprediction_torch import config as config_lib
    from relationprediction_torch.data import dataset as dataset_lib
    from relationprediction_torch.data import synthetic
    from relationprediction_torch.device import resolve_device
    from relationprediction_torch.evaluation.scorer import Scorer
    from relationprediction_torch.models.build import ModelView, build_model
    from relationprediction_torch.training.engine import TrainLoop

    device = resolve_device(args.cpu)
    cfg = config_lib.load(args.settings)
    if args.dataset.startswith("synth:"):
        profile = args.dataset.split(":", 1)[1]
        if profile not in synthetic.PROFILES:
            parser.error(f"unknown synthetic profile {profile!r}; choose "
                         f"from {sorted(synthetic.PROFILES)}")
        ds = synthetic.like(profile, seed=args.seed)
    else:
        ds = dataset_lib.load(args.dataset, metric=cfg.training.metric)
    cfg = cfg.with_counts(ds.n_entities, ds.n_relations, len(ds.train))
    print(f"Dataset {ds.name}: {ds.n_entities} entities, "
          f"{ds.n_relations} relations, {len(ds.train)} train triples "
          f"({device})")

    model = build_model(cfg, device)
    loop = TrainLoop(model, cfg, ds, sampler=args.sampler, seed=args.seed)
    t0 = time.time()
    result = loop.fit(max_iterations=args.max_iterations)
    s = loop.timer.summary()
    print(f"Training done: {result.iterations} iterations in "
          f"{time.time() - t0:.1f}s, last loss {result.last_loss} "
          f"({s['steps_per_sec']} steps/s, {s['edges_per_sec']} edges/s)")

    scorer = Scorer(metric=cfg.training.metric)
    for t in (ds.train, ds.valid, ds.test):
        scorer.register_data(t)
    scorer.register_degrees(ds.train)
    scorer.register_model(ModelView(model), result.params,
                          model.make_graph(ds.train),
                          n_entities=ds.n_entities)
    scorer.finalize_frequency_computation(ds.all_triples())
    print("Final test metrics:")
    scorer.compute_scores(ds.test).pretty_print()


if __name__ == "__main__":
    main()
