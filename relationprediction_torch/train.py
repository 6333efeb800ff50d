#!/usr/bin/env python
"""Train a model with the PyTorch port.

    python -m relationprediction_torch.train --settings settings/gcn_block.exp \
        --dataset synth:FB15k-237 [--max-iterations N] [--max-seconds S] \
        [--negative-mode binomial|split|shared] [--resume] [--seed 0] [--cpu]

Counterpart of ``relationprediction_tpu/cli.py:102-215`` on one device:
loads the settings and the dataset (a directory, or ``synth:<profile>``
for a seeded synthetic graph with a real dataset's counts), trains with
device-drawn negatives of ``--negative-mode`` (binomial, the reference's
coin-flip corruption, by default; split or shared with a factorizable
decoder; the MLP decoder takes the tiled binomial loss in every mode, as
in the JAX package), printing the loss on the reference's cadence, scores
the validation split's filtered MRR (its pairwise Accuracy under
``Metric=Accuracy``) every ``CheckEvery`` iterations (printing the test
metrics there too) until the early stopper fires or a cap is reached,
saves a checkpoint under the settings' ``ExperimentName`` at each check
that did not stop, and prints the test metrics of the trained weights.
``--resume`` continues from the newest checkpoint. Runs on the CUDA card
unless ``--cpu`` is given; without a card it fails rather than fall back.
``--mesh``, ``--vertex-sharded`` and the multi-host flags are not ported
yet (ROADMAP.md Queue 1 item 5).
"""
from __future__ import annotations

import argparse
import time


def build_scorer(model, ds, metric: str):
    """The evaluation scorer over the train, valid and test splits, scoring
    through the encode-once view on the whole train graph (none for a
    model without one)."""
    from relationprediction_torch.evaluation.scorer import Scorer
    from relationprediction_torch.models.build import ModelView
    scorer = Scorer(metric=metric)
    for t in (ds.train, ds.valid, ds.test):
        scorer.register_data(t)
    scorer.register_degrees(ds.train)
    scorer.register_model(ModelView(model), None, model.make_graph(ds.train),
                          n_entities=ds.n_entities)
    scorer.finalize_frequency_computation(ds.all_triples())
    return scorer


def validation_scoring(scorer, ds):
    """The early stopper's score (``cli.py:173-186``): the validation
    split's filtered MRR, or its pairwise Accuracy under that metric;
    prints the test metrics at each check (``train.py:110-126`` of the
    reference)."""
    metric_key = "MRR" if scorer.metric == "MRR" else "Accuracy"

    def score_validation_data(params) -> float:
        scorer.set_params(params)
        early_stopping = scorer.compute_scores(
            ds.valid).results["Filtered"][metric_key]
        scorer.compute_scores(ds.test).pretty_print()
        return early_stopping
    return score_validation_data


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="Train a model on a given dataset (PyTorch port).")
    parser.add_argument("--settings", required=True,
                        help="Filepath for settings (.exp) file.")
    parser.add_argument("--dataset", required=True,
                        help="Dataset directory, or synth:<profile> "
                             "(e.g. synth:FB15k-237).")
    parser.add_argument("--max-iterations", type=int, default=None)
    parser.add_argument("--max-seconds", type=float, default=None)
    parser.add_argument("--resume", action="store_true",
                        help="Resume from the experiment checkpoint.")
    parser.add_argument("--sampler", default="neighborhood",
                        choices=["neighborhood", "uniform"],
                        help="Subgraph sampler (uniform = faster host path).")
    parser.add_argument("--negative-mode", default="binomial",
                        choices=["binomial", "split", "shared"],
                        help="binomial = reference coin-flip corruption; "
                             "split = factorized fast path; shared = "
                             "shared-pool GEMM path (bilinear decoders; "
                             "the MLP decoder trains on the tiled binomial "
                             "loss in every mode).")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--cpu", action="store_true",
                        help="Run on the CPU instead of the CUDA card.")
    args = parser.parse_args(argv)

    from relationprediction_torch import config as config_lib
    from relationprediction_torch.data import dataset as dataset_lib
    from relationprediction_torch.data import synthetic
    from relationprediction_torch.device import resolve_device
    from relationprediction_torch.models.build import build_model
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
    scorer = build_scorer(model, ds, cfg.training.metric)
    loop = TrainLoop(model, cfg, ds,
                     scoring_function=validation_scoring(scorer, ds),
                     sampler=args.sampler, seed=args.seed,
                     negative_mode=args.negative_mode)
    checkpoint_path = cfg.training.experiment_name
    t0 = time.time()
    if args.resume:
        result = loop.resume(checkpoint_path,
                             max_iterations=args.max_iterations,
                             max_seconds=args.max_seconds)
    else:
        result = loop.fit(max_iterations=args.max_iterations,
                          max_seconds=args.max_seconds,
                          checkpoint_path=checkpoint_path)
    s = loop.timer.summary()
    print(f"Training done: {result.iterations} iterations in "
          f"{time.time() - t0:.1f}s (early stop: {result.stopped_early}), "
          f"last loss {result.last_loss} ({s['steps_per_sec']} steps/s, "
          f"{s['edges_per_sec']} edges/s)")

    scorer.set_params(result.params)
    print("Final test metrics:")
    scorer.compute_scores(ds.test).pretty_print()


if __name__ == "__main__":
    main()
