#!/usr/bin/env python
"""Evaluate a trained checkpoint on any split, with the PyTorch port.

    python -m relationprediction_torch.evaluate \
        --settings settings/gcn_block.exp --dataset data/Toy --split test

Reads the newest checkpoint written by training (the settings'
ExperimentName prefix; ``--checkpoint`` overrides) and prints the same
metrics table as ``relationprediction_tpu/evaluate.py``, and writes its
files: ``--dump-scores DIR`` the all-entity score dumps
``DIR/subjects.<split>`` and ``DIR/objects.<split>`` (the ensemble tool's
``--p1`` / ``--p2``), ``--dump-degrees PREFIX`` ``PREFIX_in.tsv`` /
``_out.tsv`` and ``--dump-frequencies PREFIX`` ``PREFIX_vertex.tsv`` /
``_relation.tsv``, from filtered ranks or, with ``--raw``, raw ones. Runs
on the CUDA card unless ``--cpu`` is given; without a card it fails rather
than fall back. ``--dataset synth:FB15k-237`` evaluates on the seeded
synthetic graph.
"""
from __future__ import annotations

import argparse
import os


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="Evaluate a trained checkpoint (PyTorch port).")
    parser.add_argument("--settings", required=True)
    parser.add_argument("--dataset", required=True)
    parser.add_argument("--checkpoint", default=None,
                        help="Checkpoint path prefix (default: the "
                             "settings' ExperimentName, as written by "
                             "training).")
    parser.add_argument("--split", default="test",
                        choices=["train", "valid", "test"])
    parser.add_argument("--limit", type=int, default=None,
                        help="Evaluate only the first N triples.")
    parser.add_argument("--dump-scores", default=None, metavar="DIR",
                        help="Write <DIR>/subjects.<split> and "
                             "<DIR>/objects.<split> full-entity score "
                             "dumps (tools/ensemble.py --p1/--p2 take "
                             "DIR).")
    parser.add_argument("--dump-degrees", default=None, metavar="PREFIX",
                        help="Write <PREFIX>_in.tsv / _out.tsv per-degree "
                             "MRR TSVs.")
    parser.add_argument("--dump-frequencies", default=None, metavar="PREFIX",
                        help="Write <PREFIX>_vertex.tsv / _relation.tsv "
                             "per-frequency MRR TSVs.")
    parser.add_argument("--raw", action="store_true",
                        help="Dump breakdowns from raw (unfiltered) ranks.")
    parser.add_argument("--cpu", action="store_true",
                        help="Run on the CPU instead of the CUDA card.")
    args = parser.parse_args(argv)

    from relationprediction_torch import config as config_lib
    from relationprediction_torch.data import dataset as dataset_lib
    from relationprediction_torch.data import synthetic
    from relationprediction_torch.device import resolve_device
    from relationprediction_torch.evaluation.scorer import Scorer
    from relationprediction_torch.models.build import ModelView, build_model
    from relationprediction_torch.params import params_from_jax
    from relationprediction_torch.training import checkpoint as ckpt_lib
    from relationprediction_torch.training.engine import restore_model_state

    device = resolve_device(args.cpu)
    cfg = config_lib.load(args.settings)
    if args.dataset.startswith("synth:"):
        ds = synthetic.like(args.dataset.split(":", 1)[1])
    else:
        ds = dataset_lib.load(args.dataset, metric=cfg.training.metric)
    cfg = cfg.with_counts(ds.n_entities, ds.n_relations, len(ds.train))
    model = build_model(cfg, device)

    ckpt_path = args.checkpoint or cfg.training.experiment_name
    state = ckpt_lib.restore_latest(ckpt_path)
    if state is None:
        raise SystemExit(f"no checkpoint found at {ckpt_path!r} "
                         f"(train first, or pass --checkpoint)")
    params = params_from_jax(state["params"], device)
    restore_model_state(model, state.get("extra") or {})
    print(f"checkpoint: {ckpt_path} (step {state['step']})")

    scorer = Scorer(metric=cfg.training.metric)
    for t in (ds.train, ds.valid, ds.test):
        scorer.register_data(t)
    scorer.register_degrees(ds.train)
    scorer.register_model(ModelView(model), params,
                          model.make_graph(ds.train),
                          n_entities=ds.n_entities)
    scorer.finalize_frequency_computation(ds.all_triples())

    triples = {"train": ds.train, "valid": ds.valid,
               "test": ds.test}[args.split]
    if args.limit:
        triples = triples[:args.limit]
    print(f"evaluating {len(triples)} {args.split} triples "
          f"on {ds.name} ({device})")
    summary = scorer.compute_scores(triples)
    summary.pretty_print()

    kind = "Raw" if args.raw else "Filtered"
    for prefix in (args.dump_degrees, args.dump_frequencies):
        if prefix and os.path.dirname(prefix):
            os.makedirs(os.path.dirname(prefix), exist_ok=True)
    if args.dump_degrees:
        fi = f"{args.dump_degrees}_in.tsv"
        fo = f"{args.dump_degrees}_out.tsv"
        summary.dump_degrees(fi, fo, filter=kind)
        print(f"wrote {fi} {fo}")
    if args.dump_frequencies:
        vf = f"{args.dump_frequencies}_vertex.tsv"
        rf = f"{args.dump_frequencies}_relation.tsv"
        summary.dump_frequencies(vf, rf, filter=kind)
        print(f"wrote {vf} {rf}")
    if args.dump_scores:
        os.makedirs(args.dump_scores, exist_ok=True)
        sf = os.path.join(args.dump_scores, f"subjects.{args.split}")
        of = os.path.join(args.dump_scores, f"objects.{args.split}")
        scorer.dump_all_scores(triples, sf, of)
        print(f"wrote {sf} {of}")


if __name__ == "__main__":
    main()
