#!/usr/bin/env python
"""Train a model with the PyTorch port.

    python -m relationprediction_torch.train --settings settings/gcn_block.exp \
        --dataset synth:FB15k-237 [--max-iterations N] [--max-seconds S] \
        [--negative-mode binomial|split|shared] [--resume] [--seed 0] [--cpu] \
        [--mesh N [--vertex-sharded [--vs-overlap]]] \
        [--coordinator HOST:PORT --num-processes P --process-id p \
         --local-devices L]

Counterpart of ``relationprediction_tpu/cli.py:102-215``:
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

``--mesh N`` trains and evaluates edge-partitioned over N ranks, one
process each (parallel/): on N cards, ``cuda:0`` to ``cuda:N-1``, over
NCCL, or with ``--cpu`` on N CPU ranks over gloo; N above the devices
attached is a parser error. NCCL takes one rank a card (several ranks on
one card run only through ``parallel.distributed.launch`` with gloo and
a device list that repeats the card). The multi-host flags start
``--local-devices`` L ranks in this process, ranks p*L to p*L+L-1 of
P*L, which meet at ``--coordinator`` (the host of process 0, on a free
port). Only rank 0 prints, writes checkpoints and
metric records; a failed rank makes the run exit non-zero.
``--vertex-sharded`` (with ``--mesh``; without it a parser error) shards
the entity table's rows over the ranks instead
(parallel/vertex_sharded.py): training takes the vertex-sharded step,
``--vs-overlap`` its overlapped halo schedule, and evaluation runs through
``VertexShardedModelView`` on the whole train graph's layouts.
Checkpoints hold the padded table gathered from the ranks, the JAX
package's layout.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import time


def build_scorer(model, ds, metric: str, mesh=None,
                 vertex_sharded: bool = False):
    """The evaluation scorer over the train, valid and test splits, scoring
    through the encode-once view on the whole train graph (none for a
    model without one); on ``mesh`` (an ``EdgeMesh``) through the sharded
    view on this rank's shard of it, or with ``vertex_sharded`` through
    ``VertexShardedModelView`` on the whole train graph's layouts
    (``cli.py:141-156``)."""
    from relationprediction_torch.evaluation.scorer import Scorer
    from relationprediction_torch.models.build import ModelView
    scorer = Scorer(metric=metric)
    for t in (ds.train, ds.valid, ds.test):
        scorer.register_data(t)
    scorer.register_degrees(ds.train)
    if vertex_sharded:
        from relationprediction_torch.parallel.vertex_sharded import (
            VertexShardedEncoder, VertexShardedModelView, eval_arrays)
        vse = VertexShardedEncoder(model, mesh)
        view, graph = VertexShardedModelView(
            vse, *eval_arrays(vse, ds.train)), None
    else:
        view = ModelView(model, mesh=mesh)
        graph = model.make_graph(ds.train, shard=(0, 1) if mesh is None
                                 else mesh.shard)
    scorer.register_model(view, None, graph, n_entities=ds.n_entities)
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


def parse_args(argv=None):
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
    parser.add_argument("--mesh", type=int, default=None, metavar="N",
                        help="Edge-partitioned training and evaluation over "
                             "N ranks, one process each: N cards over NCCL, "
                             "or N CPU ranks over gloo with --cpu.")
    parser.add_argument("--vertex-sharded", action="store_true",
                        help="With --mesh: shard the entity table's rows "
                             "over the ranks (targeted halo exchange).")
    parser.add_argument("--vs-overlap", action="store_true",
                        help="With --vertex-sharded: the overlapped halo "
                             "schedule.")
    parser.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                        help="Multi-host: the process group's TCP store "
                             "(process 0's host binds it).")
    parser.add_argument("--num-processes", type=int, default=None)
    parser.add_argument("--process-id", type=int, default=None)
    parser.add_argument("--local-devices", type=int, default=None,
                        help="Ranks this process starts (default: the "
                             "cards attached, or 1 with --cpu).")
    args = parser.parse_args(argv)
    if args.dataset.startswith("synth:"):
        from relationprediction_torch.data import synthetic
        profile = args.dataset.split(":", 1)[1]
        if profile not in synthetic.PROFILES:
            parser.error(f"unknown synthetic profile {profile!r}; choose "
                         f"from {sorted(synthetic.PROFILES)}")
    args.multihost = args.coordinator is not None \
        or args.num_processes is not None
    if args.mesh is not None and args.mesh < 1:
        parser.error("--mesh takes a positive rank count")
    if args.vertex_sharded and args.mesh is None:
        parser.error("--vertex-sharded requires --mesh")
    if args.multihost and (args.coordinator is None
                           or args.num_processes is None
                           or args.process_id is None):
        parser.error("multi-host runs need --coordinator, --num-processes "
                     "and --process-id")
    return parser, args


def main(argv=None) -> None:
    parser, args = parse_args(argv)

    import torch

    from relationprediction_torch.device import resolve_device
    from relationprediction_torch.parallel.distributed import launch

    device = resolve_device(args.cpu)
    if args.mesh is None and not args.multihost:
        run(args, device)
        return
    attached = os.cpu_count() if args.cpu else torch.cuda.device_count()
    if args.multihost:
        local = args.local_devices or (1 if args.cpu else attached)
        processes, process_id = args.num_processes, args.process_id
        total = local * processes
    else:
        local = total = args.mesh
        processes, process_id = 1, 0
    if local > attached:
        parser.error(f"{local} ranks in this process but only {attached} "
                     f"{'CPUs' if args.cpu else 'cards'} are attached")
    if args.mesh is not None and args.mesh > total:
        parser.error(f"--mesh {args.mesh} but only {total} devices over "
                     f"{processes} process(es)")
    launch(_run_rank, local, (args,), cpu=args.cpu, n_devices=args.mesh,
           coordinator=args.coordinator, num_processes=processes,
           process_id=process_id)


def _run_rank(mesh, args) -> None:
    """One rank of a ``--mesh`` or multi-host run (the mesh over every
    process's ranks, held to ``make_global_mesh``'s size rules): ``run``;
    only rank 0 prints."""
    from relationprediction_torch.parallel.distributed import is_coordinator
    with contextlib.ExitStack() as stack:
        if not is_coordinator():
            stack.enter_context(contextlib.redirect_stdout(
                stack.enter_context(open(os.devnull, "w"))))
        run(args, mesh.device, mesh)


def run(args, device, mesh=None) -> None:
    """train.py's run on ``device``, or as one rank of ``mesh``."""
    from relationprediction_torch import config as config_lib
    from relationprediction_torch.data import dataset as dataset_lib
    from relationprediction_torch.data import synthetic
    from relationprediction_torch.models.build import build_model
    from relationprediction_torch.training.engine import TrainLoop

    cfg = config_lib.load(args.settings)
    if args.dataset.startswith("synth:"):
        ds = synthetic.like(args.dataset.split(":", 1)[1], seed=args.seed)
    else:
        ds = dataset_lib.load(args.dataset, metric=cfg.training.metric)
    cfg = cfg.with_counts(ds.n_entities, ds.n_relations, len(ds.train))
    print(f"Dataset {ds.name}: {ds.n_entities} entities, "
          f"{ds.n_relations} relations, {len(ds.train)} train triples "
          f"({device})")
    if mesh is not None:
        layout = "vertex-sharded" if args.vertex_sharded \
            else "edge-partitioned"
        print(f"Mesh: {mesh.world_size} ranks over {mesh.backend}, "
              f"{layout}")

    model = build_model(cfg, device)
    scorer = build_scorer(model, ds, cfg.training.metric, mesh,
                          args.vertex_sharded)
    loop = TrainLoop(model, cfg, ds,
                     scoring_function=validation_scoring(scorer, ds),
                     sampler=args.sampler, seed=args.seed,
                     negative_mode=args.negative_mode, mesh=mesh,
                     vertex_sharded=args.vertex_sharded,
                     vs_overlap=args.vs_overlap)
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
    print(f"Step graphs: {loop.graph_counts}")

    scorer.set_params(result.params)
    print("Final test metrics:")
    scorer.compute_scores(ds.test).pretty_print()


if __name__ == "__main__":
    main()
