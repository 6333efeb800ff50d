#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Drives the port's serving path of ``settings/gcn_block.exp`` at full width
on the seeded ``synth:FB15k-237`` graph (V=14,541, R=237, E=272,115,
d=500, 100 blocks of 5x5) with random weights from a seed. Each phase prints
one JSON line:

  device  the card, its count, and nvidia-smi's name and power limit;
  build   the kernel built from relationprediction_torch/ops/csrc with nvcc
          for sm_90a: build time, registers and spills;
  kernel  block_direction against block_direction_reference in both
          directions on random inputs, within rtol=1e-4, atol=1e-5; the
          time of each (CUDA events) beside the bound computed from shapes;
  serve   init, graph, one encode and Scorer.compute_scores on the first
          2,000 test triples; the kernel's launch count over that run (must
          be 4: 2 layers x 2 directions), MRR and Hits@10, and the codes
          held against the plain path on the CPU.

Then a line listing every ported kernel with its numbers, nvidia-smi's line,
and last ``{"ok": true, "device": {...}}``. Any failure exits non-zero;
without a CUDA card the script exits 2 and prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

from relationprediction_torch import config
from relationprediction_torch.data import synthetic
from relationprediction_torch.device import exact_float32
from relationprediction_torch.evaluation import ranking
from relationprediction_torch.evaluation.scorer import Scorer
from relationprediction_torch.graph import CsrLayout, build_graph_batch
from relationprediction_torch.models import build
from relationprediction_torch.ops import staircase2
from relationprediction_torch.params import map_tree

ROOT = Path(__file__).resolve().parent
SETTINGS = ROOT / "settings" / "gcn_block.exp"
KERNEL_SOURCE = "relationprediction_torch/ops/csrc/block_direction.cu"
REPLACES = "relationprediction_tpu/ops/staircase2.py:460"
SERVE_TRIPLES = 2000
HUB_ROW = 1024  # rows longer than this are timed apart
# NVIDIA H100 SXM data sheet: HBM rate and float32 rate outside the
# tensor cores, at the full 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of one call, from CUDA events around ``iters``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def block_direction_bound(layout, n_vertices, n_rel, n_blocks, dr):
    """Least time of one launch: bytes moved (each input read once, the
    output written once) over the HBM rate, against the f32 operations
    this data needs (z = sum w*x per edge, one block product per
    (target, relation) run) over the f32 rate."""
    e, d = layout.n_edges, n_blocks * dr
    n_bytes = 4 * (2 * n_vertices * d + n_rel * n_blocks * dr * dr
                   + (n_vertices + 1) + 3 * e)
    targets = torch.repeat_interleave(
        torch.arange(n_vertices, device=layout.row_ptr.device),
        layout.row_ptr.diff().long())
    runs = int(1 + ((targets.diff() != 0) | (layout.rel.diff() != 0))
               .sum().item()) if e else 0
    ops = 2 * e * d + 2 * runs * d * dr
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return {"bytes": n_bytes, "ops": ops, "runs": runs,
            "ops_per_edge_products": 2 * e * n_blocks * dr * dr,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def split_rows(layout, limit):
    """Two layouts of the same rows: one keeps only the rows longer than
    ``limit`` edges, the other only the rest (the dropped rows are empty)."""
    lengths = layout.row_ptr.diff()
    long_row = torch.repeat_interleave(lengths > limit, lengths.long())
    parts = []
    for keep_rows, keep_edges in ((lengths > limit, long_row),
                                  (lengths <= limit, ~long_row)):
        row_ptr = torch.zeros_like(layout.row_ptr)
        row_ptr[1:] = torch.cumsum(lengths * keep_rows, 0)
        parts.append(CsrLayout(row_ptr=row_ptr.to(torch.int32),
                               src=layout.src[keep_edges].contiguous(),
                               rel=layout.rel[keep_edges].contiguous(),
                               w=layout.w[keep_edges].contiguous()))
    return parts


def phase_kernel(graph, n_rel, n_blocks, dr, device):
    """block_direction against its plain version, both directions."""
    v = graph.n_vertices
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(v, n_blocks * dr, generator=gen).to(device)
    w = torch.randn(n_rel, n_blocks, dr, dr, generator=gen).to(device)
    rows = []
    for name, layout in (("forward", graph.fwd), ("backward", graph.bwd)):
        got = staircase2.block_direction(x, w, layout, v)
        want = staircase2.block_direction_reference(x, w, layout, v)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            raise AssertionError(f"{name}: kernel output is not finite")
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
        err = (got - want).abs().max().item()
        kernel_ms = cuda_ms(
            lambda: staircase2.block_direction(x, w, layout, v), 50)
        plain_ms = cuda_ms(
            lambda: staircase2.block_direction_reference(
                x, w, layout, v), 3, warmup=1)
        bound = block_direction_bound(layout, v, n_rel, n_blocks, dr)
        # Where the launch's time goes: the same launch over only the rows
        # longer than HUB_ROW edges, and over only the others.
        hubs, rest = split_rows(layout, HUB_ROW)
        hub_ms = cuda_ms(
            lambda: staircase2.block_direction(x, w, hubs, v), 20)
        rest_ms = cuda_ms(
            lambda: staircase2.block_direction(x, w, rest, v), 20)
        row = {"direction": name, "max_abs_err": err,
               "kernel_ms": kernel_ms, "plain_ms": plain_ms,
               f"rows_over_{HUB_ROW}": int(
                   (hubs.row_ptr.diff() > 0).sum().item()),
               "hub_rows_only_ms": hub_ms, "other_rows_only_ms": rest_ms,
               "bound_us": bound["bound_ms"] * 1e3,
               "largest_row": int(layout.row_ptr.diff().max().item()),
               "empty_rows": int((layout.row_ptr.diff() == 0).sum().item()),
               "edges": layout.n_edges, **bound}
        emit("kernel", kernel="block_direction", **row)
        rows.append(row)
    return rows


def phase_serve(ds, device):
    """The serving path at full width, with the kernel's launch count."""
    cfg = config.load(str(SETTINGS)).with_counts(
        ds.n_entities, ds.n_relations, len(ds.train))
    model = build.build_model(cfg, device)
    params = model.init_params(torch.Generator().manual_seed(0))
    t0 = time.perf_counter()
    graph = model.make_graph(ds.train)
    torch.cuda.synchronize()
    graph_s = time.perf_counter() - t0

    view = build.ModelView(model)
    scorer = Scorer(metric=cfg.training.metric)
    for t in (ds.train, ds.valid, ds.test):
        scorer.register_data(t)
    scorer.register_degrees(ds.train)
    scorer.register_model(view, params, graph, n_entities=ds.n_entities)
    scorer.finalize_frequency_computation(ds.all_triples())
    triples = ds.test[:SERVE_TRIPLES]
    n_chunks = 2 * -(-len(triples) // scorer.chunk_size)

    # -- the main path: one encode, then the scoring chunks -------------
    torch.cuda.reset_peak_memory_stats()
    staircase2.block_direction.launches = 0
    t0 = time.perf_counter()
    encoded = view.encoded(params, graph)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    summary = scorer.compute_scores(triples)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = staircase2.block_direction.launches
    peak = torch.cuda.max_memory_allocated()
    if launches != 2 * cfg.encoder.n_layers:
        raise AssertionError(f"block_direction launched {launches} times in "
                             f"one encode, expected "
                             f"{2 * cfg.encoder.n_layers}")

    codes = encoded.entity_codes
    if codes.shape != (ds.n_entities, cfg.encoder.code_dimension) \
            or not torch.isfinite(codes).all():
        raise AssertionError(f"codes {tuple(codes.shape)} not finite or "
                             f"not [V, d]")
    # The same encode through the plain path on the CPU.
    ref_view = build.ModelView(build.build_model(cfg, torch.device("cpu")))
    cpu_params = map_tree(lambda t: t.cpu(), params)
    cpu_graph = graph.to("cpu")
    ref = ref_view.encoded(cpu_params, cpu_graph).entity_codes
    codes_err = (codes.cpu() - ref).abs().max().item()
    torch.testing.assert_close(codes.cpu(), ref, rtol=1e-4, atol=1e-4)
    scorer.register_model(ref_view, cpu_params, cpu_graph,
                          n_entities=ds.n_entities)
    ref_summary = scorer.compute_scores(triples)
    mrr_diff = abs(ref_summary.results["Filtered"]["MRR"]
                   - summary.results["Filtered"]["MRR"])
    if mrr_diff > 1e-3:
        raise AssertionError(f"filtered MRR differs from the CPU plain "
                             f"path by {mrr_diff}")

    # -- warm timings, outside the counted run ---------------------------
    def encode_again():
        view.invalidate()
        view.encoded(params, graph)
    encode_ms_warm = cuda_ms(encode_again, 5, warmup=1)
    scorer.register_model(view, params, graph, n_entities=ds.n_entities)
    t3 = time.perf_counter()
    scorer.compute_scores(triples)
    torch.cuda.synchronize()
    chunk_ms_warm = (time.perf_counter() - t3) * 1e3 / n_chunks

    # One object-side chunk taken apart: the all-entity GEMM, the rank
    # counts on the card, and the known-set padding on the host.
    chunk = triples[:scorer.chunk_size]
    score_ms = cuda_ms(lambda: view.score_all_objects(
        params, graph, chunk, apply_sigmoid=False), 10)
    t4 = time.perf_counter()
    known_idxs, n_known = ranking.pad_known(
        [scorer.known_objects[(int(s), int(r))] for s, r, _ in chunk],
        chunk[:, 2])
    pad_known_ms = (time.perf_counter() - t4) * 1e3
    scores = view.score_all_objects(params, graph, chunk,
                                    apply_sigmoid=False)
    rank_args = (scores, torch.from_numpy(chunk[:, 2]).to(device),
                 torch.from_numpy(known_idxs).to(device),
                 torch.from_numpy(n_known).to(device),
                 torch.arange(scores.shape[1], device=device)
                 < ds.n_entities)
    rank_ms = cuda_ms(lambda: ranking.ranks_from_scores(*rank_args), 10)

    res = summary.results
    row = {"triples": len(triples), "chunks": n_chunks,
           "graph_build_s": graph_s,
           "encode_ms": (t1 - t0) * 1e3, "encode_ms_warm": encode_ms_warm,
           "chunk_ms": (t2 - t1) * 1e3 / n_chunks,
           "chunk_ms_warm": chunk_ms_warm,
           "chunk_score_ms": score_ms, "chunk_rank_ms": rank_ms,
           "chunk_pad_known_host_ms": pad_known_ms,
           "mrr_raw": res["Raw"]["MRR"], "mrr_filtered": res["Filtered"]["MRR"],
           "hits10_raw": res["Raw"]["H@10"],
           "hits10_filtered": res["Filtered"]["H@10"],
           "codes_max_abs_err_vs_cpu_plain": codes_err,
           "mrr_filtered_cpu_plain": ref_summary.results["Filtered"]["MRR"],
           "max_memory_allocated": peak,
           "block_direction_launches": launches}
    emit("serve", **row)
    return row


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    exact_float32()
    device = torch.device("cuda:0")
    smi = nvidia_smi_line()
    emit("device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)

    _, info = staircase2.kernel_library()
    emit("build", source=KERNEL_SOURCE, **info.as_dict())

    ds = synthetic.like("FB15k-237", seed=0)
    graph = build_graph_batch(ds.train, ds.n_entities,
                              ds.n_relations).to(device)
    n_blocks, dr = 100, 5
    rows = phase_kernel(graph, ds.n_relations, n_blocks,
                        dr, device)
    serve = phase_serve(ds, device)

    def mean(key):
        return sum(r[key] for r in rows) / len(rows)

    print(json.dumps({"kernels": [{
        "name": "block_direction", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES,
        "launches": serve["block_direction_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": mean("kernel_ms"), "plain_ms": mean("plain_ms"),
        "bound_ms": mean("bound_ms"),
        "bound_by": rows[0]["bound_by"], "library_ms": None}]}),
        flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
