#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Drives the port's serving and training paths of ``settings/gcn_block.exp``
(d=500, 100 blocks of 5x5), ``settings/gcn_basis.exp`` (d=500, 5 bases)
with and without its input transform, and gcn_diag (d=500) at full width on the seeded ``synth:FB15k-237`` graph (V=14,541, R=237,
E=272,115) with random weights from a seed. Each phase prints JSON lines,
each with the seconds the phase has taken so far (``phase_s``):

  device  the card, its count, and nvidia-smi's name and power limit;
  build   the kernels built from relationprediction_torch/ops/csrc with nvcc
          for sm_90a, one nvcc per source, all started together: build
          time, registers and spills;
  kernel  block_direction (a merge-path kernel and its carry fix-up) in
          both directions of the full train graph and of the first training
          batch's graph against a float64 sum within the rounding its terms
          allow, the opposite direction's CSR outside it; its carry rows
          against merge_path_carry_rows and two launches bit for bit; the
          time of each (CUDA events) beside the bound computed from shapes,
          the plain version, the hub rows and the others apart, the same
          CSR with every relation 0 (W[0] stays in L1: only the x gathers
          and the partition remain) and every item count of SWEEP_ITEMS;
          then the stress layouts of block_layouts, forward and twin;
  serve   init, graph, one encode and Scorer.compute_scores on the first
          2,000 test triples; the kernel's launch count over that run (must
          be 4: 2 layers x 2 directions), MRR and Hits@10, and the codes
          held against the plain path on the CPU;
  grad    block_direction's output and gradient (kernel forward, twin
          kernel, d blocks summed by relation on kernel 3) against
          autograd through
          block_direction_reference in float64 on the card, both
          directions, on the full train graph and on the first training
          batch's graph; d features and the twin pass within the rounding
          an f32 sum of their terms may have, and the twin pass on the
          wrong twin outside it; the twin pass's carry rows and two
          launches bit for bit; times of both kernels (the twin pass also
          on the hub rows and the others apart, and at every item count),
          the d blocks contraction (two calls bit for bit; beside it the
          same sums by index_add_, the form before the sums by relation),
          kernel 3 as sum_by_csr runs it on one chunk of d blocks'
          products (against a float64 sum, index_add_ beside it) and the
          plain backward, and the bounds;
  train   one train step on the card against the same step (params, batch,
          draws, masks) on the CPU plain path, then 20 steps of
          TrainLoop.fit: host batch and device step times, the loss at
          steps 1, 10 and 20 (finite and falling), exactly 4 forward and 4
          twin launches in every step, peak device memory; then the hand
          kernels of 3 replayed steps of the step's CUDA graph, counted by
          name in torch.profiler, against 3 steps op by op
          (replayed_launches; every train phase whose loop takes a graph).

Then the same for gcn_basis (TPU kernel 2 as basis_project + basis_combine):

  kernel_basis  basis_project (a split pass, then 3xTF32 on the tensor
          cores) against a float64 product within sqrt(K) * 2^-24 *
          sum |x||w| per element, at the forward and twin shapes and two odd
          shapes: the split equal to tf32_split_reference bit for bit, two
          launches equal bit for bit, and TF32 torch.matmul as the control
          that must fail the allowance at the forward and twin shapes;
          times of the whole, the split and the product beside
          torch.matmul (TF32 off, and on) and the 3xTF32 and f32 bounds;
          basis_combine (a merge-path kernel and its carry fix-up)
          in both directions on the full train graph and on the first
          training batch's graph against a float64 sum within the rounding
          its terms allow, hub rows and the others timed apart, every item
          count of SWEEP_ITEMS, torch.sparse.mm on the same [V, V*B] CSR
          matrix beside it; the twin pass (project g by w_t, combine on the
          twin CSR) likewise, and on the wrong twin outside that allowance;
          carry rows against merge_path_carry_rows and two launches bit for
          bit; then the stress layouts (B = 5, d = 500; and B = 1, 8 at
          d_out = 37, the scalar path);
  serve_basis, grad_basis, train_basis  as serve, grad and train, through
          staircase2.basis_direction (4 combine launches an encode; 4
          forward and 4 twin combine launches a step, each after a project
          launch and its split pass); grad_basis also times d C (two calls
          bit for bit) beside the same sums by index_add_.

Every aggregation launch of the main paths (block_direction and its twin,
basis_combine forward and twin, staircase_aggregate) is followed by one
launch of its carry fix-up, counted apart and checked on every path; so is
every kernel 3 launch of ops/gather.sum_by_csr (d blocks and d C summed by
relation, once a direction and layer a step; the fused energies' per-id
scalars; the float32 gather-dot route's d codes and per-id scalars, with
its two kernels counted on the energies ops), whose count each train phase
checks. Every bf16 block_direction
and basis_combine launch of a main path is counted by its route too, and
must be the slice route and the chunk route (check_routes). No wrapper
runs in a replay of the step's CUDA graph: a replayed step adds the counts
its capture recorded, and each train phase measures its hand kernels by
name (replayed_launches; the kernels line's replayed_step_launches).

Then the one-hot-input R-GCN (gcn_basis.exp with UseInputTransform=No) and
gcn_diag (gcn_basis.exp with Name=gcn_diag), whose layers sum per-edge
messages with TPU kernel 3 (staircase_aggregate; TPU kernel 4, scatter2,
runs on the same kernel):

  kernel_staircase  staircase_aggregate_f32 in both directions on the full
          train graph and on the first training batch's graph at d=500
          against its plain version and a float64 sum within the rounding
          its terms allow, the opposite direction's CSR outside it; its VJP
          against float64 autograd through the plain version; scatter2 with
          a random primary edge order (the perm path) against the same sum;
          the kernel's carry rows against merge_path_carry_rows and two
          launches bit for bit; times (hub rows and the others apart, and
          at every item count of SWEEP_ITEMS) beside the bound and
          torch.sparse.mm on the same [V, E] CSR matrix; then layouts that
          stress the merge-path partition (a 9,155-entry hub row, also on
          the perm path, every entry in one row, no entries, rows of one
          entry, d = 37); then kernel 3 at the 1-N CompGCN step's shapes
          (compgcn_sums: each half's weighted sum at d = 200, the
          gathers' gradients summed by id into the relation and entity
          rows at d = 100) against a float64 sum, index_add_ beside it,
          one launch and fix-up a call;
  kernel_energies  the factored energies' float32 gather-dot route
          (csrc/neg_energy.cu: gather_dot_kernel, gather_dot_grad_kernel;
          d codes by kernel 3) at the R-GCN cells' shapes (30,000 x 10
          corruptions at d = 500 over V = 14,541 and 40,943) against the
          float64 direct form within the rounding its terms allow, two
          calls bit for bit, its launches and device memory; times of the
          route, its kernels, d q by kernel 3 instead and d codes beside
          the direct form and index_put_, and the bounds;
  serve_onehot, train_onehot, serve_diag, train_diag  as serve and train,
          through staircase.staircase_aggregate: 4 launches an encode and a
          step, each with its carry fix-up, no twin pass, none of the fused
          kernels.

Then the rest of TrainLoop on gcn_block.exp:

  fit     the main path of train.py: TrainLoop with the CLI's scorer over
          the synthetic validation split as the early stopper's score,
          prefetch on 2 threads, checkpoints and the metrics JSONL under
          build/chip_smoke/fit, the cadence cut to CheckEvery 10,
          BurninPhaseDuration 20, ReportTrainLossEvery 10 and at most 40
          steps: validation at each multiple of 10 until the stop, the
          stop rule on the logged scores, a checkpoint for each check that
          did not stop, train_loss and validation records, 4 forward and 4
          twin block_direction launches a step, 4 more forward a check;
  prefetch, prefetch_basis  5 steps serial, prefetch, prefetch, serial
          (gcn_block, then gcn_basis), in turns in one process: steps/s,
          median step_ms, batch_ms (in the producer) and wait_ms; the
          device idle share of a whole 5-step fit each way
          (torch.profiler); prefetch with one producer consumes the serial
          run's batches, hash for hash;
  resume  20 steps against 10 and a resume to 20 in a new loop, saves
          every 10, prefetch on 2 threads, at PyTorch's default settings:
          batches, losses, params and Adam state equal bit for bit (the
          whole run replayed from step 3, the resumed one from step 13);
  graph, graph_basis  the step as one CUDA graph (gcn_block, then
          gcn_basis): GRAPH_STEPS steps of a fit by the loop's own step
          (captured at step 3, then replayed) and by the sync-free step op
          by op (TrainLoop.eager_step, no graph), in turns (graph, eager,
          eager, graph), prefetch on 2 threads: the losses equal step for
          step, the captures, replays and eager steps, a replayed step's
          host ms against an eager one's, each run's rate over the steps
          after the capture, peak and reserved device memory;
  determinism  in a child process (``chip_smoke.py --determinism-child``)
          whose environment lacks CUBLAS_WORKSPACE_CONFIG: two 10-step
          fits from seed 0 as train.py runs them, at default settings, of
          gcn_block, gcn_basis bf16 and distmult bf16 (d blocks', d C's
          and the fused energies' sums by id, the gathers' backward):
          params and Adam state equal bit for bit, each fit's step time;
  quality  the learning-quality gate on synthetic.learnable(2000, 40,
          60000, 5000, 5000, latent_dim=16, temperature=0.4, seed=0), the
          JAX capstone's mid-size graph (its draw time printed): the
          teacher's own scores through the Scorer in float64 (0.4742 /
          0.6018 filtered MRR / H@10 within 1e-4, docs/QUALITY.md); then
          gcn_block.exp in f32 and in bf16 (message and stream precision)
          for 2,000 steps and distmult.exp for 500 (all 60,000 positives
          a step), each through TrainLoop.fit with serial batches and the
          filtered MRR of the first 2,000 validation triples as the early
          stopper's score, CheckEvery 500 and BurninPhaseDuration 1,000
          (cut from 2,000 / 6,000): the untrained and trained test
          filtered MRR and H@10, the fraction of the ceiling, the
          validation curve, steps/s and the launches (4 + 4 block_direction
          a step, 4 more a validation encode); gates: gcn_block >= 0.13
          (half the capstone's 0.257 at 2,000 steps, a TPU quality
          reference) and DistMult >= 18x chance, each >= 3x untrained;
          gcn_block f32's first 5 steps inside observability.trace, whose
          file must name the block kernel; the score and degree dumps of
          gcn_block f32 and DistMult over the first 200 test triples
          (cut to bound the text) under build/chip_smoke/quality, and
          the R-GCN+ ensemble of tools/ensemble.py over them (weights 1,
          0 and 0.5, the cutoff at 1,000): weights 1 and 0 give the two
          models' filtered MRR over those triples within 1e-3.

Then distmult.exp and complex.exp (the embedding table, no graph, all
272,115 positives a step):

  serve_distmult, serve_complex  as serve, with no aggregation launch;
  train_distmult, train_complex  as train for 6 steps, the one-step
          comparison on the CPU plain path on the first 30,000 positives.

Then the negative protocols and the MLP decoder on gcn_block.exp, each a
train phase as train (one step on the card against the CPU plain path,
then TrainLoop.fit with 4 forward and 4 twin block_direction launches and
8 fix-ups a step):

  train_tiled       the tiled loss on device_negative_sample's batch
          (in place of the factored loss), 20 steps; first the tiled loss held to
          the factored loss on the same generator state on the card (loss
          within 1e-5 relative, each leaf within 1e-4 relative L2), and
          the e1, r and e2 gathers of the tiled batch timed with their
          backward and beside index_add_;
  train_split, train_shared  --negative-mode split and shared (a pool of
          512), 20 steps each;
  train_host_tiled  device_negatives=False, 6 steps: the host-tiled batches
          the fit consumed equal a CPU model's pipeline's, batch for batch;
  serve_mlp  gcn_block.exp with [Decoder] Name=nonlinear-transform (D=500)
          as serve, with the MLP's all-entity scoring of one chunk timed
          at blocks of 1 and 8 rows and the default budget's, beside its
          bound;
  train_mlp  the same model through the tiled loss, 20 steps, its
          gathers timed as train_tiled's.

Then the rest of the reference's encoder surface, each configuration a
copy of a shipped settings file with one or two keys changed (written under
build/chip_smoke/<label>), served and trained as serve and train (a fit of
6 steps; the loss finite at every step, not held to fall):

  serve_/train_plus_diag   gcn_basis.exp, AddDiagonal=Yes: basis + x[src]
          * D[r] messages summed by staircase_aggregate, 4 launches an
          encode and a step;
  serve_/train_times_diag  gcn_basis.exp, DiagonalCoefficients=Yes:
          sigmoid-scaled [R, B, d] coefficients, the same launches;
  serve_/train_stored      gcn_basis.exp, StoreEdgeData=Yes: host-tiled
          batches and the tiled loss, deltas against per-edge caches
          summed by staircase_aggregate with unit weights (4 a step); the
          first step against the CPU plain path, and every cache after 3
          steps from zero within 1e-5 in relative L2 norm of the CPU's;
  serve_/train_vgcn        gcn_basis.exp, Name=variational_gcn_basis: the
          launches of serve_basis and train_basis, and the step's KL term
          held to the CPU's within 1e-5 relative;
  serve_/train_vemb        distmult.exp, Name=variational_embedding: no
          launch, all 272,115 positives a step, the KL term as vgcn's;
  serve_/train_highway, _residual_out, _random, _partial  gcn_block.exp
          with SkipConnections=Highway; SkipConnections=Residual and
          UseOutputTransform=Yes; UseInputTransform=No with RandomInput=Yes;
          and with PartiallyRandomInput=Yes: 4 (+ 4 twin) block_direction
          launches an encode (a step).

Then bf16 message and stream precision, each configuration a copy
of a shipped settings file with ``MessagePrecision=bfloat16`` and
``stream_precision`` bfloat16 set by ``dataclasses.replace`` (no settings
key has it), at published widths:

  kernel_bf16  the bf16 entry points (block_direction_bf16 and its twin by
          the slice route, W's slice in shared memory: equal bit
          for bit to the f32 entry point on the widened inputs, carry rows
          and two launches bit for bit, timed beside the walk on the
          same inputs (route="walk") with both device times, the slice
          plan, shared memory, registers, items and an items sweep, and
          torch.sparse.mm of the one-call [V*d, V*d] CSR of E*B*dr*dr
          entries, f32 and bf16, its build timed apart; then the stress
          layouts of block_layouts and the training batch at every dr of
          1-8 by the slice route, and a layout of R = 5,000 relations that
          takes the walk: within the allowance, the wrong layout outside,
          bits twice, route="slice" refused; basis_project_bf16 after its
          pad pass (the pad equal to
          bf16_pad_reference bit for bit; pad and product timed apart,
          their device times from torch.profiler, the product's
          registers and stages), basis_combine_bf16 forward and twin CSR
          by the chunk route (equal bit for bit to the f32 entry point on
          the widened P, carry rows and two launches bit for bit, timed
          beside PR 6's kernel on the same inputs (route="row") with both
          device times, ptxas' registers and spills of both, the plan and
          an items sweep; then combine_layouts' stress layouts, the
          training batch at B = 1-8 with d_out = 37, items 1,024 at B = 8,
          two column chunks at d_out = 1,000 and two rectangular layouts,
          each equal to the f32 entry point's bits, within the allowance,
          the wrong layout outside, both kernels timed),
          staircase_aggregate_bf16 with and without perm, scatter2 with
          compute_dtype bf16) on the full train graph and on the first
          training batch's graph, each against a float64 sum of its
          bf16-valued inputs within sum_allowance (the product within its
          f32 allowance plus one bf16 ulp) and the wrong layout outside
          it, beside its plain version; times beside the f32 kernel's, the
          bound (bf16 bytes, 989 TFLOP/s for the product) and the library
          call (torch.matmul in bf16, torch.sparse.mm on a bf16 CSR);
  serve_bf16, train_bf16, serve_basis_bf16, train_basis_bf16,
  serve_diag_bf16, train_diag_bf16  as serve and train (10 steps) on
          gcn_block.exp, gcn_basis.exp and gcn_diag: the bf16 entry points
          launched 4 (+ 4 twin) times an encode (a step) and no f32 one,
          one fused energies' kernel 3 launch a step; codes within 1e-3
          (relative L2) of the CPU plain path and 2e-2 of the f32 encode,
          MRR beside the f32 one; the step within BF16_STEP_TOL of the CPU
          plain path and its loss within 1e-2 of the f32 loss on the same
          draws; gcn_block's and gcn_basis's warm encode timed and 3 steps
          profiled by each bf16 route of their kernel (slice and walk;
          chunk and row), in the order new, old, old, new;
  train_distmult_bf16  distmult.exp on bf16 streams, 6 steps of all
          272,115 positives: the fused backward's d codes against
          autograd's on the same bf16 values, and the fused, bf16 direct
          and f32 backwards timed side by side;
  train_split_bf16  gcn_block.exp bf16 with --negative-mode split, 10
          steps: two single-factor fused backwards a step.

Then the edge-partitioned mesh (relationprediction_torch/parallel/), its
ranks spawned processes on cuda:0 (distributed.launch; a rank that fails
fails the phase):

  mesh_step  gcn_block.exp f32, the factored loss, on 1 rank over NCCL
          and on 2 and 4 gloo ranks that share the card: one step on each
          rank's shard of 30,000 positives and 15,000 message edges, with
          global draws (each rank its rows' negatives, the keep-masks
          shared), against the one-device step on the same batch and draws
          (loss within 1e-5 relative, each leaf within 1e-4 relative L2;
          at world size 1 equal bit for bit); an SGD step at lr 1 against
          the one-device SGD step (each leaf's update within 1e-4), with a
          control that sums the ranks' gradients in place of their mean
          and must miss by N-1; 5 Adam steps of TrainLoop(mesh=) whose
          params and Adam state are equal bit for bit on every rank; each
          rank's launches a step (4 forward, 4 twin block_direction, their
          fix-ups, 4 sums by relation) and all-reduces a step (calls,
          bytes). At 2 ranks also gcn_basis (kernel 2), gcn_diag (kernel
          3), gcn_block with bf16 message precision (BF16_STEP_TOL), with
          bf16 message and stream precision (BF16_STEP_TOL against the
          one-device steps on each rank's block of rows,
          bf16_stream_rule, with two controls that must miss) and with
          the split protocol, each one step as above; and a 20-step fit of
          TrainLoop(mesh=) through the library (finite, falling loss;
          checkpoints from rank 0 only; its steps/s beside the one-device
          train phase's, ranks that share one card, not a scale-out
          number);
  mesh_eval  ModelView(mesh=) on 2 ranks against the one-device view:
          codes within 1e-4, filtered MRR of 2,000 test triples within
          1e-3, 4 forward launches an encode on each rank;
  mesh_fit  train.py --mesh 1 (NCCL) on synth:FB15k-237 at the fit
          phase's cadence for 40 steps, then a 10-step run and its
          --resume to 20: its checkpoints at 10 and 20 equal the first
          run's bit for bit;
  vs_step  the vertex-sharded step (parallel/vertex_sharded.py, factored,
          'full_parity' dropout) of gcn_block on 1 (NCCL), 2 and 4
          (gloo) ranks on cuda:0, and at 2 ranks gcn_basis, gcn_diag, the
          overlapped schedule, the all-gather halo, the tiled loss and
          bf16 messages, each against the one-device step on the same
          batch and draws (loss 1e-5, leaves 1e-4); its launches a rank
          (exact), all-to-alls (counted and from shapes), the halo's h
          and rows shipped; the table's gradient through a mean over the
          ranks (must miss); in every cell each kernel of its route, in
          its precision (bf16 entry points in the bf16 cell), on the
          rank's rectangular layouts against its float64 sum, a wrong
          layout outside it;
  vs_eval  VertexShardedModelView on 2 ranks against the one-device
          view: codes within 1e-4, filtered MRR within 1e-3;
  vs_fit  20 steps of TrainLoop(vertex_sharded=True) on 2 ranks (steps/s
          of ranks that share a card), then train.py --mesh 1
          --vertex-sharded for 20 steps and a 10-step run with its
          --resume to 20: checkpoints at 10 and 20 bit for bit.

Then a line listing every ported kernel with its numbers (each kernel's
launches on each of these paths beside them), nvidia-smi's line, and last
``{"ok": true, "device": {...}}``. Any failure exits non-zero;
without a CUDA card the script exits 2 and prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import hashlib
import io
import itertools
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time
import types
import weakref
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from relationprediction_torch import config, observability
from relationprediction_torch import train as train_cli
from relationprediction_torch.data import synthetic
from relationprediction_torch.device import exact_float32
from relationprediction_torch.evaluation import ranking
from relationprediction_torch.evaluation.scorer import Scorer
from relationprediction_torch.graph import CsrLayout, build_graph_batch
from relationprediction_torch.models import build, decoders
from relationprediction_torch.ops import neg_energy, staircase, staircase2
from relationprediction_torch.parallel import distributed
from relationprediction_torch.parallel import collectives
from relationprediction_torch.parallel import mesh as mesh_mod
from relationprediction_torch.params import (map_tree, tree_leaves,
                                             tree_unflatten)
from relationprediction_torch.tools import ensemble
from relationprediction_torch.training import (checkpoint, device_sampling,
                                               engine, optimizers)

ROOT = Path(__file__).resolve().parent
SETTINGS = ROOT / "settings" / "gcn_block.exp"
BASIS_SETTINGS = ROOT / "settings" / "gcn_basis.exp"
KERNEL_SOURCE = "relationprediction_torch/ops/csrc/block_direction.cu"
BASIS_SOURCE = "relationprediction_torch/ops/csrc/basis_direction.cu"
PROJECT_SOURCE = "relationprediction_torch/ops/csrc/basis_project.cu"
REPLACES = "relationprediction_tpu/ops/staircase2.py:460"
# The twin pass: the VJP's second launch of the same TPU kernel.
REPLACES_TWIN = "relationprediction_tpu/ops/staircase2.py:721"
# TPU kernel 2 (_make_basis_kernel) and its launch on the twin layout.
REPLACES_BASIS = "relationprediction_tpu/ops/staircase2.py:505"
REPLACES_BASIS_TWIN = "relationprediction_tpu/ops/staircase2.py:874"
STAIRCASE_SOURCE = "relationprediction_torch/ops/csrc/staircase.cu"
# TPU kernel 3 (_staircase_kernel) and kernel 4 (_scatter_kernel).
REPLACES_STAIRCASE = "relationprediction_tpu/ops/staircase.py:191"
REPLACES_SCATTER2 = "relationprediction_tpu/ops/staircase2.py:443"
ENERGY_SOURCE = "relationprediction_torch/ops/csrc/neg_energy.cu"
# The R-GCN cells' corruption energies, (n, k, d, V): n positives of k
# corruptions at d = 500, over FB15k-237's and WN18's entity tables.
ENERGY_SHAPES = {"fb15k237": (30000, 10, 500, 14541),
                 "wn18": (30000, 10, 500, 40943)}
SERVE_TRIPLES = 2000
TRAIN_STEPS = 20
HUB_ROW = 1024  # rows longer than this are timed apart
# Items a block of a merge-path kernel takes, swept in kernel and grad
# (block_direction and its twin), kernel_basis (basis_combine) and
# kernel_staircase; staircase.block_direction_items, basis_combine_items
# and merge_path_items give the port's.
SWEEP_ITEMS = (16, 32, 64, 128, 256, 512, 1024)
# NVIDIA H100 SXM data sheet: HBM rate, float32 rate outside the tensor
# cores and dense TF32 tensor-core rate, at the full 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12
BF16_OPS_PER_S = 989e12
F32_UNIT_ROUNDOFF = 2.0 ** -24


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


@functools.lru_cache(maxsize=None)
def nvidia_smi_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
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


def profiler_record(fn, names, iters: int = 20) -> tuple:
    """torch.profiler's CUDA activity over ``iters`` calls of ``fn`` (one
    call before, unprofiled): for each kernel whose name holds one of
    ``names``, (name, kernel, times recorded, mean ms a call), and the
    CUDA events' ms a call around the same calls."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
    kernels = [(name, event.key[:90], event.count,
                event.device_time_total / iters / 1e3)
               for event in prof.key_averages() for name in names
               if name in event.key and event.device_time_total > 0]
    return kernels, start.elapsed_time(end) / iters


def device_ms(fn, names, iters: int = 20) -> dict:
    """Mean device time of each kernel whose name holds one of ``names``
    over ``iters`` calls of ``fn``, from torch.profiler's CUDA activity
    (CUDA events around calls of a launch function that spends more time
    on the host than the kernel takes measure the host instead). Empty
    where the profiler's record cannot be right: a kernel not recorded
    once a call, or kernels whose times add up to more than the CUDA
    events around the same calls."""
    return checked_device_ms(*profiler_record(fn, names, iters), iters)


def checked_device_ms(kernels, events_ms, iters) -> dict:
    """device_ms's result from a profiler_record."""
    out = {name: ms if count == iters else None
           for name, _, count, ms in kernels}
    if None in out.values() or sum(out.values()) > 1.05 * events_ms:
        return {}
    return out


def retried_device_ms(fn, names, key: str, tries: int = 3,
                      iters: int = 20) -> dict:
    """device_ms, taken again where the profiler's record could not be
    right (an empty result), up to ``tries`` times: ``key`` the last
    reading, ``key``_tries the readings taken, ``key``_refused the
    records that failed device_ms's check (what the profiler saw)."""
    refused = []
    for n in range(1, tries + 1):
        kernels, events_ms = profiler_record(fn, names, iters)
        out = checked_device_ms(kernels, events_ms, iters)
        if out:
            break
        refused.append({"kernels": kernels, "events_ms": events_ms})
    return {key: out, f"{key}_tries": n, f"{key}_refused": refused}


def mean_device_ms(readings, name):
    """The mean of kernel ``name``'s time over device_ms readings, or
    None where a reading has none."""
    values = [r.get(name) for r in readings]
    return None if None in values else sum(values) / len(values)


def sum_by_csr_op():
    """ops/gather.sum_by_csr, imported where it is used: the determinism
    child also runs on a checkout of the port before that module existed,
    to show how its parent commit fared."""
    from relationprediction_torch.ops import gather
    return gather.sum_by_csr


def block_direction_bound(layout, n_vertices, n_rel, n_blocks, dr, elem=4):
    """Least time of one launch: bytes moved (each input read once, the
    output written once) over the HBM rate, against the f32 operations
    this data needs (z = sum w*x per edge, one block product per (target,
    relation) run) over the f32 rate. Inputs are counted as this layout
    needs them: the feature rows its edges gather and the blocks of the
    relations it holds, ``elem`` bytes an element (2 for the bf16 entry
    points); out, the weights and the CSR 4."""
    e, d = layout.n_edges, n_blocks * dr
    rows = int(torch.unique(layout.src).numel()) if e else 0
    rels = int(torch.unique(layout.rel).numel()) if e else 0
    n_bytes = elem * (rows * d + rels * n_blocks * dr * dr) \
        + 4 * (n_vertices * d + (n_vertices + 1) + 3 * e)
    targets = torch.repeat_interleave(
        torch.arange(n_vertices, device=layout.row_ptr.device),
        layout.row_ptr.diff().long())
    runs = int(1 + ((targets.diff() != 0) | (layout.rel.diff() != 0))
               .sum().item()) if e else 0
    return {**least_time(n_bytes, 2 * e * d + 2 * runs * d * dr), "runs": runs,
            "gathered_rows": rows, "relations": rels,
            "ops_per_edge_products": 2 * e * n_blocks * dr * dr}


def dblocks_bound(layout, n_vertices, n_rel, n_blocks, dr):
    """Least time of the d blocks contraction: read the gathered rows of
    features and of the cotangent and the CSR, write d blocks, against
    2 * E * d * dr f32 operations (one weighted outer product per edge)."""
    e, d = layout.n_edges, n_blocks * dr
    rows = int(torch.unique(layout.src).numel()) if e else 0
    tgts = int((layout.row_ptr.diff() > 0).sum().item())
    n_bytes = 4 * ((rows + tgts) * d + n_rel * n_blocks * dr * dr
                   + (n_vertices + 1) + 3 * e)
    ops = 2 * e * d * dr
    return least_time(n_bytes, ops)


def least_time(n_bytes, ops, ops_per_s=F32_OPS_PER_S) -> dict:
    """The least time for ``n_bytes`` of HBM traffic and ``ops``
    operations at ``ops_per_s`` (the f32 rate unless said): the larger of
    the two times, and which it is."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, ops / ops_per_s
    return {"bytes": n_bytes, "ops": ops,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def project_bound(m, k, n) -> dict:
    """basis_project as the kernel computes it, 3xTF32: read X [M, K] and
    W [K, N], write P [M, N], against 3 * 2 * M * K * N operations at the
    dense TF32 tensor-core rate; beside it the f32 FMA bound of the same
    product (2 * M * K * N at the f32 rate), the route the kernel of PRs
    3-4 was priced at."""
    n_bytes = 4 * (m * k + k * n + m * n)
    return {**least_time(n_bytes, 3 * 2 * m * k * n, TF32_OPS_PER_S),
            "priced_at": "3xTF32, dense TF32 tensor-core rate",
            "f32_fma_bound_ms": least_time(n_bytes, 2 * m * k * n)[
                "bound_ms"]}


def split_bound(m, k, n, kp, parts) -> dict:
    """The split pass: read X [M, K] and W [K, N] once, write their TF32
    parts [parts, M, Kp] and [parts, N, Kp]; no operations worth a
    bound."""
    return least_time(4 * (m * k + k * n + parts * (m + n) * kp), 0)


def combine_bound(layout, n_rows, n_bases, d_out, elem=4) -> dict:
    """basis_combine on this layout: each gathered projected row (B *
    d_out elements of ``elem`` bytes, 2 for bf16 P) once, the coefficients
    of the relations present, the CSR, and ``out`` written once, against
    2 * E * B * d_out f32 operations (one FMA per basis and column an
    edge) and E * B for the edges' coefficients."""
    e = layout.n_edges
    rows = int(torch.unique(layout.src).numel()) if e else 0
    rels = int(torch.unique(layout.rel).numel()) if e else 0
    n_bytes = elem * rows * n_bases * d_out + 4 * (
        n_rows * d_out + rels * n_bases + (n_rows + 1) + 3 * e)
    return {**least_time(n_bytes, 2 * e * n_bases * d_out + e * n_bases),
            "gathered_rows": rows}


def staircase_bound(layout, n_rows, d, perm=False, elem=4) -> dict:
    """staircase_aggregate on this layout: every message row read once
    (E * d elements of ``elem`` bytes, 2 for bf16 messages), ``out``
    written once, the weights and row_ptr (and the permutation on the
    scatter2 path), against 2 * E * d f32 operations (one FMA an entry
    and column)."""
    e = layout.n_edges
    n_bytes = elem * e * d + 4 * (n_rows * d + e + (n_rows + 1)
                                  + (e if perm else 0))
    return least_time(n_bytes, 2 * e * d)


def staircase_exact(msgs, layout, n_rows, perm=None):
    """The segment sum in float64 and its sum_allowance (one term an
    entry)."""
    exact = staircase.staircase_aggregate_reference(msgs.double(), layout,
                                                    n_rows, perm)
    abs_sum = staircase.staircase_aggregate_reference(
        msgs.double().abs(), with_weights(layout, layout.w.abs()), n_rows,
        perm)
    deg = layout.row_ptr.diff().long()[:, None]
    return exact, sum_allowance(exact, abs_sum, deg)


def model_label(cfg) -> str:
    """Which configuration a phase ran: the encoder and its input stage,
    or the embedding table and its decoder."""
    e = cfg.encoder
    if e.name in ("embedding", "variational_embedding"):
        return f"{e.name}, {cfg.decoder.name}"
    if e.name == "gcn_diag":
        return "gcn_diag"
    stage = "input transform" if e.use_input_transform \
        else "random input" if e.random_input \
        else "partially random input" if e.partially_random_input \
        else "one-hot input"
    extras = "".join(f", {x}" for x, on in (
        (f"{e.skip_connections} skip connections",
         e.skip_connections != "None"),
        ("output transform", e.use_output_transform),
        (cfg.decoder.name, cfg.decoder.name != "bilinear-diag")) if on)
    return f"{e.name}/{e.gcn_variant}, {stage}{extras}"


def sum_allowance(exact, abs_sum, n_terms):
    """What an f32 evaluation of a sum may differ from its float64 value
    ``exact`` at each element: 1e-5 + 1e-4 * |exact| (the kernel phase's
    tolerance), plus sqrt(n) * 2^-24 * sum |terms| for the element's n
    terms (``abs_sum``: the same sum of the terms' absolute values), the
    usual size of the rounding error of an n-term f32 sum (Higham and
    Mary, 2019)."""
    return (1e-5 + 1e-4 * exact.abs()
            + n_terms.double().sqrt() * F32_UNIT_ROUNDOFF * abs_sum)


def with_weights(layout, w):
    """``layout`` with the edge weights ``w``."""
    return dataclasses.replace(layout, w=w)


def twin_sum_allowance(g, blocks, layout, n_vertices):
    """d features of one block direction for the cotangent ``g``, in
    float64 by autograd through block_direction_reference (no twin layout
    involved), and its sum_allowance (dr terms an edge). Returns (exact,
    allowance), both [V, d] float64."""
    def d_features(g, blocks, w):
        x = torch.zeros(n_vertices, g.shape[1], dtype=torch.float64,
                        device=g.device, requires_grad=True)
        out = staircase2.block_direction_reference(
            x, blocks, with_weights(layout, w), n_vertices)
        return torch.autograd.grad((out * g).sum(), x)[0]
    exact = d_features(g.double(), blocks.double(), layout.w)
    abs_sum = d_features(g.double().abs(), blocks.double().abs(),
                         layout.w.abs())
    n_terms = torch.bincount(layout.src.long(), minlength=n_vertices)
    return exact, sum_allowance(exact, abs_sum,
                                n_terms[:, None] * blocks.shape[-1])


def basis_exact(x, w_flat, coef, layout, n_vertices, probe):
    """One basis direction and its d features for the cotangent ``probe``,
    in float64 by autograd through basis_direction_reference on ``layout``
    (no twin layout involved), each with its sum_allowance: (out,
    out_allowance, dx, dx_allowance). An element of the forward sums
    deg * B * d_in terms, one of d features deg_src * B * d_out."""
    parts = []
    for f, w in ((torch.Tensor.double, layout.w),
                 (lambda t: t.double().abs(), layout.w.abs())):
        xd = f(x).requires_grad_(True)
        out = staircase2.basis_direction_reference(
            xd, f(w_flat), f(coef), with_weights(layout, w), n_vertices)
        dx = torch.autograd.grad((out * f(probe)).sum(), xd)[0]
        parts.append((out.detach(), dx))
    (out, dx), (out_abs, dx_abs) = parts
    n_bases = coef.shape[1]
    deg_tgt = layout.row_ptr.diff().long()
    deg_src = torch.bincount(layout.src.long(), minlength=n_vertices)
    return (out, sum_allowance(out, out_abs,
                               deg_tgt[:, None] * n_bases * x.shape[1]),
            dx, sum_allowance(dx, dx_abs,
                              deg_src[:, None] * n_bases * probe.shape[1]))


def block_exact(x, blocks, layout, n_rows):
    """block_direction in float64 and its sum_allowance (dr terms an
    edge); ``blocks`` transposed gives the twin pass's."""
    exact = staircase2.block_direction_reference(x.double(), blocks.double(),
                                                 layout, n_rows)
    abs_sum = staircase2.block_direction_reference(
        x.double().abs(), blocks.double().abs(),
        with_weights(layout, layout.w.abs()), n_rows)
    deg = layout.row_ptr.diff().long()[:, None] * blocks.shape[-1]
    return exact, sum_allowance(exact, abs_sum, deg)


def combine_exact(proj, coef, layout, n_rows):
    """basis_combine in float64 and its sum_allowance (B terms an edge)."""
    exact = staircase2.basis_combine_reference(proj.double(), coef.double(),
                                               layout, n_rows)
    abs_sum = staircase2.basis_combine_reference(
        proj.double().abs(), coef.double().abs(),
        with_weights(layout, layout.w.abs()), n_rows)
    deg = layout.row_ptr.diff().long()[:, None] * coef.shape[1]
    return exact, sum_allowance(exact, abs_sum, deg)


def project_exact(x, w):
    """x @ w in float64 and what an f32 product may differ from it at each
    element: sqrt(K) * 2^-24 * sum_k |x[m, k]| |w[k, n]|."""
    exact = x.double() @ w.double()
    allowance = (x.shape[1] ** 0.5 * F32_UNIT_ROUNDOFF
                 * (x.double().abs() @ w.double().abs()))
    return exact, allowance


def rel_l2(got, want) -> float:
    """|got - want| / |want| in the L2 norm, in float64."""
    want = want.double()
    return ((got.double() - want).norm() / want.norm()).item()


def float32_config(cfg):
    """``cfg`` with float32 message and stream precision."""
    return dataclasses.replace(
        cfg, encoder=dataclasses.replace(cfg.encoder,
                                         message_precision="float32"),
        decoder=dataclasses.replace(cfg.decoder, stream_precision="float32"))


def over_allowance(got, exact, allowance) -> float:
    """Largest |got - exact| / allowance (above 1 fails)."""
    return ((got.double() - exact).abs() / allowance).max().item()


def long_row_entries(layout, limit):
    """[E] bool: the CSR entries of rows longer than ``limit`` edges."""
    lengths = layout.row_ptr.diff()
    return torch.repeat_interleave(lengths > limit, lengths.long())


def split_rows(layout, limit):
    """Two layouts of the same rows: one keeps only the rows longer than
    ``limit`` edges, the other only the rest (the dropped rows are empty);
    each keeps its entries in order (``long_row_entries`` and its
    complement)."""
    lengths = layout.row_ptr.diff()
    long_row = long_row_entries(layout, limit)
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


def repeatable(what, launch, row_ptr, items):
    """One call of a merge-path kernel (``launch(carries)``, which returns
    (out, carry_rows) when ``carries`` is true) with its carry rows held
    against merge_path_carry_rows(row_ptr, items), and a second call that
    must give the same bits. Returns the output."""
    got, carry_rows = launch(True)
    again = launch(False)
    if not torch.equal(carry_rows.cpu(),
                       staircase.merge_path_carry_rows(row_ptr, items)):
        raise AssertionError(f"{what}: the kernel's carry rows differ from "
                             f"merge_path_carry_rows")
    if not torch.equal(got.view(torch.int32), again.view(torch.int32)):
        raise AssertionError(f"{what}: two launches differ")
    return got


def grouped_w_tiles(layout, v, items) -> int:
    """W tiles a launch would load if each block loaded each of its
    relations once (grouping its runs by relation) instead of once a
    relation run: the (block, relation) pairs of the partition at
    ``items``."""
    if layout.n_edges == 0:
        return 0
    _, entries = staircase.merge_path_split(layout.row_ptr, items)
    block = torch.searchsorted(entries[1:], torch.arange(layout.n_edges),
                               right=True)
    rel = layout.rel.long().cpu()
    return int(torch.unique(block * (int(rel.max()) + 1) + rel).numel())


def block_timings(lib, x, w, layout, v, n_rel, *, twin=False) -> dict:
    """Times of one block_direction pass on ``layout`` beside its bound:
    the kernel, the hub rows and the others apart, every item count of
    SWEEP_ITEMS, and the same CSR with every relation 0, where W[0] stays
    in L1 and only the x gathers and the partition remain (beside the
    bytes the x gathers and the W reloads of the relation runs move, and
    the W tiles a block grouping its runs by relation would load at each
    item count)."""
    n_blocks, dr = w.shape[1], w.shape[2]
    e, d = layout.n_edges, n_blocks * dr
    bound = block_direction_bound(layout, v, n_rel, n_blocks, dr)
    hubs, rest = split_rows(layout, HUB_ROW)
    one_rel = dataclasses.replace(layout, rel=torch.zeros_like(layout.rel))
    lengths = layout.row_ptr.diff()
    def run(lay, **kw):
        return lambda: staircase2.launch(lib, x, w, lay, v, twin=twin, **kw)
    return {"kernel_ms": cuda_ms(run(layout), 50),
            "items": staircase.block_direction_items(v, e),
            "hub_rows_only_ms": cuda_ms(run(hubs), 20),
            "other_rows_only_ms": cuda_ms(run(rest), 20),
            "relation_0_ms": cuda_ms(run(one_rel), 20),
            "x_gather_bytes": 4 * e * d,
            "w_reload_bytes": 4 * bound["runs"] * n_blocks * dr * dr,
            "items_sweep_ms": {str(items): cuda_ms(run(layout, items=items),
                                                   20)
                               for items in SWEEP_ITEMS},
            "grouped_w_tiles": {str(items): grouped_w_tiles(layout, v, items)
                                for items in SWEEP_ITEMS},
            f"rows_over_{HUB_ROW}": int((lengths > HUB_ROW).sum().item()),
            "largest_row": int(lengths.max().item()),
            "empty_rows": int((lengths == 0).sum().item()),
            "edges": e, **bound}


def phase_kernel(graphs, n_rel, n_blocks, dr, device):
    """block_direction (the op, a merge-path kernel and its carry fix-up)
    in both directions of each graph against a float64 sum within the
    rounding its terms allow (block_exact), the opposite direction's CSR
    outside it, the kernel's carry rows against merge_path_carry_rows and
    two launches bit for bit; times (block_timings) beside the plain
    version. Then block_layouts, forward and twin."""
    t_phase = time.perf_counter()
    lib, _ = staircase2.kernel_library()
    rows = []
    for graph_name, graph in graphs.items():
        v = graph.n_vertices
        gen = torch.Generator().manual_seed(1)
        x = torch.randn(v, n_blocks * dr, generator=gen).to(device)
        w = torch.randn(n_rel, n_blocks, dr, dr, generator=gen).to(device)
        for name, layout, wrong in (("forward", graph.fwd, graph.bwd),
                                    ("backward", graph.bwd, graph.fwd)):
            items = staircase.block_direction_items(v, layout.n_edges)
            got = staircase2.block_direction(x, w, layout, v)
            checked = repeatable(
                "block_direction", lambda c: staircase2.launch(
                    lib, x, w, layout, v, carries=c), layout.row_ptr, items)
            want = staircase2.block_direction_reference(x, w, layout, v)
            wrong_out = staircase2.launch(lib, x, w, wrong, v)
            exact, allowance = block_exact(x, w, layout, v)
            torch.cuda.synchronize()
            if not torch.isfinite(got).all():
                raise AssertionError(f"{graph_name}/{name}: kernel output "
                                     f"is not finite")
            if not torch.equal(got.view(torch.int32),
                               checked.view(torch.int32)):
                raise AssertionError(f"{graph_name}/{name}: the op and its "
                                     f"launch differ")
            over = over_allowance(got, exact, allowance)
            wrong_over = over_allowance(wrong_out, exact, allowance)
            if not over <= 1:
                raise AssertionError(f"block_direction {graph_name}/{name}: "
                                     f"{over} of the f32 rounding allowance")
            if not wrong_over > 1:
                raise AssertionError(
                    f"block_direction {graph_name}/{name}: the opposite CSR "
                    f"passes the allowance ({wrong_over} of it)")
            row = {"graph": graph_name, "direction": name,
                   "max_abs_err": (got.double() - exact).abs().max().item(),
                   "max_abs_diff_vs_plain": (got - want).abs().max().item(),
                   "over_allowance": over,
                   "wrong_layout_over_allowance": wrong_over,
                   "same_bits_twice": True,
                   "plain_ms": cuda_ms(
                       lambda: staircase2.block_direction_reference(
                           x, w, layout, v), 3, warmup=1),
                   **block_timings(lib, x, w, layout, v, n_rel)}
            emit("kernel", kernel="block_direction",
                 phase_s=time.perf_counter() - t_phase, **row)
            rows.append(row)
    for row in block_layouts(lib, graphs, n_rel, device):
        emit("kernel", phase_s=time.perf_counter() - t_phase, **row)
        rows.append(row)
    return rows


FIXUP_OPS = (staircase2.block_direction, staircase2.basis_direction,
             staircase.staircase_aggregate)
# The factored energies: their bf16 backwards launch kernel 3's bf16
# entry point (its fix-ups count on staircase_aggregate); their float32
# gather-dot route on the card launches gather_dot_kernel and
# gather_dot_grad_kernel (csrc/neg_energy.cu) and kernel 3 twice by
# sum_by_csr.
ENERGY_OPS = (neg_energy.factored_negative_energies,
              neg_energy.single_factor_negative_energies)


# block_direction's and basis_combine's bf16 launches by direction and
# route.
ROUTE_COUNTERS = ("bf16_slice_launches", "bf16_walk_launches",
                  "bf16_twin_slice_launches", "bf16_twin_walk_launches")
COMBINE_ROUTE_COUNTERS = ("bf16_chunk_launches", "bf16_row_launches",
                          "bf16_twin_chunk_launches",
                          "bf16_twin_row_launches")


def reset_launch_counts() -> None:
    """Every kernel count to 0, f32 and bf16, just before a main path
    runs."""
    for op in (staircase2.block_direction, staircase2.basis_direction):
        op.launches = op.twin_launches = 0
        op.bf16_launches = op.bf16_twin_launches = 0
    for name in ROUTE_COUNTERS:
        setattr(staircase2.block_direction, name, 0)
    for name in COMBINE_ROUTE_COUNTERS:
        setattr(staircase2.basis_direction, name, 0)
    staircase2.basis_direction.project_launches = 0
    staircase2.basis_direction.split_launches = 0
    staircase2.basis_direction.bf16_project_launches = 0
    staircase2.basis_direction.bf16_pad_launches = 0
    for op in (staircase.staircase_aggregate, staircase2.scatter2,
               staircase2.scatter2_slot_order, sum_by_csr_op()):
        op.launches = op.bf16_launches = 0
    for op in ENERGY_OPS:
        op.bf16_launches = op.f32_launches = op.f32_grad_launches = 0
    for op in FIXUP_OPS:
        op.fixup_launches = 0


def precision_counts(bf16: bool) -> dict:
    """The launches of one precision's entry points since the counts were
    set to 0, by name: bf16's where ``bf16``, else f32's."""
    pre = "bf16_" if bf16 else ""
    out = {}
    for op in (staircase2.block_direction, staircase2.basis_direction):
        for kind in ("launches", "twin_launches"):
            out[f"{op.__name__}.{pre}{kind}"] = getattr(op, pre + kind)
    out[f"basis_project.{pre}launches"] = getattr(
        staircase2.basis_direction, f"{pre}project_launches")
    for op in (staircase.staircase_aggregate, staircase2.scatter2,
               staircase2.scatter2_slot_order):
        out[f"{op.__name__}.{pre}launches"] = getattr(op, f"{pre}launches")
    if bf16:
        out["bf16_pad.launches"] = \
            staircase2.basis_direction.bf16_pad_launches
    else:
        out["tf32_split.launches"] = \
            staircase2.basis_direction.split_launches
    return out


def check_other_precision_idle(bf16: bool, dc_projects: int = 0) -> None:
    """A path of one message precision launched no aggregation entry point
    of the other: a bf16 tensor never reached an f32 kernel, nor an f32
    one a bf16 kernel. The one f32 work on a bf16 path is d C's f32 P
    (features @ W_flat from the saved f32 inputs, as JAX computes it):
    ``dc_projects`` launches of the f32 basis_project and as many of its
    split pass. (The bf16 energies' launches follow the stream precision
    and are checked apart.)"""
    other = precision_counts(not bf16)
    want = dict.fromkeys(other, 0)
    if bf16:
        want["basis_project.launches"] = dc_projects
        want["tf32_split.launches"] = dc_projects
    if other != want:
        raise AssertionError(f"a {'bf16' if bf16 else 'float32'} path "
                             f"launched the other precision's kernels: "
                             f"{other}, expected {want}")


def energy_launches() -> int:
    """Kernel 3 launches of the bf16 energies' backwards since the counts
    were set to 0."""
    return sum(op.bf16_launches for op in ENERGY_OPS)


def fused_energy_launches(model, kind, rows, rate) -> int:
    """Kernel 3 launches a step of the bf16 energies' backwards for a
    batch of ``rows`` positives: one for the factored loss (k = rate), one
    for each side of the split loss (k = rate // 2 and rate - rate // 2)
    that neg_energy.fused_backward_applies (the JAX package's rule) sends
    to the fused form; none for the tiled and shared losses or an f32
    stream."""
    if model.stream_dtype is None or kind not in ("factored", "split"):
        return 0
    codes = torch.empty(model.n_entities, 1, dtype=model.stream_dtype,
                        device="meta")
    ks = (rate,) if kind == "factored" else (rate // 2, rate - rate // 2)
    return sum(neg_energy.fused_backward_applies(codes, rows, k)
               for k in ks)


def gather_dot_calls(model, kind, rows, rate) -> int:
    """Calls a step of the energies' float32 gather-dot route
    (neg_energy.energy_route) for a batch of ``rows`` positives: one for
    the factored loss, one for each side of the split loss, where the
    codes are float32 on the card; none for the tiled and shared losses,
    a bf16 stream or the CPU. Each launches gather_dot_kernel and
    gather_dot_grad_kernel once and kernel 3 twice by sum_by_csr (d codes'
    weighted sum by id and its per-id scalars)."""
    if kind not in ("factored", "split"):
        return 0
    codes = types.SimpleNamespace(
        device=model.device, shape=(model.n_entities, 1),
        dtype=model.stream_dtype or torch.float32)
    ks = (rate,) if kind == "factored" else (rate // 2, rate - rate // 2)
    return sum(neg_energy.energy_route(codes, rows, k) == "gather_dot"
               for k in ks)


def gather_dot_launches() -> tuple:
    """(gather_dot_kernel, gather_dot_grad_kernel) launches since the
    counts were set to 0."""
    return (sum(op.f32_launches for op in ENERGY_OPS),
            sum(op.f32_grad_launches for op in ENERGY_OPS))


def check_gather_dot(dots: tuple, calls: int, where: str) -> None:
    """Each of the gather-dot route's ``calls`` launched its forward and
    its gradient kernel once."""
    if dots != (calls, calls):
        raise AssertionError(f"{where}: the gather-dot route launched its "
                             f"kernels {dots} times, expected {calls} "
                             f"calls")


def fixup_counts() -> dict:
    """The carry fix-up launches of each aggregation op since the counts
    were set to 0."""
    return {op.__name__: op.fixup_launches for op in FIXUP_OPS}


def op_name(op) -> str:
    return "no aggregation op" if op is None else op.__name__


def check_helper_launches(op, launches, twin_launches, project_launches,
                          split_launches, fixups, energies=0) -> None:
    """The kernels that run beside a main path's aggregation kernel: one
    split pass before each f32 basis_project launch (``project_launches``
    counts the f32 ones), one pad pass before each bf16 one, one carry
    fix-up after each launch of ``op`` (forward and twin), after each of
    the ``energies`` kernel 3 launches of the bf16 energies' backwards and
    after each kernel 3 launch of sum_by_csr (the sums by id of d blocks,
    d C and the fused backwards' per-id scalars), and neither
    elsewhere."""
    if split_launches != project_launches:
        raise AssertionError(f"{split_launches} split passes for "
                             f"{project_launches} basis_project launches")
    pads = staircase2.basis_direction.bf16_pad_launches
    products = staircase2.basis_direction.bf16_project_launches
    if pads != products:
        raise AssertionError(f"{pads} pad passes for {products} "
                             f"basis_project_bf16 launches")
    want = {name: 0 for name in fixups}
    want[staircase.staircase_aggregate.__name__] = \
        energies + sum_by_csr_op().launches
    if op is not None:
        want[op.__name__] += launches + twin_launches
    if fixups != want:
        raise AssertionError(f"carry fix-ups {fixups}, expected {want}")
    check_routes()


def route_launches() -> dict:
    """block_direction's and basis_combine's bf16 launch counts by
    direction and route since the counts were set to 0."""
    return {**{name: getattr(staircase2.block_direction, name)
               for name in ROUTE_COUNTERS},
            **{name: getattr(staircase2.basis_direction, name)
               for name in COMBINE_ROUTE_COUNTERS}}


def check_routes() -> None:
    """Every bf16 block_direction launch since the counts were set to 0
    went by the slice route and every bf16 basis_combine launch by the
    chunk route, counted once by direction and route: the routes are
    picked from the shapes, and every cell's (R = 237 or 40, B = 100,
    dr = 5; B = 5, d_out = 500) takes the slice and the chunks."""
    bd, bb = staircase2.block_direction, staircase2.basis_direction
    want = {"bf16_slice_launches": bd.bf16_launches,
            "bf16_walk_launches": 0,
            "bf16_twin_slice_launches": bd.bf16_twin_launches,
            "bf16_twin_walk_launches": 0,
            "bf16_chunk_launches": bb.bf16_launches,
            "bf16_row_launches": 0,
            "bf16_twin_chunk_launches": bb.bf16_twin_launches,
            "bf16_twin_row_launches": 0}
    if route_launches() != want:
        raise AssertionError(f"bf16 launches by route {route_launches()}, "
                             f"expected {want}")


# Each bf16 op's routes: (the main path's, the earlier design's).
OP_ROUTES = {"block_direction": ("slice", "walk"),
             "basis_direction": ("chunk", "row")}


@contextlib.contextmanager
def forced_route(route: str):
    """block_direction's bf16 launches take ``route`` ("slice" or "walk"),
    or basis_combine's ("chunk" or "row"), inside the block, whatever
    their shapes' plan: for timing the main path by the earlier design
    beside the shipped one, outside counted runs."""
    if route in OP_ROUTES["block_direction"]:
        name, f32 = "kernel_route", "walk"
    else:
        name, f32 = "combine_route", "row"
    chosen = getattr(staircase2, name)
    setattr(staircase2, name, lambda t, _: (
        route if t.dtype == torch.bfloat16 else f32))
    try:
        yield
    finally:
        setattr(staircase2, name, chosen)


def route_times(measure, routes=OP_ROUTES["block_direction"]) -> dict:
    """``measure()`` by the shipped route and by the earlier one
    (``routes``), in the order new, old, old, new (so a drift of the
    machine falls on both): route -> its two readings."""
    new, old = routes
    out = {new: [], old: []}
    for route in (new, old, old, new):
        with forced_route(route):
            out[route].append(measure())
    return out


def phase_serve(ds, device, cfg, op=staircase2.block_direction,
                phase="serve", compare_routes=False):
    """The serving path at full width, with the kernels' launch counts:
    ``op`` (block_direction, basis_direction or staircase_aggregate) must
    have launched once a direction and layer, and nothing else launched;
    with ``op`` None (the embedding encoder, no graph) nothing at all. A
    bf16 message precision counts the bf16 entry points and no f32 one
    (and an f32 one no bf16 one); its codes are held to the CPU plain
    path's within 1e-3 in relative L2 norm (the same bf16 inputs, f32
    sums in other orders, which can flip a bf16 rounding of the next
    layer's input) and to the f32 configuration's encode within 2e-2,
    its filtered MRR beside the f32 one. ``compare_routes`` (bf16
    block_direction or basis_direction) also times the warm encode by
    each of its bf16 routes (OP_ROUTES)."""
    t_phase = time.perf_counter()
    model = build.build_model(cfg, device)
    bf16 = model.agg_dtype is not None
    pre = "bf16_" if bf16 else ""
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
    reset_launch_counts()
    t0 = time.perf_counter()
    encoded = view.encoded(params, graph)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    summary = scorer.compute_scores(triples)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = getattr(op, pre + "launches") if op else 0
    project_launches = staircase2.basis_direction.project_launches
    products = getattr(staircase2.basis_direction, pre + "project_launches")
    split_launches = staircase2.basis_direction.split_launches
    pads = staircase2.basis_direction.bf16_pad_launches
    fixups = fixup_counts()
    fixup_launches = sum(fixups.values())
    route_counts = route_launches()
    peak = torch.cuda.max_memory_allocated()
    check_helper_launches(op, launches, 0, project_launches, split_launches,
                          fixups)
    check_other_precision_idle(bf16)
    if staircase2.launch_counts() != (launches, 0):
        raise AssertionError(f"an encode for serving ran a twin pass or "
                             f"another op: {staircase2.launch_counts()}")
    want = 2 * cfg.encoder.n_layers if op else 0
    if launches != want:
        raise AssertionError(f"{op_name(op)} launched {launches} times in "
                             f"one encode, expected {want}")
    if products != (launches if op is staircase2.basis_direction else 0):
        raise AssertionError(f"basis_project launched {products} "
                             f"times for {launches} combine launches")

    codes = encoded.entity_codes
    if codes.shape != (ds.n_entities, cfg.encoder.code_dimension) \
            or not torch.isfinite(codes).all():
        raise AssertionError(f"codes {tuple(codes.shape)} not finite or "
                             f"not [V, d]")
    # The same encode through the plain path on the CPU.
    ref_view = build.ModelView(build.build_model(cfg, torch.device("cpu")))
    cpu_params = map_tree(lambda t: t.cpu(), params)
    cpu_graph = None if graph is None else graph.to("cpu")
    ref = ref_view.encoded(cpu_params, cpu_graph).entity_codes
    codes_err = (codes.cpu() - ref).abs().max().item()
    # The stored variant sums its test-mode messages with unit weights
    # (rows of up to 9,155 edges, twice): its codes grow to thousands and
    # an entry near 0 is a cancellation of terms that large, so its atol
    # is 1e-4 of the largest code; every other model's is 1e-4.
    scale = ref.abs().max().item() if model.has_state else 1.0
    codes_rel = rel_l2(codes.cpu(), ref)
    if bf16:
        if not codes_rel <= 1e-3:
            raise AssertionError(f"bf16 codes differ from the CPU plain "
                                 f"path's by {codes_rel} (relative L2)")
    else:
        torch.testing.assert_close(codes.cpu(), ref, rtol=1e-4,
                                   atol=1e-4 * scale)
    scorer.register_model(ref_view, cpu_params, cpu_graph,
                          n_entities=ds.n_entities)
    ref_summary = scorer.compute_scores(triples)
    mrr_diff = abs(ref_summary.results["Filtered"]["MRR"]
                   - summary.results["Filtered"]["MRR"])
    if mrr_diff > 1e-3:
        raise AssertionError(f"filtered MRR differs from the CPU plain "
                             f"path by {mrr_diff}")
    vs_f32 = {}
    if bf16:
        f32_view = build.ModelView(build.build_model(float32_config(cfg),
                                                     device))
        f32_codes = f32_view.encoded(params, graph).entity_codes
        scorer.register_model(f32_view, params, graph,
                              n_entities=ds.n_entities)
        vs_f32 = {"codes_rel_l2_vs_f32": rel_l2(codes, f32_codes),
                  "mrr_filtered_f32": scorer.compute_scores(triples)
                  .results["Filtered"]["MRR"]}
        if not vs_f32["codes_rel_l2_vs_f32"] <= 2e-2:
            raise AssertionError(f"bf16 codes differ from the f32 encode "
                                 f"by {vs_f32['codes_rel_l2_vs_f32']}")
        del f32_view, f32_codes

    # -- warm timings, outside the counted run ---------------------------
    def encode_again():
        view.invalidate()
        view.encoded(params, graph)
    encode_ms_warm = cuda_ms(encode_again, 5, warmup=1)
    by_route = {"encode_ms_warm_by_route": route_times(
        lambda: cuda_ms(encode_again, 5, warmup=1), OP_ROUTES[op.__name__])
        } if compare_routes else {}
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
    mlp = mlp_scoring(view, params, graph, chunk) \
        if isinstance(model.decoder, decoders.NonlinearTransform) else None

    res = summary.results
    row = {"triples": len(triples), "chunks": n_chunks,
           "graph_build_s": graph_s,
           "encode_ms": (t1 - t0) * 1e3, "encode_ms_warm": encode_ms_warm,
           **by_route,
           "chunk_ms": (t2 - t1) * 1e3 / n_chunks,
           "chunk_ms_warm": chunk_ms_warm,
           "chunk_score_ms": score_ms, "chunk_rank_ms": rank_ms,
           "chunk_pad_known_host_ms": pad_known_ms,
           "mrr_raw": res["Raw"]["MRR"], "mrr_filtered": res["Filtered"]["MRR"],
           "hits10_raw": res["Raw"]["H@10"],
           "hits10_filtered": res["Filtered"]["H@10"],
           "codes_max_abs_err_vs_cpu_plain": codes_err,
           "codes_rel_l2_vs_cpu_plain": codes_rel,
           "codes_max_abs": ref.abs().max().item(),
           "mrr_filtered_cpu_plain": ref_summary.results["Filtered"]["MRR"],
           **vs_f32, "precision": "bfloat16" if bf16 else "float32",
           "max_memory_allocated": peak,
           "launches": launches, "project_launches": products,
           "split_launches": split_launches,
           "pad_launches": pads, "fixup_launches": fixup_launches,
           **route_counts}
    if mlp is not None:
        row["mlp_scoring"] = mlp
    emit(phase, model=model_label(cfg),
         phase_s=time.perf_counter() - t_phase, **row)
    return row


def mlp_scoring(view, params, graph, chunk) -> dict:
    """The MLP decoder's all-entity scoring of one object-side chunk
    (CUDA events), with its [rows, V, D] hidden activations in blocks of
    1 and 8 rows and of the default budget's rows, beside its bound: read
    the codes, weights and the chunk's ids, write the [N, V] energies,
    against the operations (the candidate GEMM [V, k] x [k, D], the two
    [N, k] x [k, D] GEMMs of the fixed part, and per hidden entry an add,
    a max and a multiply-add) at the f32 rate; and the bytes the plain
    form's temporaries move (written by the add, read and written by the
    ReLU, read by the product)."""
    dec = view.model.decoder
    n, v, d, k = len(chunk), view.model.n_entities, dec.dimension, \
        dec.embedding_width
    per_row = 4 * v * d
    default = dec.score_budget_bytes
    by_rows = {}
    try:
        for rows in (1, 8, max(1, default // per_row)):
            dec.score_budget_bytes = rows * per_row
            by_rows[str(rows)] = cuda_ms(lambda: view.score_all_objects(
                params, graph, chunk, apply_sigmoid=False), 3, warmup=1)
    finally:
        dec.score_budget_bytes = default
    n_bytes = 4 * (v * k + 3 * k * d + 2 * d + 1 + 2 * n + n * v)
    ops = 2 * v * k * d + 4 * n * k * d + 4 * n * v * d
    return {"chunk": n, "hidden_entries": n * v * d,
            "default_rows": max(1, default // per_row),
            "ms_by_rows": by_rows, **least_time(n_bytes, ops),
            "temporaries_bytes": 4 * 4 * n * v * d}


def first_batch_graph(cfg, ds, device):
    """The graph of the first training batch at seed 0 (what TrainLoop's
    first step sees)."""
    model = build.build_model(cfg, device)
    return engine.BatchPipeline(model, cfg, ds,
                                np.random.default_rng(0)).next().graph.to(
                                    device)


def dblocks_index_add(features, g, blocks_shape, layout):
    """d blocks as the port summed them before its sums by relation ran on
    kernel 3: each chunk's products added into their relation with
    ``index_add_`` (atomics on the card), timed beside the sorted form."""
    n_rel, n_blocks, dr, _ = blocks_shape
    targets = staircase.row_of_entry(layout)
    dw = torch.zeros(n_rel, n_blocks, dr, dr, device=features.device)
    for start in range(0, layout.n_edges, staircase2._EDGE_CHUNK):
        sl = slice(start, start + staircase2._EDGE_CHUNK)
        gw = (g[targets[sl]] * layout.w[sl, None]).view(-1, n_blocks, dr)
        x = features[layout.src[sl].long()].view(-1, n_blocks, dr)
        dw.index_add_(0, layout.rel[sl].long(),
                      torch.einsum("ebi,ebj->ebij", gw, x))
    return dw


def dc_index_add(proj, g, coefficients, layout):
    """d C as the port summed it before (``index_add_`` into the
    relations), for its time beside the sorted form."""
    n_bases = coefficients.shape[1]
    targets = staircase.row_of_entry(layout)
    dc = torch.zeros_like(coefficients)
    for start in range(0, layout.n_edges, staircase2._EDGE_CHUNK):
        sl = slice(start, start + staircase2._EDGE_CHUNK)
        src = layout.src[sl].long()
        gw = g[targets[sl]] * layout.w[sl, None]
        dots = torch.bmm(proj[src].view(-1, n_bases, g.shape[1]),
                         gw[:, :, None]).squeeze(-1)
        dc.index_add_(0, layout.rel[sl].long(), dots)
    return dc


def twice_same(fn) -> bool:
    """Two calls of ``fn`` give the same bits."""
    a, b = fn(), fn()
    torch.cuda.synchronize()
    return torch.equal(a, b)


def sum_by_csr_timings(features, g, layout, n_rel, n_blocks, dr) -> dict:
    """Kernel 3 as sum_by_csr runs it for d blocks, on the first chunk of
    ``layout``'s edges: the per-edge products [chunk, B*dr*dr] summed by
    relation, held to a float64 index_add_ within sum_allowance, two calls
    bit for bit; device times of the kernel and its carry fix-up
    (profiler), CUDA-event times of the call (CSR given), of the sort and
    CSR, of the plain version and of index_add_ (the library call), and
    the bound: the products, the permutation, row_ptr and the sums each
    moved once, one add a product element."""
    n = min(layout.n_edges, staircase2._EDGE_CHUNK)
    targets = staircase.row_of_entry(layout)[:n]
    gw = (g[targets] * layout.w[:n, None]).view(-1, n_blocks, dr)
    x = features[layout.src[:n].long()].view(-1, n_blocks, dr)
    values = torch.einsum("ebi,ebj->ebij", gw, x).reshape(n, -1)
    rel = layout.rel[:n]
    sum_by_csr = sum_by_csr_op()
    from relationprediction_torch.ops.gather import id_csr
    csr = id_csr(rel, n_rel)
    got = sum_by_csr(values, *csr, n_rel)
    if not twice_same(lambda: sum_by_csr(values, *csr, n_rel)):
        raise AssertionError("sum_by_csr: two calls differ")
    exact = torch.zeros(n_rel, values.shape[1], dtype=torch.float64,
                        device=values.device).index_add_(
                            0, rel.long(), values.double())
    abs_sum = torch.zeros_like(exact).index_add_(0, rel.long(),
                                                 values.double().abs())
    counts = torch.bincount(rel.long(), minlength=n_rel)[:, None]
    over = over_allowance(got, exact, sum_allowance(exact, abs_sum, counts))
    if not over <= 1:
        raise AssertionError(f"sum_by_csr: {over} of the allowance")
    w = values.shape[1]
    dev = device_ms(lambda: sum_by_csr(values, *csr, n_rel),
                    ("merge_path_kernel", "carry_fixup"))
    return {"sum_entries": n, "sum_width": w,
            "sum_max_abs_err": (got.double() - exact).abs().max().item(),
            "sum_over_allowance": over, "sum_same_bits_twice": True,
            "sum_ms": cuda_ms(lambda: sum_by_csr(values, *csr, n_rel), 20),
            "sum_kernel_device_ms": dev.get("merge_path_kernel"),
            "sum_fixup_device_ms": dev.get("carry_fixup"),
            "sum_csr_ms": cuda_ms(lambda: id_csr(rel, n_rel), 20),
            "sum_plain_ms": cuda_ms(
                lambda: staircase.staircase_aggregate_reference(
                    values, CsrLayout(csr[0], csr[1].int(), csr[1].int(),
                                      layout.w[:n]),
                    n_rel, csr[1].int(), weighted=False), 5),
            "sum_library_ms": cuda_ms(lambda: torch.zeros(
                n_rel, w, device=values.device).index_add_(
                    0, rel.long(), values), 20),
            **{f"sum_{k}": v for k, v in least_time(
                4 * (n * w + n + n_rel + 1 + n_rel * w), n * w).items()}}


def phase_grad(graphs, n_rel, n_blocks, dr, device):
    """block_direction's gradient against autograd through the plain
    version, and each kernel pass against its plain version, the plain
    version run in float64 on the same float32 inputs. The forward is held
    within rtol=1e-4, atol=1e-5 and d blocks within a tolerance scaled to
    its entries. d features and the twin pass are held to
    twin_sum_allowance: a twin row sums up to ~9k terms whose weights are
    not 1/degree of that row, so its f32 partial sums reach tens while the
    result may be near 0. The twin pass on the wrong twin (the opposite
    direction's CSR: the same edges with the other weights) must fail that
    allowance; its carry rows equal merge_path_carry_rows and two launches
    give the same bits. Plain times are those of the float32 plain
    version; the twin pass is timed as block_timings times the forward."""
    t_phase = time.perf_counter()
    lib, _ = staircase2.kernel_library()
    rows = []
    for graph_name, graph in graphs.items():
        v = graph.n_vertices
        gen = torch.Generator().manual_seed(2)
        x = torch.randn(v, n_blocks * dr, generator=gen).to(device)
        w = torch.randn(n_rel, n_blocks, dr, dr, generator=gen).to(device)
        probe = torch.randn(v, n_blocks * dr, generator=gen).to(device)
        w_t = w.transpose(-1, -2)
        for name, layout, twin, wrong_twin in (
                ("forward", graph.fwd, graph.fwd_twin, graph.bwd),
                ("backward", graph.bwd, graph.bwd_twin, graph.fwd)):
            xf = x.clone().requires_grad_(True)
            wf = w.clone().requires_grad_(True)
            out = staircase2.block_direction(xf, wf, layout, v, twin)
            gx, gw = torch.autograd.grad((out * probe).sum(), (xf, wf))
            w64 = w.double().requires_grad_(True)
            out_ref = staircase2.block_direction_reference(
                x.double(), w64, layout, v)
            gw_ref = torch.autograd.grad((out_ref * probe.double()).sum(),
                                         w64)[0].float()
            out_ref = out_ref.detach().float()
            gx_ref, allowance = twin_sum_allowance(probe, w, layout, v)
            twin_out = repeatable(
                "block_direction_twin", lambda c: staircase2.launch(
                    lib, probe, w, twin, v, twin=True, carries=c),
                twin.row_ptr,
                staircase.block_direction_items(v, twin.n_edges))
            wrong_out = staircase2.launch(lib, probe, w, wrong_twin, v,
                                          twin=True)
            xr = x.clone().requires_grad_(True)
            wr = w.clone().requires_grad_(True)
            ref_loss = (staircase2.block_direction_reference(
                xr, wr, layout, v) * probe).sum()
            torch.cuda.synchronize()
            for t in (out, gx, gw, twin_out):
                if not torch.isfinite(t).all():
                    raise AssertionError(f"{graph_name}/{name}: output or "
                                         f"gradient not finite")
            torch.testing.assert_close(out.detach(), out_ref, rtol=1e-4,
                                       atol=1e-5)
            gx_over = over_allowance(gx, gx_ref, allowance)
            twin_over = over_allowance(twin_out, gx_ref, allowance)
            wrong_over = over_allowance(wrong_out, gx_ref, allowance)
            if not (gx_over <= 1 and twin_over <= 1):
                raise AssertionError(
                    f"{graph_name}/{name}: d features or the twin pass "
                    f"beyond the f32 rounding allowance ({gx_over}, "
                    f"{twin_over} of it)")
            if not wrong_over > 1:
                raise AssertionError(
                    f"{graph_name}/{name}: the wrong twin passes the "
                    f"allowance ({wrong_over} of it)")
            fixed = 1e-5 + 1e-4 * gx_ref.abs()
            twin_err = (twin_out.double() - gx_ref).abs()
            # d blocks sums w * g * x over every edge of a relation (up to
            # ~44k edges here) in float32: its rounding grows
            # as ~sqrt(edges) ulps of the entries' scale, so the tolerance
            # is relative to that scale.
            gw_scale = gw_ref.abs().max().item()
            torch.testing.assert_close(gw, gw_ref, rtol=1e-4,
                                       atol=1e-4 * gw_scale)
            dblocks_ms = cuda_ms(lambda: staircase2.block_direction_dblocks(
                x, probe, w.shape, layout), 10)
            if not twice_same(lambda: staircase2.block_direction_dblocks(
                    x, probe, w.shape, layout)):
                raise AssertionError(f"{graph_name}/{name}: two d blocks "
                                     f"calls differ")
            index_add_same = twice_same(
                lambda: dblocks_index_add(x, probe, w.shape, layout))
            dblocks_index_add_ms = cuda_ms(lambda: dblocks_index_add(
                x, probe, w.shape, layout), 10)
            twin_plain_ms = cuda_ms(
                lambda: staircase2.block_direction_reference(
                    probe, w_t, twin, v), 3, warmup=1)
            plain_backward_ms = cuda_ms(lambda: torch.autograd.grad(
                ref_loss, (xr, wr), retain_graph=True), 3, warmup=1)
            row = {"graph": graph_name, "direction": name,
                   "edges": layout.n_edges,
                   "forward_max_abs_err":
                       (out.detach() - out_ref).abs().max().item(),
                   "dfeatures_max_abs_err":
                       (gx.double() - gx_ref).abs().max().item(),
                   "dfeatures_over_allowance": gx_over,
                   "dblocks_max_abs_err": (gw - gw_ref).abs().max().item(),
                   "dblocks_max_abs": gw_scale,
                   "twin_max_abs_err": twin_err.max().item(),
                   "twin_over_allowance": twin_over,
                   "twin_beyond_rtol1e-4_atol1e-5":
                       int((twin_err > fixed).sum().item()),
                   "wrong_twin_over_allowance": wrong_over,
                   "twin_same_bits_twice": True,
                   "twin_plain_ms": twin_plain_ms,
                   "dblocks_ms": dblocks_ms,
                   "dblocks_same_bits_twice": True,
                   "dblocks_index_add_ms": dblocks_index_add_ms,
                   "dblocks_index_add_same_bits_twice": index_add_same,
                   **sum_by_csr_timings(x, probe, layout, n_rel, n_blocks,
                                        dr),
                   "dblocks_bound_ms": dblocks_bound(
                       layout, v, n_rel, n_blocks, dr)["bound_ms"],
                   "plain_backward_ms": plain_backward_ms,
                   **{f"twin_{k}": val for k, val in block_timings(
                       lib, probe, w, twin, v, n_rel, twin=True).items()}}
            emit("grad", phase_s=time.perf_counter() - t_phase, **row)
            rows.append(row)
    return rows


def split_matches_plain(xs, ws, a, b) -> bool:
    """The split pass's parts equal tf32_split_reference bit for bit: xs
    [parts, M, Kp] of a [M, K], ws [parts, N, Kp] of b [K, N] transposed,
    the padding columns zero."""
    k = a.shape[1]
    for got, plain in ((xs, a), (ws, b.t())):
        want = torch.stack(staircase2.tf32_split_reference(plain,
                                                           xs.shape[0]))
        if not (torch.equal(got[:, :, :k].contiguous().view(torch.int32),
                            want.contiguous().view(torch.int32))
                and not got[:, :, k:].any()):
            return False
    return True


def project_checks(plib, name, a, b) -> dict:
    """basis_project (split pass + 3xTF32 product) at one shape: within
    project_exact's allowance, the split equal to its plain version bit for
    bit, two launches equal bit for bit; TF32 torch.matmul held to the same
    allowance as the control (reported; the caller requires it to fail at
    the main path's shapes). Times of the whole, of the split and the
    product apart, of the plain version and of torch.matmul."""
    got = staircase2.launch_project(plib, a, b)
    again = staircase2.launch_project(plib, a, b)
    xs, ws = staircase2.launch_split(plib, a, b)
    exact, allowance = project_exact(a, b)
    torch.backends.cuda.matmul.allow_tf32 = True
    tf32 = torch.matmul(a, b)
    tf32_ms = cuda_ms(lambda: torch.matmul(a, b), 20)
    exact_float32()
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise AssertionError(f"basis_project {name}: not finite")
    over = over_allowance(got, exact, allowance)
    if not over <= 1:
        raise AssertionError(f"basis_project {name}: {over} of the f32 "
                             f"rounding allowance")
    if not torch.equal(got.view(torch.int32), again.view(torch.int32)):
        raise AssertionError(f"basis_project {name}: two launches differ")
    if not split_matches_plain(xs, ws, a, b):
        raise AssertionError(f"basis_project {name}: the split pass differs "
                             f"from tf32_split_reference")
    (m, k), n = a.shape, b.shape[1]
    kp = xs.shape[2]
    return {"kernel": "basis_project", "shape": name, "m": m, "k": k,
            "n": n, "kp": kp,
            "max_abs_err": (got.double() - exact).abs().max().item(),
            "over_allowance": over, "same_bits_twice": True,
            "split_equals_plain": True,
            "tf32_matmul_over_allowance": over_allowance(tf32, exact,
                                                         allowance),
            "kernel_ms": cuda_ms(
                lambda: staircase2.launch_project(plib, a, b), 20),
            "split_ms": cuda_ms(
                lambda: staircase2.launch_split(plib, a, b), 20),
            "product_ms": cuda_ms(
                lambda: staircase2.launch_product(plib, xs, ws), 20),
            "parts": xs.shape[0],
            "split_plain_ms": cuda_ms(
                lambda: (staircase2.tf32_split_reference(a, xs.shape[0]),
                         staircase2.tf32_split_reference(b.t(),
                                                         xs.shape[0])), 5),
            "plain_ms": cuda_ms(
                lambda: staircase2.basis_project_reference(a, b), 20),
            "library_ms": cuda_ms(lambda: torch.matmul(a, b), 20),
            "library_tf32_ms": tf32_ms,
            "split_bound_ms": split_bound(m, k, n, kp, xs.shape[0])[
                "bound_ms"],
            **project_bound(m, k, n)}


def phase_kernel_basis(graphs, n_rel, n_bases, d, device):
    """basis_project against a float64 product at the forward and twin
    shapes and two odd shapes (project_checks; TF32 torch.matmul must fail
    the allowance at the forward and twin shapes); basis_combine and the
    twin pass (project g by w_t, combine on the twin CSR) against float64
    sums in both directions of each graph; the twin pass on the wrong twin
    (the opposite CSR) must fail its allowance; basis_combine's carry rows
    equal merge_path_carry_rows and two launches give the same bits. Times
    of each kernel, of its plain version and of one PyTorch call for the
    same function (torch.matmul, TF32 off, for basis_project;
    torch.sparse.mm of combine_matrix for basis_combine), with the bounds;
    hub rows and the others timed apart, and basis_combine at every item
    count of SWEEP_ITEMS. Then combine_layouts. Launches here go through
    launch_project / launch_combine and count nowhere."""
    t_phase = time.perf_counter()
    lib, _ = staircase2.basis_kernel_library()
    plib, _ = staircase2.project_kernel_library()
    gen = torch.Generator().manual_seed(3)
    v = next(iter(graphs.values())).n_vertices
    x = torch.randn(v, d, generator=gen).to(device)
    w_flat = torch.randn(d, n_bases * d, generator=gen).to(device)
    w_t = staircase2.basis_twin_weights(w_flat, n_bases)
    probe = torch.randn(v, d, generator=gen).to(device)
    coef = torch.randn(n_rel, n_bases, generator=gen).to(device)

    rows = []
    operands = {"forward": (x, w_flat), "twin": (probe, w_t)}
    for m, k, n in ((1, 1, 7), (129, 33, 65)):
        operands[f"odd_{m}x{k}x{n}"] = (
            torch.randn(m, k, generator=gen).to(device),
            torch.randn(k, n, generator=gen).to(device))
    for name, (a, b) in operands.items():
        row = project_checks(plib, name, a, b)
        if name in ("forward", "twin") \
                and not row["tf32_matmul_over_allowance"] > 1:
            raise AssertionError(f"basis_project {name}: TF32 matmul passes "
                                 f"the allowance, which then cannot tell "
                                 f"3xTF32 from TF32")
        emit("kernel_basis", phase_s=time.perf_counter() - t_phase, **row)
        rows.append(row)

    proj = staircase2.launch_project(plib, x, w_flat)
    q = staircase2.launch_project(plib, probe, w_t)
    for graph_name, graph in graphs.items():
        for name, layout, twin, wrong in (
                ("forward", graph.fwd, graph.fwd_twin, graph.bwd),
                ("backward", graph.bwd, graph.bwd_twin, graph.fwd)):
            got, twin_out = (repeatable(
                "basis_combine", lambda c: staircase2.launch_combine(
                    lib, p, coef, lay, v, carries=c), lay.row_ptr,
                staircase.basis_combine_items(v, lay.n_edges))
                for p, lay in ((proj, layout), (q, twin)))
            wrong_out = staircase2.launch_combine(lib, q, coef, wrong, v)
            exact, allowance = combine_exact(proj, coef, layout, v)
            _, _, dx, dx_allowance = basis_exact(x, w_flat, coef, layout, v,
                                                 probe)
            torch.cuda.synchronize()
            for t in (got, twin_out):
                if not torch.isfinite(t).all():
                    raise AssertionError(f"basis_combine {graph_name}/"
                                         f"{name}: not finite")
            over = over_allowance(got, exact, allowance)
            twin_over = over_allowance(twin_out, dx, dx_allowance)
            wrong_over = over_allowance(wrong_out, dx, dx_allowance)
            if not (over <= 1 and twin_over <= 1):
                raise AssertionError(
                    f"basis_combine {graph_name}/{name}: forward or twin "
                    f"pass beyond the f32 rounding allowance ({over}, "
                    f"{twin_over} of it)")
            if not wrong_over > 1:
                raise AssertionError(
                    f"basis_combine {graph_name}/{name}: the wrong twin "
                    f"passes the allowance ({wrong_over} of it)")
            row = {"kernel": "basis_combine", "graph": graph_name,
                   "direction": name, "edges": layout.n_edges,
                   "max_abs_err": (got.double() - exact).abs().max().item(),
                   "over_allowance": over,
                   "twin_max_abs_err": (twin_out.double() - dx).abs().max()
                   .item(),
                   "twin_over_allowance": twin_over,
                   "wrong_twin_over_allowance": wrong_over,
                   "same_bits_twice": True}
            for part, lay, p, want in (("", layout, proj, exact),
                                       ("twin_", twin, q, dx)):
                hubs, rest = split_rows(lay, HUB_ROW)
                lengths = lay.row_ptr.diff()
                b = combine_bound(lay, v, n_bases, d)
                matrix = combine_matrix(coef, lay, v, v)
                merged = combine_matrix(coef, lay, v, v, coalesced=True)
                p_rows = p.view(-1, d)
                row.update({
                    f"{part}library_ms": cuda_ms(
                        lambda: torch.sparse.mm(matrix, p_rows), 20),
                    f"{part}library_max_abs_err": (
                        torch.sparse.mm(matrix, p_rows).double() - want)
                    .abs().max().item(),
                    f"{part}library_coalesced_ms": cuda_ms(
                        lambda: torch.sparse.mm(merged, p_rows), 20),
                    f"{part}library_coalesced_max_abs_err": (
                        torch.sparse.mm(merged, p_rows).double() - want)
                    .abs().max().item(),
                    f"{part}library_nnz": matrix.values().numel(),
                    f"{part}library_coalesced_nnz": merged.values().numel(),
                    f"{part}items": staircase.basis_combine_items(
                        v, lay.n_edges),
                    f"{part}items_sweep_ms": {str(items): cuda_ms(
                        lambda: staircase2.launch_combine(
                            lib, p, coef, lay, v, items=items), 20)
                        for items in SWEEP_ITEMS},
                    f"{part}kernel_ms": cuda_ms(
                        lambda: staircase2.launch_combine(lib, p, coef, lay,
                                                          v), 20),
                    f"{part}plain_ms": cuda_ms(
                        lambda: staircase2.basis_combine_reference(
                            p, coef, lay, v), 3, warmup=1),
                    f"{part}hub_rows_only_ms": cuda_ms(
                        lambda: staircase2.launch_combine(lib, p, coef, hubs,
                                                          v), 10),
                    f"{part}other_rows_only_ms": cuda_ms(
                        lambda: staircase2.launch_combine(lib, p, coef, rest,
                                                          v), 10),
                    f"{part}rows_over_{HUB_ROW}": int(
                        (lengths > HUB_ROW).sum().item()),
                    f"{part}largest_row": int(lengths.max().item()),
                    f"{part}empty_rows": int((lengths == 0).sum().item()),
                    f"{part}bound_ms": b["bound_ms"],
                    f"{part}bound_by": b["bound_by"],
                    f"{part}bytes": b["bytes"],
                    f"{part}gathered_rows": b["gathered_rows"]})
            # The whole twin pass as the backward runs it: project g by
            # w_t, then combine on the twin CSR.
            row["twin_pass_ms"] = cuda_ms(
                lambda: staircase2.launch_combine(
                    lib, staircase2.launch_project(plib, probe, w_t), coef,
                    twin, v), 20)
            emit("kernel_basis", phase_s=time.perf_counter() - t_phase,
                 **row)
            rows.append(row)
    for row in combine_layouts(lib, graphs, n_rel, device):
        emit("kernel_basis", phase_s=time.perf_counter() - t_phase, **row)
        rows.append(row)
    return rows


def combine_matrix(coef, layout, n_rows, n_src, coalesced=False):
    """basis_combine as one sparse matrix, the library's form of it:
    [n_rows, n_src * B] CSR with entry (row of e, src_e * B + b) = w_e *
    C[r_e, b]; times P viewed as [n_src * B, d_out] it gives the combine's
    output. E * B entries, columns ascending within a row, an edge that
    repeats a (target, source) pair kept apart: the kernel's work. With
    ``coalesced`` such entries are summed into one (10.6 % fewer on the
    full graph), work the kernel does not skip."""
    n_bases = coef.shape[1]
    rows = staircase.row_of_entry(layout).repeat_interleave(n_bases)
    cols = (layout.src.long()[:, None] * n_bases
            + torch.arange(n_bases, device=coef.device)).reshape(-1)
    vals = (layout.w[:, None] * coef[layout.rel.long()]).reshape(-1)
    size = (n_rows, n_src * n_bases)
    if coalesced:
        return torch.sparse_coo_tensor(torch.stack([rows, cols]), vals,
                                       size).coalesce().to_sparse_csr()
    order = torch.argsort(rows * size[1] + cols, stable=True)
    return torch.sparse_csr_tensor(layout.row_ptr.long() * n_bases,
                                   cols[order], vals[order], size)


def staircase_repeatable(lib, msgs, layout, v, perm=None):
    """repeatable() for staircase_aggregate_f32 at its items rule."""
    return repeatable(
        "staircase", lambda c: staircase.launch(lib, msgs, layout, v, perm,
                                                carries=c),
        layout.row_ptr, staircase.merge_path_items(v, layout.n_edges))


def csr_of_counts(counts, gen, device, n_src=1, n_rel=1):
    """A layout with ``counts[v]`` entries in row v: weights in [0.1, 1.1),
    src uniform over [0, n_src), rel uniform over [0, n_rel) and ascending
    within each row (0 where n_src or n_rel is 1)."""
    counts = torch.as_tensor(counts)
    row_ptr = torch.zeros(len(counts) + 1, dtype=torch.int64)
    row_ptr[1:] = torch.cumsum(counts, 0)
    e = int(row_ptr[-1])
    w = torch.rand(e, generator=gen) + 0.1
    src = (torch.randint(n_src, (e,), generator=gen) if n_src > 1
           else torch.zeros(e, dtype=torch.int64))
    rel = torch.zeros(e, dtype=torch.int64)
    if n_rel > 1:
        rows = torch.repeat_interleave(torch.arange(len(counts)), counts)
        rel = torch.randint(n_rel, (e,), generator=gen)
        rel = rel[torch.argsort(rows * n_rel + rel, stable=True)]
    return CsrLayout(row_ptr=row_ptr.to(torch.int32),
                     src=src.to(torch.int32), rel=rel.to(torch.int32),
                     w=w).to(device)


def stress_counts(graphs) -> dict:
    """Row lengths over the full graph's 14,541 rows that stress the
    merge-path partition: one hub row of 9,155 entries (FB15k-237's
    largest), every entry of the full graph (272,115) in the last row
    (blocks holding only row ends, then ~1,000 carrying one row), no
    entries at all, rows of one entry."""
    full = graphs["full_train"]
    v = full.n_vertices
    hub = [0] * v
    hub[v // 2] = 9155
    last = [0] * v
    last[-1] = full.fwd.n_edges
    return {"hub_9155": hub, "one_row_holds_every_entry": last,
            "no_entries": [0] * v, "rows_of_one_entry": [1] * v}


def partition_row(layout, v, items) -> dict:
    """The partition a stress layout gets: items, blocks, carrying
    blocks."""
    return {"edges": layout.n_edges, "items": items,
            "blocks": staircase.merge_path_blocks(v, layout.n_edges, items),
            "carrying_blocks": int((staircase.merge_path_carry_rows(
                layout.row_ptr, items) >= 0).sum())}


def staircase_layouts(lib, graphs, d, device) -> list:
    """staircase_aggregate_f32 on the layouts of stress_counts, the hub
    also on the perm path, and the training batch's layout at d = 37 (the
    scalar path), each within the rounding allowance of a float64 sum,
    with carry rows equal to merge_path_carry_rows and two launches equal
    bit for bit."""
    gen = torch.Generator().manual_seed(6)
    v = graphs["full_train"].n_vertices
    counts = stress_counts(graphs)
    cases = {name: (csr_of_counts(c, gen, device), d, False)
             for name, c in counts.items()}
    cases["hub_9155_perm"] = (csr_of_counts(counts["hub_9155"], gen, device),
                              d, True)
    cases["train_batch_d37"] = (graphs["train_batch"].fwd, 37, False)
    rows = []
    for name, (layout, width, use_perm) in cases.items():
        e = layout.n_edges
        msgs = torch.randn(e, width, generator=gen).to(device)
        perm = (torch.randperm(e, generator=gen).to(torch.int32).to(device)
                if use_perm else None)
        got = staircase_repeatable(lib, msgs, layout, v, perm)
        exact, allowance = staircase_exact(msgs, layout, v, perm)
        torch.cuda.synchronize()
        over = over_allowance(got, exact, allowance)
        if not (torch.isfinite(got).all() and over <= 1):
            raise AssertionError(f"staircase layout {name}: {over} of the "
                                 f"f32 rounding allowance")
        rows.append({"kernel": "staircase_aggregate", "layout": name,
                     "d": width, "perm": use_perm,
                     **partition_row(layout, v,
                                     staircase.merge_path_items(v, e)),
                     "over_allowance": over, "same_bits_twice": True,
                     "kernel_ms": cuda_ms(lambda: staircase.launch(
                         lib, msgs, layout, v, perm), 10),
                     **staircase_bound(layout, v, width,
                                       perm=use_perm)})
    return rows


def compgcn_sums(ds, device) -> list:
    """Kernel 3 at the shapes of the 1-N CompGCN step
    (settings/compgcn_conve.exp), on the CompGCN graph of the full train
    graph and with no training: staircase_aggregate's weighted sum of each
    half into the entities at d = 200, and take_rows' gradient summed by id
    over the graph's CSRs (ops/gather.add_by_id through sum_by_csr) into
    the 2R relation rows (one id's run up to ~19k entries) and into the
    entity rows at d = 100. Each within the rounding allowance of a float64
    sum, index_add_ (the library call) held to the same allowance, one
    kernel launch and one carry fix-up a call, counted on the op's
    counters, and two calls bit for bit. Imported here, as
    sum_by_csr_op."""
    from relationprediction_torch.graph import build_compgcn_graph
    from relationprediction_torch.ops.gather import take_rows
    t_phase = time.perf_counter()
    g = build_compgcn_graph(ds.train, ds.n_entities,
                            ds.n_relations).to(device)
    v = ds.n_entities
    gen = torch.Generator().manual_seed(8)
    rows = []

    def check(name, op, call, library, exact, allowance, entries):
        reset_launch_counts()
        got = call()
        launches = (op.launches, staircase.staircase_aggregate.fixup_launches)
        if not twice_same(call):
            raise AssertionError(f"compgcn {name}: two calls differ")
        lib_out = library()
        torch.cuda.synchronize()
        over = over_allowance(got, exact, allowance)
        lib_over = over_allowance(lib_out, exact, allowance)
        if not (torch.isfinite(got).all() and over <= 1 and lib_over <= 1):
            raise AssertionError(f"compgcn {name}: {over} (kernel), "
                                 f"{lib_over} (index_add_) of the f32 "
                                 f"rounding allowance")
        if launches != (1, 1):
            raise AssertionError(f"compgcn {name}: {launches} launches and "
                                 f"fix-ups in one call, expected (1, 1)")
        row = {"kernel": op.__name__, "compgcn": name, "entries": entries,
               "rows": exact.shape[0], "d": exact.shape[1],
               "over_allowance": over, "library_over_allowance": lib_over,
               "max_abs_diff_vs_library": (got - lib_out).abs().max().item(),
               "launches": launches[0], "fixup_launches": launches[1],
               "same_bits_twice": True}
        emit("kernel_staircase", phase_s=time.perf_counter() - t_phase,
             **row)
        rows.append(row)

    for name, layout in (("inward", g.inward), ("outward", g.outward)):
        msgs = torch.randn(layout.n_edges, 200, generator=gen).to(device)
        targets = staircase.row_of_entry(layout).long()
        check(f"{name}_d200", staircase.staircase_aggregate,
              lambda: staircase.staircase_aggregate(msgs, layout, v),
              lambda: torch.zeros(v, 200, device=device).index_add_(
                  0, targets, msgs * layout.w[:, None]),
              *staircase_exact(msgs, layout, v), layout.n_edges)
    for name, ids, csr, n_ids in (
            ("by_relation_d100", g.rel_ids, g.by_relation,
             2 * ds.n_relations),
            ("by_source_d100", g.src_ids, g.by_source, v)):
        table = torch.zeros(n_ids, 100, device=device, requires_grad=True)
        rows_g = torch.randn(ids.shape[0], 100, generator=gen).to(device)
        exact = torch.zeros(n_ids, 100, dtype=torch.float64,
                            device=device).index_add_(0, ids,
                                                      rows_g.double())
        abs_sum = torch.zeros_like(exact).index_add_(
            0, ids, rows_g.double().abs())
        counts = torch.bincount(ids, minlength=n_ids)[:, None]
        check(name, sum_by_csr_op(),
              lambda: torch.autograd.grad(take_rows(table, ids, csr), table,
                                          rows_g)[0],
              lambda: torch.zeros(n_ids, 100, device=device).index_add_(
                  0, ids, rows_g),
              exact, sum_allowance(exact, abs_sum, counts), ids.shape[0])
    return rows


def block_layouts(lib, graphs, n_rel, device) -> list:
    """block_direction_f32 and its twin entry point on the layouts of
    stress_counts at B = 100, dr = 5 (sources uniform over the rows,
    relations ascending within a row), on the hub as one relation run
    across ~18 blocks, and on the training batch's layout at dr = 1, 3, 8
    (B = 128, 42, 64); each within the rounding allowance of a float64
    sum, with carry rows equal to merge_path_carry_rows and two launches
    equal bit for bit."""
    gen = torch.Generator().manual_seed(7)
    v = graphs["full_train"].n_vertices
    counts = stress_counts(graphs)
    cases = {name: (csr_of_counts(c, gen, device, v, n_rel), 100, 5)
             for name, c in counts.items()}
    cases["one_run_9155"] = (csr_of_counts(counts["hub_9155"], gen, device,
                                           v), 100, 5)
    for n_blocks, dr in ((128, 1), (42, 3), (64, 8)):
        cases[f"train_batch_B{n_blocks}_dr{dr}"] = (
            graphs["train_batch"].fwd, n_blocks, dr)
    rows = []
    for name, (layout, n_blocks, dr) in cases.items():
        x = torch.randn(v, n_blocks * dr, generator=gen).to(device)
        w = torch.randn(n_rel, n_blocks, dr, dr, generator=gen).to(device)
        items = staircase.block_direction_items(v, layout.n_edges)
        for kernel, twin in (("block_direction", False),
                             ("block_direction_twin", True)):
            got = repeatable(f"{kernel} layout {name}",
                             lambda c: staircase2.launch(
                                 lib, x, w, layout, v, twin=twin,
                                 carries=c), layout.row_ptr, items)
            exact, allowance = block_exact(
                x, w.transpose(-1, -2) if twin else w, layout, v)
            torch.cuda.synchronize()
            over = over_allowance(got, exact, allowance)
            if not (torch.isfinite(got).all() and over <= 1):
                raise AssertionError(f"{kernel} layout {name}: {over} of "
                                     f"the f32 rounding allowance")
            bound = block_direction_bound(layout, v, n_rel, n_blocks, dr)
            rows.append({"kernel": kernel, "layout": name, "B": n_blocks,
                         "dr": dr, **partition_row(layout, v, items),
                         "runs": bound["runs"], "over_allowance": over,
                         "same_bits_twice": True,
                         "kernel_ms": cuda_ms(lambda: staircase2.launch(
                             lib, x, w, layout, v, twin=twin), 10),
                         "bound_ms": bound["bound_ms"]})
    return rows


def combine_layouts(lib, graphs, n_rel, device) -> list:
    """basis_combine_f32 (forward and twin pass are one entry point) on
    the layouts of stress_counts at B = 5, d_out = 500 (sources uniform
    over the rows, relations ascending within a row), and on the training
    batch's layout at B = 1 and 8 with d_out = 37 (the scalar path); each
    within the rounding allowance of a float64 sum, with carry rows equal
    to merge_path_carry_rows and two launches equal bit for bit."""
    gen = torch.Generator().manual_seed(8)
    v = graphs["full_train"].n_vertices
    cases = {name: (csr_of_counts(c, gen, device, v, n_rel), 5, 500)
             for name, c in stress_counts(graphs).items()}
    for n_bases in (1, 8):
        cases[f"train_batch_B{n_bases}_d37"] = (graphs["train_batch"].fwd,
                                                n_bases, 37)
    rows = []
    for name, (layout, n_bases, d_out) in cases.items():
        proj = torch.randn(v, n_bases * d_out, generator=gen).to(device)
        coef = torch.randn(n_rel, n_bases, generator=gen).to(device)
        items = staircase.basis_combine_items(v, layout.n_edges)
        got = repeatable(f"basis_combine layout {name}",
                         lambda c: staircase2.launch_combine(
                             lib, proj, coef, layout, v, carries=c),
                         layout.row_ptr, items)
        exact, allowance = combine_exact(proj, coef, layout, v)
        torch.cuda.synchronize()
        over = over_allowance(got, exact, allowance)
        if not (torch.isfinite(got).all() and over <= 1):
            raise AssertionError(f"basis_combine layout {name}: {over} of "
                                 f"the f32 rounding allowance")
        rows.append({"kernel": "basis_combine", "layout": name,
                     "B": n_bases, "d_out": d_out,
                     **partition_row(layout, v, items),
                     "over_allowance": over, "same_bits_twice": True,
                     "kernel_ms": cuda_ms(lambda: staircase2.launch_combine(
                         lib, proj, coef, layout, v), 10),
                     "bound_ms": combine_bound(layout, v, n_bases,
                                               d_out)["bound_ms"]})
    return rows


def energies_exact(codes, q_subj, q_obj, ids, coin, d_e, d_s) -> dict:
    """The direct form of the factored energies in float64 on the card
    (the single-factor form where ``q_obj`` is None), with each result's
    allowance: name -> (exact, allowance), the allowance gamma(m) *
    sum |terms| for the m terms the element's f32 sum adds (d for an
    energy or ev_sq, k for a factor's gradient, the id's entries and 2
    more for d codes), gamma(m) = m u / (1 - m u): the bound on any f32
    sum of m products in any order (Higham, 2002, eq. 3.5)."""
    def gamma(m):
        return m * F32_UNIT_ROUNDOFF / (1 - m * F32_UNIT_ROUNDOFF)
    c, ids = codes.detach().double(), ids.long()
    v, d = c.shape
    n, k = ids.shape
    ev = c[ids]
    qs = q_subj.detach().double()[:, None]
    q = qs.expand(n, k, d) if q_obj is None else torch.where(
        coin[:, :, None], q_obj.detach().double()[:, None], qs)
    prod = ev * q
    out = {"energy": (prod.sum(-1), gamma(d) * prod.abs().sum(-1))}
    del prod
    sq = ev * ev
    out["ev_sq"] = (sq.sum(-1), gamma(d) * sq.sum(-1))
    del sq
    flat = ids.reshape(-1)
    terms = (d_e.double()[:, :, None] * q).reshape(-1, d)
    del q
    first = c.new_zeros(v, d).index_add_(0, flat, terms)
    first_abs = c.new_zeros(v, d).index_add_(0, flat, terms.abs())
    del terms
    s2 = 2 * d_s.double().reshape(-1)
    scale = c.new_zeros(v).index_add_(0, flat, s2)[:, None]
    scale_abs = c.new_zeros(v).index_add_(0, flat, s2.abs())[:, None]
    counts = torch.bincount(flat, minlength=v).double()[:, None]
    out["d_codes"] = (first + c * scale, gamma(counts + 2)
                      * (first_abs + c.abs() * scale_abs))
    sides = ((("d_q_subj", torch.ones_like(ids, dtype=torch.bool)),)
             if q_obj is None else (("d_q_subj", ~coin), ("d_q_obj", coin)))
    for name, side in sides:
        t = (d_e.double() * side)[:, :, None] * ev
        out[name] = (t.sum(1), gamma(k) * t.abs().sum(1))
    return out


def kernel3_dq(codes, ids, coin, d_e) -> list:
    """d q_subj and d q_obj by kernel 3 instead of gather_dot_grad: two
    launches over a CSR of k entries a positive, perm the ids, weights the
    cotangents masked by the coins."""
    n, k = ids.shape
    row_ptr = torch.arange(0, n * k + 1, k, dtype=torch.int32,
                           device=codes.device)
    perm = ids.reshape(-1).to(torch.int32)
    obj = coin.reshape(-1).float()
    g = d_e.reshape(-1)
    return [staircase.aggregate(codes, CsrLayout(row_ptr, perm, perm,
                                                 w.contiguous()), n, perm)
            for w in (g * (1 - obj), g * obj)]


def phase_kernel_energies(device) -> list:
    """The factored energies' float32 gather-dot route (ops/neg_energy.py,
    csrc/neg_energy.cu) at the R-GCN cells' shapes (ENERGY_SHAPES), on
    random codes, factors, ids, coins and cotangents: the energies, ev_sq
    and the gradients of the codes and both factors within the f32
    rounding allowance of the float64 direct form (energies_exact); one
    launch of each gather-dot kernel and two of kernel 3 by sum_by_csr a
    forward and backward, none of the bf16 backward's; two calls bit for
    bit; the device memory the route and the direct form take beyond
    their inputs. Times: the route's forward and backward, the forward
    kernel and the gradient kernel (CUDA events; device times from
    torch.profiler), d q by kernel 3 instead (two launches, bits against
    the gradient kernel), d codes (_code_grads), and as the yardstick the
    direct form's forward and backward (direct_energies) and autograd's
    index_put_ of the [n * k, d] rows into the table. Bounds: each
    kernel's gathered bytes (every gathered row read, the factors, ids,
    coins and outputs once) and its compulsory bytes (the code table read
    once in place of the gathered rows) at HBM_BYTES_PER_S."""
    t_phase = time.perf_counter()
    op = neg_energy.factored_negative_energies
    rows = []
    for cell, (n, k, d, v) in ENERGY_SHAPES.items():
        gen = torch.Generator(device=device).manual_seed(21)

        def normal(*shape):
            return torch.randn(*shape, generator=gen, device=device)
        codes, q_subj, q_obj = (normal(*shape).requires_grad_(True)
                                for shape in ((v, d), (n, d), (n, d)))
        ids = torch.randint(0, v, (n, k), generator=gen, device=device)
        coin = torch.rand(n, k, generator=gen, device=device) < 0.5
        d_e, d_s = normal(n, k), normal(n, k)
        leaves = (codes, q_subj, q_obj)

        def grads(energy, ev_sq):
            return (energy, ev_sq) + torch.autograd.grad(
                (energy * d_e).sum() + (ev_sq * d_s).sum(), leaves)

        def route():
            return grads(*op(codes, q_subj, q_obj, ids, coin))

        def direct():
            return grads(*neg_energy.direct_energies(codes, ids, q_subj,
                                                     q_obj, coin))

        def peak_bytes(fn):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out = fn()
            torch.cuda.synchronize()
            return out, torch.cuda.max_memory_allocated() - base

        reset_launch_counts()
        got, route_peak = peak_bytes(route)
        counts = {"f32_launches": op.f32_launches,
                  "f32_grad_launches": op.f32_grad_launches,
                  "sum_by_csr": sum_by_csr_op().launches,
                  "bf16_launches": op.bf16_launches}
        if counts != {"f32_launches": 1, "f32_grad_launches": 1,
                      "sum_by_csr": 2, "bf16_launches": 0}:
            raise AssertionError(f"gather_dot {cell}: launches {counts}")
        again = route()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"gather_dot {cell}: two calls differ")
        del again
        names = ("energy", "ev_sq", "d_codes", "d_q_subj", "d_q_obj")
        want = energies_exact(codes, q_subj, q_obj, ids, coin, d_e, d_s)
        over = {name: over_allowance(g, want[name][0],
                                     want[name][1] + 1e-30)
                for name, g in zip(names, got)}
        max_err = {name: (g.double() - want[name][0]).abs().max().item()
                   for name, g in zip(names, got)}
        del want
        if not all(o <= 1 for o in over.values()):
            raise AssertionError(f"gather_dot {cell}: {over} of the f32 "
                                 f"rounding allowance")
        plain, direct_peak = peak_bytes(direct)
        vs_direct = {name: (a - b).abs().max().item()
                     for name, a, b in zip(names, got, plain)}
        del plain
        c, qs, qo = (t.detach() for t in leaves)
        dq3 = kernel3_dq(c, ids, coin, d_e)
        dq = neg_energy.gather_dot_grad(c, ids, coin, d_e)
        dq3_same = all(torch.equal(a, b) for a, b in zip(dq3, dq))
        del dq3, dq, got
        flat = ids.reshape(-1)
        fsel = neg_energy._factor_rows(n, k, coin, device)
        qcat = torch.cat([qs, qo])
        rows_nkd = normal(n * k, d)
        times = {
            "route_ms": cuda_ms(route, 10),
            "forward_ms": cuda_ms(lambda: neg_energy.gather_dot(
                c, qs, qo, ids, coin), 20),
            "grad_ms": cuda_ms(lambda: neg_energy.gather_dot_grad(
                c, ids, coin, d_e), 20),
            "dq_kernel3_ms": cuda_ms(lambda: kernel3_dq(c, ids, coin, d_e),
                                     20),
            "code_grads_ms": cuda_ms(lambda: neg_energy._code_grads(
                c, qcat, flat, d_e.reshape(-1), 2.0 * d_s.reshape(-1), fsel,
                None), 20),
            "direct_ms": cuda_ms(direct, 5),
            "index_put_ms": cuda_ms(lambda: torch.zeros(
                v, d, device=device).index_put_((flat,), rows_nkd,
                                                accumulate=True), 5)}
        del rows_nkd
        dev = retried_device_ms(route, ("gather_dot_kernel",
                                        "gather_dot_grad_kernel"),
                                "route_device_ms", iters=10)
        meta = n * k * (8 + 1)                      # ids, coins
        factors = 2 * n * d * 4
        gathered = n * k * d * 4
        table = v * d * 4
        fwd = {"gathered": gathered + factors + meta + 2 * n * k * 4,
               "compulsory": table + factors + meta + 2 * n * k * 4}
        grad = {"gathered": gathered + meta + n * k * 4 + factors,
                "compulsory": table + meta + n * k * 4 + factors}
        bounds = {f"{kernel}_{kind}_bound_ms": 1e3 * b / HBM_BYTES_PER_S
                  for kernel, by in (("forward", fwd), ("grad", grad))
                  for kind, b in by.items()}
        # The roofline is the compulsory bytes': the gathered rows come
        # from L2 where the table fits there (FB15k-237's 29 MB).
        kernel_ms = dev["route_device_ms"]
        shares = {}
        for kernel, name in (("forward", "gather_dot_kernel"),
                             ("grad", "gather_dot_grad_kernel")):
            if kernel_ms.get(name):
                shares[f"{kernel}_roofline"] = 100 * bounds[
                    f"{kernel}_compulsory_bound_ms"] / kernel_ms[name]
        row = {"kernel": "gather_dot", "cell": cell, "n": n, "k": k, "d": d,
               "V": v, "over_allowance": over, "max_abs_err": max_err,
               "max_abs_diff_vs_direct": vs_direct,
               "same_bits_twice": True, "dq_kernel3_same_bits": dq3_same,
               "launches": counts, "route_peak_bytes": route_peak,
               "direct_peak_bytes": direct_peak,
               "nkd_tensor_bytes": gathered, **times, **dev, **bounds,
               **shares}
        emit("kernel_energies", phase_s=time.perf_counter() - t_phase,
             **row)
        rows.append(row)
        del codes, q_subj, q_obj, c, qs, qo, qcat
        torch.cuda.empty_cache()
    return rows


def energies_kernels_line(rows, runs) -> list:
    """The gather-dot kernels (csrc/neg_energy.cu), which replace no TPU
    kernel: each cell shape's row of phase_kernel_energies, and the
    gather-dot launches of every training path (``runs``: phase ->
    row)."""
    return [{"name": "gather_dot", "route": "cuda", "source": ENERGY_SOURCE,
             "replaces": "none (the JAX package's f32 _direct, left to XLA)",
             "launches": sum(r.get("gather_dot_launches", 0)
                             for r in runs.values()),
             "launches_by_path": {k: r.get("gather_dot_launches", 0)
                                  for k, r in runs.items()},
             "cells": rows}]


def phase_kernel_staircase(graphs, d, device):
    """staircase_aggregate_f32 (TPU kernels 3 and 4) against a float64 sum
    within the rounding its terms allow, in both directions of each graph:
    the model path (messages in the CSR's entry order, no perm), the same
    messages summed on the opposite direction's CSR (must fail the
    allowance), the op's VJP against float64 autograd through the plain
    version, and scatter2 with a random primary edge order (the perm
    path); the kernel's carry rows equal merge_path_carry_rows and two
    launches give the same bits. Times of the kernel, its plain version
    and torch.sparse.mm on the [V, E] CSR matrix of weights, beside the
    bound; hub rows and the others apart; the kernel at every item count
    of SWEEP_ITEMS. Then staircase_layouts. Launches here go through
    staircase.launch or count on counters the main paths reset."""
    t_phase = time.perf_counter()
    lib, _ = staircase.kernel_library()
    rows = []
    for graph_name, graph in graphs.items():
        v = graph.n_vertices
        for name, layout, wrong in (("forward", graph.fwd, graph.bwd),
                                    ("backward", graph.bwd, graph.fwd)):
            e = layout.n_edges
            gen = torch.Generator().manual_seed(5)
            msgs = torch.randn(e, d, generator=gen).to(device)
            probe = torch.randn(v, d, generator=gen).to(device)
            order = torch.randperm(e, generator=gen).to(device)
            perm = order.to(torch.int32)
            primary = torch.empty_like(msgs)
            primary[order] = msgs  # CSR entry k is primary edge order[k]

            got = staircase_repeatable(lib, msgs, layout, v)
            staircase_repeatable(lib, primary, layout, v, perm)
            plain = staircase.staircase_aggregate_reference(msgs, layout, v)
            wrong_out = staircase.launch(lib, msgs, wrong, v)
            scattered = staircase2.scatter2(primary, layout, v, perm)
            m = msgs.clone().requires_grad_(True)
            out = staircase.staircase_aggregate(m, layout, v)
            (dm,) = torch.autograd.grad((out * probe).sum(), m)
            exact, allowance = staircase_exact(msgs, layout, v)
            m64 = msgs.double().requires_grad_(True)
            (dm_ref,) = torch.autograd.grad(
                (staircase.staircase_aggregate_reference(m64, layout, v)
                 * probe.double()).sum(), m64)
            torch.cuda.synchronize()
            for t in (got, scattered, dm):
                if not torch.isfinite(t).all():
                    raise AssertionError(f"staircase {graph_name}/{name}: "
                                         f"not finite")
            torch.testing.assert_close(got, plain, rtol=1e-4, atol=1e-5)
            over = over_allowance(got, exact, allowance)
            scatter_over = over_allowance(scattered, exact, allowance)
            wrong_over = over_allowance(wrong_out, exact, allowance)
            # one term an element: w_k * g[row(k)]
            dm_over = over_allowance(dm, dm_ref, sum_allowance(
                dm_ref, dm_ref.abs(), torch.ones_like(dm_ref)))
            if not (over <= 1 and scatter_over <= 1 and dm_over <= 1):
                raise AssertionError(
                    f"staircase {graph_name}/{name}: kernel, scatter2 or "
                    f"the VJP beyond the f32 rounding allowance ({over}, "
                    f"{scatter_over}, {dm_over} of it)")
            if not wrong_over > 1:
                raise AssertionError(
                    f"staircase {graph_name}/{name}: the opposite CSR "
                    f"passes the allowance ({wrong_over} of it)")

            csr = torch.sparse_csr_tensor(
                layout.row_ptr.long(), torch.arange(e, device=device),
                layout.w, size=(v, e))
            # scatter2's yardstick: the same matrix over primary edge
            # columns, sorted within each row as a CSR matrix keeps them
            by_col = torch.argsort(
                staircase.row_of_entry(layout) * e + order)
            csr_perm = torch.sparse_csr_tensor(
                layout.row_ptr.long(), order[by_col], layout.w[by_col],
                size=(v, e))
            library_err = (torch.sparse.mm(csr, msgs).double()
                           - exact).abs().max().item()
            lengths = layout.row_ptr.diff()
            long_entry = long_row_entries(layout, HUB_ROW)
            hubs, rest = split_rows(layout, HUB_ROW)
            hub_msgs = msgs[long_entry].contiguous()
            rest_msgs = msgs[~long_entry].contiguous()
            bound = staircase_bound(layout, v, d)
            row = {"kernel": "staircase_aggregate", "graph": graph_name,
                   "direction": name, "edges": e, "d": d,
                   "max_abs_err": (got.double() - exact).abs().max().item(),
                   "max_abs_diff_vs_plain": (got - plain).abs().max().item(),
                   "over_allowance": over,
                   "wrong_layout_over_allowance": wrong_over,
                   "vjp_max_abs_err": (dm.double() - dm_ref).abs().max()
                   .item(),
                   "vjp_over_allowance": dm_over,
                   "scatter2_max_abs_err": (scattered.double() - exact)
                   .abs().max().item(),
                   "scatter2_over_allowance": scatter_over,
                   "library_max_abs_err": library_err,
                   "kernel_ms": cuda_ms(
                       lambda: staircase.launch(lib, msgs, layout, v), 20),
                   "plain_ms": cuda_ms(
                       lambda: staircase.staircase_aggregate_reference(
                           msgs, layout, v), 3, warmup=1),
                   "library_ms": cuda_ms(lambda: torch.sparse.mm(csr, msgs),
                                         20),
                   "hub_rows_only_ms": cuda_ms(
                       lambda: staircase.launch(lib, hub_msgs, hubs, v), 10),
                   "other_rows_only_ms": cuda_ms(
                       lambda: staircase.launch(lib, rest_msgs, rest, v),
                       10),
                   "vjp_ms": cuda_ms(lambda: torch.autograd.grad(
                       (staircase.staircase_aggregate(m, layout, v)
                        * probe).sum(), m), 5),
                   "scatter2_ms": cuda_ms(lambda: staircase.launch(
                       lib, primary, layout, v, perm), 20),
                   "scatter2_plain_ms": cuda_ms(
                       lambda: staircase.staircase_aggregate_reference(
                           primary, layout, v, perm), 3, warmup=1),
                   "scatter2_library_ms": cuda_ms(
                       lambda: torch.sparse.mm(csr_perm, primary), 20),
                   "scatter2_bound_ms": staircase_bound(
                       layout, v, d, perm=True)["bound_ms"],
                   f"rows_over_{HUB_ROW}": int((lengths > HUB_ROW).sum()
                                               .item()),
                   "largest_row": int(lengths.max().item()),
                   "empty_rows": int((lengths == 0).sum().item()),
                   "items": staircase.merge_path_items(v, e),
                   "items_sweep_ms": {str(items): cuda_ms(
                       lambda: staircase.launch(lib, msgs, layout, v,
                                                items=items), 20)
                       for items in SWEEP_ITEMS},
                   "same_bits_twice": True,
                   **bound}
            emit("kernel_staircase", phase_s=time.perf_counter() - t_phase,
                 **row)
            rows.append(row)
    for row in staircase_layouts(lib, graphs, d, device):
        emit("kernel_staircase", phase_s=time.perf_counter() - t_phase,
             **row)
        rows.append(row)
    return rows


def phase_grad_basis(graphs, n_rel, n_bases, d, device):
    """basis_direction's output and gradient (project + combine forward,
    twin pass, torch d W_flat and d C) against autograd through
    basis_direction_reference in float64 on the card, both directions of
    each graph: the output and d features within the rounding an f32 sum
    of their terms may have (basis_exact), d W_flat and d C within
    rtol 1e-4 and 1e-4 of their largest entry (sums over up to ~44k edges
    of a relation, in f32). Times of the differentiable op's
    forward, of d W_flat + d C, of d C alone beside the same sums by
    index_add_ (and two d C calls bit for bit), of its whole backward and
    of the plain
    backward (float32)."""
    t_phase = time.perf_counter()
    plib, _ = staircase2.project_kernel_library()
    rows = []
    for graph_name, graph in graphs.items():
        v = graph.n_vertices
        gen = torch.Generator().manual_seed(4)
        x = torch.randn(v, d, generator=gen).to(device)
        w_flat = (torch.randn(d, n_bases * d, generator=gen)
                  * d ** -0.5).to(device)
        coef = torch.randn(n_rel, n_bases, generator=gen).to(device)
        probe = torch.randn(v, d, generator=gen).to(device)
        for name, layout, twin in (("forward", graph.fwd, graph.fwd_twin),
                                   ("backward", graph.bwd, graph.bwd_twin)):
            leaves = [t.clone().requires_grad_(True)
                      for t in (x, w_flat, coef)]
            out = staircase2.basis_direction(*leaves, layout, v, twin)
            loss = (out * probe).sum()
            gx, gw, gc = torch.autograd.grad(loss, leaves,
                                             retain_graph=True)
            out_ref, out_allowance, gx_ref, gx_allowance = basis_exact(
                x, w_flat, coef, layout, v, probe)
            w64 = w_flat.double().requires_grad_(True)
            c64 = coef.double().requires_grad_(True)
            gw_ref, gc_ref = torch.autograd.grad(
                (staircase2.basis_direction_reference(
                    x.double(), w64, c64, layout, v)
                 * probe.double()).sum(), (w64, c64))
            torch.cuda.synchronize()
            for t in (out, gx, gw, gc):
                if not torch.isfinite(t).all():
                    raise AssertionError(f"{graph_name}/{name}: output or "
                                         f"gradient not finite")
            out_over = over_allowance(out.detach(), out_ref, out_allowance)
            gx_over = over_allowance(gx, gx_ref, gx_allowance)
            if not (out_over <= 1 and gx_over <= 1):
                raise AssertionError(
                    f"{graph_name}/{name}: output or d features beyond the "
                    f"f32 rounding allowance ({out_over}, {gx_over} of it)")
            for got, ref in ((gw, gw_ref), (gc, gc_ref)):
                torch.testing.assert_close(
                    got, ref.float(), rtol=1e-4,
                    atol=1e-4 * ref.abs().max().item())
            proj = staircase2.launch_project(plib, x, w_flat)
            dc_same = twice_same(lambda: staircase2.basis_direction_dweights(
                x, proj, probe, coef, layout, need_w=False)[1])
            if not dc_same:
                raise AssertionError(f"{graph_name}/{name}: two d C calls "
                                     f"differ")
            xr = [t.clone().requires_grad_(True) for t in (x, w_flat, coef)]
            ref_loss = (staircase2.basis_direction_reference(*xr, layout, v)
                        * probe).sum()
            row = {"graph": graph_name, "direction": name,
                   "edges": layout.n_edges,
                   "forward_max_abs_err":
                       (out.detach().double() - out_ref).abs().max().item(),
                   "forward_over_allowance": out_over,
                   "dfeatures_max_abs_err":
                       (gx.double() - gx_ref).abs().max().item(),
                   "dfeatures_over_allowance": gx_over,
                   "dw_max_abs_err": (gw.double() - gw_ref).abs().max()
                   .item(),
                   "dw_max_abs": gw_ref.abs().max().item(),
                   "dc_max_abs_err": (gc.double() - gc_ref).abs().max()
                   .item(),
                   "dc_max_abs": gc_ref.abs().max().item(),
                   "forward_ms": cuda_ms(lambda: staircase2.basis_direction(
                       x, w_flat, coef, layout, v), 10),
                   "backward_ms": cuda_ms(lambda: torch.autograd.grad(
                       loss, leaves, retain_graph=True), 5),
                   "twin_weights_ms": cuda_ms(
                       lambda: staircase2.basis_twin_weights(w_flat,
                                                             n_bases), 10),
                   "dweights_ms": cuda_ms(
                       lambda: staircase2.basis_direction_dweights(
                           x, proj, probe, coef, layout), 5),
                   "dc_ms": cuda_ms(
                       lambda: staircase2.basis_direction_dweights(
                           x, proj, probe, coef, layout, need_w=False), 10),
                   "dc_same_bits_twice": dc_same,
                   "dc_index_add_ms": cuda_ms(lambda: dc_index_add(
                       proj, probe, coef, layout), 10),
                   "dc_index_add_same_bits_twice": twice_same(
                       lambda: dc_index_add(proj, probe, coef, layout)),
                   "plain_backward_ms": cuda_ms(lambda: torch.autograd.grad(
                       ref_loss, xr, retain_graph=True), 3, warmup=1)}
            emit("grad_basis", phase_s=time.perf_counter() - t_phase, **row)
            rows.append(row)
    return rows


def same_step(loss, grads, ref_loss, ref_grads, what, loss_rtol=1e-5,
              leaf_rtol=1e-4) -> dict:
    """Hold one step's loss within ``loss_rtol`` relative and each
    gradient leaf within ``leaf_rtol`` in relative L2 norm of a reference
    step's (``what`` names the reference)."""
    loss_rel = abs(loss.item() - ref_loss.item()) / abs(ref_loss.item())
    if not loss_rel <= loss_rtol:
        raise AssertionError(f"step loss differs from {what} by {loss_rel} "
                             f"(relative)")
    grad_rows = []
    for g, c in zip(tree_leaves(grads), tree_leaves(ref_grads)):
        g, c = g.cpu(), c.cpu()
        norm = c.norm().item()
        rel = (g - c).norm().item() / norm if norm else (g - c).norm().item()
        grad_rows.append({"shape": list(c.shape),
                          "max_abs_diff": (g - c).abs().max().item(),
                          "max_abs": c.abs().max().item(),
                          "rel_l2_diff": rel})
        # A ReLU gate at |a| ~ 0 can flip between two f32 summation orders
        # and move a few entries by their own size; a wrong formula moves
        # the whole leaf. So the leaf is held in the L2 norm.
        if not rel <= leaf_rtol:
            raise AssertionError(f"gradient leaf {list(c.shape)} differs "
                                 f"from {what}: relative L2 {rel}")
    return {"loss": loss.item(), "ref_loss": ref_loss.item(),
            "loss_rel_diff": loss_rel,
            "worst_leaf_rel_l2_diff": max(r["rel_l2_diff"]
                                          for r in grad_rows),
            "grads": grad_rows}


def tiled_vs_factored(loop, params, batch) -> dict:
    """The tiled loss on device_negative_sample's batch against the
    factored binomial loss on device_negative_parts' corruptions of the
    same generator state (the keep-masks follow from the same state), on
    the card: loss within 1e-5 relative, leaves within 1e-4."""
    model, cfg, gen = loop.model, loop.config, loop.generator
    state = gen.get_state()
    tiled = loop.draw(batch)
    gen.set_state(state)
    factored = engine.Draws(
        device_sampling.device_negative_parts(
            batch.triples, cfg.training.negative_sample_rate,
            cfg.entity_count, gen),
        model.draw_keep_masks(gen))
    loss, grads = engine.step_loss_and_grads(model, "tiled", params, batch,
                                             tiled)
    ref_loss, ref_grads = engine.step_loss_and_grads(
        model, "factored", params, batch, factored)
    return {"tiled_rows": int(tiled.negatives[0].shape[0]),
            **same_step(loss, grads, ref_loss, ref_grads,
                        "the factored loss on the same draws")}


def gather_backward(model, params, batch, draws) -> dict:
    """The tiled loss's three code gathers (e1, r and e2 of the tiled
    triples) on the card: for each, the time of the gather alone and of
    the gather with autograd's backward (its sort-based index_put_),
    beside one index_add_ of the same rows (CUDA events), with the rows
    gathered and the distinct ids among them."""
    with torch.no_grad():
        enc = model.encode(params, batch.graph, deterministic=True)
    triples = draws.negatives[0].long()
    gen = torch.Generator(device=triples.device).manual_seed(0)
    out = {}
    for name, table, col in (("e1", enc.entity_codes, 0),
                             ("r", enc.relation_codes, 1),
                             ("e2", enc.entity_codes, 2)):
        idx = triples[:, col]
        g = torch.randn(len(idx), table.shape[1], generator=gen,
                        device=table.device)
        leaf = table.detach().requires_grad_(True)
        out[name] = {
            "rows": len(idx), "distinct_ids": int(idx.unique().numel()),
            "table_rows": table.shape[0],
            "gather_ms": cuda_ms(lambda: table[idx], 5),
            "gather_and_backward_ms": cuda_ms(
                lambda: torch.autograd.grad(leaf[idx], leaf, g), 5),
            "index_add_ms": cuda_ms(
                lambda: torch.zeros_like(table).index_add_(0, idx, g), 5)}
    return out


def same_batches(got, want) -> None:
    """Two lists of host batches equal tensor for tensor."""
    if len(got) != len(want):
        raise AssertionError(f"{len(got)} batches against {len(want)}")
    for k, (a, b) in enumerate(zip(got, want)):
        ta, tb = a.tensors(), b.tensors()
        if len(ta) != len(tb) or not all(torch.equal(x, y)
                                         for x, y in zip(ta, tb)) \
                or not np.array_equal(a.edge_ids, b.edge_ids):
            raise AssertionError(f"host batch {k} differs from the CPU "
                                 f"pipeline's")


def kl_vs_cpu(model, params, batch, draws) -> dict:
    """A variational encoder's KL term for one step's train-mode encode
    (its keep-masks and noise) on the card against the CPU plain path's,
    within 1e-5 relative."""
    cpu = torch.device("cpu")
    ref_model = build.build_model(model.config, cpu)
    values = []
    for m, p, b, d in ((model, params, batch, draws),
                       (ref_model, map_tree(lambda t: t.cpu(), params),
                        batch.to(cpu), draws.to(cpu))):
        with torch.no_grad():
            enc = m.encode(p, b.graph, deterministic=False,
                           keep_masks=d.keep_masks, noise=d.noise)
            values.append(m.plus_kl(torch.zeros((), device=m.device),
                                    enc).item())
    kl, ref = values
    rel = abs(kl - ref) / abs(ref)
    if not rel <= 1e-5:
        raise AssertionError(f"KL term {kl} differs from the CPU plain "
                             f"path's {ref} by {rel} (relative)")
    return {"kl": kl, "kl_cpu_plain": ref, "kl_rel_diff": rel}


STORED_CACHE_STEPS = 3


def stateful_vs_cpu(loop, params, batches) -> dict:
    """The stored variant's loss_stateful over ``batches`` from zero
    caches, the caches carried, on the card and on the CPU plain path
    with the same params, batches and draws: the first step held as
    same_step, every cache after the last step within 1e-5 in relative L2
    norm."""
    model, cpu = loop.model, torch.device("cpu")
    ref_model = build.build_model(loop.config, cpu)
    cpu_params = map_tree(lambda t: t.cpu(), params)
    cache, ref_cache = model.init_cache_state(), ref_model.init_cache_state()
    first = None
    for batch in batches:
        draws = loop.draw(batch)
        loss, grads, cache = engine.stateful_loss_and_grads(
            model, params, cache, batch, draws)
        ref_loss, ref_grads, ref_cache = engine.stateful_loss_and_grads(
            ref_model, cpu_params, ref_cache, batch.to(cpu), draws.to(cpu))
        if first is None:
            first = same_step(loss, grads, ref_loss, ref_grads,
                              "the CPU plain path")
    rows = []
    for layer, (st, ref) in enumerate(zip(cache, ref_cache)):
        for key in sorted(st):
            diff = (st[key].cpu() - ref[key]).norm().item()
            norm = ref[key].norm().item()
            rel = diff / norm if norm else diff
            rows.append({"layer": layer, "cache": key,
                         "shape": list(ref[key].shape),
                         "max_abs": ref[key].abs().max().item(),
                         "rel_l2_diff": rel})
            if not rel <= 1e-5:
                raise AssertionError(f"cache {key} of layer {layer} after "
                                     f"{len(batches)} steps differs from "
                                     f"the CPU plain path's: relative L2 "
                                     f"{rel}")
    return {**first, "cache_steps": len(batches),
            "worst_cache_rel_l2_diff": max(r["rel_l2_diff"] for r in rows),
            "caches": rows}


def lockstep_vs_cpu(cfg, ds, device, steps) -> dict:
    """``steps`` train steps (draws, loss, clip and Adam) from seed-0
    weights, in lockstep on the card and on the CPU plain path with the
    same batches and the card's draws: each step's loss on both, and the
    first step whose loss is not finite on each, which must be the same.
    The evidence for a path whose loss leaves the floats on the card."""
    cpu = torch.device("cpu")
    model = build.build_model(cfg, device)
    loop = engine.TrainLoop(model, cfg, ds, seed=0, log=lambda _: None,
                            prefetch=False)
    ref_model = build.build_model(cfg, cpu)
    params, opt_state = loop.init_state(0)
    ref_params = map_tree(lambda t: t.cpu().clone(), params)
    ref_state = loop.optimizer.init(ref_params)
    def step(m, p, st, batch, draws):
        loss, grads = engine.step_loss_and_grads(m, loop.loss_kind, p, batch,
                                                 draws)
        updates, st = loop.optimizer.update(grads, st)
        optimizers.apply_updates(p, updates)
        return loss.item(), st

    losses, ref_losses = [], []
    for _ in range(steps):
        batch = loop.pipeline.next().to(device)
        draws = loop.draw(batch)
        loss, opt_state = step(model, params, opt_state, batch, draws)
        ref_loss, ref_state = step(ref_model, ref_params, ref_state,
                                   batch.to(cpu), draws.to(cpu))
        losses.append(loss)
        ref_losses.append(ref_loss)

    def first_nonfinite(xs):
        return next((i + 1 for i, x in enumerate(xs)
                     if not np.isfinite(x)), None)
    row = {"lockstep_losses": losses, "lockstep_cpu_plain_losses": ref_losses,
           "first_nonfinite_step": first_nonfinite(losses),
           "first_nonfinite_step_cpu_plain": first_nonfinite(ref_losses)}
    if row["first_nonfinite_step"] != row["first_nonfinite_step_cpu_plain"] \
            or row["first_nonfinite_step"] is None:
        raise AssertionError(f"the card's losses leave the floats at another "
                             f"step than the CPU plain path's: {row}")
    return row


def checked_graph_counts(loop, what: str) -> dict:
    """The loop's graph counts (``TrainLoop.graph_counts``); raises where
    a capture failed."""
    counts = dict(loop.graph_counts)
    if counts["failed_captures"]:
        raise AssertionError(f"{what}: a capture of the step failed: "
                             f"{counts}")
    return counts


def phase_train(cfg, ds, device, op=staircase2.block_direction,
                phase="train", steps=TRAIN_STEPS, compare_positives=None,
                tiled=False, falling=True, nonfinite_ok=False,
                compare_routes=False, **loop_kwargs):
    """One step on the card against the CPU plain path, then the training
    path through TrainLoop.fit (serial batches, prefetch=False) with
    the kernels' launch counts: ``op`` (block_direction, basis_direction
    or staircase_aggregate) must have launched once a direction and layer
    in each step, and its twin pass as often (staircase_aggregate has none:
    its gradient is a torch gather), and nothing else launched; with
    ``op`` None (no graph) nothing at all. ``compare_positives``: the
    one-step comparison takes the batch's first that many positives.
    ``loop_kwargs`` go to TrainLoop (the negative protocol, host-tiled
    batches): the step and its comparison take the loop's loss.
    ``tiled``: the tiled loss on device draws in place of the factored
    binomial loss of a factorizable decoder (the JAX package's tests reach
    it by clearing ``_use_factored_binomial``), also held to the factored
    loss on the same draws. Host-tiled batches consumed by the fit are
    held to a CPU model's pipeline's, batch for batch. The loss must be
    finite at every step, and with ``falling`` lower at the last step
    than at the first. With ``nonfinite_ok`` a loss that is not finite
    passes only where lockstep_vs_cpu shows the CPU plain path's loss
    leaving the floats at the same step. The stored variant's comparison runs
    STORED_CACHE_STEPS steps and holds its caches too (stateful_vs_cpu);
    a variational encoder's adds its KL term (kl_vs_cpu). A bf16 message
    or stream precision counts the bf16 entry points (and the bf16
    energies' backwards: one kernel 3 launch a step for the factored
    loss, two for the split loss, where the JAX package's rule takes
    them) and no f32 one; its step is held to the CPU plain path within
    BF16_STEP_TOL (the same bf16 arithmetic, f32 sums in other orders,
    which can flip bf16 roundings and ReLU gates near 0), and its loss to
    the f32 configuration's on the same draws within 1e-2 relative (the
    JAX package's own rule, tests/test_bf16_streams.py).
    ``compare_routes`` (bf16 block_direction or basis_direction) also
    profiles steps by each of its bf16 routes after the counted run."""
    t_phase = time.perf_counter()
    model = build.build_model(cfg, device)
    bf16 = model.agg_dtype is not None or model.stream_dtype is not None
    pre = "bf16_" if model.agg_dtype is not None else ""
    logged = []
    loop = engine.TrainLoop(model, cfg, ds, seed=0, log=logged.append,
                            prefetch=False, **loop_kwargs)
    params, opt_state = loop.init_state(0)
    if tiled:
        loop.loss_kind = "tiled"
    kind, host_tiled = loop.loss_kind, not loop.pipeline.device_negatives

    # -- one step, card against the CPU plain path -----------------------
    pipeline = engine.BatchPipeline(model, cfg, ds, np.random.default_rng(0),
                                    device_negatives=not host_tiled)
    batch = pipeline.next().to(device)
    energies_per_step = fused_energy_launches(
        model, kind, batch.triples.shape[0],
        cfg.training.negative_sample_rate)
    dots_per_step = gather_dot_calls(model, kind, batch.triples.shape[0],
                                     cfg.training.negative_sample_rate)
    if phase == "train_distmult_bf16":
        emit(f"{phase}_fused_backward", phase_s=time.perf_counter() - t_phase,
             **fused_vs_autograd(model, params, batch))
    if model.has_state:
        batches = [batch] + [pipeline.next().to(device)
                             for _ in range(STORED_CACHE_STEPS - 1)]
        emit(f"{phase}_step_vs_cpu", phase_s=time.perf_counter() - t_phase,
             loss_kind=kind, positives=loop.pipeline.n_positives,
             **stateful_vs_cpu(loop, params, batches))
        del batches
    if compare_positives is not None:
        batch = batch._replace(triples=batch.triples[:compare_positives],
                               mask=batch.mask[:compare_positives])
    if kind == "tiled" and not host_tiled and model.decoder.factorizable:
        emit(f"{phase}_tiled_vs_factored",
             **tiled_vs_factored(loop, params, batch),
             phase_s=time.perf_counter() - t_phase)
    cpu = torch.device("cpu")
    if not model.has_state:
        draws = loop.draw(batch)
        if kind == "tiled" and not host_tiled:
            emit(f"{phase}_gather_backward",
                 **gather_backward(model, params, batch, draws),
                 phase_s=time.perf_counter() - t_phase)
        loss, grads = engine.step_loss_and_grads(model, kind, params, batch,
                                                 draws)
        cpu_loss, cpu_grads = engine.step_loss_and_grads(
            build.build_model(cfg, cpu), kind,
            map_tree(lambda t: t.cpu(), params), batch.to(cpu),
            draws.to(cpu))
        kl = kl_vs_cpu(model, params, batch, draws) if model.variational \
            else {}
        emit(f"{phase}_step_vs_cpu", phase_s=time.perf_counter() - t_phase,
             loss_kind=kind, positives=loop.pipeline.n_positives
             if host_tiled else int(batch.mask.sum().item()),
             **same_step(loss, grads, cpu_loss, cpu_grads,
                         "the CPU plain path",
                         **(BF16_STEP_TOL if bf16 else {})), **kl)
        if bf16:
            emit(f"{phase}_vs_f32", phase_s=time.perf_counter() - t_phase,
                 **bf16_vs_f32(model, kind, params, batch, draws, loss,
                               grads))
        del draws, grads, cpu_grads
    del batch

    consumed, make_batch = [], loop.pipeline.next
    if host_tiled:
        def keep_batch():
            consumed.append(make_batch())
            return consumed[-1]
        loop.pipeline.next = keep_batch

    # -- the main path: TrainLoop.fit ------------------------------------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    result = loop.fit(params, opt_state, max_iterations=steps)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    loop.pipeline.next = make_batch
    if host_tiled:
        cpu_pipe = engine.BatchPipeline(build.build_model(cfg, cpu), cfg, ds,
                                        np.random.default_rng(0),
                                        device_negatives=False)
        same_batches(consumed, [cpu_pipe.next() for _ in consumed])
        emit(f"{phase}_host_batches", batches=len(consumed),
             rows=int(consumed[0].triples.shape[0]),
             real_rows=int(consumed[0].mask.sum().item()),
             equal_to_cpu_pipeline=True,
             phase_s=time.perf_counter() - t_phase)
        del consumed
    launches = getattr(op, pre + "launches") if op else 0
    twin_launches = getattr(op, pre + "twin_launches", 0)
    project_launches = staircase2.basis_direction.project_launches
    products = getattr(staircase2.basis_direction, pre + "project_launches")
    split_launches = staircase2.basis_direction.split_launches
    fixups = fixup_counts()
    fixup_launches = sum(fixups.values())
    energies = energy_launches()
    dots = gather_dot_launches()
    id_sums = sum_by_csr_op().launches
    pads = staircase2.basis_direction.bf16_pad_launches
    route_counts = route_launches()
    peak = torch.cuda.max_memory_allocated()
    check_helper_launches(op, launches, twin_launches, project_launches,
                          split_launches, fixups, energies)
    # bf16 gcn_basis: one f32 P for d C after each forward pass.
    dc_projects = launches if pre and op is staircase2.basis_direction \
        else 0
    check_other_precision_idle(pre == "bf16_", dc_projects)
    want_energies = steps * energies_per_step
    if energies != want_energies:
        raise AssertionError(f"the bf16 energies' backwards launched kernel "
                             f"3 {energies} times in {steps} steps, "
                             f"expected {want_energies}")
    records = result.steps
    per_layer = 2 * cfg.encoder.n_layers if op else 0
    # No twin pass where nothing needs the layer input's gradient: the
    # first layer's on random input (its blocks' gradient is the torch
    # contraction alone).
    twin_per_layer = 0 if op is staircase.staircase_aggregate \
        else per_layer - (2 if model.random_input else 0)
    for s in records:
        if s["launches"] != per_layer \
                or s["twin_launches"] != twin_per_layer:
            raise AssertionError(f"step {s['iteration']}: "
                                 f"{s['launches']} forward and "
                                 f"{s['twin_launches']} twin launches, "
                                 f"expected {per_layer} and "
                                 f"{twin_per_layer}")
    # d blocks (block_direction) and d C (basis_direction) sum by relation
    # once a direction and layer for each chunk of its edges; each fused
    # energies' backward sums its per-id scalars once, each gather-dot
    # backward d codes' weighted sum and its per-id scalars.
    check_gather_dot(dots, steps * dots_per_step, phase)
    chunks = -(-loop.pipeline.split_size // staircase2._EDGE_CHUNK)
    by_relation = per_layer * chunks if op in (
        staircase2.block_direction, staircase2.basis_direction) else 0
    want_sums = steps * by_relation + energies + 2 * dots[0]
    if id_sums != want_sums:
        raise AssertionError(f"sum_by_csr launched kernel 3 {id_sums} "
                             f"times in {steps} steps, expected "
                             f"{want_sums}")
    if staircase2.launch_counts() != (launches, twin_launches) \
            or launches != per_layer * steps \
            or twin_launches != twin_per_layer * steps:
        raise AssertionError(f"fit launched {launches} forward and "
                             f"{twin_launches} twin passes of "
                             f"{op_name(op)}, all ops "
                             f"{staircase2.launch_counts()}")
    if products != (launches + twin_launches
                    if op is staircase2.basis_direction else 0):
        raise AssertionError(f"basis_project launched {products} "
                             f"times for {launches + twin_launches} "
                             f"combine launches")
    graphs = checked_graph_counts(loop, phase)
    replayed = replayed_launches(loop, params, result.opt_state)
    losses = {i: records[i - 1]["loss"] for i in (1, steps // 2, steps)}
    finite = all(np.isfinite(s["loss"]) for s in records)
    lockstep = {}
    if not finite and nonfinite_ok:
        lockstep = lockstep_vs_cpu(cfg, ds, device, steps)
        emit(f"{phase}_lockstep_vs_cpu", phase_s=time.perf_counter()
             - t_phase, losses=[s["loss"] for s in records], **lockstep)
    elif not finite or (falling and not losses[steps] < losses[1]):
        raise AssertionError(f"losses not finite"
                             f"{' and falling' if falling else ''}: "
                             f"{[s['loss'] for s in records]}")
    timing = loop.timer.summary()
    row = {"steps": result.iterations, "loss_kind": kind,
           "negative_mode": loop_kwargs.get("negative_mode", "binomial"),
           "device_negatives": not host_tiled,
           "positives": loop.pipeline.n_positives,
           "message_edges": loop.pipeline.split_size,
           "batch_ms_median": statistics.median(s["batch_ms"]
                                                for s in records),
           "step_ms_median": statistics.median(s["step_ms"]
                                               for s in records),
           "step_ms_first": records[0]["step_ms"],
           "batch_ms": [s["batch_ms"] for s in records],
           "step_ms": [s["step_ms"] for s in records],
           **{f"loss_{i}": v for i, v in losses.items()},
           "loss_fell": losses[steps] < losses[1], "losses_finite": finite,
           **{k: v for k, v in lockstep.items() if k.startswith("first")},
           "wall_s": wall_s, "steps_per_s": timing["steps_per_sec"],
           "edges_per_s": timing["edges_per_sec"],
           "launches_per_step": launches // steps,
           "twin_launches_per_step": twin_launches // steps,
           "project_launches_per_step": products // steps,
           "split_launches_per_step": split_launches // steps,
           "dc_project_launches_per_step": dc_projects // steps,
           "fixup_launches_per_step": fixup_launches // steps,
           "energy_launches_per_step": energies // steps,
           "gather_dot_launches_per_step": dots[0] // steps,
           "sum_by_csr_launches_per_step": id_sums // steps,
           "pad_launches_per_step": pads // steps,
           "precision": {"message": "bfloat16" if pre else "float32",
                         "stream": "float32" if model.stream_dtype is None
                         else "bfloat16"},
           "max_memory_allocated": peak, "graph_counts": graphs,
           "replayed_kernels": replayed, "log": logged}
    emit(phase, model=model_label(cfg),
         phase_s=time.perf_counter() - t_phase, **row)
    breakdown = host_batch_breakdown(loop.pipeline, device) \
        if model.needs_graph() else {}
    emit(f"{phase}_breakdown", **breakdown,
         **profile_steps(loop, params, result.opt_state),
         phase_s=time.perf_counter() - t_phase)
    if compare_routes:
        keys = ("profile_wall_ms_per_step", "device_busy_ms_per_step",
                "device_idle_share")
        by_route = route_times(lambda: profile_steps(
            loop, params, result.opt_state, eager=True),
            OP_ROUTES[op.__name__])
        emit(f"{phase}_routes", phase_s=time.perf_counter() - t_phase,
             **{route: {k: [p.get(k) for p in readings] for k in keys}
                for route, readings in by_route.items()})
    return {**row, "launches": launches, "twin_launches": twin_launches,
            "project_launches": products, "dc_project_launches": dc_projects,
            "split_launches": split_launches, "fixup_launches": fixup_launches,
            "energy_launches": energies, "sum_by_csr_launches": id_sums,
            "gather_dot_launches": dots[0], "pad_launches": pads,
            **route_counts}


def host_batch_breakdown(pipeline, device, reps: int = 5) -> dict:
    """Median host time of each part of a batch: edge sampling and split,
    the four CSRs on the host, their copy to the card."""
    parts = {"sample_and_split_ms": [], "layouts_ms": [], "to_device_ms": []}
    model = pipeline.model
    for _ in range(reps):
        t0 = time.perf_counter()
        _, split_ids = pipeline.sample_ids()
        t1 = time.perf_counter()
        graph = build_graph_batch(pipeline.train[split_ids],
                                  model.n_entities, model.n_relations)
        t2 = time.perf_counter()
        graph.to(device)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for key, dt in zip(parts, (t1 - t0, t2 - t1, t3 - t2)):
            parts[key].append(dt * 1e3)
    return {k: statistics.median(v) for k, v in parts.items()}


def hand_kernel_names() -> tuple:
    """The hand kernels' names (``__global__`` functions of
    ``relationprediction_torch/ops/csrc``), as a device trace names
    them."""
    names = set()
    for path in sorted((ROOT / "relationprediction_torch" / "ops"
                        / "csrc").glob("*.cu*")):
        names.update(re.findall(r"__global__[^;{]*?\b(\w+_kernel)\s*\(",
                                path.read_text()))
    return tuple(sorted(names))


def kernels_by_name(prof, n: int) -> dict:
    """Each hand kernel's launches a step in a torch.profiler session
    over ``n`` steps, by name (those launched at all)."""
    cuda = torch.autograd.DeviceType.CUDA
    counts = dict.fromkeys(hand_kernel_names(), 0)
    for e in prof.key_averages():
        if e.device_type == cuda:
            for name in counts:
                if re.search(rf"\b{name}\b", e.key):
                    counts[name] += e.count
    return {name: c / n for name, c in counts.items() if c}


REPLAY_COUNT_STEPS = 3


def replayed_launches(loop, params, opt_state,
                      n: int = REPLAY_COUNT_STEPS) -> dict:
    """The hand kernels a replayed step launches, measured: torch.profiler
    over ``n`` replays of the loop's graph and over ``n`` steps op by op
    (``TrainLoop.eager_step``), each kernel counted by name. Raises where
    the two differ by any kernel, where the profiler saw no hand kernel
    that the counters saw, or where the wrappers' counters over the eager
    steps differ from the counts the graph's capture recorded (which a
    replay adds to them, since no wrapper runs in a replay). Empty where
    the loop's steps take no graph. Runs after the counted run, so its
    launches count nowhere else."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from relationprediction_torch.ops import launch_counters
    entry = loop.graphs.current
    if entry is None or entry.graph is None:
        return {}
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    batches = [loop.pipeline.next().to(loop.model.device)
               for _ in range(2 * n + 3)]
    state = [opt_state]

    def eager(batch):
        state[0], _ = loop.eager_step(params, state[0], batch,
                                      loop.draw(batch))

    def replay(batch):
        state[0], _ = loop.train_step(params, state[0], batch)
        if loop.last_step != "replay":
            raise AssertionError(f"a step ran {loop.last_step}, not as a "
                                 f"replay of the loop's graph")

    def profiled(step, batches) -> dict:
        # The session's first step warms the profiler up and counts for
        # nothing: a session can miss the kernels of its first
        # launches.
        read = []
        with profile(activities=acts, on_trace_ready=lambda prof:
                     read.append(kernels_by_name(prof, len(batches) - 1)),
                     schedule=schedule(wait=0, warmup=1,
                                       active=len(batches) - 1,
                                       repeat=1)) as prof:
            for batch in batches:
                step(batch)
                torch.cuda.synchronize()
                prof.step()
        if len(read) != 1:
            raise AssertionError(f"{len(read)} profiles, expected one")
        return read[0]
    # Thrown away: a process's first session can record no kernel of the
    # port's.
    with profile(activities=acts):
        eager(batches[0])
        torch.cuda.synchronize()
    before = launch_counters()
    eager_kernels = profiled(eager, batches[1:n + 2])
    counted = {f"{fn.__name__}.{attr}": (c - before[fn, attr]) / (n + 1)
               for (fn, attr), c in launch_counters().items()
               if c != before[fn, attr]}
    recorded = {f"{fn.__name__}.{attr}": c
                for (fn, attr), c in entry.launches.items()}
    replay_kernels = profiled(replay, batches[n + 2:])
    if counted != recorded:
        raise AssertionError(f"an eager step's launch counters {counted}, "
                             f"the capture recorded {recorded}")
    if replay_kernels != eager_kernels or (recorded and not replay_kernels):
        raise AssertionError(f"hand kernels a replayed step "
                             f"{replay_kernels}, an eager step "
                             f"{eager_kernels}")
    return {"steps": n, "per_replayed_step": replay_kernels,
            "equal_to_eager_step": True,
            "eager_counters_equal_to_recorded": True}


def profile_steps(loop, params, opt_state, n: int = 3,
                  eager: bool = False) -> dict:
    """torch.profiler over ``n`` device steps (batches made beforehand):
    device busy time per step, the idle share of the window, and the
    kernels and operators with the most device time. Runs after the
    counted run, so its launches count nowhere. The steps are
    ``loop.train_step``'s (replays of the step's graph once it has one),
    or with ``eager`` the step op by op (``TrainLoop.eager_step``), which
    a route forced after the capture reaches."""
    from torch.profiler import ProfilerActivity, profile
    batches = [loop.pipeline.next().to(loop.model.device)
               for _ in range(n)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for batch in batches:
            if eager:
                opt_state, _ = loop.eager_step(params, opt_state, batch,
                                               loop.draw(batch))
            else:
                opt_state, _ = loop.train_step(params, opt_state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    cuda = torch.autograd.DeviceType.CUDA
    kernels, ops = [], []
    for e in prof.key_averages():
        if e.device_type == cuda and e.self_device_time_total > 0:
            kernels.append((e.self_device_time_total / n / 1e3, e.key,
                            e.count / n))
        elif e.device_type != cuda and e.device_time_total > 0 \
                and e.key.startswith("aten::"):
            ops.append((e.device_time_total / n / 1e3, e.key, e.count / n))
    if not kernels:
        return {"profile": "not measured: the profiler saw no device time"}
    busy_ms = sum(k[0] for k in kernels)
    def top(items):
        return [{"ms": ms, "name": name[:90], "calls": calls}
                for ms, name, calls in sorted(items, reverse=True)[:15]]
    return {"profiled_steps": n, "profile_wall_ms_per_step": wall_ms,
            "device_busy_ms_per_step": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "kernels_per_step": sum(k[2] for k in kernels),
            "top_kernels": top(kernels), "top_ops_inclusive": top(ops)}


# The fit phase's cadence, cut from the settings' CheckEvery 2000,
# BurninPhaseDuration 6000 and ReportTrainLossEvery 100 to fit the run's
# time limit.
FIT_CUTS = {"early_stopping_check_every": 10, "early_stopping_burnin": 20,
            "report_train_loss_every": 10}
FIT_STEPS = 40
PREFETCH_STEPS = 5
PROFILE_STEPS = 5
# The thread switch interval (s) of the interpreter-lock diagnostic runs,
# against the default 5 ms.
FAST_SWITCH = 1e-4
HASH_STEPS = 8
RESUME_STEPS = 20
EMBEDDING_STEPS = 6
HOST_TILED_STEPS = 6
POOL_SIZE = 512
# The one-step comparison of the embedding models on the CPU plain path
# takes the first 30,000 of the 272,115 positives of a step.
EMBEDDING_COMPARE_POSITIVES = 30000
SMOKE_DIR = ROOT / "build" / "chip_smoke"


def fresh_dir(name: str) -> Path:
    path = SMOKE_DIR / name
    shutil.rmtree(path, ignore_errors=True)
    path.mkdir(parents=True)
    return path


def with_optimizer(cfg, **changes):
    return dataclasses.replace(cfg, optimizer=dataclasses.replace(
        cfg.optimizer, **changes))


def stop_rule(scores, burnin, check_every):
    """The iteration at which the reference's stopper fires on the scores
    taken at check_every, 2 check_every, ..., or None."""
    previous = None
    for k, score in enumerate(scores, 1):
        if previous is not None and not score > previous \
                and k * check_every > burnin:
            return k * check_every
        previous = score
    return None


def hashing(loop) -> list:
    """Wrap ``loop.train_step`` to record a hash of each consumed batch's
    triples (read back from the card, after the step's stream has waited
    for the copy) and message-graph edge ids, in consumption order."""
    hashes, ref = [], weakref.ref(loop)

    def train_step(params, opt_state, batch):
        h = hashlib.sha256(batch.triples.cpu().numpy().tobytes())
        if batch.edge_ids is not None:
            h.update(batch.edge_ids.tobytes())
        hashes.append(h.hexdigest())
        return engine.TrainLoop.train_step(ref(), params, opt_state, batch)
    # The wrapper holds the loop weakly: a cycle would keep the loop, and
    # its step's graph with the graph's memory pool, until a collection.
    loop.train_step = train_step
    return hashes


def phase_fit(cfg, ds, device):
    """The main path of train.py on gcn_block: TrainLoop with the CLI's
    scorer over the synthetic validation split as the early stopper's
    score (and the test metrics at each check, as the CLI prints them),
    prefetch on 2 threads, checkpoints and the metrics JSONL under
    build/chip_smoke/fit, the cadence cut by FIT_CUTS to at most FIT_STEPS
    steps. Checks: a validation at each multiple of CheckEvery until the
    stop; the stop rule on the logged scores; a checkpoint for each check
    that did not stop; train_loss and validation records; 4 forward and 4
    twin block_direction launches in every step; and the totals, 4 a step
    + 4 a validation encode forward, 4 a step twin."""
    t_phase = time.perf_counter()
    out = fresh_dir("fit")
    cfg = with_optimizer(cfg, **FIT_CUTS)
    opt = cfg.optimizer
    model = build.build_model(cfg, device)
    scorer = train_cli.build_scorer(model, ds, cfg.training.metric)
    logged = []
    loop = engine.TrainLoop(
        model, cfg, ds, seed=0, log=logged.append,
        scoring_function=train_cli.validation_scoring(scorer, ds),
        prefetch_threads=2, metrics_path=str(out / "metrics.jsonl"))
    params, opt_state = loop.init_state(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        result = loop.fit(params, opt_state, max_iterations=FIT_STEPS,
                          checkpoint_path=str(out / "m"))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    fwd = staircase2.block_direction.launches
    twin = staircase2.block_direction.twin_launches
    check_helper_launches(staircase2.block_direction, fwd, twin,
                          staircase2.basis_direction.project_launches,
                          staircase2.basis_direction.split_launches,
                          fixup_counts())
    id_sums = sum_by_csr_op().launches
    loop.metrics.close()
    with open(out / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    checks = [r for r in records if r["kind"] == "validation"]
    scores = [r["score"] for r in checks]
    steps = result.iterations
    every = opt.early_stopping_check_every
    if [r["iteration"] for r in checks] != list(range(every, steps + 1,
                                                       every)):
        raise AssertionError(f"validation at {[r['iteration'] for r in checks]}"
                             f" in {steps} steps")
    stop = stop_rule(scores, opt.early_stopping_burnin, every)
    if result.stopped_early != (stop is not None) \
            or steps != (stop or FIT_STEPS):
        raise AssertionError(f"stopped at {steps} (early: "
                             f"{result.stopped_early}); the rule on {scores} "
                             f"says {stop}")
    saved = sorted(int(p.name[2:-5]) for p in out.glob("m-*.ckpt"))
    if saved != [r["iteration"] for r in checks
                 if not (stop and r["iteration"] == stop)]:
        raise AssertionError(f"checkpoints at {saved}, checks at "
                             f"{[r['iteration'] for r in checks]}")
    latest = checkpoint.restore_latest(str(out / "m"))
    if latest["step"] != saved[-1] \
            or int(latest["opt_state"]["count"]) != saved[-1]:
        raise AssertionError(f"newest checkpoint at step {latest['step']}")
    if not {"train_loss", "validation"} <= {r["kind"] for r in records}:
        raise AssertionError(f"metric kinds {[r['kind'] for r in records]}")
    per_step = 2 * cfg.encoder.n_layers
    for s in result.steps:
        if (s["launches"], s["twin_launches"]) != (per_step, per_step):
            raise AssertionError(f"step {s['iteration']}: {s['launches']} "
                                 f"forward and {s['twin_launches']} twin "
                                 f"launches")
    if fwd != per_step * (steps + len(checks)) or twin != per_step * steps \
            or staircase2.launch_counts() != (fwd, twin):
        raise AssertionError(f"fit launched {fwd} forward and {twin} twin "
                             f"block_direction passes in {steps} steps and "
                             f"{len(checks)} checks; all ops "
                             f"{staircase2.launch_counts()}")
    # d blocks' sums by relation, and the gather-dot route's two sums by id
    # a step (none on the CPU).
    dots = gather_dot_launches()
    check_gather_dot(dots, steps * gather_dot_calls(
        model, loop.loss_kind, loop.pipeline.positives_pad,
        cfg.training.negative_sample_rate), "fit")
    chunks = -(-loop.pipeline.split_size // staircase2._EDGE_CHUNK)
    if id_sums != per_step * chunks * steps + 2 * dots[0]:
        raise AssertionError(f"d blocks' sums by relation and the "
                             f"gather-dot route's sums by id launched "
                             f"kernel 3 {id_sums} times in {steps} steps")
    row = {"steps": steps, "stopped_early": result.stopped_early,
           "best_score": result.best_score, "scores": scores,
           "checks": len(checks), "checkpoints": saved,
           "checkpoint_bytes": (out / f"m-{saved[-1]}.ckpt").stat().st_size,
           "wall_s": wall_s, "steps_per_s_incl_checks": steps / wall_s,
           "step_ms_median": statistics.median(s["step_ms"]
                                               for s in result.steps),
           "batch_ms_median": statistics.median(s["batch_ms"]
                                                for s in result.steps),
           "wait_ms_median": statistics.median(s["wait_ms"]
                                               for s in result.steps),
           "launches": fwd, "twin_launches": twin,
           "sum_by_csr_launches": id_sums, "gather_dot_launches": dots[0],
           "metric_records": len(records),
           "printed_tables": printed.getvalue().count("MRR"),
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "graph_counts": checked_graph_counts(loop, "fit"),
           "routes": [s["graph"] for s in result.steps], "log": logged}
    emit("fit", model=model_label(cfg), phase_s=time.perf_counter() - t_phase,
         **row)
    return row


def new_loop(cfg, ds, device, *, prefetch, threads=2):
    model = build.build_model(cfg, device)
    return engine.TrainLoop(model, cfg, ds, seed=0, log=lambda line: None,
                            prefetch=prefetch, prefetch_threads=threads)


def timed_fit(cfg, ds, device, params0, *, prefetch, threads=2,
              switch_interval=None) -> dict:
    """PREFETCH_STEPS steps of a fresh TrainLoop's fit from a copy of
    ``params0``: steps/s over the call (host clock, synchronized at both
    ends), the medians of the step records, and every step's launches
    checked against ``cfg``'s layers. ``switch_interval``: the
    interpreter's thread switch interval (s) for this run, else its
    default (5 ms)."""
    loop = new_loop(cfg, ds, device, prefetch=prefetch, threads=threads)
    params = map_tree(torch.clone, params0)
    opt_state = loop.optimizer.init(params)
    default_interval = sys.getswitchinterval()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        if switch_interval is not None:
            sys.setswitchinterval(switch_interval)
        result = loop.fit(params, opt_state, max_iterations=PREFETCH_STEPS)
        torch.cuda.synchronize()
    finally:
        sys.setswitchinterval(default_interval)
    wall_s = time.perf_counter() - t0
    per_step = 2 * cfg.encoder.n_layers
    if any((s["launches"], s["twin_launches"]) != (per_step, per_step)
           for s in result.steps):
        raise AssertionError("a step's launches differ from "
                             f"{per_step} forward and {per_step} twin")
    recs = result.steps
    return {"prefetch": prefetch, "threads": threads if prefetch else 0,
            "graph_counts": checked_graph_counts(loop, "prefetch"),
            "switch_interval_s": switch_interval or default_interval,
            "steps": len(recs), "wall_s": wall_s,
            "steps_per_s": len(recs) / wall_s,
            "step_ms_median": statistics.median(s["step_ms"] for s in recs),
            "batch_ms_median": statistics.median(s["batch_ms"]
                                                 for s in recs),
            "wait_ms_median": statistics.median(s["wait_ms"] for s in recs),
            "loss_last": recs[-1]["loss"]}


def fit_profile(cfg, ds, device, params0, *, prefetch) -> dict:
    """torch.profiler over a whole fit of PROFILE_STEPS steps (batches
    made as fit makes them, so the host's share shows): the device's busy
    time (the union of its kernel and copy intervals) against the window
    from its first activity to its last. The profiler records the
    producers' host operators too, and slows the run it traces: the
    window is that run's, not an unprofiled one's."""
    from torch.profiler import ProfilerActivity, profile
    loop = new_loop(cfg, ds, device, prefetch=prefetch)
    params = map_tree(torch.clone, params0)
    opt_state = loop.optimizer.init(params)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        loop.fit(params, opt_state, max_iterations=PROFILE_STEPS)
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == cuda
                   and e.time_range.end > e.time_range.start)
    if not spans:
        return {"profile": "not measured: the profiler saw no device time"}
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy += hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    busy += hi - lo
    window = max(b for _, b in spans) - spans[0][0]
    return {"profiled_steps": PROFILE_STEPS,
            "device_window_ms_per_step": window / 1e3 / PROFILE_STEPS,
            "device_busy_ms_per_step": busy / 1e3 / PROFILE_STEPS,
            "device_idle_share": 1.0 - busy / window}


def background_load(kind: str, pipeline):
    """A thread's work for the contention diagnostic, looping until the
    returned event is set: host batches (``pipeline.next``, as a producer
    builds them, without the copies), a pure-Python loop (holds the
    interpreter lock), or numpy sorts of 4M floats (release it), or
    nothing."""
    stop = threading.Event()
    rng = np.random.default_rng(1)
    data = rng.random(1 << 22)

    def python_loop():
        x = 0
        for i in range(100_000):
            x += i * i
        return x
    work = {"host_batches": pipeline.next, "python": python_loop,
            "numpy_sort": lambda: np.sort(data)}.get(kind)

    def run():
        while not stop.is_set():
            work()
    thread = threading.Thread(target=run, daemon=True) if work else None
    if thread:
        thread.start()
    return stop, thread


def contended_steps(cfg, ds, device, params0, kind: str) -> dict:
    """PREFETCH_STEPS serial steps while one background thread runs
    ``kind`` (background_load): the median device step and host batch,
    and steps/s. Which load lengthens the step says whether the main
    thread's dispatch loses to the interpreter lock or to the CPU."""
    loop = new_loop(cfg, ds, device, prefetch=False)
    params = map_tree(torch.clone, params0)
    opt_state = loop.optimizer.init(params)
    helper = engine.BatchPipeline(loop.model, cfg, ds,
                                  np.random.default_rng(7))
    stop, thread = background_load(kind, helper)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = loop.fit(params, opt_state, max_iterations=PREFETCH_STEPS)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    finally:
        stop.set()
        if thread:
            thread.join(60)
    recs = result.steps
    return {"load": kind, "steps_per_s": len(recs) / wall_s,
            "step_ms_median": statistics.median(s["step_ms"] for s in recs),
            "batch_ms_median": statistics.median(s["batch_ms"]
                                                 for s in recs)}


def consumed_hashes(cfg, ds, device, params0, *, prefetch, threads=2):
    loop = new_loop(cfg, ds, device, prefetch=prefetch, threads=threads)
    hashes = hashing(loop)
    params = map_tree(torch.clone, params0)
    loop.fit(params, loop.optimizer.init(params), max_iterations=HASH_STEPS)
    return hashes


def phase_prefetch(cfg, ds, device, phase="prefetch"):
    """Serial against prefetched batches, in turns in one process (serial,
    prefetch, prefetch, serial; 2 producer threads), PREFETCH_STEPS steps
    each from the same weights; then prefetch at the default thread switch
    interval against FAST_SWITCH (fast, default, default, fast), the
    diagnostic of the interpreter lock; the device busy time of a whole
    fit of PROFILE_STEPS steps each way (torch.profiler) and the idle
    share it gives over the unprofiled runs' step time; and the stream
    check: prefetch with one producer consumes the serial run's batches,
    hash for hash. Beside them the contention diagnostic: serial steps
    while one thread builds host batches, runs pure Python, sorts with
    numpy, or nothing (contended_steps)."""
    t_phase = time.perf_counter()
    params0 = build.build_model(cfg, device).init_params(
        torch.Generator().manual_seed(0))
    runs = [timed_fit(cfg, ds, device, params0, prefetch=p)
            for p in (False, True, True, False)]
    runs += [timed_fit(cfg, ds, device, params0, prefetch=True,
                       switch_interval=s)
             for s in (FAST_SWITCH, None, None, FAST_SWITCH)]
    profiles = {name: fit_profile(cfg, ds, device, params0, prefetch=p)
                for name, p in (("serial", False), ("prefetch", True))}
    contention = [contended_steps(cfg, ds, device, params0, kind)
                  for kind in ("none", "host_batches", "python",
                               "numpy_sort", "none")]
    serial = consumed_hashes(cfg, ds, device, params0, prefetch=False)
    one = consumed_hashes(cfg, ds, device, params0, prefetch=True,
                          threads=1)
    if serial != one or len(serial) != HASH_STEPS:
        raise AssertionError("prefetch with one producer consumed other "
                             "batches than the serial run")

    def mean(key, prefetch, interval=None):
        vals = [r[key] for r in runs if r["prefetch"] == prefetch
                and (interval is None or r["switch_interval_s"] == interval)]
        return sum(vals) / len(vals)
    default = sys.getswitchinterval()
    serial = mean("steps_per_s", False)
    prefetched = mean("steps_per_s", True, default)
    fast = mean("steps_per_s", True, FAST_SWITCH)
    for name, rate in (("serial", serial), ("prefetch", prefetched)):
        busy = profiles[name].get("device_busy_ms_per_step")
        if busy is not None:
            profiles[name]["device_idle_share_unprofiled"] = \
                1.0 - busy * rate / 1e3
    row = {"runs": runs, "profiles": profiles,
           "serial_steps_per_s": serial, "prefetch_steps_per_s": prefetched,
           "speedup": prefetched / serial,
           "contention": contention,
           "fast_switch_steps_per_s": fast,
           "fast_switch_speedup": fast / serial,
           "one_producer_equals_serial": True, "hashed_steps": HASH_STEPS}
    emit(phase, model=model_label(cfg), phase_s=time.perf_counter() - t_phase,
         **row)
    return row


def phase_resume(cfg, ds, device):
    """RESUME_STEPS steps straight against half of them and a resume to
    RESUME_STEPS in a fresh loop, saves every 10 steps, prefetch on 2
    threads, at PyTorch's default settings (no deterministic algorithms):
    the batches of the second half equal hash for hash, the losses and the
    params bit for bit."""
    t_phase = time.perf_counter()
    out = fresh_dir("resume")
    cfg = with_optimizer(cfg, save_every_n=RESUME_STEPS // 2)
    loop = new_loop(cfg, ds, device, prefetch=True)
    straight = hashing(loop)
    params, opt_state = loop.init_state(0)
    whole = loop.fit(params, opt_state, max_iterations=RESUME_STEPS,
                     checkpoint_path=str(out / "a"))
    graphs = checked_graph_counts(loop, "resume")
    loop = new_loop(cfg, ds, device, prefetch=True)
    params, opt_state = loop.init_state(0)
    loop.fit(params, opt_state, max_iterations=RESUME_STEPS // 2,
             checkpoint_path=str(out / "b"))
    loop = new_loop(cfg, ds, device, prefetch=True)
    resumed = hashing(loop)
    tail = loop.resume(str(out / "b"), max_iterations=RESUME_STEPS)
    torch.cuda.synchronize()
    graphs_resumed = checked_graph_counts(loop, "resume")
    half = RESUME_STEPS // 2
    if straight[half:] != resumed or len(resumed) != half:
        raise AssertionError("the resumed run consumed other batches")
    losses = [s["loss"] for s in whole.steps[half:]]
    if losses != [s["loss"] for s in tail.steps]:
        raise AssertionError("the resumed run's losses differ")
    unequal = [list(a.shape) for a, b in zip(tree_leaves(whole.params),
                                             tree_leaves(tail.params))
               if not torch.equal(a, b)]
    unequal += [list(a.shape) for a, b in zip(
        tree_leaves(whole.opt_state), tree_leaves(tail.opt_state))
        if not torch.equal(a, b)]
    if unequal:
        raise AssertionError(f"params or Adam state differ after the "
                             f"resume: leaves {unequal}")
    row = {"steps": RESUME_STEPS, "resumed_at": half,
           "batches_equal": True, "losses_equal": True,
           "params_and_state_equal_bitwise": True,
           "graph_counts": graphs, "graph_counts_resumed": graphs_resumed,
           "deterministic_algorithms":
               torch.are_deterministic_algorithms_enabled(),
           "loss_last": losses[-1]}
    emit("resume", model=model_label(cfg),
         phase_s=time.perf_counter() - t_phase, **row)
    return row


GRAPH_STEPS = 60


def graph_run(cfg, ds, device, params0, graph: bool) -> dict:
    """GRAPH_STEPS steps of a fresh loop's fit (prefetch on 2 threads)
    from a copy of ``params0``, by the loop's own step, or with ``graph``
    false op by op (``TrainLoop.eager_step``: the sync-free eager step).
    Read over the steps after the capture's: the mean host ms of a step's
    dispatch (``fit.train_step``), of each span and of its period
    (``fit.step``), the rate,
    the median device step; peak and reserved device memory over the
    run."""
    logged = []
    loop = engine.TrainLoop(build.build_model(cfg, device), cfg, ds, seed=0,
                            log=logged.append)
    if not graph:
        ref = weakref.ref(loop)  # no cycle (hashing)
        loop.train_step = lambda p, s, b: ref().eager_step(p, s, b,
                                                           ref().draw(b))
    params = map_tree(torch.clone, params0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    result = loop.fit(params, loop.optimizer.init(params),
                      max_iterations=GRAPH_STEPS)
    torch.cuda.synchronize()
    recs = result.steps[engine.GRAPH_WARMUP_STEPS + 1:]
    period_ms = statistics.mean(s["spans"]["fit.step"][0] for s in recs)
    return {"graph": graph, "counts": dict(loop.graph_counts),
            "routes": [s["graph"] for s in result.steps],
            "losses": [s["loss"] for s in result.steps],
            "host_step_ms": statistics.mean(
                s["spans"]["fit.train_step"][0] for s in recs),
            "host_step_cpu_ms": statistics.mean(
                s["spans"]["fit.train_step"][1] for s in recs),
            "span_wall_ms": {name: statistics.mean(
                s["spans"].get(name, [0.0])[0] for s in recs)
                for name in recs[-1]["spans"]},
            "period_ms": period_ms, "steps_per_s": 1e3 / period_ms,
            "triples_per_s": loop.pipeline.n_positives * 1e3 / period_ms,
            "device_step_ms_median": statistics.median(
                s["step_ms"] for s in recs),
            "wait_ms": statistics.mean(s["wait_ms"] for s in recs),
            "batch_ms": statistics.mean(s["batch_ms"] for s in recs),
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "memory_reserved": torch.cuda.memory_reserved(), "log": logged}


def phase_graph(cfg, ds, device, phase="graph"):
    """``graph_run`` by the graph and op by op in turns (graph, eager,
    eager, graph) from the same weights: every run's losses equal, the
    graph runs captured once and replayed every later step with no failed
    capture; the row gives both sides' readings and their ratios."""
    t_phase = time.perf_counter()
    params0 = build.build_model(cfg, device).init_params(
        torch.Generator().manual_seed(0))
    runs = [graph_run(cfg, ds, device, params0, graph)
            for graph in (True, False, False, True)]
    warm = engine.GRAPH_WARMUP_STEPS
    want = {"captures": 1, "replays": GRAPH_STEPS - warm - 1,
            "eager": warm, "failed_captures": 0}
    for r in runs:
        if r["losses"] != runs[0]["losses"]:
            raise AssertionError(f"{phase}: the graph and the eager runs' "
                                 f"losses differ")
        if r["graph"] and r["counts"] != want:
            raise AssertionError(f"{phase}: graph counts {r['counts']}, "
                                 f"expected {want}; {r['log']}")

    def mean(key, graph):
        vals = [r[key] for r in runs if r["graph"] == graph]
        return sum(vals) / len(vals)
    row = {"runs": [{k: v for k, v in r.items() if k != "losses"}
                    for r in runs],
           "losses_equal": True, "loss_last": runs[0]["losses"][-1],
           "replay_host_step_ms": mean("host_step_ms", True),
           "eager_host_step_ms": mean("host_step_ms", False),
           "graph_steps_per_s": mean("steps_per_s", True),
           "eager_steps_per_s": mean("steps_per_s", False),
           "speedup": mean("steps_per_s", True) / mean("steps_per_s", False),
           "card": nvidia_smi_line()}
    emit(phase, model=model_label(cfg), phase_s=time.perf_counter() - t_phase,
         **{k: v for k, v in row.items() if k != "runs"})
    emit(f"{phase}_runs", runs=row["runs"])
    return row


DETERMINISM_STEPS = 10


def determinism_cells(ds):
    """(label, config) of the determinism phase: gcn_block in f32 (d
    blocks' sums by relation), gcn_basis with bf16 message and stream
    precision (d C's sums, the fused energies' per-id scalars) and
    distmult on bf16 streams (the fused energies at 272,115 x 10, the
    positives' gathers)."""
    return (("gcn_block", config.load(str(SETTINGS)).with_counts(
                ds.n_entities, ds.n_relations, len(ds.train))),
            ("gcn_basis_bf16", bf16_config(ds, "determinism_basis_bf16",
                                           BASIS_SETTINGS, [BF16_LINE])),
            ("distmult_bf16", bf16_config(
                ds, "determinism_distmult_bf16",
                ROOT / "settings" / "distmult.exp", [])))


def determinism_child() -> int:
    """The determinism phase's child process: for each cell two fits of
    DETERMINISM_STEPS steps from seed 0 as train.py runs them (TrainLoop's
    defaults, batches on 2 producer threads) at PyTorch's default
    settings; one JSON line a cell with both fits' step times and the
    leaves of the params and the Adam state that differ between them.
    Returns 1 where any differs, else 0. Uses only what the port had
    before its sums by id, so that it also runs on that checkout."""
    device = torch.device("cuda:0")
    ds = synthetic.like("FB15k-237", seed=0)
    differ = False
    for label, cfg in determinism_cells(ds):
        t_cell = time.perf_counter()
        fits = []
        for _ in range(2):
            loop = engine.TrainLoop(build.build_model(cfg, device), cfg, ds,
                                    seed=0, log=lambda line: None)
            fits.append(loop.fit(max_iterations=DETERMINISM_STEPS))
            torch.cuda.synchronize()
        a, b = fits
        unequal = [f"{part} {i} {list(x.shape)}"
                   for part in ("params", "opt_state")
                   for i, (x, y) in enumerate(zip(
                       tree_leaves(getattr(a, part)),
                       tree_leaves(getattr(b, part))))
                   if not torch.equal(x, y)]
        differ = differ or bool(unequal)
        emit("determinism_cell", label=label, model=model_label(cfg),
             steps=DETERMINISM_STEPS,
             step_ms_median=[statistics.median(s["step_ms"]
                                               for s in f.steps)
                             for f in fits],
             losses_equal=[s["loss"] for s in a.steps]
             == [s["loss"] for s in b.steps],
             params_and_state_equal_bitwise=not unequal,
             unequal_leaves=unequal,
             deterministic_algorithms=(
                 torch.are_deterministic_algorithms_enabled()),
             cublas_workspace_config=os.environ.get(
                 "CUBLAS_WORKSPACE_CONFIG"),
             card=nvidia_smi_line(), cell_s=time.perf_counter() - t_cell)
    return 1 if differ else 0


def phase_determinism():
    """determinism_child in a process of its own whose environment lacks
    CUBLAS_WORKSPACE_CONFIG (the port's entry points do not set it):
    params and Adam state equal bit for bit in every cell, or the phase
    fails."""
    t_phase = time.perf_counter()
    env = {k: v for k, v in os.environ.items()
           if k != "CUBLAS_WORKSPACE_CONFIG"}
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                           "--determinism-child"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    cells = [json.loads(line) for line in proc.stdout.splitlines()
             if line.startswith('{"phase": "determinism_cell"')]
    row = {"cells": cells, "child_rc": proc.returncode,
           "card": nvidia_smi_line()}
    emit("determinism", phase_s=time.perf_counter() - t_phase, **row)
    if proc.returncode != 0 or len(cells) != 3 or not all(
            c["params_and_state_equal_bitwise"] for c in cells):
        raise AssertionError(f"two fits at one seed differ, or the child "
                             f"failed: {proc.stderr[-3000:]}")
    return row


# The quality phase: the JAX capstone's mid-size learnable graph
# (benchmarks/e2e_quality_run.py:89-94 at 2,000 entities; 3.3 s of host
# time to draw, where FB15k-237's counts take 118 s) and its teacher's
# ceiling from docs/QUALITY.md, a quality reference.
QUALITY_GRAPH = (2000, 40, 60000, 5000, 5000)
QUALITY_DRAW = dict(latent_dim=16, temperature=0.4, seed=0)
TEACHER_MRR, TEACHER_H10, TEACHER_TOL = 0.4742, 0.6018, 1e-4
# The shipped cadence (2,000 / 6,000) cut to fit the phase's time.
QUALITY_CUTS = {"early_stopping_check_every": 500,
                "early_stopping_burnin": 1000}
QUALITY_VALID = 2000
QUALITY_BLOCK_STEPS = 2000
QUALITY_DISTMULT_STEPS = 500
QUALITY_TRACE_STEPS = 5
# The first 200 test triples bound the dumps' text.
QUALITY_DUMP_TRIPLES = 200
ENSEMBLE_WEIGHTS = (1.0, 0.0, 0.5)
ENSEMBLE_CUTOFF = 1000  # tools/ensemble.py's default
# The dumps hold sigmoids and the ensemble counts ties against the gold,
# so a weight of 1 or 0 may rank a near-tie one lower than the Scorer.
ENSEMBLE_TOL = 1e-3
# Gates, set before the first run: gcn_block at half the JAX capstone's
# validation MRR at 2,000 steps (0.257, docs/QUALITY.md, a TPU quality
# reference), 260x chance; DistMult at tests/test_learning_quality.py's
# ratios; every model at 3x its untrained MRR.
BLOCK_MRR_GATE = 0.13
DISTMULT_CHANCE_GATE = 18.0
UNTRAINED_GATE = 3.0
# The block kernel's symbol, as the profiler's trace names its launches.
TRACE_KERNEL = "block_direction_kernel"


class TeacherView:
    """The generator's own DistMult, <e_s * w_r, e_o>, as a Scorer model
    (``benchmarks/e2e_quality_run.py:142-175``): float64 scores of every
    candidate on the card; the temperature scales them monotonically."""

    def __init__(self, ds, device):
        ent, rel = synthetic.teacher_factors(
            ds.n_entities, ds.n_relations,
            latent_dim=QUALITY_DRAW["latent_dim"], seed=QUALITY_DRAW["seed"])
        self.ent = torch.from_numpy(ent).to(device)
        self.rel = torch.from_numpy(rel).to(device)

    def _rows(self, chunk):
        return torch.from_numpy(chunk).to(self.ent.device).long()

    def score_all_subjects(self, params, graph, chunk, apply_sigmoid=False):
        t = self._rows(chunk)
        return (self.rel[t[:, 1]] * self.ent[t[:, 2]]) @ self.ent.T

    def score_all_objects(self, params, graph, chunk, apply_sigmoid=False):
        t = self._rows(chunk)
        return (self.ent[t[:, 0]] * self.rel[t[:, 1]]) @ self.ent.T

    def invalidate(self):
        pass


def quality_teacher(ds, device) -> dict:
    """The teacher's filtered test metrics through the port's Scorer, held
    to docs/QUALITY.md's ceiling within TEACHER_TOL: ``learnable``,
    ``teacher_factors`` and the Scorer together."""
    scorer = Scorer(metric="MRR")
    for t in (ds.train, ds.valid, ds.test):
        scorer.register_data(t)
    scorer.register_model(TeacherView(ds, device), None, None,
                          n_entities=ds.n_entities)
    got = scorer.compute_scores(ds.test).results["Filtered"]
    if abs(got["MRR"] - TEACHER_MRR) > TEACHER_TOL \
            or abs(got["H@10"] - TEACHER_H10) > TEACHER_TOL:
        raise AssertionError(f"teacher ceiling {got}, expected MRR "
                             f"{TEACHER_MRR} and H@10 {TEACHER_H10}")
    return got


def quality_cell(label, cfg, ds, device, steps, ceiling, trace_dir=None):
    """train.py's main path on the learnable graph from seed 0: the
    untrained test filtered MRR, then ``steps`` steps of TrainLoop.fit
    (serial batches) with the filtered MRR of the first QUALITY_VALID
    validation triples as the early stopper's score at the cut cadence;
    the trained test metrics against the ceiling and the gates, and the
    launches of the run's aggregation entry points (4 + 4 a step, 4 more
    forward a validation encode, each with its fix-up; d blocks' sums by
    relation and the bf16 energies' backward on kernel 3). With
    ``trace_dir`` the first QUALITY_TRACE_STEPS steps run inside
    observability.trace, whose file must name the block kernel. Returns
    (row, scorer, trained params)."""
    t_cell = time.perf_counter()
    cfg = with_optimizer(cfg, **QUALITY_CUTS)
    model = build.build_model(cfg, device)
    op = staircase2.block_direction if model.is_gcn else None
    pre = "bf16_" if model.agg_dtype is not None else ""
    scorer = train_cli.build_scorer(model, ds, "MRR")
    valid = ds.valid[:QUALITY_VALID]
    curve = []

    def score_validation(params) -> float:
        scorer.set_params(params)
        mrr = scorer.compute_scores(valid).results["Filtered"]["MRR"]
        curve.append(mrr)
        return mrr

    logged = []
    loop = engine.TrainLoop(model, cfg, ds, seed=0, log=logged.append,
                            scoring_function=score_validation,
                            prefetch=False)
    params, opt_state = loop.init_state(0)
    scorer.set_params(params)
    untrained = scorer.compute_scores(ds.test).results["Filtered"]["MRR"]
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    records, traced = [], None
    start = 0
    if trace_dir is not None:
        with observability.trace(str(trace_dir)) as traced:
            first = loop.fit(params, opt_state,
                             max_iterations=QUALITY_TRACE_STEPS)
            torch.cuda.synchronize()
        params, opt_state, start = first.params, first.opt_state, \
            first.iterations
        records += first.steps
    result = loop.fit(params, opt_state, start_iteration=start,
                      max_iterations=steps)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    records += result.steps
    launches = getattr(op, pre + "launches") if op else 0
    twin = getattr(op, pre + "twin_launches") if op else 0
    routes = route_launches()
    energies = energy_launches()
    dots = gather_dot_launches()
    id_sums = sum_by_csr_op().launches
    check_helper_launches(op, launches, twin,
                          staircase2.basis_direction.project_launches,
                          staircase2.basis_direction.split_launches,
                          fixup_counts(), energies)
    check_other_precision_idle(pre == "bf16_")
    n = result.iterations
    per_layer = 2 * cfg.encoder.n_layers if op else 0
    chunks = -(-loop.pipeline.split_size // staircase2._EDGE_CHUNK)
    want_energies = n * fused_energy_launches(
        model, loop.loss_kind, loop.pipeline.positives_pad,
        cfg.training.negative_sample_rate)
    check_gather_dot(dots, n * gather_dot_calls(
        model, loop.loss_kind, loop.pipeline.positives_pad,
        cfg.training.negative_sample_rate), label)
    if (launches, twin) != (per_layer * (n + len(curve)), per_layer * n) \
            or staircase2.launch_counts() != (launches, twin) \
            or energies != want_energies \
            or id_sums != per_layer * chunks * n + energies + 2 * dots[0]:
        raise AssertionError(
            f"{label}: {launches} forward, {twin} twin, {energies} energies' "
            f"and {id_sums} sum_by_csr launches in {n} steps and "
            f"{len(curve)} checks; all ops {staircase2.launch_counts()}")
    trace = {}
    if traced is not None:
        text = Path(traced).read_text()
        trace = {"trace_file": str(Path(traced).relative_to(ROOT)),
                 "trace_bytes": len(text),
                 "trace_names_block_kernel": TRACE_KERNEL in text}
        if not trace["trace_names_block_kernel"]:
            raise AssertionError(f"{label}: the trace {traced} names no "
                                 f"{TRACE_KERNEL}")
    scorer.set_params(result.params)
    test = scorer.compute_scores(ds.test).results["Filtered"]
    every = cfg.optimizer.early_stopping_check_every
    mrr_gate = BLOCK_MRR_GATE if op else DISTMULT_CHANCE_GATE / ds.n_entities
    row = {"cell": label, "model": model_label(cfg),
           "precision": {"message": "bfloat16" if pre else "float32",
                         "stream": "float32" if model.stream_dtype is None
                         else "bfloat16"},
           "loss_kind": loop.loss_kind, "steps": n,
           "stopped_early": result.stopped_early,
           "positives": loop.pipeline.n_positives,
           "message_edges": loop.pipeline.split_size,
           "untrained_test_mrr": untrained,
           "validation_curve": [{"iteration": every * (i + 1), "mrr": v}
                                for i, v in enumerate(curve)],
           "test_mrr": test["MRR"], "test_h10": test["H@10"],
           "test_h1": test["H@1"], "test_h3": test["H@3"],
           "fraction_of_ceiling": test["MRR"] / ceiling,
           "chance": 1.0 / ds.n_entities,
           "gates": {"test_mrr_min": mrr_gate,
                     "untrained_ratio_min": UNTRAINED_GATE},
           "loss_first": records[0]["loss"], "loss_last": result.last_loss,
           "wall_s": wall_s, "steps_per_s_incl_checks": n / wall_s,
           "steps_per_s": loop.timer.summary()["steps_per_sec"],
           "step_ms_median": statistics.median(s["step_ms"]
                                               for s in records),
           "batch_ms_median": statistics.median(s["batch_ms"]
                                                for s in records),
           "launches": launches, "twin_launches": twin,
           "energy_launches": energies, "gather_dot_launches": dots[0],
           "sum_by_csr_launches": id_sums,
           "fixup_launches": sum(fixup_counts().values()),
           "graph_counts": checked_graph_counts(loop, label),
           **routes, "op": op.__name__ if op else None, **trace,
           "card": nvidia_smi_line(),
           "cell_s": time.perf_counter() - t_cell}
    row["passed"] = test["MRR"] >= mrr_gate \
        and test["MRR"] >= UNTRAINED_GATE * untrained
    emit("quality_cell", **row)
    if not row["passed"]:
        raise AssertionError(f"{label}: test filtered MRR {test['MRR']} "
                             f"under its gate ({mrr_gate}, or "
                             f"{UNTRAINED_GATE}x the untrained {untrained})")
    return row, scorer, result.params


def quality_dumps(label, scorer, params, triples) -> tuple:
    """The score dumps (``subjects.test``, ``objects.test``) and the
    degree dumps under the names tools/ensemble.CutoffEnsemble reads
    (``degrees.in``, ``degrees.out``) of ``triples`` in
    build/chip_smoke/quality/<label>; (the folder, the filtered MRR the
    Scorer gives them)."""
    out = fresh_dir(f"quality/{label}")
    scorer.set_params(params)
    summary = scorer.compute_scores(triples)
    summary.dump_degrees(str(out / "degrees.in"), str(out / "degrees.out"))
    scorer.dump_all_scores(triples, str(out / "subjects.test"),
                           str(out / "objects.test"))
    return str(out), summary.results["Filtered"]


def quality_ensemble(rgcn, distmult) -> dict:
    """The R-GCN+ ensemble of the two dumps (``tools/ensemble.py``):
    WeightEnsemble at ENSEMBLE_WEIGHTS and CutoffEnsemble at its default
    cutoff; weight 1 must give the R-GCN's filtered MRR over the dumped
    triples and weight 0 DistMult's, each within ENSEMBLE_TOL."""
    (rgcn_dir, rgcn_mrr), (dm_dir, dm_mrr) = rgcn, distmult
    runs = {f"weight_{w}": ensemble.WeightEnsemble(w, rgcn_dir, dm_dir)
            for w in ENSEMBLE_WEIGHTS}
    runs["cutoff"] = ensemble.CutoffEnsemble(ENSEMBLE_CUTOFF, rgcn_dir,
                                             dm_dir)
    out = {}
    for name, e in runs.items():
        e.compute_ranks()
        out[name] = {"mrr": e.combined_mrr(),
                     **{f"h{k}": e.hits_at(k) for k in (1, 3, 10)}}
    out["weight_1.0_minus_rgcn"] = out["weight_1.0"]["mrr"] - rgcn_mrr["MRR"]
    out["weight_0.0_minus_distmult"] = out["weight_0.0"]["mrr"] \
        - dm_mrr["MRR"]
    if abs(out["weight_1.0_minus_rgcn"]) > ENSEMBLE_TOL \
            or abs(out["weight_0.0_minus_distmult"]) > ENSEMBLE_TOL:
        raise AssertionError(f"ensemble at weights 1 / 0 {out}, Scorer "
                             f"{rgcn_mrr['MRR']} / {dm_mrr['MRR']}")
    return out


def phase_quality(device) -> dict:
    """The learning-quality gate on the card (module docstring): the
    learnable graph, the teacher's ceiling, gcn_block in f32 (its first
    steps traced) and bf16, DistMult, their dumps and the R-GCN+
    ensemble. Returns the cells' rows by path name."""
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    ds = synthetic.learnable(*QUALITY_GRAPH, **QUALITY_DRAW)
    emit("quality_graph", entities=ds.n_entities, relations=ds.n_relations,
         train=len(ds.train), valid=len(ds.valid), test=len(ds.test),
         **QUALITY_DRAW, generation_s=time.perf_counter() - t0,
         phase_s=time.perf_counter() - t_phase)
    teacher = quality_teacher(ds, device)
    emit("quality_teacher", **teacher, phase_s=time.perf_counter() - t_phase)
    ceiling = teacher["MRR"]

    def counted(settings):
        return config.load(str(settings)).with_counts(
            ds.n_entities, ds.n_relations, len(ds.train))

    rows, dumps = {}, {}
    triples = ds.test[:QUALITY_DUMP_TRIPLES]
    for label, cfg, steps, trace in (
            ("gcn_block", counted(SETTINGS), QUALITY_BLOCK_STEPS, True),
            ("gcn_block_bf16", bf16_config(ds, "quality_bf16", SETTINGS,
                                           [BF16_LINE]),
             QUALITY_BLOCK_STEPS, False),
            ("distmult", counted(ROOT / "settings" / "distmult.exp"),
             QUALITY_DISTMULT_STEPS, False)):
        row, scorer, params = quality_cell(
            label, cfg, ds, device, steps, ceiling,
            SMOKE_DIR / "quality" / "trace" if trace else None)
        rows[f"quality_{label}"] = row
        if label != "gcn_block_bf16":
            dumps[label] = quality_dumps(label, scorer, params, triples)
        del scorer, params
    dumped = {k: v[1] for k, v in dumps.items()}
    ens = quality_ensemble(dumps["gcn_block"], dumps["distmult"])
    emit("quality", teacher=teacher, dump_triples=len(triples),
         dumped_filtered=dumped, ensemble=ens,
         cells={k: {key: r[key] for key in (
             "test_mrr", "test_h10", "fraction_of_ceiling",
             "untrained_test_mrr", "validation_curve", "steps_per_s",
             "launches", "twin_launches")} for k, r in rows.items()},
         card=nvidia_smi_line(), phase_s=time.perf_counter() - t_phase)
    return rows


def mean_of(items, key, sub=None) -> float:
    """The mean of ``key`` (of its entry ``sub``) over phase rows."""
    pick = (lambda r: r[key]) if sub is None else (lambda r: r[key][sub])
    return sum(pick(r) for r in items) / len(items)


def mean_or_none(items, key):
    """The mean of ``key`` over phase rows, or None where a row has none
    (a device time the profiler did not report)."""
    values = [r[key] for r in items]
    return None if None in values else sum(values) / len(values)


def merge_path_numbers(full, batch, prefix="") -> dict:
    """A merge-path kernel's items, hub/other times and items sweeps, means
    over the two directions of the full graph and of the training batch's
    graph (phase rows whose keys carry ``prefix``)."""
    sweep = f"{prefix}items_sweep_ms"
    return {"items": full[0][f"{prefix}items"],
            "train_batch_items": batch[0][f"{prefix}items"],
            "hub_rows_only_ms": mean_of(full, f"{prefix}hub_rows_only_ms"),
            "other_rows_only_ms": mean_of(full,
                                          f"{prefix}other_rows_only_ms"),
            "items_sweep_ms": {k: mean_of(full, sweep, k)
                               for k in full[0][sweep]},
            "train_batch_items_sweep_ms": {k: mean_of(batch, sweep, k)
                                           for k in batch[0][sweep]}}


def kernels_line(rows, serve, grads, train, fit, paths) -> list:
    """The block kernel's two entries with this run's numbers.
    block_direction is timed on the full train graph (the serving path's
    shape) and on the first training batch's graph; block_direction_twin
    on the training batch (its path) and on the full train graph. Times and
    bounds are means over the two directions; launches are the training
    run's, and beside them the serving run's, the fit run's (train.py's
    main path: steps and validation encodes) and those of the other paths
    (the quality phase's gcn_block run, the negative protocols, the MLP
    decoder and the encoder variants; ``paths``: phase rows by phase)."""
    full = [r for r in rows if r.get("graph") == "full_train"]
    batch = [r for r in rows if r.get("graph") == "train_batch"]
    layouts = [r for r in rows if "layout" in r]
    g_batch = [r for r in grads if r["graph"] == "train_batch"]
    g_full = [r for r in grads if r["graph"] == "full_train"]
    return [{
        "name": "block_direction", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": train["launches"],
        "launches_serve": serve["launches"],
        "launches_fit": fit["launches"],
        "launches_by_path": {k: r["launches"] for k, r in paths.items()},
        "fixup_launches": train["fixup_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in full + batch),
        "max_over_allowance": max(r["over_allowance"] for r in rows),
        "ms": mean_of(full, "kernel_ms"), "plain_ms": mean_of(full,
                                                              "plain_ms"),
        "bound_ms": mean_of(full, "bound_ms"),
        "bound_by": full[0]["bound_by"], "library_ms": None,
        "library": "none: the one-call form is a [V*d, V*d] sparse matrix "
                   "of E*B*dr*dr entries",
        **merge_path_numbers(full, batch),
        "relation_0_ms": mean_of(full, "relation_0_ms"),
        "runs": mean_of(full, "runs"),
        "grouped_w_tiles": {k: mean_of(full, "grouped_w_tiles", k)
                            for k in full[0]["grouped_w_tiles"]},
        "x_gather_bytes": mean_of(full, "x_gather_bytes"),
        "w_reload_bytes": mean_of(full, "w_reload_bytes"),
        "train_batch_ms": mean_of(batch, "kernel_ms"),
        "train_batch_plain_ms": mean_of(batch, "plain_ms"),
        "train_batch_bound_ms": mean_of(batch, "bound_ms"),
        "train_batch_relation_0_ms": mean_of(batch, "relation_0_ms"),
        "layouts_ms": {r["layout"]: r["kernel_ms"] for r in layouts
                       if r["kernel"] == "block_direction"}}, {
        "name": "block_direction_twin", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": REPLACES_TWIN,
        "launches": train["twin_launches"],
        "launches_fit": fit["twin_launches"],
        "launches_by_path": {k: r.get("twin_launches", 0)
                             for k, r in paths.items()},
        "max_abs_err": max(r["twin_max_abs_err"] for r in grads),
        "max_over_allowance": max(r["twin_over_allowance"] for r in grads),
        "ms": mean_of(g_batch, "twin_kernel_ms"),
        "plain_ms": mean_of(g_batch, "twin_plain_ms"),
        "bound_ms": mean_of(g_batch, "twin_bound_ms"),
        "bound_by": g_batch[0]["twin_bound_by"], "library_ms": None,
        **merge_path_numbers(g_full, g_batch, "twin_"),
        "full_train_ms": mean_of(g_full, "twin_kernel_ms"),
        "full_train_plain_ms": mean_of(g_full, "twin_plain_ms"),
        "full_train_bound_ms": mean_of(g_full, "twin_bound_ms"),
        "full_train_relation_0_ms": mean_of(g_full, "twin_relation_0_ms"),
        "layouts_ms": {r["layout"]: r["kernel_ms"] for r in layouts
                       if r["kernel"] == "block_direction_twin"}}]


def sum_by_csr_line(grads, runs) -> list:
    """Kernel 3's f32 entry point as ops/gather.sum_by_csr runs it: the
    sums by relation of d blocks (timed on one chunk of the first training
    batch's graph, the train step's shape, and of the full train graph;
    means over the directions), index_add_ beside it as the library call;
    launches those of every training path (``runs``: phase -> row), d
    blocks, d C and the fused energies' per-id scalars together."""
    batch = [r for r in grads if r["graph"] == "train_batch"]
    full = [r for r in grads if r["graph"] == "full_train"]
    return [{
        "name": "sum_by_csr", "route": "cuda", "source": STAIRCASE_SOURCE,
        "replaces": REPLACES_STAIRCASE,
        "launches": sum(r.get("sum_by_csr_launches", 0)
                        for r in runs.values()),
        "launches_by_path": {k: r.get("sum_by_csr_launches", 0)
                             for k, r in runs.items()},
        "max_abs_err": max(r["sum_max_abs_err"] for r in grads),
        "max_over_allowance": max(r["sum_over_allowance"] for r in grads),
        "entries": batch[0]["sum_entries"], "width": batch[0]["sum_width"],
        "ms": mean_of(batch, "sum_ms"),
        "kernel_device_ms": mean_or_none(batch, "sum_kernel_device_ms"),
        "fixup_device_ms": mean_or_none(batch, "sum_fixup_device_ms"),
        "csr_ms": mean_of(batch, "sum_csr_ms"),
        "plain_ms": mean_of(batch, "sum_plain_ms"),
        "bound_ms": mean_of(batch, "sum_bound_ms"),
        "bound_by": batch[0]["sum_bound_by"],
        "library_ms": mean_of(batch, "sum_library_ms"),
        "library": "index_add_ into zeros (atomics)",
        "full_train_ms": mean_of(full, "sum_ms"),
        "full_train_library_ms": mean_of(full, "sum_library_ms"),
        "dblocks_ms": mean_of(batch, "dblocks_ms"),
        "dblocks_index_add_ms": mean_of(batch, "dblocks_index_add_ms"),
        "full_train_dblocks_ms": mean_of(full, "dblocks_ms"),
        "full_train_dblocks_index_add_ms": mean_of(full,
                                                   "dblocks_index_add_ms"),
        "card": nvidia_smi_line()}]


def basis_kernels_line(kb, serve, train, paths) -> list:
    """basis_project and basis_combine with this run's numbers.
    basis_project is timed at the forward shape (x [V, d] @ W_flat) and the
    twin shape (g [V, d] @ w_t), torch.matmul beside it. basis_combine is
    timed on the full train graph (the serving path's shape) and on the
    first training batch's graph, forward and twin; times and bounds are
    means over the two directions, torch.sparse.mm of combine_matrix
    beside them. Launches are the training run's, split into forward and
    twin passes, and the serving run's, and those of the other paths
    through these kernels (``paths``: phase rows by phase)."""
    proj = {r["shape"]: r for r in kb if r["kernel"] == "basis_project"}
    comb = [r for r in kb if r["kernel"] == "basis_combine"]
    full = [r for r in comb if r.get("graph") == "full_train"]
    batch = [r for r in comb if r.get("graph") == "train_batch"]
    layouts = [r for r in comb if "layout" in r]
    fwd, twin = proj["forward"], proj["twin"]
    return [{
        "name": "basis_project", "route": "cuda", "source": PROJECT_SOURCE,
        "replaces": REPLACES_BASIS, "replaces_twin": REPLACES_BASIS_TWIN,
        "launches": train["project_launches"],
        "launches_forward": train["launches"],
        "launches_twin": train["twin_launches"],
        "launches_serve": serve["project_launches"],
        "launches_by_path": {k: r["project_launches"]
                             for k, r in paths.items()},
        "max_abs_err": max(r["max_abs_err"] for r in proj.values()),
        "max_over_allowance": max(r["over_allowance"]
                                  for r in proj.values()),
        "tf32_matmul_over_allowance": min(
            fwd["tf32_matmul_over_allowance"],
            twin["tf32_matmul_over_allowance"]),
        "ms": fwd["kernel_ms"], "plain_ms": fwd["plain_ms"],
        "bound_ms": fwd["bound_ms"], "bound_by": fwd["bound_by"],
        "priced_at": fwd["priced_at"],
        "f32_fma_bound_ms": fwd["f32_fma_bound_ms"],
        "library_ms": fwd["library_ms"],
        "library_tf32_ms": fwd["library_tf32_ms"],
        "product_ms": fwd["product_ms"], "split_ms": fwd["split_ms"],
        "twin_ms": twin["kernel_ms"], "twin_library_ms": twin["library_ms"],
        "twin_bound_ms": twin["bound_ms"]}, {
        "name": "tf32_split", "route": "cuda", "source": PROJECT_SOURCE,
        "replaces": REPLACES_BASIS, "launches": train["split_launches"],
        "launches_serve": serve["split_launches"],
        "launches_by_path": {k: r["split_launches"]
                             for k, r in paths.items()},
        "max_abs_err": 0.0, "equals_plain_bitwise": True,
        "ms": fwd["split_ms"], "plain_ms": fwd["split_plain_ms"],
        "bound_ms": fwd["split_bound_ms"], "bound_by": "bytes",
        "library_ms": None}, {
        "name": "basis_combine", "route": "cuda", "source": BASIS_SOURCE,
        "replaces": REPLACES_BASIS, "replaces_twin": REPLACES_BASIS_TWIN,
        "launches": train["launches"] + train["twin_launches"],
        "launches_forward": train["launches"],
        "launches_twin": train["twin_launches"],
        "launches_serve": serve["launches"],
        "launches_by_path": {k: r["launches"] + r.get("twin_launches", 0)
                             for k, r in paths.items()},
        "fixup_launches": train["fixup_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in full + batch),
        "max_over_allowance": max(max(r["over_allowance"],
                                      r.get("twin_over_allowance", 0))
                                  for r in comb),
        "ms": mean_of(full, "kernel_ms"),
        "plain_ms": mean_of(full, "plain_ms"),
        "bound_ms": mean_of(full, "bound_ms"), "bound_by": full[0]["bound_by"],
        "library_ms": mean_of(full, "library_ms"),
        "library": "torch.sparse.mm of the [V, V*B] CSR matrix, E*B "
                   "entries",
        "library_coalesced_ms": mean_of(full, "library_coalesced_ms"),
        **merge_path_numbers(full, batch),
        "train_batch_library_ms": mean_of(batch, "library_ms"),
        "full_train_twin_library_ms": mean_of(full, "twin_library_ms"),
        "train_batch_twin_library_ms": mean_of(batch, "twin_library_ms"),
        "twin_hub_rows_only_ms": mean_of(full, "twin_hub_rows_only_ms"),
        "twin_other_rows_only_ms": mean_of(full, "twin_other_rows_only_ms"),
        "layouts_ms": {r["layout"]: r["kernel_ms"] for r in layouts},
        "train_batch_ms": mean_of(batch, "kernel_ms"),
        "train_batch_plain_ms": mean_of(batch, "plain_ms"),
        "train_batch_bound_ms": mean_of(batch, "bound_ms"),
        "train_batch_twin_ms": mean_of(batch, "twin_kernel_ms"),
        "train_batch_twin_plain_ms": mean_of(batch, "twin_plain_ms"),
        "train_batch_twin_bound_ms": mean_of(batch, "twin_bound_ms"),
        "full_train_twin_ms": mean_of(full, "twin_kernel_ms"),
        "full_train_twin_bound_ms": mean_of(full, "twin_bound_ms")}]


def staircase_kernels_line(ks, runs) -> list:
    """staircase_aggregate with this run's numbers, scatter2's (TPU kernel
    4, the same kernel on the perm path) beside them. Timed on the full
    train graph (the serving shape) and on the first training batch's
    graph; times and bounds are means over the two directions. Launches
    are those of the four main paths (``runs``: phase -> its row)."""
    full = [r for r in ks if r.get("graph") == "full_train"]
    batch = [r for r in ks if r.get("graph") == "train_batch"]
    layouts = [r for r in ks if "layout" in r]
    return [{
        "name": "staircase_aggregate", "route": "cuda",
        "source": STAIRCASE_SOURCE, "replaces": REPLACES_STAIRCASE,
        "replaces_too": REPLACES_SCATTER2,
        "launches": sum(r["launches"] for r in runs.values()),
        "launches_by_path": {k: r["launches"] for k, r in runs.items()},
        "fixup_launches": sum(r["fixup_launches"] for r in runs.values()),
        "max_abs_err": max(r["max_abs_err"] for r in full + batch),
        "max_over_allowance": max(r["over_allowance"] for r in ks),
        "layouts_ms": {r["layout"]: r["kernel_ms"] for r in layouts},
        "compgcn_sums": {r["compgcn"]: {k: r[k] for k in (
            "kernel", "entries", "over_allowance", "library_over_allowance",
            "launches", "fixup_launches")} for r in ks if "compgcn" in r},
        "ms": mean_of(full, "kernel_ms"),
        "plain_ms": mean_of(full, "plain_ms"),
        "bound_ms": mean_of(full, "bound_ms"), "bound_by": full[0]["bound_by"],
        "library_ms": mean_of(full, "library_ms"),
        "library": "torch.sparse.mm",
        **merge_path_numbers(full, batch),
        "train_batch_ms": mean_of(batch, "kernel_ms"),
        "train_batch_plain_ms": mean_of(batch, "plain_ms"),
        "train_batch_bound_ms": mean_of(batch, "bound_ms"),
        "train_batch_library_ms": mean_of(batch, "library_ms"),
        "scatter2_launches": staircase2.scatter2.launches,
        "scatter2_max_abs_err": max(r["scatter2_max_abs_err"]
                                    for r in full + batch),
        "scatter2_ms": mean_of(full, "scatter2_ms"),
        "scatter2_plain_ms": mean_of(full, "scatter2_plain_ms"),
        "scatter2_bound_ms": mean_of(full, "scatter2_bound_ms"),
        "scatter2_library_ms": mean_of(full, "scatter2_library_ms"),
        "train_batch_scatter2_ms": mean_of(batch, "scatter2_ms")}]


# ---------------------------------------------------------------------------
# bf16 message and stream precision
# ---------------------------------------------------------------------------

# One step on the card against the CPU plain path, bf16: see phase_train.
BF16_STEP_TOL = {"loss_rtol": 1e-4, "leaf_rtol": 1e-2}
BF16 = torch.bfloat16
# One bf16 ulp is at most 2^-7 of a value: the allowance of a product
# that the kernel rounds to bf16 (basis_project_bf16's P).
BF16_ULP = 2.0 ** -7


def bf16_vs_f32(model, kind, params, batch, draws, loss, grads) -> dict:
    """One bf16 step against the f32 configuration's on the same params,
    batch and draws, on the card: the loss within 1e-2 relative (the JAX
    package's rule, tests/test_bf16_streams.py), the leaves reported."""
    ref_loss, ref_grads = engine.step_loss_and_grads(
        build.build_model(float32_config(model.config), model.device), kind,
        params, batch, draws)
    rel = abs(loss.item() - ref_loss.item()) / abs(ref_loss.item())
    if not rel <= 1e-2:
        raise AssertionError(f"the bf16 loss {loss.item()} differs from the "
                             f"f32 loss {ref_loss.item()} by {rel}")
    leaves = [rel_l2(g, c) if c.norm() > 0 else 0.0
              for g, c in zip(tree_leaves(grads), tree_leaves(ref_grads))]
    return {"loss_bf16": loss.item(), "loss_f32": ref_loss.item(),
            "loss_rel_diff": rel, "worst_leaf_rel_l2_diff": max(leaves)}


def fused_vs_autograd(model, params, batch) -> dict:
    """The factored energies of every positive of the batch (272,115 x 10
    for distmult) on a bf16 stream, with random cotangents: the fused
    backward's d codes (kernel 3's bf16 entry point, rounded to bf16) and
    d factors against autograd's through the f32 form on the same bf16
    values (within 1e-2 in relative L2 norm: the bf16 rounding of d codes
    is 2^-9 an element), and the times of the three backwards (CUDA
    events): fused, autograd through the bf16 direct form (its sort-based
    index_put_ accumulating in bf16), autograd through the f32 form (the
    f32 stream's backward)."""
    enc = model.stream_cast(model.encode(params, None, deterministic=True))
    e1, r, e2 = model.gather_codes(enc, batch.triples)
    dp = params["decoder"]
    q_subj = model.decoder.subject_factor(dp, r, e2).detach()
    q_obj = model.decoder.object_factor(dp, e1, r).detach()
    codes = enc.entity_codes.detach()
    gen = torch.Generator(device=codes.device).manual_seed(1)
    values, co = device_sampling.device_negative_parts(
        batch.triples, model.config.training.negative_sample_rate,
        model.n_entities, gen)
    d_e = torch.randn(values.shape, generator=gen, device=codes.device)
    d_s = 1e-3 * torch.randn(values.shape, generator=gen,
                             device=codes.device)

    def graph(form):
        leaves = [t.clone().requires_grad_(True) for t in
                  ((codes, q_subj, q_obj) if form != "f32" else
                   (codes.float(), q_subj.float(), q_obj.float()))]
        if form == "direct_bf16":
            ev = leaves[0][values.long()]
            es = (ev * leaves[1][:, None]).sum(-1, dtype=torch.float32)
            eo = (ev * leaves[2][:, None]).sum(-1, dtype=torch.float32)
            energy = es + co.float() * (eo - es)
            sq = (ev.float() ** 2).sum(-1)
        else:
            energy, sq = neg_energy.factored_negative_energies(
                *leaves, values, co)
        return leaves, (energy * d_e).sum() + (sq * d_s).sum()

    out, grads = {"rows": int(values.numel()),
                  "entities": model.n_entities}, {}
    before = neg_energy.factored_negative_energies.bf16_launches
    for form in ("fused", "direct_bf16", "f32"):
        leaves, total = graph(form)
        grads[form] = torch.autograd.grad(total, leaves, retain_graph=True)
        out[f"{form}_backward_ms"] = cuda_ms(lambda: torch.autograd.grad(
            total, leaves, retain_graph=True), 3, warmup=1)
        del leaves, total
    if neg_energy.factored_negative_energies.bf16_launches == before:
        raise AssertionError("the fused backward launched no kernel 3")
    for i, name in enumerate(("d_codes", "d_q_subj", "d_q_obj")):
        want = grads["f32"][i]
        rel = rel_l2(grads["fused"][i], want)
        out[f"{name}_rel_l2_vs_f32_autograd"] = rel
        out[f"{name}_direct_bf16_rel_l2_vs_f32_autograd"] = rel_l2(
            grads["direct_bf16"][i], want)
        if not rel <= 1e-2:
            raise AssertionError(f"the fused backward's {name} differs "
                                 f"from autograd's by {rel}")
    return out


def bf16_csr_library(csr, dense) -> tuple:
    """(time, note) of torch.sparse.mm of a CSR matrix with bf16 values
    by a bf16 dense matrix, or (None, the reason it did not run)."""
    try:
        csr16 = torch.sparse_csr_tensor(csr.crow_indices(),
                                        csr.col_indices(),
                                        csr.values().to(BF16), csr.shape)
        torch.sparse.mm(csr16, dense)
        torch.cuda.synchronize()
    except RuntimeError as err:
        return None, f"none: torch.sparse.mm on a bf16 CSR raised " \
                     f"{str(err).splitlines()[0][:120]}"
    return cuda_ms(lambda: torch.sparse.mm(csr16, dense), 20), \
        "torch.sparse.mm on the same CSR matrix, bf16 values"


def bf16_row(kernel, graph_name, direction, got, exact, allowance, wrong,
             plain, launch, f32_launch, plain_fn, bound, library) -> dict:
    """One bf16 kernel's checks and times: ``got`` against the float64
    sum ``exact`` of its bf16-valued inputs within ``allowance``, the
    output ``wrong`` on the wrong layout outside it, ``plain`` (the plain
    version on the same bf16 inputs) beside it; CUDA-event times of the
    bf16 launch, of the f32 kernel on the f32 inputs and of the plain
    version, with the bound and ``library``, (its time or None, what it
    is)."""
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{kernel} {graph_name}/{direction}: not "
                             f"finite")
    over = over_allowance(got, exact, allowance)
    if not over <= 1:
        raise AssertionError(f"{kernel} {graph_name}/{direction}: {over} "
                             f"of the allowance")
    row = {"kernel": kernel, "graph": graph_name, "direction": direction,
           "max_abs_err": (got.double() - exact).abs().max().item(),
           "max_abs_diff_vs_plain": (got.float() - plain.float()).abs()
           .max().item(),
           "over_allowance": over,
           "ms": cuda_ms(launch, 20), "f32_ms": cuda_ms(f32_launch, 20),
           "plain_ms": cuda_ms(plain_fn, 3, warmup=1),
           "library_ms": library[0], "library": library[1], **bound}
    if wrong is not None:
        row["wrong_layout_over_allowance"] = over_allowance(wrong, exact,
                                                            allowance)
        if not row["wrong_layout_over_allowance"] > 1:
            raise AssertionError(f"{kernel} {graph_name}/{direction}: the "
                                 f"wrong layout passes the allowance")
    return row


def block_csr_matrix(blocks, layout, n_rows, n_src, dtype=torch.float32,
                     edge_chunk=16384):
    """The one-call form of a block_direction pass (``blocks`` as the pass
    reads them: transposed for the twin): the [n_rows * d, n_src * d] CSR
    matrix with w_e * W[r_e, b, i, j] at (tgt_e * d + b * dr + i, src_e *
    d + b * dr + j) for every edge, block, i and j, E * B * dr * dr
    entries with int32 indices, scattered straight into CSR order (row
    (v, b, i) holds v's edges' dr entries in CSR order, so it starts at
    row_ptr[v] * d * dr + (b * dr + i) * deg(v) * dr). Returns (matrix,
    build ms on the host clock, synchronized)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n_blocks, dr = blocks.shape[1], blocks.shape[2]
    d, e = n_blocks * dr, layout.n_edges
    dev = layout.row_ptr.device
    rp = layout.row_ptr.long()
    deg = rp.diff()
    bi = torch.arange(d, device=dev)
    crow = torch.empty(n_rows * d + 1, dtype=torch.int64, device=dev)
    crow[:-1] = (rp[:-1, None] * (d * dr)
                 + bi[None, :] * (deg[:, None] * dr)).reshape(-1)
    crow[-1] = e * d * dr
    cols = torch.empty(e * d * dr, dtype=torch.int32, device=dev)
    vals = torch.empty(e * d * dr, dtype=dtype, device=dev)
    targets = staircase.row_of_entry(layout)
    b_dr = (torch.arange(n_blocks, device=dev) * dr)[:, None]
    ij = torch.arange(dr, device=dev)
    for start in range(0, e, edge_chunk):
        k = torch.arange(start, min(start + edge_chunk, e), device=dev)
        v = targets[k]
        pos = ((rp[v] * (d * dr) + (k - rp[v]) * dr)[:, None, None, None]
               + (b_dr + ij[None, :])[None, :, :, None]
               * (deg[v] * dr)[:, None, None, None]
               + ij[None, None, None, :])
        src = layout.src[k].long()
        cols[pos] = (src[:, None, None, None] * d + b_dr[None, :, :, None]
                     + ij[None, None, None, :]).expand_as(pos).to(
                         torch.int32)
        vals[pos] = (blocks[layout.rel[k].long()].float()
                     * layout.w[k, None, None, None]).to(dtype)
        del pos
    matrix = torch.sparse_csr_tensor(crow.to(torch.int32), cols, vals,
                                     size=(n_rows * d, n_src * d))
    torch.cuda.synchronize()
    return matrix, (time.perf_counter() - t0) * 1e3


def block_library(blocks, x, layout, n_rows, got) -> dict:
    """torch.sparse.mm of block_csr_matrix by x as one column, with f32
    values (beside the f32 entry point) and bf16 values (beside the bf16
    ones): times, build times, and the f32 product's relative L2 distance
    from the kernel's output ``got`` (a check that the matrix is the
    pass's). Where the matrix cannot be built or multiplied (memory), the
    reason."""
    out = {}
    for label, dtype in (("f32", torch.float32), ("bf16", BF16)):
        try:
            matrix, build_ms = block_csr_matrix(blocks, layout, n_rows,
                                                x.shape[0], dtype)
            col = x.to(dtype).reshape(-1, 1)
            product = torch.sparse.mm(matrix, col)
            torch.cuda.synchronize()
        except (RuntimeError, torch.cuda.OutOfMemoryError) as err:
            out[f"library_{label}_ms"] = None
            out[f"library_{label}"] = (f"none: torch.sparse.mm on the "
                                       f"{label} one-call form raised "
                                       f"{str(err).splitlines()[0][:120]}")
            continue
        out[f"library_{label}_ms"] = cuda_ms(
            lambda: torch.sparse.mm(matrix, col), 10)
        out[f"library_{label}_build_ms"] = build_ms
        out[f"library_{label}"] = (
            f"torch.sparse.mm of the [V*d, S*d] one-call CSR "
            f"({matrix.values().numel()} entries, {label} values, int32 "
            f"indices) by x as one column")
        if dtype == torch.float32:
            out["library_rel_l2_vs_kernel"] = rel_l2(
                product.view(n_rows, -1), got)
            if not out["library_rel_l2_vs_kernel"] < 1e-2:
                raise AssertionError(f"the one-call matrix is not the "
                                     f"pass's: {out}")
        del matrix, product, col
    torch.cuda.empty_cache()
    return out


def slice_plan_row(lib, blocks, layout, n_rows, twin) -> dict:
    """The route block_direction's bf16 entry points take for ``blocks``,
    and the slice kernel's plan, shared memory, threads, thread blocks
    along the partition, registers and items at this layout."""
    n_rel, n_blocks, dr = blocks.shape[:3]
    plan = staircase2.block_direction_route(n_rel, n_blocks, dr)
    items = staircase.block_direction_items(n_rows, layout.n_edges)
    row = {"route": plan.route, "items": items}
    if plan.route == "slice":
        row.update(
            blocks_per_slice=plan.blocks_per_slice, lanes=plan.lanes,
            n_slices=plan.n_slices, smem_bytes=plan.smem_bytes,
            kernel_smem_bytes=lib.block_direction_slice_smem_bytes(
                n_rel, plan.blocks_per_slice, dr),
            threads=lib.block_direction_slice_threads(dr),
            chunks=lib.block_direction_slice_chunks(
                n_rows, layout.n_edges, n_blocks, dr, n_rel, items,
                plan.blocks_per_slice, int(twin), 0),
            registers=lib.block_direction_slice_registers(dr, int(twin)))
        if (row["kernel_smem_bytes"], row["threads"],
                lib.block_direction_slice_min_lanes()) != (
                    plan.smem_bytes, staircase2.slice_threads(dr),
                    staircase2.SLICE_LANES[0]):
            raise AssertionError(f"the kernel's layout {row} is not the "
                                 f"plan's {plan}")
    return row


def same_bits(a, b) -> bool:
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def ptxas_of(info, kernel: str):
    """ptxas' line (registers, spills) of the first kernel of a fresh
    build whose mangled name holds ``kernel``, or None (a cached build
    has none)."""
    return next((line for line in info.ptxas if kernel in line), None)


# The B = 5 instantiations the main path's bf16 combine launches at d_out
# = 500: the chunk kernel on 4-column words, PR 6's on uint2 into float4.
CHUNK_KERNEL = "combine_chunk_kernelILi5ELi4E"
ROW_KERNEL = "basis_combine_kernelILi5E5uint26float4E"


def combine_route_row(blib, p16, pf, coef, layout, v, got, items) -> dict:
    """basis_combine_bf16's route on these inputs and its chunk plan
    (checked against the kernel's constants), ``got`` (the chunk
    kernel's output) against the f32 entry point on the widened P ``pf``
    bit for bit (raises where it differs), PR 6's kernel (route="row") on
    the same inputs: its bits, its time (CUDA events) and both kernels'
    device times (torch.profiler), with ptxas' registers and spills of
    both at B = 5."""
    n_bases = coef.shape[1]
    d_out = p16.shape[1] // n_bases
    plan = staircase.basis_combine_plan(d_out)
    info = staircase2.basis_kernel_library()[1]
    f32 = staircase2.launch_combine(blib, pf, coef, layout, v)
    row_out = staircase2.launch_combine(blib, p16, coef, layout, v,
                                        route="row")
    out = {"route": staircase2.combine_route(p16, coef), "items": items,
           "cols": plan.cols, "chunk_cols": plan.chunk_cols,
           "n_chunks": plan.n_chunks,
           "smem_bytes": blib.basis_combine_chunk_smem_bytes(n_bases,
                                                             items),
           "equals_f32_bitwise": same_bits(got, f32),
           "row_equals_f32_bitwise": same_bits(row_out, f32),
           "row_ms": cuda_ms(lambda: staircase2.launch_combine(
               blib, p16, coef, layout, v, route="row"), 20),
           **retried_device_ms(lambda: staircase2.launch_combine(
               blib, p16, coef, layout, v),
               ("combine_chunk_kernel", "carry_fixup"), "device_ms"),
           **retried_device_ms(lambda: staircase2.launch_combine(
               blib, p16, coef, layout, v, route="row"),
               ("basis_combine_kernel", "carry_fixup"), "row_device_ms"),
           "ptxas": ptxas_of(info, CHUNK_KERNEL),
           "row_ptxas": ptxas_of(info, ROW_KERNEL)}
    if (blib.basis_combine_chunk_threads(),
            blib.basis_combine_word_cols()) != (
                staircase.COMBINE_CHUNK_THREADS,
                staircase.COMBINE_WORD_COLS):
        raise AssertionError(f"the chunk kernel's shape is not the "
                             f"planner's: {out}")
    if not (out["route"] == "chunk" and out["equals_f32_bitwise"]
            and out["row_equals_f32_bitwise"]):
        raise AssertionError(f"basis_combine_bf16: the chunk route's bits "
                             f"differ from the f32 entry point's: {out}")
    return out


def bf16_block_layouts(lib, graphs, n_rel, device) -> list:
    """block_direction_bf16 and its twin by the slice route on
    block_layouts' stress layouts (B = 100, dr = 5) and on the training
    batch's layout at every dr of 1-8 (B = min(128, 500 // dr); d odd at
    dr = 7, the 2-byte load path), each equal bit for bit to the f32
    entry point on the widened inputs, within the rounding allowance of a
    float64 sum, with carry rows equal to merge_path_carry_rows and two
    launches equal bit for bit; then a layout whose R = 5,000 relations
    do not fit shared memory (one 5x5 block of every relation takes
    260,000 bytes), which must take the walk: through the op's launch
    function (counted on its direction's walk counter), within the
    allowance, the wrong layout (weights reversed) outside it, two
    launches the same bits, and route="slice" refused."""
    gen = torch.Generator().manual_seed(15)
    v = graphs["full_train"].n_vertices
    counts = stress_counts(graphs)
    cases = {name: (csr_of_counts(c, gen, device, v, n_rel), n_rel, 100, 5)
             for name, c in counts.items()}
    cases["one_run_9155"] = (csr_of_counts(counts["hub_9155"], gen, device,
                                           v), n_rel, 100, 5)
    for dr in range(1, 9):
        cases[f"train_batch_dr{dr}"] = (graphs["train_batch"].fwd, n_rel,
                                        min(128, 500 // dr), dr)
    walk_rel = 5000
    cases["walk_R5000"] = (csr_of_counts(counts["hub_9155"], gen, device, v,
                                         walk_rel), walk_rel, 100, 5)
    rows = []
    for name, (layout, r, n_blocks, dr) in cases.items():
        x = torch.randn(v, n_blocks * dr, generator=gen).to(device).to(BF16)
        w = torch.randn(r, n_blocks, dr, dr, generator=gen).to(device) \
            .to(BF16)
        items = staircase.block_direction_items(v, layout.n_edges)
        want_route = "walk" if r == walk_rel else "slice"
        for kernel, twin in (("block_direction_bf16", False),
                             ("block_direction_twin_bf16", True)):
            plan = slice_plan_row(lib, w, layout, v, twin)
            if plan["route"] != want_route:
                raise AssertionError(f"{kernel} {name}: route {plan}")
            got = repeatable(f"{kernel} layout {name}",
                             lambda c: staircase2.launch(
                                 lib, x, w, layout, v, twin=twin,
                                 carries=c), layout.row_ptr, items)
            f32 = staircase2.launch(lib, x.float(), w.float(), layout, v,
                                    twin=twin)
            wt = w.float().transpose(-1, -2) if twin else w.float()
            exact, allowance = block_exact(x.float(), wt, layout, v)
            torch.cuda.synchronize()
            over = over_allowance(got, exact, allowance)
            row = {"kernel": kernel, "layout": name, "R": r, "B": n_blocks,
                   "dr": dr, **plan, **partition_row(layout, v, items),
                   "over_allowance": over, "same_bits_twice": True,
                   "equals_f32_bitwise": same_bits(got, f32),
                   "kernel_ms": cuda_ms(lambda: staircase2.launch(
                       lib, x, w, layout, v, twin=twin), 10),
                   "bound_ms": block_direction_bound(
                       layout, v, r, n_blocks, dr, elem=2)["bound_ms"]}
            if not (torch.isfinite(got).all() and over <= 1):
                raise AssertionError(f"{kernel} layout {name}: {row}")
            if want_route == "slice" and not row["equals_f32_bitwise"]:
                raise AssertionError(f"{kernel} layout {name}: the slice "
                                     f"route's bits differ from the f32 "
                                     f"entry point's: {row}")
            if want_route == "walk":
                pre = "bf16_twin_" if twin else "bf16_"
                keys = (pre + "slice_launches", pre + "walk_launches")
                before = [route_launches()[k] for k in keys]
                via_op = staircase2._aggregate(x, w, layout, v, twin=twin)
                after = [route_launches()[k] for k in keys]
                wrong = staircase2._aggregate(
                    x, w, with_weights(layout, layout.w.flip(0)
                                       .contiguous()), v, twin=twin)
                row["wrong_layout_over_allowance"] = over_allowance(
                    wrong, exact, allowance)
                row["op_counted"] = [after[0] - before[0],
                                     after[1] - before[1]]
                try:
                    staircase2.launch(lib, x, w, layout, v, twin=twin,
                                      route="slice")
                    refused = False
                except ValueError:
                    refused = True
                if not (same_bits(via_op, got) and row["op_counted"]
                        == [0, 1] and refused
                        and row["wrong_layout_over_allowance"] > 1):
                    raise AssertionError(f"{kernel} layout {name}: the "
                                         f"walk route {row}")
            rows.append(row)
    return rows


def bf16_combine_layouts(lib, graphs, n_rel, device) -> list:
    """basis_combine_bf16 by the chunk route on combine_layouts' stress
    layouts (B = 5, d_out = 500), on the training batch's layout at every
    B of 1-8 with d_out = 37 (one column a thread) and at B = 8, d_out =
    500 with the kernels' largest items (1,024: 40,960 bytes of staging),
    at B = 5, d_out = 1,000 (two column chunks), and on two rectangular
    layouts (a vertex shard's: the full graph's first 7,270 rows reading
    14,541 source rows, and its 14,541 rows reading 7,270): each equal bit
    for bit
    to the f32 entry point on the widened P, and to PR 6's kernel
    (route="row") likewise, within the rounding allowance of a float64
    sum, the layout with its weights reversed outside it (where it has
    entries), carry rows equal to merge_path_carry_rows and two launches
    equal bit for bit; route="chunk" refused for an f32 P. Both kernels
    timed."""
    gen = torch.Generator().manual_seed(16)
    full = graphs["full_train"]
    v = full.n_vertices
    cases = {name: (csr_of_counts(c, gen, device, v, n_rel), v, 5, 500,
                    None)
             for name, c in stress_counts(graphs).items()}
    batch = graphs["train_batch"].fwd
    for n_bases in range(1, 9):
        cases[f"train_batch_B{n_bases}_d37"] = (batch, v, n_bases, 37, None)
    cases["train_batch_B8_items1024"] = (batch, v, 8, 500, 1024)
    cases["train_batch_d1000"] = (batch, v, 5, 1000, None)
    lengths = full.fwd.row_ptr.diff().cpu().long()
    half = v // 2
    for name, counts, n_src in (("rect_fewer_rows", lengths[:half], v),
                                ("rect_more_rows", lengths, half)):
        lay = csr_of_counts(counts, gen, device, n_src, n_rel)
        cases[name] = (dataclasses.replace(lay, n_sources=n_src), n_src, 5,
                       500, None)
    rows = []
    for name, (layout, n_src, n_bases, d_out, items) in cases.items():
        n_rows = layout.n_rows
        p16 = torch.randn(n_src, n_bases * d_out, generator=gen).to(
            device).to(BF16)
        pf = p16.float()
        coef = torch.randn(n_rel, n_bases, generator=gen).to(device)
        staircase2._check_combine(p16, coef, layout, n_rows)
        items = items or staircase.basis_combine_items(n_rows,
                                                       layout.n_edges)
        got = repeatable(f"basis_combine_bf16 layout {name}",
                         lambda c: staircase2.launch_combine(
                             lib, p16, coef, layout, n_rows, items=items,
                             carries=c), layout.row_ptr, items)
        f32 = staircase2.launch_combine(lib, pf, coef, layout, n_rows,
                                        items=items)
        row_out = staircase2.launch_combine(lib, p16, coef, layout, n_rows,
                                            items=items, route="row")
        exact, allowance = combine_exact(pf, coef, layout, n_rows)
        torch.cuda.synchronize()
        plan = staircase.basis_combine_plan(d_out)
        row = {"kernel": "basis_combine_bf16", "layout": name,
               "n_src": n_src, "n_rows": n_rows, "B": n_bases,
               "d_out": d_out, "route": staircase2.combine_route(p16, coef),
               "cols": plan.cols, "chunk_cols": plan.chunk_cols,
               "n_chunks": plan.n_chunks,
               "smem_bytes": lib.basis_combine_chunk_smem_bytes(n_bases,
                                                                items),
               **partition_row(layout, n_rows, items),
               "over_allowance": over_allowance(got, exact, allowance),
               "same_bits_twice": True,
               "equals_f32_bitwise": same_bits(got, f32),
               "row_equals_f32_bitwise": same_bits(row_out, f32),
               "kernel_ms": cuda_ms(lambda: staircase2.launch_combine(
                   lib, p16, coef, layout, n_rows, items=items), 10),
               "row_ms": cuda_ms(lambda: staircase2.launch_combine(
                   lib, p16, coef, layout, n_rows, items=items,
                   route="row"), 10),
               "bound_ms": combine_bound(layout, n_rows, n_bases, d_out,
                                         elem=2)["bound_ms"]}
        if layout.n_edges:
            wrong = staircase2.launch_combine(
                lib, p16, coef, with_weights(layout, layout.w.flip(0)
                                             .contiguous()), n_rows,
                items=items)
            row["wrong_layout_over_allowance"] = over_allowance(
                wrong, exact, allowance)
        if not (torch.isfinite(got).all() and row["over_allowance"] <= 1
                and row["route"] == "chunk" and row["equals_f32_bitwise"]
                and row["row_equals_f32_bitwise"]
                and row.get("wrong_layout_over_allowance", 2) > 1):
            raise AssertionError(f"basis_combine_bf16 layout {name}: {row}")
        rows.append(row)
    try:
        staircase2.launch_combine(lib, pf, coef, layout, n_rows,
                                  route="chunk")
        raise AssertionError("basis_combine: route='chunk' ran an f32 P")
    except ValueError:
        pass
    return rows


def phase_kernel_bf16(graphs, n_rel, n_blocks, dr, n_bases, d, device):
    """The bf16 entry points at the main paths' shapes, on the full train
    graph and on the first training batch's graph, both directions, each
    held to a float64 sum of its bf16-valued inputs within sum_allowance
    (the wrong layout outside it) and beside its plain version:
    block_direction_bf16 (forward) and block_direction_twin_bf16 (the
    twin CSR, W read transposed); basis_combine_bf16 on a bf16 P, forward
    and twin CSR; staircase_aggregate_bf16 without and with perm, and
    scatter2 with compute_dtype bf16 (TPU kernel 4's mapping onto it);
    basis_project_bf16 at the forward and twin shapes ([V, d] by [d, B*d])
    and an odd one (the 2-byte load path) within the f32 product's
    allowance plus one bf16 ulp (P is rounded). Times (CUDA events) of
    each bf16 launch, of its f32 kernel on the f32 inputs and of the plain
    version, beside the bound (bf16 bytes; 989 TFLOP/s for the product)
    and the library call: torch.matmul in bf16 for the product,
    torch.sparse.mm on a bf16 CSR for combine and staircase (none for
    block_direction, whose one-call form has E*B*dr*dr entries). Launches
    here go through the launch functions, or count on counters the main
    paths reset."""
    t_phase = time.perf_counter()
    lib, _ = staircase2.kernel_library()
    blib, _ = staircase2.basis_kernel_library()
    plib, _ = staircase2.project_kernel_library()
    slib, _ = staircase.kernel_library()
    exact_float32()
    rows = []

    def emit_row(row):
        emit("kernel_bf16", phase_s=time.perf_counter() - t_phase, **row)
        rows.append(row)

    gen = torch.Generator().manual_seed(12)
    v_full = graphs["full_train"].n_vertices
    x = torch.randn(v_full, d, generator=gen).to(device)
    w_flat = (torch.randn(d, n_bases * d, generator=gen) * 0.05).to(device)
    w_t = staircase2.basis_twin_weights(w_flat, n_bases)
    for shape, a, b in (("forward", x, w_flat), ("twin", x, w_t),
                        ("odd", x[:37, :33], w_flat[:33, :29])):
        a16, b16 = a.to(BF16).contiguous(), b.to(BF16).contiguous()
        got = staircase2.launch_project_bf16(plib, a16, b16)
        again = staircase2.launch_project_bf16(plib, a16, b16)
        exact, allowance = project_exact(a16.float(), b16.float())
        allowance = allowance + BF16_ULP * exact.abs()
        (m, k), n = a16.shape, b16.shape[1]
        af, bf = a16.float(), b16.float()
        row = bf16_row(
            "basis_project_bf16", "-", shape, got, exact, allowance, None,
            staircase2.basis_project_reference(a16, b16),
            lambda: staircase2.launch_project_bf16(plib, a16, b16),
            lambda: staircase2.launch_project(plib, af, bf),
            lambda: staircase2.basis_project_reference(a16, b16),
            least_time(2 * (m * k + k * n + m * n), 2 * m * k * n,
                       BF16_OPS_PER_S),
            (cuda_ms(lambda: torch.matmul(a16, b16), 20),
             "torch.matmul in bf16, f32 reduction"))
        if not torch.equal(got.view(torch.int16), again.view(torch.int16)):
            raise AssertionError("basis_project_bf16: two launches differ")
        xp, wt = staircase2.launch_pad_bf16(plib, a16, b16)
        kp = xp.shape[1]
        for got_pad, want_pad in zip((xp, wt), staircase2.bf16_pad_reference(
                a16, b16, kp)):
            if not torch.equal(got_pad.view(torch.int16),
                               want_pad.view(torch.int16)):
                raise AssertionError(f"bf16_pad {shape}: differs from "
                                     f"bf16_pad_reference")
        dev = device_ms(lambda: staircase2.launch_project_bf16(plib, a16,
                                                               b16),
                        ("bf16_pad_kernel", "project_bf16_kernel"))
        row.update(
            m=m, k=k, n=n, kp=kp, same_bits_twice=True,
            differs_from_plain_share=(got != staircase2
                                      .basis_project_reference(
                                          a16, b16)).float().mean().item(),
            pad_equals_plain=True,
            pad_ms=cuda_ms(lambda: staircase2.launch_pad_bf16(plib, a16, b16),
                           20),
            pad_device_ms=dev.get("bf16_pad_kernel"),
            pad_plain_ms=cuda_ms(lambda: staircase2.bf16_pad_reference(
                a16, b16, kp), 20),
            pad_bound_ms=least_time(2 * (m * k + k * n + (m + n) * kp),
                                    0)["bound_ms"],
            product_ms=cuda_ms(lambda: staircase2.launch_product_bf16(
                plib, xp, wt), 20),
            product_device_ms=dev.get("project_bf16_kernel"),
            registers=plib.basis_project_bf16_registers(),
            stages=plib.basis_project_bf16_stages(),
            card=nvidia_smi_line())
        emit_row(row)

    for graph_name, graph in graphs.items():
        v = graph.n_vertices
        x = torch.randn(v, n_blocks * dr, generator=gen).to(device)
        w = torch.randn(n_rel, n_blocks, dr, dr, generator=gen).to(device)
        p = torch.randn(v, n_bases * d, generator=gen).to(device)
        coef = torch.randn(n_rel, n_bases, generator=gen).to(device)
        x16, w16, p16 = x.to(BF16), w.to(BF16), p.to(BF16)
        xf, wf, pf = x16.float(), w16.float(), p16.float()
        for name, layout, twin, wrong in (
                ("forward", graph.fwd, graph.fwd_twin, graph.bwd),
                ("backward", graph.bwd, graph.bwd_twin, graph.fwd)):
            for kernel, lay, bad, is_twin in (
                    ("block_direction_bf16", layout, wrong, False),
                    ("block_direction_twin_bf16", twin, layout, True)):
                wt = wf.transpose(-1, -2) if is_twin else wf
                exact, allowance = block_exact(xf, wt, lay, v)
                items = staircase.block_direction_items(v, lay.n_edges)
                got = repeatable(f"{kernel} {graph_name}/{name}",
                                 lambda c: staircase2.launch(
                                     lib, x16, w16, lay, v, twin=is_twin,
                                     carries=c), lay.row_ptr, items)
                f32 = staircase2.launch(lib, xf, wf, lay, v, twin=is_twin)
                walk = staircase2.launch(lib, x16, w16, lay, v,
                                         twin=is_twin, route="walk")
                extra = block_library(wt, xf, lay, v, f32) \
                    if name == "forward" else {}
                row = bf16_row(
                    kernel, graph_name, name, got, exact, allowance,
                    staircase2.launch(lib, x16, w16, bad, v, twin=is_twin),
                    staircase2.block_direction_reference(x16, wt, lay, v),
                    lambda: staircase2.launch(lib, x16, w16, lay, v,
                                              twin=is_twin),
                    lambda: staircase2.launch(lib, xf, wf, lay, v,
                                              twin=is_twin),
                    lambda: staircase2.block_direction_reference(
                        x16, wt, lay, v),
                    block_direction_bound(lay, v, n_rel, n_blocks, dr,
                                          elem=2),
                    (extra.get("library_bf16_ms"),
                     extra.get("library_bf16", "none: timed on the "
                                               "forward direction")))
                row.update(
                    **slice_plan_row(lib, w16, lay, v, is_twin),
                    same_bits_twice=True,
                    equals_f32_bitwise=same_bits(got, f32),
                    walk_equals_f32_bitwise=same_bits(walk, f32),
                    walk_ms=cuda_ms(lambda: staircase2.launch(
                        lib, x16, w16, lay, v, twin=is_twin,
                        route="walk"), 20),
                    **retried_device_ms(lambda: staircase2.launch(
                        lib, x16, w16, lay, v, twin=is_twin),
                        ("block_slice_kernel", "carry_fixup"), "device_ms"),
                    **retried_device_ms(
                        lambda: staircase2.launch(lib, x16, w16, lay, v,
                                                  twin=is_twin,
                                                  route="walk"),
                        ("block_direction_kernel", "carry_fixup"),
                        "walk_device_ms"),
                    **{k: val for k, val in extra.items()
                       if k not in ("library_bf16_ms", "library_bf16")},
                    card=nvidia_smi_line())
                if graph_name == "full_train" and name == "forward":
                    row["items_sweep_ms"] = {
                        str(n): cuda_ms(lambda: staircase2.launch(
                            lib, x16, w16, lay, v, twin=is_twin, items=n),
                            10) for n in SWEEP_ITEMS}
                if not (row["equals_f32_bitwise"]
                        and row["route"] == "slice"):
                    raise AssertionError(f"{kernel} {graph_name}/{name}: "
                                         f"the slice route's bits differ "
                                         f"from the f32 entry point's: "
                                         f"{row}")
                emit_row(row)
            for kernel, lay, bad in (("basis_combine_bf16", layout, wrong),
                                     ("basis_combine_bf16_twin", twin,
                                      layout)):
                exact, allowance = combine_exact(pf, coef, lay, v)
                direction = name + ("_twin" if kernel.endswith("twin")
                                    else "")
                items = staircase.basis_combine_items(v, lay.n_edges)
                got = repeatable(f"basis_combine_bf16 {graph_name}/"
                                 f"{direction}",
                                 lambda c: staircase2.launch_combine(
                                     blib, p16, coef, lay, v, carries=c),
                                 lay.row_ptr, items)
                row = bf16_row(
                    "basis_combine_bf16", graph_name, direction, got,
                    exact, allowance,
                    staircase2.launch_combine(blib, p16, coef, bad, v),
                    staircase2.basis_combine_reference(p16, coef, lay, v),
                    lambda: staircase2.launch_combine(blib, p16, coef, lay,
                                                      v),
                    lambda: staircase2.launch_combine(blib, pf, coef, lay,
                                                      v),
                    lambda: staircase2.basis_combine_reference(p16, coef,
                                                               lay, v),
                    combine_bound(lay, v, n_bases, d, elem=2),
                    bf16_csr_library(combine_matrix(coef, lay, v, v),
                                     p16.view(v * n_bases, d)))
                row.update(**combine_route_row(blib, p16, pf, coef, lay, v,
                                               got, items),
                           same_bits_twice=True, card=nvidia_smi_line())
                if graph_name == "full_train" and direction == "forward":
                    row["items_sweep_ms"] = {
                        str(n): cuda_ms(lambda: staircase2.launch_combine(
                            blib, p16, coef, lay, v, items=n), 10)
                        for n in SWEEP_ITEMS}
                emit_row(row)
            e = layout.n_edges
            msgs = torch.randn(e, d, generator=gen).to(device).to(BF16)
            msgs_f = msgs.float()
            order = torch.randperm(e, generator=gen).to(device)
            perm = order.to(torch.int32)
            primary = torch.empty_like(msgs)
            primary[order] = msgs
            csr = torch.sparse_csr_tensor(
                layout.row_ptr.long(), torch.arange(e, device=device),
                layout.w, size=(v, e))
            exact, allowance = staircase_exact(msgs_f, layout, v)
            for label, m16, pm in (("", msgs, None), ("_perm", primary,
                                                     perm)):
                mf = m16.float()
                row = bf16_row(
                    "staircase_aggregate_bf16", graph_name, name + label,
                    staircase.launch(slib, m16, layout, v, pm), exact,
                    allowance, staircase.launch(slib, m16, wrong, v, pm),
                    staircase.staircase_aggregate_reference(m16, layout, v,
                                                            pm),
                    lambda: staircase.launch(slib, m16, layout, v, pm),
                    lambda: staircase.launch(slib, mf, layout, v, pm),
                    lambda: staircase.staircase_aggregate_reference(
                        m16, layout, v, pm),
                    staircase_bound(layout, v, d, perm=pm is not None,
                                    elem=2),
                    bf16_csr_library(csr, msgs) if pm is None
                    else (None, "none: timed on the no-perm path"))
                row["items"] = staircase.merge_path_items(v, e)
                emit_row(row)
            # TPU kernel 4: scatter2 with compute_dtype bf16 (its f32
            # primary-order messages cast, the CSR's order as perm); it
            # launches the bf16 entry point once and the f32 one never.
            before = (staircase2.scatter2.launches,
                      staircase2.scatter2.bf16_launches)
            scattered = staircase2.scatter2(primary.float(), layout, v,
                                            order, compute_dtype=BF16)
            after = (staircase2.scatter2.launches,
                     staircase2.scatter2.bf16_launches)
            if after != (before[0], before[1] + 1):
                raise AssertionError(f"scatter2 bf16 {graph_name}/{name}: "
                                     f"(f32, bf16) launches went from "
                                     f"{before} to {after}")
            over = over_allowance(scattered, exact, allowance)
            if not over <= 1:
                raise AssertionError(f"scatter2 bf16 {graph_name}/{name}: "
                                     f"{over} of the allowance")
            emit_row({"kernel": "scatter2_bf16", "graph": graph_name,
                      "direction": name, "over_allowance": over,
                      "max_abs_err": (scattered.double() - exact).abs()
                      .max().item()})
    for row in bf16_block_layouts(lib, graphs, n_rel, device):
        emit_row({**row, "graph": "stress", "direction": row["layout"]})
    for row in bf16_combine_layouts(blib, graphs, n_rel, device):
        emit_row({**row, "graph": "stress", "direction": row["layout"]})
    return rows


# The bf16 cells: (label, settings file, changed lines, the aggregation
# op its path launches); each config also gets stream_precision bfloat16
# (no settings key has it, in either package).
BF16_LINE = ("SkipConnections=None",
             "SkipConnections=None\n\tMessagePrecision=bfloat16")
BF16_VARIANTS = (
    ("bf16", SETTINGS, [BF16_LINE], staircase2.block_direction),
    ("basis_bf16", BASIS_SETTINGS, [BF16_LINE], staircase2.basis_direction),
    ("diag_bf16", BASIS_SETTINGS, [BF16_LINE, ("Name=gcn_basis",
                                               "Name=gcn_diag")],
     staircase.staircase_aggregate),
)
BF16_STEPS = 10


def bf16_config(ds, label, settings, lines):
    """variant_config with bf16 stream precision (``dataclasses.replace``;
    no settings key sets it)."""
    cfg = variant_config(ds, label, settings, lines)
    return dataclasses.replace(cfg, decoder=dataclasses.replace(
        cfg.decoder, stream_precision="bfloat16"))


def bf16_kernels_line(kb, runs) -> list:
    """The five bf16 entry points with this run's numbers: times and
    bounds on the full train graph (the serving shape; the product at the
    forward shape), means over the directions, the training batch's beside
    them; launches those of the bf16 serve and train paths (``runs``:
    phase -> row with the ``op`` it ran), kernel 3's with the energies'
    backwards."""
    def pick(kernel, graph=None, directions=("forward", "backward")):
        return [r for r in kb if r["kernel"] == kernel
                and graph in (None, r["graph"])
                and (directions is None or r["direction"] in directions)]

    def library_mean(rows):
        lib = [r["library_ms"] for r in rows if r["library_ms"] is not None]
        return sum(lib) / len(lib) if lib else None

    def timed(name, source, replaces, kernel, launches, directions=(
            "forward", "backward"), **extra):
        full = pick(kernel, "full_train", directions)
        batch = pick(kernel, "train_batch", directions)
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": sum(launches.values()),
                "launches_by_path": launches,
                "max_abs_err": max(r["max_abs_err"] for r in full + batch),
                "max_over_allowance": max(r["over_allowance"]
                                          for r in full + batch),
                "ms": mean_of(full, "ms"), "f32_ms": mean_of(full, "f32_ms"),
                "plain_ms": mean_of(full, "plain_ms"),
                "bound_ms": mean_of(full, "bound_ms"),
                "bound_by": full[0]["bound_by"],
                "library_ms": library_mean(full),
                "library": full[0]["library"],
                "train_batch_ms": mean_of(batch, "ms"),
                "train_batch_f32_ms": mean_of(batch, "f32_ms"),
                "train_batch_bound_ms": mean_of(batch, "bound_ms"),
                "train_batch_library_ms": library_mean(batch), **extra}

    def launches(key, op, energies=False):
        return {k: r.get(key, 0) * (r["op"] == op)
                + (r.get("energy_launches", 0) if energies else 0)
                for k, r in runs.items()}

    def block_routes(kernel, launches):
        """The slice and walk routes of a block_direction bf16 entry
        point: the slice's plan, times (CUDA events; device times from
        torch.profiler) beside the walk's on the same inputs, bits against
        the f32 entry point, the library's one-call form (f32 and bf16,
        forward direction), and the walk on the layout that forces it."""
        full = pick(kernel, "full_train")
        batch = pick(kernel, "train_batch")
        fwd = [r for r in full + batch if r["direction"] == "forward"]
        walk_rows = [r for r in pick(kernel, "stress", None)
                     if r["route"] == "walk"]
        keys = ("blocks_per_slice", "lanes", "n_slices", "smem_bytes",
                "threads", "registers", "items")
        pre = "bf16_twin_" if "twin" in kernel else "bf16_"
        by_route = {route: sum(r.get(f"{pre}{route}_launches", 0)
                               for r in runs.values())
                    for route in ("slice", "walk")}
        if sum(by_route.values()) != sum(launches.values()):
            raise AssertionError(f"{kernel}: launches by route {by_route}, "
                                 f"{sum(launches.values())} in all")
        return {
            "launches_by_route": by_route,
            "equals_f32_bitwise": all(r["equals_f32_bitwise"]
                                      for r in full + batch),
            "slice": {**{k: full[0][k] for k in keys},
                      "chunks": full[0]["chunks"],
                      "train_batch_chunks": batch[0]["chunks"],
                      "train_batch_items": batch[0]["items"],
                      "ms": mean_of(full, "ms"),
                      "device_ms": mean_device_ms(
                          [r["device_ms"] for r in full],
                          "block_slice_kernel"),
                      "device_ms_tries": [r["device_ms_tries"]
                                          for r in full],
                      "train_batch_ms": mean_of(batch, "ms"),
                      "items_sweep_ms": full[0].get("items_sweep_ms")},
            "walk": {"ms": mean_of(full, "walk_ms"),
                     "device_ms": mean_device_ms(
                         [r["walk_device_ms"] for r in full],
                         "block_direction_kernel"),
                     "device_ms_tries": [r["walk_device_ms_tries"]
                                         for r in full],
                     "train_batch_ms": mean_of(batch, "walk_ms"),
                     "stress_layouts": [
                         {k: r[k] for k in ("layout", "R", "kernel_ms",
                                            "over_allowance",
                                            "wrong_layout_over_allowance",
                                            "op_counted")}
                         for r in walk_rows]},
            "library_one_call": {
                f"{r['graph']}_{k}": r.get(k) for r in fwd
                for k in ("library_f32_ms", "library_f32_build_ms",
                          "library_bf16_build_ms",
                          "library_rel_l2_vs_kernel")},
            "stress_layouts_slice": len([r for r in pick(kernel, "stress",
                                                         None)
                                         if r["route"] == "slice"]),
            "card": full[0]["card"]}

    def combine_routes(launches):
        """basis_combine_bf16's chunk and row routes: the chunk plan,
        times (CUDA events; device times from torch.profiler) beside PR
        6's kernel on the same inputs, forward and twin CSR, bits against
        the f32 entry point, ptxas of both, the library at both shapes,
        and the stress and rectangular layouts."""
        full = pick("basis_combine_bf16", "full_train", None)
        batch = pick("basis_combine_bf16", "train_batch", None)
        twin = ("forward_twin", "backward_twin")
        stress = [r for r in pick("basis_combine_bf16", "stress", None)]
        by_route = {route: sum(r.get(f"bf16_{route}_launches", 0)
                               + r.get(f"bf16_twin_{route}_launches", 0)
                               for r in runs.values())
                    for route in ("chunk", "row")}
        if sum(by_route.values()) != sum(launches.values()):
            raise AssertionError(f"basis_combine_bf16: launches by route "
                                 f"{by_route}, {sum(launches.values())} in "
                                 f"all")

        def times(rows, key, kernel):
            return {"ms": mean_of(rows, key),
                    "device_ms": mean_device_ms([r[f"{kernel[1]}"]
                                                 for r in rows], kernel[0]),
                    "fixup_device_ms": mean_device_ms(
                        [r[kernel[1]] for r in rows], "carry_fixup"),
                    "device_ms_tries": [r[f"{kernel[1]}_tries"]
                                        for r in rows]}
        chunk_k = ("combine_chunk_kernel", "device_ms")
        row_k = ("basis_combine_kernel", "row_device_ms")
        fwd_full = [r for r in full if r["direction"] not in twin]
        fwd_batch = [r for r in batch if r["direction"] not in twin]
        tw_full = [r for r in full if r["direction"] in twin]
        tw_batch = [r for r in batch if r["direction"] in twin]
        return {
            "launches_by_route": by_route,
            "equals_f32_bitwise": all(r["equals_f32_bitwise"]
                                      for r in full + batch + stress),
            "chunk": {**{k: full[0][k] for k in (
                          "cols", "chunk_cols", "n_chunks",
                          "smem_bytes", "items", "ptxas")},
                      "train_batch_items": batch[0]["items"],
                      **times(fwd_full, "ms", chunk_k),
                      "twin": times(tw_full, "ms", chunk_k),
                      "train_batch": times(fwd_batch, "ms", chunk_k),
                      "train_batch_twin": times(tw_batch, "ms", chunk_k),
                      "items_sweep_ms": next(
                          (r["items_sweep_ms"] for r in full
                           if "items_sweep_ms" in r), None)},
            "row": {"ptxas": full[0]["row_ptxas"],
                    **times(fwd_full, "row_ms", row_k),
                    "twin": times(tw_full, "row_ms", row_k),
                    "train_batch": times(fwd_batch, "row_ms", row_k),
                    "train_batch_twin": times(tw_batch, "row_ms", row_k)},
            "library_twin_ms": library_mean(tw_full),
            "library_train_batch_twin_ms": library_mean(tw_batch),
            "stress_layouts": [
                {k: r.get(k) for k in (
                    "layout", "n_src", "n_rows", "B", "d_out", "cols",
                    "n_chunks", "items", "kernel_ms", "row_ms", "bound_ms",
                    "over_allowance", "wrong_layout_over_allowance")}
                for r in stress],
            "card": full[0]["card"]}

    proj = {r["direction"]: r for r in pick("basis_project_bf16", None,
                                            None)}
    fwd = proj["forward"]
    combine = {k: a + b for (k, a), b in zip(
        launches("launches", "basis_direction").items(),
        launches("twin_launches", "basis_direction").values())}
    block_fwd = launches("launches", "block_direction")
    block_twin = launches("twin_launches", "block_direction")
    return [
        timed("block_direction_bf16", KERNEL_SOURCE, REPLACES,
              "block_direction_bf16", block_fwd,
              **block_routes("block_direction_bf16", block_fwd)),
        timed("block_direction_twin_bf16", KERNEL_SOURCE, REPLACES_TWIN,
              "block_direction_twin_bf16", block_twin,
              **block_routes("block_direction_twin_bf16", block_twin)),
        {"name": "basis_project_bf16", "route": "cuda",
         "source": PROJECT_SOURCE, "replaces": REPLACES_BASIS,
         "replaces_twin": REPLACES_BASIS_TWIN,
         "launches": sum(launches("project_launches",
                                  "basis_direction").values()),
         "launches_by_path": launches("project_launches", "basis_direction"),
         "f32_dc_project_launches_by_path": launches("dc_project_launches",
                                                     "basis_direction"),
         "max_abs_err": max(r["max_abs_err"] for r in proj.values()),
         "max_over_allowance": max(r["over_allowance"]
                                   for r in proj.values()),
         "differs_from_plain_share": fwd["differs_from_plain_share"],
         "ms": fwd["ms"], "f32_ms": fwd["f32_ms"],
         "plain_ms": fwd["plain_ms"], "bound_ms": fwd["bound_ms"],
         "bound_by": fwd["bound_by"], "library_ms": fwd["library_ms"],
         "library": fwd["library"], "twin_ms": proj["twin"]["ms"],
         "twin_library_ms": proj["twin"]["library_ms"],
         "odd_shape_ms": proj["odd"]["ms"],
         "product_ms": fwd["product_ms"],
         "product_device_ms": fwd["product_device_ms"],
         "pad_ms": fwd["pad_ms"], "pad_device_ms": fwd["pad_device_ms"],
         "registers": fwd["registers"], "stages": fwd["stages"],
         "bound_share": fwd["bound_ms"] / fwd["ms"],
         "card": fwd["card"]},
        {"name": "bf16_pad", "route": "cuda", "source": PROJECT_SOURCE,
         "replaces": REPLACES_BASIS,
         "launches": sum(launches("pad_launches",
                                  "basis_direction").values()),
         "launches_by_path": launches("pad_launches", "basis_direction"),
         "max_abs_err": 0.0, "equals_plain_bitwise": True,
         "ms": fwd["pad_ms"], "device_ms": fwd["pad_device_ms"],
         "plain_ms": fwd["pad_plain_ms"], "bound_ms": fwd["pad_bound_ms"],
         "bound_by": "bytes", "library_ms": None,
         "twin_ms": proj["twin"]["pad_ms"], "card": fwd["card"]},
        timed("basis_combine_bf16", BASIS_SOURCE, REPLACES_BASIS,
              "basis_combine_bf16", combine,
              replaces_twin=REPLACES_BASIS_TWIN,
              twin_ms=mean_of(pick("basis_combine_bf16", "full_train",
                                   ("forward_twin", "backward_twin")),
                              "ms"), **combine_routes(combine)),
        timed("staircase_aggregate_bf16", STAIRCASE_SOURCE,
              REPLACES_STAIRCASE, "staircase_aggregate_bf16",
              launches("launches", "staircase_aggregate", energies=True),
              replaces_too=REPLACES_SCATTER2,
              perm_ms=mean_of(pick("staircase_aggregate_bf16", "full_train",
                                   ("forward_perm", "backward_perm")), "ms"),
              scatter2_max_over_allowance=max(
                  r["over_allowance"]
                  for r in pick("scatter2_bf16", None, None)))]


def variant_config(ds, label, settings, lines):
    """A copy of ``settings`` with each (old, new) line of ``lines``
    replaced, written under build/chip_smoke/<label> and loaded."""
    text = settings.read_text()
    for old, new in lines:
        if old not in text:
            raise AssertionError(f"{settings.name} has no line {old!r}")
        text = text.replace(old, new)
    path = fresh_dir(label) / f"{settings.stem}_{label}.exp"
    path.write_text(text)
    return config.load(str(path)).with_counts(
        ds.n_entities, ds.n_relations, len(ds.train))


def mlp_config(ds):
    """settings/gcn_block.exp with [Decoder] Name=nonlinear-transform (the
    MLP decoder at its default widths, D=500 over 500-wide codes)."""
    return variant_config(ds, "mlp", SETTINGS, [
        ("Name=bilinear-diag", "Name=nonlinear-transform")])


# The rest of the encoder surface: (phase suffix, settings file, its
# changed lines, the aggregation op its path launches).
ENCODER_VARIANTS = (
    ("plus_diag", BASIS_SETTINGS, [("AddDiagonal=No", "AddDiagonal=Yes")],
     staircase.staircase_aggregate),
    ("times_diag", BASIS_SETTINGS,
     [("DiagonalCoefficients=No", "DiagonalCoefficients=Yes")],
     staircase.staircase_aggregate),
    ("stored", BASIS_SETTINGS, [("StoreEdgeData=No", "StoreEdgeData=Yes")],
     staircase.staircase_aggregate),
    ("vgcn", BASIS_SETTINGS,
     [("Name=gcn_basis", "Name=variational_gcn_basis")],
     staircase2.basis_direction),
    ("vemb", ROOT / "settings" / "distmult.exp",
     [("Name=embedding", "Name=variational_embedding")], None),
    ("highway", SETTINGS,
     [("SkipConnections=None", "SkipConnections=Highway")],
     staircase2.block_direction),
    ("residual_out", SETTINGS,
     [("SkipConnections=None", "SkipConnections=Residual"),
      ("UseOutputTransform=No", "UseOutputTransform=Yes")],
     staircase2.block_direction),
    ("random", SETTINGS, [("UseInputTransform=Yes", "UseInputTransform=No"),
                          ("RandomInput=No", "RandomInput=Yes")],
     staircase2.block_direction),
    ("partial", SETTINGS,
     [("UseInputTransform=Yes", "UseInputTransform=No"),
      ("PartiallyRandomInput=No", "PartiallyRandomInput=Yes")],
     staircase2.block_direction),
)
VARIANT_STEPS = 6
# variational_gcn_basis at full width: its loss leaves the floats after
# the first Adam step, on the CPU plain path as on the card (PERF.md §6,
# PR 9), which lockstep_vs_cpu shows in every run.
NONFINITE_OK = ("vgcn",)


# ---------------------------------------------------------------------------
# The edge-partitioned mesh: mesh_step, mesh_eval, mesh_fit
# ---------------------------------------------------------------------------

# (world size, backend) of the gcn_block step: NCCL on the card's one rank
# (NCCL takes one rank a card), gloo for ranks that share cuda:0.
MESH_WORLDS = ((1, "nccl"), (2, "gloo"), (4, "gloo"))
MESH_ADAM_STEPS = 5
MESH_FIT_STEPS = 20
MESH_DRAW_SEED = 11
MESH_TIMEOUT = 600
MESH_OPS = {"block": staircase2.block_direction,
            "basis": staircase2.basis_direction,
            "staircase": staircase.staircase_aggregate}


def digest(*trees) -> str:
    h = hashlib.sha256()
    for tree in trees:
        for t in tree_leaves(tree):
            h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def mesh_batches(mesh, model, cfg, ds, whole: bool):
    """(this rank's batch, the global batch with the whole graph or None)
    of one pipeline seed, on the rank's device."""
    kw = dict(shard_multiple=mesh.world_size)
    mine = engine.BatchPipeline(model, cfg, ds, np.random.default_rng(0),
                                shard_rank=mesh.rank, **kw).next()
    glob = engine.BatchPipeline(model, cfg, ds, np.random.default_rng(0),
                                **kw).next() if whole else None
    return (mine.to(mesh.device),
            None if glob is None else glob.to(mesh.device))


def mesh_draws(mesh, model, cfg, kind, n_rows):
    """(global draws, this rank's draws): every positive's negatives of
    ``kind`` (factored or split) and the keep-masks from one seeded
    generator on the card, the same on every rank; the rank's rows of the
    negatives."""
    gen = torch.Generator(device=mesh.device).manual_seed(MESH_DRAW_SEED)
    rate, v = cfg.training.negative_sample_rate, cfg.entity_count
    shape = torch.empty(n_rows, 3, device="meta")
    if kind == "factored":
        neg = device_sampling.device_negative_parts(shape, rate, v, gen)
    elif kind == "split":
        neg = device_sampling.device_negative_entities_split(shape, rate, v,
                                                             gen)
    else:
        raise ValueError(f"no mesh draws for {kind!r}")
    draws = engine.Draws(tuple(neg), model.draw_keep_masks(gen))
    rows = mesh_mod.shard_rows(n_rows, mesh.shard)
    return draws, draws._replace(
        negatives=tuple(x[rows] for x in draws.negatives))


def mesh_launches(model, cfg, op, kind, steps, graph, rows) -> dict:
    """The kernels launched since reset_launch_counts by ``steps`` steps
    on this rank's shard, held as phase_train holds a fit's: ``op``'s
    forward and twin launches (none for staircase_aggregate) once a layer
    and direction a step, in the model's precision only, with their
    split, pad and fix-up passes; d blocks' and d C's sums by relation
    once a layer and direction and chunk of the shard's edges; the bf16
    energies' kernel 3 launches for ``rows`` positives, or the float32
    gather-dot route's two kernels and its two sums by id."""
    pre = "bf16_" if model.agg_dtype is not None else ""
    launches = getattr(op, pre + "launches")
    twin = getattr(op, pre + "twin_launches", 0)
    energies = energy_launches()
    check_helper_launches(op, launches, twin,
                          staircase2.basis_direction.project_launches,
                          staircase2.basis_direction.split_launches,
                          fixup_counts(), energies)
    check_other_precision_idle(
        bool(pre), launches if pre and op is staircase2.basis_direction
        else 0)
    per_layer = 2 * cfg.encoder.n_layers
    twin_per_layer = 0 if op is staircase.staircase_aggregate else per_layer
    chunks = -(-graph.fwd.n_edges // staircase2._EDGE_CHUNK)
    by_relation = 0 if op is staircase.staircase_aggregate \
        else per_layer * chunks
    want_energies = steps * fused_energy_launches(
        model, kind, rows, cfg.training.negative_sample_rate)
    want_dots = steps * gather_dot_calls(
        model, kind, rows, cfg.training.negative_sample_rate)
    dots = gather_dot_launches()
    check_gather_dot(dots, want_dots, "mesh rank")
    got = {"launches": launches, "twin_launches": twin,
           "sum_by_csr_launches": sum_by_csr_op().launches,
           "energy_launches": energies, "gather_dot_launches": dots[0]}
    want = {"launches": per_layer * steps,
            "twin_launches": twin_per_layer * steps,
            "sum_by_csr_launches": steps * by_relation + want_energies
            + 2 * want_dots,
            "energy_launches": want_energies,
            "gather_dot_launches": want_dots}
    if got != want:
        raise AssertionError(f"rank's launches {got}, expected {want}")
    return {**got, "project_launches": getattr(
                staircase2.basis_direction, pre + "project_launches"),
            "split_launches": staircase2.basis_direction.split_launches,
            "pad_launches": staircase2.basis_direction.bf16_pad_launches,
            "fixup_launches": sum(fixup_counts().values()),
            **route_launches(),
            "dc_project_launches": launches if pre and op is
            staircase2.basis_direction else 0,
            "per_step": {k: v // steps for k, v in got.items()}}


def sgd_vs_one_device(mesh, model, cfg, params, mine, draws, mine_draws,
                      ref_grads) -> dict:
    """One SGD step at lr 1 without clipping, sharded, against the
    one-device step from the same params and draws: each leaf's update
    within 1e-4 in relative L2 norm; the control sums the ranks' gradients
    (each N times its share) in place of their mean and must miss by N-1
    (at world size 1 a sum is the mean: no control)."""
    sgd = with_optimizer(cfg, algorithm="GradientDescent",
                         max_gradient_norm=None, learning_rate=1.0)
    opt = optimizers.build_optimizer(sgd.optimizer)
    sharded = map_tree(torch.clone, params)
    engine.make_sharded_train_step(model, opt, mesh, "factored")(
        sharded, opt.init(sharded), mine, mine_draws)
    _, local = engine.step_loss_and_grads(model, "factored", params, mine,
                                          mine_draws, group=mesh.group)
    summed = map_tree(lambda g: g * mesh.world_size,
                      collectives.pmean(local, mesh.group))
    if mesh.rank:
        return {}
    out = {}
    for name, grads in (("one_device", ref_grads), ("summed", summed)):
        p = map_tree(torch.clone, params)
        updates, _ = opt.update(grads, opt.init(p))
        optimizers.apply_updates(p, updates)
        out[name] = p

    def worst(got):
        """The largest relative L2 difference of a leaf's update from the
        one-device update (absolute where that update is 0: the unused
        bias)."""
        diffs = []
        for a, b, p0 in zip(tree_leaves(got), tree_leaves(out["one_device"]),
                            tree_leaves(params)):
            diff = (a - b).double().norm().item()
            norm = (b - p0).double().norm().item()
            diffs.append(diff / norm if norm else diff)
        return max(diffs)
    row = {"sgd_lr": 1.0, "sgd_worst_update_rel_l2": worst(sharded)}
    if not row["sgd_worst_update_rel_l2"] <= 1e-4:
        raise AssertionError(f"the sharded SGD step misses the one-device "
                             f"step: {row}")
    if mesh.world_size > 1:
        row["sgd_summed_control_rel_l2"] = worst(out["summed"])
        if not row["sgd_summed_control_rel_l2"] > 0.5:
            raise AssertionError(f"the control that sums the gradients "
                                 f"passed the SGD check: {row}")
    return row


def per_block_step(model, kind, params, whole, draws, n) -> tuple:
    """(loss, gradient tree): the mean over n equal blocks of the global
    batch's rows of the one-device step on each block with the whole
    graph and the block's negatives. Each block's means divide by its own
    count, n times smaller than the batch's (every row real), so its
    gradient is n times its rows' share, as on a rank: the mesh's step
    without a collective."""
    n_rows = whole.triples.shape[0]
    losses, trees = [], []
    for r in range(n):
        rows = mesh_mod.shard_rows(n_rows, (r, n))
        if whole.mask[rows].sum().item() * n != whole.mask.sum().item():
            raise AssertionError("the blocks' real rows differ")
        loss, grads = engine.step_loss_and_grads(
            model, kind, params,
            whole._replace(triples=whole.triples[rows],
                           mask=whole.mask[rows]),
            draws._replace(negatives=tuple(x[rows]
                                           for x in draws.negatives)))
        losses.append(loss)
        trees.append(tree_leaves(grads))
    return sum(losses) / n, tree_unflatten(
        grads, [sum(leaves) / n for leaves in zip(*trees)])


def bf16_stream_rule(loss, grads, ref_loss, ref_grads, f32_grads, block,
                     controls) -> dict:
    """A step on bf16 streams. The positives' gathers sum their backward
    serially in bf16 (the reference's arithmetic, kept: ROADMAP Queue 3
    item 3), so a rank's half of a hub entity's rows rounds otherwise than
    the whole: against the one-device step on the global batch
    (``ref_loss``, ``ref_grads``) the leaves move by up to the bf16 error
    itself, and so does the one-device step against the f32 step
    (``f32_grads``); both reported, the loss held within BF16_STEP_TOL.
    The step is held to BF16_STEP_TOL against ``block`` (loss, gradient
    tree), the mean of the one-device steps on each rank's block of rows
    (``per_block_step``), which sum in bf16 as the ranks do; each of
    ``controls`` (name: gradient tree of a faulty sharded step) must miss
    it."""
    loss_rel = abs(loss.item() - ref_loss.item()) / abs(ref_loss.item())
    if not loss_rel <= BF16_STEP_TOL["loss_rtol"]:
        raise AssertionError(f"bf16 mesh loss differs from the one-device "
                             f"step by {loss_rel}")
    row = same_step(loss, grads, *block, "the one-device steps on the "
                    "ranks' blocks of rows", **BF16_STEP_TOL)
    caught = {}
    for name, tree in controls.items():
        caught[name] = max(rel_l2(g, c) for g, c in zip(
            tree_leaves(tree), tree_leaves(block[1])) if c.norm().item())
        if not caught[name] > BF16_STEP_TOL["leaf_rtol"]:
            raise AssertionError(f"the control {name} passed the bf16 "
                                 f"streams' rule: {caught}")
    leaves = [{"shape": list(g.shape), "vs_one_device": rel_l2(g, r),
               "vs_f32": rel_l2(g, f), "one_device_vs_f32": rel_l2(r, f)}
              for g, r, f in zip(tree_leaves(grads), tree_leaves(ref_grads),
                                 tree_leaves(f32_grads)) if f.norm().item()]
    return {"loss": loss.item(), "ref_loss": ref_loss.item(),
            "loss_rel_diff": loss_rel, "blocks_loss": row["ref_loss"],
            "vs_blocks_loss_rel_diff": row["loss_rel_diff"],
            "vs_blocks_worst_leaf_rel_l2_diff":
                row["worst_leaf_rel_l2_diff"],
            "bf16_stream_rule": True,
            "worst_leaf_rel_l2_diff": max(x["vs_one_device"] for x in leaves),
            "worst_leaf_vs_f32": max(x["vs_f32"] for x in leaves),
            "worst_one_device_leaf_vs_f32": max(x["one_device_vs_f32"]
                                                for x in leaves),
            "controls_vs_blocks": caught, "leaves": leaves}


def mesh_step_cell(mesh, ds, cfg, kind, op_name, tol, full) -> dict:
    """One step of ``kind`` on this rank's shard against the one-device
    step on the global batch and draws (rank 0), within ``tol`` (on bf16
    streams ``bf16_stream_rule``: against the one-device steps on the
    ranks' blocks of rows); at world size 1 they must be
    equal bit for bit. The step's launches on the rank
    (``mesh_launches``) and its all-reduces. With ``full`` (the f32
    gcn_block cell) also sgd_vs_one_device and MESH_ADAM_STEPS steps of
    TrainLoop(mesh=) whose params and Adam state must be equal bit for
    bit on every rank (digests compared by the parent)."""
    exact_float32()
    op = MESH_OPS[op_name]
    model = build.build_model(cfg, mesh.device)
    params = model.init_params(torch.Generator().manual_seed(0))
    mine, whole = mesh_batches(mesh, model, cfg, ds, mesh.rank == 0)
    draws, mine_draws = mesh_draws(mesh, model, cfg, kind,
                                   mine.triples.shape[0] * mesh.world_size)
    torch.cuda.synchronize()
    reset_launch_counts()
    calls0, bytes0 = collectives.all_reduce_sum.calls, \
        collectives.all_reduce_sum.bytes
    loss, grads = engine.sharded_loss_and_grads(model, kind, params, mine,
                                                mine_draws, mesh)
    torch.cuda.synchronize()
    row = {"model": model_label(cfg), "loss_kind": kind,
           "op": op.__name__, "bf16": model.agg_dtype is not None,
           "world_size": mesh.world_size, "backend": mesh.backend,
           "rank_rows": int(mine.triples.shape[0]),
           "rank_real_rows": int(mine.mask.sum().item()),
           "rank_message_edges": mine.graph.fwd.n_edges,
           "all_reduce_calls": collectives.all_reduce_sum.calls - calls0,
           "all_reduce_bytes": collectives.all_reduce_sum.bytes - bytes0,
           **mesh_launches(model, cfg, op, kind, 1, mine.graph,
                           mine.triples.shape[0])}
    controls = {}
    if model.stream_dtype is not None:
        # bf16_stream_rule's controls: the ranks' gradients summed in place
        # of their mean, and rank 0's alone (N times its rows' share: the
        # other ranks' rows lost). Every rank joins the collectives.
        _, alone = engine.step_loss_and_grads(model, kind, params, mine,
                                              mine_draws, group=mesh.group)
        controls = {"summed": map_tree(lambda g: g * mesh.world_size,
                                       grads), "rank0_alone": alone}
    ref_grads = None
    if mesh.rank == 0:
        ref_loss, ref_grads = engine.step_loss_and_grads(model, kind, params,
                                                         whole, draws)
        if model.stream_dtype is None:
            row.update(same_step(loss, grads, ref_loss, ref_grads,
                                 "the one-device step", **tol))
            del row["grads"]
        else:
            _, f32_grads = engine.step_loss_and_grads(
                build.build_model(float32_config(cfg), mesh.device), kind,
                params, whole, draws)
            block = per_block_step(model, kind, params, whole, draws,
                                   mesh.world_size)
            row.update(bf16_stream_rule(loss, grads, ref_loss, ref_grads,
                                        f32_grads, block, controls))
            del f32_grads, block
        row["bitwise_equal"] = loss.item() == ref_loss.item() and all(
            torch.equal(a, b) for a, b in zip(tree_leaves(grads),
                                              tree_leaves(ref_grads)))
        if mesh.world_size == 1 and not row["bitwise_equal"]:
            raise AssertionError("at world size 1 the mesh step differs "
                                 "from the one-device step")
    del grads, controls
    if full:
        row.update(sgd_vs_one_device(mesh, model, cfg, params, mine, draws,
                                     mine_draws, ref_grads))
        del ref_grads
        loop = engine.TrainLoop(model, cfg, ds, seed=0, prefetch=False,
                                log=lambda line: None, mesh=mesh)
        p0, s0 = loop.init_state(0)
        torch.cuda.synchronize()
        reset_launch_counts()
        calls0, bytes0 = collectives.all_reduce_sum.calls, \
            collectives.all_reduce_sum.bytes
        result = loop.fit(p0, s0, max_iterations=MESH_ADAM_STEPS)
        torch.cuda.synchronize()
        row["adam"] = {
            "steps": MESH_ADAM_STEPS,
            "digest": digest(result.params, result.opt_state),
            "count": int(result.opt_state["count"]),
            "losses": [s["loss"] for s in result.steps],
            "all_reduce_calls_per_step": (collectives.all_reduce_sum.calls
                                          - calls0) / MESH_ADAM_STEPS,
            "all_reduce_bytes_per_step": (collectives.all_reduce_sum.bytes
                                          - bytes0) / MESH_ADAM_STEPS,
            **mesh_launches(model, cfg, op, kind, MESH_ADAM_STEPS,
                            mine.graph, mine.triples.shape[0])}
    return row


def mesh_eval_cell(mesh, ds, cfg) -> dict:
    """ModelView(mesh=) on this rank's shard of the train graph against
    the one-device view (rank 0): codes within rtol 1e-4 / atol 1e-4, and
    the filtered MRR of SERVE_TRIPLES test triples within 1e-3 (the serve
    rule); 4 forward launches an encode on each rank."""
    exact_float32()
    model = build.build_model(cfg, mesh.device)
    params = model.init_params(torch.Generator().manual_seed(0))
    graph = model.make_graph(ds.train, shard=mesh.shard)
    view = build.ModelView(model, mesh=mesh)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    codes = view.encoded(params, graph).entity_codes
    torch.cuda.synchronize()
    encode_ms = (time.perf_counter() - t0) * 1e3
    launches = staircase2.block_direction.launches
    if launches != 2 * cfg.encoder.n_layers \
            or staircase2.launch_counts() != (launches, 0):
        raise AssertionError(f"a sharded encode launched "
                             f"{staircase2.launch_counts()}")
    scorer = Scorer(metric=cfg.training.metric)
    for t in (ds.train, ds.valid, ds.test):
        scorer.register_data(t)
    scorer.register_degrees(ds.train)
    scorer.finalize_frequency_computation(ds.all_triples())
    triples = ds.test[:SERVE_TRIPLES]
    scorer.register_model(view, params, graph, n_entities=ds.n_entities)
    t0 = time.perf_counter()
    got = scorer.compute_scores(triples).results["Filtered"]
    score_s = time.perf_counter() - t0
    row = {"world_size": mesh.world_size, "backend": mesh.backend,
           "op": "block_direction", "bf16": False,
           "launches": launches, "twin_launches": 0,
           "fixup_launches": sum(fixup_counts().values()),
           "encode_ms": encode_ms, "score_s": score_s,
           "shard_edges": graph.fwd.n_edges, "mrr_filtered": got["MRR"],
           "hits10_filtered": got["H@10"], "triples": len(triples)}
    if mesh.rank == 0:
        one = build.ModelView(model)
        whole = model.make_graph(ds.train)
        ref = one.encoded(params, whole).entity_codes
        torch.testing.assert_close(codes, ref, rtol=1e-4, atol=1e-4)
        scorer.register_model(one, params, whole, n_entities=ds.n_entities)
        want = scorer.compute_scores(triples).results["Filtered"]
        row.update(codes_max_abs_diff=(codes - ref).abs().max().item(),
                   codes_rel_l2=rel_l2(codes, ref),
                   mrr_filtered_one_device=want["MRR"],
                   mrr_diff=abs(got["MRR"] - want["MRR"]))
        if row["mrr_diff"] > 1e-3:
            raise AssertionError(f"sharded filtered MRR {got['MRR']} "
                                 f"against {want['MRR']}")
    return row


def mesh_fit_cell(mesh, ds, cfg, out_dir) -> dict:
    """MESH_FIT_STEPS steps of TrainLoop(mesh=) through the library, serial
    batches, saving every 10 under a directory of each rank's: only rank
    0's holds checkpoints; the loss finite at every step and lower at the
    last than at the first; steps/s of ranks that share one card."""
    exact_float32()
    cfg = with_optimizer(cfg, save_every_n=10)
    model = build.build_model(cfg, mesh.device)
    loop = engine.TrainLoop(model, cfg, ds, seed=0, prefetch=False,
                            log=lambda line: None, mesh=mesh)
    rank_dir = Path(out_dir) / f"rank{mesh.rank}"
    rank_dir.mkdir(parents=True, exist_ok=True)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    result = loop.fit(max_iterations=MESH_FIT_STEPS,
                      checkpoint_path=str(rank_dir / "m"))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    losses = [s["loss"] for s in result.steps]
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"mesh fit losses {losses}")
    return {"world_size": mesh.world_size, "steps": result.iterations,
            "op": "block_direction", "bf16": False,
            **mesh_launches(model, cfg, staircase2.block_direction,
                            "factored", MESH_FIT_STEPS,
                            loop.pipeline.next().graph,
                            loop.pipeline.positives_pad
                            // mesh.world_size),
            "losses": losses, "wall_s": wall_s,
            "steps_per_s": loop.timer.summary()["steps_per_sec"],
            "step_ms_median": statistics.median(s["step_ms"]
                                                for s in result.steps),
            "checkpoints": sorted(p.name for p in rank_dir.glob("*.ckpt")),
            "digest": digest(result.params, result.opt_state)}


def mesh_rank(mesh, cells) -> dict:
    """One rank of a mesh phase (a process started by
    distributed.launch): each cell (label, kind, arguments) in turn on the
    seeded synth:FB15k-237 graph."""
    ds = synthetic.like("FB15k-237", seed=0)
    out = {}
    for label, kind, args in cells:
        t0 = time.perf_counter()
        if kind == "step":
            out[label] = mesh_step_cell(mesh, ds, *args)
        elif kind == "eval":
            out[label] = mesh_eval_cell(mesh, ds, *args)
        else:
            out[label] = mesh_fit_cell(mesh, ds, *args)
        out[label]["cell_s"] = time.perf_counter() - t0
    return out


def launch_mesh(world, backend, cells) -> list:
    """mesh_rank on ``world`` spawned ranks on cuda:0 (one rank over NCCL,
    or gloo ranks sharing the card)."""
    return distributed.launch(mesh_rank, world, (cells,), backend=backend,
                              devices=["cuda:0"] * world,
                              timeout=MESH_TIMEOUT)


def phase_mesh_step(ds, cfg, basis_cfg, train_steps_per_s) -> dict:
    """mesh_step and mesh_eval: the gcn_block f32 step (factored) on 1
    (NCCL), 2 and 4 (gloo) ranks on cuda:0, each with its SGD control and
    MESH_ADAM_STEPS Adam steps equal bit for bit on every rank; at 2 ranks
    also gcn_basis (kernel 2), gcn_diag (kernel 3), gcn_block with bf16
    message precision (the bf16 kernels, BF16_STEP_TOL) and with both
    precisions bf16 (bf16_stream_rule: BF16_STEP_TOL against the
    one-device steps on the ranks' blocks of rows), the split protocol,
    the sharded ModelView and a MESH_FIT_STEPS-step fit (its steps/s
    beside the one-device train phase's ``train_steps_per_s``: ranks that
    share one card, not a scale-out number). Returns each path's launch row by phase name."""
    t_phase = time.perf_counter()
    diag_cfg = dataclasses.replace(basis_cfg, encoder=dataclasses.replace(
        basis_cfg.encoder, name="gcn_diag"))
    bf16_cfg = bf16_config(ds, "mesh_bf16", SETTINGS, [BF16_LINE])
    message_cfg = variant_config(ds, "mesh_bf16_message", SETTINGS,
                                 [BF16_LINE])
    block = ("block", "step", (cfg, "factored", "block", {}, True))
    extra = [("basis", "step", (basis_cfg, "factored", "basis", {}, False)),
             ("diag", "step", (diag_cfg, "factored", "staircase", {},
                               False)),
             ("bf16_message", "step", (message_cfg, "factored", "block",
                                       BF16_STEP_TOL, False)),
             ("bf16", "step", (bf16_cfg, "factored", "block",
                               BF16_STEP_TOL, False)),
             ("split", "step", (cfg, "split", "block", {}, False)),
             ("eval", "eval", (cfg,)),
             ("fit", "fit", (cfg, str(fresh_dir("mesh_fit_library"))))]
    paths = {}
    for world, backend in MESH_WORLDS:
        results = launch_mesh(world, backend,
                              [block] + (extra if world == 2 else []))
        digests = {r["block"]["adam"]["digest"] for r in results}
        if len(digests) != 1:
            raise AssertionError(f"params and Adam state differ between "
                                 f"the {world} ranks after "
                                 f"{MESH_ADAM_STEPS} steps")
        head = results[0]
        for label, row in head.items():
            if label == "eval":
                emit("mesh_eval", phase_s=time.perf_counter() - t_phase,
                     card=nvidia_smi_line(), **row)
            elif label == "fit":
                ckpts = [r["fit"]["checkpoints"] for r in results]
                if ckpts[0] != ["m-10.ckpt", "m-20.ckpt"] \
                        or any(ckpts[1:]) \
                        or len({r["fit"]["digest"] for r in results}) != 1:
                    raise AssertionError(f"mesh fit checkpoints {ckpts}, "
                                         f"or the ranks' params differ")
                emit("mesh_step_fit", phase_s=time.perf_counter() - t_phase,
                     card=nvidia_smi_line(),
                     one_device_steps_per_s=train_steps_per_s,
                     note="ranks that share one card, not a scale-out "
                          "number", **row)
            else:
                emit("mesh_step", cell=label,
                     phase_s=time.perf_counter() - t_phase,
                     replicas_bitwise_equal=True, card=nvidia_smi_line(),
                     **row)
            launch_row = {**row, **row.get("adam", {})}
            paths[f"mesh_{label}_{world}"] = launch_row
    return paths


MESH_CLI_CUTS = ("CheckEvery=2000", "CheckEvery=10"), \
    ("BurninPhaseDuration=6000", "BurninPhaseDuration=20"), \
    ("ReportTrainLossEvery=100", "ReportTrainLossEvery=10")
# The resume runs save every 10 steps and check nothing before step 1,000.
MESH_CLI_SAVES = ("CheckEvery=2000", "CheckEvery=1000"), \
    ("ReportTrainLossEvery=100", "ReportTrainLossEvery=10\n\tSaveEveryN=10")


def mesh_cli(name, lines, *flags) -> tuple:
    """``python -m relationprediction_torch.train`` on gcn_block.exp with
    ``lines`` changed and ExperimentName under build/chip_smoke/mesh_fit,
    on synth:FB15k-237 with --mesh 1 (one rank, NCCL); (stdout, the
    checkpoint path, seconds)."""
    out = fresh_dir(f"mesh_fit/{name}")
    text = SETTINGS.read_text()
    for old, new in lines + (("ExperimentName=models/BlockGCN",
                              f"ExperimentName={out / 'm'}"),):
        if old not in text:
            raise AssertionError(f"gcn_block.exp has no line {old!r}")
        text = text.replace(old, new)
    (out / "gcn_block.exp").write_text(text)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "relationprediction_torch.train",
         "--settings", str(out / "gcn_block.exp"), "--dataset",
         "synth:FB15k-237", "--mesh", "1", *flags], cwd=ROOT,
        capture_output=True, text=True, timeout=MESH_TIMEOUT)
    if proc.returncode != 0:
        raise AssertionError(f"train.py --mesh 1 failed: "
                             f"{proc.stdout[-2000:]}{proc.stderr[-4000:]}")
    return proc.stdout, str(out / "m"), time.perf_counter() - t0


def same_checkpoints(a: str, b: str, step: int) -> None:
    """The two runs' checkpoints at ``step``: params, Adam state and the
    pipelines' states equal bit for bit."""
    x = checkpoint.restore(f"{a}-{step}.ckpt")
    y = checkpoint.restore(f"{b}-{step}.ckpt")
    for part in ("params", "opt_state"):
        for u, v in zip(tree_leaves(x[part]), tree_leaves(y[part])):
            if not np.array_equal(np.asarray(u), np.asarray(v)):
                raise AssertionError(f"{part} differ at step {step}")
    if x["extra"]["pipeline_states"] != y["extra"]["pipeline_states"]:
        raise AssertionError(f"pipeline states differ at step {step}")


def phase_mesh_fit() -> dict:
    """mesh_fit: train.py's main path with --mesh 1 (NCCL) for FIT_STEPS
    steps at the fit phase's cadence, then a 10-step run and its --resume
    to 20 (saving every 10, no check): the checkpoints at 10 (two runs from
    one seed) and 20 (the resumed run) equal the first run's bit for
    bit."""
    t_phase = time.perf_counter()
    out_a, a, a_s = mesh_cli("a", MESH_CLI_CUTS, "--max-iterations",
                             str(FIT_STEPS))
    _, b, b_s = mesh_cli("b", MESH_CLI_SAVES, "--max-iterations", "10")
    proc = subprocess.run(
        [sys.executable, "-m", "relationprediction_torch.train",
         "--settings", str(Path(b).parent / "gcn_block.exp"), "--dataset",
         "synth:FB15k-237", "--mesh", "1", "--resume",
         "--max-iterations", "20"], cwd=ROOT, capture_output=True,
        text=True, timeout=MESH_TIMEOUT)
    if proc.returncode != 0:
        raise AssertionError(f"the resumed run failed: {proc.stderr[-4000:]}")
    same_checkpoints(a, b, 10)
    same_checkpoints(a, b, 20)
    done = re.search(r"Training done: (\d+) iterations .* last loss (\S+) "
                     r"\((\S+) steps/s", out_a)
    checks = re.findall(r"Tested validation score at iteration (\d+)", out_a)
    if not done or "Mesh: 1 ranks over nccl" not in out_a \
            or not np.isfinite(float(done.group(2))) or not checks:
        raise AssertionError(f"train.py --mesh 1 printed {out_a[-2000:]}")
    row = {"steps": int(done.group(1)), "last_loss": float(done.group(2)),
           "steps_per_s_incl_checks": float(done.group(3)),
           "checks": [int(c) for c in checks], "run_s": a_s,
           "short_run_s": b_s, "checkpoints_10_and_20_bitwise": True,
           "backend": "nccl", "card": nvidia_smi_line()}
    emit("mesh_fit", phase_s=time.perf_counter() - t_phase, **row)
    return row


# ---------------------------------------------------------------------------
# The vertex-sharded path: vs_step, vs_eval, vs_fit
# ---------------------------------------------------------------------------

VS_DRAW_SEED = 13
VS_KERNEL_SEED = 14
VS_FIT_STEPS = 20
VS_TIMEOUT = 600


def vs_module():
    """parallel/vertex_sharded.py, imported where it is used, as
    sum_by_csr_op is."""
    from relationprediction_torch.parallel import vertex_sharded
    return vertex_sharded


def vs_one_device(model, whole, masks, kind) -> tuple:
    """(TrainBatch, Draws) of the one-device step on a VSBatch: the
    message graph of every shard's real forward edges, the padded
    positives (or the host-tiled rows and labels) with their mask, the
    corruption parts, the [V, d] keep-masks."""
    sen, rel, rec, msk = whole.f_arrays[:4]
    real = msk > 0
    graph = model.make_graph(np.stack([sen[real], rel[real], rec[real]], 1))
    dev = model.device

    def flat(a, *shape):
        return torch.from_numpy(np.ascontiguousarray(a).reshape(
            -1, *shape)).to(dev)
    triples, mask = flat(whole.triples, 3), flat(whole.mask)
    if kind == "factored":
        k = whole.neg_values.shape[-1]
        return (engine.TrainBatch(graph, triples, mask),
                engine.Draws((flat(whole.neg_values, k),
                              flat(whole.corrupt_object, k)), masks))
    return (engine.TrainBatch(graph, triples, mask,
                              labels=flat(whole.labels)),
            engine.Draws((), masks))


def vs_launches(enc, model, op, batch, steps=1) -> dict:
    """The kernels a rank launched since reset_launch_counts in ``steps``
    vertex-sharded steps on ``batch`` (its VSRankBatch), held exactly:
    ``op``'s forward launches (2 a layer) and, on the fused routes, as
    many twin passes, in the model's message precision (the unfused
    routes sum in f32, as JAX's segment sum does), each with its split,
    pad and fix-up passes; the sums by id of kernel 3: d blocks' or d C's
    by relation (a layer, direction and chunk of the rank's edges) and
    each halo exchange's backward (2 a layer with the targeted halo, and
    the decoder's); on a factored batch the gather-dot route's two kernels
    and its two sums by id; no bf16 energies' launch (f32 streams)."""
    pre = "bf16_" if model.agg_dtype is not None and enc.fused else ""
    launches = getattr(op, pre + "launches")
    twin = getattr(op, pre + "twin_launches", 0)
    energies = energy_launches()
    check_helper_launches(op, launches, twin,
                          staircase2.basis_direction.project_launches,
                          staircase2.basis_direction.split_launches,
                          fixup_counts(), energies)
    check_other_precision_idle(bool(pre))
    n_layers = model.config.encoder.n_layers
    chunks = sum(-(-d.csr.n_edges // staircase2._EDGE_CHUNK)
                 for d in (batch.graph.fwd, batch.graph.bwd))
    exchanges = 2 * n_layers if enc.halo == "targeted" else 0
    dots = steps * gather_dot_calls(
        model, "factored" if batch.loss.factored else "tiled", 0, 1)
    check_gather_dot(gather_dot_launches(), dots, "vertex-sharded rank")
    got = {"launches": launches, "twin_launches": twin,
           "sum_by_csr_launches": sum_by_csr_op().launches,
           "energy_launches": energies,
           "gather_dot_launches": gather_dot_launches()[0]}
    want = {"launches": 2 * n_layers * steps,
            "twin_launches": 2 * n_layers * steps * enc.fused,
            "sum_by_csr_launches": steps * (
                n_layers * chunks * enc.fused + exchanges + 1) + 2 * dots,
            "energy_launches": 0, "gather_dot_launches": dots}
    if got != want:
        raise AssertionError(f"rank's vertex-sharded launches {got}, "
                             f"expected {want}")
    return {**got, "op": op.__name__, "bf16": bool(pre),
            "project_launches": getattr(staircase2.basis_direction,
                                        pre + "project_launches"),
            "split_launches": staircase2.basis_direction.split_launches,
            "pad_launches": staircase2.basis_direction.bf16_pad_launches,
            "fixup_launches": sum(fixup_counts().values()),
            **route_launches(),
            "per_step": {k: v // steps for k, v in got.items()}}


def vs_exchange_bytes(enc, model, batch) -> int:
    """The bytes a step's all-to-alls send from this rank, from shapes:
    each exchange ships its [n, h] rows of d f32 columns, once forward and
    once backward; a layer exchanges each direction with the targeted
    halo, and the loss exchanges the decoder's."""
    e = model.config.encoder
    rows = batch.loss.dec_send.numel() * e.code_dimension
    if enc.halo == "targeted":
        rows += e.n_layers * e.internal_dimension * (
            batch.graph.fwd.send_idx.numel()
            + batch.graph.bwd.send_idx.numel())
    return 2 * 4 * rows


def vs_kernel_rows(enc, model, batch) -> list:
    """Each hand kernel of the cell's route, in the cell's message
    precision (the bf16 entry points where the fused route sums in bf16),
    on the rank's forward direction's rectangular layouts (rows_per owned
    rows from its halo buffer, and the twin the reverse) against the
    float64 sum of its (bf16-valued) inputs within sum_allowance (plus one
    bf16 ulp for the rounded bf16 product); the same layout with its
    weights reversed (a wrong layout) must fall outside it. Times of the
    kernel (CUDA events) and of its plain version beside the bound. The
    f32 all-gather cell also holds the bf16 block entry points (the slice
    route) on its layouts, which read all v_pad rows."""
    dev = model.device
    gen = torch.Generator(device=dev).manual_seed(VS_KERNEL_SEED)
    e = model.config.encoder
    d, n_rel = e.internal_dimension, model.n_relations
    csr, twin = batch.graph.fwd.csr, batch.graph.fwd.twin
    rows_per, h_len = csr.n_rows, csr.source_rows
    bf16 = model.agg_dtype is not None and enc.fused
    dtype, elem, sfx = (BF16, 2, "_bf16") if bf16 else (torch.float32, 4, "")

    def randn(*shape, to=dtype):
        """Random inputs in the kernel's dtype."""
        return torch.randn(*shape, generator=gen, device=dev).to(to)

    def wrong(layout):
        return with_weights(layout, layout.w.flip(0).contiguous())
    cases = []
    if enc.fused and enc.variant == "block":
        n_blocks, dr = e.n_bases, d // e.n_bases
        lib = staircase2.kernel_library()[0]
        precisions = [(dtype, elem, sfx)]
        if enc.halo == "all_gather" and not bf16:
            precisions.append((BF16, 2, "_bf16"))
        for (to, p_elem, p_sfx), (kernel, x_rows, layout, n_out, is_twin) \
                in itertools.product(precisions, (
                    ("block_direction", h_len, csr, rows_per, False),
                    ("block_direction_twin", rows_per, twin, h_len, True))):
            if not is_twin:  # one set of blocks for both passes
                blocks = randn(n_rel, n_blocks, dr, dr, to=to)
            x = randn(x_rows, d, to=to)
            w_eff = blocks.transpose(-1, -2) if is_twin else blocks
            cases.append((
                kernel + p_sfx, layout, n_out,
                lambda lay, x=x, w=blocks, n=n_out, t=is_twin:
                    staircase2._aggregate(x, w, lay, n, twin=t),
                lambda lay, x=x, w=w_eff, n=n_out: block_exact(
                    x.float(), w.float(), lay, n),
                lambda lay, x=x, w=w_eff, n=n_out:
                    staircase2.block_direction_reference(x, w, lay, n),
                lambda lay, x=x, w=blocks, n=n_out, t=is_twin:
                    staircase2.launch(lib, x, w, lay, n, twin=t),
                block_direction_bound(layout, n_out, n_rel, n_blocks, dr,
                                      elem=p_elem)))
    elif enc.fused:
        n_bases = e.n_bases
        coef = torch.randn(n_rel, n_bases, generator=gen, device=dev)
        lib = staircase2.basis_kernel_library()[0]
        for kernel, proj, layout, n_out in (
                ("basis_combine", randn(h_len, n_bases * d), csr, rows_per),
                ("basis_combine_twin", randn(rows_per, n_bases * d), twin,
                 h_len)):
            cases.append((
                kernel + sfx, layout, n_out,
                lambda lay, p=proj, n=n_out, t=kernel.endswith("twin"):
                    staircase2._combine(p, coef, lay, n, twin=t),
                lambda lay, p=proj, n=n_out: combine_exact(p.float(), coef,
                                                           lay, n),
                lambda lay, p=proj, n=n_out:
                    staircase2.basis_combine_reference(p, coef, lay, n),
                lambda lay, p=proj, n=n_out: staircase2.launch_combine(
                    lib, p, coef, lay, n),
                combine_bound(layout, n_out, n_bases, d, elem=elem)))
    else:
        msgs = randn(csr.n_edges, d)
        lib = staircase.kernel_library()[0]
        cases.append(("staircase_aggregate", csr, rows_per,
                      lambda lay: staircase.aggregate(msgs, lay, rows_per),
                      lambda lay: staircase_exact(msgs, lay, rows_per),
                      lambda lay: staircase.staircase_aggregate_reference(
                          msgs, lay, rows_per),
                      lambda lay: staircase.launch(lib, msgs, lay, rows_per),
                      staircase_bound(csr, rows_per, d)))
    rows = []
    for kernel, layout, n_out, run, exact_of, plain_of, launch_of, bound \
            in cases:
        got, bad = run(layout), run(wrong(layout))
        exact, allowance = exact_of(layout)
        torch.cuda.synchronize()
        row = {"kernel": kernel, "rows": layout.n_rows,
               "source_rows": layout.source_rows, "edges": layout.n_edges,
               "over_allowance": over_allowance(got, exact, allowance),
               "wrong_layout_over_allowance": over_allowance(bad, exact,
                                                             allowance),
               "max_abs_err": (got.float() - plain_of(layout).float()).abs()
               .max().item(),
               "kernel_ms": cuda_ms(lambda: launch_of(layout), 10),
               "plain_ms": cuda_ms(lambda: plain_of(layout), 3, warmup=1),
               "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"]}
        if kernel.startswith("block_direction"):
            # The bf16 block kernels take the slice route: R = 237
            # relations' 5x5 blocks fit shared memory.
            row["route"] = staircase2.block_direction_route(
                n_rel, e.n_bases, d // e.n_bases).route \
                if kernel.endswith("_bf16") else "walk"
            if kernel.endswith("_bf16") and row["route"] != "slice":
                raise AssertionError(f"{kernel}: route {row['route']}")
        if not (torch.isfinite(got).all() and row["over_allowance"] <= 1
                < row["wrong_layout_over_allowance"]):
            raise AssertionError(f"{kernel} on a rectangular layout: {row}")
        rows.append(row)
    if enc.fused and enc.variant == "basis":
        x, w = randn(h_len, d), randn(d, e.n_bases * d)
        exact, allowance = project_exact(x.float(), w.float())
        if bf16:  # P is rounded to bf16
            allowance = allowance + BF16_ULP * exact.abs()
        got = staircase2._project(x, w)
        plib = staircase2.project_kernel_library()[0]
        launch = staircase2.launch_project_bf16 if bf16 \
            else staircase2.launch_project
        row = {"kernel": "basis_project" + sfx, "rows": h_len,
               "over_allowance": over_allowance(got, exact, allowance),
               "max_abs_err": (got.float() - staircase2
                               .basis_project_reference(x, w).float())
               .abs().max().item(),
               "kernel_ms": cuda_ms(lambda: launch(plib, x, w), 10),
               "plain_ms": cuda_ms(lambda: staircase2.basis_project_reference(
                   x, w), 3, warmup=1),
               **(least_time(2 * (h_len * d + d * e.n_bases * d
                                  + h_len * e.n_bases * d),
                             2 * h_len * d * e.n_bases * d, BF16_OPS_PER_S)
                  if bf16 else project_bound(h_len, d, e.n_bases * d))}
        if not row["over_allowance"] <= 1:
            raise AssertionError(f"basis_project on the halo buffer: {row}")
        rows.append(row)
    return rows


def vs_step_cell(mesh, ds, cfg, kind, options, tol, control) -> dict:
    """One vertex-sharded step of ``kind`` ('factored' or 'tiled') with
    'full_parity' dropout and the encoder ``options`` on this rank's shard,
    against the one-device step on the same batch and draws (rank 0):
    ``same_step`` within ``tol``, the padded table unpadded; its launches
    (``vs_launches``), all-to-alls (counted and from shapes) and
    all-reduces; the kernels of its route on the rank's rectangular
    layouts (``vs_kernel_rows``); with ``control``, the control that takes
    the mean over the ranks of the whole gradient tree (the table's rows
    included), which must miss the leaf rule."""
    exact_float32()
    vsm = vs_module()
    model = build.build_model(cfg, mesh.device)
    params = model.init_params(torch.Generator().manual_seed(0))
    enc = vsm.VertexShardedEncoder(model, mesh, dropout_mode="full_parity",
                                   **options)
    t0 = time.perf_counter()
    pipe = vsm.VertexShardedBatchPipeline(enc, cfg, ds,
                                          np.random.default_rng(0),
                                          factored=kind == "factored")
    whole = pipe.next()
    batch = vsm.VSRankBatch(
        enc.shard_graph(whole.f_arrays, whole.b_arrays),
        enc.shard_loss(whole)).to(mesh.device)
    host_s = time.perf_counter() - t0
    masks = model.draw_keep_masks(
        torch.Generator(device=mesh.device).manual_seed(VS_DRAW_SEED))
    keep = enc.shard_keep_masks(masks)
    local = enc.place_state(enc.pad_params(params))
    torch.cuda.synchronize()
    reset_launch_counts()
    counters = (collectives.halo_exchange.calls,
                collectives.halo_exchange.bytes,
                collectives.all_reduce_sum.calls,
                collectives.all_reduce_sum.bytes)
    t0 = time.perf_counter()
    loss, grads = enc.loss_and_grads(local, batch, keep)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    a2a_calls = collectives.halo_exchange.calls - counters[0]
    a2a_bytes = collectives.halo_exchange.bytes - counters[1]
    (f_tg, f_ag), (b_tg, b_ag) = enc.traffic
    row = {"model": model_label(cfg), "loss_kind": kind,
           "halo": enc.halo, "overlap": enc.overlap, "fused": enc.fused,
           "world_size": mesh.world_size, "backend": mesh.backend,
           "rows_per": enc.rows_per, "v_pad": enc.v_pad,
           "budgets": pipe.budgets,
           "halo_h": None if batch.graph.fwd.send_idx is None
           else batch.graph.fwd.send_idx.shape[-1],
           "decoder_halo_h": batch.loss.dec_send.shape[-1],
           "rows_shipped_per_exchange": {"forward": f_tg, "backward": b_tg,
                                         "all_gather": f_ag},
           "rank_edges": {"forward": batch.graph.fwd.csr.n_edges,
                          "backward": batch.graph.bwd.csr.n_edges},
           "rank_loss_rows": int(batch.loss.triples.shape[0]),
           "host_batch_s": host_s, "step_ms_host_clock": step_ms,
           "all_to_all_calls": a2a_calls, "all_to_all_bytes": a2a_bytes,
           "all_to_all_bytes_from_shapes": vs_exchange_bytes(enc, model,
                                                             batch),
           "all_reduce_calls": collectives.all_reduce_sum.calls
           - counters[2],
           "all_reduce_bytes": collectives.all_reduce_sum.bytes
           - counters[3],
           **vs_launches(enc, model, MESH_OPS[
               "staircase" if not enc.fused
               else enc.variant], batch)}
    if row["all_to_all_bytes"] != row["all_to_all_bytes_from_shapes"] \
            or a2a_calls != 2 * (2 * cfg.encoder.n_layers * (
                enc.halo == "targeted") + 1):
        raise AssertionError(f"all-to-alls {a2a_calls} calls, "
                             f"{a2a_bytes} bytes: {row}")
    grads = enc.unpad_params(enc.gather_state(grads))
    bad_table = None
    if control and mesh.world_size > 1:
        _, raw = engine._value_and_grad(
            lambda: enc.loss(local, batch.graph, batch.loss, keep), local)
        bad_table = enc.gather_state(collectives.pmean(raw, mesh.group))[
            "input_transform"]["W"][:model.n_entities]
    if mesh.rank:
        return row
    one_batch, draws = vs_one_device(model, whole, masks, kind)
    ref_loss, ref_grads = engine.step_loss_and_grads(model, kind, params,
                                                     one_batch, draws)
    row.update(same_step(loss, grads, ref_loss, ref_grads,
                         "the one-device step", **tol))
    del row["grads"]
    row["bitwise_equal"] = loss.item() == ref_loss.item() and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(grads),
                                          tree_leaves(ref_grads)))
    if control and mesh.world_size > 1:  # one rank's mean is its own
        rule = tol.get("leaf_rtol", 1e-4)
        row["pmean_control_table_rel_l2"] = rel_l2(
            bad_table, ref_grads["input_transform"]["W"])
        if not row["pmean_control_table_rel_l2"] > rule:
            raise AssertionError(f"the table's gradient through pmean "
                                 f"passed the leaf rule: {row}")
    row["rectangular_kernels"] = vs_kernel_rows(enc, model, batch)
    return row


def vs_eval_cell(mesh, ds, cfg) -> dict:
    """VertexShardedModelView on the whole train graph's layouts against
    the one-device view (rank 0): codes within rtol 1e-4 / atol 1e-4, the
    filtered MRR of SERVE_TRIPLES test triples within 1e-3 (the serve
    rule); 4 forward launches an encode on each rank."""
    exact_float32()
    vsm = vs_module()
    model = build.build_model(cfg, mesh.device)
    params = model.init_params(torch.Generator().manual_seed(0))
    enc = vsm.VertexShardedEncoder(model, mesh)
    view = vsm.VertexShardedModelView(enc, *vsm.eval_arrays(enc, ds.train))
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    _, codes = view.encoded(params)
    torch.cuda.synchronize()
    encode_ms = (time.perf_counter() - t0) * 1e3
    launches = staircase2.block_direction.launches
    if launches != 2 * cfg.encoder.n_layers \
            or staircase2.launch_counts() != (launches, 0):
        raise AssertionError(f"a vertex-sharded encode launched "
                             f"{staircase2.launch_counts()}")
    codes = collectives.all_gather_rows(codes, mesh.group)[:ds.n_entities]
    scorer = Scorer(metric=cfg.training.metric)
    for t in (ds.train, ds.valid, ds.test):
        scorer.register_data(t)
    scorer.register_degrees(ds.train)
    scorer.finalize_frequency_computation(ds.all_triples())
    triples = ds.test[:SERVE_TRIPLES]
    scorer.register_model(view, params, None, n_entities=ds.n_entities)
    t0 = time.perf_counter()
    got = scorer.compute_scores(triples).results["Filtered"]
    score_s = time.perf_counter() - t0
    row = {"world_size": mesh.world_size, "backend": mesh.backend,
           "op": "block_direction", "bf16": False, "launches": launches,
           "twin_launches": 0, "fixup_launches": sum(fixup_counts().values()),
           "sum_by_csr_launches": 0, "project_launches": 0,
           "split_launches": 0, "encode_ms": encode_ms, "score_s": score_s,
           "rank_edges": view.graph.fwd.csr.n_edges,
           "mrr_filtered": got["MRR"], "hits10_filtered": got["H@10"],
           "triples": len(triples)}
    if mesh.rank == 0:
        one = build.ModelView(model)
        whole = model.make_graph(ds.train)
        ref = one.encoded(params, whole).entity_codes
        torch.testing.assert_close(codes, ref, rtol=1e-4, atol=1e-4)
        scorer.register_model(one, params, whole, n_entities=ds.n_entities)
        want = scorer.compute_scores(triples).results["Filtered"]
        row.update(codes_max_abs_diff=(codes - ref).abs().max().item(),
                   codes_rel_l2=rel_l2(codes, ref),
                   mrr_filtered_one_device=want["MRR"],
                   mrr_diff=abs(got["MRR"] - want["MRR"]))
        if row["mrr_diff"] > 1e-3:
            raise AssertionError(f"vertex-sharded filtered MRR "
                                 f"{got['MRR']} against {want['MRR']}")
    return row


def vs_fit_cell(mesh, ds, cfg) -> dict:
    """VS_FIT_STEPS steps of TrainLoop(vertex_sharded=True) (factored,
    per-shard dropout, serial batches): the loss finite at every step and
    lower at the last than at the first, the launches of every step, the
    ranks' gathered params and Adam state equal; steps/s of ranks that
    share one card."""
    exact_float32()
    model = build.build_model(cfg, mesh.device)
    loop = engine.TrainLoop(model, cfg, ds, seed=0, prefetch=False,
                            log=lambda line: None, mesh=mesh,
                            vertex_sharded=True)
    params, opt_state = loop.init_state(0)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    result = loop.fit(params, opt_state, max_iterations=VS_FIT_STEPS)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    losses = [s["loss"] for s in result.steps]
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"vertex-sharded fit losses {losses}")
    batch = loop.pipeline.next()
    return {"world_size": mesh.world_size, "steps": result.iterations,
            **vs_launches(loop.vse, model, staircase2.block_direction,
                          batch, VS_FIT_STEPS),
            "losses": losses, "wall_s": wall_s,
            "steps_per_s": loop.timer.summary()["steps_per_sec"],
            "step_ms_median": statistics.median(s["step_ms"]
                                                for s in result.steps),
            "digest": digest(result.params, result.opt_state)}


def vs_rank(mesh, cells) -> dict:
    """One rank of the vertex-sharded phases: each cell (label, kind,
    arguments) in turn on the seeded synth:FB15k-237 graph."""
    ds = synthetic.like("FB15k-237", seed=0)
    out = {}
    for label, kind, args in cells:
        t0 = time.perf_counter()
        fn = {"step": vs_step_cell, "eval": vs_eval_cell,
              "fit": vs_fit_cell}[kind]
        out[label] = fn(mesh, ds, *args)
        out[label]["cell_s"] = time.perf_counter() - t0
    return out


def phase_vs(ds, cfg, basis_cfg, train_steps_per_s) -> dict:
    """vs_step and vs_eval, and vs_fit's library part: the gcn_block f32
    factored step with 'full_parity' dropout on 1 (NCCL), 2 and 4 (gloo)
    ranks on cuda:0 against the one-device step, with the pmean control;
    at 2 ranks also gcn_basis (kernel 2) and gcn_diag (kernel 3) with
    the control, the overlapped schedule on gcn_block (unfused block
    messages, kernel 3), the all-gather halo, the tiled loss and bf16
    message precision (BF16_STEP_TOL); every cell with the kernels of its
    route on its rectangular layouts (``vs_kernel_rows``); the 2-rank VertexShardedModelView, and
    VS_FIT_STEPS steps of TrainLoop(vertex_sharded=True) (their steps/s
    beside the one-device train phase's ``train_steps_per_s``: ranks that
    share one card, not a scale-out number). Returns each path's launch
    row by phase name."""
    t_phase = time.perf_counter()
    diag_cfg = dataclasses.replace(basis_cfg, encoder=dataclasses.replace(
        basis_cfg.encoder, name="gcn_diag"))
    message_cfg = variant_config(ds, "vs_bf16_message", SETTINGS,
                                 [BF16_LINE])
    block = ("block", "step", (cfg, "factored", {}, {}, True))
    extra = [("basis", "step", (basis_cfg, "factored", {}, {}, True)),
             ("diag", "step", (diag_cfg, "factored", {}, {}, True)),
             ("overlap", "step", (cfg, "factored", {"overlap": True}, {},
                                  False)),
             ("all_gather", "step", (cfg, "factored",
                                     {"halo": "all_gather"}, {}, False)),
             ("tiled", "step", (cfg, "tiled", {}, {}, False)),
             ("bf16_message", "step", (message_cfg, "factored", {},
                                       BF16_STEP_TOL, False)),
             ("eval", "eval", (cfg,)),
             ("fit", "fit", (cfg,))]
    paths = {}
    for world, backend in MESH_WORLDS:
        results = distributed.launch(
            vs_rank, world, ([block] + (extra if world == 2 else []),),
            backend=backend, devices=["cuda:0"] * world,
            timeout=VS_TIMEOUT)
        head = results[0]
        for label, row in head.items():
            if label == "eval":
                emit("vs_eval", phase_s=time.perf_counter() - t_phase,
                     card=nvidia_smi_line(), **row)
            elif label == "fit":
                if len({r["fit"]["digest"] for r in results}) != 1:
                    raise AssertionError("the ranks' gathered params "
                                         "differ after the fit")
                emit("vs_fit", part="library",
                     phase_s=time.perf_counter() - t_phase,
                     card=nvidia_smi_line(),
                     one_device_steps_per_s=train_steps_per_s,
                     note="ranks that share one card, not a scale-out "
                          "number", **row)
            else:
                emit("vs_step", cell=label,
                     phase_s=time.perf_counter() - t_phase,
                     card=nvidia_smi_line(), **row)
            paths[f"vs_{label}_{world}"] = row
    return paths


def phase_vs_fit() -> dict:
    """vs_fit's CLI part: train.py --mesh 1 --vertex-sharded (NCCL) at the
    fit phase's cadence for 20 steps (checks and saves at 10 and 20), at
    the same time the same run cut at 10 (two processes on the card),
    then that run's --resume to 20: the checkpoints at 10 and 20 equal bit
    for bit."""
    t_phase = time.perf_counter()
    flags = ("--vertex-sharded",)
    with ThreadPoolExecutor(2) as pool:
        runs = [pool.submit(mesh_cli, name, MESH_CLI_CUTS, *flags,
                            "--max-iterations", steps)
                for name, steps in (("vs_a", "20"), ("vs_b", "10"))]
    (out_a, a, a_s), (_, b, b_s) = (run.result() for run in runs)
    proc = subprocess.run(
        [sys.executable, "-m", "relationprediction_torch.train",
         "--settings", str(Path(b).parent / "gcn_block.exp"), "--dataset",
         "synth:FB15k-237", "--mesh", "1", *flags, "--resume",
         "--max-iterations", "20"], cwd=ROOT, capture_output=True,
        text=True, timeout=MESH_TIMEOUT)
    if proc.returncode != 0:
        raise AssertionError(f"the resumed run failed: {proc.stderr[-4000:]}")
    same_checkpoints(a, b, 10)
    same_checkpoints(a, b, 20)
    state = checkpoint.restore(f"{a}-20.ckpt")
    done = re.search(r"Training done: (\d+) iterations .* last loss (\S+) "
                     r"\((\S+) steps/s", out_a)
    checks = re.findall(r"Tested validation score at iteration (\d+)", out_a)
    if not done or "Mesh: 1 ranks over nccl, vertex-sharded" not in out_a \
            or not np.isfinite(float(done.group(2))) or checks != ["10",
                                                                   "20"]:
        raise AssertionError(f"train.py --vertex-sharded printed "
                             f"{out_a[-2000:]}")
    row = {"part": "cli", "steps": int(done.group(1)),
           "last_loss": float(done.group(2)),
           "steps_per_s_incl_checks_beside_another_run":
               float(done.group(3)),
           "checks": [int(c) for c in checks], "run_s": a_s,
           "short_run_s": b_s,
           "table_rows": int(state["params"]["input_transform"]["W"]
                             .shape[0]),
           "checkpoints_10_and_20_bitwise": True, "backend": "nccl",
           "card": nvidia_smi_line()}
    emit("vs_fit", phase_s=time.perf_counter() - t_phase, **row)
    return row


def build_all() -> None:
    """Build every kernel source at once, one nvcc each."""
    t_phase = time.perf_counter()
    with ThreadPoolExecutor(5) as pool:
        futures = {source: pool.submit(fn) for source, fn in (
            (KERNEL_SOURCE, staircase2.kernel_library),
            (BASIS_SOURCE, staircase2.basis_kernel_library),
            (PROJECT_SOURCE, staircase2.project_kernel_library),
            (STAIRCASE_SOURCE, staircase.kernel_library),
            (ENERGY_SOURCE, neg_energy.kernel_library))}
    for source, future in futures.items():
        _, info = future.result()
        emit("build", source=source, phase_s=time.perf_counter() - t_phase,
             **info.as_dict())


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    t_phase = time.perf_counter()
    exact_float32()
    device = torch.device("cuda:0")
    smi = nvidia_smi_line()
    emit("device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda,
         phase_s=time.perf_counter() - t_phase)
    build_all()

    ds = synthetic.like("FB15k-237", seed=0)
    graph = build_graph_batch(ds.train, ds.n_entities,
                              ds.n_relations).to(device)
    cfg = config.load(str(SETTINGS)).with_counts(
        ds.n_entities, ds.n_relations, len(ds.train))
    # gcn_basis.exp samples its batches as gcn_block.exp does, so the
    # first training batch's graph is the same for both.
    graphs = {"full_train": graph,
              "train_batch": first_batch_graph(cfg, ds, device)}

    # gcn_block.exp: 100 blocks of 5x5
    n_blocks, dr = 100, 5
    rows = phase_kernel(graphs, ds.n_relations, n_blocks, dr, device)
    serve = phase_serve(ds, device, cfg)
    grads = phase_grad(graphs, ds.n_relations, n_blocks, dr, device)
    train = phase_train(cfg, ds, device)

    # gcn_basis.exp: 5 bases of 500 x 500
    basis_cfg = config.load(str(BASIS_SETTINGS)).with_counts(
        ds.n_entities, ds.n_relations, len(ds.train))
    n_bases = basis_cfg.encoder.n_bases
    d = basis_cfg.encoder.internal_dimension
    kb = phase_kernel_basis(graphs, ds.n_relations, n_bases, d, device)
    serve_b = phase_serve(ds, device, basis_cfg,
                          staircase2.basis_direction, "serve_basis")
    phase_grad_basis(graphs, ds.n_relations, n_bases, d, device)
    train_b = phase_train(basis_cfg, ds, device, staircase2.basis_direction,
                          "train_basis")

    # The one-hot-input model and gcn_diag, both from gcn_basis.exp, as
    # tests/test_model_variants.py derives them: every layer sums per-edge
    # messages with staircase_aggregate (TPU kernel 3).
    ks = phase_kernel_staircase(graphs, d, device) + compgcn_sums(ds, device)
    ke = phase_kernel_energies(device)
    runs = {}
    for label, change in (("onehot", dict(use_input_transform=False)),
                          ("diag", dict(name="gcn_diag"))):
        v1_cfg = dataclasses.replace(basis_cfg, encoder=dataclasses.replace(
            basis_cfg.encoder, **change))
        runs[f"serve_{label}"] = phase_serve(
            ds, device, v1_cfg, staircase.staircase_aggregate,
            f"serve_{label}")
        runs[f"train_{label}"] = phase_train(
            v1_cfg, ds, device, staircase.staircase_aggregate,
            f"train_{label}")

    # The rest of TrainLoop on gcn_block: the main path of train.py
    # (validation, early stopping, checkpoints, prefetch), prefetch against
    # serial batches (gcn_block and gcn_basis), and resume.
    fit = phase_fit(cfg, ds, device)
    phase_prefetch(cfg, ds, device)
    phase_prefetch(basis_cfg, ds, device, "prefetch_basis")
    phase_resume(cfg, ds, device)
    phase_graph(cfg, ds, device)
    phase_graph(basis_cfg, ds, device, "graph_basis")
    phase_determinism()
    quality = phase_quality(device)

    # distmult.exp and complex.exp: the embedding table, no graph, all
    # 272,115 positives a step; no aggregation kernel runs.
    for name in ("distmult", "complex"):
        emb_cfg = config.load(str(ROOT / "settings" / f"{name}.exp")) \
            .with_counts(ds.n_entities, ds.n_relations, len(ds.train))
        phase_serve(ds, device, emb_cfg, None, f"serve_{name}")
        phase_train(emb_cfg, ds, device, None, f"train_{name}",
                    steps=EMBEDDING_STEPS,
                    compare_positives=EMBEDDING_COMPARE_POSITIVES)

    # The negative protocols on gcn_block.exp (the tiled loss on device
    # draws, held to the factored loss on the same draws; split; shared,
    # a 512-entity pool; host-tiled batches), then the MLP decoder
    # (gcn_block.exp with [Decoder] Name=nonlinear-transform), served and
    # trained through the tiled loss.
    paths = {
        "train_tiled": phase_train(cfg, ds, device, phase="train_tiled",
                                   tiled=True),
        "train_split": phase_train(cfg, ds, device, phase="train_split",
                                   negative_mode="split"),
        "train_shared": phase_train(cfg, ds, device, phase="train_shared",
                                    negative_mode="shared",
                                    negative_pool_size=POOL_SIZE),
        "train_host_tiled": phase_train(cfg, ds, device,
                                        phase="train_host_tiled",
                                        steps=HOST_TILED_STEPS,
                                        device_negatives=False)}
    paths["quality_gcn_block"] = quality["quality_gcn_block"]
    mlp_cfg = mlp_config(ds)
    paths["serve_mlp"] = phase_serve(ds, device, mlp_cfg, phase="serve_mlp")
    paths["train_mlp"] = phase_train(mlp_cfg, ds, device, phase="train_mlp")

    # The rest of the encoder surface (ENCODER_VARIANTS), each path's
    # launches listed with the kernel it runs (none for vemb).
    basis_paths = {}
    by_op = {staircase2.block_direction: paths,
             staircase2.basis_direction: basis_paths,
             staircase.staircase_aggregate: runs, None: {}}
    for label, settings, lines, op in ENCODER_VARIANTS:
        v_cfg = variant_config(ds, label, settings, lines)
        steps_kw = {"compare_positives": EMBEDDING_COMPARE_POSITIVES} \
            if op is None else {}
        by_op[op][f"serve_{label}"] = phase_serve(ds, device, v_cfg, op,
                                                  f"serve_{label}")
        by_op[op][f"train_{label}"] = phase_train(
            v_cfg, ds, device, op, f"train_{label}", steps=VARIANT_STEPS,
            falling=False, nonfinite_ok=label in NONFINITE_OK, **steps_kw)

    # bf16 message and stream precision: the bf16 entry points of the four
    # kernels, a serve and a train phase for each kernel family, DistMult's
    # streams (the fused energies' backward at 272,115 x 10) and the split
    # loss on gcn_block (the single-factor fused backward).
    kb16 = phase_kernel_bf16(graphs, ds.n_relations, n_blocks, dr, n_bases,
                             d, device)
    bf16_runs = {}
    for label, settings, lines, op in BF16_VARIANTS:
        b_cfg = bf16_config(ds, label, settings, lines)
        routes = op.__name__ in OP_ROUTES
        bf16_runs[f"serve_{label}"] = {**phase_serve(
            ds, device, b_cfg, op, f"serve_{label}", compare_routes=routes),
            "op": op.__name__}
        bf16_runs[f"train_{label}"] = {**phase_train(
            b_cfg, ds, device, op, f"train_{label}", steps=BF16_STEPS,
            compare_routes=routes), "op": op.__name__}
    dm_cfg = bf16_config(ds, "distmult_bf16",
                         ROOT / "settings" / "distmult.exp", [])
    bf16_runs["train_distmult_bf16"] = {**phase_train(
        dm_cfg, ds, device, None, "train_distmult_bf16",
        steps=EMBEDDING_STEPS,
        compare_positives=EMBEDDING_COMPARE_POSITIVES), "op": None}
    bf16_runs["train_split_bf16"] = {**phase_train(
        bf16_config(ds, "split_bf16", SETTINGS, [BF16_LINE]), ds, device,
        phase="train_split_bf16", steps=BF16_STEPS, negative_mode="split"),
        "op": "block_direction"}

    bf16_runs["quality_gcn_block_bf16"] = quality["quality_gcn_block_bf16"]

    # The edge-partitioned mesh: the gcn_block step on 1 (NCCL), 2 and 4
    # (gloo) ranks on cuda:0, and at 2 ranks gcn_basis, gcn_diag, bf16, the
    # split protocol, the sharded ModelView and a 20-step fit; then
    # train.py --mesh 1. Each path's launches join its kernels' rows.
    by_op = {"block_direction": paths, "basis_direction": basis_paths,
             "staircase_aggregate": runs}
    for name, row in phase_mesh_step(ds, cfg, basis_cfg,
                                     train["steps_per_s"]).items():
        (bf16_runs if row["bf16"] else by_op[row["op"]])[name] = row
    phase_mesh_fit()

    # The vertex-sharded path: the gcn_block step on 1 (NCCL), 2 and 4
    # (gloo) ranks on cuda:0, at 2 ranks every route (gcn_basis, gcn_diag,
    # overlapped, all-gather, tiled, bf16), the view and a 20-step fit;
    # then train.py --mesh 1 --vertex-sharded and its resume.
    for name, row in phase_vs(ds, cfg, basis_cfg,
                              train["steps_per_s"]).items():
        (bf16_runs if row["bf16"] else by_op[row["op"]])[name] = row
    phase_vs_fit()

    train_runs = {"train": train, "train_basis": train_b, "fit": fit,
                  **{k: r for k, r in {**paths, **basis_paths, **runs,
                                       **bf16_runs}.items()
                     if k.startswith(("train", "quality", "mesh", "vs"))}}
    print(json.dumps({"kernels": kernels_line(rows, serve, grads, train, fit,
                                              paths)
                      + basis_kernels_line(kb, serve_b, train_b,
                                           basis_paths)
                      + staircase_kernels_line(ks, runs)
                      + sum_by_csr_line(grads, train_runs)
                      + energies_kernels_line(ke, train_runs)
                      + bf16_kernels_line(kb16, bf16_runs),
                      # The hand kernels a replayed step launched, counted
                      # by name in a profile (replayed_launches): the
                      # runs' launch counts above re-add a capture's
                      # counts on a replayed step.
                      "replayed_step_launches": {
                          k: r["replayed_kernels"]["per_replayed_step"]
                          for k, r in train_runs.items()
                          if r.get("replayed_kernels")}}),
          flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(determinism_child() if sys.argv[1:] == ["--determinism-child"]
             else main())
