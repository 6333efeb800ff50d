#!/usr/bin/env python3
"""Sweep the block_direction kernel's edge lanes per row and batch depth.

    python3 block_direction_sweep.py

Needs one CUDA card. Compiles variants of
relationprediction_torch/ops/csrc/block_direction.cu with ``kLanes`` and
``kBatch`` replaced (one nvcc per variant, all started together, into
build/torch_kernels/sweep/), checks each against block_direction_reference
on the full-width synth:FB15k-237 forward layout (seed 0, d=500, B=100,
dr=5), and prints one JSON line per variant: the time of the whole launch,
of only the rows longer than chip_smoke.HUB_ROW edges and of only the others
(CUDA events), with the registers ptxas gave the dr=5 instantiation. The
committed kernel is the (kLanes=4, kBatch=4) variant.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import torch

from chip_smoke import HUB_ROW, cuda_ms, nvidia_smi_line, split_rows
from relationprediction_torch.data import synthetic
from relationprediction_torch.device import exact_float32
from relationprediction_torch.graph import build_graph_batch
from relationprediction_torch.ops import nvcc, staircase2

VARIANTS = [(lanes, batch) for lanes in (1, 2, 4, 8) for batch in (2, 4, 8)]
SWEEP_DIR = nvcc.BUILD_DIR / "sweep"


def variant_source(text: str, lanes: int, batch: int) -> str:
    """The kernel source with kLanes/kBatch set; 8 lanes of 128 threads
    ask for one resident block per SM instead of two."""
    edits = [("constexpr int kLanes = 4;", f"constexpr int kLanes = {lanes};"),
             ("constexpr int kBatch = 4;", f"constexpr int kBatch = {batch};"),
             ("__launch_bounds__(kMaxThreads, 2)",
              f"__launch_bounds__(kMaxThreads, {2 if lanes <= 4 else 1})")]
    for old, new in edits:
        if old not in text:
            raise ValueError(f"kernel source no longer contains {old!r}")
        text = text.replace(old, new)
    return text


def build_variants() -> dict:
    SWEEP_DIR.mkdir(parents=True, exist_ok=True)
    text = (nvcc.CSRC / "block_direction.cu").read_text()
    jobs = {}
    for lanes, batch in VARIANTS:
        src = SWEEP_DIR / f"block_direction_l{lanes}_b{batch}.cu"
        src.write_text(variant_source(text, lanes, batch))
        lib = src.with_suffix(".so")
        jobs[(lanes, batch)] = (lib, subprocess.Popen(
            [nvcc.nvcc_path(), *nvcc.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for key, (lib, proc) in jobs.items():
        log, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        regs = [line for line in nvcc.ptxas_summary(log)
                if "kernelILi5E" in line]
        built[key] = (staircase2.bind_library(ctypes.CDLL(str(lib))), regs)
    return built


def main() -> int:
    if not torch.cuda.is_available():
        print("block_direction_sweep: no CUDA device", file=sys.stderr)
        return 2
    exact_float32()
    device = torch.device("cuda:0")
    ds = synthetic.like("FB15k-237", seed=0)
    v, r = ds.n_entities, ds.n_relations
    layout = build_graph_batch(ds.train, v, r).fwd.to(device)
    hubs, rest = split_rows(layout, HUB_ROW)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(v, 500, generator=gen).to(device)
    w = torch.randn(r, 100, 5, 5, generator=gen).to(device)
    want = staircase2.block_direction_reference(x, w, layout, v)
    print(json.dumps({"card": nvidia_smi_line()}), flush=True)

    for (lanes, batch), (lib, regs) in build_variants().items():
        got = staircase2.launch(lib, x, w, layout, v)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
        row = {"lanes": lanes, "batch": batch, "ptxas_dr5": regs,
               "max_abs_err": (got - want).abs().max().item()}
        for name, lay in (("all_rows_ms", layout), ("hub_rows_only_ms", hubs),
                          ("other_rows_only_ms", rest)):
            row[name] = cuda_ms(
                lambda: staircase2.launch(lib, x, w, lay, v), 30)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
