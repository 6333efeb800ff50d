#!/usr/bin/env python3
"""Where basis_project_bf16's time goes, on one CUDA card.

    python3 bf16_product_variants.py

Builds copies of ``relationprediction_torch/ops/csrc/basis_project.cu``
with one part of the bf16 product taken out (text edits, under
build/variants, one nvcc each, all started together) and times each
product at the main path's shape (14,541 x 500 by 500 x 2,500, after one
pad pass), in two rounds, torch.matmul in bf16 beside them:

  base             the kernel as it ships;
  no_store         the storer warps write nothing to P;
  no_mma           no wgmma is issued (loads, waits and stores stay);
  no_tma           no TMA load is issued (the full barriers are arrived
                   on instead): the tensor cores and the stores alone;
  loads_only       neither wgmma nor stores: the TMA loads alone;
  wait_all         each k-tile waits for its own wgmma group (no group
                   in flight across k-tiles);
  stages2          a ring of 2 stages in place of 3.

The variants compute wrong products by design; only their times mean
anything. Prints one JSON line each, with nvidia-smi's name and power
limit. Needs nvcc and a card; exits non-zero without them.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from relationprediction_torch.device import exact_float32
from relationprediction_torch.ops import nvcc, staircase2

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "variants"
NO_MMA = ("for (int kk = 0; kk < kBfBK / 16; ++kk) {",
          "for (int kk = 0; kk < 0; ++kk) {")
NO_STORE = ("if (row >= m || gc >= n) continue;", "if (row >= 0) continue;")
NO_TMA = ("""          mbar_expect_tx(&full[s], kBfStageBytes);
          unsigned char* st = smem + s * kBfStageBytes;
          tma_load_2d(st, &map_x, &full[s], kt * kBfBK, m0);
          tma_load_2d(st + kBfTileA, &map_w, &full[s], kt * kBfBK, n0);""",
          "          mbar_arrive(&full[s]);")
VARIANTS = {
    "base": [],
    "no_store": [NO_STORE],
    "no_mma": [NO_MMA],
    "no_tma": [NO_TMA],
    "loads_only": [NO_MMA, NO_STORE],
    "wait_all": [("      wgmma_wait_one();\n", "      wgmma_wait_all();\n")],
    "stages2": [("constexpr int kBfStages = 3;",
                 "constexpr int kBfStages = 2;")],
}


def build(name: str) -> Path:
    """Compile the variant ``name``; raises where an edit no longer
    matches the source or nvcc fails."""
    src = (nvcc.CSRC / "basis_project.cu").read_text()
    for old, new in VARIANTS[name]:
        if old not in src:
            raise AssertionError(f"{name}: the source has no {old!r}")
        src = src.replace(old, new)
    cu = OUT / f"{name}.cu"
    cu.write_text(src)
    lib = OUT / f"{name}.so"
    proc = subprocess.run([nvcc.nvcc_path(), *nvcc.NVCC_FLAGS, "-I",
                           str(nvcc.CSRC), "-o", str(lib), str(cu)],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr}")
    return lib


def cuda_ms(fn, iters: int = 30, warmup: int = 3) -> float:
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


def main() -> int:
    if not torch.cuda.is_available():
        print("bf16_product_variants: no CUDA card", file=sys.stderr)
        return 2
    exact_float32()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    OUT.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        paths = dict(zip(VARIANTS, pool.map(build, VARIANTS)))
    libs = {name: staircase2.bind_project_library(ctypes.CDLL(str(path)))
            for name, path in paths.items()}
    device = torch.device("cuda:0")
    gen = torch.Generator().manual_seed(12)
    x = torch.randn(14541, 500, generator=gen).to(device).to(torch.bfloat16)
    w = (torch.randn(500, 2500, generator=gen) * 0.05).to(device) \
        .to(torch.bfloat16)
    xp, wt = staircase2.launch_pad_bf16(libs["base"], x, w)
    for rnd in range(2):
        for name, lib in libs.items():
            ms = cuda_ms(lambda: staircase2.launch_product_bf16(lib, xp, wt))
            print(json.dumps({"variant": name, "round": rnd,
                              "product_ms": ms, "card": card}), flush=True)
    print(json.dumps({"variant": "torch.matmul bf16",
                      "ms": cuda_ms(lambda: torch.matmul(x, w)),
                      "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
