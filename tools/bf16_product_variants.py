#!/usr/bin/env python3
"""Where basis_project_bf16's time goes, on one CUDA card.

    python3 -m tools.bf16_product_variants

Builds copies of ``relationprediction_torch/ops/csrc/basis_project.cu``
with one part of the bf16 product taken out (``tools/variants.py``) and
times each product at the main path's shape (14,541 x 500 by 500 x
2,500, after one pad pass), in two rounds, torch.matmul in bf16 beside
them:

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
import sys

import torch

import chip_smoke
from relationprediction_torch.device import exact_float32
from relationprediction_torch.ops import staircase2
from tools import variants

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


def main() -> int:
    if not torch.cuda.is_available():
        print("bf16_product_variants: no CUDA card", file=sys.stderr)
        return 2
    exact_float32()
    card = chip_smoke.nvidia_smi_line()
    built = variants.build_all("basis_project.cu", VARIANTS)
    libs = {name: staircase2.bind_project_library(ctypes.CDLL(str(path)))
            for name, (path, _) in built.items()}
    device = torch.device("cuda:0")
    gen = torch.Generator().manual_seed(12)
    x = torch.randn(14541, 500, generator=gen).to(device).to(torch.bfloat16)
    w = (torch.randn(500, 2500, generator=gen) * 0.05).to(device) \
        .to(torch.bfloat16)
    xp, wt = staircase2.launch_pad_bf16(libs["base"], x, w)
    for rnd in range(2):
        for name, lib in libs.items():
            ms = chip_smoke.cuda_ms(
                lambda: staircase2.launch_product_bf16(lib, xp, wt), 30, 3)
            print(json.dumps({"variant": name, "round": rnd,
                              "product_ms": ms, "card": card}), flush=True)
    print(json.dumps({"variant": "torch.matmul bf16",
                      "ms": chip_smoke.cuda_ms(lambda: torch.matmul(x, w),
                                                 30, 3),
                      "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
