#!/usr/bin/env python3
"""Where block_direction_bf16's slice kernel spends its time, on one CUDA
card.

    python3 -m tools.block_slice_variants

Builds copies of ``relationprediction_torch/ops/csrc/block_direction.cu``
with one part of the slice kernel changed (``tools/variants.py``) and
times each on gcn_block.exp's forward pass (B = 100 blocks of 5x5 in
bf16) over the seeded synth:FB15k-237 train graph and the first training
batch's graph, in two rounds, beside the walk (``route="walk"``) on the
same inputs:

  base          the kernel as it ships;
  threads512    512 threads a thread block (32 walkers an SM, not 64);
  threads256    256 threads a thread block;
  batch4        4 entries' x loads in flight at dr = 5, not 2;
  x_2byte       x read with 2-byte loads where d is even;
  apply_words   W read from shared memory as 4-byte words, shifted into
                place, not as 2-byte values;
  no_apply      no block product: a relation run adds z to y's diagonal
                (the W reads and dr * dr FMAs a run gone);
  fixed_cost    each walker writes its carry rows as none and stops after
                the copy of W and its search: the launch, the copy, the
                search and the fix-up alone.

Prints one JSON line a variant, graph and round: its CUDA-event time of a
launch and its fix-up, the slice kernel's device time (torch.profiler),
whether it equals the shipped kernel's output bit for bit (no_apply and
fixed_cost compute wrong sums by design), ptxas' registers and spills at
dr = 5, and nvidia-smi's name and power limit. Needs nvcc and a card;
exits non-zero without them.
"""
from __future__ import annotations

import ctypes
import json
import sys

import torch

import chip_smoke
from relationprediction_torch import config
from relationprediction_torch.data import synthetic
from relationprediction_torch.device import exact_float32
from relationprediction_torch.graph import build_graph_batch
from relationprediction_torch.ops import staircase2
from tools import variants

APPLY = """        y[i] = fmaf(__uint_as_float(static_cast<uint32_t>(wb[at]) << 16),
                    z[j], y[i]);"""
APPLY_WORDS = (
    """    const uint16_t* wb = s_w + rel * region_u16 + phase + l * (DR * DR);
#pragma unroll
    for (int i = 0; i < DR; ++i) {
#pragma unroll
      for (int j = 0; j < DR; ++j) {
        const int at = kTransposeW ? j * DR + i : i * DR + j;
""" + APPLY,
    """    const int first = rel * region_u16 + phase + l * (DR * DR);
    const uint32_t* ww =
        reinterpret_cast<const uint32_t*>(s_w) + (first >> 1);
    const unsigned sh = (first & 1) * 16;
    constexpr int kW = (DR * DR + 1) / 2 + 1;
    uint32_t u[kW], a[kW - 1];
#pragma unroll
    for (int k = 0; k < kW; ++k) u[k] = ww[k];
#pragma unroll
    for (int k = 0; k < kW - 1; ++k) a[k] = __funnelshift_r(u[k], u[k + 1], sh);
#pragma unroll
    for (int i = 0; i < DR; ++i) {
#pragma unroll
      for (int j = 0; j < DR; ++j) {
        const int at = kTransposeW ? j * DR + i : i * DR + j;
        const uint32_t h = a[at >> 1];
        y[i] = fmaf(__uint_as_float((at & 1) ? h & 0xFFFF0000u : h << 16),
                    z[j], y[i]);""")
VARIANTS = {
    "base": [],
    "threads512": [("  return DR <= 6 ? 1024 : 512;", "  return 512;")],
    "threads256": [("  return DR <= 6 ? 1024 : 512;", "  return 256;")],
    "batch4": [("  return DR <= 3 ? 4 : 2;", "  return 4;")],
    "x_2byte": [("const bool x_words = d % 2 == 0 && aligned4(x);",
                 "const bool x_words = false;")],
    "apply_words": [APPLY_WORDS],
    "no_apply": [(APPLY, "        y[i] += i == j ? z[j] : 0.f;")],
    "fixed_cost": [("  if (k0 >= k1) return;\n",
                    "  if (k0 < k1 && w.l == 0 && blockIdx.y == 0) {\n"
                    "    for (int b = k0; b < k1; ++b) carry_row[b] = -1;\n"
                    "  }\n  return;\n")],
}


def main() -> int:
    if not torch.cuda.is_available():
        print("block_slice_variants: no CUDA card", file=sys.stderr)
        return 2
    exact_float32()
    card = chip_smoke.nvidia_smi_line()
    built = variants.build_all("block_direction.cu", VARIANTS,
                               "block_slice_kernelILi5ELb0")
    libs = {name: staircase2.bind_library(ctypes.CDLL(str(path)))
            for name, (path, _) in built.items()}
    shipped = staircase2.kernel_library()[0]
    device = torch.device("cuda:0")
    ds = synthetic.like("FB15k-237", seed=0)
    cfg = config.load(str(chip_smoke.SETTINGS)).with_counts(
        ds.n_entities, ds.n_relations, len(ds.train))
    graphs = {"full_train": build_graph_batch(ds.train, ds.n_entities,
                                              ds.n_relations).to(device),
              "train_batch": chip_smoke.first_batch_graph(cfg, ds, device)}
    gen = torch.Generator().manual_seed(12)
    for graph_name, graph in graphs.items():
        v = graph.n_vertices
        x = torch.randn(v, 500, generator=gen).to(device).to(torch.bfloat16)
        w = torch.randn(ds.n_relations, 100, 5, 5, generator=gen).to(
            device).to(torch.bfloat16)
        want = staircase2.launch(shipped, x, w, graph.fwd, v)
        for rnd in range(2):
            runs = {name: (lib, "slice") for name, lib in libs.items()}
            runs["walk"] = (shipped, "walk")
            for name, (lib, route) in runs.items():
                def run(lib=lib, route=route):
                    return staircase2.launch(lib, x, w, graph.fwd, v,
                                             route=route)
                kernel = "block_slice_kernel" if route == "slice" \
                    else "block_direction_kernel"
                device_ms = chip_smoke.device_ms(run, (kernel,
                                                       "carry_fixup"))
                print(json.dumps({
                    "variant": name, "graph": graph_name, "round": rnd,
                    "ms": chip_smoke.cuda_ms(run, 20),
                    "device_ms": device_ms.get(kernel),
                    "fixup_device_ms": device_ms.get("carry_fixup"),
                    "equals_shipped": chip_smoke.same_bits(run(), want),
                    "ptxas_dr5": built[name][1] if name in built else None,
                    "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
