#!/usr/bin/env python3
"""Where basis_combine_bf16's chunk kernel spends its time, on one CUDA
card.

    python3 -m tools.basis_combine_variants

Builds copies of ``relationprediction_torch/ops/csrc/basis_direction.cu``
with one part of the chunk kernel changed (``tools/variants.py``) and
times each on gcn_basis.exp's bf16 P (B = 5 bases of d_out = 500) over the
seeded synth:FB15k-237 train graph and the first training batch's graph
(forward CSR), in two rounds, beside PR 6's kernel (``route="row"``) and
the f32 entry point on the widened P, all on the same inputs:

  base           the kernel as it ships (one group of 128 threads a
                 block, 4 entries in flight, one chunk of 500 columns);
  l2_chunks      4 groups of 32 threads a block: 4 chunks of 128 columns,
                 each chunk's slice of P (18.6 MB) small enough for L2;
  group64        2 groups of 64 threads: 2 chunks of 256 columns;
  threads256     2 groups of 128 threads a block (two parts);
  batch6         6 entries in flight, not 4 (8, 12 likewise);
  widen_at_load  each word widened to f32 as it is loaded (PR 6's way);
  wide16         16-byte loads of 8 columns (a group of 64 threads), on a
                 copy of P padded to 504 columns a basis;
  no_fma         the gathers alone: each word XORed into the sum, no
                 coefficient and no FMA;
  fixed_cost     each group stops after its search and staging: the
                 launch, the search, the staging and the fix-up alone.

and the shipped kernel at items 64, 256 and 512 a part (the rule gives
128 on the full graph, 32 on the training batch's).

Prints one JSON line a variant, graph and round: its CUDA-event time of a
launch and its fix-up, the kernel's device time (torch.profiler), whether
its output equals the shipped kernel's bit for bit (and so
basis_combine_f32's on the widened P; no_fma and fixed_cost compute wrong
sums by design; wide16's first 500 columns of each basis), ptxas'
registers and spills at B = 5, and nvidia-smi's name and power limit. Needs
nvcc and a card; exits non-zero without them.
"""
from __future__ import annotations

import ctypes
import json
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

import chip_smoke
from relationprediction_torch import config
from relationprediction_torch.data import synthetic
from relationprediction_torch.device import exact_float32
from relationprediction_torch.graph import build_graph_batch
from relationprediction_torch.ops import staircase, staircase2
from tools import variants

GROUP = ("constexpr int kGroupThreads = 128;",
         "constexpr int kGroups = 1;")
BATCH = "constexpr int kChunkBatch = 4;"
HELD = """  typename Bf16Word<kCols>::type w;
  __device__ __forceinline__ void hold(typename Bf16Word<kCols>::type x) {
    w = x;
  }
  __device__ __forceinline__ float at(int c) const { return column(w, c); }"""
FMA = "          acc[c] = fmaf(cb, v[e][b].at(c), acc[c]);"
STAGED = "  __syncthreads();\n\n  const int words = d_out / kCols;"


def group(threads: int, groups: int) -> list:
    return [(GROUP[0], f"constexpr int kGroupThreads = {threads};"),
            (GROUP[1], f"constexpr int kGroups = {groups};")]


# name -> (edits, columns a thread, columns a chunk at d_out = 500)
VARIANTS = {
    "base": ([], 4, 500),
    "l2_chunks": (group(32, 4), 4, 128),
    "group64": (group(64, 2), 4, 256),
    "threads256": ([(GROUP[1], "constexpr int kGroups = 2;")], 4, 500),
    **{f"batch{n}": ([(BATCH, f"constexpr int kChunkBatch = {n};")], 4, 500)
       for n in (6, 8, 12)},
    "widen_at_load": ([(HELD, """  float f[kCols];
  __device__ __forceinline__ void hold(typename Bf16Word<kCols>::type x) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) f[c] = column(x, c);
  }
  __device__ __forceinline__ float at(int c) const { return f[c]; }""")],
                      4, 500),
    "wide16": (group(64, 1) + [
        ("constexpr int kWordCols = 4;", "constexpr int kWordCols = 8;"),
        ("// What a thread keeps of a loaded word until its FMAs",
         "template <>\nstruct Bf16Word<8> {\n  using type = uint4;\n};\n"
         "__device__ __forceinline__ float column(uint4 w, int c) {\n"
         "  const uint32_t h = c < 2 ? w.x : c < 4 ? w.y : c < 6 ? w.z : "
         "w.w;\n"
         "  return __uint_as_float((c & 1) ? h & 0xFFFF0000u : h << 16);\n"
         "}\n\n// What a thread keeps of a loaded word until its FMAs")],
               8, 504),
    "no_fma": ([(HELD, HELD + """
  __device__ __forceinline__ uint32_t bits() const { return fold(w); }"""),
                ("// What a thread keeps of a loaded word until its FMAs",
                 "__device__ __forceinline__ uint32_t fold(uint16_t w) {"
                 " return w; }\n"
                 "__device__ __forceinline__ uint32_t fold(uint2 w) {"
                 " return w.x ^ w.y; }\n"
                 "__device__ __forceinline__ uint32_t fold(uint4 w) {"
                 " return w.x ^ w.y ^ w.z ^ w.w; }\n\n"
                 "// What a thread keeps of a loaded word until its FMAs"),
                (FMA, "          acc[c] = __uint_as_float("
                      "__float_as_uint(acc[c]) ^ v[e][b].bits());")],
               4, 500),
    "fixed_cost": ([(STAGED, "  __syncthreads();\n"
                     "  if (l == 0 && chunk == 0 && part0 + g < n_parts) {\n"
                     "    carry_row[part0 + g] = -1;\n  }\n  return;\n"
                     "  const int words = d_out / kCols;")], 4, 500),
}
ITEMS = (64, 256, 512)
PAD = 504  # columns a basis of the padded P: a multiple of 8


def build_variants() -> dict:
    """``variants.build`` of every variant at once: name -> (library path,
    ptxas' line of its B = 5 chunk kernel), or (None, nvcc's error) for
    a variant that does not build, so the others are still timed."""
    def one(name):
        try:
            return variants.build("basis_direction.cu", name,
                                  VARIANTS[name][0],
                                  f"combine_chunk_kernelILi5ELi"
                                  f"{VARIANTS[name][1]}E")
        except RuntimeError as err:
            return None, str(err)[-2000:]
    variants.OUT.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        return dict(zip(VARIANTS, pool.map(one, VARIANTS)))


def launch(lib, proj, coef, layout, v, cols, chunk_cols, items):
    """One basis_combine_bf16 call of ``lib`` (the kernel, then its
    fix-up) with the given plan; raises if it is refused."""
    n_bases = coef.shape[1]
    d_out = proj.shape[1] // n_bases
    carry_rows, carry = staircase2._carry_buffers(
        v, layout.n_edges, items, d_out, lib.basis_combine_max_items(),
        proj.device)
    out = torch.empty(v, d_out, dtype=torch.float32, device=proj.device)
    rc = lib.basis_combine_bf16(
        proj.data_ptr(), coef.data_ptr(), layout.row_ptr.data_ptr(),
        layout.src.data_ptr(), layout.rel.data_ptr(), layout.w.data_ptr(),
        out.data_ptr(), carry_rows.data_ptr(), carry.data_ptr(), v,
        layout.n_edges, n_bases, d_out, items, cols, chunk_cols,
        proj.device.index, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"basis_combine_bf16 refused: "
                           f"{lib.basis_direction_error_string(rc).decode()}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("basis_combine_variants: no CUDA card", file=sys.stderr)
        return 2
    exact_float32()
    card = chip_smoke.nvidia_smi_line()
    built = build_variants()
    libs = {name: staircase2.bind_basis_library(ctypes.CDLL(str(path)))
            for name, (path, _) in built.items() if path is not None}
    shipped, info = staircase2.basis_kernel_library()
    print(json.dumps({"build": info.as_dict(), "card": card}), flush=True)
    device = torch.device("cuda:0")
    ds = synthetic.like("FB15k-237", seed=0)
    cfg = config.load(str(chip_smoke.BASIS_SETTINGS)).with_counts(
        ds.n_entities, ds.n_relations, len(ds.train))
    n_bases, d = cfg.encoder.n_bases, cfg.encoder.internal_dimension
    graphs = {"full_train": build_graph_batch(ds.train, ds.n_entities,
                                              ds.n_relations).to(device),
              "train_batch": chip_smoke.first_batch_graph(cfg, ds, device)}
    gen = torch.Generator().manual_seed(12)
    kernels = ("combine_chunk_kernel", "basis_combine_kernel",
               "carry_fixup")
    for graph_name, graph in graphs.items():
        v, layout = graph.n_vertices, graph.fwd
        p16 = torch.randn(v, n_bases * d, generator=gen).to(device) \
            .to(torch.bfloat16)
        padded = torch.zeros(v, n_bases, PAD, dtype=torch.bfloat16,
                             device=device)
        padded[:, :, :d] = p16.view(v, n_bases, d)
        padded = padded.view(v, n_bases * PAD)
        coef = torch.randn(ds.n_relations, n_bases, generator=gen).to(device)
        rule = staircase.basis_combine_items(v, layout.n_edges)
        want = staircase2.launch_combine(shipped, p16, coef, layout, v)
        f32 = staircase2.launch_combine(shipped, p16.float(), coef, layout,
                                        v)
        for name, (path, error) in built.items():
            if path is None:
                print(json.dumps({"variant": name, "graph": graph_name,
                                  "build_error": error, "card": card}),
                      flush=True)
        if not chip_smoke.same_bits(want, f32):
            raise AssertionError(f"{graph_name}: the shipped kernel's bits "
                                 f"differ from basis_combine_f32's")
        pf = p16.float()
        runs = {name: (lambda lib=libs[name], c=cols, cc=chunk, p=(
                    padded if name == "wide16" else p16), items=rule:
                    launch(lib, p, coef, layout, v, c, cc, items))
                for name, (_, cols, chunk) in VARIANTS.items()
                if name in libs}
        for items in ITEMS:
            runs[f"items{items}"] = (
                lambda items=items: staircase2.launch_combine(
                    shipped, p16, coef, layout, v, items=items))
        runs["row"] = lambda: staircase2.launch_combine(
            shipped, p16, coef, layout, v, route="row")
        runs["f32"] = lambda: staircase2.launch_combine(
            shipped, pf, coef, layout, v)
        for rnd in range(2):
            for name, run in runs.items():
                got = run()
                if name == "wide16":
                    got = got.view(v, -1)[:, :d].contiguous()
                dev = chip_smoke.device_ms(run, kernels)
                print(json.dumps({
                    "variant": name, "graph": graph_name, "round": rnd,
                    "items": rule, "ms": chip_smoke.cuda_ms(run, 20),
                    "device_ms": dev.get("combine_chunk_kernel",
                                         dev.get("basis_combine_kernel")),
                    "fixup_device_ms": dev.get("carry_fixup"),
                    "equals_shipped": chip_smoke.same_bits(got, want),
                    "ptxas_B5": built[name][1] if name in built else None,
                    "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
