// Basis-decomposition relational aggregation, one direction, for sm_90a.
//
//   out[v] = sum over edges e with target v of
//            w_e * sum_b C[r_e, b] * (x[src_e] @ W_b)
//
// x [V, d_in] f32, W_flat [d_in, B * d_out] f32 (W_b is columns
// b*d_out .. (b+1)*d_out), C [R, B] f32, out [V, d_out] f32. Two steps:
//
// * the projection P = x @ W_flat [V, B * d_out] once per vertex (and, in
//   the twin pass, Q = g @ w_t [V, B * d_in], with w_t[o, b, i] =
//   W_flat[i, b * d_out + o]): basis_project_f32 of basis_project.cu;
// * basis_combine_f32 (this file):  out[v] = sum_{e in row v} w_e sum_b
//   C[rel_e, b] * P[src_e, b, :] on a CSR (graph.py: row_ptr, src, rel, w).
//   On the direction's twin CSR (rows are the edges' sources) with Q it
//   gives d features[u] = sum_{e: src_e = u} w_e sum_b C[r_e, b]
//   (g[tgt_e] @ W_b^T).
//
// Replaces relationprediction_tpu/ops/staircase2.py:505-518
// (_make_basis_kernel, launched by _call_basis at :601-632, and again on
// the twin layout by the VJP at :853-875). That kernel gathers weighted
// source rows into TPU slots, multiplies each slot by W_flat on the MXU
// (2 * E * d_in * B * d_out operations: 680 GFLOP a direction on the full
// FB15k-237 graph), combines the B parts with the slot's coefficients and
// adds into 256-row output blocks with a one-hot matmul. Here the product
// is taken once per vertex (2 * V * d_in * B * d_out: 36.4 GFLOP at
// V=14,541, d=500, B=5), the same function with the edge weight applied
// after the product instead of before it (other rounding, same sum).
//
// What bounds basis_combine_f32 on an H100: bytes, each gathered P row
// (B * d_out floats, 10 KB at d=500, B=5) once, plus out, C and the CSR
// (0.053 ms on the full graph). A per-edge gather reads a P row once per
// edge, not once per vertex: 2.72 GB a launch on the full graph from a P
// of 145 MB that does not fit the 50 MB L2, so the gathers set the time of
// any design of this shape. Summing the weighted x rows per basis first and
// projecting after would cut those bytes; that reorders basis_project's
// work and is not done here.
//
// basis_combine_bf16 takes P in bf16 (basis_project_bf16's output, the
// TPU kernel's bf16 t_ref, relationprediction_tpu/ops/staircase2.py:
// 508-515): each element is widened to f32 as it is loaded, C and the edge
// weights stay f32, the sums are f32 and out is f32, and the gathers move
// half the bytes (1.36 GB a launch on the full graph).
//
// Design: the merge-path partition of merge_path.cuh. Each thread block
// takes `items` row ends + entries, so a hub row (about 9k edges at
// FB15k-237 scale, 90 MB of gathers) is cut across many blocks and a run
// of empty rows costs a block one item a row; rows cut by a block boundary
// are finished by the carry fix-up in block order (no atomics, the same
// bits on every launch). The block stages its row ends, sources and the
// B values w_e * C[r_e, b] of its entries in shared memory. 128 threads lie
// across the d_out columns, each owning one float4 (d_out % 4 == 0 and
// 16-byte aligned pointers; d_out = 500 gives 125 threads) or one float
// otherwise, with gridDim.y covering wider rows. An entry adds its B
// coefficient-scaled P values to the thread's columns, the loads of kBatch
// entries in flight together; the B parts are combined before any carry is
// written, so a carry is [d_out]. Sums are f32, in CSR order.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "merge_path.cuh"

namespace {

using merge_path::axpy;
using merge_path::zero_of;

constexpr int kThreads = 128;    // threads of a block, across the columns
constexpr int kBatch = 4;        // entries whose loads are in flight together
constexpr int kMaxBases = 8;
constexpr int kMaxItems = 1024;  // staging: 2 + B words an item, 40 KB at most

// T is float4 (units = d_out / 4) or float (units = d_out); P rows are
// NB * units T wide. In is P's element as stored: T for f32, uint2 (four
// bf16) or uint16_t (one bf16) for bf16.
template <int NB, typename In, typename T>
__global__ void __launch_bounds__(kThreads)
basis_combine_kernel(const In* __restrict__ proj,
                     const float* __restrict__ coef,
                     const int* __restrict__ row_ptr,
                     const int* __restrict__ src,
                     const int* __restrict__ rel,
                     const float* __restrict__ wt, T* __restrict__ out,
                     int* __restrict__ carry_row, T* __restrict__ carry,
                     int n_rows, int n_edges, int units, int items) {
  extern __shared__ int staged[];  // row ends, sources, B coefficients
  const int t = threadIdx.x;
  const int u = blockIdx.y * kThreads + t;
  const merge_path::Range g =
      merge_path::find_range(row_ptr, n_rows, n_edges, items);
  const int n_ends = g.i1 - g.i0;  // rows i0 .. i1 - 1 end in this block
  const int n_ent = g.j1 - g.j0;   // entries j0 .. j1 - 1 are taken here
  int* s_end = staged;
  int* s_src = staged + items;
  float* s_c = reinterpret_cast<float*>(staged + 2 * items);  // [NB][items]
  for (int r = t; r < n_ends; r += kThreads) {
    s_end[r] = __ldg(row_ptr + g.i0 + r + 1);
  }
  for (int q = t; q < n_ent; q += kThreads) {
    const int k = g.j0 + q;
    s_src[q] = __ldg(src + k);
    const float we = __ldg(wt + k);
    const float* c = coef + static_cast<int64_t>(__ldg(rel + k)) * NB;
#pragma unroll
    for (int b = 0; b < NB; ++b) s_c[b * items + q] = we * __ldg(c + b);
  }
  __syncthreads();

  const bool col = u < units;
  const int64_t pitch = static_cast<int64_t>(NB) * units;
  T acc = zero_of(T());
  int r = 0;  // row i0 + r takes the next entry
  int row_end = n_ends > 0 ? s_end[0] : INT_MAX;
  for (int q0 = 0; q0 < n_ent; q0 += kBatch) {
    T v[kBatch][NB];
#pragma unroll
    for (int e = 0; e < kBatch; ++e) {
      const bool live = col && q0 + e < n_ent;
      const In* p = proj + (live ? s_src[q0 + e] : 0) * pitch + u;
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        v[e][b] = live ? merge_path::load_f32(p + b * units) : zero_of(T());
      }
    }
#pragma unroll
    for (int e = 0; e < kBatch; ++e) {
      const int q = q0 + e;
      if (q >= n_ent) break;
      while (g.j0 + q >= row_end) {  // row i0 + r ends before this entry
        if (col) out[static_cast<int64_t>(g.i0 + r) * units + u] = acc;
        acc = zero_of(T());
        ++r;
        row_end = r < n_ends ? s_end[r] : INT_MAX;
      }
#pragma unroll
      for (int b = 0; b < NB; ++b) axpy(s_c[b * items + q], v[e][b], acc);
    }
  }
  for (; r < n_ends; ++r) {  // rows ending after the block's last entry
    if (col) out[static_cast<int64_t>(g.i0 + r) * units + u] = acc;
    acc = zero_of(T());
  }
  // acc is now the block's part of row i1, in progress at its end.
  if (blockIdx.y == 0 && t == 0) {
    carry_row[blockIdx.x] = g.has_carry ? g.i1 : -1;
  }
  if (g.has_carry && col) {
    carry[static_cast<int64_t>(blockIdx.x) * units + u] = acc;
  }
}

template <int NB, typename In, typename T>
int launch(const In* proj, const float* coef, const int* row_ptr,
           const int* src, const int* rel, const float* w, T* out,
           int* carry_row, T* carry, int n_rows, int n_edges, int units,
           int items, cudaStream_t s) {
  const int grid_y = (units + kThreads - 1) / kThreads;
  const int64_t n_blocks = merge_path::grid_blocks(n_rows, n_edges, items);
  if (grid_y > 65535 || n_blocks < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(n_blocks),
                  static_cast<unsigned>(grid_y));
  const size_t smem = sizeof(int) * (2 + NB) * static_cast<size_t>(items);
  basis_combine_kernel<NB, In, T><<<grid, kThreads, smem, s>>>(
      proj, coef, row_ptr, src, rel, w, out, carry_row, carry, n_rows,
      n_edges, units, items);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return merge_path::launch_fixup(carry_row, carry, out,
                                  static_cast<int>(n_blocks), units, s);
}

// P f32 (kBf16 false) or bf16: four columns a thread where d_out % 4 == 0
// and the pointers allow it, else one.
template <int NB, bool kBf16>
int dispatch(const void* proj, const float* coef, const int* row_ptr,
             const int* src, const int* rel, const float* w, float* out,
             int* carry_row, float* carry, int n_rows, int n_edges,
             int d_out, int items, cudaStream_t s) {
  const bool wide = d_out % 4 == 0 && merge_path::aligned16(out) &&
                    merge_path::aligned16(carry) &&
                    (kBf16 ? merge_path::aligned8(proj)
                           : merge_path::aligned16(proj));
  float4* out4 = reinterpret_cast<float4*>(out);
  float4* carry4 = reinterpret_cast<float4*>(carry);
  if (kBf16 && wide) {
    return launch<NB>(static_cast<const uint2*>(proj), coef, row_ptr, src,
                      rel, w, out4, carry_row, carry4, n_rows, n_edges,
                      d_out / 4, items, s);
  }
  if (kBf16) {
    return launch<NB>(static_cast<const uint16_t*>(proj), coef, row_ptr, src,
                      rel, w, out, carry_row, carry, n_rows, n_edges, d_out,
                      items, s);
  }
  if (wide) {
    return launch<NB>(static_cast<const float4*>(proj), coef, row_ptr, src,
                      rel, w, out4, carry_row, carry4, n_rows, n_edges,
                      d_out / 4, items, s);
  }
  return launch<NB>(static_cast<const float*>(proj), coef, row_ptr, src, rel,
                    w, out, carry_row, carry, n_rows, n_edges, d_out, items,
                    s);
}

// Checks the sizes and launches for n_bases in [1, kMaxBases].
template <bool kBf16>
int combine(const void* proj, const float* coef, const int* row_ptr,
            const int* src, const int* rel, const float* w, float* out,
            int* carry_row, float* carry, int n_rows, int n_edges,
            int n_bases, int d_out, int items, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_rows < 0 || n_edges < 0 || d_out < 1 || items < 1 ||
      items > kMaxItems ||
      static_cast<int64_t>(n_rows) + n_edges > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BASIS_COMBINE_CASE(NB)                                              \
  case NB:                                                                  \
    return dispatch<NB, kBf16>(proj, coef, row_ptr, src, rel, w, out,       \
                               carry_row, carry, n_rows, n_edges, d_out,    \
                               items, s);
  switch (n_bases) {
    BASIS_COMBINE_CASE(1)
    BASIS_COMBINE_CASE(2)
    BASIS_COMBINE_CASE(3)
    BASIS_COMBINE_CASE(4)
    BASIS_COMBINE_CASE(5)
    BASIS_COMBINE_CASE(6)
    BASIS_COMBINE_CASE(7)
    BASIS_COMBINE_CASE(8)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef BASIS_COMBINE_CASE
}

}  // namespace

extern "C" {

// Largest B and `items` basis_combine_f32 takes; the Python wrapper checks
// against them.
int basis_direction_max_bases() { return kMaxBases; }
int basis_combine_max_items() { return kMaxItems; }

// out [n_rows, d_out] from proj [*, n_bases * d_out] and coef [R, n_bases]
// on a CSR of n_rows rows and n_edges entries, on `stream` of `device`,
// with carry_row [n_blocks] int32 and carry [n_blocks, d_out] f32 as
// scratch, n_blocks = ceil((n_rows + n_edges) / items); carry_row is left
// holding each block's carried row (-1 for none). Returns
// cudaGetLastError() after the launches (0 on success);
// cudaErrorInvalidValue for a negative size, n_bases outside [1, 8],
// d_out < 1, items outside [1, basis_combine_max_items()], n_rows +
// n_edges beyond int32 or a grid beyond the card's limits.
int basis_combine_f32(const float* proj, const float* coef,
                      const int* row_ptr, const int* src, const int* rel,
                      const float* w, float* out, int* carry_row,
                      float* carry, int n_rows, int n_edges, int n_bases,
                      int d_out, int items, int device, void* stream) {
  return combine<false>(proj, coef, row_ptr, src, rel, w, out, carry_row,
                        carry, n_rows, n_edges, n_bases, d_out, items, device,
                        stream);
}

// The same for proj bf16 (its bits as uint16_t); coef, w, out and carry
// f32.
int basis_combine_bf16(const void* proj, const float* coef,
                       const int* row_ptr, const int* src, const int* rel,
                       const float* w, float* out, int* carry_row,
                       float* carry, int n_rows, int n_edges, int n_bases,
                       int d_out, int items, int device, void* stream) {
  return combine<true>(proj, coef, row_ptr, src, rel, w, out, carry_row,
                       carry, n_rows, n_edges, n_bases, d_out, items, device,
                       stream);
}

const char* basis_direction_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
