// Relational block-diagonal aggregation, one direction, for sm_90a.
//
//   out[v] = sum over edges e with target v of  w_e * blockdiag(W[r_e]) @ x[src_e]
//
// x [V, d] f32, W [R, B, dr, dr] f32 with d = B * dr, out [V, d] f32, in the
// orientation y[b*dr + i] = sum_j W[r, b, i, j] * x[b*dr + j].
//
// block_direction_bf16 and block_direction_twin_bf16 take x and W in bf16
// (the TPU kernel's compute_dtype, relationprediction_tpu/ops/
// staircase2.py:683-689, twin :711-716): each element is widened to f32 as
// it is loaded, so the edge weights, products and sums stay f32 and out is
// f32, while the x gathers and the W reloads move half the bytes.
//
// The twin pass (block_direction_twin_f32) is the same kernel reading W
// transposed, y[b*dr + i] = sum_j W[r, b, j, i] * x[b*dr + j]: run on a
// direction's twin CSR (rows are the edges' sources, sorted by relation
// within a row; x is the cotangent g of the output) it gives d features[u]
// = sum_{e: src_e = u} w_e W[r_e]^T g[tgt_e] without a transposed copy of
// W. It replaces the JAX VJP's second launch of the same TPU kernel on the
// twin layout with blocks_to_jmajor_T
// (relationprediction_tpu/ops/staircase2.py:698-723).
//
// Replaces relationprediction_tpu/ops/staircase2.py:460-502
// (_make_block_kernel, launched by _call_block at :560-598). That kernel
// gathers pre-weighted source rows into TPU slots, expands each slot group's
// relation weights with a one-hot MXU matmul, transforms on a j-major lane
// layout and adds into 256-row output blocks with a one-hot matmul, which a
// segment-sum then finishes. None of that carries over.
//
// What bounds it on an H100: a launch must read x, W and the CSR once and
// write out once (about 64 MB at FB15k-237 width, ~19 us at 3.35 TB/s; a
// training batch's 15k edges: ~41 MB, ~12 us); its 2*E*d + 2*P*d*dr f32
// operations (P relation runs) need less than that on the 67 TFLOP/s f32
// pipes, so the bound is set by bytes. What a launch really moves is more:
// every edge gathers its x row (E * d * 4 B, 0.54 GB on the full graph,
// mostly L2 hits: x is 29 MB) and every relation run reloads its W[r]
// (B * dr * dr * 4 B = 10 KB, ~156k runs, ~1.56 GB from L2). The graphs
// are skewed: hub rows of up to 9,155 edges beside rows of one, and at the
// train shape 2/3 of the 14,541 rows are empty.
//
// Design: the merge-path partition of merge_path.cuh. Each thread block
// takes `items` row ends + entries, so a hub row is cut across ~140 blocks
// and a run of empty rows costs a block one item a row; rows cut by a block
// boundary are finished by the carry fix-up in block order (no atomics, the
// same bits on every launch).
// * Work split: thread b owns output block b (dr features), B <= 128
//   threads rounded up to a warp. The block's row ends, sources, relations
//   and weights are staged in shared memory.
// * Relation runs: the edges of one (target, relation) pair share W[r]
//   (the CSR is sorted by relation within a row), so a thread first sums
//   z = sum_e w_e * x[src_e] over the run (dr FMAs an edge) and applies the
//   block once per run (dr*dr FMAs), not per edge. A run cut by a block
//   boundary applies W[r] in each part: the product is linear, so the
//   parts add up in the carry.
// * Latency: the feature loads of kBatch entries are all issued before the
//   first is used.
// * Precision: f32 arithmetic throughout (bf16 inputs widened on load);
//   sums in CSR order.
//   chip_smoke.py holds each output to a float64 sum within the rounding
//   that the element's sum of |terms| allows an f32 sum.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "merge_path.cuh"

namespace {

constexpr int kMaxBlocks = 128;  // B: one thread an output block
constexpr int kBatch = 4;        // entries whose loads are in flight together
constexpr int kMaxItems = 2048;  // staging: 4 words an item, 32 KB at most

// y += W[rel] (block b, transposed with kTransposeW) @ z, then z = 0; a
// negative rel (no run open) adds nothing. In is float or uint16_t (bf16).
template <int DR, bool kTransposeW, typename In>
__device__ __forceinline__ void apply_run(const In* __restrict__ blocks,
                                          int rel, int n_blocks, int b,
                                          float (&z)[DR], float (&y)[DR]) {
  if (rel >= 0) {
    const In* wb = blocks + (static_cast<int64_t>(rel) * n_blocks + b) *
                                (DR * DR);
#pragma unroll
    for (int i = 0; i < DR; ++i) {
#pragma unroll
      for (int j = 0; j < DR; ++j) {
        const int at = kTransposeW ? j * DR + i : i * DR + j;
        y[i] = fmaf(merge_path::load_f32(wb + at), z[j], y[i]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < DR; ++j) z[j] = 0.f;
}

template <int DR>
__device__ __forceinline__ void store(float* __restrict__ p,
                                      float (&y)[DR]) {
#pragma unroll
  for (int i = 0; i < DR; ++i) {
    p[i] = y[i];
    y[i] = 0.f;
  }
}

template <int DR, bool kTransposeW, typename In>
__global__ void __launch_bounds__(kMaxBlocks)
block_direction_kernel(const In* __restrict__ x,
                       const In* __restrict__ blocks,
                       const int* __restrict__ row_ptr,
                       const int* __restrict__ src,
                       const int* __restrict__ rel,
                       const float* __restrict__ wt,
                       float* __restrict__ out, int* __restrict__ carry_row,
                       float* __restrict__ carry, int n_rows, int n_edges,
                       int n_blocks, int items) {
  extern __shared__ int staged[];  // row ends, sources, relations, weights
  const int t = threadIdx.x;
  const merge_path::Range g =
      merge_path::find_range(row_ptr, n_rows, n_edges, items);
  const int n_ends = g.i1 - g.i0;  // rows i0 .. i1 - 1 end in this block
  const int n_ent = g.j1 - g.j0;   // entries j0 .. j1 - 1 are taken here
  int* s_end = staged;
  int* s_src = staged + items;
  int* s_rel = staged + 2 * items;
  float* s_w = reinterpret_cast<float*>(staged + 3 * items);
  for (int r = t; r < n_ends; r += blockDim.x) {
    s_end[r] = __ldg(row_ptr + g.i0 + r + 1);
  }
  for (int q = t; q < n_ent; q += blockDim.x) {
    s_src[q] = __ldg(src + g.j0 + q);
    s_rel[q] = __ldg(rel + g.j0 + q);
    s_w[q] = __ldg(wt + g.j0 + q);
  }
  __syncthreads();

  const int d = n_blocks * DR;
  const bool owner = t < n_blocks;
  const int64_t col = static_cast<int64_t>(t) * DR;
  float y[DR], z[DR];
#pragma unroll
  for (int i = 0; i < DR; ++i) {
    y[i] = 0.f;
    z[i] = 0.f;
  }
  int run_rel = -1;  // relation of the open run, -1 for none
  int r = 0;         // row i0 + r takes the next entry
  int row_end = n_ends > 0 ? s_end[0] : INT_MAX;
  for (int q0 = 0; q0 < n_ent; q0 += kBatch) {
    float xv[kBatch][DR];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const bool live = owner && q0 + u < n_ent;
      const In* xs =
          x + static_cast<int64_t>(live ? s_src[q0 + u] : 0) * d + col;
#pragma unroll
      for (int j = 0; j < DR; ++j) {
        xv[u][j] = live ? merge_path::load_f32(xs + j) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int q = q0 + u;
      if (q >= n_ent) break;
      while (g.j0 + q >= row_end) {  // row i0 + r ends before this entry
        if (owner) {
          apply_run<DR, kTransposeW>(blocks, run_rel, n_blocks, t, z, y);
          store<DR>(out + static_cast<int64_t>(g.i0 + r) * d + col, y);
        }
        run_rel = -1;
        ++r;
        row_end = r < n_ends ? s_end[r] : INT_MAX;
      }
      const int rq = s_rel[q];
      if (rq != run_rel) {
        if (owner) {
          apply_run<DR, kTransposeW>(blocks, run_rel, n_blocks, t, z, y);
        }
        run_rel = rq;
      }
      const float wq = s_w[q];
#pragma unroll
      for (int j = 0; j < DR; ++j) z[j] = fmaf(wq, xv[u][j], z[j]);
    }
  }
  if (owner) apply_run<DR, kTransposeW>(blocks, run_rel, n_blocks, t, z, y);
  for (; r < n_ends; ++r) {  // rows ending after the block's last entry
    if (owner) store<DR>(out + static_cast<int64_t>(g.i0 + r) * d + col, y);
  }
  // y is now the block's part of row i1, in progress at its end.
  if (t == 0) carry_row[blockIdx.x] = g.has_carry ? g.i1 : -1;
  if (g.has_carry && owner) {
    store<DR>(carry + static_cast<int64_t>(blockIdx.x) * d + col, y);
  }
}

template <int DR, bool kTransposeW, typename In>
int launch(const In* x, const In* blocks, const int* row_ptr,
           const int* src, const int* rel, const float* w, float* out,
           int* carry_row, float* carry, int n_rows, int n_edges,
           int n_blocks, int items, cudaStream_t s) {
  const int64_t grid = merge_path::grid_blocks(n_rows, n_edges, items);
  if (grid < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = (n_blocks + 31) / 32 * 32;
  const size_t smem = sizeof(int) * 4 * static_cast<size_t>(items);
  block_direction_kernel<DR, kTransposeW, In>
      <<<static_cast<unsigned>(grid), threads, smem, s>>>(
          x, blocks, row_ptr, src, rel, w, out, carry_row, carry, n_rows,
          n_edges, n_blocks, items);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int d = n_blocks * DR;
  if (d % 4 == 0 && merge_path::aligned16(out) &&
      merge_path::aligned16(carry)) {
    return merge_path::launch_fixup(
        carry_row, reinterpret_cast<const float4*>(carry),
        reinterpret_cast<float4*>(out), static_cast<int>(grid), d / 4, s);
  }
  return merge_path::launch_fixup(carry_row, carry, out,
                                  static_cast<int>(grid), d, s);
}

template <bool kTransposeW, typename In>
int dispatch(const In* x, const In* blocks, const int* row_ptr,
             const int* src, const int* rel, const float* w, float* out,
             int* carry_row, float* carry, int n_rows, int n_edges,
             int n_blocks, int dr, int items, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_rows < 0 || n_edges < 0 || n_blocks < 1 || n_blocks > kMaxBlocks ||
      items < 1 || items > kMaxItems ||
      static_cast<int64_t>(n_rows) + n_edges > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BLOCK_DIRECTION_CASE(DR)                                           \
  case DR:                                                                 \
    return launch<DR, kTransposeW, In>(x, blocks, row_ptr, src, rel, w,    \
                                       out, carry_row, carry, n_rows,      \
                                       n_edges, n_blocks, items, s);
  switch (dr) {
    BLOCK_DIRECTION_CASE(1)
    BLOCK_DIRECTION_CASE(2)
    BLOCK_DIRECTION_CASE(3)
    BLOCK_DIRECTION_CASE(4)
    BLOCK_DIRECTION_CASE(5)
    BLOCK_DIRECTION_CASE(6)
    BLOCK_DIRECTION_CASE(7)
    BLOCK_DIRECTION_CASE(8)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef BLOCK_DIRECTION_CASE
}

}  // namespace

extern "C" {

// Largest B and `items` the kernel takes; the Python wrapper checks
// against them.
int block_direction_max_blocks() { return kMaxBlocks; }
int block_direction_max_items() { return kMaxItems; }

// out [n_rows, d] on `stream` of `device`, with carry_row [n_blocks] int32
// and carry [n_blocks, d] f32 as scratch, n_blocks = ceil((n_rows +
// n_edges) / items); carry_row is left holding each block's carried row
// (-1 for none). Returns cudaGetLastError() after the launches (0 on
// success); cudaErrorInvalidValue for a negative size, B outside [1, 128],
// dr outside [1, 8], items outside [1, block_direction_max_items()] or
// n_rows + n_edges beyond int32.
int block_direction_f32(const float* x, const float* blocks,
                        const int* row_ptr, const int* src, const int* rel,
                        const float* w, float* out, int* carry_row,
                        float* carry, int n_rows, int n_edges, int n_blocks,
                        int dr, int items, int device, void* stream) {
  return dispatch<false>(x, blocks, row_ptr, src, rel, w, out, carry_row,
                         carry, n_rows, n_edges, n_blocks, dr, items, device,
                         stream);
}

// The twin pass: the same launch reading W[r, b, j, i] for W[r, b, i, j].
int block_direction_twin_f32(const float* x, const float* blocks,
                             const int* row_ptr, const int* src,
                             const int* rel, const float* w, float* out,
                             int* carry_row, float* carry, int n_rows,
                             int n_edges, int n_blocks, int dr, int items,
                             int device, void* stream) {
  return dispatch<true>(x, blocks, row_ptr, src, rel, w, out, carry_row,
                        carry, n_rows, n_edges, n_blocks, dr, items, device,
                        stream);
}

// block_direction_f32 and block_direction_twin_f32 with x and blocks in
// bf16 (their bits as uint16_t); w, out and carry f32.
int block_direction_bf16(const void* x, const void* blocks,
                         const int* row_ptr, const int* src, const int* rel,
                         const float* w, float* out, int* carry_row,
                         float* carry, int n_rows, int n_edges, int n_blocks,
                         int dr, int items, int device, void* stream) {
  return dispatch<false>(static_cast<const uint16_t*>(x),
                         static_cast<const uint16_t*>(blocks), row_ptr, src,
                         rel, w, out, carry_row, carry, n_rows, n_edges,
                         n_blocks, dr, items, device, stream);
}

int block_direction_twin_bf16(const void* x, const void* blocks,
                              const int* row_ptr, const int* src,
                              const int* rel, const float* w, float* out,
                              int* carry_row, float* carry, int n_rows,
                              int n_edges, int n_blocks, int dr, int items,
                              int device, void* stream) {
  return dispatch<true>(static_cast<const uint16_t*>(x),
                        static_cast<const uint16_t*>(blocks), row_ptr, src,
                        rel, w, out, carry_row, carry, n_rows, n_edges,
                        n_blocks, dr, items, device, stream);
}

const char* block_direction_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
