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
// basis_combine_row_bf16 takes P in bf16 (basis_project_bf16's output,
// the TPU kernel's bf16 t_ref, relationprediction_tpu/ops/staircase2.py:
// 508-515): each element is widened to f32 as it is loaded, C and the edge
// weights stay f32, the sums are f32 and out is f32, and the gathers move
// half the bytes (1.36 GB a launch on the full graph, from a P of 72.7 MB).
//
// Design of basis_combine_f32 and basis_combine_row_bf16 (PR 6's; for bf16
// now only a yardstick): the merge-path partition of merge_path.cuh. Each
// thread block takes `items` row ends + entries, so a hub row (about 9k
// edges at FB15k-237 scale, 90 MB of gathers) is cut across many blocks
// and a run of empty rows costs a block one item a row; rows cut by a
// block boundary are finished by the carry fix-up in block order (no
// atomics, the same bits on every launch). The block stages its row ends,
// sources and the B values w_e * C[r_e, b] of its entries in shared
// memory. 128 threads lie across the d_out columns, each owning one float4
// (d_out % 4 == 0 and 16-byte aligned pointers; d_out = 500 gives 125
// threads) or one float otherwise, with gridDim.y covering wider rows. An
// entry adds its B coefficient-scaled P values to the thread's columns,
// the loads of kBatch entries in flight together; the B parts are combined
// before any carry is written, so a carry is [d_out]. Sums are f32, in CSR
// order.
//
// basis_combine_bf16 (the main path's bf16 entry point) walks the same
// partition with the same sums in the same order, so its output equals
// basis_combine_f32's on the widened P bit for bit. What holds the row
// design's bf16 instantiation on the full graph is the loads in flight:
// at 109 registers a thread an SM holds 4 of its thread blocks, 16 warps
// with 4 entries' 8-byte loads a thread in flight, too few to cover the
// gathers' trip to L2. Here a thread keeps its P values as the loaded
// bf16 words (its FMAs widen them): 71 registers at the same 4 entries,
// 7 thread blocks an SM. Rows wider than a block's kGroupThreads words
// are cut into column chunks, the grid ordered chunk by chunk; a block
// holds kGroups groups, each group one merge-path part
// (staircase.basis_combine_plan plans the chunks from the shapes). With
// P's gathers alone (no FMA) the kernel is about as fast: the bytes from
// L2 set its time. Chunks of 128 columns, sized so that a chunk's slice of
// P stays in L2 (18.6 MB of 72.7 MB), and 8 or 12 entries in flight were
// measured no faster (PERF.md; tools/basis_combine_variants.py).

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

// Sets the device and checks the sizes every entry point takes: 0 to
// launch, -1 where there is nothing to do (no rows), else the error.
int checked(int n_rows, int n_edges, int d_out, int items, int device) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_rows < 0 || n_edges < 0 || d_out < 1 || items < 1 ||
      items > kMaxItems ||
      static_cast<int64_t>(n_rows) + n_edges > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return n_rows == 0 ? -1 : 0;
}

// Checks the sizes and launches for n_bases in [1, kMaxBases].
template <bool kBf16>
int combine(const void* proj, const float* coef, const int* row_ptr,
            const int* src, const int* rel, const float* w, float* out,
            int* carry_row, float* carry, int n_rows, int n_edges,
            int n_bases, int d_out, int items, int device, void* stream) {
  if (const int rc = checked(n_rows, n_edges, d_out, items, device)) {
    return rc < 0 ? 0 : rc;
  }
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

// ---------------------------------------------------------------------------
// basis_combine_bf16: the column-chunked kernel (see the head of the file)
// ---------------------------------------------------------------------------

constexpr int kGroupThreads = 128;  // threads of a group: a chunk's words
constexpr int kGroups = 1;          // groups (merge-path parts) of a block
constexpr int kChunkThreads = kGroupThreads * kGroups;
constexpr int kChunkBatch = 4;      // entries whose loads are in flight
constexpr int kWordCols = 4;        // bf16 columns of a word, d_out allowing

// The word a thread loads of one basis part of a P row: kCols bf16
// columns.
template <int kCols>
struct Bf16Word;
template <>
struct Bf16Word<1> {
  using type = uint16_t;
};
template <>
struct Bf16Word<4> {
  using type = uint2;
};

// Column c of a word as f32, widened exactly (its bits the high half of
// the f32's).
__device__ __forceinline__ float column(uint16_t w, int) {
  return __uint_as_float(static_cast<uint32_t>(w) << 16);
}
__device__ __forceinline__ float column(uint2 w, int c) {
  const uint32_t h = c < 2 ? w.x : w.y;
  return __uint_as_float((c & 1) ? h & 0xFFFF0000u : h << 16);
}

// What a thread keeps of a loaded word until its FMAs: the word itself,
// widened a column at a time where it is used (a type of its own, so that
// tools/basis_combine_variants.py can widen at the load instead).
template <int kCols>
struct Held {
  typename Bf16Word<kCols>::type w;
  __device__ __forceinline__ void hold(typename Bf16Word<kCols>::type x) {
    w = x;
  }
  __device__ __forceinline__ float at(int c) const { return column(w, c); }
};

// kCols f32 sums to out or carry: float4 stores where kCols is a multiple
// of 4.
template <int kCols>
__device__ __forceinline__ void store(float* dst, const float (&acc)[kCols]) {
  if constexpr (kCols == 1) {
    *dst = acc[0];
  } else {
#pragma unroll
    for (int c = 0; c < kCols; c += 4) {
      *reinterpret_cast<float4*>(dst + c) =
          make_float4(acc[c], acc[c + 1], acc[c + 2], acc[c + 3]);
    }
  }
}

// Thread block x is part group x % blocks_per_chunk of column chunk
// x / blocks_per_chunk, so every thread block of a chunk comes before the
// next chunk's. Group g of the block takes merge-path part part0 + g (the
// partition of merge_path.cuh, `items` items a part) and the chunk's
// chunk_words words of each row: its thread l the word chunk *
// chunk_words + l, kCols columns. It stages its row ends, sources and B
// coefficients w_e * C[r_e, b] as basis_combine_kernel does, walks its
// entries in CSR order with the same FMAs in the same order, and writes
// its carry to the part's slot of carry (its chunk's columns), carry_row
// from chunk 0.
template <int NB, int kCols>
__global__ void __launch_bounds__(kChunkThreads)
combine_chunk_kernel(const typename Bf16Word<kCols>::type* __restrict__ proj,
                     const float* __restrict__ coef,
                     const int* __restrict__ row_ptr,
                     const int* __restrict__ src,
                     const int* __restrict__ rel,
                     const float* __restrict__ wt, float* __restrict__ out,
                     int* __restrict__ carry_row, float* __restrict__ carry,
                     int n_rows, int n_edges, int d_out, int items,
                     int n_parts, int chunk_words) {
  using Word = typename Bf16Word<kCols>::type;
  extern __shared__ int staged[];  // each group's row ends, sources, coefs
  __shared__ int bounds[kGroups + 1][3];  // rows ended, entries, carry
  const int t = threadIdx.x;
  const int g = t / kGroupThreads;
  const int l = t % kGroupThreads;
  const int blocks_per_chunk = (n_parts + kGroups - 1) / kGroups;
  const int chunk = blockIdx.x / blocks_per_chunk;
  const int part0 = (blockIdx.x - chunk * blocks_per_chunk) * kGroups;
  if (t <= kGroups) {  // where the merge path is at each group boundary
    const int64_t total = static_cast<int64_t>(n_rows) + n_edges;
    const int64_t at = static_cast<int64_t>(part0 + t) * items;
    const int diag = static_cast<int>(at < total ? at : total);
    const int i = merge_path::rows_before(row_ptr, n_rows, n_edges, diag);
    const int j = diag - i;
    bounds[t][0] = i;
    bounds[t][1] = j;
    bounds[t][2] = i < n_rows && j > __ldg(row_ptr + i);
  }
  __syncthreads();
  const int i0 = bounds[g][0];
  const int j0 = bounds[g][1];
  const int n_ends = bounds[g + 1][0] - i0;  // rows ending in the part
  const int n_ent = bounds[g + 1][1] - j0;   // entries taken in the part
  int* s_end = staged + g * (2 + NB) * items;
  int* s_src = s_end + items;
  float* s_c = reinterpret_cast<float*>(s_src + items);  // [NB][items]
  for (int r = l; r < n_ends; r += kGroupThreads) {
    s_end[r] = __ldg(row_ptr + i0 + r + 1);
  }
  for (int q = l; q < n_ent; q += kGroupThreads) {
    const int k = j0 + q;
    s_src[q] = __ldg(src + k);
    const float we = __ldg(wt + k);
    const float* c = coef + static_cast<int64_t>(__ldg(rel + k)) * NB;
#pragma unroll
    for (int b = 0; b < NB; ++b) s_c[b * items + q] = we * __ldg(c + b);
  }
  __syncthreads();

  const int words = d_out / kCols;
  const int u = chunk * chunk_words + l;
  const bool col = l < chunk_words && u < words;
  const int64_t pitch = static_cast<int64_t>(NB) * words;
  float acc[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) acc[c] = 0.f;
  int r = 0;  // row i0 + r takes the next entry
  int row_end = n_ends > 0 ? s_end[0] : INT_MAX;
  for (int q0 = 0; q0 < n_ent; q0 += kChunkBatch) {
    Held<kCols> v[kChunkBatch][NB];
#pragma unroll
    for (int e = 0; e < kChunkBatch; ++e) {
      const bool live = col && q0 + e < n_ent;
      const Word* p = proj + (live ? s_src[q0 + e] : 0) * pitch + u;
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        v[e][b].hold(live ? __ldg(p + b * words) : Word{});
      }
    }
#pragma unroll
    for (int e = 0; e < kChunkBatch; ++e) {
      const int q = q0 + e;
      if (q >= n_ent) break;
      while (j0 + q >= row_end) {  // row i0 + r ends before this entry
        if (col) {
          store<kCols>(out + static_cast<int64_t>(i0 + r) * d_out + u * kCols,
                       acc);
        }
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[c] = 0.f;
        ++r;
        row_end = r < n_ends ? s_end[r] : INT_MAX;
      }
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const float cb = s_c[b * items + q];
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          acc[c] = fmaf(cb, v[e][b].at(c), acc[c]);
        }
      }
    }
  }
  for (; r < n_ends; ++r) {  // rows ending after the part's last entry
    if (col) {
      store<kCols>(out + static_cast<int64_t>(i0 + r) * d_out + u * kCols,
                   acc);
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[c] = 0.f;
  }
  // acc is now the part's share of the row in progress at its end.
  const int part = part0 + g;
  if (part < n_parts) {
    const bool has_carry = bounds[g + 1][2] != 0;
    if (chunk == 0 && l == 0) carry_row[part] = has_carry ? i0 + n_ends : -1;
    if (has_carry && col) {
      store<kCols>(carry + static_cast<int64_t>(part) * d_out + u * kCols,
                   acc);
    }
  }
}

// Shared memory of a chunk thread block: each group's staging, 2 + B
// words an item (3,584 bytes at B = 5, 128 items; 40 KB at B = 8, 1,024
// items; above 48 KB, with more groups, the launch asks for it).
constexpr size_t chunk_smem_bytes(int n_bases, int items) {
  return sizeof(int) * kGroups * (2 + n_bases) * static_cast<size_t>(items);
}

template <int NB, int kCols>
int launch_chunks(const void* proj, const float* coef, const int* row_ptr,
                  const int* src, const int* rel, const float* w, float* out,
                  int* carry_row, float* carry, int n_rows, int n_edges,
                  int d_out, int items, int chunk_cols, cudaStream_t s) {
  const int words = d_out / kCols;
  const int chunk_words = chunk_cols / kCols;
  if (d_out % kCols != 0 || chunk_cols % kCols != 0 || chunk_words < 1 ||
      chunk_words > kGroupThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t n_chunks = (words + chunk_words - 1) / chunk_words;
  const int64_t n_parts = merge_path::grid_blocks(n_rows, n_edges, items);
  const int64_t per_chunk = (n_parts + kGroups - 1) / kGroups;
  if (n_parts < 0 || per_chunk * n_chunks > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = chunk_smem_bytes(NB, items);
  auto kernel = combine_chunk_kernel<NB, kCols>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<static_cast<unsigned>(per_chunk * n_chunks), kChunkThreads, smem,
           s>>>(static_cast<const typename Bf16Word<kCols>::type*>(proj),
                coef, row_ptr, src, rel, w, out, carry_row, carry, n_rows,
                n_edges, d_out, items, static_cast<int>(n_parts),
                chunk_words);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if constexpr (kCols == 1) {
    return merge_path::launch_fixup(carry_row, carry, out,
                                    static_cast<int>(n_parts), d_out, s);
  } else {
    return merge_path::launch_fixup(
        carry_row, reinterpret_cast<const float4*>(carry),
        reinterpret_cast<float4*>(out), static_cast<int>(n_parts),
        d_out / 4, s);
  }
}

// `cols` kWordCols (P, out and carry aligned to a word and 16 bytes) or
// 1 columns a thread.
template <int NB>
int dispatch_chunks(const void* proj, const float* coef, const int* row_ptr,
                    const int* src, const int* rel, const float* w,
                    float* out, int* carry_row, float* carry, int n_rows,
                    int n_edges, int d_out, int items, int cols,
                    int chunk_cols, cudaStream_t s) {
  if (cols == kWordCols && merge_path::aligned16(out) &&
      merge_path::aligned16(carry) &&
      reinterpret_cast<uintptr_t>(proj) % (2 * kWordCols) == 0) {
    return launch_chunks<NB, kWordCols>(proj, coef, row_ptr, src, rel, w,
                                        out, carry_row, carry, n_rows,
                                        n_edges, d_out, items, chunk_cols, s);
  }
  if (cols == 1) {
    return launch_chunks<NB, 1>(proj, coef, row_ptr, src, rel, w, out,
                                carry_row, carry, n_rows, n_edges, d_out,
                                items, chunk_cols, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

int combine_chunks(const void* proj, const float* coef, const int* row_ptr,
                   const int* src, const int* rel, const float* w,
                   float* out, int* carry_row, float* carry, int n_rows,
                   int n_edges, int n_bases, int d_out, int items, int cols,
                   int chunk_cols, int device, void* stream) {
  if (const int rc = checked(n_rows, n_edges, d_out, items, device)) {
    return rc < 0 ? 0 : rc;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BASIS_CHUNK_CASE(NB)                                                \
  case NB:                                                                  \
    return dispatch_chunks<NB>(proj, coef, row_ptr, src, rel, w, out,       \
                               carry_row, carry, n_rows, n_edges, d_out,    \
                               items, cols, chunk_cols, s);
  switch (n_bases) {
    BASIS_CHUNK_CASE(1)
    BASIS_CHUNK_CASE(2)
    BASIS_CHUNK_CASE(3)
    BASIS_CHUNK_CASE(4)
    BASIS_CHUNK_CASE(5)
    BASIS_CHUNK_CASE(6)
    BASIS_CHUNK_CASE(7)
    BASIS_CHUNK_CASE(8)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef BASIS_CHUNK_CASE
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

// The same for proj bf16 (its bits as uint16_t) by PR 6's design (the
// columns of whole rows across a thread block); coef, w, out and carry
// f32. Kept to time the chunk kernel against.
int basis_combine_row_bf16(const void* proj, const float* coef,
                           const int* row_ptr, const int* src,
                           const int* rel, const float* w, float* out,
                           int* carry_row, float* carry, int n_rows,
                           int n_edges, int n_bases, int d_out, int items,
                           int device, void* stream) {
  return combine<true>(proj, coef, row_ptr, src, rel, w, out, carry_row,
                       carry, n_rows, n_edges, n_bases, d_out, items, device,
                       stream);
}

// basis_combine_row_bf16's function by the chunk kernel: `cols` columns a
// thread (basis_combine_word_cols(), with P 2 * cols-byte and out and
// carry 16-byte aligned and d_out a multiple of it; or 1) and chunks of
// chunk_cols columns (a multiple of cols, at most
// basis_combine_chunk_threads() * cols), planned by
// staircase.basis_combine_plan. The same scratch, carry rows and bits as
// basis_combine_f32 on the widened P; cudaErrorInvalidValue also for
// another cols or chunk_cols, or a grid beyond int32.
int basis_combine_bf16(const void* proj, const float* coef,
                       const int* row_ptr, const int* src, const int* rel,
                       const float* w, float* out, int* carry_row,
                       float* carry, int n_rows, int n_edges, int n_bases,
                       int d_out, int items, int cols, int chunk_cols,
                       int device, void* stream) {
  return combine_chunks(proj, coef, row_ptr, src, rel, w, out, carry_row,
                        carry, n_rows, n_edges, n_bases, d_out, items, cols,
                        chunk_cols, device, stream);
}

// The chunk kernel's shape, for the planner's checks: threads of a group
// (the most words a chunk has), bf16 columns of a word, and a block's
// shared memory at B bases and `items` items.
int basis_combine_chunk_threads() { return kGroupThreads; }
int basis_combine_word_cols() { return kWordCols; }
long long basis_combine_chunk_smem_bytes(int n_bases, int items) {
  return static_cast<long long>(chunk_smem_bytes(n_bases, items));
}

const char* basis_direction_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
