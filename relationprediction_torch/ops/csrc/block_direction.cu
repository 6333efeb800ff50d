// Relational block-diagonal aggregation, one direction, for sm_90a.
//
//   out[v] = sum over edges e with target v of  w_e * blockdiag(W[r_e]) @ x[src_e]
//
// x [V, d] f32, W [R, B, dr, dr] f32 with d = B * dr, out [V, d] f32, in the
// orientation y[b*dr + i] = sum_j W[r, b, i, j] * x[b*dr + j].
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
// mostly L2 hits: x is 29 MB) and, in the walk below, every relation run
// reloads its W[r] (B * dr * dr * 4 B = 10 KB, ~156k runs, ~1.56 GB from
// L2). The graphs are skewed: hub rows of up to 9,155 edges beside rows of
// one, and at the train shape 2/3 of the 14,541 rows are empty.
//
// Two routes, both on the merge-path partition of merge_path.cuh: sub-range
// b of the merged list of row ends and entries is items [b * items,
// (b + 1) * items), a hub row is cut across sub-ranges, and rows cut by a
// boundary are finished by the carry fix-up in sub-range order (no
// atomics, the same bits on every launch).
//
// The walk (block_direction_f32, block_direction_twin_f32, and for bf16
// where W's slice does not fit shared memory): one thread block a
// sub-range.
// * Work split: thread b owns output block b (dr features), B <= 128
//   threads rounded up to a warp. The block's row ends, sources, relations
//   and weights are staged in shared memory.
// * Relation runs: the edges of one (target, relation) pair share W[r]
//   (the CSR is sorted by relation within a row), so a thread first sums
//   z = sum_e w_e * x[src_e] over the run (dr FMAs an edge) and applies the
//   block once per run (dr*dr FMAs), not per edge. A run cut by a
//   boundary applies W[r] in each part: the product is linear, so the
//   parts add up in the carry.
// * Latency: the feature loads of kBatch entries are all issued before the
//   first is used.
//
// The slice route (block_direction_slice_bf16 and its twin, x and W in
// bf16, the route of every shipped dataset): the walk's bf16 form moved
// ~1.05 GB through L2 on the full graph, ~0.78 GB of it W reloads, and
// took 0.335 ms against a 0.016 ms bound. All of W is small (R * B * dr *
// dr * 2 B = 1.19 MB at FB15k-237), and output blocks are independent, so:
// * Slices: a thread block serves one slice of bs output blocks
//   (blockIdx.y) and copies W[:, slice] for all R relations into shared
//   memory once (cp.async of the 16-byte chunks of W that hold a
//   relation's row of the slice: the row starts at any bf16 element, and
//   TMA, which needs 16-byte strides, cannot take it; each region keeps
//   the row's offset in its first chunk and is read with 2-byte loads,
//   whose 25-value, 50-byte lane stride meets distinct banks). bs, the
//   lanes of a walker and the slices are the host's plan
//   (ops/staircase2.block_direction_route): the largest bs whose R
//   regions and the CSR staging fit the 227 KB a block may have, and the
//   lanes of a walker a power of two >= bs (at least 4, at most 32),
//   chosen to idle the fewest lanes.
// * Walkers: the slice caps an SM at one thread block (FB15k-237: 182 KB
//   of W and 16 KB of staging), so each thread block runs 1024 threads
//   (512 above dr = 6) as walkers of `lanes` lanes, lane l owning output
//   block b0 + l, and each walker walks its own contiguous run of
//   sub-ranges with its own carries: 64 independent walkers an SM hide
//   the x gathers' latency that many small blocks hid in the walk
//   (block_slice_variants.py times 512 and 256). Thread blocks are as
//   many as fit the card at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor
//   x SMs), split over the slices, so W is read from L2 about once a
//   resident thread block, not once a relation run.
// * Staging: a walker keeps windows of `lanes` row ends and entries
//   (source, relation, weight) in shared memory, each lane loading its
//   element of the next window a window ahead. Shuffles with a walker's
//   mask compile to a MATCH and a collective fallback on every call, four
//   an entry; the windows' loads need none.
// * The same sums: a walker starts its run with an L-ary search of the
//   partition (one ballot a step), walks the merged list item by item and,
//   at every multiple of `items`, closes the open relation run and writes
//   the sub-range's carry exactly as the walk's block end does; so with
//   the walk's `items` it adds the same terms in the same order and gives
//   the same bits as block_direction_f32 on the widened inputs.
// * Loads: an entry's x slice is read with 4-byte loads where d is even
//   (dr + 1 or dr + 2 bf16 values a lane, the odd start shifted out), with
//   2-byte loads otherwise; kBatch entries' loads are in flight together.
// * Precision: x and W widened exactly from bf16 (the TPU kernel's
//   compute_dtype, relationprediction_tpu/ops/staircase2.py:683-689, twin
//   :711-716); the edge weights, products and sums f32, out f32.
//
// Both routes sum in f32 in CSR order. chip_smoke.py holds each output to
// a float64 sum within the rounding that the element's sum of |terms|
// allows an f32 sum, and the slice route bit for bit to the walk's f32
// entry point on the widened inputs.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <mutex>

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

// ---------------------------------------------------------------------------
// The slice route (bf16 x and W).
// ---------------------------------------------------------------------------

constexpr int kSliceMinLanes = 4;  // a multiple of every slice_batch
constexpr int kSliceMaxLanes = 32;

// Threads of a slice thread block: 1024 (32 warps, 64 registers a
// thread) up to dr = 6, the most warps an SM can hold to hide the
// gathers' latency; 512 above, where a thread's sums need more registers.
template <int DR>
__host__ __device__ constexpr int slice_threads() {
  return DR <= 6 ? 1024 : 512;
}

// Entries of a walker whose x loads are in flight together: fewer above
// dr = 3, where 64 registers a thread hold fewer values.
template <int DR>
__host__ __device__ constexpr int slice_batch() {
  return DR <= 3 ? 4 : 2;
}

// 16-byte chunks of one relation's region of a slice of bs blocks: the
// chunks of W that hold its bs * dr * dr bf16 values, which start at any
// even byte of a chunk.
__host__ __device__ inline int slice_region_chunks(int bs, int dr) {
  return (bs * dr * dr * 2 + 14 + 15) / 16;
}

// Threads of a slice thread block at a runtime dr.
inline int slice_threads_at(int dr) {
  return dr <= 6 ? slice_threads<1>() : slice_threads<8>();
}

// Dynamic shared memory of a slice launch: R regions of W, then each
// walker's windows, 16 bytes a thread (a row end, a source, a relation
// and a weight a lane).
inline int64_t slice_smem_bytes(int n_rel, int bs, int dr) {
  return 16 * (static_cast<int64_t>(n_rel) * slice_region_chunks(bs, dr) +
               slice_threads_at(dr));
}

__host__ __device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

inline bool aligned4(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 3u) == 0;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ float bf16_low(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_high(uint32_t w) {
  return __uint_as_float(w & 0xFFFF0000u);
}

// The lanes of one walker: `lanes` consecutive lanes of a warp.
struct Walker {
  unsigned mask;  // its lanes in the warp
  int lanes;      // a power of two
  int shift;      // log2(lanes)
  int base;       // its first lane in the warp
  int l;          // this thread's lane in the walker
};

// merge_path::rows_before for a walker, all its lanes alike: an L-ary
// search, lane l probing p_l = min(lo + l * step, hi - 1) with step =
// ceil(span / L); the probes below `diag` are a prefix of the lanes,
// counted by one ballot, and the next span is at most step.
__device__ __forceinline__ int walker_rows_before(
    const Walker& w, const int* __restrict__ row_ptr, int n_rows,
    int n_edges, int diag) {
  int lo = max(diag - n_edges, 0);
  int hi = min(diag, n_rows);
  const unsigned own = w.lanes == 32 ? 0xFFFFFFFFu : (1u << w.lanes) - 1u;
  while (lo < hi) {
    const int step = (hi - lo + w.lanes - 1) >> w.shift;
    const int p = min(lo + w.l * step, hi - 1);
    const bool below = __ldg(row_ptr + p + 1) + p < diag;
    const int c = __popc((__ballot_sync(w.mask, below) >> w.base) & own);
    if (c == 0) {
      hi = lo;
    } else {
      const int last_below = min(lo + (c - 1) * step, hi - 1);
      if (c < w.lanes) hi = min(lo + c * step, hi - 1);
      lo = last_below + 1;
    }
  }
  return lo;
}

// y += W[rel] (this lane's block, transposed with kTransposeW) @ z from
// the slice in shared memory, then z = 0; a negative rel adds nothing.
template <int DR, bool kTransposeW>
__device__ __forceinline__ void apply_slice(const uint16_t* __restrict__ s_w,
                                            int rel, int region_u16,
                                            int n_blocks, int b0, int l,
                                            float (&z)[DR], float (&y)[DR]) {
  if (rel >= 0) {
    // The region's first value sits where it sits in its chunk of W.
    const int phase = ((rel * n_blocks + b0) * (DR * DR)) & 7;
    const uint16_t* wb = s_w + rel * region_u16 + phase + l * (DR * DR);
#pragma unroll
    for (int i = 0; i < DR; ++i) {
#pragma unroll
      for (int j = 0; j < DR; ++j) {
        const int at = kTransposeW ? j * DR + i : i * DR + j;
        y[i] = fmaf(__uint_as_float(static_cast<uint32_t>(wb[at]) << 16),
                    z[j], y[i]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < DR; ++j) z[j] = 0.f;
}

// The lane's dr features of x row s from element `at` = s * d + col, as
// f32; zeros unless `live`. With `words` (d even, x 4-byte aligned) as
// 4-byte loads within the row, else as 2-byte loads.
template <int DR>
__device__ __forceinline__ void load_x(const uint16_t* __restrict__ x,
                                       int64_t at, bool words, bool live,
                                       float (&v)[DR]) {
  if (!live) {
#pragma unroll
    for (int e = 0; e < DR; ++e) v[e] = 0.f;
    return;
  }
  if (words) {
    constexpr int kWords = (DR + 2) / 2;
    const uint32_t* p = reinterpret_cast<const uint32_t*>(x) + (at >> 1);
    const bool odd = (at & 1) != 0;
    const int need = (static_cast<int>(odd) + DR + 1) >> 1;
    uint32_t u[kWords];
#pragma unroll
    for (int k = 0; k < kWords; ++k) u[k] = k < need ? __ldg(p + k) : 0u;
#pragma unroll
    for (int e = 0; e < DR; ++e) {
      // Element e is half e of u when `at` is even, half e + 1 when odd.
      const float even = (e & 1) ? bf16_high(u[e >> 1]) : bf16_low(u[e >> 1]);
      const float odd_v = ((e + 1) & 1) ? bf16_high(u[(e + 1) >> 1])
                                        : bf16_low(u[(e + 1) >> 1]);
      v[e] = odd ? odd_v : even;
    }
    return;
  }
#pragma unroll
  for (int e = 0; e < DR; ++e) v[e] = merge_path::load_f32(x + at + e);
}

template <int DR, bool kTransposeW>
__global__ void __launch_bounds__(slice_threads<DR>(), 1)
block_slice_kernel(const uint16_t* __restrict__ x,
                   const uint16_t* __restrict__ blocks,
                   const int* __restrict__ row_ptr,
                   const int* __restrict__ src,
                   const int* __restrict__ rel,
                   const float* __restrict__ wt, float* __restrict__ out,
                   int* __restrict__ carry_row, float* __restrict__ carry,
                   int n_rows, int n_edges, int n_blocks, int n_rel,
                   int items, int bs, int lanes, bool x_words) {
  extern __shared__ uint4 s_chunks[];
  constexpr int kBatch = slice_batch<DR>();
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int b0 = blockIdx.y * bs;
  const int bs_here = min(bs, n_blocks - b0);
  const int region = slice_region_chunks(bs, DR);

  // 1. The 16-byte chunks of W that hold W[:, b0 .. b0 + bs_here) of
  // every relation into shared memory, asynchronously: one warp a
  // relation, consecutive chunks per lane (W is 16-byte aligned).
  {
    const uint4* w_chunks = reinterpret_cast<const uint4*>(blocks);
    const int64_t total_el = static_cast<int64_t>(n_rel) * n_blocks * DR * DR;
    const int n_el = bs_here * DR * DR;
    for (int r = t >> 5; r < n_rel; r += blockDim.x >> 5) {
      const int64_t g0 = (static_cast<int64_t>(r) * n_blocks + b0) * (DR * DR);
      const int64_t c0 = g0 >> 3;
      const int64_t c1 = (g0 + n_el - 1) >> 3;
      uint4* dst = s_chunks + static_cast<int64_t>(r) * region;
      for (int64_t q = c0 + lane; q <= c1; q += 32) {
        if (8 * q + 8 <= total_el) {
          cp_async16(dst + (q - c0), w_chunks + q);
        } else {  // the chunk at W's end, value by value
          uint16_t* d16 = reinterpret_cast<uint16_t*>(dst + (q - c0));
          for (int k = 0; k < 8; ++k) {
            d16[k] = 8 * q + k < total_el ? blocks[8 * q + k] : 0;
          }
        }
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }

  // 2. This walker's sub-ranges: the thread block's share of the partition
  // (blockIdx.x), then the walker's contiguous part of it.
  Walker w;
  w.lanes = lanes;
  w.shift = __ffs(lanes) - 1;
  w.base = lane & ~(lanes - 1);
  w.l = lane & (lanes - 1);
  w.mask = lanes == 32 ? 0xFFFFFFFFu : ((1u << lanes) - 1u) << w.base;
  const int walkers = blockDim.x >> w.shift;
  const int walker = t >> w.shift;
  const int total = n_rows + n_edges;
  const int n_sub = static_cast<int>(
      (static_cast<int64_t>(total) + items - 1) / items);
  const int per_block = (n_sub + gridDim.x - 1) / gridDim.x;
  const int kb0 = static_cast<int>(
      min64(static_cast<int64_t>(blockIdx.x) * per_block, n_sub));
  const int kb1 = min(kb0 + per_block, n_sub);
  const int per_walker = (kb1 - kb0 + walkers - 1) / walkers;
  const int k0 = min(kb0 + walker * per_walker, kb1);
  const int k1 = min(k0 + per_walker, kb1);
  const int d0 = static_cast<int>(
      min64(static_cast<int64_t>(k0) * items, total));
  const int d_end = static_cast<int>(
      min64(static_cast<int64_t>(k1) * items, total));
  // The search runs while the copy is in flight.
  const int i_start =
      k0 < k1 ? walker_rows_before(w, row_ptr, n_rows, n_edges, d0) : 0;

  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  if (k0 >= k1) return;

  const uint16_t* s_w = reinterpret_cast<const uint16_t*>(s_chunks);
  const int region_u16 = 8 * region;
  const int d = n_blocks * DR;
  const int l = w.l;
  const bool owner = l < bs_here;
  const int col = (b0 + l) * DR;

  int i = i_start;        // the row in progress, or the next to end
  int j = d0 - i_start;   // the next entry
  int pos = d0;           // items taken
  int row_start = __ldg(row_ptr + i);
  // The walker's windows in shared memory (after W's regions): the ends
  // of rows rbase .. rbase + lanes - 1 (INT_MAX past the last row), and
  // the sources, relations and weights of entries ebase .. ebase + lanes
  // - 1. Each lane loads its element of the next window into registers a
  // window ahead. i and j advance one at a time, and j by kBatch a batch
  // (lanes is a multiple of kBatch), so each window is left exactly at
  // its end.
  int* st_end = reinterpret_cast<int*>(s_chunks + n_rel * region) +
                4 * lanes * walker;
  int* st_src = st_end + lanes;
  int* st_rel = st_src + lanes;
  float* st_w = reinterpret_cast<float*>(st_rel + lanes);
  auto row_end_at = [&](int v) {
    return v < n_rows ? __ldg(row_ptr + v + 1) : INT_MAX;
  };
  int nx_src, nx_rel;
  float nx_w;
  auto load_entry = [&](int q) {
    const bool in = q < n_edges;
    nx_src = in ? __ldg(src + q) : 0;
    nx_rel = in ? __ldg(rel + q) : -1;
    nx_w = in ? __ldg(wt + q) : 0.f;
  };
  int rbase = i;
  int ebase = j;
  st_end[l] = row_end_at(rbase + l);
  int nx_end = row_end_at(rbase + lanes + l);
  load_entry(ebase + l);
  st_src[l] = nx_src;
  st_rel[l] = nx_rel;
  st_w[l] = nx_w;
  load_entry(ebase + lanes + l);
  __syncwarp(w.mask);
  int row_end = st_end[0];

  float y[DR], z[DR];
#pragma unroll
  for (int e = 0; e < DR; ++e) {
    y[e] = 0.f;
    z[e] = 0.f;
  }
  int run_rel = -1;  // relation of the open run, -1 for none
  int b = k0;        // the sub-range in progress
  int cut = static_cast<int>(min64(static_cast<int64_t>(d0) + items, d_end));

  // The end of sub-range b: what the walk's block end does.
  auto close_subrange = [&]() {
    if (owner) {
      apply_slice<DR, kTransposeW>(s_w, run_rel, region_u16, n_blocks, b0, l,
                                   z, y);
    }
    run_rel = -1;
    const bool has_carry = i < n_rows && j > row_start;
    if (l == 0 && blockIdx.y == 0) carry_row[b] = has_carry ? i : -1;
    if (has_carry && owner) {
      store<DR>(carry + static_cast<int64_t>(b) * d + col, y);
    }
    ++b;
    cut = static_cast<int>(min64(static_cast<int64_t>(cut) + items, d_end));
  };

  while (pos < d_end) {
    if (j == ebase + lanes) {  // into the next window; load the one after
      ebase = j;
      __syncwarp(w.mask);
      st_src[l] = nx_src;
      st_rel[l] = nx_rel;
      st_w[l] = nx_w;
      load_entry(ebase + lanes + l);
      __syncwarp(w.mask);
    }
    float xv[kBatch][DR];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int s = st_src[j + u - ebase];
      load_x<DR>(x, static_cast<int64_t>(s) * d + col, x_words,
                 owner && j + u < n_edges, xv[u]);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      while (pos < d_end && j >= row_end) {  // row i ends before entry j
        if (owner) {
          apply_slice<DR, kTransposeW>(s_w, run_rel, region_u16, n_blocks,
                                       b0, l, z, y);
          store<DR>(out + static_cast<int64_t>(i) * d + col, y);
        }
        run_rel = -1;
        row_start = row_end;
        ++i;
        if (i == rbase + lanes) {
          rbase = i;
          __syncwarp(w.mask);
          st_end[l] = nx_end;
          nx_end = row_end_at(rbase + lanes + l);
          __syncwarp(w.mask);
        }
        row_end = st_end[i - rbase];
        if (++pos == cut) close_subrange();
      }
      if (pos >= d_end) break;
      const int rq = st_rel[j - ebase];
      const float wq = st_w[j - ebase];
      if (rq != run_rel) {
        if (owner) {
          apply_slice<DR, kTransposeW>(s_w, run_rel, region_u16, n_blocks,
                                       b0, l, z, y);
        }
        run_rel = rq;
      }
#pragma unroll
      for (int e = 0; e < DR; ++e) z[e] = fmaf(wq, xv[u][e], z[e]);
      ++j;
      if (++pos == cut) close_subrange();
    }
  }
}

// Thread blocks of the slice kernel the card holds at once with `smem`
// bytes of shared memory each (SMs x blocks an SM), or a negative CUDA
// error; sets the kernel's dynamic shared memory limit to `smem`.
template <int DR, bool kTransposeW>
int64_t slice_fit(int64_t smem, int device) {
  int optin = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  if (err != cudaSuccess) return -static_cast<int64_t>(err);
  if (smem > optin) return -static_cast<int64_t>(cudaErrorInvalidValue);
  auto kernel = block_slice_kernel<DR, kTransposeW>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, slice_threads<DR>(), static_cast<size_t>(smem));
  }
  if (err != cudaSuccess) return -static_cast<int64_t>(err);
  if (per_sm < 1) {
    return -static_cast<int64_t>(cudaErrorInvalidConfiguration);
  }
  return static_cast<int64_t>(sms) * per_sm;
}

// Thread blocks of one slice launch along the partition: as many as fit
// the card at once, split over the slices, at most one a sub-range; or a
// negative CUDA error. The device's limits and the kernel's occupancy at
// the last (device, smem) asked are kept, so a launch makes no query.
template <int DR, bool kTransposeW>
int64_t slice_chunks(int n_sub, int n_slices, int64_t smem, int device) {
  struct Fit {
    int device = -1;
    int64_t smem = -1;
    int64_t resident = 0;  // thread blocks the card holds at once, or error
  };
  static std::mutex lock;
  static Fit last;
  int64_t resident;
  {
    std::lock_guard<std::mutex> hold(lock);
    if (last.device != device || last.smem != smem) {
      last = Fit{device, smem, slice_fit<DR, kTransposeW>(smem, device)};
    }
    resident = last.resident;
  }
  if (resident < 0) return resident;
  const int64_t chunks = resident / n_slices;
  return chunks < 1 ? 1 : (chunks > n_sub ? n_sub : chunks);
}

template <int DR, bool kTransposeW>
int launch_slice(const uint16_t* x, const uint16_t* blocks,
                 const int* row_ptr, const int* src, const int* rel,
                 const float* w, float* out, int* carry_row, float* carry,
                 int n_rows, int n_edges, int n_blocks, int n_rel, int items,
                 int bs, int lanes, int device, cudaStream_t s) {
  const int64_t n_sub = merge_path::grid_blocks(n_rows, n_edges, items);
  if (n_sub < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int n_slices = (n_blocks + bs - 1) / bs;
  const int64_t smem = slice_smem_bytes(n_rel, bs, DR);
  const int64_t chunks = slice_chunks<DR, kTransposeW>(
      static_cast<int>(n_sub), n_slices, smem, device);
  if (chunks < 0) return static_cast<int>(-chunks);
  const int d = n_blocks * DR;
  const bool x_words = d % 2 == 0 && aligned4(x);
  block_slice_kernel<DR, kTransposeW>
      <<<dim3(static_cast<unsigned>(chunks), static_cast<unsigned>(n_slices)),
         slice_threads<DR>(), static_cast<size_t>(smem), s>>>(
          x, blocks, row_ptr, src, rel, w, out, carry_row, carry, n_rows,
          n_edges, n_blocks, n_rel, items, bs, lanes, x_words);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (d % 4 == 0 && merge_path::aligned16(out) &&
      merge_path::aligned16(carry)) {
    return merge_path::launch_fixup(
        carry_row, reinterpret_cast<const float4*>(carry),
        reinterpret_cast<float4*>(out), static_cast<int>(n_sub), d / 4, s);
  }
  return merge_path::launch_fixup(carry_row, carry, out,
                                  static_cast<int>(n_sub), d, s);
}

// The checks of the slice entry points, 0 when they pass.
int slice_args_error(const void* blocks, int n_rows, int n_edges,
                     int n_blocks, int dr, int n_rel, int items, int bs,
                     int lanes) {
  const bool lanes_ok = lanes >= kSliceMinLanes && lanes <= kSliceMaxLanes &&
                        (lanes & (lanes - 1)) == 0;
  if (n_rows < 0 || n_edges < 0 || n_blocks < 1 || n_blocks > kMaxBlocks ||
      dr < 1 || dr > 8 || n_rel < 1 || items < 1 || items > kMaxItems ||
      !lanes_ok || bs < 1 || bs > lanes ||
      static_cast<int64_t>(n_rows) + n_edges > INT_MAX ||
      !merge_path::aligned16(blocks)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

template <bool kTransposeW>
int dispatch_slice(const uint16_t* x, const uint16_t* blocks,
                   const int* row_ptr, const int* src, const int* rel,
                   const float* w, float* out, int* carry_row, float* carry,
                   int n_rows, int n_edges, int n_blocks, int dr, int n_rel,
                   int items, int bs, int lanes, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int bad = slice_args_error(blocks, n_rows, n_edges, n_blocks, dr,
                                   n_rel, items, bs, lanes);
  if (bad != 0) return bad;
  if (n_rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BLOCK_SLICE_CASE(DR)                                                \
  case DR:                                                                  \
    return launch_slice<DR, kTransposeW>(x, blocks, row_ptr, src, rel, w,   \
                                         out, carry_row, carry, n_rows,     \
                                         n_edges, n_blocks, n_rel, items,   \
                                         bs, lanes, device, s);
  switch (dr) {
    BLOCK_SLICE_CASE(1)
    BLOCK_SLICE_CASE(2)
    BLOCK_SLICE_CASE(3)
    BLOCK_SLICE_CASE(4)
    BLOCK_SLICE_CASE(5)
    BLOCK_SLICE_CASE(6)
    BLOCK_SLICE_CASE(7)
    BLOCK_SLICE_CASE(8)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef BLOCK_SLICE_CASE
}

template <bool kTransposeW>
int64_t chunks_of(int n_sub, int n_slices, int64_t smem, int dr,
                  int device) {
  switch (dr) {
    case 1: return slice_chunks<1, kTransposeW>(n_sub, n_slices, smem, device);
    case 2: return slice_chunks<2, kTransposeW>(n_sub, n_slices, smem, device);
    case 3: return slice_chunks<3, kTransposeW>(n_sub, n_slices, smem, device);
    case 4: return slice_chunks<4, kTransposeW>(n_sub, n_slices, smem, device);
    case 5: return slice_chunks<5, kTransposeW>(n_sub, n_slices, smem, device);
    case 6: return slice_chunks<6, kTransposeW>(n_sub, n_slices, smem, device);
    case 7: return slice_chunks<7, kTransposeW>(n_sub, n_slices, smem, device);
    case 8: return slice_chunks<8, kTransposeW>(n_sub, n_slices, smem, device);
    default: return -static_cast<int64_t>(cudaErrorInvalidValue);
  }
}

template <bool kTransposeW>
int registers_of(int dr) {
  cudaFuncAttributes a{};
  cudaError_t err = cudaErrorInvalidValue;
  switch (dr) {
    case 1: err = cudaFuncGetAttributes(&a, block_slice_kernel<1, kTransposeW>); break;
    case 2: err = cudaFuncGetAttributes(&a, block_slice_kernel<2, kTransposeW>); break;
    case 3: err = cudaFuncGetAttributes(&a, block_slice_kernel<3, kTransposeW>); break;
    case 4: err = cudaFuncGetAttributes(&a, block_slice_kernel<4, kTransposeW>); break;
    case 5: err = cudaFuncGetAttributes(&a, block_slice_kernel<5, kTransposeW>); break;
    case 6: err = cudaFuncGetAttributes(&a, block_slice_kernel<6, kTransposeW>); break;
    case 7: err = cudaFuncGetAttributes(&a, block_slice_kernel<7, kTransposeW>); break;
    case 8: err = cudaFuncGetAttributes(&a, block_slice_kernel<8, kTransposeW>); break;
    default: break;
  }
  return err == cudaSuccess ? a.numRegs : -1;
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

// The slice route: block_direction_bf16's function on n_rel relations,
// the thread blocks of blockIdx.y = s serving output blocks [s * bs,
// min((s + 1) * bs, n_blocks)) with W's slice in shared memory, walkers of
// `lanes` lanes (a power of two in [block_direction_slice_min_lanes(), 32],
// bs <= lanes). Arguments, scratch and result as block_direction_bf16's;
// blocks must be 16-byte aligned. cudaErrorInvalidValue also where the
// slice's shared memory, block_direction_slice_smem_bytes(n_rel, bs, dr),
// exceeds what a block may have.
int block_direction_slice_bf16(const void* x, const void* blocks,
                               const int* row_ptr, const int* src,
                               const int* rel, const float* w, float* out,
                               int* carry_row, float* carry, int n_rows,
                               int n_edges, int n_blocks, int dr, int n_rel,
                               int items, int bs, int lanes, int device,
                               void* stream) {
  return dispatch_slice<false>(
      static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(blocks),
      row_ptr, src, rel, w, out, carry_row, carry, n_rows, n_edges, n_blocks,
      dr, n_rel, items, bs, lanes, device, stream);
}

// Its twin: W[r, b, j, i] for W[r, b, i, j].
int block_direction_twin_slice_bf16(const void* x, const void* blocks,
                                    const int* row_ptr, const int* src,
                                    const int* rel, const float* w,
                                    float* out, int* carry_row, float* carry,
                                    int n_rows, int n_edges, int n_blocks,
                                    int dr, int n_rel, int items, int bs,
                                    int lanes, int device, void* stream) {
  return dispatch_slice<true>(
      static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(blocks),
      row_ptr, src, rel, w, out, carry_row, carry, n_rows, n_edges, n_blocks,
      dr, n_rel, items, bs, lanes, device, stream);
}

// Dynamic shared memory of a slice launch: R regions of
// ceil((2 * bs * dr * dr + 14) / 16) 16-byte chunks, and 16 bytes a
// thread of block_direction_slice_threads(dr) for the walkers' windows.
long long block_direction_slice_smem_bytes(int n_rel, int bs, int dr) {
  return slice_smem_bytes(n_rel, bs, dr);
}

// Threads of a slice thread block at dr.
int block_direction_slice_threads(int dr) { return slice_threads_at(dr); }
int block_direction_slice_min_lanes() { return kSliceMinLanes; }

// Thread blocks along the partition of a slice launch (its grid is that
// by the slices), or a negative CUDA error.
long long block_direction_slice_chunks(int n_rows, int n_edges, int n_blocks,
                                       int dr, int n_rel, int items, int bs,
                                       int twin, int device) {
  const int64_t n_sub = merge_path::grid_blocks(n_rows, n_edges, items);
  if (n_sub < 1 || bs < 1) return -static_cast<int64_t>(cudaErrorInvalidValue);
  const int n_slices = (n_blocks + bs - 1) / bs;
  const int64_t smem = slice_smem_bytes(n_rel, bs, dr);
  return twin ? chunks_of<true>(static_cast<int>(n_sub), n_slices, smem, dr,
                                device)
              : chunks_of<false>(static_cast<int>(n_sub), n_slices, smem, dr,
                                 device);
}

// Registers a thread of the slice kernel at dr takes, or -1.
int block_direction_slice_registers(int dr, int twin) {
  return twin ? registers_of<true>(dr) : registers_of<false>(dr);
}

const char* block_direction_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
