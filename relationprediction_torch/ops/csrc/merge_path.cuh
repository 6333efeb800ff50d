// The merge-path partition of a CSR and its carry fix-up, and the loads of
// f32 and bf16 inputs as f32, for sm_90a; included by the port's three CSR
// kernels (staircase.cu, block_direction.cu, basis_direction.cu), each
// built into its own library.
//
// Merge-based CSR SpMM (Merrill and Garland, "Merge-based Parallel Sparse
// Matrix-Vector Multiplication", SC'16):
// * The partition. The merged list is the n_rows row ends and the E
//   entries, row end v coming after row v's entries (entry k comes first
//   iff k < row_ptr[v + 1]). Block b takes the items [b * items,
//   (b + 1) * items) of it and finds where that range starts and ends, as
//   (rows ended, entries taken), by a binary search over row_ptr on its
//   two diagonals (find_range). A hub row is cut across blocks; a run of
//   empty rows costs a block one item a row; every block has the same
//   work. The grid is ceil((n_rows + E) / items) blocks, known from sizes
//   alone (grid_blocks).
// * Inside a block (the kernel's own loop). It walks its entries in CSR
//   order and writes each row that ends in its range once: the full sum of
//   a row that began there, the block's partial sum of a row that began in
//   an earlier block, zeros for an empty row.
// * Rows cut by a block boundary are finished without atomics. Block b
//   writes a carry, the row in progress at its end (carry_row[b], -1 if
//   none) and its partial sum of that row (carry[b, :]). The carries of a
//   row sit in consecutive slots, since a row's blocks are consecutive.
//   carry_fixup_kernel, launched after every partitioned launch (no host
//   sync to see whether carries exist), lets the slot that heads each run
//   add the run's carries in block order and then the partial that the
//   row's last block wrote to out. The order is fixed, so two launches on
//   the same inputs give the same bits.
//
// relationprediction_torch/ops/staircase.py states the partition in Python
// (merge_path_split, merge_path_carry_rows) for the tests and
// chip_smoke.py.

#pragma once

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace merge_path {

constexpr int kFixupThreads = 128;  // fix-up threads, across the columns
constexpr int kFixupBatch = 8;      // carries whose loads are in flight

__device__ __forceinline__ float zero_of(float) { return 0.f; }
__device__ __forceinline__ float4 zero_of(float4) {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}
__device__ __forceinline__ void axpy(float a, float x, float& acc) {
  acc = fmaf(a, x, acc);
}
__device__ __forceinline__ void axpy(float a, float4 x, float4& acc) {
  acc.x = fmaf(a, x.x, acc.x);
  acc.y = fmaf(a, x.y, acc.y);
  acc.z = fmaf(a, x.z, acc.z);
  acc.w = fmaf(a, x.w, acc.w);
}
// A gathered element or vector as f32: f32 as it is; bf16 (uint16_t, and
// uint2 for four) widened exactly, its bits the high half of an f32's.
// The bf16-input kernels read their tables through these, so their
// products and sums are f32 as in the f32 kernels.
__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float4 load_f32(const float4* p) {
  return __ldg(p);
}
__device__ __forceinline__ float load_f32(const uint16_t* p) {
  return __uint_as_float(static_cast<uint32_t>(__ldg(p)) << 16);
}
__device__ __forceinline__ float4 load_f32(const uint2* p) {
  const uint2 v = __ldg(p);
  return make_float4(__uint_as_float(v.x << 16),
                     __uint_as_float(v.x & 0xFFFF0000u),
                     __uint_as_float(v.y << 16),
                     __uint_as_float(v.y & 0xFFFF0000u));
}

__device__ __forceinline__ void add(float x, float& acc) { acc += x; }
__device__ __forceinline__ void add(float4 x, float4& acc) {
  acc.x += x.x;
  acc.y += x.y;
  acc.z += x.z;
  acc.w += x.w;
}

// Rows whose end comes before item `diag` of the merged list: the number
// of v with row_ptr[v + 1] + v < diag (row end v is item row_ptr[v+1] + v).
__device__ __forceinline__ int rows_before(const int* __restrict__ row_ptr,
                                           int n_rows, int n_edges,
                                           int diag) {
  int lo = max(diag - n_edges, 0);
  int hi = min(diag, n_rows);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(row_ptr + mid + 1) + mid < diag) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// A block's part of the merged list: rows i0 .. i1 - 1 end in it, entries
// j0 .. j1 - 1 are taken in it, and has_carry says that row i1 is in
// progress at its end (it has entries before j1).
struct Range {
  int i0, j0, i1, j1;
  bool has_carry;
};

// The range of block blockIdx.x, for every thread of the block: the two
// binary searches run on threads 0 and 32 (both on thread 0 in a block of
// one warp), then the block synchronises.
__device__ __forceinline__ Range find_range(const int* __restrict__ row_ptr,
                                            int n_rows, int n_edges,
                                            int items) {
  __shared__ int bounds[5];  // i0, j0, i1, j1, has_carry
  const int t = threadIdx.x;
  const int64_t total = static_cast<int64_t>(n_rows) + n_edges;
  const int64_t d0 = static_cast<int64_t>(blockIdx.x) * items;
  const int64_t d1 = d0 + items < total ? d0 + items : total;
  if (t == 0) {
    const int i0 = rows_before(row_ptr, n_rows, n_edges, static_cast<int>(d0));
    bounds[0] = i0;
    bounds[1] = static_cast<int>(d0) - i0;
  }
  if (t == (blockDim.x > 32 ? 32 : 0)) {
    const int i1 = rows_before(row_ptr, n_rows, n_edges, static_cast<int>(d1));
    const int j1 = static_cast<int>(d1) - i1;
    bounds[2] = i1;
    bounds[3] = j1;
    bounds[4] = i1 < n_rows && j1 > __ldg(row_ptr + i1);
  }
  __syncthreads();
  return Range{bounds[0], bounds[1], bounds[2], bounds[3], bounds[4] != 0};
}

// Thread blocks of one partitioned launch, or -1 where the merged list or
// the grid is too long for int32.
inline int64_t grid_blocks(int n_rows, int n_edges, int items) {
  const int64_t n =
      (static_cast<int64_t>(n_rows) + n_edges + items - 1) / items;
  return n > INT_MAX ? -1 : n;
}

// For each run of slots carrying the same row, its first slot adds the
// run's carries in block order, then the partial the row's last block
// wrote to out, and stores the sum in out. T is float4 (units = columns /
// 4) or float (units = columns).
template <typename T>
__global__ void __launch_bounds__(kFixupThreads)
carry_fixup_kernel(const int* __restrict__ carry_row,
                   const T* __restrict__ carry, T* __restrict__ out,
                   int n_blocks, int units) {
  const int b = blockIdx.x;
  const int row = carry_row[b];
  if (row < 0 || (b > 0 && carry_row[b - 1] == row)) return;
  const int u = blockIdx.y * kFixupThreads + threadIdx.x;
  if (u >= units) return;
  T sum = carry[static_cast<int64_t>(b) * units + u];
  int c = b + 1;
  bool more = c < n_blocks && carry_row[c] == row;
  while (more) {  // kFixupBatch carries' loads in flight, in block order
    T v[kFixupBatch];
    int taken = 0;
#pragma unroll
    for (int i = 0; i < kFixupBatch; ++i) {
      more = more && c + i < n_blocks && carry_row[c + i] == row;
      v[i] = more ? carry[static_cast<int64_t>(c + i) * units + u]
                  : zero_of(T());
      taken += more;
    }
#pragma unroll
    for (int i = 0; i < kFixupBatch; ++i) {
      if (i < taken) add(v[i], sum);
    }
    c += taken;
    more = taken == kFixupBatch && c < n_blocks && carry_row[c] == row;
  }
  T* o = out + static_cast<int64_t>(row) * units + u;
  add(*o, sum);
  *o = sum;
}

// Launches the fix-up after a partitioned launch of n_blocks blocks;
// returns cudaGetLastError().
template <typename T>
int launch_fixup(const int* carry_row, const T* carry, T* out, int n_blocks,
                 int units, cudaStream_t s) {
  const int grid_y = (units + kFixupThreads - 1) / kFixupThreads;
  if (grid_y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(n_blocks),
                  static_cast<unsigned>(grid_y));
  carry_fixup_kernel<T><<<grid, kFixupThreads, 0, s>>>(carry_row, carry, out,
                                                       n_blocks, units);
  return static_cast<int>(cudaGetLastError());
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

inline bool aligned8(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 7u) == 0;
}

}  // namespace merge_path
