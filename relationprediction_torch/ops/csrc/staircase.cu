// Weighted segment sum of per-edge messages over a CSR, for sm_90a.
//
//   out[v, :] = sum over k in [row_ptr[v], row_ptr[v+1]) of
//               w[k] * msgs[perm ? perm[k] : k, :]
//
// msgs [n_msgs, d] f32, perm [E] int32 or null, row_ptr [n_rows + 1]
// int32 with row_ptr[0] = 0 and row_ptr[n_rows] = E, w [E] f32 or null
// (every weight 1), out [n_rows, d] f32, all row-major and contiguous.
// Two C entry points, each launching two kernels (merge_path_kernel, then
// merge_path.cuh's carry_fixup_kernel): staircase_aggregate_f32, and
// staircase_aggregate_bf16 for bf16 msgs (the TPU kernels' compute_dtype,
// relationprediction_tpu/ops/staircase.py:263-266), which widens each
// message element to f32 as it loads it: the weights, the products and
// the sums stay f32, the output is f32, and the gather moves half the
// bytes.
//
// Replaces two TPU kernels:
// * relationprediction_tpu/ops/staircase.py:191 (_staircase_kernel,
//   launched by _staircase_call at :215-243; op staircase_aggregate at
//   :246-287). On the TPU the messages are first gathered into slot order
//   and weighted in XLA (msgs[perm] * w), then a sequential grid over
//   512-slot chunks adds onehot([128, C]) @ msgs([C, d]) into a VMEM row
//   block. Here the CSR by target (graph.py) is the layout: a row's entries
//   are contiguous, so they are summed directly. The one-hot product,
//   2 * 128 * d operations of mostly zeros an edge, is not carried over.
//   The model path builds its messages in each direction's CSR order, so
//   perm is null there and no gather is needed.
// * relationprediction_tpu/ops/staircase2.py:443 (_scatter_kernel,
//   launched by _call_scatter at :533-557; ops scatter2 and
//   scatter2_slot_order at :639-661): the same sum on the v2 slot layout.
//   Here scatter2 passes the CSR's `order` as perm (its messages come in
//   primary edge order), the fusion of the permutation into the gather
//   that the TPU op does in XLA; scatter2_slot_order passes messages in
//   CSR order with the weights already applied (perm and w null).
//
// Bound on an H100: bytes. Every message row is read once (E * d * 4:
// 544 MB for the full FB15k-237 graph at d = 500; 272 MB in bf16), out
// written once (29 MB), plus the CSR; 2 * E * d operations are far below
// the f32 rate.
// The graphs are skewed: hub rows of up to 9,155 entries (18 MB of
// messages) beside rows of one entry, and at the train shape (15,000
// entries) 2/3 of the 14,541 rows are empty.
//
// Design: the merge-path partition of merge_path.cuh (equal thread blocks
// of row ends + entries; rows cut by a block boundary finished by its carry
// fix-up in block order, no atomics), with the d columns across the threads
// of a block. The block's row ends, message indices and weights are staged
// in shared memory. 128 threads lie across the columns, each owning one
// float4 (d % 4 == 0 and 16-byte aligned pointers, 8-byte aligned bf16
// msgs; d = 500 gives 125 threads) or one float otherwise, with gridDim.y
// covering wider rows. The
// block walks its entries in CSR order, the loads of kBatch entries in
// flight together. Sums are f32, in CSR order.
//
// Cases that the tests and chip_smoke.py hold against the plain version:
// a row spanning dozens of blocks (a 9,155-entry hub at 256 items is ~36
// blocks); a block holding only row ends (a run of empty rows); a block
// whose range starts and ends inside one row (its carry is its whole
// sum); E = 0 (every row zero, no carries); every entry in one row;
// n_rows + E near int32 (the wrapper raises); the perm path's gathered
// rows; d % 4 != 0 (the scalar path).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "merge_path.cuh"

namespace {

using merge_path::axpy;
using merge_path::zero_of;

constexpr int kThreads = 128;   // threads of a block, across the columns
constexpr int kBatch = 8;       // entries whose loads are in flight together
constexpr int kMaxItems = 2048;  // staging: 3 ints an item, 24 KB at most

// T is float4 (units = d / 4) or float (units = d); In is the message
// element as stored, T itself for f32, uint2 (four bf16) or uint16_t (one
// bf16) for bf16. An entry whose message index falls outside [0, n_msgs)
// adds nothing; the wrapper's checks keep every index inside.
template <typename In, typename T>
__global__ void __launch_bounds__(kThreads)
merge_path_kernel(const In* __restrict__ msgs, const int* __restrict__ perm,
                  const int* __restrict__ row_ptr,
                  const float* __restrict__ w, T* __restrict__ out,
                  int* __restrict__ carry_row, T* __restrict__ carry,
                  int n_rows, int n_edges, int units, int n_msgs,
                  int items) {
  extern __shared__ int staged[];  // row ends, message indices, weights
  const int t = threadIdx.x;
  const int u = blockIdx.y * kThreads + t;
  const merge_path::Range g =
      merge_path::find_range(row_ptr, n_rows, n_edges, items);
  const int i0 = g.i0, j0 = g.j0, i1 = g.i1, j1 = g.j1;
  const int n_ends = i1 - i0;  // rows i0 .. i1 - 1 end in this block
  const int n_ent = j1 - j0;   // entries j0 .. j1 - 1 are taken here
  int* s_end = staged;
  int* s_idx = staged + items;
  float* s_w = reinterpret_cast<float*>(staged + 2 * items);
  for (int r = t; r < n_ends; r += kThreads) {
    s_end[r] = __ldg(row_ptr + i0 + r + 1);
  }
  for (int q = t; q < n_ent; q += kThreads) {
    const int k = j0 + q;
    s_idx[q] = perm ? __ldg(perm + k) : k;
    s_w[q] = w ? __ldg(w + k) : 1.f;
  }
  __syncthreads();

  const bool col = u < units;
  T acc = zero_of(T());
  int r = 0;  // row i0 + r takes the next entry
  int row_end = n_ends > 0 ? s_end[0] : INT_MAX;
  for (int q0 = 0; q0 < n_ent; q0 += kBatch) {
    T v[kBatch];
    float wk[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int q = q0 + b;
      const int idx = q < n_ent ? s_idx[q] : -1;
      wk[b] = q < n_ent ? s_w[q] : 0.f;
      v[b] = (col && idx >= 0 && idx < n_msgs)
                 ? merge_path::load_f32(msgs + static_cast<int64_t>(idx) *
                                                   units + u)
                 : zero_of(T());
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int q = q0 + b;
      if (q >= n_ent) break;
      while (j0 + q >= row_end) {  // row i0 + r ends before this entry
        if (col) out[static_cast<int64_t>(i0 + r) * units + u] = acc;
        acc = zero_of(T());
        ++r;
        row_end = r < n_ends ? s_end[r] : INT_MAX;
      }
      axpy(wk[b], v[b], acc);
    }
  }
  for (; r < n_ends; ++r) {  // rows ending after the block's last entry
    if (col) out[static_cast<int64_t>(i0 + r) * units + u] = acc;
    acc = zero_of(T());
  }
  // acc is now the block's part of row i1, in progress at its end.
  if (blockIdx.y == 0 && t == 0) carry_row[blockIdx.x] = g.has_carry ? i1 : -1;
  if (g.has_carry && col) {
    carry[static_cast<int64_t>(blockIdx.x) * units + u] = acc;
  }
}

template <typename In, typename T>
int launch(const In* msgs, const int* perm, const int* row_ptr,
           const float* w, T* out, int* carry_row, T* carry, int n_rows,
           int n_edges, int units, int n_msgs, int items, cudaStream_t s) {
  const int grid_y = (units + kThreads - 1) / kThreads;
  const int64_t n_blocks = merge_path::grid_blocks(n_rows, n_edges, items);
  if (grid_y > 65535 || n_blocks < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(n_blocks),
                  static_cast<unsigned>(grid_y));
  const size_t smem = sizeof(int) * 3 * static_cast<size_t>(items);
  merge_path_kernel<In, T><<<grid, kThreads, smem, s>>>(
      msgs, perm, row_ptr, w, out, carry_row, carry, n_rows, n_edges, units,
      n_msgs, items);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return merge_path::launch_fixup(carry_row, carry, out,
                                  static_cast<int>(n_blocks), units, s);
}

// Checks the sizes and launches on the f32 path (msgs f32) or the bf16
// one (msgs bf16): four elements a thread where d % 4 == 0 and the
// pointers allow it, else one.
template <bool kBf16>
int dispatch(const void* msgs, const int* perm, const int* row_ptr,
             const float* w, float* out, int* carry_row, float* carry,
             int n_rows, int n_edges, int d, int n_msgs, int items,
             int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_rows < 0 || n_edges < 0 || d < 1 || n_msgs < 0 || items < 1 ||
      items > kMaxItems ||
      static_cast<int64_t>(n_rows) + n_edges > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wide = d % 4 == 0 && merge_path::aligned16(out) &&
                    merge_path::aligned16(carry) &&
                    (kBf16 ? merge_path::aligned8(msgs)
                           : merge_path::aligned16(msgs));
  float4* out4 = reinterpret_cast<float4*>(out);
  float4* carry4 = reinterpret_cast<float4*>(carry);
  if (kBf16 && wide) {
    return launch(static_cast<const uint2*>(msgs), perm, row_ptr, w, out4,
                  carry_row, carry4, n_rows, n_edges, d / 4, n_msgs, items,
                  s);
  }
  if (kBf16) {
    return launch(static_cast<const uint16_t*>(msgs), perm, row_ptr, w, out,
                  carry_row, carry, n_rows, n_edges, d, n_msgs, items, s);
  }
  if (wide) {
    return launch(static_cast<const float4*>(msgs), perm, row_ptr, w, out4,
                  carry_row, carry4, n_rows, n_edges, d / 4, n_msgs, items,
                  s);
  }
  return launch(static_cast<const float*>(msgs), perm, row_ptr, w, out,
                carry_row, carry, n_rows, n_edges, d, n_msgs, items, s);
}

}  // namespace

extern "C" {

// Largest `items` a block takes; the Python wrapper checks against it.
int staircase_max_items() { return kMaxItems; }

// out [n_rows, d] on `stream` of `device`, with carry_row [n_blocks] int32
// and carry [n_blocks, d] f32 as scratch, n_blocks = ceil((n_rows +
// n_edges) / items); carry_row is left holding each block's carried row
// (-1 for none). Returns cudaGetLastError() after the launches (0 on
// success), cudaErrorInvalidValue for a negative size, d < 1, items
// outside [1, staircase_max_items()], n_rows + n_edges beyond int32 or a
// grid beyond the card's limits.
int staircase_aggregate_f32(const float* msgs, const int* perm,
                            const int* row_ptr, const float* w, float* out,
                            int* carry_row, float* carry, int n_rows,
                            int n_edges, int d, int n_msgs, int items,
                            int device, void* stream) {
  return dispatch<false>(msgs, perm, row_ptr, w, out, carry_row, carry,
                         n_rows, n_edges, d, n_msgs, items, device, stream);
}

// The same for msgs [n_msgs, d] bf16 (its bits as uint16_t).
int staircase_aggregate_bf16(const void* msgs, const int* perm,
                             const int* row_ptr, const float* w, float* out,
                             int* carry_row, float* carry, int n_rows,
                             int n_edges, int d, int n_msgs, int items,
                             int device, void* stream) {
  return dispatch<true>(msgs, perm, row_ptr, w, out, carry_row, carry,
                        n_rows, n_edges, d, n_msgs, items, device, stream);
}

const char* staircase_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
