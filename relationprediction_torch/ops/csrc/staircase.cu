// Weighted segment sum of per-edge messages over a CSR, for sm_90a.
//
//   out[v, :] = sum over k in [row_ptr[v], row_ptr[v+1]) of
//               w[k] * msgs[perm ? perm[k] : k, :]
//
// msgs [n_msgs, d] f32, perm [E] int32 or null, row_ptr [n_rows + 1]
// int32, w [E] f32 or null (every weight 1), out [n_rows, d] f32, all
// row-major and contiguous. One kernel, staircase_aggregate_f32.
//
// Replaces two TPU kernels:
// * relationprediction_tpu/ops/staircase.py:191 (_staircase_kernel,
//   launched by _staircase_call at :215-243; op staircase_aggregate at
//   :246-287). On the TPU the messages are first gathered into slot order
//   and weighted in XLA (msgs[perm] * w), then a sequential grid over
//   512-slot chunks adds onehot([128, C]) @ msgs([C, d]) into a VMEM row
//   block. Here the CSR by target (graph.py) is the layout: a row's entries
//   are contiguous, so one thread block sums its row directly. The one-hot
//   product, 2 * 128 * d operations of mostly zeros an edge, is not
//   carried over. The model path builds its messages in each direction's
//   CSR order, so perm is null there and no gather is needed.
// * relationprediction_tpu/ops/staircase2.py:443 (_scatter_kernel,
//   launched by _call_scatter at :533-557; ops scatter2 and
//   scatter2_slot_order at :639-661): the same sum on the v2 slot layout.
//   Here scatter2 passes the CSR's `order` as perm (its messages come in
//   primary edge order), the fusion of the permutation into the gather
//   that the TPU op does in XLA; scatter2_slot_order passes messages in
//   CSR order with the weights already applied (perm and w null).
//
// Design: one thread block per output row, written once (no atomics, no
// second pass; a row without entries writes zeros, since the wrapper
// allocates `out` with torch.empty). A block is kLanes lanes of 128
// threads. Threads of a lane lie across the columns, each owning one float4
// (d % 4 == 0 and 16-byte aligned msgs and out; d = 500 gives a 2,000-byte
// pitch) or one float otherwise, with gridDim.y covering wider rows. The
// lanes split the row's entries into kLanes contiguous parts; each thread
// keeps its sums in registers and walks its part in CSR order, the loads
// of kBatch entries in flight together, and the lanes add their sums
// through shared memory at the end. Sums are f32.
//
// A row costs one memory round trip per kLanes * kBatch entries, so the
// longest row sets a launch's time: the hub rows on the full graph, rows
// of ~640 entries at the train shape. On an H100, blocks of one lane
// with 4 entries in flight took 0.18 ms at the train shape; 4 lanes cut
// that chain by 4 (PERF.md).
//
// Bound on an H100: bytes. Every message row is read once (E * d * 4:
// 544 MB for the full FB15k-237 graph at d = 500), out written once
// (29 MB), plus the CSR; 2 * E * d operations are far below the f32 rate.
// Known limits: a hub row (up to 9,155 entries at FB15k-237 scale, 18 MB
// of messages) is pulled by one thread block on one SM, so on the full
// graph the few hub rows set the time; at the train shape (15,000 edges)
// about 2/3 of the 14,541 rows are empty and their blocks only write
// zeros. Splitting long rows over blocks and skipping empty ones is not
// done here.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;  // threads of a lane, across the columns
constexpr int kLanes = 4;      // lanes of a block, over the row's entries
constexpr int kBatch = 4;      // entries a thread has in flight together

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

// T is float4 (units = d / 4) or float (units = d). An entry whose message
// index falls outside [0, n_msgs) adds nothing; the wrapper's checks keep
// every index inside.
template <typename T>
__global__ void __launch_bounds__(kThreads * kLanes)
staircase_kernel(const T* __restrict__ msgs, const int* __restrict__ perm,
                 const int* __restrict__ row_ptr,
                 const float* __restrict__ w, T* __restrict__ out,
                 int units, int n_msgs) {
  __shared__ T partial[kLanes - 1][kThreads];
  const int row = blockIdx.x;
  const int lane = threadIdx.x / kThreads;
  const int t = threadIdx.x - lane * kThreads;
  const int u = blockIdx.y * kThreads + t;
  const int start = row_ptr[row];
  const int len = row_ptr[row + 1] - start;
  const int begin = start + static_cast<int>(
                                static_cast<int64_t>(len) * lane / kLanes);
  const int end = start + static_cast<int>(
                              static_cast<int64_t>(len) * (lane + 1) / kLanes);
  T acc = zero_of(T());
  if (u < units) {
    for (int k = begin; k < end; k += kBatch) {
      int idx[kBatch];
      float wk[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const bool live = k + b < end;
        idx[b] = live ? (perm ? __ldg(perm + k + b) : k + b) : -1;
        wk[b] = live ? (w ? __ldg(w + k + b) : 1.f) : 0.f;
      }
      T v[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        v[b] = (idx[b] >= 0 && idx[b] < n_msgs)
                   ? __ldg(msgs + static_cast<int64_t>(idx[b]) * units + u)
                   : zero_of(T());
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) axpy(wk[b], v[b], acc);
    }
  }
  if (lane > 0) partial[lane - 1][t] = acc;
  __syncthreads();
  if (lane > 0 || u >= units) return;
#pragma unroll
  for (int l = 0; l < kLanes - 1; ++l) axpy(1.f, partial[l][t], acc);
  out[static_cast<int64_t>(row) * units + u] = acc;
}

template <typename T>
int launch(const T* msgs, const int* perm, const int* row_ptr,
           const float* w, T* out, int n_rows, int units, int n_msgs,
           cudaStream_t s) {
  const int grid_y = (units + kThreads - 1) / kThreads;
  if (grid_y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(n_rows),
                  static_cast<unsigned>(grid_y));
  staircase_kernel<T><<<grid, kThreads * kLanes, 0, s>>>(
      msgs, perm, row_ptr, w, out, units, n_msgs);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

extern "C" {

// out [n_rows, d] on `stream` of `device`; returns cudaGetLastError()
// after the launch (0 on success), cudaErrorInvalidValue for a negative
// size, d < 1 or a grid beyond the card's limits.
int staircase_aggregate_f32(const float* msgs, const int* perm,
                            const int* row_ptr, const float* w, float* out,
                            int n_rows, int d, int n_msgs, int device,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_rows < 0 || d < 1 || n_msgs < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d % 4 == 0 && aligned16(msgs) && aligned16(out)) {
    return launch(reinterpret_cast<const float4*>(msgs), perm, row_ptr, w,
                  reinterpret_cast<float4*>(out), n_rows, d / 4, n_msgs, s);
  }
  return launch(msgs, perm, row_ptr, w, out, n_rows, d, n_msgs, s);
}

const char* staircase_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
