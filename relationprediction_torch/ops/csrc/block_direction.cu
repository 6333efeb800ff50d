// Relational block-diagonal aggregation, one direction, for sm_90a.
//
//   out[v] = sum over edges e with target v of  w_e * blockdiag(W[r_e]) @ x[src_e]
//
// x [V, d] f32, W [R, B, dr, dr] f32 with d = B * dr, out [V, d] f32, in the
// orientation y[b*dr + i] = sum_j W[r, b, i, j] * x[b*dr + j].
//
// The twin pass (block_direction_twin_f32) is the same kernel reading W
// transposed, y[b*dr + i] = sum_j W[r, b, j, i] * x[b*dr + j]: run on a
// direction's twin CSR (rows are the edges' sources, x is the cotangent g of
// the output) it gives d features[u] = sum_{e: src_e = u} w_e W[r_e]^T g[tgt_e]
// without a transposed copy of W. It replaces the JAX VJP's second launch of
// the same TPU kernel on the twin layout with blocks_to_jmajor_T
// (relationprediction_tpu/ops/staircase2.py:698-723). In a train step the
// twin CSR has V rows but only ~15k edges: most rows are empty and write
// zeros, so the launch of V thread blocks, not bytes, may set its time.
//
// Replaces relationprediction_tpu/ops/staircase2.py:460-502
// (_make_block_kernel, launched by _call_block at :560-598). That kernel
// gathers pre-weighted source rows into TPU slots, expands each slot group's
// relation weights with a one-hot MXU matmul, transforms on a j-major lane
// layout and adds into 256-row output blocks with a one-hot matmul, which a
// segment-sum then finishes. None of that carries over:
//
// * Layout: one CSR per direction, by target, sorted by relation within a row
//   (relationprediction_torch/graph.py). One thread block owns one target row
//   and writes it once: no atomics and no finishing pass; an empty row writes
//   zeros.
// * Work split: thread b of a lane owns output block b (dr features). The
//   kLanes lanes of a thread block take contiguous parts of the row's edges
//   and add their partial sums through shared memory at the end.
// * Relation runs: the edges of one (target, relation) pair share W[r], so a
//   lane first sums z = sum_e w_e * x[src_e] over the run (dr FMAs a thread
//   per edge) and applies the block once per run (dr*dr FMAs), not per edge.
// * Latency: the index and feature loads of kBatch edges are all issued
//   before the first is used.
// * Precision: f32 throughout, as the TPU kernel. A twin row sums up to
//   ~9k terms whose weights are not 1/degree of that row, so its partial
//   sums reach tens while the result may be near 0 and its rounding error
//   ~1e-4. chip_smoke.py holds each output to a float64 sum within the
//   rounding that the element's sum of |terms| allows an f32 sum.
//
// What bounds it on an H100: a launch must read x, W and the CSR once and
// write out once (about 64 MB at FB15k-237 width, ~19 us at 3.35 TB/s;
// a training batch's 15k edges: ~41 MB, ~12 us); its 2*E*d + 2*P*d*dr f32
// operations (P relation runs) need less than that on the 67 TFLOP/s f32
// pipes, so the bound is set by bytes. x (29 MB at that width) fits the
// 50 MB L2, so the gathered rows are mostly L2 hits. A hub row (about 9k
// edges at FB15k-237 scale) is summed by a single thread block and can set
// the time of the whole launch; splitting long rows over several blocks is
// not done here.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kLanes = 4;         // edge lanes per target row
constexpr int kBatch = 4;         // edges whose loads are in flight together
constexpr int kMaxBlocks = 128;   // B: one lane of at most 128 threads
constexpr int kMaxThreads = kLanes * kMaxBlocks;

template <int DR, bool kTransposeW>
__device__ __forceinline__ void apply_run(const float* __restrict__ blocks,
                                          int rel, int n_blocks, int b,
                                          float (&z)[DR], float (&y)[DR]) {
  if (rel >= 0) {
    const float* wb = blocks + (static_cast<int64_t>(rel) * n_blocks + b) *
                                   (DR * DR);
#pragma unroll
    for (int i = 0; i < DR; ++i) {
#pragma unroll
      for (int j = 0; j < DR; ++j) {
        const int at = kTransposeW ? j * DR + i : i * DR + j;
        y[i] = fmaf(__ldg(wb + at), z[j], y[i]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < DR; ++j) z[j] = 0.f;
}

template <int DR, bool kTransposeW>
__global__ void __launch_bounds__(kMaxThreads, 2)
block_direction_kernel(const float* __restrict__ x,
                       const float* __restrict__ blocks,
                       const int* __restrict__ row_ptr,
                       const int* __restrict__ src,
                       const int* __restrict__ rel,
                       const float* __restrict__ wt,
                       float* __restrict__ out, int n_blocks,
                       int lane_width) {
  extern __shared__ float partial[];  // [(kLanes - 1) * d]
  const int d = n_blocks * DR;
  const int row = blockIdx.x;
  const int lane = threadIdx.x / lane_width;
  const int b = threadIdx.x - lane * lane_width;
  const bool owner = b < n_blocks;
  const int64_t col = static_cast<int64_t>(b) * DR;

  const int start = row_ptr[row];
  const int len = row_ptr[row + 1] - start;
  const int e_begin = start + static_cast<int>(
                                  static_cast<int64_t>(len) * lane / kLanes);
  const int e_end = start + static_cast<int>(
                                static_cast<int64_t>(len) * (lane + 1) /
                                kLanes);

  float y[DR], z[DR];
#pragma unroll
  for (int i = 0; i < DR; ++i) {
    y[i] = 0.f;
    z[i] = 0.f;
  }
  int run_rel = -1;

  for (int e = e_begin; e < e_end; e += kBatch) {
    int s[kBatch], r[kBatch];
    float w[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const bool live = e + u < e_end;
      s[u] = live ? __ldg(src + e + u) : 0;
      r[u] = live ? __ldg(rel + e + u) : 0;
      w[u] = live ? __ldg(wt + e + u) : 0.f;
    }
    float xv[kBatch][DR];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const bool live = owner && e + u < e_end;
      const float* xs = x + static_cast<int64_t>(s[u]) * d + col;
#pragma unroll
      for (int j = 0; j < DR; ++j) xv[u][j] = live ? __ldg(xs + j) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (e + u < e_end) {
        if (r[u] != run_rel) {
          if (owner) {
            apply_run<DR, kTransposeW>(blocks, run_rel, n_blocks, b, z, y);
          }
          run_rel = r[u];
        }
#pragma unroll
        for (int j = 0; j < DR; ++j) z[j] = fmaf(w[u], xv[u][j], z[j]);
      }
    }
  }
  if (owner) apply_run<DR, kTransposeW>(blocks, run_rel, n_blocks, b, z, y);

  if (lane > 0 && owner) {
    float* p = partial + static_cast<int64_t>(lane - 1) * d + col;
#pragma unroll
    for (int i = 0; i < DR; ++i) p[i] = y[i];
  }
  __syncthreads();
  if (lane == 0 && owner) {
    for (int l = 1; l < kLanes; ++l) {
      const float* p = partial + static_cast<int64_t>(l - 1) * d + col;
#pragma unroll
      for (int i = 0; i < DR; ++i) y[i] += p[i];
    }
    float* o = out + static_cast<int64_t>(row) * d + col;
#pragma unroll
    for (int i = 0; i < DR; ++i) o[i] = y[i];
  }
}

template <int DR, bool kTransposeW>
int launch(const float* x, const float* blocks, const int* row_ptr,
           const int* src, const int* rel, const float* w, float* out,
           int n_rows, int n_blocks, cudaStream_t stream) {
  const int lane_width = (n_blocks + 31) / 32 * 32;
  const size_t smem = sizeof(float) * (kLanes - 1) * n_blocks * DR;
  block_direction_kernel<DR, kTransposeW>
      <<<n_rows, kLanes * lane_width, smem, stream>>>(
          x, blocks, row_ptr, src, rel, w, out, n_blocks, lane_width);
  return static_cast<int>(cudaGetLastError());
}

template <bool kTransposeW>
int dispatch(const float* x, const float* blocks, const int* row_ptr,
             const int* src, const int* rel, const float* w, float* out,
             int n_rows, int n_blocks, int dr, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_blocks < 1 || n_blocks > kMaxBlocks) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dr) {
    case 1: return launch<1, kTransposeW>(x, blocks, row_ptr, src, rel, w, out, n_rows, n_blocks, s);
    case 2: return launch<2, kTransposeW>(x, blocks, row_ptr, src, rel, w, out, n_rows, n_blocks, s);
    case 3: return launch<3, kTransposeW>(x, blocks, row_ptr, src, rel, w, out, n_rows, n_blocks, s);
    case 4: return launch<4, kTransposeW>(x, blocks, row_ptr, src, rel, w, out, n_rows, n_blocks, s);
    case 5: return launch<5, kTransposeW>(x, blocks, row_ptr, src, rel, w, out, n_rows, n_blocks, s);
    case 6: return launch<6, kTransposeW>(x, blocks, row_ptr, src, rel, w, out, n_rows, n_blocks, s);
    case 7: return launch<7, kTransposeW>(x, blocks, row_ptr, src, rel, w, out, n_rows, n_blocks, s);
    case 8: return launch<8, kTransposeW>(x, blocks, row_ptr, src, rel, w, out, n_rows, n_blocks, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Largest B the kernel takes; the Python wrapper checks against it.
int block_direction_max_blocks() { return kMaxBlocks; }

// Launches on `stream` of `device`; returns cudaGetLastError() after the
// launch (0 on success). dr outside [1, 8] returns cudaErrorInvalidValue.
int block_direction_f32(const float* x, const float* blocks,
                        const int* row_ptr, const int* src, const int* rel,
                        const float* w, float* out, int n_rows, int n_blocks,
                        int dr, int device, void* stream) {
  return dispatch<false>(x, blocks, row_ptr, src, rel, w, out, n_rows,
                         n_blocks, dr, device, stream);
}

// The twin pass: the same launch reading W[r, b, j, i] for W[r, b, i, j].
int block_direction_twin_f32(const float* x, const float* blocks,
                             const int* row_ptr, const int* src,
                             const int* rel, const float* w, float* out,
                             int n_rows, int n_blocks, int dr, int device,
                             void* stream) {
  return dispatch<true>(x, blocks, row_ptr, src, rel, w, out, n_rows,
                        n_blocks, dr, device, stream);
}

const char* block_direction_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
