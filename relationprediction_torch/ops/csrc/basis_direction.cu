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
// basis_combine_f32: one thread block per output row, written once (no
// atomics; an empty row writes zeros). kLanes lanes of kColThreads threads
// take contiguous parts of the row's edges; thread t of a lane owns
// columns t, t + kColThreads, ... and adds the edge's B coefficient-scaled
// P values to them, the loads of kBatch edges in flight together; the
// lanes add their partial sums through shared memory at the end. Sums are
// f32, per edge in order of the CSR. Bound: bytes, each gathered P row
// (B * d_out floats, 10 KB at d=500, B=5) once, plus out, C and the CSR.
// A gathered row is read once per edge, not once per vertex, and P (145 MB
// at full width) does not fit the 50 MB L2, so the time is set by the
// gathers (2.7 GB on the full graph) and, for a hub row (about 9k edges at
// FB15k-237 scale, one thread block), by the bandwidth one SM can pull.
// Splitting long rows over several blocks is not done here.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// ---- basis_combine_f32 ------------------------------------------------

constexpr int kLanes = 4;          // edge lanes per output row
constexpr int kColThreads = 128;   // threads of a lane, over the columns
constexpr int kBatch = 2;          // edges whose loads are in flight together
constexpr int kMaxBases = 8;
constexpr int kMaxColsPerThread = 8;
constexpr int kMaxCols = kColThreads * kMaxColsPerThread;  // d_out <= 1024

template <int NB, int COLS>
__global__ void __launch_bounds__(kLanes * kColThreads)
basis_combine_kernel(const float* __restrict__ proj,
                     const float* __restrict__ coef,
                     const int* __restrict__ row_ptr,
                     const int* __restrict__ src,
                     const int* __restrict__ rel,
                     const float* __restrict__ wt,
                     float* __restrict__ out, int d_out) {
  extern __shared__ float partial[];  // [(kLanes - 1) * d_out]
  const int row = blockIdx.x;
  const int lane = threadIdx.x / kColThreads;
  const int t = threadIdx.x - lane * kColThreads;
  const int64_t pitch = static_cast<int64_t>(NB) * d_out;

  const int start = row_ptr[row];
  const int len = row_ptr[row + 1] - start;
  const int e_begin = start + static_cast<int>(
                                  static_cast<int64_t>(len) * lane / kLanes);
  const int e_end = start + static_cast<int>(
                                static_cast<int64_t>(len) * (lane + 1) /
                                kLanes);

  float y[COLS];
#pragma unroll
  for (int c = 0; c < COLS; ++c) y[c] = 0.f;

  for (int e = e_begin; e < e_end; e += kBatch) {
    float cb[kBatch][NB];
    int s[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const bool live = e + u < e_end;
      s[u] = live ? __ldg(src + e + u) : 0;
      const int r = live ? __ldg(rel + e + u) : 0;
      const float we = live ? __ldg(wt + e + u) : 0.f;
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        cb[u][b] = we * __ldg(coef + static_cast<int64_t>(r) * NB + b);
      }
    }
    float pv[kBatch][NB][COLS];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const bool live = e + u < e_end;
      const float* ps = proj + static_cast<int64_t>(s[u]) * pitch + t;
#pragma unroll
      for (int b = 0; b < NB; ++b) {
#pragma unroll
        for (int c = 0; c < COLS; ++c) {
          const int col = t + c * kColThreads;
          pv[u][b][c] = (live && col < d_out)
                            ? __ldg(ps + b * d_out + c * kColThreads)
                            : 0.f;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
#pragma unroll
      for (int b = 0; b < NB; ++b) {
#pragma unroll
        for (int c = 0; c < COLS; ++c) y[c] = fmaf(cb[u][b], pv[u][b][c], y[c]);
      }
    }
  }

  if (lane > 0) {
    float* pp = partial + static_cast<int64_t>(lane - 1) * d_out;
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      const int col = t + c * kColThreads;
      if (col < d_out) pp[col] = y[c];
    }
  }
  __syncthreads();
  if (lane == 0) {
    float* o = out + static_cast<int64_t>(row) * d_out;
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      const int col = t + c * kColThreads;
      if (col >= d_out) continue;
      float v = y[c];
      for (int l = 1; l < kLanes; ++l) {
        v += partial[static_cast<int64_t>(l - 1) * d_out + col];
      }
      o[col] = v;
    }
  }
}

template <int NB, int COLS>
int launch_combine(const float* proj, const float* coef, const int* row_ptr,
                   const int* src, const int* rel, const float* w, float* out,
                   int n_rows, int d_out, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (kLanes - 1) * d_out;
  basis_combine_kernel<NB, COLS>
      <<<n_rows, kLanes * kColThreads, smem, stream>>>(
          proj, coef, row_ptr, src, rel, w, out, d_out);
  return static_cast<int>(cudaGetLastError());
}

template <int NB>
int dispatch_cols(const float* proj, const float* coef, const int* row_ptr,
                  const int* src, const int* rel, const float* w, float* out,
                  int n_rows, int d_out, cudaStream_t s) {
  const int cols = (d_out + kColThreads - 1) / kColThreads;
  if (cols <= 1) return launch_combine<NB, 1>(proj, coef, row_ptr, src, rel, w, out, n_rows, d_out, s);
  if (cols <= 2) return launch_combine<NB, 2>(proj, coef, row_ptr, src, rel, w, out, n_rows, d_out, s);
  if (cols <= 4) return launch_combine<NB, 4>(proj, coef, row_ptr, src, rel, w, out, n_rows, d_out, s);
  return launch_combine<NB, 8>(proj, coef, row_ptr, src, rel, w, out, n_rows, d_out, s);
}

}  // namespace

extern "C" {

// Largest B and d_out basis_combine_f32 takes; the Python wrapper checks
// against them.
int basis_direction_max_bases() { return kMaxBases; }
int basis_direction_max_cols() { return kMaxCols; }

// out [n_rows, d_out] from proj [*, n_bases * d_out] and coef [R, n_bases]
// on a CSR of n_rows rows; n_bases outside [1, 8] or d_out outside
// [1, 1024] returns cudaErrorInvalidValue.
int basis_combine_f32(const float* proj, const float* coef,
                      const int* row_ptr, const int* src, const int* rel,
                      const float* w, float* out, int n_rows, int n_bases,
                      int d_out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (d_out < 1 || d_out > kMaxCols) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_bases) {
    case 1: return dispatch_cols<1>(proj, coef, row_ptr, src, rel, w, out, n_rows, d_out, s);
    case 2: return dispatch_cols<2>(proj, coef, row_ptr, src, rel, w, out, n_rows, d_out, s);
    case 3: return dispatch_cols<3>(proj, coef, row_ptr, src, rel, w, out, n_rows, d_out, s);
    case 4: return dispatch_cols<4>(proj, coef, row_ptr, src, rel, w, out, n_rows, d_out, s);
    case 5: return dispatch_cols<5>(proj, coef, row_ptr, src, rel, w, out, n_rows, d_out, s);
    case 6: return dispatch_cols<6>(proj, coef, row_ptr, src, rel, w, out, n_rows, d_out, s);
    case 7: return dispatch_cols<7>(proj, coef, row_ptr, src, rel, w, out, n_rows, d_out, s);
    case 8: return dispatch_cols<8>(proj, coef, row_ptr, src, rel, w, out, n_rows, d_out, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* basis_direction_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
