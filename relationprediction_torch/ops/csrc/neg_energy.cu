// Corruption energies of the factored binomial and split losses in
// float32, for sm_90a: a gather-dot (an SDDMM over a regular pattern, k
// entries a row) and the gradient of its factors.
//
//   energy[p, j] = sum_c codes[ids[p, j], c] * q_sel(p, j)[c]
//   ev_sq[p, j]  = sum_c codes[ids[p, j], c]^2
//   q_sel(p, j)  = q_obj[p] where coin[p, j], else q_subj[p]
//
// and, for the energies' cotangent g [n, k],
//
//   dq_subj[p] = sum over j with !coin[p, j] of g[p, j] * codes[ids[p, j]]
//   dq_obj[p]  = sum over j with  coin[p, j] of g[p, j] * codes[ids[p, j]]
//
// codes [V, d], q_subj / q_obj / dq_subj / dq_obj [n, d] f32, ids [n, k]
// int64, coin [n, k] bool (one byte each) or null (every entry scores
// against q_subj, the split loss; q_obj and dq_obj unused), energy and
// ev_sq [n, k] f32; all row-major and contiguous. Two C entry points, one
// kernel each: gather_dot_f32 (gather_dot_kernel) and gather_dot_grad_f32
// (gather_dot_grad_kernel). The codes' own gradient is not here: it is a
// sum by id, kernel 3 over the CSR by id (ops/neg_energy.py _code_grads).
//
// Replaces no TPU kernel. The JAX package leaves the float32 energies to
// XLA (relationprediction_tpu/ops/neg_energy.py, _direct: gather the
// [n, k, d] rows, reduce them against both factors, select by the coin).
// Written in PyTorch ops, that form writes the gathered rows, reads them
// twice, squares them into another [n, k, d] temporary, and autograd's
// backward writes several more, then adds them into the code table by id
// with index_put_'s sort-based kernel, which adds a repeated id's rows one
// after the other: ~12 GB moved a train step at n = 30,000, k = 10,
// d = 500 (600 MB a [n, k, d] tensor). Here no [n, k, d] tensor exists.
//
// Bound on an H100: bytes. The gather-dot reads n * k gathered rows (600
// MB at those shapes), q_subj and q_obj once (120 MB), the ids and the
// coins (3.3 MB), and writes the two outputs (2.4 MB): 0.22 ms at 3.35
// TB/s. Its compulsory bytes read the code table once instead of the
// gathered rows: 29 MB at V = 14,541 (FB15k-237), which stays in the 50 MB
// L2, 82 MB at V = 40,943 (WN18), which does not. The gradient reads the
// same gathered rows, g and the ids, and writes dq_subj and dq_obj. Two
// flops a gathered element are far below the f32 rate.
//
// Design: one warp per positive p, kWarps positives a block, the d
// columns across the lanes as float4 (d % 4 == 0 and 16-byte aligned
// pointers; d = 500 gives 125 units, at most 4 a lane) or as floats. The
// warp stages its entries' row offsets (and coins, cotangents) in shared
// memory, 32 at a time. The gather-dot walks the entries in batches of at
// most kRows, evened out (k = 10: two of 5); for each of its units a lane
// loads both factors' unit and the batch's rows' units together, all in
// flight before the first FMA, then adds each product to its entry's
// energy and each square to its ev_sq. The lanes' partial sums are added
// by shuffles in a fixed butterfly order, so every call gives the same
// bits. The gradient kernel holds each unit's two sums in registers while
// it walks the entries in order, kBatch rows' loads in flight together,
// and writes each unit once (k <= 32; beyond, each chunk of 32 entries
// adds to the unit in order). Every product and sum is an f32 FMA. An id
// outside [0, V) adds nothing; the wrapper's checks keep ids in range
// where the host can see them.

#include <cuda_runtime.h>

#include <cstdint>

#include "merge_path.cuh"

namespace {

using merge_path::axpy;
using merge_path::load_f32;
using merge_path::zero_of;

constexpr int kWarps = 8;               // positives a block
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 8;                // gather-dot rows in flight
constexpr int kBatch = 8;               // gradient rows in flight
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void dot_acc(float a, float b, float& acc) {
  acc = fmaf(a, b, acc);
}
__device__ __forceinline__ void dot_acc(float4 a, float4 b, float& acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  acc = fmaf(a.w, b.w, acc);
}

// The sum of the warp's 32 values, on every lane, in one fixed order.
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) x += __shfl_xor_sync(kFull, x, m);
  return x;
}

// Stages entries j0 .. j0 + m - 1 of positive p for the warp: each row's
// first unit in codes (-1 for an id outside [0, n_codes)), its coin and,
// where g is given, its cotangent.
__device__ __forceinline__ void stage(const int64_t* __restrict__ ids,
                                      const uint8_t* __restrict__ coin,
                                      const float* __restrict__ g,
                                      int64_t first, int m, int units,
                                      int64_t n_codes, int64_t* s_row,
                                      uint8_t* s_coin, float* s_g) {
  const int lane = threadIdx.x & 31;
  if (lane < m) {
    const int64_t id = __ldg(ids + first + lane);
    s_row[lane] = (id >= 0 && id < n_codes) ? id * units : -1;
    s_coin[lane] = coin ? __ldg(coin + first + lane) : 0;
    if (g) s_g[lane] = __ldg(g + first + lane);
  }
  __syncwarp();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gather_dot_kernel(const T* __restrict__ codes, const T* __restrict__ q_subj,
                  const T* __restrict__ q_obj,
                  const int64_t* __restrict__ ids,
                  const uint8_t* __restrict__ coin,
                  float* __restrict__ energy, float* __restrict__ ev_sq,
                  int n, int k, int units, int64_t n_codes) {
  __shared__ int64_t s_row[kWarps][32];
  __shared__ uint8_t s_coin[kWarps][32];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int p = blockIdx.x * kWarps + w;
  if (p >= n) return;  // the whole warp: no block-wide barrier follows
  const T* qs = q_subj + static_cast<int64_t>(p) * units;
  const T* qo = coin ? q_obj + static_cast<int64_t>(p) * units : qs;
  for (int j0 = 0; j0 < k; j0 += 32) {
    const int m = min(32, k - j0);
    const int64_t first = static_cast<int64_t>(p) * k + j0;
    stage(ids, coin, nullptr, first, m, units, n_codes, s_row[w], s_coin[w],
          nullptr);
    const int batches = (m + kRows - 1) / kRows;
    const int per = (m + batches - 1) / batches;
    for (int b0 = 0; b0 < m; b0 += per) {
      const int rows = min(per, m - b0);
      int64_t row[kRows];
      bool obj[kRows];
      float e[kRows], s[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        row[r] = r < rows ? s_row[w][b0 + r] : -1;
        obj[r] = r < rows && s_coin[w][b0 + r];
        e[r] = s[r] = 0.f;
      }
      for (int u = lane; u < units; u += 32) {
        const T a = load_f32(qs + u);
        const T o = load_f32(qo + u);
        T v[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          v[r] = row[r] >= 0 ? load_f32(codes + row[r] + u) : zero_of(T());
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          dot_acc(obj[r] ? o : a, v[r], e[r]);
          dot_acc(v[r], v[r], s[r]);
        }
      }
      // rows is the same on every lane of the warp, and every lane is
      // past the loop over units: the shuffles see the whole warp.
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r < rows) {
          e[r] = warp_sum(e[r]);
          s[r] = warp_sum(s[r]);
          if (lane == 0) {
            energy[first + b0 + r] = e[r];
            ev_sq[first + b0 + r] = s[r];
          }
        }
      }
    }
    __syncwarp();  // the next chunk restages s_row
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gather_dot_grad_kernel(const T* __restrict__ codes,
                       const int64_t* __restrict__ ids,
                       const uint8_t* __restrict__ coin,
                       const float* __restrict__ g, T* __restrict__ dq_subj,
                       T* __restrict__ dq_obj, int n, int k, int units,
                       int64_t n_codes) {
  __shared__ int64_t s_row[kWarps][32];
  __shared__ uint8_t s_coin[kWarps][32];
  __shared__ float s_g[kWarps][32];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int p = blockIdx.x * kWarps + w;
  if (p >= n) return;
  T* ds = dq_subj + static_cast<int64_t>(p) * units;
  T* dob = coin ? dq_obj + static_cast<int64_t>(p) * units : nullptr;
  for (int j0 = 0; j0 < k; j0 += 32) {
    const int m = min(32, k - j0);
    stage(ids, coin, g, static_cast<int64_t>(p) * k + j0, m, units, n_codes,
          s_row[w], s_coin[w], s_g[w]);
    for (int u = lane; u < units; u += 32) {
      T as = j0 > 0 ? ds[u] : zero_of(T());
      T ao = (dob && j0 > 0) ? dob[u] : zero_of(T());
      for (int q0 = 0; q0 < m; q0 += kBatch) {
        T v[kBatch];
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          const int64_t row = q0 + b < m ? s_row[w][q0 + b] : -1;
          v[b] = row >= 0 ? load_f32(codes + row + u) : zero_of(T());
        }
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          const int q = q0 + b;
          if (q >= m) break;
          if (s_coin[w][q]) {
            axpy(s_g[w][q], v[b], ao);
          } else {
            axpy(s_g[w][q], v[b], as);
          }
        }
      }
      ds[u] = as;
      if (dob) dob[u] = ao;
    }
    __syncwarp();
  }
}

bool aligned16(const void* p) {
  return p == nullptr || merge_path::aligned16(p);
}

int check(int n, int k, int d, int64_t n_codes, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n < 0 || k < 0 || d < 1 || n_codes < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

unsigned grid_of(int n) { return static_cast<unsigned>((n + kWarps - 1) /
                                                       kWarps); }

}  // namespace

extern "C" {

// energy and ev_sq [n, k] on `stream` of `device`: one launch of
// gather_dot_kernel (none where n * k == 0). q_obj is read only where coin
// is given. Returns cudaGetLastError() after the launch (0 on success),
// cudaErrorInvalidValue for a negative size or d < 1.
int gather_dot_f32(const float* codes, const float* q_subj,
                   const float* q_obj, const int64_t* ids,
                   const uint8_t* coin, float* energy, float* ev_sq, int n,
                   int k, int d, long long n_codes, int device,
                   void* stream) {
  int rc = check(n, k, d, n_codes, device);
  if (rc != 0 || n == 0 || k == 0) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d % 4 == 0 && aligned16(codes) && aligned16(q_subj) &&
      aligned16(coin ? q_obj : nullptr)) {
    gather_dot_kernel<float4><<<grid_of(n), kThreads, 0, s>>>(
        reinterpret_cast<const float4*>(codes),
        reinterpret_cast<const float4*>(q_subj),
        reinterpret_cast<const float4*>(q_obj), ids, coin, energy, ev_sq, n,
        k, d / 4, n_codes);
  } else {
    gather_dot_kernel<float><<<grid_of(n), kThreads, 0, s>>>(
        codes, q_subj, q_obj, ids, coin, energy, ev_sq, n, k, d, n_codes);
  }
  return static_cast<int>(cudaGetLastError());
}

// dq_subj (and dq_obj where coin is given) [n, d] for the energies'
// cotangent g [n, k]: one launch of gather_dot_grad_kernel (none where
// n * k == 0; the wrapper then returns zeros). Return codes as
// gather_dot_f32's.
int gather_dot_grad_f32(const float* codes, const int64_t* ids,
                        const uint8_t* coin, const float* g, float* dq_subj,
                        float* dq_obj, int n, int k, int d,
                        long long n_codes, int device, void* stream) {
  int rc = check(n, k, d, n_codes, device);
  if (rc != 0 || n == 0 || k == 0) return rc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d % 4 == 0 && aligned16(codes) && aligned16(dq_subj) &&
      aligned16(coin ? dq_obj : nullptr)) {
    gather_dot_grad_kernel<float4><<<grid_of(n), kThreads, 0, s>>>(
        reinterpret_cast<const float4*>(codes), ids, coin, g,
        reinterpret_cast<float4*>(dq_subj), reinterpret_cast<float4*>(dq_obj),
        n, k, d / 4, n_codes);
  } else {
    gather_dot_grad_kernel<float><<<grid_of(n), kThreads, 0, s>>>(
        codes, ids, coin, g, dq_subj, dq_obj, n, k, d, n_codes);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* gather_dot_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
