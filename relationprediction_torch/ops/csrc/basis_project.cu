// P = X @ W in split TF32 on Hopper's tensor cores (wgmma, TMA), for
// sm_90a.
//
// X [M, K] and W [K, N] f32 row-major, P [M, N] f32 row-major. The basis
// layer's projection: the forward projects every vertex once, P = x @
// W_flat [V, B * d_out]; the twin pass projects the cotangent, Q = g @ w_t
// [V, B * d_in] (14,541 x 500 x 2,500 both, at FB15k-237 scale). Together
// with basis_combine_f32 (basis_direction.cu) it replaces
// relationprediction_tpu/ops/staircase2.py:505-518 (_make_basis_kernel,
// launched by _call_basis at :601-632, and on the twin layout by the VJP at
// :853-875), whose per-edge product on the MXU becomes one product per
// vertex here.
//
// Precision. The port keeps f32-grade products (device.exact_float32): the
// result is held to sqrt(K) * 2^-24 * sum_k |x||w| an element
// (chip_smoke.project_exact), which one TF32 product (10-bit mantissas)
// misses many times over. Each operand is split into TF32 parts, a_0 =
// tf32_rna(a), a_1 = tf32_rna(a - a_0), a_2 = tf32_rna(a - a_0 - a_1)
// (cvt.rna.tf32.f32: round to nearest, ties away), and P is the sum of the
// part products down to 2^-22 of the leading one:
// * kParts = 2 (3xTF32), for K >= 64: A_1 B_0 + A_0 B_1 + A_0 B_0. a_0 +
//   a_1 holds ~22 bits of a, so a product may be off by up to ~2^-22 of
//   |x||w|, at most half the allowance once sqrt(K) >= 8;
// * kParts = 3 (6xTF32), for K < 64 (a shape only tests use here): a_0 +
//   a_1 + a_2 = a exactly, and A_0 B_2 + A_2 B_0 + A_1 B_1 + A_1 B_0 +
//   A_0 B_1 + A_0 B_0; at K = 1 the 2-part split misses the allowance,
//   which is then that of one correctly rounded product.
// The tensor cores' accumulator may truncate rather than round to nearest
// (Fasi et al., "Numerical behavior of NVIDIA tensor cores", 2021,
// measured truncation on the generations before Hopper); in the model of
// that in tests/test_torch_basis_direction.py, three products into one
// accumulator over K = 500 land over the allowance. So the products of a
// k-tile of 32 run into an accumulator that starts afresh every k-tile,
// and that one is added into an f32 register sum (rounding to nearest)
// after it. With 3 parts the correction products run instead into one
// accumulator over the whole of K (its truncation is ~2^-11 of the
// result's) added at the end, so that at K = 1 the leading product, exact
// in f32, meets the corrections in one rounding to nearest. Every order
// is fixed, so two launches give the same bits.
//
// Two kernels, two C entry points:
// * tf32_split_kernel (tf32_split_f32): one launch splits both operands
//   into K-major parts, which is what wgmma takes for .tf32 on both sides:
//   xs [kParts, M, Kp] from X, and ws [kParts, N, Kp] from W transposed
//   through a shared-memory tile. K is zero-padded to Kp, a multiple of 32
//   floats (one 128-byte swizzled row of a k-tile), so every row pitch is
//   16-byte aligned for TMA whatever K is (K = 1 and K = 33 included). W
//   is split anew at every call: it changes every Adam step.
// * project_kernel (basis_project_f32): 128 x 128 output tiles. One
//   thread of a producer warp keeps TMA loads of the k-tiles of every part
//   (128 x 32 each, 128-byte swizzle) in a ring of kStages shared-memory
//   stages, each with a "full" and an "empty" mbarrier. Two consumer
//   warpgroups take 64 rows each and issue wgmma.mma_async m64n128k8 .tf32
//   from shared memory, f32 accumulators in registers (2 or 3 x 64 a
//   thread; 142 registers and no spills with 2 parts). M and N edges come
//   from TMA's zero fill and the guarded stores of the epilogue. A wait on
//   an mbarrier that never completes traps after 2^24 polls instead of
//   hanging the card.
//
// Bound on an H100: operations. 3 * 2 * M * K * N tensor-core operations
// at 495 TFLOP/s dense TF32: 0.22 ms at 14,541 x 500 x 2,500. Bytes: the
// split reads X and W and writes twice their size (~0.1 GB), the product
// reads the parts and writes P (0.15 GB): ~0.08 ms at 3.35 TB/s.
//
// A third kernel, a third entry point: project_bf16_kernel
// (basis_project_bf16), the product of the bf16 message precision, X and
// W in bf16, P = X @ W accumulated in f32 and stored in bf16, rounded to
// nearest even, as the TPU kernel's bf16 t_ref holds it
// (relationprediction_tpu/ops/staircase2.py:508-510). It needs no split:
// bf16 x bf16 products are exact in f32. Each block takes a 128 x 128
// tile of P; 8 warps of 64 x 32 issue mma.sync m16n8k16 bf16 from shared
// memory, whose A tile is stored as X's rows and whose B tile as W's
// columns (K-contiguous, as the instruction takes both), loaded through
// registers a k-tile of 32 ahead of the one in use (two buffers). Loads
// are 8 bytes where K and N are multiples of 4 (K = 500, N = 2,500), else
// 2 bytes; rows and columns past M, N and K are zero-filled. Its bound on
// an H100 is operations: 2 * M * K * N at 989 TFLOP/s dense bf16, 0.037
// ms at 14,541 x 500 x 2,500; bytes (X, W and P in bf16, 88 MB) 0.026 ms.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kBM = 128;           // output rows a block
constexpr int kBN = 128;           // output columns a block (one wgmma)
constexpr int kBK = 32;            // k-tile: 32 floats = one 128-byte row
constexpr int kConsumers = 2;      // warpgroups of 64 rows
constexpr int kThreads = kConsumers * 128 + 32;  // + one producer warp
constexpr int kTile = kBM * kBK * 4;             // 16 KB, A or B, one part
constexpr int kAccum = kBN / 2;    // f32 accumulators a thread a wgmma
constexpr int kSmallK = 64;        // K below this takes 3 parts

template <int kParts>
struct Shape {
  static constexpr int kStages = kParts == 2 ? 3 : 2;
  static constexpr int kStageBytes = 2 * kParts * kTile;
  static constexpr int kSmemBytes = kStages * kStageBytes + 1024 + 64;
};

// ---- the split pass ----------------------------------------------------

__device__ __forceinline__ float tf32_rna(float a) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(a));
  return __uint_as_float(r);
}

// Block (x, y, z): rows 32x .. 32x + 31 and k 32y .. 32y + 31 of the
// output xs (z = 0, from X [m, k]) or ws (z = 1, from W [k, n]
// transposed). Writes part p to [p, r, c]; c >= k writes zeros.
template <int kParts>
__global__ void __launch_bounds__(256)
tf32_split_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  float* __restrict__ xs, float* __restrict__ ws, int m,
                  int k, int n, int kp) {
  __shared__ float tile[32][33];
  const int tx = threadIdx.x, ty = threadIdx.y;  // 32 x 8
  const int r0 = blockIdx.x * 32, c0 = blockIdx.y * 32;
  const bool is_x = blockIdx.z == 0;
  const int rows = is_x ? m : n;
  if (r0 >= rows) return;
  for (int i = ty; i < 32; i += 8) {
    if (is_x) {  // consecutive threads on consecutive k of a row of X
      const int r = r0 + i, c = c0 + tx;
      tile[i][tx] =
          (r < m && c < k) ? __ldg(x + static_cast<int64_t>(r) * k + c) : 0.f;
    } else {     // consecutive threads on consecutive columns of W
      const int c = c0 + i, r = r0 + tx;
      tile[tx][i] =
          (r < n && c < k) ? __ldg(w + static_cast<int64_t>(c) * n + r) : 0.f;
    }
  }
  __syncthreads();
  float* dst = is_x ? xs : ws;
  for (int i = ty; i < 32; i += 8) {
    const int r = r0 + i;
    if (r >= rows) break;
    float rest = tile[i][tx];
#pragma unroll
    for (int p = 0; p < kParts; ++p) {
      const float part = tf32_rna(rest);
      rest -= part;
      dst[(static_cast<int64_t>(p) * rows + r) * kp + c0 + tx] = part;
    }
  }
}

// ---- barriers, TMA, wgmma ----------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar))
               : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_addr(bar);
  for (uint32_t polls = 0;; ++polls) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 24)) __trap();
  }
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// Shared-memory matrix descriptor of a K-major tile with 128-byte swizzle:
// rows of 128 bytes, 8-row groups 1024 bytes apart (stride byte offset),
// leading byte offset unused (1), swizzle mode 1 in bits 62-63. `p` is the
// tile's start (1024-byte aligned) plus 32 bytes a k-step of 8 floats.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint64_t addr = smem_addr(p);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keeps the compiler from moving accumulator reads and writes across the
// asynchronous wgmma.
__device__ __forceinline__ void fence_operands(float (&d)[kAccum]) {
#pragma unroll
  for (int i = 0; i < kAccum; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 128] = A[64 x 8] B[8 x 128] + (accumulate ? d : 0) in TF32, both
// operands from shared memory.
__device__ __forceinline__ void wgmma_m64n128k8(float (&d)[kAccum],
                                                uint64_t a, uint64_t b,
                                                int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// ---- the product -------------------------------------------------------

// The correction products (A part, B part), smallest first; the leading
// product A_0 B_0 runs apart. kParts = 2: (1, 0), (0, 1); kParts = 3:
// (2, 0), (0, 2), (1, 1), (1, 0), (0, 1).
__host__ __device__ constexpr int corrections(int parts) {
  return parts == 2 ? 2 : 5;
}
__device__ __forceinline__ int correction_a(int parts, int c) {
  constexpr int a3[5] = {2, 0, 1, 1, 0};
  return parts == 2 ? 1 - c : a3[c];
}
__device__ __forceinline__ int correction_b(int parts, int c) {
  constexpr int b3[5] = {0, 2, 1, 0, 1};
  return parts == 2 ? c : b3[c];
}

// Block (x, y): columns kBN x .. and rows kBM y .. of P. Stage s holds
// the k-tile of A part p at s * kStageBytes + p * kTile and of B part p
// after the kParts A tiles.
template <int kParts>
__global__ void __launch_bounds__(kThreads, 1)
project_kernel(const __grid_constant__ CUtensorMap map_x,
               const __grid_constant__ CUtensorMap map_w,
               float* __restrict__ p, int m, int n, int kp) {
  using S = Shape<kParts>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem + S::kStages * S::kStageBytes);
  uint64_t* empty = full + S::kStages;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int n_k = kp / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers * 4) {  // the producer warp: one thread
    if (lane == 0) {
      for (int it = 0; it < n_k; ++it) {
        const int s = it % S::kStages;
        if (it >= S::kStages) {
          mbar_wait(&empty[s], ((it / S::kStages) - 1) & 1);
        }
        mbar_expect_tx(&full[s], S::kStageBytes);
        unsigned char* st = smem + s * S::kStageBytes;
        const int k0 = it * kBK;
#pragma unroll
        for (int part = 0; part < kParts; ++part) {
          tma_load(st + part * kTile, &map_x, &full[s], k0, m0, part);
          tma_load(st + (kParts + part) * kTile, &map_w, &full[s], k0, n0,
                   part);
        }
      }
    }
    return;
  }

  const int wg = warp / 4;  // consumer warpgroup: rows 64 wg .. 64 wg + 63
  // sum: f32 register sum of the k-tiles' `lead`. With 3 parts the
  // corrections run into `corr` over all of K; with 2 parts into `lead`
  // (they are ~2^-11 of it, and K >= 64 leaves the allowance room for
  // their truncation), which saves the registers of a third accumulator.
  float sum[kAccum], lead[kAccum], corr[kAccum];
#pragma unroll
  for (int i = 0; i < kAccum; ++i) sum[i] = corr[i] = lead[i] = 0.f;
  for (int it = 0; it < n_k; ++it) {
    const int s = it % S::kStages;
    mbar_wait(&full[s], (it / S::kStages) & 1);
    const unsigned char* a = smem + s * S::kStageBytes + wg * 64 * 128;
    const unsigned char* b = smem + s * S::kStageBytes + kParts * kTile;
    fence_operands(lead);
    if constexpr (kParts == 3) fence_operands(corr);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 8; ++kk) {
#pragma unroll
      for (int c = 0; c < corrections(kParts); ++c) {
        const uint64_t da =
            sw128_desc(a + correction_a(kParts, c) * kTile + kk * 32);
        const uint64_t db =
            sw128_desc(b + correction_b(kParts, c) * kTile + kk * 32);
        if constexpr (kParts == 3) {
          wgmma_m64n128k8(corr, da, db, 1);
        } else {
          wgmma_m64n128k8(lead, da, db, kk > 0 || c > 0);
        }
      }
      wgmma_m64n128k8(lead, sw128_desc(a + kk * 32), sw128_desc(b + kk * 32),
                      kParts == 2 || kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_operands(lead);
    if constexpr (kParts == 3) fence_operands(corr);
    mbar_arrive(&empty[s]);
#pragma unroll
    for (int i = 0; i < kAccum; ++i) sum[i] += lead[i];
  }
  if constexpr (kParts == 3) {
#pragma unroll
    for (int i = 0; i < kAccum; ++i) sum[i] += corr[i];
  }

  // Accumulator i of a thread: row 16 w + lane / 4 + 8 ((i / 2) % 2) of
  // the warpgroup's 64, column 8 (i / 4) + 2 (lane % 4) + i % 2 of the
  // tile's 128.
  const int w_in = warp % 4;
  const bool pairs = (n % 2) == 0;
#pragma unroll
  for (int i = 0; i < kAccum; i += 2) {
    const int row = m0 + wg * 64 + w_in * 16 + lane / 4 + 8 * ((i / 2) % 2);
    const int col = n0 + 8 * (i / 4) + 2 * (lane % 4);
    if (row >= m) continue;
    const float v0 = sum[i];
    const float v1 = sum[i + 1];
    float* dst = p + static_cast<int64_t>(row) * n + col;
    if (pairs && col + 1 < n) {
      *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
    } else {
      if (col < n) dst[0] = v0;
      if (col + 1 < n) dst[1] = v1;
    }
  }
}

// ---- the bf16 product ---------------------------------------------------

constexpr int kMmaBM = 128;         // rows of P a block
constexpr int kMmaBN = 128;         // columns of P a block
constexpr int kMmaBK = 32;          // k-tile
constexpr int kMmaPitch = kMmaBK + 8;  // bf16 a shared row of X (80 bytes)
// bf16 a shared column of W (68 bytes: 17 words, so the 32 lanes of a
// transposing store fall on 8 banks, not 2, and 32-bit fragment loads stay
// aligned)
constexpr int kMmaPitchB = kMmaBK + 2;
constexpr int kMmaThreads = 256;    // 8 warps: 2 (64 rows) x 4 (32 cols)
// Elements a thread loads of each tile, as kVec-wide pieces.
template <int kVec>
struct BfLoads {
  static constexpr int kPieces = kMmaBM * kMmaBK / (kVec * kMmaThreads);
};

// The bits of one bf16 element, or of four.
template <int kVec>
struct BfPiece;
template <>
struct BfPiece<4> {
  using T = uint2;
  static __device__ __forceinline__ T zero() { return make_uint2(0u, 0u); }
  static __device__ __forceinline__ uint16_t at(T v, int i) {
    const uint32_t w = i < 2 ? v.x : v.y;
    return static_cast<uint16_t>(i % 2 ? w >> 16 : w & 0xFFFFu);
  }
};
template <>
struct BfPiece<1> {
  using T = uint16_t;
  static __device__ __forceinline__ T zero() { return 0; }
  static __device__ __forceinline__ uint16_t at(T v, int) { return v; }
};

__device__ __forceinline__ uint32_t lds32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c[4] += A[16 x 16] B[16 x 8], bf16 in, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Block (x, y): columns kMmaBN x .. and rows kMmaBM y .. of P [m, n] from
// X [m, k] and W [k, n], all bf16 row-major. as[buf][r][kk] holds X[m0 +
// r, k0 + kk]; bs[buf][c][kk] holds W[k0 + kk, n0 + c]. Warp w owns rows
// 64 (w / 4) .. + 63 and columns 32 (w % 4) .. + 31 of the tile: 4 x 4
// fragments of 16 x 8.
template <int kVec>
__global__ void __launch_bounds__(kMmaThreads)
project_bf16_kernel(const uint16_t* __restrict__ x,
                    const uint16_t* __restrict__ w, uint16_t* __restrict__ p,
                    int m, int k, int n) {
  using Piece = BfPiece<kVec>;
  using PieceT = typename Piece::T;
  constexpr int kPieces = BfLoads<kVec>::kPieces;
  __shared__ __align__(16) uint16_t as[2][kMmaBM][kMmaPitch];
  __shared__ __align__(16) uint16_t bs[2][kMmaBN][kMmaPitchB];
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int wm = (warp / 4) * 64, wn = (warp % 4) * 32;
  const int m0 = blockIdx.y * kMmaBM, n0 = blockIdx.x * kMmaBN;
  const int n_k = (k + kMmaBK - 1) / kMmaBK;

  PieceT ra[kPieces], rb[kPieces];
  // Piece i of X's tile: row v / (kMmaBK / kVec), k (v % ...) * kVec; of
  // W's tile: k v / (kMmaBN / kVec), column (v % ...) * kVec.
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kPieces; ++i) {
      const int v = tid + i * kMmaThreads;
      const int r = v / (kMmaBK / kVec), kk = (v % (kMmaBK / kVec)) * kVec;
      const int gr = m0 + r, gk = k0 + kk;
      ra[i] = (gr < m && gk < k)
                  ? __ldg(reinterpret_cast<const PieceT*>(
                        x + static_cast<int64_t>(gr) * k + gk))
                  : Piece::zero();
      const int kr = v / (kMmaBN / kVec), c = (v % (kMmaBN / kVec)) * kVec;
      const int hk = k0 + kr, gc = n0 + c;
      rb[i] = (hk < k && gc < n)
                  ? __ldg(reinterpret_cast<const PieceT*>(
                        w + static_cast<int64_t>(hk) * n + gc))
                  : Piece::zero();
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < kPieces; ++i) {
      const int v = tid + i * kMmaThreads;
      const int r = v / (kMmaBK / kVec), kk = (v % (kMmaBK / kVec)) * kVec;
      *reinterpret_cast<PieceT*>(&as[buf][r][kk]) = ra[i];
      const int kr = v / (kMmaBN / kVec), c = (v % (kMmaBN / kVec)) * kVec;
#pragma unroll
      for (int j = 0; j < kVec; ++j) bs[buf][c + j][kr] = Piece::at(rb[i], j);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][b][c] = 0.f;
    }
  }

  load(0);
  store(0);
  __syncthreads();
  for (int it = 0; it < n_k; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_k) load((it + 1) * kMmaBK);
#pragma unroll
    for (int kk = 0; kk < kMmaBK; kk += 16) {
      uint32_t bf[4][2];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const uint16_t* col = &bs[buf][wn + ni * 8 + g][kk + 2 * t4];
        bf[ni][0] = lds32(col);
        bf[ni][1] = lds32(col + 8);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const uint16_t* row = &as[buf][wm + mi * 16 + g][kk + 2 * t4];
        const uint32_t a0 = lds32(row), a2 = lds32(row + 8);
        const uint32_t a1 = lds32(row + 8 * kMmaPitch);
        const uint32_t a3 = lds32(row + 8 * kMmaPitch + 8);
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          mma_bf16(acc[mi][ni], a0, a1, a2, a3, bf[ni][0], bf[ni][1]);
        }
      }
    }
    if (it + 1 < n_k) store(buf ^ 1);
    __syncthreads();
  }

  // Accumulator c of fragment (mi, ni): row g + 8 (c / 2), column 2 t4 +
  // c % 2 of its 16 x 8.
  const bool pairs = n % 2 == 0;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm + mi * 16 + g + 8 * half;
      if (row >= m) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int col = n0 + wn + ni * 8 + 2 * t4;
        const uint16_t v0 = __bfloat16_as_ushort(
            __float2bfloat16_rn(acc[mi][ni][2 * half]));
        const uint16_t v1 = __bfloat16_as_ushort(
            __float2bfloat16_rn(acc[mi][ni][2 * half + 1]));
        uint16_t* dst = p + static_cast<int64_t>(row) * n + col;
        if (pairs && col + 1 < n) {
          *reinterpret_cast<uint32_t*>(dst) =
              static_cast<uint32_t>(v0) | (static_cast<uint32_t>(v1) << 16);
        } else {
          if (col < n) dst[0] = v0;
          if (col + 1 < n) dst[1] = v1;
        }
      }
    }
  }
}

// ---- host side ---------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult status =
        cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                     cudaEnableDefault, &status);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault,
                            &status);
#endif
    if (status == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(ptr);
    }
  }
  return fn;
}

// A 3-D map over parts [n_parts, rows, kp] f32 with boxes of 128 x 32.
bool make_map(CUtensorMap* map, const float* base, int n_parts, int rows,
              int kp) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(kp),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(n_parts)};
  const cuuint64_t strides[2] = {
      static_cast<cuuint64_t>(kp) * sizeof(float),
      static_cast<cuuint64_t>(kp) * rows * sizeof(float)};
  const cuuint32_t box[3] = {kBK, kBM, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                const_cast<float*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int kParts>
int launch_product(const float* xs, const float* ws, float* p, int m, int n,
                   int kp, cudaStream_t s) {
  using S = Shape<kParts>;
  const int64_t grid_m = (static_cast<int64_t>(m) + kBM - 1) / kBM;
  const int64_t grid_n = (static_cast<int64_t>(n) + kBN - 1) / kBN;
  if (grid_m > 65535) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_x, map_w;
  if (!make_map(&map_x, xs, kParts, m, kp) ||
      !make_map(&map_w, ws, kParts, n, kp)) {
    return static_cast<int>(cudaErrorNotSupported);
  }
  static bool attribute_set = false;
  if (!attribute_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        project_kernel<kParts>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        S::kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    attribute_set = true;
  }
  project_kernel<kParts><<<dim3(static_cast<unsigned>(grid_n),
                                static_cast<unsigned>(grid_m)),
                           kThreads, S::kSmemBytes, s>>>(map_x, map_w, p, m,
                                                         n, kp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The k-tile (the split pads K to a multiple of it) and the number of
// TF32 parts an operand is split into for inner dimension k.
int basis_project_k_tile() { return kBK; }
int basis_project_parts(int k) { return k < kSmallK ? 3 : 2; }

// xs [parts, m, kp] and ws [parts, n, kp] from x [m, k] and w [k, n] on
// `stream` of `device`, parts 2 or 3 (basis_project_parts(k)), kp a
// multiple of basis_project_k_tile() with kp >= k; one launch. Returns
// cudaGetLastError() after it (0 on success), cudaErrorInvalidValue for a
// negative size, a bad kp or parts, or a grid beyond the card's limits.
int tf32_split_f32(const float* x, const float* w, float* xs, float* ws,
                   int m, int k, int n, int kp, int parts, int device,
                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (m < 0 || k < 0 || n < 0 || kp < k || kp % kBK != 0 ||
      (parts != 2 && parts != 3)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int rows = m > n ? m : n;
  if (rows == 0 || kp == 0) return 0;
  const dim3 grid((rows + 31) / 32, kp / 32, 2);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (parts == 3) {
    tf32_split_kernel<3><<<grid, dim3(32, 8), 0, s>>>(x, w, xs, ws, m, k, n,
                                                      kp);
  } else {
    tf32_split_kernel<2><<<grid, dim3(32, 8), 0, s>>>(x, w, xs, ws, m, k, n,
                                                      kp);
  }
  return static_cast<int>(cudaGetLastError());
}

// p [m, n] from the parts xs [parts, m, kp] and ws [parts, n, kp]
// (tf32_split_f32's output) on `stream` of `device`. Returns
// cudaGetLastError() after the launch (0 on success),
// cudaErrorInvalidValue for a negative size, a bad kp or parts, or a grid
// beyond the card's limits, cudaErrorNotSupported where a TMA map cannot
// be made.
int basis_project_f32(const float* xs, const float* ws, float* p, int m,
                      int n, int kp, int parts, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (m < 0 || n < 0 || kp < 0 || kp % kBK != 0 ||
      (parts != 2 && parts != 3)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (m == 0 || n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kp == 0) {
    return static_cast<int>(cudaMemsetAsync(
        p, 0, sizeof(float) * static_cast<size_t>(m) * n, s));
  }
  return parts == 3
             ? launch_product<3>(xs, ws, p, m, n, kp, s)
             : launch_product<2>(xs, ws, p, m, n, kp, s);
}

// p [m, n] bf16 = x [m, k] bf16 @ w [k, n] bf16 with f32 accumulation,
// rounded to nearest even, on `stream` of `device`; one launch. Returns
// cudaGetLastError() after it (0 on success), cudaErrorInvalidValue for a
// negative size or a grid beyond the card's limits.
int basis_project_bf16(const void* x, const void* w, void* p, int m, int k,
                       int n, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (m < 0 || k < 0 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0 || n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k == 0) {
    return static_cast<int>(cudaMemsetAsync(
        p, 0, sizeof(uint16_t) * static_cast<size_t>(m) * n, s));
  }
  const int64_t grid_m = (static_cast<int64_t>(m) + kMmaBM - 1) / kMmaBM;
  const int64_t grid_n = (static_cast<int64_t>(n) + kMmaBN - 1) / kMmaBN;
  if (grid_m > 65535 || grid_n > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(grid_n),
                  static_cast<unsigned>(grid_m));
  const uintptr_t bases = reinterpret_cast<uintptr_t>(x) |
                          reinterpret_cast<uintptr_t>(w);
  const auto* xb = static_cast<const uint16_t*>(x);
  const auto* wb = static_cast<const uint16_t*>(w);
  auto* pb = static_cast<uint16_t*>(p);
  if (k % 4 == 0 && n % 4 == 0 && (bases & 7u) == 0) {
    project_bf16_kernel<4><<<grid, kMmaThreads, 0, s>>>(xb, wb, pb, m, k, n);
  } else {
    project_bf16_kernel<1><<<grid, kMmaThreads, 0, s>>>(xb, wb, pb, m, k, n);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* basis_project_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
