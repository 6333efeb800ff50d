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
// Two more kernels for the bf16 message precision, X and W in bf16, P =
// X @ W summed in f32 and stored in bf16, rounded to nearest even, as the
// TPU kernel's bf16 t_ref holds it (relationprediction_tpu/ops/
// staircase2.py:505-518, _make_basis_kernel, :508-510). bf16 x bf16
// products are exact in f32, so no split is needed. Bound on an H100:
// operations, 2 * M * K * N at 989 TFLOP/s dense bf16, 0.037 ms at
// 14,541 x 500 x 2,500; bytes (X, W and P in bf16, 88 MB) 0.026 ms. What
// stands in the way of TMA and wgmma is the layout: rows of K = 500 bf16
// (1,000 bytes) and N = 2,500 (5,000 bytes) are not 16-byte aligned, and
// wgmma takes a bf16 B K-major.
// * bf16_pad_kernel (bf16_pad): one launch copies X into xp [M, K_pad]
//   and W transposed into wt [N, K_pad], K_pad = K rounded up to 8 (504:
//   1,008-byte rows), columns K .. K_pad - 1 zero. Bytes: ~35 MB, ~0.01 ms.
// * project_bf16_kernel (basis_project_bf16): persistent blocks, one an
//   SM, walk 128 x 256 tiles of P (1,140 at the main shape). One producer
//   thread keeps TMA loads of 64-wide k-tiles of xp and wt (128-byte
//   swizzle) in a ring of 3 stages of 48 KB, running on into the next
//   tile while the consumers finish this one; two consumer warpgroups of
//   64 rows issue wgmma.mma_async m64n256k16 bf16 with f32 accumulators
//   (128 a thread), keep one k-tile's group in flight (wait_group 1) and
//   free a stage when the group that read it completes. At a tile's end
//   they round to bf16 into a shared tile, which three storer warps copy
//   into P (8 bytes a thread where N % 4 == 0, else 2; P's 5,000-byte rows
//   forbid a TMA store) while the consumers run the next tile. Tiles of
//   256 columns read each row of xp from L2 10 times at N = 2,500 and wt
//   114 times: ~434 MB, against ~580 MB for 128 x 128 tiles. That feed
//   (~0.09 ms of loads alone on an H100) is what holds the product at
//   ~3x its bound (bf16_product_variants.py).
// Every sum runs in a fixed order, so two launches give the same bits.

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
template <int kN>
__device__ __forceinline__ void fence_operands(float (&d)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(d[i])::"memory");
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

// ---- the bf16 pad pass ---------------------------------------------------

constexpr int kPadK = 8;            // K_pad: K rounded up to 8 (16 bytes)
constexpr int kPadThreads = 256;

// The bits of one bf16 element, or of four.
template <int kVec>
struct BfPiece;
template <>
struct BfPiece<4> {
  using T = uint2;
  static __device__ __forceinline__ T zero() { return make_uint2(0u, 0u); }
};
template <>
struct BfPiece<1> {
  using T = uint16_t;
  static __device__ __forceinline__ T zero() { return 0; }
};

// One launch, two parts. Blocks [0, x_blocks) copy X [m, k] into xp [m,
// kp], kVec elements a thread, columns k .. kp - 1 zero (a piece lies
// wholly below k or wholly past it: kVec = 4 needs k % 4 == 0). The other
// blocks transpose W [k, n] into wt [n, kp] through a shared 32 x 32 tile,
// reading W's rows and writing wt's rows with consecutive threads on
// consecutive addresses, zeros past k.
template <int kVec>
__global__ void __launch_bounds__(kPadThreads)
bf16_pad_kernel(const uint16_t* __restrict__ x,
                const uint16_t* __restrict__ w, uint16_t* __restrict__ xp,
                uint16_t* __restrict__ wt, int m, int k, int n, int kp,
                int x_blocks) {
  using Piece = BfPiece<kVec>;
  using PieceT = typename Piece::T;
  __shared__ uint16_t tile[32][33];
  if (static_cast<int>(blockIdx.x) < x_blocks) {
    const int64_t pieces = kp / kVec;
    const int64_t i =
        static_cast<int64_t>(blockIdx.x) * kPadThreads + threadIdx.x;
    if (i >= static_cast<int64_t>(m) * pieces) return;
    const int64_t r = i / pieces;
    const int c = static_cast<int>(i % pieces) * kVec;
    *reinterpret_cast<PieceT*>(xp + r * kp + c) =
        c < k ? __ldg(reinterpret_cast<const PieceT*>(x + r * k + c))
              : Piece::zero();
    return;
  }
  const int b = static_cast<int>(blockIdx.x) - x_blocks;
  const int k_tiles = (kp + 31) / 32;
  const int r0 = (b / k_tiles) * 32;  // rows of wt: columns of W
  const int c0 = (b % k_tiles) * 32;  // columns of wt: rows of W
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  for (int i = ty; i < 32; i += kPadThreads / 32) {
    const int kk = c0 + i, col = r0 + tx;
    tile[i][tx] = (kk < k && col < n)
                      ? __ldg(w + static_cast<int64_t>(kk) * n + col)
                      : uint16_t{0};
  }
  __syncthreads();
  for (int i = ty; i < 32; i += kPadThreads / 32) {
    const int row = r0 + i, c = c0 + tx;
    if (row < n && c < kp) {
      wt[static_cast<int64_t>(row) * kp + c] = tile[tx][i];
    }
  }
}

// ---- the bf16 product ----------------------------------------------------

constexpr int kBfBN = 256;          // output columns a tile (one wgmma n256)
constexpr int kBfBK = 64;           // k-tile: 64 bf16 = one 128-byte row
constexpr int kBfStages = 3;
constexpr int kBfTileA = kBM * kBfBK * 2;             // 16 KB
constexpr int kBfTileB = kBfBN * kBfBK * 2;           // 32 KB
constexpr int kBfStageBytes = kBfTileA + kBfTileB;    // 48 KB
// The rounded tile in shared memory for the storer warps: rows of 256
// bf16 padded by 16 bytes (132 words), so that the 8 rows x 4 column
// pairs of a consumer warp's 4-byte stores fall on 32 banks.
constexpr int kBfOutPitch = kBfBN + 8;
constexpr int kBfOutBytes = kBM * kBfOutPitch * 2;    // 66 KB
constexpr int kBfBarriers = 2 * kBfStages + 2;
constexpr int kBfSmemBytes =
    kBfStages * kBfStageBytes + kBfOutBytes + 1024 + 8 * kBfBarriers;
constexpr int kBfAccum = kBfBN / 2;  // f32 accumulators a thread
// Two consumer warpgroups, then one warpgroup whose first warp issues the
// TMA loads and whose other three store P.
constexpr int kBfThreads = kConsumers * 128 + 128;
constexpr int kBfStorers = 96;

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

__device__ __forceinline__ void wgmma_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
}

#define ACC8(i)                                                           \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),             \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d[64 x 256] = A[64 x 16] B[16 x 256] + (accumulate ? d : 0), bf16 in,
// f32 sums, both operands K-major from shared memory.
__device__ __forceinline__ void wgmma_m64n256k16_bf16(
    float (&d)[kBfAccum], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n}"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48),
        ACC8(56), ACC8(64), ACC8(72), ACC8(80), ACC8(88), ACC8(96),
        ACC8(104), ACC8(112), ACC8(120)
      : "l"(a), "l"(b), "r"(accumulate));
}

#undef ACC8

// Persistent: block b takes the tiles b, b + gridDim.x, ... of P, each
// kBM x kBfBN, columns fastest (tile t: rows kBM (t / tiles_n) .., columns
// kBfBN (t % tiles_n) ..). xp [m, kp] and wt [n, kp] are K-major bf16
// (the pad pass's output); stage s holds a k-tile of xp (kBM x kBfBK) and
// one of wt (kBfBN x kBfBK), TMA's 128-byte swizzle, with a "full" and an
// "empty" mbarrier. The producer thread runs ahead across tiles, so the
// next tile's loads overlap this one's epilogue. Each consumer warpgroup
// keeps one k-tile's wgmma group in flight and frees a stage once the
// group that read it has completed; at a tile's end it rounds its
// accumulators to bf16 into the shared tile `out` (once the storers have
// emptied it: "out_empty") and goes on to the next tile ("out_full").
// The three storer warps copy `out` into P row by row, 8 bytes a thread
// where n % 4 == 0 (P's rows are then 8-byte aligned; 2 bytes else),
// while the consumers run the next tile. Rows and columns past m and n
// come from TMA's zero fill, k past kp too, and the storers' guards.
__global__ void __launch_bounds__(kBfThreads, 1)
project_bf16_kernel(const __grid_constant__ CUtensorMap map_x,
                    const __grid_constant__ CUtensorMap map_w,
                    uint16_t* __restrict__ p, int m, int n, int kp) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  uint16_t* out =
      reinterpret_cast<uint16_t*>(smem + kBfStages * kBfStageBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      smem + kBfStages * kBfStageBytes + kBfOutBytes);
  uint64_t* empty = full + kBfStages;
  uint64_t* out_full = empty + kBfStages;
  uint64_t* out_empty = out_full + 1;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int tiles_n = (n + kBfBN - 1) / kBfBN;
  const int tiles = ((m + kBM - 1) / kBM) * tiles_n;
  const int n_k = (kp + kBfBK - 1) / kBfBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kBfStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 128);
    }
    mbar_init(out_full, kConsumers * 128);
    mbar_init(out_empty, kBfStorers);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers * 4) {  // the producer warp: one thread
    if (lane == 0) {
      int it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = (t / tiles_n) * kBM, n0 = (t % tiles_n) * kBfBN;
        for (int kt = 0; kt < n_k; ++kt, ++it) {
          const int s = it % kBfStages;
          if (it >= kBfStages) {
            mbar_wait(&empty[s], ((it / kBfStages) - 1) & 1);
          }
          mbar_expect_tx(&full[s], kBfStageBytes);
          unsigned char* st = smem + s * kBfStageBytes;
          tma_load_2d(st, &map_x, &full[s], kt * kBfBK, m0);
          tma_load_2d(st + kBfTileA, &map_w, &full[s], kt * kBfBK, n0);
        }
      }
    }
    return;
  }

  if (warp > kConsumers * 4) {  // the storer warps
    const int tid = threadIdx.x - (kConsumers * 4 + 1) * 32;
    const bool wide = n % 4 == 0;
    int j = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++j) {
      const int m0 = (t / tiles_n) * kBM, n0 = (t % tiles_n) * kBfBN;
      mbar_wait(out_full, j & 1);
      for (int c = tid; c < kBM * kBfBN / 4; c += kBfStorers) {
        const int r = c / (kBfBN / 4), col = (c % (kBfBN / 4)) * 4;
        const int row = m0 + r, gc = n0 + col;
        if (row >= m || gc >= n) continue;
        const uint16_t* src = out + r * kBfOutPitch + col;
        uint16_t* dst = p + static_cast<int64_t>(row) * n + gc;
        if (wide) {
          *reinterpret_cast<uint2*>(dst) =
              *reinterpret_cast<const uint2*>(src);
        } else {
          for (int e = 0; e < 4 && gc + e < n; ++e) dst[e] = src[e];
        }
      }
      mbar_arrive(out_empty);
    }
    return;
  }

  const int wg = warp / 4;  // consumer warpgroup: rows 64 wg .. 64 wg + 63
  const int w_in = warp % 4;
  float acc[kBfAccum];
#pragma unroll
  for (int i = 0; i < kBfAccum; ++i) acc[i] = 0.f;
  int it = 0, j = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, ++j) {
    for (int kt = 0; kt < n_k; ++kt, ++it) {
      const int s = it % kBfStages;
      mbar_wait(&full[s], (it / kBfStages) & 1);
      const unsigned char* a = smem + s * kBfStageBytes + wg * 64 * 128;
      const unsigned char* b = smem + s * kBfStageBytes + kBfTileA;
      fence_operands(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBfBK / 16; ++kk) {
        wgmma_m64n256k16_bf16(acc, sw128_desc(a + kk * 32),
                              sw128_desc(b + kk * 32), kt > 0 || kk > 0);
      }
      wgmma_commit();
      // This k-tile's group stays in flight; the one before it has
      // completed, so its stage is free.
      wgmma_wait_one();
      fence_operands(acc);
      if (kt > 0) mbar_arrive(&empty[(it - 1) % kBfStages]);
    }
    wgmma_wait_all();
    fence_operands(acc);
    mbar_arrive(&empty[(it - 1) % kBfStages]);

    // Accumulator i of a thread: row 16 w + lane / 4 + 8 ((i / 2) % 2) of
    // the warpgroup's 64, column 8 (i / 4) + 2 (lane % 4) + i % 2 of the
    // tile's 256; rounded to bf16 (to nearest even) as column pairs.
    if (j > 0) mbar_wait(out_empty, (j - 1) & 1);
#pragma unroll
    for (int i = 0; i < kBfAccum; i += 2) {
      const int r = wg * 64 + w_in * 16 + lane / 4 + 8 * ((i / 2) % 2);
      const int col = 8 * (i / 4) + 2 * (lane % 4);
      const uint32_t v0 = __bfloat16_as_ushort(__float2bfloat16_rn(acc[i]));
      const uint32_t v1 =
          __bfloat16_as_ushort(__float2bfloat16_rn(acc[i + 1]));
      *reinterpret_cast<uint32_t*>(out + r * kBfOutPitch + col) =
          v0 | (v1 << 16);
    }
    mbar_arrive(out_full);
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

// A 2-D map over [rows, kp] bf16 (K-major, 16-byte row pitch) with boxes
// of box_rows x kBfBK.
bool make_map_bf16(CUtensorMap* map, const void* base, int rows, int kp,
                   int box_rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(kp),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(kp) * 2};
  const cuuint32_t box[2] = {kBfBK, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int launch_product_bf16(const void* xp, const void* wt, uint16_t* p, int m,
                        int n, int kp, int device, cudaStream_t s) {
  const int64_t tiles = ((static_cast<int64_t>(m) + kBM - 1) / kBM) *
                        ((static_cast<int64_t>(n) + kBfBN - 1) / kBfBN);
  if (tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_x, map_w;
  if (!make_map_bf16(&map_x, xp, m, kp, kBM) ||
      !make_map_bf16(&map_w, wt, n, kp, kBfBN)) {
    return static_cast<int>(cudaErrorNotSupported);
  }
  int sms = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  static bool attribute_set = false;
  if (!attribute_set) {
    err = cudaFuncSetAttribute(project_bf16_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kBfSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    attribute_set = true;
  }
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  project_bf16_kernel<<<grid, kBfThreads, kBfSmemBytes, s>>>(map_x, map_w,
                                                             p, m, n, kp);
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

// The multiple that the pad pass rounds K up to (K_pad), and the stages
// and registers a thread of the bf16 product (0 where the attributes
// cannot be read).
int basis_project_bf16_k_pad() { return kPadK; }
int basis_project_bf16_stages() { return kBfStages; }
int basis_project_bf16_registers() {
  cudaFuncAttributes attr;
  return cudaFuncGetAttributes(&attr, project_bf16_kernel) == cudaSuccess
             ? attr.numRegs
             : 0;
}

// The pad pass: xp [m, kp] from x [m, k] and wt [n, kp] from w [k, n]
// transposed, all bf16 row-major, columns k .. kp - 1 zero, on `stream` of
// `device`; kp a multiple of basis_project_bf16_k_pad() with kp >= k; one
// launch. Returns cudaGetLastError() after it (0 on success),
// cudaErrorInvalidValue for a negative size, a bad kp or a grid beyond the
// card's limits.
int bf16_pad(const void* x, const void* w, void* xp, void* wt, int m, int k,
             int n, int kp, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (m < 0 || k < 0 || n < 0 || kp < k || kp % kPadK != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (kp == 0 || (m == 0 && n == 0)) return 0;
  const uintptr_t bases =
      reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(xp);
  const bool wide = k % 4 == 0 && (bases & 7u) == 0;
  const int vec = wide ? 4 : 1;
  const int64_t x_blocks =
      (static_cast<int64_t>(m) * (kp / vec) + kPadThreads - 1) / kPadThreads;
  const int64_t w_blocks = ((static_cast<int64_t>(n) + 31) / 32) *
                           ((kp + 31) / 32);
  if (x_blocks + w_blocks > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int grid = static_cast<int>(x_blocks + w_blocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const uint16_t*>(x);
  const auto* wb = static_cast<const uint16_t*>(w);
  auto* xpb = static_cast<uint16_t*>(xp);
  auto* wtb = static_cast<uint16_t*>(wt);
  if (wide) {
    bf16_pad_kernel<4><<<grid, kPadThreads, 0, s>>>(
        xb, wb, xpb, wtb, m, k, n, kp, static_cast<int>(x_blocks));
  } else {
    bf16_pad_kernel<1><<<grid, kPadThreads, 0, s>>>(
        xb, wb, xpb, wtb, m, k, n, kp, static_cast<int>(x_blocks));
  }
  return static_cast<int>(cudaGetLastError());
}

// p [m, n] bf16 = xp [m, kp] @ wt [n, kp]^T (the pad pass's K-major
// operands, bf16, 16-byte aligned) with f32 sums, rounded to nearest even,
// on `stream` of `device`; one launch. Returns cudaGetLastError() after it
// (0 on success), cudaErrorInvalidValue for a negative size, a kp that is
// not a multiple of basis_project_bf16_k_pad() or a misaligned operand,
// cudaErrorNotSupported where a TMA map cannot be made.
int basis_project_bf16(const void* xp, const void* wt, void* p, int m,
                       int kp, int n, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const uintptr_t bases =
      reinterpret_cast<uintptr_t>(xp) | reinterpret_cast<uintptr_t>(wt);
  if (m < 0 || kp < 0 || n < 0 || kp % kPadK != 0 || (bases & 15u) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (m == 0 || n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kp == 0) {
    return static_cast<int>(cudaMemsetAsync(
        p, 0, sizeof(uint16_t) * static_cast<size_t>(m) * n, s));
  }
  return launch_product_bf16(xp, wt, static_cast<uint16_t*>(p), m, n, kp,
                             device, s);
}

const char* basis_project_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
