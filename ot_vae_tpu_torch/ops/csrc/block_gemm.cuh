// Matrix products of the fused attention block (attention_block.cu,
// attention_block_bwd.cu): its projections and their gradients,
//
//   C[m, n] = sum_k A[m, k] * B[k, n],
//
// in kernels chosen by the block's dtype:
//
//   - bf16 on the tensor cores (mma_gemm_kernel): mma.sync.m16n8k16 with
//     bf16 operands and f32 accumulation (mma_bf16.cuh), C rounded once to
//     its own type; and for qkv = x w_qkv, whose bf16 rounding feeds lse,
//     exact sums on the FP64 tensor cores (exact_gemm_kernel,
//     mma.sync.m8n8k4.f64), rounded once to f32 and then to bf16, so that
//     every entry rounds as the plain version's exact sum does whatever the
//     order of the sum. The weights arrive as f32 through their strides, in
//     either layout ([in, out] as the JAX package holds them, or the [out,
//     in] view of a 1x1 convolution's weight); cast_weights_kernel first
//     rounds both to bf16, as the TPU kernel casts them to x's dtype in its
//     body, into a workspace in one fixed layout, [in, out] with every row
//     padded with zeros to a multiple of 8 entries. So every operand of
//     every product is bf16 with one unit stride, and a tile moves in
//     16-byte cp.async chunks wherever its rows start on 16 bytes. A cast
//     pass (at most 512 x 1536 + 512 x 512 entries, read once through L2) is
//     cheaper than rounding f32 weights while loading tiles, which every
//     block of a product with B*T rows would repeat.
//   - f32 on CUDA cores (gemm_kernel): tensor cores would take f32
//     operands as TF32, which the f32 gates against the plain version do
//     not allow. A 64 x 64 tile of C per block of 256 threads, 4 x 4 a
//     thread, K in steps of 16 through shared memory.
//
// mma_gemm_kernel. A 128 x 128 tile of C per block of 8 warps, each warp a
// 32 x 64 patch (2 x 8 accumulators of 16 x 8); K in steps of 32 through
// two shared-memory stages filled by cp.async while the other is consumed.
// Each operand is addressed through its one non-unit stride and is either
// K-contiguous (a row-major activation A, or a weight read as B^T) or
// contiguous along M or N (the transposed activations of the weight
// gradients, a weight read as B); a tile is stored as it lies in memory,
// rows padded by 16 bytes (no ldmatrix bank conflict), and ldmatrix reads
// the fragments plainly or with .trans as its layout needs. Tiles are
// zero-filled past M, N and K; where a row does not start on 16 bytes (C,
// H*ch or C_out not a multiple of 8) they are copied by masked scalar loads.
//
// exact_gemm_kernel. The same tiles and copies, with a 64 x 64 tile of C
// per block of 4 warps and K in steps of 16; each bf16 operand is widened to
// f64 as its fragment is read. The price of the exact sum: the FP64 tensor
// cores run at 67 TFLOP/s, a fifteenth of the bf16 rate, so at the FFHQ128
// decoder's 32x32 block at batch 128 the qkv projection (1.3e10 FLOP) takes
// 0.19 ms at best (PERF.md has its measured time).
//
// Split K, without atomics. A weight gradient sums over every row of the
// batch (B*T up to 131072) into a C of at most a few hundred thousand
// entries, too few tiles to fill 132 SMs. The TPU carried the sum across its
// sequential grid; here `splits` blocks each sum a fixed, contiguous range
// of K into their own f32 slice of a workspace, and a second kernel adds the
// slices in order. The order of every sum is fixed by the shape, so a run
// repeats bit for bit.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "mma_bf16.cuh"

namespace block_gemm {

using mma::bf16;

// Internal linkage for every kernel and launcher: each library that
// includes this header holds its own instantiations (see
// attention_fwd_mma.cuh).
namespace {

constexpr int kTileM = 64;  // f32 kernel
constexpr int kTileN = 64;
constexpr int kTileK = 16;
constexpr int kThreads = 256;
constexpr int kReduceThreads = 256;

constexpr int kMmaM = 128;  // bf16 kernel: C tile
constexpr int kMmaN = 128;
constexpr int kMmaK = 32;  // K step
constexpr int kMmaThreads = 256;

// entries of a weight row in the bf16 workspace: `cols` padded to 8
__host__ __forceinline__ int64_t padded(int cols) { return (cols + 7) / 8 * 8; }

// rows x cols values of X at (r0, c0) into tile[col][row]; outside
// (rows_end, cols_end) zeros. `sr` and `sc` are X's strides.
template <int kRows>
__device__ __forceinline__ void fill(float (*tile)[kRows + 4], const float* x, int64_t sr,
                                     int64_t sc, int r0, int rows_end, int c0, int cols_end) {
  for (int i = threadIdx.x; i < kRows * kTileK; i += kThreads) {
    int r, c;
    if (sc == 1) {  // neighbouring threads along a row
      r = i / kTileK;
      c = i % kTileK;
    } else {  // neighbouring threads down a column
      c = i / kRows;
      r = i % kRows;
    }
    const bool in = r0 + r < rows_end && c0 + c < cols_end;
    tile[c][r] = in ? x[(r0 + r) * sr + (c0 + c) * sc] : 0.f;
  }
}

// f32 on CUDA cores: grid (M tiles, N tiles, splits); split z sums K rows
// [z*k_chunk, (z+1)*k_chunk) into C + z*split_stride
__global__ void __launch_bounds__(kThreads)
gemm_kernel(const float* __restrict__ a, int64_t sam, int64_t sak, const float* __restrict__ b,
            int64_t sbk, int64_t sbn, float* __restrict__ c, int64_t scm, int64_t scn,
            int64_t split_stride, int m, int n, int k, int k_chunk) {
  __shared__ __align__(16) float a_tile[kTileK][kTileM + 4];  // [k][m]
  __shared__ __align__(16) float b_tile[kTileK][kTileN + 4];  // [k][n]
  const int m0 = blockIdx.x * kTileM;
  const int n0 = blockIdx.y * kTileN;
  const int k_begin = blockIdx.z * k_chunk;
  const int k_end = min(k, k_begin + k_chunk);
  const int tn = threadIdx.x % (kTileN / 4);
  const int tm = threadIdx.x / (kTileN / 4);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += kTileK) {
    __syncthreads();  // the previous tiles are consumed
    fill<kTileM>(a_tile, a, sam, sak, m0, m, k0, k_end);
    // B[k, n] as rows n, columns k: strides (sbn, sbk)
    fill<kTileN>(b_tile, b, sbn, sbk, n0, n, k0, k_end);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTileK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&a_tile[kk][tm * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&b_tile[kk][tn * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
  }

  float* out = c + blockIdx.z * split_stride;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + tm * 4 + i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tn * 4 + j;
      if (col < n) out[row * scm + col * scn] = acc[i][j];
    }
  }
}

// C[i] = sum over splits s, in order, of ws[s][i]; ws is [splits, M, N]
__global__ void __launch_bounds__(kReduceThreads)
reduce_splits_kernel(const float* __restrict__ ws, int splits, int m, int n,
                     float* __restrict__ c, int64_t scm, int64_t scn) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kReduceThreads + threadIdx.x;
  const int64_t size = static_cast<int64_t>(m) * n;
  if (i >= size) return;
  float sum = 0.f;
  for (int s = 0; s < splits; ++s) sum += ws[s * size + i];
  c[(i / n) * scm + (i % n) * scn] = sum;
}

// ------------------------------------------------------------ bf16 weights

// an f32 weight, element (i, j) at w + i*s0 + j*s1, rounded to bf16 into
// out [rows, padded(cols)] with zeros past cols
struct CastJob {
  const float* w;
  int64_t s0, s1;
  int rows, cols;
  bf16* out;
};

// grid (column tiles, row tiles, job): 32 x 32 tiles through shared memory,
// read along the weight's unit stride and written along out's rows
__global__ void __launch_bounds__(256) cast_weights_kernel(CastJob j0, CastJob j1) {
  __shared__ float tile[32][33];
  const CastJob& j = blockIdx.z == 0 ? j0 : j1;
  const int64_t ld = (j.cols + 7) / 8 * 8;
  const int i0 = blockIdx.y * 32;
  const int c0 = blockIdx.x * 32;
  if (i0 >= j.rows || c0 >= ld) return;
  const int tx = threadIdx.x % 32;
  const int ty = threadIdx.x / 32;
  for (int r = ty; r < 32; r += 8) {
    // neighbouring threads on neighbouring addresses, whichever the layout
    const int i = j.s1 == 1 ? i0 + r : i0 + tx;
    const int c = j.s1 == 1 ? c0 + tx : c0 + r;
    const float v = i < j.rows && c < j.cols ? j.w[i * j.s0 + c * j.s1] : 0.f;
    if (j.s1 == 1)
      tile[r][tx] = v;
    else
      tile[tx][r] = v;
  }
  __syncthreads();
  for (int r = ty; r < 32; r += 8) {
    const int i = i0 + r;
    const int c = c0 + tx;
    if (i < j.rows && c < ld) j.out[i * ld + c] = __float2bfloat16(tile[r][tx]);
  }
}

// w_qkv [C, 3*H*ch] and w_out [H*ch, C_out] (f32, through their strides)
// rounded to bf16 into ws: w_qkv at ws, [C, padded(3*H*ch)], then w_out at
// ws + C*padded(3*H*ch), [H*ch, padded(C_out)]
cudaError_t cast_weights(const float* w_qkv, int64_t wq0, int64_t wq1, const float* w_out,
                         int64_t wo0, int64_t wo1, int channels, int width, int out_channels,
                         bf16* ws, cudaStream_t stream) {
  const CastJob jq{w_qkv, wq0, wq1, channels, 3 * width, ws};
  const CastJob jo{w_out, wo0, wo1, width, out_channels, ws + channels * padded(3 * width)};
  const int64_t cols = padded(std::max(3 * width, out_channels));
  const int64_t rows = std::max(channels, width);
  const dim3 grid(static_cast<unsigned>((cols + 31) / 32), static_cast<unsigned>((rows + 31) / 32),
                  2);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  cast_weights_kernel<<<grid, 256, 0, stream>>>(jq, jo);
  return cudaGetLastError();
}

// ------------------------------------------------------- bf16 tensor cores

// kRows x kCols (kCols a multiple of 8) entries of X from (r0, c0) into a
// tile with row stride kCols + 8; rows past rows_end and columns past
// cols_end are zero. X's rows are `stride` apart with unit-stride columns.
// vec: 16-byte cp.async chunks (every row starts on 16 bytes, and entries
// past cols_end up to the next multiple of 8 are zeros or absent); otherwise
// masked scalar copies.
template <int kRows, int kCols, int kBlock = kMmaThreads>
__device__ __forceinline__ void load_tile(bf16* tile, const bf16* x, int64_t stride, int r0,
                                          int rows_end, int c0, int cols_end, bool vec) {
  constexpr int kS = kCols + 8;
  if (vec) {
    constexpr int kChunks = kCols / 8;
#pragma unroll
    for (int i = threadIdx.x; i < kRows * kChunks; i += kBlock) {
      const int r = i / kChunks;
      const int c = (i % kChunks) * 8;
      const bool in = r0 + r < rows_end && c0 + c < cols_end;
      mma::cp_async_16(tile + r * kS + c, in ? x + (r0 + r) * stride + c0 + c : x, in);
    }
  } else {
    for (int i = threadIdx.x; i < kRows * kCols; i += kBlock) {
      const int r = i / kCols;
      const int c = i % kCols;
      const bool in = r0 + r < rows_end && c0 + c < cols_end;
      tile[r * kS + c] = in ? x[(r0 + r) * stride + c0 + c] : __float2bfloat16(0.f);
    }
  }
}

// Operand layouts, fixed at compile time:
//   kAM false: A[m, k] at a + m*sa + k (K-contiguous), tile [128 m][32 k];
//       true:  A[m, k] at a + k*sa + m (M-contiguous), tile [32 k][128 m];
//   kBN false: B[k, n] at b + n*sb + k (K-contiguous), tile [128 n][32 k];
//       true:  B[k, n] at b + k*sb + n (N-contiguous), tile [32 k][128 n].
template <bool kAM>
struct ATile {
  static constexpr int kRows = kAM ? kMmaK : kMmaM;
  static constexpr int kCols = kAM ? kMmaM : kMmaK;
  static constexpr int kStride = kCols + 8;
  static constexpr int kElems = kRows * kStride;
};

template <bool kBN>
struct BTile {
  static constexpr int kRows = kBN ? kMmaK : kMmaN;
  static constexpr int kCols = kBN ? kMmaN : kMmaK;
  static constexpr int kStride = kCols + 8;
  static constexpr int kElems = kRows * kStride;
};

// an f32 accumulator pair (row, col), (row, col + 1) into C
template <typename TC>
__device__ __forceinline__ void store_pair(TC* c, int64_t scm, int64_t scn, int row, int col,
                                           int m, int n, float lo, float hi);

template <>
__device__ __forceinline__ void store_pair<bf16>(bf16* c, int64_t scm, int64_t scn, int row,
                                                 int col, int m, int n, float lo, float hi) {
  if (row >= m || col >= n) return;
  bf16* p = c + row * scm + col * scn;
  if (scn == 1 && col + 1 < n && reinterpret_cast<uintptr_t>(p) % 4 == 0) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(lo, hi);
    return;
  }
  *p = __float2bfloat16(lo);
  if (col + 1 < n) p[scn] = __float2bfloat16(hi);
}

template <>
__device__ __forceinline__ void store_pair<float>(float* c, int64_t scm, int64_t scn, int row,
                                                  int col, int m, int n, float lo, float hi) {
  if (row >= m || col >= n) return;
  float* p = c + row * scm + col * scn;
  if (scn == 1 && col + 1 < n && reinterpret_cast<uintptr_t>(p) % 8 == 0) {
    *reinterpret_cast<float2*>(p) = make_float2(lo, hi);
    return;
  }
  *p = lo;
  if (col + 1 < n) p[scn] = hi;
}

// grid (M tiles, N tiles, splits); split z sums K rows [z*k_chunk,
// (z+1)*k_chunk) into C + z*split_stride
template <bool kAM, bool kBN, typename TC>
__global__ void __launch_bounds__(kMmaThreads, 2)
mma_gemm_kernel(const bf16* __restrict__ a, int64_t sa, bool a_vec, const bf16* __restrict__ b,
                int64_t sb, bool b_vec, TC* __restrict__ c, int64_t scm, int64_t scn,
                int64_t split_stride, int m, int n, int k, int k_chunk) {
  using TA = ATile<kAM>;
  using TB = BTile<kBN>;
  __shared__ __align__(16) bf16 sa_tiles[2][TA::kElems];
  __shared__ __align__(16) bf16 sb_tiles[2][TB::kElems];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wm = (warp & 3) * 32;   // the warp's first row of the C tile
  const int wn = (warp >> 2) * 64;  // and first column
  const int m0 = blockIdx.x * kMmaM;
  const int n0 = blockIdx.y * kMmaN;
  const int k_begin = blockIdx.z * k_chunk;
  const int k_end = min(k, k_begin + k_chunk);
  const int n_steps = k_end > k_begin ? (k_end - k_begin + kMmaK - 1) / kMmaK : 0;

  auto fill = [&](int stage, int k0) {
    if (kAM)
      load_tile<TA::kRows, TA::kCols>(sa_tiles[stage], a, sa, k0, k_end, m0, m, a_vec);
    else
      load_tile<TA::kRows, TA::kCols>(sa_tiles[stage], a, sa, m0, m, k0, k_end, a_vec);
    if (kBN)
      load_tile<TB::kRows, TB::kCols>(sb_tiles[stage], b, sb, k0, k_end, n0, n, b_vec);
    else
      load_tile<TB::kRows, TB::kCols>(sb_tiles[stage], b, sb, n0, n, k0, k_end, b_vec);
  };

  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[mi][j][0] = acc[mi][j][1] = acc[mi][j][2] = acc[mi][j][3] = 0.f;

  if (n_steps > 0) fill(0, k_begin);
  mma::cp_async_commit();
  for (int step = 0; step < n_steps; ++step) {
    const int stage = step & 1;
    if (step + 1 < n_steps) fill(stage ^ 1, k_begin + (step + 1) * kMmaK);
    mma::cp_async_commit();
    mma::cp_async_wait<1>();  // this step's tiles have landed
    __syncthreads();
    const bf16* ta = sa_tiles[stage];
    const bf16* tb = sb_tiles[stage];
#pragma unroll
    for (int ks = 0; ks < kMmaK; ks += 16) {
      uint32_t af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = wm + mi * 16;
        if (kAM)  // [k][m]: the 8 x 8 blocks (m, k) = (0, 0), (8, 0), (0, 8), (8, 8)
          mma::ldsm_x4_trans(af[mi], ta + (ks + (lane & 7) + (lane >> 4) * 8) * TA::kStride + r +
                                         ((lane >> 3) & 1) * 8);
        else
          mma::load_a(af[mi], ta + r * TA::kStride, TA::kStride, ks, lane);
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bf[4];
        if (kBN)
          mma::load_b_trans(bf, tb + ks * TB::kStride, TB::kStride, wn + np * 16, lane);
        else
          mma::load_b_rows(bf, tb + (wn + np * 16) * TB::kStride, TB::kStride, ks, lane);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma::mma_16816(acc[mi][2 * np], af[mi], bf[0], bf[1]);
          mma::mma_16816(acc[mi][2 * np + 1], af[mi], bf[2], bf[3]);
        }
      }
    }
    __syncthreads();  // this stage is consumed before the next fill
  }

  TC* out = c + blockIdx.z * split_stride;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const int row = m0 + wm + mi * 16 + g;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + wn + j * 8 + 2 * t;
      store_pair<TC>(out, scm, scn, row, col, m, n, acc[mi][j][0], acc[mi][j][1]);
      store_pair<TC>(out, scm, scn, row + 8, col, m, n, acc[mi][j][2], acc[mi][j][3]);
    }
  }
}

// ------------------------------------------- exact sums, FP64 tensor cores

constexpr int kExactM = 64;  // C tile
constexpr int kExactN = 64;
constexpr int kExactK = 16;  // K step
constexpr int kExactThreads = 128;

// c += a * b, an 8 x 8 x 4 product on the FP64 tensor cores. With g = lane
// / 4 and t = lane % 4, a is A[g][t], b is B[t][g] and c holds C[g][2t],
// C[g][2t + 1] (PTX ISA, mma.m8n8k4 with .f64).
__device__ __forceinline__ void dmma_884(double (&c)[2], double a, double b) {
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};\n"
               : "+d"(c[0]), "+d"(c[1])
               : "d"(a), "d"(b));
}

// C = A B rounded to f32 and then to bf16, with A[m, k] at a + m*sa + k and
// B[k, n] at b + k*sb + n in bf16, summed in f64: every product of two bf16
// values is exact in f64, and so is every partial sum whose terms span fewer
// than 53 bits, so the sum is the exact one whatever its order, and C is
// the exact product rounded once to f32, then to bf16. grid (M tiles, N
// tiles); a block of 4 warps, each a 32 x 32 patch (4 x 4 accumulators of
// 8 x 8 in f64), K in steps of 16 through two cp.async stages.
__global__ void __launch_bounds__(kExactThreads)
exact_gemm_kernel(const bf16* __restrict__ a, int64_t sa, bool a_vec, const bf16* __restrict__ b,
                  int64_t sb, bool b_vec, bf16* __restrict__ c, int64_t scm, int m, int n, int k) {
  constexpr int kSA = kExactK + 8;  // [64 m][16 k]
  constexpr int kSB = kExactN + 8;  // [16 k][64 n]
  __shared__ __align__(16) bf16 sa_tiles[2][kExactM * kSA];
  __shared__ __align__(16) bf16 sb_tiles[2][kExactK * kSB];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm = (warp & 1) * 32;
  const int wn = (warp >> 1) * 32;
  const int m0 = blockIdx.x * kExactM;
  const int n0 = blockIdx.y * kExactN;
  const int n_steps = (k + kExactK - 1) / kExactK;

  auto fill = [&](int stage, int k0) {
    load_tile<kExactM, kExactK, kExactThreads>(sa_tiles[stage], a, sa, m0, m, k0, k, a_vec);
    load_tile<kExactK, kExactN, kExactThreads>(sb_tiles[stage], b, sb, k0, k, n0, n, b_vec);
  };

  double acc[4][4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = 0.0;

  fill(0, 0);
  mma::cp_async_commit();
  for (int step = 0; step < n_steps; ++step) {
    const int stage = step & 1;
    if (step + 1 < n_steps) fill(stage ^ 1, (step + 1) * kExactK);
    mma::cp_async_commit();
    mma::cp_async_wait<1>();
    __syncthreads();
    const bf16* ta = sa_tiles[stage];
    const bf16* tb = sb_tiles[stage];
#pragma unroll
    for (int kk = 0; kk < kExactK; kk += 4) {
      double af[4], bf[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        af[i] = __bfloat162float(ta[(wm + i * 8 + g) * kSA + kk + t]);
        bf[i] = __bfloat162float(tb[(kk + t) * kSB + wn + i * 8 + g]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dmma_884(acc[i][j], af[i], bf[j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + wm + i * 8 + g;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      store_pair<bf16>(c, scm, 1, row, n0 + wn + j * 8 + 2 * t, m, n,
                       __double2float_rn(acc[i][j][0]), __double2float_rn(acc[i][j][1]));
  }
}

// true where an operand with this non-unit stride moves in 16-byte chunks
__host__ __forceinline__ bool chunked(const bf16* p, int64_t stride) {
  return stride % 8 == 0 && mma::aligned16(p);
}

// ---------------------------------------------------------------- launchers

// C = A B summed exactly on the FP64 tensor cores, rounded to f32 and then
// to bf16 (A K-contiguous, B N-contiguous; sa and sb their row strides)
cudaError_t exact_gemm(const bf16* a, int64_t sa, const bf16* b, int64_t sb, bf16* c,
                       int64_t scm, int m, int n, int k, cudaStream_t stream) {
  const dim3 grid((m + kExactM - 1) / kExactM, (n + kExactN - 1) / kExactN, 1);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  exact_gemm_kernel<<<grid, kExactThreads, 0, stream>>>(a, sa, chunked(a, sa), b, sb,
                                                        chunked(b, sb), c, scm, m, n, k);
  return cudaGetLastError();
}

// C = A B on the tensor cores (bf16 operands in the layouts kAM, kBN; sa
// and sb their non-unit strides), C rounded to TC, in one pass over K
template <bool kAM, bool kBN, typename TC>
cudaError_t mma_gemm(const bf16* a, int64_t sa, const bf16* b, int64_t sb, TC* c, int64_t scm,
                     int64_t scn, int m, int n, int k, cudaStream_t stream) {
  const dim3 grid((m + kMmaM - 1) / kMmaM, (n + kMmaN - 1) / kMmaN, 1);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  mma_gemm_kernel<kAM, kBN, TC><<<grid, kMmaThreads, 0, stream>>>(
      a, sa, chunked(a, sa), b, sb, chunked(b, sb), c, scm, scn, 0, m, n, k, k);
  return cudaGetLastError();
}

// C = A B in f32, the sum over K in `splits` fixed ranges through the f32
// workspace ws ([splits, M, N]) and then added in order; with one split C
// is written directly
template <bool kAM, bool kBN>
cudaError_t mma_gemm_split(const bf16* a, int64_t sa, const bf16* b, int64_t sb, float* c,
                           int64_t scm, int64_t scn, int m, int n, int k, float* ws, int splits,
                           cudaStream_t stream) {
  if (splits < 1 || splits > 65535) return cudaErrorInvalidValue;
  if (splits == 1) return mma_gemm<kAM, kBN, float>(a, sa, b, sb, c, scm, scn, m, n, k, stream);
  // whole K steps per split, so that the splits partition K
  const int k_chunk = ((k + splits - 1) / splits + kMmaK - 1) / kMmaK * kMmaK;
  const dim3 grid((m + kMmaM - 1) / kMmaM, (n + kMmaN - 1) / kMmaN, splits);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  const int64_t size = static_cast<int64_t>(m) * n;
  mma_gemm_kernel<kAM, kBN, float><<<grid, kMmaThreads, 0, stream>>>(
      a, sa, chunked(a, sa), b, sb, chunked(b, sb), ws, n, 1, size, m, n, k, k_chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t blocks = (size + kReduceThreads - 1) / kReduceThreads;
  reduce_splits_kernel<<<static_cast<unsigned>(blocks), kReduceThreads, 0, stream>>>(
      ws, splits, m, n, c, scm, scn);
  return cudaGetLastError();
}

// C = A B in f32 on CUDA cores, in one pass over K
cudaError_t gemm(const float* a, int64_t sam, int64_t sak, const float* b, int64_t sbk,
                 int64_t sbn, float* c, int64_t scm, int64_t scn, int m, int n, int k,
                 cudaStream_t stream) {
  const dim3 grid((m + kTileM - 1) / kTileM, (n + kTileN - 1) / kTileN, 1);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  gemm_kernel<<<grid, kThreads, 0, stream>>>(a, sam, sak, b, sbk, sbn, c, scm, scn, 0, m, n, k,
                                             k);
  return cudaGetLastError();
}

// C = A B in f32 on CUDA cores with K split `splits` ways through ws
// ([splits, M, N]); with one split C is written directly
cudaError_t gemm_split(const float* a, int64_t sam, int64_t sak, const float* b, int64_t sbk,
                       int64_t sbn, float* c, int64_t scm, int64_t scn, int m, int n, int k,
                       float* ws, int splits, cudaStream_t stream) {
  if (splits < 1 || splits > 65535) return cudaErrorInvalidValue;
  if (splits == 1) return gemm(a, sam, sak, b, sbk, sbn, c, scm, scn, m, n, k, stream);
  // whole K tiles per split, so that the splits partition K
  const int k_chunk = ((k + splits - 1) / splits + kTileK - 1) / kTileK * kTileK;
  const dim3 grid((m + kTileM - 1) / kTileM, (n + kTileN - 1) / kTileN, splits);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  const int64_t size = static_cast<int64_t>(m) * n;
  gemm_kernel<<<grid, kThreads, 0, stream>>>(a, sam, sak, b, sbk, sbn, ws, n, 1, size, m, n, k,
                                             k_chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t blocks = (size + kReduceThreads - 1) / kReduceThreads;
  reduce_splits_kernel<<<static_cast<unsigned>(blocks), kReduceThreads, 0, stream>>>(
      ws, splits, m, n, c, scm, scn);
  return cudaGetLastError();
}

}  // namespace

}  // namespace block_gemm
