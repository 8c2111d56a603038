// Tiled matrix product on CUDA cores for the fused attention block
// (attention_block.cu, attention_block_bwd.cu): its four projections and
// their gradients.
//
//   C[m, n] = sum_k A[m, k] * B[k, n]
//
// A, B and C are addressed through element strides, so one kernel reads a
// row-major activation, a weight in either of its layouts ([in, out] as the
// JAX package holds it, or the [out, in] view of a 1x1 convolution's
// weight) and the transposed operands of the weight gradients, all without
// a copy. Each operand value is rounded to the compute dtype R as it is read
// (the TPU kernel casts the f32 weights to x's dtype in its body; for
// activations already in R the rounding changes nothing); products and sums
// are f32 and C is rounded once, to its own type.
//
// Design: a 64 x 64 tile of C per block of 256 threads, each thread owning a
// 4 x 4 patch in registers; K runs in steps of 16 through shared memory as
// f32. A tile is loaded with the fastest-moving index on the operand's unit
// stride, so neighbouring threads read neighbouring addresses whichever
// layout the operand has.
//
// Split K, without atomics. A weight gradient sums over every row of the
// batch (B*T up to 131072) into a C of a few hundred thousand entries, too
// few tiles to fill 132 SMs. The TPU carried the sum across its sequential
// grid; here `splits` blocks each sum a fixed, contiguous range of K into
// their own f32 slice of a workspace, and a second kernel adds the slices in
// order. The order of every sum is fixed by the shape, so a run repeats bit
// for bit.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace block_gemm {

constexpr int kTileM = 64;
constexpr int kTileN = 64;
constexpr int kTileK = 16;
constexpr int kThreads = 256;
constexpr int kReduceThreads = 256;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// an f32 value rounded to R
template <typename R>
__device__ __forceinline__ float round_as(float x);
template <>
__device__ __forceinline__ float round_as<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_as<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// rows x cols values of X at (r0, c0) into tile[col][row] as f32 rounded to
// R; outside (rows_end, cols_end) zeros. `sr` and `sc` are X's strides.
template <typename R, int kRows, typename TX>
__device__ __forceinline__ void fill(float (*tile)[kRows + 4], const TX* x, int64_t sr,
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
    tile[c][r] = in ? round_as<R>(to_float(x[(r0 + r) * sr + (c0 + c) * sc])) : 0.f;
  }
}

// grid (M tiles, N tiles, splits); split z sums K rows [z*k_chunk,
// (z+1)*k_chunk) into C + z*split_stride
template <typename TA, typename TB, typename TC, typename R>
__global__ void __launch_bounds__(kThreads)
gemm_kernel(const TA* __restrict__ a, int64_t sam, int64_t sak, const TB* __restrict__ b,
            int64_t sbk, int64_t sbn, TC* __restrict__ c, int64_t scm, int64_t scn,
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
    fill<R, kTileM>(a_tile, a, sam, sak, m0, m, k0, k_end);
    // B[k, n] as rows n, columns k: strides (sbn, sbk)
    fill<R, kTileN>(b_tile, b, sbn, sbk, n0, n, k0, k_end);
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

  TC* out = c + blockIdx.z * split_stride;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + tm * 4 + i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tn * 4 + j;
      if (col < n) store(out + row * scm + col * scn, acc[i][j]);
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

// C = A B rounded to TC, in one pass over K
template <typename TA, typename TB, typename TC, typename R>
cudaError_t gemm(const TA* a, int64_t sam, int64_t sak, const TB* b, int64_t sbk,
                 int64_t sbn, TC* c, int64_t scm, int64_t scn, int m, int n, int k,
                 cudaStream_t stream) {
  const dim3 grid((m + kTileM - 1) / kTileM, (n + kTileN - 1) / kTileN, 1);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  gemm_kernel<TA, TB, TC, R><<<grid, kThreads, 0, stream>>>(
      a, sam, sak, b, sbk, sbn, c, scm, scn, 0, m, n, k, k);
  return cudaGetLastError();
}

// C = A B in f32 with K split `splits` ways through the f32 workspace `ws`
// ([splits, M, N]); with one split C is written directly
template <typename TA, typename TB, typename R>
cudaError_t gemm_split(const TA* a, int64_t sam, int64_t sak, const TB* b, int64_t sbk,
                       int64_t sbn, float* c, int64_t scm, int64_t scn, int m, int n, int k,
                       float* ws, int splits, cudaStream_t stream) {
  if (splits < 1 || splits > 65535) return cudaErrorInvalidValue;
  if (splits == 1) return gemm<TA, TB, float, R>(a, sam, sak, b, sbk, sbn, c, scm, scn, m, n, k,
                                                 stream);
  // whole K tiles per split, so that the splits partition K
  const int k_chunk = ((k + splits - 1) / splits + kTileK - 1) / kTileK * kTileK;
  const dim3 grid((m + kTileM - 1) / kTileM, (n + kTileN - 1) / kTileN, splits);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  const int64_t size = static_cast<int64_t>(m) * n;
  gemm_kernel<TA, TB, float, R><<<grid, kThreads, 0, stream>>>(
      a, sam, sak, b, sbk, sbn, ws, n, 1, size, m, n, k, k_chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t blocks = (size + kReduceThreads - 1) / kReduceThreads;
  reduce_splits_kernel<<<static_cast<unsigned>(blocks), kReduceThreads, 0, stream>>>(
      ws, splits, m, n, c, scm, scn);
  return cudaGetLastError();
}

}  // namespace block_gemm
