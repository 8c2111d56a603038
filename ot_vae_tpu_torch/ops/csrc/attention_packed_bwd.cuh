// Device code of the packed-qkv attention backward (see attention_packed_bwd.cu).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace packed_bwd {

constexpr int kThreads = 128;
constexpr int kTile = 32;  // rows of the streamed operands per shared-memory tile

template <int C>
struct Split {
  static_assert(C >= 1 && C <= 128, "head dim must be 1 to 128");
  static constexpr int kRowThreads = C <= 16 ? 1 : C <= 32 ? 2 : C <= 64 ? 4 : 8;
  static constexpr int kDims = C / kRowThreads;   // dims each thread owns
  static constexpr int kRows = kThreads / kRowThreads;  // rows per block
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// an f32 value rounded to T (the plain version's casts of P and dS)
template <typename T>
__device__ __forceinline__ float round_as(float x);
template <>
__device__ __forceinline__ float round_as<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_as<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// sum over the R neighbouring lanes that share a row
template <int R>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = R / 2; o > 0; o /= 2) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// copy kTile rows of C values at column `col` of rows r0.. into shared memory
// as f32; rows past `seq` and dims past `cw` become zeros
template <typename T, int C>
__device__ __forceinline__ void fill_tile(float (*tile)[C], const T* base,
                                          int64_t stride, int col, int r0, int seq,
                                          int cw) {
  for (int i = threadIdx.x; i < kTile * C; i += kThreads) {
    const int r = i / C;
    const int c = i % C;
    tile[r][c] = r0 + r < seq && c < cw ? to_float(base[(r0 + r) * stride + col + c]) : 0.f;
  }
}

// C is the width the kernels are built for; `ch` the head dim of the
// tensors, equal to C unless kTail (then ch <= C, the dims past ch masked)
template <typename T, int C, bool kTail>
__global__ void __launch_bounds__(kThreads)
attention_packed_dq_kernel(const T* __restrict__ qkv, const T* __restrict__ out,
                           const float* __restrict__ lse, const T* __restrict__ dout,
                           T* __restrict__ dqkv, float* __restrict__ delta,
                           int seq, int heads, int ch, float scale) {
  using S = Split<C>;
  constexpr int R = S::kRowThreads;
  __shared__ float k_tile[kTile][C];
  __shared__ float v_tile[kTile][C];

  const int cw = kTail ? ch : C;  // the tensors' head dim
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int row = blockIdx.x * S::kRows + threadIdx.x / R;
  const int part = threadIdx.x % R;
  const int64_t width = 3LL * heads * cw;
  const int64_t o_width = static_cast<int64_t>(heads) * cw;
  const T* qkv_b = qkv + static_cast<int64_t>(b) * seq * width;
  const bool valid = row < seq;
  const int64_t stat = (static_cast<int64_t>(b) * seq + row) * heads + h;

  float q[S::kDims], d_o[S::kDims], dq[S::kDims];
  float partial = 0.f;
  float lse_i = 0.f;
#pragma unroll
  for (int i = 0; i < S::kDims; ++i) {
    q[i] = 0.f;
    d_o[i] = 0.f;
    dq[i] = 0.f;
  }
  if (valid) {
    const T* q_row = qkv_b + row * width + h * cw;
    const int64_t o_off = (static_cast<int64_t>(b) * seq + row) * o_width + h * cw;
#pragma unroll
    for (int i = 0; i < S::kDims; ++i) {
      const int c = part + R * i;
      if (kTail && c >= cw) continue;
      q[i] = to_float(q_row[c]);
      d_o[i] = to_float(dout[o_off + c]);
      partial = fmaf(d_o[i], to_float(out[o_off + c]), partial);
    }
    lse_i = lse[stat];
  }
  const float delta_i = row_sum<R>(partial);
  if (valid && part == 0) delta[stat] = delta_i;

  for (int k0 = 0; k0 < seq; k0 += kTile) {
    __syncthreads();  // the previous tiles are consumed
    fill_tile<T, C>(k_tile, qkv_b, width, heads * cw + h * cw, k0, seq, cw);
    fill_tile<T, C>(v_tile, qkv_b, width, 2 * heads * cw + h * cw, k0, seq, cw);
    __syncthreads();
    const int n_keys = min(kTile, seq - k0);
#pragma unroll 2
    for (int j = 0; j < n_keys; ++j) {
      float s = 0.f;
      float dp = 0.f;
#pragma unroll
      for (int i = 0; i < S::kDims; ++i) {
        s = fmaf(q[i], k_tile[j][part + R * i], s);
        dp = fmaf(d_o[i], v_tile[j][part + R * i], dp);
      }
      s = row_sum<R>(s);
      dp = row_sum<R>(dp);
      const float p = expf(s * scale - lse_i);
      const float ds = round_as<T>(p * (dp - delta_i) * scale);
#pragma unroll
      for (int i = 0; i < S::kDims; ++i) dq[i] = fmaf(ds, k_tile[j][part + R * i], dq[i]);
    }
  }

  if (!valid) return;
  T* dq_row = dqkv + static_cast<int64_t>(b) * seq * width + row * width + h * cw;
#pragma unroll
  for (int i = 0; i < S::kDims; ++i)
    if (!kTail || part + R * i < cw) store(dq_row + part + R * i, dq[i]);
}

template <typename T, int C, bool kTail>
__global__ void __launch_bounds__(kThreads)
attention_packed_dkdv_kernel(const T* __restrict__ qkv, const float* __restrict__ lse,
                             const T* __restrict__ dout, const float* __restrict__ delta,
                             T* __restrict__ dqkv, int seq, int heads, int ch,
                             float scale) {
  using S = Split<C>;
  constexpr int R = S::kRowThreads;
  __shared__ float q_tile[kTile][C];
  __shared__ float do_tile[kTile][C];
  __shared__ float lse_tile[kTile];
  __shared__ float delta_tile[kTile];

  const int cw = kTail ? ch : C;  // the tensors' head dim
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int row = blockIdx.x * S::kRows + threadIdx.x / R;  // key row
  const int part = threadIdx.x % R;
  const int64_t width = 3LL * heads * cw;
  const int64_t o_width = static_cast<int64_t>(heads) * cw;
  const T* qkv_b = qkv + static_cast<int64_t>(b) * seq * width;
  const T* dout_b = dout + static_cast<int64_t>(b) * seq * o_width;
  const float* lse_b = lse + static_cast<int64_t>(b) * seq * heads;
  const float* delta_b = delta + static_cast<int64_t>(b) * seq * heads;
  const int k_col = heads * cw + h * cw;
  const int v_col = 2 * heads * cw + h * cw;
  const bool valid = row < seq;

  float k[S::kDims], v[S::kDims], dk[S::kDims], dv[S::kDims];
#pragma unroll
  for (int i = 0; i < S::kDims; ++i) {
    k[i] = 0.f;
    v[i] = 0.f;
    dk[i] = 0.f;
    dv[i] = 0.f;
  }
  if (valid) {
    const T* key_row = qkv_b + row * width;
#pragma unroll
    for (int i = 0; i < S::kDims; ++i) {
      if (kTail && part + R * i >= cw) continue;
      k[i] = to_float(key_row[k_col + part + R * i]);
      v[i] = to_float(key_row[v_col + part + R * i]);
    }
  }

  for (int q0 = 0; q0 < seq; q0 += kTile) {
    __syncthreads();  // the previous tiles are consumed
    fill_tile<T, C>(q_tile, qkv_b, width, h * cw, q0, seq, cw);
    fill_tile<T, C>(do_tile, dout_b, o_width, h * cw, q0, seq, cw);
    for (int i = threadIdx.x; i < kTile; i += kThreads) {
      const bool in = q0 + i < seq;
      lse_tile[i] = in ? lse_b[static_cast<int64_t>(q0 + i) * heads + h] : 0.f;
      delta_tile[i] = in ? delta_b[static_cast<int64_t>(q0 + i) * heads + h] : 0.f;
    }
    __syncthreads();
    const int n_rows = min(kTile, seq - q0);
#pragma unroll 2
    for (int j = 0; j < n_rows; ++j) {
      float s = 0.f;
      float dp = 0.f;
#pragma unroll
      for (int i = 0; i < S::kDims; ++i) {
        s = fmaf(q_tile[j][part + R * i], k[i], s);
        dp = fmaf(do_tile[j][part + R * i], v[i], dp);
      }
      s = row_sum<R>(s);
      dp = row_sum<R>(dp);
      const float p = expf(s * scale - lse_tile[j]);
      const float p_in = round_as<T>(p);
      const float ds = round_as<T>(p * (dp - delta_tile[j]) * scale);
#pragma unroll
      for (int i = 0; i < S::kDims; ++i) {
        dv[i] = fmaf(p_in, do_tile[j][part + R * i], dv[i]);
        dk[i] = fmaf(ds, q_tile[j][part + R * i], dk[i]);
      }
    }
  }

  if (!valid) return;
  T* d_row = dqkv + static_cast<int64_t>(b) * seq * width + row * width;
#pragma unroll
  for (int i = 0; i < S::kDims; ++i) {
    if (kTail && part + R * i >= cw) continue;
    store(d_row + k_col + part + R * i, dk[i]);
    store(d_row + v_col + part + R * i, dv[i]);
  }
}

template <typename T, int C, bool kTail>
cudaError_t launch(const void* qkv, const void* out, const float* lse, const void* dout,
                   void* dqkv, float* delta, int batch, int seq, int heads, int head_dim,
                   float scale, cudaStream_t stream) {
  constexpr int kRows = Split<C>::kRows;
  const dim3 grid((seq + kRows - 1) / kRows, heads, batch);
  // the dq kernel writes D, which the dk/dv kernel reads: same stream, in order
  attention_packed_dq_kernel<T, C, kTail><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(out), lse,
      static_cast<const T*>(dout), static_cast<T*>(dqkv), delta, seq, heads, head_dim,
      scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_packed_dkdv_kernel<T, C, kTail><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(qkv), lse, static_cast<const T*>(dout), delta,
      static_cast<T*>(dqkv), seq, heads, head_dim, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int head_dim, const void* qkv, const void* out, const float* lse,
                     const void* dout, void* dqkv, float* delta, int batch, int seq,
                     int heads, float scale, cudaStream_t stream) {
#define CASE(C, TAIL)                                                                \
  case C:                                                                           \
    return launch<T, C, TAIL>(qkv, out, lse, dout, dqkv, delta, batch, seq, heads, \
                              head_dim, scale, stream);
  if (head_dim % 8 == 0) {
    switch (head_dim) {
      CASE(8, false) CASE(16, false) CASE(24, false) CASE(32, false)
      CASE(40, false) CASE(48, false) CASE(56, false) CASE(64, false)
      CASE(72, false) CASE(80, false) CASE(88, false) CASE(96, false)
      CASE(104, false) CASE(112, false) CASE(120, false) CASE(128, false)
      default:
        return cudaErrorInvalidValue;
    }
  }
  if (head_dim < 1 || head_dim > 128) return cudaErrorInvalidValue;
  int padded = 1;
  while (padded < head_dim) padded *= 2;
  switch (padded) {
    CASE(1, true) CASE(2, true) CASE(4, true) CASE(8, true)
    CASE(16, true) CASE(32, true) CASE(64, true) CASE(128, true)
    default:
      return cudaErrorInvalidValue;
  }
#undef CASE
}

}  // namespace packed_bwd
