// Device code of the packed-qkv attention forward (see attention_packed.cu).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace packed_fwd {

constexpr int kThreads = 128;
constexpr int kKeyTile = 32;
constexpr int kChunk = 8;  // keys per online-softmax step

__device__ __forceinline__ void load4(const float* p, float* dst) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  dst[0] = a.x;
  dst[1] = a.y;
  dst[2] = a.z;
  dst[3] = a.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* dst) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float2 lo = __bfloat1622float2(h[0]);
  const float2 hi = __bfloat1622float2(h[1]);
  dst[0] = lo.x;
  dst[1] = lo.y;
  dst[2] = hi.x;
  dst[3] = hi.y;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// C is the width the kernel is built for; `ch` the head dim of the tensors,
// equal to C unless kTail (then ch <= C, and the dims past ch are masked)
template <typename T, int C, bool kTail>
__global__ void __launch_bounds__(kThreads)
attention_packed_fwd_kernel(const T* __restrict__ qkv, T* __restrict__ out,
                            float* __restrict__ lse, int seq, int heads, int ch,
                            float scale) {
  constexpr int kRowThreads = C > 64 ? 2 : 1;  // threads sharing a query row
  constexpr int kDims = C / kRowThreads;        // head dims each thread owns
  constexpr int kRows = kThreads / kRowThreads; // query rows per block
  constexpr int kChunks = C / 4;                // 4-element chunks in a row
  static_assert(C <= 128 && (kTail || C % 8 == 0),
                "an exact head dim must be a multiple of 8, at most 128");
  static_assert(kDims % 4 == 0 || kTail, "per-thread dims must be whole 4-element chunks");
  static_assert(kKeyTile % kChunk == 0, "key tile must be whole chunks");

  __shared__ __align__(16) float k_tile[kKeyTile][C];
  __shared__ __align__(16) float v_tile[kKeyTile][C];

  const int cw = kTail ? ch : C;  // the tensors' head dim
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int row = blockIdx.x * kRows + threadIdx.x / kRowThreads;
  const int part = threadIdx.x % kRowThreads;
  const int64_t width = 3LL * heads * cw;
  const T* base = qkv + static_cast<int64_t>(b) * seq * width;
  const int k_col = heads * cw + h * cw;
  const int v_col = 2 * heads * cw + h * cw;
  const bool valid = row < seq;

  float q[kDims];
  float o[kDims];
#pragma unroll
  for (int d = 0; d < kDims; ++d) {
    q[d] = 0.f;
    o[d] = 0.f;
  }
  if (valid) {
    const T* q_row = base + row * width + h * cw + part * kDims;
    if constexpr (kTail) {
#pragma unroll
      for (int d = 0; d < kDims; ++d)
        if (part * kDims + d < cw) q[d] = to_float(q_row[d]);
    } else {
#pragma unroll
      for (int d = 0; d < kDims; d += 4) load4(q_row + d, q + d);
    }
  }

  float m = -INFINITY;
  float l = 0.f;
  for (int k0 = 0; k0 < seq; k0 += kKeyTile) {
    __syncthreads();  // the previous tile is consumed
    if constexpr (kTail) {
      for (int i = threadIdx.x; i < kKeyTile * C; i += kThreads) {
        const int r = i / C;
        const int c = i % C;
        const bool in = k0 + r < seq && c < cw;
        const T* key_row = base + (k0 + r) * width;
        k_tile[r][c] = in ? to_float(key_row[k_col + c]) : 0.f;
        v_tile[r][c] = in ? to_float(key_row[v_col + c]) : 0.f;
      }
    } else {
      for (int i = threadIdx.x; i < kKeyTile * kChunks; i += kThreads) {
        const int r = i / kChunks;
        const int c = (i % kChunks) * 4;
        float kv[4] = {0.f, 0.f, 0.f, 0.f};
        float vv[4] = {0.f, 0.f, 0.f, 0.f};
        if (k0 + r < seq) {
          const T* key_row = base + (k0 + r) * width;
          load4(key_row + k_col + c, kv);
          load4(key_row + v_col + c, vv);
        }
        *reinterpret_cast<float4*>(&k_tile[r][c]) = make_float4(kv[0], kv[1], kv[2], kv[3]);
        *reinterpret_cast<float4*>(&v_tile[r][c]) = make_float4(vv[0], vv[1], vv[2], vv[3]);
      }
    }
    __syncthreads();

    // keys in chunks of kChunk: the chunk loop stays rolled, so the unrolled
    // body (and the build) stays small and s[] lives in registers
    const int n_keys = min(kKeyTile, seq - k0);
#pragma unroll 1
    for (int j0 = 0; j0 < n_keys; j0 += kChunk) {
      float s[kChunk];
      float chunk_max = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const float* k_row = &k_tile[j0 + jj][part * kDims];
        float acc = 0.f;
        if constexpr (kDims % 4 == 0) {
#pragma unroll
          for (int d = 0; d < kDims; d += 4) {
            const float4 kk = *reinterpret_cast<const float4*>(k_row + d);
            acc = fmaf(q[d], kk.x, acc);
            acc = fmaf(q[d + 1], kk.y, acc);
            acc = fmaf(q[d + 2], kk.z, acc);
            acc = fmaf(q[d + 3], kk.w, acc);
          }
        } else {
#pragma unroll
          for (int d = 0; d < kDims; ++d) acc = fmaf(q[d], k_row[d], acc);
        }
        if (kRowThreads == 2) acc += __shfl_xor_sync(0xffffffffu, acc, 1);
        s[jj] = j0 + jj < n_keys ? acc * scale : -INFINITY;
        chunk_max = fmaxf(chunk_max, s[jj]);
      }

      // j0 < n_keys, so chunk_max and m_new are finite; exp(-inf) = 0 masks
      const float m_new = fmaxf(m, chunk_max);
      const float alpha = expf(m - m_new);
      l *= alpha;
#pragma unroll
      for (int d = 0; d < kDims; ++d) o[d] *= alpha;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const float p = expf(s[jj] - m_new);
        const float* v_row = &v_tile[j0 + jj][part * kDims];
        l += p;
        if constexpr (kDims % 4 == 0) {
#pragma unroll
          for (int d = 0; d < kDims; d += 4) {
            const float4 vv = *reinterpret_cast<const float4*>(v_row + d);
            o[d] = fmaf(p, vv.x, o[d]);
            o[d + 1] = fmaf(p, vv.y, o[d + 1]);
            o[d + 2] = fmaf(p, vv.z, o[d + 2]);
            o[d + 3] = fmaf(p, vv.w, o[d + 3]);
          }
        } else {
#pragma unroll
          for (int d = 0; d < kDims; ++d) o[d] = fmaf(p, v_row[d], o[d]);
        }
      }
      m = m_new;
    }
  }

  if (!valid) return;
  const float inv = 1.f / l;
  T* o_row = out + (static_cast<int64_t>(b) * seq + row) * heads * cw + h * cw + part * kDims;
#pragma unroll
  for (int d = 0; d < kDims; ++d)
    if (!kTail || part * kDims + d < cw) store(o_row + d, o[d] * inv);
  if (part == 0) lse[(static_cast<int64_t>(b) * seq + row) * heads + h] = m + logf(l);
}

template <typename T, int C, bool kTail>
cudaError_t launch(const void* qkv, void* out, float* lse, int batch, int seq,
                   int heads, int head_dim, float scale, cudaStream_t stream) {
  constexpr int kRows = kThreads / (C > 64 ? 2 : 1);
  const dim3 grid((seq + kRows - 1) / kRows, heads, batch);
  attention_packed_fwd_kernel<T, C, kTail><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out), lse, seq, heads, head_dim, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int head_dim, const void* qkv, void* out, float* lse,
                     int batch, int seq, int heads, float scale,
                     cudaStream_t stream) {
#define CASE(C, TAIL) \
  case C:             \
    return launch<T, C, TAIL>(qkv, out, lse, batch, seq, heads, head_dim, scale, stream);
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

}  // namespace packed_fwd
