// Fused attention block backward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_block_bwd_kernel` (ot_vae_tpu/ops/attention_pallas.py),
// reached through `_fused_block_bwd`, the VJP of `fused_attention_block`.
// Same function: from the forward's residuals x, w_qkv, w_out, lse and the
// output's gradient dout [B, T, C_out],
//
//   dx     [B, T, C]        in x's dtype
//   dw_qkv [C, 3*H*ch]      f32, summed over the batch
//   dw_out [H*ch, C_out]    f32, summed over the batch
//
// with qkv and the per-head attention output recomputed and rounded to x's
// dtype, dattn = dout w_out^T rounded to x's dtype, the packed attention
// backward of (qkv, attn, lse, dattn) giving dqkv rounded to x's dtype,
// dx = dqkv w_qkv^T, dw_qkv = x^T dqkv and dw_out = attn^T dout.
//
// Design: one call, seven to nine launches on one stream, no atomics:
//   1. qkv = x w_qkv (block_gemm.cuh), as the forward;
//   2. attn recomputed from lse, as the TPU kernel recomputes it: per query
//      row P = exp(scale*QK^T - lse) rounded to x's dtype, attn = P V in f32
//      rounded to x's dtype (attn_from_lse_kernel below, laid out as the
//      packed backward's kernels: rows split over 1 to 8 threads, K and V
//      tiles streamed through shared memory). Rounding P as the plain
//      version does matters: D = rowsum(dattn * attn) shifts every dS of a
//      row alike, so a bias in attn adds up over the keys in dq and dk
//      rather than averaging out;
//   3. dattn = dout w_out^T (block_gemm.cuh);
//   4. dqkv by the packed attention backward (attention_packed_bwd.cuh, the
//      kernels of attention_packed_bwd.cu) with attn in out's place and
//      dattn in dout's, two kernels that write their own columns;
//   5. dx = dqkv w_qkv^T;
//   6. dw_qkv = x^T dqkv and dw_out = attn^T dout, each summed over all B*T
//      rows. The TPU accumulated these across its sequential grid; here the
//      rows are split into fixed ranges summed by separate blocks into an
//      f32 workspace, then added in order (block_gemm.cuh), so two runs on
//      the same inputs give the same bits.
//
// What bounds it: at the decoder's 32x32 block at the train batch (B=128,
// T=1024, H=2, ch=64, C=C_out=128) the function needs 10*T^2*H*ch +
// 4*T*C*3*H*ch + 4*T*H*ch*C_out = 1.6e9 FLOP per batch element, 2.1e11 in
// all, against about 100 MB of input and output, so the card's bound is the
// tensor-core rate (0.21 ms). These kernels use no tensor cores and are far
// above it.

#include "attention_packed_bwd.cuh"
#include "block_gemm.cuh"

namespace {

using packed_bwd::kThreads;
using packed_bwd::kTile;

// attn [B, T, H*ch] = (exp(scale*QK^T - lse) rounded to T) V, rounded to T,
// from the packed qkv; grid (query tile, head, batch). C is the width the
// kernel is built for, `ch` the tensors' head dim (C unless kTail).
template <typename T, int C, bool kTail>
__global__ void __launch_bounds__(kThreads)
attn_from_lse_kernel(const T* __restrict__ qkv, const float* __restrict__ lse,
                     T* __restrict__ attn, int seq, int heads, int ch, float scale) {
  using S = packed_bwd::Split<C>;
  constexpr int R = S::kRowThreads;
  __shared__ float k_tile[kTile][C];
  __shared__ float v_tile[kTile][C];

  const int cw = kTail ? ch : C;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int row = blockIdx.x * S::kRows + threadIdx.x / R;
  const int part = threadIdx.x % R;
  const int64_t width = 3LL * heads * cw;
  const T* qkv_b = qkv + static_cast<int64_t>(b) * seq * width;
  const bool valid = row < seq;

  float q[S::kDims], o[S::kDims];
  float lse_i = 0.f;
#pragma unroll
  for (int i = 0; i < S::kDims; ++i) {
    q[i] = 0.f;
    o[i] = 0.f;
  }
  if (valid) {
    const T* q_row = qkv_b + row * width + h * cw;
#pragma unroll
    for (int i = 0; i < S::kDims; ++i)
      if (!kTail || part + R * i < cw) q[i] = packed_bwd::to_float(q_row[part + R * i]);
    lse_i = lse[(static_cast<int64_t>(b) * seq + row) * heads + h];
  }

  for (int k0 = 0; k0 < seq; k0 += kTile) {
    __syncthreads();  // the previous tiles are consumed
    packed_bwd::fill_tile<T, C>(k_tile, qkv_b, width, heads * cw + h * cw, k0, seq, cw);
    packed_bwd::fill_tile<T, C>(v_tile, qkv_b, width, 2 * heads * cw + h * cw, k0, seq, cw);
    __syncthreads();
    const int n_keys = min(kTile, seq - k0);
#pragma unroll 2
    for (int j = 0; j < n_keys; ++j) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < S::kDims; ++i) s = fmaf(q[i], k_tile[j][part + R * i], s);
      s = packed_bwd::row_sum<R>(s);
      const float p = packed_bwd::round_as<T>(expf(s * scale - lse_i));
#pragma unroll
      for (int i = 0; i < S::kDims; ++i) o[i] = fmaf(p, v_tile[j][part + R * i], o[i]);
    }
  }

  if (!valid) return;
  T* o_row = attn + (static_cast<int64_t>(b) * seq + row) * heads * cw + h * cw;
#pragma unroll
  for (int i = 0; i < S::kDims; ++i)
    if (!kTail || part + R * i < cw) packed_bwd::store(o_row + part + R * i, o[i]);
}

template <typename T, int C, bool kTail>
cudaError_t launch_attn(const T* qkv, const float* lse, T* attn, int batch, int seq, int heads,
                        int head_dim, float scale, cudaStream_t stream) {
  constexpr int kRows = packed_bwd::Split<C>::kRows;
  const dim3 grid((seq + kRows - 1) / kRows, heads, batch);
  attn_from_lse_kernel<T, C, kTail><<<grid, kThreads, 0, stream>>>(qkv, lse, attn, seq, heads,
                                                                   head_dim, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t attn_from_lse(const T* qkv, const float* lse, T* attn, int batch, int seq,
                          int heads, int head_dim, float scale, cudaStream_t stream) {
#define CASE(C, TAIL) \
  case C:             \
    return launch_attn<T, C, TAIL>(qkv, lse, attn, batch, seq, heads, head_dim, scale, stream);
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

template <typename T>
cudaError_t block_bwd(const T* x, const float* w_qkv, int64_t wq0, int64_t wq1,
                      const float* w_out, int64_t wo0, int64_t wo1, const float* lse,
                      const T* dout, T* dx, float* dw_qkv, int64_t dq0, int64_t dq1,
                      float* dw_out, int64_t do0, int64_t do1, T* qkv, T* attn, T* dattn,
                      T* dqkv, float* delta, float* split_ws, int splits_qkv, int splits_out,
                      int batch, int seq, int channels, int heads, int head_dim,
                      int out_channels, float scale, cudaStream_t stream) {
  const int rows = batch * seq;
  const int width = heads * head_dim;
  cudaError_t err = block_gemm::gemm<T, float, T, T>(
      x, channels, 1, w_qkv, wq0, wq1, qkv, 3 * width, 1, rows, 3 * width, channels, stream);
  if (err != cudaSuccess) return err;
  err = attn_from_lse<T>(qkv, lse, attn, batch, seq, heads, head_dim, scale, stream);
  if (err != cudaSuccess) return err;
  // dattn[r, p] = sum_o dout[r, o] w_out[p, o]
  err = block_gemm::gemm<T, float, T, T>(dout, out_channels, 1, w_out, wo1, wo0, dattn, width,
                                         1, rows, width, out_channels, stream);
  if (err != cudaSuccess) return err;
  err = packed_bwd::dispatch<T>(head_dim, qkv, attn, lse, dattn, dqkv, delta, batch, seq, heads,
                                scale, stream);
  if (err != cudaSuccess) return err;
  // dx[r, c] = sum_n dqkv[r, n] w_qkv[c, n]
  err = block_gemm::gemm<T, float, T, T>(dqkv, 3 * width, 1, w_qkv, wq1, wq0, dx, channels, 1,
                                         rows, channels, 3 * width, stream);
  if (err != cudaSuccess) return err;
  // dw_qkv[c, n] = sum_r x[r, c] dqkv[r, n]
  err = block_gemm::gemm_split<T, T, T>(x, 1, channels, dqkv, 3 * width, 1, dw_qkv, dq0, dq1,
                                        channels, 3 * width, rows, split_ws, splits_qkv, stream);
  if (err != cudaSuccess) return err;
  // dw_out[p, o] = sum_r attn[r, p] dout[r, o]; the workspace is free again
  return block_gemm::gemm_split<T, T, T>(attn, 1, width, dout, out_channels, 1, dw_out, do0,
                                         do1, width, out_channels, rows, split_ws, splits_out,
                                         stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, dout, dx and the workspaces qkv and
// dqkv [B*T, 3*H*ch], attn and dattn [B*T, H*ch]); the weights and their
// gradients are f32 and addressed through strides, element (i, j) of w_qkv
// at w_qkv + i*wq0 + j*wq1 (dw_qkv: dq0, dq1; w_out: wo0, wo1; dw_out: do0,
// do1). delta is f32 [B*T, H] scratch; split_ws is f32 scratch
// of max(splits_qkv * C * 3*H*ch, splits_out * H*ch * C_out) entries (none
// needed where both splits are 1). Returns a cudaError_t (0 on success).
extern "C" int attention_block_bwd(
    const void* x, const void* w_qkv, int64_t wq0, int64_t wq1, const void* w_out, int64_t wo0,
    int64_t wo1, const void* lse, const void* dout, void* dx, void* dw_qkv, int64_t dq0,
    int64_t dq1, void* dw_out, int64_t do0, int64_t do1, void* qkv, void* attn, void* dattn,
    void* dqkv, void* delta, void* split_ws, int splits_qkv, int splits_out, int batch,
    int seq, int channels, int heads, int head_dim, int out_channels, float scale, int dtype,
    void* stream) {
  if (batch < 1 || seq < 1 || heads < 1 || channels < 1 || out_channels < 1 ||
      batch > 65535 || heads > 65535 || static_cast<int64_t>(batch) * seq > INT32_MAX)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wq = static_cast<const float*>(w_qkv);
  const float* wo = static_cast<const float*>(w_out);
  const float* lse_f = static_cast<const float*>(lse);
  float* dwq = static_cast<float*>(dw_qkv);
  float* dwo = static_cast<float*>(dw_out);
  float* delta_f = static_cast<float*>(delta);
  float* split = static_cast<float*>(split_ws);
  if (dtype == 0) {
    using T = float;
    return block_bwd<T>(static_cast<const T*>(x), wq, wq0, wq1, wo, wo0, wo1, lse_f,
                        static_cast<const T*>(dout), static_cast<T*>(dx), dwq, dq0, dq1, dwo,
                        do0, do1, static_cast<T*>(qkv), static_cast<T*>(attn),
                        static_cast<T*>(dattn), static_cast<T*>(dqkv), delta_f, split,
                        splits_qkv, splits_out, batch, seq, channels, heads, head_dim,
                        out_channels, scale, s);
  }
  if (dtype == 1) {
    using T = __nv_bfloat16;
    return block_bwd<T>(static_cast<const T*>(x), wq, wq0, wq1, wo, wo0, wo1, lse_f,
                        static_cast<const T*>(dout), static_cast<T*>(dx), dwq, dq0, dq1, dwo,
                        do0, do1, static_cast<T*>(qkv), static_cast<T*>(attn),
                        static_cast<T*>(dattn), static_cast<T*>(dqkv), delta_f, split,
                        splits_qkv, splits_out, batch, seq, channels, heads, head_dim,
                        out_channels, scale, s);
  }
  return cudaErrorInvalidValue;
}
