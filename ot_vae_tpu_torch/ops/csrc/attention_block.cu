// Fused attention block forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_block_fwd_kernel` (ot_vae_tpu/ops/attention_pallas.py),
// reached through `fused_attention_block`. Same function, with the block's
// normalization outside:
//
//   x     [B, T, C]         the normalized block input (f32 or bf16)
//   w_qkv [C, 3*H*ch]       f32, read through its strides (q | k | v columns)
//   w_out [H*ch, C_out]     f32, read through its strides
//   out   [B, T, C_out]     attention(x w_qkv) w_out, in x's dtype
//   lse   [B, T, H]         f32 log-sum-exp of the scaled logits
//
// with the weights rounded to x's dtype, qkv and the attention output
// rounded to x's dtype, and every product accumulated in f32.
//
// Design. The TPU kernel keeps one batch element's qkv [T, 3*H*ch] and its
// per-head outputs in VMEM and runs the two projections inside its grid
// program. Here the call is three launches on one stream:
//   1. qkv = x w_qkv into a workspace [B*T, 3*H*ch] (block_gemm.cuh);
//   2. the packed attention forward (attention_packed_fwd.cuh, the kernel of
//      attention_packed.cu) on that workspace, writing attn [B*T, H*ch] and
//      lse;
//   3. out = attn w_out (block_gemm.cuh), one f32 sum over every head's
//      columns, which is the TPU kernel's per-head sum in another order.
// Keeping qkv out of device memory, as the TPU does, would need each query
// tile's block to project every K/V row itself: T/64 times the projection
// work at T=1024 (as many FLOPs as the attention). An f32 [rows, C_out]
// accumulator for the per-head output product would not fit beside the
// attention kernel's one-row-per-thread layout either (128 rows x 512 f32 =
// 256 KB). The workspaces cost 2 * B*T*4*H*ch bytes of traffic (about 0.1
// GB at the largest block), a few hundredths of a millisecond at 3.35 TB/s
// against milliseconds of CUDA-core arithmetic.
//
// What bounds it: at the FFHQ128 decoder's 32x32 block (B=64, T=1024, H=2,
// ch=64, C=C_out=128) the function needs 4*T^2*H*ch + 2*T*C*3*H*ch +
// 2*T*H*ch*C_out = 6.7e8 FLOP per batch element, 4.3e10 in all, against
// 34 MB of input and output, so the card's bound is the tensor-core rate
// (0.043 ms). These kernels use no tensor cores and are far above it.

#include "attention_packed_fwd.cuh"
#include "block_gemm.cuh"

namespace {

template <typename T>
cudaError_t block_fwd(const T* x, const float* w_qkv, int64_t wq0, int64_t wq1,
                      const float* w_out, int64_t wo0, int64_t wo1, T* out, float* lse, T* qkv,
                      T* attn, int batch, int seq, int channels, int heads, int head_dim,
                      int out_channels, float scale, cudaStream_t stream) {
  const int rows = batch * seq;
  const int width = heads * head_dim;
  cudaError_t err = block_gemm::gemm<T, float, T, T>(
      x, channels, 1, w_qkv, wq0, wq1, qkv, 3 * width, 1, rows, 3 * width, channels, stream);
  if (err != cudaSuccess) return err;
  err = packed_fwd::dispatch<T>(head_dim, qkv, attn, lse, batch, seq, heads, scale, stream);
  if (err != cudaSuccess) return err;
  return block_gemm::gemm<T, float, T, T>(attn, width, 1, w_out, wo0, wo1, out, out_channels,
                                          1, rows, out_channels, width, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, out and the workspaces qkv [B*T,
// 3*H*ch] and attn [B*T, H*ch]); the weights are f32, element (i, j) of
// w_qkv at w_qkv + i*wq0 + j*wq1, of w_out at w_out + i*wo0 + j*wo1.
// Returns a cudaError_t (0 on success).
extern "C" int attention_block_fwd(const void* x, const void* w_qkv, int64_t wq0, int64_t wq1,
                                   const void* w_out, int64_t wo0, int64_t wo1, void* out,
                                   void* lse, void* qkv, void* attn, int batch, int seq,
                                   int channels, int heads, int head_dim, int out_channels,
                                   float scale, int dtype, void* stream) {
  if (batch < 1 || seq < 1 || heads < 1 || channels < 1 || out_channels < 1 ||
      batch > 65535 || heads > 65535 || static_cast<int64_t>(batch) * seq > INT32_MAX)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wq = static_cast<const float*>(w_qkv);
  const float* wo = static_cast<const float*>(w_out);
  float* lse_f = static_cast<float*>(lse);
  if (dtype == 0)
    return block_fwd<float>(static_cast<const float*>(x), wq, wq0, wq1, wo, wo0, wo1,
                            static_cast<float*>(out), lse_f, static_cast<float*>(qkv),
                            static_cast<float*>(attn), batch, seq, channels, heads, head_dim,
                            out_channels, scale, s);
  if (dtype == 1)
    return block_fwd<__nv_bfloat16>(
        static_cast<const __nv_bfloat16*>(x), wq, wq0, wq1, wo, wo0, wo1,
        static_cast<__nv_bfloat16*>(out), lse_f, static_cast<__nv_bfloat16*>(qkv),
        static_cast<__nv_bfloat16*>(attn), batch, seq, channels, heads, head_dim, out_channels,
        scale, s);
  return cudaErrorInvalidValue;
}
