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
// program. Here the call is three stages on one stream:
//   1. qkv = x w_qkv into a workspace [B*T, 3*H*ch] (block_gemm.cuh);
//   2. the packed attention forward on that workspace, writing attn
//      [B*T, H*ch] and lse;
//   3. out = attn w_out (block_gemm.cuh), one f32 sum over every head's
//      columns, which is the TPU kernel's per-head sum in another order.
// Keeping qkv out of device memory, as the TPU does, would need each query
// tile's block to project every K/V row itself: T/64 times the projection
// work at T=1024 (as many FLOPs as the attention). An f32 [rows, C_out]
// accumulator for the per-head output product would not fit beside the
// attention kernel's registers either (128 rows x 512 f32 = 256 KB). The
// workspaces cost 2 * B*T*4*H*ch bytes of traffic (about 0.1 GB at the
// largest block), a few hundredths of a millisecond at 3.35 TB/s.
//
// The dtype picks the kernels, inside this library, as in rows 1 and 2:
//   - bf16 runs on the tensor cores throughout (block_gemm.cuh): a cast
//     pass rounds both weights to bf16 into the workspace w_ws; qkv is summed
//     exactly on the FP64 tensor cores (exact_gemm_kernel) and rounded once
//     to f32, then to bf16; the attention runs row 1's attention_fwd_mma
//     (attention_fwd_mma.cuh) on the qkv workspace read through strides: q,
//     k and v at columns 0, H*ch and 2*H*ch, token stride 3*H*ch, attn and
//     lse in the packed layouts (kPacked), exactly as attention_packed.cu
//     calls it; out = attn w_out runs the bf16 mma.sync GEMM. Four launches.
//     The qkv sum is exact so that qkv rounds to the bf16 values the plain
//     version's (exact) sum rounds to, whatever the order: summed in f32 in
//     another order, some entries round to the other bf16 neighbour, and at
//     the FFHQ128 encoder's 16x16 block that moved lse by 6.5e-4 against
//     the plain version's (PERF.md), where its gate is 1e-4.
//   - f32 runs on CUDA cores (block_gemm's gemm, attention_packed_fwd.cuh):
//     tensor cores would take f32 operands as TF32, which the f32 gates
//     against the plain version do not allow. A choice of arithmetic, not a
//     size threshold: every bf16 call runs the tensor-core kernels.
//
// What bounds it: at the FFHQ128 decoder's 32x32 block (B=64, T=1024, H=2,
// ch=64, C=C_out=128) the function needs 4*T^2*H*ch + 2*T*C*3*H*ch +
// 2*T*H*ch*C_out = 6.7e8 FLOP per batch element, 4.3e10 in all, against
// 34 MB of input and output, so the card's bound is the tensor-core rate
// (0.043 ms).

#include "attention_fwd_mma.cuh"
#include "attention_packed_fwd.cuh"
#include "block_gemm.cuh"

namespace {

cudaError_t block_fwd_f32(const float* x, const float* w_qkv, int64_t wq0, int64_t wq1,
                          const float* w_out, int64_t wo0, int64_t wo1, float* out, float* lse,
                          float* qkv, float* attn, int batch, int seq, int channels, int heads,
                          int head_dim, int out_channels, float scale, cudaStream_t stream) {
  const int rows = batch * seq;
  const int width = heads * head_dim;
  cudaError_t err = block_gemm::gemm(x, channels, 1, w_qkv, wq0, wq1, qkv, 3 * width, 1, rows,
                                     3 * width, channels, stream);
  if (err != cudaSuccess) return err;
  err = packed_fwd::dispatch<float>(head_dim, qkv, attn, lse, batch, seq, heads, scale, stream);
  if (err != cudaSuccess) return err;
  return block_gemm::gemm(attn, width, 1, w_out, wo0, wo1, out, out_channels, 1, rows,
                          out_channels, width, stream);
}

using mma::bf16;

cudaError_t block_fwd_bf16(const bf16* x, const float* w_qkv, int64_t wq0, int64_t wq1,
                           const float* w_out, int64_t wo0, int64_t wo1, bf16* out, float* lse,
                           bf16* qkv, bf16* attn, bf16* w_ws, int batch, int seq, int channels,
                           int heads, int head_dim, int out_channels, float scale,
                           cudaStream_t stream) {
  const int rows = batch * seq;
  const int64_t width = static_cast<int64_t>(heads) * head_dim;
  const int64_t ldq = block_gemm::padded(3 * width);
  const int64_t ldo = block_gemm::padded(out_channels);
  const bf16* wq = w_ws;                  // [C, ldq]
  const bf16* wo = w_ws + channels * ldq;  // [H*ch, ldo]
  cudaError_t err = block_gemm::cast_weights(w_qkv, wq0, wq1, w_out, wo0, wo1, channels,
                                             static_cast<int>(width), out_channels, w_ws, stream);
  if (err != cudaSuccess) return err;
  // qkv[r, j] = sum_c x[r, c] w_qkv[c, j], exactly, then rounded
  err = block_gemm::exact_gemm(x, channels, wq, ldq, qkv, 3 * width, rows, 3 * width, channels,
                               stream);
  if (err != cudaSuccess) return err;
  const mma::Strides sqkv{seq * 3 * width, head_dim, 3 * width};
  const mma::FwdArgs a{qkv, qkv + width, qkv + 2 * width, nullptr, attn, lse, batch, seq, seq,
                       heads, head_dim, scale, 0, sqkv, sqkv};
  err = mma::run_fwd<true>(a, stream);
  if (err != cudaSuccess) return err;
  // out[r, o] = sum_p attn[r, p] w_out[p, o]
  return block_gemm::mma_gemm<false, true, bf16>(attn, width, wo, ldo, out, out_channels, 1, rows,
                                                 out_channels, width, stream);
}

}  // namespace

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores) (x, out and
// the workspaces qkv [B*T, 3*H*ch] and attn [B*T, H*ch]); the weights are
// f32, element (i, j) of w_qkv at w_qkv + i*wq0 + j*wq1, of w_out at w_out
// + i*wo0 + j*wo1. w_ws is bf16 scratch of C*pad8(3*H*ch) + H*ch*pad8(C_out)
// entries (pad8: rounded up to a multiple of 8) on 16 bytes, for bf16 only
// (may be null for f32). Returns a cudaError_t (0 on success).
extern "C" int attention_block_fwd(const void* x, const void* w_qkv, int64_t wq0, int64_t wq1,
                                   const void* w_out, int64_t wo0, int64_t wo1, void* out,
                                   void* lse, void* qkv, void* attn, void* w_ws, int batch,
                                   int seq, int channels, int heads, int head_dim,
                                   int out_channels, float scale, int dtype, void* stream) {
  if (batch < 1 || seq < 1 || heads < 1 || channels < 1 || out_channels < 1 || head_dim < 1 ||
      head_dim > 128 || batch > 65535 || heads > 65535 ||
      static_cast<int64_t>(batch) * seq > INT32_MAX)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wq = static_cast<const float*>(w_qkv);
  const float* wo = static_cast<const float*>(w_out);
  float* lse_f = static_cast<float*>(lse);
  if (dtype == 0)
    return block_fwd_f32(static_cast<const float*>(x), wq, wq0, wq1, wo, wo0, wo1,
                         static_cast<float*>(out), lse_f, static_cast<float*>(qkv),
                         static_cast<float*>(attn), batch, seq, channels, heads, head_dim,
                         out_channels, scale, s);
  if (dtype != 1 || w_ws == nullptr || !mma::aligned16(w_ws)) return cudaErrorInvalidValue;
  return block_fwd_bf16(static_cast<const bf16*>(x), wq, wq0, wq1, wo, wo0, wo1,
                        static_cast<bf16*>(out), lse_f, static_cast<bf16*>(qkv),
                        static_cast<bf16*>(attn), static_cast<bf16*>(w_ws), batch, seq,
                        channels, heads, head_dim, out_channels, scale, s);
}
