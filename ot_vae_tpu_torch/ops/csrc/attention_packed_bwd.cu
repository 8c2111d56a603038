// Packed-qkv multi-head attention backward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_bwd_kernel_packed` (row 2,
// ot_vae_tpu/ops/attention_pallas.py:279), reached through
// `_fused_packed_bwd`. Same function:
//
//   qkv  [B, T, 3*H*C]  the forward's input (q block, then k, then v)
//   out  [B, T, H*C]    the forward's output
//   lse  [B, T, H]      the forward's f32 log-sum-exp
//   dout [B, T, H*C]    gradient of out
//   dqkv [B, T, 3*H*C]  dq, dk, dv written into the packed columns
//
// with P = exp(scale*QK^T - lse), D = rowsum(dO*O), dV = P^T dO,
// dS = P*(dO V^T - D)*scale, dQ = dS K, dK = dS^T Q. P (for dV) is rounded to
// dout's dtype and dS to q's dtype before their products, as the TPU kernel
// and the plain PyTorch version round them.
//
// What bounds it: at the FFHQ128 decoder's block at the train batch (B=128,
// H=2, C=64, T=1024, bf16) the backward needs 10*T^2*C*B*H = 1.7e11 FLOP
// against 270 MB of input and output, so the card's bound is the bf16
// tensor-core rate (0.17 ms). The TPU kernel holds a whole [T, T] instance in
// VMEM (4 MB of f32 scores at T=1024); an SM has 227 KB of shared memory, so
// both kernels here are the flash-attention-2 backward in two kernels that
// recompute S and P from lse: a dQ kernel that computes and stores
// D = rowsum(dO*O), then a dK/dV kernel on the same stream. Each writes its
// own columns of dqkv, so there are no atomics and a run repeats bit for
// bit.
//
// The dtype picks the kernels, inside this library:
//   - bf16 runs on the tensor cores: attention_dq_mma and attention_dkdv_mma
//     (attention_bwd_mma.cuh, mma.sync.m16n8k16 with bf16 operands and f32
//     accumulation), the kernels of rows 8 and 4, on the packed layout read
//     through strides: q, k, v and dq, dk, dv are the column blocks at 0,
//     H*C and 2*H*C of qkv and dqkv (token stride 3*H*C, head stride C); out
//     and dout have token stride H*C; lse and D [B, T, H] token stride H and
//     head stride 1.
//   - f32 runs on CUDA-core FMAs (attention_packed_bwd.cuh), because tensor
//     cores would take f32 operands as TF32, which the f32 gates and the f32
//     card-vs-CPU train steps do not allow; the port's f32 callers (the
//     MNIST32 models, T <= 256, head dims 1-16) are launch-bound. A choice of
//     arithmetic, not a size threshold: every bf16 call runs the tensor-core
//     kernels. Threads own query rows (dq kernel) or key rows (dk/dv kernel)
//     with a row of C head dims split over 1 to 8 neighbouring threads, and
//     stream the other side's tiles through shared memory as f32. The fused
//     attention block's backward (attention_block_bwd.cu, row 6) runs the
//     same device code in each dtype: the tensor-core kernels in bf16, these
//     in f32.
//
// Head dims: every C from 1 to 128, in both dtypes.

#include "attention_bwd_mma.cuh"
#include "attention_packed_bwd.cuh"

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores). `delta` is
// f32 [B, T, H] scratch. Returns a cudaError_t (0 on success).
extern "C" int attention_packed_bwd(const void* qkv, const void* out, const void* lse,
                                    const void* dout, void* dqkv, void* delta, int batch,
                                    int seq, int heads, int head_dim, float scale,
                                    int dtype, void* stream) {
  if (batch < 1 || seq < 1 || heads < 1 || batch > 65535 || heads > 65535 || head_dim < 1 ||
      head_dim > 128)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lse_f = static_cast<const float*>(lse);
  float* delta_f = static_cast<float*>(delta);
  if (dtype == 0)
    return packed_bwd::dispatch<float>(head_dim, qkv, out, lse_f, dout, dqkv, delta_f,
                                       batch, seq, heads, scale, s);
  if (dtype != 1) return cudaErrorInvalidValue;
  const int64_t width = static_cast<int64_t>(heads) * head_dim;
  const mma::bf16* q = static_cast<const mma::bf16*>(qkv);
  mma::bf16* dq = static_cast<mma::bf16*>(dqkv);
  const mma::Strides sqkv{seq * 3 * width, head_dim, 3 * width};
  const mma::BwdArgs a{q, q + width, q + 2 * width, nullptr, out, dout, lse_f, dq, dq + width,
                       dq + 2 * width, delta_f, batch, seq, seq, heads, head_dim, scale, 0,
                       sqkv, sqkv, mma::Strides{seq * width, head_dim, width},
                       mma::Strides{static_cast<int64_t>(seq) * heads, 1, heads}};
  return mma::run_bwd(a, s);
}
