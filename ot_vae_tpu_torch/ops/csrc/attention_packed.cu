// Packed-qkv multi-head attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_fwd_kernel_packed` (row 1,
// ot_vae_tpu/ops/attention_pallas.py:255) reached through `_packed_fwd_call`
// and `fused_attention_packed`. Same function:
//
//   qkv [B, T, 3*H*C]  (q block, then k, then v; heads contiguous in each block)
//   out [B, T, H*C]    softmax(scale * Q K^T) V per head, in the input dtype
//   lse [B, T, H]      f32 log-sum-exp of the scaled logits
//
// What bounds it: at the FFHQ128 decoder's block (B=64, H=2, C=64, T=1024)
// the work is 4*T^2*C*B*H = 3.4e10 FLOP against 68 MB of input and output,
// so the card's bound is the bf16 tensor-core rate (0.035 ms; the bytes take
// 0.020 ms). The TPU kernel holds a whole [T, T] instance in VMEM; an SM has
// at most 227 KB of shared memory, so both kernels here stream keys
// (flash-attention forward) and keep S and P out of device memory.
//
// The dtype picks the kernel, inside this library:
//   - bf16 runs on the tensor cores: attention_fwd_mma (attention_fwd_mma.cuh,
//     mma.sync.m16n8k16 with bf16 operands and f32 accumulation), the kernel
//     of rows 7 and 3. The packed layout is the BTHD layout read through
//     strides: q, k and v are the column blocks at 0, H*C and 2*H*C of qkv,
//     all with token stride 3*H*C and head stride C; out [B, T, H*C] and lse
//     [B, T, H] are the kernel's packed layouts (kPacked). As the TPU
//     kernel rounds the normalised P to v's dtype before P V, this one rounds
//     the running maximum's P into its bf16 A fragments: a rounding of the
//     same size, not the same bits.
//   - f32 runs on CUDA-core FMAs (attention_packed_fwd.cuh): tensor cores
//     would take f32 operands as TF32 (10-bit mantissa), which the f32 gates
//     against the plain version and the f32 card-vs-CPU paths do not allow;
//     the port's f32 callers, the MNIST32 models at T <= 256 and head dims
//     1-16, are launch-bound. This is a choice of arithmetic, not a size
//     threshold: every bf16 call, at every T and head dim, runs the
//     tensor-core kernel. Each thread owns a query row (two share one when
//     C > 64) and streams K and V tiles through shared memory as f32 with an
//     online softmax; a C that is not a multiple of 8 runs the next padded
//     width with loads masked past C. The fused attention block
//     (attention_block.cu, row 5) runs the same device code in each dtype:
//     the tensor-core kernel in bf16, this one in f32.
//
// Head dims: every C from 1 to 128, in both kernels. The TPU kernel's
// d % 8 rule was a Mosaic lane rule, not a rule of the function.

#include "attention_fwd_mma.cuh"
#include "attention_packed_fwd.cuh"

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores). Returns a
// cudaError_t (0 on success).
extern "C" int attention_packed_fwd(const void* qkv, void* out, void* lse,
                                    int batch, int seq, int heads, int head_dim,
                                    float scale, int dtype, void* stream) {
  if (batch < 1 || seq < 1 || heads < 1 || batch > 65535 || heads > 65535 || head_dim < 1 ||
      head_dim > 128)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lse_f = static_cast<float*>(lse);
  if (dtype == 0)
    return packed_fwd::dispatch<float>(head_dim, qkv, out, lse_f, batch, seq, heads,
                                       scale, s);
  if (dtype != 1) return cudaErrorInvalidValue;
  const int64_t width = static_cast<int64_t>(heads) * head_dim;
  const mma::bf16* q = static_cast<const mma::bf16*>(qkv);
  const mma::Strides sqkv{seq * 3 * width, head_dim, 3 * width};
  const mma::FwdArgs a{q, q + width, q + 2 * width, nullptr, out, lse_f, batch, seq, seq, heads,
                       head_dim, scale, 0, sqkv, sqkv};
  return mma::run_fwd<true>(a, s);
}
