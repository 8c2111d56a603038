// Packed-qkv multi-head attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_fwd_kernel_packed` (ot_vae_tpu/ops/attention_pallas.py)
// reached through `fused_attention_packed`. Same function:
//
//   qkv [B, T, 3*H*C]  (q block, then k, then v; heads contiguous in each block)
//   out [B, T, H*C]    softmax(scale * Q K^T) V per head, in the input dtype
//   lse [B, T, H]      f32 log-sum-exp of the scaled logits
//
// Design. The TPU kernel holds a whole [T, T] instance in VMEM; an SM has at
// most 227 KB of shared memory, so this kernel streams keys instead
// (flash-attention forward):
//   - grid (query tile, head, batch); each thread owns one query row (two
//     threads share a row when C > 64, so q and the f32 accumulator stay in
//     registers);
//   - K and V tiles of kKeyTile rows are copied from the packed rows into
//     shared memory as f32 (q at h*C, k at H*C + h*C, v at 2*H*C + h*C:
//     strided column slices, nothing transposed);
//   - online softmax in f32, O accumulated in f32 and normalised once at the
//     end, lse = m + log(l); keys past T are masked, rows past T not written.
// Products run on CUDA-core FMAs in f32 on exactly converted inputs, which is
// the input dtype's product with f32 accumulation.
//
// Head dims. Every C from 1 to 128 is taken. A multiple of 8 runs the kernel
// built for that width, with 16-byte loads. Any other C runs on the next
// padded width of 1, 2, 4, 8, 16, 32, 64 or 128 (the `kTail` instances):
// loads are scalar and masked past C, the tail dims of q, k and v are zeros
// in registers and shared memory (so they add nothing to QK^T), and the tail
// dims of the output are not written. The TPU kernel's d % 8 rule was a
// Mosaic lane rule, not a rule of the function.
//
// What bounds it: at the FFHQ128 decoder's block (B=64, H=2, C=64, T=1024)
// the work is 4*T^2*C*B*H = 3.4e10 FLOP against 68 MB of input and output,
// so the card's bound is the tensor-core rate. This kernel uses no tensor
// cores (mma.sync or wgmma with TMA-fed tiles is the next step) and is far
// above that bound; each K/V tile is read once per query tile from L2.
//
// The device code lives in attention_packed_fwd.cuh, which the fused
// attention block (attention_block.cu, attention_block_bwd.cu) includes too.

#include "attention_packed_fwd.cuh"

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 on success).
extern "C" int attention_packed_fwd(const void* qkv, void* out, void* lse,
                                    int batch, int seq, int heads, int head_dim,
                                    float scale, int dtype, void* stream) {
  if (batch < 1 || seq < 1 || heads < 1 || batch > 65535 || heads > 65535)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lse_f = static_cast<float*>(lse);
  if (dtype == 0)
    return packed_fwd::dispatch<float>(head_dim, qkv, out, lse_f, batch, seq, heads,
                                       scale, s);
  if (dtype == 1)
    return packed_fwd::dispatch<__nv_bfloat16>(head_dim, qkv, out, lse_f, batch, seq,
                                               heads, scale, s);
  return cudaErrorInvalidValue;
}
