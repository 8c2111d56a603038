// Packed-qkv multi-head attention backward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_bwd_kernel_packed` (ot_vae_tpu/ops/attention_pallas.py),
// reached through `_fused_packed_bwd`. Same function:
//
//   qkv  [B, T, 3*H*C]  the forward's input (q block, then k, then v)
//   out  [B, T, H*C]    the forward's output
//   lse  [B, T, H]      the forward's f32 log-sum-exp
//   dout [B, T, H*C]    gradient of out
//   dqkv [B, T, 3*H*C]  dq, dk, dv written into the packed columns
//
// with P = exp(scale*QK^T - lse), D = rowsum(dO*O), dV = P^T dO,
// dS = P*(dO V^T - D)*scale, dQ = dS K, dK = dS^T Q.
//
// Design. The TPU kernel holds a whole [T, T] instance in VMEM (4 MB of f32
// scores at T=1024); an SM has 227 KB of shared memory, so this is the
// flash-attention-2 backward in two kernels that recompute S and P from lse:
//   - dq kernel, grid (query tile, head, batch): threads own query rows (q,
//     dO and the f32 dQ accumulator in registers), stream K and V tiles
//     through shared memory, and compute D = rowsum(dO*O) in their prologue,
//     which they store for the second kernel;
//   - dk/dv kernel, same grid over key tiles: threads own key rows (k, v and
//     the f32 dK and dV accumulators), stream Q, dO, lse and D tiles.
// Each kernel writes its own columns of dqkv, so there are no atomics and the
// result is the same from run to run. A row of C head dims is split over
// 1, 2, 4 or 8 neighbouring threads (at most 16 dims each, interleaved so
// the shared-memory reads of one row hit distinct banks), which keeps the
// per-thread arrays small; partial dot products meet by warp shuffles.
// P (for dV) and dS are rounded to the input dtype before their products, as
// the TPU kernel and the plain PyTorch version do; sums are f32 on CUDA-core
// FMAs over exactly converted inputs.
//
// Head dims. Every C from 1 to 128 is taken, as in the forward kernel: a
// multiple of 8 runs the kernels built for that width; any other C runs on
// the next padded width of 1, 2, 4, 8, 16, 32, 64 or 128 (`kTail`), with
// loads masked past C (zeros in registers and shared memory, which add
// nothing to the products) and the tail dims of dqkv not written.
//
// What bounds it: at the FFHQ128 decoder's block at the train batch (B=128,
// H=2, C=64, T=1024, bf16) the backward needs 10*T^2*C*B*H = 1.7e11 FLOP
// against 270 MB of input and output, so the card's bound is the
// tensor-core rate (0.17 ms). This kernel uses no tensor cores and
// recomputes S once more; mma.sync or wgmma with TMA-fed tiles is later work.
//
// The device code lives in attention_packed_bwd.cuh, which the fused
// attention block's backward (attention_block_bwd.cu) includes too.

#include "attention_packed_bwd.cuh"

// dtype: 0 = float32, 1 = bfloat16. `delta` is f32 [B, T, H] scratch.
// Returns a cudaError_t (0 on success).
extern "C" int attention_packed_bwd(const void* qkv, const void* out, const void* lse,
                                    const void* dout, void* dqkv, void* delta, int batch,
                                    int seq, int heads, int head_dim, float scale,
                                    int dtype, void* stream) {
  if (batch < 1 || seq < 1 || heads < 1 || batch > 65535 || heads > 65535)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lse_f = static_cast<const float*>(lse);
  float* delta_f = static_cast<float*>(delta);
  if (dtype == 0)
    return packed_bwd::dispatch<float>(head_dim, qkv, out, lse_f, dout, dqkv, delta_f,
                                       batch, seq, heads, scale, s);
  if (dtype == 1)
    return packed_bwd::dispatch<__nv_bfloat16>(head_dim, qkv, out, lse_f, dout, dqkv,
                                               delta_f, batch, seq, heads, scale, s);
  return cudaErrorInvalidValue;
}
