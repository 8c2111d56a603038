// Multi-head attention backward on separate q, k and v tensors, for Hopper (sm_90a).
//
// Replaces two TPU kernels of ot_vae_tpu/ops/attention_pallas.py with one
// source that reads the layout through batch, head and token strides, as
// attention_bthd.cu (the forward) does:
//
//   `_bwd_kernel_bthd` (row 8, attention_pallas.py:710, reached through
//   `_bthd_bwd_call`, the backward of `fused_attention_bthd` and
//   `fused_attention_bthd_dropout`):
//     q, out, dout [B, Tq, H*d], k and v [B, Tk, H*d], lse [B, H, Tq] f32
//     (row 7's), an optional in-kernel causal mask (Tq = Tk) and an optional
//     multiplier mult [Tq, Tk] shared by every batch element and head;
//     dq [B, Tq, H*d], dk and dv [B, Tk, H*d];
//   `_bwd_kernel` (row 4, attention_pallas.py:130, reached through
//     `_fused_bwd`, the backward of `fused_attention`): q, k, v, out, dout
//     [B, H, T, d], lse [B*H, T] f32.
//
// with P = exp(scale*QK^T - lse) (masked entries 0), D = rowsum(dO*O) in f32,
// Pd = P*mult, dV = Pd^T dO, dP = (dO V^T)*mult, dS = P*(dP - D)*scale,
// dQ = dS K, dK = dS^T Q. Pd is rounded to dO's dtype before Pd^T dO and dS
// to q's dtype before its two products, as the TPU kernel rounds them; the
// multiplier gets no gradient.
//
// What bounds it: at the FFHQ128 ViT encoder's layer at the train batch
// (B=32, H=4, d=128, T=1024, bf16) the backward needs 10*Tq*Tk*d*B*H =
// 1.72e11 FLOP (S, dP, dV, dQ, dK) against 268 MB of input and output, so the
// card's bound is the bf16 tensor-core rate: 0.174 ms at 989 TFLOP/s (the
// bytes take 0.080 ms). The TPU kernel holds whole [Tq, Tk] instances in
// VMEM; an SM has 227 KB of shared memory, so this is the flash-attention-2
// backward in two kernels that recompute S and P from lse. Each kernel
// writes its own tensors: there are no atomics and a run repeats bit for
// bit. The price is that S and dP are computed in both kernels: 14 units of
// 2*Tq*Tk*d FLOP against the bound's 10, taken for determinism.
//
// The dtype picks the kernels, inside this library: bf16 runs on the tensor
// cores (attention_dq_mma, attention_dkdv_mma: mma.sync.m16n8k16, bf16
// operands, f32 accumulation, mma_bf16.cuh); f32 on CUDA-core FMAs
// (attention_dq_kernel, attention_dkdv_kernel, unchanged), because tensor
// cores would take f32 operands as TF32, which the f32 gates and the f32
// card-vs-CPU train steps do not allow, and the port's one f32 caller (the
// conditional CIFAR10 ViT at T = 18-19) is launch- and host-bound. This is a
// choice of arithmetic, not a size threshold.
//
// bf16 design: attention_bwd_mma.cuh, whose kernels attention_packed_bwd.cu
// (row 2) runs too, on the packed layout.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "attention_bwd_mma.cuh"

namespace {

// ---- f32: CUDA-core FMAs ---------------------------------------------------

// f32 design (attention_dq_kernel, attention_dkdv_kernel): threads own query
// rows (dq kernel: q, dO and the f32 dQ accumulator in registers; D computed
// in the prologue and stored) or key rows (dk/dv kernel: k, v, dK and dV),
// and stream the other side's tiles (and the block's window of mult) through
// shared memory as f32. A row of d head dims is split over 1, 2, 4 or 8
// neighbouring threads (at most 16 dims each, interleaved so the
// shared-memory reads of one row hit distinct banks); partial dot products
// meet by warp shuffles. Every d from 1 to 128: a multiple of 8 runs the
// kernels built for that width; any other d the next padded width of 1, 2,
// 4, ..., 128 (`kTail`), with loads masked past d.
constexpr int kThreads = 128;
constexpr int kTile = 32;  // rows of the streamed operands per shared-memory tile

template <int C>
struct Split {
  static_assert(C >= 1 && C <= 128, "head dim must be 1 to 128");
  static constexpr int kRowThreads = C <= 16 ? 1 : C <= 32 ? 2 : C <= 64 ? 4 : 8;
  static constexpr int kDims = C / kRowThreads;         // dims each thread owns
  static constexpr int kRows = kThreads / kRowThreads;  // rows per block
};

__device__ __forceinline__ float to_float(float x) { return x; }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }

// an f32 value rounded to T (the plain version's casts of Pd and dS)
template <typename T>
__device__ __forceinline__ float round_as(float x);
template <>
__device__ __forceinline__ float round_as<float>(float x) { return x; }

// sum over the R neighbouring lanes that share a row
template <int R>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = R / 2; o > 0; o /= 2) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

using mma::offset;
using mma::Strides;

// copy kTile token rows r0.. of one head (`base` at token 0, rows `t_stride`
// apart) into shared memory as f32; rows past `seq` and dims past `cw` are 0
template <typename T, int C>
__device__ __forceinline__ void fill_tile(float (*tile)[C], const T* base, int64_t t_stride,
                                          int r0, int seq, int cw) {
  for (int i = threadIdx.x; i < kTile * C; i += kThreads) {
    const int r = i / C;
    const int c = i % C;
    tile[r][c] = r0 + r < seq && c < cw ? to_float(base[(r0 + r) * t_stride + c]) : 0.f;
  }
}

// the f32 kernels read the bf16 ones' arguments, out and dout through q's
// strides and lse and D as [B, H, Tq] (true of both layouts here)
using Args = mma::BwdArgs;

// C is the width the kernels are built for; `ch` the head dim of the
// tensors, equal to C unless kTail (then ch <= C, the dims past ch masked)
template <typename T, int C, bool kTail>
__global__ void __launch_bounds__(kThreads) attention_dq_kernel(Args a) {
  using S = Split<C>;
  constexpr int R = S::kRowThreads;
  __shared__ float k_tile[kTile][C];
  __shared__ float v_tile[kTile][C];
  __shared__ float m_tile[S::kRows][kTile + 1];  // mult[rows, keys], padded: no bank conflict

  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* mult = static_cast<const T*>(a.mult);
  const int cw = kTail ? a.head_dim : C;  // the tensors' head dim
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int row0 = blockIdx.x * S::kRows;
  const int local = threadIdx.x / R;
  const int row = row0 + local;
  const int part = threadIdx.x % R;
  const bool valid = row < a.tq;
  const int64_t stat = (static_cast<int64_t>(b) * a.heads + h) * a.tq + row;
  const T* k_head = k + offset(a.skv, b, h, 0);
  const T* v_head = v + offset(a.skv, b, h, 0);

  float qr[S::kDims], d_o[S::kDims], dq[S::kDims];
  float partial = 0.f;
  float lse_i = 0.f;
#pragma unroll
  for (int i = 0; i < S::kDims; ++i) {
    qr[i] = 0.f;
    d_o[i] = 0.f;
    dq[i] = 0.f;
  }
  if (valid) {
    const int64_t at = offset(a.sq, b, h, row);
    const T* out = static_cast<const T*>(a.out);
    const T* dout = static_cast<const T*>(a.dout);
#pragma unroll
    for (int i = 0; i < S::kDims; ++i) {
      const int c = part + R * i;
      if (kTail && c >= cw) continue;
      qr[i] = to_float(q[at + c]);
      d_o[i] = to_float(dout[at + c]);
      partial = fmaf(d_o[i], to_float(out[at + c]), partial);
    }
    lse_i = a.lse[stat];
  }
  const float delta_i = row_sum<R>(partial);
  if (valid && part == 0) a.delta[stat] = delta_i;

  // causal: the tile's last row sees keys up to itself, none past it
  const int key_end = a.causal ? min(a.tk, row0 + S::kRows) : a.tk;
  for (int k0 = 0; k0 < key_end; k0 += kTile) {
    __syncthreads();  // the previous tiles are consumed
    fill_tile<T, C>(k_tile, k_head, a.skv.t, k0, a.tk, cw);
    fill_tile<T, C>(v_tile, v_head, a.skv.t, k0, a.tk, cw);
    if (mult != nullptr) {
      for (int i = threadIdx.x; i < S::kRows * kTile; i += kThreads) {
        const int r = i / kTile;
        const int c = i % kTile;
        const bool in = row0 + r < a.tq && k0 + c < a.tk;
        m_tile[r][c] = in ? to_float(mult[static_cast<int64_t>(row0 + r) * a.tk + k0 + c]) : 0.f;
      }
    }
    __syncthreads();
    const int n_keys = min(kTile, key_end - k0);
#pragma unroll 2
    for (int j = 0; j < n_keys; ++j) {
      float s = 0.f;
      float dp = 0.f;
#pragma unroll
      for (int i = 0; i < S::kDims; ++i) {
        s = fmaf(qr[i], k_tile[j][part + R * i], s);
        dp = fmaf(d_o[i], v_tile[j][part + R * i], dp);
      }
      s = row_sum<R>(s);
      dp = row_sum<R>(dp);
      if (a.causal && k0 + j > row) continue;  // P = 0 above the diagonal
      if (mult != nullptr) dp *= m_tile[local][j];
      const float p = expf(s * a.scale - lse_i);
      const float ds = round_as<T>(p * (dp - delta_i) * a.scale);
#pragma unroll
      for (int i = 0; i < S::kDims; ++i) dq[i] = fmaf(ds, k_tile[j][part + R * i], dq[i]);
    }
  }

  if (!valid) return;
  T* dq_row = static_cast<T*>(a.dq) + offset(a.sq, b, h, row);
#pragma unroll
  for (int i = 0; i < S::kDims; ++i)
    if (!kTail || part + R * i < cw) store(dq_row + part + R * i, dq[i]);
}

// capped at 128 registers a thread, so that 4 blocks share an SM: uncapped,
// the d = 128 build took more (3 blocks an SM) and ran slower on an H100
template <typename T, int C, bool kTail>
__global__ void __launch_bounds__(kThreads, 4) attention_dkdv_kernel(Args a) {
  using S = Split<C>;
  constexpr int R = S::kRowThreads;
  __shared__ float q_tile[kTile][C];
  __shared__ float do_tile[kTile][C];
  __shared__ float lse_tile[kTile];
  __shared__ float delta_tile[kTile];
  __shared__ float m_tile[kTile][S::kRows];  // mult[queries, rows]

  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const T* mult = static_cast<const T*>(a.mult);
  const int cw = kTail ? a.head_dim : C;  // the tensors' head dim
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int row0 = blockIdx.x * S::kRows;  // first key row of the block
  const int local = threadIdx.x / R;
  const int row = row0 + local;  // key row
  const int part = threadIdx.x % R;
  const bool valid = row < a.tk;
  const T* q_head = q + offset(a.sq, b, h, 0);
  const T* do_head = dout + offset(a.sq, b, h, 0);
  const int64_t stat0 = (static_cast<int64_t>(b) * a.heads + h) * a.tq;

  float kr[S::kDims], vr[S::kDims], dk[S::kDims], dv[S::kDims];
#pragma unroll
  for (int i = 0; i < S::kDims; ++i) {
    kr[i] = 0.f;
    vr[i] = 0.f;
    dk[i] = 0.f;
    dv[i] = 0.f;
  }
  if (valid) {
    const int64_t at = offset(a.skv, b, h, row);
#pragma unroll
    for (int i = 0; i < S::kDims; ++i) {
      const int c = part + R * i;
      if (kTail && c >= cw) continue;
      kr[i] = to_float(k[at + c]);
      vr[i] = to_float(v[at + c]);
    }
  }

  // causal: queries before the block's first key see none of its keys
  for (int q0 = a.causal ? row0 : 0; q0 < a.tq; q0 += kTile) {
    __syncthreads();  // the previous tiles are consumed
    fill_tile<T, C>(q_tile, q_head, a.sq.t, q0, a.tq, cw);
    fill_tile<T, C>(do_tile, do_head, a.sq.t, q0, a.tq, cw);
    for (int i = threadIdx.x; i < kTile; i += kThreads) {
      const bool in = q0 + i < a.tq;
      lse_tile[i] = in ? a.lse[stat0 + q0 + i] : 0.f;
      delta_tile[i] = in ? a.delta[stat0 + q0 + i] : 0.f;
    }
    if (mult != nullptr) {
      for (int i = threadIdx.x; i < kTile * S::kRows; i += kThreads) {
        const int r = i / S::kRows;
        const int c = i % S::kRows;
        const bool in = q0 + r < a.tq && row0 + c < a.tk;
        m_tile[r][c] = in ? to_float(mult[static_cast<int64_t>(q0 + r) * a.tk + row0 + c]) : 0.f;
      }
    }
    __syncthreads();
    const int n_rows = min(kTile, a.tq - q0);
#pragma unroll 2
    for (int j = 0; j < n_rows; ++j) {
      float s = 0.f;
      float dp = 0.f;
#pragma unroll
      for (int i = 0; i < S::kDims; ++i) {
        s = fmaf(q_tile[j][part + R * i], kr[i], s);
        dp = fmaf(do_tile[j][part + R * i], vr[i], dp);
      }
      s = row_sum<R>(s);
      dp = row_sum<R>(dp);
      if (a.causal && row > q0 + j) continue;  // P = 0 above the diagonal
      const float p = expf(s * a.scale - lse_tile[j]);
      float pd = p;
      if (mult != nullptr) {
        const float m = m_tile[j][local];
        pd *= m;
        dp *= m;
      }
      const float p_in = round_as<T>(pd);
      const float ds = round_as<T>(p * (dp - delta_tile[j]) * a.scale);
#pragma unroll
      for (int i = 0; i < S::kDims; ++i) {
        dv[i] = fmaf(p_in, do_tile[j][part + R * i], dv[i]);
        dk[i] = fmaf(ds, q_tile[j][part + R * i], dk[i]);
      }
    }
  }

  if (!valid) return;
  const int64_t at = offset(a.skv, b, h, row);
  T* dk_row = static_cast<T*>(a.dk) + at;
  T* dv_row = static_cast<T*>(a.dv) + at;
#pragma unroll
  for (int i = 0; i < S::kDims; ++i) {
    if (kTail && part + R * i >= cw) continue;
    store(dk_row + part + R * i, dk[i]);
    store(dv_row + part + R * i, dv[i]);
  }
}

template <typename T, int C, bool kTail>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr int kRows = Split<C>::kRows;
  // the dq kernel writes D, which the dk/dv kernel reads: same stream, in order
  const dim3 q_grid((a.tq + kRows - 1) / kRows, a.heads, a.batch);
  attention_dq_kernel<T, C, kTail><<<q_grid, kThreads, 0, stream>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 k_grid((a.tk + kRows - 1) / kRows, a.heads, a.batch);
  attention_dkdv_kernel<T, C, kTail><<<k_grid, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t dispatch_f32(const Args& a, cudaStream_t stream) {
  using T = float;
#define CASE(C, TAIL) \
  case C:             \
    return launch<T, C, TAIL>(a, stream);
  if (a.head_dim % 8 == 0) {
    switch (a.head_dim) {
      CASE(8, false) CASE(16, false) CASE(24, false) CASE(32, false)
      CASE(40, false) CASE(48, false) CASE(56, false) CASE(64, false)
      CASE(72, false) CASE(80, false) CASE(88, false) CASE(96, false)
      CASE(104, false) CASE(112, false) CASE(120, false) CASE(128, false)
      default:
        return cudaErrorInvalidValue;
    }
  }
  if (a.head_dim < 1 || a.head_dim > 128) return cudaErrorInvalidValue;
  int padded = 1;
  while (padded < a.head_dim) padded *= 2;
  switch (padded) {
    CASE(1, true) CASE(2, true) CASE(4, true) CASE(8, true)
    CASE(16, true) CASE(32, true) CASE(64, true) CASE(128, true)
    default:
      return cudaErrorInvalidValue;
  }
#undef CASE
}

cudaError_t run(const Args& a, int dtype, void* stream) {
  if (a.batch < 1 || a.tq < 1 || a.tk < 1 || a.heads < 1 || a.batch > 65535 ||
      a.heads > 65535 || (a.causal && a.tq != a.tk) || a.head_dim < 1 || a.head_dim > 128)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_f32(a, s);
  if (dtype == 1) return mma::run_bwd(a, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// Row 8. q, out, dout, dq [B, Tq, H*d]; k, v, dk, dv [B, Tk, H*d]; all
// contiguous, in one dtype; mult [Tq, Tk] in q's dtype or null; lse [B, H, Tq]
// f32 (the forward's); delta f32 [B, H, Tq] scratch.
// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores). Returns a
// cudaError_t (0 on success).
extern "C" int attention_bthd_bwd(const void* q, const void* k, const void* v,
                                  const void* mult, const void* out, const void* lse,
                                  const void* dout, void* dq, void* dk, void* dv, void* delta,
                                  int batch, int tq, int tk, int heads, int head_dim,
                                  float scale, int causal, int dtype, void* stream) {
  const int64_t width = static_cast<int64_t>(heads) * head_dim;
  const Strides sq{tq * width, head_dim, width};
  const Args a{q, k, v, mult, out, dout, static_cast<const float*>(lse), dq, dk, dv,
               static_cast<float*>(delta), batch, tq, tk, heads, head_dim, scale, causal,
               sq, Strides{tk * width, head_dim, width}, sq,
               Strides{static_cast<int64_t>(heads) * tq, tq, 1}};
  return run(a, dtype, stream);
}

// Row 4. q, k, v, out, dout, dq, dk, dv [B, H, T, d], contiguous; lse [B*H, T]
// f32 (the same memory as [B, H, T]); delta f32 [B*H, T] scratch.
extern "C" int attention_bhtc_bwd(const void* q, const void* k, const void* v,
                                  const void* out, const void* lse, const void* dout,
                                  void* dq, void* dk, void* dv, void* delta, int batch,
                                  int heads, int seq, int head_dim, float scale, int dtype,
                                  void* stream) {
  const Strides s{static_cast<int64_t>(heads) * seq * head_dim,
                  static_cast<int64_t>(seq) * head_dim, head_dim};
  const Args a{q, k, v, nullptr, out, dout, static_cast<const float*>(lse), dq, dk, dv,
               static_cast<float*>(delta), batch, seq, seq, heads, head_dim, scale, 0, s, s, s,
               Strides{static_cast<int64_t>(heads) * seq, seq, 1}};
  return run(a, dtype, stream);
}
