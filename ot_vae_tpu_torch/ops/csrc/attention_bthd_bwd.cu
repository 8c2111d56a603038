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
// bf16 design. Both kernels: 4 warps, 64-row tiles of 16 rows a warp, tiles
// in bf16 in shared memory with rows padded by 16 bytes (no ldmatrix bank
// conflict), the streamed tiles in two stages filled by cp.async while the
// other is consumed (zero-filled past Tq or Tk), head dims rounded up to a
// multiple of 16 and zero past d (masked scalar copies where d is not a
// multiple of 8 or a tensor is unaligned). The dQ kernel is launched first;
// the dK/dV kernel, on the same stream, reads the D it wrote.
//   - dq kernel, grid (query tile, head, batch): Q and dO stay in shared
//     memory, lse and D of the lane's two rows in registers; its prologue
//     computes D = rowsum(dO*O) in f32 for the tile and stores it. It loops
//     over K/V tiles of 64 keys: S = Q K^T and dP = dO V^T on the tensor
//     cores, P = exp2(S*scale*log2(e) - lse*log2(e)), dS = P*(dP*mult -
//     D)*scale rounded to bf16 and packed in registers into the A fragments
//     of dQ += dS K (K's B fragments by ldmatrix.trans).
//   - dk/dv kernel, grid (key tile, head, batch): K and V of 64 keys stay in
//     shared memory and dK, dV accumulate in f32 in registers. It loops over
//     64-row query tiles (Q, dO, lse and D double-buffered). Each warp
//     computes the transposed products for its 16 keys, so that P^T and dS^T
//     come out of the accumulators already in the A layout of the next
//     product, with no trip through shared memory:
//       1. S^T = K Q^T, then P^T from lse;
//       2. Pd^T = P^T*mult^T rounded to bf16, packed into A fragments;
//       3. dV += Pd^T dO (dO's B fragments by ldmatrix.trans);
//       4. dP^T = V dO^T, times mult^T;
//       5. dS^T = P^T*(dP^T - D)*scale rounded to bf16, packed;
//       6. dK += dS^T Q.
//     Steps 2-3 and 5-6 go 16 queries at a time, so that 4 registers hold
//     the packed fragments (dS in the dq kernel likewise, 16 keys a time).
//   - causal: the dq kernel's query tile stops at its last row's key tile
//     and the dk/dv kernel's key tile starts at its first key's query tile;
//     tiles wholly above the diagonal are skipped, the diagonal ones masked
//     entry by entry. mult is read for each fragment's own entries from the
//     one [Tq, Tk] tensor (2 MB in bf16 at T = 1024), which L2 holds.
//   - budget at d = 128: 6 tiles of 64 x 136 bf16 = 104,448 bytes of dynamic
//     shared memory in the dq kernel (Q, dO, K and V twice), 105,472 in the
//     dk/dv kernel (K, V, Q and dO twice, lse and D twice), so two blocks
//     share an SM; the dk/dv kernel's f32 accumulators (dK and dV, 64 each;
//     P^T and dP^T, 32 each) take most of the 255 registers that two blocks
//     of 128 threads allow: it uses all 255 without spilling, the dq kernel
//     222 (ptxas -v, PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <initializer_list>

#include "mma_bf16.cuh"

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

// element (b, h, t, 0) of a tensor with these strides
struct Strides {
  int64_t b, h, t;
};

__device__ __forceinline__ int64_t offset(const Strides& s, int b, int h, int t) {
  return b * s.b + h * s.h + t * s.t;
}

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

struct Args {
  const void *q, *k, *v, *mult, *out, *dout;
  const float* lse;
  void *dq, *dk, *dv;
  float* delta;
  int batch, tq, tk, heads, head_dim;
  float scale;
  int causal;
  Strides sq, skv;  // out, dout and dq have q's strides; dk, dv have k's
};

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

// ---- bf16: tensor cores (mma.sync) -----------------------------------------

// dynamic shared memory: the dq kernel's Q and dO tiles and two stages of K
// and V; the dk/dv kernel's K and V tiles, two stages of Q and dO, and two
// stages of the query tile's lse and D (f32)
template <int C>
constexpr int dq_smem_bytes() {
  return 6 * mma::Tile<C>::kBytes;
}

template <int C>
constexpr int dkdv_smem_bytes() {
  return 6 * mma::Tile<C>::kBytes + 4 * mma::kTileRows * int(sizeof(float));
}

// C: the tiles' head dims, d rounded up to a multiple of 16 (a.head_dim <= C)
template <int C>
__global__ void __launch_bounds__(mma::kThreads, 2) attention_dq_mma(Args a, bool vec) {
  using namespace mma;
  constexpr int S = Tile<C>::kStride;
  constexpr int kSteps = C / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* sdo = sq + Tile<C>::kElems;
  bf16* sk = sdo + Tile<C>::kElems;  // two stages
  bf16* sv = sk + 2 * Tile<C>::kElems;

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int row0 = blockIdx.x * kTileRows;
  const int wrow = (threadIdx.x >> 5) * 16;
  const int rows[2] = {row0 + wrow + g, row0 + wrow + g + 8};
  const int cw = a.head_dim;
  const int64_t head_q = offset(a.sq, b, h, 0);
  const bf16* k = static_cast<const bf16*>(a.k) + offset(a.skv, b, h, 0);
  const bf16* v = static_cast<const bf16*>(a.v) + offset(a.skv, b, h, 0);
  const bf16* mult = static_cast<const bf16*>(a.mult);
  const int64_t stat0 = (static_cast<int64_t>(b) * a.heads + h) * a.tq;
  const float sl2 = a.scale * kLog2e;

  const int key_end = a.causal ? min(a.tk, row0 + kTileRows) : a.tk;
  const int n_tiles = (key_end + kTileRows - 1) / kTileRows;

  load_tile<C>(sq, static_cast<const bf16*>(a.q) + head_q, a.sq.t, row0, a.tq, cw, vec);
  load_tile<C>(sdo, static_cast<const bf16*>(a.dout) + head_q, a.sq.t, row0, a.tq, cw, vec);
  cp_async_commit();
  load_tile<C>(sk, k, a.skv.t, 0, a.tk, cw, vec);
  load_tile<C>(sv, v, a.skv.t, 0, a.tk, cw, vec);
  cp_async_commit();
  cp_async_wait<1>();  // Q and dO have landed
  __syncthreads();

  // D = rowsum(dO*O) in f32 for the warp's 16 rows (dO from its tile, O
  // from device memory), stored for the dk/dv kernel; each lane keeps its
  // two rows' D and lse (in log2 units)
  const bf16* o = static_cast<const bf16*>(a.out) + head_q;
  float delta[2] = {0.f, 0.f};
  for (int r = 0; r < 16; ++r) {
    const int row = row0 + wrow + r;
    float part = 0.f;
    if (row < a.tq)
      for (int c = lane; c < cw; c += 32)
        part = fmaf(__bfloat162float(sdo[(wrow + r) * S + c]),
                    __bfloat162float(o[row * a.sq.t + c]), part);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
    if (r == g) delta[0] = part;
    if (r == g + 8) delta[1] = part;
    if (lane == 0 && row < a.tq) a.delta[stat0 + row] = part;
  }
  float lse2[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) lse2[i] = rows[i] < a.tq ? a.lse[stat0 + rows[i]] * kLog2e : 0.f;

  float dq[C / 8][4];
#pragma unroll
  for (int j = 0; j < C / 8; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int stage = kt & 1;
    if (kt + 1 < n_tiles) {
      const int next = (stage ^ 1) * Tile<C>::kElems;
      load_tile<C>(sk + next, k, a.skv.t, (kt + 1) * kTileRows, a.tk, cw, vec);
      load_tile<C>(sv + next, v, a.skv.t, (kt + 1) * kTileRows, a.tk, cw, vec);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* ck = sk + stage * Tile<C>::kElems;
    const bf16* cv = sv + stage * Tile<C>::kElems;
    const int k0 = kt * kTileRows;

    // S = Q K^T and dP = dO V^T, 16 rows x 64 keys each
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      uint32_t qa[4], da[4];
      load_a(qa, sq + wrow * S, S, ks * 16, lane);
      load_a(da, sdo + wrow * S, S, ks * 16, lane);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t kb[4], vb[4];
        load_b_rows(kb, ck + np * 16 * S, S, ks * 16, lane);
        mma_16816(s[2 * np], qa, kb[0], kb[1]);
        mma_16816(s[2 * np + 1], qa, kb[2], kb[3]);
        load_b_rows(vb, cv + np * 16 * S, S, ks * 16, lane);
        mma_16816(dp[2 * np], da, vb[0], vb[1]);
        mma_16816(dp[2 * np + 1], da, vb[2], vb[3]);
      }
    }

    // dQ += dS K, 16 keys a step: dS = P*(dP*mult - D)*scale of those keys
    // rounded to bf16 into the step's A fragments
    const bool edge = k0 + kTileRows > a.tk || (a.causal && k0 + kTileRows - 1 > row0 + wrow);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t dsa[4];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = 2 * kk + jj;
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const int key = k0 + j * 8 + 2 * t + (e & 1);
          const bool masked = edge && (key >= a.tk || (a.causal && key > rows[i]));
          const float p = masked ? 0.f : exp2f(fmaf(s[j][e], sl2, -lse2[i]));
          float dpv = dp[j][e];
          if (mult != nullptr)
            dpv *= rows[i] < a.tq && key < a.tk
                       ? __bfloat162float(mult[static_cast<int64_t>(rows[i]) * a.tk + key])
                       : 0.f;
          ds[e] = p * (dpv - delta[i]) * a.scale;
        }
        dsa[jj * 2] = pack_bf16(ds[0], ds[1]);
        dsa[jj * 2 + 1] = pack_bf16(ds[2], ds[3]);
      }
#pragma unroll
      for (int np = 0; np < kSteps; ++np) {
        uint32_t kb[4];
        load_b_trans(kb, ck + kk * 16 * S, S, np * 16, lane);
        mma_16816(dq[2 * np], dsa, kb[0], kb[1]);
        mma_16816(dq[2 * np + 1], dsa, kb[2], kb[3]);
      }
    }
    __syncthreads();
  }

  // dq through the warp's own rows of the Q tile, to 16-byte stores
  stage_rows<C>(sq + wrow * S, S, dq, 1.f, 1.f, lane);
  __syncwarp();
  store_rows<C>(static_cast<bf16*>(a.dq) + head_q, a.sq.t, sq + wrow * S, row0 + wrow, a.tq, cw,
                vec, lane);
}

template <int C>
__global__ void __launch_bounds__(mma::kThreads, 2) attention_dkdv_mma(Args a, bool vec) {
  using namespace mma;
  constexpr int S = Tile<C>::kStride;
  constexpr int kSteps = C / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sk = reinterpret_cast<bf16*>(smem);
  bf16* sv = sk + Tile<C>::kElems;
  bf16* sq = sv + Tile<C>::kElems;    // two stages
  bf16* sdo = sq + 2 * Tile<C>::kElems;  // two stages
  float* slse = reinterpret_cast<float*>(sdo + 2 * Tile<C>::kElems);  // [2][64], log2 units
  float* sdelta = slse + 2 * kTileRows;                                // [2][64]

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int key0 = blockIdx.x * kTileRows;
  const int wkey = (threadIdx.x >> 5) * 16;
  const int keys[2] = {key0 + wkey + g, key0 + wkey + g + 8};  // this lane's key rows
  const int cw = a.head_dim;
  const int64_t head_kv = offset(a.skv, b, h, 0);
  const bf16* q = static_cast<const bf16*>(a.q) + offset(a.sq, b, h, 0);
  const bf16* dout = static_cast<const bf16*>(a.dout) + offset(a.sq, b, h, 0);
  const bf16* mult = static_cast<const bf16*>(a.mult);
  const int64_t stat0 = (static_cast<int64_t>(b) * a.heads + h) * a.tq;
  const float sl2 = a.scale * kLog2e;

  // causal: queries before the tile's first key see none of its keys
  const int q_begin = a.causal ? key0 : 0;
  const int n_tiles = (a.tq - q_begin + kTileRows - 1) / kTileRows;

  // the query tile from row q0 into `stage`: Q and dO by cp.async, lse
  // (in log2 units) and D by plain stores
  auto fill = [&](int stage, int q0) {
    load_tile<C>(sq + stage * Tile<C>::kElems, q, a.sq.t, q0, a.tq, cw, vec);
    load_tile<C>(sdo + stage * Tile<C>::kElems, dout, a.sq.t, q0, a.tq, cw, vec);
    for (int i = threadIdx.x; i < kTileRows; i += mma::kThreads) {
      const bool in = q0 + i < a.tq;
      slse[stage * kTileRows + i] = in ? a.lse[stat0 + q0 + i] * kLog2e : 0.f;
      sdelta[stage * kTileRows + i] = in ? a.delta[stat0 + q0 + i] : 0.f;
    }
  };

  load_tile<C>(sk, static_cast<const bf16*>(a.k) + head_kv, a.skv.t, key0, a.tk, cw, vec);
  load_tile<C>(sv, static_cast<const bf16*>(a.v) + head_kv, a.skv.t, key0, a.tk, cw, vec);
  if (n_tiles > 0) fill(0, q_begin);
  cp_async_commit();

  float dk[C / 8][4], dv[C / 8][4];
#pragma unroll
  for (int j = 0; j < C / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1;
    const int q0 = q_begin + it * kTileRows;
    if (it + 1 < n_tiles) fill(stage ^ 1, q0 + kTileRows);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* cq = sq + stage * Tile<C>::kElems;
    const bf16* cdo = sdo + stage * Tile<C>::kElems;
    const float* clse = slse + stage * kTileRows;
    const float* cdelta = sdelta + stage * kTileRows;

    // 1. S^T = K Q^T: the warp's 16 keys x 64 queries
    float p[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) p[j][0] = p[j][1] = p[j][2] = p[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      uint32_t ka[4];
      load_a(ka, sk + wkey * S, S, ks * 16, lane);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t qb[4];
        load_b_rows(qb, cq + np * 16 * S, S, ks * 16, lane);
        mma_16816(p[2 * np], ka, qb[0], qb[1]);
        mma_16816(p[2 * np + 1], ka, qb[2], qb[3]);
      }
    }
    // P^T from lse
    const bool edge = q0 + kTileRows > a.tq || (a.causal && q0 < key0 + wkey + 15);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * t + (e & 1);
        const int query = q0 + col;
        const bool masked = edge && (query >= a.tq || (a.causal && keys[e >> 1] > query));
        p[j][e] = masked ? 0.f : exp2f(fmaf(p[j][e], sl2, -clse[col]));
      }
    }
    // 2. and 3. dV += Pd^T dO, 16 queries a step: Pd^T = P^T*mult^T of those
    // queries rounded to bf16 into the step's A fragments
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[4];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = 2 * kk + jj;
        float pd[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int query = q0 + j * 8 + 2 * t + (e & 1);
          const int key = keys[e >> 1];
          pd[e] = p[j][e];
          if (mult != nullptr)
            pd[e] *= query < a.tq && key < a.tk
                         ? __bfloat162float(mult[static_cast<int64_t>(query) * a.tk + key])
                         : 0.f;
        }
        pa[jj * 2] = pack_bf16(pd[0], pd[1]);
        pa[jj * 2 + 1] = pack_bf16(pd[2], pd[3]);
      }
#pragma unroll
      for (int np = 0; np < kSteps; ++np) {
        uint32_t db[4];
        load_b_trans(db, cdo + kk * 16 * S, S, np * 16, lane);
        mma_16816(dv[2 * np], pa, db[0], db[1]);
        mma_16816(dv[2 * np + 1], pa, db[2], db[3]);
      }
    }
    // 4. dP^T = V dO^T
    float dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      uint32_t va[4];
      load_a(va, sv + wkey * S, S, ks * 16, lane);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t db[4];
        load_b_rows(db, cdo + np * 16 * S, S, ks * 16, lane);
        mma_16816(dp[2 * np], va, db[0], db[1]);
        mma_16816(dp[2 * np + 1], va, db[2], db[3]);
      }
    }
    // 5. and 6. dK += dS^T Q, 16 queries a step: dS^T = P^T*(dP^T*mult^T -
    // D)*scale of those queries rounded to bf16 into the step's A fragments
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t sa[4];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = 2 * kk + jj;
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = j * 8 + 2 * t + (e & 1);
          const int query = q0 + col;
          const int key = keys[e >> 1];
          float dpv = dp[j][e];
          if (mult != nullptr)
            dpv *= query < a.tq && key < a.tk
                       ? __bfloat162float(mult[static_cast<int64_t>(query) * a.tk + key])
                       : 0.f;
          ds[e] = p[j][e] * (dpv - cdelta[col]) * a.scale;
        }
        sa[jj * 2] = pack_bf16(ds[0], ds[1]);
        sa[jj * 2 + 1] = pack_bf16(ds[2], ds[3]);
      }
#pragma unroll
      for (int np = 0; np < kSteps; ++np) {
        uint32_t qb[4];
        load_b_trans(qb, cq + kk * 16 * S, S, np * 16, lane);
        mma_16816(dk[2 * np], sa, qb[0], qb[1]);
        mma_16816(dk[2 * np + 1], sa, qb[2], qb[3]);
      }
    }
    __syncthreads();
  }

  // dk and dv through the warp's own rows of the K and V tiles
  stage_rows<C>(sk + wkey * S, S, dk, 1.f, 1.f, lane);
  stage_rows<C>(sv + wkey * S, S, dv, 1.f, 1.f, lane);
  __syncwarp();
  store_rows<C>(static_cast<bf16*>(a.dk) + head_kv, a.skv.t, sk + wkey * S, key0 + wkey, a.tk,
                cw, vec, lane);
  store_rows<C>(static_cast<bf16*>(a.dv) + head_kv, a.skv.t, sv + wkey * S, key0 + wkey, a.tk,
                cw, vec, lane);
}

template <int C>
cudaError_t launch_mma(const Args& a, cudaStream_t stream) {
  constexpr int kDqBytes = dq_smem_bytes<C>();
  constexpr int kDkdvBytes = dkdv_smem_bytes<C>();
  static const cudaError_t smem_err = [] {
    const cudaError_t err = mma::allow_smem(attention_dq_mma<C>, dq_smem_bytes<C>());
    return err != cudaSuccess ? err
                              : mma::allow_smem(attention_dkdv_mma<C>, dkdv_smem_bytes<C>());
  }();
  if (smem_err != cudaSuccess) return smem_err;
  bool vec = a.head_dim % 8 == 0;
  for (const void* p : {a.q, a.k, a.v, a.out, a.dout, static_cast<const void*>(a.dq),
                        static_cast<const void*>(a.dk), static_cast<const void*>(a.dv)})
    vec = vec && mma::aligned16(p);
  // the dq kernel writes D, which the dk/dv kernel reads: same stream, in order
  const dim3 q_grid((a.tq + mma::kTileRows - 1) / mma::kTileRows, a.heads, a.batch);
  attention_dq_mma<C><<<q_grid, mma::kThreads, kDqBytes, stream>>>(a, vec);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 k_grid((a.tk + mma::kTileRows - 1) / mma::kTileRows, a.heads, a.batch);
  attention_dkdv_mma<C><<<k_grid, mma::kThreads, kDkdvBytes, stream>>>(a, vec);
  return cudaGetLastError();
}

cudaError_t run(const Args& a, int dtype, void* stream) {
  if (a.batch < 1 || a.tq < 1 || a.tk < 1 || a.heads < 1 || a.batch > 65535 ||
      a.heads > 65535 || (a.causal && a.tq != a.tk) || a.head_dim < 1 || a.head_dim > 128)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_f32(a, s);
  if (dtype == 1)
    return mma::dispatch(a.head_dim,
                         [&](auto c) { return launch_mma<decltype(c)::value>(a, s); });
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
  const Args a{q, k, v, mult, out, dout, static_cast<const float*>(lse), dq, dk, dv,
               static_cast<float*>(delta), batch, tq, tk, heads, head_dim, scale, causal,
               Strides{tq * width, head_dim, width}, Strides{tk * width, head_dim, width}};
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
               static_cast<float*>(delta), batch, seq, seq, heads, head_dim, scale, 0, s, s};
  return run(a, dtype, stream);
}
