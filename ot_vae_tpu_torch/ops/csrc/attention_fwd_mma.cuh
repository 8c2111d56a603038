// bf16 attention forward on the tensor cores (attention_fwd_mma), shared by
// attention_bthd.cu (rows 7 and 3: q, k, v in their own tensors) and
// attention_packed.cu (row 1: q, k and v as column blocks of one packed
// qkv). q, k and v are read through (batch, head, token) strides in
// elements, head dims contiguous, and out and lse are written in one of two
// layouts fixed at compile time, so one kernel serves every layout:
//
//   row 7  q, out [B, Tq, H*d], k, v [B, Tk, H*d]: token stride H*d, head
//          stride d; lse [B, H, Tq];
//   row 3  q, k, v, out [B, H, T, d]: token stride d, head stride T*d; lse
//          [B*H, T] (the same memory as [B, H, T]);
//   row 1  q, k, v at columns 0, H*C and 2*H*C of qkv [B, T, 3*H*C]: token
//          stride 3*H*C, head stride C; out [B, T, H*C] and lse [B, T, H]
//          (the kernel's kPacked layouts).
//
// Design (flash-attention 2 on mma.sync.m16n8k16, bf16 operands, f32
// accumulation; the instructions are in mma_bf16.cuh):
//   - grid (query tile, head, batch); a block is 4 warps and kM * 64 query
//     rows, kM 16-row m-tiles a warp (rows 16w.., 64 + 16w.., ...), so every
//     K and V fragment that ldmatrix reads feeds kM products. The Q tiles are
//     copied once and stay in shared memory, their A fragments read by
//     ldmatrix at each step.
//   - K and V tiles of 64 keys x d are held in bf16 in shared memory, rows
//     padded by 16 bytes (no ldmatrix bank conflict), in two stages filled
//     by cp.async while the other stage is consumed; rows past Tk are
//     zero-filled.
//   - S = Q K^T on the tensor cores (B fragments of K by ldmatrix); the
//     online softmax runs in f32 on the accumulator fragments, the row max
//     and sum over the 4 lanes of a quad, with exp2f and scale*log2(e)
//     folded into one multiply. Causal: key tiles wholly above the block's
//     last row are skipped, the diagonal tiles masked entry by entry (an
//     m-tile's tile wholly above its own rows is then all masked); keys
//     past Tk are masked.
//   - the multiplier (rows 7 and 3 only) is read for each fragment's own
//     entries from the one [Tq, Tk] tensor, which L2 holds for every batch
//     element and head.
//   - P (times mult) is rounded to bf16 and packed in registers straight
//     into the A fragments of P V (B fragments of V by ldmatrix.trans): the
//     products' inputs are bf16 operands, as the TPU kernels round P to v's
//     dtype before P V. P here is the running maximum's unnormalised P, so
//     the rounding is of the same size as the TPU kernels' rounding of the
//     normalised P, not the same bits. O accumulates in f32 and is divided
//     once by the f32 sum of the unrounded P: out = acc / l, lse = m +
//     log(l). Output rows go through the warp's own rows of the Q tile to
//     16-byte stores.
//   - head dims: every d from 1 to 128. The tiles are built for d rounded
//     up to a multiple of 16 (16, 32, ..., 128) and the dims past d are
//     zero. When d is a multiple of 8 and q, k, v and out start on 16 bytes,
//     every row of every operand starts on 16 bytes (all token and head
//     strides of the three layouts are multiples of d, and for row 1 the
//     column offsets H*d and 2*H*d too), so the tiles are copied in 16-byte
//     chunks by cp.async; any other d, or an unaligned tensor, copies
//     through masked scalar loads.
//   - budget at d = 128: 6 tiles of 64 x 136 bf16 (Q twice, K and V
//     twice each) = 104,448 bytes of dynamic shared memory (the opt-in limit
//     is set at launch), so two blocks share an SM (227 KB). Two blocks of
//     128 threads allow 255 registers a thread: the f32 accumulators take
//     192 of them (O, 2 x 64; S, 2 x 32) and the d = 128 build reaches 255
//     and spills 64 bytes (ptxas -v, PERF.md).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "mma_bf16.cuh"

namespace mma {

// q, k and v are read through their strides. out and lse have one of two
// layouts, fixed at compile time (attention_fwd_mma's kPacked): out through
// q's strides and lse [B, H, Tq] (rows 7 and 3), or out a contiguous
// [B, T, H*d] and lse [B, T, H] (row 1). The struct stays at 128 bytes: with
// strides of its own for out and lse (176 bytes) the d = 128 forward ran
// 5-41% slower on an H100, the compiler no longer splitting the loop on
// `mult` (PERF.md).
struct FwdArgs {
  const void *q, *k, *v;
  const void* mult;  // [Tq, Tk] contiguous, in q's dtype, or null
  void* out;
  float* lse;
  int batch, tq, tk, heads, head_dim;
  float scale;
  int causal;
  Strides sq, skv;  // q; k and v
};

// Internal linkage for the kernels and their launchers: every library that
// includes this header holds its own instantiations, and so its own
// one-time shared-memory set-up. With external linkage a function-local
// static of a template is one (GNU unique) object across all the libraries
// of a process, and only the first library to launch a width would raise
// its kernel's shared-memory limit.
namespace {

// 16-row m-tiles each warp owns, so a block holds kM * 64 query rows: two
// reuse every K and V fragment that ldmatrix reads for two products, and
// ran faster on an H100 than one at d = 128, though that build spills; at
// d = 64 one m-tile with four blocks an SM ran as fast, within 3% either
// way (PERF.md)
constexpr int kM = 2;

// dynamic shared memory of attention_fwd_mma: kM Q tiles, then K and V tiles
// in two stages each
template <int C>
__host__ __device__ constexpr int fwd_smem_bytes() {
  return (kM + 4) * Tile<C>::kBytes;
}

// C: the tiles' head dims, d rounded up to a multiple of 16 (a.head_dim <= C);
// kPacked: row 1's out and lse layouts (see FwdArgs)
template <int C, bool kPacked>
__global__ void __launch_bounds__(kThreads, 2) attention_fwd_mma(FwdArgs a, bool vec) {
  constexpr int S = Tile<C>::kStride;
  constexpr int kSteps = C / 16;  // 16-deep steps over the head dims
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);  // kM tiles
  bf16* sk = sq + kM * Tile<C>::kElems;      // two stages
  bf16* sv = sk + 2 * Tile<C>::kElems;

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int row0 = blockIdx.x * kM * kTileRows;
  const int wrow = (threadIdx.x >> 5) * 16;  // the warp's first row in each Q tile
  int rows[kM][2];                           // this lane's query rows
#pragma unroll
  for (int mi = 0; mi < kM; ++mi) {
    rows[mi][0] = row0 + mi * kTileRows + wrow + g;
    rows[mi][1] = rows[mi][0] + 8;
  }
  const int cw = a.head_dim;
  const bf16* q = static_cast<const bf16*>(a.q) + offset(a.sq, b, h, 0);
  const bf16* k = static_cast<const bf16*>(a.k) + offset(a.skv, b, h, 0);
  const bf16* v = static_cast<const bf16*>(a.v) + offset(a.skv, b, h, 0);
  const bf16* mult = static_cast<const bf16*>(a.mult);
  const float sl2 = a.scale * kLog2e;

  // causal: the block's last row sees keys up to itself, none past it
  const int key_end = a.causal ? min(a.tk, row0 + kM * kTileRows) : a.tk;
  const int n_tiles = (key_end + kTileRows - 1) / kTileRows;

#pragma unroll
  for (int mi = 0; mi < kM; ++mi)
    load_tile<C>(sq + mi * Tile<C>::kElems, q, a.sq.t, row0 + mi * kTileRows, a.tq, cw, vec);
  load_tile<C>(sk, k, a.skv.t, 0, a.tk, cw, vec);
  load_tile<C>(sv, v, a.skv.t, 0, a.tk, cw, vec);
  cp_async_commit();

  float o[kM][C / 8][4];
#pragma unroll
  for (int mi = 0; mi < kM; ++mi)
#pragma unroll
    for (int j = 0; j < C / 8; ++j) o[mi][j][0] = o[mi][j][1] = o[mi][j][2] = o[mi][j][3] = 0.f;
  float m[kM][2];  // running row max of s*scale*log2(e)
  float l[kM][2];  // this lane's part of the running row sum
#pragma unroll
  for (int mi = 0; mi < kM; ++mi) {
    m[mi][0] = m[mi][1] = -INFINITY;
    l[mi][0] = l[mi][1] = 0.f;
  }

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int stage = kt & 1;
    if (kt + 1 < n_tiles) {
      const int next = (stage ^ 1) * Tile<C>::kElems;
      load_tile<C>(sk + next, k, a.skv.t, (kt + 1) * kTileRows, a.tk, cw, vec);
      load_tile<C>(sv + next, v, a.skv.t, (kt + 1) * kTileRows, a.tk, cw, vec);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and, first, Q) has landed
    __syncthreads();
    const bf16* ck = sk + stage * Tile<C>::kElems;
    const bf16* cv = sv + stage * Tile<C>::kElems;
    const int k0 = kt * kTileRows;

    float s[kM][8][4];
#pragma unroll
    for (int mi = 0; mi < kM; ++mi)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[mi][j][0] = s[mi][j][1] = s[mi][j][2] = s[mi][j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      uint32_t qf[kM][4];
#pragma unroll
      for (int mi = 0; mi < kM; ++mi)
        load_a(qf[mi], sq + mi * Tile<C>::kElems + wrow * S, S, ks * 16, lane);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t kb[4];
        load_b_rows(kb, ck + np * 16 * S, S, ks * 16, lane);
#pragma unroll
        for (int mi = 0; mi < kM; ++mi) {
          mma_16816(s[mi][2 * np], qf[mi], kb[0], kb[1]);
          mma_16816(s[mi][2 * np + 1], qf[mi], kb[2], kb[3]);
        }
      }
    }

    // mask past Tk and above the diagonal (only where the tile reaches them),
    // then the new row max and the rescaled sums and accumulators
    float base[kM][2];
#pragma unroll
    for (int mi = 0; mi < kM; ++mi) {
      const bool edge = k0 + kTileRows > a.tk ||
                        (a.causal && k0 + kTileRows - 1 > row0 + mi * kTileRows + wrow);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[mi][j][e] * sl2;
          if (edge) {
            const int key = k0 + j * 8 + 2 * t + (e & 1);
            if (key >= a.tk || (a.causal && key > rows[mi][e >> 1])) x = -INFINITY;
          }
          s[mi][j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float m_new = fmaxf(m[mi][i], quad_max(mx[i]));
        // a row that has seen only masked keys keeps m = -inf; exp2(-inf) = 0
        base[mi][i] = m_new == -INFINITY ? 0.f : m_new;
        const float alpha = exp2f(m[mi][i] - base[mi][i]);
        l[mi][i] *= alpha;
#pragma unroll
        for (int j = 0; j < C / 8; ++j) {
          o[mi][j][2 * i] *= alpha;
          o[mi][j][2 * i + 1] *= alpha;
        }
        m[mi][i] = m_new;
      }
    }

    // P (times mult) rounded to bf16: the A fragments of P V, 16 keys a step
    uint32_t pa[kM][4][4];
#pragma unroll
    for (int mi = 0; mi < kM; ++mi) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = exp2f(s[mi][j][e] - base[mi][e >> 1]);
          l[mi][e >> 1] += p[e];
        }
        if (mult != nullptr) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + j * 8 + 2 * t + (e & 1);
            const int row = rows[mi][e >> 1];
            p[e] *= row < a.tq && key < a.tk
                        ? __bfloat162float(mult[static_cast<int64_t>(row) * a.tk + key])
                        : 0.f;
          }
        }
        pa[mi][j >> 1][(j & 1) * 2] = pack_bf16(p[0], p[1]);
        pa[mi][j >> 1][(j & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int dp = 0; dp < kSteps; ++dp) {
        uint32_t vb[4];
        load_b_trans(vb, cv + kk * 16 * S, S, dp * 16, lane);
#pragma unroll
        for (int mi = 0; mi < kM; ++mi) {
          mma_16816(o[mi][2 * dp], pa[mi][kk], vb[0], vb[1]);
          mma_16816(o[mi][2 * dp + 1], pa[mi][kk], vb[2], vb[3]);
        }
      }
    }
    __syncthreads();  // this stage is consumed before the next fill
  }

  const Strides so = kPacked ? Strides{static_cast<int64_t>(a.tq) * a.heads * a.head_dim,
                                       a.head_dim, static_cast<int64_t>(a.heads) * a.head_dim}
                             : a.sq;
#pragma unroll
  for (int mi = 0; mi < kM; ++mi) {
    float inv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[mi][i] = quad_sum(l[mi][i]);
      inv[i] = 1.f / l[mi][i];
    }
    // out through the warp's own rows of the Q tile, to 16-byte stores
    bf16* rows_q = sq + mi * Tile<C>::kElems + wrow * S;
    stage_rows<C>(rows_q, S, o[mi], inv[0], inv[1], lane);
    __syncwarp();
    store_rows<C>(static_cast<bf16*>(a.out) + offset(so, b, h, 0), so.t, rows_q,
                  row0 + mi * kTileRows + wrow, a.tq, cw, vec, lane);
    if (t == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (rows[mi][i] < a.tq)
          a.lse[kPacked ? (static_cast<int64_t>(b) * a.tq + rows[mi][i]) * a.heads + h
                        : (static_cast<int64_t>(b) * a.heads + h) * a.tq + rows[mi][i]] =
              (m[mi][i] + log2f(l[mi][i])) * kLn2;
    }
  }
}

template <int C, bool kPacked>
cudaError_t launch_fwd(const FwdArgs& a, cudaStream_t stream) {
  constexpr int kBytes = fwd_smem_bytes<C>();
  static const cudaError_t smem_err = allow_smem(attention_fwd_mma<C, kPacked>, kBytes);
  if (smem_err != cudaSuccess) return smem_err;
  const bool vec = a.head_dim % 8 == 0 && aligned16(a.q) && aligned16(a.k) && aligned16(a.v) &&
                   aligned16(a.out);
  constexpr int kRows = kM * kTileRows;
  const dim3 grid((a.tq + kRows - 1) / kRows, a.heads, a.batch);
  attention_fwd_mma<C, kPacked><<<grid, kThreads, kBytes, stream>>>(a, vec);
  return cudaGetLastError();
}

// the bf16 forward at a.head_dim (1 to 128)
template <bool kPacked>
cudaError_t run_fwd(const FwdArgs& a, cudaStream_t stream) {
  return dispatch(a.head_dim,
                  [&](auto c) { return launch_fwd<decltype(c)::value, kPacked>(a, stream); });
}

}  // namespace

}  // namespace mma
