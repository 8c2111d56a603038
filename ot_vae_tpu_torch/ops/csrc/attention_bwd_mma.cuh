// bf16 attention backward on the tensor cores (attention_dq_mma,
// attention_dkdv_mma), shared by attention_bthd_bwd.cu (rows 8 and 4) and
// attention_packed_bwd.cu (row 2). Every operand is read or written through
// (batch, head, token) strides in elements with its head dims contiguous:
// dq has q's strides and dk, dv have k's (true of all three layouts: dqkv is
// laid out as qkv), out and dout have their own, and so do lse and D. See
// attention_fwd_mma.cuh for the three layouts.
//
// with P = exp(scale*QK^T - lse) (masked entries 0), D = rowsum(dO*O) in f32,
// Pd = P*mult, dV = Pd^T dO, dP = (dO V^T)*mult, dS = P*(dP - D)*scale,
// dQ = dS K, dK = dS^T Q. Pd is rounded to dO's dtype before Pd^T dO and dS
// to q's dtype before its two products, as the TPU kernels round them; the
// multiplier (rows 8 and 4 only) gets no gradient.
//
// Design (flash-attention 2 on mma.sync.m16n8k16, bf16 operands, f32
// accumulation, mma_bf16.cuh), in two kernels that recompute S and P from
// lse. Each writes its own tensors: there are no atomics and a run repeats
// bit for bit. The price is that S and dP are computed in both kernels: 14
// units of 2*Tq*Tk*d FLOP against the bound's 10, taken for determinism.
// Both kernels: 4 warps, 64-row tiles of 16 rows a warp, tiles in bf16 in
// shared memory with rows padded by 16 bytes (no ldmatrix bank conflict),
// the streamed tiles in two stages filled by cp.async while the other is
// consumed (zero-filled past Tq or Tk), head dims rounded up to a multiple
// of 16 and zero past d (masked scalar copies where d is not a multiple of 8
// or a tensor does not start on 16 bytes). The dQ kernel is launched first;
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
//     64-row query tiles (Q, dO, lse and D double-buffered). Each warp computes
//     the transposed products for its 16 keys, so that P^T and dS^T come out
//     of the accumulators already in the A layout of the next product, with
//     no trip through shared memory:
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
//   - budget at d = 128, two stages: 6 tiles of 64 x 136 bf16 = 104,448
//     bytes of dynamic shared memory in the dq kernel (Q, dO, K and V twice),
//     105,472 in the dk/dv kernel (K, V, Q and dO twice, lse and D twice), so
//     two blocks share an SM; the dk/dv kernel's f32 accumulators (dK and
//     dV, 64 each; P^T and dP^T, 32 each) take most of the 255 registers
//     that two blocks of 128 threads allow: it uses all 255 without
//     spilling, the dq kernel 222 (ptxas -v, PERF.md).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <initializer_list>

#include "mma_bf16.cuh"

namespace mma {

struct BwdArgs {
  const void *q, *k, *v;
  const void* mult;  // [Tq, Tk] contiguous, in q's dtype, or null
  const void *out, *dout;
  const float* lse;
  void *dq, *dk, *dv;
  float* delta;  // D, written by the dq kernel
  int batch, tq, tk, heads, head_dim;
  float scale;
  int causal;
  Strides sq, skv, so, sl;  // q and dq; k, v, dk and dv; out and dout; lse and D
};

// Internal linkage for the plan, the kernels and their launchers: every
// library that includes this header holds its own instantiations, and so
// its own one-time shared-memory set-up. With external linkage a
// function-local static of a template is one (GNU unique) object across all
// the libraries of a process, and only the first library to launch a width
// would raise its kernel's shared-memory limit.
namespace {

// The backward's plan at tile width C: kBlocks, the blocks an SM that the
// registers of both kernels must allow.
template <int C>
struct BwdPlan {
  static constexpr int kBlocks = 2;
};

// At C = 64 (the FFHQ128 CNN's head dim) both kernels in 168 registers (the
// dk/dv kernel spills 8 bytes), so that three blocks share an SM, ran
// 19-25% faster on an H100 than at two blocks, and faster than a third
// stage of the streamed tiles (PERF.md)
template <>
struct BwdPlan<64> {
  static constexpr int kBlocks = 3;
};

// dynamic shared memory: the dq kernel's Q and dO tiles and two stages of K
// and V; the dk/dv kernel's K and V tiles, two stages of Q and dO, and two
// stages of the query tile's lse and D (f32)
template <int C>
__host__ __device__ constexpr int dq_smem_bytes() {
  return 6 * Tile<C>::kBytes;
}

template <int C>
__host__ __device__ constexpr int dkdv_smem_bytes() {
  return 6 * Tile<C>::kBytes + 4 * kTileRows * int(sizeof(float));
}

// C: the tiles' head dims, d rounded up to a multiple of 16 (a.head_dim <= C)
template <int C>
__global__ void __launch_bounds__(kThreads, BwdPlan<C>::kBlocks)
    attention_dq_mma(BwdArgs a, bool vec) {
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
  const int64_t head_o = offset(a.so, b, h, 0);
  const bf16* k = static_cast<const bf16*>(a.k) + offset(a.skv, b, h, 0);
  const bf16* v = static_cast<const bf16*>(a.v) + offset(a.skv, b, h, 0);
  const bf16* mult = static_cast<const bf16*>(a.mult);
  const int64_t stat = offset(a.sl, b, h, 0);
  const float sl2 = a.scale * kLog2e;

  const int key_end = a.causal ? min(a.tk, row0 + kTileRows) : a.tk;
  const int n_tiles = (key_end + kTileRows - 1) / kTileRows;

  load_tile<C>(sq, static_cast<const bf16*>(a.q) + head_q, a.sq.t, row0, a.tq, cw, vec);
  load_tile<C>(sdo, static_cast<const bf16*>(a.dout) + head_o, a.so.t, row0, a.tq, cw, vec);
  cp_async_commit();
  load_tile<C>(sk, k, a.skv.t, 0, a.tk, cw, vec);
  load_tile<C>(sv, v, a.skv.t, 0, a.tk, cw, vec);
  cp_async_commit();
  cp_async_wait<1>();  // Q and dO have landed
  __syncthreads();

  // D = rowsum(dO*O) in f32 for the warp's 16 rows (dO from its tile, O
  // from device memory), stored for the dk/dv kernel; each lane keeps its
  // two rows' D and lse (in log2 units)
  const bf16* o = static_cast<const bf16*>(a.out) + head_o;
  float delta[2] = {0.f, 0.f};
  for (int r = 0; r < 16; ++r) {
    const int row = row0 + wrow + r;
    float part = 0.f;
    if (row < a.tq)
      for (int c = lane; c < cw; c += 32)
        part = fmaf(__bfloat162float(sdo[(wrow + r) * S + c]),
                    __bfloat162float(o[row * a.so.t + c]), part);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
    if (r == g) delta[0] = part;
    if (r == g + 8) delta[1] = part;
    if (lane == 0 && row < a.tq) a.delta[stat + row * a.sl.t] = part;
  }
  float lse2[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    lse2[i] = rows[i] < a.tq ? a.lse[stat + rows[i] * a.sl.t] * kLog2e : 0.f;

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
__global__ void __launch_bounds__(kThreads, BwdPlan<C>::kBlocks)
    attention_dkdv_mma(BwdArgs a, bool vec) {
  constexpr int S = Tile<C>::kStride;
  constexpr int kSteps = C / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sk = reinterpret_cast<bf16*>(smem);
  bf16* sv = sk + Tile<C>::kElems;
  bf16* sq = sv + Tile<C>::kElems;       // two stages
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
  const bf16* dout = static_cast<const bf16*>(a.dout) + offset(a.so, b, h, 0);
  const bf16* mult = static_cast<const bf16*>(a.mult);
  const int64_t stat = offset(a.sl, b, h, 0);
  const float sl2 = a.scale * kLog2e;

  // causal: queries before the tile's first key see none of its keys
  const int q_begin = a.causal ? key0 : 0;
  const int n_tiles = (a.tq - q_begin + kTileRows - 1) / kTileRows;

  // the query tile from row q0 into `stage`: Q and dO by cp.async, lse (in
  // log2 units) and D by plain stores
  auto fill = [&](int stage, int q0) {
    load_tile<C>(sq + stage * Tile<C>::kElems, q, a.sq.t, q0, a.tq, cw, vec);
    load_tile<C>(sdo + stage * Tile<C>::kElems, dout, a.so.t, q0, a.tq, cw, vec);
    for (int i = threadIdx.x; i < kTileRows; i += kThreads) {
      const bool in = q0 + i < a.tq;
      slse[stage * kTileRows + i] = in ? a.lse[stat + (q0 + i) * a.sl.t] * kLog2e : 0.f;
      sdelta[stage * kTileRows + i] = in ? a.delta[stat + (q0 + i) * a.sl.t] : 0.f;
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
cudaError_t launch_bwd(const BwdArgs& a, cudaStream_t stream) {
  constexpr int kDqBytes = dq_smem_bytes<C>();
  constexpr int kDkdvBytes = dkdv_smem_bytes<C>();
  static const cudaError_t smem_err = [] {
    const cudaError_t err = allow_smem(attention_dq_mma<C>, dq_smem_bytes<C>());
    return err != cudaSuccess ? err : allow_smem(attention_dkdv_mma<C>, dkdv_smem_bytes<C>());
  }();
  if (smem_err != cudaSuccess) return smem_err;
  // every pointer that a tile is copied from or stored to
  bool vec = a.head_dim % 8 == 0;
  for (const void* p : {a.q, a.k, a.v, a.out, a.dout, static_cast<const void*>(a.dq),
                        static_cast<const void*>(a.dk), static_cast<const void*>(a.dv)})
    vec = vec && aligned16(p);
  // the dq kernel writes D, which the dk/dv kernel reads: same stream, in order
  const dim3 q_grid((a.tq + kTileRows - 1) / kTileRows, a.heads, a.batch);
  attention_dq_mma<C><<<q_grid, kThreads, kDqBytes, stream>>>(a, vec);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 k_grid((a.tk + kTileRows - 1) / kTileRows, a.heads, a.batch);
  attention_dkdv_mma<C><<<k_grid, kThreads, kDkdvBytes, stream>>>(a, vec);
  return cudaGetLastError();
}

// the bf16 backward at a.head_dim (1 to 128)
cudaError_t run_bwd(const BwdArgs& a, cudaStream_t stream) {
  return dispatch(a.head_dim, [&](auto c) { return launch_bwd<decltype(c)::value>(a, stream); });
}

}  // namespace

}  // namespace mma
