// Fused attention block backward for Hopper (sm_90a).
//
// Replaces the TPU kernel `_block_bwd_kernel` (ot_vae_tpu/ops/attention_pallas.py),
// reached through `_fused_block_bwd`, the VJP of `fused_attention_block`.
// Same function: from the forward's residuals x, w_qkv, w_out, lse and the
// output's gradient dout [B, T, C_out],
//
//   dx     [B, T, C]        in x's dtype
//   dw_qkv [C, 3*H*ch]      f32, summed over the batch
//   dw_out [H*ch, C_out]    f32, summed over the batch
//
// with qkv and the per-head attention output recomputed and rounded to x's
// dtype, dattn = dout w_out^T rounded to x's dtype, the packed attention
// backward of (qkv, attn, lse, dattn) giving dqkv rounded to x's dtype,
// dx = dqkv w_qkv^T, dw_qkv = x^T dqkv and dw_out = attn^T dout.
//
// Design: one call, several launches on one stream, no atomics:
//   1. qkv = x w_qkv (block_gemm.cuh), as the forward computes it, so that
//      the recomputed qkv is the forward's to the bit;
//   2. attn recomputed from lse, as the TPU kernel recomputes it: per query
//      row P = exp(scale*QK^T - lse) rounded to x's dtype, attn = P V in f32
//      rounded to x's dtype, with no running maximum and no rescale.
//      Rounding P as the plain version does matters: D = rowsum(dattn *
//      attn) shifts every dS of a row alike, so a bias in attn adds up over
//      the keys in dq and dk rather than averaging out;
//   3. dattn = dout w_out^T (block_gemm.cuh);
//   4. dqkv by the packed attention backward with attn in out's place and
//      dattn in dout's: a dq kernel that writes D, then a dk/dv kernel, each
//      writing its own columns;
//   5. dx = dqkv w_qkv^T;
//   6. dw_qkv = x^T dqkv and dw_out = attn^T dout, each summed over all B*T
//      rows. The TPU accumulated these across its sequential grid; here the
//      rows are split into fixed ranges summed by separate blocks into an
//      f32 workspace, then added in order (block_gemm.cuh), so two runs on
//      the same inputs give the same bits.
//
// The dtype picks the kernels, inside this library, as in rows 1 and 2:
//   - bf16 runs on the tensor cores throughout: a cast pass rounds both
//     weights to bf16 into the workspace w_ws, step 1 sums exactly on the
//     FP64 tensor cores (block_gemm's exact_gemm_kernel, as the forward),
//     steps 3, 5 and 6 run block_gemm's bf16 mma.sync GEMM (dw_qkv and
//     dw_out with bf16 operands and f32 sums), step 2 runs
//     attn_from_lse_mma below (the forward's S = QK^T and P V on mma.sync,
//     P from lse in f32, rounded to bf16 and packed in registers into P V's
//     A fragments), and step 4 runs
//     rows 2 and 8's attention_dq_mma and attention_dkdv_mma
//     (attention_bwd_mma.cuh) on the packed layout read through strides,
//     exactly as attention_packed_bwd.cu calls them.
//   - f32 runs on CUDA cores (block_gemm's gemm, attn_from_lse_f32 below,
//     attention_packed_bwd.cuh): tensor cores would take f32 operands as
//     TF32, which the f32 gates and the f32 card-vs-CPU train steps do not
//     allow. A choice of arithmetic, not a size threshold: every bf16 call
//     runs the tensor-core kernels.
//
// What bounds it: at the decoder's 32x32 block at the train batch (B=128,
// T=1024, H=2, ch=64, C=C_out=128) the function needs 10*T^2*H*ch +
// 4*T*C*3*H*ch + 4*T*H*ch*C_out = 1.6e9 FLOP per batch element, 2.1e11 in
// all, against about 100 MB of input and output, so the card's bound is the
// tensor-core rate (0.21 ms).

#include "attention_bwd_mma.cuh"
#include "attention_packed_bwd.cuh"
#include "block_gemm.cuh"

namespace {

using mma::bf16;

// ---------------------------------------------------------------- f32

using packed_bwd::kThreads;
using packed_bwd::kTile;

// attn [B, T, H*ch] = exp(scale*QK^T - lse) V in f32 from the packed qkv;
// grid (query tile, head, batch), laid out as the packed backward's f32
// kernels: rows split over 1 to 8 threads, K and V tiles streamed through
// shared memory. C is the width the kernel is built for, `ch` the tensors'
// head dim (C unless kTail).
template <int C, bool kTail>
__global__ void __launch_bounds__(kThreads)
attn_from_lse_f32(const float* __restrict__ qkv, const float* __restrict__ lse,
                  float* __restrict__ attn, int seq, int heads, int ch, float scale) {
  using S = packed_bwd::Split<C>;
  constexpr int R = S::kRowThreads;
  __shared__ float k_tile[kTile][C];
  __shared__ float v_tile[kTile][C];

  const int cw = kTail ? ch : C;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int row = blockIdx.x * S::kRows + threadIdx.x / R;
  const int part = threadIdx.x % R;
  const int64_t width = 3LL * heads * cw;
  const float* qkv_b = qkv + static_cast<int64_t>(b) * seq * width;
  const bool valid = row < seq;

  float q[S::kDims], o[S::kDims];
  float lse_i = 0.f;
#pragma unroll
  for (int i = 0; i < S::kDims; ++i) {
    q[i] = 0.f;
    o[i] = 0.f;
  }
  if (valid) {
    const float* q_row = qkv_b + row * width + h * cw;
#pragma unroll
    for (int i = 0; i < S::kDims; ++i)
      if (!kTail || part + R * i < cw) q[i] = q_row[part + R * i];
    lse_i = lse[(static_cast<int64_t>(b) * seq + row) * heads + h];
  }

  for (int k0 = 0; k0 < seq; k0 += kTile) {
    __syncthreads();  // the previous tiles are consumed
    packed_bwd::fill_tile<float, C>(k_tile, qkv_b, width, heads * cw + h * cw, k0, seq, cw);
    packed_bwd::fill_tile<float, C>(v_tile, qkv_b, width, 2 * heads * cw + h * cw, k0, seq, cw);
    __syncthreads();
    const int n_keys = min(kTile, seq - k0);
#pragma unroll 2
    for (int j = 0; j < n_keys; ++j) {
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < S::kDims; ++i) s = fmaf(q[i], k_tile[j][part + R * i], s);
      s = packed_bwd::row_sum<R>(s);
      const float p = expf(s * scale - lse_i);
#pragma unroll
      for (int i = 0; i < S::kDims; ++i) o[i] = fmaf(p, v_tile[j][part + R * i], o[i]);
    }
  }

  if (!valid) return;
  float* o_row = attn + (static_cast<int64_t>(b) * seq + row) * heads * cw + h * cw;
#pragma unroll
  for (int i = 0; i < S::kDims; ++i)
    if (!kTail || part + R * i < cw) o_row[part + R * i] = o[i];
}

template <int C, bool kTail>
cudaError_t launch_attn_f32(const float* qkv, const float* lse, float* attn, int batch, int seq,
                            int heads, int head_dim, float scale, cudaStream_t stream) {
  constexpr int kRows = packed_bwd::Split<C>::kRows;
  const dim3 grid((seq + kRows - 1) / kRows, heads, batch);
  attn_from_lse_f32<C, kTail><<<grid, kThreads, 0, stream>>>(qkv, lse, attn, seq, heads,
                                                             head_dim, scale);
  return cudaGetLastError();
}

cudaError_t attn_from_lse(const float* qkv, const float* lse, float* attn, int batch, int seq,
                          int heads, int head_dim, float scale, cudaStream_t stream) {
#define CASE(C, TAIL) \
  case C:             \
    return launch_attn_f32<C, TAIL>(qkv, lse, attn, batch, seq, heads, head_dim, scale, stream);
  if (head_dim % 8 == 0) {
    switch (head_dim) {
      CASE(8, false) CASE(16, false) CASE(24, false) CASE(32, false)
      CASE(40, false) CASE(48, false) CASE(56, false) CASE(64, false)
      CASE(72, false) CASE(80, false) CASE(88, false) CASE(96, false)
      CASE(104, false) CASE(112, false) CASE(120, false) CASE(128, false)
      default:
        return cudaErrorInvalidValue;
    }
  }
  int padded = 1;
  while (padded < head_dim) padded *= 2;
  switch (padded) {
    CASE(1, true) CASE(2, true) CASE(4, true) CASE(8, true)
    CASE(16, true) CASE(32, true) CASE(64, true) CASE(128, true)
    default:
      return cudaErrorInvalidValue;
  }
#undef CASE
}

cudaError_t block_bwd_f32(const float* x, const float* w_qkv, int64_t wq0, int64_t wq1,
                          const float* w_out, int64_t wo0, int64_t wo1, const float* lse,
                          const float* dout, float* dx, float* dw_qkv, int64_t dq0, int64_t dq1,
                          float* dw_out, int64_t do0, int64_t do1, float* qkv, float* attn,
                          float* dattn, float* dqkv, float* delta, float* split_ws,
                          int splits_qkv, int splits_out, int batch, int seq, int channels,
                          int heads, int head_dim, int out_channels, float scale,
                          cudaStream_t stream) {
  const int rows = batch * seq;
  const int width = heads * head_dim;
  cudaError_t err = block_gemm::gemm(x, channels, 1, w_qkv, wq0, wq1, qkv, 3 * width, 1, rows,
                                     3 * width, channels, stream);
  if (err != cudaSuccess) return err;
  err = attn_from_lse(qkv, lse, attn, batch, seq, heads, head_dim, scale, stream);
  if (err != cudaSuccess) return err;
  // dattn[r, p] = sum_o dout[r, o] w_out[p, o]
  err = block_gemm::gemm(dout, out_channels, 1, w_out, wo1, wo0, dattn, width, 1, rows, width,
                         out_channels, stream);
  if (err != cudaSuccess) return err;
  err = packed_bwd::dispatch<float>(head_dim, qkv, attn, lse, dattn, dqkv, delta, batch, seq,
                                    heads, scale, stream);
  if (err != cudaSuccess) return err;
  // dx[r, c] = sum_n dqkv[r, n] w_qkv[c, n]
  err = block_gemm::gemm(dqkv, 3 * width, 1, w_qkv, wq1, wq0, dx, channels, 1, rows, channels,
                         3 * width, stream);
  if (err != cudaSuccess) return err;
  // dw_qkv[c, n] = sum_r x[r, c] dqkv[r, n]
  err = block_gemm::gemm_split(x, 1, channels, dqkv, 3 * width, 1, dw_qkv, dq0, dq1, channels,
                               3 * width, rows, split_ws, splits_qkv, stream);
  if (err != cudaSuccess) return err;
  // dw_out[p, o] = sum_r attn[r, p] dout[r, o]; the workspace is free again
  return block_gemm::gemm_split(attn, 1, width, dout, out_channels, 1, dw_out, do0, do1, width,
                                out_channels, rows, split_ws, splits_out, stream);
}

// ---------------------------------------------------------------- bf16

// attn [B, T, H*ch] = (exp2(S*scale*log2(e) - lse*log2(e)) rounded to bf16)
// V on the tensor cores, rounded to bf16, from the packed qkv [B, T,
// 3*H*ch]; grid (query tile, head, batch), 4 warps of 16 query rows. The Q
// tile stays in shared memory; K and V tiles of 64 keys stream through two
// stages filled by cp.async (mma_bf16.cuh). S = Q K^T accumulates in f32,
// P comes straight from lse (no running maximum, no rescale; keys past T
// masked to 0) and is packed in registers into the A fragments of P V, as
// attention_fwd_mma packs its P. C: the tiles' head dims, ch rounded up to
// a multiple of 16. Budget at C = 128: 5 tiles of 64 x 136 bf16 = 87,040
// bytes of dynamic shared memory, two blocks an SM.
template <int C>
__global__ void __launch_bounds__(mma::kThreads, 2)
attn_from_lse_mma(const bf16* __restrict__ qkv, const float* __restrict__ lse,
                  bf16* __restrict__ attn, int seq, int heads, int ch, float scale, bool vec) {
  using mma::Tile;
  using mma::kTileRows;
  constexpr int S = Tile<C>::kStride;
  constexpr int kSteps = C / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* sk = sq + Tile<C>::kElems;      // two stages
  bf16* sv = sk + 2 * Tile<C>::kElems;  // two stages

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int row0 = blockIdx.x * kTileRows;
  const int wrow = (threadIdx.x >> 5) * 16;
  const int rows[2] = {row0 + wrow + g, row0 + wrow + g + 8};
  const int64_t width = 3LL * heads * ch;
  const bf16* base = qkv + static_cast<int64_t>(b) * seq * width + h * ch;
  const bf16* q = base;
  const bf16* k = base + heads * ch;
  const bf16* v = base + 2 * heads * ch;
  const float sl2 = scale * mma::kLog2e;
  const int n_tiles = (seq + kTileRows - 1) / kTileRows;

  mma::load_tile<C>(sq, q, width, row0, seq, ch, vec);
  mma::load_tile<C>(sk, k, width, 0, seq, ch, vec);
  mma::load_tile<C>(sv, v, width, 0, seq, ch, vec);
  mma::cp_async_commit();

  float lse2[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    lse2[i] = rows[i] < seq ? lse[(static_cast<int64_t>(b) * seq + rows[i]) * heads + h] *
                                  mma::kLog2e
                            : 0.f;
  float o[C / 8][4];
#pragma unroll
  for (int j = 0; j < C / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int stage = kt & 1;
    if (kt + 1 < n_tiles) {
      const int next = (stage ^ 1) * Tile<C>::kElems;
      mma::load_tile<C>(sk + next, k, width, (kt + 1) * kTileRows, seq, ch, vec);
      mma::load_tile<C>(sv + next, v, width, (kt + 1) * kTileRows, seq, ch, vec);
    }
    mma::cp_async_commit();
    mma::cp_async_wait<1>();  // this tile (and, first, Q) has landed
    __syncthreads();
    const bf16* ck = sk + stage * Tile<C>::kElems;
    const bf16* cv = sv + stage * Tile<C>::kElems;
    const int k0 = kt * kTileRows;

    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      uint32_t qf[4];
      mma::load_a(qf, sq + wrow * S, S, ks * 16, lane);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t kb[4];
        mma::load_b_rows(kb, ck + np * 16 * S, S, ks * 16, lane);
        mma::mma_16816(s[2 * np], qf, kb[0], kb[1]);
        mma::mma_16816(s[2 * np + 1], qf, kb[2], kb[3]);
      }
    }

    // P from lse, rounded to bf16: the A fragments of P V, 16 keys a step
    const bool edge = k0 + kTileRows > seq;
    uint32_t pa[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + 2 * t + (e & 1);
        p[e] = edge && key >= seq ? 0.f : exp2f(fmaf(s[j][e], sl2, -lse2[e >> 1]));
      }
      pa[j >> 1][(j & 1) * 2] = mma::pack_bf16(p[0], p[1]);
      pa[j >> 1][(j & 1) * 2 + 1] = mma::pack_bf16(p[2], p[3]);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int dp = 0; dp < kSteps; ++dp) {
        uint32_t vb[4];
        mma::load_b_trans(vb, cv + kk * 16 * S, S, dp * 16, lane);
        mma::mma_16816(o[2 * dp], pa[kk], vb[0], vb[1]);
        mma::mma_16816(o[2 * dp + 1], pa[kk], vb[2], vb[3]);
      }
    }
    __syncthreads();  // this stage is consumed before the next fill
  }

  // attn through the warp's own rows of the Q tile, to 16-byte stores
  bf16* rows_q = sq + wrow * S;
  mma::stage_rows<C>(rows_q, S, o, 1.f, 1.f, lane);
  __syncwarp();
  mma::store_rows<C>(attn + static_cast<int64_t>(b) * seq * heads * ch + h * ch,
                     static_cast<int64_t>(heads) * ch, rows_q, row0 + wrow, seq, ch, vec, lane);
}

template <int C>
cudaError_t launch_attn_mma(const bf16* qkv, const float* lse, bf16* attn, int batch, int seq,
                            int heads, int head_dim, float scale, cudaStream_t stream) {
  constexpr int kBytes = 5 * mma::Tile<C>::kBytes;
  static const cudaError_t smem_err = mma::allow_smem(attn_from_lse_mma<C>, kBytes);
  if (smem_err != cudaSuccess) return smem_err;
  const bool vec = head_dim % 8 == 0 && mma::aligned16(qkv) && mma::aligned16(attn);
  const dim3 grid((seq + mma::kTileRows - 1) / mma::kTileRows, heads, batch);
  attn_from_lse_mma<C><<<grid, mma::kThreads, kBytes, stream>>>(qkv, lse, attn, seq, heads,
                                                                 head_dim, scale, vec);
  return cudaGetLastError();
}

cudaError_t block_bwd_bf16(const bf16* x, const float* w_qkv, int64_t wq0, int64_t wq1,
                           const float* w_out, int64_t wo0, int64_t wo1, const float* lse,
                           const bf16* dout, bf16* dx, float* dw_qkv, int64_t dq0, int64_t dq1,
                           float* dw_out, int64_t do0, int64_t do1, bf16* qkv, bf16* attn,
                           bf16* dattn, bf16* dqkv, float* delta, float* split_ws, bf16* w_ws,
                           int splits_qkv, int splits_out, int batch, int seq, int channels,
                           int heads, int head_dim, int out_channels, float scale,
                           cudaStream_t stream) {
  const int rows = batch * seq;
  const int width = heads * head_dim;
  const int64_t ldq = block_gemm::padded(3 * width);
  const int64_t ldo = block_gemm::padded(out_channels);
  const bf16* wq = w_ws;                   // [C, ldq]
  const bf16* wo = w_ws + channels * ldq;  // [H*ch, ldo]
  cudaError_t err = block_gemm::cast_weights(w_qkv, wq0, wq1, w_out, wo0, wo1, channels, width,
                                             out_channels, w_ws, stream);
  if (err != cudaSuccess) return err;
  // qkv[r, j] = sum_c x[r, c] w_qkv[c, j], exactly, then rounded
  err = block_gemm::exact_gemm(x, channels, wq, ldq, qkv, 3 * width, rows, 3 * width, channels,
                               stream);
  if (err != cudaSuccess) return err;
  err = mma::dispatch(head_dim, [&](auto c) {
    return launch_attn_mma<decltype(c)::value>(qkv, lse, attn, batch, seq, heads, head_dim,
                                               scale, stream);
  });
  if (err != cudaSuccess) return err;
  // dattn[r, p] = sum_o dout[r, o] w_out[p, o]
  err = block_gemm::mma_gemm<false, false, bf16>(dout, out_channels, wo, ldo, dattn, width, 1,
                                                 rows, width, out_channels, stream);
  if (err != cudaSuccess) return err;
  const int64_t w = width;
  const mma::Strides sqkv{seq * 3 * w, head_dim, 3 * w};
  const mma::BwdArgs a{qkv, qkv + w, qkv + 2 * w, nullptr, attn, dattn, lse, dqkv, dqkv + w,
                       dqkv + 2 * w, delta, batch, seq, seq, heads, head_dim, scale, 0, sqkv,
                       sqkv, mma::Strides{seq * w, head_dim, w},
                       mma::Strides{static_cast<int64_t>(seq) * heads, 1, heads}};
  err = mma::run_bwd(a, stream);
  if (err != cudaSuccess) return err;
  // dx[r, c] = sum_j dqkv[r, j] w_qkv[c, j]
  err = block_gemm::mma_gemm<false, false, bf16>(dqkv, 3 * width, wq, ldq, dx, channels, 1, rows,
                                                 channels, 3 * width, stream);
  if (err != cudaSuccess) return err;
  // dw_qkv[c, j] = sum_r x[r, c] dqkv[r, j]
  err = block_gemm::mma_gemm_split<true, true>(x, channels, dqkv, 3 * width, dw_qkv, dq0, dq1,
                                               channels, 3 * width, rows, split_ws, splits_qkv,
                                               stream);
  if (err != cudaSuccess) return err;
  // dw_out[p, o] = sum_r attn[r, p] dout[r, o]; the workspace is free again
  return block_gemm::mma_gemm_split<true, true>(attn, width, dout, out_channels, dw_out, do0,
                                                do1, width, out_channels, rows, split_ws,
                                                splits_out, stream);
}

}  // namespace

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores) (x, dout, dx
// and the workspaces qkv and dqkv [B*T, 3*H*ch], attn and dattn [B*T,
// H*ch]); the weights and their gradients are f32 and addressed through
// strides, element (i, j) of w_qkv at w_qkv + i*wq0 + j*wq1 (dw_qkv: dq0,
// dq1; w_out: wo0, wo1; dw_out: do0, do1). delta is f32 [B*T, H] scratch;
// split_ws is f32 scratch of max(splits_qkv * C * 3*H*ch, splits_out * H*ch
// * C_out) entries (none needed where both splits are 1); w_ws is bf16
// scratch of C*pad8(3*H*ch) + H*ch*pad8(C_out) entries on 16 bytes, for
// bf16 only (may be null for f32). Returns a cudaError_t (0 on success).
extern "C" int attention_block_bwd(
    const void* x, const void* w_qkv, int64_t wq0, int64_t wq1, const void* w_out, int64_t wo0,
    int64_t wo1, const void* lse, const void* dout, void* dx, void* dw_qkv, int64_t dq0,
    int64_t dq1, void* dw_out, int64_t do0, int64_t do1, void* qkv, void* attn, void* dattn,
    void* dqkv, void* delta, void* split_ws, void* w_ws, int splits_qkv, int splits_out,
    int batch, int seq, int channels, int heads, int head_dim, int out_channels, float scale,
    int dtype, void* stream) {
  if (batch < 1 || seq < 1 || heads < 1 || channels < 1 || out_channels < 1 || head_dim < 1 ||
      head_dim > 128 || batch > 65535 || heads > 65535 ||
      static_cast<int64_t>(batch) * seq > INT32_MAX)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wq = static_cast<const float*>(w_qkv);
  const float* wo = static_cast<const float*>(w_out);
  const float* lse_f = static_cast<const float*>(lse);
  float* dwq = static_cast<float*>(dw_qkv);
  float* dwo = static_cast<float*>(dw_out);
  float* delta_f = static_cast<float*>(delta);
  float* split = static_cast<float*>(split_ws);
  if (dtype == 0) {
    using T = float;
    return block_bwd_f32(static_cast<const T*>(x), wq, wq0, wq1, wo, wo0, wo1, lse_f,
                         static_cast<const T*>(dout), static_cast<T*>(dx), dwq, dq0, dq1, dwo,
                         do0, do1, static_cast<T*>(qkv), static_cast<T*>(attn),
                         static_cast<T*>(dattn), static_cast<T*>(dqkv), delta_f, split,
                         splits_qkv, splits_out, batch, seq, channels, heads, head_dim,
                         out_channels, scale, s);
  }
  if (dtype != 1 || w_ws == nullptr || !mma::aligned16(w_ws)) return cudaErrorInvalidValue;
  using T = bf16;
  return block_bwd_bf16(static_cast<const T*>(x), wq, wq0, wq1, wo, wo0, wo1, lse_f,
                        static_cast<const T*>(dout), static_cast<T*>(dx), dwq, dq0, dq1, dwo,
                        do0, do1, static_cast<T*>(qkv), static_cast<T*>(attn),
                        static_cast<T*>(dattn), static_cast<T*>(dqkv), delta_f, split,
                        static_cast<T*>(w_ws), splits_qkv, splits_out, batch, seq, channels,
                        heads, head_dim, out_channels, scale, s);
}
