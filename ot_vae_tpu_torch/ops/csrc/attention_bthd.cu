// Multi-head attention forward on separate q, k and v tensors, for Hopper (sm_90a).
//
// Replaces two TPU kernels of ot_vae_tpu/ops/attention_pallas.py with one
// source: the layout is read through strides, so the same kernels serve
//
//   `_fwd_kernel_bthd` (row 7, attention_pallas.py:676, entries
//   `fused_attention_bthd` and `fused_attention_bthd_dropout`):
//     q [B, Tq, H*d], k and v [B, Tk, H*d] (heads contiguous along the last
//     axis, the layout a multi-head Dense projection writes), an optional
//     in-kernel causal mask (Tq = Tk, query i sees keys <= i) and an optional
//     post-softmax multiplier mult [Tq, Tk] shared by every batch element and
//     head: out = (P o mult) V, lse that of P;
//     out [B, Tq, H*d] in q's dtype, lse [B, H, Tq] f32;
//   `_fwd_kernel` (row 3, attention_pallas.py:109, entry `fused_attention`):
//     q, k, v [B, H, T, d]; out [B, H, T, d], lse [B*H, T] f32 (the same
//     memory as [B, H, T]).
//
// What bounds it: at the FFHQ128 ViT encoder's layer (B=64, H=4, d=128,
// T=1024, bf16) the work is 4*Tq*Tk*d*B*H = 1.37e11 FLOP against 268 MB of
// input and output (q, k, v and out, 67 MB each), so the card's bound is the
// bf16 tensor-core rate: 0.139 ms at 989 TFLOP/s (the bytes take 0.080 ms).
// The TPU kernels hold a whole [Tq, Tk] instance per head in VMEM; an SM has
// at most 227 KB of shared memory, so both kernels here stream keys
// (flash-attention forward) and keep S and P out of device memory.
//
// The dtype picks the kernel, inside this library:
//   - bf16 runs on the tensor cores (attention_fwd_mma, the flash-attention-2
//     design on mma.sync.m16n8k16, bf16 operands, f32 accumulation; the
//     instructions are in mma_bf16.cuh);
//   - f32 runs on CUDA-core FMAs (attention_fwd_kernel,
//     unchanged). Tensor cores would take f32 operands as TF32 (10-bit
//     mantissa), which the f32 gates against the plain version and the f32
//     card-vs-CPU paths do not allow; the port's one f32 caller, the
//     conditional CIFAR10 ViT at T = 18-19, is launch- and host-bound, so
//     tensor cores would buy it nothing. This is a choice of arithmetic, not
//     a size threshold.
//
// bf16 design: attention_fwd_mma.cuh, whose kernel attention_packed.cu
// (row 1) runs too, on the packed layout.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "attention_fwd_mma.cuh"

namespace {

// ---- f32: CUDA-core FMAs ---------------------------------------------------

// f32 design (attention_fwd_kernel): each thread owns one query row
// (two threads share a row when d > 64, so q and the f32 accumulator stay in
// registers), K and V tiles of kKeyTile rows are copied into shared memory as
// f32 through the batch, head and token strides, and the online softmax runs
// in f32; keys past Tk (and, causal, past the row) are masked and a causal
// query tile stops at its last row's key. Every d from 1 to 128 is taken: a
// multiple of 8 runs the kernel built for that width with vector loads, any
// other d the next padded width (1, 2, 4, ..., 128) with scalar, masked loads.

constexpr int kThreads = 128;
constexpr int kKeyTile = 32;
constexpr int kChunk = 8;  // keys per online-softmax step

// threads sharing a query row: one up to d = 64, two above, so that q and
// the f32 accumulator stay in registers. (Four at d = 128 took fewer
// registers but ran slower on an H100: two more shuffles and the same
// exponentials on every thread of a row.)
template <int C>
__host__ __device__ constexpr int row_threads() {
  return C <= 64 ? 1 : 2;
}

// head dim of a thread's d-th value: the threads of a row take 4-element
// chunks in turn, so one vector load of theirs reads contiguous shared
// memory (no bank conflict) and contiguous device memory
template <int kRowThreads>
__device__ __forceinline__ int dim_of(int d, int part) {
  return ((d >> 2) * kRowThreads + part) * 4 + (d & 3);
}

__device__ __forceinline__ void load4(const float* p, float* dst) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  dst[0] = a.x;
  dst[1] = a.y;
  dst[2] = a.z;
  dst[3] = a.w;
}

__device__ __forceinline__ float to_float(float x) { return x; }

// x rounded to T and back: P is cast to v's dtype before P.V
__device__ __forceinline__ float round_to(float x, float) { return x; }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }

using mma::offset;
using mma::Strides;

// C is the width the kernel is built for; `ch` the head dim of the tensors,
// equal to C unless kTail (then ch <= C, and the dims past ch are masked).
// out has q's strides, v has k's; lse is [B, H, Tq].
template <typename T, int C, bool kTail>
__global__ void __launch_bounds__(kThreads)
attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ mult,
                     T* __restrict__ out, float* __restrict__ lse, int tq, int tk,
                     int heads, int ch, float scale, int causal, Strides sq,
                     Strides skv) {
  constexpr int kRowThreads = row_threads<C>();
  constexpr int kDims = C / kRowThreads;        // head dims each thread owns
  constexpr int kRows = kThreads / kRowThreads; // query rows per block
  constexpr int kChunks = C / 4;                // 4-element chunks in a row
  static_assert(C <= 128 && (kTail || C % 8 == 0),
                "an exact head dim must be a multiple of 8, at most 128");
  static_assert(kDims % 4 == 0 || kTail, "per-thread dims must be whole 4-element chunks");
  static_assert(kKeyTile % kChunk == 0, "key tile must be whole chunks");

  __shared__ __align__(16) float k_tile[kKeyTile][C];
  __shared__ __align__(16) float v_tile[kKeyTile][C];

  const int cw = kTail ? ch : C;  // the tensors' head dim
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int row0 = blockIdx.x * kRows;
  const int row = row0 + threadIdx.x / kRowThreads;
  const int part = threadIdx.x % kRowThreads;
  const bool valid = row < tq;
  const T* k_head = k + offset(skv, b, h, 0);
  const T* v_head = v + offset(skv, b, h, 0);
  const T* mult_row = mult == nullptr ? nullptr : mult + static_cast<int64_t>(min(row, tq - 1)) * tk;

  float qr[kDims];
  float o[kDims];
#pragma unroll
  for (int d = 0; d < kDims; ++d) {
    qr[d] = 0.f;
    o[d] = 0.f;
  }
  if (valid) {
    const T* q_row = q + offset(sq, b, h, row);
    if constexpr (kTail) {
#pragma unroll
      for (int d = 0; d < kDims; ++d) {
        const int at = dim_of<kRowThreads>(d, part);
        if (at < cw) qr[d] = to_float(q_row[at]);
      }
    } else {
#pragma unroll
      for (int d = 0; d < kDims; d += 4) load4(q_row + dim_of<kRowThreads>(d, part), qr + d);
    }
  }

  // causal: the tile's last row sees keys up to itself, none past it
  const int key_end = causal ? min(tk, row0 + kRows) : tk;
  float m = -INFINITY;
  float l = 0.f;
  for (int k0 = 0; k0 < key_end; k0 += kKeyTile) {
    __syncthreads();  // the previous tile is consumed
    if constexpr (kTail) {
      for (int i = threadIdx.x; i < kKeyTile * C; i += kThreads) {
        const int r = i / C;
        const int c = i % C;
        const bool in = k0 + r < tk && c < cw;
        const int64_t at = (k0 + r) * skv.t + c;
        k_tile[r][c] = in ? to_float(k_head[at]) : 0.f;
        v_tile[r][c] = in ? to_float(v_head[at]) : 0.f;
      }
    } else {
      for (int i = threadIdx.x; i < kKeyTile * kChunks; i += kThreads) {
        const int r = i / kChunks;
        const int c = (i % kChunks) * 4;
        float kv[4] = {0.f, 0.f, 0.f, 0.f};
        float vv[4] = {0.f, 0.f, 0.f, 0.f};
        if (k0 + r < tk) {
          const int64_t at = (k0 + r) * skv.t + c;
          load4(k_head + at, kv);
          load4(v_head + at, vv);
        }
        *reinterpret_cast<float4*>(&k_tile[r][c]) = make_float4(kv[0], kv[1], kv[2], kv[3]);
        *reinterpret_cast<float4*>(&v_tile[r][c]) = make_float4(vv[0], vv[1], vv[2], vv[3]);
      }
    }
    __syncthreads();

    // keys in chunks of kChunk: the chunk loop stays rolled, so the unrolled
    // body (and the build) stays small and s[] lives in registers
    const int n_keys = min(kKeyTile, key_end - k0);
#pragma unroll 1
    for (int j0 = 0; j0 < n_keys; j0 += kChunk) {
      float s[kChunk];
      float chunk_max = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const float* k_row = &k_tile[j0 + jj][0];
        float acc = 0.f;
        if constexpr (kDims % 4 == 0) {
#pragma unroll
          for (int d = 0; d < kDims; d += 4) {
            const float4 kk =
                *reinterpret_cast<const float4*>(k_row + dim_of<kRowThreads>(d, part));
            acc = fmaf(qr[d], kk.x, acc);
            acc = fmaf(qr[d + 1], kk.y, acc);
            acc = fmaf(qr[d + 2], kk.z, acc);
            acc = fmaf(qr[d + 3], kk.w, acc);
          }
        } else {
#pragma unroll
          for (int d = 0; d < kDims; ++d)
            acc = fmaf(qr[d], k_row[dim_of<kRowThreads>(d, part)], acc);
        }
#pragma unroll
        for (int lane = 1; lane < kRowThreads; lane *= 2)
          acc += __shfl_xor_sync(0xffffffffu, acc, lane);
        const int key = k0 + j0 + jj;
        const bool seen = j0 + jj < n_keys && (!causal || key <= row);
        s[jj] = seen ? acc * scale : -INFINITY;
        chunk_max = fmaxf(chunk_max, s[jj]);
      }

      // every row sees key 0 (the first chunk), so after it m is finite and
      // m_new too; exp(-inf) = 0 masks. Before it m = -inf and alpha = 0.
      const float m_new = fmaxf(m, chunk_max);
      const float alpha = m_new == -INFINITY ? 1.f : expf(m - m_new);
      l *= alpha;
#pragma unroll
      for (int d = 0; d < kDims; ++d) o[d] *= alpha;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const float p = s[jj] == -INFINITY ? 0.f : expf(s[jj] - m_new);
        l += p;
        float pv = p;
        if (mult_row != nullptr && j0 + jj < n_keys)
          pv *= to_float(mult_row[k0 + j0 + jj]);
        pv = round_to(pv, T());
        const float* v_row = &v_tile[j0 + jj][0];
        if constexpr (kDims % 4 == 0) {
#pragma unroll
          for (int d = 0; d < kDims; d += 4) {
            const float4 vv =
                *reinterpret_cast<const float4*>(v_row + dim_of<kRowThreads>(d, part));
            o[d] = fmaf(pv, vv.x, o[d]);
            o[d + 1] = fmaf(pv, vv.y, o[d + 1]);
            o[d + 2] = fmaf(pv, vv.z, o[d + 2]);
            o[d + 3] = fmaf(pv, vv.w, o[d + 3]);
          }
        } else {
#pragma unroll
          for (int d = 0; d < kDims; ++d)
            o[d] = fmaf(pv, v_row[dim_of<kRowThreads>(d, part)], o[d]);
        }
      }
      m = m_new;
    }
  }

  if (!valid) return;
  const float inv = 1.f / l;
  T* o_row = out + offset(sq, b, h, row);
#pragma unroll
  for (int d = 0; d < kDims; ++d) {
    const int at = dim_of<kRowThreads>(d, part);
    if (!kTail || at < cw) store(o_row + at, o[d] * inv);
  }
  if (part == 0) lse[(static_cast<int64_t>(b) * heads + h) * tq + row] = m + logf(l);
}

// the f32 kernel takes the bf16 kernel's arguments: out through q's strides
// and lse [B, H, Tq]
using Args = mma::FwdArgs;

template <typename T, int C, bool kTail>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr int kRows = kThreads / row_threads<C>();
  const dim3 grid((a.tq + kRows - 1) / kRows, a.heads, a.batch);
  attention_fwd_kernel<T, C, kTail><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.mult), static_cast<T*>(a.out), a.lse, a.tq, a.tk, a.heads,
      a.head_dim, a.scale, a.causal, a.sq, a.skv);
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

cudaError_t run(Args a, int dtype, void* stream) {
  if (a.batch < 1 || a.tq < 1 || a.tk < 1 || a.heads < 1 || a.batch > 65535 ||
      a.heads > 65535 || (a.causal && a.tq != a.tk) || a.head_dim < 1 || a.head_dim > 128)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_f32(a, s);
  if (dtype == 1) return mma::run_fwd<false>(a, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// Row 7. q [B, Tq, H*d], k and v [B, Tk, H*d], contiguous; mult [Tq, Tk] in
// q's dtype or null; out [B, Tq, H*d]; lse [B, H, Tq] f32.
// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores). Returns a
// cudaError_t (0 on success).
extern "C" int attention_bthd_fwd(const void* q, const void* k, const void* v,
                                  const void* mult, void* out, void* lse, int batch,
                                  int tq, int tk, int heads, int head_dim, float scale,
                                  int causal, int dtype, void* stream) {
  const int64_t width = static_cast<int64_t>(heads) * head_dim;
  Args a{q, k, v, mult, out, static_cast<float*>(lse), batch, tq, tk, heads, head_dim,
         scale, causal, Strides{tq * width, head_dim, width},
         Strides{tk * width, head_dim, width}};
  return run(a, dtype, stream);
}

// Row 3. q, k, v and out [B, H, T, d], contiguous; lse [B*H, T] f32.
extern "C" int attention_bhtc_fwd(const void* q, const void* k, const void* v,
                                  void* out, void* lse, int batch, int heads, int seq,
                                  int head_dim, float scale, int dtype, void* stream) {
  const Strides s{static_cast<int64_t>(heads) * seq * head_dim,
                  static_cast<int64_t>(seq) * head_dim, head_dim};
  Args a{q, k, v, nullptr, out, static_cast<float*>(lse), batch, seq, seq, heads,
         head_dim, scale, 0, s, s};
  return run(a, dtype, stream);
}
