// bf16 tensor-core building blocks of the attention kernels
// (attention_fwd_mma.cuh, attention_bwd_mma.cuh, which attention_bthd.cu,
// attention_bthd_bwd.cu, attention_packed.cu and attention_packed_bwd.cu
// include), for Hopper (sm_90a) through the Ampere-era warp-level
// instructions:
//   - cp.async 16-byte copies from device to shared memory (zero-filled past
//     a tile's valid rows and head dims), committed and waited on in groups;
//   - ldmatrix (plain and .trans) of 8x8 b16 matrices from shared memory;
//   - mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32: bf16 operands,
//     f32 accumulation.
// Operands are addressed through (batch, head, token) strides (`Strides`),
// and the tile copies take the token stride of the operand they copy and
// whether it moves in 16-byte chunks.
// A tile is kTileRows token rows of one head, C head dims (a multiple of 16,
// the tensors' own head dim zero-padded up to it), stored with a row stride
// of C + 8 elements: 16 bytes of padding make the stride an odd number of
// 16-byte units, so the 8 row addresses of one ldmatrix land in 8 distinct
// bank groups (no bank conflict) and every row stays 16-byte aligned.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16): with g = lane / 4 and
// t = lane % 4, an f32 accumulator c[4] holds rows g (c0, c1) and g + 8 (c2,
// c3) at columns 2t and 2t + 1; an A fragment a[4] holds rows g, g + 8, g,
// g + 8 at k = 2t..2t+1, 2t..2t+1, 2t+8..2t+9, 2t+8..2t+9; a B fragment b[2]
// holds column g at k = 2t..2t+1 and 2t+8..2t+9. Two accumulators of
// neighbouring 8-column blocks are thus, rounded and packed in pairs, the A
// fragment of a 16-deep product: P and dS go from one product to the next in
// registers.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace mma {

using bf16 = __nv_bfloat16;

constexpr int kTileRows = 64;  // token rows of every shared-memory tile
constexpr int kThreads = 128;  // 4 warps, 16 rows of a 64-row tile each
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// element (b, h, t, 0) of a tensor with these strides, in elements
struct Strides {
  int64_t b, h, t;
};

__host__ __device__ __forceinline__ int64_t offset(const Strides& s, int b, int h, int t) {
  return b * s.b + h * s.h + t * s.t;
}

template <int C>
struct Tile {
  static_assert(C % 16 == 0 && C >= 16 && C <= 128, "tile width must be 16, 32, ..., 128");
  static constexpr int kStride = C + 8;                   // elements between rows
  static constexpr int kElems = kTileRows * kStride;      // elements of one tile
  static constexpr int kBytes = kElems * int(sizeof(bf16));
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from src to dst, or zeros when !in (src is then not read)
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// wait until at most N committed groups of this thread are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a * b on the tensor cores
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 values rounded to bf16 (nearest even) in one register, lo first
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragment of the rows this warp owns, 16 rows from `rows` (a tile
// row), head dims k0..k0+15.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* rows, int stride, int k0,
                                       int lane) {
  ldsm_x4(a, rows + (lane & 15) * stride + k0 + (lane >> 4) * 8);
}

// B fragments of two neighbouring 8-column blocks, taken from 16 tile rows
// (`rows`, the columns n of the product) at head dims k0..k0+15: b[0], b[1]
// are the first block's, b[2], b[3] the second's. For S = Q K^T, the rows
// are keys.
__device__ __forceinline__ void load_b_rows(uint32_t (&b)[4], const bf16* rows, int stride,
                                            int k0, int lane) {
  ldsm_x4(b, rows + ((lane & 7) + (lane >> 4) * 8) * stride + k0 + ((lane >> 3) & 1) * 8);
}

// B fragments of two neighbouring 8-dim blocks (dims n0..n0+15) for a
// product whose depth runs over 16 tile rows from `rows`: the transposed
// read of P V, with V's rows (keys) as the depth.
__device__ __forceinline__ void load_b_trans(uint32_t (&b)[4], const bf16* rows, int stride,
                                             int n0, int lane) {
  ldsm_x4_trans(b, rows + ((lane & 7) + ((lane >> 3) & 1) * 8) * stride + n0 + (lane >> 4) * 8);
}

// Copy kTileRows token rows r0.. of one head (`base` at token 0, rows
// `t_stride` elements apart) into a tile; rows past `seq` and dims past `cw`
// are zero. vec: cw % 8 == 0 and every row 16-byte aligned, so cp.async
// moves 16-byte chunks (in flight until the caller's wait); otherwise masked
// scalar copies through registers.
template <int C>
__device__ __forceinline__ void load_tile(bf16* tile, const bf16* base, int64_t t_stride,
                                          int r0, int seq, int cw, bool vec) {
  constexpr int kChunks = C / 8;
  if (vec) {
#pragma unroll 4
    for (int i = threadIdx.x; i < kTileRows * kChunks; i += kThreads) {
      const int r = i / kChunks;
      const int c = (i % kChunks) * 8;
      const bool in = r0 + r < seq && c < cw;
      cp_async_16(tile + r * Tile<C>::kStride + c, in ? base + (r0 + r) * t_stride + c : base,
                  in);
    }
  } else {
    for (int i = threadIdx.x; i < kTileRows * C; i += kThreads) {
      const int r = i / C;
      const int c = i % C;
      const bool in = r0 + r < seq && c < cw;
      tile[r * Tile<C>::kStride + c] = in ? base[(r0 + r) * t_stride + c] : __float2bfloat16(0.f);
    }
  }
}

// Write the 16 rows r0.. of a tile that this warp owns (rows past `seq` and
// dims past `cw` are not written): 16-byte stores when vec, else scalar.
template <int C>
__device__ __forceinline__ void store_rows(bf16* base, int64_t t_stride, const bf16* tile,
                                           int r0, int seq, int cw, bool vec, int lane) {
  constexpr int kChunks = C / 8;
  if (vec) {
    for (int i = lane; i < 16 * kChunks; i += 32) {
      const int r = i / kChunks;
      const int c = (i % kChunks) * 8;
      if (r0 + r < seq && c < cw)
        *reinterpret_cast<uint4*>(base + (r0 + r) * t_stride + c) =
            *reinterpret_cast<const uint4*>(tile + r * Tile<C>::kStride + c);
    }
  } else {
    for (int i = lane; i < 16 * C; i += 32) {
      const int r = i / C;
      const int c = i % C;
      if (r0 + r < seq && c < cw) base[(r0 + r) * t_stride + c] = tile[r * Tile<C>::kStride + c];
    }
  }
}

// an accumulator tile (16 rows of this warp, N columns as N/8 blocks) rounded
// to bf16 into the warp's 16 rows of a tile
template <int N>
__device__ __forceinline__ void stage_rows(bf16* rows, int stride, const float (&acc)[N / 8][4],
                                           float scale_lo, float scale_hi, int lane) {
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    *reinterpret_cast<uint32_t*>(rows + g * stride + j * 8 + 2 * t) =
        pack_bf16(acc[j][0] * scale_lo, acc[j][1] * scale_lo);
    *reinterpret_cast<uint32_t*>(rows + (g + 8) * stride + j * 8 + 2 * t) =
        pack_bf16(acc[j][2] * scale_hi, acc[j][3] * scale_hi);
  }
}

// max and sum over the 4 lanes of a quad (the lanes that share a row)
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// true when the pointer is 16-byte aligned
__host__ __forceinline__ bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// let `kernel` take `bytes` of dynamic shared memory (above 48 KB only on
// request) and prefer the largest shared-memory carve-out, so that two
// blocks fit on an SM. The launchers call it once per instantiation, from a
// function-local static: the port drives one card per process.
template <typename Kernel>
__host__ cudaError_t allow_smem(Kernel* kernel, int bytes) {
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// launch(std::integral_constant<int, C>) for the tiles' head dims C: d
// rounded up to a multiple of 16 (16, 32, ..., 128)
template <typename Launch>
__host__ cudaError_t dispatch(int head_dim, Launch&& launch) {
  switch ((head_dim + 15) / 16) {
    case 1: return launch(std::integral_constant<int, 16>());
    case 2: return launch(std::integral_constant<int, 32>());
    case 3: return launch(std::integral_constant<int, 48>());
    case 4: return launch(std::integral_constant<int, 64>());
    case 5: return launch(std::integral_constant<int, 80>());
    case 6: return launch(std::integral_constant<int, 96>());
    case 7: return launch(std::integral_constant<int, 112>());
    case 8: return launch(std::integral_constant<int, 128>());
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace mma
