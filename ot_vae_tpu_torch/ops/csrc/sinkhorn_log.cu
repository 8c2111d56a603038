// Log-domain entropic OT (Sinkhorn) for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` (ot_vae_tpu/ops/sinkhorn_pallas.py),
// reached through `sinkhorn_log_pallas` and the dispatcher
// `sinkhorn_log_auto`. Same function, in f32, for each instance of a batch:
//
//   Cr = -C / reg;  log a = log(a + 1e-8);  log b = log(b + 1e-8);  u = v = 0
//   repeat:  v <- log b - LSE over rows (Cr + u^T)
//            u <- log a - LSE over columns (Cr + v)
//            err = sum |du| + sum |dv|
//   until err < threshold or max_iter iterations; each instance on its own
//   plan = exp(u^T + v + Cr)   [N, M]
//
//   a [B, N], b [B, M], C [B, N, M] -> plan [B, N, M], iters [B] (int32),
//   err [B] (the last iteration's err; inf when no iteration ran)
//
// Design. The TPU kernel keeps Cr whole in VMEM; one 256 x 256 f32 instance
// is 256 KB, more than an SM's 227 KB of shared memory. So:
//   - one thread block of 1024 threads per instance, the whole fixed-point
//     loop inside one launch (no host round trip per iteration);
//   - a prologue writes Cr = -C/reg into the plan buffer (the division once,
//     rounded as the TPU kernel rounds it), the iterations stream Cr from
//     there (it stays resident in the 50 MB L2), and the epilogue overwrites
//     it in place with the plan;
//   - u, v, log a, log b live in shared memory;
//   - the row pass (v) maps threads to columns, so a warp's reads of a row
//     of Cr are coalesced; when M is below the block size the rows are
//     split over kThreads / M slices of threads whose (max, sum) pairs are
//     combined afterwards in slice order;
//   - the column pass (u) maps a warp to a row and combines the lanes'
//     (max, sum) pairs with shuffles;
//   - each LSE is one online (max, sum) pass over chunks of kChunk entries,
//     loaded together so that their L2 latencies overlap: one exponential
//     per entry and one rescale per chunk;
//   - err is a block-wide sum that every thread reads in the same order, so
//     every thread leaves the loop on the same iteration.
//
// What bounds it: each iteration takes 2*N*M exponentials. At 256 x 256 and
// 1000 iterations that is 1.31e8; at the H100's 16 per clock per SM (SFU) the
// whole card could do it in about 0.03 ms, but one block per instance runs
// on one SM (about 4 ms alone). Bytes: 2*N*M*4 per iteration from L2; from
// device memory C read once and the plan written once. Keeping Cr on chip
// across a thread-block cluster (distributed shared memory) and exp2 on the
// FMA pipes are later work.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 8;  // entries loaded before they are folded in
constexpr float kStab = 1e-8f;

// fold kChunk entries into a running (max m, sum s of exp(. - m)): one
// rescale per chunk, one exponential per entry
__device__ __forceinline__ void lse_push(const float (&x)[kChunk], float& m, float& s) {
  float cm = x[0];
#pragma unroll
  for (int q = 1; q < kChunk; ++q) cm = fmaxf(cm, x[q]);
  if (cm > m) {
    s = m == -INFINITY ? 0.f : s * expf(m - cm);
    m = cm;
  }
#pragma unroll
  for (int q = 0; q < kChunk; ++q)
    if (x[q] != -INFINITY) s += expf(x[q] - m);  // a NaN entry stays NaN
}

// the LSE state of entries k = first, first + stride, ... < end of
// x_k = base[k * step] + add[k]: kChunk independent loads in flight, the
// tail padded with -inf
__device__ __forceinline__ void lse_strided(const float* base, int64_t step,
                                            const float* add, int first, int stride,
                                            int end, float& m, float& s) {
  for (int k = first; k < end; k += kChunk * stride) {
    float x[kChunk];
#pragma unroll
    for (int q = 0; q < kChunk; ++q) {
      const int kk = k + q * stride;
      x[q] = kk < end ? base[kk * step] + add[kk] : -INFINITY;
    }
    lse_push(x, m, s);
  }
}

// merge (m2, s2) into (m, s)
__device__ __forceinline__ void lse_merge(float& m, float& s, float m2, float s2) {
  const float mx = fmaxf(m, m2);
  if (mx == -INFINITY) return;  // both empty
  s = (m == -INFINITY ? 0.f : s * expf(m - mx)) + (m2 == -INFINITY ? 0.f : s2 * expf(m2 - mx));
  m = mx;
}

__global__ void __launch_bounds__(kThreads)
sinkhorn_log_kernel(const float* __restrict__ a, const float* __restrict__ b,
                    const float* __restrict__ cost, float* __restrict__ plan,
                    int* __restrict__ iters, float* __restrict__ err_out, int n, int m,
                    float reg, int max_iter, float threshold) {
  extern __shared__ float smem[];
  float* u = smem;             // [n]
  float* log_a = u + n;        // [n]
  float* v = log_a + n;        // [m]
  float* log_b = v + m;        // [m]
  float* part_m = log_b + m;   // [kThreads] row-pass partial maxima
  float* part_s = part_m + kThreads;  // [kThreads] row-pass partial sums
  float* red = part_s + kThreads;     // [kWarps] err partial sums

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int64_t inst = blockIdx.x;
  const int64_t nm = static_cast<int64_t>(n) * m;
  const float* c = cost + inst * nm;
  float* cr = plan + inst * nm;  // holds Cr until the epilogue

  for (int i = tid; i < n; i += kThreads) {
    u[i] = 0.f;
    log_a[i] = logf(a[inst * n + i] + kStab);
  }
  for (int j = tid; j < m; j += kThreads) {
    v[j] = 0.f;
    log_b[j] = logf(b[inst * m + j] + kStab);
  }
  for (int64_t k = tid; k < nm; k += kThreads) cr[k] = -c[k] / reg;
  __syncthreads();

  // the row pass: thread t takes column t % m over rows i = t / m (mod slices)
  const int slices = m >= kThreads ? 1 : kThreads / m;
  int it = 0;
  float err = INFINITY;
  while (it < max_iter) {
    float local = 0.f;  // this thread's share of err
    if (slices == 1) {
      for (int j = tid; j < m; j += kThreads) {
        float mx = -INFINITY, sm = 0.f;
        lse_strided(cr + j, m, u, 0, 1, n, mx, sm);
        const float vn = log_b[j] - (mx + logf(sm));
        local += fabsf(vn - v[j]);
        v[j] = vn;
      }
    } else {
      const int j = tid % m;
      const int slice = tid / m;
      if (slice < slices) {
        float mx = -INFINITY, sm = 0.f;
        lse_strided(cr + j, m, u, slice, slices, n, mx, sm);
        part_m[slice * m + j] = mx;
        part_s[slice * m + j] = sm;
      }
      __syncthreads();
      if (tid < m) {
        float mx = part_m[tid], sm = part_s[tid];
        for (int s = 1; s < slices; ++s) lse_merge(mx, sm, part_m[s * m + tid], part_s[s * m + tid]);
        const float vn = log_b[tid] - (mx + logf(sm));
        local += fabsf(vn - v[tid]);
        v[tid] = vn;
      }
    }
    __syncthreads();  // v complete

    // the column pass: warp w takes rows w, w + kWarps, ...
    for (int i = warp; i < n; i += kWarps) {
      const float* row = cr + static_cast<int64_t>(i) * m;
      float mx = -INFINITY, sm = 0.f;
      lse_strided(row, 1, v, lane, 32, m, mx, sm);
#pragma unroll
      for (int o = 16; o > 0; o /= 2) {
        const float m2 = __shfl_xor_sync(0xffffffffu, mx, o);
        const float s2 = __shfl_xor_sync(0xffffffffu, sm, o);
        lse_merge(mx, sm, m2, s2);
      }
      if (lane == 0) {
        const float un = log_a[i] - (mx + logf(sm));
        local += fabsf(un - u[i]);
        u[i] = un;
      }
    }

    // err: warp sums, then every thread adds the kWarps partials in order
#pragma unroll
    for (int o = 16; o > 0; o /= 2) local += __shfl_xor_sync(0xffffffffu, local, o);
    if (lane == 0) red[warp] = local;
    __syncthreads();  // u and red complete
    err = 0.f;
    for (int w = 0; w < kWarps; ++w) err += red[w];
    ++it;
    if (!(err >= threshold)) break;  // as the TPU kernel's while_loop: NaN stops too
  }

  for (int64_t k = tid; k < nm; k += kThreads) {
    const int i = static_cast<int>(k / m);
    const int j = static_cast<int>(k % m);
    cr[k] = expf(u[i] + v[j] + cr[k]);
  }
  if (tid == 0) {
    iters[inst] = it;
    err_out[inst] = err;
  }
}

}  // namespace

// Shared memory the kernel needs for an N x M instance, in bytes.
extern "C" int sinkhorn_log_smem_bytes(int n, int m) {
  return static_cast<int>(sizeof(float)) * (2 * n + 2 * m + 2 * kThreads + kWarps);
}

// All tensors f32 (iters int32), contiguous, on one device. Returns a
// cudaError_t (0 on success).
extern "C" int sinkhorn_log(const void* a, const void* b, const void* cost, void* plan,
                            void* iters, void* err, int batch, int n, int m, float reg,
                            int max_iter, float threshold, void* stream) {
  if (batch < 1 || n < 1 || m < 1 || max_iter < 0) return cudaErrorInvalidValue;
  const int smem = sinkhorn_log_smem_bytes(n, m);
  cudaError_t e = cudaFuncSetAttribute(sinkhorn_log_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  sinkhorn_log_kernel<<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(cost), static_cast<float*>(plan), static_cast<int*>(iters),
      static_cast<float*>(err), n, m, reg, max_iter, threshold);
  return cudaGetLastError();
}
