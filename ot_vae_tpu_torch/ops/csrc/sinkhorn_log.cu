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
//   until err < threshold (or NaN) or max_iter iterations; each instance on
//   its own
//   plan = exp(u^T + v + Cr)   [N, M]
//
//   a [B, N], b [B, M], C [B, N, M] -> plan [B, N, M], iters [B] (int32),
//   err [B] (the last iteration's err; inf when no iteration ran)
//
// Design: one instance per thread-block cluster of kCluster CTAs (grid
// B * kCluster, launched with cudaLaunchKernelEx and a cluster dimension),
// the whole fixed-point loop inside one launch. The wrapper computes the
// launch plan (ops/sinkhorn.py, _launch_plan) and make_plan below checks it.
//   - Rows. CTA r owns the band of rows [r R, (r + 1) R), R = ceil(N / k).
//     The prologue writes Cr = -C/reg for its band once (the division, so Cr
//     rounds as the TPU kernel's does): the first `resident` rows into the
//     CTA's shared memory, where they stay for the whole loop, the rest into
//     the plan buffer, from which both passes stream them out of L2 (only
//     where the band does not fit: 1024 x 1024 is 4 MB, more than a
//     cluster holds). Each CTA keeps u and log a of its band and a full
//     copy of v.
//   - Row pass (v). Each CTA folds its band, for every column, into
//     (max, sum) partials: thread t takes column t % M over every
//     `slices`-th row of the band (slices = kThreads / M, at most
//     kMaxSlices and R), so a warp reads a row of Cr conflict-free. Column j
//     is finalised by CTA j / Mc, Mc = ceil(M / k); each thread stores its
//     partial straight into that CTA's inbox through distributed shared
//     memory (map_shared_rank), laid out [rank, slice][column] so that a
//     warp's 32 stores to a peer coalesce.
//   - After the first cluster barrier CTA r finalises its column slice from
//     its own inbox: a group of 8, 16 or 32 lanes a column, a lane a
//     partial; the partials' maximum by shuffles, then the rescaled partial
//     sums added one by one in (rank, slice) order, by every lane alike.
//     It stores v into every CTA's copy of v.
//   - Column pass (u), after the second cluster barrier: local to each CTA,
//     kRowLanes lanes a row of the band (two rows a warp at once), from the
//     CTA's copy of v; each lane folds its entries, then a maximum, one
//     rescale a lane and a sum over the row's lanes.
//   - err. Each thread sums its |du| and |dv| in f64; the warps' sums, then
//     warp 0's, make the CTA's share, which warp 0 stores into every CTA
//     with the next row pass. After the first barrier every thread of the
//     cluster adds the k shares in rank order and rounds once to f32: every
//     CTA holds the same float and leaves the loop on the same iteration
//     (CTAs that disagreed would deadlock on a cluster barrier), and the
//     f64 sum makes the count independent of the order in all but the last
//     bit.
//   - Barriers: two cluster barriers and one block barrier an iteration; no
//     buffer is double-buffered. Every access to another CTA's shared
//     memory is a store, and each buffer's stores and reads are kept apart
//     by a barrier: the partials and the err shares are stored before the
//     first barrier and read between the first and the second; v is stored
//     between the two (each column by its one owner, which reads the old
//     value first) and read by the column pass after the second; the next
//     stores into the inbox and the err shares come after the second
//     barrier. err(t) is read after the first barrier of iteration t + 1,
//     whose row pass is then discarded when the loop stops: nothing of it
//     has reached a peer's v. So the first barrier of the last pass is the
//     cluster barrier before the CTAs exit: after it no CTA touches
//     another's memory. A CTA whose band is empty (N < k) folds nothing
//     (partials -inf, 0) and takes part in every barrier.
//   - Epilogue: each CTA writes the plan of its band, coalesced, from the
//     resident rows in shared memory and the streamed rows in place.
//   - Exponentials. The plan keeps expf on u + v + Cr, and Cr is not
//     scaled by log2 e: at reg 1e-5 |Cr| reaches 1e5, where an f32 ulp is
//     0.008, so a rounding of Cr * log2 e would move the plan entries by
//     about 0.3%, against a gate of 1e-3 of the largest entry at the path's
//     256 x 256. The folds take __expf (ex2.approx) of x - max <= 0: its
//     relative error stays below about 1e-6 on every term large enough to
//     move an f32 sum (x - max > -17). At reg 1e-5 the plan reads as with
//     expf (chip_smoke.py phase 11's gates hold unchanged, its entries at
//     256 x 256 equal), and the folds run 10-30% faster.
//
// What bounds it: each iteration takes 2 N M exponentials on the SFUs (16 a
// clock an SM). The whole card could do the path's 256 x 256 x 1000
// iterations in about 0.03 ms; one cluster of 8 SMs in about 0.5 ms. The
// kernel takes about 4.7 ms there (PERF.md): it is bound by the
// instructions each pass issues an entry on 16 warps and by the two cluster
// barriers an iteration (each also a GPU-scope memory fence).
// Bytes: C read once and the plan written once from device memory; the
// streamed rows, 2 * 4 * M bytes a row an iteration, from L2. What is left:
// point-to-point signalling (st.async with an mbarrier a buffer) in place
// of the cluster barriers; fewer instructions an entry; a batch smaller
// than the card leaves most SMs idle.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cmath>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

// CTAs an instance: 8, the portable cluster size (16 measured slower at the
// path's 256 x 256 and at 64 x 256 x 256, faster at 1024 x 1024; PERF.md)
constexpr int kCluster = 8;
constexpr int kThreads = 512;  // 1024 measured slower at 256 x 256
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSlices = 4;  // row-pass partials a column a CTA, at most
constexpr int kMinBlocks = 2;  // CTAs an SM holds at once (64 registers a thread)
constexpr int kChunk = 16;     // entries loaded before they are folded in
constexpr int kRowLanes = 16;  // lanes a row in the column pass
static_assert(kCluster >= 8, "the finalisation's lane groups hold 8 or more partials");
// row-pass partials a lane merges in the finalisation, at most
constexpr int kPartsPerLane = (kCluster * kMaxSlices + 31) / 32;
constexpr int kMaxShared = 232448;  // dynamic shared memory a Hopper block may have
constexpr float kStab = 1e-8f;
constexpr int kNoCluster = -1;  // returned when no cluster can be scheduled

struct Plan {
  int cluster;   // CTAs an instance
  int rows;      // rows a CTA's band holds (ceil(N / cluster))
  int resident;  // of them, rows kept in shared memory; the rest streamed
  int slices;    // row-pass partials a column a CTA
  int smem;      // dynamic shared memory bytes a CTA (-1: M too large)
};

__host__ __device__ constexpr int ceil_div(int a, int b) { return (a + b - 1) / b; }

// the shared memory a CTA lays out: f64 [kWarps] warp err sums and
// [kCluster] every CTA's share of err, then f32 v [M], log b [Mc], u [R],
// log a [R], the inbox of partial maxima and sums [kCluster * slices][Mc + 1]
// each, resident Cr [resident * M]
Plan make_plan(int n, int m) {
  Plan p;
  p.cluster = kCluster;
  p.rows = ceil_div(n, kCluster);
  p.slices = std::min(std::min(kMaxSlices, std::max(1, kThreads / m)), p.rows);
  const int64_t fixed =
      8 * static_cast<int64_t>(kWarps + kCluster) +
      4 * (static_cast<int64_t>(m) + ceil_div(m, kCluster) + 2LL * p.rows +
           2LL * (ceil_div(m, kCluster) + 1) * kCluster * p.slices);
  if (fixed > kMaxShared) {
    p.resident = 0;
    p.smem = -1;
    return p;
  }
  p.resident = static_cast<int>(
      std::min<int64_t>(p.rows, (kMaxShared - fixed) / (4 * static_cast<int64_t>(m))));
  p.smem = static_cast<int>(fixed + 4LL * p.resident * m);
  return p;
}

// the exponential of the LSE folds, of x - max <= 0 (ex2.approx; the note
// at the top says why the plan keeps expf)
__device__ __forceinline__ float fold_exp(float x) { return __expf(x); }

// fold kChunk entries into a running (max m, sum s of exp(. - m)): one
// rescale per chunk, one exponential per entry. An entry of -inf adds 0, a
// NaN entry makes s NaN; while m is -inf every entry so far was -inf or
// NaN, and the entries are taken against 0 instead
__device__ __forceinline__ void lse_push(const float (&x)[kChunk], float& m, float& s) {
  float cm = x[0];
#pragma unroll
  for (int q = 1; q < kChunk; ++q) cm = fmaxf(cm, x[q]);
  if (cm > m) {
    s *= fold_exp(m - cm);  // 0 from m = -inf, NaN kept
    m = cm;
  }
  const float base = m == -INFINITY ? 0.f : m;
#pragma unroll
  for (int q = 0; q < kChunk; ++q) s += fold_exp(x[q] - base);
}

// fold entries k = first, first + stride, ... < end of
// x_k = base[k * step] + add[k]: kChunk independent loads in flight; whole
// chunks unchecked, the tail padded with -inf. Offsets are 32-bit: a band
// holds fewer than 2^31 entries (the plan's limits on M and N)
__device__ __forceinline__ void lse_strided(const float* base, int step, const float* add,
                                            int first, int stride, int end, float& m,
                                            float& s) {
  const int estep = stride * step;  // between entries
  int k = first;
  for (; k + (kChunk - 1) * stride < end; k += kChunk * stride) {
    const float* p = base + k * step;
    float x[kChunk];
#pragma unroll
    for (int q = 0; q < kChunk; ++q) x[q] = p[q * estep] + add[k + q * stride];
    lse_push(x, m, s);
  }
  if (k < end) {
    float x[kChunk];
#pragma unroll
    for (int q = 0; q < kChunk; ++q) {
      const int kk = k + q * stride;
      x[q] = kk < end ? base[kk * step] + add[kk] : -INFINITY;
    }
    lse_push(x, m, s);
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
sinkhorn_cluster_kernel(const float* __restrict__ a, const float* __restrict__ b,
                        const float* __restrict__ cost, float* __restrict__ plan,
                        int* __restrict__ iters, float* __restrict__ err_out, int n, int m,
                        int rows, int resident, int slices, float reg, int max_iter,
                        float threshold) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int64_t inst = blockIdx.x / kCluster;
  const int mc = ceil_div(m, kCluster);
  const int parts = kCluster * slices;  // row-pass partials of a column

  extern __shared__ double smem[];
  double* red = smem;                    // [kWarps] warp sums of err
  double* err_in = red + kWarps;         // [kCluster] every CTA's share of err
  float* v = reinterpret_cast<float*>(err_in + kCluster);  // [m], every column
  float* log_b = v + m;                  // [mc], this CTA's column slice
  float* u = log_b + mc;                 // [rows], this CTA's band
  float* log_a = u + rows;               // [rows]
  // the inbox rows are mc + 1 apart, so that a group's reads of one
  // column's partials fall in distinct banks
  const int pitch = mc + 1;
  float* in_m = log_a + rows;            // [parts][pitch] partial maxima of the slice
  float* in_s = in_m + parts * pitch;    // [parts][pitch] partial sums of the slice
  float* cr = in_s + parts * pitch;      // [resident * m] resident rows of Cr

  const int r0 = rank * rows;                           // first row of the band
  const int nrows = max(0, min(rows, n - r0));          // rows in the band
  const int res = min(resident, nrows);                 // of them resident
  const int c0 = rank * mc;                             // first column of the slice
  const int ncols = max(0, min(mc, m - c0));            // columns in the slice
  const int64_t nm = static_cast<int64_t>(n) * m;
  // the band's rows in the plan buffer: streamed rows of Cr until the epilogue
  float* gcr = plan + inst * nm + static_cast<int64_t>(r0) * m;
  // the finalisation's lane groups: one column a group of `group` lanes,
  // lane gl holding partials gl, gl + group, ... of the (rank, slice) order
  int group = 1;
  while (group < parts && group < 32) group *= 2;
  const int gl = lane % group;
  const int per_warp = 32 / group;  // columns a warp finalises at once

  for (int i = tid; i < nrows; i += kThreads) {
    u[i] = 0.f;
    log_a[i] = logf(a[inst * n + r0 + i] + kStab);
  }
  for (int j = tid; j < m; j += kThreads) v[j] = 0.f;
  for (int j = tid; j < ncols; j += kThreads) log_b[j] = logf(b[inst * m + c0 + j] + kStab);
  {
    const float* c = cost + inst * nm + static_cast<int64_t>(r0) * m;
    const int band = nrows * m;
    const int kept = res * m;
    for (int k = tid; k < band; k += kThreads) {
      const float x = -c[k] / reg;
      if (k < kept) cr[k] = x;
      else gcr[k] = x;
    }
  }
  cluster.sync();  // every CTA started and initialised before any peer access

  int it = 0;  // iterations complete
  float err = INFINITY;
  while (max_iter > 0) {
    if (it > 0 && warp == 0) {  // this CTA's share of the last iteration's err, to every CTA
      double total = lane < kWarps ? red[lane] : 0.0;
#pragma unroll
      for (int o = 16; o > 0; o /= 2) total += __shfl_xor_sync(0xffffffffu, total, o);
      total = __shfl_sync(0xffffffffu, total, 0);  // one value for every peer
      if (lane < kCluster) cluster.map_shared_rank(err_in, lane)[rank] = total;
    }
    // row pass: (max, sum) of each column over this band, `slices` partials,
    // stored into the inbox of the CTA that finalises the column
    for (int w = tid; w < slices * m; w += kThreads) {
      const int s = w / m;
      const int j = w - s * m;
      float mx = -INFINITY, sm = 0.f;
      lse_strided(cr + j, m, u, s, slices, res, mx, sm);
      // the band's first streamed row of this slice
      const int first = res + ((s - res) % slices + slices) % slices;
      lse_strided(gcr + j, m, u, first, slices, nrows, mx, sm);
      const int owner = j / mc;
      const int at = (rank * slices + s) * pitch + j - owner * mc;  // a warp's stores coalesce
      cluster.map_shared_rank(in_m, owner)[at] = mx;
      cluster.map_shared_rank(in_s, owner)[at] = sm;
    }
    cluster.sync();  // the inboxes and the err shares complete

    if (it > 0) {  // every thread adds the same shares in rank order
      double total = 0.0;
#pragma unroll
      for (int p = 0; p < kCluster; ++p) total += err_in[p];
      err = static_cast<float>(total);
      // as the TPU kernel's while_loop: NaN stops too. Nothing of this pass
      // has reached a peer's v, and no CTA touches a peer after the barrier
      if (!(err >= threshold) || it == max_iter) break;
    }

    // finalise this CTA's column slice of v from its inbox: the partials'
    // maximum, then their rescaled sums added in (rank, slice) order by
    // every lane of the group; v to every CTA
    double local = 0.0;  // this thread's share of err
    for (int base = warp * per_warp; base < ncols; base += kWarps * per_warp) {
      const int jj = base + lane / group;
      const bool valid = jj < ncols;
      float pm[kPartsPerLane], ps[kPartsPerLane];
      float mx = -INFINITY;
#pragma unroll
      for (int q = 0; q < kPartsPerLane; ++q) {
        const int part = gl + q * group;
        pm[q] = -INFINITY;
        ps[q] = 0.f;
        if (valid && part < parts) {
          pm[q] = in_m[part * pitch + jj];
          ps[q] = in_s[part * pitch + jj];
          mx = fmaxf(mx, pm[q]);
        }
      }
      for (int o = group / 2; o > 0; o /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float top = mx == -INFINITY ? 0.f : mx;  // as in lse_push: NaN kept
      float sum = 0.f;
#pragma unroll
      for (int q = 0; q < kPartsPerLane; ++q) {
        const float term = ps[q] * fold_exp(pm[q] - top);
        for (int l0 = 0; l0 < group; l0 += 8) {  // group is 8, 16 or 32
#pragma unroll
          for (int l = l0; l < l0 + 8; ++l) sum += __shfl_sync(0xffffffffu, term, l, group);
        }
      }
      const int j = c0 + jj;
      const float vn = valid ? log_b[jj] - (mx + logf(sum)) : 0.f;
      const float old = valid ? v[j] : 0.f;
      __syncwarp();  // the old v[j] read before any lane replaces it
      if (valid) {
        if (gl == 0) local += fabsf(vn - old);
        for (int p = gl; p < kCluster; p += group) cluster.map_shared_rank(v, p)[j] = vn;
      }
    }
    cluster.sync();  // v complete in every CTA; the inboxes read

    // column pass: kRowLanes lanes a row of the band, a warp's rows at once
    for (int base = warp * (32 / kRowLanes); base < nrows; base += kWarps * (32 / kRowLanes)) {
      const int i = base + lane / kRowLanes;
      const int rl = lane % kRowLanes;
      const bool valid = i < nrows;
      float mx = -INFINITY, sm = 0.f;
      if (valid) lse_strided((i < res ? cr : gcr) + i * m, 1, v, rl, kRowLanes, m, mx, sm);
      float top = mx;
#pragma unroll
      for (int o = kRowLanes / 2; o > 0; o /= 2)
        top = fmaxf(top, __shfl_xor_sync(0xffffffffu, top, o));
      float sum = sm * fold_exp(mx - (top == -INFINITY ? 0.f : top));
#pragma unroll
      for (int o = kRowLanes / 2; o > 0; o /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (valid && rl == 0) {
        const float un = log_a[i] - (top + logf(sum));
        local += fabsf(un - u[i]);
        u[i] = un;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o /= 2) local += __shfl_xor_sync(0xffffffffu, local, o);
    if (lane == 0) red[warp] = local;
    __syncthreads();  // u and the warp sums complete
    ++it;
  }

  const int band = nrows * m;
  const int kept = res * m;
  for (int k = tid; k < band; k += kThreads) {
    const int i = k / m;
    const int j = k - i * m;
    gcr[k] = expf(u[i] + v[j] + (k < kept ? cr[k] : gcr[k]));
  }
  if (rank == 0 && tid == 0) {
    iters[inst] = it;
    err_out[inst] = err;
  }
}

// Sets the kernel's attributes for plan `p` and fills `config` (whose
// attrs point at `attr`) for `batch` instances on `stream`.
cudaError_t configure(const Plan& p, int batch, cudaStream_t stream, cudaLaunchConfig_t* config,
                      cudaLaunchAttribute* attr) {
  cudaError_t e = cudaFuncSetAttribute(sinkhorn_cluster_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (e != cudaSuccess) return e;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = p.cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *config = cudaLaunchConfig_t{};
  config->gridDim = dim3(static_cast<unsigned>(batch * p.cluster));
  config->blockDim = dim3(kThreads);
  config->dynamicSmemBytes = static_cast<size_t>(p.smem);
  config->stream = stream;
  config->attrs = attr;
  config->numAttrs = 1;
  return cudaSuccess;
}

}  // namespace

// How many clusters of an N x M instance's plan the current device can run
// at once, into *clusters (0: none can be scheduled). Returns a cudaError_t.
extern "C" int sinkhorn_log_active_clusters(int n, int m, int* clusters) {
  if (n < 1 || m < 1) return cudaErrorInvalidValue;
  const Plan p = make_plan(n, m);
  if (p.smem < 0) return cudaErrorInvalidValue;
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attr;
  cudaError_t e = configure(p, 1, nullptr, &config, &attr);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveClusters(clusters, sinkhorn_cluster_kernel, &config);
}

// All tensors f32 (iters int32), contiguous, on one device. The launch plan
// (cluster, rows, resident, slices, smem) is the wrapper's, checked against
// this file's. Returns a cudaError_t (0 on success; cudaErrorInvalidValue on
// a plan that is not this file's), or -1 when no cluster of the plan's size
// and shared memory can be scheduled on the device.
extern "C" int sinkhorn_log(const void* a, const void* b, const void* cost, void* plan,
                            void* iters, void* err, int batch, int n, int m, int cluster,
                            int rows, int resident, int slices, int smem, float reg,
                            int max_iter, float threshold, void* stream) {
  if (batch < 1 || n < 1 || m < 1 || max_iter < 0) return cudaErrorInvalidValue;
  const Plan p = make_plan(n, m);
  if (p.smem < 0 || cluster != p.cluster || rows != p.rows || resident != p.resident ||
      slices != p.slices || smem != p.smem ||
      static_cast<int64_t>(batch) * p.cluster > INT32_MAX)
    return cudaErrorInvalidValue;
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attr;
  cudaError_t e = configure(p, batch, static_cast<cudaStream_t>(stream), &config, &attr);
  if (e != cudaSuccess) return e;
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, sinkhorn_cluster_kernel, &config);
  if (e != cudaSuccess) return e;
  if (clusters < 1) return kNoCluster;
  e = cudaLaunchKernelEx(&config, sinkhorn_cluster_kernel, static_cast<const float*>(a),
                         static_cast<const float*>(b), static_cast<const float*>(cost),
                         static_cast<float*>(plan), static_cast<int*>(iters),
                         static_cast<float*>(err), n, m, rows, resident, slices, reg, max_iter,
                         threshold);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}
