// LSTM recurrence over T steps, one or both directions in one launch, with
// W_hh held in the shared memory of a thread-block cluster.
//
// Replaces fnssl_tpu/kernels/lstm_pallas.py:_lstm_kernel (the TPU kernel
// launched by _lstm_pallas_fwd) for H a multiple of 32 up to 256; lstm_wide.cu
// serves larger H. Same contract, per direction d of ndir (1 or 2):
//   xg (ndir, T, B, 4H) float32 or bfloat16, the input gates x @ W_ih^T + b;
//   w_hh_t (ndir, H, 4H) in the dtype of xg;  h0, c0 (ndir, B, H) float32.
//   Per step: gates = xg_t + h @ w_hh_t (float32 accumulation), torch gate
//   order i, f, g, o; c = sig(f) c + sig(i) tanh(g); h = sig(o) tanh(c).
//   (h, c) stay float32 for all T. Direction d walks backwards (t = T-1 .. 0,
//   ys[t] written in place, no flip) when reverse ^ d is 1, so a two-direction
//   launch with reverse = 0 is a BiLSTM. ys (ndir, T, B, H) in the dtype of
//   xg; hT, cT (ndir, B, H) float32.
//
// What bounds it on an H100: the function moves few bytes and does few FLOPs
// (2 B H 4H a step), and its T steps are serial, so the time is T times the
// latency of one step. A block that re-read all of W_hh (256 KB at H = 128 in
// float32) from L2 on every step would have that re-read set the latency.
//
// Design: one cluster of N CTAs per (tile of BT batch rows, direction).
// CTA r of the cluster owns the U = H/N hidden units [r U, (r+1) U) and their
// four gate columns. It copies its slice of W_hh^T (H x 4U, in xg's dtype) into
// shared memory once and never reads W_hh again; it keeps c of its units in
// registers and h of the whole tile in shared memory, in two buffers
// (ping-pong) of BT x H float32. Each step, thread (ks, j) of KS x U threads:
//   1. waits until the buffer it reads holds the whole tile's h (below);
//   2. sums the four gate columns of unit j over k-slice ks (KL = H/KS
//      values, a compile-time length) for every row of the tile: a k-split,
//      the KS partial sums meeting in shared memory;
//   3. finishes rows ks RPT .. ks RPT + RPT - 1 of unit j (the cell update)
//      with this step's xg, which it loaded during the step before, so that
//      the load's latency overlaps a whole step;
//   4. stores that h into the other buffer of every CTA of the cluster
//      through distributed shared memory, with st.async, which counts the
//      bytes on the receiving CTA's mbarrier for that buffer; then writes h
//      to ys and loads the next step's xg.
// A CTA waits only on its own mbarrier, for the BT x H x 4 bytes of the next
// h, instead of a cluster barrier: a barrier's release has to wait for the
// remote stores to be acknowledged, and cost more than the product's FMAs on
// the card. Reuse is safe without a barrier because every hazard is ordered by
// the data: CTA X writes buffer b for step s+2 only after it has all of step
// s+1's h, which every CTA sends only after its threads finished step s, that
// is, after all their reads of buffer b and of the partial sums at step s. The
// last step sends nothing, so no store is in flight into a CTA that exits.
// The ragged edge of B is masked, never padded by the caller; a masked row is
// computed (on zeros) and sent, but not written out. All arithmetic is
// float32 FMAs outside the tensor cores, for both xg dtypes; a bfloat16 W_hh
// slice takes half the shared memory. sigmoid and tanh use the fast exp
// (__expf, __fdividef): about 1e-7 from the exact functions, far inside the
// 1e-4 to which the kernel is held, and hundreds of cycles shorter a step.
// The wrapper (lstm_cuda.cluster_plan) picks N, BT and KS; the entry point
// checks that they fit and that the cluster can be placed, and otherwise
// returns an error without launching.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <set>
#include <tuple>

namespace cg = cooperative_groups;

namespace {

// threads a CTA may have: 512, or 256 at 16 rows a tile, so that a thread
// keeps its 4 x 16 gate sums in registers without spilling
__host__ __device__ constexpr int max_threads(int tile) {
  return tile == 16 ? 256 : 512;
}
constexpr size_t kMaxSmem = 232448;  // shared memory one block may use (227 KB)
constexpr size_t kBarrierSmem = 16;  // of it, the two mbarriers (static)
constexpr int kMaxRows = 2;          // rows of the tile a thread finishes

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  const unsigned short bits =
      __ldg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(static_cast<unsigned int>(bits) << 16);
}

__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }

__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// The four gates (i, f, g, o) of one (k, unit) entry of the W_hh slice.
__device__ __forceinline__ float4 gates4(const float* ws, int idx) {
  return reinterpret_cast<const float4*>(ws)[idx];
}

__device__ __forceinline__ float4 gates4(const __nv_bfloat16* ws, int idx) {
  const uint2 v = reinterpret_cast<const uint2*>(ws)[idx];
  return make_float4(__uint_as_float(v.x << 16),
                     __uint_as_float(v.x & 0xffff0000u),
                     __uint_as_float(v.y << 16),
                     __uint_as_float(v.y & 0xffff0000u));
}

// Stages the four gates of one (k, unit) of W_hh^T (src, src + stride, ...)
// into shared memory as one 16-byte (8-byte for bfloat16) entry.
__device__ __forceinline__ void stage4(float* ws, int idx, const float* src,
                                       int stride) {
  reinterpret_cast<float4*>(ws)[idx] =
      make_float4(__ldg(src), __ldg(src + stride), __ldg(src + 2 * stride),
                  __ldg(src + 3 * stride));
}

__device__ __forceinline__ void stage4(__nv_bfloat16* ws, int idx,
                                       const __nv_bfloat16* src, int stride) {
  const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
  const unsigned int b0 = __ldg(s), b1 = __ldg(s + stride),
                     b2 = __ldg(s + 2 * stride), b3 = __ldg(s + 3 * stride);
  reinterpret_cast<uint2*>(ws)[idx] = make_uint2(b0 | b1 << 16, b2 | b3 << 16);
}

// mbarriers and distributed shared memory (PTX for sm_90)
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar))
               : "memory");
}

// The one arrival of the barrier's current phase, which then completes once
// `bytes` more have been stored into this CTA against it.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// The address of the same shared memory location in CTA `rank` of the cluster.
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}

// Stores v at addr (any CTA of the cluster) and counts its 4 bytes on the
// mbarrier at bar (in the same CTA as addr).
__device__ __forceinline__ void store_async(uint32_t addr, float v,
                                            uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];\n" ::"r"(addr),
      "r"(__float_as_uint(v)), "r"(bar)
      : "memory");
}

// This step's input gates for the rows r_begin + q of the tile (0 for the
// masked ones), for one unit.
template <typename T_in, int BT>
__device__ __forceinline__ void load_gates(float (&xv)[kMaxRows][4],
                                           const T_in* xg_t, int b0,
                                           int r_begin, int rows, int batch,
                                           int hidden) {
#pragma unroll
  for (int q = 0; q < kMaxRows; ++q) {
    const int r = r_begin + q;
    const bool valid = q < rows && r < BT && b0 + r < batch;
    const T_in* row = xg_t + static_cast<size_t>(b0 + r) * 4 * hidden;
#pragma unroll
    for (int g = 0; g < 4; ++g)
      xv[q][g] = valid ? load_f(row + g * hidden) : 0.0f;
  }
}

__device__ __forceinline__ float sigmoid_f(float x) {
  return __fdividef(1.0f, 1.0f + __expf(-x));
}

__device__ __forceinline__ float tanh_f(float x) {
  return 2.0f * sigmoid_f(2.0f * x) - 1.0f;
}

struct Args {
  const void* xg;
  const void* w_hh_t;
  const float* h0;
  const float* c0;
  void* ys;
  float* h_t;
  float* c_t;
  int t_steps, batch, hidden, ndir, reverse, ks, device;
};

// shared memory of one CTA: KS x 4 partial gates of BT x U, two h buffers of
// BT x H (float32), and the W_hh slice H x 4U in xg's dtype
size_t smem_bytes(int hidden, int units, int tile, int ks, size_t itemsize) {
  return static_cast<size_t>(ks) * 4 * tile * units * sizeof(float) +
         static_cast<size_t>(2) * tile * hidden * sizeof(float) +
         static_cast<size_t>(hidden) * 4 * units * itemsize;
}

// N: CTAs per cluster; BT: batch rows per tile; KL: the k-slice length H/KS.
template <typename T_in, int N, int BT, int KL>
__global__ void __launch_bounds__(BT == 16 ? 256 : 512)
lstm_cluster_kernel(const T_in* __restrict__ xg,
                    const T_in* __restrict__ w_hh_t,
                    const float* __restrict__ h0,
                    const float* __restrict__ c0, T_in* __restrict__ ys,
                    float* __restrict__ h_t, float* __restrict__ c_t,
                    int t_steps, int batch, int hidden, int reverse) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int dir = blockIdx.y;
  const int b0 = (blockIdx.x / N) * BT;
  const int units = hidden / N;
  const int four_h = 4 * hidden;
  const int ks_count = hidden / KL;
  const int rows = ks_count >= BT ? 1 : 2;  // RPT
  const int j = threadIdx.x % units;
  const int ks = threadIdx.x / units;
  const int k_begin = ks * KL;
  const int unit = rank * units + j;  // this thread's hidden unit
  const int r_begin = ks * rows;
  const bool backward = (reverse ^ dir) != 0;
  const size_t step_len = static_cast<size_t>(batch) * four_h;  // xg per t
  const uint32_t h_bytes = BT * hidden * sizeof(float);  // one buffer

  // this direction's arrays
  xg += static_cast<size_t>(dir) * t_steps * step_len;
  ys += static_cast<size_t>(dir) * t_steps * batch * hidden;
  w_hh_t += static_cast<size_t>(dir) * hidden * four_h;
  const size_t state_off = static_cast<size_t>(dir) * batch * hidden;
  h0 += state_off;
  c0 += state_off;
  h_t += state_off;
  c_t += state_off;

  extern __shared__ float4 smem4[];
  float* part = reinterpret_cast<float*>(smem4);  // [KS][4][BT][U]
  float* hbuf = part + ks_count * 4 * BT * units;  // [2][BT][H]
  T_in* ws = reinterpret_cast<T_in*>(hbuf + 2 * BT * hidden);  // [H][U][4]
  __shared__ alignas(8) uint64_t full[2];  // buffer b holds the next h

  // the W_hh slice: entry (k, u) holds the four gates of unit r U + u,
  // loaded coalesced along u
#pragma unroll 4
  for (int idx = threadIdx.x; idx < hidden * units; idx += blockDim.x) {
    const int k = idx / units;
    stage4(ws, idx,
           w_hh_t + static_cast<size_t>(k) * four_h + rank * units + idx -
               k * units,
           hidden);
  }
  // h0 of the whole tile into buffer 0
  for (int idx = threadIdx.x; idx < BT * hidden; idx += blockDim.x) {
    const int r = idx / hidden;
    const int b = b0 + r;
    hbuf[idx] =
        b < batch ? h0[static_cast<size_t>(b) * hidden + idx - r * hidden]
                  : 0.0f;
  }
  float c[kMaxRows], h_last[kMaxRows], xv[kMaxRows][4];
#pragma unroll
  for (int q = 0; q < kMaxRows; ++q) {
    const int r = r_begin + q;
    const bool valid = q < rows && r < BT && b0 + r < batch;
    const size_t bu = static_cast<size_t>(b0 + r) * hidden + unit;
    c[q] = valid ? c0[bu] : 0.0f;
    h_last[q] = valid ? h0[bu] : 0.0f;
  }
  if (t_steps > 0)
    load_gates<T_in, BT>(xv,
                         xg + (backward ? t_steps - 1 : 0) * step_len + unit,
                         b0, r_begin, rows, batch, hidden);
  // h of step s (1 <= s < T) arrives in buffer s & 1; arm the barriers for
  // steps 1 and 2, and make them visible to the cluster before anyone sends
  if (threadIdx.x == 0) {
    mbar_init(&full[0]);
    mbar_init(&full[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (t_steps > 1) mbar_expect(&full[1], h_bytes);
    if (t_steps > 2) mbar_expect(&full[0], h_bytes);
  }
  cluster.sync();  // slice, h0 and barriers in place; every CTA started

  const uint32_t hbuf_addr = smem_addr(hbuf);
  const uint32_t full_addr = smem_addr(full);
  for (int s = 0; s < t_steps; ++s) {
    const int t = backward ? t_steps - 1 - s : s;
    const int cur = s & 1;
    if (s > 0) {
      mbar_wait(&full[cur], ((s - 1) >> 1) & 1);
      if (threadIdx.x == 0 && s + 2 < t_steps)
        mbar_expect(&full[cur], h_bytes);  // for step s + 2
    }
    const float* h_cur = hbuf + cur * BT * hidden;

    float acc[4][BT];
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int r = 0; r < BT; ++r) acc[g][r] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KL; kk += 4) {
      const int k = k_begin + kk;
      float4 w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) w[e] = gates4(ws, (k + e) * units + j);
#pragma unroll
      for (int r = 0; r < BT; ++r) {
        const float4 h4 =
            *reinterpret_cast<const float4*>(h_cur + r * hidden + k);
        const float hv[4] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[0][r] = fmaf(hv[e], w[e].x, acc[0][r]);
          acc[1][r] = fmaf(hv[e], w[e].y, acc[1][r]);
          acc[2][r] = fmaf(hv[e], w[e].z, acc[2][r]);
          acc[3][r] = fmaf(hv[e], w[e].w, acc[3][r]);
        }
      }
    }
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int r = 0; r < BT; ++r)
        part[((ks * 4 + g) * BT + r) * units + j] = acc[g][r];
    __syncthreads();  // partial sums written

    const int gate_stride = BT * units;
    const bool send = s + 1 < t_steps;
#pragma unroll
    for (int q = 0; q < kMaxRows; ++q) {
      const int r = r_begin + q;
      if (q < rows && r < BT) {
        float gate[4] = {xv[q][0], xv[q][1], xv[q][2], xv[q][3]};
#pragma unroll 4
        for (int p = 0; p < ks_count; ++p) {
          const float* pp = part + (p * 4 * BT + r) * units + j;
#pragma unroll
          for (int g = 0; g < 4; ++g) gate[g] += pp[g * gate_stride];
        }
        const float ig = sigmoid_f(gate[0]);
        const float fg = sigmoid_f(gate[1]);
        const float gg = tanh_f(gate[2]);
        const float og = sigmoid_f(gate[3]);
        c[q] = fg * c[q] + ig * gg;
        const float h = og * tanh_f(c[q]);
        h_last[q] = h;
        if (send) {
          const uint32_t dst = hbuf_addr + ((cur ^ 1) * BT * hidden +
                                            r * hidden + unit) *
                                               sizeof(float);
          const uint32_t bar = full_addr + (cur ^ 1) * sizeof(uint64_t);
#pragma unroll
          for (int p = 0; p < N; ++p)
            store_async(map_rank(dst, p), h, map_rank(bar, p));
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kMaxRows; ++q) {
      const int r = r_begin + q;
      if (q < rows && r < BT && b0 + r < batch)
        store_f(ys + (static_cast<size_t>(t) * batch + b0 + r) * hidden + unit,
                h_last[q]);
    }
    if (send)
      load_gates<T_in, BT>(
          xv, xg + (backward ? t - 1 : t + 1) * step_len + unit, b0, r_begin,
          rows, batch, hidden);
  }

#pragma unroll
  for (int q = 0; q < kMaxRows; ++q) {
    const int r = r_begin + q;
    if (q < rows && r < BT && b0 + r < batch) {
      const size_t bu = static_cast<size_t>(b0 + r) * hidden + unit;
      h_t[bu] = h_last[q];
      c_t[bu] = c[q];
    }
  }
}

// The shared memory limit is raised once per kernel instance and device, and
// each (device, shared memory, threads) is checked once for a cluster that
// can be placed; a launch then costs no more host calls than a plain one.
template <typename T_in, int N, int BT, int KL>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const auto kernel = lstm_cluster_kernel<T_in, N, BT, KL>;
  const int units = a.hidden / N;
  const int threads = a.ks * units;
  const size_t smem = smem_bytes(a.hidden, units, BT, a.ks, sizeof(T_in));
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = N;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(((a.batch + BT - 1) / BT) * N, a.ndir, 1);
  config.blockDim = dim3(threads, 1, 1);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  config.attrs = attr;
  config.numAttrs = 1;
  {
    static std::mutex mu;
    static std::set<int> raised;
    static std::set<std::tuple<int, size_t, int>> placed;
    std::lock_guard<std::mutex> lock(mu);
    cudaError_t err;
    if (!raised.count(a.device)) {
      cudaFuncAttributes fa;
      err = cudaFuncGetAttributes(&fa, kernel);
      if (err != cudaSuccess) return err;
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(kMaxSmem - fa.sharedSizeBytes));
      if (err != cudaSuccess) return err;
      raised.insert(a.device);
    }
    const auto key = std::make_tuple(a.device, smem, threads);
    if (!placed.count(key)) {
      int clusters = 0;
      err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &config);
      if (err != cudaSuccess) return err;
      if (clusters < 1) return cudaErrorLaunchOutOfResources;
      placed.insert(key);
    }
  }
  cudaError_t err = cudaLaunchKernelEx(
      &config, kernel, static_cast<const T_in*>(a.xg),
      static_cast<const T_in*>(a.w_hh_t), a.h0, a.c0, static_cast<T_in*>(a.ys),
      a.h_t, a.c_t, a.t_steps, a.batch, a.hidden, a.reverse);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T_in, int N, int BT>
cudaError_t by_slice(const Args& a, cudaStream_t s) {
  return a.hidden / a.ks == 8 ? launch<T_in, N, BT, 8>(a, s)
                              : launch<T_in, N, BT, 16>(a, s);
}

template <typename T_in, int N>
cudaError_t by_tile(const Args& a, int tile, cudaStream_t s) {
  return tile == 8 ? by_slice<T_in, N, 8>(a, s) : by_slice<T_in, N, 16>(a, s);
}

template <typename T_in>
cudaError_t by_cluster(const Args& a, int cluster, int tile,
                       cudaStream_t s) {
  switch (cluster) {
    case 1: return by_tile<T_in, 1>(a, tile, s);
    case 2: return by_tile<T_in, 2>(a, tile, s);
    case 4: return by_tile<T_in, 4>(a, tile, s);
    default: return by_tile<T_in, 8>(a, tile, s);
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). Runs ndir directions (1 or 2) of
// one recurrence in one launch with clusters of `cluster` CTAs (1, 2, 4 or
// 8), tiles of `tile` batch rows (8 or 16) and a k-split of `ks` (H/ks = 8 or
// 16), on `stream` of device `device`; does not synchronise, allocates
// nothing, and returns the cudaError_t of the launch (0 on success). A plan
// that does not fit (too many threads or too much shared memory) or whose
// cluster cannot be placed on the card is refused with an error, never run
// another way.
extern "C" int lstm_cluster(const void* xg, const void* w_hh_t,
                            const void* h0, const void* c0, void* ys,
                            void* h_t, void* c_t, int t_steps, int batch,
                            int hidden, int ndir, int reverse, int is_bf16,
                            int cluster, int tile, int ks, int device,
                            void* stream) {
  const bool cluster_ok =
      cluster == 1 || cluster == 2 || cluster == 4 || cluster == 8;
  if (hidden < 32 || hidden % 32 != 0 || hidden > 256 || batch < 1 ||
      t_steps < 0 || (ndir != 1 && ndir != 2) || !cluster_ok ||
      (tile != 8 && tile != 16) || ks < 1 ||
      (hidden != 8 * ks && hidden != 16 * ks) || kMaxRows * ks < tile)
    return static_cast<int>(cudaErrorInvalidValue);
  const int units = hidden / cluster;
  const size_t itemsize = is_bf16 ? 2 : 4;
  if (ks * units > max_threads(tile) ||
      smem_bytes(hidden, units, tile, ks, itemsize) > kMaxSmem - kBarrierSmem)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a{xg,
               w_hh_t,
               static_cast<const float*>(h0),
               static_cast<const float*>(c0),
               ys,
               static_cast<float*>(h_t),
               static_cast<float*>(c_t),
               t_steps,
               batch,
               hidden,
               ndir,
               reverse,
               ks,
               device};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = is_bf16 ? by_cluster<__nv_bfloat16>(a, cluster, tile, s)
                : by_cluster<float>(a, cluster, tile, s);
  return static_cast<int>(err);
}

extern "C" const char* lstm_cluster_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
