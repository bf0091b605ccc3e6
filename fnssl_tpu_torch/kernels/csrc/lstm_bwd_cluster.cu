// The backward recurrence of an LSTM layer (K2), one or both directions in
// one launch, with W_hh held in the shared memory of a thread-block cluster.
//
// Replaces the sequential part of fnssl_tpu/kernels/lstm_pallas.py:
// _lstm_backward (:269-343), the custom_vjp backward of the TPU kernel
// _lstm_kernel (a lax.scan in JAX): its replay of c and its reverse walk,
// without the weight sums, which stay matrix products outside
// (models/lstm.py). The contract of lstm_bwd.cu and of
// lstm_cuda.lstm_bwd_plain, per direction d of ndir (1 or 2):
//   g (ndir, T, B, 4H) float32: the gate pre-activations
//        x_t @ W_ih^T + b + h_{t-1} @ W_hh^T, computed outside; on return
//        it holds dgates (in place);
//   w_hh (ndir, 4H, H) in the dtype of ys (float32 or bfloat16), products
//        in float32;  c0, dhT, dcT (ndir, B, H) float32;  dys (ndir, T, B,
//        H) in the dtype of ys;  cs (ndir, T, B, H) float32 scratch;  out
//        dh0, dc0 (ndir, B, H) float32.
//   Replay: c_t = sig(f) c_{t-1} + sig(i) tanh(g), stored in cs.
//   Reverse walk, from the last walk step to the first:
//     dh_tot = dy_t + dh;  dct = dc + dh_tot o (1 - tanh^2 c_t);
//     dgates_t = [dct g i (1-i), dct c_{t-1} f (1-f), dct i (1-g^2),
//                 dh_tot tanh(c_t) o (1-o)]  (torch order i, f, g, o);
//     dh = dgates_t @ W_hh;  dc = dct f.
//   Direction d's forward walked t = T-1 .. 0 when reverse ^ d is 1 (so a
//   two-direction launch with reverse = 0 is a BiLSTM's backward); its
//   c_{t-1} is cs[t+1], and c0 at t = T-1.
//
// What bounds it on an H100: operations. The serial product dgates_t @
// W_hh is 2 B 4H H FLOPs a step: at FN-SSL's training shapes (nb = 16)
// 9.551 ms for (T, B, H) = (298, 4096, 256) and 4.776 ms for both
// directions of (256, 4768, 128) at 67 TFLOP/s of float32 FMAs; the bytes
// (g read, dgates written, dys read) take 3.4 ms at 3.35 TB/s. lstm_bwd.cu
// has one SM do the whole (BT x 4H) x (4H x H) product of its tile at
// every step and re-read all of W_hh (1 MB at H = 256 in float32) from L2
// for it, so the step's latency and W_hh's traffic set its time.
//
// Design: K1's cluster kernel (lstm_cluster.cu), mirrored. One cluster of N
// CTAs per (tile of BT batch rows, direction). CTA r owns the U = H/N
// hidden units [r U, (r+1) U). Once, it copies the 4H x U column slice of
// W_hh for its units into shared memory and never reads W_hh again: entry
// (u, j) holds rows e H + u (e = i, f, g, o) of column r U + j, one 16-byte
// entry (8 bytes in bfloat16), staged coalesced along j. Each thread
// finishes up to two (row, unit) pairs of the tile's BT x U (the cell
// part); it replays c for them into cs first, kRing steps of G loaded at a
// time, so that a load's latency is paid once per kRing steps, not once a
// step. Each walk step:
//   1. the cell part: each pair's dgates and dc from dh of its own CTA's
//      product of the step before, and c_t, c_{t-1}, G_t and dy_t, which
//      the thread loaded during the step before, so that the loads' latency
//      overlaps a whole step; dgates are written over G, dc stays in
//      registers;
//   2. the four dgates of the pair go as one 16-byte st.async into slot
//      [row][unit] of the step's dgates buffer in every CTA of the cluster,
//      counted on that buffer's mbarrier in the receiving CTA; then the
//      thread loads the next step's operands;
//   3. every thread waits on its own CTA's mbarrier for the whole tile's
//      dgates (BT x 4H x 4 bytes); two buffers, ping-pong;
//   4. the product: thread (ks, jj) of KS x U/UPT sums dh[row, r U + jj +
//      m U/UPT] for m < UPT and every row of the tile over k-slice ks of
//      the H units (KL = H/KS units of four gates, a compile-time length);
//      the KS partial sums meet in shared memory, where each pair's owner
//      adds them up.
// A dgates buffer keeps the four gates of a unit together (the product's
// 4H columns permuted, in the W_hh slice alike), so a thread sends one
// store a pair and peer and reads dgates as float4 broadcasts. dh for the
// CTA's units is summed whole in the CTA: only dgates cross CTAs, one way.
// Per CTA the product is 1/N of the tile's. Its pace is set by the dgates
// loads from shared memory (each feeds 4 UPT FMAs), so a thread sums UPT =
// 2 units where it can; and since a CTA at FN-SSL's widths fills most of
// an SM's shared memory, the tiles run in waves, and a smaller cluster
// runs more tiles at once.
// A CTA waits only on its own mbarrier, never on a cluster barrier. Reuse is
// safe without one because every hazard is ordered by the data: CTA X
// writes buffer b for walk step k+2 only after it has all of step k+1's
// dgates, which every CTA sends only after its threads passed the block
// barrier of step k, that is, after all their reads of buffer b at step k;
// and a thread writes step k+1's partial sums only after its CTA's owners
// sent step k+1, which they computed from their reads of step k's partial
// sums. Every step sends, the last one too (its product is dh0), and every
// store into a CTA is counted on one of its mbarriers, whose every phase it
// waits for; so a CTA exits only after all of the last step's bytes have
// arrived, and no remote store can be in flight into a CTA that has exited.
// G is read through the non-coherent path (__ldg) although the kernel writes
// dgates over it. That is safe because each entry of G belongs to one (row,
// unit) pair, so to one thread of one CTA, which reads it (in the replay and
// a step ahead in the walk) only before it overwrites it, and never after;
// whatever a cache line holds for an entry not yet written is still G.
// The ragged edge of B is masked, never padded by the caller; a masked row
// is computed (on zeros) and sent, but not written out. All arithmetic is
// float32 FMAs outside the tensor cores, for both dtypes; a bfloat16 W_hh
// slice takes half the shared memory. sigmoid and tanh use the fast exp
// (__expf, __fdividef), about 1e-7 from the exact functions. BT is 8; the
// wrapper (lstm_cuda.bwd_cluster_plan) picks N, KS and UPT, and the entry
// point checks that they fit and that the cluster can be placed, and
// otherwise returns an error without launching.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <set>
#include <tuple>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 512;     // KS x U threads a CTA may have
constexpr size_t kMaxSmem = 232448;  // shared memory one block may use (227 KB)
constexpr size_t kBarrierSmem = 16;  // of it, the two mbarriers (static)
constexpr int kMaxPairs = 2;         // (row, unit) pairs a thread finishes
constexpr int kTile = 8;             // batch rows of a tile (BT)
constexpr int kRing = 8;             // replay steps loaded at a time

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  const unsigned short bits =
      __ldg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(static_cast<unsigned int>(bits) << 16);
}

// The four gate rows (i, f, g, o) of one (unit, column) entry of the slice.
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

// Stages src, src + stride, src + 2 stride, src + 3 stride into shared
// memory as one 16-byte (8-byte for bfloat16) entry.
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

// Stores v at addr (16-byte aligned, any CTA of the cluster) and counts its
// 16 bytes on the mbarrier at bar (in the same CTA as addr).
__device__ __forceinline__ void store_async4(uint32_t addr, float4 v,
                                             uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(addr),
      "r"(__float_as_uint(v.x)), "r"(__float_as_uint(v.y)),
      "r"(__float_as_uint(v.z)), "r"(__float_as_uint(v.w)), "r"(bar)
      : "memory");
}

__device__ __forceinline__ float sigmoid_f(float x) {
  return __fdividef(1.0f, 1.0f + __expf(-x));
}

__device__ __forceinline__ float tanh_f(float x) {
  return 2.0f * sigmoid_f(2.0f * x) - 1.0f;
}

struct Args {
  float* g;
  float* cs;
  const void* w_hh;
  const float* c0;
  const void* dys;
  const float* dh_t;
  const float* dc_t;
  float* dh0;
  float* dc0;
  int t_steps, batch, hidden, ndir, reverse, cluster, ks, upt, device;
};

// shared memory of one CTA: KS partial dh of BT x U, two dgates buffers of
// BT x 4H (float32), and the W_hh slice 4H x U in ys's dtype
size_t smem_bytes(int hidden, int units, int tile, int ks, size_t itemsize) {
  return static_cast<size_t>(ks) * tile * units * sizeof(float) +
         static_cast<size_t>(2) * tile * 4 * hidden * sizeof(float) +
         static_cast<size_t>(4) * hidden * units * itemsize;
}

// BT: batch rows per tile; KL: the k-slice length H/KS; UPT: units a thread
// sums in the product; RPT: (row, unit) pairs a thread finishes in the cell
// part, ceil(BT UPT / KS). The cluster has n CTAs.
template <typename T_in, int BT, int KL, int UPT, int RPT>
__global__ void __launch_bounds__(kMaxThreads)
lstm_bwd_cluster_kernel(float* __restrict__ g, float* __restrict__ cs,
                        const T_in* __restrict__ w_hh,
                        const float* __restrict__ c0,
                        const T_in* __restrict__ dys,
                        const float* __restrict__ dh_t,
                        const float* __restrict__ dc_t,
                        float* __restrict__ dh0, float* __restrict__ dc0,
                        int t_steps, int batch, int hidden, int reverse,
                        int n) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int dir = blockIdx.y;
  const int b0 = (blockIdx.x / n) * BT;
  const int units = hidden / n;
  const int four_h = 4 * hidden;
  const int ks_count = hidden / KL;
  const int lanes = units / UPT;  // threads along the units in the product
  const int jj = threadIdx.x % lanes;  // sums units jj + m lanes, m < UPT
  const int ks = threadIdx.x / lanes;
  const int u_begin = ks * KL;
  const bool backward = (reverse ^ dir) != 0;  // the forward's walk
  const size_t gate_step = static_cast<size_t>(batch) * four_h;  // g per t
  const size_t unit_step = static_cast<size_t>(batch) * hidden;  // cs per t
  const uint32_t dg_bytes = BT * four_h * sizeof(float);  // one buffer

  // this direction's arrays
  g += static_cast<size_t>(dir) * t_steps * gate_step;
  cs += static_cast<size_t>(dir) * t_steps * unit_step;
  dys += static_cast<size_t>(dir) * t_steps * unit_step;
  w_hh += static_cast<size_t>(dir) * four_h * hidden;
  const size_t state_off = static_cast<size_t>(dir) * unit_step;
  c0 += state_off;
  dh_t += state_off;
  dc_t += state_off;
  dh0 += state_off;
  dc0 += state_off;

  extern __shared__ float4 smem4[];
  float* part = reinterpret_cast<float*>(smem4);   // [KS][BT][U]
  float* dgbuf = part + ks_count * BT * units;      // [2][BT][H][4]
  T_in* ws = reinterpret_cast<T_in*>(dgbuf + 2 * BT * four_h);  // [H][U][4]
  __shared__ alignas(8) uint64_t full[2];  // buffer b holds a step's dgates

  // the W_hh slice: entry (u, j) holds rows e H + u of column r U + j,
  // loaded coalesced along j
#pragma unroll 4
  for (int idx = threadIdx.x; idx < hidden * units; idx += blockDim.x) {
    const int u = idx / units;
    stage4(ws, idx,
           w_hh + static_cast<size_t>(u) * hidden + rank * units + idx -
               u * units,
           hidden * hidden);
  }
  if (threadIdx.x == 0) {
    mbar_init(&full[0]);
    mbar_init(&full[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // walk step k's dgates arrive in buffer k & 1; arm steps 0 and 1
    if (t_steps > 0) mbar_expect(&full[0], dg_bytes);
    if (t_steps > 1) mbar_expect(&full[1], dg_bytes);
  }

  // the (row, unit) pairs this thread finishes: pair threadIdx.x + q
  // blockDim.x of the tile's BT x U; the replay, in the forward's walk
  // order, for them
  bool owned[RPT], valid[RPT];
  int row[RPT], col[RPT];  // the pair's row of the tile and unit of the CTA
  size_t bu[RPT];  // offset of (row, unit) in a (B, H) array
  size_t bg[RPT];  // and of (row, gate i of unit) in a (B, 4H) array
  float c[RPT];
#pragma unroll
  for (int q = 0; q < RPT; ++q) {
    const int p = threadIdx.x + q * blockDim.x;
    owned[q] = p < BT * units;
    row[q] = p / units;
    col[q] = p - row[q] * units;
    valid[q] = owned[q] && b0 + row[q] < batch;
    const int unit = rank * units + col[q];
    bu[q] = static_cast<size_t>(b0 + row[q]) * hidden + unit;
    bg[q] = static_cast<size_t>(b0 + row[q]) * four_h + unit;
    c[q] = valid[q] ? c0[bu[q]] : 0.0f;
  }
  for (int s0 = 0; s0 < t_steps; s0 += kRing) {
    float gv[kRing][RPT][3];
#pragma unroll
    for (int i = 0; i < kRing; ++i) {
      const int s = s0 + i;
      const int t = backward ? t_steps - 1 - s : s;
#pragma unroll
      for (int q = 0; q < RPT; ++q) {
        gv[i][q][0] = gv[i][q][1] = gv[i][q][2] = 0.0f;
        if (s < t_steps && valid[q]) {
          const float* gr = g + t * gate_step + bg[q];
          gv[i][q][0] = __ldg(gr);
          gv[i][q][1] = __ldg(gr + hidden);
          gv[i][q][2] = __ldg(gr + 2 * hidden);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kRing; ++i) {
      const int s = s0 + i;
      const int t = backward ? t_steps - 1 - s : s;
#pragma unroll
      for (int q = 0; q < RPT; ++q) {
        if (s < t_steps && valid[q]) {
          c[q] = sigmoid_f(gv[i][q][1]) * c[q] +
                 sigmoid_f(gv[i][q][0]) * tanh_f(gv[i][q][2]);
          cs[t * unit_step + bu[q]] = c[q];
        }
      }
    }
  }

  // the walk's carries and the first walk step's operands: c_t (the
  // replay's last c), c_{t-1}, G_t and dy_t
  float dh[RPT], dc[RPT], ct[RPT], cp[RPT], gt[RPT][4], dy[RPT];
  auto load_step = [&](int s) {  // walk step s's c_{t-1}, G_t and dy_t
    const int t = backward ? t_steps - 1 - s : s;
    const int t_prev = backward ? t + 1 : t - 1;
#pragma unroll
    for (int q = 0; q < RPT; ++q) {
      cp[q] = dy[q] = 0.0f;
#pragma unroll
      for (int e = 0; e < 4; ++e) gt[q][e] = 0.0f;
      if (valid[q]) {
        const float* gr = g + t * gate_step + bg[q];
#pragma unroll
        for (int e = 0; e < 4; ++e) gt[q][e] = __ldg(gr + e * hidden);
        dy[q] = load_f(dys + t * unit_step + bu[q]);
        cp[q] = s > 0 ? cs[t_prev * unit_step + bu[q]] : c0[bu[q]];
      }
    }
  };
#pragma unroll
  for (int q = 0; q < RPT; ++q) {
    dh[q] = valid[q] ? dh_t[bu[q]] : 0.0f;
    dc[q] = valid[q] ? dc_t[bu[q]] : 0.0f;
    ct[q] = c[q];
  }
  if (t_steps > 0) load_step(t_steps - 1);
  cluster.sync();  // slice in place, barriers armed; every CTA started

  const uint32_t dg_addr = smem_addr(dgbuf);
  const uint32_t full_addr = smem_addr(full);
  for (int k = 0; k < t_steps; ++k) {
    const int s = t_steps - 1 - k;  // the walk step being undone
    const int t = backward ? t_steps - 1 - s : s;
    const int cur = k & 1;

    // 1-2. the cell part of this thread's pairs, sent to every CTA
#pragma unroll
    for (int q = 0; q < RPT; ++q) {
      if (owned[q]) {
        const float ig = sigmoid_f(gt[q][0]);
        const float fg = sigmoid_f(gt[q][1]);
        const float gg = tanh_f(gt[q][2]);
        const float og = sigmoid_f(gt[q][3]);
        const float tc = tanh_f(ct[q]);
        const float dht = dy[q] + dh[q];
        const float dct = dc[q] + dht * og * (1.0f - tc * tc);
        const float4 d = make_float4(dct * gg * ig * (1.0f - ig),
                                     dct * cp[q] * fg * (1.0f - fg),
                                     dct * ig * (1.0f - gg * gg),
                                     dht * tc * og * (1.0f - og));
        dc[q] = dct * fg;
        ct[q] = cp[q];
        const uint32_t dst =
            dg_addr + ((cur * BT + row[q]) * four_h +
                       (rank * units + col[q]) * 4) *
                          sizeof(float);
        const uint32_t bar = full_addr + cur * sizeof(uint64_t);
        for (int p = 0; p < n; ++p)
          store_async4(map_rank(dst, p), d, map_rank(bar, p));
        if (valid[q]) {
          float* gr = g + t * gate_step + bg[q];
          gr[0] = d.x;
          gr[hidden] = d.y;
          gr[2 * hidden] = d.z;
          gr[3 * hidden] = d.w;
        }
      }
    }
    if (k + 1 < t_steps) load_step(s - 1);

    // 3. the whole tile's dgates of this step
    mbar_wait(&full[cur], (k >> 1) & 1);
    if (threadIdx.x == 0 && k + 2 < t_steps)
      mbar_expect(&full[cur], dg_bytes);  // for step k + 2

    // 4. dh of units jj + m lanes over k-slice ks, for every row of the
    // tile: each dgates load feeds UPT units
    const float4* dg =
        reinterpret_cast<const float4*>(dgbuf + cur * BT * four_h);
    float acc[UPT][BT];
#pragma unroll
    for (int m = 0; m < UPT; ++m)
#pragma unroll
      for (int r = 0; r < BT; ++r) acc[m][r] = 0.0f;
#pragma unroll
    for (int uu = 0; uu < KL; ++uu) {
      const int u = u_begin + uu;
      float4 w[UPT];
#pragma unroll
      for (int m = 0; m < UPT; ++m)
        w[m] = gates4(ws, u * units + jj + m * lanes);
#pragma unroll
      for (int r = 0; r < BT; ++r) {
        const float4 v = dg[r * hidden + u];
#pragma unroll
        for (int m = 0; m < UPT; ++m) {
          acc[m][r] = fmaf(v.x, w[m].x, acc[m][r]);
          acc[m][r] = fmaf(v.y, w[m].y, acc[m][r]);
          acc[m][r] = fmaf(v.z, w[m].z, acc[m][r]);
          acc[m][r] = fmaf(v.w, w[m].w, acc[m][r]);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < UPT; ++m)
#pragma unroll
      for (int r = 0; r < BT; ++r)
        part[(ks * BT + r) * units + jj + m * lanes] = acc[m][r];
    __syncthreads();  // partial sums written

#pragma unroll
    for (int q = 0; q < RPT; ++q) {
      if (owned[q]) {
        float sum = 0.0f;
#pragma unroll 4
        for (int p = 0; p < ks_count; ++p)
          sum += part[(p * BT + row[q]) * units + col[q]];
        dh[q] = sum;
      }
    }
  }

#pragma unroll
  for (int q = 0; q < RPT; ++q) {
    if (valid[q]) {
      dh0[bu[q]] = dh[q];
      dc0[bu[q]] = dc[q];
    }
  }
}

// The shared memory limit is raised once per kernel instance and device, and
// each (device, shared memory, threads) is checked once for a cluster that
// can be placed; a launch then costs no more host calls than a plain one.
template <typename T_in, int BT, int KL, int UPT, int RPT>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const auto kernel = lstm_bwd_cluster_kernel<T_in, BT, KL, UPT, RPT>;
  const int units = a.hidden / a.cluster;
  const int threads = a.ks * units / UPT;
  const size_t smem = smem_bytes(a.hidden, units, BT, a.ks, sizeof(T_in));
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(((a.batch + BT - 1) / BT) * a.cluster, a.ndir, 1);
  config.blockDim = dim3(threads, 1, 1);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  config.attrs = attr;
  config.numAttrs = 1;
  {
    static std::mutex mu;
    static std::set<int> raised;
    static std::set<std::tuple<int, size_t, int, int>> placed;
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
    const auto key = std::make_tuple(a.device, smem, threads, a.cluster);
    if (!placed.count(key)) {
      int clusters = 0;
      err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &config);
      if (err != cudaSuccess) return err;
      if (clusters < 1) return cudaErrorLaunchOutOfResources;
      placed.insert(key);
    }
  }
  cudaError_t err = cudaLaunchKernelEx(
      &config, kernel, a.g, a.cs, static_cast<const T_in*>(a.w_hh), a.c0,
      static_cast<const T_in*>(a.dys), a.dh_t, a.dc_t, a.dh0, a.dc0,
      a.t_steps, a.batch, a.hidden, a.reverse, a.cluster);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T_in, int BT, int KL, int UPT>
cudaError_t by_pairs(const Args& a, cudaStream_t s) {
  return BT * UPT <= a.ks ? launch<T_in, BT, KL, UPT, 1>(a, s)
                          : launch<T_in, BT, KL, UPT, 2>(a, s);
}

template <typename T_in, int BT, int KL>
cudaError_t by_units(const Args& a, cudaStream_t s) {
  return a.upt == 1 ? by_pairs<T_in, BT, KL, 1>(a, s)
                    : by_pairs<T_in, BT, KL, 2>(a, s);
}

template <typename T_in>
cudaError_t by_slice(const Args& a, cudaStream_t s) {
  return a.hidden / a.ks == 8 ? by_units<T_in, kTile, 8>(a, s)
                              : by_units<T_in, kTile, 16>(a, s);
}

}  // namespace

// Plain C entry point (bound with ctypes). Every tensor carries `ndir`
// directions stacked in front; direction d's forward walked t = T-1 .. 0
// when reverse ^ d is 1. Clusters of `cluster` CTAs (1, 2, 4 or 8), tiles
// of `tile` batch rows (8), a k-split of `ks` (H/ks = 8 or 16) and
// `upt` units a thread sums in the product (1 or 2), on `stream` of device
// `device`; does not synchronise, allocates nothing, and returns the
// cudaError_t of the launch (0 on success). A plan that does not fit (too
// many threads or pairs a thread, or too much shared memory) or whose
// cluster cannot be placed on the card is refused with an error, never run
// another way.
extern "C" int lstm_bwd_cluster(void* g, void* cs, const void* w_hh,
                                const void* c0, const void* dys,
                                const void* dh_t, const void* dc_t,
                                void* dh0, void* dc0, int t_steps, int batch,
                                int hidden, int ndir, int reverse,
                                int is_bf16, int cluster, int tile, int ks,
                                int upt, int device, void* stream) {
  const bool cluster_ok =
      cluster == 1 || cluster == 2 || cluster == 4 || cluster == 8;
  if (hidden < 32 || hidden % 32 != 0 || hidden > 256 || batch < 1 ||
      t_steps < 0 || (ndir != 1 && ndir != 2) || !cluster_ok ||
      tile != kTile || ks < 1 ||
      (hidden != 8 * ks && hidden != 16 * ks) ||
      (upt != 1 && upt != 2) || (hidden / cluster) % upt != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int units = hidden / cluster;
  const size_t itemsize = is_bf16 ? 2 : 4;
  if (ks * units / upt > kMaxThreads || tile * upt > kMaxPairs * ks ||
      smem_bytes(hidden, units, tile, ks, itemsize) > kMaxSmem - kBarrierSmem)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a{static_cast<float*>(g),
               static_cast<float*>(cs),
               w_hh,
               static_cast<const float*>(c0),
               dys,
               static_cast<const float*>(dh_t),
               static_cast<const float*>(dc_t),
               static_cast<float*>(dh0),
               static_cast<float*>(dc0),
               t_steps,
               batch,
               hidden,
               ndir,
               reverse,
               cluster,
               ks,
               upt,
               device};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = is_bf16 ? by_slice<__nv_bfloat16>(a, s) : by_slice<float>(a, s);
  return static_cast<int>(err);
}

extern "C" const char* lstm_bwd_cluster_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
