// The backward recurrence of an LSTM layer (K2) for large batches: the grid
// fits in about one wave of CTAs, and each CTA walks a tile of many batch
// rows through the replay of c and the whole reverse walk, its step product a
// register-tiled (rows x 4H) @ (4H x H) matrix tile.
//
// Replaces the sequential part of fnssl_tpu/kernels/lstm_pallas.py:
// _lstm_backward (:269-343), the custom_vjp backward of the TPU kernel
// _lstm_kernel (a lax.scan in JAX): its replay of c and its reverse walk,
// without the weight sums, which stay matrix products outside
// (models/lstm.py). lstm_cuda.bwd_route sends a shape here only where it
// measured faster than lstm_bwd_cluster.cu (chip_smoke.py's sweep; PERF.md).
// The contract of lstm_bwd_cluster.cu and of lstm_cuda.lstm_bwd_plain, per
// direction d of ndir (1 or 2):
//   g (ndir, T, B, 4H) float32: the gate pre-activations
//        x_t @ W_ih^T + b + h_{t-1} @ W_hh^T, computed outside; on return
//        it holds dgates (in place);
//   w_hh (ndir, 4H, H) float32 (the wrapper widens a bfloat16 W_hh once:
//        here each of its values feeds only 4 FMAs, too few to widen in the
//        loop), products in float32;  c0, dhT, dcT (ndir, B, H) float32;
//        dys (ndir, T, B, H) in the dtype of ys (float32 or bfloat16);  cs
//        (ndir, T, B, H) float32 scratch;  out dh0, dc0 (ndir, B, H)
//        float32.
//   Replay: c_t = sig(f) c_{t-1} + sig(i) tanh(g), stored in cs.
//   Reverse walk, from the last walk step to the first:
//     dh_tot = dy_t + dh;  dct = dc + dh_tot o (1 - tanh^2 c_t);
//     dgates_t = [dct g i (1-i), dct c_{t-1} f (1-f), dct i (1-g^2),
//                 dh_tot tanh(c_t) o (1-o)]  (torch order i, f, g, o);
//     dh = dgates_t @ W_hh;  dc = dct f.
//   Direction d's forward walked t = T-1 .. 0 when reverse ^ d is 1 (so a
//   two-direction launch with reverse = 0 is a BiLSTM's backward).
//
// What bounds it on an H100: its FLOPs. The serial product dgates_t @ W_hh
// is B 4H H float32 FMAs a step: at (T, B, H) = (298, 4096, 256) 9.551 ms at
// the card's 67 TFLOP/s, while the bytes it must move (g read, dgates
// written, dys read) take 3.4 ms. lstm_bwd_cluster.cu keeps W_hh in a
// cluster's shared memory and walks 8-row tiles for the least step latency;
// at H = 256 in float32 one of its CTAs fills an SM, so B = 4096 is 512
// clusters of 8 CTAs, about 32 waves of serial walks.
//
// Design (lstm_wave.cu's tile, for the backward's product): a CTA of 256
// threads owns a tile of BT = R x 1024/H batch rows for all T steps. Rows are
// independent, so no dgates and no dh cross a CTA. Thread (row group rg, unit
// lane) owns the 4 hidden units u0 .. u0+3 (one 16-byte group) of the R rows
// rg, rg + G, .., rg + (R-1) G of the tile (G = 1024/H row groups): a
// micro-tile of 4R (row, unit) pairs, so that each W_hh value loaded feeds R
// FMAs and each dgates value 4. A warp is 8 unit lanes x 4 row groups, so
// that its loads of W_hh are 128 contiguous bytes that its 4 row groups share
// and its loads of dgates are 4 rows that fall in distinct banks. The same
// pairs hold the product's sums and the cell part, so dh never leaves
// registers.
//   The replay first: each thread walks its pairs forward through G's i, f
//   and g rows (3R 16-byte loads in flight a step) and stores c into cs.
//   Then, each walk step:
//   1. the cell part of the thread's pairs, from G_t, c_{t-1} and dy_t, which
//      bulk copies (TMA, completing on one mbarrier) brought into shared
//      memory during the step before, c_t and dc in registers, and dh from
//      the step before's product; dgates go over G_t in shared memory (in
//      place) and over g;
//   2. one barrier (the tile's dgates in place; every read of the step's
//      c_{t-1} and dy_t done), after which one warp starts the next step's
//      copies of c_{t-1} and dy_t;
//   3. the product dh = dgates_t @ W_hh over k = 0 .. 4H-1, in four blocks of
//      H k's (one gate each). W_hh is read from L2 (read-only path) straight
//      into registers, 4 k's x 4 units a register block, a block ahead (the
//      last block of a step loads the next step's first); dgates are read
//      from shared memory as 4 k's of a row a load. After each gate block a
//      barrier, and the warp copies the next step's G for that block into the
//      rows the block leaves: three quarters of the next step's G load while
//      this step's product runs.
// Shared memory: dgates / G (BT x (4H + 4) float32; rows padded so that the 4
// rows of a warp's load fall in distinct banks), c_{t-1} (BT x H float32) and
// dy_t (BT x H in ys's dtype): 96.3 KB at R = 4 (BT = 16 at H = 256), two
// CTAs an SM, so that B = 4096 is 256 CTAs in one wave of 264 places.
// Measured on an H100 (chip_smoke.py phase 9, tools/lstm_bwd_breakdown.py,
// tools/lstm_bwd_wave_variants.py; PERF.md): 22.7 ms at the shape above in
// float32, 42% of the FMA bound (lstm_bwd_cluster.cu 39.4 ms), 22.5 with a
// bfloat16 dy. The two CTAs an SM are what makes it fast: one CTA of 32 rows
// (R = 8, 192.5 KB) took 26-28 ms at the shape above, and a CTA of 512
// threads over the same 32 rows 25-26 ms, although both read W_hh from L2
// half as often; R = 2 (three CTAs an SM) took 46 ms; fewer barriers a step
// (one or two in place of four) and prefetching W_hh into L1 gained nothing.
// So R = 4 is the tile, and R = 5 (BT = 20) a second one with a bfloat16
// dy, whose smaller stage lets two CTAs of 20 rows share an SM: B = 4768 is
// then 239 CTAs in one wave (28.6 ms against 36.2 for two waves of 16-row
// tiles; with a float32 dy one CTA an SM, 42 ms). Without its product the
// kernel takes 6.3 ms (the replay about 1.2 of it): the bytes, most of which
// the product hides. The product runs at about half the FMA rate: each
// 16-byte load feeds 16 FMAs, and a W_hh block loaded one block ahead does
// not cover L2's latency with 4 warps on each of the SM's schedulers (a
// build whose W_hh reads all hit L1 took 2.8 ms less; one that loads one
// row of dgates for all of a thread's rows, 2.3 ms less).
// The ragged edge of B is masked, never padded by the caller: the copies
// bring only the valid rows, a masked row's dgates, dh and dc are zeros, and
// it is never stored. G is read through the non-coherent path (__ldg) in the
// replay only, before the walk writes any dgates over it; the walk reads it
// through the bulk copies, each before its step writes over it. There are no
// atomics: the same inputs give the same bits on every run. All arithmetic is
// float32 FMAs outside the tensor cores, for both dtypes; a bfloat16 dy is
// widened as it is read from shared memory. sigmoid and tanh use the fast exp
// (__expf, __fdividef), as in the sibling kernels (about 1e-7 from the exact
// functions). At H = 256 H is a compile-time constant (the loads' offsets
// become immediates).
// At H = 128 (FN-SSL's full band in training, B = 4768 both directions:
// 9536 rows, 72.2 an SM if spread evenly; bound 4.78 ms of FMAs) the tiles
// above would be 32 rows: 298 CTAs, two waves, 96 rows on the busiest SM
// (23.4 ms, slower than lstm_bwd_cluster.cu's 18.5; slower at every H = 128
// shape measured). So H = 128 has a kernel of its own, the only one this
// source runs at that width (lstm_bwd_wave_kernel_h128, below): tiles of
// any even row count up to 40, so that the full band is 252 CTAs of 38 rows
// in one wave, 76 rows on the busiest SM, and dgates alone in shared
// memory, so that two CTAs of 38 rows share an SM in float32. Measured on
// an H100 80GB HBM3 at 700 W (chip_smoke.py phase 9,
// tools/lstm_h128_variants.py, tools/lstm_bwd_breakdown.py; PERF.md):
// 13.0 ms at the full band in float32 and bfloat16, 37% of the FMA bound,
// against 18.4 and 16.2-16.8 on lstm_bwd_cluster.cu. Without W_hh's loads it
// takes 10.6 ms, without the replay 11.6 (the replay moves 5 GB at the HBM
// rate); deeper W_hh pipelines (a ring of 4 register blocks, a TMA ring in
// shared memory), L2 prefetches of the next step's rows and a warp a row
// group of up to 10 rows all measured slower.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <set>

namespace {

constexpr int kThreads = 256;         // threads a CTA
constexpr int kUnits = 4;             // hidden units a thread owns
constexpr int kPad = 4;               // floats a row of dgates is padded by
constexpr int kBlock = 4;             // k's of W_hh a register block
constexpr int kRows = 4;              // rows of the tile a thread owns (R)
constexpr int kRowsWide = 5;          // with a bfloat16 dy: 2 CTAs an SM
constexpr size_t kMaxSmem = 232448;   // shared memory a block may use (227 KB)
constexpr size_t kBarrierSmem = 16;   // of it, the mbarrier (static)

// four bfloat16 values, widened (the lower address in the low half)
__device__ __forceinline__ float4 widen(uint2 v) {
  return make_float4(__uint_as_float(v.x << 16),
                     __uint_as_float(v.x & 0xffff0000u),
                     __uint_as_float(v.y << 16),
                     __uint_as_float(v.y & 0xffff0000u));
}

// dy_t staged in shared memory (a plain load: the copy completed)
__device__ __forceinline__ float4 smem4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 smem4(const __nv_bfloat16* p) {
  return widen(*reinterpret_cast<const uint2*>(p));
}

__device__ __forceinline__ float sigmoid_f(float x) {
  return __fdividef(1.0f, 1.0f + __expf(-x));
}

__device__ __forceinline__ float tanh_f(float x) {
  return 2.0f * sigmoid_f(2.0f * x) - 1.0f;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar))
               : "memory");
}

// The one arrival of the barrier's current phase, which then completes once
// `bytes` more have been copied into this CTA against it.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// Copies `bytes` (a multiple of 16) from global src to shared dst (both
// 16-byte aligned), counted on the mbarrier's transaction bytes.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// W_hh rows k0 .. k0 + kBlock - 1 at the thread's 4 units, from L2.
__device__ __forceinline__ void load_block(float4 (&w)[kBlock],
                                           const float* w_hh, int k0, int u0,
                                           int hidden) {
#pragma unroll
  for (int e = 0; e < kBlock; ++e)
    w[e] = __ldg(reinterpret_cast<const float4*>(
        w_hh + static_cast<size_t>(k0 + e) * hidden + u0));
}

// acc[i][u] += dgates[row i][k0 + e] * w[e].u for the kBlock k's of a block:
// one 16-byte load of a row's 4 k's feeds 16 FMAs.
template <int R>
__device__ __forceinline__ void fma_block(float (&acc)[R][kUnits],
                                          const float4 (&w)[kBlock],
                                          const float* dgrow, int k0,
                                          int row_stride) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const float4 d4 =
        *reinterpret_cast<const float4*>(dgrow + i * row_stride + k0);
    const float dv[kBlock] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
    for (int e = 0; e < kBlock; ++e) {
      acc[i][0] = fmaf(dv[e], w[e].x, acc[i][0]);
      acc[i][1] = fmaf(dv[e], w[e].y, acc[i][1]);
      acc[i][2] = fmaf(dv[e], w[e].z, acc[i][2]);
      acc[i][3] = fmaf(dv[e], w[e].w, acc[i][3]);
    }
  }
}

// The cell part of one (row, unit) pair: its dgates d from its gates, c_t
// (ct), c_{t-1} (cp), dy_t and dh; dc and ct move one walk step back.
__device__ __forceinline__ void cell(float gi, float gf, float gg, float go,
                                     float cp, float dy, float dh, float& dc,
                                     float& ct, float (&d)[4]) {
  const float ig = sigmoid_f(gi);
  const float fg = sigmoid_f(gf);
  const float gc = tanh_f(gg);
  const float og = sigmoid_f(go);
  const float tc = tanh_f(ct);
  const float dht = dy + dh;
  const float dct = dc + dht * og * (1.0f - tc * tc);
  d[0] = dct * gc * ig * (1.0f - ig);
  d[1] = dct * cp * fg * (1.0f - fg);
  d[2] = dct * ig * (1.0f - gc * gc);
  d[3] = dht * tc * og * (1.0f - og);
  dc = dct * fg;
  ct = cp;
}

__device__ __forceinline__ float get(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

// shared memory of one CTA: dgates / G [BT][4H + pad] and c_{t-1} [BT][H]
// float32, and dy_t [BT][H] in ys's dtype
__host__ __device__ constexpr size_t smem_bytes(int hidden, int tile,
                                                int itemsize) {
  return static_cast<size_t>(tile) * (4 * hidden + kPad) * 4 +
         static_cast<size_t>(tile) * hidden * 4 +
         static_cast<size_t>(tile) * hidden * itemsize;
}

// R: rows of the tile a thread owns (4, or 5 with a bfloat16 dy; two CTAs an
// SM, as the registers are budgeted); HC: H when it is known at compile time
// (256, the width the rule routes here), else 0. T_in: dy's dtype.
template <typename T_in, int R, int HC>
__global__ void __launch_bounds__(kThreads, 2)
lstm_bwd_wave_kernel(float* __restrict__ g, float* __restrict__ cs,
                     const float* __restrict__ w_hh,
                     const float* __restrict__ c0,
                     const T_in* __restrict__ dys,
                     const float* __restrict__ dh_t,
                     const float* __restrict__ dc_t, float* __restrict__ dh0,
                     float* __restrict__ dc0, int t_steps, int batch,
                     int hidden_arg, int reverse) {
  const int hidden = HC ? HC : hidden_arg;
  const int four_h = 4 * hidden;
  const int groups = kThreads * kUnits / hidden;  // row groups G
  const int tile = groups * R;                    // BT
  const int pitch = four_h + kPad;                // floats a row of dgates
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wcols = hidden / 32;  // warps across the units (8 lanes of 4)
  const int u0 = ((warp % wcols) * 8 + lane % 8) * kUnits;
  const int rg = (warp / wcols) * 4 + lane / 8;   // rows rg + G i, i < R
  const int dir = blockIdx.y;
  const int b0 = blockIdx.x * tile;
  const int valid = min(tile, batch - b0);  // rows of the tile inside B
  const bool backward = (reverse ^ dir) != 0;  // the forward's walk
  const size_t gate_step = static_cast<size_t>(batch) * four_h;  // g per t
  const size_t unit_step = static_cast<size_t>(batch) * hidden;  // cs per t
  const uint32_t step_bytes =
      static_cast<uint32_t>(valid) *
      (four_h * 4 + hidden * 4 + hidden * static_cast<int>(sizeof(T_in)));

  // this direction's and tile's arrays
  g += static_cast<size_t>(dir) * t_steps * gate_step +
       static_cast<size_t>(b0) * four_h;
  const size_t rows_off = static_cast<size_t>(dir) * t_steps * unit_step +
                          static_cast<size_t>(b0) * hidden;
  cs += rows_off;
  dys += rows_off;
  w_hh += static_cast<size_t>(dir) * four_h * hidden;
  const size_t state_off =
      (static_cast<size_t>(dir) * batch + b0) * hidden;
  c0 += state_off;
  dh_t += state_off;
  dc_t += state_off;
  dh0 += state_off;
  dc0 += state_off;

  extern __shared__ float4 smem_v4[];
  float* dg = reinterpret_cast<float*>(smem_v4);               // [BT][pitch]
  float* cps = dg + static_cast<size_t>(tile) * pitch;          // [BT][H]
  T_in* dys_s = reinterpret_cast<T_in*>(cps + static_cast<size_t>(tile) *
                                                  hidden);     // [BT][H]
  __shared__ alignas(8) uint64_t full;  // a step's G, c_{t-1}, dy_t arrived

  // masked rows stay zeros: the copies bring only the valid rows
  const int vec4 = static_cast<int>(smem_bytes(hidden, tile, sizeof(T_in)) /
                                    16);
  for (int idx = threadIdx.x; idx < vec4; idx += kThreads)
    smem_v4[idx] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (threadIdx.x == 0) {
    mbar_init(&full);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  auto time_of = [&](int s) { return backward ? t_steps - 1 - s : s; };

  // the replay of c, in the forward's walk order, for the thread's pairs
  float ct[R][kUnits];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = rg + groups * i;
    const float4 v = row < valid
                         ? *reinterpret_cast<const float4*>(
                               c0 + static_cast<size_t>(row) * hidden + u0)
                         : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    ct[i][0] = v.x;
    ct[i][1] = v.y;
    ct[i][2] = v.z;
    ct[i][3] = v.w;
  }
  for (int s = 0; s < t_steps; ++s) {
    const int t = time_of(s);
    const float* gt = g + static_cast<size_t>(t) * gate_step;
    float* c_out = cs + static_cast<size_t>(t) * unit_step;
    float4 gv[R][3];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = rg + groups * i;
      if (row < valid) {
        const float* p = gt + static_cast<size_t>(row) * four_h + u0;
        gv[i][0] = __ldg(reinterpret_cast<const float4*>(p));
        gv[i][1] = __ldg(reinterpret_cast<const float4*>(p + hidden));
        gv[i][2] = __ldg(reinterpret_cast<const float4*>(p + 2 * hidden));
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = rg + groups * i;
      if (row < valid) {
#pragma unroll
        for (int u = 0; u < kUnits; ++u)
          ct[i][u] = sigmoid_f(get(gv[i][1], u)) * ct[i][u] +
                     sigmoid_f(get(gv[i][0], u)) * tanh_f(get(gv[i][2], u));
        *reinterpret_cast<float4*>(c_out + static_cast<size_t>(row) * hidden +
                                   u0) =
            make_float4(ct[i][0], ct[i][1], ct[i][2], ct[i][3]);
      }
    }
  }
  // cs and the zeroed shared memory are read / written next by bulk copies
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  // walk step s's c_{t-1} and dy_t; G_t's gate block e (one warp)
  auto stage_state = [&](int s) {
    const float* src_c =
        s > 0 ? cs + static_cast<size_t>(time_of(s - 1)) * unit_step : c0;
    const T_in* src_dy = dys + static_cast<size_t>(time_of(s)) * unit_step;
    for (int row = lane; row < valid; row += 32) {
      const size_t o = static_cast<size_t>(row) * hidden;
      bulk_copy(cps + o, src_c + o, hidden * 4, &full);
      bulk_copy(dys_s + o, src_dy + o, hidden * sizeof(T_in), &full);
    }
  };
  auto stage_gates = [&](int s, int e) {
    const float* src =
        g + static_cast<size_t>(time_of(s)) * gate_step + e * hidden;
    for (int row = lane; row < valid; row += 32)
      bulk_copy(dg + row * pitch + e * hidden,
                src + static_cast<size_t>(row) * four_h, hidden * 4, &full);
  };
  auto expect = [&]() {
    if (lane == 0) mbar_expect(&full, step_bytes);
    __syncwarp();
  };
  if (warp == 0 && t_steps > 0) {
    expect();
    stage_state(t_steps - 1);
    for (int e = 0; e < 4; ++e) stage_gates(t_steps - 1, e);
  }

  // the walk's carries: dh (the product's sums) and dc, from dhT and dcT
  float acc[R][kUnits], dc[R][kUnits];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = rg + groups * i;
    const bool ok = row < valid;
    const size_t o = static_cast<size_t>(row) * hidden + u0;
    const float4 h4 = ok ? *reinterpret_cast<const float4*>(dh_t + o)
                         : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const float4 c4 = ok ? *reinterpret_cast<const float4*>(dc_t + o)
                         : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int u = 0; u < kUnits; ++u) {
      acc[i][u] = get(h4, u);
      dc[i][u] = get(c4, u);
    }
  }

  const float* dgrow = dg + rg * pitch;  // the thread's first row
  const int row_stride = groups * pitch;
  float4 w0[kBlock], w1[kBlock];
  load_block(w0, w_hh, 0, u0, hidden);
  for (int k = 0; k < t_steps; ++k) {
    const int s = t_steps - 1 - k;  // the walk step being undone
    const int t = time_of(s);
    mbar_wait(&full, k & 1);  // G_t, c_{t-1}, dy_t in shared memory

    // 1. the cell part: dgates over G_t in shared memory and over g
    float* g_out = g + static_cast<size_t>(t) * gate_step;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = rg + groups * i;
      float* d = dg + row * pitch + u0;
      const float4 gi = smem4(d), gf = smem4(d + hidden),
                   gc = smem4(d + 2 * hidden), go = smem4(d + 3 * hidden);
      const float4 cp = smem4(cps + row * hidden + u0);
      const float4 dy = smem4(dys_s + row * hidden + u0);
      float o[kUnits][4];  // [unit][gate]
#pragma unroll
      for (int u = 0; u < kUnits; ++u)
        cell(get(gi, u), get(gf, u), get(gc, u), get(go, u), get(cp, u),
             get(dy, u), acc[i][u], dc[i][u], ct[i][u], o[u]);
      if (row >= valid) {
#pragma unroll
        for (int u = 0; u < kUnits; ++u) {
          dc[i][u] = 0.0f;
#pragma unroll
          for (int e = 0; e < 4; ++e) o[u][e] = 0.0f;
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float4 v = make_float4(o[0][e], o[1][e], o[2][e], o[3][e]);
        *reinterpret_cast<float4*>(d + e * hidden) = v;
        if (row < valid)
          *reinterpret_cast<float4*>(g_out + static_cast<size_t>(row) *
                                                 four_h +
                                     u0 + e * hidden) = v;
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // the tile's dgates in place; c_{t-1}, dy_t read
    const bool more = k + 1 < t_steps;
    if (more && warp == 0) {
      expect();
      stage_state(s - 1);
    }

    // 3. dh = dgates_t @ W_hh, one gate block of H k's at a time; the next
    // step's G for a block is copied in once every thread is past it
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int u = 0; u < kUnits; ++u) acc[i][u] = 0.0f;
#pragma unroll 1
    for (int e = 0; e < 4; ++e) {
#pragma unroll 1
      for (int kk = 0; kk < hidden; kk += 2 * kBlock) {
        const int kg = e * hidden + kk;
        load_block(w1, w_hh, kg + kBlock, u0, hidden);
        fma_block<R>(acc, w0, dgrow, kg, row_stride);
        const int kn = kg + 2 * kBlock < four_h ? kg + 2 * kBlock : 0;
        load_block(w0, w_hh, kn, u0, hidden);
        fma_block<R>(acc, w1, dgrow, kg + kBlock, row_stride);
      }
      __syncthreads();  // every read of gate block e done
      if (more && warp == 0) stage_gates(s - 1, e);
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = rg + groups * i;
    if (row < valid) {
      const size_t o = static_cast<size_t>(row) * hidden + u0;
      *reinterpret_cast<float4*>(dh0 + o) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      *reinterpret_cast<float4*>(dc0 + o) =
          make_float4(dc[i][0], dc[i][1], dc[i][2], dc[i][3]);
    }
  }
}

// ---- H = 128: tiles of any even row count from 10 to 40 ----
//
// A warp is 16 unit lanes x 2 row groups (64 units of 2 rows), so two warps
// cover H = 128 and the CTA's 8 warps are 4 warp-rows of 2 row groups: 8 row
// groups. Thread (row group rg, unit lane) owns units u0 .. u0+3 of the rows
// rg, rg + 8, .., rg + 8 (R-1) of the tile; the last of them only in the
// first `xr` warp-rows, so that a tile is 8 (R-1) + 2 xr rows: any even count
// from 10 to 40, which lets the grid spread B evenly over the SMs (FN-SSL's
// full band, 2 x 4768 rows, is 252 tiles of 38, at most 76 rows an SM where
// 32-row tiles put 96). Which slot count a warp has is the same for all its
// lanes, so a warp of R-1 rows runs a product built for R-1 rows. Shared
// memory holds only the step's dgates (BT x (4H + 4) float32, 78.4 KB at 38
// rows, two CTAs an SM in float32 and bfloat16 alike): the cell part loads
// its G_t, c_{t-1} and dy_t into registers straight from memory, and each
// step has two barriers (dgates in place; every read of them done), and at
// R = 5 (tiles of 34-40 rows, FN-SSL's full band) four more, one after each
// gate block of the product, which keep the CTA's warps on the same rows of
// W_hh: 0.8-2.1% faster at the full band in four calls, while at R = 3
// (VariableIPDnet's 24-row tiles) the same barriers measured 2% slower and
// at R = 2 no faster (tools/lstm_h128_variants.py; PERF.md). W_hh comes
// from L2 into register blocks a block ahead, as at the other widths.
constexpr int kRowGroups128 = 8;  // row groups of a CTA at H = 128

// shared memory of one CTA at H = 128: dgates [BT][4H + pad] float32
__host__ __device__ constexpr size_t smem_bytes128(int tile) {
  return static_cast<size_t>(tile) * (4 * 128 + kPad) * 4;
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  return widen(*reinterpret_cast<const uint2*>(p));
}

// acc[i][u] += dgates[row i][k0 + e] * w[e].u for the first N of the R rows
template <int N, int R>
__device__ __forceinline__ void fma_rows(float (&acc)[R][kUnits],
                                         const float4 (&w)[kBlock],
                                         const float* dgrow, int k0,
                                         int row_stride) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float4 d4 =
        *reinterpret_cast<const float4*>(dgrow + i * row_stride + k0);
    const float dv[kBlock] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
    for (int e = 0; e < kBlock; ++e) {
      acc[i][0] = fmaf(dv[e], w[e].x, acc[i][0]);
      acc[i][1] = fmaf(dv[e], w[e].y, acc[i][1]);
      acc[i][2] = fmaf(dv[e], w[e].z, acc[i][2]);
      acc[i][3] = fmaf(dv[e], w[e].w, acc[i][3]);
    }
  }
}

// dh = dgates_t @ W_hh for the first N of the thread's R rows, over k = 0 ..
// 4H-1 (W_hh in register blocks a block ahead; the last loads the next
// step's first). At R = 5 the CTA's warps meet after each gate block, on a
// non-aligned barrier: warps of R and of R - 1 rows reach it from different
// branches, where an aligned one (__syncthreads) is undefined.
template <int N, int R>
__device__ __forceinline__ void product128(float (&acc)[R][kUnits],
                                           float4 (&w0)[kBlock],
                                           float4 (&w1)[kBlock],
                                           const float* w_hh,
                                           const float* dgrow, int u0) {
  constexpr int four_h = 4 * 128, stride = kRowGroups128 * (four_h + kPad);
#pragma unroll 1
  for (int kg = 0; kg < four_h; kg += 2 * kBlock) {
    load_block(w1, w_hh, kg + kBlock, u0, 128);
    fma_rows<N>(acc, w0, dgrow, kg, stride);
    load_block(w0, w_hh, kg + 2 * kBlock < four_h ? kg + 2 * kBlock : 0, u0,
               128);
    fma_rows<N>(acc, w1, dgrow, kg + kBlock, stride);
    if (R == 5 && (kg + 2 * kBlock) % 128 == 0)
      asm volatile("barrier.sync 0;\n" ::: "memory");
  }
}

template <typename T_in, int R>
__global__ void __launch_bounds__(kThreads, 2)
lstm_bwd_wave_kernel_h128(float* __restrict__ g, float* __restrict__ cs,
                          const float* __restrict__ w_hh,
                          const float* __restrict__ c0,
                          const T_in* __restrict__ dys,
                          const float* __restrict__ dh_t,
                          const float* __restrict__ dc_t,
                          float* __restrict__ dh0, float* __restrict__ dc0,
                          int t_steps, int batch, int tile, int reverse) {
  constexpr int hidden = 128, four_h = 4 * hidden, pitch = four_h + kPad;
  constexpr int groups = kRowGroups128;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int u0 = ((warp % 2) * 16 + lane % 16) * kUnits;
  const int wrow = warp / 2;                   // warp-row 0 .. 3
  const int rg = wrow * 2 + lane / 16;         // rows rg + 8 i
  const bool full = 2 * wrow < tile - groups * (R - 1);  // owns slot R-1
  const int dir = blockIdx.y;
  const int b0 = blockIdx.x * tile;
  const int valid = min(tile, batch - b0);  // rows of the tile inside B
  const bool backward = (reverse ^ dir) != 0;  // the forward's walk
  const size_t gate_step = static_cast<size_t>(batch) * four_h;  // g per t
  const size_t unit_step = static_cast<size_t>(batch) * hidden;  // cs per t

  g += static_cast<size_t>(dir) * t_steps * gate_step +
       static_cast<size_t>(b0) * four_h;
  const size_t rows_off = static_cast<size_t>(dir) * t_steps * unit_step +
                          static_cast<size_t>(b0) * hidden;
  cs += rows_off;
  dys += rows_off;
  w_hh += static_cast<size_t>(dir) * four_h * hidden;
  const size_t state_off = (static_cast<size_t>(dir) * batch + b0) * hidden;
  c0 += state_off;
  dh_t += state_off;
  dc_t += state_off;
  dh0 += state_off;
  dc0 += state_off;

  extern __shared__ float4 smem_v4[];
  float* dg = reinterpret_cast<float*>(smem_v4);  // [BT][pitch]

  auto time_of = [&](int s) { return backward ? t_steps - 1 - s : s; };
  auto owns = [&](int i) {  // slot i of the thread holds a row of B
    return (i < R - 1 || full) && rg + groups * i < valid;
  };

  // the replay of c, in the forward's walk order, for the thread's pairs
  float ct[R][kUnits];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const float4 v = owns(i) ? load4(c0 + (rg + groups * i) * hidden + u0)
                             : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    ct[i][0] = v.x;
    ct[i][1] = v.y;
    ct[i][2] = v.z;
    ct[i][3] = v.w;
  }
  for (int s = 0; s < t_steps; ++s) {
    const float* gt = g + static_cast<size_t>(time_of(s)) * gate_step;
    float* c_out = cs + static_cast<size_t>(time_of(s)) * unit_step;
    float4 gv[R][3];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (owns(i)) {
        const float* p = gt + (rg + groups * i) * four_h + u0;
        gv[i][0] = __ldg(reinterpret_cast<const float4*>(p));
        gv[i][1] = __ldg(reinterpret_cast<const float4*>(p + hidden));
        gv[i][2] = __ldg(reinterpret_cast<const float4*>(p + 2 * hidden));
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (owns(i)) {
#pragma unroll
        for (int u = 0; u < kUnits; ++u)
          ct[i][u] = sigmoid_f(get(gv[i][1], u)) * ct[i][u] +
                     sigmoid_f(get(gv[i][0], u)) * tanh_f(get(gv[i][2], u));
        *reinterpret_cast<float4*>(c_out + (rg + groups * i) * hidden + u0) =
            make_float4(ct[i][0], ct[i][1], ct[i][2], ct[i][3]);
      }
    }
  }

  // the walk's carries: dh (the product's sums) and dc, from dhT and dcT
  float acc[R][kUnits], dc[R][kUnits];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int o = (rg + groups * i) * hidden + u0;
    const bool ok = owns(i);
    const float4 h4 = ok ? load4(dh_t + o) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const float4 c4 = ok ? load4(dc_t + o) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int u = 0; u < kUnits; ++u) {
      acc[i][u] = get(h4, u);
      dc[i][u] = get(c4, u);
    }
  }
  // (the walk reads back only the thread's own cs: no barrier)
  const float* dgrow = dg + rg * pitch;  // the thread's first row
  float4 w0[kBlock], w1[kBlock];
  load_block(w0, w_hh, 0, u0, hidden);
  for (int k = 0; k < t_steps; ++k) {
    const int s = t_steps - 1 - k;  // the walk step being undone
    const int t = time_of(s);
    float* g_t = g + static_cast<size_t>(t) * gate_step;
    const float* c_prev =
        s > 0 ? cs + static_cast<size_t>(time_of(s - 1)) * unit_step : c0;
    const T_in* dy_t = dys + static_cast<size_t>(t) * unit_step;

    // 1. the cell part: dgates over dg in shared memory and over g
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (i == R - 1 && !full) break;
      const int row = rg + groups * i;
      float o[kUnits][4];  // [unit][gate]
      if (row < valid) {
        const float* p = g_t + row * four_h + u0;
        const float4 gi = load4(p), gf = load4(p + hidden),
                     gc = load4(p + 2 * hidden), go = load4(p + 3 * hidden);
        const float4 cp = load4(c_prev + row * hidden + u0);
        const float4 dy = load4(dy_t + row * hidden + u0);
#pragma unroll
        for (int u = 0; u < kUnits; ++u)
          cell(get(gi, u), get(gf, u), get(gc, u), get(go, u), get(cp, u),
               get(dy, u), acc[i][u], dc[i][u], ct[i][u], o[u]);
      } else {
#pragma unroll
        for (int u = 0; u < kUnits; ++u) {
          dc[i][u] = 0.0f;
#pragma unroll
          for (int e = 0; e < 4; ++e) o[u][e] = 0.0f;
        }
      }
      float* d = dg + row * pitch + u0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float4 v = make_float4(o[0][e], o[1][e], o[2][e], o[3][e]);
        *reinterpret_cast<float4*>(d + e * hidden) = v;
        if (row < valid)
          *reinterpret_cast<float4*>(g_t + row * four_h + u0 + e * hidden) = v;
      }
    }
    __syncthreads();  // the tile's dgates in place

    // 2. dh = dgates_t @ W_hh
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int u = 0; u < kUnits; ++u) acc[i][u] = 0.0f;
    if (full)
      product128<R>(acc, w0, w1, w_hh, dgrow, u0);
    else
      product128<R - 1>(acc, w0, w1, w_hh, dgrow, u0);
    __syncthreads();  // every read of dgates done
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (owns(i)) {
      const int o = (rg + groups * i) * hidden + u0;
      *reinterpret_cast<float4*>(dh0 + o) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      *reinterpret_cast<float4*>(dc0 + o) =
          make_float4(dc[i][0], dc[i][1], dc[i][2], dc[i][3]);
    }
  }
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
  int t_steps, batch, hidden, ndir, reverse, device;
};

// The shared memory limit is raised once per kernel instance and device; a
// launch then costs no more host calls than a plain one.
template <typename T_in, int R, int HC>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const auto kernel = lstm_bwd_wave_kernel<T_in, R, HC>;
  const int tile = kThreads * kUnits / a.hidden * R;
  const size_t smem = smem_bytes(a.hidden, tile, sizeof(T_in));
  {
    static std::mutex mu;
    static std::set<int> raised;
    std::lock_guard<std::mutex> lock(mu);
    if (!raised.count(a.device)) {
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(kMaxSmem - kBarrierSmem));
      if (err != cudaSuccess) return err;
      raised.insert(a.device);
    }
  }
  const dim3 grid((a.batch + tile - 1) / tile, a.ndir);
  kernel<<<grid, kThreads, smem, stream>>>(
      a.g, a.cs, static_cast<const float*>(a.w_hh), a.c0,
      static_cast<const T_in*>(a.dys), a.dh_t, a.dc_t, a.dh0, a.dc0,
      a.t_steps, a.batch, a.hidden, a.reverse);
  return cudaGetLastError();
}

template <typename T_in, int R>
cudaError_t launch128(const Args& a, int tile, cudaStream_t stream) {
  const auto kernel = lstm_bwd_wave_kernel_h128<T_in, R>;
  {
    static std::mutex mu;
    static std::set<int> raised;
    std::lock_guard<std::mutex> lock(mu);
    if (!raised.count(a.device)) {
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem_bytes128(kRowGroups128 * R)));
      if (err != cudaSuccess) return err;
      raised.insert(a.device);
    }
  }
  const dim3 grid((a.batch + tile - 1) / tile, a.ndir);
  kernel<<<grid, kThreads, smem_bytes128(tile), stream>>>(
      a.g, a.cs, static_cast<const float*>(a.w_hh), a.c0,
      static_cast<const T_in*>(a.dys), a.dh_t, a.dc_t, a.dh0, a.dc0,
      a.t_steps, a.batch, tile, a.reverse);
  return cudaGetLastError();
}

// a tile of `tile` rows at H = 128 (even, 10 .. 40): R = ceil(tile / 8)
template <typename T_in>
cudaError_t by_tile128(const Args& a, int tile, cudaStream_t s) {
  switch ((tile + kRowGroups128 - 1) / kRowGroups128) {
    case 2: return launch128<T_in, 2>(a, tile, s);
    case 3: return launch128<T_in, 3>(a, tile, s);
    case 4: return launch128<T_in, 4>(a, tile, s);
    default: return launch128<T_in, 5>(a, tile, s);
  }
}

template <typename T_in, int R>
cudaError_t by_width(const Args& a, cudaStream_t s) {
  return a.hidden == 256 ? launch<T_in, R, 256>(a, s)
                         : launch<T_in, R, 0>(a, s);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// Plain C entry point (bound with ctypes). Every tensor carries `ndir`
// directions stacked in front; direction d's forward walked t = T-1 .. 0
// when reverse ^ d is 1; `is_bf16` gives dys' dtype (w_hh is float32).
// `rows` is, at H 32, 64 and 256, the batch rows of the tile a thread (4, or
// 5 with a bfloat16 dy), and at H = 128 the tile's rows (even, 10 to 40: the
// H = 128 kernel, the only one at that width); on `stream` of device
// `device`; does not synchronise, allocates nothing, and returns the
// cudaError_t of the launch (0 on success). H must be 32, 64, 128 or 256 (a
// warp's 8 lanes of 4 units, 1024/H row groups) and every array 16-byte
// aligned (the bulk copies and 16-byte loads); other arguments are refused
// with an error, never run another way.
extern "C" int lstm_bwd_wave(void* g, void* cs, const void* w_hh,
                             const void* c0, const void* dys,
                             const void* dh_t, const void* dc_t, void* dh0,
                             void* dc0, int t_steps, int batch, int hidden,
                             int ndir, int reverse, int is_bf16, int rows,
                             int device, void* stream) {
  // at H = 128, `rows` is a tile of that many rows
  const bool h128 = hidden == 128;
  if (hidden < 32 || hidden > 256 || hidden % 32 != 0 ||
      (kThreads * kUnits) % hidden != 0 || batch < 1 || t_steps < 0 ||
      (ndir != 1 && ndir != 2) ||
      !(h128 ? rows >= 10 && rows <= 40 && rows % 2 == 0
             : rows == kRows || (rows == kRowsWide && is_bf16)))
    return static_cast<int>(cudaErrorInvalidValue);
  const void* arrays[] = {g, cs, w_hh, c0, dys, dh_t, dc_t, dh0, dc0};
  for (const void* p : arrays)
    if (!aligned16(p)) return static_cast<int>(cudaErrorMisalignedAddress);
  const int tile = kThreads * kUnits / hidden * rows;
  if (!h128 &&
      smem_bytes(hidden, tile, is_bf16 ? 2 : 4) > kMaxSmem - kBarrierSmem)
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
               device};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (h128)
    return static_cast<int>(is_bf16 ? by_tile128<__nv_bfloat16>(a, rows, s)
                                    : by_tile128<float>(a, rows, s));
  err = !is_bf16              ? by_width<float, kRows>(a, s)
        : rows == kRowsWide ? by_width<__nv_bfloat16, kRowsWide>(a, s)
                            : by_width<__nv_bfloat16, kRows>(a, s);
  return static_cast<int>(err);
}

extern "C" const char* lstm_bwd_wave_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
