// LSTM recurrence over T steps for large batches: the grid fits in one wave
// of CTAs, and each CTA walks a tile of many batch rows through all T steps,
// its step product a register-tiled (rows x H) @ (H x 4H) matrix tile.
//
// Replaces fnssl_tpu/kernels/lstm_pallas.py:_lstm_kernel (the TPU kernel
// launched by _lstm_pallas_fwd) where the batch is large: lstm_cuda.fwd_route
// sends a shape here only where it measured faster than lstm_cluster.cu
// (FN-SSL's narrow band, B = nb nf = 4096 rows at H = 256, in training and in
// the 16-slot tick; its full band in training, B = nb nt = 4768 at H = 128 in
// both directions). Same contract as lstm_cluster.cu, per direction d of ndir
// (1 or 2):
//   xg (ndir, T, B, 4H) float32 or bfloat16, the input gates x @ W_ih^T + b;
//   w_hh_t (ndir, H, 4H) in the dtype of xg;  h0, c0 (ndir, B, H) float32.
//   Per step: gates = xg_t + h @ w_hh_t (float32 accumulation), torch gate
//   order i, f, g, o; c = sig(f) c + sig(i) tanh(g); h = sig(o) tanh(c).
//   (h, c) stay float32 for all T. Direction d walks backwards (t = T-1 .. 0,
//   ys[t] written in place, no flip) when reverse ^ d is 1, so a two-direction
//   launch with reverse = 0 is a BiLSTM. ys (ndir, T, B, H) in the dtype of
//   xg; hT, cT (ndir, B, H) float32.
//
// What bounds it on an H100: its FLOPs. A step is B H 4H float32 FMAs (at
// T = 298, B = 4096, H = 256: 9.55 ms at the card's 67 TFLOP/s), while the
// bytes it must move (xg once, ys once, W_hh once) take 1.9 ms.
// lstm_cluster.cu keeps W_hh in a cluster's shared memory and walks 8-row
// tiles for the least step latency; at H = 256 in float32 one CTA fills an
// SM, so B = 4096 is 512 clusters of 8 CTAs, about 32 waves of serial walks,
// each step mostly the exchange of h. 8-row tiles that re-read all of W_hh
// from L2 for each tile and step are bound by L2.
//
// Design (the TPU kernel's shape, 512-row programs doing one matrix tile a
// step, rethought for the card): a CTA of 256 threads owns a tile of BT rows
// for all T steps, BT = R x 256/H: thread (rs, j) owns hidden unit j (its
// four gate columns j, H+j, 2H+j, 3H+j) for the R rows rs R .. rs R + R-1 of
// the tile. Rows are independent, so no h crosses a CTA, and at R = 32 B =
// 4096 is 128 CTAs: one wave. Each step:
//   1. the product: 4R float32 accumulators a thread, over k = 0 .. H-1. W_hh
//      is read from L2 (read-only path) straight into registers, 4 values a
//      k, a block of 4 k's ahead (two register blocks in turns; the last
//      block of a step loads the next step's first, W_hh being the same every
//      step), each value used for R rows: at R = 32 the 132 SMs read W_hh
//      from L2 at about 4.2 TB/s at the FMA rate, a quarter of what 8-row
//      tiles need. h is read from shared memory
//      ([k][row], 16-byte loads that every thread of a warp shares);
//   2. the cell update in the thread's own registers, with this step's xg,
//      which a bulk copy (TMA, one instruction of one thread, completing on an
//      mbarrier) brought into shared memory during the product; c stays in
//      shared memory ([row][unit]); h goes to shared memory (for the next
//      step; rows padded by 4 floats so that the 16-byte stores of 8
//      neighbouring units fall in distinct banks) and to ys;
//   3. one barrier before the cell update (every read of h done) and one
//      after it (the new h in place, every read of xg done), after which
//      thread 0 starts the next step's copy of xg.
// At H = 256, the width the rule routes here, H is a compile-time constant:
// the loads' offsets become immediates, and the product's loop is 1024 FMAs
// in 1181 instructions a block of 8 k's (86.7%; 80.6% with H read at run
// time), which took the time at the shape above from 17.2 to 15.5 ms on an
// H100. What holds it at about 60% of the FMA rate is not settled: the card's
// machine has no instruction profiler, and the SM holds its 1.98 GHz clock
// while it runs. Its loads into registers (R + 4 words a k for 4R FMAs; a
// broadcast 16-byte load still delivers 16 bytes to every thread) need, at
// R = 32, about as many clocks of the SM's load path as its FMAs need of the
// FMA pipes, and the times at R = 32, 16 and 8 follow that ratio; but a
// build that spread a thread over 2 units of 16 rows (a third fewer loads a
// FMA, no spills) ran slower, as did the product on the tensor cores under
// 3xTF32 (mma.sync m16n8k8, W_hh staged through shared memory:
// tools/lstm_wave_tf32x3.cu; PERF.md).
// R (rows a thread: 32, 16 or 8, a compile-time length; 128, 64 or 32
// accumulators, so 1, 2 or 3 CTAs an SM) sets the tile: the wrapper
// (lstm_cuda.wave_plan) picks it from B and H so that the grid puts the
// fewest rows on the busiest SM.
// At H = 128 (FN-SSL's full band in training, B = 4768 both directions:
// 9536 rows, 72.2 an SM if spread evenly; bound 4.78 ms of FMAs) the tiles
// of 256/H = 2 row groups put 80 to 128 rows on the busiest SM, and a step
// is half the FMAs a thread does at H = 256 for the same barriers and waits.
// So H = 128 has its own tile, lstm_wave_kernel_h128: a CTA of 128 threads
// (one row group) of R = 37 rows, 148 accumulators a thread and 2 CTAs an SM
// (232 registers, no spills), so that the full band is 258 CTAs in one wave,
// 74 rows on the busiest SM, each W_hh value loaded feeding 37 FMAs. Its
// shared memory holds only h, double-buffered (one barrier a step), and c:
// the step's xg goes from memory straight into the accumulators (4R loads a
// thread, coalesced). Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py
// phase 5, tools/lstm_h128_variants.py; PERF.md): 9.85 ms at the full band
// in float32, 48% of the FMA bound, 9.6 in bfloat16, against 13.5 and 16.7
// on lstm_cluster.cu; a bulk L2 prefetch of the next step's xg cost 0.5 ms,
// a 24-row tile at 3 CTAs an SM ran 12.7 (16.1 in bfloat16). The ragged edge of B is masked, never padded
// by the caller: the copy brings only the valid rows, and a masked row is
// computed on zeros and never stored. All arithmetic is float32 FMAs outside
// the tensor cores, for both xg dtypes; a bfloat16 W_hh halves the L2 reads
// and is widened as it is loaded (one shift a value, each value then used for
// R rows: no unpacking in the product loop). sigmoid and tanh use the fast
// exp, as in lstm_cluster.cu (about 1e-7 from the exact functions).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <set>

namespace {

constexpr int kThreads = 256;         // threads a CTA
constexpr int kPad = 4;               // floats a row of h is padded by
constexpr int kBlock = 4;             // k's of W_hh a register block
constexpr size_t kMaxSmem = 232448;   // shared memory a block may use (227 KB)
constexpr size_t kBarrierSmem = 16;   // of it, the mbarrier (static)

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  const unsigned short bits =
      __ldg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(static_cast<unsigned int>(bits) << 16);
}

// xg staged in shared memory (a plain load: the copy completed)
__device__ __forceinline__ float smem_f(const float* p) { return *p; }

__device__ __forceinline__ float smem_f(const __nv_bfloat16* p) {
  const unsigned short bits = *reinterpret_cast<const unsigned short*>(p);
  return __uint_as_float(static_cast<unsigned int>(bits) << 16);
}

__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }

__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
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
// 16-byte aligned) and counts them on the mbarrier, whose one arrival this
// is. One thread.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Four gates (i, f, g, o) of unit j at row k of W_hh^T, from L2.
template <typename T_in>
__device__ __forceinline__ float4 w_gates(const T_in* w, int k, int j,
                                          int hidden) {
  const T_in* p = w + static_cast<size_t>(k) * 4 * hidden + j;
  return make_float4(load_f(p), load_f(p + hidden), load_f(p + 2 * hidden),
                     load_f(p + 3 * hidden));
}

template <typename T_in>
__device__ __forceinline__ void load_block(float4 (&w)[kBlock],
                                           const T_in* w_hh, int k0, int j,
                                           int hidden) {
#pragma unroll
  for (int e = 0; e < kBlock; ++e) w[e] = w_gates(w_hh, k0 + e, j, hidden);
}

// acc[r][g] += h[k0 + e][r] * w[e].g for the kBlock k's of one block.
template <int R>
__device__ __forceinline__ void fma_block(float (&acc)[R][4],
                                          const float4 (&w)[kBlock],
                                          const float* hrow, int k0,
                                          int pitch) {
#pragma unroll
  for (int e = 0; e < kBlock; ++e) {
    const float* hk = hrow + (k0 + e) * pitch;
#pragma unroll
    for (int q = 0; q < R / 4; ++q) {
      const float4 h4 = *reinterpret_cast<const float4*>(hk + 4 * q);
      const float hv[4] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        float* a = acc[4 * q + v];
        a[0] = fmaf(hv[v], w[e].x, a[0]);
        a[1] = fmaf(hv[v], w[e].y, a[1]);
        a[2] = fmaf(hv[v], w[e].z, a[2]);
        a[3] = fmaf(hv[v], w[e].w, a[3]);
      }
    }
  }
}

// shared memory of one CTA: h [H][BT + pad] and c [BT][H] float32, and this
// step's xg [BT][4H] in xg's dtype
__host__ __device__ constexpr size_t smem_bytes(int hidden, int tile,
                                                int itemsize) {
  return static_cast<size_t>(hidden) * (tile + kPad) * 4 +
         static_cast<size_t>(tile) * hidden * 4 +
         static_cast<size_t>(tile) * 4 * hidden * itemsize;
}

// CTAs an SM is asked to hold at R rows a thread (the registers' budget for
// its 4 R accumulators)
__host__ __device__ constexpr int min_blocks(int rows) {
  return rows <= 8 ? 3 : rows <= 16 ? 2 : 1;
}

// R: rows of the tile a thread owns (8, 16 or 32); HC: H when it is known
// at compile time (256, the width the rule routes here: the loads' offsets
// become immediates and the loop's address arithmetic goes), else 0.
template <typename T_in, int R, int HC>
__global__ void __launch_bounds__(kThreads, min_blocks(R))
lstm_wave_kernel(const T_in* __restrict__ xg, const T_in* __restrict__ w_hh_t,
                 const float* __restrict__ h0, const float* __restrict__ c0,
                 T_in* __restrict__ ys, float* __restrict__ h_t,
                 float* __restrict__ c_t, int t_steps, int batch,
                 int hidden_arg, int reverse) {
  const int hidden = HC ? HC : hidden_arg;
  const int tile = kThreads / hidden * R;  // BT
  const int pitch = tile + kPad;           // floats a row of h
  const int j = threadIdx.x % hidden;      // this thread's unit
  const int r0 = (threadIdx.x / hidden) * R;  // its first row of the tile
  const int dir = blockIdx.y;
  const int b0 = blockIdx.x * tile;
  const int four_h = 4 * hidden;
  const int valid = min(tile, batch - b0);  // rows of the tile inside B
  const bool backward = (reverse ^ dir) != 0;
  const size_t step_len = static_cast<size_t>(batch) * four_h;  // xg per t
  const uint32_t copy_bytes =
      static_cast<uint32_t>(valid) * four_h * sizeof(T_in);

  xg += static_cast<size_t>(dir) * t_steps * step_len +
        static_cast<size_t>(b0) * four_h;
  ys += static_cast<size_t>(dir) * t_steps * batch * hidden;
  w_hh_t += static_cast<size_t>(dir) * hidden * four_h;
  const size_t state_off = static_cast<size_t>(dir) * batch * hidden;
  h0 += state_off;
  c0 += state_off;
  h_t += state_off;
  c_t += state_off;

  extern __shared__ float4 smem4[];
  float* hs = reinterpret_cast<float*>(smem4);           // [H][pitch]
  float* cs = hs + static_cast<size_t>(hidden) * pitch;  // [BT][H]
  T_in* xs = reinterpret_cast<T_in*>(cs + static_cast<size_t>(tile) * hidden);
  __shared__ alignas(8) uint64_t full;  // this step's xg has arrived

  // h0, c0 of the thread's rows; masked rows start from zeros
#pragma unroll 4
  for (int r = 0; r < R; ++r) {
    const int row = r0 + r;
    const bool ok = row < valid;
    const size_t bj = static_cast<size_t>(b0 + row) * hidden + j;
    hs[j * pitch + row] = ok ? h0[bj] : 0.0f;
    cs[row * hidden + j] = ok ? c0[bj] : 0.0f;
  }
  // masked rows of xg stay zeros: the copy brings only the valid rows
  for (int idx = valid * four_h + threadIdx.x; idx < tile * four_h;
       idx += kThreads)
    xs[idx] = T_in(0.0f);
  if (threadIdx.x == 0) {
    mbar_init(&full);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // h0, c0, zeros and the barrier in place
  if (threadIdx.x == 0 && t_steps > 0)
    bulk_copy(xs, xg + (backward ? t_steps - 1 : 0) * step_len, copy_bytes,
              &full);

  const float* hrow = hs + r0;
  float4 w0[kBlock], w1[kBlock];
  load_block(w0, w_hh_t, 0, j, hidden);
  for (int s = 0; s < t_steps; ++s) {
    const int t = backward ? t_steps - 1 - s : s;
    float acc[R][4];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int g = 0; g < 4; ++g) acc[r][g] = 0.0f;
    // the product, two blocks of kBlock k's a turn; the last turn loads
    // the next step's first block
#pragma unroll 1
    for (int k0 = 0; k0 < hidden; k0 += 2 * kBlock) {
      load_block(w1, w_hh_t, k0 + kBlock, j, hidden);
      fma_block<R>(acc, w0, hrow, k0, pitch);
      load_block(w0, w_hh_t, k0 + 2 * kBlock < hidden ? k0 + 2 * kBlock : 0,
                 j, hidden);
      fma_block<R>(acc, w1, hrow, k0 + kBlock, pitch);
    }
    mbar_wait(&full, s & 1);  // this step's xg in xs
    __syncthreads();          // every read of h done

    T_in* ys_t = ys + (static_cast<size_t>(t) * batch + b0) * hidden + j;
#pragma unroll
    for (int q = 0; q < R / 4; ++q) {
      float hv[4];
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int r = 4 * q + v;
        const int row = r0 + r;
        const T_in* x = xs + row * four_h + j;
        const float ig = sigmoid_f(acc[r][0] + smem_f(x));
        const float fg = sigmoid_f(acc[r][1] + smem_f(x + hidden));
        const float gg = tanh_f(acc[r][2] + smem_f(x + 2 * hidden));
        const float og = sigmoid_f(acc[r][3] + smem_f(x + 3 * hidden));
        float* cp = cs + row * hidden + j;
        const float c = fg * *cp + ig * gg;
        *cp = c;
        hv[v] = og * tanh_f(c);
        if (row < valid)
          store_f(ys_t + static_cast<size_t>(row) * hidden, hv[v]);
      }
      *reinterpret_cast<float4*>(hs + j * pitch + r0 + 4 * q) =
          make_float4(hv[0], hv[1], hv[2], hv[3]);
    }
    __syncthreads();  // the new h in place; every read of xs done
    if (threadIdx.x == 0 && s + 1 < t_steps)
      bulk_copy(xs, xg + (backward ? t - 1 : t + 1) * step_len, copy_bytes,
                &full);
  }

#pragma unroll 4
  for (int r = 0; r < R; ++r) {
    const int row = r0 + r;
    if (row < valid) {
      const size_t bj = static_cast<size_t>(b0 + row) * hidden + j;
      h_t[bj] = hs[j * pitch + row];
      c_t[bj] = cs[row * hidden + j];
    }
  }
}

// ---- H = 128: a tile of R rows a CTA of 128 threads (one row group) ----
//
// Thread j owns unit j of the tile's R rows, 2 CTAs an SM. The CTA's shared
// memory holds only h (two buffers, [H][R + pad]) and c ([R][H]): the
// step's xg is loaded by each thread straight into its accumulators (4R
// values, coalesced across the warp) at the top of the step. h is
// double-buffered, so the step has one barrier.
constexpr int kThreads128 = 128;  // threads a CTA at H = 128
constexpr int kRows128 = 37;      // its rows: 2 CTAs an SM (232 registers)

__host__ __device__ constexpr int pitch128(int rows) {
  return (rows + 3) / 4 * 4 + kPad;  // floats a row of h, 16-byte aligned
}

// shared memory of one CTA: two h buffers [H][pitch] and c [R][H], float32
__host__ __device__ constexpr size_t smem_bytes128(int rows) {
  return (2 * static_cast<size_t>(128) * pitch128(rows) +
          static_cast<size_t>(rows) * 128) * 4;
}

// acc[r][g] += h[k0 + e][r] * w[e].g for the kBlock k's of one block, for
// the R rows (a multiple of 4 or not: the last 16-byte load's spare rows
// are padding, never summed)
template <int R>
__device__ __forceinline__ void fma_block128(float (&acc)[R][4],
                                             const float4 (&w)[kBlock],
                                             const float* hs, int k0) {
  constexpr int pitch = pitch128(R);
#pragma unroll
  for (int e = 0; e < kBlock; ++e) {
    const float* hk = hs + (k0 + e) * pitch;
#pragma unroll
    for (int q = 0; q < (R + 3) / 4; ++q) {
      const float4 h4 = *reinterpret_cast<const float4*>(hk + 4 * q);
      const float hv[4] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        if (4 * q + v < R) {
          float* a = acc[4 * q + v];
          a[0] = fmaf(hv[v], w[e].x, a[0]);
          a[1] = fmaf(hv[v], w[e].y, a[1]);
          a[2] = fmaf(hv[v], w[e].z, a[2]);
          a[3] = fmaf(hv[v], w[e].w, a[3]);
        }
      }
    }
  }
}

template <typename T_in, int R>
__global__ void __launch_bounds__(kThreads128, 2)
lstm_wave_kernel_h128(const T_in* __restrict__ xg,
                      const T_in* __restrict__ w_hh_t,
                      const float* __restrict__ h0,
                      const float* __restrict__ c0, T_in* __restrict__ ys,
                      float* __restrict__ h_t, float* __restrict__ c_t,
                      int t_steps, int batch, int reverse) {
  constexpr int hidden = 128, four_h = 4 * hidden, pitch = pitch128(R);
  const int j = threadIdx.x;  // this thread's unit
  const int dir = blockIdx.y;
  const int b0 = blockIdx.x * R;
  const int valid = min(R, batch - b0);  // rows of the tile inside B
  const bool backward = (reverse ^ dir) != 0;
  const size_t step_len = static_cast<size_t>(batch) * four_h;  // xg per t

  xg += static_cast<size_t>(dir) * t_steps * step_len +
        static_cast<size_t>(b0) * four_h;
  ys += static_cast<size_t>(dir) * t_steps * batch * hidden +
        static_cast<size_t>(b0) * hidden + j;
  w_hh_t += static_cast<size_t>(dir) * hidden * four_h;
  const size_t state_off =
      (static_cast<size_t>(dir) * batch + b0) * hidden + j;
  h0 += state_off;
  c0 += state_off;
  h_t += state_off;
  c_t += state_off;

  extern __shared__ float4 smem4[];
  float* hs = reinterpret_cast<float*>(smem4);  // [2][H][pitch]
  float* cs = hs + 2 * hidden * pitch;           // [R][H]

  // h0, c0 of the thread's rows; masked rows start from zeros
#pragma unroll 4
  for (int r = 0; r < R; ++r) {
    const bool ok = r < valid;
    hs[j * pitch + r] = ok ? h0[r * hidden] : 0.0f;
    cs[r * hidden + j] = ok ? c0[r * hidden] : 0.0f;
  }
  __syncthreads();

  float4 w0[kBlock], w1[kBlock];
  load_block(w0, w_hh_t, 0, j, hidden);
  for (int s = 0; s < t_steps; ++s) {
    const int t = backward ? t_steps - 1 - s : s;
    const T_in* x = xg + t * step_len + j;
    float acc[R][4];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int g = 0; g < 4; ++g)
        acc[r][g] = r < valid ? load_f(x + r * four_h + g * hidden) : 0.0f;

    const float* h_in = hs + (s & 1) * hidden * pitch;
#pragma unroll 1
    for (int k0 = 0; k0 < hidden; k0 += 2 * kBlock) {
      load_block(w1, w_hh_t, k0 + kBlock, j, hidden);
      fma_block128<R>(acc, w0, h_in, k0);
      load_block(w0, w_hh_t, k0 + 2 * kBlock < hidden ? k0 + 2 * kBlock : 0,
                 j, hidden);
      fma_block128<R>(acc, w1, h_in, k0 + kBlock);
    }

    // the cell update; the new h goes to the other buffer, which no thread
    // reads before the barrier
    float* h_out = hs + ((s + 1) & 1) * hidden * pitch + j * pitch;
    T_in* ys_t = ys + static_cast<size_t>(t) * batch * hidden;
#pragma unroll
    for (int q = 0; q < (R + 3) / 4; ++q) {
      float hv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int r = 4 * q + v;
        if (r < R) {
          const float ig = sigmoid_f(acc[r][0]);
          const float fg = sigmoid_f(acc[r][1]);
          const float gg = tanh_f(acc[r][2]);
          const float og = sigmoid_f(acc[r][3]);
          float* cp = cs + r * hidden + j;
          const float c = fg * *cp + ig * gg;
          *cp = c;
          hv[v] = og * tanh_f(c);
          if (r < valid) store_f(ys_t + r * hidden, hv[v]);
        }
      }
      *reinterpret_cast<float4*>(h_out + 4 * q) =
          make_float4(hv[0], hv[1], hv[2], hv[3]);
    }
    __syncthreads();  // the new h in place; every read of the old done
  }

  const float* h_last = hs + (t_steps & 1) * hidden * pitch + j * pitch;
#pragma unroll 4
  for (int r = 0; r < R; ++r) {
    if (r < valid) {
      h_t[r * hidden] = h_last[r];
      c_t[r * hidden] = cs[r * hidden + j];
    }
  }
}

struct Args {
  const void* xg;
  const void* w_hh_t;
  const float* h0;
  const float* c0;
  void* ys;
  float* h_t;
  float* c_t;
  int t_steps, batch, hidden, ndir, reverse, device;
};

// The shared memory limit is raised once per kernel instance and device; a
// launch then costs no more host calls than a plain one (and none that a
// CUDA graph capture refuses, once a first launch ran outside one).
template <typename T_in, int R, int HC>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const auto kernel = lstm_wave_kernel<T_in, R, HC>;
  const int tile = kThreads / a.hidden * R;
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
      static_cast<const T_in*>(a.xg), static_cast<const T_in*>(a.w_hh_t), a.h0,
      a.c0, static_cast<T_in*>(a.ys), a.h_t, a.c_t, a.t_steps, a.batch,
      a.hidden, a.reverse);
  return cudaGetLastError();
}

template <typename T_in, int R>
cudaError_t launch128(const Args& a, cudaStream_t stream) {
  const auto kernel = lstm_wave_kernel_h128<T_in, R>;
  {
    static std::mutex mu;
    static std::set<int> raised;
    std::lock_guard<std::mutex> lock(mu);
    if (!raised.count(a.device)) {
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem_bytes128(R)));
      if (err != cudaSuccess) return err;
      raised.insert(a.device);
    }
  }
  const dim3 grid((a.batch + R - 1) / R, a.ndir);
  kernel<<<grid, kThreads128, smem_bytes128(R), stream>>>(
      static_cast<const T_in*>(a.xg), static_cast<const T_in*>(a.w_hh_t), a.h0,
      a.c0, static_cast<T_in*>(a.ys), a.h_t, a.c_t, a.t_steps, a.batch,
      a.reverse);
  return cudaGetLastError();
}

template <typename T_in, int HC>
cudaError_t by_rows(const Args& a, int rows, cudaStream_t s) {
  switch (rows) {
    case 8: return launch<T_in, 8, HC>(a, s);
    case 16: return launch<T_in, 16, HC>(a, s);
    default: return launch<T_in, 32, HC>(a, s);
  }
}

template <typename T_in>
cudaError_t by_width(const Args& a, int rows, cudaStream_t s) {
  if (rows == kRows128) return launch128<T_in, kRows128>(a, s);
  return a.hidden == 256 ? by_rows<T_in, 256>(a, rows, s)
                         : by_rows<T_in, 0>(a, rows, s);
}

}  // namespace

// Plain C entry point (bound with ctypes). Runs ndir directions (1 or 2) of
// one recurrence in one launch, `rows` (8, 16 or 32; at H = 128 also 37, the
// 128-thread tile) batch rows a thread, on `stream` of device `device`;
// does not synchronise, allocates nothing, and
// returns the cudaError_t of the launch (0 on success). H must be a multiple
// of 32 that divides 256 (32, 64, 128 or 256: the row groups of a CTA) and xg
// 16-byte aligned (the bulk copies); other arguments are refused with an
// error, never run another way.
extern "C" int lstm_wave(const void* xg, const void* w_hh_t, const void* h0,
                         const void* c0, void* ys, void* h_t, void* c_t,
                         int t_steps, int batch, int hidden, int ndir,
                         int reverse, int is_bf16, int rows, int device,
                         void* stream) {
  const bool h128 = hidden == 128 && rows == kRows128;
  if (hidden < 32 || hidden > kThreads || kThreads % hidden != 0 ||
      batch < 1 || t_steps < 0 || (ndir != 1 && ndir != 2) ||
      (rows != 8 && rows != 16 && rows != 32 && !h128) ||
      reinterpret_cast<uintptr_t>(xg) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tile = kThreads / hidden * rows;
  if (!h128 &&
      smem_bytes(hidden, tile, is_bf16 ? 2 : 4) > kMaxSmem - kBarrierSmem)
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
               device};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = is_bf16 ? by_width<__nv_bfloat16>(a, rows, s)
                : by_width<float>(a, rows, s);
  return static_cast<int>(err);
}

extern "C" const char* lstm_wave_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
