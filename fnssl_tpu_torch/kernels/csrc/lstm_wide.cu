// LSTM recurrence over T steps (K1) for 256 < H <= 1024: FN-SSL at
// hidden_size 512 (narrow-band LSTMs of H = 512). A CTA walks a tile of many
// batch rows through all T steps, its step product a register-tiled
// (rows x H) @ (H x 4H) matrix tile, taken in passes of 256 hidden units.
//
// Replaces fnssl_tpu/kernels/lstm_pallas.py:_lstm_kernel (the TPU kernel
// launched by _lstm_pallas_fwd) above H = 256: lstm_cuda.fwd_route sends
// every such H here. The contract of lstm_wave.cu, per direction d of ndir
// (1 or 2), but for W_hh's layout:
//   xg (ndir, T, B, 4H) float32 or bfloat16, the input gates x @ W_ih^T + b;
//   w4 (ndir, H, H, 4) in the dtype of xg: W_hh^T with each unit's four gate
//   columns side by side, w4[d, k, j, g] = w_hh_t[d, k, g H + j] (the
//   wrapper interleaves it);  h0, c0 (ndir, B, H) float32.
//   Per step: gates = xg_t + h @ w_hh_t (float32 accumulation), torch gate
//   order i, f, g, o; c = sig(f) c + sig(i) tanh(g); h = sig(o) tanh(c).
//   (h, c) stay float32 for all T. Direction d walks backwards (t = T-1 .. 0,
//   ys[t] written in place, no flip) when reverse ^ d is 1, so a two-direction
//   launch with reverse = 0 is a BiLSTM. ys (ndir, T, B, H) in the dtype of
//   xg; hT, cT (ndir, B, H) float32.
//
// What bounds it on an H100: its FLOPs. A step is B H 4H float32 FMAs (at
// T = 298, B = 4096, H = 512: 38.2 ms at the card's 67 TFLOP/s), while the
// bytes it must move (xg once, ys once, W_hh once) take 3.7 ms. W_hh (4 MB
// in float32 at H = 512) fits no SM's shared memory, so each CTA reads it
// from L2 on every step, and what a value read buys is the rows of the tile
// it is used for. lstm_wave.cu lays 256/H row groups of one unit a thread on
// a CTA of 256 threads and stops at H = 256.
//
// Design (lstm_wave.cu's one-wave tile, widened): a CTA of 256 threads owns
// a tile of R rows for all T steps; rows are independent, so no h crosses a
// CTA. Thread j owns hidden unit j + 256 p (its four gate columns) of all R
// rows in pass p = 0 .. ceil(H / 256) - 1; in the last pass the threads whose
// unit lies past H (whole warps: H is a multiple of 32) sit out. Each pass:
//   1. this step's xg of the thread's unit goes from memory straight into its
//      4R accumulators (coalesced across the warp: a 32 x 4H xg stage would
//      not fit shared memory beside h);
//   2. the product over k = 0 .. H-1: W_hh is read from L2 (read-only path)
//      straight into registers, the unit's 4 gates of a k in one 16-byte
//      load (w4's layout), a block of 4 k's ahead (two register blocks in
//      turns; the last block of a pass loads the next pass's first, or the
//      next step's), each value used for R rows; h_{t-1} is read from
//      shared memory ([k][row], 16-byte loads that every thread of a warp
//      shares);
//   3. the cell update in the thread's own registers; c stays in shared
//      memory ([row][unit]); h_t goes to the other h buffer (rows padded by 4
//      floats so that the 16-byte stores of 8 neighbouring units fall in
//      distinct banks) and to ys.
// h is double-buffered, so every pass of a step reads h_{t-1} from one buffer
// while h_t goes to the other, and a step has one barrier.
// At H = 512 and R = 32: 2 passes of 128 accumulators a thread (the register
// budget of lstm_wave.cu's 32-row tile at H = 256, one CTA an SM), each W_hh
// value loaded feeding 32 FMAs; shared memory 2 x 512 x 36 x 4 + 32 x 512 x 4
// = 208 KB; B = 4096 is 128 CTAs, one wave, 32 rows on the busiest SM
// (31.03 if spread evenly); the 128 SMs read W_hh from L2 at 4 MB x 298 x
// 128 = 156 GB, a quarter of what 8-row tiles would read. At H = 512
// H is a compile-time constant (HC), as lstm_wave.cu's H = 256: the loads'
// offsets become immediates. What W_hh's loads cost, on an H100 80GB HBM3
// at 700 W (tools/lstm_wide_variants.py; PERF.md): with W_hh^T as given,
// four 4-byte loads a k from four rows, a launch at (298, 4096, 512) took
// 79.5 ms in float32 (68.9 in bfloat16), and 56.0 with its W_hh loads cut;
// with w4's one 16-byte load, 62.1 (65.8): the count of loads, not their
// bytes, held it. R (32, 16, 8 or 4, a compile-time length; 1,
// 2, 3 and 3 CTAs an SM by the registers' budget) sets the tile: the wrapper
// (lstm_cuda.wide_plan) picks it from B, H and the shared memory (2 H (R + 4)
// 4 + R H 4 bytes within 227 KB: R = 32 up to H = 544, 16 up to 1024) so
// that the grid puts the fewest rows on the busiest SM; at small B that is 4
// rows, spreading the step over the most SMs. The ragged edge of B is
// masked, never padded by the caller: a masked row is computed on zeros and
// never stored. All arithmetic is float32 FMAs outside the tensor cores, for
// both xg dtypes; a bfloat16 W_hh halves the L2 reads and is widened as it
// is loaded (a shift or a mask a value, each value then used for R rows).
// sigmoid and tanh use the fast exp, as in the sibling kernels (about 1e-7
// from the exact functions).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <set>

namespace {

constexpr int kThreads = 256;        // threads a CTA: one unit each a pass
constexpr int kPad = 4;              // floats a row of h is padded by
constexpr int kBlock = 4;            // k's of W_hh a register block
constexpr int kMinHidden = 288;      // H: above lstm_wave.cu's 256 ..
constexpr int kMaxHidden = 1024;     // .. up to 1024, multiples of 32
constexpr size_t kMaxSmem = 232432;  // shared memory a block may use

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

__device__ __forceinline__ float sigmoid_f(float x) {
  return __fdividef(1.0f, 1.0f + __expf(-x));
}

__device__ __forceinline__ float tanh_f(float x) {
  return 2.0f * sigmoid_f(2.0f * x) - 1.0f;
}

// Four gates (i, f, g, o) of unit u at row k of W_hh^T, from L2: the
// wrapper stores W_hh^T [k][unit][gate], so that they are one 16-byte load
// (8 bytes in bfloat16, widened here).
__device__ __forceinline__ float4 w_gates(const float* w, int k, int u,
                                          int hidden) {
  return __ldg(reinterpret_cast<const float4*>(w) +
               static_cast<size_t>(k) * hidden + u);
}

__device__ __forceinline__ float4 w_gates(const __nv_bfloat16* w, int k,
                                          int u, int hidden) {
  const uint2 v = __ldg(reinterpret_cast<const uint2*>(w) +
                        static_cast<size_t>(k) * hidden + u);
  return make_float4(__uint_as_float(v.x << 16),
                     __uint_as_float(v.x & 0xffff0000u),
                     __uint_as_float(v.y << 16),
                     __uint_as_float(v.y & 0xffff0000u));
}

template <typename T_in>
__device__ __forceinline__ void load_block(float4 (&w)[kBlock],
                                           const T_in* w_hh, int k0, int u,
                                           int hidden) {
#pragma unroll
  for (int e = 0; e < kBlock; ++e) w[e] = w_gates(w_hh, k0 + e, u, hidden);
}

// acc[r][g] += h[k0 + e][r] * w[e].g for the kBlock k's of one block
template <int R>
__device__ __forceinline__ void fma_block(float (&acc)[R][4],
                                          const float4 (&w)[kBlock],
                                          const float* hs, int k0) {
  constexpr int pitch = R + kPad;
#pragma unroll
  for (int e = 0; e < kBlock; ++e) {
    const float* hk = hs + (k0 + e) * pitch;
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

// shared memory of one CTA: two h buffers [H][R + pad] and c [R][H], float32
__host__ __device__ constexpr size_t smem_bytes(int hidden, int rows) {
  return (2 * static_cast<size_t>(hidden) * (rows + kPad) +
          static_cast<size_t>(rows) * hidden) * 4;
}

// CTAs an SM is asked to hold at R rows (the registers' budget for the 4 R
// accumulators)
__host__ __device__ constexpr int min_blocks(int rows) {
  return rows <= 8 ? 3 : rows <= 16 ? 2 : 1;
}

// R: rows of the tile (32, 16, 8 or 4); HC: H when it is known at compile
// time (512, FN-SSL's width), else 0.
template <typename T_in, int R, int HC>
__global__ void __launch_bounds__(kThreads, min_blocks(R))
lstm_wide_kernel(const T_in* __restrict__ xg, const T_in* __restrict__ w4,
                 const float* __restrict__ h0, const float* __restrict__ c0,
                 T_in* __restrict__ ys, float* __restrict__ h_t,
                 float* __restrict__ c_t, int t_steps, int batch,
                 int hidden_arg, int reverse) {
  constexpr int pitch = R + kPad;  // floats a row of h
  const int hidden = HC ? HC : hidden_arg;
  const int four_h = 4 * hidden;
  const int tid = threadIdx.x;
  const int dir = blockIdx.y;
  const int b0 = blockIdx.x * R;
  const int valid = min(R, batch - b0);  // rows of the tile inside B
  const bool backward = (reverse ^ dir) != 0;
  const size_t step_len = static_cast<size_t>(batch) * four_h;  // xg per t

  xg += static_cast<size_t>(dir) * t_steps * step_len +
        static_cast<size_t>(b0) * four_h;
  ys += (static_cast<size_t>(dir) * t_steps * batch + b0) * hidden;
  w4 += static_cast<size_t>(dir) * hidden * four_h;
  const size_t state_off = (static_cast<size_t>(dir) * batch + b0) * hidden;
  h0 += state_off;
  c0 += state_off;
  h_t += state_off;
  c_t += state_off;

  extern __shared__ float4 smem4[];
  float* hs = reinterpret_cast<float*>(smem4);  // [2][H][pitch]
  float* cs = hs + 2 * hidden * pitch;           // [R][H]

  // h0, c0 of the tile; masked rows start from zeros
  for (int u = tid; u < hidden; u += kThreads) {
#pragma unroll 4
    for (int r = 0; r < R; ++r) {
      const bool ok = r < valid;
      hs[u * pitch + r] = ok ? h0[r * hidden + u] : 0.0f;
      cs[r * hidden + u] = ok ? c0[r * hidden + u] : 0.0f;
    }
  }
  __syncthreads();

  float4 w0[kBlock], w1[kBlock];
  load_block(w0, w4, 0, tid, hidden);
  for (int s = 0; s < t_steps; ++s) {
    const int t = backward ? t_steps - 1 - s : s;
    const T_in* x_t = xg + t * step_len;
    const float* h_in = hs + (s & 1) * hidden * pitch;
    float* h_out = hs + ((s + 1) & 1) * hidden * pitch;
    T_in* ys_t = ys + static_cast<size_t>(t) * batch * hidden;
#pragma unroll 1
    for (int u = tid; u < hidden; u += kThreads) {
      // the unit whose first block the pass's last turn loads: the next
      // pass's, else the next step's first
      const int next = u + kThreads < hidden ? u + kThreads : tid;
      float acc[R][4];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int g = 0; g < 4; ++g)
          acc[r][g] =
              r < valid ? load_f(x_t + r * four_h + g * hidden + u) : 0.0f;
#pragma unroll 1
      for (int k0 = 0; k0 < hidden; k0 += 2 * kBlock) {
        load_block(w1, w4, k0 + kBlock, u, hidden);
        fma_block<R>(acc, w0, h_in, k0);
        const bool last = k0 + 2 * kBlock >= hidden;
        load_block(w0, w4, last ? 0 : k0 + 2 * kBlock, last ? next : u,
                   hidden);
        fma_block<R>(acc, w1, h_in, k0 + kBlock);
      }

      // the cell update; the new h goes to the other buffer, which no
      // thread reads before the barrier
#pragma unroll
      for (int q = 0; q < R / 4; ++q) {
        float hv[4];
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int r = 4 * q + v;
          const float ig = sigmoid_f(acc[r][0]);
          const float fg = sigmoid_f(acc[r][1]);
          const float gg = tanh_f(acc[r][2]);
          const float og = sigmoid_f(acc[r][3]);
          float* cp = cs + r * hidden + u;
          const float c = fg * *cp + ig * gg;
          *cp = c;
          hv[v] = og * tanh_f(c);
          if (r < valid) store_f(ys_t + r * hidden + u, hv[v]);
        }
        *reinterpret_cast<float4*>(h_out + u * pitch + 4 * q) =
            make_float4(hv[0], hv[1], hv[2], hv[3]);
      }
    }
    __syncthreads();  // the new h in place; every read of the old done
  }

  const float* h_last = hs + (t_steps & 1) * hidden * pitch;
  for (int u = tid; u < hidden; u += kThreads) {
#pragma unroll 4
    for (int r = 0; r < R; ++r) {
      if (r < valid) {
        h_t[r * hidden + u] = h_last[u * pitch + r];
        c_t[r * hidden + u] = cs[r * hidden + u];
      }
    }
  }
}

struct Args {
  const void* xg;
  const void* w4;
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
  const auto kernel = lstm_wide_kernel<T_in, R, HC>;
  {
    static std::mutex mu;
    static std::set<int> raised;
    std::lock_guard<std::mutex> lock(mu);
    if (!raised.count(a.device)) {
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(kMaxSmem));
      if (err != cudaSuccess) return err;
      raised.insert(a.device);
    }
  }
  const dim3 grid((a.batch + R - 1) / R, a.ndir);
  kernel<<<grid, kThreads, smem_bytes(a.hidden, R), stream>>>(
      static_cast<const T_in*>(a.xg), static_cast<const T_in*>(a.w4), a.h0,
      a.c0, static_cast<T_in*>(a.ys), a.h_t, a.c_t, a.t_steps, a.batch,
      a.hidden, a.reverse);
  return cudaGetLastError();
}

template <typename T_in, int HC>
cudaError_t by_rows(const Args& a, int rows, cudaStream_t s) {
  switch (rows) {
    case 4: return launch<T_in, 4, HC>(a, s);
    case 8: return launch<T_in, 8, HC>(a, s);
    case 16: return launch<T_in, 16, HC>(a, s);
    default: return launch<T_in, 32, HC>(a, s);
  }
}

template <typename T_in>
cudaError_t by_width(const Args& a, int rows, cudaStream_t s) {
  return a.hidden == 512 ? by_rows<T_in, 512>(a, rows, s)
                         : by_rows<T_in, 0>(a, rows, s);
}

}  // namespace

// Plain C entry point (bound with ctypes). Runs ndir directions (1 or 2) of
// one recurrence in one launch, tiles of `rows` (32, 16, 8 or 4) batch rows,
// on `stream` of device `device`; does not synchronise, allocates nothing,
// and returns the cudaError_t of the launch (0 on success). H must be a
// multiple of 32 from 288 to 1024, the tile's shared memory within 227 KB
// and w4 16-byte aligned (its 16-byte loads); other arguments are refused
// with an error, never run another way.
extern "C" int lstm_wide(const void* xg, const void* w4, const void* h0,
                         const void* c0, void* ys, void* h_t, void* c_t,
                         int t_steps, int batch, int hidden, int ndir,
                         int reverse, int is_bf16, int rows, int device,
                         void* stream) {
  if (hidden < kMinHidden || hidden > kMaxHidden || hidden % 32 != 0 ||
      batch < 1 || t_steps < 0 || (ndir != 1 && ndir != 2) ||
      (rows != 4 && rows != 8 && rows != 16 && rows != 32))
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(w4) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (smem_bytes(hidden, rows) > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a{xg,
               w4,
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

extern "C" const char* lstm_wide_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
