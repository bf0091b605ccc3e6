// The backward recurrence of an LSTM layer (K2): one or both directions.
//
// Replaces the sequential part of fnssl_tpu/kernels/lstm_pallas.py:
// _lstm_backward, the custom_vjp backward of the TPU kernel _lstm_kernel
// (a lax.scan in JAX). Its replay of c (:300-307) and its bwd_step
// (:309-330) without the weight sums, which stay large matrix products
// outside (models/lstm.py). Per direction, in the forward's walk order:
//   g (T, B, 4H) float32: the gate pre-activations
//        x_t @ W_ih^T + b + h_{t-1} @ W_hh^T, computed outside; on return
//        it holds dgates (in place);
//   w_hh (4H, H) in the dtype of ys (float32 or bfloat16), products in
//        float32;  c0, dhT, dcT (B, H) float32;  dys (T, B, H) in the dtype
//        of ys;  cs (T, B, H) float32 scratch;  out dh0, dc0 (B, H) float32.
//   Phase 1 (replay): c_t = sig(f) c_{t-1} + sig(i) tanh(g), stored in cs.
//   Phase 2 (reverse walk), from the last walk step to the first:
//     dh_tot = dy_t + dh;  dct = dc + dh_tot o (1 - tanh^2 c_t);
//     dgates_t = [dct g i (1-i), dct c_{t-1} f (1-f), dct i (1-g^2),
//                 dh_tot tanh(c_t) o (1-o)]  (torch order i, f, g, o);
//     dh = dgates_t @ W_hh;  dc = dct f.
//   A direction whose forward walked t = T-1 .. 0 (reverse) walks
//   t = 0 .. T-1 here; its c_{t-1} is cs[t+1] (c0 at t = T-1).
//   h_{t-1} enters only g and dW_hh, both outside, so ys is not read here.
//
// What bounds it on an H100: every step's serial product dgates_t @ W_hh,
// (B x 4H) by (4H x H), 2 B 4H H FLOPs; at the narrow-band training shape
// (T=298, B=4096, H=256) that is 640 GFLOP a direction, 9.5 ms at the
// 67 TFLOP/s of float32 FMAs outside the tensor cores. Bytes: g read
// twice and dgates written once (5 GB each at that shape), 1.7 ms at
// 3.35 TB/s. So operations bound it, provided W_hh (1 MB at H = 256 in
// float32) reaches the FMAs fast enough: it does not fit one SM's shared
// memory, so every block re-reads it from L2 on every step.
//
// Design (simple and right first): one block per tile of TB = 16 batch
// rows, with KS x H threads (KS = 512 / H). Phase 1 is elementwise per
// (row, unit); thread (ks, j) replays rows ks*TB/KS .. of unit j and keeps
// their c in registers. In phase 2 the same thread turns those rows' gates
// into dgates, writes them over g and into shared memory, and keeps their
// dh and dc in registers. The step's product is k-split as in lstm_fwd.cu:
// thread (ks, k) sums dh[r, k] for all TB rows over its slice ks of the 4H
// gate columns, reading W_hh[col, k] through L2 (coalesced over k) once per
// block and step, and dgates[r, col..col+3] from shared memory as float4
// broadcasts; the KS partial sums meet in shared memory. Two __syncthreads
// a step. A 16-row tile halves the L2 traffic of W_hh against the
// forward's 8 rows, with TB accumulators a thread. The ragged edge of B is
// masked here, not padded by the caller. Both directions of a BiLSTM run
// in one launch (blockIdx.y = direction). Serves H a multiple of 32 up to
// 256: every LSTM of the JAX package.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;      // TB: batch rows per block
constexpr int kThreads = 512;  // KS x H

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  const unsigned short bits =
      __ldg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(static_cast<unsigned int>(bits) << 16);
}

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

template <typename T_in, int KS>
__global__ void __launch_bounds__(kThreads)
lstm_bwd_kernel(float* __restrict__ g, float* __restrict__ cs,
                const T_in* __restrict__ w_hh, const float* __restrict__ c0,
                const T_in* __restrict__ dys, const float* __restrict__ dh_t,
                const float* __restrict__ dc_t, float* __restrict__ dh0,
                float* __restrict__ dc0, int t_steps, int batch, int hidden,
                int reverse) {
  constexpr int TB = kTile;
  constexpr int RPT = TB / KS;  // rows of the tile a thread owns
  extern __shared__ float4 smem4[];
  const int four_h = 4 * hidden;
  float* dg = reinterpret_cast<float*>(smem4);  // [TB][4H]: dgates_t
  float* part = dg + TB * four_h;               // [KS][TB][H]: partial dh
  const int j = threadIdx.x % hidden;
  const int ks = threadIdx.x / hidden;
  const int r_begin = ks * RPT;
  const int b0 = blockIdx.x * TB;
  // direction blockIdx.y: with two, direction 1 walked t = T-1 .. 0
  const int dir = blockIdx.y;
  const bool rev = reverse != 0 || dir == 1;
  const size_t gate_step = static_cast<size_t>(batch) * four_h;
  const size_t unit_step = static_cast<size_t>(batch) * hidden;
  g += dir * t_steps * gate_step;
  cs += dir * t_steps * unit_step;
  dys += dir * t_steps * unit_step;
  w_hh += static_cast<size_t>(dir) * four_h * hidden;
  c0 += dir * unit_step;
  dh_t += dir * unit_step;
  dc_t += dir * unit_step;
  dh0 += dir * unit_step;
  dc0 += dir * unit_step;

  // phase 1: replay c in the forward's walk order
  float c[RPT];
#pragma unroll
  for (int q = 0; q < RPT; ++q) {
    const int b = b0 + r_begin + q;
    c[q] = b < batch ? c0[static_cast<size_t>(b) * hidden + j] : 0.0f;
  }
  for (int s = 0; s < t_steps; ++s) {
    const int t = rev ? t_steps - 1 - s : s;
#pragma unroll
    for (int q = 0; q < RPT; ++q) {
      const int b = b0 + r_begin + q;
      if (b < batch) {
        const float* gr = g + t * gate_step + static_cast<size_t>(b) * four_h
                          + j;
        c[q] = sigmoid_f(gr[hidden]) * c[q]
               + sigmoid_f(gr[0]) * tanhf(gr[2 * hidden]);
        cs[t * unit_step + static_cast<size_t>(b) * hidden + j] = c[q];
      }
    }
  }

  // phase 2: the reverse walk; c[q] holds c_t of the step being undone
  float dh[RPT], dc[RPT];
#pragma unroll
  for (int q = 0; q < RPT; ++q) {
    const int b = b0 + r_begin + q;
    const size_t bj = static_cast<size_t>(b) * hidden + j;
    dh[q] = b < batch ? dh_t[bj] : 0.0f;
    dc[q] = b < batch ? dc_t[bj] : 0.0f;
  }
  const int k_len = four_h / KS;  // gate columns of this thread's slice
  const int col_begin = ks * k_len;
  for (int s = t_steps - 1; s >= 0; --s) {
    const int t = rev ? t_steps - 1 - s : s;
    const int t_prev = rev ? t + 1 : t - 1;  // the walk's previous step
#pragma unroll
    for (int q = 0; q < RPT; ++q) {
      const int r = r_begin + q;
      const int b = b0 + r;
      float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (b < batch) {
        const size_t bj = static_cast<size_t>(b) * hidden + j;
        float* gr = g + t * gate_step + static_cast<size_t>(b) * four_h + j;
        const float ig = sigmoid_f(gr[0]);
        const float fg = sigmoid_f(gr[hidden]);
        const float gg = tanhf(gr[2 * hidden]);
        const float og = sigmoid_f(gr[3 * hidden]);
        const float cp = s > 0 ? cs[t_prev * unit_step + bj] : c0[bj];
        const float tc = tanhf(c[q]);
        const float dht = load_f(dys + t * unit_step + bj) + dh[q];
        const float dct = dc[q] + dht * og * (1.0f - tc * tc);
        d[0] = dct * gg * ig * (1.0f - ig);
        d[1] = dct * cp * fg * (1.0f - fg);
        d[2] = dct * ig * (1.0f - gg * gg);
        d[3] = dht * tc * og * (1.0f - og);
#pragma unroll
        for (int e = 0; e < 4; ++e) gr[e * hidden] = d[e];
        dc[q] = dct * fg;
        c[q] = cp;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) dg[r * four_h + e * hidden + j] = d[e];
    }
    __syncthreads();  // dgates_t in shared memory; last step's part read

    float acc[TB];
#pragma unroll
    for (int r = 0; r < TB; ++r) acc[r] = 0.0f;
#pragma unroll 4
    for (int col = col_begin; col < col_begin + k_len; col += 4) {
      const T_in* wcol = w_hh + static_cast<size_t>(col) * hidden + j;
      const float w0 = load_f(wcol);
      const float w1 = load_f(wcol + hidden);
      const float w2 = load_f(wcol + 2 * hidden);
      const float w3 = load_f(wcol + 3 * hidden);
#pragma unroll
      for (int r = 0; r < TB; ++r) {
        const float4 v = *reinterpret_cast<const float4*>(dg + r * four_h
                                                          + col);
        acc[r] = fmaf(v.x, w0, acc[r]);
        acc[r] = fmaf(v.y, w1, acc[r]);
        acc[r] = fmaf(v.z, w2, acc[r]);
        acc[r] = fmaf(v.w, w3, acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < TB; ++r) part[(ks * TB + r) * hidden + j] = acc[r];
    __syncthreads();  // partial sums written; every read of dg is done

#pragma unroll
    for (int q = 0; q < RPT; ++q) {
      const int r = r_begin + q;
      float sum = 0.0f;
#pragma unroll
      for (int p = 0; p < KS; ++p) sum += part[(p * TB + r) * hidden + j];
      dh[q] = sum;
    }
  }

#pragma unroll
  for (int q = 0; q < RPT; ++q) {
    const int b = b0 + r_begin + q;
    if (b < batch) {
      const size_t bj = static_cast<size_t>(b) * hidden + j;
      dh0[bj] = dh[q];
      dc0[bj] = dc[q];
    }
  }
}

template <typename T_in, int KS>
cudaError_t launch(float* g, float* cs, const void* w_hh, const float* c0,
                   const void* dys, const float* dh_t, const float* dc_t,
                   float* dh0, float* dc0, int t_steps, int batch, int hidden,
                   int ndir, int reverse, cudaStream_t stream) {
  const auto kernel = lstm_bwd_kernel<T_in, KS>;
  // dgates [TB][4H] and KS partial dh [TB][H], float32 (at most 96 KB)
  const size_t smem =
      static_cast<size_t>(kTile) * hidden * sizeof(float) * (4 + KS);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((batch + kTile - 1) / kTile, ndir);
  kernel<<<grid, KS * hidden, smem, stream>>>(
      g, cs, static_cast<const T_in*>(w_hh), c0,
      static_cast<const T_in*>(dys), dh_t, dc_t, dh0, dc0, t_steps, batch,
      hidden, reverse);
  return cudaGetLastError();
}

// The k-split: as many thread groups as keep a block at <= 512 threads.
template <typename T_in>
cudaError_t dispatch(float* g, float* cs, const void* w_hh, const float* c0,
                     const void* dys, const float* dh_t, const float* dc_t,
                     float* dh0, float* dc0, int t_steps, int batch,
                     int hidden, int ndir, int reverse, cudaStream_t stream) {
#define LSTM_BWD_LAUNCH(KS)                                                 \
  return launch<T_in, KS>(g, cs, w_hh, c0, dys, dh_t, dc_t, dh0, dc0,       \
                          t_steps, batch, hidden, ndir, reverse, stream)
  if (hidden <= 32) LSTM_BWD_LAUNCH(16);
  if (hidden <= 64) LSTM_BWD_LAUNCH(8);
  if (hidden <= 128) LSTM_BWD_LAUNCH(4);
  LSTM_BWD_LAUNCH(2);
#undef LSTM_BWD_LAUNCH
}

}  // namespace

// Plain C entry point (bound with ctypes). Every tensor carries `ndir`
// directions stacked in front; with ndir = 2 direction 1 is the one that
// walked t = T-1 .. 0, with ndir = 1 `reverse` says so. Launches on
// `stream` of device `device`, does not synchronise, allocates nothing,
// and returns the cudaError_t of the launch (0 on success).
extern "C" int lstm_bwd(void* g, void* cs, const void* w_hh, const void* c0,
                        const void* dys, const void* dh_t, const void* dc_t,
                        void* dh0, void* dc0, int t_steps, int batch,
                        int hidden, int ndir, int reverse, int is_bf16,
                        int device, void* stream) {
  if (hidden < 32 || hidden % 32 != 0 || hidden > 256 || batch < 1 ||
      t_steps < 0 || ndir < 1 || ndir > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  float* gf = static_cast<float*>(g);
  float* csf = static_cast<float*>(cs);
  const float* c0f = static_cast<const float*>(c0);
  const float* dhtf = static_cast<const float*>(dh_t);
  const float* dctf = static_cast<const float*>(dc_t);
  float* dh0f = static_cast<float*>(dh0);
  float* dc0f = static_cast<float*>(dc0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = is_bf16
            ? dispatch<__nv_bfloat16>(gf, csf, w_hh, c0f, dys, dhtf, dctf,
                                      dh0f, dc0f, t_steps, batch, hidden,
                                      ndir, reverse, s)
            : dispatch<float>(gf, csf, w_hh, c0f, dys, dhtf, dctf, dh0f,
                              dc0f, t_steps, batch, hidden, ndir, reverse, s);
  return static_cast<int>(err);
}

extern "C" const char* lstm_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
