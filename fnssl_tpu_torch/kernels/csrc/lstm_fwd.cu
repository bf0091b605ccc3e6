// One LSTM direction over T steps: the recurrence half of an LSTM layer.
//
// Replaces fnssl_tpu/kernels/lstm_pallas.py:_lstm_kernel (the TPU kernel
// launched by _lstm_pallas_fwd). Same contract:
//   xg (T, B, 4H) float32 or bfloat16, the input gates x @ W_ih^T + b,
//        computed outside by one large matrix product;
//   w_hh_t (H, 4H) in the dtype of xg;  h0, c0 (B, H) float32.
//   Per step: gates = xg_t + h @ w_hh_t (float32 accumulation), torch gate
//   order i, f, g, o; c = sig(f) c + sig(i) tanh(g); h = sig(o) tanh(c).
//   (h, c) stay float32 for all T. reverse walks t = T-1 .. 0 and writes
//   ys[t] in place (no flip). ys (T, B, H) in the dtype of xg; hT, cT
//   (B, H) float32.
//
// What bounds it on an H100: the bytes the function must move (xg once,
// ys once, W_hh once) and its FLOPs (2 B H 4H per step) are small, and
// its steps are serial. Each step is a (TB x H) @ (H x 4H) product whose
// weight operand does not fit one SM's shared memory at H = 256 (1 MB in
// float32, 512 KB in bfloat16) nor at H = 128 in float32 (256 KB). So a
// block re-reads W_hh from L2 on every step, and a step costs the larger
// of one SM's float32 FMA time (TB H 4H FMAs at 128 a clock) and its L2
// read time (H 4H itemsize bytes at about 64 B a clock). At TB = 8 in
// float32 the two are about equal.
//
// Design (simple and right first): one block per tile of TB = 8 batch
// rows, with KS x H threads. Thread (ks, j) sums the four gate columns
// (j, H+j, 2H+j, 3H+j) of every row of the tile over its slice ks of the
// hidden dimension (the k-split), so the tile's product has KS times more
// warps in flight to hide the L2 latency of W_hh, which is read with __ldg
// and coalesced across the warp. The KS partial sums meet in shared
// memory; thread (ks, j) then finishes rows ks*TB/KS .. of unit j and
// keeps their c in registers. h lives in shared memory. Two __syncthreads
// a step. The ragged edge of B is masked here, not padded by the caller.
// This file now serves H above 256 (up to 1024). lstm_cluster.cu, which
// keeps W_hh in a thread-block cluster's shared memory, serves H up to 256:
// every LSTM of the JAX package.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kTile = 8;  // TB: batch rows per block

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
  return 1.0f / (1.0f + expf(-x));
}

// TB: batch rows per block; KS: the k-split (thread groups per block);
// MAXT: the most threads (KS * H) it is launched with, so that the compiler
// budgets registers for them.
template <typename T_in, int TB, int KS, int MAXT>
__global__ void __launch_bounds__(MAXT)
lstm_fwd_kernel(const T_in* __restrict__ xg, const T_in* __restrict__ w_hh_t,
                const float* __restrict__ h0, const float* __restrict__ c0,
                T_in* __restrict__ ys, float* __restrict__ h_t,
                float* __restrict__ c_t, int t_steps, int batch, int hidden,
                int reverse) {
  constexpr int RPT = TB / KS;  // rows of the tile a thread finishes
  extern __shared__ float4 smem4[];
  float* hs = reinterpret_cast<float*>(smem4);  // [hidden][TB]: h
  float* part = hs + hidden * TB;  // [KS][4][TB][hidden]: partial gates
  const int j = threadIdx.x % hidden;
  const int ks = threadIdx.x / hidden;
  const int k_len = hidden / KS;
  const int k_begin = ks * k_len;
  const int r_begin = ks * RPT;
  const int b0 = blockIdx.x * TB;
  const int four_h = 4 * hidden;

  float c[RPT];
#pragma unroll
  for (int q = 0; q < RPT; ++q) {
    const int r = r_begin + q;
    const bool valid = b0 + r < batch;
    const size_t bj = static_cast<size_t>(b0 + r) * hidden + j;
    c[q] = valid ? c0[bj] : 0.0f;
    hs[j * TB + r] = valid ? h0[bj] : 0.0f;
  }
  __syncthreads();

  for (int s = 0; s < t_steps; ++s) {
    const int t = reverse ? t_steps - 1 - s : s;
    // this step's input gates for the rows this thread finishes, loaded
    // first so that their latency overlaps the product
    float xv[RPT][4];
#pragma unroll
    for (int q = 0; q < RPT; ++q) {
      const int b = b0 + r_begin + q;
      const T_in* row = xg + (static_cast<size_t>(t) * batch + b) * four_h + j;
#pragma unroll
      for (int g = 0; g < 4; ++g)
        xv[q][g] = b < batch ? load_f(row + g * hidden) : 0.0f;
    }

    float acc[4][TB];
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int r = 0; r < TB; ++r) acc[g][r] = 0.0f;
#pragma unroll 4
    for (int k = k_begin; k < k_begin + k_len; ++k) {
      const T_in* wrow = w_hh_t + static_cast<size_t>(k) * four_h + j;
      const float w0 = load_f(wrow);
      const float w1 = load_f(wrow + hidden);
      const float w2 = load_f(wrow + 2 * hidden);
      const float w3 = load_f(wrow + 3 * hidden);
      const float4* hk = reinterpret_cast<const float4*>(hs + k * TB);
#pragma unroll
      for (int q4 = 0; q4 < TB / 4; ++q4) {
        const float4 h4 = hk[q4];
        const float hv[4] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 4 * q4 + e;
          acc[0][r] = fmaf(hv[e], w0, acc[0][r]);
          acc[1][r] = fmaf(hv[e], w1, acc[1][r]);
          acc[2][r] = fmaf(hv[e], w2, acc[2][r]);
          acc[3][r] = fmaf(hv[e], w3, acc[3][r]);
        }
      }
    }
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int r = 0; r < TB; ++r)
        part[((ks * 4 + g) * TB + r) * hidden + j] = acc[g][r];
    __syncthreads();  // partial sums written; every read of hs is done

#pragma unroll
    for (int q = 0; q < RPT; ++q) {
      const int r = r_begin + q;
      float gate[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        gate[g] = xv[q][g];
#pragma unroll
        for (int p = 0; p < KS; ++p)
          gate[g] += part[((p * 4 + g) * TB + r) * hidden + j];
      }
      const float ig = sigmoid_f(gate[0]);
      const float fg = sigmoid_f(gate[1]);
      const float gg = tanhf(gate[2]);
      const float og = sigmoid_f(gate[3]);
      c[q] = fg * c[q] + ig * gg;
      const float h = og * tanhf(c[q]);
      hs[j * TB + r] = h;
      if (b0 + r < batch)
        store_f(ys + (static_cast<size_t>(t) * batch + b0 + r) * hidden + j,
                h);
    }
    __syncthreads();  // h written; every read of part is done
  }

#pragma unroll
  for (int q = 0; q < RPT; ++q) {
    const int r = r_begin + q;
    if (b0 + r < batch) {
      const size_t bj = static_cast<size_t>(b0 + r) * hidden + j;
      h_t[bj] = hs[j * TB + r];  // this thread's own last write
      c_t[bj] = c[q];
    }
  }
}

template <typename T_in, int KS, int MAXT>
cudaError_t launch(const void* xg, const void* w_hh_t, const float* h0,
                   const float* c0, void* ys, float* h_t, float* c_t,
                   int t_steps, int batch, int hidden, int reverse,
                   cudaStream_t stream) {
  const auto kernel = lstm_fwd_kernel<T_in, kTile, KS, MAXT>;
  // h plus KS x 4 partial gates, each [hidden][TB] floats (at most 160 KB)
  const size_t smem =
      static_cast<size_t>(hidden) * kTile * sizeof(float) * (1 + 4 * KS);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((batch + kTile - 1) / kTile);
  kernel<<<grid, KS * hidden, smem, stream>>>(
      static_cast<const T_in*>(xg), static_cast<const T_in*>(w_hh_t), h0, c0,
      static_cast<T_in*>(ys), h_t, c_t, t_steps, batch, hidden, reverse);
  return cudaGetLastError();
}

// The k-split: as many thread groups as keep a block at <= 512 threads
// (1024 past H = 512) and each thread at >= 1 row of the tile.
template <typename T_in>
cudaError_t dispatch(const void* xg, const void* w_hh_t, const float* h0,
                     const float* c0, void* ys, float* h_t, float* c_t,
                     int t_steps, int batch, int hidden, int reverse,
                     cudaStream_t stream) {
#define LSTM_LAUNCH(KS, MAXT)                                             \
  return launch<T_in, KS, MAXT>(xg, w_hh_t, h0, c0, ys, h_t, c_t, t_steps, \
                                batch, hidden, reverse, stream)
  if (hidden <= 64) LSTM_LAUNCH(8, 512);
  if (hidden <= 128) LSTM_LAUNCH(4, 512);
  if (hidden <= 256) LSTM_LAUNCH(2, 512);
  if (hidden <= 512) LSTM_LAUNCH(1, 512);
  LSTM_LAUNCH(1, 1024);
#undef LSTM_LAUNCH
}

}  // namespace

// Plain C entry point (bound with ctypes). Launches on `stream` of device
// `device`, does not synchronise, allocates nothing, and returns the
// cudaError_t of the launch (0 on success).
extern "C" int lstm_fwd(const void* xg, const void* w_hh_t, const void* h0,
                        const void* c0, void* ys, void* h_t, void* c_t,
                        int t_steps, int batch, int hidden, int reverse,
                        int is_bf16, int device, void* stream) {
  if (hidden < 32 || hidden % 32 != 0 || hidden > 1024 || batch < 1 ||
      t_steps < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* h0f = static_cast<const float*>(h0);
  const float* c0f = static_cast<const float*>(c0);
  float* htf = static_cast<float*>(h_t);
  float* ctf = static_cast<float*>(c_t);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = is_bf16
            ? dispatch<__nv_bfloat16>(xg, w_hh_t, h0f, c0f, ys, htf, ctf,
                                      t_steps, batch, hidden, reverse, s)
            : dispatch<float>(xg, w_hh_t, h0f, c0f, ys, htf, ctf, t_steps,
                              batch, hidden, reverse, s);
  return static_cast<int>(err);
}

extern "C" const char* lstm_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
