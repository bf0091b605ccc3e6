// The selective scan of a Mamba block, fused: K3 (forward) and K4
// (backward).
//
// Replaces the sequential core of fnssl_tpu/models/mamba.py: ssm_scan, a
// lax.scan behind a custom_vjp (_ssm_scan_ref, :145; its vjp _ssm_bwd,
// :189), together with the elementwise producers of its inputs in
// _ssm_inputs (:80): the slot of the reference's mamba_ssm CUDA
// selective_scan. Contract, batch-major:
//   x, dt (B, L, d) and Bm, C (B, L, n) float32 or bfloat16 (one dtype);
//   dt_bias (d), A (d, n), D (d) and h0 (B, d, n) float32; n = 16. dt is
//   the dt_proj product before its bias and softplus.
//   K3: per step, in registers: delta = softplus(dt + dt_bias) (torch's,
//       threshold 20), da = exp(delta * A), dbx = delta * x * Bm,
//       h = da * h + dbx;  y = sum_n h * C + D * x.
//       y (B, L, d) and h_last (B, d, n) float32: bfloat16 inputs are
//       widened to float32, as JAX promotes them against the float32
//       state.
//   K4: from dy (B, L, d) and dh_last (B, d, n) float32, walking back with
//       g = dL/dh:  gh = g + dy * C;  d(C) = sum_d dy * h;
//       d(Bm) = sum_d gh * delta * x;  s_B = sum_n gh * Bm;
//       s_A = sum_n gh * h_prev * da * A;  dx = dy * D + delta * s_B;
//       d(dt) = (s_A + x * s_B) * softplus'(dt + dt_bias);
//       d(A) += gh * h_prev * da * delta;  d(D) += dy * x;
//       d(dt_bias) += d(dt);  g = gh * da;  d(h0) = g at t = 0.
//       dx, d(dt), d(Bm), d(C) in the inputs' dtype (float32 sums, rounded
//       at the store); d(A), d(D), d(dt_bias), d(h0) float32.
// No (B, L, d, n) tensor is written, forward or backward: exp(delta * A)
// and delta * x * Bm live in registers for the step that uses them.
//
// What bounds it on an H100. The bytes are few: x, dt and y are 12 bytes
// a channel a step, Bm and C 128 bytes a batch row a step (at IPDnet2's
// layer 0 in training, B 256, L 201, d 192: ~125 MB, 0.04 ms at 3.35
// TB/s). The work is an exponential a state a step (16 a channel), on the
// SFU's 16 a clock an SM (~0.04 ms there), beside ~10 float32 instructions
// a state a step (the accurate expf's range reduction, the recurrence, the
// contraction): both kernels are bound by instruction issue, K4 at about
// four times K3 (it replays the forward, recomputes each decay twice and
// reduces d(Bm), d(C) by shuffles). The design:
//
// Both kernels give a block of 128 threads one batch row's slice of 32
// channels (a grid of B x ceil(d / 32) blocks: 384 at B 64, d 192), four
// threads a (b, d) channel, each holding 4 of the 16 states (and of A) in
// registers. Every 8 steps the block stages that group's inputs in shared
// memory, coalesced: Bm and C (shared by every channel of the row), x, and
// the softplus of dt + dt_bias, computed once a channel a step (and, in
// K4, its derivative and dy); each thread then reads its channel's
// scalars and its 4 states' Bm and C (one 16-byte read each, a broadcast
// across the warp's 8 channels). Outputs a channel a step (y; dx, d(dt))
// go through shared memory too and are written coalesced after the group.
// This keeps the loads out of the serial walk and the registers few (K3
// 40 a thread, K4 96). In a ragged last slice (d not a multiple of 32)
// the spare threads walk the last channel on zeros, so that the four
// threads of a channel all reach the shuffles, and store nothing.
//
// K3: y_t is the sum of the four threads' partial dot products (two
// xor-shuffles).
//
// K4: phase 1 replays the forward and stores h at the start of every
// 8-step segment into a scratch (B, ceil(L/8), d, n) float32 (an eighth of
// h, written and read back by the same thread).
// Phase 2 walks the segments backwards: it recomputes the segment's 8
// states from its checkpoint in registers, then walks them back,
// recomputing each decay (an SFU operation instead of 32 registers). The
// sums over the channel's 16 states (s_A, s_B) take two xor-shuffles each.
// d(Bm) and d(C), sums over d, are reduced inside the block: the 8
// channels of a warp by a butterfly that leaves each of the 32 lanes one of
// the 32 sums (7 shuffles), the warps through shared memory after each
// segment, and the block writes its slice's partial (B, L, slices, 32).
// d(A), d(D) and d(dt_bias) are summed over L in registers and written per
// batch row; the wrapper sums every partial in a fixed order: no atomics,
// the same bits run to run.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kN = 16;                 // d_state
constexpr int kQ = 4;                  // states a thread holds
constexpr int kTpc = kN / kQ;          // threads a channel
constexpr int kGroup = 8;              // steps a staged group / K4 segment
constexpr int kThreads = 128;          // a block: 32 channels
constexpr int kCh = kThreads / kTpc;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float ld1(const float* p) { return __ldg(p); }

__device__ __forceinline__ float ld1(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

__device__ __forceinline__ void load4(const float* p, float (&v)[kQ]) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

// a load of what this thread itself wrote in this launch: not through the
// read-only (non-coherent) path
__device__ __forceinline__ void load4_rw(const float* p, float (&v)[kQ]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

__device__ __forceinline__ void store4(float* p, const float (&v)[kQ]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }

__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// torch's softplus (beta 1, threshold 20) and its derivative
__device__ __forceinline__ float softplus(float v) {
  return v > 20.0f ? v : log1pf(expf(v));
}

__device__ __forceinline__ void softplus_grad(float v, float& sp,
                                              float& dsp) {
  if (v > 20.0f) {
    sp = v;
    dsp = 1.0f;
  } else {
    const float z = expf(v);
    sp = log1pf(z);
    dsp = z / (z + 1.0f);
  }
}

// Stages the inputs of steps t0 .. t0 + kk - 1 of batch row `row` (the
// flat index of (b, t = 0)) for the block's channels d0 .. d0 + kCh - 1
// in shared memory: Bm and C (s_bc[k] = Bm_t then C_t), x, delta and, with
// kGrad, softplus' derivative and dy. Each channel's softplus is computed
// once, by one thread; channels past d hold zeros.
template <typename T, bool kGrad>
__device__ __forceinline__ void stage(
    const T* __restrict__ x, const T* __restrict__ dt,
    const float* __restrict__ dt_bias, const T* __restrict__ bm,
    const T* __restrict__ c, const float* __restrict__ dy, long long row,
    int t0, int kk, int dim, int d0, bool with_c,
    float (&s_bc)[kGroup][2 * kN], float (&s_x)[kGroup][kCh],
    float (&s_dl)[kGroup][kCh], float (&s_dsp)[kGroup][kCh],
    float (&s_dy)[kGroup][kCh]) {
  const int per_step = with_c ? 2 * kN : kN;
  for (int i = threadIdx.x; i < kk * per_step; i += kThreads) {
    const int k = i / per_step, e = i % per_step;
    const long long t = row + t0 + k;
    s_bc[k][e] = e < kN ? ld1(bm + t * kN + e) : ld1(c + t * kN + e - kN);
  }
  for (int i = threadIdx.x; i < kk * kCh; i += kThreads) {
    const int k = i / kCh, ch = i % kCh, dd = d0 + ch;
    float xv = 0.0f, sp = 0.0f, dsp = 0.0f, gy = 0.0f;
    if (dd < dim) {
      const long long off = (row + t0 + k) * dim + dd;
      xv = ld1(x + off);
      const float v = ld1(dt + off) + __ldg(dt_bias + dd);
      if (kGrad) {
        softplus_grad(v, sp, dsp);
        gy = __ldg(dy + off);
      } else {
        sp = softplus(v);
      }
    }
    s_x[k][ch] = xv;
    s_dl[k][ch] = sp;
    if (kGrad) {
      s_dsp[k][ch] = dsp;
      s_dy[k][ch] = gy;
    }
  }
}

// K3: y and h_last. Block (b, slice) holds channels slice * 32 .. + 31 of
// batch row b; thread (c, j) = (tid / 4, tid % 4) holds states 4j .. 4j+3
// of its channel.
template <typename T>
__global__ void __launch_bounds__(kThreads)
selective_fwd_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                     const float* __restrict__ dt_bias,
                     const float* __restrict__ A, const T* __restrict__ bm,
                     const T* __restrict__ c, const float* __restrict__ D,
                     const float* __restrict__ h0, float* __restrict__ y,
                     float* __restrict__ h_last, int steps, int dim) {
  __shared__ __align__(16) float s_bc[kGroup][2 * kN];
  __shared__ float s_x[kGroup][kCh], s_dl[kGroup][kCh], s_y[kGroup][kCh];
  const long long b = blockIdx.x;
  const int tid = threadIdx.x, cl = tid / kTpc, j = tid % kTpc;
  const int d0 = blockIdx.y * kCh;
  const bool valid = d0 + cl < dim;    // else: zeros on the last channel
  const int dd = valid ? d0 + cl : dim - 1;
  const long long row = b * steps;
  const long long state = (b * dim + dd) * kN + j * kQ;
  const float dskip = __ldg(D + dd);
  float a[kQ], h[kQ];
  load4(A + dd * kN + j * kQ, a);
  load4(h0 + state, h);
  for (int t0 = 0; t0 < steps; t0 += kGroup) {
    const int kk = min(kGroup, steps - t0);
    __syncthreads();                   // the last group's s_* are read
    stage<T, false>(x, dt, dt_bias, bm, c, nullptr, row, t0, kk, dim, d0,
                    true, s_bc, s_x, s_dl, s_dl, s_dl);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      if (k < kk) {                    // the same for every thread
        const float delta = s_dl[k][cl], xv = s_x[k][cl];
        const float4 bq = *reinterpret_cast<const float4*>(&s_bc[k][j * kQ]);
        const float4 cq =
            *reinterpret_cast<const float4*>(&s_bc[k][kN + j * kQ]);
        const float bb[kQ] = {bq.x, bq.y, bq.z, bq.w};
        const float cc[kQ] = {cq.x, cq.y, cq.z, cq.w};
        const float du = delta * xv;
        float s = 0.0f;
#pragma unroll
        for (int q = 0; q < kQ; ++q) {
          h[q] = expf(delta * a[q]) * h[q] + du * bb[q];
          s += h[q] * cc[q];
        }
        s += __shfl_xor_sync(kFull, s, 1);
        s += __shfl_xor_sync(kFull, s, 2);
        if (j == 0) s_y[k][cl] = s + dskip * xv;
      }
    }
    __syncthreads();
    for (int i = tid; i < kk * kCh; i += kThreads) {
      const int k = i / kCh, ch = i % kCh;
      if (d0 + ch < dim) y[(row + t0 + k) * dim + d0 + ch] = s_y[k][ch];
    }
  }
  if (valid) store4(h_last + state, h);
}

// K4: block (b, slice) holds channels slice * 32 .. + 31 of batch row b;
// thread (c, j) = (tid / 4, tid % 4) holds states 4j .. 4j+3.
template <typename T>
__global__ void __launch_bounds__(kThreads)
selective_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                     const float* __restrict__ dt_bias,
                     const float* __restrict__ A, const T* __restrict__ bm,
                     const T* __restrict__ c, const float* __restrict__ D,
                     const float* __restrict__ h0,
                     const float* __restrict__ dy,
                     const float* __restrict__ dh_last, T* __restrict__ dx,
                     T* __restrict__ ddt, float* __restrict__ part_bc,
                     float* __restrict__ part_a, float* __restrict__ part_d,
                     float* __restrict__ part_bias, float* __restrict__ dh0,
                     float* __restrict__ ck, int steps, int dim, int nseg) {
  __shared__ __align__(16) float s_bc[kGroup][2 * kN];
  __shared__ float s_x[kGroup][kCh], s_dl[kGroup][kCh];
  __shared__ float s_dsp[kGroup][kCh], s_dy[kGroup][kCh];
  __shared__ float s_dx[kGroup][kCh], s_ddt[kGroup][kCh];
  __shared__ float red[kWarps][kGroup][2 * kN];
  const long long b = blockIdx.x;
  const int slices = gridDim.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cl = tid / kTpc, j = tid % kTpc, cw = lane / kTpc;
  const int d0 = blockIdx.y * kCh;
  const bool valid = d0 + cl < dim;    // else: zeros on the last channel
  const int dd = valid ? d0 + cl : dim - 1;
  const long long row = b * steps;
  const long long state = (b * dim + dd) * kN + j * kQ;
  const long long seg_stride = static_cast<long long>(dim) * kN;
  float* pck = ck + b * nseg * seg_stride + dd * kN + j * kQ;
  const float dskip = __ldg(D + dd);
  float a[kQ];
  load4(A + dd * kN + j * kQ, a);

  // phase 1: replay the forward; checkpoint h before every segment
  float h[kQ];
  load4(h0 + state, h);
  for (int s = 0; s < nseg; ++s) {
    const int t0 = s * kGroup, kk = min(kGroup, steps - t0);
    // a spare thread shares the last channel's address: it must not write
    if (valid) store4(pck + s * seg_stride, h);
    __syncthreads();
    stage<T, false>(x, dt, dt_bias, bm, c, nullptr, row, t0, kk, dim, d0,
                    false, s_bc, s_x, s_dl, s_dsp, s_dy);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      if (k < kk) {
        const float delta = s_dl[k][cl];
        const float du = delta * s_x[k][cl];
        const float4 bq = *reinterpret_cast<const float4*>(&s_bc[k][j * kQ]);
        const float bb[kQ] = {bq.x, bq.y, bq.z, bq.w};
#pragma unroll
        for (int q = 0; q < kQ; ++q)
          h[q] = expf(delta * a[q]) * h[q] + du * bb[q];
      }
    }
  }

  // phase 2: the segments backwards
  float g[kQ], acc_a[kQ] = {0.0f, 0.0f, 0.0f, 0.0f};
  float acc_d = 0.0f, acc_bias = 0.0f;
  load4(dh_last + state, g);
  for (int s = nseg - 1; s >= 0; --s) {
    const int t0 = s * kGroup, kk = min(kGroup, steps - t0);
    __syncthreads();                   // the last segment's s_* are read
    stage<T, true>(x, dt, dt_bias, bm, c, dy, row, t0, kk, dim, d0, true,
                   s_bc, s_x, s_dl, s_dsp, s_dy);
    __syncthreads();
    float hs[kGroup + 1][kQ];          // hs[k + 1] = h at step t0 + k
    load4_rw(pck + s * seg_stride, hs[0]);
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      if (k < kk) {
        const float delta = s_dl[k][cl];
        const float du = delta * s_x[k][cl];
        const float4 bq = *reinterpret_cast<const float4*>(&s_bc[k][j * kQ]);
        const float bb[kQ] = {bq.x, bq.y, bq.z, bq.w};
#pragma unroll
        for (int q = 0; q < kQ; ++q)
          hs[k + 1][q] = expf(delta * a[q]) * hs[k][q] + du * bb[q];
      }
    }
#pragma unroll
    for (int k = kGroup - 1; k >= 0; --k) {
      if (k < kk) {                     // the same for every thread
        const float delta = s_dl[k][cl], xv = s_x[k][cl], gy = s_dy[k][cl];
        const float4 bq = *reinterpret_cast<const float4*>(&s_bc[k][j * kQ]);
        const float4 cq =
            *reinterpret_cast<const float4*>(&s_bc[k][kN + j * kQ]);
        const float bb[kQ] = {bq.x, bq.y, bq.z, bq.w};
        const float cc[kQ] = {cq.x, cq.y, cq.z, cq.w};
        const float du = delta * xv;
        float v[2 * kQ], s_a = 0.0f, s_b = 0.0f;
#pragma unroll
        for (int q = 0; q < kQ; ++q) {
          const float da = expf(delta * a[q]);
          const float gh = g[q] + gy * cc[q];
          const float gda = gh * hs[k][q] * da;
          v[q] = valid ? gh * du : 0.0f;                // d(Bm), this channel's
          v[kQ + q] = valid ? gy * hs[k + 1][q] : 0.0f;  // d(C), this channel's
          s_a += gda * a[q];
          s_b += gh * bb[q];
          acc_a[q] += gda * delta;
          g[q] = gh * da;
        }
        s_a += __shfl_xor_sync(kFull, s_a, 1);
        s_b += __shfl_xor_sync(kFull, s_b, 1);
        s_a += __shfl_xor_sync(kFull, s_a, 2);
        s_b += __shfl_xor_sync(kFull, s_b, 2);
        if (j == 0) {
          const float gdt = (s_a + xv * s_b) * s_dsp[k][cl];
          s_dx[k][cl] = gy * dskip + delta * s_b;
          s_ddt[k][cl] = gdt;
          acc_d += gy * xv;
          acc_bias += gdt;
        }
        // d(Bm), d(C) over the warp's 8 channels: a butterfly that leaves
        // lane (cw, j) the sum of entry e = 4 (cw & 1) + 2 (cw >> 1 & 1) +
        // (cw >> 2 & 1) of the channels' v
        float w4[kQ], w2[2];
        bool hi = cw & 1;
#pragma unroll
        for (int e = 0; e < kQ; ++e) {
          const float send = hi ? v[e] : v[e + kQ];
          w4[e] = (hi ? v[e + kQ] : v[e]) +
                  __shfl_xor_sync(kFull, send, kTpc);
        }
        hi = cw & 2;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float send = hi ? w4[e] : w4[e + 2];
          w2[e] = (hi ? w4[e + 2] : w4[e]) +
                  __shfl_xor_sync(kFull, send, 2 * kTpc);
        }
        hi = cw & 4;
        const float send = hi ? w2[0] : w2[1];
        const float sum = (hi ? w2[1] : w2[0]) +
                          __shfl_xor_sync(kFull, send, 4 * kTpc);
        const int e = 4 * (cw & 1) + 2 * ((cw >> 1) & 1) + ((cw >> 2) & 1);
        // slots 0..15 d(Bm) of states 0..15, 16..31 d(C)
        red[warp][k][(e / kQ) * kN + j * kQ + e % kQ] = sum;
      }
    }
    __syncthreads();
    for (int i = tid; i < kk * 2 * kN; i += kThreads) {
      const int k = i / (2 * kN), e = i % (2 * kN);
      float sum = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += red[w][k][e];
      part_bc[((row + t0 + k) * slices + blockIdx.y) * 2 * kN + e] = sum;
    }
    for (int i = tid; i < kk * kCh; i += kThreads) {
      const int k = i / kCh, ch = i % kCh;
      if (d0 + ch < dim) {
        const long long off = (row + t0 + k) * dim + d0 + ch;
        store1(dx + off, s_dx[k][ch]);
        store1(ddt + off, s_ddt[k][ch]);
      }
    }
  }
  if (valid) {
    store4(dh0 + state, g);
    store4(part_a + state, acc_a);
    if (j == 0) {
      part_d[b * dim + dd] = acc_d;
      part_bias[b * dim + dd] = acc_bias;
    }
  }
}

template <typename T>
cudaError_t launch_fwd(const void* x, const void* dt, const float* dt_bias,
                       const float* A, const void* bm, const void* c,
                       const float* D, const float* h0, float* y,
                       float* h_last, int batch, int steps, int dim,
                       cudaStream_t s) {
  const dim3 grid(batch, (dim + kCh - 1) / kCh);
  selective_fwd_kernel<T><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt), dt_bias, A,
      static_cast<const T*>(bm), static_cast<const T*>(c), D, h0, y, h_last,
      steps, dim);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* x, const void* dt, const float* dt_bias,
                       const float* A, const void* bm, const void* c,
                       const float* D, const float* h0, const float* dy,
                       const float* dh_last, void* dx, void* ddt,
                       float* part_bc, float* part_a, float* part_d,
                       float* part_bias, float* dh0, float* ck, int batch,
                       int steps, int dim, cudaStream_t s) {
  const int nseg = (steps + kGroup - 1) / kGroup;
  const dim3 grid(batch, (dim + kCh - 1) / kCh);
  selective_bwd_kernel<T><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt), dt_bias, A,
      static_cast<const T*>(bm), static_cast<const T*>(c), D, h0, dy, dh_last,
      static_cast<T*>(dx), static_cast<T*>(ddt), part_bc, part_a, part_d,
      part_bias, dh0, ck, steps, dim, nseg);
  return cudaGetLastError();
}

}  // namespace

// K3. Returns a cudaError_t (0 on success).
extern "C" int selective_scan_fwd(const void* x, const void* dt,
                                  const void* dt_bias, const void* A,
                                  const void* bm, const void* c,
                                  const void* D, const void* h0, void* y,
                                  void* h_last, int batch, int steps,
                                  int dim, int d_state, int is_bf16,
                                  int device, void* stream) {
  if (d_state != kN || batch < 1 || steps < 1 || dim < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* bias = static_cast<const float*>(dt_bias);
  const float* af = static_cast<const float*>(A);
  const float* df = static_cast<const float*>(D);
  const float* h0f = static_cast<const float*>(h0);
  float* yf = static_cast<float*>(y);
  float* hf = static_cast<float*>(h_last);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = is_bf16 ? launch_fwd<__nv_bfloat16>(x, dt, bias, af, bm, c, df, h0f,
                                            yf, hf, batch, steps, dim, s)
                : launch_fwd<float>(x, dt, bias, af, bm, c, df, h0f, yf, hf,
                                    batch, steps, dim, s);
  return static_cast<int>(err);
}

// K4. Scratch and partials, all float32: ck (batch, ceil(steps / 8), dim,
// 16); part_bc (batch, steps, ceil(dim / 32), 32), d(Bm) then d(C); part_a
// (batch, dim, 16); part_d and part_bias (batch, dim).
extern "C" int selective_scan_bwd(
    const void* x, const void* dt, const void* dt_bias, const void* A,
    const void* bm, const void* c, const void* D, const void* h0,
    const void* dy, const void* dh_last, void* dx, void* ddt, void* part_bc,
    void* part_a, void* part_d, void* part_bias, void* dh0, void* ck,
    int batch, int steps, int dim, int d_state, int is_bf16, int device,
    void* stream) {
  if (d_state != kN || batch < 1 || steps < 1 || dim < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* bias = static_cast<const float*>(dt_bias);
  const float* af = static_cast<const float*>(A);
  const float* df = static_cast<const float*>(D);
  const float* h0f = static_cast<const float*>(h0);
  const float* dyf = static_cast<const float*>(dy);
  const float* dhf = static_cast<const float*>(dh_last);
  float* pbc = static_cast<float*>(part_bc);
  float* pa = static_cast<float*>(part_a);
  float* pd = static_cast<float*>(part_d);
  float* pbias = static_cast<float*>(part_bias);
  float* dh0f = static_cast<float*>(dh0);
  float* ckf = static_cast<float*>(ck);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = is_bf16
            ? launch_bwd<__nv_bfloat16>(x, dt, bias, af, bm, c, df, h0f,
                                        dyf, dhf, dx, ddt, pbc, pa, pd, pbias,
                                        dh0f, ckf, batch, steps, dim, s)
            : launch_bwd<float>(x, dt, bias, af, bm, c, df, h0f, dyf, dhf, dx,
                                ddt, pbc, pa, pd, pbias, dh0f, ckf, batch,
                                steps, dim, s);
  return static_cast<int>(err);
}

extern "C" const char* ssm_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
