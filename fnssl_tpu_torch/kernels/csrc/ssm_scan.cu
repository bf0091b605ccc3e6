// The selective scan of a Mamba block: K3 (forward) and K4 (backward).
//
// Replaces the sequential core of fnssl_tpu/models/mamba.py: ssm_scan, a
// lax.scan behind a custom_vjp (_ssm_scan_ref, :145; its vjp _ssm_bwd,
// :189), the slot of the reference's mamba_ssm CUDA kernels. Contract, in
// the batch-major layout that _ssm_inputs produces (no time-major copy):
//   da, dbx (B, L, d, n) and c (B, L, n) float32 or bfloat16; h0 (B, d, n)
//   float32; n = d_state = 16.
//   K3: h_t = da_t * h_{t-1} + dbx_t;  y_t = sum_n h_t * c_t.
//       y (B, L, d) float32 and h_last (B, d, n) float32: bfloat16 inputs
//       are widened to float32, as JAX promotes them against the float32
//       state.
//   K4: from dy (B, L, d) and dh_last (B, d, n) float32, walking back:
//       gh = g + dy_t * c_t;  d(dbx_t) = gh;  d(da_t) = gh * h_{t-1};
//       d(c_t) = sum_d dy_t * h_t;  g = gh * da_t;  d(h0) = g at t = 0.
//       d(da), d(dbx), d(c) in the inputs' dtype (float32 sums, rounded at
//       the store), d(h0) float32.
//
// What bounds it on an H100: bytes. The recurrence is one FMA per state a
// step and the whole work is a few FLOPs per byte, far below the card's
// ~20 FLOP/byte float32 balance; at IPDnet2's layer 0 in training (B=256,
// L=201, d=192) da and dbx are 632 MB each. The serial walk over L is
// short in work per step, so the design keeps enough loads in flight to
// cover memory latency:
//
// K3: four threads a (b, d) channel, each holding 4 of the 16 states in
// registers (float4 loads: a warp reads 512 contiguous bytes of da per
// instruction). A thread loads the da, dbx and c of 8 steps before it
// walks them (the loads do not depend on h), so 24 16-byte loads are in
// flight per thread. y_t is the sum of the four threads' partial dot
// products (two xor-shuffles). Blocks of 256 threads (64 channels) tile
// the B x d channels. c is read by every channel of a batch row: the same
// 64 bytes across a warp, served by one L1 broadcast.
//
// K4: one block per batch row b, 4 x d threads (d <= 192, a multiple of
// 8), so that d(c_t), a sum over d, is reduced inside the block: each
// warp reduces its channels by shuffles, writes its partial into shared
// memory, and after a segment of 4 steps the block sums the warps' partial
// sums (two __syncthreads a segment, a fixed order: deterministic). The
// backward needs h_{t-1} and h_t in reverse order. Phase 1 replays the
// forward and stores h at the start of every 4-step segment into a
// scratch (B, ceil(L/4), d, n) float32 (a quarter of h), written and read
// back by the same thread; phase 2 walks the segments backwards,
// recomputing the segment's 4 states from its checkpoint in registers,
// then walking them back. da and dbx are read twice (about 3.9 GB at
// layer 0 against the 2.5 GB the function must move); a checkpoint
// written by K3 in training would save phase 1 (ROADMAP, Queue 2).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kN = 16;                 // d_state
constexpr int kQ = 4;                  // states a thread holds
constexpr int kTpc = kN / kQ;          // threads a channel
constexpr int kFwdThreads = 256;       // K3 block: 64 channels
constexpr int kFwdUnroll = 8;          // K3 steps loaded before they are walked
constexpr int kSeg = 4;                // K4 segment (checkpoint interval)
constexpr int kBwdMaxDim = 192;        // K4: 4 x d threads a block
constexpr int kBwdMaxWarps = kBwdMaxDim * kTpc / 32;

__device__ __forceinline__ void load4(const float* p, float (&v)[kQ]) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                      float (&v)[kQ]) {
  const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
  v[0] = __uint_as_float(q.x << 16);
  v[1] = __uint_as_float(q.x & 0xffff0000u);
  v[2] = __uint_as_float(q.y << 16);
  v[3] = __uint_as_float(q.y & 0xffff0000u);
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

__device__ __forceinline__ void store4(__nv_bfloat16* p,
                                       const float (&v)[kQ]) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 q;
  q.x = *reinterpret_cast<unsigned int*>(&lo);
  q.y = *reinterpret_cast<unsigned int*>(&hi);
  *reinterpret_cast<uint2*>(p) = q;
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }

__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// K3: y and h_last. Thread (channel, j) holds states 4j .. 4j+3.
template <typename T>
__global__ void __launch_bounds__(kFwdThreads)
ssm_fwd_kernel(const T* __restrict__ da, const T* __restrict__ dbx,
               const T* __restrict__ c, const float* __restrict__ h0,
               float* __restrict__ y, float* __restrict__ h_last, int batch,
               int steps, int dim) {
  const long long channels = static_cast<long long>(batch) * dim;
  long long ch = static_cast<long long>(blockIdx.x) * (kFwdThreads / kTpc)
                 + threadIdx.x / kTpc;
  const int j = threadIdx.x % kTpc;
  // a ragged last block: its spare threads walk the last channel again
  // (the four threads of a channel must all reach the shuffles) and store
  // nothing
  const bool valid = ch < channels;
  if (!valid) ch = channels - 1;
  const long long b = ch / dim;
  const long long dd = ch % dim;
  const long long step = static_cast<long long>(dim) * kN;
  const long long off = b * steps * step + dd * kN + j * kQ;
  const T* pa = da + off;
  const T* pb = dbx + off;
  const T* pc = c + b * steps * kN + j * kQ;
  float* py = y + b * steps * dim + dd;

  float h[kQ];
  load4(h0 + ch * kN + j * kQ, h);
  for (int t0 = 0; t0 < steps; t0 += kFwdUnroll) {
    float a[kFwdUnroll][kQ], x[kFwdUnroll][kQ], cc[kFwdUnroll][kQ];
#pragma unroll
    for (int u = 0; u < kFwdUnroll; ++u) {
      if (t0 + u < steps) {
        const long long t = t0 + u;
        load4(pa + t * step, a[u]);
        load4(pb + t * step, x[u]);
        load4(pc + t * kN, cc[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kFwdUnroll; ++u) {
      if (t0 + u < steps) {            // the same for every thread
        float s = 0.0f;
#pragma unroll
        for (int q = 0; q < kQ; ++q) {
          h[q] = a[u][q] * h[q] + x[u][q];
          s += h[q] * cc[u][q];
        }
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        if (valid && j == 0) py[static_cast<long long>(t0 + u) * dim] = s;
      }
    }
  }
  if (valid) store4(h_last + ch * kN + j * kQ, h);
}

// K4: one block per batch row, thread (dd, j) = (tid / 4, tid % 4).
template <typename T>
__global__ void __launch_bounds__(kBwdMaxDim * kTpc, 1)
ssm_bwd_kernel(const T* __restrict__ da, const T* __restrict__ dbx,
               const T* __restrict__ c, const float* __restrict__ h0,
               const float* __restrict__ dy,
               const float* __restrict__ dh_last, T* __restrict__ dda,
               T* __restrict__ ddbx, T* __restrict__ dc,
               float* __restrict__ dh0, float* __restrict__ ck, int steps,
               int dim, int nseg) {
  __shared__ __align__(16) float red[kBwdMaxWarps * kSeg * kN];
  const long long b = blockIdx.x;
  const int tid = threadIdx.x;
  const int dd = tid / kTpc, j = tid % kTpc;
  const int lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  const long long step = static_cast<long long>(dim) * kN;
  const long long off = b * steps * step + dd * kN + j * kQ;
  const T* pa = da + off;
  const T* pb = dbx + off;
  const T* pc = c + b * steps * kN + j * kQ;
  const float* pdy = dy + b * steps * dim + dd;
  T* pda = dda + off;
  T* pdb = ddbx + off;
  T* pdc = dc + b * steps * kN;
  float* pck = ck + b * nseg * step + dd * kN + j * kQ;
  const long long state = (b * dim + dd) * kN + j * kQ;

  // phase 1: replay the forward; checkpoint h before every segment
  float h[kQ];
  load4(h0 + state, h);
  for (int s = 0; s < nseg; ++s) {
    const int t0 = s * kSeg;
    store4(pck + s * step, h);
    float a[kSeg][kQ], x[kSeg][kQ];
#pragma unroll
    for (int k = 0; k < kSeg; ++k) {
      if (t0 + k < steps) {
        load4(pa + static_cast<long long>(t0 + k) * step, a[k]);
        load4(pb + static_cast<long long>(t0 + k) * step, x[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < kSeg; ++k) {
      if (t0 + k < steps) {
#pragma unroll
        for (int q = 0; q < kQ; ++q) h[q] = a[k][q] * h[q] + x[k][q];
      }
    }
  }

  // phase 2: the segments backwards
  float g[kQ];
  load4(dh_last + state, g);
  for (int s = nseg - 1; s >= 0; --s) {
    const int t0 = s * kSeg;
    const int kk = min(kSeg, steps - t0);
    float hs[kSeg + 1][kQ];              // hs[k + 1] = h at step t0 + k
    float a[kSeg][kQ], x[kSeg][kQ];
    load4_rw(pck + s * step, hs[0]);
#pragma unroll
    for (int k = 0; k < kSeg; ++k) {
      if (k < kk) {
        load4(pa + static_cast<long long>(t0 + k) * step, a[k]);
        load4(pb + static_cast<long long>(t0 + k) * step, x[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < kSeg; ++k) {
      if (k < kk) {
#pragma unroll
        for (int q = 0; q < kQ; ++q)
          hs[k + 1][q] = a[k][q] * hs[k][q] + x[k][q];
      }
    }
#pragma unroll
    for (int k = kSeg - 1; k >= 0; --k) {
      if (k < kk) {                     // the same for every thread
        const long long t = t0 + k;
        const float gy = __ldg(pdy + t * dim);
        float cc[kQ], gh[kQ], part[kQ], ga[kQ];
        load4(pc + t * kN, cc);
#pragma unroll
        for (int q = 0; q < kQ; ++q) {
          gh[q] = g[q] + gy * cc[q];
          ga[q] = gh[q] * hs[k][q];
          part[q] = gy * hs[k + 1][q];
          g[q] = gh[q] * a[k][q];
        }
        store4(pda + t * step, ga);
        store4(pdb + t * step, gh);
        // the warp's 8 channels: lanes with the same j hold the same states
#pragma unroll
        for (int q = 0; q < kQ; ++q) {
          part[q] += __shfl_xor_sync(0xffffffffu, part[q], 4);
          part[q] += __shfl_xor_sync(0xffffffffu, part[q], 8);
          part[q] += __shfl_xor_sync(0xffffffffu, part[q], 16);
        }
        if (lane < kTpc)
          store4(red + (warp * kSeg + k) * kN + lane * kQ, part);
      }
    }
    __syncthreads();
    for (int i = tid; i < kk * kN; i += blockDim.x) {
      const int k = i / kN;
      float sum = 0.0f;
      for (int w = 0; w < nwarps; ++w) sum += red[(w * kSeg + k) * kN + i % kN];
      store1(pdc + static_cast<long long>(t0) * kN + i, sum);
    }
    __syncthreads();
  }
  store4(dh0 + state, g);
}

template <typename T>
cudaError_t launch_fwd(const void* da, const void* dbx, const void* c,
                       const float* h0, float* y, float* h_last, int batch,
                       int steps, int dim, cudaStream_t s) {
  const long long threads = static_cast<long long>(batch) * dim * kTpc;
  const unsigned blocks =
      static_cast<unsigned>((threads + kFwdThreads - 1) / kFwdThreads);
  ssm_fwd_kernel<T><<<blocks, kFwdThreads, 0, s>>>(
      static_cast<const T*>(da), static_cast<const T*>(dbx),
      static_cast<const T*>(c), h0, y, h_last, batch, steps, dim);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* da, const void* dbx, const void* c,
                       const float* h0, const float* dy,
                       const float* dh_last, void* dda, void* ddbx, void* dc,
                       float* dh0, float* ck, int batch, int steps, int dim,
                       cudaStream_t s) {
  const int nseg = (steps + kSeg - 1) / kSeg;
  ssm_bwd_kernel<T><<<batch, dim * kTpc, 0, s>>>(
      static_cast<const T*>(da), static_cast<const T*>(dbx),
      static_cast<const T*>(c), h0, dy, dh_last, static_cast<T*>(dda),
      static_cast<T*>(ddbx), static_cast<T*>(dc), dh0, ck, steps, dim, nseg);
  return cudaGetLastError();
}

}  // namespace

// K3. Returns a cudaError_t (0 on success).
extern "C" int ssm_scan_fwd(const void* da, const void* dbx, const void* c,
                            const void* h0, void* y, void* h_last, int batch,
                            int steps, int dim, int d_state, int is_bf16,
                            int device, void* stream) {
  if (d_state != kN || batch < 1 || steps < 1 || dim < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* h0f = static_cast<const float*>(h0);
  float* yf = static_cast<float*>(y);
  float* hf = static_cast<float*>(h_last);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = is_bf16 ? launch_fwd<__nv_bfloat16>(da, dbx, c, h0f, yf, hf, batch,
                                            steps, dim, s)
                : launch_fwd<float>(da, dbx, c, h0f, yf, hf, batch, steps,
                                    dim, s);
  return static_cast<int>(err);
}

// K4; ck is a float32 scratch of (batch, ceil(steps / 4), dim, 16).
extern "C" int ssm_scan_bwd(const void* da, const void* dbx, const void* c,
                            const void* h0, const void* dy,
                            const void* dh_last, void* dda, void* ddbx,
                            void* dc, void* dh0, void* ck, int batch,
                            int steps, int dim, int d_state, int is_bf16,
                            int device, void* stream) {
  if (d_state != kN || batch < 1 || steps < 1 || dim < 8 || dim % 8 != 0 ||
      dim > kBwdMaxDim)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* h0f = static_cast<const float*>(h0);
  const float* dyf = static_cast<const float*>(dy);
  const float* dhf = static_cast<const float*>(dh_last);
  float* dh0f = static_cast<float*>(dh0);
  float* ckf = static_cast<float*>(ck);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = is_bf16
            ? launch_bwd<__nv_bfloat16>(da, dbx, c, h0f, dyf, dhf, dda, ddbx,
                                        dc, dh0f, ckf, batch, steps, dim, s)
            : launch_bwd<float>(da, dbx, c, h0f, dyf, dhf, dda, ddbx, dc,
                                dh0f, ckf, batch, steps, dim, s);
  return static_cast<int>(err);
}

extern "C" const char* ssm_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
