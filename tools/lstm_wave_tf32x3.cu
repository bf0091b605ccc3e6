// A variant of lstm_wave.cu kept for measurement, not used by the package:
// the same contract and grid (a CTA owns a tile of batch rows for all T
// steps), with the step product on the tensor cores under 3xTF32, so that
// the float32 result keeps float32's accuracy: h = h_hi + h_lo and W_hh =
// w_hi + w_lo split in registers into TF32 pieces (cvt.rna), and each
// product summed as h_lo w_hi + h_hi w_lo + h_hi w_hi by mma.sync m16n8k8
// (bfloat16 W_hh is exact in TF32: two products). A CTA has 8 warps; warp w
// owns the 4H/8 gate columns of its H/8 units as n-tiles of 8 columns (4
// units x the gates (i, f), then (g, o)), so that each thread's accumulators
// hold all four gates of its units and the cell update stays in registers.
// W_hh streams through a ring of kStages stages of kChunk k-rows in shared
// memory (cp.async, in the order [k][unit quad][gate][4 units], rows padded
// so that the fragments' loads fall in distinct banks); h and c stay in
// shared memory; this step's xg is loaded straight into the accumulators
// (prefetched into L2 a step ahead). Entry point as lstm_wave.cu's, with
// rows = the tile (16 or 32 rows) and H 128 or 256.
//
// Built and timed by tools/lstm_wave_variants.py (variants tf32x3*, which
// also set kChunk and kStages). On an H100 it ran slower than lstm_wave.cu
// at every shape measured (PERF.md), and its time fell by less than the
// products it dropped in bfloat16: the tensor-core rate of mma.sync is not
// what bounds it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <set>

namespace {

constexpr size_t kMaxSmem = 232448;
constexpr size_t kBarrierSmem = 16;
#ifndef WAVE_CHUNK
#define WAVE_CHUNK 8
#endif
#ifndef WAVE_STAGES
#define WAVE_STAGES 4
#endif
constexpr int kChunk = WAVE_CHUNK;    // k rows of W_hh a stage
constexpr int kStages = WAVE_STAGES;  // stages of the ring
constexpr int kWPad = 8;      // elements a staged W row is padded by
constexpr int kHPad = 4;      // floats a row of h / c is padded by

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  const unsigned short bits = __ldg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(static_cast<unsigned int>(bits) << 16);
}
__device__ __forceinline__ uint32_t bits_of(float v) {
  return __float_as_uint(v);
}
__device__ __forceinline__ float smem_w(const float* p) { return *p; }
__device__ __forceinline__ float smem_w(const __nv_bfloat16* p) {
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

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, both tf32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "n"(BYTES)
                 : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stages W_hh^T rows [k0, k0 + kChunk) into one stage of the ring, in the
// order [k][unit quad q][gate][4 units] (a quad of one gate is one copy of 4
// elements), rows kPitch = 4H + kWPad elements apart.
template <typename T_in>
__device__ __forceinline__ void stage_w(T_in* ring, const T_in* w, int k0,
                                        int hidden, int threads) {
  constexpr int kBytes = 4 * sizeof(T_in);
  const int pitch = 4 * hidden + kWPad;
  const int pieces = kChunk * hidden;  // (k, gate, quad) pieces of 4 units
  for (int p = threadIdx.x; p < pieces; p += threads) {
    const int k = p / hidden;
    const int rest = p - k * hidden;  // gate * H/4 + quad
    const int gate = rest / (hidden / 4);
    const int quad = rest - gate * (hidden / 4);
    cp_async<kBytes>(ring + k * pitch + quad * 16 + gate * 4,
                     w + static_cast<size_t>(k0 + k) * 4 * hidden +
                         gate * hidden + quad * 4);
  }
}

template <typename T_in, int MT, int NT>
__global__ void __launch_bounds__(256, 1)
lstm_wave_mma_kernel(const T_in* __restrict__ xg,
                     const T_in* __restrict__ w_hh_t,
                     const float* __restrict__ h0,
                     const float* __restrict__ c0, T_in* __restrict__ ys,
                     float* __restrict__ h_t, float* __restrict__ c_t,
                     int t_steps, int batch, int hidden, int reverse) {
  constexpr int kTile = 16 * MT;
  const int threads = blockDim.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int dir = blockIdx.y;
  const int b0 = blockIdx.x * kTile;
  const int four_h = 4 * hidden;
  const bool backward = (reverse ^ dir) != 0;
  const size_t step_len = static_cast<size_t>(batch) * four_h;
  const int wpitch = four_h + kWPad;
  const int hpitch = hidden + kHPad;
  const int quad0 = warp * (NT / 2);  // the warp's first unit quad

  xg += static_cast<size_t>(dir) * t_steps * step_len;
  ys += static_cast<size_t>(dir) * t_steps * batch * hidden;
  w_hh_t += static_cast<size_t>(dir) * hidden * four_h;
  const size_t state_off = static_cast<size_t>(dir) * batch * hidden;
  h0 += state_off;
  c0 += state_off;
  h_t += state_off;
  c_t += state_off;

  extern __shared__ float4 smem4[];
  T_in* ring = reinterpret_cast<T_in*>(smem4);
  float* hs = reinterpret_cast<float*>(
      ring + static_cast<size_t>(kStages) * kChunk * wpitch);  // [row][unit]
  float* cs = hs + kTile * hpitch;                             // [row][unit]

  for (int idx = threadIdx.x; idx < kTile * hidden; idx += threads) {
    const int row = idx / hidden, unit = idx - row * hidden;
    const bool ok = b0 + row < batch;
    const size_t bj = static_cast<size_t>(b0 + row) * hidden + unit;
    hs[row * hpitch + unit] = ok ? h0[bj] : 0.0f;
    cs[row * hpitch + unit] = ok ? c0[bj] : 0.0f;
  }
  const int chunks = hidden / kChunk;
  // the ring: chunk q (counted over all steps) in stage q % kStages
#pragma unroll
  for (int q = 0; q < kStages - 1; ++q) {
    stage_w(ring + static_cast<size_t>(q) * kChunk * wpitch, w_hh_t,
            (q % chunks) * kChunk, hidden, threads);
    cp_commit();
  }
  __syncthreads();

  const int valid = min(kTile, batch - b0);
  const bool aligned = reinterpret_cast<uintptr_t>(xg) % 16 == 0;
  int q = 0;  // chunks consumed
  for (int s = 0; s < t_steps; ++s) {
    const int t = backward ? t_steps - 1 - s : s;
    const T_in* x = xg + static_cast<size_t>(t) * step_len;
    if (threadIdx.x == 0 && aligned && s + 1 < t_steps) {
      const T_in* nx = xg + static_cast<size_t>(backward ? t - 1 : t + 1) *
                                step_len + static_cast<size_t>(b0) * four_h;
      asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(nx),
                   "r"(static_cast<uint32_t>(valid * four_h * sizeof(T_in)))
                   : "memory");
    }
    // acc[m][j]: rows g, g+8 of m-tile m; n-tile j = (quad quad0 + j/2,
    // gates (i, f) for even j, (g, o) for odd j), columns 2tq, 2tq+1
    float acc[MT][NT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = b0 + m * 16 + g + (e >> 1) * 8;
          const int unit = (quad0 + j / 2) * 4 + tq;
          const int gate = (j & 1) * 2 + (e & 1);
          acc[m][j][e] =
              row < batch
                  ? load_f(x + static_cast<size_t>(row) * four_h +
                           gate * hidden + unit)
                  : 0.0f;
        }
    for (int c = 0; c < chunks; ++c, ++q) {
      cp_wait<kStages - 2>();
      __syncthreads();  // chunk q in place; stage of chunk q-1 free
      stage_w(ring + static_cast<size_t>((q + kStages - 1) % kStages) *
                         kChunk * wpitch,
              w_hh_t, ((c + kStages - 1) % chunks) * kChunk, hidden,
              threads);
      cp_commit();
      const T_in* ws = ring + static_cast<size_t>(q % kStages) * kChunk *
                                  wpitch;
#pragma unroll
      for (int kk = 0; kk < kChunk; kk += 8) {
        const int k0 = c * kChunk + kk;
        // A: h rows, k = k0 + tq (+4)
        uint32_t ahi[MT][4], alo[MT][4];
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const float* hr = hs + (m * 16 + g) * hpitch + k0 + tq;
          split(hr[0], ahi[m][0], alo[m][0]);
          split(hr[8 * hpitch], ahi[m][1], alo[m][1]);
          split(hr[4], ahi[m][2], alo[m][2]);
          split(hr[8 * hpitch + 4], ahi[m][3], alo[m][3]);
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          // B: k = tq (+4), column g of n-tile j: unit quad quad0 + j/2,
          // gate (j & 1) * 2 + g % 2, in the staged order [quad][gate][4]
          const int col = (quad0 + j / 2) * 16 +
                          ((j & 1) * 2 + (g & 1)) * 4 + g / 2;
          const float w0 = smem_w(ws + (kk + tq) * wpitch + col);
          const float w1 = smem_w(ws + (kk + tq + 4) * wpitch + col);
          if constexpr (sizeof(T_in) == 2) {
            const uint32_t b0v = bits_of(w0), b1v = bits_of(w1);
#pragma unroll
            for (int m = 0; m < MT; ++m) {
              mma(acc[m][j], alo[m], b0v, b1v);
              mma(acc[m][j], ahi[m], b0v, b1v);
            }
          } else {
            uint32_t b0h, b0l, b1h, b1l;
            split(w0, b0h, b0l);
            split(w1, b1h, b1l);
#pragma unroll
            for (int m = 0; m < MT; ++m) {
              mma(acc[m][j], alo[m], b0h, b1h);
              mma(acc[m][j], ahi[m], b0l, b1l);
              mma(acc[m][j], ahi[m], b0h, b1h);
            }
          }
        }
      }
    }
    __syncthreads();  // every read of h done
    T_in* ys_t = ys + static_cast<size_t>(t) * batch * hidden;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < NT; j += 2)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = m * 16 + g + half * 8;
          const int unit = (quad0 + j / 2) * 4 + tq;
          const float ig = sigmoid_f(acc[m][j][2 * half]);
          const float fg = sigmoid_f(acc[m][j][2 * half + 1]);
          const float gg = tanh_f(acc[m][j + 1][2 * half]);
          const float og = sigmoid_f(acc[m][j + 1][2 * half + 1]);
          float* cp = cs + r * hpitch + unit;
          const float cn = fg * *cp + ig * gg;
          *cp = cn;
          const float hn = og * tanh_f(cn);
          hs[r * hpitch + unit] = hn;
          if (b0 + r < batch)
            store_f(ys_t + static_cast<size_t>(b0 + r) * hidden + unit, hn);
        }
    __syncthreads();  // the new h in place
  }
  cp_wait<0>();
  for (int idx = threadIdx.x; idx < kTile * hidden; idx += threads) {
    const int row = idx / hidden, unit = idx - row * hidden;
    if (b0 + row < batch) {
      const size_t bj = static_cast<size_t>(b0 + row) * hidden + unit;
      h_t[bj] = hs[row * hpitch + unit];
      c_t[bj] = cs[row * hpitch + unit];
    }
  }
}

size_t smem_bytes(int hidden, int tile, int itemsize) {
  return static_cast<size_t>(kStages) * kChunk * (4 * hidden + kWPad) *
             itemsize +
         static_cast<size_t>(2) * tile * (hidden + kHPad) * 4;
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

template <typename T_in, int MT, int NT>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const auto kernel = lstm_wave_mma_kernel<T_in, MT, NT>;
  const int tile = 16 * MT;
  const int threads = a.hidden / (2 * NT) * 32;
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
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const T_in*>(a.xg), static_cast<const T_in*>(a.w_hh_t), a.h0,
      a.c0, static_cast<T_in*>(a.ys), a.h_t, a.c_t, a.t_steps, a.batch,
      a.hidden, a.reverse);
  return cudaGetLastError();
}

}  // namespace

// As lstm_wave.cu's entry point; rows = the tile: 16 or 32 (MT = 1 or 2
// m-tiles), H = 128 or 256 (H/16 n-tiles a warp, 8 warps).
extern "C" int lstm_wave(const void* xg, const void* w_hh_t, const void* h0,
                         const void* c0, void* ys, void* h_t, void* c_t,
                         int t_steps, int batch, int hidden, int ndir,
                         int reverse, int is_bf16, int rows, int device,
                         void* stream) {
  if ((hidden != 128 && hidden != 256) || batch < 1 || t_steps < 0 ||
      (ndir != 1 && ndir != 2) || (rows != 16 && rows != 32))
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem_bytes(hidden, rows, is_bf16 ? 2 : 4) > kMaxSmem - kBarrierSmem)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a{xg, w_hh_t, static_cast<const float*>(h0),
               static_cast<const float*>(c0), ys, static_cast<float*>(h_t),
               static_cast<float*>(c_t), t_steps, batch, hidden, ndir,
               reverse, device};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int mt = rows / 16;
#define TF32X3_LAUNCH(T)                                      \
  (hidden == 256                                              \
       ? (mt == 2 ? launch<T, 2, 16>(a, s) : launch<T, 1, 16>(a, s)) \
       : (mt == 2 ? launch<T, 2, 8>(a, s) : launch<T, 1, 8>(a, s)))
  err = is_bf16 ? TF32X3_LAUNCH(__nv_bfloat16) : TF32X3_LAUNCH(float);
#undef TF32X3_LAUNCH
  return static_cast<int>(err);
}

extern "C" const char* lstm_wave_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
