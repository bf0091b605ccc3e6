// The backward recurrence of an LSTM layer (K2) for 256 < H <= 1024, where
// neither lstm_bwd_cluster.cu nor lstm_bwd_wave.cu takes the width: FN-SSL
// at hidden_size 512 (narrow-band LSTMs of H = 512).
//
// Replaces the sequential part of fnssl_tpu/kernels/lstm_pallas.py:
// _lstm_backward (:269-343), the custom_vjp backward of the TPU kernel
// _lstm_kernel (a lax.scan in JAX, which trains at any H): its replay of c
// and its reverse walk, without the weight sums, which stay matrix products
// outside (models/lstm.py). lstm_cuda.bwd_route sends every H above 256
// here. The contract of lstm_bwd_wave.cu and of lstm_cuda.lstm_bwd_plain,
// per direction d of ndir (1 or 2):
//   g (ndir, T, B, 4H) float32: the gate pre-activations
//        x_t @ W_ih^T + b + h_{t-1} @ W_hh^T, computed outside; on return
//        it holds dgates (in place);
//   w_hh (ndir, 4H, H) float32 (the wrapper widens a bfloat16 W_hh once),
//        products in float32;  c0, dhT, dcT (ndir, B, H) float32;  dys
//        (ndir, T, B, H) in the dtype of ys (float32 or bfloat16);  cs
//        (ndir, T, B, H) float32 scratch;  out dh0, dc0 (ndir, B, H)
//        float32.
//   Replay: c_t = sig(f) c_{t-1} + sig(i) tanh(g), stored in cs.
//   Reverse walk, from the last walk step to the first:
//     dh_tot = dy_t + dh;  dct = dc + dh_tot o (1 - tanh^2 c_t);
//     dgates_t = [dct g i (1-i), dct c_{t-1} f (1-f), dct i (1-g^2),
//                 dh_tot tanh(c_t) o (1-o)]  (torch order i, f, g, o);
//     dh = dgates_t @ W_hh;  dc = dct f.
//   Direction d's forward walked t = T-1 .. 0 when reverse ^ d is 1.
//
// What bounds it on an H100: its FLOPs. The serial product dgates_t @ W_hh
// is B 4H H float32 FMAs a step: at (T, B, H) = (298, 4096, 512) 38.2 ms at
// the card's 67 TFLOP/s, while the bytes it must move (g read, dgates
// written, dys read: 12.5 GB) take 3.7 ms. Why the other sources stop at
// H = 256: lstm_bwd_cluster.cu keeps W_hh in a cluster's shared memory (4 MB
// in float32 at H = 512, more than 16 CTAs' 227 KB), and lstm_bwd_wave.cu
// lays 1024/H row groups on a CTA of 256 threads of 4 units each.
//
// Design (simple and right first; lstm_bwd_wave.cu's tile, widened): a CTA
// owns a tile of 4 R batch rows for all T steps (rows are independent, so no
// dgates and no dh cross a CTA) and keeps the step's dgates in shared memory,
// 4H + 4 floats a row (8.2 KB at H = 512). A warp is 8 unit lanes x 4 row
// groups, as in lstm_bwd_wave.cu: its loads of W_hh are 128 contiguous bytes
// that its 4 row groups share, and its loads of dgates are 4 rows whose
// padding puts them in distinct banks. Thread (warp w, row group rg, unit
// lane l) owns units u = (w 8 + l) 4 .. + 3 of the R rows rg, rg + 4, ..,
// rg + 4 (R-1), and, above H = 512, also the units of column w + W (J = 2
// columns of 32 units a lane; W warps a CTA, W = ceil(H / 32 / J): 9 to 16
// warps, 288 to 512 threads). Where H / 32 is odd, the last warp's second
// column lies past H: it repeats its first column's loads and sums, which
// keeps the product free of branches, and stores nothing of it. The same
// (row, unit) pairs hold the product's sums and the cell part, so dh never
// leaves registers.
//   The replay first: each thread walks its pairs forward through G's i, f
//   and g rows and stores c into cs.
//   Then, each walk step:
//   1. the cell part of the thread's pairs, from G_t, c_t, c_{t-1} (both
//      from cs, written by this thread) and dy_t, loaded straight into
//      registers; dgates go into shared memory and over g;
//   2. a barrier (the tile's dgates in place);
//   3. the product dh = dgates_t @ W_hh over k = 0 .. 4H-1: W_hh is read from
//      L2 (read-only path) straight into registers, 4 k's x 4 units a
//      register block a column, a block ahead (the last block of a step loads
//      the next step's first); dgates are read from shared memory as 4 k's of
//      a row a load, each feeding 16 J FMAs;
//   4. a barrier (every read of dgates done).
// One CTA an SM (__launch_bounds__(512, 1): up to 128 registers a thread
// for 8 R J carries, acc and dc, and two W_hh blocks of 16 J). The plan
// (lstm_cuda.bwd_wide_plan) picks R of 4, 2, 1 (2, 1 at J = 2) for the
// fewest rows on the busiest SM: at (298, 4096, 512) R = 4, 16-row tiles,
// 256 CTAs in two waves, 32 rows on the busiest SM (31.03 if spread evenly).
// Shared memory 131.3 KB at H = 512 (R = 4) and 131.2 KB at H = 1024 (R =
// 2). Each CTA reads W_hh from L2 once a step for its 4 R rows.
// The ragged edge of B is masked, never padded by the caller: a masked
// row's dgates, dh and dc are zeros, and it is never stored. G is read
// through the non-coherent path (__ldg) in the replay only, before the walk
// writes any dgates over it, by the thread that later writes them. There
// are no atomics: the same inputs give the same bits on every run. All
// arithmetic is float32 FMAs outside the tensor cores, for both dtypes; a
// bfloat16 dy is widened as it is loaded. sigmoid and tanh use the fast exp
// (__expf, __fdividef), as in the sibling kernels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <set>

namespace {

constexpr int kUnits = 4;             // hidden units of a column a thread owns
constexpr int kLanes = 8;             // unit lanes of a warp
constexpr int kGroups = 4;            // row groups of a warp, and of a CTA
constexpr int kPad = 4;               // floats a row of dgates is padded by
constexpr int kBlock = 4;             // k's of W_hh a register block
constexpr int kMaxThreads = 512;      // threads a CTA, at most
constexpr int kMinHidden = 288;       // the widths this source takes
constexpr int kMaxHidden = 1024;
constexpr size_t kMaxSmem = 232448;   // shared memory a block may use (227 KB)

// columns of 32 units a lane owns: 1 up to H = 512, 2 above
__host__ __device__ constexpr int columns(int hidden) {
  return hidden / 32 <= 16 ? 1 : 2;
}

// warps a CTA: the H / 32 columns, J to a warp
__host__ __device__ constexpr int warps(int hidden) {
  return (hidden / 32 + columns(hidden) - 1) / columns(hidden);
}

// shared memory of one CTA: dgates [tile][4H + pad] float32
__host__ __device__ constexpr size_t smem_bytes(int hidden, int tile) {
  return static_cast<size_t>(tile) * (4 * hidden + kPad) * 4;
}

// four bfloat16 values, widened (the lower address in the low half)
__device__ __forceinline__ float4 widen(uint2 v) {
  return make_float4(__uint_as_float(v.x << 16),
                     __uint_as_float(v.x & 0xffff0000u),
                     __uint_as_float(v.y << 16),
                     __uint_as_float(v.y & 0xffff0000u));
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  return widen(*reinterpret_cast<const uint2*>(p));
}

__device__ __forceinline__ float sigmoid_f(float x) {
  return __fdividef(1.0f, 1.0f + __expf(-x));
}

__device__ __forceinline__ float tanh_f(float x) {
  return 2.0f * sigmoid_f(2.0f * x) - 1.0f;
}

__device__ __forceinline__ float get(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

// The cell part of one (row, unit) pair: its dgates d from its gates, c_t
// (ct), c_{t-1} (cp), dy_t and dh; dc moves one walk step back.
__device__ __forceinline__ void cell(float gi, float gf, float gg, float go,
                                     float ct, float cp, float dy, float dh,
                                     float& dc, float (&d)[4]) {
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
}

// W_hh rows k0 .. k0 + kBlock - 1 at the thread's units of each column,
// from L2
template <int J>
__device__ __forceinline__ void load_block(float4 (&w)[J][kBlock],
                                           const float* w_hh, int k0,
                                           const int (&u)[J], int hidden) {
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int e = 0; e < kBlock; ++e)
      w[j][e] = __ldg(reinterpret_cast<const float4*>(
          w_hh + static_cast<size_t>(k0 + e) * hidden + u[j]));
}

// acc[i][j][u] += dgates[row i][k0 + e] * w[j][e].u for the kBlock k's of a
// block: one 16-byte load of a row's 4 k's feeds 16 J FMAs.
template <int J, int R>
__device__ __forceinline__ void fma_block(float (&acc)[R][J][kUnits],
                                          const float4 (&w)[J][kBlock],
                                          const float* dgrow, int k0,
                                          int row_stride) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const float4 d4 =
        *reinterpret_cast<const float4*>(dgrow + i * row_stride + k0);
    const float dv[kBlock] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int e = 0; e < kBlock; ++e) {
        acc[i][j][0] = fmaf(dv[e], w[j][e].x, acc[i][j][0]);
        acc[i][j][1] = fmaf(dv[e], w[j][e].y, acc[i][j][1]);
        acc[i][j][2] = fmaf(dv[e], w[j][e].z, acc[i][j][2]);
        acc[i][j][3] = fmaf(dv[e], w[j][e].w, acc[i][j][3]);
      }
  }
}

// J: columns of 32 units a lane owns (1, or 2 above H = 512); R: rows of
// the tile a thread owns (tiles of 4 R rows); T_in: dy's dtype.
template <typename T_in, int J, int R>
__global__ void __launch_bounds__(kMaxThreads, 1)
lstm_bwd_wide_kernel(float* __restrict__ g, float* __restrict__ cs,
                     const float* __restrict__ w_hh,
                     const float* __restrict__ c0,
                     const T_in* __restrict__ dys,
                     const float* __restrict__ dh_t,
                     const float* __restrict__ dc_t, float* __restrict__ dh0,
                     float* __restrict__ dc0, int t_steps, int batch,
                     int hidden, int reverse) {
  constexpr int tile = kGroups * R;
  const int four_h = 4 * hidden;
  const int pitch = four_h + kPad;  // floats a row of dgates
  const int nwarps = blockDim.x / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int rg = lane / kLanes;  // rows rg + 4 i, i < R
  // the second column lies inside H (else it repeats the first)
  const bool two = J == 2 && warp + nwarps < hidden / 32;
  int u[J];
#pragma unroll
  for (int j = 0; j < J; ++j)
    u[j] = ((warp + (two ? j : 0) * nwarps) * kLanes + lane % kLanes) *
           kUnits;
  const int dir = blockIdx.y;
  const int b0 = blockIdx.x * tile;
  const int valid = min(tile, batch - b0);  // rows of the tile inside B
  const bool backward = (reverse ^ dir) != 0;  // the forward's walk
  const size_t gate_step = static_cast<size_t>(batch) * four_h;  // g per t
  const size_t unit_step = static_cast<size_t>(batch) * hidden;  // cs per t

  // this direction's and tile's arrays
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
  float* dg = reinterpret_cast<float*>(smem_v4);  // [tile][pitch]

  auto time_of = [&](int s) { return backward ? t_steps - 1 - s : s; };
  auto mine = [&](int j) { return j == 0 || two; };  // column j is stored

  // the replay of c, in the forward's walk order, for the thread's pairs
  {
    float ct[R][J][kUnits];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = rg + kGroups * i;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const float4 v = row < valid
                             ? load4(c0 + static_cast<size_t>(row) * hidden +
                                     u[j])
                             : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        ct[i][j][0] = v.x;
        ct[i][j][1] = v.y;
        ct[i][j][2] = v.z;
        ct[i][j][3] = v.w;
      }
    }
    for (int s = 0; s < t_steps; ++s) {
      const float* gt = g + static_cast<size_t>(time_of(s)) * gate_step;
      float* c_out = cs + static_cast<size_t>(time_of(s)) * unit_step;
      float4 gv[R][J][3];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int row = rg + kGroups * i;
        if (row < valid) {
#pragma unroll
          for (int j = 0; j < J; ++j) {
            const float* p = gt + static_cast<size_t>(row) * four_h + u[j];
            gv[i][j][0] = __ldg(reinterpret_cast<const float4*>(p));
            gv[i][j][1] = __ldg(reinterpret_cast<const float4*>(p + hidden));
            gv[i][j][2] =
                __ldg(reinterpret_cast<const float4*>(p + 2 * hidden));
          }
        }
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int row = rg + kGroups * i;
        if (row < valid) {
#pragma unroll
          for (int j = 0; j < J; ++j) {
#pragma unroll
            for (int q = 0; q < kUnits; ++q)
              ct[i][j][q] =
                  sigmoid_f(get(gv[i][j][1], q)) * ct[i][j][q] +
                  sigmoid_f(get(gv[i][j][0], q)) * tanh_f(get(gv[i][j][2], q));
            if (mine(j))
              *reinterpret_cast<float4*>(
                  c_out + static_cast<size_t>(row) * hidden + u[j]) =
                  make_float4(ct[i][j][0], ct[i][j][1], ct[i][j][2],
                              ct[i][j][3]);
          }
        }
      }
    }
  }

  // the walk's carries: dh (the product's sums) and dc, from dhT and dcT
  float acc[R][J][kUnits], dc[R][J][kUnits];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = rg + kGroups * i;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const size_t o = static_cast<size_t>(row) * hidden + u[j];
      const bool ok = row < valid;
      const float4 h4 = ok ? load4(dh_t + o)
                           : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      const float4 c4 = ok ? load4(dc_t + o)
                           : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
      for (int q = 0; q < kUnits; ++q) {
        acc[i][j][q] = get(h4, q);
        dc[i][j][q] = get(c4, q);
      }
    }
  }

  // (the walk reads back only the thread's own cs: no barrier)
  const float* dgrow = dg + rg * pitch;  // the thread's first row
  const int row_stride = kGroups * pitch;
  float4 w0[J][kBlock], w1[J][kBlock];
  load_block<J>(w0, w_hh, 0, u, hidden);
  for (int k = 0; k < t_steps; ++k) {
    const int s = t_steps - 1 - k;  // the walk step being undone
    const int t = time_of(s);
    float* g_t = g + static_cast<size_t>(t) * gate_step;
    const float* c_now = cs + static_cast<size_t>(t) * unit_step;
    const float* c_prev =
        s > 0 ? cs + static_cast<size_t>(time_of(s - 1)) * unit_step : c0;
    const T_in* dy_t = dys + static_cast<size_t>(t) * unit_step;

    // 1. the cell part: dgates into shared memory and over g
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = rg + kGroups * i;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        float o[kUnits][4];  // [unit][gate]
        if (row < valid) {
          const size_t r4 = static_cast<size_t>(row) * four_h + u[j];
          const size_t r1 = static_cast<size_t>(row) * hidden + u[j];
          const float4 gi = load4(g_t + r4), gf = load4(g_t + r4 + hidden),
                       gc = load4(g_t + r4 + 2 * hidden),
                       go = load4(g_t + r4 + 3 * hidden);
          const float4 cn = load4(c_now + r1), cp = load4(c_prev + r1);
          const float4 dy = load4(dy_t + r1);
#pragma unroll
          for (int q = 0; q < kUnits; ++q)
            cell(get(gi, q), get(gf, q), get(gc, q), get(go, q), get(cn, q),
                 get(cp, q), get(dy, q), acc[i][j][q], dc[i][j][q], o[q]);
        } else {
#pragma unroll
          for (int q = 0; q < kUnits; ++q) {
            dc[i][j][q] = 0.0f;
#pragma unroll
            for (int e = 0; e < 4; ++e) o[q][e] = 0.0f;
          }
        }
        if (mine(j)) {
          float* d = dg + row * pitch + u[j];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float4 v = make_float4(o[0][e], o[1][e], o[2][e], o[3][e]);
            *reinterpret_cast<float4*>(d + e * hidden) = v;
            if (row < valid)
              *reinterpret_cast<float4*>(
                  g_t + static_cast<size_t>(row) * four_h + u[j] +
                  e * hidden) = v;
          }
        }
      }
    }
    __syncthreads();  // the tile's dgates in place

    // 2. dh = dgates_t @ W_hh, W_hh a register block ahead
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < J; ++j)
#pragma unroll
        for (int q = 0; q < kUnits; ++q) acc[i][j][q] = 0.0f;
#pragma unroll 1
    for (int kg = 0; kg < four_h; kg += 2 * kBlock) {
      load_block<J>(w1, w_hh, kg + kBlock, u, hidden);
      fma_block<J, R>(acc, w0, dgrow, kg, row_stride);
      load_block<J>(w0, w_hh, kg + 2 * kBlock < four_h ? kg + 2 * kBlock : 0,
                    u, hidden);
      fma_block<J, R>(acc, w1, dgrow, kg + kBlock, row_stride);
    }
    __syncthreads();  // every read of dgates done
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = rg + kGroups * i;
    if (row < valid) {
#pragma unroll
      for (int j = 0; j < J; ++j) {
        if (!mine(j)) continue;
        const size_t o = static_cast<size_t>(row) * hidden + u[j];
        *reinterpret_cast<float4*>(dh0 + o) = make_float4(
            acc[i][j][0], acc[i][j][1], acc[i][j][2], acc[i][j][3]);
        *reinterpret_cast<float4*>(dc0 + o) = make_float4(
            dc[i][j][0], dc[i][j][1], dc[i][j][2], dc[i][j][3]);
      }
    }
  }
}

struct Args {
  float* g;
  float* cs;
  const float* w_hh;
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
template <typename T_in, int J, int R>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const auto kernel = lstm_bwd_wide_kernel<T_in, J, R>;
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
  const int tile = kGroups * R;
  const dim3 grid((a.batch + tile - 1) / tile, a.ndir);
  kernel<<<grid, 32 * warps(a.hidden), smem_bytes(a.hidden, tile), stream>>>(
      a.g, a.cs, a.w_hh, a.c0, static_cast<const T_in*>(a.dys), a.dh_t,
      a.dc_t, a.dh0, a.dc0, a.t_steps, a.batch, a.hidden, a.reverse);
  return cudaGetLastError();
}

template <typename T_in>
cudaError_t by_plan(const Args& a, int rows, cudaStream_t s) {
  if (columns(a.hidden) == 1)
    return rows == 4   ? launch<T_in, 1, 4>(a, s)
           : rows == 2 ? launch<T_in, 1, 2>(a, s)
                       : launch<T_in, 1, 1>(a, s);
  return rows == 2 ? launch<T_in, 2, 2>(a, s) : launch<T_in, 2, 1>(a, s);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// Plain C entry point (bound with ctypes). Every tensor carries `ndir`
// directions stacked in front; direction d's forward walked t = T-1 .. 0
// when reverse ^ d is 1; `is_bf16` gives dys' dtype (w_hh is float32).
// `rows` is the rows of the tile a thread owns (tiles of 4 rows x `rows`):
// 4, 2 or 1 up to H = 512, 2 or 1 above. On `stream` of device `device`;
// does not synchronise, allocates nothing, and returns the cudaError_t of
// the launch (0 on success). H must be a multiple of 32 from 288 to 1024
// and every array 16-byte aligned (16-byte loads and stores); other
// arguments are refused with an error, never run another way.
extern "C" int lstm_bwd_wide(void* g, void* cs, const void* w_hh,
                             const void* c0, const void* dys,
                             const void* dh_t, const void* dc_t, void* dh0,
                             void* dc0, int t_steps, int batch, int hidden,
                             int ndir, int reverse, int is_bf16, int rows,
                             int device, void* stream) {
  if (hidden < kMinHidden || hidden > kMaxHidden || hidden % 32 != 0 ||
      batch < 1 || t_steps < 0 || (ndir != 1 && ndir != 2) ||
      !(rows == 1 || rows == 2 || (rows == 4 && columns(hidden) == 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  const void* arrays[] = {g, cs, w_hh, c0, dys, dh_t, dc_t, dh0, dc0};
  for (const void* p : arrays)
    if (!aligned16(p)) return static_cast<int>(cudaErrorMisalignedAddress);
  if (smem_bytes(hidden, kGroups * rows) > kMaxSmem ||
      32 * warps(hidden) > kMaxThreads)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a{static_cast<float*>(g),
               static_cast<float*>(cs),
               static_cast<const float*>(w_hh),
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
  err = is_bf16 ? by_plan<__nv_bfloat16>(a, rows, s) : by_plan<float>(a, rows, s);
  return static_cast<int>(err);
}

extern "C" const char* lstm_bwd_wide_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
