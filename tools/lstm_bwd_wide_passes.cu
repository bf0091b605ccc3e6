// A variant of fnssl_tpu_torch/kernels/csrc/lstm_bwd_wide.cu (K2 above H =
// 256), kept out of the package because it measured slower: 32-row tiles in
// one wave, the step's product in two passes over the gate blocks. Built
// and timed only by tools/lstm_bwd_wide_cells.py --passes; nothing else
// loads it.
//
// The contract is the package source's (the replay of c into cs, dgates
// over g, dh0 and dc0; every product in float32 FMAs). What differs: the
// dgates stage holds 4 / P of the gate blocks, tile x (4H / P + 4) float32,
// since a 32-row tile's whole dgates (262 KB at H = 512) do not fit a CTA's
// 227 KB and half of them do. dh = sum over the gate blocks e of dgates_e @
// W_hh[e H : (e + 1) H]: the cell part computes all four dgates of a pair,
// writes them over g and stages the first pass's blocks; a later pass
// waits for every read of the stage (a barrier), stages its own blocks,
// which the thread reads back from g_t where it wrote them, then a barrier
// and its part of the product. Each W_hh value read from L2 then serves 32
// rows instead of 16: at (298, 4096, 512), 128 CTAs in one wave read 160 GB
// of W_hh a launch where 256 16-row tiles in two waves read 320 GB.
// The plan (R, J, P): R of 8 (P = 2), or 4, 2, 1 (P = 1) rows a thread at J
// = 1 column a lane up to H = 512; 2 or 1 at J = 2 above. KB = block_k(R)
// k's of W_hh a register block and the CTAs' 8 offsets of k (inside each
// pass) as in the package source. On an H100 80GB HBM3 at 700 W, at (298,
// 4096, 512), in one call with the package's 16-row tile (78.6-78.8 ms
// fp32): 89.3-89.4 ms, and 87.2 with every CTA starting at k = 0
// (tools/lstm_bwd_wide_cells.py --plans --passes; PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <set>
#include <utility>

namespace {

constexpr int kUnits = 4;             // hidden units of a column a thread owns
constexpr int kLanes = 8;             // unit lanes of a warp
constexpr int kGroups = 4;            // row groups of a warp, and of a CTA
constexpr int kPad = 4;               // floats a row (dgates, dc) is padded by
constexpr int kMaxThreads = 512;      // threads a CTA, at most
constexpr int kMinHidden = 288;       // the widths this source takes
constexpr int kMaxHidden = 1024;
constexpr size_t kMaxSmem = 232448;   // shared memory a block may use (227 KB)

// k's of W_hh a register block at R rows a thread, the package source's
// rule: 8 at R = 4, 4 elsewhere (8 at R = 8 spills at 128 registers)
__host__ __device__ constexpr int block_k(int r) { return r == 4 ? 8 : 4; }

// warps a CTA: the H / 32 columns, J to a warp
__host__ __device__ constexpr int warps(int hidden, int j) {
  return (hidden / 32 + j - 1) / j;
}

// shared memory of one CTA: the dgates stage [tile][4H / P + pad] and dc
// [tile][H + pad], float32
__host__ __device__ constexpr size_t smem_bytes(int hidden, int tile,
                                                int passes) {
  return static_cast<size_t>(tile) *
         (4 * hidden / passes + kPad + hidden + kPad) * 4;
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

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  const unsigned int v = *reinterpret_cast<const unsigned int*>(p);
  return make_float2(__uint_as_float(v << 16),
                     __uint_as_float(v & 0xffff0000u));
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store2(float* p, float2 v) {
  *reinterpret_cast<float2*>(p) = v;
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

__device__ __forceinline__ float get(const float2& v, int u) {
  return u == 0 ? v.x : v.y;
}

// The replay's step of one (row, unit) pair: c_t from c_{t-1} and the
// gates i, f, g.
__device__ __forceinline__ float replay(float gi, float gf, float gg,
                                        float c) {
  return sigmoid_f(gf) * c + sigmoid_f(gi) * tanh_f(gg);
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

// The arrays of direction `dir` and of the tile that starts at row b0.
template <typename T_in>
struct Tile {
  float* g;
  float* cs;
  const float* w_hh;
  const float* c0;
  const T_in* dys;
  const float* dh_t;
  const float* dc_t;
  float* dh0;
  float* dc0;
};

template <typename T_in>
__device__ __forceinline__ Tile<T_in> tile_of(
    float* g, float* cs, const float* w_hh, const float* c0, const T_in* dys,
    const float* dh_t, const float* dc_t, float* dh0, float* dc0,
    int t_steps, int batch, int hidden, int dir, int b0) {
  const size_t four_h = 4 * static_cast<size_t>(hidden);
  const size_t rows_off =
      static_cast<size_t>(dir) * t_steps * batch * hidden +
      static_cast<size_t>(b0) * hidden;
  const size_t state_off = (static_cast<size_t>(dir) * batch + b0) * hidden;
  return {g + static_cast<size_t>(dir) * t_steps * batch * four_h +
              static_cast<size_t>(b0) * four_h,
          cs + rows_off,
          w_hh + static_cast<size_t>(dir) * four_h * hidden,
          c0 + state_off,
          dys + rows_off,
          dh_t + state_off,
          dc_t + state_off,
          dh0 + state_off,
          dc0 + state_off};
}

// W_hh rows k0 .. k0 + KB - 1 at the thread's units of each column, from L2
template <int J, int KB>
__device__ __forceinline__ void load_block(float4 (&w)[J][KB],
                                           const float* w_hh, int k0,
                                           const int (&u)[J], int hidden) {
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int e = 0; e < KB; ++e)
      w[j][e] = __ldg(reinterpret_cast<const float4*>(
          w_hh + static_cast<size_t>(k0 + e) * hidden + u[j]));
}

// acc[i][j][u] += dgates[row i][k0 + e] * w[j][e].u for the KB k's of a
// block: each 16-byte load of a row's 4 k's feeds 16 J FMAs.
template <int J, int R, int KB>
__device__ __forceinline__ void fma_block(float (&acc)[R][J][kUnits],
                                          const float4 (&w)[J][KB],
                                          const float* dgrow, int k0,
                                          int row_stride) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int h = 0; h < KB; h += 4) {
      const float4 d4 = *reinterpret_cast<const float4*>(
          dgrow + i * row_stride + k0 + h);
      const float dv[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
      for (int j = 0; j < J; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float4& wv = w[j][h + e];
          acc[i][j][0] = fmaf(dv[e], wv.x, acc[i][j][0]);
          acc[i][j][1] = fmaf(dv[e], wv.y, acc[i][j][1]);
          acc[i][j][2] = fmaf(dv[e], wv.z, acc[i][j][2]);
          acc[i][j][3] = fmaf(dv[e], wv.w, acc[i][j][3]);
        }
    }
}

// J: columns of 32 units a lane owns (1, or 2 above H = 512); R: rows of
// the tile a thread owns (tiles of 4 R rows); P: passes of the product a
// step (the stage holds 4 / P gate blocks); T_in: dy's dtype.
template <typename T_in, int J, int R, int P>
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
  constexpr int blocks = 4 / P;     // gate blocks a pass
  constexpr int KB = block_k(R);    // k's of a W_hh register block
  const int four_h = 4 * hidden;
  const int span = blocks * hidden;  // k's a pass
  const int pitch = span + kPad;     // floats a row of the stage
  const int dc_pitch = hidden + kPad;
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
  const Tile<T_in> a = tile_of(g, cs, w_hh, c0, dys, dh_t, dc_t, dh0, dc0,
                               t_steps, batch, hidden, dir, b0);

  extern __shared__ float4 smem_v4[];
  float* dg = reinterpret_cast<float*>(smem_v4);  // stage [tile][pitch]
  float* dcs = dg + tile * pitch;                 // dc [tile][dc_pitch]

  auto time_of = [&](int s) { return backward ? t_steps - 1 - s : s; };
  auto mine = [&](int j) { return j == 0 || two; };  // column j is stored
  // the thread's own (row, unit) slots of dc: no other thread reads them
  auto dc_at = [&](int row, int j) { return dcs + row * dc_pitch + u[j]; };

  // the replay of c, in the forward's walk order, for the thread's pairs;
  // c_t waits in dc's slots
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = rg + kGroups * i;
#pragma unroll
    for (int j = 0; j < J; ++j)
      if (mine(j) && row < valid)
        store4(dc_at(row, j),
               load4(a.c0 + static_cast<size_t>(row) * hidden + u[j]));
  }
  for (int s = 0; s < t_steps; ++s) {
    const float* gt = a.g + static_cast<size_t>(time_of(s)) * gate_step;
    float* c_out = a.cs + static_cast<size_t>(time_of(s)) * unit_step;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = rg + kGroups * i;
      if (row >= valid) continue;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        if (!mine(j)) continue;
        const float* p = gt + static_cast<size_t>(row) * four_h + u[j];
        const float4 gi = __ldg(reinterpret_cast<const float4*>(p));
        const float4 gf = __ldg(reinterpret_cast<const float4*>(p + hidden));
        const float4 gg =
            __ldg(reinterpret_cast<const float4*>(p + 2 * hidden));
        float* cp = dc_at(row, j);
        const float4 c = load4(cp);
        const float4 cn = make_float4(replay(gi.x, gf.x, gg.x, c.x),
                                      replay(gi.y, gf.y, gg.y, c.y),
                                      replay(gi.z, gf.z, gg.z, c.z),
                                      replay(gi.w, gf.w, gg.w, c.w));
        store4(cp, cn);
        store4(c_out + static_cast<size_t>(row) * hidden + u[j], cn);
      }
    }
  }

  // the walk's carries: dh (the product's sums) and dc, from dhT and dcT
  float acc[R][J][kUnits];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = rg + kGroups * i;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const size_t o = static_cast<size_t>(row) * hidden + u[j];
      const bool ok = row < valid;
      const float4 h4 = ok ? load4(a.dh_t + o)
                           : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
      for (int q = 0; q < kUnits; ++q) acc[i][j][q] = get(h4, q);
      if (ok && mine(j)) store4(dc_at(row, j), load4(a.dc_t + o));
    }
  }

  // (the walk reads back only the thread's own cs and g: no barrier)
  const float* dgrow = dg + rg * pitch;  // the thread's first row
  const int row_stride = kGroups * pitch;
  float4 w0[J][KB], w1[J][KB];
  // CTAs start each pass's product at 8 offsets of its k's (wrapping round
  // inside the pass), spread over L2, as the package source does
  const int k_off = (blockIdx.x & 7) * (span / 8);
  load_block<J, KB>(w0, a.w_hh, k_off, u, hidden);
  for (int k = 0; k < t_steps; ++k) {
    const int s = t_steps - 1 - k;  // the walk step being undone
    const int t = time_of(s);
    float* g_t = a.g + static_cast<size_t>(t) * gate_step;
    const float* c_now = a.cs + static_cast<size_t>(t) * unit_step;
    const float* c_prev =
        s > 0 ? a.cs + static_cast<size_t>(time_of(s - 1)) * unit_step
              : a.c0;
    const T_in* dy_t = a.dys + static_cast<size_t>(t) * unit_step;

    // 1. the cell part: dgates over g, the first pass's blocks into the
    // stage
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = rg + kGroups * i;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        if (!mine(j)) continue;
        float o[kUnits][4];  // [unit][gate]
        if (row < valid) {
          const size_t r4 = static_cast<size_t>(row) * four_h + u[j];
          const size_t r1 = static_cast<size_t>(row) * hidden + u[j];
          const float4 gi = load4(g_t + r4), gf = load4(g_t + r4 + hidden),
                       gc = load4(g_t + r4 + 2 * hidden),
                       go = load4(g_t + r4 + 3 * hidden);
          const float4 cn = load4(c_now + r1), cp = load4(c_prev + r1);
          const float4 dy = load4(dy_t + r1);
          float* dcp = dc_at(row, j);
          const float4 dc4 = load4(dcp);
          float dc[kUnits] = {dc4.x, dc4.y, dc4.z, dc4.w};
#pragma unroll
          for (int q = 0; q < kUnits; ++q)
            cell(get(gi, q), get(gf, q), get(gc, q), get(go, q), get(cn, q),
                 get(cp, q), get(dy, q), acc[i][j][q], dc[q], o[q]);
          store4(dcp, make_float4(dc[0], dc[1], dc[2], dc[3]));
#pragma unroll
          for (int e = 0; e < 4; ++e)
            store4(g_t + r4 + e * hidden,
                   make_float4(o[0][e], o[1][e], o[2][e], o[3][e]));
        } else {
#pragma unroll
          for (int q = 0; q < kUnits; ++q)
#pragma unroll
            for (int e = 0; e < 4; ++e) o[q][e] = 0.0f;
        }
#pragma unroll
        for (int e = 0; e < blocks; ++e)
          store4(dg + row * pitch + e * hidden + u[j],
                 make_float4(o[0][e], o[1][e], o[2][e], o[3][e]));
      }
    }

    // 2. dh = dgates_t @ W_hh in P passes over the gate blocks, W_hh a
    // register block ahead
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < J; ++j)
#pragma unroll
        for (int q = 0; q < kUnits; ++q) acc[i][j][q] = 0.0f;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (p > 0) {
        __syncthreads();  // every read of the last pass's stage done
        // this pass's blocks, read back from g_t, where this thread wrote
        // them
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const int row = rg + kGroups * i;
#pragma unroll
          for (int j = 0; j < J; ++j) {
            if (!mine(j)) continue;
#pragma unroll
            for (int e = 0; e < blocks; ++e)
              store4(dg + row * pitch + e * hidden + u[j],
                     row < valid
                         ? load4(g_t + static_cast<size_t>(row) * four_h +
                                 (p * blocks + e) * hidden + u[j])
                         : make_float4(0.0f, 0.0f, 0.0f, 0.0f));
          }
        }
      }
      __syncthreads();  // the pass's stage in place
      const int k0 = p * span;
      // the first block of the next pass, or of the next step's first
      const int k_last = (p + 1 < P ? k0 + span : 0) + k_off;
#pragma unroll 1
      for (int kg = 0; kg < span; kg += 2 * KB) {
        int kk = kg + k_off;  // k inside the pass: the stage's column
        kk = kk < span ? kk : kk - span;
        load_block<J, KB>(w1, a.w_hh, k0 + kk + KB, u, hidden);
        fma_block<J, R, KB>(acc, w0, dgrow, kk, row_stride);
        int next = kk + 2 * KB;
        next = kg + 2 * KB == span ? k_last
               : next < span      ? k0 + next
                                  : k0 + next - span;
        load_block<J, KB>(w0, a.w_hh, next, u, hidden);
        fma_block<J, R, KB>(acc, w1, dgrow, kk + KB, row_stride);
      }
    }
    __syncthreads();  // every read of the stage done
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = rg + kGroups * i;
    if (row < valid) {
#pragma unroll
      for (int j = 0; j < J; ++j) {
        if (!mine(j)) continue;
        const size_t o = static_cast<size_t>(row) * hidden + u[j];
        store4(a.dh0 + o, make_float4(acc[i][j][0], acc[i][j][1],
                                      acc[i][j][2], acc[i][j][3]));
        store4(a.dc0 + o, load4(dc_at(row, j)));
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
template <typename T_in, typename Kernel>
cudaError_t launch(Kernel kernel, const Args& a, int tile, int threads,
                   size_t smem, cudaStream_t stream) {
  {
    static std::mutex mu;
    static std::set<std::pair<const void*, int>> raised;
    std::lock_guard<std::mutex> lock(mu);
    const auto key = std::make_pair(reinterpret_cast<const void*>(kernel),
                                    a.device);
    if (!raised.count(key)) {
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(kMaxSmem));
      if (err != cudaSuccess) return err;
      raised.insert(key);
    }
  }
  const dim3 grid((a.batch + tile - 1) / tile, a.ndir);
  kernel<<<grid, threads, smem, stream>>>(
      a.g, a.cs, a.w_hh, a.c0, static_cast<const T_in*>(a.dys), a.dh_t,
      a.dc_t, a.dh0, a.dc0,
      a.t_steps, a.batch, a.hidden, a.reverse);
  return cudaGetLastError();
}

template <typename T_in, int J, int R, int P>
cudaError_t tiles(const Args& a, cudaStream_t s) {
  constexpr int tile = kGroups * R;
  return launch<T_in>(lstm_bwd_wide_kernel<T_in, J, R, P>, a, tile,
                      32 * warps(a.hidden, J), smem_bytes(a.hidden, tile, P),
                      s);
}

// the plans (rows a thread, columns a lane, passes) this source is built
// for: 8 rows in 2 passes and 4, 2 or 1 in one at one column; 2 or 1 rows
// in one pass at two
__host__ __device__ constexpr bool built(int rows, int columns,
                                         int passes) {
  return columns == 1 ? (rows == 8 && passes == 2) ||
                            ((rows == 4 || rows == 2 || rows == 1) &&
                             passes == 1)
                      : columns == 2 && (rows == 2 || rows == 1) &&
                            passes == 1;
}

template <typename T_in>
cudaError_t by_plan(const Args& a, int rows, int columns, cudaStream_t s) {
  if (columns == 2)
    return rows == 2 ? tiles<T_in, 2, 2, 1>(a, s) : tiles<T_in, 2, 1, 1>(a, s);
  return rows == 8   ? tiles<T_in, 1, 8, 2>(a, s)
         : rows == 4 ? tiles<T_in, 1, 4, 1>(a, s)
         : rows == 2 ? tiles<T_in, 1, 2, 1>(a, s)
                     : tiles<T_in, 1, 1, 1>(a, s);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// Plain C entry point (bound with ctypes). Every tensor carries `ndir`
// directions stacked in front; direction d's forward walked t = T-1 .. 0
// when reverse ^ d is 1; `is_bf16` gives dys' dtype (w_hh is float32).
// The plan: `rows` a thread (tiles of 4 x `rows` rows), `columns` of 32
// units a lane (1 up to H = 512, 2 above) and `passes` of the product a
// step, as `built` lists them. On `stream` of device `device`; does not
// synchronise, allocates nothing, and returns the cudaError_t of the launch
// (0 on success). H must be a multiple of 32 from 288 to 1024, the CTA's
// threads and shared memory within 512 and 227 KB and every array 16-byte
// aligned (16-byte loads and stores); other arguments are refused with an
// error, never run another way.
extern "C" int lstm_bwd_wide(void* g, void* cs, const void* w_hh,
                             const void* c0, const void* dys,
                             const void* dh_t, const void* dc_t, void* dh0,
                             void* dc0, int t_steps, int batch, int hidden,
                             int ndir, int reverse, int is_bf16, int rows,
                             int columns, int passes, int device,
                             void* stream) {
  if (hidden < kMinHidden || hidden > kMaxHidden || hidden % 32 != 0 ||
      batch < 1 || t_steps < 0 || (ndir != 1 && ndir != 2) ||
      !built(rows, columns, passes) || (columns == 2) != (hidden > 512))
    return static_cast<int>(cudaErrorInvalidValue);
  const void* arrays[] = {g, cs, w_hh, c0, dys, dh_t, dc_t, dh0, dc0};
  for (const void* p : arrays)
    if (!aligned16(p)) return static_cast<int>(cudaErrorMisalignedAddress);
  if (smem_bytes(hidden, kGroups * rows, passes) > kMaxSmem ||
      32 * warps(hidden, columns) > kMaxThreads)
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
  err = is_bf16 ? by_plan<__nv_bfloat16>(a, rows, columns, s)
                : by_plan<float>(a, rows, columns, s);
  return static_cast<int>(err);
}

extern "C" const char* lstm_bwd_wide_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
