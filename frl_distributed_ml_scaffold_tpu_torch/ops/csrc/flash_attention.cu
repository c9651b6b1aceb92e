// Flash attention for training, forward and backward, for Hopper (sm_90a).
// Built with nvcc into a shared library with a plain C interface and
// loaded with ctypes (ops/_build.py, ops/flash_attention.py).
//
// Replaces the TPU kernels of frl_distributed_ml_scaffold_tpu/ops/
// flash_attention.py:
//   frl_flash_fwd      <- _fwd_kernel      (launched by _fwd)
//   frl_flash_bwd_dq   <- _bwd_dq_kernel   (launched by _bwd)
//   frl_flash_bwd_dkv  <- _bwd_dkv_kernel  (launched by _bwd)
// and computes what they compute, with their numerics rules:
// - S = Q K^T takes the input dtype's values with an fp32 accumulator,
//   times 1/sqrt(D); masked scores (above the causal diagonal, or past T)
//   take -1e30, never -inf;
// - forward: online softmax in fp32, denominator floored at 1e-30,
//   lse = m + log(l); P rounded to V's dtype before the PV product; O
//   written in the input dtype;
// - dQ: delta = rowsum(dO * O) in fp32, p = exp(s - lse), dP = dO V^T in
//   fp32, dS = p (dP - delta) / sqrt(D) rounded to K's dtype before dS K;
// - dK/dV: the same p and dS, unrounded: dV = P^T dO and dK = dS^T Q in
//   fp32; each output cast to its input's dtype.
//
// The TPU kernels carry their accumulators in VMEM scratch across a grid
// axis because a TPU grid runs in order. Here blocks run in parallel and
// in no order, so each accumulation is a loop inside one block:
// - fwd: one block per (b, h, 64-query tile) loops over the key tiles up
//   to the diagonal, keeping the running max, denominator and O
//   accumulator in registers;
// - dQ: one block per (b, h, 64-query tile) forms delta from its own dO
//   and O tiles, then loops over the key tiles up to the diagonal;
// - dK/dV: one block per (b, h, 64-key tile) loops over the query tiles
//   from the diagonal down, recomputing delta per query tile. The
//   flash-attention-2 split: every output element has one writer, so no
//   atomics and no second pass.
// Under causal masking the query-tile kernels run the heaviest tiles (the
// last ones) first, so the short tiles fill the tail of the launch.
//
// Bound: at the GPT-2-medium training shape ([8, 1024, 16, 64] bf16,
// causal) a forward moves 67 MB and does 1.7e10 flops, 254 flops a byte,
// so on the tensor cores it would sit at the ridge between the two
// bounds. This first kernel runs every product as fp32 FMAs on the CUDA
// cores (67 TFLOP/s peak, not the tensor cores' 989), so it is bound by
// operations, and by how many FMAs each shared-memory load feeds.
//
// Design (right and simple first):
// - 256 threads as a 16 x 16 grid; every 64 x 64 (or 64 x D) product tile
//   gives each thread 4 rows (ty + 16 i) by 4 (or D / 16) columns
//   (tx + 16 j), so one thread holds the same rows of S, P and the output
//   accumulator, and a row's max and sum reduce over the 16 lanes of one
//   half-warp with shuffles.
// - Tiles are read from device memory through strides (the public
//   (B, T, H, D) layout needs no transpose), converted to fp32 once, and
//   kept in shared memory with an odd row stride (D + 1, 65), so both a
//   row and a column of a tile are read without bank conflicts and one
//   product routine (tile_mma) serves every product, transposed or not.
// - Rows and keys past T are loaded as zeros and masked; nothing past T is
//   read or written.
// Left for later: bf16 mma.sync / wgmma on the tensor cores, TMA or
// cp.async double buffering of the K/V (Q/dO) tiles, and 128-row tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;      // query rows and key rows per tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kLP = kTile + 1; // padded row stride of a 64 x 64 tile
constexpr float kNegInf = -1.0e30f;

// Slots of the stride table: tensor i's element strides along b, h and t
// are strides[3 i], [3 i + 1] and [3 i + 2].
enum Slot { kQ = 0, kK, kV, kO, kDO, kDQ, kDK, kDV, kSlots };

struct Strides {
  long long b[kSlots];
  long long h[kSlots];
  long long t[kSlots];
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Round to T and back: a value as a product with T operands sees it.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

// 64 rows x D of a (b, h) slice, rows row0.. with element stride st
// between rows, into dst (row stride D + 1) as fp32; rows >= n as zeros.
// Thread t loads row t / 4, columns (t % 4) * D / 4 onwards.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long st, int row0, int n) {
  constexpr int E = D / 4;
  const int r = threadIdx.x >> 2;
  const int c0 = (threadIdx.x & 3) * E;
  float* d = dst + r * (D + 1) + c0;
  if (row0 + r < n) {
    const T* s = src + static_cast<long long>(row0 + r) * st + c0;
#pragma unroll
    for (int e = 0; e < E; ++e) d[e] = to_float(s[e]);
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) d[e] = 0.f;
  }
}

// load_tile for dO, plus delta[r] = sum_d dO[r, d] * O[r, d] in fp32 for
// each of the 64 rows (0 past n). The four threads of a row are
// neighbouring lanes, so the row sum closes with two shuffles.
template <typename T, int D>
__device__ __forceinline__ void load_do_delta(float* dst, float* delta,
                                              const T* dout, long long st_do,
                                              const T* out, long long st_o,
                                              int row0, int n) {
  constexpr int E = D / 4;
  const int r = threadIdx.x >> 2;
  const int c0 = (threadIdx.x & 3) * E;
  float* d = dst + r * (D + 1) + c0;
  float acc = 0.f;
  if (row0 + r < n) {
    const T* g = dout + static_cast<long long>(row0 + r) * st_do + c0;
    const T* o = out + static_cast<long long>(row0 + r) * st_o + c0;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const float gv = to_float(g[e]);
      d[e] = gv;
      acc = fmaf(gv, to_float(o[e]), acc);
    }
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) d[e] = 0.f;
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  if ((threadIdx.x & 3) == 0) delta[r] = acc;
}

// acc[i][j] += sum_{k < K} A(ty + 16 i, k) * B(k, tx + 16 j), with
// A(m, k) = a[m * AR + k * AC] and B(k, n) = b[k * BR + n * BC] in shared
// memory. Every stride is 1 or odd (D + 1, 65), so the 16 lanes of a
// half-warp read 16 banks and the two half-warps' A reads broadcast.
template <int TN, int K, int AR, int AC, int BR, int BC>
__device__ __forceinline__ void tile_mma(const float* __restrict__ a,
                                         const float* __restrict__ b,
                                         float (&acc)[4][TN]) {
  const float* ap = a + (threadIdx.x >> 4) * AR;
  const float* bp = b + (threadIdx.x & 15) * BC;
#pragma unroll 8
  for (int k = 0; k < K; ++k) {
    float av[4];
    float bv[TN];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = ap[16 * i * AR + k * AC];
#pragma unroll
    for (int j = 0; j < TN; ++j) bv[j] = bp[k * BR + 16 * j * BC];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
}

// Max and sum over the 16 lanes of a half-warp (one row's 64 columns).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  }
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
constexpr size_t fwd_smem_floats() {
  return 3 * kTile * (D + 1) + kTile * kLP;
}

template <int D>
constexpr size_t bwd_smem_floats() {
  return 4 * kTile * (D + 1) + kTile * kLP + 2 * kTile;
}

template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int H, int n, Strides s,
                 float scale) {
  constexpr int LD = D + 1;
  constexpr int TN = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kTile * LD;
  float* vs = ks + kTile * LD;
  float* ps = vs + kTile * LD;

  const int n_tiles = (n + kTile - 1) / kTile;
  const int qt = n_tiles - 1 - static_cast<int>(blockIdx.x);
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
  const int q0 = qt * kTile;

  const T* qb = q + b * s.b[kQ] + h * s.h[kQ];
  const T* kb = k + b * s.b[kK] + h * s.h[kK];
  const T* vb = v + b * s.b[kV] + h * s.h[kV];
  load_tile<T, D>(qs, qb, s.t[kQ], q0, n);

  float m[4], l[4], acc[4][TN];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  }

  const int k_end = CAUSAL ? qt + 1 : n_tiles;
  for (int kt = 0; kt < k_end; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the last iteration is done with ks, vs and ps
    load_tile<T, D>(ks, kb, s.t[kK], k0, n);
    load_tile<T, D>(vs, vb, s.t[kV], k0, n);
    __syncthreads();
    float sc[4][4] = {};
    tile_mma<4, D, LD, 1, 1, LD>(qs, ks, sc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool live = kpos < n && (!CAUSAL || kpos <= qpos);
        sc[i][j] = live ? sc[i][j] * scale : kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - m_new);
        sum += p;
        ps[(ty + 16 * i) * kLP + tx + 16 * j] = round_to<T>(p);
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + row_sum(sum);
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] *= alpha;
      m[i] = m_new;
    }
    __syncthreads();
    tile_mma<TN, kTile, kLP, 1, LD, 1>(ps, vs, acc);
  }

  T* ob = o + b * s.b[kO] + h * s.h[kO];
  float* lb = lse + (static_cast<long long>(b) * H + h) * n;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= n) continue;
    const float ls = fmaxf(l[i], 1e-30f);
    T* orow = ob + static_cast<long long>(row) * s.t[kO];
#pragma unroll
    for (int j = 0; j < TN; ++j) orow[tx + 16 * j] = from_float<T>(acc[i][j] / ls);
    if (tx == 0) lb[row] = m[i] + logf(ls);
  }
}

template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ o,
                    const T* __restrict__ dout,
                    const float* __restrict__ lse, T* __restrict__ dq,
                    int H, int n, Strides s, float scale) {
  constexpr int LD = D + 1;
  constexpr int TN = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + kTile * LD;
  float* ks = dos + kTile * LD;
  float* vs = ks + kTile * LD;
  float* ps = vs + kTile * LD;
  float* delta_s = ps + kTile * kLP;
  float* lse_s = delta_s + kTile;

  const int n_tiles = (n + kTile - 1) / kTile;
  const int qt = n_tiles - 1 - static_cast<int>(blockIdx.x);
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
  const int q0 = qt * kTile;

  load_tile<T, D>(qs, q + b * s.b[kQ] + h * s.h[kQ], s.t[kQ], q0, n);
  load_do_delta<T, D>(dos, delta_s, dout + b * s.b[kDO] + h * s.h[kDO],
                      s.t[kDO], o + b * s.b[kO] + h * s.h[kO], s.t[kO], q0,
                      n);
  const float* lb = lse + (static_cast<long long>(b) * H + h) * n;
  if (threadIdx.x < kTile) {
    lse_s[threadIdx.x] = q0 + threadIdx.x < n ? lb[q0 + threadIdx.x] : 0.f;
  }
  __syncthreads();
  float lse_r[4], delta_r[4], acc[4][TN];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lse_r[i] = lse_s[ty + 16 * i];
    delta_r[i] = delta_s[ty + 16 * i];
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  }

  const T* kb = k + b * s.b[kK] + h * s.h[kK];
  const T* vb = v + b * s.b[kV] + h * s.h[kV];
  const int k_end = CAUSAL ? qt + 1 : n_tiles;
  for (int kt = 0; kt < k_end; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_tile<T, D>(ks, kb, s.t[kK], k0, n);
    load_tile<T, D>(vs, vb, s.t[kV], k0, n);
    __syncthreads();
    float sc[4][4] = {};
    float dp[4][4] = {};
    tile_mma<4, D, LD, 1, 1, LD>(qs, ks, sc);
    tile_mma<4, D, LD, 1, 1, LD>(dos, vs, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool live = kpos < n && (!CAUSAL || kpos <= qpos);
        const float x = live ? sc[i][j] * scale : kNegInf;
        const float p = expf(x - lse_r[i]);
        const float ds = p * (dp[i][j] - delta_r[i]) * scale;
        ps[(ty + 16 * i) * kLP + tx + 16 * j] = round_to<T>(ds);
      }
    }
    __syncthreads();
    tile_mma<TN, kTile, kLP, 1, LD, 1>(ps, ks, acc);
  }

  T* qb = dq + b * s.b[kDQ] + h * s.h[kDQ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= n) continue;
    T* r = qb + static_cast<long long>(row) * s.t[kDQ];
#pragma unroll
    for (int j = 0; j < TN; ++j) r[tx + 16 * j] = from_float<T>(acc[i][j]);
  }
}

template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ o,
                     const T* __restrict__ dout,
                     const float* __restrict__ lse, T* __restrict__ dk,
                     T* __restrict__ dv, int H, int n, Strides s,
                     float scale) {
  constexpr int LD = D + 1;
  constexpr int TN = D / 16;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + kTile * LD;
  float* qs = vs + kTile * LD;
  float* dos = qs + kTile * LD;
  float* ps = dos + kTile * LD;
  float* delta_s = ps + kTile * kLP;
  float* lse_s = delta_s + kTile;

  const int n_tiles = (n + kTile - 1) / kTile;
  const int kt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
  const int k0 = kt * kTile;

  load_tile<T, D>(ks, k + b * s.b[kK] + h * s.h[kK], s.t[kK], k0, n);
  load_tile<T, D>(vs, v + b * s.b[kV] + h * s.h[kV], s.t[kV], k0, n);
  float dk_acc[4][TN], dv_acc[4][TN];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      dk_acc[i][j] = 0.f;
      dv_acc[i][j] = 0.f;
    }
  }

  const T* qb = q + b * s.b[kQ] + h * s.h[kQ];
  const T* dob = dout + b * s.b[kDO] + h * s.h[kDO];
  const T* ob = o + b * s.b[kO] + h * s.h[kO];
  const float* lb = lse + (static_cast<long long>(b) * H + h) * n;
  for (int qt = CAUSAL ? kt : 0; qt < n_tiles; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();
    load_tile<T, D>(qs, qb, s.t[kQ], q0, n);
    load_do_delta<T, D>(dos, delta_s, dob, s.t[kDO], ob, s.t[kO], q0, n);
    if (threadIdx.x < kTile) {
      lse_s[threadIdx.x] = q0 + threadIdx.x < n ? lb[q0 + threadIdx.x] : 0.f;
    }
    __syncthreads();
    // Transposed tiles: row = key (ty + 16 i), column = query (tx + 16 j).
    float st[4][4] = {};
    float dpt[4][4] = {};
    tile_mma<4, D, LD, 1, 1, LD>(ks, qs, st);
    tile_mma<4, D, LD, 1, 1, LD>(vs, dos, dpt);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kpos = k0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qc = tx + 16 * j;
        const int qpos = q0 + qc;
        const bool live = qpos < n && kpos < n && (!CAUSAL || kpos <= qpos);
        const float x = live ? st[i][j] * scale : kNegInf;
        const float p = expf(x - lse_s[qc]);
        dpt[i][j] = p * (dpt[i][j] - delta_s[qc]) * scale;
        ps[(ty + 16 * i) * kLP + qc] = p;
      }
    }
    __syncthreads();
    tile_mma<TN, kTile, kLP, 1, LD, 1>(ps, dos, dv_acc);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) ps[(ty + 16 * i) * kLP + tx + 16 * j] = dpt[i][j];
    }
    __syncthreads();
    tile_mma<TN, kTile, kLP, 1, LD, 1>(ps, qs, dk_acc);
  }

  T* dkb = dk + b * s.b[kDK] + h * s.h[kDK];
  T* dvb = dv + b * s.b[kDV] + h * s.h[kDV];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= n) continue;
    T* kr = dkb + static_cast<long long>(row) * s.t[kDK];
    T* vr = dvb + static_cast<long long>(row) * s.t[kDV];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      kr[tx + 16 * j] = from_float<T>(dk_acc[i][j]);
      vr[tx + 16 * j] = from_float<T>(dv_acc[i][j]);
    }
  }
}

template <typename T_, int D_, bool CAUSAL_>
struct Tag {
  using T = T_;
  static constexpr int D = D_;
  static constexpr bool causal = CAUSAL_;
};

template <typename T, int D, typename F>
cudaError_t dispatch_causal(int causal, F f) {
  return causal ? f(Tag<T, D, true>{}) : f(Tag<T, D, false>{});
}

template <typename T, typename F>
cudaError_t dispatch_dim(int d, int causal, F f) {
  switch (d) {
    case 32:
      return dispatch_causal<T, 32>(causal, f);
    case 64:
      return dispatch_causal<T, 64>(causal, f);
    case 128:
      return dispatch_causal<T, 128>(causal, f);
  }
  return cudaErrorInvalidValue;
}

// f(Tag<T, D, causal>) for dtype 0 = float32, 1 = bfloat16 and D in
// {32, 64, 128}; anything else is refused before a launch.
template <typename F>
int dispatch(int B, int H, int n, int d, int dtype, int causal, F f) {
  if (B < 1 || B > 65535 || H < 1 || H > 65535 || n < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0) return static_cast<int>(dispatch_dim<float>(d, causal, f));
  if (dtype == 1) {
    return static_cast<int>(dispatch_dim<__nv_bfloat16>(d, causal, f));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

Strides unpack(const long long* strides) {
  Strides s;
  for (int i = 0; i < kSlots; ++i) {
    s.b[i] = strides[3 * i];
    s.h[i] = strides[3 * i + 1];
    s.t[i] = strides[3 * i + 2];
  }
  return s;
}

// Dynamic shared memory above 48 KB has to be asked for per kernel.
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
}

}  // namespace

// Every tensor is read and written in place through element strides along
// b, h and t (unit stride along D), given per tensor in `strides`
// (host memory, 24 int64: q, k, v, o, dO, dQ, dK, dV, each as b, h, t;
// slots a call does not use are ignored). lse is a contiguous fp32
// [B, H, T] (the [B, H, T, 1] of the API). Tq == Tk == T. dtype: 0 =
// float32, 1 = bfloat16; D in {32, 64, 128}. Each returns a cudaError_t
// as int: the launch's own error, checked right after it.

extern "C" int frl_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, int B, int H, int T, int D,
                             int dtype, int causal, const long long* strides,
                             float scale, void* stream) {
  const Strides s = unpack(strides);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((T + kTile - 1) / kTile, H, B);
  return dispatch(B, H, T, D, dtype, causal, [&](auto tag) {
    using Tg = decltype(tag);
    using Ty = typename Tg::T;
    auto kernel = flash_fwd_kernel<Ty, Tg::D, Tg::causal>;
    const size_t smem = fwd_smem_floats<Tg::D>() * sizeof(float);
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, smem, st>>>(
        static_cast<const Ty*>(q), static_cast<const Ty*>(k),
        static_cast<const Ty*>(v), static_cast<Ty*>(o),
        static_cast<float*>(lse), H, T, s, scale);
    return cudaGetLastError();
  });
}

extern "C" int frl_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* o, const void* dout,
                                const void* lse, void* dq, int B, int H,
                                int T, int D, int dtype, int causal,
                                const long long* strides, float scale,
                                void* stream) {
  const Strides s = unpack(strides);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((T + kTile - 1) / kTile, H, B);
  return dispatch(B, H, T, D, dtype, causal, [&](auto tag) {
    using Tg = decltype(tag);
    using Ty = typename Tg::T;
    auto kernel = flash_bwd_dq_kernel<Ty, Tg::D, Tg::causal>;
    const size_t smem = bwd_smem_floats<Tg::D>() * sizeof(float);
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, smem, st>>>(
        static_cast<const Ty*>(q), static_cast<const Ty*>(k),
        static_cast<const Ty*>(v), static_cast<const Ty*>(o),
        static_cast<const Ty*>(dout), static_cast<const float*>(lse),
        static_cast<Ty*>(dq), H, T, s, scale);
    return cudaGetLastError();
  });
}

extern "C" int frl_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* o, const void* dout,
                                 const void* lse, void* dk, void* dv, int B,
                                 int H, int T, int D, int dtype, int causal,
                                 const long long* strides, float scale,
                                 void* stream) {
  const Strides s = unpack(strides);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((T + kTile - 1) / kTile, H, B);
  return dispatch(B, H, T, D, dtype, causal, [&](auto tag) {
    using Tg = decltype(tag);
    using Ty = typename Tg::T;
    auto kernel = flash_bwd_dkv_kernel<Ty, Tg::D, Tg::causal>;
    const size_t smem = bwd_smem_floats<Tg::D>() * sizeof(float);
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, smem, st>>>(
        static_cast<const Ty*>(q), static_cast<const Ty*>(k),
        static_cast<const Ty*>(v), static_cast<const Ty*>(o),
        static_cast<const Ty*>(dout), static_cast<const float*>(lse),
        static_cast<Ty*>(dk), static_cast<Ty*>(dv), H, T, s, scale);
    return cudaGetLastError();
  });
}
