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
//   from the diagonal down. The flash-attention-2 split: every output
//   element has one writer, so no atomics and no second pass.
// Under causal masking the query-tile kernels run the heaviest tiles (the
// last ones) first, so the short tiles fill the tail of the launch.
//
// Two designs, chosen by dtype:
//
// bf16 (the training path's): the tensor cores, through
// mma.sync.m16n8k16 (bf16 operands, fp32 accumulators). At the GPT-2-
// medium training shape ([8, 1024, 16, 64] bf16, causal) a forward moves
// 67 MB and does 1.7e10 flops; its bound is bytes (0.020 ms), and its
// operation floor is below the library's time even at mma.sync's rate, so
// what matters is what each byte of shared memory feeds: operands in
// registers, bf16 tiles, copies overlapped with compute.
// - 128 threads, 4 warps of 16 rows each (query rows in the forward and
//   dQ, key rows in dK/dV). The warp's own rows stay in registers as mma
//   A fragments: Q in the forward, Q and dO in dQ, K and V in dK/dV (at
//   D = 128 the dQ and dK/dV fragments are reloaded from shared memory
//   per product instead: with the D-wide accumulators they do not fit).
// - The streamed tiles (K and V in the forward and dQ; Q, dO, lse and
//   delta in dK/dV) pass through a 2-stage ring of shared memory filled by
//   cp.async, so the next tile is in flight while this one is computed.
//   Rows past T are zero-filled by the copy (src-size 0) and never read.
//   Rows are padded to D + 8 bf16 (a 16-byte shift a row), so the 8 rows
//   of every ldmatrix phase fall in 8 distinct 16-byte bank groups.
// - S (S^T in dK/dV) stays in registers: the scale, the mask (only on the
//   diagonal and ragged tiles) and the softmax work on the mma C
//   fragments, a row's max and sum reducing over the 4 lanes of a quad;
//   the C fragments of P (and dS, P^T, dS^T) are reused as the A
//   fragments of the next product, and V, K, dO and Q come in through
//   ldmatrix.trans.
// - exp is the special-function unit's 2^x (ex2.approx) of a log2(e)-
//   prescaled score: p = 2^(s log2(e) - m'), m' the running max (lse in
//   dQ and dK/dV) in log2 units; lse is written back in natural units.
// - dQ does three products a key tile (S = Q K^T, dP = dO V^T, dQ += dS
//   K) and rounds dS to bf16 before the last, exactly as the reference's
//   ds.astype(k.dtype), so it needs no hi + lo split; delta = rowsum(dO O)
//   comes from the block's own 64 rows of O and dO, read while the first
//   copies are in flight.
// - dK/dV keeps the reference's unrounded P and dS (fp32): each is split
//   into hi = bf16(x) and lo = bf16(x - hi), and each of P^T dO and
//   dS^T Q is two mma's, hi B + lo B (about 16 significant bits, where
//   one bf16 keeps 8).
// - dK/dV's delta is computed once per row by a small kernel that the
//   same C entry launches first, into a [B, H, T] fp32 scratch the
//   wrapper allocates, instead of once per (key tile, query tile).
//
// fp32: every product as fp32 FMAs on the CUDA cores (67 TFLOP/s peak;
// TF32 would not hold fp32 to 1e-4), so bound by operations and by how
// many FMAs each shared-memory load feeds.
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
// Left for later: wgmma and TMA, and 128-row tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

// ------------------------------------------- bf16 on the tensor cores

using bf16 = __nv_bfloat16;

constexpr int kTcThreads = 128;  // 4 warps of 16 rows
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Row stride (bf16 elements) of a tile in shared memory: D + 8, so rows
// start 16 bytes apart modulo 128 and ldmatrix has no bank conflicts.
template <int D>
constexpr int kTcLds = D + 8;

template <int D>
constexpr size_t fwd_tc_smem_bytes() {
  return 5 * kTile * kTcLds<D> * sizeof(bf16);  // Q, 2 x (K, V)
}

template <int D>
constexpr size_t dq_tc_smem_bytes() {
  return 6 * kTile * kTcLds<D> * sizeof(bf16);  // Q, dO, 2 x (K, V)
}

template <int D>
constexpr size_t dkv_tc_smem_bytes() {
  // K, V; 2 x (Q, dO); 2 x (lse, delta)
  return 6 * kTile * kTcLds<D> * sizeof(bf16) + 4 * kTile * sizeof(float);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled (nothing read)
// when !ok.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 bf16 matrices; lanes 8 i .. 8 i + 7 give the row addresses
// of matrix i, and register i of lane l holds matrix i's row l / 4,
// columns 2 (l % 4) and + 1 (with .trans: rows 2 (l % 4) and + 1, column
// l / 4).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// c (16 x 8 fp32) += a (16 x 16 bf16, row) * b (16 x 8 bf16, col). Lane l
// (g = l / 4, t = l % 4) holds a = {(g, 2t..), (g + 8, 2t..), (g, 2t + 8..),
// (g + 8, 2t + 8..)}, b = {(2t.., g), (2t + 8.., g)} and c = {(g, 2t),
// (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)}.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two fp32 values as one bf16x2 register (x in the low half).
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// hi = bf16(x), lo = bf16(x - hi), pairwise: hi + lo carries x to about
// 16 significant bits.
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x - hf.x, y - hf.y);
}

// 64 rows x D of a (b, h) slice from row row0 (element stride st between
// rows) into dst (row stride kTcLds<D>), 16 bytes a copy; rows >= n
// zero-filled.
template <int D>
__device__ __forceinline__ void cp_tile(bf16* dst, const bf16* src,
                                        long long st, int row0, int n) {
  constexpr int kChunks = D / 8;
  constexpr int LDS = kTcLds<D>;
#pragma unroll
  for (int it = 0; it < kTile * kChunks / kTcThreads; ++it) {
    const int i = threadIdx.x + it * kTcThreads;
    const int r = i / kChunks;
    const int c = i % kChunks;
    const bool ok = row0 + r < n;
    const bf16* s = src + (ok ? static_cast<long long>(row0 + r) * st : 0) +
                    c * 8;
    cp_async16(dst + r * LDS + c * 8, s, ok);
  }
}

// 64 fp32 of a contiguous row vector from row0 into dst; rows >= n zero.
__device__ __forceinline__ void cp_rows(float* dst, const float* src,
                                        int row0, int n) {
  if (threadIdx.x < kTile) {
    const bool ok = row0 + static_cast<int>(threadIdx.x) < n;
    cp_async4(dst + threadIdx.x, src + (ok ? row0 + threadIdx.x : 0), ok);
  }
}

// A lane's ldmatrix offsets (elements) within a tile of row stride LDS:
// A fragments of a warp's 16 rows (plus warp * 16 * LDS); B fragments of
// two n-tiles of 8 rows (k along the row: K for Q K^T, Q for K Q^T); B
// fragments of two n-tiles of 8 columns read transposed (k down the rows:
// V for P V, dO for P^T dO, Q for dS^T Q).
template <int LDS>
__device__ __forceinline__ int a_offset(int lane) {
  return (lane & 15) * LDS + (lane >> 4) * 8;
}
template <int LDS>
__device__ __forceinline__ int b_offset(int lane) {
  return ((lane & 7) + ((lane >> 4) << 3)) * LDS + ((lane >> 3) & 1) * 8;
}
template <int LDS>
__device__ __forceinline__ int bt_offset(int lane) {
  return ((lane & 7) + (((lane >> 3) & 1) << 3)) * LDS + (lane >> 4) * 8;
}

// acc[16 x 64] += A[16 x D] * tile[64 x D]^T, A from the warp's fragments
// (or, when A_REGS is false, from a_tile's rows by ldmatrix), the tile's 64
// rows as the 8 n-tiles of the product.
template <int D, bool A_REGS>
__device__ __forceinline__ void mma_abt(
    float (&acc)[8][4], const uint32_t (&af)[A_REGS ? D / 16 : 1][4],
    const bf16* a_tile, const bf16* tile, int lane) {
  constexpr int LDS = kTcLds<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    if constexpr (A_REGS) {
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = af[kk][i];
    } else {
      ldsm_x4(a, a_tile + a_offset<LDS>(lane) + kk * 16);
    }
    uint32_t b[4][4];  // all four loads in flight before the products
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      ldsm_x4(b[np], tile + b_offset<LDS>(lane) + np * 16 * LDS + kk * 16);
    }
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      mma_bf16(acc[2 * np], a, b[np][0], b[np][1]);
      mma_bf16(acc[2 * np + 1], a, b[np][2], b[np][3]);
    }
  }
}

// 2^x by the special-function unit (ex2.approx.ftz: about 2 ulp; a
// result below 2^-126 flushes to 0 where expf would keep a denormal).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The A fragment of k-chunk kc (columns 16 kc .. 16 kc + 15) of a 16 x 64
// fp32 C-fragment tile x, rounded to bf16: the C -> A reuse.
__device__ __forceinline__ void c_to_a(const float (&x)[8][4], int kc,
                                       uint32_t (&a)[4]) {
  a[0] = pack_bf16(x[2 * kc][0], x[2 * kc][1]);
  a[1] = pack_bf16(x[2 * kc][2], x[2 * kc][3]);
  a[2] = pack_bf16(x[2 * kc + 1][0], x[2 * kc + 1][1]);
  a[3] = pack_bf16(x[2 * kc + 1][2], x[2 * kc + 1][3]);
}

// The same, split into hi and lo fragments.
__device__ __forceinline__ void c_to_a_split(const float (&x)[8][4], int kc,
                                             uint32_t (&hi)[4],
                                             uint32_t (&lo)[4]) {
  split_bf16(x[2 * kc][0], x[2 * kc][1], hi[0], lo[0]);
  split_bf16(x[2 * kc][2], x[2 * kc][3], hi[1], lo[1]);
  split_bf16(x[2 * kc + 1][0], x[2 * kc + 1][1], hi[2], lo[2]);
  split_bf16(x[2 * kc + 1][2], x[2 * kc + 1][3], hi[3], lo[3]);
}

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kTcThreads)
flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o,
                    float* __restrict__ lse, int H, int n, Strides s,
                    float scale_log2) {
  constexpr int LDS = kTcLds<D>;
  constexpr int TILE = kTile * LDS;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* qs = reinterpret_cast<bf16*>(tc_smem);
  // Stage st of the ring: K at qs + (1 + 2 st) TILE, V right after it.

  const int n_tiles = (n + kTile - 1) / kTile;
  const int qt = n_tiles - 1 - static_cast<int>(blockIdx.x);
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int q0 = qt * kTile;

  const bf16* kb = k + b * s.b[kK] + h * s.h[kK];
  const bf16* vb = v + b * s.b[kV] + h * s.h[kV];
  cp_tile<D>(qs, q + b * s.b[kQ] + h * s.h[kQ], s.t[kQ], q0, n);
  cp_tile<D>(qs + TILE, kb, s.t[kK], 0, n);
  cp_tile<D>(qs + 2 * TILE, vb, s.t[kV], 0, n);
  cp_async_commit();

  uint32_t qf[D / 16][4];
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  }
  // Rows g and g + 8 of the warp's 16: running max (log2 units) and this
  // lane's share of the denominator.
  float m_r[2] = {kNegInf, kNegInf};
  float l_r[2] = {0.f, 0.f};

  const int k_end = CAUSAL ? qt + 1 : n_tiles;
  for (int kt = 0; kt < k_end; ++kt) {
    if (kt + 1 < k_end) {
      bf16* nxt = qs + (1 + 2 * ((kt + 1) & 1)) * TILE;
      cp_tile<D>(nxt, kb, s.t[kK], (kt + 1) * kTile, n);
      cp_tile<D>(nxt + TILE, vb, s.t[kV], (kt + 1) * kTile, n);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile's group (and Q) have landed
    __syncthreads();
    if (kt == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        ldsm_x4(qf[kk], qs + warp * 16 * LDS + a_offset<LDS>(lane) + kk * 16);
      }
    }
    const bf16* kc = qs + (1 + 2 * (kt & 1)) * TILE;
    const bf16* vc = kc + TILE;

    float sc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
    }
    mma_abt<D, true>(sc, qf, nullptr, kc, lane);

    const int k0 = kt * kTile;
    const bool edge = (CAUSAL && kt == qt) || k0 + kTile > n;
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[j][e] * scale_log2;
        if (edge) {
          const int kpos = k0 + 8 * j + 2 * t4 + (e & 1);
          const int qpos = q0 + warp * 16 + g + (e >> 1) * 8;
          if (kpos >= n || (CAUSAL && kpos > qpos)) x = kNegInf;
        }
        sc[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float alpha = ex2(m_r[r] - mx[r]);
      m_r[r] = mx[r];
      l_r[r] *= alpha;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[j][2 * r] *= alpha;
        acc[j][2 * r + 1] *= alpha;
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(sc[j][e] - m_r[e >> 1]);
        l_r[e >> 1] += p;
        sc[j][e] = p;
      }
    }

    // O += P V: P's C fragments, rounded to bf16, are the A fragments.
#pragma unroll
    for (int kc2 = 0; kc2 < 4; ++kc2) {
      uint32_t pa[4];
      c_to_a(sc, kc2, pa);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t bv[4];
        ldsm_x4_t(bv, vc + bt_offset<LDS>(lane) + kc2 * 16 * LDS + dp * 16);
        mma_bf16(acc[2 * dp], pa, bv[0], bv[1]);
        mma_bf16(acc[2 * dp + 1], pa, bv[2], bv[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before refill
  }

  bf16* ob = o + b * s.b[kO] + h * s.h[kO];
  float* lb = lse + (static_cast<long long>(b) * H + h) * n;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_r[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = q0 + warp * 16 + g + r * 8;
    if (row >= n) continue;
    const float ls = fmaxf(l, 1e-30f);
    bf16* orow = ob + static_cast<long long>(row) * s.t[kO];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * t4) =
          __floats2bfloat162_rn(acc[j][2 * r] / ls, acc[j][2 * r + 1] / ls);
    }
    if (t4 == 0) lb[row] = m_r[r] * kLn2 + logf(ls);
  }
}

// dQ for one (b, h, 64-query tile): the forward's loop with a second score
// product and no online softmax. Q and dO stay (as A fragments up to D =
// 64), K and V stream through the ring; S = Q K^T and dP = dO V^T land in
// C fragments, p = 2^(s log2(e) / sqrt(D) - lse log2(e)) and dS = p (dP -
// delta) / sqrt(D) are formed in place, and dS, rounded to bf16 (the
// reference's ds.astype(k.dtype)), is the A operand of dQ += dS K with K
// read through ldmatrix.trans.
template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kTcThreads)
flash_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ o,
                       const bf16* __restrict__ dout,
                       const float* __restrict__ lse, bf16* __restrict__ dq,
                       int H, int n, Strides s, float scale,
                       float scale_log2) {
  constexpr int LDS = kTcLds<D>;
  constexpr int TILE = kTile * LDS;
  // Q and dO fragments in registers up to D = 64 (32 registers); at 128
  // they are reloaded from the resident tiles for each product.
  constexpr bool kRegs = D <= 64;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  __shared__ float delta_s[kTile];
  bf16* qs = reinterpret_cast<bf16*>(tc_smem);
  bf16* dos = qs + TILE;
  // Stage st of the ring: K at qs + (2 + 2 st) TILE, V right after it.

  const int n_tiles = (n + kTile - 1) / kTile;
  const int qt = n_tiles - 1 - static_cast<int>(blockIdx.x);
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int q0 = qt * kTile;
  const int qrow = q0 + warp * 16 + g;  // this lane's rows: qrow, qrow + 8

  const bf16* kb = k + b * s.b[kK] + h * s.h[kK];
  const bf16* vb = v + b * s.b[kV] + h * s.h[kV];
  const bf16* ob = o + b * s.b[kO] + h * s.h[kO];
  const bf16* dob = dout + b * s.b[kDO] + h * s.h[kDO];
  cp_tile<D>(qs, q + b * s.b[kQ] + h * s.h[kQ], s.t[kQ], q0, n);
  cp_tile<D>(dos, dob, s.t[kDO], q0, n);
  cp_tile<D>(qs + 2 * TILE, kb, s.t[kK], 0, n);
  cp_tile<D>(qs + 3 * TILE, vb, s.t[kV], 0, n);
  cp_async_commit();

  // delta = rowsum(dO O) in fp32 for the tile's 64 rows (0 past n), two
  // threads a row, 16 bytes a load, while the copies are in flight.
  {
    const int r = threadIdx.x >> 1;
    const int c0 = (threadIdx.x & 1) * (D / 2);
    float acc = 0.f;
    if (q0 + r < n) {
      const bf16* orow = ob + static_cast<long long>(q0 + r) * s.t[kO] + c0;
      const bf16* grow = dob + static_cast<long long>(q0 + r) * s.t[kDO] + c0;
#pragma unroll
      for (int c = 0; c < D / 2; c += 8) {
        const uint4 ov = *reinterpret_cast<const uint4*>(orow + c);
        const uint4 gv = *reinterpret_cast<const uint4*>(grow + c);
        const __nv_bfloat162* op = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* gp = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 a = __bfloat1622float2(op[e]);
          const float2 d = __bfloat1622float2(gp[e]);
          acc = fmaf(d.x, a.x, acc);
          acc = fmaf(d.y, a.y, acc);
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if ((threadIdx.x & 1) == 0) delta_s[r] = acc;
  }
  // lse of the lane's two rows, in log2 units.
  const float* lb = lse + (static_cast<long long>(b) * H + h) * n;
  float lse_r[2], delta_r[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qrow + r * 8;
    lse_r[r] = row < n ? lb[row] * kLog2e : 0.f;
  }

  uint32_t qf[kRegs ? D / 16 : 1][4];
  uint32_t df[kRegs ? D / 16 : 1][4];
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  }
  const bf16* qw = qs + warp * 16 * LDS;  // this warp's 16 query rows
  const bf16* dw = dos + warp * 16 * LDS;

  const int k_end = CAUSAL ? qt + 1 : n_tiles;
  for (int kt = 0; kt < k_end; ++kt) {
    if (kt + 1 < k_end) {
      bf16* nxt = qs + (2 + 2 * ((kt + 1) & 1)) * TILE;
      cp_tile<D>(nxt, kb, s.t[kK], (kt + 1) * kTile, n);
      cp_tile<D>(nxt + TILE, vb, s.t[kV], (kt + 1) * kTile, n);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile's group (and Q, dO) have landed
    __syncthreads();
    if (kt == 0) {
      if constexpr (kRegs) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          ldsm_x4(qf[kk], qw + a_offset<LDS>(lane) + kk * 16);
          ldsm_x4(df[kk], dw + a_offset<LDS>(lane) + kk * 16);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) delta_r[r] = delta_s[warp * 16 + g + r * 8];
    }
    const bf16* kc = qs + (2 + 2 * (kt & 1)) * TILE;
    const bf16* vc = kc + TILE;

    // S = Q K^T and dP = dO V^T: rows the warp's 16 queries, columns the
    // tile's 64 keys.
    float sc[8][4], ds[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[j][e] = 0.f;
        ds[j][e] = 0.f;
      }
    }
    mma_abt<D, kRegs>(sc, qf, qw, kc, lane);
    mma_abt<D, kRegs>(ds, df, dw, vc, lane);

    // dS = p (dP - delta) / sqrt(D), p = exp(S / sqrt(D) - lse), 0 where
    // masked.
    const int k0 = kt * kTile;
    const bool edge = (CAUSAL && kt == qt) || k0 + kTile > n;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = ex2(sc[j][e] * scale_log2 - lse_r[e >> 1]);
        if (edge) {
          const int kpos = k0 + 8 * j + 2 * t4 + (e & 1);
          const int qpos = qrow + (e >> 1) * 8;
          if (kpos >= n || (CAUSAL && kpos > qpos)) p = 0.f;
        }
        ds[j][e] = p * (ds[j][e] - delta_r[e >> 1]) * scale;
      }
    }

    // dQ += dS K: dS's C fragments, rounded to bf16, are the A fragments.
#pragma unroll
    for (int kc2 = 0; kc2 < 4; ++kc2) {
      uint32_t da[4];
      c_to_a(ds, kc2, da);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t bk[4];
        ldsm_x4_t(bk, kc + bt_offset<LDS>(lane) + kc2 * 16 * LDS + dp * 16);
        mma_bf16(acc[2 * dp], da, bk[0], bk[1]);
        mma_bf16(acc[2 * dp + 1], da, bk[2], bk[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before refill
  }

  bf16* qb = dq + b * s.b[kDQ] + h * s.h[kDQ];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qrow + r * 8;
    if (row >= n) continue;
    bf16* qr = qb + static_cast<long long>(row) * s.t[kDQ];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(qr + 8 * j + 2 * t4) =
          __floats2bfloat162_rn(acc[j][2 * r], acc[j][2 * r + 1]);
    }
  }
}

// delta[r] = sum_d dO[r, d] O[r, d] in fp32 for every row r = (b, h, t) of
// a [B, H, T] fp32 output; D / 8 lanes a row, 16 bytes each.
template <int D>
__global__ void __launch_bounds__(256)
flash_delta_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                   float* __restrict__ delta, int H, int n, Strides s,
                   long long rows) {
  constexpr int L = D / 8;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const long long r = i / L;
  const int c = static_cast<int>(i % L);
  float acc = 0.f;
  if (r < rows) {
    const long long t = r % n;
    const long long bh = r / n;
    const long long hh = bh % H;
    const long long bb = bh / H;
    const uint4 ov = *reinterpret_cast<const uint4*>(
        o + bb * s.b[kO] + hh * s.h[kO] + t * s.t[kO] + c * 8);
    const uint4 gv = *reinterpret_cast<const uint4*>(
        dout + bb * s.b[kDO] + hh * s.h[kDO] + t * s.t[kDO] + c * 8);
    const __nv_bfloat162* op = reinterpret_cast<const __nv_bfloat162*>(&ov);
    const __nv_bfloat162* gp = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 a = __bfloat1622float2(op[e]);
      const float2 d = __bfloat1622float2(gp[e]);
      acc = fmaf(d.x, a.x, acc);
      acc = fmaf(d.y, a.y, acc);
    }
  }
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  if (c == 0 && r < rows) delta[r] = acc;
}

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(kTcThreads)
flash_bwd_dkv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, bf16* __restrict__ dk,
                        bf16* __restrict__ dv, int H, int n, Strides s,
                        float scale, float scale_log2) {
  constexpr int LDS = kTcLds<D>;
  constexpr int TILE = kTile * LDS;
  // K and V fragments in registers up to D = 64 (32 registers); at 128
  // they are reloaded from the resident tiles for each product.
  constexpr bool kRegs = D <= 64;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* ks = reinterpret_cast<bf16*>(tc_smem);
  bf16* vs = ks + TILE;
  // Stage st: Q at ks + (2 + 2 st) TILE, dO right after it; lse and
  // delta (64 fp32 each) at rows + 128 st and + 64.
  float* rows_s = reinterpret_cast<float*>(ks + 6 * TILE);

  const int n_tiles = (n + kTile - 1) / kTile;
  const int kt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int k0 = kt * kTile;
  const int krow = k0 + warp * 16 + g;  // this lane's rows: krow, krow + 8

  const bf16* qb = q + b * s.b[kQ] + h * s.h[kQ];
  const bf16* dob = dout + b * s.b[kDO] + h * s.h[kDO];
  const long long bh = static_cast<long long>(b) * H + h;
  const float* lb = lse + bh * n;
  const float* db = delta + bh * n;
  auto load_stage = [&](int st, int qt) {
    bf16* qd = ks + (2 + 2 * st) * TILE;
    cp_tile<D>(qd, qb, s.t[kQ], qt * kTile, n);
    cp_tile<D>(qd + TILE, dob, s.t[kDO], qt * kTile, n);
    cp_rows(rows_s + 128 * st, lb, qt * kTile, n);
    cp_rows(rows_s + 128 * st + 64, db, qt * kTile, n);
  };

  const int q_begin = CAUSAL ? kt : 0;
  cp_tile<D>(ks, k + b * s.b[kK] + h * s.h[kK], s.t[kK], k0, n);
  cp_tile<D>(vs, v + b * s.b[kV] + h * s.h[kV], s.t[kV], k0, n);
  load_stage(0, q_begin);
  cp_async_commit();

  uint32_t kf[kRegs ? D / 16 : 1][4];
  uint32_t vf[kRegs ? D / 16 : 1][4];
  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dka[j][e] = 0.f;
      dva[j][e] = 0.f;
    }
  }
  const bf16* kw = ks + warp * 16 * LDS;  // this warp's 16 key rows
  const bf16* vw = vs + warp * 16 * LDS;

  for (int qt = q_begin; qt < n_tiles; ++qt) {
    const int st = (qt - q_begin) & 1;
    if (qt + 1 < n_tiles) load_stage(st ^ 1, qt + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if constexpr (kRegs) {
      if (qt == q_begin) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          ldsm_x4(kf[kk], kw + a_offset<LDS>(lane) + kk * 16);
          ldsm_x4(vf[kk], vw + a_offset<LDS>(lane) + kk * 16);
        }
      }
    }
    const bf16* qc = ks + (2 + 2 * st) * TILE;
    const bf16* doc = qc + TILE;
    const float* ls = rows_s + 128 * st;
    const float* dl = ls + 64;
    const int q0 = qt * kTile;

    // S^T = K Q^T: rows the warp's 16 keys, columns the tile's 64 queries.
    float pt[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) pt[j][e] = 0.f;
    }
    mma_abt<D, kRegs>(pt, kf, kw, qc, lane);

    // P^T = exp(S^T / sqrt(D) - lse), 0 where masked.
    const bool edge = (CAUSAL && qt == kt) || q0 + kTile > n || k0 + kTile > n;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(ls + 8 * j + 2 * t4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float lq = (e & 1) ? l2.y : l2.x;
        float p = ex2(pt[j][e] * scale_log2 - lq * kLog2e);
        if (edge) {
          const int qpos = q0 + 8 * j + 2 * t4 + (e & 1);
          const int kpos = krow + (e >> 1) * 8;
          if (qpos >= n || kpos >= n || (CAUSAL && kpos > qpos)) p = 0.f;
        }
        pt[j][e] = p;
      }
    }

    // dP^T = V dO^T, then dS^T = P^T (dP^T - delta) / sqrt(D) in place.
    float ds[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[j][e] = 0.f;
    }
    mma_abt<D, kRegs>(ds, vf, vw, doc, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 d2 = *reinterpret_cast<const float2*>(dl + 8 * j + 2 * t4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float dq = (e & 1) ? d2.y : d2.x;
        ds[j][e] = pt[j][e] * (ds[j][e] - dq) * scale;
      }
    }

    // dV += P^T dO and dK += dS^T Q, each operand as hi + lo.
#pragma unroll
    for (int kc2 = 0; kc2 < 4; ++kc2) {
      uint32_t ph[4], pl[4], sh[4], sl[4];
      c_to_a_split(pt, kc2, ph, pl);
      c_to_a_split(ds, kc2, sh, sl);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t bo[4];
        ldsm_x4_t(bo, doc + bt_offset<LDS>(lane) + kc2 * 16 * LDS + dp * 16);
        mma_bf16(dva[2 * dp], ph, bo[0], bo[1]);
        mma_bf16(dva[2 * dp], pl, bo[0], bo[1]);
        mma_bf16(dva[2 * dp + 1], ph, bo[2], bo[3]);
        mma_bf16(dva[2 * dp + 1], pl, bo[2], bo[3]);
        uint32_t bq[4];
        ldsm_x4_t(bq, qc + bt_offset<LDS>(lane) + kc2 * 16 * LDS + dp * 16);
        mma_bf16(dka[2 * dp], sh, bq[0], bq[1]);
        mma_bf16(dka[2 * dp], sl, bq[0], bq[1]);
        mma_bf16(dka[2 * dp + 1], sh, bq[2], bq[3]);
        mma_bf16(dka[2 * dp + 1], sl, bq[2], bq[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before refill
  }

  bf16* dkb = dk + b * s.b[kDK] + h * s.h[kDK];
  bf16* dvb = dv + b * s.b[kDV] + h * s.h[kDV];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = krow + r * 8;
    if (row >= n) continue;
    bf16* kr = dkb + static_cast<long long>(row) * s.t[kDK];
    bf16* vr = dvb + static_cast<long long>(row) * s.t[kDV];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(kr + 8 * j + 2 * t4) =
          __floats2bfloat162_rn(dka[j][2 * r], dka[j][2 * r + 1]);
      *reinterpret_cast<__nv_bfloat162*>(vr + 8 * j + 2 * t4) =
          __floats2bfloat162_rn(dva[j][2 * r], dva[j][2 * r + 1]);
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
// float32, 1 = bfloat16; D in {32, 64, 128}. bf16 inputs are read 16 bytes
// at a time: every base pointer 16-byte aligned and every stride a
// multiple of 8 elements (the wrapper checks). Each returns a cudaError_t
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
    if constexpr (std::is_same<Ty, bf16>::value) {
      auto kernel = flash_fwd_tc_kernel<Tg::D, Tg::causal>;
      const size_t smem = fwd_tc_smem_bytes<Tg::D>();
      cudaError_t err = allow_smem(kernel, smem);
      if (err != cudaSuccess) return err;
      kernel<<<grid, kTcThreads, smem, st>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), static_cast<bf16*>(o),
          static_cast<float*>(lse), H, T, s, scale * kLog2e);
    } else {
      auto kernel = flash_fwd_kernel<Ty, Tg::D, Tg::causal>;
      const size_t smem = fwd_smem_floats<Tg::D>() * sizeof(float);
      cudaError_t err = allow_smem(kernel, smem);
      if (err != cudaSuccess) return err;
      kernel<<<grid, kThreads, smem, st>>>(
          static_cast<const Ty*>(q), static_cast<const Ty*>(k),
          static_cast<const Ty*>(v), static_cast<Ty*>(o),
          static_cast<float*>(lse), H, T, s, scale);
    }
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
    if constexpr (std::is_same<Ty, bf16>::value) {
      auto kernel = flash_bwd_dq_tc_kernel<Tg::D, Tg::causal>;
      const size_t smem = dq_tc_smem_bytes<Tg::D>();
      cudaError_t err = allow_smem(kernel, smem);
      if (err != cudaSuccess) return err;
      kernel<<<grid, kTcThreads, smem, st>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), static_cast<const bf16*>(o),
          static_cast<const bf16*>(dout), static_cast<const float*>(lse),
          static_cast<bf16*>(dq), H, T, s, scale, scale * kLog2e);
    } else {
      auto kernel = flash_bwd_dq_kernel<Ty, Tg::D, Tg::causal>;
      const size_t smem = bwd_smem_floats<Tg::D>() * sizeof(float);
      cudaError_t err = allow_smem(kernel, smem);
      if (err != cudaSuccess) return err;
      kernel<<<grid, kThreads, smem, st>>>(
          static_cast<const Ty*>(q), static_cast<const Ty*>(k),
          static_cast<const Ty*>(v), static_cast<const Ty*>(o),
          static_cast<const Ty*>(dout), static_cast<const float*>(lse),
          static_cast<Ty*>(dq), H, T, s, scale);
    }
    return cudaGetLastError();
  });
}

// delta: a [B, H, T] fp32 scratch, written and read by the bf16 path
// (rowsum(dO O), by a first launch) and unused by the fp32 one.
extern "C" int frl_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* o, const void* dout,
                                 const void* lse, void* delta, void* dk,
                                 void* dv, int B, int H, int T, int D,
                                 int dtype, int causal,
                                 const long long* strides, float scale,
                                 void* stream) {
  const Strides s = unpack(strides);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((T + kTile - 1) / kTile, H, B);
  return dispatch(B, H, T, D, dtype, causal, [&](auto tag) {
    using Tg = decltype(tag);
    using Ty = typename Tg::T;
    if constexpr (std::is_same<Ty, bf16>::value) {
      const long long rows = static_cast<long long>(B) * H * T;
      const long long lanes = rows * (Tg::D / 8);
      flash_delta_kernel<Tg::D>
          <<<static_cast<unsigned>((lanes + 255) / 256), 256, 0, st>>>(
              static_cast<const bf16*>(o), static_cast<const bf16*>(dout),
              static_cast<float*>(delta), H, T, s, rows);
      cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return err;
      auto kernel = flash_bwd_dkv_tc_kernel<Tg::D, Tg::causal>;
      const size_t smem = dkv_tc_smem_bytes<Tg::D>();
      err = allow_smem(kernel, smem);
      if (err != cudaSuccess) return err;
      kernel<<<grid, kTcThreads, smem, st>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
          static_cast<const float*>(lse), static_cast<const float*>(delta),
          static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, T, s, scale,
          scale * kLog2e);
    } else {
      auto kernel = flash_bwd_dkv_kernel<Ty, Tg::D, Tg::causal>;
      const size_t smem = bwd_smem_floats<Tg::D>() * sizeof(float);
      cudaError_t err = allow_smem(kernel, smem);
      if (err != cudaSuccess) return err;
      kernel<<<grid, kThreads, smem, st>>>(
          static_cast<const Ty*>(q), static_cast<const Ty*>(k),
          static_cast<const Ty*>(v), static_cast<const Ty*>(o),
          static_cast<const Ty*>(dout), static_cast<const float*>(lse),
          static_cast<Ty*>(dk), static_cast<Ty*>(dv), H, T, s, scale);
    }
    return cudaGetLastError();
  });
}
