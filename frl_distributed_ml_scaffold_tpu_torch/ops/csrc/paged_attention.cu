// Decode and speculative-verify attention over a PAGED KV cache, for
// Hopper (sm_90a). Built with nvcc into a shared library with a plain C
// interface and loaded with ctypes (ops/_build.py, ops/decode_attention.py).
//
// Replaces two TPU kernels of
//   frl_distributed_ml_scaffold_tpu/ops/decode_attention.py:
//   - _paged_decode_kernel (launched by _flash_paged_decode), through the
//     entry point frl_paged_decode_attention (one query per row);
//   - _paged_verify_kernel (launched by _flash_paged_verify), through
//     frl_paged_verify_attention (a tile of T <= 8 queries per row).
// Same function: K/V live in pools [N, bs, H, D] shared by every row, and
// row b's logical block j is pool block tables[b, j]. Query t of a row
// whose total occupancy is kv_len attends logical positions
// p < n_t = clamp(kv_len - (T-1) + t, 1, M*bs): softmax(q . K / sqrt(D)) . V
// with an online softmax in fp32, mask value -1e30, denominator floored
// at 1e-30, the probability rounded to the pool dtype before the PV
// product (as the TPU kernels cast p to v's dtype), output in q's dtype.
// Occupancy is clamped at M*bs because retired serving rows keep running
// past their table.
//
// Bound: HBM bytes. Per row the kernels must read the occupied prefix,
// 2 * n * H * D * sizeof(dtype) bytes of K and V, plus the table and q/o;
// the verify tile does T times the flops on the same bytes (T <= 8 flops
// per byte in bf16), still far below the ~295 flop/byte at which the H100
// turns compute-bound. So the lever is to read each occupied pool byte
// once, and never touch a block that no row's occupied prefix reaches.
//
// Two designs, chosen by dtype:
//
// bf16 (the serving dtype): paged_tc.cuh, on the tensor cores: a split
// over positions fixed by tile index and merged in a thread-block
// cluster, 16-warp CTAs, 16-byte cp.async of whole tiles into a 2-stage
// ring, the verify tile as one 16-row mma A operand. Its note has the
// design.
//
// fp32 (the fp32 token-identity checks): this file's CUDA-core template.
// - One CTA of 8 warps per (row, head). On the TPU the table rides the
//   scalar-prefetch channel into the BlockSpec index map and the grid
//   walks logical blocks in order; here the CTA loads its own indices:
//   it copies the row's table entries that its occupancy reaches into
//   shared memory, then warps stride over positions p < n, U positions
//   per iteration (U = 8 / E), each read as
//   pool[table[p / bs], p % bs, h, :] through strides, one coalesced
//   D-vector per warp (lane l owns elements [l*E, (l+1)*E)).
// - Positions >= n and blocks the occupancy does not reach are never
//   read, so garbage there (NaN included) cannot reach the output.
// - Each warp keeps a running (m, l, acc[D]) in fp32 per query; the warps
//   merge through shared memory with the log-sum-exp rescale, one query
//   at a time.
// - Verify query 0 gives the SAME BITS as decode at occupancy
//   kv_len - T + 1: both entry points run this one template, with the
//   same warp partition, loop order and merge order; a position that a
//   query masks contributes p = 0 and leaves m unchanged (alpha = 1), and
//   the arithmetic is written with explicit _rn intrinsics so the
//   compiler cannot contract it differently per tile width.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "paged_tc.cuh"

namespace {

constexpr float kNegInf = -1.0e30f;
constexpr int kWarps = 8;
constexpr int kMaxTile = 8;
// Shared memory for the row's table: 8192 columns, 32 KB.
constexpr int kMaxTableCols = 8192;

__device__ __forceinline__ float to_float(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}

// Round to T and back: the probability as the PV product sees it.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

template <typename T, int E, int NQ>
__global__ void __launch_bounds__(kWarps * 32)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                       const T* __restrict__ v_pool,
                       const int32_t* __restrict__ kv_len,
                       const int32_t* __restrict__ tables,
                       T* __restrict__ out, int H, int M, int log2_bs,
                       int64_t q_sb, int64_t q_st, int64_t q_sh,
                       int64_t p_sn, int64_t p_ss, int64_t p_sh,
                       int64_t o_sb, int64_t o_st, int64_t o_sh,
                       float scale) {
  constexpr int D = 32 * E;
  constexpr int U = 8 / E;
  extern __shared__ int32_t sm_tbl[];
  __shared__ float sm_m[kWarps];
  __shared__ float sm_l[kWarps];
  __shared__ float sm_acc[kWarps][D];

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int bs_mask = (1 << log2_bs) - 1;
  const int cap = M << log2_bs;

  // Per-query occupancy; n is what the last (widest) query reads.
  const int len = kv_len[b];
  int nq[NQ];
#pragma unroll
  for (int t = 0; t < NQ; ++t) {
    nq[t] = min(max(len - (NQ - 1) + t, 1), cap);
  }
  const int n = nq[NQ - 1];

  // The CTA loads its own indices: only the table columns n reaches.
  const int n_blk = ((n - 1) >> log2_bs) + 1;
  const int32_t* trow = tables + static_cast<int64_t>(b) * M;
  for (int i = threadIdx.x; i < n_blk; i += blockDim.x) sm_tbl[i] = trow[i];
  __syncthreads();

  const int64_t head_off = h * p_sh + lane * E;
  float qr[NQ][E];
  float acc[NQ][E];
  float m[NQ];
  float l[NQ];
#pragma unroll
  for (int t = 0; t < NQ; ++t) {
    const T* qp = q + b * q_sb + t * q_st + h * q_sh + lane * E;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      qr[t][e] = to_float(qp[e]);
      acc[t][e] = 0.f;
    }
    m[t] = kNegInf;
    l[t] = 0.f;
  }

  for (int p0 = warp * U; p0 < n; p0 += kWarps * U) {
    float kr[U][E];
    float vr[U][E];
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const int p = p0 + j;
      const bool live = p < n;
      const int64_t off =
          live ? static_cast<int64_t>(sm_tbl[p >> log2_bs]) * p_sn +
                     static_cast<int64_t>(p & bs_mask) * p_ss + head_off
               : 0;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        kr[j][e] = live ? to_float(k_pool[off + e]) : 0.f;
        vr[j][e] = live ? to_float(v_pool[off + e]) : 0.f;
      }
    }
#pragma unroll
    for (int t = 0; t < NQ; ++t) {
      float s[U];
#pragma unroll
      for (int j = 0; j < U; ++j) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) dot = fmaf(qr[t][e], kr[j][e], dot);
        s[j] = dot;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
        for (int j = 0; j < U; ++j) {
          s[j] = __fadd_rn(s[j], __shfl_xor_sync(0xffffffffu, s[j], o));
        }
      }
      float m_new = m[t];
#pragma unroll
      for (int j = 0; j < U; ++j) {
        s[j] = p0 + j < nq[t] ? __fmul_rn(s[j], scale) : kNegInf;
        m_new = fmaxf(m_new, s[j]);
      }
      const float alpha = expf(__fsub_rn(m[t], m_new));
      l[t] = __fmul_rn(l[t], alpha);
#pragma unroll
      for (int e = 0; e < E; ++e) acc[t][e] = __fmul_rn(acc[t][e], alpha);
#pragma unroll
      for (int j = 0; j < U; ++j) {
        const float p = p0 + j < nq[t] ? expf(__fsub_rn(s[j], m_new)) : 0.f;
        l[t] = __fadd_rn(l[t], p);
        const float pv = round_to<T>(p);
#pragma unroll
        for (int e = 0; e < E; ++e) acc[t][e] = fmaf(pv, vr[j][e], acc[t][e]);
      }
      m[t] = m_new;
    }
  }

#pragma unroll
  for (int t = 0; t < NQ; ++t) {
    if (lane == 0) {
      sm_m[warp] = m[t];
      sm_l[warp] = l[t];
    }
#pragma unroll
    for (int e = 0; e < E; ++e) sm_acc[warp][lane * E + e] = acc[t][e];
    __syncthreads();
    for (int d = threadIdx.x; d < D; d += blockDim.x) {
      float mx = kNegInf;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w]);
      float den = 0.f;
      float num = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float c = expf(__fsub_rn(sm_m[w], mx));
        den = fmaf(sm_l[w], c, den);
        num = fmaf(sm_acc[w][d], c, num);
      }
      out[b * o_sb + t * o_st + h * o_sh + d] =
          from_float<T>(__fdiv_rn(num, fmaxf(den, 1e-30f)));
    }
    __syncthreads();
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* kv_len;
  const void* tables;
  void* out;
  int H, M, log2_bs;
  int64_t q_sb, q_st, q_sh, p_sn, p_ss, p_sh, o_sb, o_st, o_sh;
  float scale;
};

template <typename T, int E, int NQ>
void launch_one(const Args& a, dim3 grid, cudaStream_t st) {
  const size_t smem = static_cast<size_t>(a.M) * sizeof(int32_t);
  paged_attention_kernel<T, E, NQ><<<grid, kWarps * 32, smem, st>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const int32_t*>(a.kv_len),
      static_cast<const int32_t*>(a.tables), static_cast<T*>(a.out), a.H,
      a.M, a.log2_bs, a.q_sb, a.q_st, a.q_sh, a.p_sn, a.p_ss, a.p_sh, a.o_sb,
      a.o_st, a.o_sh, a.scale);
}

template <typename T, int E>
void launch_tile(int nq, const Args& a, dim3 grid, cudaStream_t st) {
  switch (nq) {
    case 1: launch_one<T, E, 1>(a, grid, st); break;
    case 2: launch_one<T, E, 2>(a, grid, st); break;
    case 3: launch_one<T, E, 3>(a, grid, st); break;
    case 4: launch_one<T, E, 4>(a, grid, st); break;
    case 5: launch_one<T, E, 5>(a, grid, st); break;
    case 6: launch_one<T, E, 6>(a, grid, st); break;
    case 7: launch_one<T, E, 7>(a, grid, st); break;
    case 8: launch_one<T, E, 8>(a, grid, st); break;
  }
}

template <typename T>
void launch_dtype(int e, int nq, const Args& a, dim3 grid, cudaStream_t st) {
  switch (e) {
    case 1: launch_tile<T, 1>(nq, a, grid, st); break;
    case 2: launch_tile<T, 2>(nq, a, grid, st); break;
    case 4: launch_tile<T, 4>(nq, a, grid, st); break;
    case 8: launch_tile<T, 8>(nq, a, grid, st); break;
  }
}

int launch(const void* q, const void* k, const void* v, const void* kv_len,
           const void* tables, void* out, int B, int T, int H, int D, int N,
           int bs, int M, int dtype, int splits, long long q_sb,
           long long q_st, long long q_sh, long long p_sn, long long p_ss,
           long long p_sh, long long o_sb, long long o_st, long long o_sh,
           float scale, void* stream) {
  const int e = D / 32;
  int log2_bs = 0;
  while ((1 << log2_bs) < bs) ++log2_bs;
  if (B < 1 || H < 1 || N < 1 || M < 1 || M > kMaxTableCols || T < 1 ||
      T > kMaxTile || D % 32 != 0 || (e != 1 && e != 2 && e != 4 && e != 8) ||
      bs < 1 || (1 << log2_bs) != bs || (dtype != 0 && dtype != 1) ||
      splits < 1 || splits > paged_tc::kMaxSplits) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const Args a{q, k, v, kv_len, tables, out, H, M, log2_bs, q_sb, q_st,
                 q_sh, p_sn, p_ss, p_sh, o_sb, o_st, o_sh, scale};
    launch_dtype<float>(e, T, a, dim3(B * H), st);
    return static_cast<int>(cudaGetLastError());
  }
  const paged_tc::Params a{
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const unsigned char*>(k),
      static_cast<const unsigned char*>(v), nullptr, nullptr,
      static_cast<const int32_t*>(kv_len),
      static_cast<const int32_t*>(tables), static_cast<__nv_bfloat16*>(out),
      T, H, M, log2_bs, 0, M * bs, q_sb, q_st, q_sh, p_sn, p_ss, p_sh, 0, 0,
      0, o_sb, o_st, o_sh, scale};
  const cudaError_t err =
      paged_tc::launch<false, /*paged=*/true>(a, B, D, splits, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Both entry points: q [B, T, H, D] and out [B, T, H, D] (T = 1 for
// decode) with the strides given in elements and unit stride along D;
// pools [N, bs, H, D] with strides (p_sn, p_ss, p_sh) and unit stride
// along D; kv_len [B] int32 >= 1 (each row's total occupancy, the tile
// included); tables [B, M] int32, contiguous, every column a row's
// occupancy reaches holding a pool block id in [0, N). bs a power of two,
// D in {32, 64, 128, 256}. dtype: 0 = float32, 1 = bfloat16. splits in
// 1..8: CTAs per (row, head), one cluster (bf16; fp32 takes one CTA). The
// bf16 kernel reads the pools 16 bytes at a time: 16-byte aligned, the N,
// bs and H strides multiples of 16 bytes (the wrapper checks). Returns a
// cudaError_t as int.
extern "C" int frl_paged_decode_attention(
    const void* q, const void* k, const void* v, const void* kv_len,
    const void* tables, void* out, int B, int T, int H, int D, int N, int bs,
    int M, int dtype, int splits, long long q_sb, long long q_st,
    long long q_sh, long long p_sn, long long p_ss, long long p_sh,
    long long o_sb, long long o_st, long long o_sh, float scale,
    void* stream) {
  if (T != 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch(q, k, v, kv_len, tables, out, B, T, H, D, N, bs, M, dtype,
                splits, q_sb, q_st, q_sh, p_sn, p_ss, p_sh, o_sb, o_st, o_sh,
                scale, stream);
}

extern "C" int frl_paged_verify_attention(
    const void* q, const void* k, const void* v, const void* kv_len,
    const void* tables, void* out, int B, int T, int H, int D, int N, int bs,
    int M, int dtype, int splits, long long q_sb, long long q_st,
    long long q_sh, long long p_sn, long long p_ss, long long p_sh,
    long long o_sb, long long o_st, long long o_sh, float scale,
    void* stream) {
  return launch(q, k, v, kv_len, tables, out, B, T, H, D, N, bs, M, dtype,
                splits, q_sb, q_st, q_sh, p_sn, p_ss, p_sh, o_sb, o_st, o_sh,
                scale, stream);
}
