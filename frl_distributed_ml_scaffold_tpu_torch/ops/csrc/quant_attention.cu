// Decode and speculative-verify attention over a QUANTIZED KV cache
// (1-byte K/V payloads with per-(row, position, head) bf16 scales), for
// Hopper (sm_90a). Built with nvcc into a shared library with a plain C
// interface and loaded with ctypes (ops/_build.py, ops/decode_attention.py).
//
// Replaces three TPU kernels of
//   frl_distributed_ml_scaffold_tpu/ops/decode_attention.py:
//   - _decode_kernel_quant (launched by _flash_decode_quant), through the
//     entry point frl_decode_attention_quant: contiguous cache
//     [B, S, H, D], scales [B, S, H];
//   - _paged_decode_kernel_quant (launched by _flash_paged_decode), through
//     frl_paged_decode_attention_quant: pools [N, bs, H, D], scale pools
//     [N, bs, H], tables [B, M], one query per row;
//   - _paged_verify_kernel_quant (launched by _flash_paged_verify), through
//     frl_paged_verify_attention_quant: the same pools, a tile of T <= 8
//     queries per row.
// Same function: query t of a row whose total occupancy is kv_len attends
// logical positions p < n_t = clamp(kv_len - (T-1) + t, 1, cap), where cap
// is S for the contiguous cache (rows past their bucket read the whole
// cache) and M*bs for the pool (retired rows run past their table). The
// score is (q . k_payload) * k_scale * 1/sqrt(D) in fp32; an online
// softmax in fp32 with mask value -1e30; the accumulator adds
// (p * v_scale) * v_payload in fp32 (no rounding of p to the cache type);
// the output is acc / max(l, 1e-30) in q's dtype. Payload formats: int8,
// fp8 e4m3 and fp8 e5m2, each upcast to fp32 exactly (fp8 through fp16,
// which holds every value of both formats). q and out: fp32 or bf16.
//
// Bound: HBM bytes. Per row the kernels must read the occupied prefix,
// n * H * (2 * D payload bytes + 2 * 2 scale bytes): 0.52x the bf16
// cache's bytes at D = 64. The flops are the unquantized kernels' (the
// verify tile's T <= 8 per byte included), far below the ~295 flop/byte
// at which the H100 turns compute-bound. So the lever is the one of the
// bf16 kernels: read each occupied payload and scale byte once, never
// touch a position or block no row's occupancy reaches.
//
// Two designs, chosen by q's dtype:
//
// bf16 q (the serving dtype), the pools and the contiguous cache:
// paged_tc.cuh, on the tensor cores, shared with the bf16 pools of
// paged_attention.cu: a split over positions fixed by tile index and
// merged in a thread-block cluster, 16-warp CTAs, 16-byte cp.async of 16
// payload bytes into a 2-stage ring, the payload bytes turned into bf16
// B fragments exactly, p * v_scale as bf16 hi + lo. The contiguous cache
// is its kPaged = false mode: position p of row b at cache[b, p] through
// three strides, no table; the host picks the split count from B*H, S
// and the SM count (ops/decode_attention.py `decode_splits`) and hands
// kv_len over unclamped. Its note has the design.
//
// fp32 q (the fp32 token-identity checks), both caches: this file's
// CUDA-core template, after decode_attention.cu's first design and
// paged_attention.cu's fp32 one.
// - One template for these entry points: one CTA of 8 warps per
//   (row, head). The paged instantiations copy the table columns the
//   occupancy reaches into shared memory (the TPU kernels get them from
//   the scalar-prefetch channel) and address pool[table[p / bs], p % bs];
//   the contiguous one addresses cache[b, p]. Warps stride over positions
//   p < n, U = 8 / E positions per iteration; a warp reads one position's
//   D payload bytes as one coalesced segment (lane l owns bytes
//   [l*E, (l+1)*E), E = D / 32) and its two bf16 scales in place through
//   strides (bf16 -> fp32 is exact, so the scale leaves need no per-step
//   transpose or cast, which the TPU router makes).
// - The payload format is a runtime argument, uniform over the grid, not
//   a template parameter. Each iteration issues all its loads first
//   (predicated, as the bf16 kernels do), then takes one branch on the
//   format to decode them: a format branch between the loads serialises
//   them, ~4x slower on the card at the serving shapes.
// - Positions >= n are never read; a position that a query masks adds
//   p = 0 and leaves the running max alone, so garbage there (NaN
//   payloads or scales included) cannot reach the output.
// - Verify query 0 gives the SAME BITS as the paged decode at occupancy
//   kv_len - T + 1: both run this template with the same warp partition,
//   loop and merge order, and the arithmetic is written with explicit _rn
//   intrinsics so the compiler cannot contract it differently per tile
//   width. Greedy acceptance over a quantized pool rests on it (and, for
//   bf16 q, on paged_tc.cuh's same property).
//
// Left for later PRs: nothing of this file's own; the fp32 template is
// not on a serving path (fp32 runs only the token-identity checks).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "paged_tc.cuh"

namespace {

constexpr float kNegInf = -1.0e30f;
constexpr int kWarps = 8;
constexpr int kMaxTile = 8;
// Shared memory for the row's table: 8192 columns, 32 KB.
constexpr int kMaxTableCols = 8192;
// Payload formats, as the wrapper numbers them.
constexpr int kInt8 = 0;
constexpr int kE4M3 = 1;
constexpr int kE5M2 = 2;

// One payload byte as fp32, exactly.
template <int kFmt>
__device__ __forceinline__ float decode(uint32_t x) {
  if constexpr (kFmt == kInt8) {
    return static_cast<float>(static_cast<int8_t>(static_cast<uint8_t>(x)));
  } else {
    const __half_raw hr = __nv_cvt_fp8_to_halfraw(
        static_cast<__nv_fp8_storage_t>(x),
        kFmt == kE4M3 ? __NV_E4M3 : __NV_E5M2);
    return __half2float(__half(hr));
  }
}

// Every loaded payload byte of an iteration as fp32; one uniform branch
// on the format per iteration, none per element.
template <int kFmt, int U, int E>
__device__ __forceinline__ void decode_all(const uint32_t (&kb)[U][E],
                                           const uint32_t (&vb)[U][E],
                                           float (&kr)[U][E],
                                           float (&vr)[U][E]) {
#pragma unroll
  for (int j = 0; j < U; ++j) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      kr[j][e] = decode<kFmt>(kb[j][e]);
      vr[j][e] = decode<kFmt>(vb[j][e]);
    }
  }
}

// The fp32-q template's arguments (q and out float32).
struct Params {
  const void* q;
  const uint8_t* k;
  const uint8_t* v;
  const __nv_bfloat16* ks;
  const __nv_bfloat16* vs;
  const int32_t* kv_len;
  const int32_t* tables;  // paged only
  void* out;
  int H, M, cap, log2_bs, fmt;
  // Payload and scale strides in elements: (row, position, head), where
  // the row is the batch row of the contiguous cache or the pool block.
  int64_t q_sb, q_st, q_sh;
  int64_t kv_sr, kv_sp, kv_sh;
  int64_t sc_sr, sc_sp, sc_sh;
  int64_t o_sb, o_st, o_sh;
  float scale;
};

template <int E, int NQ, bool kPaged>
__global__ void __launch_bounds__(kWarps * 32)
quant_attention_kernel(const Params a) {
  constexpr int D = 32 * E;
  constexpr int U = 8 / E;
  extern __shared__ int32_t sm_tbl[];
  __shared__ float sm_m[kWarps];
  __shared__ float sm_l[kWarps];
  __shared__ float sm_acc[kWarps][D];

  const int b = blockIdx.x / a.H;
  const int h = blockIdx.x % a.H;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int bs_mask = (1 << a.log2_bs) - 1;

  // Per-query occupancy; n is what the last (widest) query reads.
  const int len = a.kv_len[b];
  int nq[NQ];
#pragma unroll
  for (int t = 0; t < NQ; ++t) {
    nq[t] = min(max(len - (NQ - 1) + t, 1), a.cap);
  }
  const int n = nq[NQ - 1];

  if constexpr (kPaged) {
    // The CTA loads its own indices: only the table columns n reaches.
    const int n_blk = ((n - 1) >> a.log2_bs) + 1;
    const int32_t* trow = a.tables + static_cast<int64_t>(b) * a.M;
    for (int i = threadIdx.x; i < n_blk; i += blockDim.x) sm_tbl[i] = trow[i];
    __syncthreads();
  }

  const float* qbase = static_cast<const float*>(a.q);
  float qr[NQ][E];
  float acc[NQ][E];
  float m[NQ];
  float l[NQ];
#pragma unroll
  for (int t = 0; t < NQ; ++t) {
    const float* qp =
        qbase + b * a.q_sb + t * a.q_st + h * a.q_sh + lane * E;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      qr[t][e] = qp[e];
      acc[t][e] = 0.f;
    }
    m[t] = kNegInf;
    l[t] = 0.f;
  }

  for (int p0 = warp * U; p0 < n; p0 += kWarps * U) {
    // Every load of the U positions is issued before any is used
    // (predicated, no branch between them), then the bytes are decoded.
    uint32_t kb[U][E];
    uint32_t vb[U][E];
    float ksc[U];
    float vsc[U];
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const int p = p0 + j;
      const bool live = p < n;
      int64_t row = b;
      int pos = p;
      if constexpr (kPaged) {
        row = live ? sm_tbl[p >> a.log2_bs] : 0;
        pos = p & bs_mask;
      }
      const int64_t off =
          live ? row * a.kv_sr + pos * a.kv_sp + h * a.kv_sh + lane * E : 0;
      const int64_t soff =
          live ? row * a.sc_sr + pos * a.sc_sp + h * a.sc_sh : 0;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        kb[j][e] = live ? a.k[off + e] : 0u;
        vb[j][e] = live ? a.v[off + e] : 0u;
      }
      ksc[j] = live ? __bfloat162float(a.ks[soff]) : 0.f;
      vsc[j] = live ? __bfloat162float(a.vs[soff]) : 0.f;
    }
    float kr[U][E];
    float vr[U][E];
    if (a.fmt == kInt8) {
      decode_all<kInt8>(kb, vb, kr, vr);
    } else if (a.fmt == kE4M3) {
      decode_all<kE4M3>(kb, vb, kr, vr);
    } else {
      decode_all<kE5M2>(kb, vb, kr, vr);
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
        s[j] = p0 + j < nq[t] ? __fmul_rn(__fmul_rn(s[j], ksc[j]), a.scale)
                              : kNegInf;
        m_new = fmaxf(m_new, s[j]);
      }
      const float alpha = expf(__fsub_rn(m[t], m_new));
      l[t] = __fmul_rn(l[t], alpha);
#pragma unroll
      for (int e = 0; e < E; ++e) acc[t][e] = __fmul_rn(acc[t][e], alpha);
#pragma unroll
      for (int j = 0; j < U; ++j) {
        const bool on = p0 + j < nq[t];
        const float p = on ? expf(__fsub_rn(s[j], m_new)) : 0.f;
        l[t] = __fadd_rn(l[t], p);
        const float pv = on ? __fmul_rn(p, vsc[j]) : 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[t][e] = fmaf(pv, vr[j][e], acc[t][e]);
      }
      m[t] = m_new;
    }
  }

  float* obase = static_cast<float*>(a.out);
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
      obase[b * a.o_sb + t * a.o_st + h * a.o_sh + d] =
          __fdiv_rn(num, fmaxf(den, 1e-30f));
    }
    __syncthreads();
  }
}

template <int E, int NQ, bool kPaged>
void launch_one(const Params& a, int rows, cudaStream_t st) {
  const size_t smem = kPaged ? static_cast<size_t>(a.M) * sizeof(int32_t) : 0;
  quant_attention_kernel<E, NQ, kPaged>
      <<<rows * a.H, kWarps * 32, smem, st>>>(a);
}

template <int E>
void launch_tile(int nq, const Params& a, int rows, cudaStream_t st) {
  switch (nq) {
    case 1: launch_one<E, 1, true>(a, rows, st); break;
    case 2: launch_one<E, 2, true>(a, rows, st); break;
    case 3: launch_one<E, 3, true>(a, rows, st); break;
    case 4: launch_one<E, 4, true>(a, rows, st); break;
    case 5: launch_one<E, 5, true>(a, rows, st); break;
    case 6: launch_one<E, 6, true>(a, rows, st); break;
    case 7: launch_one<E, 7, true>(a, rows, st); break;
    case 8: launch_one<E, 8, true>(a, rows, st); break;
  }
}

// nq == 0: the contiguous cache (one query); else a paged tile of nq.
template <int E>
void launch_e(int nq, const Params& a, int rows, cudaStream_t st) {
  if (nq == 0) {
    launch_one<E, 1, false>(a, rows, st);
  } else {
    launch_tile<E>(nq, a, rows, st);
  }
}

bool valid_common(int B, int H, int D, int dtype, int fmt, int splits) {
  return B >= 1 && H >= 1 && (D == 32 || D == 64 || D == 128 || D == 256) &&
         (dtype == 0 || dtype == 1) && fmt >= kInt8 && fmt <= kE5M2 &&
         splits >= 1 && splits <= paged_tc::kMaxSplits;
}

// The fp32-q template, for head dim D.
int launch_fp32(int nq, int rows, int D, const Params& a, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D / 32) {
    case 1: launch_e<1>(nq, a, rows, st); break;
    case 2: launch_e<2>(nq, a, rows, st); break;
    case 4: launch_e<4>(nq, a, rows, st); break;
    case 8: launch_e<8>(nq, a, rows, st); break;
  }
  return static_cast<int>(cudaGetLastError());
}

// bf16 q: paged_tc.cuh, paged or contiguous.
template <bool kPaged>
int launch_bf16(const paged_tc::Params& a, int rows, int D, int splits,
                void* stream) {
  const cudaError_t err = paged_tc::launch<true, kPaged>(
      a, rows, D, splits, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

int launch_paged(const void* q, const void* k, const void* v, const void* ks,
                 const void* vs, const void* kv_len, const void* tables,
                 void* out, int B, int T, int H, int D, int N, int bs, int M,
                 int dtype, int fmt, int splits, long long q_sb,
                 long long q_st, long long q_sh, long long p_sn,
                 long long p_ss, long long p_sh, long long s_sn,
                 long long s_ss, long long s_sh, long long o_sb,
                 long long o_st, long long o_sh, float scale, void* stream) {
  int log2_bs = 0;
  while ((1 << log2_bs) < bs) ++log2_bs;
  if (!valid_common(B, H, D, dtype, fmt, splits) || N < 1 || M < 1 ||
      M > kMaxTableCols || T < 1 || T > kMaxTile || bs < 1 ||
      (1 << log2_bs) != bs) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0) {
    const Params a{q, static_cast<const uint8_t*>(k),
                   static_cast<const uint8_t*>(v),
                   static_cast<const __nv_bfloat16*>(ks),
                   static_cast<const __nv_bfloat16*>(vs),
                   static_cast<const int32_t*>(kv_len),
                   static_cast<const int32_t*>(tables), out, H, M, M * bs,
                   log2_bs, fmt, q_sb, q_st, q_sh, p_sn, p_ss, p_sh, s_sn,
                   s_ss, s_sh, o_sb, o_st, o_sh, scale};
    return launch_fp32(T, B, D, a, stream);
  }
  const paged_tc::Params a{
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const unsigned char*>(k),
      static_cast<const unsigned char*>(v),
      static_cast<const __nv_bfloat16*>(ks),
      static_cast<const __nv_bfloat16*>(vs),
      static_cast<const int32_t*>(kv_len),
      static_cast<const int32_t*>(tables), static_cast<__nv_bfloat16*>(out),
      T, H, M, log2_bs, fmt, M * bs, q_sb, q_st, q_sh, p_sn, p_ss, p_sh, s_sn,
      s_ss, s_sh, o_sb, o_st, o_sh, scale};
  return launch_bf16<true>(a, B, D, splits, stream);
}

}  // namespace

// Every entry point: payloads with unit stride along D and strides given
// in elements (bytes); scales bf16 with the payload's leading shape and
// their own strides; kv_len [B] int32, each row's total occupancy (a
// verify tile included), clamped here to [1, cap]; D in {32, 64, 128,
// 256}. dtype (of q and out): 0 = float32, 1 = bfloat16. fmt (of the
// payloads): 0 = int8, 1 = fp8 e4m3, 2 = fp8 e5m2. splits in 1..8: CTAs
// per (row, head), one cluster (bf16 q; fp32 takes one CTA). The bf16-q
// kernel reads the payloads 16 bytes at a time: 16-byte aligned, the row
// (or block), position and head strides multiples of 16 bytes (the
// wrapper checks). Returns a cudaError_t as int.

// Contiguous: q [B, H, D], k/v [B, S, H, D], scales [B, S, H], out
// [B, H, D].
extern "C" int frl_decode_attention_quant(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* kv_len, void* out, int B, int H, int S,
    int D, int dtype, int fmt, int splits, long long q_sb, long long q_sh,
    long long kv_sb, long long kv_ss, long long kv_sh, long long sc_sb,
    long long sc_ss, long long sc_sh, long long o_sb, long long o_sh,
    float scale, void* stream) {
  if (!valid_common(B, H, D, dtype, fmt, splits) || S < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0) {
    const Params a{q, static_cast<const uint8_t*>(k),
                   static_cast<const uint8_t*>(v),
                   static_cast<const __nv_bfloat16*>(k_scale),
                   static_cast<const __nv_bfloat16*>(v_scale),
                   static_cast<const int32_t*>(kv_len), nullptr, out, H, 0,
                   S, 0, fmt, q_sb, 0, q_sh, kv_sb, kv_ss, kv_sh, sc_sb,
                   sc_ss, sc_sh, o_sb, 0, o_sh, scale};
    return launch_fp32(0, B, D, a, stream);
  }
  const paged_tc::Params a{
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const unsigned char*>(k),
      static_cast<const unsigned char*>(v),
      static_cast<const __nv_bfloat16*>(k_scale),
      static_cast<const __nv_bfloat16*>(v_scale),
      static_cast<const int32_t*>(kv_len), nullptr,
      static_cast<__nv_bfloat16*>(out), 1, H, 0, 0, fmt, S, q_sb, 0, q_sh,
      kv_sb, kv_ss, kv_sh, sc_sb, sc_ss, sc_sh, o_sb, 0, o_sh, scale};
  return launch_bf16<false>(a, B, D, splits, stream);
}

// Paged: q and out [B, T, H, D] (T = 1 for decode), pools [N, bs, H, D],
// scale pools [N, bs, H]; tables [B, M] int32, contiguous, every column a
// row's occupancy reaches holding a pool block id in [0, N); bs a power
// of two. splits in 1..8: CTAs per (row, head), one cluster (bf16 q; fp32
// takes one CTA). The bf16-q kernel reads the pools 16 bytes at a time:
// 16-byte aligned, the N, bs and H strides multiples of 16 bytes (the
// wrapper checks).
extern "C" int frl_paged_decode_attention_quant(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* kv_len, const void* tables, void* out,
    int B, int T, int H, int D, int N, int bs, int M, int dtype, int fmt,
    int splits, long long q_sb, long long q_st, long long q_sh,
    long long p_sn, long long p_ss, long long p_sh, long long s_sn,
    long long s_ss, long long s_sh, long long o_sb, long long o_st,
    long long o_sh, float scale, void* stream) {
  if (T != 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch_paged(q, k, v, k_scale, v_scale, kv_len, tables, out, B, T,
                      H, D, N, bs, M, dtype, fmt, splits, q_sb, q_st, q_sh,
                      p_sn, p_ss, p_sh, s_sn, s_ss, s_sh, o_sb, o_st, o_sh,
                      scale, stream);
}

extern "C" int frl_paged_verify_attention_quant(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* kv_len, const void* tables, void* out,
    int B, int T, int H, int D, int N, int bs, int M, int dtype, int fmt,
    int splits, long long q_sb, long long q_st, long long q_sh,
    long long p_sn, long long p_ss, long long p_sh, long long s_sn,
    long long s_ss, long long s_sh, long long o_sb, long long o_st,
    long long o_sh, float scale, void* stream) {
  return launch_paged(q, k, v, k_scale, v_scale, kv_len, tables, out, B, T,
                      H, D, N, bs, M, dtype, fmt, splits, q_sb, q_st, q_sh,
                      p_sn, p_ss, p_sh, s_sn, s_ss, s_sh, o_sb, o_st, o_sh,
                      scale, stream);
}
