// Decode and speculative-verify attention over a PAGED KV cache, and
// decode over a CONTIGUOUS quantized one, for a bf16 q, on the tensor
// cores: the design that paged_attention.cu (bf16 pools) and
// quant_attention.cu (1-byte pools and the 1-byte contiguous cache, with
// bf16 scales) launch for bf16 q. fp32 q keeps each file's CUDA-core
// template.
//
// Same function as those files state: query t of a row whose total
// occupancy is kv_len attends logical positions
// p < n_t = clamp(kv_len - (T-1) + t, 1, cap), T <= 8 queries a row
// (T = 1 for the decode), cap = M*bs for the pools (retired rows run past
// their table) and S for the contiguous cache [B, S, H, D] (rows past
// their bucket read all of it), an online softmax in fp32 with mask value
// -1e30 and the denominator floored at 1e-30, output in bf16. bf16 pools:
// the probability rounded to bf16 before the PV product (the TPU kernels
// cast p to v's dtype). Quantized pools: the score is
// (q . k_payload) * k_scale * log2(e)/sqrt(D) in fp32, and the PV operand
// is p * v_scale in fp32, unrounded.
//
// Bound: HBM bytes (the occupied prefix of K and V, T <= 8 flops a byte).
// At the serving shapes (8 slots x 16 heads, occupancies from 1 to the
// table's 1024 positions) a launch lasts microseconds, so what bounds it
// is how many bytes each SM keeps in flight, and how little the tile's
// arithmetic costs once they land.
//
// Design:
// - Addressing, a template flag (kPaged). Paged: logical position p of
//   row b is pool[tables[b, p / bs], p % bs]. Contiguous: cache[b, p],
//   through the row, position and head strides (a per-layer view of the
//   engine's cache, whose row stride is not S times the position
//   stride); no table, no table prologue, no table in shared memory.
// - Split over positions, fixed by tile index. A tile is 16 logical
//   positions (one pool block at the serving block size 16). The grid is
//   (B*H, splits); split s takes tiles [s*c, (s+1)*c) of the capacity,
//   c = ceil(ceil(cap/16) / splits), cut at the last query's
//   occupancy, and warp w of its CTA takes the tiles whose index within
//   the split is w mod the warp count, in increasing order. The host
//   picks splits from B*H, cap and the SM count, never from kv_len
//   (ops/decode_attention.py `paged_splits`, `decode_splits`): the
//   decode runs at n0 and the verify at n0 + T - 1, and both must
//   partition positions alike.
//   The splits of one (row, head) form a thread-block cluster; rank 0
//   merges their partials through distributed shared memory in split
//   order, as decode_attention.cu does.
// - Memory. Paged, the CTA copies its split's table columns into shared
//   memory (cp.async, alongside the occupancy and q, so the three loads
//   overlap; table entries are indices, not pool bytes). Each warp stages
//   its tile's K and V head slices (16 rows at the cache's position stride)
//   with 16-byte cp.async into a 2-stage ring of its own, so the next
//   tile is in flight while this one is computed;
//   rows at or past the last query's occupancy are zero-filled (src-size
//   0) and never read from the cache. Quantized: one cp.async carries 16
//   payload bytes, and the tile's 16 K and 16 V scales are plain loads
//   issued with it, one a lane. 16 warps a CTA (B4's finding); 8 at
//   D = 128 and 4 at D = 256, where the ring would not fit.
// - Compute on the tensor cores (mma.sync.m16n8k16, bf16 operands, fp32
//   accumulators). The T <= 8 queries are rows 0..T-1 of one 16-row A
//   tile, loaded once (rows >= T zero). Per tile: S = Q K^T as two n-tiles
//   of 8 positions; the causal mask p < n_t by select (s = -1e30, p = 0;
//   nothing added, no scale of a masked position multiplied in); the
//   online softmax per row in registers, a row's max over the 4 lanes of
//   a quad, 2^x by the special-function unit; then O += P V with P's C
//   fragments reused as the A fragment. bf16 pools: K by ldmatrix, V by
//   ldmatrix.trans (rows padded by 16 bytes: no bank conflicts).
//   Quantized: the payload bytes become bf16 exactly (int8 by an fp32
//   magic number, fp8 through fp16: every value of the three formats is
//   a bf16) as each lane builds its B fragments from shared memory; the
//   contraction index d is permuted so that a lane reads 16 contiguous K
//   bytes (q's A fragment is built with the same permutation), V's
//   output columns so that a lane reads D/8 contiguous bytes of each of
//   its four rows (undone where the warps merge); p * v_scale enters as
//   bf16 hi + lo, two products (flash dK/dV's device).
// - Query 0 of a verify tile equals the decode (T = 1) at occupancy
//   kv_len - T + 1 bit for bit: T is a runtime argument of one kernel,
//   so both run the same instructions over the same partition; a tile
//   that only the verify reaches is fully masked for row 0, which keeps
//   its max (alpha = 1 by select) and adds p = 0 (exact zeros through the
//   products); the arithmetic is written with _rn intrinsics.
// - The warps of a CTA merge in warp order through shared memory laid
//   over the finished rings; nothing is atomic, so the output is
//   deterministic.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace paged_tc {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1.0e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kTile = 16;       // positions a tile
constexpr int kMaxQ = 8;        // queries a row (the verify tile)
constexpr int kMaxSplits = 8;   // the portable cluster size
constexpr int kMaxTableCols = 8192;  // the wrappers' 32 KB of table
// Payload formats, as the wrappers number them.
constexpr int kInt8 = 0;
constexpr int kE4M3 = 1;
constexpr int kE5M2 = 2;

template <int D>
__host__ __device__ constexpr int warps() {
  return D <= 64 ? 16 : D == 128 ? 8 : 4;
}


// Bytes of one staged row (a position's head slice) in shared memory.
// bf16: D + 8 elements, so the 8 rows of an ldmatrix phase fall in 8
// distinct 16-byte bank groups. Payload K: read 16 bytes a lane at 16-byte
// steps, conflict-free unpadded up to D = 64 and with 64 bytes of padding
// above. Payload V: read D/8 bytes a lane from rows 2 apart, conflict-free
// with 16 bytes of padding.
template <int D, bool kQuant>
struct Stage {
  static constexpr int kK = kQuant ? (D <= 64 ? D : D + 64) : 2 * (D + 8);
  static constexpr int kV = kQuant ? D + 16 : 2 * (D + 8);
  static constexpr int kBytes = kTile * (kK + kV);  // one tile, K then V
};

struct Params {
  const bf16* q;
  const unsigned char* k;  // pools, as bytes
  const unsigned char* v;
  const bf16* ks;          // scale pools (quantized only)
  const bf16* vs;
  const int32_t* kv_len;
  const int32_t* tables;  // paged only
  bf16* out;
  int T, H, M, log2_bs, fmt;
  // Positions a row holds, S contiguous. The paged mode derives
  // M << log2_bs itself: reading this field instead changed its
  // generated code and slowed it on the card.
  int cap;
  // Strides in elements: q and out (row, query, head); the cache and its
  // scales (block, position, head) paged, (row, position, head)
  // contiguous.
  int64_t q_sb, q_st, q_sh;
  int64_t p_sn, p_ss, p_sh;
  int64_t s_sn, s_ss, s_sh;
  int64_t o_sb, o_st, o_sh;
  float scale;  // 1 / sqrt(D)
};

__host__ __device__ constexpr int table_bytes(int m) {
  return (m * 4 + 15) / 16 * 16;
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

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
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

__device__ __forceinline__ uint32_t pack_bf16(bf16 x, bf16 y) {
  const __nv_bfloat162 v = __halves2bfloat162(x, y);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// hi = bf16(x), lo = bf16(x - hi), pairwise: hi + lo carries x to about
// 16 significant bits.
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(__fsub_rn(x, hf.x), __fsub_rn(y, hf.y));
}

// 2^x by the special-function unit (ex2.approx.ftz: about 2 ulp).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The int8 in a byte's low 8 bits, exactly: 2^23 + (x + 128) - (2^23 + 128).
__device__ __forceinline__ float i8_to_float(uint32_t x) {
  return __fsub_rn(__uint_as_float(0x4B000000u | ((x ^ 0x80u) & 0xFFu)),
                   8388736.f);
}

// The two payload bytes in bits 0-15 (the low byte first) as bf16x2,
// exactly.
template <int kFmt>
__device__ __forceinline__ uint32_t pair_to_bf16x2(uint32_t pair) {
  if constexpr (kFmt == kInt8) {
    return pack_bf16(i8_to_float(pair), i8_to_float(pair >> 8));
  } else {
    const __half2_raw hr = __nv_cvt_fp8x2_to_halfraw2(
        static_cast<__nv_fp8x2_storage_t>(pair & 0xFFFFu),
        kFmt == kE4M3 ? __NV_E4M3 : __NV_E5M2);
    const float2 f = __half22float2(__half2(hr));
    return pack_bf16(f.x, f.y);
  }
}

// Quantized S: the byte of K's row that lane t (of its quad) gives to
// slot 2t (then 2t + 1, 2t + 8, 2t + 9) of contraction chunk kk. A lane
// reads its bytes as 16 contiguous ones (8 at D = 32).
template <int D>
__device__ __forceinline__ int k_byte(int t, int kk) {
  return D == 32 ? 8 * t + 4 * kk : 16 * (t + 4 * (kk >> 2)) + 4 * (kk & 3);
}

// The D/16 words of K's row from which lane t builds its B fragments:
// word kk holds the bytes of chunk kk's slots.
template <int D>
__device__ __forceinline__ void load_k_words(const unsigned char* row, int t,
                                             uint32_t (&w)[D / 16]) {
  if constexpr (D == 32) {
    const uint2 x = *reinterpret_cast<const uint2*>(row + 8 * t);
    w[0] = x.x;
    w[1] = x.y;
  } else {
#pragma unroll
    for (int i = 0; i < D / 64; ++i) {
      const uint4 x = *reinterpret_cast<const uint4*>(row + 16 * (t + 4 * i));
      w[4 * i] = x.x;
      w[4 * i + 1] = x.y;
      w[4 * i + 2] = x.z;
      w[4 * i + 3] = x.w;
    }
  }
}

// D/8 contiguous bytes of a V row, as D/32 words.
template <int D>
__device__ __forceinline__ void load_v_words(const unsigned char* p,
                                             uint32_t (&w)[D / 32]) {
  if constexpr (D == 32) {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  } else if constexpr (D == 64) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    w[0] = x.x;
    w[1] = x.y;
  } else {
#pragma unroll
    for (int i = 0; i < D / 128; ++i) {
      const uint4 x = *reinterpret_cast<const uint4*>(p + 16 * i);
      w[4 * i] = x.x;
      w[4 * i + 1] = x.y;
      w[4 * i + 2] = x.z;
      w[4 * i + 3] = x.w;
    }
  }
}

// The output column that accumulator element (n-tile j, column c) of the
// PV product holds: bf16 pools in order; quantized, V's columns permuted
// so that lane g of a quad row reads bytes [g D/8, (g + 1) D/8).
template <int D, bool kQuant>
__device__ __forceinline__ int out_col(int j, int c) {
  return kQuant ? c * (D / 8) + j : 8 * j + c;
}

// Stage tile `tile`'s K and V head slices of row b into `st` (cp.async,
// rows at or past n zero-filled). Quantized, returns lane l's scale of
// the tile: K's of position l for l < 16, V's of position l - 16, 0 past
// n. Paged, position p is pool[tbl[p >> log2_bs], p & mask]; contiguous,
// cache[b, p]. The two offsets are written out apart, each as one
// expression: a shared helper changed the paged mode's generated code and
// slowed it on the card.
template <int D, bool kQuant, bool kPaged>
__device__ __forceinline__ float stage_tile(const Params& a,
                                            const int32_t* tbl,
                                            unsigned char* st, int tile,
                                            int n, int b, int h, int lane) {
  using S = Stage<D, kQuant>;
  constexpr int kElem = kQuant ? 1 : 2;
  constexpr int kChunks = D * kElem / 16;  // 16-byte chunks of a row
  const int mask = (1 << a.log2_bs) - 1;
  const int p0 = tile * kTile;
#pragma unroll
  for (int it = 0; it < kTile * kChunks / 32; ++it) {
    const int i = lane + 32 * it;
    const int r = i / kChunks;
    const int c = i % kChunks;
    const int p = p0 + r;
    const bool ok = p < n;
    int64_t off;
    if constexpr (kPaged) {
      off = ok ? (static_cast<int64_t>(tbl[p >> a.log2_bs]) * a.p_sn +
                  static_cast<int64_t>(p & mask) * a.p_ss + h * a.p_sh) *
                         kElem +
                     c * 16
               : 0;
    } else {
      off = ok ? (static_cast<int64_t>(b) * a.p_sn +
                  static_cast<int64_t>(p) * a.p_ss + h * a.p_sh) *
                         kElem +
                     c * 16
               : 0;
    }
    cp_async16(st + r * S::kK + c * 16, a.k + off, ok);
    cp_async16(st + kTile * S::kK + r * S::kV + c * 16, a.v + off, ok);
  }
  if constexpr (kQuant) {
    const int p = p0 + (lane & 15);
    if (p < n) {
      int64_t off;
      if constexpr (kPaged) {
        off = static_cast<int64_t>(tbl[p >> a.log2_bs]) * a.s_sn +
              static_cast<int64_t>(p & mask) * a.s_ss + h * a.s_sh;
      } else {
        off = static_cast<int64_t>(b) * a.s_sn +
              static_cast<int64_t>(p) * a.s_ss + h * a.s_sh;
      }
      return __bfloat162float((lane < 16 ? a.ks : a.vs)[off]);
    }
  }
  return 0.f;
}

// One staged tile through S = Q K^T, the masked online softmax of row g
// (occupancy n_row) and O += P V.
template <int D, bool kQuant, int kFmt>
__device__ __forceinline__ void tile_step(
    const unsigned char* st, int tile, int n_row, float sc,
    float scale_log2, const uint32_t (&qa)[D / 16][2], float (&acc)[D / 8][4],
    float& m_r, float& l_r, int lane) {
  using S = Stage<D, kQuant>;
  constexpr int LDS = D + 8;  // bf16 row stride, elements
  const int g = lane >> 2;
  const int t4 = lane & 3;

  float s[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  }
  if constexpr (kQuant) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      uint32_t w[D / 16];
      load_k_words<D>(st + (8 * j + g) * S::kK, t4, w);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t af[4] = {qa[kk][0], 0u, qa[kk][1], 0u};
        mma_bf16(s[j], af, pair_to_bf16x2<kFmt>(w[kk]),
                 pair_to_bf16x2<kFmt>(w[kk] >> 16));
      }
    }
  } else {
    const bf16* kt = reinterpret_cast<const bf16*>(st);
    // Matrices 0-1: positions 0-7 (n-tile 0), 2-3: positions 8-15.
    const int off = ((lane & 7) + ((lane >> 4) << 3)) * LDS +
                    ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t bk[4];
      ldsm_x4(bk, kt + off + kk * 16);
      const uint32_t af[4] = {qa[kk][0], 0u, qa[kk][1], 0u};
      mma_bf16(s[0], af, bk[0], bk[1]);
      mma_bf16(s[1], af, bk[2], bk[3]);
    }
  }

  // Row g's scores at positions 8 j + 2 t4 + e of the tile; the scales of
  // those positions come from the lanes that loaded them.
  const int p0 = tile * kTile;
  float vsc[2][2];
  float x[2][2];
  float mx = m_r;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 8 * j + 2 * t4 + e;
      float v;
      if constexpr (kQuant) {
        const float ks = __shfl_sync(0xffffffffu, sc, col);
        vsc[j][e] = __shfl_sync(0xffffffffu, sc, 16 + col);
        v = __fmul_rn(__fmul_rn(s[j][e], ks), scale_log2);
      } else {
        v = __fmul_rn(s[j][e], scale_log2);
      }
      x[j][e] = p0 + col < n_row ? v : kNegInf;
      mx = fmaxf(mx, x[j][e]);
    }
  }
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
  const float alpha = mx > m_r ? ex2(__fsub_rn(m_r, mx)) : 1.f;
  m_r = mx;
  l_r = __fmul_rn(l_r, alpha);
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    acc[j][0] = __fmul_rn(acc[j][0], alpha);
    acc[j][1] = __fmul_rn(acc[j][1], alpha);
  }
  float pr[2][2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      pr[j][e] = p0 + 8 * j + 2 * t4 + e < n_row
                     ? ex2(__fsub_rn(x[j][e], mx))
                     : 0.f;
      l_r = __fadd_rn(l_r, pr[j][e]);
    }
  }

  // O += P V: row g of P as the A fragment (rows g + 8 zero).
  const unsigned char* vst = st + kTile * S::kK;
  if constexpr (kQuant) {
    uint32_t ph[4] = {0u, 0u, 0u, 0u};
    uint32_t pl[4] = {0u, 0u, 0u, 0u};
    split_bf16(__fmul_rn(pr[0][0], vsc[0][0]), __fmul_rn(pr[0][1], vsc[0][1]),
               ph[0], pl[0]);
    split_bf16(__fmul_rn(pr[1][0], vsc[1][0]), __fmul_rn(pr[1][1], vsc[1][1]),
               ph[2], pl[2]);
    // Rows 2 t4, 2 t4 + 1, 2 t4 + 8, 2 t4 + 9 (the B fragment's k), bytes
    // [g D/8, (g + 1) D/8) (its n, permuted).
    uint32_t r[4][D / 32];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = 2 * t4 + (i & 1) + 8 * (i >> 1);
      load_v_words<D>(vst + row * S::kV + g * (D / 8), r[i]);
    }
#pragma unroll
    for (int wi = 0; wi < D / 32; ++wi) {
      // Bytes c of rows (2 t4, 2 t4 + 1) and (2 t4 + 8, 2 t4 + 9),
      // interleaved into pairs: column 4 wi + c of the permuted V.
      const uint32_t lo01 = __byte_perm(r[0][wi], r[1][wi], 0x5140);
      const uint32_t hi01 = __byte_perm(r[0][wi], r[1][wi], 0x7362);
      const uint32_t lo89 = __byte_perm(r[2][wi], r[3][wi], 0x5140);
      const uint32_t hi89 = __byte_perm(r[2][wi], r[3][wi], 0x7362);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int sh = 16 * (c & 1);
        const uint32_t b0 = pair_to_bf16x2<kFmt>((c < 2 ? lo01 : hi01) >> sh);
        const uint32_t b1 = pair_to_bf16x2<kFmt>((c < 2 ? lo89 : hi89) >> sh);
        mma_bf16(acc[4 * wi + c], ph, b0, b1);
        mma_bf16(acc[4 * wi + c], pl, b0, b1);
      }
    }
  } else {
    const uint32_t pa[4] = {pack_bf16(pr[0][0], pr[0][1]), 0u,
                            pack_bf16(pr[1][0], pr[1][1]), 0u};
    const bf16* vt = reinterpret_cast<const bf16*>(vst);
    // Matrices 0-1: positions 0-7 and 8-15 of columns 0-7, 2-3: of 8-15.
    const int off = ((lane & 7) + (((lane >> 3) & 1) << 3)) * LDS +
                    (lane >> 4) * 8;
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t bv[4];
      ldsm_x4_t(bv, vt + off + dp * 16);
      mma_bf16(acc[2 * dp], pa, bv[0], bv[1]);
      mma_bf16(acc[2 * dp + 1], pa, bv[2], bv[3]);
    }
  }
}

template <int D, bool kQuant, bool kPaged>
__global__ void __launch_bounds__(warps<D>() * 32)
paged_tc_kernel(const Params a) {
  constexpr int W = warps<D>();
  using S = Stage<D, kQuant>;
  static_assert(W * kMaxQ * (D + 2) * 4 <= W * 2 * S::kBytes,
                "the merge scratch must fit in the rings it overlays");
  extern __shared__ __align__(16) unsigned char smem[];
  // This CTA's merged partial per query: acc[D], then m and l.
  __shared__ float part[kMaxQ][D + 2];

  const int T = a.T;
  const int b = blockIdx.x / a.H;
  const int h = blockIdx.x % a.H;
  const int splits = gridDim.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int cap = kPaged ? a.M << a.log2_bs : a.cap;

  // The occupancy, this split's table columns (paged: all its share of
  // the table, which needs no occupancy; copied asynchronously) and q's
  // fragments are independent loads, all in flight at once.
  const int len = a.kv_len[b];
  const int tiles = (cap + kTile - 1) / kTile;
  const int per = (tiles + splits - 1) / splits;
  const int tile0 = static_cast<int>(blockIdx.y) * per;
  int32_t* tbl = reinterpret_cast<int32_t*>(smem);
  unsigned char* rings = smem + (kPaged ? table_bytes(a.M) : 0);
  if constexpr (kPaged) {
    if (tile0 < tiles) {
      const int c0 = (tile0 * kTile) >> a.log2_bs;
      const int c1 =
          ((min(tile0 + per, tiles) * kTile - 1) >> a.log2_bs) + 1;
      const int32_t* trow = a.tables + static_cast<int64_t>(b) * a.M;
      for (int i = c0 + static_cast<int>(threadIdx.x); i < min(c1, a.M);
           i += blockDim.x) {
        cp_async4(tbl + i, trow + i);
      }
    }
    cp_async_commit();
  }

  // q's A fragments, row g: slots 2 t4, + 1 (register 0) and 2 t4 + 8,
  // + 9 (register 1) of each 16-wide chunk of the contraction.
  uint32_t qa[D / 16][2];
  {
    const bf16* qrow = a.q + b * a.q_sb + g * a.q_st + h * a.q_sh;
    const bf16 zero = __float2bfloat16(0.f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c0 = kQuant ? k_byte<D>(t4, kk) : 16 * kk + 2 * t4;
      const int c1 = kQuant ? c0 + 2 : c0 + 8;
      qa[kk][0] = g < T ? pack_bf16(qrow[c0], qrow[c0 + 1])
                        : pack_bf16(zero, zero);
      qa[kk][1] = g < T ? pack_bf16(qrow[c1], qrow[c1 + 1])
                        : pack_bf16(zero, zero);
    }
  }

  // The last query's occupancy bounds every read; row g is query g. This
  // CTA's tiles: the split's share cut at n.
  const int n = min(max(len, 1), cap);
  const int n_row = g < T ? min(max(len - (T - 1) + g, 1), cap) : 0;
  const int tile1 = min(tile0 + per, (n + kTile - 1) / kTile);
  if constexpr (kPaged) {
    cp_async_wait<0>();
    __syncthreads();  // the table columns are in
  }
  const float scale_log2 = __fmul_rn(a.scale, kLog2e);

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  }
  float m_r = kNegInf;  // row g's running max, log2 units
  float l_r = 0.f;      // this lane's share of row g's denominator

  // The warp's 2-stage ring: tile i + 1 is staged while tile i is
  // computed (on the H100 at the serving shapes, 3 and 4 stages, 4- and
  // 8-warp CTAs with more splits, and L2 prefetches of a warp's later
  // tiles were no faster). sc: lane l's scale of the tile computed.
  unsigned char* ring = rings + warp * 2 * S::kBytes;
  int tile = tile0 + warp;
  float sc = 0.f;
  if (tile < tile1) {
    sc = stage_tile<D, kQuant, kPaged>(a, tbl, ring, tile, n, b, h, lane);
  }
  cp_async_commit();
  for (int i = 0; tile < tile1; ++i, tile += W) {
    float sc_next = 0.f;
    if (tile + W < tile1) {
      sc_next = stage_tile<D, kQuant, kPaged>(
          a, tbl, ring + ((i + 1) & 1) * S::kBytes, tile + W, n, b, h, lane);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile's group has landed
    __syncwarp();
    const unsigned char* st = ring + (i & 1) * S::kBytes;
    if constexpr (kQuant) {
      if (a.fmt == kInt8) {
        tile_step<D, true, kInt8>(st, tile, n_row, sc, scale_log2, qa, acc,
                                  m_r, l_r, lane);
      } else if (a.fmt == kE4M3) {
        tile_step<D, true, kE4M3>(st, tile, n_row, sc, scale_log2, qa, acc,
                                  m_r, l_r, lane);
      } else {
        tile_step<D, true, kE5M2>(st, tile, n_row, sc, scale_log2, qa, acc,
                                  m_r, l_r, lane);
      }
    } else {
      tile_step<D, false, 0>(st, tile, n_row, sc, scale_log2, qa, acc, m_r,
                             l_r, lane);
    }
    __syncwarp();  // every lane is done with this stage before its refill
    sc = sc_next;
  }
  l_r = __fadd_rn(l_r, __shfl_xor_sync(0xffffffffu, l_r, 1));
  l_r = __fadd_rn(l_r, __shfl_xor_sync(0xffffffffu, l_r, 2));

  // Merge the warps in warp order, through scratch laid over the rings.
  __syncthreads();  // every warp is done with its ring
  float* sm_acc = reinterpret_cast<float*>(rings);  // [W][kMaxQ][D]
  float* sm_m = sm_acc + W * kMaxQ * D;             // [W][kMaxQ]
  float* sm_l = sm_m + W * kMaxQ;
  if (g < T) {
    float* row = sm_acc + (warp * kMaxQ + g) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      row[out_col<D, kQuant>(j, 2 * t4)] = acc[j][0];
      row[out_col<D, kQuant>(j, 2 * t4 + 1)] = acc[j][1];
    }
    if (t4 == 0) {
      sm_m[warp * kMaxQ + g] = m_r;
      sm_l[warp * kMaxQ + g] = l_r;
    }
  }
  __syncthreads();
  bf16* ob = a.out + b * a.o_sb + h * a.o_sh;
  for (int i = threadIdx.x; i < T * D; i += blockDim.x) {
    const int t = i / D;
    const int d = i % D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < W; ++w) mx = fmaxf(mx, sm_m[w * kMaxQ + t]);
    float den = 0.f;
    float num = 0.f;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const float c = ex2(__fsub_rn(sm_m[w * kMaxQ + t], mx));
      den = fmaf(sm_l[w * kMaxQ + t], c, den);
      num = fmaf(sm_acc[(w * kMaxQ + t) * D + d], c, num);
    }
    if (splits == 1) {
      ob[t * a.o_st + d] = __float2bfloat16(__fdiv_rn(num, fmaxf(den, 1e-30f)));
    } else {
      part[t][d] = num;
      if (d == 0) {
        part[t][D] = mx;
        part[t][D + 1] = den;
      }
    }
  }
  if (splits == 1) return;

  // Merge the cluster's splits, in split order, on rank 0.
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every CTA's partial is written
  if (cluster.block_rank() == 0) {
    for (int i = threadIdx.x; i < T * D; i += blockDim.x) {
      const int t = i / D;
      const int d = i % D;
      // Unrolled to kMaxSplits with guards, so rp and cm stay in registers.
      const float* rp[kMaxSplits];
      float cm[kMaxSplits];
      float gm = kNegInf;
#pragma unroll
      for (int r = 0; r < kMaxSplits; ++r) {
        if (r < splits) {
          rp[r] = cluster.map_shared_rank(&part[t][0], r);
          cm[r] = rp[r][D];
          gm = fmaxf(gm, cm[r]);
        }
      }
      float gden = 0.f;
      float num = 0.f;
#pragma unroll
      for (int r = 0; r < kMaxSplits; ++r) {
        if (r < splits) {
          const float c = ex2(__fsub_rn(cm[r], gm));
          gden = fmaf(rp[r][D + 1], c, gden);
          num = fmaf(rp[r][d], c, num);
        }
      }
      ob[t * a.o_st + d] =
          __float2bfloat16(__fdiv_rn(num, fmaxf(gden, 1e-30f)));
    }
  }
  cluster.sync();  // rank 0 is done reading before any CTA exits
}

template <int D, bool kQuant, bool kPaged>
cudaError_t launch_d(const Params& a, int B, int splits, cudaStream_t st) {
  constexpr int W = warps<D>();
  constexpr int kRings = W * 2 * Stage<D, kQuant>::kBytes;
  // Opt in to the most dynamic shared memory any table needs, once per
  // device (a host call per launch would cost the host-bound step).
  static std::atomic<uint64_t> opted{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (!(opted.load() >> dev & 1)) {
    err = cudaFuncSetAttribute(
        paged_tc_kernel<D, kQuant, kPaged>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (kPaged ? table_bytes(kMaxTableCols) : 0) + kRings);
    if (err != cudaSuccess) return err;
    opted.fetch_or(uint64_t{1} << dev);
  }
  const size_t smem = (kPaged ? table_bytes(a.M) : 0) + kRings;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * a.H, splits);
  cfg.blockDim = dim3(W * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, paged_tc_kernel<D, kQuant, kPaged>, a);
}

// Launch for head dim D in {32, 64, 128, 256} (the callers check it),
// splits in 1..kMaxSplits; kPaged false: tables unused, a.cap = S.
// Returns the launch's own error.
template <bool kQuant, bool kPaged>
cudaError_t launch(const Params& a, int B, int D, int splits,
                   cudaStream_t st) {
  switch (D) {
    case 32: return launch_d<32, kQuant, kPaged>(a, B, splits, st);
    case 64: return launch_d<64, kQuant, kPaged>(a, B, splits, st);
    case 128: return launch_d<128, kQuant, kPaged>(a, B, splits, st);
    case 256: return launch_d<256, kQuant, kPaged>(a, B, splits, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace paged_tc
