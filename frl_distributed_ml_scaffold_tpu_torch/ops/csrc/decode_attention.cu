// Single-token decode attention over a contiguous KV cache, for Hopper
// (sm_90a). Built with nvcc into a shared library with a plain C
// interface and loaded with ctypes (ops/_build.py, ops/decode_attention.py).
//
// Replaces the TPU kernel
//   frl_distributed_ml_scaffold_tpu/ops/decode_attention.py::_decode_kernel
// (launched by _flash_decode). Same function: for each (row b, head h),
// softmax(q . K[:n] / sqrt(D)) . V[:n] over the occupied prefix
// n = min(kv_len[b], S) of the cache, online softmax in fp32, mask value
// -1e30, denominator floored at 1e-30, the probability rounded to the cache
// dtype before the PV product (as the TPU kernel casts p to v's dtype),
// output in q's dtype.
//
// Bound: HBM bytes. Per row the kernel must read
// 2 * min(kv_len, S) * H * D * sizeof(dtype) bytes of K and V (plus q and
// o, which are tiny); it does 4 * n * H * D flops on them, one flop per
// byte in bf16, far below the ~295 flop/byte at which the H100 becomes
// compute-bound. So the only lever is to read each cache byte once and
// keep enough loads in flight.
//
// Design (simple first):
// - One CTA of 8 warps per (b, h): 128 CTAs at 8 slots x 16 heads.
// - The cache is read in its [B, S, H, D] layout through strides, so the
//   caller never transposes (a transpose would copy the whole cache every
//   step). A warp reads one position's D-vector as one coalesced segment:
//   lane l owns elements [l*E, (l+1)*E), E = D / 32.
// - Warps stride over positions < n, U positions per iteration (U = 8 / E),
//   whose K and V loads are issued together before any is used. Positions
//   >= n are never read, so they contribute exactly zero whatever the cache
//   holds there. Rows whose kv_len runs past S (retired serving slots keep
//   decoding past their bucket) read the whole cache and no further.
// - Each warp keeps its own running (m, l, acc[D]) in fp32; the warps merge
//   through shared memory with the log-sum-exp rescale at the end.
//
// Left for later PRs: 16-byte vector loads (8 bf16 per lane, several
// positions per warp), cp.async/TMA double buffering of K/V tiles, and a
// split over S with a combine pass for few slots or long caches, where 128
// CTAs leave the card's memory system underfed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1.0e30f;
constexpr int kWarps = 8;

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

// Round to T and back: the probability as the PV product sees it.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

template <typename T, int E>
__global__ void __launch_bounds__(kWarps * 32)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int32_t* __restrict__ kv_len,
                        T* __restrict__ out, int H, int S, int64_t q_sb,
                        int64_t q_sh, int64_t kv_sb, int64_t kv_ss,
                        int64_t kv_sh, int64_t o_sb, int64_t o_sh,
                        float scale) {
  constexpr int D = 32 * E;
  constexpr int U = 8 / E;
  __shared__ float sm_m[kWarps];
  __shared__ float sm_l[kWarps];
  __shared__ float sm_acc[kWarps][D];

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n = min(kv_len[b], S);

  const T* qp = q + b * q_sb + h * q_sh + lane * E;
  const T* kb = k + b * kv_sb + h * kv_sh + lane * E;
  const T* vb = v + b * kv_sb + h * kv_sh + lane * E;
  float qr[E];
  float acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    qr[e] = to_float(qp[e]);
    acc[e] = 0.f;
  }
  float m = kNegInf;
  float l = 0.f;

  for (int p0 = warp * U; p0 < n; p0 += kWarps * U) {
    float kr[U][E];
    float vr[U][E];
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const bool live = p0 + j < n;
      const int64_t off = static_cast<int64_t>(p0 + j) * kv_ss;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        kr[j][e] = live ? to_float(kb[off + e]) : 0.f;
        vr[j][e] = live ? to_float(vb[off + e]) : 0.f;
      }
    }
    float s[U];
#pragma unroll
    for (int j = 0; j < U; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) dot = fmaf(qr[e], kr[j][e], dot);
      s[j] = dot;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int j = 0; j < U; ++j) s[j] += __shfl_xor_sync(0xffffffffu, s[j], o);
    }
    float m_new = m;
#pragma unroll
    for (int j = 0; j < U; ++j) {
      s[j] = p0 + j < n ? s[j] * scale : kNegInf;
      m_new = fmaxf(m_new, s[j]);
    }
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] *= alpha;
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const float p = p0 + j < n ? expf(s[j] - m_new) : 0.f;
      l += p;
      const float pv = round_to<T>(p);
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] = fmaf(pv, vr[j][e], acc[e]);
    }
    m = m_new;
  }

  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
#pragma unroll
  for (int e = 0; e < E; ++e) sm_acc[warp][lane * E + e] = acc[e];
  __syncthreads();

  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w]);
    float den = 0.f;
    float num = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(sm_m[w] - mx);
      den = fmaf(sm_l[w], c, den);
      num = fmaf(sm_acc[w][d], c, num);
    }
    out[b * o_sb + h * o_sh + d] = from_float<T>(num / fmaxf(den, 1e-30f));
  }
}

template <typename T>
void launch(int e, dim3 grid, cudaStream_t st, const void* q, const void* k,
            const void* v, const void* kv_len, void* out, int H, int S,
            int64_t q_sb, int64_t q_sh, int64_t kv_sb, int64_t kv_ss,
            int64_t kv_sh, int64_t o_sb, int64_t o_sh, float scale) {
  const dim3 block(kWarps * 32);
#define FRL_DECODE_CASE(E_)                                                   \
  case E_:                                                                    \
    decode_attention_kernel<T, E_><<<grid, block, 0, st>>>(                   \
        static_cast<const T*>(q), static_cast<const T*>(k),                   \
        static_cast<const T*>(v), static_cast<const int32_t*>(kv_len),        \
        static_cast<T*>(out), H, S, q_sb, q_sh, kv_sb, kv_ss, kv_sh, o_sb,    \
        o_sh, scale);                                                         \
    break;
  switch (e) {
    FRL_DECODE_CASE(1)
    FRL_DECODE_CASE(2)
    FRL_DECODE_CASE(3)
    FRL_DECODE_CASE(4)
    FRL_DECODE_CASE(5)
    FRL_DECODE_CASE(6)
    FRL_DECODE_CASE(7)
    FRL_DECODE_CASE(8)
  }
#undef FRL_DECODE_CASE
}

}  // namespace

// q [B, H, D], k/v [B, S, H, D], out [B, H, D], each with unit stride
// along D and the strides given in elements; kv_len [B] int32 >= 1.
// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t as int.
extern "C" int frl_decode_attention(
    const void* q, const void* k, const void* v, const void* kv_len,
    void* out, int B, int H, int S, int D, int dtype, long long q_sb,
    long long q_sh, long long kv_sb, long long kv_ss, long long kv_sh,
    long long o_sb, long long o_sh, float scale, void* stream) {
  if (B < 1 || H < 1 || S < 1 || D < 32 || D > 256 || D % 32 != 0 ||
      (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(B * H);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(D / 32, grid, st, q, k, v, kv_len, out, H, S, q_sb, q_sh,
                  kv_sb, kv_ss, kv_sh, o_sb, o_sh, scale);
  } else {
    launch<__nv_bfloat16>(D / 32, grid, st, q, k, v, kv_len, out, H, S, q_sb,
                          q_sh, kv_sb, kv_ss, kv_sh, o_sb, o_sh, scale);
  }
  return static_cast<int>(cudaGetLastError());
}
