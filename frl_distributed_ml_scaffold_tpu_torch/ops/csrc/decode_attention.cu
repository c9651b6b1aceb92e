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
// compute-bound. At the serving path's shapes (8 slots x 16 heads, a few
// MB a layer) a launch lasts a few microseconds, so what bounds it is how
// many bytes are in flight at once: the CTAs, the loads per lane and the
// size of each load.
//
// Design, a split-KV kernel:
// - Split over positions. The grid is (B * H, splits): CTA (bh, sp) reads
//   n = min(kv_len[b], S) (at least 1) on the device and takes positions
//   [sp * chunk, (sp + 1) * chunk) of them, chunk = ceil(n / splits)
//   rounded up to the positions one pass of the CTA's groups covers. The
//   host picks splits from B * H, S and the SM count, up to 8
//   (ops/decode_attention.py `decode_splits`): about one CTA per SM, so a
//   few slots still reach every SM, and one split from B * H >= SMs (the
//   serving path's 8 slots x 16 heads). A CTA whose chunk is empty
//   contributes the neutral partial (m = -1e30, l = 0, acc = 0).
// - 16-byte loads. A position's D-vector is D * elem / 16 chunks of 16
//   bytes (8 bf16 or 4 fp32), read by a group of L lanes (L the power of
//   two at or above the chunk count, at most 32; above 32 chunks a lane
//   takes two). A warp reads 32 / L positions per load (4 at D = 64
//   bf16), and every lane issues its K and V loads for 4 / (chunks a
//   lane) positions before it uses any. The score reduces over the
//   group's L lanes with shuffles. Each group keeps its own running
//   (m, l, acc) in fp32.
// - Many warps, few loads each: 16 warps a CTA. On the H100 at the
//   path's shapes, CTAs of 4 warps with 8 loads in flight per lane were
//   slower at every split count than 16 warps with 4: past a few loads a
//   lane, the time goes to each pass's dependent shuffles and exps, which
//   only more warps hide (PERF.md has the measurements).
// - The cache is read in its [B, S, H, D] layout through strides, so the
//   caller never transposes (a transpose would copy the whole cache every
//   step); the wrapper requires 16-byte aligned K and V with strides in
//   multiples of 16 bytes. q is read with plain loads, so the model's
//   strided views of it need no copy.
// - Positions >= n are never read, so they contribute exactly zero
//   whatever the cache holds there. Rows whose kv_len runs past S
//   (retired serving slots keep decoding past their bucket) read the whole
//   cache and no further.
// - The merge. The groups of a warp merge with shuffles and the warps of
//   a CTA through shared memory, both with the log-sum-exp rescale; the
//   splits of one (b, h) form a thread-block cluster (1 x splits), and
//   after a cluster barrier rank 0 reads every CTA's (m, l, acc) through
//   distributed shared memory and merges them in split order. Chosen over
//   a second launch into an fp32 scratch: one launch and no allocation on
//   a path whose step is host-bound, and the partials never touch device
//   memory. Every merge runs in a fixed order with no atomics, so the
//   output is deterministic.
//
// Left for later PRs: TMA or a cp.async ring in place of the register
// loads, and one CTA over several heads of a row.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr float kNegInf = -1.0e30f;
constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxSplits = 8;  // the portable cluster size
constexpr int kLoads = 4;      // 16-byte loads of K (and of V) per lane a pass

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

// The 16 bytes of one load as fp32.
__device__ __forceinline__ void widen(const uint4& u, float (&x)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(&u);
  x[0] = f.x;
  x[1] = f.y;
  x[2] = f.z;
  x[3] = f.w;
}
__device__ __forceinline__ void widen(const uint4& u, float (&x)[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(p[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

constexpr int pow2_at_least(int x) {
  return x <= 4 ? 4 : x <= 8 ? 8 : x <= 16 ? 16 : 32;
}

// How a CTA covers positions, for dtype T and head dim D.
template <typename T, int D>
struct Geom {
  static constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  static constexpr int kChunks = D / kVec;  // 16-byte chunks a position
  static constexpr int kLanes = pow2_at_least(kChunks);  // lanes a position
  static constexpr int kPer = (kChunks + kLanes - 1) / kLanes;  // a lane's
  static constexpr int kGroups = 32 / kLanes;  // positions a warp per load
  static constexpr int kUnroll = kLoads / kPer;  // positions a lane a pass
  static constexpr int kWorkers = kWarps * kGroups;  // groups in a CTA
  static constexpr int kStep = kWorkers * kUnroll;   // positions a pass
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int32_t* __restrict__ kv_len,
                        T* __restrict__ out, int H, int S, int64_t q_sb,
                        int64_t q_sh, int64_t kv_sb, int64_t kv_ss,
                        int64_t kv_sh, int64_t o_sb, int64_t o_sh,
                        float scale) {
  using G = Geom<T, D>;
  constexpr int V = G::kVec;
  __shared__ float sm_m[kWarps];
  __shared__ float sm_l[kWarps];
  __shared__ float sm_acc[kWarps][D];
  // This CTA's merged partial: acc[D], then m and l (read by rank 0).
  __shared__ float part[D + 2];

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int splits = gridDim.y;
  const int sp = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int sub = lane % G::kLanes;  // this lane's place in its group
  const int worker = warp * G::kGroups + lane / G::kLanes;

  const int n = max(1, min(kv_len[b], S));  // the router's clamp, here
  const int per = (n + splits - 1) / splits;
  const int chunk = (per + G::kWorkers - 1) / G::kWorkers * G::kWorkers;
  const int begin = sp * chunk;
  const int end = min(n, begin + chunk);

  // The lane's chunks c = sub + i L of q, and of each K and V row.
  const T* qp = q + b * q_sb + h * q_sh;
  float qr[G::kPer][V];
  float acc[G::kPer][V];
#pragma unroll
  for (int i = 0; i < G::kPer; ++i) {
    const int c = sub + i * G::kLanes;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      qr[i][e] = c < G::kChunks ? to_float(qp[c * V + e]) : 0.f;
      acc[i][e] = 0.f;
    }
  }
  const T* kb = k + b * kv_sb + h * kv_sh;
  const T* vb = v + b * kv_sb + h * kv_sh;
  float m = kNegInf;
  float l = 0.f;

  for (int p0 = begin; p0 < end; p0 += G::kStep) {
    uint4 kr[G::kUnroll][G::kPer];
    uint4 vr[G::kUnroll][G::kPer];
#pragma unroll
    for (int u = 0; u < G::kUnroll; ++u) {
      const int pos = p0 + u * G::kWorkers + worker;
      const int64_t off = static_cast<int64_t>(pos) * kv_ss;
#pragma unroll
      for (int i = 0; i < G::kPer; ++i) {
        const int c = sub + i * G::kLanes;
        const bool ok = pos < end && c < G::kChunks;
        kr[u][i] = ok ? *reinterpret_cast<const uint4*>(kb + off + c * V)
                      : make_uint4(0u, 0u, 0u, 0u);
        vr[u][i] = ok ? *reinterpret_cast<const uint4*>(vb + off + c * V)
                      : make_uint4(0u, 0u, 0u, 0u);
      }
    }
    float s[G::kUnroll];
#pragma unroll
    for (int u = 0; u < G::kUnroll; ++u) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < G::kPer; ++i) {
        float x[V];
        widen(kr[u][i], x);
#pragma unroll
        for (int e = 0; e < V; ++e) dot = fmaf(qr[i][e], x[e], dot);
      }
      s[u] = dot;
    }
#pragma unroll
    for (int o = G::kLanes / 2; o > 0; o >>= 1) {
#pragma unroll
      for (int u = 0; u < G::kUnroll; ++u) {
        s[u] += __shfl_xor_sync(0xffffffffu, s[u], o);
      }
    }
    float m_new = m;
#pragma unroll
    for (int u = 0; u < G::kUnroll; ++u) {
      const bool live = p0 + u * G::kWorkers + worker < end;
      s[u] = live ? s[u] * scale : kNegInf;
      m_new = fmaxf(m_new, s[u]);
    }
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int i = 0; i < G::kPer; ++i) {
#pragma unroll
      for (int e = 0; e < V; ++e) acc[i][e] *= alpha;
    }
#pragma unroll
    for (int u = 0; u < G::kUnroll; ++u) {
      const bool live = p0 + u * G::kWorkers + worker < end;
      const float p = live ? expf(s[u] - m_new) : 0.f;
      l += p;
      const float pv = round_to<T>(p);
#pragma unroll
      for (int i = 0; i < G::kPer; ++i) {
        float x[V];
        widen(vr[u][i], x);
#pragma unroll
        for (int e = 0; e < V; ++e) acc[i][e] = fmaf(pv, x[e], acc[i][e]);
      }
    }
    m = m_new;
  }

  // Merge the warp's groups with shuffles (group 0's lanes end with the
  // warp's partial), then the CTA's warps through shared memory, in warp
  // order.
#pragma unroll
  for (int o = G::kLanes; o < 32; o <<= 1) {
    const float mo = __shfl_xor_sync(0xffffffffu, m, o);
    const float lo = __shfl_xor_sync(0xffffffffu, l, o);
    const float mn = fmaxf(m, mo);
    const float a = expf(m - mn);
    const float c = expf(mo - mn);
    l = l * a + lo * c;
#pragma unroll
    for (int i = 0; i < G::kPer; ++i) {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float other = __shfl_xor_sync(0xffffffffu, acc[i][e], o);
        acc[i][e] = acc[i][e] * a + other * c;
      }
    }
    m = mn;
  }
  if (lane < G::kLanes) {
    if (lane == 0) {
      sm_m[warp] = m;
      sm_l[warp] = l;
    }
#pragma unroll
    for (int i = 0; i < G::kPer; ++i) {
      const int c = sub + i * G::kLanes;
      if (c < G::kChunks) {
#pragma unroll
        for (int e = 0; e < V; ++e) sm_acc[warp][c * V + e] = acc[i][e];
      }
    }
  }
  __syncthreads();
  float mx = kNegInf;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w]);
  float wscale[kWarps];
  float den = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    wscale[w] = expf(sm_m[w] - mx);
    den = fmaf(sm_l[w], wscale[w], den);
  }
  T* ob = out + b * o_sb + h * o_sh;
  if (splits == 1) {
    for (int d = threadIdx.x; d < D; d += kThreads) {
      float num = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) num = fmaf(sm_acc[w][d], wscale[w], num);
      ob[d] = from_float<T>(num / fmaxf(den, 1e-30f));
    }
    return;
  }
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float num = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) num = fmaf(sm_acc[w][d], wscale[w], num);
    part[d] = num;
  }
  if (threadIdx.x == 0) {
    part[D] = mx;
    part[D + 1] = den;
  }

  // Merge the cluster's splits, in split order, on rank 0.
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every CTA's partial is written
  if (cluster.block_rank() == 0) {
    // Unrolled to kMaxSplits with guards, so rp and cm stay in registers.
    const float* rp[kMaxSplits];
    float cm[kMaxSplits];
    float gm = kNegInf;
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r) {
      if (r < splits) {
        rp[r] = cluster.map_shared_rank(part, r);
        cm[r] = rp[r][D];
        gm = fmaxf(gm, cm[r]);
      }
    }
    float gden = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r) {
      if (r < splits) {
        cm[r] = expf(cm[r] - gm);
        gden = fmaf(rp[r][D + 1], cm[r], gden);
      }
    }
    for (int d = threadIdx.x; d < D; d += kThreads) {
      float num = 0.f;
#pragma unroll
      for (int r = 0; r < kMaxSplits; ++r) {
        if (r < splits) num = fmaf(rp[r][d], cm[r], num);
      }
      ob[d] = from_float<T>(num / fmaxf(gden, 1e-30f));
    }
  }
  cluster.sync();  // rank 0 is done reading before any CTA exits
}

template <typename T, int D>
cudaError_t launch(int B, int H, int splits, cudaStream_t st, const void* q,
                   const void* k, const void* v, const void* kv_len,
                   void* out, int S, int64_t q_sb, int64_t q_sh,
                   int64_t kv_sb, int64_t kv_ss, int64_t kv_sh, int64_t o_sb,
                   int64_t o_sh, float scale) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * H, splits);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  return cudaLaunchKernelEx(
      &cfg, decode_attention_kernel<T, D>, static_cast<const T*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int32_t*>(kv_len), static_cast<T*>(out), H, S, q_sb,
      q_sh, kv_sb, kv_ss, kv_sh, o_sb, o_sh, scale);
}

template <typename T>
cudaError_t launch_dim(int D, int B, int H, int splits, cudaStream_t st,
                       const void* q, const void* k, const void* v,
                       const void* kv_len, void* out, int S, int64_t q_sb,
                       int64_t q_sh, int64_t kv_sb, int64_t kv_ss,
                       int64_t kv_sh, int64_t o_sb, int64_t o_sh,
                       float scale) {
#define FRL_DECODE_CASE(D_)                                                   \
  case D_:                                                                    \
    return launch<T, D_>(B, H, splits, st, q, k, v, kv_len, out, S, q_sb,     \
                         q_sh, kv_sb, kv_ss, kv_sh, o_sb, o_sh, scale);
  switch (D) {
    FRL_DECODE_CASE(32)
    FRL_DECODE_CASE(64)
    FRL_DECODE_CASE(96)
    FRL_DECODE_CASE(128)
    FRL_DECODE_CASE(160)
    FRL_DECODE_CASE(192)
    FRL_DECODE_CASE(224)
    FRL_DECODE_CASE(256)
  }
#undef FRL_DECODE_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// q [B, H, D], k/v [B, S, H, D], out [B, H, D], each with unit stride
// along D and the strides given in elements; kv_len [B] int32, each row
// clamped to [1, S] here (the router launches no clamp of its own). k and
// v are read 16 bytes at a time: 16-byte aligned, every stride a multiple
// of 16 bytes (the wrapper checks). splits in 1..8: CTAs per (b, h), one
// cluster. dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t as
// int: the launch's own error, checked right after it.
extern "C" int frl_decode_attention(
    const void* q, const void* k, const void* v, const void* kv_len,
    void* out, int B, int H, int S, int D, int dtype, int splits,
    long long q_sb, long long q_sh, long long kv_sb, long long kv_ss,
    long long kv_sh, long long o_sb, long long o_sh, float scale,
    void* stream) {
  if (B < 1 || H < 1 || S < 1 || D < 32 || D > 256 || D % 32 != 0 ||
      static_cast<long long>(B) * H > 0x7fffffffLL || splits < 1 ||
      splits > kMaxSplits || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == 0
          ? launch_dim<float>(D, B, H, splits, st, q, k, v, kv_len, out, S,
                              q_sb, q_sh, kv_sb, kv_ss, kv_sh, o_sb, o_sh,
                              scale)
          : launch_dim<__nv_bfloat16>(D, B, H, splits, st, q, k, v, kv_len,
                                      out, S, q_sb, q_sh, kv_sb, kv_ss,
                                      kv_sh, o_sb, o_sh, scale);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
