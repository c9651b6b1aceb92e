// One-pass AdamW update of one parameter leaf, for Hopper (sm_90a). Built
// with nvcc into a shared library with a plain C interface and loaded with
// ctypes (ops/_build.py, ops/fused_adamw.py).
//
// Replaces the TPU kernel of frl_distributed_ml_scaffold_tpu/ops/
// fused_adamw.py:
//   frl_fused_adamw <- _kernel (launched by _update_leaf)
// and computes _adamw_math over flat fp32 m, v, an fp32 or bf16 p and an
// fp32 or bf16 g, in place:
//   m' = b1 m + (1 - b1) g
//   v' = b2 v + (1 - b2) g g
//   p' = p - lr ((m' / bc1) / (sqrt(v' / bc2) + eps) + wd p)
// lr, bc1 = 1 - b1^t and bc2 = 1 - b2^t come from the host (the step
// count is a host integer), so nothing is read back from the card.
// Every operation is an IEEE-rounded intrinsic (__fmul_rn, __fadd_rn,
// __fdiv_rn, __fsqrt_rn: never contracted into an FMA, never approximated),
// in the plain version's order, so the kernel rounds where it does.
//
// A bf16 g (the train step's cast under precision.policy=bf16) is read
// in place, four values to an 8-byte load, and widened to fp32 in
// registers, as the JAX _update_leaf upcasts it; the update itself is
// the same.
//
// A bf16 p (trainer.init_params_path under precision.policy=bf16) is read
// the same way and widened in registers; m and v stay fp32 and p' is
// rounded to bf16 to nearest even (__float2bfloat16_rn) as it is stored.
// This is the JAX package's plain path (_adamw_math on p as fp32, p'
// cast back to the param dtype, m' and v' kept fp32), which every backend
// but the TPU runs; its TPU kernel path casts m' and v' to the param
// dtype too. The plain path keeps the state's dtypes fixed from step to
// step, and it is what the CPU reference computes.
//
// Bound: 4 reads and 3 writes of 4 bytes an element (28 bytes; 26 with a
// bf16 g, 22 with a bf16 p and g) against ~15 flops: device memory bytes.
// The TPU kernel pads each leaf to 512 x 128 tiles; here a grid-stride
// loop reads m, v (and an fp32 p or g) as float4 (16-byte loads, each
// pointer 16-byte aligned) and a bf16 p or g as four bf16 (8-byte
// aligned), all checked by the wrapper, and finishes the last n % 4
// elements one by one. No padding, no copy. Left for later: one launch
// over every leaf (a multi-tensor list).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct Hyper {
  float lr, bc1, bc2, b1, omb1, b2, omb2, eps, wd;
};

__device__ __forceinline__ void adamw(float& p, float g, float& m, float& v,
                                      const Hyper& h) {
  m = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.omb1, g));
  v = __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(h.omb2, __fmul_rn(g, g)));
  const float mhat = __fdiv_rn(m, h.bc1);
  const float vhat = __fdiv_rn(v, h.bc2);
  const float u = __fadd_rn(__fdiv_rn(mhat, __fadd_rn(__fsqrt_rn(vhat), h.eps)),
                            __fmul_rn(h.wd, p));
  p = __fsub_rn(p, __fmul_rn(h.lr, u));
}

// Four consecutive values from element 4 i, and one, as fp32.
__device__ __forceinline__ float4 load4(const float* x, long long i) {
  return reinterpret_cast<const float4*>(x)[i];
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* x,
                                        long long i) {
  const uint2 raw = reinterpret_cast<const uint2*>(x)[i];
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ __forceinline__ float load1(const float* x, long long i) {
  return x[i];
}
__device__ __forceinline__ float load1(const __nv_bfloat16* x, long long i) {
  return __bfloat162float(x[i]);
}

// Four fp32 values stored from element 4 i, and one: as they are, or
// rounded to bf16 to nearest even.
__device__ __forceinline__ void store4(float* x, long long i, float4 val) {
  reinterpret_cast<float4*>(x)[i] = val;
}
__device__ __forceinline__ void store4(__nv_bfloat16* x, long long i,
                                       float4 val) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(val.x, val.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(val.z, val.w);
  uint2 raw;
  raw.x = *reinterpret_cast<const unsigned int*>(&lo);
  raw.y = *reinterpret_cast<const unsigned int*>(&hi);
  reinterpret_cast<uint2*>(x)[i] = raw;
}
__device__ __forceinline__ void store1(float* x, long long i, float val) {
  x[i] = val;
}
__device__ __forceinline__ void store1(__nv_bfloat16* x, long long i,
                                       float val) {
  x[i] = __float2bfloat16_rn(val);
}

template <typename P, typename G>
__global__ void __launch_bounds__(kThreads)
    adamw_kernel(P* __restrict__ p, const G* __restrict__ g,
                 float* __restrict__ m, float* __restrict__ v, long long n,
                 Hyper h) {
  const long long n4 = n / 4;
  const long long stride = (long long)gridDim.x * blockDim.x;
  float4* m4 = reinterpret_cast<float4*>(m);
  float4* v4 = reinterpret_cast<float4*>(v);
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += stride) {
    float4 pp = load4(p, i), mm = m4[i], vv = v4[i];
    const float4 gg = load4(g, i);
    adamw(pp.x, gg.x, mm.x, vv.x, h);
    adamw(pp.y, gg.y, mm.y, vv.y, h);
    adamw(pp.z, gg.z, mm.z, vv.z, h);
    adamw(pp.w, gg.w, mm.w, vv.w, h);
    store4(p, i, pp);
    m4[i] = mm;
    v4[i] = vv;
  }
  // The last n % 4 elements, one thread each.
  const long long t = n4 * 4 + (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t < n) {
    float pp = load1(p, t), mm = m[t], vv = v[t];
    adamw(pp, load1(g, t), mm, vv, h);
    store1(p, t, pp);
    m[t] = mm;
    v[t] = vv;
  }
}

template <typename P>
void launch(P* p, const void* g, int g_bf16, float* m, float* v, long long n,
            const Hyper& h, unsigned blocks, cudaStream_t st) {
  if (g_bf16) {
    adamw_kernel<<<blocks, kThreads, 0, st>>>(
        p, static_cast<const __nv_bfloat16*>(g), m, v, n, h);
  } else {
    adamw_kernel<<<blocks, kThreads, 0, st>>>(
        p, static_cast<const float*>(g), m, v, n, h);
  }
}

}  // namespace

// m, v: n fp32 each, 16-byte aligned, updated in place; p: n fp32 (p_bf16
// = 0, 16-byte aligned) or n bf16 (p_bf16 = 1, 8-byte aligned), updated in
// place; g: n fp32 (g_bf16 = 0, 16-byte aligned) or n bf16 (g_bf16 = 1,
// 8-byte aligned). one_minus_b1 / one_minus_b2 are the host's (1 - b)
// rounded to fp32, as the plain version multiplies by them. Returns
// cudaGetLastError().
extern "C" int frl_fused_adamw(void* p, int p_bf16, const void* g, int g_bf16,
                               float* m, float* v, long long n, float lr,
                               float bc1, float bc2, float b1,
                               float one_minus_b1, float b2,
                               float one_minus_b2, float eps, float wd,
                               void* stream) {
  const Hyper h{lr, bc1, bc2, b1, one_minus_b1, b2, one_minus_b2, eps, wd};
  // About 8 blocks per SM on 132 SMs; the grid-stride loop covers the rest.
  long long blocks = (n / 4 + kThreads - 1) / kThreads;
  if (blocks > 1056) blocks = 1056;
  if (blocks < 1) blocks = 1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p_bf16) {
    launch(static_cast<__nv_bfloat16*>(p), g, g_bf16, m, v, n, h,
           (unsigned)blocks, st);
  } else {
    launch(static_cast<float*>(p), g, g_bf16, m, v, n, h, (unsigned)blocks,
           st);
  }
  return (int)cudaGetLastError();
}
