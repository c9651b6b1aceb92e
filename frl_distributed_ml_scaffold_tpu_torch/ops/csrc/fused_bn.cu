// BatchNorm backward for Hopper (sm_90a): the two passes of the fused
// train-mode BatchNorm backward. Built with nvcc into a shared library
// with a plain C interface and loaded with ctypes (ops/_build.py,
// ops/fused_bn.py).
//
// Replaces the TPU kernels of frl_distributed_ml_scaffold_tpu/ops/
// fused_bn.py:
//   frl_bn_bwd_sums <- _sums_kernel (launched by _kernel_sums)
//   frl_bn_bwd_dx   <- _dx_kernel   (launched by _kernel_dx)
// over x and dy read in place as a row-major (M, C) matrix (channels
// last), fp32 or bf16, with fp32 per-channel mean and var:
// - sums: dbeta[c] = sum_r dy[r, c], dgamma[c] = sum_r dy[r, c] xhat[r, c],
//   xhat = (x - mean) rsqrt(var + eps) recomputed in registers (never in
//   device memory), accumulated in fp32;
// - dx: dx = gamma rsqrt(var + eps) (dy - dbeta / M - xhat dgamma / M),
//   written in x's dtype; gamma (scale) fp32 or bf16.
//
// The TPU's sums kernel carries its accumulators in VMEM across a grid
// axis that runs in order. Here blocks run in parallel and in no order, so
// the sums pass is a split and a combine:
// - a 2-D grid of (channel tiles) x (row splits); each thread keeps fp32
//   sums for its VEC channels over the rows of its split (stepping by the
//   block's row count), the block reduces its rows in shared memory in a
//   fixed order and writes one partial [split, 2, C] into a workspace;
// - a second kernel sums the partials of each channel over the splits in
//   order. Deterministic, no atomics. One call of the entry is one launch
//   to its wrapper, whatever it issues inside.
// The dx pass is elementwise over the same 2-D grid; each thread computes
// its channels' constants (1/sigma, gamma/sigma, dbeta/M, dgamma/M) once,
// in registers, so no launch prepares them.
//
// Bound: both passes stream their inputs once: sums reads x and dy (4
// bytes an element in bf16, 8 in fp32), dx reads x and dy and writes dx
// (6 / 12 bytes). At ResNet-50's shapes (M up to 3.2M rows) they are
// bound by device memory bytes, a few flops per byte.
//
// Design (right and simple first):
// - Threads of a block are (tx, ty): tx along channels, VEC consecutive
//   channels each, so neighbouring threads read neighbouring 16-byte
//   chunks of a row; ty along rows. tx = min(ceil(C / VEC), 32), and the
//   block's 256 threads give ty = 256 / tx rows per step: at C = 64 bf16,
//   8 threads cover a 128-byte row and a warp reads 4 whole rows.
// - VEC = 8 (bf16) or 4 (fp32): one 16-byte load or store when C is a
//   multiple of VEC and the pointers are 16-byte aligned; else VEC = 1.
// - Channels past C and rows past M are never read; there is no padding
//   (the TPU's 128-lane padding is TPU tiling and does not carry over).
// Left for later: TMA bulk loads, one launch for both passes of small
// layers, and reading x and dy once for both passes where the sums fit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(v);
}

// VEC consecutive elements of T, aligned to their size: one 16-byte load
// or store when VEC elements make 16 bytes.
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float (&out)[VEC]) {
  const Pack<T, VEC> pk = *reinterpret_cast<const Pack<T, VEC>*>(p);
#pragma unroll
  for (int i = 0; i < VEC; ++i) out[i] = to_f(pk.v[i]);
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[VEC]) {
  Pack<T, VEC> pk;
#pragma unroll
  for (int i = 0; i < VEC; ++i) from_f(v[i], &pk.v[i]);
  *reinterpret_cast<Pack<T, VEC>*>(p) = pk;
}

// Partial sums of one row split: part[split][0][c] = sum dy,
// part[split][1][c] = sum dy * xhat. Dynamic shared memory: ty * 2 * tile
// floats.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    sums_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                const float* __restrict__ mean, const float* __restrict__ var,
                float eps, long long m, int c, long long rows_per_split,
                float* __restrict__ part) {
  extern __shared__ float sm[];
  const int tile = blockDim.x * VEC;
  const int c0 = blockIdx.x * tile + threadIdx.x * VEC;
  const long long r0 = (long long)blockIdx.y * rows_per_split;
  const long long r1 = min(m, r0 + rows_per_split);
  float sb[VEC], sg[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) sb[i] = sg[i] = 0.f;
  if (c0 < c) {
    float mu[VEC], inv[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      mu[i] = mean[c0 + i];
      inv[i] = rsqrtf(var[c0 + i] + eps);
    }
    for (long long r = r0 + threadIdx.y; r < r1; r += blockDim.y) {
      float xv[VEC], dv[VEC];
      load_vec<T, VEC>(x + r * c + c0, xv);
      load_vec<T, VEC>(dy + r * c + c0, dv);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float xhat = (xv[i] - mu[i]) * inv[i];
        sb[i] += dv[i];
        sg[i] += dv[i] * xhat;
      }
    }
  }
  const int col = threadIdx.x * VEC;
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    sm[(threadIdx.y * 2 + 0) * tile + col + i] = sb[i];
    sm[(threadIdx.y * 2 + 1) * tile + col + i] = sg[i];
  }
  __syncthreads();
  const int nthreads = blockDim.x * blockDim.y;
  for (int j = threadIdx.y * blockDim.x + threadIdx.x; j < 2 * tile;
       j += nthreads) {
    const int which = j / tile, ch = j % tile;
    const int cc = blockIdx.x * tile + ch;
    if (cc >= c) continue;
    float s = 0.f;
    for (int y = 0; y < (int)blockDim.y; ++y) s += sm[(y * 2 + which) * tile + ch];
    part[((long long)blockIdx.y * 2 + which) * c + cc] = s;
  }
}

// dbeta[c], dgamma[c]: the partials of channel c summed over the splits
// in order.
__global__ void combine_kernel(const float* __restrict__ part, int splits,
                               int c, float* __restrict__ dbeta,
                               float* __restrict__ dgamma) {
  const int ch = blockIdx.x * blockDim.x + threadIdx.x;
  if (ch >= c) return;
  float b = 0.f, g = 0.f;
  for (int s = 0; s < splits; ++s) {
    b += part[((long long)s * 2 + 0) * c + ch];
    g += part[((long long)s * 2 + 1) * c + ch];
  }
  dbeta[ch] = b;
  dgamma[ch] = g;
}

template <typename T, typename S, int VEC>
__global__ void __launch_bounds__(kThreads)
    dx_kernel(const T* __restrict__ x, const T* __restrict__ dy,
              const S* __restrict__ scale, const float* __restrict__ mean,
              const float* __restrict__ var, const float* __restrict__ dbeta,
              const float* __restrict__ dgamma, float eps, float inv_m,
              long long m, int c, long long rows_per_split,
              T* __restrict__ dx) {
  const int c0 = blockIdx.x * blockDim.x * VEC + threadIdx.x * VEC;
  if (c0 >= c) return;
  const long long r0 = (long long)blockIdx.y * rows_per_split;
  const long long r1 = min(m, r0 + rows_per_split);
  float mu[VEC], inv[VEC], gi[VEC], k1[VEC], k2[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    mu[i] = mean[c0 + i];
    inv[i] = rsqrtf(var[c0 + i] + eps);
    gi[i] = to_f(scale[c0 + i]) * inv[i];
    k1[i] = dbeta[c0 + i] * inv_m;
    k2[i] = dgamma[c0 + i] * inv_m;
  }
  for (long long r = r0 + threadIdx.y; r < r1; r += blockDim.y) {
    float xv[VEC], dv[VEC], out[VEC];
    load_vec<T, VEC>(x + r * c + c0, xv);
    load_vec<T, VEC>(dy + r * c + c0, dv);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float xhat = (xv[i] - mu[i]) * inv[i];
      out[i] = gi[i] * (dv[i] - k1[i] - xhat * k2[i]);
    }
    store_vec<T, VEC>(dx + r * c + c0, out);
  }
}

struct Geometry {
  dim3 block;
  int tiles;
};

// (tx, ty) threads and the number of channel tiles for VEC channels per
// thread.
Geometry geometry(int c, int vec) {
  const int per_row = (c + vec - 1) / vec;
  const int tx = per_row < 32 ? per_row : 32;
  const int ty = kThreads / tx;
  const int tile = tx * vec;
  return {dim3(tx, ty), (c + tile - 1) / tile};
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T, int VEC>
void launch_sums(const void* x, const void* dy, const float* mean,
                 const float* var, float eps, long long m, int c, int splits,
                 float* part, cudaStream_t stream) {
  const Geometry g = geometry(c, VEC);
  const long long rows = (m + splits - 1) / splits;
  const size_t smem = (size_t)g.block.y * 2 * g.block.x * VEC * sizeof(float);
  sums_kernel<T, VEC><<<dim3(g.tiles, splits), g.block, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), mean, var, eps, m,
      c, rows, part);
}

template <typename T, typename S, int VEC>
void launch_dx(const void* x, const void* dy, const void* scale,
               const float* mean, const float* var, const float* dbeta,
               const float* dgamma, float eps, float inv_m, long long m,
               int c, void* dx, cudaStream_t stream) {
  const Geometry g = geometry(c, VEC);
  // About 2048 blocks in all, each at least 8 steps of ty rows.
  const long long step = 8LL * g.block.y;
  long long splits = (m + step - 1) / step;
  const long long cap = (2048 + g.tiles - 1) / g.tiles;
  if (splits > cap) splits = cap;
  if (splits < 1) splits = 1;
  const long long rows = (m + splits - 1) / splits;
  splits = (m + rows - 1) / rows;
  dx_kernel<T, S, VEC><<<dim3(g.tiles, (unsigned)splits), g.block, 0,
                         stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy),
      static_cast<const S*>(scale), mean, var, dbeta, dgamma, eps, inv_m, m,
      c, rows, static_cast<T*>(dx));
}

template <typename T>
void sums_for(const void* x, const void* dy, const float* mean,
              const float* var, float eps, long long m, int c, int splits,
              float* part, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (c % kVec == 0 && aligned16(x) && aligned16(dy)) {
    launch_sums<T, kVec>(x, dy, mean, var, eps, m, c, splits, part, stream);
  } else {
    launch_sums<T, 1>(x, dy, mean, var, eps, m, c, splits, part, stream);
  }
}

template <typename T, typename S>
void dx_for(const void* x, const void* dy, const void* scale,
            const float* mean, const float* var, const float* dbeta,
            const float* dgamma, float eps, float inv_m, long long m, int c,
            void* dx, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (c % kVec == 0 && aligned16(x) && aligned16(dy) && aligned16(dx)) {
    launch_dx<T, S, kVec>(x, dy, scale, mean, var, dbeta, dgamma, eps, inv_m,
                          m, c, dx, stream);
  } else {
    launch_dx<T, S, 1>(x, dy, scale, mean, var, dbeta, dgamma, eps, inv_m, m,
                       c, dx, stream);
  }
}

template <typename T>
void dx_scale(const void* x, const void* dy, const void* scale,
              int scale_dtype, const float* mean, const float* var,
              const float* dbeta, const float* dgamma, float eps, float inv_m,
              long long m, int c, void* dx, cudaStream_t stream) {
  if (scale_dtype == 1) {
    dx_for<T, __nv_bfloat16>(x, dy, scale, mean, var, dbeta, dgamma, eps,
                             inv_m, m, c, dx, stream);
  } else {
    dx_for<T, float>(x, dy, scale, mean, var, dbeta, dgamma, eps, inv_m, m,
                     c, dx, stream);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and dy). workspace: splits * 2 * c
// floats. Returns cudaGetLastError() after the launches.
extern "C" int frl_bn_bwd_sums(const void* x, const void* dy,
                               const float* mean, const float* var, float eps,
                               long long m, int c, int dtype, int splits,
                               float* workspace, float* dbeta, float* dgamma,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    sums_for<__nv_bfloat16>(x, dy, mean, var, eps, m, c, splits, workspace,
                            s);
  } else {
    sums_for<float>(x, dy, mean, var, eps, m, c, splits, workspace, s);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  combine_kernel<<<(c + 255) / 256, 256, 0, s>>>(workspace, splits, c, dbeta,
                                                 dgamma);
  return (int)cudaGetLastError();
}

// dtype as above for x, dy and dx; scale_dtype likewise for scale.
// inv_m = 1 / M of the statistics.
extern "C" int frl_bn_bwd_dx(const void* x, const void* dy, const void* scale,
                             int scale_dtype, const float* mean,
                             const float* var, const float* dbeta,
                             const float* dgamma, float eps, float inv_m,
                             long long m, int c, int dtype, void* dx,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    dx_scale<__nv_bfloat16>(x, dy, scale, scale_dtype, mean, var, dbeta,
                            dgamma, eps, inv_m, m, c, dx, s);
  } else {
    dx_scale<float>(x, dy, scale, scale_dtype, mean, var, dbeta, dgamma, eps,
                    inv_m, m, c, dx, s);
  }
  return (int)cudaGetLastError();
}
