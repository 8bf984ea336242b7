// Fused RMSNorm for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel `rmsnorm_kernel` / `_kernel` in
// src/repro/kernels/rmsnorm/rmsnorm.py.  Per row: fp32 mean of squares,
// rsqrtf(var + eps), times the scale in fp32, cast back to the input type.
//
// Bound on an H100: memory.  Each element is read once and written once
// (2 bytes each way in bf16), about 0.5 flop per byte, far under the
// card's ~295 flop/byte balance point; at decode (a few rows) it is bound
// by the launch itself.  No row padding (the TPU wrapper pads rows to 256).
//
// Design (`rmsnorm_vec`): `tpr` threads per row (32, 64, 128 or 256: the
// fewest that keep a thread's share at 4 16-byte vectors or under, so up to
// 8 for the widest rows), 256 threads a block.  Each thread holds its share
// of the row in registers, VPL 16-byte vectors (a template parameter,
// 1..8), and issues all of its loads of x and of the scale (16-byte vectors
// too, not 2-byte scalars) before the reduction, so the row is read from
// memory once and every load is in flight together.  Rows of 512 vectors
// or more (bf16 d >= 4096) go two to a thread group (RPT = 2), so one load
// of the scale serves two rows.  The sum of squares is reduced over the
// warp with shuffles and, for tpr > 32, across the row's warps through
// shared memory; then each thread scales the vectors it holds and stores
// them.  A row that is not 16-byte aligned, or wider than 256 x 8 vectors
// (16384 bf16, 8192 fp32), takes `rmsnorm_scalar`: one warp a row, scalar
// loads, the row read twice.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxVpl = 8;     // vectors a thread can hold
constexpr int kTargetVpl = 4;  // widen tpr until a thread holds at most this many
constexpr int kPairFrom = 512;  // rows of this many vectors or more: 2 rows a thread group

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as a dtype cast
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// A vector of `BYTES` bytes: the scale elements that go with one 16-byte
// vector of x (8 bytes for bf16 scale with fp32 x, 32 for the reverse).
template <int BYTES> struct Vec;
template <> struct Vec<8> { uint2 v; };
template <> struct Vec<16> { uint4 v; };
template <> struct alignas(16) Vec<32> { uint4 v[2]; };

template <typename T, typename S, int VPL, int RPT>
__global__ void __launch_bounds__(kThreads)
rmsnorm_vec(const T* __restrict__ x, const S* __restrict__ scale,
            T* __restrict__ out, long long rows, int d, long long x_stride,
            float eps, int tpr) {
  constexpr int kV = 16 / sizeof(T);  // elements per 16-byte vector of x
  typedef Vec<kV * sizeof(S)> SV;
  __shared__ float red[RPT][kThreads / 32];
  const int nv = d / kV;
  const int sub = threadIdx.x / tpr, lane = threadIdx.x - sub * tpr;
  const long long row0 = ((long long)blockIdx.x * (kThreads / tpr) + sub) * RPT;
  const SV* sr = reinterpret_cast<const SV*>(scale);

  uint4 xv[RPT][VPL];
  SV sv[VPL];
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    const int i = lane + k * tpr;
    if (row0 < rows && i < nv) sv[k] = sr[i];
#pragma unroll
    for (int rr = 0; rr < RPT; ++rr) {
      const long long row = row0 + rr;
      xv[rr][k] = row < rows && i < nv
                      ? reinterpret_cast<const uint4*>(x + row * x_stride)[i]
                      : make_uint4(0u, 0u, 0u, 0u);
    }
  }
  float ss[RPT];
#pragma unroll
  for (int rr = 0; rr < RPT; ++rr) {
    ss[rr] = 0.f;
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      const T* e = reinterpret_cast<const T*>(&xv[rr][k]);
#pragma unroll
      for (int j = 0; j < kV; ++j) {
        const float f = to_f(e[j]);
        ss[rr] += f * f;
      }
    }
    ss[rr] = warp_sum(ss[rr]);
  }
  if (tpr > 32) {  // uniform over the block
    if ((threadIdx.x & 31) == 0)
#pragma unroll
      for (int rr = 0; rr < RPT; ++rr) red[rr][threadIdx.x >> 5] = ss[rr];
    __syncthreads();
    const int w0 = (sub * tpr) >> 5;
#pragma unroll
    for (int rr = 0; rr < RPT; ++rr) {
      ss[rr] = 0.f;
      for (int w = 0; w < (tpr >> 5); ++w) ss[rr] += red[rr][w0 + w];
    }
  }
#pragma unroll
  for (int rr = 0; rr < RPT; ++rr) {
    const long long row = row0 + rr;
    if (row >= rows) break;
    const float r = rsqrtf(ss[rr] / (float)d + eps);
    uint4* orow = reinterpret_cast<uint4*>(out + row * (long long)d);
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      const int i = lane + k * tpr;
      if (i < nv) {
        const T* e = reinterpret_cast<const T*>(&xv[rr][k]);
        const S* sc = reinterpret_cast<const S*>(&sv[k]);
        uint4 w;
        T* o = reinterpret_cast<T*>(&w);
#pragma unroll
        for (int j = 0; j < kV; ++j) o[j] = from_f<T>(to_f(e[j]) * r * to_f(sc[j]));
        orow[i] = w;
      }
    }
  }
}

constexpr int kScalarWarps = 8;

template <typename T, typename S>
__global__ void __launch_bounds__(32 * kScalarWarps)
rmsnorm_scalar(const T* __restrict__ x, const S* __restrict__ scale,
               T* __restrict__ out, long long rows, int d,
               long long x_stride, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kScalarWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + row * x_stride;
  T* orow = out + row * (long long)d;
  float ss = 0.f;
  for (int i = lane; i < d; i += 32) { float f = to_f(xr[i]); ss += f * f; }
  ss = warp_sum(ss);
  const float r = rsqrtf(ss / (float)d + eps);
  for (int i = lane; i < d; i += 32)
    orow[i] = from_f<T>(to_f(xr[i]) * r * to_f(scale[i]));
}

template <typename T, typename S, int VPL, int RPT>
void launch_vec(const void* x, const void* scale, void* out, long long rows,
                int d, long long x_stride, float eps, int tpr,
                cudaStream_t stream) {
  const long long per_block = (long long)(kThreads / tpr) * RPT;
  const dim3 grid((unsigned)((rows + per_block - 1) / per_block));
  rmsnorm_vec<T, S, VPL, RPT><<<grid, kThreads, 0, stream>>>(
      (const T*)x, (const S*)scale, (T*)out, rows, d, x_stride, eps, tpr);
}

template <typename T, typename S, int RPT>
void launch_vpl(int vpl, const void* x, const void* scale, void* out,
                long long rows, int d, long long x_stride, float eps, int tpr,
                cudaStream_t st) {
  switch (vpl) {
    case 1: launch_vec<T, S, 1, RPT>(x, scale, out, rows, d, x_stride, eps, tpr, st); break;
    case 2: launch_vec<T, S, 2, RPT>(x, scale, out, rows, d, x_stride, eps, tpr, st); break;
    case 3: launch_vec<T, S, 3, RPT>(x, scale, out, rows, d, x_stride, eps, tpr, st); break;
    case 4: launch_vec<T, S, 4, RPT>(x, scale, out, rows, d, x_stride, eps, tpr, st); break;
    case 5: launch_vec<T, S, 5, RPT>(x, scale, out, rows, d, x_stride, eps, tpr, st); break;
    case 6: launch_vec<T, S, 6, RPT>(x, scale, out, rows, d, x_stride, eps, tpr, st); break;
    case 7: launch_vec<T, S, 7, RPT>(x, scale, out, rows, d, x_stride, eps, tpr, st); break;
    default: launch_vec<T, S, 8, RPT>(x, scale, out, rows, d, x_stride, eps, tpr, st); break;
  }
}

template <typename T, typename S>
int launch(const void* x, const void* scale, void* out, long long rows, int d,
           long long x_stride, float eps, cudaStream_t stream) {
  constexpr int kV = 16 / sizeof(T);
  const int nv = d / kV;
  const bool vec = d % kV == 0 && x_stride % kV == 0 &&
                   nv <= kMaxVpl * kThreads &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(scale) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (!vec) {
    const dim3 grid((unsigned)((rows + kScalarWarps - 1) / kScalarWarps));
    rmsnorm_scalar<T, S><<<grid, 32 * kScalarWarps, 0, stream>>>(
        (const T*)x, (const S*)scale, (T*)out, rows, d, x_stride, eps);
    return (int)cudaGetLastError();
  }
  int tpr = 32;
  while (nv > kTargetVpl * tpr && tpr < kThreads) tpr *= 2;
  const int vpl = (nv + tpr - 1) / tpr;
  if (nv >= kPairFrom)
    launch_vpl<T, S, 2>(vpl, x, scale, out, rows, d, x_stride, eps, tpr, stream);
  else
    launch_vpl<T, S, 1>(vpl, x, scale, out, rows, d, x_stride, eps, tpr, stream);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16.  `out` is (rows, d) contiguous;
// row i of x starts at x + i * x_stride elements.
int rmsnorm_fwd(const void* x, const void* scale, void* out, long long rows,
                int d, long long x_stride, float eps, int x_dtype,
                int scale_dtype, void* stream) {
  if (rows == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (x_dtype == 0 && scale_dtype == 0)
    return launch<float, float>(x, scale, out, rows, d, x_stride, eps, s);
  if (x_dtype == 0 && scale_dtype == 1)
    return launch<float, __nv_bfloat16>(x, scale, out, rows, d, x_stride, eps, s);
  if (x_dtype == 1 && scale_dtype == 0)
    return launch<__nv_bfloat16, float>(x, scale, out, rows, d, x_stride, eps, s);
  if (x_dtype == 1 && scale_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, scale, out, rows, d, x_stride, eps, s);
  return (int)cudaErrorInvalidValue;
}

const char* error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
