// Fused RMSNorm for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel `rmsnorm_kernel` / `_kernel` in
// src/repro/kernels/rmsnorm/rmsnorm.py.  Per row: fp32 mean of squares,
// rsqrtf(var + eps), times the scale in fp32, cast back to the input type.
//
// Bound on an H100: memory.  Each element is read once and written once
// (2 bytes each way in bf16), about 0.5 flop per byte, far under the
// card's ~295 flop/byte balance point; at decode (a few rows) it is bound
// by the launch itself.  Design: one warp per row, 8 rows per block, no
// row padding (the TPU wrapper pads rows to 256).  Loads are 16 bytes a
// lane where d and the pointers allow it, with a scalar path otherwise;
// the row is read twice (sum of squares, then normalise), the second
// read coming from L1/L2.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

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

template <typename T, typename S, bool kVec>
__global__ void rmsnorm_kernel(const T* __restrict__ x, const S* __restrict__ scale,
                               T* __restrict__ out, long long rows, int d,
                               long long x_stride, float eps) {
  constexpr int kV = 16 / sizeof(T);  // elements per 16-byte vector
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + row * x_stride;
  T* orow = out + row * (long long)d;

  float ss = 0.f;
  if (kVec) {
    const int nv = d / kV;
    for (int i = lane; i < nv; i += 32) {
      uint4 u = reinterpret_cast<const uint4*>(xr)[i];
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int j = 0; j < kV; ++j) { float f = to_f(e[j]); ss += f * f; }
    }
  } else {
    for (int i = lane; i < d; i += 32) { float f = to_f(xr[i]); ss += f * f; }
  }
  ss = warp_sum(ss);
  const float r = rsqrtf(ss / (float)d + eps);

  if (kVec) {
    const int nv = d / kV;
    for (int i = lane; i < nv; i += 32) {
      uint4 u = reinterpret_cast<const uint4*>(xr)[i];
      const T* e = reinterpret_cast<const T*>(&u);
      uint4 w;
      T* o = reinterpret_cast<T*>(&w);
#pragma unroll
      for (int j = 0; j < kV; ++j)
        o[j] = from_f<T>(to_f(e[j]) * r * to_f(scale[i * kV + j]));
      reinterpret_cast<uint4*>(orow)[i] = w;
    }
  } else {
    for (int i = lane; i < d; i += 32)
      orow[i] = from_f<T>(to_f(xr[i]) * r * to_f(scale[i]));
  }
}

template <typename T, typename S>
int launch(const void* x, const void* scale, void* out, long long rows, int d,
           long long x_stride, float eps, cudaStream_t stream) {
  constexpr int kV = 16 / sizeof(T);
  const bool vec = d % kV == 0 && x_stride % kV == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const dim3 grid((unsigned)((rows + kWarpsPerBlock - 1) / kWarpsPerBlock));
  const dim3 block(32 * kWarpsPerBlock);
  if (vec)
    rmsnorm_kernel<T, S, true><<<grid, block, 0, stream>>>(
        (const T*)x, (const S*)scale, (T*)out, rows, d, x_stride, eps);
  else
    rmsnorm_kernel<T, S, false><<<grid, block, 0, stream>>>(
        (const T*)x, (const S*)scale, (T*)out, rows, d, x_stride, eps);
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
