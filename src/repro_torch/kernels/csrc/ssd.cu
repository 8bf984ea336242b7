// Mamba2 SSD chunked scan for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel `ssd_kernel` / `_kernel` in
// src/repro/kernels/ssd/ssd.py.  y = SSD(x, dt, A, B, C) for one B/C group:
// within a tile of rows, y_diag[i] = sum_{j<=i} (C_i.B_j) exp(cum_i - cum_j)
// dt_j x_j and y_off[i] = exp(cum_i) C_i . state; then
// state <- exp(cum_last) state + sum_j exp(cum_last - cum_j) dt_j x_j B_j^T.
// Everything is fp32; y is cast to x's type.
//
// What replaces the TPU's sequential chunk axis: the TPU kernel keeps the
// whole (H, P, N) fp32 state in VMEM (786 KB for mamba2-130m), more than an
// SM's shared memory.  Here one block owns one (batch row, head) and loops
// over the tiles in order, its (P, N) fp32 state resident in shared memory
// (32 KB at P=64, N=128); the state never goes to device memory.  Grid
// (H, b): 96 blocks for mamba2-130m at b=4, 160 for zamba2-2.7b at b=2.
//
// Tile: 64 rows, not the model's chunk (256).  The result does not depend
// on the tile apart from rounding, and at 64 rows B, C (transposed, N-major),
// x*dt, the (64, 64) gate and the state fit in 134 KB of shared memory at
// N=128, where 256 rows would need ~0.5 MB.  The decay matrix is masked
// before exp (the TPU kernel exponentiates first, which overflows to inf for
// steep decays and then gives inf*0 = NaN), and a ragged last tile is masked
// by index: nothing is padded.
//
// Bound on an H100 at the mamba2 prefill shape (b=4, L=1024, H=24, P=64,
// N=128): bytes, ~27.7 MB in and out, ~8.3 us at 3.35 TB/s, against
// ~6.7 GFLOP.  This first version is far from that: scalar fp32 FMAs from
// shared memory (4x4 register tiles, float4 loads), and each head's block
// recomputes C.B^T, which the TPU kernel computes once per chunk for all
// heads.  Sharing that tile (a cluster, or a separate pass) and moving the
// three products onto mma.sync / wgmma are the next steps.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kQ = 64;          // rows of one tile
constexpr int kQS = kQ + 4;     // padded stride of the N-major (and gate) tiles
constexpr int kThreads = 256;   // (kQ/4)^2 4x4 micro-tiles of the gate

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as a dtype cast
}

__host__ __device__ inline long long smem_floats(int N, int P) {
  // Bt, Ct (N x kQS), xs (kQ x P), Gt (kQ x kQS), St (N x P), 4 row vectors
  return 2LL * N * kQS + (long long)kQ * P + (long long)kQ * kQS +
         (long long)N * P + 4LL * kQ;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const T* __restrict__ Bm,
           const T* __restrict__ Cm, T* __restrict__ y, int L, int H, int P,
           int N, long long x_sb, long long x_sl, long long x_sh,
           long long dt_sb, long long dt_sl, long long dt_sh, long long b_sb,
           long long b_sl, long long c_sb, long long c_sl) {
  extern __shared__ float4 smem4[];
  float* Bt = reinterpret_cast<float*>(smem4);  // Bt[n * kQS + j] = B[j][n]
  float* Ct = Bt + N * kQS;                     // Ct[n * kQS + i] = C[i][n]
  float* xs = Ct + N * kQS;                     // xs[j * P + p] = x[j][p] dt[j]
  float* Gt = xs + kQ * P;                      // Gt[j * kQS + i] = gate[i][j]
  float* St = Gt + kQ * kQS;                    // St[n * P + p] = state[p][n]
  float* cum = St + N * P;                      // inclusive cumsum of dt A
  float* wend = cum + kQ;                       // exp(cum_last - cum_j)
  float* ecum = wend + kQ;                      // exp(cum_i)
  float* dts = ecum + kQ;                       // dt of the tile's rows

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const float a = A[h];
  const T* xb = x + b * x_sb + h * x_sh;
  const float* dtb = dt + b * dt_sb + h * dt_sh;
  const T* Bb = Bm + b * b_sb;
  const T* Cb = Cm + b * c_sb;
  const int P4 = P / 4, N4 = N / 4;

  for (int i = tid; i < N * P; i += kThreads) St[i] = 0.f;

  for (int t0 = 0; t0 < L; t0 += kQ) {
    const int q = min(kQ, L - t0);

    // (a) dt and the decay cumsum over the tile: warp 0, two rows a lane.
    //     Rows past L get dt = 0, so cum stays flat and they add nothing.
    if (tid < 32) {
      const int r0 = 2 * tid, r1 = r0 + 1;
      const float d0 = r0 < q ? dtb[(long long)(t0 + r0) * dt_sl] : 0.f;
      const float d1 = r1 < q ? dtb[(long long)(t0 + r1) * dt_sl] : 0.f;
      const float a0 = d0 * a, a1 = d1 * a;
      float incl = a0 + a1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, o);
        if (tid >= o) incl += v;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (tid == 0) excl = 0.f;
      dts[r0] = d0;
      dts[r1] = d1;
      cum[r0] = excl + a0;
      cum[r1] = cum[r0] + a1;
    }
    __syncthreads();

    // (b) stage B and C transposed, x * dt, and the decay vectors
    for (int idx = tid; idx < kQ * N; idx += kThreads) {
      const int j = idx / N, n = idx - j * N;
      const bool in = j < q;
      Bt[n * kQS + j] = in ? to_f(Bb[(long long)(t0 + j) * b_sl + n]) : 0.f;
      Ct[n * kQS + j] = in ? to_f(Cb[(long long)(t0 + j) * c_sl + n]) : 0.f;
    }
    for (int idx = tid; idx < kQ * P; idx += kThreads) {
      const int j = idx / P, p = idx - j * P;
      xs[idx] = j < q ? to_f(xb[(long long)(t0 + j) * x_sl + p]) * dts[j] : 0.f;
    }
    if (tid < kQ) {
      wend[tid] = expf(cum[kQ - 1] - cum[tid]);
      ecum[tid] = expf(cum[tid]);
    }
    __syncthreads();

    // (c) gate[i][j] = (C_i . B_j) exp(cum_i - cum_j) for j <= i, else 0;
    //     the exponent is masked first, so it is never positive
    {
      const int i0 = 4 * (tid / (kQ / 4)), j0 = 4 * (tid % (kQ / 4));
      float g[4][4] = {};
      if (j0 <= i0 + 3) {
        for (int n = 0; n < N; ++n) {
          const float4 c4 = ld4(Ct + n * kQS + i0);
          const float4 b4 = ld4(Bt + n * kQS + j0);
          const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
          const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) g[r][c] = fmaf(cv[r], bv[c], g[r][c]);
        }
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = j0 + c;
        float out[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + r;
          out[r] = j <= i ? g[r][c] * expf(cum[i] - cum[j]) : 0.f;
        }
        *reinterpret_cast<float4*>(Gt + j * kQS + i0) =
            make_float4(out[0], out[1], out[2], out[3]);
      }
    }
    __syncthreads();

    // (d) y[i][p] = sum_{j<=i} gate[i][j] xs[j][p]
    //             + exp(cum_i) sum_n C[i][n] state[p][n]
    for (int mt = tid; mt < (kQ / 4) * P4; mt += kThreads) {
      const int i0 = 4 * (mt / P4), p0 = 4 * (mt % P4);
      if (i0 >= q) continue;
      float acc[4][4] = {}, off[4][4] = {};
      const int jend = min(i0 + 4, q);
      for (int j = 0; j < jend; ++j) {
        const float4 g4 = ld4(Gt + j * kQS + i0);
        const float4 x4 = ld4(xs + j * P + p0);
        const float gv[4] = {g4.x, g4.y, g4.z, g4.w};
        const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(gv[r], xv[c], acc[r][c]);
      }
      for (int n = 0; n < N; ++n) {
        const float4 c4 = ld4(Ct + n * kQS + i0);
        const float4 s4 = ld4(St + n * P + p0);
        const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
        const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) off[r][c] = fmaf(cv[r], sv[c], off[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + r;
        if (i >= q) break;
        T* yr = y + (((long long)b * L + t0 + i) * H + h) * P + p0;
        const float e = ecum[i];
#pragma unroll
        for (int c = 0; c < 4; ++c) yr[c] = from_f<T>(acc[r][c] + e * off[r][c]);
      }
    }
    __syncthreads();

    // (e) state[p][n] <- exp(cum_last) state[p][n]
    //                    + sum_j exp(cum_last - cum_j) xs[j][p] B[j][n]
    {
      const float dec = expf(cum[kQ - 1]);
      for (int mt = tid; mt < N4 * P4; mt += kThreads) {
        const int n0 = 4 * (mt / P4), p0 = 4 * (mt % P4);
        float acc[4][4] = {};
        for (int j = 0; j < q; ++j) {
          const float w = wend[j];
          float bv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) bv[r] = Bt[(n0 + r) * kQS + j] * w;
          const float4 x4 = ld4(xs + j * P + p0);
          const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(bv[r], xv[c], acc[r][c]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float4* s = reinterpret_cast<float4*>(St + (n0 + r) * P + p0);
          float4 v = *s;
          v.x = fmaf(dec, v.x, acc[r][0]);
          v.y = fmaf(dec, v.y, acc[r][1]);
          v.z = fmaf(dec, v.z, acc[r][2]);
          v.w = fmaf(dec, v.w, acc[r][3]);
          *s = v;
        }
      }
    }
    __syncthreads();
  }
}

template <typename T>
int launch(const void* x, const float* dt, const float* A, const void* Bm,
           const void* Cm, void* y, int batch, int L, int H, int P, int N,
           const long long* s, cudaStream_t stream) {
  const size_t bytes = (size_t)smem_floats(N, P) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)H, (unsigned)batch);
  ssd_kernel<T><<<grid, kThreads, bytes, stream>>>(
      (const T*)x, dt, A, (const T*)Bm, (const T*)Cm, (T*)y, L, H, P, N, s[0],
      s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9]);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one block needs, in bytes.
long long ssd_smem_bytes(int N, int P) {
  return smem_floats(N, P) * (long long)sizeof(float);
}

// dtype codes: 0 = float32, 1 = bfloat16 (x, B, C and y share it; dt and A
// are float32).  y is (batch, L, H, P) contiguous.  Element strides:
// x (batch, L, H) with P contiguous; dt (batch, L, H); B and C (batch, L)
// with N contiguous.  P and N must be multiples of 4 (float4 tiles).
int ssd_fwd(const void* x, const void* dt, const void* A, const void* Bm,
            const void* Cm, void* y, int batch, int L, int H, int P, int N,
            long long x_sb, long long x_sl, long long x_sh, long long dt_sb,
            long long dt_sl, long long dt_sh, long long b_sb, long long b_sl,
            long long c_sb, long long c_sl, int dtype, void* stream) {
  if (batch == 0 || L == 0 || H == 0) return 0;
  if (P % 4 || N % 4 || P <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  const long long s[10] = {x_sb, x_sl, x_sh, dt_sb, dt_sl, dt_sh,
                           b_sb, b_sl, c_sb, c_sl};
  cudaStream_t st = (cudaStream_t)stream;
  const float* dtf = (const float*)dt;
  const float* Af = (const float*)A;
  if (dtype == 0)
    return launch<float>(x, dtf, Af, Bm, Cm, y, batch, L, H, P, N, s, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dtf, Af, Bm, Cm, y, batch, L, H, P, N, s, st);
  return (int)cudaErrorInvalidValue;
}

const char* error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
