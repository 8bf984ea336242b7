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
//
// A row split over ranks (`rmsnorm_sumsq`, `rmsnorm_apply`): the Mamba2
// mixer's gated norm when 'model' splits its heads, each rank holding its
// heads' columns of every row.  The norm needs the whole row's mean of
// squares, so it runs as two launches with the caller's all-reduce of one
// fp32 a row between them: pass 1 stores each row's sum of squares over
// the local columns, pass 2 scales by rsqrt(ss / d_total + eps) and the
// rank's slice of the weight.  Both are the forward kernel above with the
// other half compiled out (`Mode`): the same row layout, so pass 2 reads
// x again (one more read of the rank's columns than a whole-row norm,
// which the collective in between makes unavoidable).  Bound: memory;
// 2 reads and 1 write an element, plus 4 bytes a row each way.
//
// Backward (`rmsnorm_bwd`, for training).  The JAX package has no backward
// kernel; its training path takes `jax.vjp` of the plain norm
// (`repro/models/layers.py:35-39`), and this is that gradient.
// With r = rsqrt(mean(x^2) + eps) per row in fp32 and gs = g * scale:
//   dx     = r * (gs - x * r^2 * mean(gs * x)), cast to x's type;
//   dscale = sum over rows of g * (x * r), in fp32, cast to the scale's type.
// r is recomputed from x (one more pass over data already in registers),
// so the forward's interface stays as it is.  Bound on an H100: memory;
// x and g are read once and dx written once (3 x 2 bytes an element in
// bf16, ~47 MB at 8192 x 960), ~8 flops an element.
//
// Design (`rmsnorm_bwd_vec`): the forward's row layout (tpr threads a
// row, the thread's VPL 16-byte vectors of x and of g in registers), and
// a grid of at most `max_parts` blocks that walk the rows (grid stride).
// A thread's columns are the same for every row it visits, so it keeps
// their dscale sums in registers across rows; at the end the block adds
// its row slots' sums in a fixed tree through shared memory and writes
// one fp32 row of partial sums.  `rmsnorm_dscale_sum` then adds the
// blocks' partial rows in a fixed order: no atomics, so dscale is the
// same bit for bit from run to run.  Rows the vector path cannot take
// (as in the forward) go to `rmsnorm_bwd_scalar`: one block a row, the
// row read twice, the partial sums kept in the block's partial row.
//
// The split row's backward (`rmsnorm_split_dot`, `rmsnorm_split_bwd`),
// for training the split-heads mixer.  With r = rsqrt(psum(sum_local x^2)
// / d_total + eps) per row, the forward's summed squares kept, and
// gs = g * scale:
//   dx     = r * gs - x * r^3 / d_total * psum(sum_local gs * x);
//   dscale = sum over rows of g * x * r, over the rank's columns.
// Two launches around the caller's all-reduce of one fp32 a row, as the
// forward: pass 1 stores each row's local sum of gs * x; pass 2, with the
// summed squares and the summed dot, writes dx and the per-block dscale
// partials that `rmsnorm_dscale_sum` adds in a fixed order.  Both are the
// whole-row backward kernel above with its row sums taken from the
// caller (`BwdMode`): pass 2 reads x and g again.  Bound: memory.

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

// What a forward launch does with a row (the split row's two passes run
// the whole-row kernel's code with one half compiled out).
enum Mode {
  kNorm = 0,   // whole row: sum of squares, then scale and store
  kSumSq = 1,  // split row, pass 1: store the fp32 sum of squares only
  kApply = 2,  // split row, pass 2: scale by rsqrt(ss[row] / d_norm + eps)
};

template <typename T, typename S, int VPL, int RPT, int MODE>
__global__ void __launch_bounds__(kThreads)
rmsnorm_vec(const T* __restrict__ x, const S* __restrict__ scale,
            T* __restrict__ out, long long rows, int d, long long x_stride,
            float eps, int tpr, float* __restrict__ ss_io, int d_norm) {
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
    if (MODE != kSumSq && row0 < rows && i < nv) sv[k] = sr[i];
#pragma unroll
    for (int rr = 0; rr < RPT; ++rr) {
      const long long row = row0 + rr;
      xv[rr][k] = row < rows && i < nv
                      ? reinterpret_cast<const uint4*>(x + row * x_stride)[i]
                      : make_uint4(0u, 0u, 0u, 0u);
    }
  }
  float ss[RPT];
  if (MODE == kApply) {
#pragma unroll
    for (int rr = 0; rr < RPT; ++rr)
      ss[rr] = row0 + rr < rows ? ss_io[row0 + rr] : 0.f;
  } else {
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
  }
  if (MODE == kSumSq) {
    if (lane == 0)
#pragma unroll
      for (int rr = 0; rr < RPT; ++rr)
        if (row0 + rr < rows) ss_io[row0 + rr] = ss[rr];
    return;
  }
#pragma unroll
  for (int rr = 0; rr < RPT; ++rr) {
    const long long row = row0 + rr;
    if (row >= rows) break;
    const float r = rsqrtf(ss[rr] / (float)d_norm + eps);
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

template <typename T, typename S, int MODE>
__global__ void __launch_bounds__(32 * kScalarWarps)
rmsnorm_scalar(const T* __restrict__ x, const S* __restrict__ scale,
               T* __restrict__ out, long long rows, int d,
               long long x_stride, float eps, float* __restrict__ ss_io,
               int d_norm) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kScalarWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + row * x_stride;
  T* orow = out + row * (long long)d;
  float ss = 0.f;
  if (MODE == kApply) {
    ss = ss_io[row];
  } else {
    for (int i = lane; i < d; i += 32) { float f = to_f(xr[i]); ss += f * f; }
    ss = warp_sum(ss);
  }
  if (MODE == kSumSq) {
    if (lane == 0) ss_io[row] = ss;
    return;
  }
  const float r = rsqrtf(ss / (float)d_norm + eps);
  for (int i = lane; i < d; i += 32)
    orow[i] = from_f<T>(to_f(xr[i]) * r * to_f(scale[i]));
}

template <typename T, typename S, int VPL, int RPT, int MODE>
void launch_vec(const void* x, const void* scale, void* out, long long rows,
                int d, long long x_stride, float eps, int tpr, float* ss_io,
                int d_norm, cudaStream_t stream) {
  const long long per_block = (long long)(kThreads / tpr) * RPT;
  const dim3 grid((unsigned)((rows + per_block - 1) / per_block));
  rmsnorm_vec<T, S, VPL, RPT, MODE><<<grid, kThreads, 0, stream>>>(
      (const T*)x, (const S*)scale, (T*)out, rows, d, x_stride, eps, tpr,
      ss_io, d_norm);
}

template <typename T, typename S, int RPT, int MODE>
void launch_vpl(int vpl, const void* x, const void* scale, void* out,
                long long rows, int d, long long x_stride, float eps, int tpr,
                float* ss, int dn, cudaStream_t st) {
  switch (vpl) {
    case 1: launch_vec<T, S, 1, RPT, MODE>(x, scale, out, rows, d, x_stride, eps, tpr, ss, dn, st); break;
    case 2: launch_vec<T, S, 2, RPT, MODE>(x, scale, out, rows, d, x_stride, eps, tpr, ss, dn, st); break;
    case 3: launch_vec<T, S, 3, RPT, MODE>(x, scale, out, rows, d, x_stride, eps, tpr, ss, dn, st); break;
    case 4: launch_vec<T, S, 4, RPT, MODE>(x, scale, out, rows, d, x_stride, eps, tpr, ss, dn, st); break;
    case 5: launch_vec<T, S, 5, RPT, MODE>(x, scale, out, rows, d, x_stride, eps, tpr, ss, dn, st); break;
    case 6: launch_vec<T, S, 6, RPT, MODE>(x, scale, out, rows, d, x_stride, eps, tpr, ss, dn, st); break;
    case 7: launch_vec<T, S, 7, RPT, MODE>(x, scale, out, rows, d, x_stride, eps, tpr, ss, dn, st); break;
    default: launch_vec<T, S, 8, RPT, MODE>(x, scale, out, rows, d, x_stride, eps, tpr, ss, dn, st); break;
  }
}

// One forward launch in `MODE`: the vector kernel where the row's layout
// allows it, else the scalar one.  `ss_io` is the split row's fp32 sums
// (written by kSumSq, read by kApply; unused by kNorm), `d_norm` the
// width the sum of squares is divided by (d for a whole row).
template <typename T, typename S, int MODE>
int launch(const void* x, const void* scale, void* out, long long rows, int d,
           long long x_stride, float eps, float* ss_io, int d_norm,
           cudaStream_t stream) {
  constexpr int kV = 16 / sizeof(T);
  const int nv = d / kV;
  const bool vec = d % kV == 0 && x_stride % kV == 0 &&
                   nv <= kMaxVpl * kThreads &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   (MODE == kSumSq ||
                    (reinterpret_cast<uintptr_t>(scale) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(out) % 16 == 0));
  if (!vec) {
    const dim3 grid((unsigned)((rows + kScalarWarps - 1) / kScalarWarps));
    rmsnorm_scalar<T, S, MODE><<<grid, 32 * kScalarWarps, 0, stream>>>(
        (const T*)x, (const S*)scale, (T*)out, rows, d, x_stride, eps, ss_io,
        d_norm);
    return (int)cudaGetLastError();
  }
  int tpr = 32;
  while (nv > kTargetVpl * tpr && tpr < kThreads) tpr *= 2;
  const int vpl = (nv + tpr - 1) / tpr;
  if (nv >= kPairFrom)
    launch_vpl<T, S, 2, MODE>(vpl, x, scale, out, rows, d, x_stride, eps, tpr, ss_io, d_norm, stream);
  else
    launch_vpl<T, S, 1, MODE>(vpl, x, scale, out, rows, d, x_stride, eps, tpr, ss_io, d_norm, stream);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

// What a backward launch does with a row.
enum BwdMode {
  kWholeBwd = 0,  // whole row: both row sums, then dx and dscale partials
  kDotBwd = 1,    // split row, pass 1: store the local sum of gs * x only
  kSplitBwd = 2,  // split row, pass 2: row sums from the caller (summed)
};

template <typename T, typename S, int VPL, int MODE>
__global__ void __launch_bounds__(kThreads, 2)
rmsnorm_bwd_vec(const T* __restrict__ x, const T* __restrict__ g,
                const S* __restrict__ scale, T* __restrict__ dx,
                float* __restrict__ part, long long rows, int d,
                long long x_stride, long long g_stride, float eps, int tpr,
                const float* __restrict__ ss_in, float* __restrict__ dot_io,
                int d_norm) {
  constexpr int kV = 16 / sizeof(T);
  constexpr int kE = VPL * kV;  // columns a thread owns
  typedef Vec<kV * sizeof(S)> SV;
  __shared__ float red[2][kThreads / 32];
  __shared__ float buf[kE][kThreads / 2];
  const int nv = d / kV;
  const int slots = kThreads / tpr;
  const int sub = threadIdx.x / tpr, lane = threadIdx.x - sub * tpr;
  const SV* sr = reinterpret_cast<const SV*>(scale);

  SV sv[VPL];
  float ds[VPL][kV];
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    const int i = lane + k * tpr;
    sv[k] = SV{};
    if (i < nv) sv[k] = sr[i];
#pragma unroll
    for (int j = 0; j < kV; ++j) ds[k][j] = 0.f;
  }

  const long long step = (long long)gridDim.x * slots;
  for (long long row0 = (long long)blockIdx.x * slots; row0 < rows;
       row0 += step) {  // uniform over the block
    const long long row = row0 + sub;
    const bool live = row < rows;
    uint4 xv[VPL], gv[VPL];
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      const int i = lane + k * tpr;
      const bool ok = live && i < nv;
      xv[k] = ok ? reinterpret_cast<const uint4*>(x + row * x_stride)[i]
                 : make_uint4(0u, 0u, 0u, 0u);
      gv[k] = ok ? reinterpret_cast<const uint4*>(g + row * g_stride)[i]
                 : make_uint4(0u, 0u, 0u, 0u);
    }
    float ss = 0.f, sd = 0.f;  // sum of x^2, sum of gs * x
    if (MODE == kSplitBwd) {
      if (live) {
        ss = ss_in[row];
        sd = dot_io[row];
      }
    } else {
#pragma unroll
      for (int k = 0; k < VPL; ++k) {
        const T* ex = reinterpret_cast<const T*>(&xv[k]);
        const T* eg = reinterpret_cast<const T*>(&gv[k]);
        const S* es = reinterpret_cast<const S*>(&sv[k]);
#pragma unroll
        for (int j = 0; j < kV; ++j) {
          const float xf = to_f(ex[j]);
          if (MODE == kWholeBwd) ss += xf * xf;
          sd += to_f(eg[j]) * to_f(es[j]) * xf;
        }
      }
      ss = warp_sum(ss);
      sd = warp_sum(sd);
      if (tpr > 32) {
        if ((threadIdx.x & 31) == 0) {
          red[0][threadIdx.x >> 5] = ss;
          red[1][threadIdx.x >> 5] = sd;
        }
        __syncthreads();
        const int w0 = (sub * tpr) >> 5;
        ss = 0.f;
        sd = 0.f;
        for (int w = 0; w < (tpr >> 5); ++w) {
          ss += red[0][w0 + w];
          sd += red[1][w0 + w];
        }
        __syncthreads();  // red is written again for the next rows
      }
    }
    if (MODE == kDotBwd) {
      if (live && lane == 0) dot_io[row] = sd;
      continue;  // uniform over the block
    }
    const float r = rsqrtf(ss / (float)d_norm + eps);
    const float c = r * r * r * (sd / (float)d_norm);
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      const int i = lane + k * tpr;
      const T* ex = reinterpret_cast<const T*>(&xv[k]);
      const T* eg = reinterpret_cast<const T*>(&gv[k]);
      const S* es = reinterpret_cast<const S*>(&sv[k]);
      uint4 w;
      T* o = reinterpret_cast<T*>(&w);
#pragma unroll
      for (int j = 0; j < kV; ++j) {
        const float xf = to_f(ex[j]), gf = to_f(eg[j]);
        o[j] = from_f<T>(r * (gf * to_f(es[j])) - xf * c);
        ds[k][j] += gf * (xf * r);  // 0 for a row past the end (g = 0)
      }
      if (live && i < nv)
        reinterpret_cast<uint4*>(dx + row * (long long)d)[i] = w;
    }
  }

  if (MODE == kDotBwd) return;
  // add the row slots' sums: slot s += slot s + h, h = slots/2, ..., 1
  const int t = threadIdx.x;
  for (int h = slots >> 1; h >= 1; h >>= 1) {
    if (sub >= h && sub < 2 * h) {
#pragma unroll
      for (int k = 0; k < VPL; ++k)
#pragma unroll
        for (int j = 0; j < kV; ++j) buf[k * kV + j][t - h * tpr] = ds[k][j];
    }
    __syncthreads();
    if (sub < h) {
#pragma unroll
      for (int k = 0; k < VPL; ++k)
#pragma unroll
        for (int j = 0; j < kV; ++j) ds[k][j] += buf[k * kV + j][t];
    }
    __syncthreads();
  }
  if (sub == 0) {
    float* prow = part + (long long)blockIdx.x * d;
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      const int i = lane + k * tpr;
      if (i < nv) {
#pragma unroll
        for (int j = 0; j < kV; j += 4)
          *reinterpret_cast<float4*>(prow + i * kV + j) =
              make_float4(ds[k][j], ds[k][j + 1], ds[k][j + 2], ds[k][j + 3]);
      }
    }
  }
}

template <typename T, typename S, int MODE>
__global__ void __launch_bounds__(kThreads)
rmsnorm_bwd_scalar(const T* __restrict__ x, const T* __restrict__ g,
                   const S* __restrict__ scale, T* __restrict__ dx,
                   float* __restrict__ part, long long rows, int d,
                   long long x_stride, long long g_stride, float eps,
                   const float* __restrict__ ss_in, float* __restrict__ dot_io,
                   int d_norm) {
  __shared__ float red[2][kThreads / 32];
  float* prow = part + (long long)blockIdx.x * d;
  if (MODE != kDotBwd)
    for (int i = threadIdx.x; i < d; i += kThreads) prow[i] = 0.f;
  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    const T* xr = x + row * x_stride;
    const T* gr = g + row * g_stride;
    float ss = 0.f, sd = 0.f;
    if (MODE == kSplitBwd) {
      ss = ss_in[row];
      sd = dot_io[row];
    } else {
      for (int i = threadIdx.x; i < d; i += kThreads) {
        const float xf = to_f(xr[i]);
        if (MODE == kWholeBwd) ss += xf * xf;
        sd += to_f(gr[i]) * to_f(scale[i]) * xf;
      }
      ss = warp_sum(ss);
      sd = warp_sum(sd);
      if ((threadIdx.x & 31) == 0) {
        red[0][threadIdx.x >> 5] = ss;
        red[1][threadIdx.x >> 5] = sd;
      }
      __syncthreads();
      ss = 0.f;
      sd = 0.f;
      for (int w = 0; w < kThreads / 32; ++w) {
        ss += red[0][w];
        sd += red[1][w];
      }
      __syncthreads();
    }
    if (MODE == kDotBwd) {
      if (threadIdx.x == 0) dot_io[row] = sd;
      continue;
    }
    const float r = rsqrtf(ss / (float)d_norm + eps);
    const float c = r * r * r * (sd / (float)d_norm);
    T* drow = dx + row * (long long)d;
    for (int i = threadIdx.x; i < d; i += kThreads) {  // a thread's own columns
      const float xf = to_f(xr[i]), gf = to_f(gr[i]);
      drow[i] = from_f<T>(r * (gf * to_f(scale[i])) - xf * c);
      prow[i] += gf * (xf * r);
    }
  }
}

// dscale[c] = sum over p of part[p][c], p in order 0, 8, 16, ... within
// each of 8 row groups, then the 8 groups in order.
constexpr int kSumCols = 32;
template <typename S>
__global__ void __launch_bounds__(kThreads)
rmsnorm_dscale_sum(const float* __restrict__ part, S* __restrict__ dscale,
                   int parts, int d) {
  constexpr int kGroups = kThreads / kSumCols;
  __shared__ float red[kGroups][kSumCols + 1];
  const int tx = threadIdx.x % kSumCols, ty = threadIdx.x / kSumCols;
  const int col = blockIdx.x * kSumCols + tx;
  float s = 0.f;
  if (col < d)
    for (int p = ty; p < parts; p += kGroups) s += part[(long long)p * d + col];
  red[ty][tx] = s;
  __syncthreads();
  if (ty == 0 && col < d) {
    float t = 0.f;
    for (int w = 0; w < kGroups; ++w) t += red[w][tx];
    dscale[col] = from_f<S>(t);
  }
}

// The row sums a backward launch in `MODE` takes from the caller or hands
// back: `ss` the split row's summed squares (kSplitBwd), `dot` its local
// (kDotBwd, written) or summed (kSplitBwd, read) sum of gs * x, `d_norm`
// the width the sums are divided by (d for a whole row).
struct RowSums {
  const float* ss;
  float* dot;
  int d_norm;
};

template <typename T, typename S, int VPL, int MODE>
void launch_bwd_vec(const void* x, const void* g, const void* scale, void* dx,
                    float* part, int parts, long long rows, int d,
                    long long x_stride, long long g_stride, float eps, int tpr,
                    RowSums rs, cudaStream_t stream) {
  rmsnorm_bwd_vec<T, S, VPL, MODE><<<parts, kThreads, 0, stream>>>(
      (const T*)x, (const T*)g, (const S*)scale, (T*)dx, part, rows, d,
      x_stride, g_stride, eps, tpr, rs.ss, rs.dot, rs.d_norm);
}

template <typename T, typename S, int MODE>
int launch_bwd(const void* x, const void* g, const void* scale, void* dx,
               void* dscale, float* part, int max_parts, long long rows, int d,
               long long x_stride, long long g_stride, float eps, RowSums rs,
               cudaStream_t st) {
  constexpr int kV = 16 / sizeof(T);
  const int nv = d / kV;
  const bool vec = d % kV == 0 && x_stride % kV == 0 && g_stride % kV == 0 &&
                   nv <= kMaxVpl * kThreads &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(scale) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dx) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(part) % 16 == 0;
  int parts;
  if (!vec) {
    parts = (int)(rows < max_parts ? rows : max_parts);
    rmsnorm_bwd_scalar<T, S, MODE><<<parts, kThreads, 0, st>>>(
        (const T*)x, (const T*)g, (const S*)scale, (T*)dx, part, rows, d,
        x_stride, g_stride, eps, rs.ss, rs.dot, rs.d_norm);
  } else {
    int tpr = 32;
    while (nv > kTargetVpl * tpr && tpr < kThreads) tpr *= 2;
    const int vpl = (nv + tpr - 1) / tpr;
    const long long slots = kThreads / tpr;
    const long long need = (rows + slots - 1) / slots;
    parts = (int)(need < max_parts ? need : max_parts);
    switch (vpl) {
      case 1: launch_bwd_vec<T, S, 1, MODE>(x, g, scale, dx, part, parts, rows, d, x_stride, g_stride, eps, tpr, rs, st); break;
      case 2: launch_bwd_vec<T, S, 2, MODE>(x, g, scale, dx, part, parts, rows, d, x_stride, g_stride, eps, tpr, rs, st); break;
      case 3: launch_bwd_vec<T, S, 3, MODE>(x, g, scale, dx, part, parts, rows, d, x_stride, g_stride, eps, tpr, rs, st); break;
      case 4: launch_bwd_vec<T, S, 4, MODE>(x, g, scale, dx, part, parts, rows, d, x_stride, g_stride, eps, tpr, rs, st); break;
      case 5: launch_bwd_vec<T, S, 5, MODE>(x, g, scale, dx, part, parts, rows, d, x_stride, g_stride, eps, tpr, rs, st); break;
      case 6: launch_bwd_vec<T, S, 6, MODE>(x, g, scale, dx, part, parts, rows, d, x_stride, g_stride, eps, tpr, rs, st); break;
      case 7: launch_bwd_vec<T, S, 7, MODE>(x, g, scale, dx, part, parts, rows, d, x_stride, g_stride, eps, tpr, rs, st); break;
      default: launch_bwd_vec<T, S, 8, MODE>(x, g, scale, dx, part, parts, rows, d, x_stride, g_stride, eps, tpr, rs, st); break;
    }
  }
  int code = (int)cudaGetLastError();
  if (code != 0 || MODE == kDotBwd) return code;
  rmsnorm_dscale_sum<S><<<(d + kSumCols - 1) / kSumCols, kThreads, 0, st>>>(
      part, (S*)dscale, parts, d);
  return (int)cudaGetLastError();
}

template <int MODE>
int dispatch_bwd(const void* x, const void* g, const void* scale, void* dx,
                 void* dscale, float* part, int max_parts, long long rows,
                 int d, long long x_stride, long long g_stride, float eps,
                 RowSums rs, int x_dtype, int scale_dtype, cudaStream_t s) {
  typedef __nv_bfloat16 bf;
  if (x_dtype == 0 && scale_dtype == 0)
    return launch_bwd<float, float, MODE>(x, g, scale, dx, dscale, part, max_parts, rows, d, x_stride, g_stride, eps, rs, s);
  if (x_dtype == 0 && scale_dtype == 1)
    return launch_bwd<float, bf, MODE>(x, g, scale, dx, dscale, part, max_parts, rows, d, x_stride, g_stride, eps, rs, s);
  if (x_dtype == 1 && scale_dtype == 0)
    return launch_bwd<bf, float, MODE>(x, g, scale, dx, dscale, part, max_parts, rows, d, x_stride, g_stride, eps, rs, s);
  if (x_dtype == 1 && scale_dtype == 1)
    return launch_bwd<bf, bf, MODE>(x, g, scale, dx, dscale, part, max_parts, rows, d, x_stride, g_stride, eps, rs, s);
  return (int)cudaErrorInvalidValue;
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
    return launch<float, float, kNorm>(x, scale, out, rows, d, x_stride, eps, nullptr, d, s);
  if (x_dtype == 0 && scale_dtype == 1)
    return launch<float, __nv_bfloat16, kNorm>(x, scale, out, rows, d, x_stride, eps, nullptr, d, s);
  if (x_dtype == 1 && scale_dtype == 0)
    return launch<__nv_bfloat16, float, kNorm>(x, scale, out, rows, d, x_stride, eps, nullptr, d, s);
  if (x_dtype == 1 && scale_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16, kNorm>(x, scale, out, rows, d, x_stride, eps, nullptr, d, s);
  return (int)cudaErrorInvalidValue;
}

// A row split over ranks, pass 1: ss[i] = the fp32 sum of squares of this
// rank's d columns of row i (ss: rows floats).
int rmsnorm_sumsq(const void* x, float* ss, long long rows, int d,
                  long long x_stride, int x_dtype, void* stream) {
  if (rows == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (x_dtype == 0)
    return launch<float, float, kSumSq>(x, nullptr, nullptr, rows, d, x_stride, 0.f, ss, d, s);
  if (x_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16, kSumSq>(x, nullptr, nullptr, rows, d, x_stride, 0.f, ss, d, s);
  return (int)cudaErrorInvalidValue;
}

// Pass 2, after the caller has summed ss over the ranks: out = x *
// rsqrt(ss[i] / d_total + eps) * scale in fp32, cast to x's type; scale is
// this rank's d entries of the weight.
int rmsnorm_apply(const void* x, const void* scale, const float* ss,
                  void* out, long long rows, int d, long long x_stride,
                  int d_total, float eps, int x_dtype, int scale_dtype,
                  void* stream) {
  if (rows == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  float* io = const_cast<float*>(ss);  // read only in kApply
  if (x_dtype == 0 && scale_dtype == 0)
    return launch<float, float, kApply>(x, scale, out, rows, d, x_stride, eps, io, d_total, s);
  if (x_dtype == 0 && scale_dtype == 1)
    return launch<float, __nv_bfloat16, kApply>(x, scale, out, rows, d, x_stride, eps, io, d_total, s);
  if (x_dtype == 1 && scale_dtype == 0)
    return launch<__nv_bfloat16, float, kApply>(x, scale, out, rows, d, x_stride, eps, io, d_total, s);
  if (x_dtype == 1 && scale_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16, kApply>(x, scale, out, rows, d, x_stride, eps, io, d_total, s);
  return (int)cudaErrorInvalidValue;
}

// Backward.  dtype codes as above; g has x's type, dx is (rows, d)
// contiguous in x's type, dscale (d,) in the scale's type.  `part` is fp32
// scratch of at least max_parts x d floats (one partial row per block of
// the first kernel; max_parts >= 1).
int rmsnorm_bwd(const void* x, const void* g, const void* scale, void* dx,
                void* dscale, void* part, int max_parts, long long rows, int d,
                long long x_stride, long long g_stride, float eps, int x_dtype,
                int scale_dtype, void* stream) {
  if (rows == 0 || d == 0 || max_parts < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return dispatch_bwd<kWholeBwd>(x, g, scale, dx, dscale, (float*)part, max_parts, rows, d,
                                 x_stride, g_stride, eps, RowSums{nullptr, nullptr, d},
                                 x_dtype, scale_dtype, s);
}

// The split row's backward, pass 1: dot[i] = the fp32 sum over this rank's
// d columns of row i of g * scale * x (dot: rows floats; `part` and
// `max_parts` as for rmsnorm_bwd, the scratch unused).
int rmsnorm_split_dot(const void* x, const void* g, const void* scale,
                      float* dot, int max_parts, long long rows, int d,
                      long long x_stride, long long g_stride, int x_dtype,
                      int scale_dtype, void* stream) {
  if (rows == 0 || d == 0 || max_parts < 1) return (int)cudaErrorInvalidValue;
  return dispatch_bwd<kDotBwd>(x, g, scale, nullptr, nullptr, nullptr, max_parts, rows,
                               d, x_stride, g_stride, 0.f, RowSums{nullptr, dot, d},
                               x_dtype, scale_dtype, (cudaStream_t)stream);
}

// Pass 2, after the caller has summed dot over the ranks: dx and dscale
// (this rank's d entries) as rmsnorm_bwd writes them, with the row sums
// ss (the forward's squares, summed) and dot over rows d_total wide.
int rmsnorm_split_bwd(const void* x, const void* g, const void* scale,
                      const float* ss, const float* dot, void* dx,
                      void* dscale, void* part, int max_parts, long long rows,
                      int d, long long x_stride, long long g_stride,
                      int d_total, float eps, int x_dtype, int scale_dtype,
                      void* stream) {
  if (rows == 0 || d == 0 || max_parts < 1) return (int)cudaErrorInvalidValue;
  return dispatch_bwd<kSplitBwd>(x, g, scale, dx, dscale, (float*)part, max_parts, rows,
                                 d, x_stride, g_stride, eps,
                                 RowSums{ss, const_cast<float*>(dot), d_total},
                                 x_dtype, scale_dtype, (cudaStream_t)stream);
}

const char* error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
