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
// The Mamba2 mixer's gated norm (`GATE`, every kernel below): the norm of
// v = y * silu(z), with the reference's rounding points
// (src/repro/models/ssm.py:156-157): silu in fp32 as z * sigmoid(z),
// rounded to y's type, the product rounded to y's type, the norm in fp32
// over that v.  A thread loads its vectors of y and of z (each with its own
// row stride: z is a column view of `in_proj`'s output) and forms v in
// registers; v never goes to memory.  A z whose rows are not 16-byte
// aligned (the split-heads mixer's columns arrive from an all-to-all with
// an odd row stride) is read an element at a time by the same vector
// kernels (`load_z`).  The four elementwise launches the
// gate took before (26 bytes an element in bf16, and an fp32 copy of z
// kept for autograd) become 2 more bytes an element read by the norm.
//
// A row split over ranks (`rmsnorm_sumsq`, `rmsnorm_apply`): the Mamba2
// mixer's gated norm when 'model' splits its heads, each rank holding its
// heads' columns of every row.  The norm needs the whole row's mean of
// squares, so it runs as two launches with the caller's all-reduce of one
// fp32 a row between them: pass 1 stores each row's sum of squares over
// the local columns, pass 2 scales by rsqrt(ss / d_total + eps) and the
// rank's slice of the weight.  Both are the forward kernel above with the
// other half compiled out (`Mode`): the same row layout, so pass 2 reads
// x (gated: y and z, v recomputed) again: one more read of the rank's
// columns than a whole-row norm, which the collective in between makes
// unavoidable; gated, that is 10 bytes an element in bf16 in all, what
// writing v in pass 1 and reading it in pass 2 would cost, without a v
// buffer.  Bound: memory; 2 reads and 1 write an element, plus 4 bytes a
// row each way.
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
// Gated, the same with x = v recomputed from y and z, and dv (the dx
// above, kept in fp32, never rounded) carried through the gate:
//   dy = dv * s,  dz = dv * y * sig(z) * (1 + z * (1 - sig(z))),
// s = silu(z) rounded to y's type, each output rounded once to y's type
// (autograd's chain through the plain ops rounds dv and each product).
// The first pass over a row's registers replaces y by v and z by s, and
// keeps y * silu'(z) in fp32, so each exp and reciprocal runs once an
// element (rows of at most 4 vectors a thread; wider rows take the scalar
// kernel).  Bound: memory, y, z and g read once, dy and dz written once
// (10 bytes an element in bf16).
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
// dscale's sum folded into the backward's last launch (the gated and the
// split entries; the whole-row ungated backward keeps its second launch).
// `rmsnorm_dscale_sum` adds, for each column, the partial rows of each of
// 8 classes (p = c, c + 8, c + 16, ... in order) and then the 8 class sums
// in order.  `fold_dscale` does the same additions in the same order
// inside the backward kernel: each block writes its partial row, fences,
// and bumps its class's device-scope counter; the class's last block adds
// the class's rows into a class row, fences and bumps a last counter; the
// last of those adds the class rows into dscale.  Each block that finishes
// a count resets it, so the next launch finds zeros.  The counters only
// order the work: no atomics touch the sums, so dscale has the two-launch
// version's bits, the same from run to run.  What the fold costs is the
// tail after the last block's rows: one block a class reads an eighth of
// the partial rows, bound by the loads one SM keeps in flight, so the
// folded kernels run 512 threads a block, one block an SM, which halves
// the partial rows and doubles the loads each tail block keeps in flight.
// Both two-launch and folded versions take the same blocks, so the fold
// keeps the two-launch version's bits whichever is run.
//
// The split row's backward (`rmsnorm_split_dot`, `rmsnorm_split_bwd`),
// for training the split-heads mixer.  With r = rsqrt(psum(sum_local x^2)
// / d_total + eps) per row, the forward's summed squares kept, and
// gs = g * scale:
//   dx     = r * gs - x * r^3 / d_total * psum(sum_local gs * x);
//   dscale = sum over rows of g * x * r, over the rank's columns.
// Two launches around the caller's all-reduce of one fp32 a row, as the
// forward: pass 1 stores each row's local sum of gs * x; pass 2, with the
// summed squares and the summed dot, writes dx and dscale (folded, as
// above).  Both are the whole-row backward kernel above with its row sums
// taken from the caller (`BwdMode`): pass 2 reads x and g again.  Bound:
// memory.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>


namespace {

std::atomic<long long> launched{0};  // kernels this library has launched

constexpr int kThreads = 256;
constexpr int kMaxVpl = 8;     // vectors a thread can hold
constexpr int kGateMaxVpl = 4;  // the same, gated (y, z and g held); wider rows take the scalar kernels
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

// sigmoid(z) in fp32: a correctly rounded reciprocal of 1 + e^-z.
__device__ __forceinline__ float sigmoid(float z) {
  return __frcp_rn(1.f + expf(-z));
}

// The gate's element: v = y * silu(z), silu in fp32 as the reference's
// jax.nn.silu computes it (z * sigmoid(z)), rounded to T, the product
// rounded to T.
template <typename T>
__device__ __forceinline__ T gate(T y, T z) {
  const float zf = to_f(z);
  return from_f<T>(to_f(y) * to_f(from_f<T>(zf * sigmoid(zf))));
}

// v in place of y, for one 16-byte vector of each.
template <typename T>
__device__ __forceinline__ void gate_vec(uint4& y, const uint4& z) {
  constexpr int kV = 16 / sizeof(T);
  T* ey = reinterpret_cast<T*>(&y);
  const T* ez = reinterpret_cast<const T*>(&z);
#pragma unroll
  for (int j = 0; j < kV; ++j) ey[j] = gate(ey[j], ez[j]);
}

// The 16-byte vector i of a row of z: one load where z's rows are 16-byte
// aligned (`zvec`), else kV loads of an element (a z whose row stride is
// not a multiple of 8 bf16, as the split-heads mixer's columns arrive).
template <typename T>
__device__ __forceinline__ uint4 load_z(const T* zrow, int i, bool zvec) {
  if (zvec) return reinterpret_cast<const uint4*>(zrow)[i];
  constexpr int kV = 16 / sizeof(T);
  uint4 v;
  T* e = reinterpret_cast<T*>(&v);
#pragma unroll
  for (int j = 0; j < kV; ++j) e[j] = zrow[i * kV + j];
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

template <typename T, typename S, int VPL, int RPT, int MODE, bool GATE>
__global__ void __launch_bounds__(kThreads)
rmsnorm_vec(const T* __restrict__ x, const T* __restrict__ z,
            const S* __restrict__ scale, T* __restrict__ out, long long rows,
            int d, long long x_stride, long long z_stride, bool zvec,
            float eps, int tpr, float* __restrict__ ss_io, int d_norm) {
  constexpr int kV = 16 / sizeof(T);  // elements per 16-byte vector of x
  typedef Vec<kV * sizeof(S)> SV;
  __shared__ float red[RPT][kThreads / 32];
  const int nv = d / kV;
  const int sub = threadIdx.x / tpr, lane = threadIdx.x - sub * tpr;
  const long long row0 = ((long long)blockIdx.x * (kThreads / tpr) + sub) * RPT;
  const SV* sr = reinterpret_cast<const SV*>(scale);

  uint4 xv[RPT][VPL];
  uint4 zv[RPT][VPL];  // GATE only
  SV sv[VPL];
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    const int i = lane + k * tpr;
    if (MODE != kSumSq && row0 < rows && i < nv) sv[k] = sr[i];
#pragma unroll
    for (int rr = 0; rr < RPT; ++rr) {
      const long long row = row0 + rr;
      const bool ok = row < rows && i < nv;
      xv[rr][k] = ok ? reinterpret_cast<const uint4*>(x + row * x_stride)[i]
                     : make_uint4(0u, 0u, 0u, 0u);
      if constexpr (GATE)
        zv[rr][k] = ok ? load_z(z + row * z_stride, i, zvec)
                       : make_uint4(0u, 0u, 0u, 0u);
    }
  }
  if constexpr (GATE) {  // x becomes v; zeros stay zeros
#pragma unroll
    for (int k = 0; k < VPL; ++k)
#pragma unroll
      for (int rr = 0; rr < RPT; ++rr) gate_vec<T>(xv[rr][k], zv[rr][k]);
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

template <typename T, typename S, int MODE, bool GATE>
__global__ void __launch_bounds__(32 * kScalarWarps)
rmsnorm_scalar(const T* __restrict__ x, const T* __restrict__ z,
               const S* __restrict__ scale, T* __restrict__ out,
               long long rows, int d, long long x_stride, long long z_stride,
               float eps, float* __restrict__ ss_io, int d_norm) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kScalarWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + row * x_stride;
  const T* zr = GATE ? z + row * z_stride : nullptr;
  T* orow = out + row * (long long)d;
  auto val = [&](int i) {  // x, or gated v
    if constexpr (GATE) return to_f(gate(xr[i], zr[i]));
    else return to_f(xr[i]);
  };
  float ss = 0.f;
  if (MODE == kApply) {
    ss = ss_io[row];
  } else {
    for (int i = lane; i < d; i += 32) { float f = val(i); ss += f * f; }
    ss = warp_sum(ss);
  }
  if (MODE == kSumSq) {
    if (lane == 0) ss_io[row] = ss;
    return;
  }
  const float r = rsqrtf(ss / (float)d_norm + eps);
  for (int i = lane; i < d; i += 32)
    orow[i] = from_f<T>(val(i) * r * to_f(scale[i]));
}

// A forward launch's arguments: `z` the gate (nullptr: none), `ss` the
// split row's fp32 sums (written by kSumSq, read by kApply; unused by
// kNorm), `d_norm` the width the sum of squares is divided by (d for a
// whole row).
struct FwdArgs {
  const void* x;
  const void* z;
  const void* scale;
  void* out;
  long long rows;
  int d;
  long long x_stride, z_stride;
  float eps;
  float* ss;
  int d_norm;
};

bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Whether z's rows can be read in 16-byte vectors of kV elements.
bool zvec(const void* z, long long z_stride, int kV) {
  return aligned(z) && z_stride % kV == 0;
}

template <typename T, typename S, int VPL, int RPT, int MODE, bool GATE>
void launch_vec(const FwdArgs& a, int tpr, cudaStream_t stream) {
  const long long per_block = (long long)(kThreads / tpr) * RPT;
  const dim3 grid((unsigned)((a.rows + per_block - 1) / per_block));
  rmsnorm_vec<T, S, VPL, RPT, MODE, GATE><<<grid, kThreads, 0, stream>>>(
      (const T*)a.x, (const T*)a.z, (const S*)a.scale, (T*)a.out, a.rows, a.d,
      a.x_stride, a.z_stride, zvec(a.z, a.z_stride, 16 / sizeof(T)), a.eps,
      tpr, a.ss, a.d_norm);
  ++launched;
}

template <typename T, typename S, int RPT, int MODE, bool GATE>
void launch_vpl(int vpl, const FwdArgs& a, int tpr, cudaStream_t st) {
  switch (vpl) {
    case 1: launch_vec<T, S, 1, RPT, MODE, GATE>(a, tpr, st); break;
    case 2: launch_vec<T, S, 2, RPT, MODE, GATE>(a, tpr, st); break;
    case 3: launch_vec<T, S, 3, RPT, MODE, GATE>(a, tpr, st); break;
    default:
      if constexpr (GATE) {
        launch_vec<T, S, 4, RPT, MODE, GATE>(a, tpr, st);
      } else {
        switch (vpl) {
          case 4: launch_vec<T, S, 4, RPT, MODE, GATE>(a, tpr, st); break;
          case 5: launch_vec<T, S, 5, RPT, MODE, GATE>(a, tpr, st); break;
          case 6: launch_vec<T, S, 6, RPT, MODE, GATE>(a, tpr, st); break;
          case 7: launch_vec<T, S, 7, RPT, MODE, GATE>(a, tpr, st); break;
          default: launch_vec<T, S, 8, RPT, MODE, GATE>(a, tpr, st); break;
        }
      }
  }
}


// One forward launch in `MODE`: the vector kernel where the rows' layout
// allows it, else the scalar one.
template <typename T, typename S, int MODE, bool GATE>
int launch(const FwdArgs& a, cudaStream_t stream) {
  constexpr int kV = 16 / sizeof(T);
  const int nv = a.d / kV;
  const bool vec = a.d % kV == 0 && a.x_stride % kV == 0 &&
                   nv <= (GATE ? kGateMaxVpl : kMaxVpl) * kThreads &&
                   aligned(a.x) &&
                   (MODE == kSumSq || (aligned(a.scale) && aligned(a.out)));
  if (!vec) {
    const dim3 grid((unsigned)((a.rows + kScalarWarps - 1) / kScalarWarps));
    rmsnorm_scalar<T, S, MODE, GATE><<<grid, 32 * kScalarWarps, 0, stream>>>(
        (const T*)a.x, (const T*)a.z, (const S*)a.scale, (T*)a.out, a.rows,
        a.d, a.x_stride, a.z_stride, a.eps, a.ss, a.d_norm);
    ++launched;
    return (int)cudaGetLastError();
  }
  int tpr = 32;
  while (nv > kTargetVpl * tpr && tpr < kThreads) tpr *= 2;
  const int vpl = (nv + tpr - 1) / tpr;
  if constexpr (GATE)  // one row a thread group: the gate's registers
    launch_vpl<T, S, 1, MODE, GATE>(vpl, a, tpr, stream);
  else if (nv >= kPairFrom)
    launch_vpl<T, S, 2, MODE, GATE>(vpl, a, tpr, stream);
  else
    launch_vpl<T, S, 1, MODE, GATE>(vpl, a, tpr, stream);
  return (int)cudaGetLastError();
}

template <typename T> struct Tag { typedef T type; };

// f(Tag<x's type>, Tag<the scale's type>, gated) for the dtype codes; the
// gated kernels take x and the scale in one type (the mixer's weights and
// activations share theirs).
template <typename F>
int by_types(int x_dtype, int scale_dtype, bool gated, F&& f) {
  typedef __nv_bfloat16 bf;
  auto g = [&](auto t, auto s) -> int {
    if constexpr (std::is_same_v<typename decltype(t)::type,
                                 typename decltype(s)::type>) {
      if (gated) return f(t, s, std::true_type{});
    } else {
      if (gated) return (int)cudaErrorInvalidValue;
    }
    return f(t, s, std::false_type{});
  };
  if (x_dtype == 0 && scale_dtype == 0) return g(Tag<float>{}, Tag<float>{});
  if (x_dtype == 0 && scale_dtype == 1) return g(Tag<float>{}, Tag<bf>{});
  if (x_dtype == 1 && scale_dtype == 0) return g(Tag<bf>{}, Tag<float>{});
  if (x_dtype == 1 && scale_dtype == 1) return g(Tag<bf>{}, Tag<bf>{});
  return (int)cudaErrorInvalidValue;
}

template <int MODE>
int dispatch_fwd(const FwdArgs& a, int x_dtype, int scale_dtype,
                 cudaStream_t s) {
  return by_types(x_dtype, scale_dtype, a.z != nullptr,
                  [&](auto t, auto sc, auto g) {
                    typedef typename decltype(t)::type T;
                    typedef std::conditional_t<  // pass 1 reads no scale
                        MODE == kSumSq, T, typename decltype(sc)::type> S;
                    return launch<T, S, MODE, decltype(g)::value>(a, s);
                  });
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

constexpr int kSumCols = 32;
constexpr int kGroups = kThreads / kSumCols;  // dscale's classes of partial rows

// dscale[c] = sum over p of part[p][c], p in order 0, 8, 16, ... within
// each of 8 row groups, then the 8 groups in order.
template <typename S>
__global__ void __launch_bounds__(kThreads)
rmsnorm_dscale_sum(const float* __restrict__ part, S* __restrict__ dscale,
                   int parts, int d) {
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

// Whether this block is the last of `of` blocks to arrive at `counter`,
// after every thread's writes so far are visible to the whole device: the
// barrier orders the block's writes before thread 0's fence, which makes
// them visible before its atomic (the pattern of a cooperative grid's
// barrier: one fence a block, not one a thread).
__device__ __forceinline__ bool arrive_last(int* counter, int of) {
  __shared__ int last;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(counter, 1) == of - 1;
    if (last) __threadfence();  // the others' writes before this block's reads
  }
  __syncthreads();
  return last;
}

// `rmsnorm_dscale_sum`'s additions, in its order, at the end of the
// backward kernel whose blocks have each written their partial row
// (`part` row blockIdx.x; rows gridDim.x .. gridDim.x + 7 hold the class
// sums).  counters[0..7]: each class's arrivals; counters[8]: the classes'.
// A thread adds kCols columns at once and loads kBatch of their partial
// rows before adding them in order, so 64 loads are in flight a thread:
// the sums after the last block's rows are one block's reads of L2, and
// their latency, not their bytes, would set the time.  Loads go through
// L2 (__ldcg): other SMs wrote the rows.
template <typename S>
__device__ __noinline__ void fold_dscale(float* __restrict__ part, S* __restrict__ dscale,
                            int d, int* counters) {
  constexpr int kCols = 4, kBatch = 16;
  const int parts = gridDim.x, c = blockIdx.x % kGroups;
  const int classes = parts < kGroups ? parts : kGroups;
  float* cls = part + (long long)parts * d;
  if (!arrive_last(counters + c, (parts - c + kGroups - 1) / kGroups)) return;
  for (int col0 = threadIdx.x; col0 < d; col0 += kCols * (int)blockDim.x) {
    float s[kCols];
#pragma unroll
    for (int u = 0; u < kCols; ++u) s[u] = 0.f;
    for (int p0 = c; p0 < parts; p0 += kBatch * kGroups) {
      float v[kBatch][kCols];
#pragma unroll
      for (int k = 0; k < kBatch; ++k)
#pragma unroll
        for (int u = 0; u < kCols; ++u) {
          const int p = p0 + k * kGroups, col = col0 + u * (int)blockDim.x;
          v[k][u] = p < parts && col < d ? __ldcg(part + (long long)p * d + col)
                                         : 0.f;
        }
#pragma unroll
      for (int k = 0; k < kBatch; ++k)
        if (p0 + k * kGroups < parts)
#pragma unroll
          for (int u = 0; u < kCols; ++u) s[u] += v[k][u];
    }
#pragma unroll
    for (int u = 0; u < kCols; ++u) {
      const int col = col0 + u * (int)blockDim.x;
      if (col < d) cls[(long long)c * d + col] = s[u];
    }
  }
  if (threadIdx.x == 0) counters[c] = 0;  // every member of the class arrived
  if (!arrive_last(counters + kGroups, classes)) return;
  for (int col0 = threadIdx.x; col0 < d; col0 += kCols * (int)blockDim.x) {
    float v[kGroups][kCols];
#pragma unroll
    for (int w = 0; w < kGroups; ++w)
#pragma unroll
      for (int u = 0; u < kCols; ++u) {
        const int col = col0 + u * (int)blockDim.x;
        v[w][u] = w < classes && col < d
                      ? __ldcg(cls + (long long)w * d + col) : 0.f;
      }
#pragma unroll
    for (int u = 0; u < kCols; ++u) {
      const int col = col0 + u * (int)blockDim.x;
      float t = 0.f;  // a class past `classes` adds 0.f: no change
#pragma unroll
      for (int w = 0; w < kGroups; ++w) t += v[w][u];
      if (col < d) dscale[col] = from_f<S>(t);
    }
  }
  if (threadIdx.x == 0) counters[kGroups] = 0;
}

template <typename T, typename S, int VPL, int MODE, bool GATE, int NT>
__global__ void __launch_bounds__(NT, 2 * kThreads / NT)
rmsnorm_bwd_vec(const T* __restrict__ x, const T* __restrict__ z,
                const T* __restrict__ g, const S* __restrict__ scale,
                T* __restrict__ dx, T* __restrict__ dz,
                S* __restrict__ dscale, float* __restrict__ part,
                long long rows, int d, long long x_stride, long long z_stride,
                bool zvec, long long g_stride, float eps, int tpr,
                const float* __restrict__ ss_in, float* __restrict__ dot_io,
                int d_norm, int* __restrict__ counters) {
  constexpr int kV = 16 / sizeof(T);
  constexpr int kE = VPL * kV;  // columns a thread owns
  typedef Vec<kV * sizeof(S)> SV;
  __shared__ float red[2][NT / 32];
  __shared__ float buf[kE][NT / 2];
  const int nv = d / kV;
  const int slots = NT / tpr;
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
    uint4 zv[VPL];       // GATE: z, then s = silu(z) in x's type
    float yd[VPL][kV];   // GATE: y * silu'(z) = y * sig * (1 + z * (1 - sig))
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      const int i = lane + k * tpr;
      const bool ok = live && i < nv;
      xv[k] = ok ? reinterpret_cast<const uint4*>(x + row * x_stride)[i]
                 : make_uint4(0u, 0u, 0u, 0u);
      gv[k] = ok ? reinterpret_cast<const uint4*>(g + row * g_stride)[i]
                 : make_uint4(0u, 0u, 0u, 0u);
      if constexpr (GATE)
        zv[k] = ok ? load_z(z + row * z_stride, i, zvec)
                   : make_uint4(0u, 0u, 0u, 0u);
    }
    if constexpr (GATE) {  // y -> v, z -> s (zeros give zeros)
#pragma unroll
      for (int k = 0; k < VPL; ++k) {
        T* ey = reinterpret_cast<T*>(&xv[k]);
        T* ez = reinterpret_cast<T*>(&zv[k]);
#pragma unroll
        for (int j = 0; j < kV; ++j) {
          const float y = to_f(ey[j]), zf = to_f(ez[j]);
          const float sig = sigmoid(zf);
          const T s = from_f<T>(zf * sig);
          ey[j] = from_f<T>(y * to_f(s));
          ez[j] = s;
          yd[k][j] = y * (sig * (1.f + zf * (1.f - sig)));
        }
      }
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
      const T* esu = reinterpret_cast<const T*>(&zv[k]);
      uint4 w, wz;
      T* o = reinterpret_cast<T*>(&w);
      T* oz = reinterpret_cast<T*>(&wz);
#pragma unroll
      for (int j = 0; j < kV; ++j) {
        const float gf = to_f(eg[j]);
        if constexpr (GATE) {  // dv in fp32, through v = y * s
          const float xf = to_f(ex[j]);
          const float dv = r * (gf * to_f(es[j])) - xf * c;
          o[j] = from_f<T>(dv * to_f(esu[j]));
          oz[j] = from_f<T>(dv * yd[k][j]);
          ds[k][j] += gf * (xf * r);
        } else {
          const float xf = to_f(ex[j]);
          o[j] = from_f<T>(r * (gf * to_f(es[j])) - xf * c);
          ds[k][j] += gf * (xf * r);  // 0 for a row past the end (g = 0)
        }
      }
      if (live && i < nv) {
        reinterpret_cast<uint4*>(dx + row * (long long)d)[i] = w;
        if constexpr (GATE)
          reinterpret_cast<uint4*>(dz + row * (long long)d)[i] = wz;
      }
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
  if (counters) fold_dscale<S>(part, dscale, d, counters);  // uniform
}

template <typename T, typename S, int MODE, bool GATE>
__global__ void __launch_bounds__(kThreads)
rmsnorm_bwd_scalar(const T* __restrict__ x, const T* __restrict__ z,
                   const T* __restrict__ g, const S* __restrict__ scale,
                   T* __restrict__ dx, T* __restrict__ dz,
                   S* __restrict__ dscale, float* __restrict__ part,
                   long long rows, int d, long long x_stride,
                   long long z_stride, long long g_stride, float eps,
                   const float* __restrict__ ss_in, float* __restrict__ dot_io,
                   int d_norm, int* __restrict__ counters) {
  __shared__ float red[2][kThreads / 32];
  float* prow = part + (long long)blockIdx.x * d;
  if (MODE != kDotBwd)
    for (int i = threadIdx.x; i < d; i += kThreads) prow[i] = 0.f;
  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    const T* xr = x + row * x_stride;
    const T* zr = GATE ? z + row * z_stride : nullptr;
    const T* gr = g + row * g_stride;
    auto val = [&](int i) {  // x, or gated v
      if constexpr (GATE) return to_f(gate(xr[i], zr[i]));
      else return to_f(xr[i]);
    };
    float ss = 0.f, sd = 0.f;
    if (MODE == kSplitBwd) {
      ss = ss_in[row];
      sd = dot_io[row];
    } else {
      for (int i = threadIdx.x; i < d; i += kThreads) {
        const float xf = val(i);
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
      const float gf = to_f(gr[i]);
      if constexpr (GATE) {
        const float y = to_f(xr[i]), zf = to_f(zr[i]);
        const float sig = sigmoid(zf), s = to_f(from_f<T>(zf * sig));
        const float xf = to_f(from_f<T>(y * s));
        const float dv = r * (gf * to_f(scale[i])) - xf * c;
        drow[i] = from_f<T>(dv * s);
        dz[row * (long long)d + i] =
            from_f<T>(dv * (y * (sig * (1.f + zf * (1.f - sig)))));
        prow[i] += gf * (xf * r);
      } else {
        const float xf = to_f(xr[i]);
        drow[i] = from_f<T>(r * (gf * to_f(scale[i])) - xf * c);
        prow[i] += gf * (xf * r);
      }
    }
  }
  if (MODE != kDotBwd && counters) fold_dscale<S>(part, dscale, d, counters);
}

// A backward launch's arguments: `z`, `dz` the gate and its gradient
// (nullptr: none); `ss` the split row's summed squares (kSplitBwd), `dot`
// its local (kDotBwd, written) or summed (kSplitBwd, read) sum of gs * x,
// `d_norm` the width the sums are divided by (d for a whole row);
// `counters` (9 int32 zeros) folds dscale's sum into the kernel, nullptr
// launches `rmsnorm_dscale_sum` after it.
struct BwdArgs {
  const void* x;
  const void* z;
  const void* g;
  const void* scale;
  void* dx;
  void* dz;
  void* dscale;
  float* part;
  int max_parts;
  long long rows;
  int d;
  long long x_stride, z_stride, g_stride;
  float eps;
  const float* ss;
  float* dot;
  int d_norm;
  int* counters;
};

template <typename T, typename S, int VPL, int MODE, bool GATE, int NT>
void launch_bwd_vec(const BwdArgs& a, int parts, int tpr, cudaStream_t st) {
  rmsnorm_bwd_vec<T, S, VPL, MODE, GATE, NT><<<parts, NT, 0, st>>>(
      (const T*)a.x, (const T*)a.z, (const T*)a.g, (const S*)a.scale,
      (T*)a.dx, (T*)a.dz, (S*)a.dscale, a.part, a.rows, a.d, a.x_stride,
      a.z_stride, zvec(a.z, a.z_stride, 16 / sizeof(T)), a.g_stride, a.eps,
      tpr, a.ss, a.dot, a.d_norm, a.counters);
  ++launched;
}

template <typename T, typename S, int MODE, bool GATE>
int launch_bwd(const BwdArgs& a, cudaStream_t st) {
  constexpr int kV = 16 / sizeof(T);
  // threads a block of the vector kernel: the gated and split entries fold
  // dscale's sum into their last launch, and 512 threads (one block an SM)
  // halve the partial rows that the fold's last blocks add
  constexpr int NT = GATE || MODE != kWholeBwd ? 2 * kThreads : kThreads;
  // vectors a thread holds at most (the gate's registers; 512 threads' share
  // of shared memory); wider rows take the scalar kernel
  constexpr int kCap = GATE || NT > kThreads ? kGateMaxVpl : kMaxVpl;
  const int nv = a.d / kV;
  const bool vec = a.d % kV == 0 && a.x_stride % kV == 0 &&
                   a.g_stride % kV == 0 && nv <= kCap * NT &&
                   aligned(a.x) && aligned(a.g) && aligned(a.scale) &&
                   aligned(a.dx) && aligned(a.part) && aligned(a.dz);
  int parts;
  if (!vec) {
    parts = (int)(a.rows < a.max_parts ? a.rows : a.max_parts);
    rmsnorm_bwd_scalar<T, S, MODE, GATE><<<parts, kThreads, 0, st>>>(
        (const T*)a.x, (const T*)a.z, (const T*)a.g, (const S*)a.scale,
        (T*)a.dx, (T*)a.dz, (S*)a.dscale, a.part, a.rows, a.d, a.x_stride,
        a.z_stride, a.g_stride, a.eps, a.ss, a.dot, a.d_norm, a.counters);
    ++launched;
  } else {
    int tpr = 32;
    while (nv > kTargetVpl * tpr && tpr < NT) tpr *= 2;
    const int vpl = (nv + tpr - 1) / tpr;
    const long long slots = NT / tpr;
    const long long need = (a.rows + slots - 1) / slots;
    const long long cap = (long long)a.max_parts * kThreads / NT;  // blocks of kThreads
    parts = (int)(need < cap ? need : (cap > 0 ? cap : 1));
    switch (vpl) {
      case 1: launch_bwd_vec<T, S, 1, MODE, GATE, NT>(a, parts, tpr, st); break;
      case 2: launch_bwd_vec<T, S, 2, MODE, GATE, NT>(a, parts, tpr, st); break;
      case 3: launch_bwd_vec<T, S, 3, MODE, GATE, NT>(a, parts, tpr, st); break;
      default:
        if constexpr (kCap == 4) {
          launch_bwd_vec<T, S, 4, MODE, GATE, NT>(a, parts, tpr, st);
        } else {
          switch (vpl) {
            case 4: launch_bwd_vec<T, S, 4, MODE, GATE, NT>(a, parts, tpr, st); break;
            case 5: launch_bwd_vec<T, S, 5, MODE, GATE, NT>(a, parts, tpr, st); break;
            case 6: launch_bwd_vec<T, S, 6, MODE, GATE, NT>(a, parts, tpr, st); break;
            case 7: launch_bwd_vec<T, S, 7, MODE, GATE, NT>(a, parts, tpr, st); break;
            default: launch_bwd_vec<T, S, 8, MODE, GATE, NT>(a, parts, tpr, st); break;
          }
        }
    }
  }
  int code = (int)cudaGetLastError();
  if (code != 0 || MODE == kDotBwd || a.counters) return code;
  rmsnorm_dscale_sum<S><<<(a.d + kSumCols - 1) / kSumCols, kThreads, 0, st>>>(
      a.part, (S*)a.dscale, parts, a.d);
  ++launched;
  return (int)cudaGetLastError();
}

template <int MODE>
int dispatch_bwd(const BwdArgs& a, int x_dtype, int scale_dtype,
                 cudaStream_t s) {
  if (a.rows == 0 || a.d == 0 || a.max_parts < 1)
    return (int)cudaErrorInvalidValue;
  return by_types(x_dtype, scale_dtype, a.z != nullptr,
                  [&](auto t, auto sc, auto g) {
                    return launch_bwd<typename decltype(t)::type,
                                      typename decltype(sc)::type, MODE,
                                      decltype(g)::value>(a, s);
                  });
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16.  `out` is (rows, d) contiguous;
// row i of x starts at x + i * x_stride elements.  `z` (x's type, row i
// at z + i * z_stride), or nullptr: the norm of v = x * silu(z) (the gated
// norm) instead of x.
int rmsnorm_fwd(const void* x, const void* z, const void* scale, void* out,
                long long rows, int d, long long x_stride, long long z_stride,
                float eps, int x_dtype, int scale_dtype, void* stream) {
  if (rows == 0) return 0;
  return dispatch_fwd<kNorm>(
      FwdArgs{x, z, scale, out, rows, d, x_stride, z_stride, eps, nullptr, d},
      x_dtype, scale_dtype, (cudaStream_t)stream);
}

// A row split over ranks, pass 1: ss[i] = the fp32 sum of squares of this
// rank's d columns of row i (ss: rows floats), of v where z is given.
int rmsnorm_sumsq(const void* x, const void* z, float* ss, long long rows,
                  int d, long long x_stride, long long z_stride, int x_dtype,
                  void* stream) {
  if (rows == 0) return 0;
  return dispatch_fwd<kSumSq>(
      FwdArgs{x, z, nullptr, nullptr, rows, d, x_stride, z_stride, 0.f, ss, d},
      x_dtype, x_dtype, (cudaStream_t)stream);
}

// Pass 2, after the caller has summed ss over the ranks: out = x (or v) *
// rsqrt(ss[i] / d_total + eps) * scale in fp32, cast to x's type; scale is
// this rank's d entries of the weight.
int rmsnorm_apply(const void* x, const void* z, const void* scale,
                  const float* ss, void* out, long long rows, int d,
                  long long x_stride, long long z_stride, int d_total,
                  float eps, int x_dtype, int scale_dtype, void* stream) {
  if (rows == 0) return 0;
  float* io = const_cast<float*>(ss);  // read only in kApply
  return dispatch_fwd<kApply>(
      FwdArgs{x, z, scale, out, rows, d, x_stride, z_stride, eps, io, d_total},
      x_dtype, scale_dtype, (cudaStream_t)stream);
}

// Backward.  dtype codes as above; g has x's type, dx (and dz, where z is
// given) is (rows, d) contiguous in x's type, dscale (d,) in the scale's
// type.  `part` is fp32 scratch of at least (max_parts + 8) x d floats
// (one partial row per block of the first kernel, then the class sums;
// max_parts >= 1).  `counters`: 9 int32 zeros on the device, left zero,
// to fold dscale's sum into the kernel (one launch), or nullptr (a second
// launch adds the partial rows).
int rmsnorm_bwd(const void* x, const void* z, const void* g,
                const void* scale, void* dx, void* dz, void* dscale,
                void* part, int* counters, int max_parts, long long rows,
                int d, long long x_stride, long long z_stride,
                long long g_stride, float eps, int x_dtype, int scale_dtype,
                void* stream) {
  return dispatch_bwd<kWholeBwd>(
      BwdArgs{x, z, g, scale, dx, dz, dscale, (float*)part, max_parts, rows,
              d, x_stride, z_stride, g_stride, eps, nullptr, nullptr, d,
              counters},
      x_dtype, scale_dtype, (cudaStream_t)stream);
}

// The split row's backward, pass 1: dot[i] = the fp32 sum over this rank's
// d columns of row i of g * scale * x (or v, where z is given; dot: rows
// floats).
int rmsnorm_split_dot(const void* x, const void* z, const void* g,
                      const void* scale, float* dot, int max_parts,
                      long long rows, int d, long long x_stride,
                      long long z_stride, long long g_stride, int x_dtype,
                      int scale_dtype, void* stream) {
  return dispatch_bwd<kDotBwd>(
      BwdArgs{x, z, g, scale, nullptr, nullptr, nullptr, nullptr, max_parts,
              rows, d, x_stride, z_stride, g_stride, 0.f, nullptr, dot, d,
              nullptr},
      x_dtype, scale_dtype, (cudaStream_t)stream);
}

// Pass 2, after the caller has summed dot over the ranks: dx (dz) and
// dscale (this rank's d entries) as rmsnorm_bwd writes them, with the row
// sums ss (the forward's squares, summed) and dot over rows d_total wide.
int rmsnorm_split_bwd(const void* x, const void* z, const void* g,
                      const void* scale, const float* ss, const float* dot,
                      void* dx, void* dz, void* dscale, void* part,
                      int* counters, int max_parts, long long rows, int d,
                      long long x_stride, long long z_stride,
                      long long g_stride, int d_total, float eps, int x_dtype,
                      int scale_dtype, void* stream) {
  return dispatch_bwd<kSplitBwd>(
      BwdArgs{x, z, g, scale, dx, dz, dscale, (float*)part, max_parts, rows,
              d, x_stride, z_stride, g_stride, eps, ss,
              const_cast<float*>(dot), d_total, counters},
      x_dtype, scale_dtype, (cudaStream_t)stream);
}

// Kernels this library has launched since it was loaded: the host's count
// of its `<<<...>>>` launches, which tests read around a call.
long long rmsnorm_kernels_launched() { return launched.load(); }

const char* error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
