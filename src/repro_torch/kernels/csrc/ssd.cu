// Mamba2 SSD chunked scan for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel `ssd_kernel` / `_kernel` in
// src/repro/kernels/ssd/ssd.py.  y = SSD(x, dt, A, B, C) for one B/C group:
// within a chunk, y_diag[i] = sum_{j<=i} (C_i.B_j) exp(cum_i - cum_j) dt_j x_j
// and y_off[i] = exp(cum_i) C_i . state; then
// state <- exp(cum_last) state + sum_j exp(cum_last - cum_j) dt_j x_j B_j^T.
// The state and all sums are fp32; y is cast to x's type.  The decay is
// masked before exp (the TPU kernel exponentiates first, which overflows to
// inf for steep decays and then gives inf*0 = NaN), and a ragged last chunk
// is masked by index: nothing is padded.  One C entry point, two routes by
// dtype.
//
// bfloat16 (every serving path): tensor cores, `tc::` below.
//   Bound on an H100: bytes.  x, B, C read once, y written once, dt and A
//   fp32: 27.66 MB at mamba2-130m's prefill (b=4, L=1024, H=24, P=64,
//   N=128), 8.26 us at 3.35 TB/s; 43.12 MB at zamba2-2.7b's (b=2, L=1024,
//   H=80, P=64, N=64), 12.87 us.  The products are ~7 GFLOP, ~7 us at the
//   bf16 rate, and the split below doubles the tensor-core work.
//   Passes (one C call: 3 launches when L > 128, 1 when L <= 128), over
//   chunks of 128 rows:
//   1. chunk_state, grid (H, chunks - 1, b), mma.sync m16n8k16: each
//      chunk's own state sum_j x_j (w_j B_j)^T, w_j = exp(cum_last -
//      cum_j) dt_j, fp32, into a (b, chunks - 1, H, P, N) scratch that the
//      wrapper allocates, and the chunk's total decay cum_last.  x^T and
//      the split w.B come by ldmatrix.trans; the last chunk's state is
//      never needed.
//   2. state_pass, grid (P.N / 1024, H, b): in order over the chunks,
//      elementwise fp32, in place: slot c becomes the state before chunk
//      c + 1.
//   3. chunk_out, grid (head groups, chunks, b), two warpgroups of 64 rows,
//      wgmma: C.B^T once per (b, chunk) for a group of up to 8 heads (sized
//      so that the grid holds about two blocks per SM), kept in the
//      accumulators; per head the gate in registers, then
//      y = G.x + diag(exp cum) C.S^T in one wgmma group.  The gate's
//      blocks below the diagonal are exp(cum_i - cum_e) exp(cum_e - cum_j),
//      cum_e the end of j's 16-row block: both exponents <= 0, and the
//      column factor is computed once per head.  The next head's x and S
//      are copied in (cp.async) while this head's products run.
//   The state tensor costs b.(L/128 - 1).H.P.N.4 bytes: 22 MB at mamba2's
//   shape, 18 MB at zamba2's, both within the 50 MB L2.
//   Split: products of two exact bf16 inputs go straight in (C.B^T).
//   Every operand derived in fp32 is split, v = hi + lo with hi = bf16(v),
//   lo = bf16(v - hi), and takes two MMAs against the exact bf16 operand:
//   the gate G (dt folded in, so x stays exact), w.B in the state (against
//   x), and the carried state in C.S^T.  Rounding those operands to plain
//   bf16 fails SSD_TOL at mamba2's shape (the gate, x.dt and the state each
//   lose 2^-9); the split keeps 16 bits.  TF32 would also pass, with less
//   margin.  kernels/ssd/ref.py: ssd_tc_plain is this arithmetic in PyTorch.
//   Loads: cp.async 16 B straight from the strided views (row strides and
//   offsets of the model's split conv output are 16-byte multiples; the
//   wrapper copies any view that is not), rows past L zero-filled; pass 3's
//   tiles are 128B-swizzled for wgmma, pass 1's padded for ldmatrix.
//   Where the time goes (builds with clock64 timers, and the SASS, on an
//   H100): every pass is latency-bound, not bound by the tensor cores.
//   Pass 3 runs one block of 8 warps per SM (C.B^T, the gate fragments
//   and the two accumulators take ~245 registers), and its products are a
//   small part of each head's time next to phases all warps run in
//   lockstep (state split, gate, stores, barriers); moving the products
//   from mma.sync to wgmma, factoring the gate and moving the copies
//   behind the products each changed its time little.  Pass 1 runs two
//   blocks per SM, each a chain of load, split, MMA and store.
//   Left on the table: warp specialisation (a producer warpgroup that
//   loads and splits the next head's state while the consumers compute);
//   wgmma in pass 1; the state scratch's round trip through L2.  Tried and
//   slower: the state passing fused into pass 1 (one block per (b, head)
//   walking the chunks in order: 96 blocks, each a serial chain), and
//   pass-3 blocks of one warpgroup (64 rows, two to an SM: each loads the
//   whole state and x, doubling that traffic).
//
// float32 (parity checks only): `scalar::`, the port's first SSD kernel.
// One block per (head, batch row) loops over 64-row tiles in order with its
// (P, N) fp32 state in shared memory; scalar FMAs in 4x4 register tiles.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace scalar {

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


int launch(const void* x, const float* dt, const float* A, const void* Bm,
           const void* Cm, void* y, int batch, int L, int H, int P, int N,
           const long long* s, cudaStream_t stream) {
  const size_t bytes = (size_t)smem_floats(N, P) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      ssd_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)H, (unsigned)batch);
  ssd_kernel<float><<<grid, kThreads, bytes, stream>>>(
      (const float*)x, dt, A, (const float*)Bm, (const float*)Cm, (float*)y, L,
      H, P, N, s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9]);
  return (int)cudaGetLastError();
}

}  // namespace scalar
// ---------------------------------------------------------------------------
// bf16: the tensor-core route.  Three passes over 128-row chunks.
// ---------------------------------------------------------------------------
namespace tc {

typedef __nv_bfloat16 bf16;

constexpr int kQ = 128;            // rows of a chunk, in every pass
constexpr int kWarps = 8;          // pass 3: warp w owns rows 16w .. 16w+15
constexpr int kThreads = 32 * kWarps;
constexpr int kPad = 8;            // bf16 of padding per shared row (16 bytes),
                                   // so the 8 rows of an ldmatrix hit 8 bank groups

__host__ __device__ constexpr int state_smem(int P, int N) {
  return kQ * (P + kPad) * 2 + 2 * kQ * (N + kPad) * 2 + 2 * kQ * 4;
}
__host__ __device__ constexpr int out_smem(int P, int N) {
  return 1024 + 2 * ((N + 63) / 64) * kQ * 128 + 2 * kQ * 128 + P * N * 4 +
         8 * kQ * 4;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; !valid zero-fills (reads nothing)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a (16x16, row) . b (16x8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}
__device__ __forceinline__ float2 unpack(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
}
// (a, b) = hi + lo, each a bf16 pair: hi = bf16(v), lo = bf16(v - hi).  The
// pair keeps 16 significant bits, so a product against an exact bf16 operand
// in two MMAs loses at most ~2^-16 of the fp32 operand.
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 f = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(a - f.x, b - f.y));
}

// One warp: cum = inclusive cumsum of dt A over the chunk's 128 rows (4 a
// lane), dts = dt; rows past L have dt = 0, so cum stays flat there.
// `chunk_dt` loads a lane's 4 dt, `chunk_scan` scans them.
__device__ __forceinline__ void chunk_dt(const float* dtp, long long dt_sl,
                                         int q, float (&d)[4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = 4 * lane + r;
    d[r] = row < q ? dtp[(long long)row * dt_sl] : 0.f;
  }
}
__device__ __forceinline__ void chunk_scan(const float (&d)[4], float a,
                                           float* cum, float* dts) {
  const int lane = threadIdx.x & 31;
  float s[4], run = 0.f;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    run += d[r] * a;
    s[r] = run;
  }
  float incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.f;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    cum[4 * lane + r] = excl + s[r];
    dts[4 * lane + r] = d[r];
  }
  __syncwarp();
}
__device__ __forceinline__ void chunk_cumsum(const float* dtp, long long dt_sl,
                                             int q, float a, float* cum,
                                             float* dts) {
  float d[4];
  chunk_dt(dtp, dt_sl, q, d);
  chunk_scan(d, a, cum, dts);
}

// Stage `rows` (kQ) rows of `cols` bf16 from a strided source; rows >= q
// are zero-filled.
template <int COLS>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src,
                                           long long row_stride, int q) {
  constexpr int V = COLS / 8, S = COLS + kPad;
  for (int i = threadIdx.x; i < kQ * V; i += kThreads) {
    const int r = i / V, v = i - r * V;
    const bool in = r < q;
    cp_async16(dst + r * S + 8 * v, src + (in ? r : 0) * row_stride + 8 * v, in);
  }
}

// Pass 1, per (head, chunk, batch row) for chunks 0 .. nc-2: the chunk's own
// state  S_c[p][n] = sum_j x_j[p] (w_j B_j[n]),  w_j = exp(cum_last - cum_j)
// dt_j, and its total decay cum_last.  M = p, N = n, K = j.  x^T by
// ldmatrix.trans (exact bf16); w.B split hi + lo once into shared memory
// (hi over the staged B, in place), both by ldmatrix.trans; two MMAs.
template <int P, int N>
__global__ void __launch_bounds__(kThreads)
chunk_state(const bf16* __restrict__ x, const float* __restrict__ dt,
            const float* __restrict__ A, const bf16* __restrict__ Bm,
            float* __restrict__ states, float* __restrict__ cumlast, int L,
            int H, int nc1, long long x_sb, long long x_sl, long long x_sh,
            long long dt_sb, long long dt_sl, long long dt_sh, long long b_sb,
            long long b_sl) {
  constexpr int XS = P + kPad, BS = N + kPad;
  constexpr int WPM = kWarps / (P / 16);              // warps per m-tile
  constexpr int NT2W = (N / 16) / WPM > 0 ? (N / 16) / WPM : 1;  // 16-col blocks a warp
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);  // [kQ][XS] x of this head
  bf16* bhi = xs + kQ * XS;                  // [kQ][BS] B, then (w.B) hi
  bf16* blo = bhi + kQ * BS;                 // [kQ][BS] (w.B) lo
  float* cum = reinterpret_cast<float*>(blo + kQ * BS);
  float* w = cum + kQ;

  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int t0 = c * kQ, q = min(kQ, L - t0);
  stage_rows<P>(xs, x + b * x_sb + t0 * x_sl + h * x_sh, x_sl, q);
  stage_rows<N>(bhi, Bm + b * b_sb + t0 * b_sl, b_sl, q);
  if (warp == 0) {
    chunk_cumsum(dt + b * dt_sb + t0 * dt_sl + h * dt_sh, dt_sl, q, A[h], cum,
                 w);
    const float last = cum[kQ - 1];
    for (int r = lane; r < kQ; r += 32) w[r] *= expf(last - cum[r]);
    if (lane == 0) cumlast[((long long)b * nc1 + c) * H + h] = last;
  }
  cp_async_wait_all();
  __syncthreads();
  for (int i = threadIdx.x; i < kQ * N / 2; i += kThreads) {
    const int r = i / (N / 2), n = 2 * i - r * N;
    __nv_bfloat162* pb = reinterpret_cast<__nv_bfloat162*>(bhi + r * BS + n);
    const float2 v = __bfloat1622float2(*pb);
    uint32_t hi, lo;
    split2(v.x * w[r], v.y * w[r], hi, lo);
    *reinterpret_cast<uint32_t*>(pb) = hi;
    *reinterpret_cast<uint32_t*>(blo + r * BS + n) = lo;
  }
  __syncthreads();

  const int mt = warp / WPM, nt0 = (warp % WPM) * NT2W;
  if (nt0 >= N / 16) return;
  float acc[NT2W][2][4] = {};
#pragma unroll
  for (int kk = 0; kk < kQ / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4_t(a, xs + (kk * 16 + (lane & 7) + ((lane >> 4) << 3)) * XS +
                     mt * 16 + (((lane >> 3) & 1) << 3));
    const int brow = (kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3)) * BS;
#pragma unroll
    for (int k = 0; k < NT2W; ++k) {
      const int col = (nt0 + k) * 16 + ((lane >> 4) << 3);
      uint32_t bh[4], bl[4];
      ldsm_x4_t(bh, bhi + brow + col);
      ldsm_x4_t(bl, blo + brow + col);
      mma(acc[k][0], a, bh[0], bh[1]);
      mma(acc[k][0], a, bl[0], bl[1]);
      mma(acc[k][1], a, bh[2], bh[3]);
      mma(acc[k][1], a, bl[2], bl[3]);
    }
  }
  float* st = states + (((long long)b * nc1 + c) * H + h) * (P * N);
#pragma unroll
  for (int k = 0; k < NT2W; ++k)
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int p = mt * 16 + g, n = (nt0 + k) * 16 + 8 * s + 2 * t;
      *reinterpret_cast<float2*>(st + p * N + n) =
          make_float2(acc[k][s][0], acc[k][s][1]);
      *reinterpret_cast<float2*>(st + (p + 8) * N + n) =
          make_float2(acc[k][s][2], acc[k][s][3]);
    }
}

// Pass 2, per (slice of P.N, head, batch row): in order over the chunks,
// carry <- exp(cum_last_c) carry + S_c, written back in place, so slot c
// ends holding the state before chunk c + 1.  fp32, elementwise.
__global__ void __launch_bounds__(kThreads)
state_pass(float* __restrict__ states, const float* __restrict__ cumlast,
           int H, int nc1, int pn4) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  if (i >= pn4) return;
  float4 carry = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = 0; c < nc1; ++c) {
    const long long slot = ((long long)b * nc1 + c) * H + h;
    float4* p = reinterpret_cast<float4*>(states + slot * 4 * pn4) + i;
    const float4 loc = *p;
    const float d = expf(cumlast[slot]);
    carry = make_float4(fmaf(d, carry.x, loc.x), fmaf(d, carry.y, loc.y),
                        fmaf(d, carry.z, loc.z), fmaf(d, carry.w, loc.w));
    *p = carry;
  }
}

// wgmma shared-memory descriptor, 128B swizzle: 8-row groups 1024 bytes
// apart (SBO); `lbo` is the stride between 64-column blocks of an MN-major
// operand (unused for K-major).
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// Pins registers an async wgmma reads or writes to this point of the
// program, so the compiler moves no access to them across a fence or wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// `x` from lane 0: a value the compiler knows is the same across the warp,
// so branches on it are not divergent (wgmma under a divergent branch is
// serialised).
__device__ __forceinline__ int warp_uniform(int x) {
  return __shfl_sync(0xffffffffu, x, 0);
}

// S (+)= A . B^T, m64 x N x k16, A and B K-major in shared memory.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d);
// O += P . V, m64 x N x k16, P from registers, V MN-major in shared memory.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint64_t db, int scale_d);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], uint32_t a0, uint32_t a1,
                                             uint32_t a2, uint32_t a3, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db),
        "r"(scale_d));
}


template <bool V> struct BoolC { static constexpr bool value = V; };

__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Byte offset of 16-byte chunk `c` (0..7) of row `r` in a tile of 128-byte
// rows under the 128B swizzle (chunk c of row r sits at c ^ (r mod 8)).
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (uint32_t)(r * 128 + ((c ^ (r & 7)) << 4));
}

// Stage kQ rows of COLS bf16 (strided source) into a tile of 64-column
// blocks (kQ x 128 bytes each, 128B-swizzled), asynchronously; rows >= q
// and columns >= COLS are zero-filled, and so is everything when `on` is
// false (nothing is read).  Unrolled (kQ * V is a multiple of the block),
// so it adds no branch while a wgmma is in flight.
template <int COLS>
__device__ __forceinline__ void stage_swz(unsigned char* dst, const bf16* src,
                                          long long row_stride, int q,
                                          bool on) {
  constexpr int NB = (COLS + 63) / 64, V = NB * 8;
  static_assert((kQ * V) % kThreads == 0, "whole rounds of the block");
#pragma unroll
  for (int k = 0; k < kQ * V / kThreads; ++k) {
    const int i = threadIdx.x + k * kThreads;
    const int r = i / V, c = i - r * V;
    const bool in = on && r < q && c < COLS / 8;
    cp_async16(dst + (c >> 3) * (kQ * 128) + swz(r, c & 7),
               src + (in ? r * row_stride + 8 * c : 0), in);
  }
}

// Pass 3, per (group of hg heads, chunk, batch row), two warpgroups: rows
// 0..63 and 64..127 of the chunk (wgmma M = 64; warp w owns rows 16w..).
// C.B^T once for the chunk: wgmma m64n128, A = C and B = B K-major in
// shared memory, kept in the accumulators.  Then for each head
//   y = diag(exp cum) C.S^T  +  G.x,   G[i][j] = (C.B^T)[i][j]
//       exp(cum_i - cum_j) dt_j  (j <= i; masked before exp),
// C.S^T by wgmma with S (fp32, from pass 2) split hi + lo into shared
// memory as two K-major B tiles; G split hi + lo in registers (the
// accumulator layout of C.B^T is wgmma's A-fragment layout) against x,
// MN-major in shared memory.  The next head's x and S are copied in
// (cp.async) while this head's products run, and warp 0 scans the next
// head's dt after them.  P < 64 pads the p columns (they are never
// stored); N < 64 pads the n columns (never read).
template <int P, int N>
__global__ void __launch_bounds__(kThreads, 1)
chunk_out(const bf16* __restrict__ x, const float* __restrict__ dt,
          const float* __restrict__ A, const bf16* __restrict__ Bm,
          const bf16* __restrict__ Cm, const float* __restrict__ states,
          bf16* __restrict__ y, int L, int H, int nc1, int hg, long long x_sb,
          long long x_sl, long long x_sh, long long dt_sb, long long dt_sl,
          long long dt_sh, long long b_sb, long long b_sl, long long c_sb,
          long long c_sl) {
  constexpr int NB = (N + 63) / 64;          // 64-column blocks of n
  constexpr int CT = NB * kQ * 128;          // bytes of the C (and B) tile
  constexpr int ST = NB * 64 * 128;          // bytes of one S tile (64 rows of p)
  constexpr int XT = kQ * 128;               // bytes of one x tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  unsigned char* cs = sm;                    // C [i][n]
  unsigned char* us = cs + CT;               // B [j][n], then S hi, S lo [p][n]
  unsigned char* xbuf = us + CT;             // 2 x x [j][p]
  float* sf = reinterpret_cast<float*>(xbuf + 2 * XT);  // [P * N] S, fp32
  float* cbuf = sf + P * N;                  // 2 x (cum, dts, ecum, fcol) [kQ] each
  const uint32_t cs_a = smem_u32(cs), us_a = smem_u32(us);
  const uint32_t xbuf_a = smem_u32(xbuf);

  const int c = blockIdx.y, b = blockIdx.z;
  const int h0 = blockIdx.x * hg, h1 = min(H, h0 + hg);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wg = warp_uniform(warp >> 2);
  const int g = lane >> 2, t = lane & 3;
  const int t0 = c * kQ, q = min(kQ, L - t0);
  const int iA = 16 * warp + g, iB = iA + 8;
  const float* st0 = states + ((long long)b * nc1 + c - 1) * H * (P * N);
  const float* dtb = dt + b * dt_sb + t0 * dt_sl;

  // x and S of head h into buffer `buf` and sf, asynchronously; `on` false
  // issues the same copies as zero-fills that read nothing
  auto fetch = [&](int h, int buf, bool on, auto hs) {
    stage_swz<P>(xbuf + buf * XT, x + b * x_sb + t0 * x_sl + h * x_sh, x_sl,
                 q, on);
    if (decltype(hs)::value) {
      const float* st = st0 + (long long)h * (P * N);
      constexpr int kS = (P * N / 4 + kThreads - 1) / kThreads;
#pragma unroll
      for (int k = 0; k < kS; ++k) {
        const int i = threadIdx.x + k * kThreads;
        const bool in = i < P * N / 4;
        cp_async16(sf + 4 * (in ? i : 0), st + 4 * (in ? i : 0), on && in);
      }
    }
  };
  // cum, dts, ecum = exp(cum) and the gate's column factors
  // fcol_j = exp(cum_e - cum_j) dt_j, cum_e the cum at the end of j's
  // 16-row block (so the exponent is <= 0), from a lane's 4 dt (warp 0)
  auto scan = [&](const float (&d)[4], int h, float* cb4) {
    chunk_scan(d, A[h], cb4, cb4 + kQ);
    for (int r = lane; r < kQ; r += 32) {
      const float cr = cb4[r];
      cb4[2 * kQ + r] = expf(cr);
      cb4[3 * kQ + r] = expf(cb4[(r | 15)] - cr) * cb4[kQ + r];
    }
    __syncwarp();
  };

  stage_swz<N>(cs, Cm + b * c_sb + t0 * c_sl, c_sl, q, true);
  stage_swz<N>(us, Bm + b * b_sb + t0 * b_sl, b_sl, q, true);
  if (c > 0)
    fetch(h0, 0, true, BoolC<true>());
  else
    fetch(h0, 0, true, BoolC<false>());
  if (warp == 0) {
    float d[4];
    chunk_dt(dtb + h0 * dt_sh, dt_sl, q, d);
    scan(d, h0, cbuf);
  }
  cp_async_wait_all();
  fence_async_smem();
  __syncthreads();

  // cb: C.B^T rows of this warpgroup, all 128 columns; register 4 jb + r
  // holds row iA (r = 0, 1) or iB (r = 2, 3), column 8 jb + 2t + (r & 1)
  float cb[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) cb[i] = 0.f;
  fence_regs(cb);
  wg_fence();
#pragma unroll
  for (int kn = 0; kn < N / 16; ++kn) {
    const uint32_t off = (kn >> 2) * (kQ * 128) + (kn & 3) * 32;
    wgmma_ss<128>(cb, gmma_desc(cs_a + off + wg * 64 * 128, 16),
                  gmma_desc(us_a + off, 16), 1);
  }
  wg_commit();
  wg_wait<0>();
  fence_regs(cb);
  __syncthreads();  // B is done with: us takes the state

  // the heads, with (HS) or without a carried state (chunk 0); one loop
  // each, so no branch joins while a wgmma is in flight
  auto heads = [&](auto hs) {
    constexpr bool HS = decltype(hs)::value;
    for (int h = h0; h < h1; ++h) {
      const int buf = (h - h0) & 1;
      const uint32_t xs_a = xbuf_a + buf * XT;
      const float* cum = cbuf + buf * (4 * kQ);
      const float* dts = cum + kQ;
      const float* ecum = dts + kQ;
      const float* fcol = ecum + kQ;
      if (HS) {  // split the state: sf -> S hi, S lo (K-major, swizzled)
        for (int i = threadIdx.x; i < P * N / 4; i += kThreads) {
          const float4 v = reinterpret_cast<const float4*>(sf)[i];
          const int p = (4 * i) / N, n = 4 * i - p * N;
          const uint32_t o = (n >> 6) * (64 * 128) + swz(p, (n & 63) >> 3) +
                             (n & 7) * 2;
          uint32_t h01, l01, h23, l23;
          split2(v.x, v.y, h01, l01);
          split2(v.z, v.w, h23, l23);
          *reinterpret_cast<uint2*>(us + o) = make_uint2(h01, h23);
          *reinterpret_cast<uint2*>(us + ST + o) = make_uint2(l01, l23);
        }
        fence_async_smem();
        __syncthreads();
      }
      const bool next = h + 1 < h1;
      const int hn = next ? h + 1 : h;

      // the gate of this warp's rows (iA, iB: both in row block `warp`),
      // split, as A fragments, by 16-column blocks kt: below the diagonal
      // block (C.B^T) exp(cum_i - cum_e) fcol_j, on it (C.B^T)
      // exp(cum_i - cum_j) dt_j masked before exp, above it zero
      uint32_t ghi[kQ / 16][4], glo[kQ / 16][4];
      const float cA = cum[iA], cB = cum[iB];
#pragma unroll
      for (int kt = 0; kt < kQ / 16; ++kt) {
        if (kt < warp) {
          const float ce = cum[16 * kt + 15];
          const float eA = __expf(cA - ce), eB = __expf(cB - ce);
#pragma unroll
          for (int s = 0; s < 2; ++s) {
            const int j = kt * 16 + 8 * s + 2 * t;
            const float* v = cb + 4 * (2 * kt + s);
            const float2 f = *reinterpret_cast<const float2*>(fcol + j);
            split2(v[0] * eA * f.x, v[1] * eA * f.y, ghi[kt][2 * s], glo[kt][2 * s]);
            split2(v[2] * eB * f.x, v[3] * eB * f.y, ghi[kt][2 * s + 1],
                   glo[kt][2 * s + 1]);
          }
        } else if (kt == warp) {
#pragma unroll
          for (int s = 0; s < 2; ++s) {
            const int j = kt * 16 + 8 * s + 2 * t;
            const float* v = cb + 4 * (2 * kt + s);
            const float cj0 = cum[j], cj1 = cum[j + 1];
            const float d0 = dts[j], d1 = dts[j + 1];
            const float gA0 = v[0] * (__expf(j <= iA ? cA - cj0 : -INFINITY) * d0);
            const float gA1 = v[1] * (__expf(j + 1 <= iA ? cA - cj1 : -INFINITY) * d1);
            const float gB0 = v[2] * (__expf(j <= iB ? cB - cj0 : -INFINITY) * d0);
            const float gB1 = v[3] * (__expf(j + 1 <= iB ? cB - cj1 : -INFINITY) * d1);
            split2(gA0, gA1, ghi[kt][2 * s], glo[kt][2 * s]);
            split2(gB0, gB1, ghi[kt][2 * s + 1], glo[kt][2 * s + 1]);
          }
        } else {
#pragma unroll
          for (int r = 0; r < 4; ++r) ghi[kt][r] = glo[kt][r] = 0u;
        }
      }

      // one group: yoff = C.S^T (S hi and lo), yacc = G.x (G hi and lo)
      float yacc[32], yoff[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) yacc[i] = yoff[i] = 0.f;
      fence_regs(yacc);
      fence_regs(yoff);
      wg_fence();
      if (HS) {
#pragma unroll
        for (int kn = 0; kn < N / 16; ++kn) {
          const uint32_t ca = cs_a + (kn >> 2) * (kQ * 128) + wg * 64 * 128 +
                              (kn & 3) * 32;
          const uint32_t sa = us_a + (kn >> 2) * (64 * 128) + (kn & 3) * 32;
          wgmma_ss<64>(yoff, gmma_desc(ca, 16), gmma_desc(sa, 16), 1);
          wgmma_ss<64>(yoff, gmma_desc(ca, 16), gmma_desc(sa + ST, 16), 1);
        }
      }
#pragma unroll
      for (int kt = 0; kt < kQ / 16; ++kt) {
        const uint64_t dx = gmma_desc(xs_a + kt * 16 * 128, XT);
        wgmma_rs<64>(yacc, ghi[kt][0], ghi[kt][1], ghi[kt][2], ghi[kt][3], dx, 1);
        wgmma_rs<64>(yacc, glo[kt][0], glo[kt][1], glo[kt][2], glo[kt][3], dx, 1);
      }
      wg_commit();
      // while the products run: the next head's x and S (copies), and its
      // dt (scanned after the wait)
      fetch(hn, buf ^ 1, next, hs);
      float dnext[4];
      chunk_dt(dtb + hn * dt_sh, dt_sl, q, dnext);
      wg_wait<0>();
      fence_regs(yacc);
      fence_regs(yoff);
      if (HS) {
        const float eA = ecum[iA], eB = ecum[iB];
#pragma unroll
        for (int jb = 0; jb < 8; ++jb) {
          yacc[4 * jb] = fmaf(eA, yoff[4 * jb], yacc[4 * jb]);
          yacc[4 * jb + 1] = fmaf(eA, yoff[4 * jb + 1], yacc[4 * jb + 1]);
          yacc[4 * jb + 2] = fmaf(eB, yoff[4 * jb + 2], yacc[4 * jb + 2]);
          yacc[4 * jb + 3] = fmaf(eB, yoff[4 * jb + 3], yacc[4 * jb + 3]);
        }
      }
      if (warp == 0 && next) scan(dnext, h + 1, cbuf + (buf ^ 1) * (4 * kQ));

      bf16* yb = y + (((long long)b * L + t0) * H + h) * P;
      const long long ys = (long long)H * P;
#pragma unroll
      for (int jb = 0; jb < P / 8; ++jb) {
        const int p = jb * 8 + 2 * t;
        if (iA < q)
          *reinterpret_cast<__nv_bfloat162*>(yb + iA * ys + p) =
              __floats2bfloat162_rn(yacc[4 * jb], yacc[4 * jb + 1]);
        if (iB < q)
          *reinterpret_cast<__nv_bfloat162*>(yb + iB * ys + p) =
              __floats2bfloat162_rn(yacc[4 * jb + 2], yacc[4 * jb + 3]);
      }
      cp_async_wait_all();
      fence_async_smem();
      __syncthreads();  // the next head's x, S and cumsum have landed
    }
  };
  if (c > 0)
    heads(BoolC<true>());
  else
    heads(BoolC<false>());
}

int num_sms() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 132;
  }
  return n;
}

template <int P, int N>
int launch(const bf16* x, const float* dt, const float* A, const bf16* Bm,
           const bf16* Cm, bf16* y, int batch, int L, int H,
           const long long* s, float* states, float* cumlast,
           cudaStream_t stream) {
  const int nc = (L + kQ - 1) / kQ, nc1 = nc - 1;
  cudaError_t e;
  if (nc1 > 0) {
    e = cudaFuncSetAttribute(chunk_state<P, N>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             state_smem(P, N));
    if (e != cudaSuccess) return (int)e;
    chunk_state<P, N><<<dim3(H, nc1, batch), kThreads, state_smem(P, N),
                        stream>>>(x, dt, A, Bm, states, cumlast, L, H, nc1,
                                  s[0], s[1], s[2], s[3], s[4], s[5], s[6],
                                  s[7]);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    const int pn4 = P * N / 4;
    state_pass<<<dim3((pn4 + kThreads - 1) / kThreads, H, batch), kThreads, 0,
                 stream>>>(states, cumlast, H, nc1, pn4);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  // heads per pass-3 block: enough blocks for about two per SM, and C.B^T
  // shared by up to 8 heads
  const long long work = (long long)batch * nc * H;
  const int hg = (int)max(1LL, min(8LL, (work + 2LL * num_sms() - 1) /
                                            (2LL * num_sms())));
  e = cudaFuncSetAttribute(chunk_out<P, N>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           out_smem(P, N));
  if (e != cudaSuccess) return (int)e;
  chunk_out<P, N><<<dim3((H + hg - 1) / hg, nc, batch), kThreads,
                    out_smem(P, N), stream>>>(
      x, dt, A, Bm, Cm, states, y, L, H, nc1, hg, s[0], s[1], s[2], s[3],
      s[4], s[5], s[6], s[7], s[8], s[9]);
  return (int)cudaGetLastError();
}

template <int P>
int launch_n(int N, const bf16* x, const float* dt, const float* A,
             const bf16* Bm, const bf16* Cm, bf16* y, int batch, int L, int H,
             const long long* s, float* states, float* cumlast,
             cudaStream_t st) {
  switch (N) {
    case 16: return launch<P, 16>(x, dt, A, Bm, Cm, y, batch, L, H, s, states, cumlast, st);
    case 32: return launch<P, 32>(x, dt, A, Bm, Cm, y, batch, L, H, s, states, cumlast, st);
    case 64: return launch<P, 64>(x, dt, A, Bm, Cm, y, batch, L, H, s, states, cumlast, st);
    case 128: return launch<P, 128>(x, dt, A, Bm, Cm, y, batch, L, H, s, states, cumlast, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace tc

extern "C" {

// Shared memory one block of the float32 kernel needs, in bytes.
long long ssd_smem_bytes(int N, int P) {
  return scalar::smem_floats(N, P) * (long long)sizeof(float);
}

// dtype codes: 0 = float32, 1 = bfloat16 (x, B, C and y share it; dt and A
// are float32).  y is (batch, L, H, P) contiguous.  Element strides:
// x (batch, L, H) with P contiguous; dt (batch, L, H); B and C (batch, L)
// with N contiguous.  float32: P and N multiples of 4.  bfloat16: P in
// {16, 32, 64}, N in {16, 32, 64, 128}, x, B and C 16-byte aligned with
// strides that are multiples of 8, and `states` (batch, ceil(L/128) - 1,
// H, P, N) and `cumlast` (batch, ceil(L/128) - 1, H) fp32 scratch.
int ssd_fwd(const void* x, const void* dt, const void* A, const void* Bm,
            const void* Cm, void* y, int batch, int L, int H, int P, int N,
            long long x_sb, long long x_sl, long long x_sh, long long dt_sb,
            long long dt_sl, long long dt_sh, long long b_sb, long long b_sl,
            long long c_sb, long long c_sl, int dtype, void* states,
            void* cumlast, void* stream) {
  if (batch == 0 || L == 0 || H == 0) return 0;
  const long long s[10] = {x_sb, x_sl, x_sh, dt_sb, dt_sl, dt_sh,
                           b_sb, b_sl, c_sb, c_sl};
  cudaStream_t st = (cudaStream_t)stream;
  const float* dtf = (const float*)dt;
  const float* Af = (const float*)A;
  if (dtype == 0) {
    if (P % 4 || N % 4 || P <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
    return scalar::launch(x, dtf, Af, Bm, Cm, y, batch, L, H, P, N, s, st);
  }
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  typedef __nv_bfloat16 bf16;
  const bf16 *xb = (const bf16*)x, *Bb = (const bf16*)Bm, *Cb = (const bf16*)Cm;
  bf16* yb = (bf16*)y;
  float *sf = (float*)states, *cl = (float*)cumlast;
  switch (P) {
    case 16: return tc::launch_n<16>(N, xb, dtf, Af, Bb, Cb, yb, batch, L, H, s, sf, cl, st);
    case 32: return tc::launch_n<32>(N, xb, dtf, Af, Bb, Cb, yb, batch, L, H, s, sf, cl, st);
    case 64: return tc::launch_n<64>(N, xb, dtf, Af, Bb, Cb, yb, batch, L, H, s, sf, cl, st);
  }
  return (int)cudaErrorInvalidValue;
}

const char* error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
