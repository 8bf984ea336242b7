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
//
// Backward (`ssd_bwd`, training): the VJP of the scan above.  The TPU
// kernel has none; the reference trains through `ssd_scan`
// (src/repro/models/ssm.py), and this is the gradient of the same function.
// Per chunk, with cum the cumsum of dt A in it, S the state before it, dS
// the gradient of the state after it (0 after the last), G_ij = (C_i.B_j)
// e^{cum_i - cum_j} and W_ij = e^{cum_i - cum_j} dt_j (dy_i.x_j), j <= i:
//   dx_j = dt_j u_j,  u_j = sum_i G_ij dy_i + e^{cum_last - cum_j} dS B_j;
//   dC_i = sum_j W_ij B_j + e^{cum_i} S^T dy_i and dB_j = sum_i W_ij C_i +
//   e^{cum_last - cum_j} dt_j dS^T x_j, both summed over the heads;
//   ddt and dA through the gradient of the decay's cumsum, which leaves
//   the diagonal out of both of its sums, where the two terms cancel: a
//   steep decay then gives exactly 0, as autograd does, not rounding
//   noise times A;  dS <- e^{cum_last} dS + sum_i e^{cum_i} dy_i C_i^T
//   from chunk to chunk in reverse.  No atomics: every sum is taken in a
//   fixed order, the same bits from run to run.
//
// bfloat16 (training): tensor cores, `tcb::`, in chunks of 128 rows, the
// forward's, whose fp32 states it reads (the wrapper keeps them when an
// input needs a gradient; recomputing them here would repeat the
// forward's passes 1 and 2, which chip_smoke.py times beside it).
//   Bound on an H100: bytes.  x, dy, B, C, dt and A read once, dx, ddt,
//   dB, dC and dA written once: 85.5 MB at mamba2-130m's train shape
//   (b=8, L=1024, H=24, P=64, N=128), 25.5 us at 3.35 TB/s; the products
//   are 2.01e10 FLOP (W B and W^T C once a chunk, W being summed over the
//   heads first), 20.4 us at the bf16 rate.  This design also reads the
//   forward's fp32 states (44 MB there), and the split below doubles the
//   state products' tensor-core work.
//   Passes (one C call: 7 launches when L > 128, 5 when L <= 128):
//   1. chunk_state<REV> (the forward's pass 1, mma.sync), grid (H,
//      chunks - 1, b): each chunk's own state gradient sum_i dy_i
//      (e^{cum_i} C_i)^T, fp32.
//   2. dstate_pass, grid (slices of P.N, H, b): in reverse over the chunks,
//      elementwise fp32, each thread's next 8 chunks loaded ahead of the
//      dependent chain (a load after a store to the same array had held
//      the first design's pass to memory latency): dS after each chunk,
//      written split (bf16 hi, lo) for the tensor cores, the forward's S
//      split the same way, and <dS, S after> by slice.
//   3. chunk_dx, grid (head groups, chunks, b), 8 warps, one block an SM:
//      C.B^T once; per head dy.x^T and x.dy^T, W and its row and column
//      sums, u = G^T dy + diag(wend) B dS^T, dx, x.u, and v1 (rowm -
//      colm - K); W summed over the group's heads in registers, then the
//      group's W terms of dB and dC (the layout is at the kernel).
//   4. chunk_dbc, the same grid: the state terms diag(e^cum) dy S and
//      diag(wend dt) x dS summed over the group's heads in registers and
//      added to chunk_dx's W terms; off_i = C_i.(that dC term) into v1.
//   5. chunk_rows: dcum = v1 (+ <dS, S after> on the last row), its
//      reverse cumsum R, ddt = A R + x.u, and the chunk's part of dA.
//   6. sum_groups: dB and dC, the groups' parts summed in group order;
//      sum_da: dA over (batch, chunk) in order.
//   Split: products of two exact bf16 operands go in as they are (C.B^T,
//   dy.x^T); every operand derived in fp32 is split, hi + lo, and takes
//   two MMAs against an exact bf16 one: G (against dy), the group's W
//   (against B and C), dS (against B and x), S (against dy) and e^cum.C
//   (against dy).  A decay or dt that scales an exact operand's rows is
//   applied after the MMA (wend on B dS^T, e^cum on dy S, wend dt on x
//   dS).  kernels/ssd/ref.py: ssd_bwd_tc_plain is this arithmetic.
//   Heads a group: enough that the grid is about one wave (ops.py:
//   bwd_heads_per_group, at most 16): each block pays C.B^T and the W
//   terms once, and the fp32 partials of dB and dC are (b, groups, L, N),
//   where the first design wrote every head's, (b, H, L, N).
//   Where the time goes (chip_smoke.py phase 2b times each pass): the
//   chunk passes run 8 warps an SM at up to 255 registers, and wait on
//   latency more than they issue MMAs.  In chunk_dx the W elementwise
//   work weighed most; the decay is therefore a row factor times a
//   column factor off the diagonal block (as the forward's gate), and
//   C.B^T sits in shared memory, not in 72 registers a thread.  Tried
//   and slower: recomputing the states (above); two waves of smaller
//   head groups; one exp an element with C.B^T in registers.  Left on the
//   table: 16 warps a block, two on each 16-row block, so that latency
//   hides; wgmma (each product's A operand is derived in registers from
//   an accumulator, which m16n8k16 fragments take directly); the
//   imbalance of G^T dy (warp w takes 8 - w blocks of it).
//
// float32 (parity checks only): `bwd::`, the first backward kernel: all
// arithmetic in fp32 in chunks of 64 rows, seven launches (each chunk's
// own state and state gradient, the forward and reverse scans, one block
// per (head, chunk, batch row) with everything of the chunk in shared
// memory and scalar FMAs in 4x4 register tiles, the sums over heads and
// over chunks), and every head's dB and dC terms through fp32 scratch.

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
// REV (the backward's state gradients), for chunks 1 .. nc-1 into slot
// c - 1: x is dy, B is C and w_j = exp(cum_j), so the slot holds the
// chunk's own term sum_i dy_i (exp(cum_i) C_i)^T, and cumlast its decay.
template <int P, int N, bool REV = false>
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

  const int h = blockIdx.x, slot = blockIdx.y, b = blockIdx.z;
  const int c = slot + (REV ? 1 : 0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int t0 = c * kQ, q = min(kQ, L - t0);
  stage_rows<P>(xs, x + b * x_sb + t0 * x_sl + h * x_sh, x_sl, q);
  stage_rows<N>(bhi, Bm + b * b_sb + t0 * b_sl, b_sl, q);
  if (warp == 0) {
    chunk_cumsum(dt + b * dt_sb + t0 * dt_sl + h * dt_sh, dt_sl, q, A[h], cum,
                 w);
    const float last = cum[kQ - 1];
    for (int r = lane; r < kQ; r += 32)
      w[r] = REV ? expf(cum[r]) : w[r] * expf(last - cum[r]);
    if (lane == 0) cumlast[((long long)b * nc1 + slot) * H + h] = last;
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
  float* st = states + (((long long)b * nc1 + slot) * H + h) * (P * N);
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

// ---------------------------------------------------------------------------
// Backward, float32: the VJP of the scan in fp32 FMAs.
// ---------------------------------------------------------------------------
namespace bwd {

using scalar::ld4;

constexpr int kQ = 64;          // rows of a chunk, in every pass
constexpr int kQS = kQ + 4;     // padded stride of the (Q, Q) tiles
constexpr int kThreads = 256;   // (kQ/4)^2 4x4 micro-tiles of a (Q, Q) tile

__host__ __device__ inline long long wide4(int P) { return (kQ > P ? kQ : P) / 4; }

// chunk_grads: B, C (Q x N+4), x, dy (Q x P+4), S, dS (P x N+4), G, W
// (Q x Q+4), 9 row vectors, the row partials of two (Q, Q or P) reductions
// and of one (Q, N) reduction, one float a warp
__host__ __device__ inline long long main_floats(int N, int P) {
  return 2LL * kQ * (N + 4) + 2LL * kQ * (P + 4) + 2LL * P * (N + 4) +
         2LL * kQ * kQS + 9LL * kQ + 2LL * kQ * wide4(P) + (long long)kQ * (N / 4) +
         kThreads / 32;
}
// own_states: v (Q x P+4), w (Q x N+4), 3 row vectors
__host__ __device__ inline long long own_floats(int N, int P) {
  return (long long)kQ * (P + 4) + (long long)kQ * (N + 4) + 4LL * kQ;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Warp 0: dts[r] = dt of the chunk's row r (0 past q), cum[r] = the
// inclusive cumsum of dt A over the chunk (flat past q), two rows a lane.
__device__ __forceinline__ void chunk_cum(const float* dtb, long long dt_sl,
                                          int t0, int q, float a, float* cum,
                                          float* dts) {
  const int lane = threadIdx.x;
  const int r0 = 2 * lane, r1 = r0 + 1;
  const float d0 = r0 < q ? dtb[(long long)(t0 + r0) * dt_sl] : 0.f;
  const float d1 = r1 < q ? dtb[(long long)(t0 + r1) * dt_sl] : 0.f;
  const float a0 = d0 * a, a1 = d1 * a;
  float incl = a0 + a1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.f;
  dts[r0] = d0;
  dts[r1] = d1;
  cum[r0] = excl + a0;
  cum[r1] = cum[r0] + a1;
}

// v[r][kk] = op(m0 + r cs, k + kk) of a shared fp32 operand: KC, op(m, k)
// = p[m ld + k] (k contiguous); else op(m, k) = p[k ld + m], cs = 1.
template <bool KC>
__device__ __forceinline__ void frag(const float* p, int ld, int m0, int cs,
                                     int k, float v[4][4]) {
  if (KC) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float4 t = ld4(p + (m0 + r * cs) * ld + k);
      v[r][0] = t.x; v[r][1] = t.y; v[r][2] = t.z; v[r][3] = t.w;
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 t = ld4(p + (k + kk) * ld + m0);
      v[0][kk] = t.x; v[1][kk] = t.y; v[2][kk] = t.z; v[3][kk] = t.w;
    }
  }
}

// acc[r][c] += sum_{k0 <= k < k1} a(m0 + r, k) b(k, n0 + c cs), k0 and k1
// multiples of 4; a's rows are contiguous, b's columns are strided by cs
// where BK (cs = 1 otherwise).
template <bool AK, bool BK>
__device__ __forceinline__ void mm(float acc[4][4], const float* a, int lda,
                                   int m0, const float* b, int ldb, int n0,
                                   int cs, int k0, int k1) {
  for (int k = k0; k < k1; k += 4) {
    float av[4][4], bv[4][4];
    frag<AK>(a, lda, m0, 1, k, av);
    frag<BK>(b, ldb, n0, cs, k, bv);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r][kk], bv[c][kk], acc[r][c]);
  }
}

// Pass 1 (rev = 0): each chunk's own state sum_j exp(cum_last - cum_j) dt_j
// x_j B_j^T, and its total decay cum_last.  Pass 2 (rev = 1): each chunk's
// own state gradient sum_i exp(cum_i) dy_i C_i^T.  v is x or dy, w is B or
// C; out[b][c][h] is (P, N) fp32.  Grid (H, chunks, batch).
__global__ void __launch_bounds__(kThreads)
own_states(const float* __restrict__ v, const float* __restrict__ dt,
           const float* __restrict__ A, const float* __restrict__ w,
           float* __restrict__ out, float* __restrict__ cumlast, int L, int H,
           int P, int N, int nc, long long v_sb, long long v_sl, long long v_sh,
           long long dt_sb, long long dt_sl, long long dt_sh, long long w_sb,
           long long w_sl, int rev) {
  extern __shared__ float4 smem4[];
  const int PS = P + 4, NS = N + 4;
  float* vs = reinterpret_cast<float*>(smem4);  // vs[j PS + p] = coef_j v[j][p]
  float* ws = vs + kQ * PS;                     // ws[j NS + n] = w[j][n]
  float* cum = ws + kQ * NS;
  float* dts = cum + kQ;
  float* coef = dts + kQ;
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int t0 = c * kQ, q = min(kQ, L - t0);
  if (tid < 32) chunk_cum(dt + b * dt_sb + h * dt_sh, dt_sl, t0, q, A[h], cum, dts);
  __syncthreads();
  const float last = cum[kQ - 1];
  if (tid < kQ) coef[tid] = rev ? expf(cum[tid]) : expf(last - cum[tid]) * dts[tid];
  if (!rev && tid == 0) cumlast[((long long)b * nc + c) * H + h] = last;
  __syncthreads();
  const float* vb = v + b * v_sb + h * v_sh + (long long)t0 * v_sl;
  const float* wb = w + b * w_sb + (long long)t0 * w_sl;
  for (int idx = tid; idx < kQ * P; idx += kThreads) {
    const int j = idx / P, p = idx - j * P;
    vs[j * PS + p] = j < q ? vb[(long long)j * v_sl + p] * coef[j] : 0.f;
  }
  for (int idx = tid; idx < kQ * N; idx += kThreads) {
    const int j = idx / N, n = idx - j * N;
    ws[j * NS + n] = j < q ? wb[(long long)j * w_sl + n] : 0.f;
  }
  __syncthreads();
  float* ob = out + (((long long)b * nc + c) * H + h) * P * N;
  const int qr = (q + 3) & ~3, N4 = N / 4;
  for (int mt = tid; mt < (P / 4) * N4; mt += kThreads) {
    const int p0 = 4 * (mt / N4), n0 = 4 * (mt % N4);
    float acc[4][4] = {};
    mm<false, false>(acc, vs, PS, p0, ws, NS, n0, 1, 0, qr);
#pragma unroll
    for (int r = 0; r < 4; ++r)
      *reinterpret_cast<float4*>(ob + (p0 + r) * N + n0) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
}

// In place over the chunks, elementwise: slot c (a chunk's own term)
// becomes the carry before it, carry <- exp(cum_last[c]) carry + own[c];
// forward order gives the state before each chunk, reverse order the
// gradient of the state after it.  Grid (P.N / 256, H, batch).
__global__ void __launch_bounds__(kThreads)
scan_states(float* __restrict__ st, const float* __restrict__ cumlast, int H,
            int nc, int pn, int rev) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  if (e >= pn) return;
  float carry = 0.f;
  for (int s = 0; s < nc; ++s) {
    const int c = rev ? nc - 1 - s : s;
    const long long slot = ((long long)b * nc + c) * H + h;
    float* ptr = st + slot * pn + e;
    const float own = *ptr;
    *ptr = carry;
    carry = fmaf(expf(cumlast[slot]), carry, own);
  }
}

// Pass 3, one block per (head, chunk, batch row): with S the state before
// the chunk and dS the gradient of the state after it,
//   G_ij = (C_i.B_j) e^{cum_i - cum_j}, W_ij = e^{cum_i - cum_j} dt_j (dy_i.x_j)
//   (j <= i, masked before exp), M_ij = W_ij (C_i.B_j);
//   u_j = sum_i G_ij dy_i + e^{cum_last - cum_j} dS B_j, dx_j = dt_j u_j;
//   dC_i = sum_j W_ij B_j + e^{cum_i} S^T dy_i, dB_j = sum_i W_ij C_i +
//   e^{cum_last - cum_j} dt_j dS^T x_j (this head's terms, fp32, to scratch);
//   dcum_i = sum_{j<i} M_ij - sum_{k>i} M_ki + C_i.(e^{cum_i} S^T dy_i)
//   - e^{cum_last - cum_i} dt_i x_i.(dS B_i), plus <dS, S after> on the last
//   row; R = the reverse cumsum of dcum, ddt_t = A R_t + x_t.u_t, and this
//   chunk's part of dA, sum_t dt_t R_t.  Products in 4x4 register tiles
//   from shared memory; sums over a row's threads through shared partials,
//   added in a fixed order.
__global__ void __launch_bounds__(kThreads)
chunk_grads(const float* __restrict__ x, const float* __restrict__ dt,
            const float* __restrict__ A, const float* __restrict__ Bm,
            const float* __restrict__ Cm, const float* __restrict__ dy,
            const float* __restrict__ states, const float* __restrict__ dstates,
            float* __restrict__ dx, float* __restrict__ ddt,
            float* __restrict__ dBp,
            float* __restrict__ dCp, float* __restrict__ dAp, int L, int H,
            int P, int N, int nc, long long x_sb, long long x_sl, long long x_sh,
            long long dt_sb, long long dt_sl, long long dt_sh, long long b_sb,
            long long b_sl, long long c_sb, long long c_sl, long long dy_sb,
            long long dy_sl, long long dy_sh) {
  extern __shared__ float4 smem4[];
  const int NS = N + 4, PS = P + 4, P4 = P / 4, N4 = N / 4, Q4 = kQ / 4;
  float* Bs = reinterpret_cast<float*>(smem4);  // Bs[j NS + n] = B[j][n]
  float* Cs = Bs + kQ * NS;                     // Cs[i NS + n] = C[i][n]
  float* xs = Cs + kQ * NS;                     // xs[j PS + p] = x[j][p]
  float* dys = xs + kQ * PS;                    // dys[i PS + p] = dy[i][p]
  float* Ss = dys + kQ * PS;                    // Ss[p NS + n] = S[p][n]
  float* dSs = Ss + P * NS;                     // dSs[p NS + n] = dS[p][n]
  float* Gs = dSs + P * NS;                     // Gs[i kQS + j] = G_ij
  float* Ws = Gs + kQ * kQS;                    // Ws[i kQS + j] = W_ij
  float* cum = Ws + kQ * kQS;
  float* dts = cum + kQ;
  float* wend = dts + kQ;                       // e^{cum_last - cum_j}
  float* ecum = wend + kQ;                      // e^{cum_i}
  float* rowm = ecum + kQ;                      // sum_{j<i} M_ij
  float* colm = rowm + kQ;                      // sum_{k>j} M_kj
  float* xu = colm + kQ;                        // x_j.u_j
  float* xk = xu + kQ;                          // x_j.(dS B_j)
  float* off = xk + kQ;                         // C_i.(e^{cum_i} S^T dy_i)
  float* partA = off + kQ;                      // 2 kQ wide4(P)
  float* partO = partA + 2 * kQ * wide4(P);     // kQ N4
  float* red = partO + kQ * N4;                 // kThreads / 32

  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int t0 = c * kQ, q = min(kQ, L - t0), qr = (q + 3) & ~3;
  const float a = A[h];
  const long long slot = ((long long)b * nc + c) * H + h;

  if (tid < 32) chunk_cum(dt + b * dt_sb + h * dt_sh, dt_sl, t0, q, a, cum, dts);
  __syncthreads();
  if (tid < kQ) {
    wend[tid] = expf(cum[kQ - 1] - cum[tid]);
    ecum[tid] = expf(cum[tid]);
  }
  {
    const float* Bb = Bm + b * b_sb + (long long)t0 * b_sl;
    const float* Cb = Cm + b * c_sb + (long long)t0 * c_sl;
    for (int idx = tid; idx < kQ * N; idx += kThreads) {
      const int j = idx / N, n = idx - j * N;
      const bool in = j < q;
      Bs[j * NS + n] = in ? Bb[(long long)j * b_sl + n] : 0.f;
      Cs[j * NS + n] = in ? Cb[(long long)j * c_sl + n] : 0.f;
    }
    const float* xb = x + b * x_sb + h * x_sh + (long long)t0 * x_sl;
    const float* dyb = dy + b * dy_sb + h * dy_sh + (long long)t0 * dy_sl;
    for (int idx = tid; idx < kQ * P; idx += kThreads) {
      const int j = idx / P, p = idx - j * P;
      const bool in = j < q;
      xs[j * PS + p] = in ? xb[(long long)j * x_sl + p] : 0.f;
      dys[j * PS + p] = in ? dyb[(long long)j * dy_sl + p] : 0.f;
    }
    const float* Sg = states + slot * P * N;
    const float* dSg = dstates + slot * P * N;
    for (int idx = tid; idx < P * N; idx += kThreads) {
      const int p = idx / N, n = idx - p * N;
      Ss[p * NS + n] = Sg[idx];
      dSs[p * NS + n] = dSg[idx];
    }
  }
  __syncthreads();

  // (a) C.B^T and dy.x^T, thread tile rows i0..i0+3 x columns g + Q4 cc;
  //     G, W, and M's strict row and column sums
  {
    const int i0 = 4 * (tid / Q4), g = tid % Q4;
    float cb[4][4] = {}, dx4[4][4] = {};
    mm<true, true>(cb, Cs, NS, i0, Bs, NS, g, Q4, 0, N);
    mm<true, true>(dx4, dys, PS, i0, xs, PS, g, Q4, 0, P);
    float rs[4] = {}, cs[4] = {};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + r;
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int j = g + Q4 * cc;
        float gv = 0.f, wv = 0.f;
        if (j <= i) {
          const float dec = expf(cum[i] - cum[j]);
          gv = cb[r][cc] * dec;
          wv = dx4[r][cc] * dec * dts[j];
          if (j < i) {
            const float m = wv * cb[r][cc];
            rs[r] += m;
            cs[cc] += m;
          }
        }
        Gs[i * kQS + j] = gv;
        Ws[i * kQS + j] = wv;
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) partA[(i0 + r) * Q4 + g] = rs[r];
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) partA[kQ * Q4 + (g + Q4 * cc) * Q4 + i0 / 4] = cs[cc];
  }
  __syncthreads();
  if (tid < kQ) {
    float s = 0.f;
    for (int k = 0; k < Q4; ++k) s += partA[tid * Q4 + k];
    rowm[tid] = s;
  } else if (tid < 2 * kQ) {
    const int j = tid - kQ;
    float s = 0.f;
    for (int k = 0; k < Q4; ++k) s += partA[kQ * Q4 + j * Q4 + k];
    colm[j] = s;
  }
  __syncthreads();

  // (b) u = G^T dy + diag(wend) B dS^T over (j, p) tiles; dx = dt u
  for (int mt = tid; mt < Q4 * P4; mt += kThreads) {
    const int j0 = 4 * (mt / P4), p0 = 4 * (mt % P4);
    float t1[4][4] = {}, t2[4][4] = {};
    mm<false, false>(t1, Gs, kQS, j0, dys, PS, p0, 1, j0, qr);
    mm<true, true>(t2, Bs, NS, j0, dSs, NS, p0, 1, 0, N);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = j0 + r;
      const float* xr = xs + j * PS + p0;
      float pu = 0.f, pk = 0.f, o[4];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float u = fmaf(wend[j], t2[r][cc], t1[r][cc]);
        o[cc] = dts[j] * u;
        pu = fmaf(xr[cc], u, pu);
        pk = fmaf(xr[cc], t2[r][cc], pk);
      }
      if (j < q) {
        float* dr = dx + (((long long)b * L + t0 + j) * H + h) * P + p0;
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) dr[cc] = o[cc];
      }
      partA[j * P4 + p0 / 4] = pu;
      partA[kQ * P4 + j * P4 + p0 / 4] = pk;
    }
  }

  // (c) dC = W B + diag(ecum) dy S and dB = W^T C + diag(wend dt) x dS over
  //     (row, n) tiles, this head's terms, to the fp32 scratch
  for (int mt = tid; mt < Q4 * N4; mt += kThreads) {
    const int r0 = 4 * (mt / N4), n0 = 4 * (mt % N4);
    float c1[4][4] = {}, c2[4][4] = {}, b1[4][4] = {}, b2[4][4] = {};
    mm<true, false>(c1, Ws, kQS, r0, Bs, NS, n0, 1, 0, min(r0 + 4, qr));
    mm<true, false>(c2, dys, PS, r0, Ss, NS, n0, 1, 0, P);
    mm<false, false>(b1, Ws, kQS, r0, Cs, NS, n0, 1, r0, qr);
    mm<true, false>(b2, xs, PS, r0, dSs, NS, n0, 1, 0, P);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = r0 + r;
      const float* cr = Cs + i * NS + n0;
      const float wd = wend[i] * dts[i];
      float po = 0.f, dc[4], db[4];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float o = ecum[i] * c2[r][cc];
        dc[cc] = c1[r][cc] + o;
        po = fmaf(cr[cc], o, po);
        db[cc] = fmaf(wd, b2[r][cc], b1[r][cc]);
      }
      if (i < q) {
        const long long at = (((long long)b * H + h) * L + t0 + i) * N + n0;
        *reinterpret_cast<float4*>(dCp + at) = make_float4(dc[0], dc[1], dc[2], dc[3]);
        *reinterpret_cast<float4*>(dBp + at) = make_float4(db[0], db[1], db[2], db[3]);
      }
      partO[i * N4 + n0 / 4] = po;
    }
  }

  // <dS, S after the chunk> (0 after the last chunk, whose dS is 0)
  float sd = 0.f;
  if (c + 1 < nc) {
    const float* Sn = states + (slot + H) * P * N;  // chunk c + 1, same b, h
    for (int idx = tid; idx < P * N; idx += kThreads) {
      const int p = idx / N, n = idx - p * N;
      sd = fmaf(dSs[p * NS + n], Sn[idx], sd);
    }
  }
  sd = warp_sum(sd);
  if ((tid & 31) == 0) red[tid >> 5] = sd;
  __syncthreads();
  if (tid < kQ) {
    float s = 0.f;
    for (int k = 0; k < P4; ++k) s += partA[tid * P4 + k];
    xu[tid] = s;
    s = 0.f;
    for (int k = 0; k < P4; ++k) s += partA[kQ * P4 + tid * P4 + k];
    xk[tid] = s;
    s = 0.f;
    for (int k = 0; k < N4; ++k) s += partO[tid * N4 + k];
    off[tid] = s;
  }
  __syncthreads();

  // (d) dcum, its reverse cumsum R, ddt and this chunk's part of dA (warp 0)
  if (tid < 32) {
    float last = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) last += red[w];
    float d[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = 2 * tid + e;
      d[e] = rowm[i] - colm[i] + off[i] - wend[i] * dts[i] * xk[i] +
             (i == q - 1 ? last : 0.f);
    }
    const float v = d[0] + d[1];
    float incl = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float t = __shfl_down_sync(0xffffffffu, incl, o);
      if (tid + o < 32) incl += t;
    }
    float later = __shfl_down_sync(0xffffffffu, incl, 1);
    if (tid == 31) later = 0.f;
    float R[2];
    R[1] = later + d[1];
    R[0] = R[1] + d[0];
    float pa = 0.f;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = 2 * tid + e;
      if (i < q) ddt[((long long)b * L + t0 + i) * H + h] = fmaf(a, R[e], xu[i]);
      pa = fmaf(dts[i], R[e], pa);
    }
    pa = warp_sum(pa);
    if (tid == 0) dAp[slot] = pa;
  }
}

// dB, dC (batch, L, N) = the sums over heads of the fp32 per-head terms
// (batch, H, L, N), in head order, cast to the inputs' type.
__global__ void __launch_bounds__(kThreads)
sum_heads(const float* __restrict__ dBp, const float* __restrict__ dCp,
          float* __restrict__ dB, float* __restrict__ dC, int batch, int H,
          long long LN) {
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= batch * LN) return;
  const long long b = idx / LN, r = idx - b * LN;
  const float* pb = dBp + b * H * LN + r;
  const float* pc = dCp + b * H * LN + r;
  float sb = 0.f, sc = 0.f;
  for (int h = 0; h < H; ++h) {
    sb += pb[h * LN];
    sc += pc[h * LN];
  }
  dB[idx] = sb;
  dC[idx] = sc;
}

// dA[h] = the sum of the chunks' parts (rows = batch x chunks), in order.
__global__ void __launch_bounds__(kThreads)
sum_da(const float* __restrict__ dAp, float* __restrict__ dA, int rows, int H) {
  const int h = blockIdx.x * kThreads + threadIdx.x;
  if (h >= H) return;
  float s = 0.f;
  for (int r = 0; r < rows; ++r) s += dAp[(long long)r * H + h];
  dA[h] = s;
}

int launch(const float* x, const float* dt, const float* A, const float* Bm,
           const float* Cm, const float* dy, float* dx, float* ddt,
           float* dA, float* dB, float* dC, int batch, int L, int H, int P,
           int N, const long long* s,
           float* states, float* dstates, float* cumlast, float* dBp,
           float* dCp, float* dAp, cudaStream_t st) {
  const int nc = (L + kQ - 1) / kQ;
  const dim3 blocks(H, nc, batch);
  const int own_bytes = (int)(own_floats(N, P) * sizeof(float));
  const int main_bytes = (int)(main_floats(N, P) * sizeof(float));
  cudaError_t e = cudaFuncSetAttribute(
      own_states, cudaFuncAttributeMaxDynamicSharedMemorySize, own_bytes);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(chunk_grads,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, main_bytes);
  if (e != cudaSuccess) return (int)e;
  own_states<<<blocks, kThreads, own_bytes, st>>>(
      x, dt, A, Bm, states, cumlast, L, H, P, N, nc, s[0], s[1], s[2], s[3],
      s[4], s[5], s[6], s[7], 0);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  own_states<<<blocks, kThreads, own_bytes, st>>>(
      dy, dt, A, Cm, dstates, cumlast, L, H, P, N, nc, s[10], s[11], s[12],
      s[3], s[4], s[5], s[8], s[9], 1);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const int pn = P * N;
  const dim3 sgrid((pn + kThreads - 1) / kThreads, H, batch);
  scan_states<<<sgrid, kThreads, 0, st>>>(states, cumlast, H, nc, pn, 0);
  scan_states<<<sgrid, kThreads, 0, st>>>(dstates, cumlast, H, nc, pn, 1);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  chunk_grads<<<blocks, kThreads, main_bytes, st>>>(
      x, dt, A, Bm, Cm, dy, states, dstates, dx, ddt, dBp, dCp, dAp, L, H, P,
      N, nc, s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9],
      s[10], s[11], s[12]);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const long long LN = (long long)L * N;
  sum_heads<<<(unsigned)((batch * LN + kThreads - 1) / kThreads), kThreads,
                 0, st>>>(dBp, dCp, dB, dC, batch, H, LN);
  sum_da<<<(H + kThreads - 1) / kThreads, kThreads, 0, st>>>(dAp, dA,
                                                             batch * nc, H);
  return (int)cudaGetLastError();
}

}  // namespace bwd

// ---------------------------------------------------------------------------
// Backward, bf16: tensor cores, chunks of 128 rows (the forward's).
// ---------------------------------------------------------------------------
namespace tcb {

using tc::bf16;
using tc::cp_async_wait_all;
using tc::kPad;
using tc::kQ;
using tc::kThreads;
using tc::kWarps;
using tc::mma;
using tc::smem_u32;
using tc::split2;

// 16-column blocks a warp of chunk_dx holds of a (Q, Q) product: blocks
// 0 .. w of its rows (the i role, columns j <= i) and blocks w .. 7 of
// its rows again (the j role, columns i >= j): 9 for every warp.
constexpr int kPairs = kQ / 16 + 1;
constexpr int kScanBatch = 8;      // dstate_pass: chunks loaded ahead
constexpr int kScanThreads = 256;  // dstate_pass: float4 of a slice

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
// A fragment of rows m0 .. m0+15, columns k0 .. k0+15 of a row-major
// [m][k] tile of row stride S
__device__ __forceinline__ void lda(uint32_t (&a)[4], const bf16* t, int S,
                                    int m0, int k0) {
  const int l = threadIdx.x & 31;
  ldsm_x4(a, t + (m0 + (l & 15)) * S + k0 + ((l >> 4) << 3));
}
// B fragments of two n-tiles (n0 .. n0+15) over k0 .. k0+15: r[0], r[1]
// the first, r[2], r[3] the second; `ldb_nk` from a [n][k] tile,
// `ldb_kn` from a [k][n] tile (transposed on load)
__device__ __forceinline__ void ldb_nk(uint32_t (&r)[4], const bf16* t, int S,
                                       int n0, int k0) {
  const int l = threadIdx.x & 31;
  ldsm_x4(r, t + (n0 + (l & 7) + ((l >> 4) << 3)) * S + k0 +
                 (((l >> 3) & 1) << 3));
}
__device__ __forceinline__ void ldb_kn(uint32_t (&r)[4], const bf16* t, int S,
                                       int k0, int n0) {
  const int l = threadIdx.x & 31;
  tc::ldsm_x4_t(r, t + (k0 + (l & 7) + (((l >> 3) & 1) << 3)) * S + n0 +
                       ((l >> 4) << 3));
}
// d[2 np], d[2 np + 1] += a . (the two n-tiles of r)
__device__ __forceinline__ void mma2(float (&d0)[4], float (&d1)[4],
                                     const uint32_t (&a)[4],
                                     const uint32_t (&r)[4]) {
  mma(d0, a, r[0], r[1]);
  mma(d1, a, r[2], r[3]);
}
// The A fragment of a 16-column block held as two accumulator tiles
// v[0], v[1] (rows g and g + 8 of each), split hi + lo
__device__ __forceinline__ void split_frag(const float (&v)[2][4],
                                           uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    split2(v[s][0], v[s][1], hi[2 * s], lo[2 * s]);
    split2(v[s][2], v[s][3], hi[2 * s + 1], lo[2 * s + 1]);
  }
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ROWS whole rows of COLS bf16 (row stride COLS) into a tile of row stride
// COLS + kPad, asynchronously
template <int ROWS, int COLS>
__device__ __forceinline__ void stage_tile(bf16* dst, const bf16* src) {
  constexpr int V = COLS / 8;
  for (int i = threadIdx.x; i < ROWS * V; i += kThreads) {
    const int r = i / V, v = i - r * V;
    tc::cp_async16(dst + r * (COLS + kPad) + 8 * v, src + r * COLS + 8 * v,
                   true);
  }
}

// chunk_dx's region for a head's x and dy, or for C, in bf16 elements
__host__ __device__ constexpr int dx_region(int P, int N) {
  return 2 * kQ * (P + kPad) > kQ * (N + kPad) ? 2 * kQ * (P + kPad)
                                               : kQ * (N + kPad);
}
__host__ __device__ constexpr int dx_smem(int P, int N) {
  return kQ * (N + kPad) * 2 + dx_region(P, N) * 2 + 4 * P * (N + kPad) * 2 +
         kWarps * kPairs * 2 * 32 * 16 + 10 * kQ * 4;
}
__host__ __device__ constexpr int dbc_smem(int P, int N) {
  return kQ * (N + kPad) * 2 + 2 * kQ * (P + kPad) * 2 +
         4 * P * (N + kPad) * 2 + 6 * kQ * 4;
}

// The state gradients, in reverse over the chunks: slot s of D holds chunk
// s + 1's own term (chunk_state<REV>); dS_s = exp(clr[s]) dS_{s+1} + D_s is
// the gradient of the state after chunk s (dS after the last chunk is 0).
// Written split for the chunk passes, hi then lo (bf16, (P, N) each):
// dshl[s] = dS_s and shl[s] = S_s, the state after chunk s (the forward's
// slot s); sdp[s] gets this slice's part of <dS_s, S_s>.  Grid (slices of
// P.N, H, batch): each thread one float4, kScanBatch chunks loaded ahead
// of the dependent chain, so the chain waits on memory once a batch.
__global__ void __launch_bounds__(kScanThreads)
dstate_pass(const float* __restrict__ D, const float* __restrict__ clr,
            const float* __restrict__ st, bf16* __restrict__ dshl,
            bf16* __restrict__ shl, float* __restrict__ sdp, int H, int nc1,
            int pn4) {
  __shared__ float red[kScanThreads / 32][kScanBatch];
  const int i = blockIdx.x * kScanThreads + threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, slices = gridDim.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool in = i < pn4;
  const long long pn = 4LL * pn4;
  auto put = [&](bf16* dst, long long slot, float4 v) {
    uint32_t h01, l01, h23, l23;
    split2(v.x, v.y, h01, l01);
    split2(v.z, v.w, h23, l23);
    bf16* p = dst + slot * 2 * pn + 4 * i;
    *reinterpret_cast<uint2*>(p) = make_uint2(h01, h23);
    *reinterpret_cast<uint2*>(p + pn) = make_uint2(l01, l23);
  };
  float4 carry = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int top = nc1 - 1; top >= 0; top -= kScanBatch) {
    float4 d[kScanBatch], sa[kScanBatch];
    float e[kScanBatch];
#pragma unroll
    for (int k = 0; k < kScanBatch; ++k) {
      const int s = top - k;
      const long long slot = ((long long)b * nc1 + (s >= 0 ? s : 0)) * H + h;
      e[k] = s >= 0 ? expf(clr[slot]) : 0.f;
      d[k] = sa[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (s >= 0 && in) {
        d[k] = reinterpret_cast<const float4*>(D + slot * pn)[i];
        sa[k] = reinterpret_cast<const float4*>(st + slot * pn)[i];
      }
    }
#pragma unroll
    for (int k = 0; k < kScanBatch; ++k) {
      const int s = top - k;
      if (s < 0) break;
      const long long slot = ((long long)b * nc1 + s) * H + h;
      carry = make_float4(fmaf(e[k], carry.x, d[k].x), fmaf(e[k], carry.y, d[k].y),
                          fmaf(e[k], carry.z, d[k].z), fmaf(e[k], carry.w, d[k].w));
      if (in) {
        put(dshl, slot, carry);
        put(shl, slot, sa[k]);
      }
      float dot = carry.x * sa[k].x + carry.y * sa[k].y + carry.z * sa[k].z +
                  carry.w * sa[k].w;
      dot = bwd::warp_sum(dot);
      if (lane == 0) red[warp][k] = dot;
    }
    __syncthreads();
    if (threadIdx.x < kScanBatch && top - (int)threadIdx.x >= 0) {
      const int s = top - threadIdx.x;
      float sum = 0.f;
      for (int w = 0; w < kScanThreads / 32; ++w) sum += red[w][threadIdx.x];
      sdp[(((long long)b * nc1 + s) * H + h) * slices + blockIdx.x] = sum;
    }
    __syncthreads();
  }
}

// Per (group of hg heads, chunk, batch row), 8 warps, warp w on rows
// 16w .. 16w+15 of the chunk in two roles: as rows i (columns j <= i,
// blocks 0 .. w) and as rows j (columns i >= j, blocks w .. 7), 9
// 16-column blocks in all (`kPairs`; pair kp <= w is block kp of the i
// role, pair kp > w block kp - 1 of the j role).
//   Once:     CB = C.B^T (i role) and BC = B.C^T (j role), exact bf16,
//             kept in shared memory, each warp's own.
//   Per head: dyx = dy.x^T (i role), xdy = x.dy^T (j role), exact;
//             W_ij = dyx_ij e^{cum_i - cum_j} dt_j, W^T from xdy the same
//             way; M = W CB strictly below the diagonal, summed over j on
//             the i rows (rowm) and over i on the j rows (colm): no
//             reduction leaves the warp; W summed over the group's heads
//             in registers; pair by pair on the j rows, u = G^T dy (G^T =
//             BC e^{cum_i - cum_j}, split, against dy).  The decay off
//             the diagonal block is a row factor times a column factor,
//             both exponents <= 0 (the forward's gate does the same):
//             e^{cum_i - cum_e} fcol_j on the i rows, cum_e the end of
//             j's block, and e^{cum_s - cum_j} hcol_i on the j rows, cum_s
//             the end of the block before i's; on the diagonal block it
//             is masked before exp.  Then u += diag(wend) B dS^T (B exact,
//             dS split); dx = dt u (bf16), x.u (to xu), and v1 = rowm -
//             colm - K, K_j = wend_j dt_j x_j.(B_j dS^T).  The next head's
//             dS hi/lo (double buffer) is copied in (cp.async) from the
//             head's start, its x and dy once the products that read them
//             are done, and warp 0 scans its dt.
//   Once:     dC's W term sum_j Wsum_ij B_j and dB's sum_i Wsum_ji C_i
//             (Wsum split, B and C exact), this group's part, to dCp, dBp.
template <int P, int N>
__global__ void __launch_bounds__(kThreads, 1)
chunk_dx(const bf16* __restrict__ x, const float* __restrict__ dt,
         const float* __restrict__ A, const bf16* __restrict__ Bm,
         const bf16* __restrict__ Cm, const bf16* __restrict__ dy,
         const bf16* __restrict__ dshl, bf16* __restrict__ dx,
         float* __restrict__ xu, float* __restrict__ v1,
         float* __restrict__ dBp, float* __restrict__ dCp, int L, int H,
         int nc, int hg, long long x_sb, long long x_sl, long long x_sh,
         long long dt_sb, long long dt_sl, long long dt_sh, long long b_sb,
         long long b_sl, long long c_sb, long long c_sl, long long dy_sb,
         long long dy_sl, long long dy_sh) {
  constexpr int BS = N + kPad, XS = P + kPad;
  constexpr int ST = 2 * P * BS;  // a dS buffer: hi rows, then lo rows
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Bs = reinterpret_cast<bf16*>(smem);  // [kQ][BS] B
  bf16* xs = Bs + kQ * BS;                   // [kQ][XS] x, then [kQ][XS] dy
  bf16* dys = xs + kQ * XS;                  //   of a head; or C [kQ][BS]
  bf16* Cs = xs;                             //   before and after the heads
  bf16* dS0 = xs + dx_region(P, N);          // 2 x [2P][BS] dS hi, lo
  float4* cbs = reinterpret_cast<float4*>(dS0 + 2 * ST);  // [warp][pair][2][lane]
  float* vec0 = reinterpret_cast<float*>(cbs + kWarps * kPairs * 2 * 32);

  const int grp = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int G = gridDim.x, nc1 = nc - 1;
  const int h0 = grp * hg, h1 = min(H, h0 + hg);
  const int lane = threadIdx.x & 31, warp = tc::warp_uniform(threadIdx.x >> 5);
  const int g = lane >> 2, t = lane & 3;
  const int t0 = c * kQ, q = min(kQ, L - t0);
  const int r0 = 16 * warp, ra = r0 + g, rb = ra + 8;
  const bool has_ds = c < nc1;
  const float* dtb = dt + b * dt_sb + t0 * dt_sl;
  float4* cbw = cbs + warp * (kPairs * 2 * 32) + lane;

  auto fetch_xdy = [&](int h) {
    tc::stage_rows<P>(xs, x + b * x_sb + t0 * x_sl + h * x_sh, x_sl, q);
    tc::stage_rows<P>(dys, dy + b * dy_sb + t0 * dy_sl + h * dy_sh, dy_sl, q);
  };
  auto fetch_ds = [&](int h, int buf) {
    if (has_ds)
      stage_tile<2 * P, N>(dS0 + buf * ST,
                           dshl + (((long long)b * nc1 + c) * H + h) * (2 * P * N));
  };
  // warp 0: a head's cum, dts, wend = e^{cum_last - cum} and the decay's
  // column factors fcol_j = e^{cum_e - cum_j} dt_j (cum_e the end of j's
  // 16-row block) and hcol_i = e^{cum_i - cum_s} (cum_s the end of the
  // block before i's), from a lane's 4 dt
  auto vectors = [&](const float (&d)[4], int h, int buf) {
    float* cum = vec0 + buf * (5 * kQ);
    tc::chunk_scan(d, A[h], cum, cum + kQ);
    const float last = cum[kQ - 1];
    for (int r = lane; r < kQ; r += 32) {
      const float cr = cum[r];
      cum[2 * kQ + r] = expf(last - cr);
      cum[3 * kQ + r] = expf(cum[r | 15] - cr) * cum[kQ + r];
      cum[4 * kQ + r] = r >= 16 ? expf(cr - cum[(r & ~15) - 1]) : 1.f;
    }
    __syncwarp();
  };

  tc::stage_rows<N>(Bs, Bm + b * b_sb + t0 * b_sl, b_sl, q);
  tc::stage_rows<N>(Cs, Cm + b * c_sb + t0 * c_sl, c_sl, q);
  cp_async_wait_all();
  __syncthreads();
  {
    float cb[kPairs][2][4] = {};
#pragma unroll
    for (int ks = 0; ks < N / 16; ++ks) {
      uint32_t aC[4], aB[4];
      lda(aC, Cs, BS, r0, 16 * ks);
      lda(aB, Bs, BS, r0, 16 * ks);
#pragma unroll
      for (int kp = 0; kp < kPairs; ++kp) {
        const bool irole = kp <= warp;
        const int blk = irole ? kp : kp - 1;
        uint32_t r[4], a[4];
        ldb_nk(r, irole ? Bs : Cs, BS, 16 * blk, 16 * ks);
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = irole ? aC[e] : aB[e];
        mma2(cb[kp][0], cb[kp][1], a, r);
      }
    }
#pragma unroll
    for (int kp = 0; kp < kPairs; ++kp)
#pragma unroll
      for (int s = 0; s < 2; ++s)
        cbw[(2 * kp + s) * 32] =
            make_float4(cb[kp][s][0], cb[kp][s][1], cb[kp][s][2], cb[kp][s][3]);
  }
  __syncthreads();  // C is done with: its region takes x and dy
  fetch_xdy(h0);
  fetch_ds(h0, 0);
  if (warp == 0) {
    float d[4];
    tc::chunk_dt(dtb + h0 * dt_sh, dt_sl, q, d);
    vectors(d, h0, 0);
  }
  cp_async_wait_all();
  __syncthreads();

  float ws[kPairs][2][4] = {};
  for (int h = h0; h < h1; ++h) {
    const int buf = (h - h0) & 1;
    const bool next = h + 1 < h1;
    if (next) fetch_ds(h + 1, buf ^ 1);
    float dn[4];
    if (warp == 0) tc::chunk_dt(dtb + (next ? h + 1 : h) * dt_sh, dt_sl, q, dn);
    const bf16* dSh = dS0 + buf * ST;
    const bf16* dSl = dSh + P * BS;
    const float* cum = vec0 + buf * (5 * kQ);
    const float* dts = cum + kQ;
    const float* wend = dts + kQ;
    const float* fcol = wend + kQ;
    const float* hcol = fcol + kQ;

    // dyx (i role) and xdy (j role)
    float v[kPairs][2][4] = {};
#pragma unroll
    for (int ks = 0; ks < P / 16; ++ks) {
      uint32_t aY[4], aX[4];
      lda(aY, dys, XS, r0, 16 * ks);
      lda(aX, xs, XS, r0, 16 * ks);
#pragma unroll
      for (int kp = 0; kp < kPairs; ++kp) {
        const bool irole = kp <= warp;
        const int blk = irole ? kp : kp - 1;
        uint32_t r[4], a[4];
        ldb_nk(r, irole ? xs : dys, XS, 16 * blk, 16 * ks);
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = irole ? aY[e] : aX[e];
        mma2(v[kp][0], v[kp][1], a, r);
      }
    }

    // W from v, its strict row and column sums, the group's sum; on the
    // j rows G^T, split, and u = G^T dy
    const float cA = cum[ra], cB = cum[rb], dA_ = dts[ra], dB_ = dts[rb];
    float mA = 0.f, mB = 0.f;
    float u[P / 8][4] = {};
#pragma unroll
    for (int kp = 0; kp < kPairs; ++kp) {
      const bool irole = kp <= warp;
      const int blk = irole ? kp : kp - 1;
      float cb[2][4];
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const float4 c4 = cbw[(2 * kp + s) * 32];
        cb[s][0] = c4.x;
        cb[s][1] = c4.y;
        cb[s][2] = c4.z;
        cb[s][3] = c4.w;
      }
      if (irole && blk < warp) {      // rows i, columns j < i
        const float ce = cum[16 * blk + 15];
        const float fa = __expf(cA - ce), fb = __expf(cB - ce);
#pragma unroll
        for (int s = 0; s < 2; ++s)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float fc = fcol[16 * blk + 8 * s + 2 * t + e];
            const float wa = v[kp][s][e] * fa * fc;
            const float wb = v[kp][s][2 + e] * fb * fc;
            mA = fmaf(wa, cb[s][e], mA);
            mB = fmaf(wb, cb[s][2 + e], mB);
            ws[kp][s][e] += wa;
            ws[kp][s][2 + e] += wb;
          }
      } else if (irole) {             // rows i, the diagonal block
#pragma unroll
        for (int s = 0; s < 2; ++s)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 16 * blk + 8 * s + 2 * t + e;
            const float cc = cum[col], dc = dts[col];
            const float wa = v[kp][s][e] *
                             __expf(col <= ra ? cA - cc : -INFINITY) * dc;
            const float wb = v[kp][s][2 + e] *
                             __expf(col <= rb ? cB - cc : -INFINITY) * dc;
            if (col < ra) mA = fmaf(wa, cb[s][e], mA);
            if (col < rb) mB = fmaf(wb, cb[s][2 + e], mB);
            ws[kp][s][e] += wa;
            ws[kp][s][2 + e] += wb;
          }
      } else {                        // rows j, columns i >= j
        float gv[2][4];
        if (blk > warp) {             // i > j throughout
          const float cs = cum[16 * blk - 1];
          const float ga = __expf(cs - cA), gb = __expf(cs - cB);
#pragma unroll
          for (int s = 0; s < 2; ++s)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float hc = hcol[16 * blk + 8 * s + 2 * t + e];
              const float da = ga * hc, db = gb * hc;
              gv[s][e] = cb[s][e] * da;
              gv[s][2 + e] = cb[s][2 + e] * db;
              const float wa = v[kp][s][e] * da * dA_;
              const float wb = v[kp][s][2 + e] * db * dB_;
              mA = fmaf(-wa, cb[s][e], mA);
              mB = fmaf(-wb, cb[s][2 + e], mB);
              ws[kp][s][e] += wa;
              ws[kp][s][2 + e] += wb;
            }
        } else {                      // the diagonal block
#pragma unroll
          for (int s = 0; s < 2; ++s)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = 16 * blk + 8 * s + 2 * t + e;
              const float cc = cum[col];
              const float da = __expf(col >= ra ? cc - cA : -INFINITY);
              const float db = __expf(col >= rb ? cc - cB : -INFINITY);
              gv[s][e] = cb[s][e] * da;
              gv[s][2 + e] = cb[s][2 + e] * db;
              const float wa = v[kp][s][e] * da * dA_;
              const float wb = v[kp][s][2 + e] * db * dB_;
              if (col > ra) mA = fmaf(-wa, cb[s][e], mA);
              if (col > rb) mB = fmaf(-wb, cb[s][2 + e], mB);
              ws[kp][s][e] += wa;
              ws[kp][s][2 + e] += wb;
            }
        }
        uint32_t ah[4], al[4];
        split_frag(gv, ah, al);
#pragma unroll
        for (int pp = 0; pp < P / 16; ++pp) {
          uint32_t r[4];
          ldb_kn(r, dys, XS, 16 * blk, 16 * pp);
          mma2(u[2 * pp], u[2 * pp + 1], ah, r);
          mma2(u[2 * pp], u[2 * pp + 1], al, r);
        }
      }
    }

    // this warp's rows of x, for the epilogue; then x and dy are done with
    uint32_t xa[P / 8], xb[P / 8];
#pragma unroll
    for (int nt = 0; nt < P / 8; ++nt) {
      xa[nt] = *reinterpret_cast<const uint32_t*>(xs + ra * XS + 8 * nt + 2 * t);
      xb[nt] = *reinterpret_cast<const uint32_t*>(xs + rb * XS + 8 * nt + 2 * t);
    }
    __syncthreads();
    if (next) fetch_xdy(h + 1);

    // u2 = B dS^T
    float u2[P / 8][4] = {};
    if (has_ds) {
#pragma unroll
      for (int ks = 0; ks < N / 16; ++ks) {
        uint32_t aB[4];
        lda(aB, Bs, BS, r0, 16 * ks);
#pragma unroll
        for (int pp = 0; pp < P / 16; ++pp) {
          uint32_t rh[4], rl[4];
          ldb_nk(rh, dSh, BS, 16 * pp, 16 * ks);
          ldb_nk(rl, dSl, BS, 16 * pp, 16 * ks);
          mma2(u2[2 * pp], u2[2 * pp + 1], aB, rh);
          mma2(u2[2 * pp], u2[2 * pp + 1], aB, rl);
        }
      }
    }

    // dx = dt u, u = G^T dy + wend u2; x.u; K
    const float wa = wend[ra], wb = wend[rb];
    float xuA = 0.f, xuB = 0.f, kA = 0.f, kB = 0.f;
    bf16* dxb = dx + (((long long)b * L + t0) * H + h) * P;
    const long long dxs = (long long)H * P;
#pragma unroll
    for (int nt = 0; nt < P / 8; ++nt) {
      const int p = 8 * nt + 2 * t;
      const float2 fa = tc::unpack(xa[nt]), fb = tc::unpack(xb[nt]);
      const float uA0 = fmaf(wa, u2[nt][0], u[nt][0]);
      const float uA1 = fmaf(wa, u2[nt][1], u[nt][1]);
      const float uB0 = fmaf(wb, u2[nt][2], u[nt][2]);
      const float uB1 = fmaf(wb, u2[nt][3], u[nt][3]);
      xuA = fmaf(fa.x, uA0, fmaf(fa.y, uA1, xuA));
      xuB = fmaf(fb.x, uB0, fmaf(fb.y, uB1, xuB));
      kA = fmaf(fa.x, u2[nt][0], fmaf(fa.y, u2[nt][1], kA));
      kB = fmaf(fb.x, u2[nt][2], fmaf(fb.y, u2[nt][3], kB));
      if (ra < q)
        *reinterpret_cast<__nv_bfloat162*>(dxb + ra * dxs + p) =
            __floats2bfloat162_rn(dA_ * uA0, dA_ * uA1);
      if (rb < q)
        *reinterpret_cast<__nv_bfloat162*>(dxb + rb * dxs + p) =
            __floats2bfloat162_rn(dB_ * uB0, dB_ * uB1);
    }
    xuA = quad_sum(xuA);
    xuB = quad_sum(xuB);
    kA = quad_sum(kA);
    kB = quad_sum(kB);
    mA = quad_sum(mA);
    mB = quad_sum(mB);
    if (t == 0) {
      const long long at = ((long long)b * L + t0) * H + h;
      if (ra < q) {
        xu[at + (long long)ra * H] = xuA;
        v1[at + (long long)ra * H] = mA - wa * dA_ * kA;
      }
      if (rb < q) {
        xu[at + (long long)rb * H] = xuB;
        v1[at + (long long)rb * H] = mB - wb * dB_ * kB;
      }
    }
    if (warp == 0 && next) vectors(dn, h + 1, buf ^ 1);
    cp_async_wait_all();
    __syncthreads();  // the next head's copies and vectors have landed
  }

  // C back in for dB's W term
  tc::stage_rows<N>(Cs, Cm + b * c_sb + t0 * c_sl, c_sl, q);
  cp_async_wait_all();
  __syncthreads();
  // this group's W terms: dC (i role, against B), then dB (j role, against C)
#pragma unroll
  for (int role = 0; role < 2; ++role) {
    float acc[N / 8][4] = {};
#pragma unroll
    for (int kp = 0; kp < kPairs; ++kp) {
      const bool irole = kp <= warp;
      if (irole != (role == 0)) continue;
      const int blk = irole ? kp : kp - 1;
      uint32_t ah[4], al[4];
      split_frag(ws[kp], ah, al);
#pragma unroll
      for (int np = 0; np < N / 16; ++np) {
        uint32_t r[4];
        ldb_kn(r, irole ? Bs : Cs, BS, 16 * blk, 16 * np);
        mma2(acc[2 * np], acc[2 * np + 1], ah, r);
        mma2(acc[2 * np], acc[2 * np + 1], al, r);
      }
    }
    float* out = (role == 0 ? dCp : dBp) +
                 (((long long)b * G + grp) * L + t0) * N;
#pragma unroll
    for (int nt = 0; nt < N / 8; ++nt) {
      const int n = 8 * nt + 2 * t;
      if (ra < q)
        *reinterpret_cast<float2*>(out + (long long)ra * N + n) =
            make_float2(acc[nt][0], acc[nt][1]);
      if (rb < q)
        *reinterpret_cast<float2*>(out + (long long)rb * N + n) =
            make_float2(acc[nt][2], acc[nt][3]);
    }
  }
}

// Per (group of hg heads, chunk, batch row), 8 warps of 16 rows: the
// state terms of dC and dB, summed over the group's heads in registers,
// added to chunk_dx's W terms in place:
//   phase 1: dC_i += sum_h e^{cum_i} (dy_i S) (dy exact, S the state
//            before the chunk, split; off_i = C_i.(that term) to v1),
//   phase 2: dB_j += sum_h wend_j dt_j (x_j dS) (x exact, dS split).
// One buffer each, the copies staggered: the next head's dy and S are
// copied in while phase 2 runs, its x and dS while the next phase 1 runs
// (two cp.async groups in flight).
template <int P, int N>
__global__ void __launch_bounds__(kThreads, 1)
chunk_dbc(const bf16* __restrict__ x, const float* __restrict__ dt,
          const float* __restrict__ A, const bf16* __restrict__ Cm,
          const bf16* __restrict__ dy, const bf16* __restrict__ shl,
          const bf16* __restrict__ dshl, float* __restrict__ v1,
          float* __restrict__ dBp, float* __restrict__ dCp, int L, int H,
          int nc, int hg, long long x_sb, long long x_sl, long long x_sh,
          long long dt_sb, long long dt_sl, long long dt_sh, long long c_sb,
          long long c_sl, long long dy_sb, long long dy_sl, long long dy_sh) {
  constexpr int BS = N + kPad, XS = P + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Cs = reinterpret_cast<bf16*>(smem);  // [kQ][BS] C
  bf16* xs = Cs + kQ * BS;                   // [kQ][XS]
  bf16* dys = xs + kQ * XS;                  // [kQ][XS]
  bf16* Sh = dys + kQ * XS;                  // [2P][BS] S hi, then lo
  bf16* Sl = Sh + P * BS;
  bf16* dSh = Sl + P * BS;                   // [2P][BS] dS hi, then lo
  bf16* dSl = dSh + P * BS;
  float* cum = reinterpret_cast<float*>(dSl + P * BS);  // cum, dts scratch
  float* vec0 = cum + 2 * kQ;                // 2 x (ecum, wd)

  const int grp = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int G = gridDim.x, nc1 = nc - 1;
  const int h0 = grp * hg, h1 = min(H, h0 + hg);
  const int lane = threadIdx.x & 31, warp = tc::warp_uniform(threadIdx.x >> 5);
  const int g = lane >> 2, t = lane & 3;
  const int t0 = c * kQ, q = min(kQ, L - t0);
  const int r0 = 16 * warp, ra = r0 + g, rb = ra + 8;
  const bool has_s = c > 0, has_ds = c < nc1;
  if (!has_s && !has_ds) return;  // one chunk: no state terms
  const float* dtb = dt + b * dt_sb + t0 * dt_sl;
  const long long PN2 = 2LL * P * N;

  // group A (phase 1's dy and S) and group B (phase 2's x and dS) of head
  // h, each committed even when empty, so two groups are always in flight
  auto fetchA = [&](int h, bool on) {
    if (on && has_s) {
      tc::stage_rows<P>(dys, dy + b * dy_sb + t0 * dy_sl + h * dy_sh, dy_sl, q);
      stage_tile<2 * P, N>(Sh, shl + (((long long)b * nc1 + c - 1) * H + h) * PN2);
    }
    cp_async_commit();
  };
  auto fetchB = [&](int h, bool on) {
    if (on && has_ds) {
      tc::stage_rows<P>(xs, x + b * x_sb + t0 * x_sl + h * x_sh, x_sl, q);
      stage_tile<2 * P, N>(dSh, dshl + (((long long)b * nc1 + c) * H + h) * PN2);
    }
    cp_async_commit();
  };
  // warp 0: ecum = e^{cum} and wd = e^{cum_last - cum} dt of a head
  auto vectors = [&](const float (&d)[4], int h, int buf) {
    tc::chunk_scan(d, A[h], cum, cum + kQ);
    float* ecum = vec0 + buf * (2 * kQ);
    const float last = cum[kQ - 1];
    for (int r = lane; r < kQ; r += 32) {
      ecum[r] = expf(cum[r]);
      ecum[kQ + r] = expf(last - cum[r]) * cum[kQ + r];
    }
    __syncwarp();
  };

  tc::stage_rows<N>(Cs, Cm + b * c_sb + t0 * c_sl, c_sl, q);
  fetchA(h0, true);
  fetchB(h0, true);
  if (warp == 0) {
    float d[4];
    tc::chunk_dt(dtb + h0 * dt_sh, dt_sl, q, d);
    vectors(d, h0, 0);
  }
  float dC[N / 8][4] = {}, dB[N / 8][4] = {};
  for (int h = h0; h < h1; ++h) {
    const int buf = (h - h0) & 1;
    const bool next = h + 1 < h1;
    const float* ecum = vec0 + buf * (2 * kQ);
    const float* wd = ecum + kQ;
    float dn[4];
    if (warp == 0) tc::chunk_dt(dtb + (next ? h + 1 : h) * dt_sh, dt_sl, q, dn);
    cp_async_wait<1>();
    __syncthreads();  // group A of h (and C) has landed
    if (has_s) {
      float tmp[N / 8][4] = {};
#pragma unroll
      for (int ks = 0; ks < P / 16; ++ks) {
        uint32_t a[4];
        lda(a, dys, XS, r0, 16 * ks);
#pragma unroll
        for (int np = 0; np < N / 16; ++np) {
          uint32_t rh[4], rl[4];
          ldb_kn(rh, Sh, BS, 16 * ks, 16 * np);
          ldb_kn(rl, Sl, BS, 16 * ks, 16 * np);
          mma2(tmp[2 * np], tmp[2 * np + 1], a, rh);
          mma2(tmp[2 * np], tmp[2 * np + 1], a, rl);
        }
      }
      const float ea = ecum[ra], eb = ecum[rb];
      float oA = 0.f, oB = 0.f;
#pragma unroll
      for (int nt = 0; nt < N / 8; ++nt) {
        const int n = 8 * nt + 2 * t;
        const float2 ca = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(Cs + ra * BS + n));
        const float2 cbv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(Cs + rb * BS + n));
        const float a0 = ea * tmp[nt][0], a1 = ea * tmp[nt][1];
        const float b0 = eb * tmp[nt][2], b1 = eb * tmp[nt][3];
        oA = fmaf(ca.x, a0, fmaf(ca.y, a1, oA));
        oB = fmaf(cbv.x, b0, fmaf(cbv.y, b1, oB));
        dC[nt][0] += a0;
        dC[nt][1] += a1;
        dC[nt][2] += b0;
        dC[nt][3] += b1;
      }
      oA = quad_sum(oA);
      oB = quad_sum(oB);
      if (t == 0) {
        const long long at = ((long long)b * L + t0) * H + h;
        if (ra < q) v1[at + (long long)ra * H] += oA;
        if (rb < q) v1[at + (long long)rb * H] += oB;
      }
    }
    __syncthreads();  // dy and S are done with
    fetchA(h + 1, next);
    cp_async_wait<1>();
    __syncthreads();  // group B of h has landed
    if (has_ds) {
      float tmp[N / 8][4] = {};
#pragma unroll
      for (int ks = 0; ks < P / 16; ++ks) {
        uint32_t a[4];
        lda(a, xs, XS, r0, 16 * ks);
#pragma unroll
        for (int np = 0; np < N / 16; ++np) {
          uint32_t rh[4], rl[4];
          ldb_kn(rh, dSh, BS, 16 * ks, 16 * np);
          ldb_kn(rl, dSl, BS, 16 * ks, 16 * np);
          mma2(tmp[2 * np], tmp[2 * np + 1], a, rh);
          mma2(tmp[2 * np], tmp[2 * np + 1], a, rl);
        }
      }
      const float wa = wd[ra], wb = wd[rb];
#pragma unroll
      for (int nt = 0; nt < N / 8; ++nt) {
        dB[nt][0] = fmaf(wa, tmp[nt][0], dB[nt][0]);
        dB[nt][1] = fmaf(wa, tmp[nt][1], dB[nt][1]);
        dB[nt][2] = fmaf(wb, tmp[nt][2], dB[nt][2]);
        dB[nt][3] = fmaf(wb, tmp[nt][3], dB[nt][3]);
      }
    }
    if (warp == 0 && next) vectors(dn, h + 1, buf ^ 1);
    __syncthreads();  // x and dS are done with; the next vectors are in
    fetchB(h + 1, next);
  }
  cp_async_wait<0>();
  const long long base = (((long long)b * G + grp) * L + t0) * N;
#pragma unroll
  for (int nt = 0; nt < N / 8; ++nt) {
    const int n = 8 * nt + 2 * t;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = half ? rb : ra;
      if (r >= q) continue;
      float2* pc = reinterpret_cast<float2*>(dCp + base + (long long)r * N + n);
      float2* pb = reinterpret_cast<float2*>(dBp + base + (long long)r * N + n);
      float2 vc = *pc, vb = *pb;
      vc.x += dC[nt][2 * half];
      vc.y += dC[nt][2 * half + 1];
      vb.x += dB[nt][2 * half];
      vb.y += dB[nt][2 * half + 1];
      *pc = vc;
      *pb = vb;
    }
  }
}

// Per (4 heads, chunk, batch row), a warp a head, 4 rows a lane: dcum =
// v1 (rowm - colm + off - K) plus <dS, S after> on the chunk's last row,
// its reverse cumsum R, ddt = A R + x.u (xu, read from and written to
// ddt), and this chunk's part of dA, sum_t dt_t R_t.
__global__ void __launch_bounds__(128)
chunk_rows(const float* __restrict__ dt, const float* __restrict__ A,
           const float* __restrict__ v1, const float* __restrict__ sdp,
           float* __restrict__ ddt, float* __restrict__ dAp, int L, int H,
           int nc, int slices, long long dt_sb, long long dt_sl,
           long long dt_sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int h = blockIdx.x * 4 + warp, c = blockIdx.y, b = blockIdx.z;
  if (h >= H) return;
  const int t0 = c * kQ, q = min(kQ, L - t0), nc1 = nc - 1;
  const long long at = ((long long)b * L + t0) * H + h;
  float d[4], dtv[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int r = 4 * lane + e;
    const bool in = r < q;
    d[e] = in ? v1[at + (long long)r * H] : 0.f;
    dtv[e] = in ? dt[b * dt_sb + (t0 + r) * dt_sl + h * dt_sh] : 0.f;
  }
  if (c < nc1 && lane == 31) {  // not the last chunk: q = kQ
    const float* sp = sdp + (((long long)b * nc1 + c) * H + h) * slices;
    float sd = 0.f;
    for (int s = 0; s < slices; ++s) sd += sp[s];
    d[3] += sd;
  }
  float R[4];
  R[3] = d[3];
  R[2] = R[3] + d[2];
  R[1] = R[2] + d[1];
  R[0] = R[1] + d[0];
  float incl = R[0];
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_down_sync(0xffffffffu, incl, o);
    if (lane + o < 32) incl += v;
  }
  float later = __shfl_down_sync(0xffffffffu, incl, 1);
  if (lane == 31) later = 0.f;
  const float a = A[h];
  float pa = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int r = 4 * lane + e;
    const float Rt = later + R[e];
    if (r < q) ddt[at + (long long)r * H] = fmaf(a, Rt, ddt[at + (long long)r * H]);
    pa = fmaf(dtv[e], Rt, pa);
  }
  pa = bwd::warp_sum(pa);
  if (lane == 0) dAp[((long long)b * nc + c) * H + h] = pa;
}

// dB, dC (batch, L, N) = the groups' parts (batch, G, L, N) summed in
// group order, cast to bf16.
__global__ void __launch_bounds__(256)
sum_groups(const float* __restrict__ dBp, const float* __restrict__ dCp,
           bf16* __restrict__ dB, bf16* __restrict__ dC, int G, long long LN,
           long long total) {
  const long long idx = (long long)blockIdx.x * 256 + threadIdx.x;
  if (idx >= total) return;
  const long long b = idx / LN, r = idx - b * LN;
  const float* pb = dBp + b * G * LN + r;
  const float* pc = dCp + b * G * LN + r;
  float sb = 0.f, sc = 0.f;
  for (int k = 0; k < G; ++k) {
    sb += pb[k * LN];
    sc += pc[k * LN];
  }
  dB[idx] = __float2bfloat16(sb);
  dC[idx] = __float2bfloat16(sc);
}

template <int P, int N>
int launch(const bf16* x, const float* dt, const float* A, const bf16* Bm,
           const bf16* Cm, const bf16* dy, bf16* dx, float* ddt, float* dA,
           bf16* dB, bf16* dC, int batch, int L, int H, int hg,
           const long long* s, const float* states, float* D, bf16* dshl,
           bf16* shl, float* clr, float* sdp, float* v1, float* dBp,
           float* dCp, float* dAp, cudaStream_t st) {
  const int nc = (L + kQ - 1) / kQ, nc1 = nc - 1, G = (H + hg - 1) / hg;
  const int pn4 = P * N / 4;
  const int slices = (pn4 + kScanThreads - 1) / kScanThreads;
  cudaError_t e;
  if (nc1 > 0) {
    e = cudaFuncSetAttribute(tc::chunk_state<P, N, true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             tc::state_smem(P, N));
    if (e != cudaSuccess) return (int)e;
    tc::chunk_state<P, N, true><<<dim3(H, nc1, batch), kThreads,
                                  tc::state_smem(P, N), st>>>(
        dy, dt, A, Cm, D, clr, L, H, nc1, s[10], s[11], s[12], s[3], s[4],
        s[5], s[8], s[9]);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    dstate_pass<<<dim3(slices, H, batch), kScanThreads, 0, st>>>(
        D, clr, states, dshl, shl, sdp, H, nc1, pn4);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  e = cudaFuncSetAttribute(chunk_dx<P, N>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           dx_smem(P, N));
  if (e != cudaSuccess) return (int)e;
  chunk_dx<P, N><<<dim3(G, nc, batch), kThreads, dx_smem(P, N), st>>>(
      x, dt, A, Bm, Cm, dy, dshl, dx, ddt, v1, dBp, dCp, L, H, nc, hg, s[0],
      s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9], s[10], s[11],
      s[12]);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(chunk_dbc<P, N>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           dbc_smem(P, N));
  if (e != cudaSuccess) return (int)e;
  chunk_dbc<P, N><<<dim3(G, nc, batch), kThreads, dbc_smem(P, N), st>>>(
      x, dt, A, Cm, dy, shl, dshl, v1, dBp, dCp, L, H, nc, hg, s[0], s[1],
      s[2], s[3], s[4], s[5], s[8], s[9], s[10], s[11], s[12]);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  chunk_rows<<<dim3((H + 3) / 4, nc, batch), 128, 0, st>>>(
      dt, A, v1, sdp, ddt, dAp, L, H, nc, slices, s[3], s[4], s[5]);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const long long LN = (long long)L * N, total = batch * LN;
  sum_groups<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(dBp, dCp, dB,
                                                             dC, G, LN, total);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  bwd::sum_da<<<(H + bwd::kThreads - 1) / bwd::kThreads, bwd::kThreads, 0,
                st>>>(dAp, dA, batch * nc, H);
  return (int)cudaGetLastError();
}

template <int P>
int launch_n(int N, const bf16* x, const float* dt, const float* A,
             const bf16* Bm, const bf16* Cm, const bf16* dy, bf16* dx,
             float* ddt, float* dA, bf16* dB, bf16* dC, int batch, int L,
             int H, int hg, const long long* s, const float* states,
             float* D, bf16* dshl, bf16* shl, float* clr, float* sdp,
             float* v1, float* dBp, float* dCp, float* dAp, cudaStream_t st) {
#define TCB_LAUNCH(NN)                                                       \
  return launch<P, NN>(x, dt, A, Bm, Cm, dy, dx, ddt, dA, dB, dC, batch, L, \
                       H, hg, s, states, D, dshl, shl, clr, sdp, v1, dBp,   \
                       dCp, dAp, st)
  switch (N) {
    case 16: TCB_LAUNCH(16);
    case 32: TCB_LAUNCH(32);
    case 64: TCB_LAUNCH(64);
    case 128: TCB_LAUNCH(128);
  }
#undef TCB_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace tcb

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

// Shared memory the backward's largest block needs, in bytes.
long long ssd_bwd_smem_bytes(int N, int P) {
  const long long a = bwd::main_floats(N, P), b = bwd::own_floats(N, P);
  return (a > b ? a : b) * (long long)sizeof(float);
}

// The float32 backward (`bwd::`, parity checks): x, B, C, dy, dx, dB and
// dC float32, as are dt, ddt, A and dA; P and N multiples of 4.  Element
// strides: x and dy (batch, L, H) with P contiguous; dt (batch, L, H); B
// and C (batch, L) with N contiguous.  dx (batch, L, H, P), ddt (batch, L,
// H) and dB, dC (batch, L, N) contiguous.  fp32 scratch, with nc =
// ceil(L / 64): `states` and `dstates` (batch, nc, H, P, N), `cumlast` and
// `dAp` (batch, nc, H), `dBp` and `dCp` (batch, H, L, N).
int ssd_bwd(const void* x, const void* dt, const void* A, const void* Bm,
            const void* Cm, const void* dy, void* dx, void* ddt, void* dA,
            void* dB, void* dC, int batch, int L, int H, int P, int N,
            long long x_sb, long long x_sl, long long x_sh, long long dt_sb,
            long long dt_sl, long long dt_sh, long long b_sb, long long b_sl,
            long long c_sb, long long c_sl, long long dy_sb, long long dy_sl,
            long long dy_sh, void* states, void* dstates, void* cumlast,
            void* dBp, void* dCp, void* dAp, void* stream) {
  if (batch == 0 || L == 0 || H == 0) return 0;
  if (P % 4 || N % 4 || P <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  const long long s[13] = {x_sb, x_sl, x_sh, dt_sb, dt_sl, dt_sh, b_sb,
                           b_sl, c_sb, c_sl, dy_sb, dy_sl, dy_sh};
  return bwd::launch((const float*)x, (const float*)dt, (const float*)A,
                     (const float*)Bm, (const float*)Cm, (const float*)dy,
                     (float*)dx, (float*)ddt, (float*)dA, (float*)dB,
                     (float*)dC, batch, L, H, P, N, s, (float*)states,
                     (float*)dstates, (float*)cumlast, (float*)dBp,
                     (float*)dCp, (float*)dAp, (cudaStream_t)stream);
}

// The bfloat16 backward (`tcb::`, tensor cores): x, B, C, dy, dx, dB and
// dC bfloat16; dt, ddt, A and dA float32.  P in {16, 32, 64}, N in {16,
// 32, 64, 128}; x, B, C and dy 16-byte aligned with strides that are
// multiples of 8 elements (strides as ssd_bwd's); dx, ddt, dB, dC
// contiguous.  `hg` heads a group.  With nc = ceil(L / 128), nc1 = nc -
// 1, G = ceil(H / hg), slices = ceil(P N / 1024): `states` (batch, nc1, H,
// P, N) fp32, the forward's (ssd_fwd's `states` after the call); scratch
// `D` (batch, nc1, H, P, N) fp32, `dshl` and `shl` (batch, nc1, H, 2, P,
// N) bf16, `clr` (batch, nc1, H), `sdp` (batch, nc1, H, slices), `v1`
// (batch, L, H), `dBp` and `dCp` (batch, G, L, N), `dAp` (batch, nc, H),
// all fp32 but dshl and shl.
int ssd_bwd_tc(const void* x, const void* dt, const void* A, const void* Bm,
               const void* Cm, const void* dy, void* dx, void* ddt, void* dA,
               void* dB, void* dC, int batch, int L, int H, int P, int N,
               int hg, long long x_sb, long long x_sl, long long x_sh,
               long long dt_sb, long long dt_sl, long long dt_sh,
               long long b_sb, long long b_sl, long long c_sb, long long c_sl,
               long long dy_sb, long long dy_sl, long long dy_sh,
               const void* states, void* D, void* dshl, void* shl, void* clr,
               void* sdp, void* v1, void* dBp, void* dCp, void* dAp,
               void* stream) {
  if (batch == 0 || L == 0 || H == 0) return 0;
  if (hg < 1) return (int)cudaErrorInvalidValue;
  const long long s[13] = {x_sb, x_sl, x_sh, dt_sb, dt_sl, dt_sh, b_sb,
                           b_sl, c_sb, c_sl, dy_sb, dy_sl, dy_sh};
  typedef __nv_bfloat16 bf16;
#define TCB_P(PP)                                                             \
  return tcb::launch_n<PP>(                                                   \
      N, (const bf16*)x, (const float*)dt, (const float*)A, (const bf16*)Bm,  \
      (const bf16*)Cm, (const bf16*)dy, (bf16*)dx, (float*)ddt, (float*)dA,   \
      (bf16*)dB, (bf16*)dC, batch, L, H, hg, s, (const float*)states,         \
      (float*)D, (bf16*)dshl, (bf16*)shl, (float*)clr, (float*)sdp,           \
      (float*)v1, (float*)dBp, (float*)dCp, (float*)dAp, (cudaStream_t)stream)
  switch (P) {
    case 16: TCB_P(16);
    case 32: TCB_P(32);
    case 64: TCB_P(64);
  }
#undef TCB_P
  return (int)cudaErrorInvalidValue;
}

const char* error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
