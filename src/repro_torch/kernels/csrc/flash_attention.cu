// Flash-attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel `flash_attention_kernel` / `_kernel` in
// src/repro/kernels/flash_attention/flash_attention.py (wrapped there by
// ops.py `flash_attention` / `_flash_attention_fwd_impl`).  Both routes
// compute GQA attention with an online softmax: fp32 scores, running max,
// denominator and accumulator; KV head h / G; causal and sliding-window
// masks from int32 position vectors; optional tanh softcap; masked scores
// take the finite NEG_INF = -2^30, so a fully masked row averages V as the
// reference does; final divide by max(l, 1e-37).  No padding: ragged rows
// and keys are masked by index, so keys past T never count, causal or not
// (the TPU wrapper pads T and, non-causal, attends the zero keys).
//
// Two routes, chosen by dtype through the one C entry point:
//
// bfloat16 -> `tc::flash_fwd_tc`, the tensor-core kernel every serving path
// runs.  Bound on an H100 (989 TFLOP/s bf16, 3.35 TB/s): smollm-360m's
// prefill (B=4, S=T=1024, H=15, K=5, D=64, causal) is 8.06 GFLOP over
// 21.0 MB, bound by operations at 8.15 us; zamba2-2.7b's (B=2, S=T=1024,
// H=K=32, D=80, causal) is 10.75 GFLOP over 41.9 MB, bound by bytes at
// 12.5 us (no GQA: K and V are as large as Q).
// Measured (chip_smoke.py phase 2b, H100 SXM at 700 W): 0.0439 ms and
// 0.0569 ms, 5.4x and 4.5x those bounds; scaled_dot_product_attention
// takes 0.0335 ms and 0.0475 ms there.
// - CTA: 128 query rows of one (batch, q-head); two consumer warpgroups of
//   64 rows (wgmma M = 64) and one producer warpgroup, of which one warp
//   picks the tiles and one thread issues every TMA load; setmaxnreg moves
//   registers to the consumers (232 each against the producer's 40).  The
//   grid runs the last (for causal prefill the heaviest) query tiles
//   first, heads fastest, so the G q-heads of a KV head run side by side
//   and share its tiles in L2.
// - Loads: TMA (cp.async.bulk.tensor, 4-d maps over the strided
//   (B, S, H, D) tensors, descriptors made per call through
//   cudaGetDriverEntryPoint, so no -lcuda).  Q once per CTA; K and V tiles
//   of BK rows through a ring of STAGES stages with full and empty
//   barriers for K and for V apart, so Q.K^T starts before V lands and K
//   frees its stage before P.V is done.  The producer also stages each
//   tile's key positions in shared memory.
// - Layout: rows of 64 bf16 (128 bytes, the 128B swizzle span).  A head
//   dim above 64 is split into 64-column blocks, one TMA box each; columns
//   past D, and rows past S or T, are zero-filled by TMA.  So D = 80 takes
//   two blocks (128 columns), of which Q.K^T reads 5 k16 steps and P.V
//   computes 128 output columns and stores 80.
// - S = Q.K^T: wgmma m64nBKk16, A = Q and B = K both K-major in shared
//   memory, fp32 accumulators.  Softmax on the fragment in registers, in
//   log2 units (exp2): scale, softcap, mask (the reference's order); the
//   row max and sum reduce over the 4 threads of a row.  P is rounded to
//   bf16 and reused in place as wgmma's A fragment (the accumulator and A
//   layouts coincide); l sums the rounded P, so the output is a true
//   weighted average of V.  O += P.V: wgmma m64nNPVk16 with A from
//   registers and V MN-major (the transpose bit), 64-column blocks LBO
//   apart.
// - Overlap (FlashAttention-3's schedules): a warpgroup issues Q.K^T of
//   tile t and P.V of tile t-1 together and runs the softmax of tile t
//   while P.V runs; the two warpgroups take turns at the tensor cores
//   (named barriers), so one issues while the other computes its softmax.
//   ptxas serialises every wgmma of the kernel (C7515) if any register a
//   wgmma in flight reads or writes is touched, or a branch joins, before
//   the wait: hence the fence_regs pins, the warp-uniform loop conditions
//   and the P.V issued on every tile (P = 0 before the first).
// - Tiles by class, from the min and max key position of the tile against
//   the query positions: fully visible to the warpgroup's rows (no
//   per-element mask), partial (mask on the fragment, branch-free, from the
//   staged positions), invisible to every row of the CTA (not loaded, or
//   skipped by both warpgroups) -- skipped only when every real row of the
//   CTA sees some key, as the fp32 route.  The consumers settle that rule
//   in a prologue while the producer already loads the first tiles.  A
//   tile invisible to one warpgroup alone is computed, fully masked, by it.
// - Sizes: D <= 64: BK = 128, 3 stages (113 KB of shared memory); D <= 128:
//   BK = 128, 2 stages (161 KB); D <= 256: BK = 64, 2 stages (193 KB),
//   chosen so S, O and P fit the consumers' 232 registers.
// Left on the table: at D = 64 each score gets only 128 MACs per exp2, so
// the multi-function unit (exp2 and the bf16 packs) and the issue slots of
// two warps per SM sub-partition, more than the tensor cores, likely set
// the pace; exp2 could be shared with an FMA polynomial.  One CTA per SM
// pays its prologue, first loads and epilogue in the open (a persistent
// grid would overlap them).
// D = 80 computes 128 output columns; the G q-heads of a KV head do not
// share one CTA; the output is stored from registers, not through TMA.
//
// float32 -> `flash_fwd`, the scalar kernel: fp32 FMAs from shared memory,
// exact to ~1e-6, for parity checks (TF32 tensor cores could not meet
// 2e-5).  One block of 256 threads per (query tile of 64 rows, q-head,
// batch) loops over 64-row KV tiles staged as fp32; thread (r = tid / 4,
// c = tid % 4) owns query row r, scores for keys c, c+4, ..., c+60 and
// output columns c, c+4, ..., reducing over the row's four threads with
// shuffles.  A KV tile no row of the query tile can see is skipped, under
// the same rule as above.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;
constexpr int kPS = kBK + 1;                 // row stride of the P tile
constexpr float kNegInf = -1073741824.0f;    // -2^30, as in the reference
constexpr int kErrTensorMap = -1;            // error code: TMA refused a map

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* q_pos;
  const int* k_pos;
  void* out;
  int S, T, H, D, G;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  float scale;
  int causal;
  int window;     // 0 = no window
  float softcap;  // 0 = no softcap
};

__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

__device__ __forceinline__ bool visible(int qp, int kp, int causal, int window) {
  if (!causal) return true;
  if (kp > qp) return false;
  return window <= 0 || (long long)qp - (long long)kp < (long long)window;
}

template <typename T, int kDMax>
__global__ void __launch_bounds__(kThreads) flash_fwd(const Params p) {
  extern __shared__ float smem[];
  const int D = p.D;
  const int DP = D + 1;                       // padded row: no bank conflicts
  float* q_s = smem;                          // kBQ x DP
  float* k_s = q_s + kBQ * DP;                // kBK x DP
  float* v_s = k_s + kBK * DP;                // kBK x DP
  float* p_s = v_s + kBK * DP;                // kBQ x kPS
  int* kp_s = reinterpret_cast<int*>(p_s + kBQ * kPS);  // kBK

  const int tid = threadIdx.x;
  const int r = tid >> 2;
  const int c = tid & 3;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / p.G;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + kh * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + kh * p.v_sh;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int rr = e / D, dd = e - rr * D;
    const int s = q0 + rr;
    q_s[rr * DP + dd] = s < p.S ? to_f(q[s * p.q_ss + dd]) : 0.f;
  }

  const int qi = q0 + r;
  const bool row_ok = qi < p.S;
  const int qp = row_ok ? p.q_pos[qi] : 0;

  // Does every real row of this tile see at least one key?
  int seen = !row_ok;
  for (int j = c; j < p.T && !seen; j += 4)
    seen = visible(qp, p.k_pos[j], p.causal, p.window);
  seen |= __shfl_xor_sync(0xffffffffu, seen, 1);
  seen |= __shfl_xor_sync(0xffffffffu, seen, 2);
  const bool may_skip = __syncthreads_and(seen);

  float m = kNegInf, l = 0.f;
  float acc[kDMax / 4];
#pragma unroll
  for (int i = 0; i < kDMax / 4; ++i) acc[i] = 0.f;

  const int nk = (p.T + kBK - 1) / kBK;
  for (int t = 0; t < nk; ++t) {
    const int k0 = t * kBK;
    __syncthreads();                          // last tile's smem reads done
    if (tid < kBK) kp_s[tid] = k0 + tid < p.T ? p.k_pos[k0 + tid] : 0;
    __syncthreads();

    unsigned vis = 0;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int j = c + 4 * i;
      if (row_ok && k0 + j < p.T && visible(qp, kp_s[j], p.causal, p.window))
        vis |= 1u << i;
    }
    if (may_skip && !__syncthreads_or(vis != 0)) continue;

    for (int e = tid; e < kBK * D; e += kThreads) {
      const int jj = e / D, dd = e - jj * D;
      const int kk = k0 + jj;
      const bool ok = kk < p.T;
      k_s[jj * DP + dd] = ok ? to_f(k[kk * p.k_ss + dd]) : 0.f;
      v_s[jj * DP + dd] = ok ? to_f(v[kk * p.v_ss + dd]) : 0.f;
    }
    __syncthreads();

    float s[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) s[i] = 0.f;
    for (int dd = 0; dd < D; ++dd) {
      const float qv = q_s[r * DP + dd];
#pragma unroll
      for (int i = 0; i < 16; ++i) s[i] += qv * k_s[(c + 4 * i) * DP + dd];
    }

    float mt = kNegInf;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      float x = s[i] * p.scale;
      if (p.softcap > 0.f) x = tanhf(x / p.softcap) * p.softcap;
      if (!((vis >> i) & 1u)) x = kNegInf;
      s[i] = x;
      if (k0 + c + 4 * i < p.T) mt = fmaxf(mt, x);
    }
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
    const float m_new = fmaxf(m, mt);
    const float alpha = expf(m - m_new);

    float ls = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float pv = k0 + c + 4 * i < p.T ? expf(s[i] - m_new) : 0.f;
      p_s[r * kPS + c + 4 * i] = pv;
      ls += pv;
    }
    ls += __shfl_xor_sync(0xffffffffu, ls, 1);
    ls += __shfl_xor_sync(0xffffffffu, ls, 2);
    l = l * alpha + ls;
    m = m_new;
    __syncwarp();                             // the row's P is in one warp

#pragma unroll
    for (int i = 0; i < kDMax / 4; ++i) acc[i] *= alpha;
    for (int j = 0; j < kBK; ++j) {
      const float pj = p_s[r * kPS + j];
#pragma unroll
      for (int i = 0; i < kDMax / 4; ++i) {
        const int col = c + 4 * i;
        if (col < D) acc[i] += pj * v_s[j * DP + col];
      }
    }
  }

  if (row_ok) {
    const float denom = fmaxf(l, 1e-37f);
    T* o = static_cast<T*>(p.out) + ((long long)(b * p.S + qi) * p.H + h) * D;
#pragma unroll
    for (int i = 0; i < kDMax / 4; ++i) {
      const int col = c + 4 * i;
      if (col < D) o[col] = from_f<T>(acc[i] / denom);
    }
  }
}

template <typename T, int kDMax>
int launch(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = (size_t)(3 * kBQ * (p.D + 1) + kBQ * kPS) * sizeof(float)
                      + kBK * sizeof(int);
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd<T, kDMax>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((p.S + kBQ - 1) / kBQ), (unsigned)p.H, (unsigned)B);
  flash_fwd<T, kDMax><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const Params& p, int B, cudaStream_t stream) {
  if (p.D <= 64) return launch<T, 64>(p, B, stream);
  if (p.D <= 128) return launch<T, 128>(p, B, stream);
  return launch<T, 256>(p, B, stream);
}

// ---------------------------------------------------------------------------
// bfloat16: the tensor-core kernel (wgmma, TMA, warp-specialised).
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kBQ = 128;          // query rows of a CTA: two warpgroups of 64
constexpr int kConsumers = 256;   // threads 0..255: consumer warpgroups 0, 1
constexpr int kThreads = 384;     // threads 256..383: the producer warpgroup
constexpr uint32_t kRow = 128;    // bytes of a tile row: 64 bf16, one swizzle span
constexpr float kNegInf = -1073741824.0f;
constexpr float kLog2e = 1.4426950408889634f;

struct TcParams {
  const int* q_pos;
  const int* k_pos;
  __nv_bfloat16* out;
  int S, T, H, D, G, nq;
  float scale_log2;   // scale * log2(e): scores go to exp2 directly
  float scale;
  float softcap;      // 0 = no softcap
  int causal;
  int window;         // 0 = no window
  // coordinate (1..3) of the head, row and batch dimension in each tensor
  // map (q, k, v); coordinate 0 is the head dimension D
  int slot[3][3];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Wait until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One TMA load of a (64 columns x rows) box into 128B-swizzled shared memory.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(bar)
      : "memory");
}

// Coordinates of (head, row, batch) in the map's order of dimensions.
__device__ __forceinline__ void tma_coords(const int (&slot)[3], int h, int s,
                                           int b, int& c1, int& c2, int& c3) {
  const int v[3] = {h, s, b};
  c1 = slot[0] == 1 ? v[0] : slot[1] == 1 ? v[1] : v[2];
  c2 = slot[0] == 2 ? v[0] : slot[1] == 2 ? v[1] : v[2];
  c3 = slot[0] == 3 ? v[0] : slot[1] == 3 ? v[1] : v[2];
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

// Named barriers among the consumer threads (0 is __syncthreads).
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
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

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], uint32_t a0, uint32_t a1,
                                             uint32_t a2, uint32_t a3, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db),
        "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128], uint32_t a0, uint32_t a1,
                                             uint32_t a2, uint32_t a3, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db),
        "r"(scale_d));
}


// No query with position in [qlo, qhi] sees a key with position in [lo, hi].
__device__ __forceinline__ bool invisible(const TcParams& p, int qlo, int qhi,
                                          int lo, int hi) {
  if (!p.causal) return false;
  return lo > qhi ||
         (p.window > 0 && (long long)qlo - (long long)hi >= (long long)p.window);
}

// Every query with position in [qlo, qhi] sees every key in [lo, hi].
__device__ __forceinline__ bool all_visible(const TcParams& p, int qlo, int qhi,
                                            int lo, int hi) {
  if (!p.causal) return true;
  return hi <= qlo &&
         (p.window <= 0 || (long long)qhi - (long long)lo < (long long)p.window);
}

// Scores of one tile in log2 units, in the reference's order: scale, tanh
// softcap, mask (positions `kpos` of the tile's keys, in shared memory).
// Masked keys take NEG_INF; keys past T take -inf, so they leave the row
// max alone and get weight exactly 0.  Returns the maxima of this thread's
// two rows.
template <int BK, bool kMask, bool kCap>
__device__ __forceinline__ void scores(float (&s)[BK / 2], const TcParams& p,
                                       const int* kpos, int k0, int lane,
                                       int qp0, int qp1, float& mx0,
                                       float& mx1) {
  // s[i] is key 8 * (i / 4) + 2 * (lane % 4) + i % 2 of the tile, row i / 2 % 2
  int2 kp[BK / 8];
  if (kMask) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
      kp[j] = *reinterpret_cast<const int2*>(kpos + 8 * j + 2 * (lane & 3));
  }
  const int cb = k0 + 2 * (lane & 3);
  mx0 = -INFINITY;
  mx1 = -INFINITY;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    float x = s[i];
    if (kCap)
      x = tanhf(x * p.scale / p.softcap) * (p.softcap * kLog2e);
    else
      x *= p.scale_log2;
    if (kMask) {
      const int key = (i & 1) ? kp[i >> 2].y : kp[i >> 2].x;
      const int qp = (i & 2) ? qp1 : qp0;
      // visible(): with key <= qp, qp - key fits an unsigned 32-bit int
      const bool vis = !p.causal || (key <= qp && (p.window <= 0 ||
                       (unsigned)(qp - key) < (unsigned)p.window));
      x = vis ? x : kNegInf;
      x = cb + 8 * (i >> 2) + (i & 1) < p.T ? x : -INFINITY;
    }
    s[i] = x;
    if (i & 2)
      mx1 = fmaxf(mx1, x);
    else
      mx0 = fmaxf(mx0, x);
  }
}

template <int BK, int NPV, int STAGES, int NKD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_tc(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v, const TcParams p) {
  constexpr int NCH = NPV / 64;                // 64-column blocks of a row
  constexpr uint32_t kQChunk = kBQ * kRow;     // one 64-column block of Q
  constexpr uint32_t kKVChunk = BK * kRow;     // one of a K or V tile
  constexpr uint32_t kQBytes = NCH * kQChunk;
  constexpr uint32_t kKVBytes = NCH * kKVChunk;

  extern __shared__ uint8_t smem_raw[];
  // barriers: Q; prologue done; per stage K full, V full, K empty, V empty
  __shared__ __align__(8) uint64_t bars[2 + 4 * STAGES];
  __shared__ int s_tile[STAGES][3];            // tile index (-1: end), key range
  __shared__ __align__(16) int s_kpos[STAGES][BK];   // the tile's key positions
  __shared__ int s_qlo[4], s_qhi[4], s_kmin, s_unseen, s_skip;

  // 128B-swizzled tiles need 1024-byte alignment
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sK = sQ + kQBytes;
  const uint32_t sV = sK + STAGES * kKVBytes;
  const uint32_t bar_q = smem_u32(&bars[0]);
  const uint32_t bar_pro = bar_q + 8u;
  auto full_k = [&](int s) { return bar_q + 8u * (2 + s); };
  auto full_v = [&](int s) { return bar_q + 8u * (2 + STAGES + s); };
  auto empty_k = [&](int s) { return bar_q + 8u * (2 + 2 * STAGES + s); };
  auto empty_v = [&](int s) { return bar_q + 8u * (2 + 3 * STAGES + s); };

  const int tid = threadIdx.x, lane = tid & 31;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (p.nq - 1 - (int)blockIdx.z) * kBQ;   // heaviest tiles first
  const int kh = h / p.G;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    mbar_init(bar_pro, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty_k(s), 8);             // one arrival per consumer warp
      mbar_init(empty_v(s), 8);
    }
    s_kmin = INT_MAX;
    s_unseen = 0;
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // ---- producer warpgroup: warp 0 picks the tiles, its lane 0 loads ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (tid - kConsumers < 32) {
      const int nk = (p.T + BK - 1) / BK;
      int c1, c2, c3;
      if (lane == 0) {
        mbar_expect_tx(bar_q, kQBytes);
        tma_coords(p.slot[0], h, q0, b, c1, c2, c3);
        for (int c = 0; c < NCH; ++c)
          tma_load(sQ + c * kQChunk, &tm_q, bar_q, 64 * c, c1, c2, c3);
      }
      // The first STAGES tiles load before the consumers' prologue decides
      // whether invisible tiles may be skipped; the consumers skip their
      // work on such a tile themselves.
      bool known = false, may_skip = false;
      int qlo = 0, qhi = 0;
      int stage = 0;
      uint32_t phase = 0;
      for (int t = 0; t < nk; ++t) {
        int kp[BK / 32];                      // key positions of the tile
        int lo = INT_MAX, hi = INT_MIN;
#pragma unroll
        for (int i = 0; i < BK / 32; ++i) {
          const int j = t * BK + lane + 32 * i;
          kp[i] = j < p.T ? __ldg(p.k_pos + j) : 0;
          if (j < p.T) {
            lo = min(lo, kp[i]);
            hi = max(hi, kp[i]);
          }
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
          hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
        }
        if (!known && t >= STAGES) {
          mbar_wait(bar_pro, 0);
          known = true;
          may_skip = s_skip;
          qlo = min(min(s_qlo[0], s_qlo[1]), min(s_qlo[2], s_qlo[3]));
          qhi = max(max(s_qhi[0], s_qhi[1]), max(s_qhi[2], s_qhi[3]));
        }
        if (may_skip && invisible(p, qlo, qhi, lo, hi)) continue;
        if (lane == 0) mbar_wait(empty_k(stage), phase ^ 1u);
        __syncwarp();
#pragma unroll
        for (int i = 0; i < BK / 32; ++i) s_kpos[stage][lane + 32 * i] = kp[i];
        __syncwarp();
        if (lane == 0) {
          const uint32_t off = stage * kKVBytes;
          s_tile[stage][0] = t;
          s_tile[stage][1] = lo;
          s_tile[stage][2] = hi;
          mbar_expect_tx(full_k(stage), kKVBytes);   // releases s_tile, s_kpos
          tma_coords(p.slot[1], kh, t * BK, b, c1, c2, c3);
          for (int c = 0; c < NCH; ++c)
            tma_load(sK + off + c * kKVChunk, &tm_k, full_k(stage), 64 * c, c1,
                     c2, c3);
          mbar_wait(empty_v(stage), phase ^ 1u);
          mbar_expect_tx(full_v(stage), kKVBytes);
          tma_coords(p.slot[2], kh, t * BK, b, c1, c2, c3);
          for (int c = 0; c < NCH; ++c)
            tma_load(sV + off + c * kKVChunk, &tm_v, full_v(stage), 64 * c, c1,
                     c2, c3);
        }
        __syncwarp();
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1u;
        }
      }
      if (lane == 0) {                        // end of the tile sequence
        mbar_wait(empty_k(stage), phase ^ 1u);
        s_tile[stage][0] = -1;
        mbar_arrive(full_k(stage));
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int wg = tid / 128, w = (tid / 32) & 3;

    // Prologue: the position range of the real query rows of each warp
    // of 32 (warps 0-3), and the least key position.
    if (tid < kBQ) {
      const bool real = q0 + tid < p.S;
      const int qp = real ? __ldg(p.q_pos + q0 + tid) : 0;
      int lo = real ? qp : INT_MAX, hi = real ? qp : INT_MIN;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
        hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
      }
      if (lane == 0) {
        s_qlo[tid / 32] = lo;
        s_qhi[tid / 32] = hi;
      }
    }
    {
      int kmin = INT_MAX;
      for (int j0 = 0; j0 < p.T; j0 += 4 * kConsumers) {
        int kp[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int j = j0 + tid + kConsumers * i;
          kp[i] = j < p.T ? __ldg(p.k_pos + j) : INT_MAX;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) kmin = min(kmin, kp[i]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        kmin = min(kmin, __shfl_xor_sync(0xffffffffu, kmin, o));
      if (lane == 0) atomicMin(&s_kmin, kmin);
    }
    named_sync(3, kConsumers);
    // A KV tile that no row of the CTA sees is skipped, but only when every
    // real row sees some key: then a masked key's weight is exactly
    // exp(-2^30 - m) = 0 and skipping changes nothing.  Non-causal, every
    // row sees every key; causal without a window, a row sees some key iff
    // the least key position is at most its own; with a window, each warp
    // scans every 8th row's keys 128 at a time until one is visible.
    const int qlo = min(min(s_qlo[0], s_qlo[1]), min(s_qlo[2], s_qlo[3]));
    bool may_skip = !p.causal || qlo >= s_kmin;
    if (p.causal && p.window > 0) {
      for (int r = tid / 32; r < kBQ && q0 + r < p.S; r += kConsumers / 32) {
        const int qp = __ldg(p.q_pos + q0 + r);
        bool seen = false;
        for (int c0 = 0; c0 < p.T && !seen; c0 += 128) {
          bool any = false;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int j = c0 + lane + 32 * i;
            any |= j < p.T && visible(qp, __ldg(p.k_pos + j), 1, p.window);
          }
          seen = __any_sync(0xffffffffu, any);
        }
        if (!seen && lane == 0) s_unseen = 1;
      }
      named_sync(3, kConsumers);
      may_skip = s_unseen == 0;
    }
    if (tid == 0) {
      s_skip = may_skip;
      mbar_arrive(bar_pro);                    // releases s_skip, s_qlo, s_qhi
    }

    const int wqlo = warp_uniform(min(s_qlo[2 * wg], s_qlo[2 * wg + 1]));
    const int wqhi = warp_uniform(max(s_qhi[2 * wg], s_qhi[2 * wg + 1]));
    const int cqlo = warp_uniform(qlo);       // the CTA's real rows
    const int cqhi = warp_uniform(
        max(max(s_qhi[0], s_qhi[1]), max(s_qhi[2], s_qhi[3])));
    const bool wg_idle = wqlo > wqhi;          // no real row in this half
    const bool skip_ok = warp_uniform(may_skip);
    // this thread's rows of the accumulator fragments: r0 and r0 + 8
    const int r0 = q0 + wg * 64 + w * 16 + (lane >> 2);
    const int qp0 = r0 < p.S ? __ldg(p.q_pos + r0) : 0;
    const int qp1 = r0 + 8 < p.S ? __ldg(p.q_pos + r0 + 8) : 0;
    const uint32_t sQw = sQ + wg * 64 * kRow;

    float o[NPV / 2];
#pragma unroll
    for (int i = 0; i < NPV / 2; ++i) o[i] = 0.f;
    float s[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
    uint32_t pa[BK / 4];
#pragma unroll
    for (int i = 0; i < BK / 4; ++i) pa[i] = 0u;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

    // O += P . (the V-layout tile at shared address `vt`), issued and
    // committed.  P and O are pinned (fence_regs) before the caller's first
    // fence and after the wait, and no branch may join while it runs:
    // anything that touches them in between makes ptxas serialise every
    // wgmma of the kernel.
    auto issue_pv = [&](uint32_t vt) {
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs<NPV>(o, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                      pa[4 * kk + 3], gmma_desc(vt + kk * 16 * kRow, kKVChunk),
                      1);
      wg_commit();
    };
    auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };

    // The two warpgroups take turns at the tensor cores (named barriers 1
    // and 2): one issues its products while the other runs its softmax.
    mbar_wait(bar_q, 0);
    if (wg == 1) named_arrive(1, kConsumers);  // warpgroup 0 goes first
    int stage = 0;
    uint32_t phase = 0;
    int pv = -1;                               // stage whose P.V is pending
    uint32_t pv_phase = 0;
    for (;;) {
      mbar_wait(full_k(stage), phase);
      const int t = warp_uniform(s_tile[stage][0]);
      if (t < 0) break;
      const int lo = warp_uniform(s_tile[stage][1]);
      const int hi = warp_uniform(s_tile[stage][2]);
      const int k0 = t * BK;
      // A tile is skipped only when no row of the whole CTA sees it: the
      // producer sends no such tile once it knows `may_skip`, so a skip
      // comes only among the first STAGES tiles (or in a warpgroup with no
      // real row, which never holds a P.V), and never lands on the stage
      // whose V this warpgroup still holds for its pending P.V.  Skipping
      // by the warpgroup's own rows could wrap onto that stage and wait for
      // a V the producer cannot load until the stage is released.
      if (wg_idle || (skip_ok && invisible(p, cqlo, cqhi, lo, hi))) {
        // nothing here for these rows: release once it landed
        mbar_wait(full_v(stage), phase);
        named_sync(1 + wg, kConsumers);        // keep the turns in step
        named_arrive(2 - wg, kConsumers);
        release(empty_k(stage));
        release(empty_v(stage));
      } else {
        const bool unmasked = all_visible(p, wqlo, wqhi, lo, hi) && k0 + BK <= p.T;
        const uint32_t sKs = sK + stage * kKVBytes;
        // S = Q.K^T of this tile, then P.V of the previous one behind it;
        // before the first, P is 0 and the K tile stands in for V (finite
        // values, so the product adds exact zeros)
        named_sync(1 + wg, kConsumers);
        fence_regs(o);
        fence_regs(pa);
        fence_regs(s);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < NKD; ++kk) {      // columns past D are zeros
          const uint32_t col = (kk & 3) * 32u;   // 16 columns = 32 bytes
          wgmma_ss<BK>(s, gmma_desc(sQw + (kk >> 2) * kQChunk + col, 16),
                       gmma_desc(sKs + (kk >> 2) * kKVChunk + col, 16), kk);
        }
        wg_commit();
        if (pv >= 0) mbar_wait(full_v(pv), pv_phase);
        issue_pv(pv >= 0 ? sV + pv * kKVBytes : sKs);
        named_arrive(2 - wg, kConsumers);
        wg_wait<1>();                          // S is done, P.V runs on
        fence_regs(s);

        float mx0, mx1;
        if (unmasked) {
          if (p.softcap > 0.f)
            scores<BK, false, true>(s, p, s_kpos[stage], k0, lane, qp0, qp1,
                                    mx0, mx1);
          else
            scores<BK, false, false>(s, p, s_kpos[stage], k0, lane, qp0, qp1,
                                     mx0, mx1);
        } else {
          if (p.softcap > 0.f)
            scores<BK, true, true>(s, p, s_kpos[stage], k0, lane, qp0, qp1,
                                   mx0, mx1);
          else
            scores<BK, true, false>(s, p, s_kpos[stage], k0, lane, qp0, qp1,
                                    mx0, mx1);
        }
        release(empty_k(stage));               // K and its positions are read
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
        const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
        const float alpha0 = ex2(m0 - mn0), alpha1 = ex2(m1 - mn1);
        m0 = mn0;
        m1 = mn1;
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) s[i] = ex2(s[i] - ((i & 2) ? m1 : m0));

        wg_wait<0>();                          // the previous P.V is done
        fence_regs(o);
        fence_regs(pa);
        fence_regs(s);                         // P is packed after the wait
        if (pv >= 0) release(empty_v(pv));
        // O and l to the new max; P to bf16 as wgmma's A fragment (the
        // accumulator and A layouts coincide); l sums the rounded P
        float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
        for (int i = 0; i < BK / 2; i += 2) {
          const __nv_bfloat162 pr = __floats2bfloat162_rn(s[i], s[i + 1]);
          pa[i / 2] = *reinterpret_cast<const uint32_t*>(&pr);
          const float2 f = __bfloat1622float2(pr);
          if (i & 2)
            ls1 += f.x + f.y;
          else
            ls0 += f.x + f.y;
        }
        l0 = l0 * alpha0 + ls0;
        l1 = l1 * alpha1 + ls1;
#pragma unroll
        for (int i = 0; i < NPV / 2; ++i) o[i] *= (i & 2) ? alpha1 : alpha0;
        pv = stage;
        pv_phase = phase;
      }
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1u;
      }
    }
    named_sync(1 + wg, kConsumers);
    if (pv >= 0) {
      mbar_wait(full_v(pv), pv_phase);
      fence_regs(o);
      fence_regs(pa);
      issue_pv(sV + pv * kKVBytes);
    }
    if (wg == 0) named_arrive(2, kConsumers);  // the turns balance out
    if (pv >= 0) {
      wg_wait<0>();
      fence_regs(o);
    }

    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float d0 = 1.f / fmaxf(l0, 1e-37f), d1 = 1.f / fmaxf(l1, 1e-37f);
#pragma unroll
    for (int j = 0; j < NPV / 8; ++j) {
      const int col = 8 * j + 2 * (lane & 3);
      if (col < p.D) {
        if (r0 < p.S)
          *reinterpret_cast<__nv_bfloat162*>(
              p.out + ((long long)(b * p.S + r0) * p.H + h) * p.D + col) =
              __floats2bfloat162_rn(o[4 * j] * d0, o[4 * j + 1] * d0);
        if (r0 + 8 < p.S)
          *reinterpret_cast<__nv_bfloat162*>(
              p.out + ((long long)(b * p.S + r0 + 8) * p.H + h) * p.D + col) =
              __floats2bfloat162_rn(o[4 * j + 2] * d1, o[4 * j + 3] * d1);
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime so the
// library needs no -lcuda.
EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault,
                            &found);
#endif
    if (found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A 4-d tensor map over (D, then head, row and batch sorted by stride) with
// a box of 64 columns x `rows` rows, 128B swizzle, zeros out of bounds.
// `size`/`stride` are in elements, in the order head, row, batch; `slot`
// receives each one's coordinate index.  Returns 0 or kErrTensorMap.
int make_map(CUtensorMap* map, const void* ptr, int D, const long long (&size)[3],
             const long long (&stride)[3], int rows, int (&slot)[3]) {
  int order[3] = {0, 1, 2};
  auto key = [&](int i) { return size[i] == 1 ? LLONG_MAX : stride[i]; };
  for (int i = 1; i < 3; ++i)
    for (int j = i; j > 0 && key(order[j]) < key(order[j - 1]); --j) {
      const int t = order[j];
      order[j] = order[j - 1];
      order[j - 1] = t;
    }
  cuuint64_t gdim[4] = {(cuuint64_t)D, 1, 1, 1};
  cuuint64_t gstride[3];
  cuuint32_t box[4] = {64, 1, 1, 1};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  long long extent = 2LL * D;          // bytes spanned by the dims so far
  for (int i = 0; i < 3; ++i) {
    const int d = order[i];
    // a dimension of size 1 is never stepped: give it a packed stride
    const long long st = size[d] == 1 ? extent : 2LL * stride[d];
    if (st % 16 != 0 || st <= 0) return kErrTensorMap;
    gdim[i + 1] = (cuuint64_t)size[d];
    gstride[i] = (cuuint64_t)st;
    box[i + 1] = d == 1 ? (cuuint32_t)rows : 1;
    slot[d] = i + 1;
    extent = st * size[d];
  }
  EncodeTiled enc = encode_fn();
  if (!enc) return kErrTensorMap;
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                         const_cast<void*>(ptr), gdim, gstride, box, estride,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrTensorMap;
}

template <int BK, int NPV, int STAGES, int NKD>
int launch(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv,
           const TcParams& p, int B, cudaStream_t stream) {
  constexpr size_t smem = 1024 + (size_t)(NPV / 64) * kRow * (kBQ + 2 * STAGES * BK);
  auto kern = flash_fwd_tc<BK, NPV, STAGES, NKD>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)p.H, (unsigned)B, (unsigned)p.nq);
  kern<<<grid, kThreads, smem, stream>>>(mq, mk, mv, p);
  return (int)cudaGetLastError();
}

}  // namespace tc

// float32: the scalar kernel.
int fwd_scalar(const void* q, const void* k, const void* v, const void* q_pos,
               const void* k_pos, void* out, int B, int S, int T, int H, int K,
               int D, long long q_sb, long long q_ss, long long q_sh,
               long long k_sb, long long k_ss, long long k_sh, long long v_sb,
               long long v_ss, long long v_sh, float scale, int causal,
               int window, float softcap, cudaStream_t s) {
  Params p;
  p.q = q; p.k = k; p.v = v;
  p.q_pos = static_cast<const int*>(q_pos);
  p.k_pos = static_cast<const int*>(k_pos);
  p.out = out;
  p.S = S; p.T = T; p.H = H; p.D = D; p.G = H / K;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.scale = scale; p.causal = causal; p.window = window; p.softcap = softcap;
  return dispatch_d<float>(p, B, s);
}

// bfloat16: the tensor-core kernel.
int fwd_tc(const void* q, const void* k, const void* v, const void* q_pos,
           const void* k_pos, void* out, int B, int S, int T, int H, int K,
           int D, long long q_sb, long long q_ss, long long q_sh,
           long long k_sb, long long k_ss, long long k_sh, long long v_sb,
           long long v_ss, long long v_sh, float scale, int causal, int window,
           float softcap, cudaStream_t s) {
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) & 15)
    return kErrTensorMap;
  tc::TcParams p;
  p.q_pos = static_cast<const int*>(q_pos);
  p.k_pos = static_cast<const int*>(k_pos);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.S = S; p.T = T; p.H = H; p.D = D; p.G = H / K;
  p.nq = (S + tc::kBQ - 1) / tc::kBQ;
  p.scale = scale;
  p.scale_log2 = scale * tc::kLog2e;
  p.softcap = softcap; p.causal = causal; p.window = window;
  const int bk = D <= 128 ? 128 : 64;
  const long long qn[3] = {H, S, B}, qst[3] = {q_sh, q_ss, q_sb};
  const long long kn[3] = {K, T, B}, kst[3] = {k_sh, k_ss, k_sb};
  const long long vst[3] = {v_sh, v_ss, v_sb};
  CUtensorMap mq, mk, mv;
  int rc = tc::make_map(&mq, q, D, qn, qst, tc::kBQ, p.slot[0]);
  if (!rc) rc = tc::make_map(&mk, k, D, kn, kst, bk, p.slot[1]);
  if (!rc) rc = tc::make_map(&mv, v, D, kn, vst, bk, p.slot[2]);
  if (rc) return rc;
  // <BK, P.V width, stages, k16 steps of Q.K^T>
  if (D <= 64) return tc::launch<128, 64, 3, 4>(mq, mk, mv, p, B, s);
  if (D <= 80) return tc::launch<128, 128, 2, 5>(mq, mk, mv, p, B, s);
  if (D <= 128) return tc::launch<128, 128, 2, 8>(mq, mk, mv, p, B, s);
  return tc::launch<64, 256, 2, 16>(mq, mk, mv, p, B, s);
}

}  // namespace

extern "C" {

// q (B,S,H,D), k/v (B,T,K,D) read through the given element strides (the
// D stride is 1); out (B,S,H,D) contiguous; positions int32 (S,), (T,).
// dtype: 0 = float32 (scalar kernel), 1 = bfloat16 (tensor-core kernel,
// which also needs 16-byte aligned q/k/v and strides that are multiples
// of 8 elements).  D a multiple of 8 up to 256.
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        const void* q_pos, const void* k_pos, void* out,
                        int B, int S, int T, int H, int K, int D,
                        long long q_sb, long long q_ss, long long q_sh,
                        long long k_sb, long long k_ss, long long k_sh,
                        long long v_sb, long long v_ss, long long v_sh,
                        float scale, int causal, int window, float softcap,
                        int dtype, void* stream) {
  if (B <= 0 || S <= 0 || T <= 0 || K <= 0 || H % K != 0 || D % 8 != 0 ||
      D < 8 || D > 256)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return fwd_scalar(q, k, v, q_pos, k_pos, out, B, S, T, H, K, D, q_sb,
                      q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale,
                      causal, window, softcap, s);
  if (dtype == 1)
    return fwd_tc(q, k, v, q_pos, k_pos, out, B, S, T, H, K, D, q_sb, q_ss,
                  q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale, causal,
                  window, softcap, s);
  return (int)cudaErrorInvalidValue;
}

const char* error_string(int code) {
  if (code == kErrTensorMap)
    return "TMA refused a tensor map (q, k, v need 16-byte aligned bases and "
           "strides that are multiples of 8 elements)";
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
