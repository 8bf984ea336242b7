// Flash-attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel `flash_attention_kernel` / `_kernel` in
// src/repro/kernels/flash_attention/flash_attention.py (wrapped there by
// ops.py `flash_attention` / `_flash_attention_fwd_impl`).  It computes
// GQA attention with an online softmax: fp32 scores, running max,
// denominator and accumulator; KV head h / G; causal and sliding-window
// masks from int32 position vectors; optional tanh softcap; masked scores
// take the finite NEG_INF = -2^30, so a fully masked row averages V as the
// reference does; final divide by max(l, 1e-37).
//
// Bound on an H100: at the serving prefill shape (B=4, S=T=1024, H=15,
// K=5, D=64, causal) about 8.05 GFLOP over 21 MB, so the tensor-core rate
// bounds it (8.1 us at 989 TFLOP/s against 6.3 us for the bytes).  This
// first version is simple and right rather than fast: it uses scalar fp32
// FMAs from shared memory, not the tensor cores, so it sits far above that
// bound; `wgmma` tiles are later work.
//
// Design against the TPU original:
// - One block of 256 threads per (query tile of 64 rows, q-head, batch).
//   The TPU's sequential KV grid axis becomes a loop inside the block over
//   64-row KV tiles of head h / G, staged in shared memory as fp32.
// - Thread (r = tid / 4, c = tid % 4) owns query row r: scores for keys
//   c, c+4, ..., c+60 of the tile and output columns c, c+4, ...; the four
//   threads of a row sit in one warp and reduce with shuffles.
// - No padding.  The TPU wrapper pads S and T to 128 and D to 128 lanes;
//   here ragged rows and keys are masked by index, so keys past T never
//   count (which also fixes the reference's non-causal padded-key fault).
// - A KV tile that no row of the query tile can see is skipped, but only
//   when every row sees some key: then a masked key's weight is exactly
//   exp(-2^30 - m) = 0 and skipping changes nothing.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;
constexpr int kPS = kBK + 1;                 // row stride of the P tile
constexpr float kNegInf = -1073741824.0f;    // -2^30, as in the reference

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
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

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

}  // namespace

extern "C" {

// q (B,S,H,D), k/v (B,T,K,D) read through the given element strides (the
// D stride is 1); out (B,S,H,D) contiguous; positions int32 (S,), (T,).
// dtype: 0 = float32, 1 = bfloat16.  D a multiple of 8 up to 256.
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
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return dispatch_d<float>(p, B, s);
  if (dtype == 1) return dispatch_d<__nv_bfloat16>(p, B, s);
  return (int)cudaErrorInvalidValue;
}

const char* error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
