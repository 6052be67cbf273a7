// Chunked RWKV6 (Finch) WKV scan for Hopper, hand-written in CUDA C++.
//
// Replaces the Pallas TPU kernel repro/kernels/rwkv6_scan/kernel.py
// (`_rwkv_kernel`, launched by `rwkv6_scan`).  Per head, with a (K,V)
// float32 state S from zero:
//   S_t = diag(exp(dlog_t)) S_{t-1} + k_t^T v_t
//   y_t = r_t S_{t-1} + (r_t . (u * k_t)) v_t
// computed chunk by chunk as the TPU kernel and repro/models/rwkv6.py
// `wkv_chunked` do (plain version: repro_torch/kernels/rwkv6_scan/ref.py
// `wkv_chunked_ref` with D in float32):
//   p = cumsum(dlog) - dlog (exclusive), q = p + dlog, p_end = q_{L-1};
//   y_i = (r_i e^{p_i}) S + sum_{s<i} A_is v_s + (r_i . u k_i) v_i,
//   A_is = sum_k r_ik k_sk e^{p_ik - q_sk};
//   S' = e^{p_end} S + sum_s (k_s e^{p_end - q_s})^T v_s.
// Returns y and the final state S_T (the TPU kernel drops it; prefill hands
// it to decode).
//
// Operands.  r, k, dlog logically (B,H,T,K), v and y (B,H,T,V), each read
// or written through its own element strides over (b, h, t) with the last
// dimension contiguous, so the model's (B,T,H,K) projections are read in
// place (a transposed view), without a copy; r, k, v and y float32 or
// bfloat16 alike, dlog float32, u (H,K) float32, state (B,H,K,V) float32.
// T need not be a multiple of the chunk: rows past T load as r=k=v=0,
// dlog=0, which leaves S unchanged, and are not stored.
//
// Design.  The TPU grid is (B, H, n_chunks) with the chunk axis sequential
// and S in VMEM scratch; Hopper's blocks run in no order, so one block owns
// one (b, h) and a slice of VB columns of V, and walks the chunks itself
// with its S columns in shared memory.  The columns of S are independent
// (y[:, v] reads only S[:, v]; A does not depend on v), so splitting V
// across blocks multiplies the blocks (the wrapper splits when B*H would
// not fill the SMs) at the price of computing A once per slice.  Per chunk:
// load r, k, dlog (L x K) and v (L x VB) widened to float32; the cumsums
// (one thread per k) and the bonus r.(u*k) (a warp per row); A over the
// strict lower triangle only (a table of the L(L-1)/2 pairs, one thread per
// pair, a loop over k); r e^p and k e^{p_end - q} in place; y (a thread per
// (i, v)); then S (a thread per (k, v)).  Shared rows of K floats are
// padded to K+1, so threads on different rows read different banks.
//
// The intra-chunk decay cannot be factored: p reaches about -236 over 32
// steps (dlog >= -e^2), so e^{-p} overflows float32 and (r e^p)(k e^{-p})^T
// is not an option; the kernel takes one exponential per (i, s, k) with
// s < i, as the TPU kernel does (kernel.py:47-49).
//
// What bounds it: operations.  Per chunk and head L(L-1)/2*K exponentials
// (31,744 at L=32, K=64) and ~0.7 MFLOP of multiply-adds, against ~0.3 MB
// of bytes in bf16; at B*H = 64 heads the walk over chunks is serial, so
// it is further bound by the latency of each chunk's five phases.
//
// Floating point: float32 throughout, expf (not __expf: its relative error
// grows with |x| and the arguments reach about -236), nvcc's default FMA
// contraction; inputs widen exactly to float32, y rounds once.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define THREADS 256
#define WARPS (THREADS / 32)
#define MAX_L 64
#define MAX_KV 64

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

struct Strides {       // element strides over (b, h, t)
  long long b, h, t;
};

static size_t smem_bytes(int L, int K, int VB) {
  const int KP = K + 1;
  return sizeof(float) * (4 * (size_t)L * KP + (size_t)L * VB +
                          (size_t)L * (L + 1) + (size_t)K * VB + L + 2 * K) +
         sizeof(int) * (size_t)(L * (L - 1) / 2);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
rwkv6_scan_kernel(const T* __restrict__ r, const T* __restrict__ k,
                  const T* __restrict__ v, const float* __restrict__ dlog,
                  const float* __restrict__ u, T* __restrict__ y,
                  float* __restrict__ state, int H, int Tn, int K, int V,
                  int L, int VB, Strides rs, Strides ks, Strides vs,
                  Strides ds, Strides ys) {
  extern __shared__ float smem[];
  const int KP = K + 1;
  float* r_s = smem;                    // L x KP: r, then r e^p
  float* k_s = r_s + L * KP;            // L x KP: k, then k e^{p_end - q}
  float* p_s = k_s + L * KP;            // L x KP: exclusive cumsum p
  float* q_s = p_s + L * KP;            // L x KP: dlog, then q = p + dlog
  float* v_s = q_s + L * KP;            // L x VB
  float* a_s = v_s + L * VB;            // L x (L+1): A, strict lower part
  float* s_s = a_s + L * (L + 1);       // K x VB: this slice of S
  float* diag_s = s_s + K * VB;         // L: r_i . (u * k_i)
  float* pend_s = diag_s + L;           // K: p_end
  float* u_s = pend_s + K;              // K
  int* pair_s = (int*)(u_s + K);        // L(L-1)/2 pairs (i << 8 | s), s < i

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int v0 = blockIdx.x * VB;
  const int vb = min(VB, V - v0);
  const int npairs = L * (L - 1) / 2;

  const T* rp = r + b * rs.b + h * rs.h;
  const T* kp = k + b * ks.b + h * ks.h;
  const T* vp = v + b * vs.b + h * vs.h + v0;
  const float* dp = dlog + b * ds.b + h * ds.h;
  T* yp = y + b * ys.b + h * ys.h + v0;

  for (int e = tid; e < K * VB; e += THREADS) s_s[e] = 0.f;
  for (int e = tid; e < K; e += THREADS) u_s[e] = u[h * K + e];
  for (int e = tid; e < L * L; e += THREADS) {
    const int i = e / L, s = e % L;
    if (s < i) pair_s[i * (i - 1) / 2 + s] = (i << 8) | s;
  }

  for (int t0 = 0; t0 < Tn; t0 += L) {
    __syncthreads();            // the last chunk's reads are done
    for (int e = tid; e < L * K; e += THREADS) {
      const int i = e / K, c = e % K, t = t0 + i;
      const bool in = t < Tn;
      r_s[i * KP + c] = in ? to_f32(rp[t * rs.t + c]) : 0.f;
      k_s[i * KP + c] = in ? to_f32(kp[t * ks.t + c]) : 0.f;
      q_s[i * KP + c] = in ? dp[t * ds.t + c] : 0.f;
    }
    for (int e = tid; e < L * VB; e += THREADS) {
      const int i = e / VB, j = e % VB, t = t0 + i;
      v_s[e] = (t < Tn && j < vb) ? to_f32(vp[t * vs.t + j]) : 0.f;
    }
    __syncthreads();

    if (tid < K) {              // p = cumsum(dlog) - dlog, q = p + dlog
      float c = 0.f, p = 0.f, d = 0.f;
      for (int i = 0; i < L; ++i) {
        d = q_s[i * KP + tid];
        c += d;
        p = c - d;
        p_s[i * KP + tid] = p;
        q_s[i * KP + tid] = p + d;
      }
      pend_s[tid] = p + d;
    }
    for (int i = warp; i < L; i += WARPS) {   // the bonus r_i . (u * k_i)
      float acc = 0.f;
      for (int c = lane; c < K; c += 32)
        acc += r_s[i * KP + c] * u_s[c] * k_s[i * KP + c];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) diag_s[i] = acc;
    }
    __syncthreads();

    for (int e = tid; e < npairs; e += THREADS) {   // A, s < i
      const int pr = pair_s[e], i = pr >> 8, s = pr & 255;
      const float* ri = r_s + i * KP;
      const float* pi = p_s + i * KP;
      const float* ksr = k_s + s * KP;
      const float* qs = q_s + s * KP;
      float acc = 0.f;
      for (int c = 0; c < K; ++c)
        acc += ri[c] * ksr[c] * expf(pi[c] - qs[c]);
      a_s[i * (L + 1) + s] = acc;
    }
    __syncthreads();

    for (int e = tid; e < L * K; e += THREADS) {
      const int i = e / K, c = e % K;
      r_s[i * KP + c] *= expf(p_s[i * KP + c]);
      k_s[i * KP + c] *= expf(pend_s[c] - q_s[i * KP + c]);
    }
    __syncthreads();

    for (int e = tid; e < L * VB; e += THREADS) {   // y
      const int i = e / VB, j = e % VB, t = t0 + i;
      float inter = 0.f, intra = 0.f;
      for (int c = 0; c < K; ++c) inter += r_s[i * KP + c] * s_s[c * VB + j];
      for (int s = 0; s < i; ++s) intra += a_s[i * (L + 1) + s] * v_s[s * VB + j];
      const float out = inter + intra + diag_s[i] * v_s[i * VB + j];
      if (t < Tn && j < vb) store(yp + t * ys.t + j, out);
    }
    __syncthreads();            // every read of S is done before it moves

    for (int e = tid; e < K * VB; e += THREADS) {   // S
      const int c = e / VB, j = e % VB;
      float acc = 0.f;
      for (int s = 0; s < L; ++s) acc += k_s[s * KP + c] * v_s[s * VB + j];
      s_s[e] = expf(pend_s[c]) * s_s[e] + acc;
    }
  }
  __syncthreads();
  float* sp = state + ((size_t)b * H + h) * K * V + v0;
  for (int e = tid; e < K * VB; e += THREADS) {
    const int c = e / VB, j = e % VB;
    if (j < vb) sp[(size_t)c * V + j] = s_s[e];
  }
}

template <typename T>
static int launch(const void* r, const void* k, const void* v,
                  const float* dlog, const float* u, void* y, float* state,
                  int B, int H, int Tn, int K, int V, int L, int VB, Strides rs,
                  Strides ks, Strides vs, Strides ds, Strides ys,
                  cudaStream_t stream) {
  const size_t smem = smem_bytes(L, K, VB);
  cudaError_t err = cudaFuncSetAttribute(
      rwkv6_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((V + VB - 1) / VB, B * H);
  rwkv6_scan_kernel<T><<<grid, THREADS, smem, stream>>>(
      (const T*)r, (const T*)k, (const T*)v, dlog, u, (T*)y, state, H, Tn, K,
      V, L, VB, rs, ks, vs, ds, ys);
  return (int)cudaGetLastError();
}

// Plain C entry point, loaded with ctypes.  Pointers as described above;
// strides in elements, five triples (b, h, t) for r, k, v, dlog and y; L is
// the chunk (at most 64), VB the columns of V per block.  `bf16` selects
// bfloat16 (1) or float32 (0) for r, k, v and y alike.  Launches on
// `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a shape the kernel does not take; it never
// synchronises.
extern "C" int rwkv6_scan_launch(
    const void* r, const void* k, const void* v, const float* dlog,
    const float* u, void* y, float* state, int B, int H, int T, int K, int V,
    int L, int VB, long long rb, long long rh, long long rt, long long kb,
    long long kh, long long kt, long long vb, long long vh, long long vt,
    long long db, long long dh, long long dt, long long yb, long long yh,
    long long yt, int bf16, void* stream) {
  if (B < 0 || H < 0 || T < 0 || K <= 0 || V <= 0 || K > MAX_KV ||
      V > MAX_KV || L <= 0 || L > MAX_L || VB <= 0 || VB > V ||
      (long long)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0) return 0;
  const Strides rs{rb, rh, rt}, ks{kb, kh, kt}, vs{vb, vh, vt},
      ds{db, dh, dt}, ys{yb, yh, yt};
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return launch<__nv_bfloat16>(r, k, v, dlog, u, y, state, B, H, T, K, V, L,
                                 VB, rs, ks, vs, ds, ys, s);
  return launch<float>(r, k, v, dlog, u, y, state, B, H, T, K, V, L, VB, rs,
                       ks, vs, ds, ys, s);
}
