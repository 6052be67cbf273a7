// Flash-attention kernel (prefill) for Hopper, hand-written in CUDA C++.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attn/kernel.py
// (`_flash_kernel`, launched by `flash_attention`).  Semantics are those of
// repro_torch/kernels/flash_attn/ref.py, its plain version:
//   q (B,H,Sq,dh), k/v (B,KV,Skv,dh), float32 or bfloat16, row-major;
//   query head h reads KV head h / (H/KV) (GQA, no KV copy);
//   s = (q * 1/sqrt(dh)) . k, key j visible to query i when j < Skv,
//   j <= i (causal) and j > i - window (window > 0);
//   float32 online softmax; a row that sees no key gives 0 through the
//   max(l, 1e-30) denominator; output in q's dtype.
//
// Design.  The TPU kernel walks a sequential grid axis over KV blocks and
// carries (m, l, acc) in VMEM scratch.  Blocks here run in no order, so one
// block owns BQ=32 query rows of one (batch, head) and loops over the KV
// tiles itself, carrying (m, l, acc) in registers.  Each query row has
// TPR=4 adjacent threads; a thread holds every fourth 4-value chunk of the
// head dimension (so dh=120 is 30 chunks, 8 or 7 per thread) of q and of
// the accumulator, and the row's score is a partial dot product summed over
// the four threads with two shuffles.  A tile of BKV=32 keys and values is
// staged through shared memory as float32; every thread of the block reads
// it (the four threads of a row read four neighbouring 16-byte chunks, the
// eight rows of a warp read the same ones, a broadcast).  The tile loop
// starts at the first key the block's first row can see and stops after
// the last key its last row can see, so tiles the mask leaves empty are
// skipped, as the TPU kernel's pl.when skips them.
//
// What bounds it: operations.  At a long prefill the work is
// 4*H*dh*(visible q-k pairs) flops against ~4*B*H*S*dh*2 bytes, far above
// the card's ~295 flops per byte.  This first version computes QK^T and PV
// on the CUDA cores in float32 (no tensor cores; mma.sync/wgmma is a later
// version), so it runs well above the bf16 tensor-core bound; at the
// serving shapes (S <= 128) it is launch-bound.
//
// Floating point: float32 throughout with nvcc's default FMA contraction,
// expf (not __expf) and IEEE division; inputs widen exactly to float32, the
// output rounds to nearest even.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define BQ 32          // query rows per block
#define BKV 32         // keys per shared-memory tile
#define TPR 4          // threads per query row
#define THREADS (BQ * TPR)
#define MAX_CHUNKS 32  // head dimension <= 128, in chunks of 4 values

template <typename T>
struct Chunk;

template <>
struct Chunk<float> {
  static __device__ __forceinline__ float4 load(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  static __device__ __forceinline__ void store(float* p, float4 x) {
    *reinterpret_cast<float4*>(p) = x;
  }
};

template <>
struct Chunk<__nv_bfloat16> {
  static __device__ __forceinline__ float4 load(const __nv_bfloat16* p) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float4 x) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(x.x, x.y);
    const __nv_bfloat162 b = __floats2bfloat162_rn(x.z, x.w);
    uint2 raw;
    raw.x = *reinterpret_cast<const uint32_t*>(&a);
    raw.y = *reinterpret_cast<const uint32_t*>(&b);
    *reinterpret_cast<uint2*>(p) = raw;
  }
};

// NC: chunks of the head dimension per thread (ceil(dh/4 / TPR)).
template <typename T, int NC>
__global__ void __launch_bounds__(THREADS)
flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ o, int H, int KV,
                  int Sq, int Skv, int dh, float scale, int causal,
                  int window) {
  __shared__ float4 ks[BKV][MAX_CHUNKS];
  __shared__ float4 vs[BKV][MAX_CHUNKS];

  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int row = threadIdx.x / TPR, lane = threadIdx.x % TPR;
  const int q_lo = blockIdx.x * BQ;
  const int qpos = q_lo + row;
  const bool q_ok = qpos < Sq;
  const int nch = dh / 4;

  const size_t q_off = (((size_t)b * H + h) * Sq + (q_ok ? qpos : 0)) * dh;
  const T* kp = k + ((size_t)b * KV + kvh) * Skv * dh;
  const T* vp = v + ((size_t)b * KV + kvh) * Skv * dh;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  float4 qr[NC], acc[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int c = lane + TPR * i;
    float4 x = zero;
    if (q_ok && c < nch) {
      x = Chunk<T>::load(q + q_off + 4 * c);
      x.x *= scale; x.y *= scale; x.z *= scale; x.w *= scale;
    }
    qr[i] = x;
    acc[i] = zero;
  }
  float m = -INFINITY, l = 0.f;

  // the keys any row of this block can see
  const int q_hi = min(q_lo + BQ, Sq) - 1;
  const int kv_end = causal ? min(Skv, q_hi + 1) : Skv;
  const int kv_begin = window > 0 ? max(0, q_lo - window + 1) : 0;

  for (int j0 = kv_begin - kv_begin % BKV; j0 < kv_end; j0 += BKV) {
    __syncthreads();  // every thread is done with the previous tile
    for (int e = threadIdx.x; e < BKV * nch; e += THREADS) {
      const int r = e / nch, c = e % nch, j = j0 + r;
      float4 kx = zero, vx = zero;
      if (j < Skv) {
        kx = Chunk<T>::load(kp + (size_t)j * dh + 4 * c);
        vx = Chunk<T>::load(vp + (size_t)j * dh + 4 * c);
      }
      ks[r][c] = kx;
      vs[r][c] = vx;
    }
    __syncthreads();

    // scores of this row against the tile; every lane of the warp takes
    // part in the shuffles, rows past Sq included
    float s[BKV];
    float tile_max = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < BKV; ++jj) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const int c = lane + TPR * i;
        if (c < nch) {
          const float4 kx = ks[jj][c];
          part += qr[i].x * kx.x + qr[i].y * kx.y + qr[i].z * kx.z + qr[i].w * kx.w;
        }
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const int kpos = j0 + jj;
      const bool seen = kpos < Skv && (!causal || kpos <= qpos) &&
                        (window <= 0 || kpos > qpos - window);
      s[jj] = seen ? part : -INFINITY;
      tile_max = fmaxf(tile_max, s[jj]);
    }

    const float m_new = fmaxf(m, tile_max);
    const float m_safe = m_new == -INFINITY ? 0.f : m_new;
    const float corr = m == -INFINITY ? 0.f : expf(m - m_safe);
    l *= corr;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      acc[i].x *= corr; acc[i].y *= corr; acc[i].z *= corr; acc[i].w *= corr;
    }
#pragma unroll
    for (int jj = 0; jj < BKV; ++jj) {
      const float p = s[jj] == -INFINITY ? 0.f : expf(s[jj] - m_safe);
      l += p;
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const int c = lane + TPR * i;
        if (c < nch) {
          const float4 vx = vs[jj][c];
          acc[i].x += p * vx.x; acc[i].y += p * vx.y;
          acc[i].z += p * vx.z; acc[i].w += p * vx.w;
        }
      }
    }
    m = m_new;
  }

  if (!q_ok) return;
  const float denom = fmaxf(l, 1e-30f);
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int c = lane + TPR * i;
    if (c < nch) {
      const float4 a = acc[i];
      Chunk<T>::store(o + q_off + 4 * c, make_float4(a.x / denom, a.y / denom,
                                                     a.z / denom, a.w / denom));
    }
  }
}

template <typename T, int NC>
static int launch(const void* q, const void* k, const void* v, void* o, int B,
                  int H, int KV, int Sq, int Skv, int dh, float scale,
                  int causal, int window, cudaStream_t stream) {
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_attn_kernel<T, NC><<<grid, THREADS, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, H, KV, Sq, Skv, dh, scale,
      causal, window);
  return (int)cudaGetLastError();
}

template <typename T>
static int dispatch(const void* q, const void* k, const void* v, void* o,
                    int B, int H, int KV, int Sq, int Skv, int dh, float scale,
                    int causal, int window, cudaStream_t s) {
  const int nc = (dh / 4 + TPR - 1) / TPR;
  if (nc <= 1) return launch<T, 1>(q, k, v, o, B, H, KV, Sq, Skv, dh, scale, causal, window, s);
  if (nc <= 2) return launch<T, 2>(q, k, v, o, B, H, KV, Sq, Skv, dh, scale, causal, window, s);
  if (nc <= 4) return launch<T, 4>(q, k, v, o, B, H, KV, Sq, Skv, dh, scale, causal, window, s);
  return launch<T, 8>(q, k, v, o, B, H, KV, Sq, Skv, dh, scale, causal, window, s);
}

// Plain C entry point, loaded with ctypes.  `bf16` selects bfloat16 (1) or
// float32 (0) for q, k, v and o alike.  Launches on `stream` and returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a shape
// the kernel does not take; it never synchronises.
extern "C" int flash_attn_launch(const void* q, const void* k, const void* v,
                                 void* o, int B, int H, int KV, int Sq, int Skv,
                                 int dh, float scale, int causal, int window,
                                 int bf16, void* stream) {
  if (KV <= 0 || H % KV != 0 || dh <= 0 || dh % 4 != 0 ||
      dh > 4 * MAX_CHUNKS || H > 65535 || B > 65535 || Skv < 0)
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || H <= 0 || Sq <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return dispatch<__nv_bfloat16>(q, k, v, o, B, H, KV, Sq, Skv, dh, scale, causal, window, s);
  return dispatch<float>(q, k, v, o, B, H, KV, Sq, Skv, dh, scale, causal, window, s);
}
