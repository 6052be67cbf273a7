// Decode attention for Hopper, hand-written in CUDA C++: one query token
// per sequence against a KV cache masked by a length per sequence.
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attn/kernel.py
// (`_decode_kernel`, launched by `decode_attention`).  Semantics are those
// of repro_torch/kernels/decode_attn/ref.py, its plain version:
//   q (B,H,dh); k, v logically (B,KV,S,dh), read through element strides
//   over (b, kv head, s) with dh contiguous, so the serving cache
//   (B,S,KV,dh) is read in place, without a transposed copy;
//   lengths (B,) int32: key j takes part when j < min(lengths[b], S);
//   query head h reads KV head h / (H/KV) (GQA by index);
//   s = (q * 1/sqrt(dh)) . k, float32 online softmax; a sequence of length 0
//   gives 0 through the max(l, 1e-30) denominator; output in q's dtype.
//
// Design.  The TPU kernel walks a sequential grid axis over KV blocks for
// all H heads of a sequence, with (m, l, acc) in VMEM scratch.  Here one
// block of 8 warps owns one (batch, query head); its warps split the keys
// (warp w takes keys 8w..8w+7 of every 64) and each keeps its own online
// softmax state in registers, so the cache is streamed with no
// synchronisation until the end, where the 8 states are merged in warp
// order through shared memory.  A lane holds 4 adjacent values of the head
// dimension (dh <= 128), so one key row is one coalesced load of the warp,
// and a score is the warp's sum over lanes (5 shuffles); a warp loads its 8
// keys and values before it reduces, for memory parallelism.  Keys at or
// past the length are never read, as the TPU kernel's pl.when skips blocks.
//
// What bounds it: bytes (K and V read once: 4*B*KV*S*dh bytes in bf16).
// This first version gives every query head its own block, so with GQA
// each KV row is read H/KV times (from L2 after the first), and at the
// serving shapes (S = 192) it is bound by latency and the launch.
//
// Floating point: float32 throughout with nvcc's default FMA contraction,
// expf (not __expf) and IEEE division; inputs widen exactly to float32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define THREADS 256
#define WARPS 8
#define KPW 8         // keys a warp takes per step
#define MAX_DH 128    // 32 lanes x 4 values

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(x.x, x.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(x.z, x.w);
  uint2 raw;
  raw.x = *reinterpret_cast<const uint32_t*>(&a);
  raw.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = raw;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
decode_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const int* __restrict__ lengths,
                   T* __restrict__ o, int H, int KV, int S, int dh,
                   long long kb, long long kh, long long ks, long long vb,
                   long long vh, long long vs, float scale) {
  __shared__ float sm_m[WARPS], sm_l[WARPS];
  __shared__ float4 sm_acc[WARPS][MAX_DH / 4];

  const int h = blockIdx.x, b = blockIdx.y;
  const int kvh = h / (H / KV);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool act = lane < dh / 4;
  const int len = max(0, min(lengths[b], S));
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  const size_t q_off = ((size_t)b * H + h) * dh + 4 * lane;
  float4 qr = zero;
  if (act) {
    qr = load4(q + q_off);
    qr.x *= scale; qr.y *= scale; qr.z *= scale; qr.w *= scale;
  }
  const T* kp = k + b * kb + kvh * kh + 4 * lane;
  const T* vp = v + b * vb + kvh * vh + 4 * lane;

  float m = -INFINITY, l = 0.f;
  float4 acc = zero;
  for (int j0 = warp * KPW; j0 < len; j0 += WARPS * KPW) {
    float s[KPW];
    float4 vx[KPW];
#pragma unroll
    for (int t = 0; t < KPW; ++t) {
      const int j = j0 + t;
      float4 kx = zero;
      vx[t] = zero;
      if (act && j < len) {
        kx = load4(kp + j * ks);
        vx[t] = load4(vp + j * vs);
      }
      s[t] = qr.x * kx.x + qr.y * kx.y + qr.z * kx.z + qr.w * kx.w;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int t = 0; t < KPW; ++t) s[t] += __shfl_xor_sync(0xffffffffu, s[t], off);

    // key j0 < len is valid, so the running max is finite from here on
    float tile_max = -INFINITY;
#pragma unroll
    for (int t = 0; t < KPW; ++t) {
      if (j0 + t >= len) s[t] = -INFINITY;
      tile_max = fmaxf(tile_max, s[t]);
    }
    const float m_new = fmaxf(m, tile_max);
    const float corr = expf(m - m_new);          // m = -inf: 0
    l *= corr;
    acc.x *= corr; acc.y *= corr; acc.z *= corr; acc.w *= corr;
#pragma unroll
    for (int t = 0; t < KPW; ++t) {
      const float p = expf(s[t] - m_new);        // masked: exp(-inf) = 0
      l += p;
      acc.x += p * vx[t].x; acc.y += p * vx[t].y;
      acc.z += p * vx[t].z; acc.w += p * vx[t].w;
    }
    m = m_new;
  }

  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
  sm_acc[warp][lane] = acc;
  __syncthreads();
  if (warp != 0 || !act) return;
  float big = -INFINITY;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) big = fmaxf(big, sm_m[w]);
  float total = 0.f;
  float4 out = zero;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const float c = sm_m[w] == -INFINITY ? 0.f : expf(sm_m[w] - big);
    const float4 a = sm_acc[w][lane];
    total += sm_l[w] * c;
    out.x += a.x * c; out.y += a.y * c; out.z += a.z * c; out.w += a.w * c;
  }
  const float denom = fmaxf(total, 1e-30f);
  store4(o + q_off, make_float4(out.x / denom, out.y / denom, out.z / denom,
                                out.w / denom));
}

// Plain C entry point, loaded with ctypes.  q and o (B,H,dh) contiguous;
// k and v addressed as base + b*kb + kv*kh + s*ks (+ d), likewise v; all
// strides in elements, multiples of 4, and the bases 16-byte aligned.
// `bf16` selects bfloat16 (1) or float32 (0) for q, k, v and o alike.
// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a shape the kernel does not take; it never
// synchronises.
extern "C" int decode_attn_launch(const void* q, const void* k, const void* v,
                                  const int* lengths, void* o, int B, int H,
                                  int KV, int S, int dh, long long kb,
                                  long long kh, long long ks, long long vb,
                                  long long vh, long long vs, float scale,
                                  int bf16, void* stream) {
  if (KV <= 0 || H % KV != 0 || dh <= 0 || dh % 4 != 0 || dh > MAX_DH ||
      B > 65535 || S < 0 || B < 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0) return 0;
  const dim3 grid(H, B);
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    decode_attn_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
        (const __nv_bfloat16*)v, lengths, (__nv_bfloat16*)o, H, KV, S, dh, kb,
        kh, ks, vb, vh, vs, scale);
  else
    decode_attn_kernel<float><<<grid, THREADS, 0, s>>>(
        (const float*)q, (const float*)k, (const float*)v, lengths, (float*)o,
        H, KV, S, dh, kb, kh, ks, vb, vh, vs, scale);
  return (int)cudaGetLastError();
}
