// RG-LRU linear recurrence for Hopper, hand-written in CUDA C++.
//
// Replaces the Pallas TPU kernel repro/kernels/rglru_scan/kernel.py
// (`_rglru_kernel`, launched by `rglru_scan`).  Semantics are those of
// repro_torch/kernels/rglru_scan/ref.py, its plain version, behind the
// wrapper's clamp (repro/kernels/rglru_scan/ops.py clamps log_a <= 0):
//   log_a, b (B,T,W) contiguous, float32 or bfloat16 alike; h0 (B,W) float32;
//   h_t = exp(min(log_a_t, 0)) * h_{t-1} + b_t, h_{-1} = h0, float32 state;
//   out (B,T,W) in b's dtype, each h_t rounded once.
//
// Design.  The recurrence is serial in time and independent across (b, w),
// so one thread owns one column (b, w) and walks t; neighbouring threads
// take neighbouring w, so every load and store of a warp is one coalesced
// row segment.  The TPU kernel keeps h in VMEM across a sequential grid
// axis over time blocks; here h stays in a register for the whole walk.
// Only the multiply-add h = a*h + b is on the dependence chain: the loads
// of a_t and b_t and the exponential do not depend on h, so the walk goes
// in groups of UNROLL steps and each group's loads go out before the
// previous group's chain runs (double buffering in registers), which keeps
// 2*UNROLL loads of each thread in flight.  No log-space cumulative product:
// the decays underflow exp(-30) within a few steps (kernel.py:12-14).
//
// What bounds it: bytes (log_a and b read once, h written once).  With one
// thread per column and W = 2560, B = 1 gives only 2,560 threads, so the
// card cannot keep enough loads in flight to reach its memory rate: the
// walk is bound by memory latency, one group per round trip.  Blocks of 64
// threads spread the columns over 40*B blocks (more SMs than 128-thread
// blocks would reach).
//
// Floating point: float32 with expf (not __expf) and one fmaf per step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define THREADS 64
#define UNROLL 16

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
rglru_scan_kernel(const T* __restrict__ log_a, const T* __restrict__ bx,
                  const float* __restrict__ h0, T* __restrict__ out, int Tn,
                  int W) {
  const int w = blockIdx.x * THREADS + threadIdx.x;
  const int b = blockIdx.y;
  if (w >= W) return;
  const size_t col = (size_t)b * Tn * W + w;
  const T* la = log_a + col;
  const T* bp = bx + col;
  T* op = out + col;
  float h = h0[(size_t)b * W + w];

  // raw values in the prefetch registers, widened only where the chain
  // uses them, so no instruction waits on a load before the chain runs;
  // steps past T load the last row again (in bounds) and are not computed
  T a_cur[UNROLL], b_cur[UNROLL];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const size_t row = (size_t)min(u, Tn - 1) * W;
    a_cur[u] = la[row];
    b_cur[u] = bp[row];
  }
  for (int t0 = 0; t0 < Tn; t0 += UNROLL) {
    T a_nxt[UNROLL], b_nxt[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {           // the next group's loads
      const size_t row = (size_t)min(t0 + UNROLL + u, Tn - 1) * W;
      a_nxt[u] = la[row];
      b_nxt[u] = bp[row];
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {           // this group's chain
      const int t = t0 + u;
      if (t < Tn) {
        h = fmaf(expf(fminf(to_f32(a_cur[u]), 0.f)), h, to_f32(b_cur[u]));
        store(op + (size_t)t * W, h);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      a_cur[u] = a_nxt[u];
      b_cur[u] = b_nxt[u];
    }
  }
}

// Plain C entry point, loaded with ctypes.  log_a, b and out (B,T,W)
// contiguous, h0 (B,W) float32 contiguous; `bf16` selects bfloat16 (1) or
// float32 (0) for log_a, b and out alike.  Launches on `stream` and returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a shape
// the kernel does not take; it never synchronises.
extern "C" int rglru_scan_launch(const void* log_a, const void* b,
                                 const float* h0, void* out, int B, int T,
                                 int W, int bf16, void* stream) {
  if (B < 0 || T < 0 || W < 0 || B > 65535) return (int)cudaErrorInvalidValue;
  if (B == 0 || T == 0 || W == 0) return 0;
  const dim3 grid((W + THREADS - 1) / THREADS, B);
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    rglru_scan_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        (const __nv_bfloat16*)log_a, (const __nv_bfloat16*)b, h0,
        (__nv_bfloat16*)out, T, W);
  else
    rglru_scan_kernel<float><<<grid, THREADS, 0, s>>>(
        (const float*)log_a, (const float*)b, h0, (float*)out, T, W);
  return (int)cudaGetLastError();
}
