// RG-LRU linear recurrence for Hopper, hand-written in CUDA C++.
//
// Replaces the Pallas TPU kernel repro/kernels/rglru_scan/kernel.py
// (`_rglru_kernel`, launched by `rglru_scan`).  Semantics are those of
// repro_torch/kernels/rglru_scan/ref.py, its plain version, behind the
// wrapper's clamp (repro/kernels/rglru_scan/ops.py clamps log_a <= 0):
//   log_a, b (B,T,W) contiguous, float32 or bfloat16 alike; h0 (B,W) float32;
//   h_t = exp(min(log_a_t, 0)) * h_{t-1} + b_t, h_{-1} = h0, float32 state;
//   out (B,T,W) in b's dtype, each h_t rounded once.
// The two-pass algorithm below is `rglru_chunked_ref` in the same file.
//
// Design.  The recurrence is serial in time and independent across (b, w).
// One thread per column walking all of T leaves B*W threads on the card
// (2,560 at B = 1), too few to keep the loads in flight that the memory
// rate needs.  So time is cut into chunks of C steps and the scan runs in
// two passes, each with a thread per (b, chunk, column):
//   1. `rglru_chunk_sums`: the chunk's walk from zero, giving its end value
//      E_c, and the chunk's decay A_c = prod exp(min(log_a, 0)), a direct
//      product (never a difference of log-space cumulative sums, so an
//      underflow to 0 is right to rounding: the TPU kernel's concern at
//      kernel.py:12-14 does not arise); (A_c, E_c) go to a float2 workspace.
//   2. `rglru_chunk_walk`: the carry into chunk c, h0 folded through the
//      (A_j, E_j) of the chunks before it (fmaf, from L2), then the chunk's
//      walk from the carry, writing h: the same fmaf chain as one serial
//      walk, started from a carry that differs from it only by rounding.
//      Its blocks take the chunks last first, so the chunks that pass 1 read
//      last, still in L2, are read again first.
// The wrapper runs pass 2 alone, with one chunk of T steps, where the card
// is full without chunks (short prompts): that is the serial walk.
//
// Within a walk only the multiply-add h = a*h + b is on the dependence
// chain: the loads of a_t and b_t and the exponential do not depend on h,
// so the walk goes in groups of UNROLL steps and each group's loads go out
// before the previous group's chain runs (double buffering in registers).
// Neighbouring threads take neighbouring w, so every load and store of a
// warp is one coalesced row segment.
//
// What bounds it: bytes.  The two passes read log_a and b twice and write h
// once, 5 x B*T*W*4 bytes in float32 against the function's 3 x; pass 2's
// re-read partly hits L2.
//
// Floating point: float32 with expf (not __expf) and fmaf.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define THREADS 128
#define UNROLL 16
#define CARRY_UNROLL 8

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Programmatic dependent launch: a pass-1 block lets pass 2 be scheduled
// (griddepcontrol.launch_dependents), and pass 2 waits for pass 1 to have
// finished and flushed (griddepcontrol.wait) only where it first reads pass
// 1's sums, so its first loads overlap pass 1's last blocks.
__device__ __forceinline__ void allow_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void wait_primary() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// Walk rows t0 .. t1-1 of one column from h, calling step(t, a, h) after
// each step: the loads of the next UNROLL rows go out before this group's
// chain runs; rows past t1 load row t1-1 again (in bounds) and are skipped.
// ready(h) runs once the first rows' loads are out, before the chain (pass
// 2 sets h there from the carry).
template <typename T, typename F, typename R>
__device__ __forceinline__ void walk(const T* la, const T* bp, int t0, int t1,
                                     int W, F step, R ready) {
  T a_cur[UNROLL], b_cur[UNROLL];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const size_t row = (size_t)min(t0 + u, t1 - 1) * W;
    a_cur[u] = la[row];
    b_cur[u] = bp[row];
  }
  float h = ready();
  for (int g = t0; g < t1; g += UNROLL) {
    T a_nxt[UNROLL], b_nxt[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {          // the next group's loads
      const size_t row = (size_t)min(g + UNROLL + u, t1 - 1) * W;
      a_nxt[u] = la[row];
      b_nxt[u] = bp[row];
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {          // this group's chain
      const int t = g + u;
      if (t < t1) {
        const float a = expf(fminf(to_f32(a_cur[u]), 0.f));
        h = fmaf(a, h, to_f32(b_cur[u]));
        step(t, a, h);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      a_cur[u] = a_nxt[u];
      b_cur[u] = b_nxt[u];
    }
  }
}

// Pass 1: grid (ceil(W/THREADS), n_chunks, B).
template <typename T>
__global__ void __launch_bounds__(THREADS)
rglru_chunk_sums(const T* __restrict__ log_a, const T* __restrict__ bx,
                 float2* __restrict__ sums, int Tn, int W, int C) {
  const int w = blockIdx.x * THREADS + threadIdx.x;
  const int c = blockIdx.y, b = blockIdx.z, nc = gridDim.y;
  allow_dependents();
  if (w >= W) return;
  const size_t col = (size_t)b * Tn * W + w;
  float prod = 1.f, end = 0.f;
  walk(log_a + col, bx + col, c * C, min(c * C + C, Tn), W,
       [&](int, float a, float h) { prod *= a; end = h; }, [] { return 0.f; });
  sums[((size_t)b * nc + c) * W + w] = make_float2(prod, end);
}

// Pass 2: grid (ceil(W/THREADS), n_chunks, B), chunks last first.
template <typename T>
__global__ void __launch_bounds__(THREADS)
rglru_chunk_walk(const T* __restrict__ log_a, const T* __restrict__ bx,
                 const float* __restrict__ h0,
                 const float2* __restrict__ sums, T* __restrict__ out, int Tn,
                 int W, int C) {
  const int w = blockIdx.x * THREADS + threadIdx.x;
  const int nc = gridDim.y, c = nc - 1 - blockIdx.y, b = blockIdx.z;
  if (w >= W) return;
  const size_t col = (size_t)b * Tn * W + w;
  T* op = out + col;
  walk(log_a + col, bx + col, c * C, min(c * C + C, Tn), W,
       [&](int t, float, float h) { store(op + (size_t)t * W, h); },
       [&] {                   // the carry into chunk c, once pass 1 is done
         float h = h0[(size_t)b * W + w];
         if (c == 0) return h;
         wait_primary();
         const float2* sp = sums + (size_t)b * nc * W + w;
         for (int j0 = 0; j0 < c; j0 += CARRY_UNROLL) {
           float2 s[CARRY_UNROLL];
#pragma unroll
           for (int u = 0; u < CARRY_UNROLL; ++u)
             s[u] = sp[(size_t)min(j0 + u, c - 1) * W];
#pragma unroll
           for (int u = 0; u < CARRY_UNROLL; ++u)
             if (j0 + u < c) h = fmaf(s[u].x, h, s[u].y);
         }
         return h;
       });
}

template <typename T>
static int launch(const void* log_a, const void* b, const float* h0,
                  float2* sums, void* out, int B, int Tn, int W, int C,
                  cudaStream_t s) {
  const int nc = (Tn + C - 1) / C;
  const dim3 grid((W + THREADS - 1) / THREADS, nc, B);
  if (nc == 1) {               // the single walk, after whatever made its inputs
    rglru_chunk_walk<T><<<grid, THREADS, 0, s>>>(
        (const T*)log_a, (const T*)b, h0, sums, (T*)out, Tn, W, C);
    return (int)cudaGetLastError();
  }
  rglru_chunk_sums<T><<<grid, THREADS, 0, s>>>((const T*)log_a, (const T*)b,
                                               sums, Tn, W, C);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // pass 2 may start as pass 1's last blocks run: its inputs were ready when
  // pass 1 started, and it waits for the sums
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, rglru_chunk_walk<T>, (const T*)log_a,
                                 (const T*)b, h0, (const float2*)sums, (T*)out,
                                 Tn, W, C);
}

// Plain C entry point, loaded with ctypes.  log_a, b and out (B,T,W)
// contiguous, h0 (B,W) float32 contiguous; `bf16` selects bfloat16 (1) or
// float32 (0) for log_a, b and out alike.  C is the chunk: with
// ceil(T/C) > 1 chunks both passes run and `sums` holds B*ceil(T/C)*W
// float2 of workspace; with one chunk only pass 2 runs and `sums` is not
// read.  Launches on `stream` and returns cudaGetLastError() (0 on
// success), or cudaErrorInvalidValue for a shape the kernel does not take;
// it never synchronises.
extern "C" int rglru_scan_launch(const void* log_a, const void* b,
                                 const float* h0, void* sums, void* out, int B,
                                 int T, int W, int C, int bf16, void* stream) {
  if (B < 0 || T < 0 || W < 0 || C <= 0 || B > 65535 ||
      (T + (long long)C - 1) / C > 65535 || (T > C && sums == nullptr))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || T == 0 || W == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return launch<__nv_bfloat16>(log_a, b, h0, (float2*)sums, out, B, T, W, C,
                                 s);
  return launch<float>(log_a, b, h0, (float2*)sums, out, B, T, W, C, s);
}
