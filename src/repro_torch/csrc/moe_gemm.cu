// Grouped expert GEMM and fused SwiGLU (MoE expert FFN) for Hopper,
// hand-written in CUDA C++.
//
// Replaces the Pallas TPU kernels repro/kernels/moe_gemm/kernel.py:
//   B4a `grouped_gemm`   out[e] = x[e] @ w[e]
//   B4b `grouped_swiglu` out[e] = silu(x[e] @ wg[e]) * (x[e] @ wu[e])
// Semantics are those of repro_torch/kernels/moe_gemm/ref.py, the plain
// versions: x (E,C,K), w (E,K,N), out (E,C,N), row-major, float32 or
// bfloat16; float32 accumulation and one rounding to the output dtype.  B4b
// keeps both products and the SiLU in float32, so h and u never reach
// device memory.  Any C, K and N: ragged tails are masked here (the TPU
// kernel asserts divisibility; the serving capacities are 4, 5, 10, 20, 40).
//
// What bounds it: bytes.  At the serving shapes (dbrx: E=16, K=6144,
// N=10752, C=4..40) every expert weight is used for C <= 40 rows, far below
// the card's ~295 flops per byte, so the time is the weight stream (B4b:
// 4.23 GB, 1.26 ms at 3.35 TB/s), provided each weight is read once and the
// arithmetic keeps up with it.
//
// Design.  The TPU kernel walks the contraction on a sequential grid axis
// with an f32 accumulator in VMEM.  Here one block of 8 warps owns BN = 128
// output columns of one expert and up to 64 rows of C (every serving
// capacity), so each weight is read from device memory once.  The
// contraction runs in chunks of BD = 32: a chunk of the weights (BD x BN
// per weight) and of x (rows x BD) is copied into shared memory with
// cp.async, STAGES chunks ahead of the one being multiplied, so the weight
// stream never waits on the arithmetic.  Each output's sum runs over the
// contraction in order in one thread (deterministic, no reduction), and
// the epilogue (SiLU * up for B4b) rounds once and stores.
//  - bfloat16 (the serving path) multiplies on the tensor cores:
//    mma.sync m16n8k16 (bf16 in, f32 accumulator), C padded with zero rows
//    to 16, 32, 48 or 64.  Warp w owns the block's columns 16w..16w+15 for
//    every row; its x fragments come from shared memory with ldmatrix and
//    its weight fragments with ldmatrix.trans (the weights are K-major).
//    Shared rows are padded by 16 bytes, so ldmatrix's eight row addresses
//    fall in distinct banks.
//  - float32 multiplies on the CUDA cores (tensor cores would round the
//    inputs to TF32): warp w owns rows w, w+8, ... and each lane 4 adjacent
//    columns, reading each weight row once from shared memory.
//
// Floating point: products and sums in float32 (nvcc's default FMA
// contraction on the CUDA cores; the tensor cores' f32 accumulation for
// bf16), expf (not __expf) and IEEE division in the SiLU; the output rounds
// to nearest even.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define THREADS 256
#define WARPS 8
#define BN 128     // output columns per block
#define BD 32      // contraction rows per chunk
#define STAGES 4   // chunks in shared memory: 3 in flight while one is used

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) { *p = __float2bfloat16_rn(x); }

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, bypassing L1; `bytes` < 16 fills the rest with
// zeros (0: all zeros, nothing read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One stage in shared memory: NW weight chunks (BD rows of row stride WS
// elements), then the x chunk (BC rows of row stride XS).
template <typename T, int NW, int BC, int WS, int XS>
struct Stage {
  static constexpr int W = NW * BD * WS;
  static constexpr int ELEMS = W + BC * XS;
  static_assert(ELEMS * sizeof(T) % 16 == 0, "stages must stay 16-byte aligned");
};

// Copy chunk `ch` (contraction rows d0 .. d0+BD) of the NW weights (columns
// n0 .. n0+BN) and of x (rows c0 .. c0+BC) into stage `st`; zeros past K, N
// and C.  `vec`: K and N are multiples of 16 bytes' worth of T and the
// bases are 16-byte aligned, so 16-byte cp.async pieces lie wholly inside
// or outside; otherwise element by element.
template <typename T, int NW, int BC, int WS, int XS>
__device__ __forceinline__ void load_stage(T* st, const T* const (&w)[NW],
                                           const T* xe, int ch, int c0, int n0,
                                           int C, int K, int N, bool vec) {
  const int d0 = ch * BD;
  T* xs = st + Stage<T, NW, BC, WS, XS>::W;
  if (vec) {
    constexpr int EPP = 16 / sizeof(T);    // elements per 16-byte piece
    constexpr int WPR = BN / EPP;          // pieces per weight row
    constexpr int XPR = BD / EPP;          // pieces per x row
    for (int p = threadIdx.x; p < NW * BD * WPR; p += THREADS) {
      const int i = p / (BD * WPR), r = p / WPR % BD, q = p % WPR;
      const int d = d0 + r, n = n0 + q * EPP;
      const bool in = d < K && n < N;
      cp_async16(st + (i * BD + r) * WS + q * EPP,
                 in ? w[i] + (size_t)d * N + n : w[i], in ? 16 : 0);
    }
    for (int p = threadIdx.x; p < BC * XPR; p += THREADS) {
      const int r = p / XPR, q = p % XPR;
      const int c = c0 + r, d = d0 + q * EPP;
      const bool in = c < C && d < K;
      cp_async16(xs + r * XS + q * EPP, in ? xe + (size_t)c * K + d : xe,
                 in ? 16 : 0);
    }
  } else {
    for (int p = threadIdx.x; p < NW * BD * BN; p += THREADS) {
      const int i = p / (BD * BN), r = p / BN % BD, q = p % BN;
      const int d = d0 + r, n = n0 + q;
      st[(i * BD + r) * WS + q] = d < K && n < N ? w[i][(size_t)d * N + n] : T(0.f);
    }
    for (int p = threadIdx.x; p < BC * BD; p += THREADS) {
      const int r = p / BD, q = p % BD;
      const int c = c0 + r, d = d0 + q;
      xs[r * XS + q] = c < C && d < K ? xe[(size_t)c * K + d] : T(0.f);
    }
  }
}

// The chunk loop both kernels share: stage chunks STAGES-1 ahead, and call
// `compute(stage)` on each chunk once it has landed.
template <typename T, int NW, int BC, int WS, int XS, typename F>
__device__ __forceinline__ void chunk_loop(T* smem, const T* const (&w)[NW],
                                           const T* xe, int c0, int n0, int C,
                                           int K, int N, bool vec, F compute) {
  constexpr int ELEMS = Stage<T, NW, BC, WS, XS>::ELEMS;
  const int nchunks = (K + BD - 1) / BD;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nchunks)
      load_stage<T, NW, BC, WS, XS>(smem + s * ELEMS, w, xe, s, c0, n0, C, K, N, vec);
    cp_async_commit();
  }
  for (int ch = 0; ch < nchunks; ++ch) {
    // chunk ch has landed (at most STAGES-2 younger groups pending), and
    // every warp is done with the stage chunk ch-1 used
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int next = ch + STAGES - 1;
    if (next < nchunks)
      load_stage<T, NW, BC, WS, XS>(smem + next % STAGES * ELEMS, w, xe, next,
                                    c0, n0, C, K, N, vec);
    cp_async_commit();
    compute(smem + ch % STAGES * ELEMS);
  }
  cp_async_wait<0>();
}

__device__ __forceinline__ float epilogue(float g, float u, bool swiglu) {
  return swiglu ? g / (1.f + expf(-g)) * u : g;
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores
// ---------------------------------------------------------------------------

#define WS_MMA (BN + 8)  // padded rows: ldmatrix's 8 rows hit distinct banks
#define XS_MMA (BD + 8)

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
// c += a (16x16, row-major) @ b (16x8, k-major)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// MT row tiles of 16 (BC = 16 MT rows of C per block).
template <int MT, bool SWIGLU>
__global__ void __launch_bounds__(THREADS)
moe_gemm_mma(const bf16* __restrict__ x, const bf16* __restrict__ wg,
             const bf16* __restrict__ wu, bf16* __restrict__ out, int C, int K,
             int N, int vec) {
  constexpr int NW = SWIGLU ? 2 : 1;
  constexpr int BC = 16 * MT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);

  const int e = blockIdx.z, c0 = blockIdx.x * BC, n0 = blockIdx.y * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bf16* xe = x + (size_t)e * C * K;
  const bf16* w[NW];
  w[0] = wg + (size_t)e * K * N;
  if constexpr (SWIGLU) w[NW - 1] = wu + (size_t)e * K * N;

  // acc[weight][row tile][column tile of 8]: the m16n8 accumulator fragment
  float acc[NW][MT][2][4] = {};
  // ldmatrix row addresses: x rows (lane & 15) at k offset 8 (lane >> 4);
  // weight rows (k) (lane & 15) at column offset 8 (lane >> 4)
  const int a_off = (lane & 15) * XS_MMA + (lane >> 4) * 8;
  const int b_off = (lane & 15) * WS_MMA + warp * 16 + (lane >> 4) * 8;

  chunk_loop<bf16, NW, BC, WS_MMA, XS_MMA>(
      smem, w, xe, c0, n0, C, K, N, vec, [&](const bf16* ws) {
        const bf16* xs = ws + NW * BD * WS_MMA;
#pragma unroll
        for (int k = 0; k < BD; k += 16) {
          uint32_t a[MT][4];
#pragma unroll
          for (int m = 0; m < MT; ++m)
            ldmatrix_x4(a[m], xs + m * 16 * XS_MMA + k + a_off);
#pragma unroll
          for (int i = 0; i < NW; ++i) {
            uint32_t b[4];  // b0 b1 of columns 0-7, then of columns 8-15
            ldmatrix_x4_trans(b, ws + (i * BD + k) * WS_MMA + b_off);
#pragma unroll
            for (int m = 0; m < MT; ++m) {
              mma_bf16(acc[i][m][0], a[m], b[0], b[1]);
              mma_bf16(acc[i][m][1], a[m], b[2], b[3]);
            }
          }
        }
      });

  // fragment element (h, q): row lane/4 + 8h, column 2 (lane % 4) + q
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = c0 + m * 16 + lane / 4 + 8 * h;
      if (c >= C) continue;
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int n = n0 + warp * 16 + t * 8 + 2 * (lane % 4) + q;
          if (n < N)
            store(out + ((size_t)e * C + c) * N + n,
                  epilogue(acc[0][m][t][2 * h + q],
                                 acc[NW - 1][m][t][2 * h + q], SWIGLU));
        }
    }
}

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

// CPW rows per warp (BC = 8 CPW rows of C per block).
template <int CPW, bool SWIGLU>
__global__ void __launch_bounds__(THREADS)
moe_gemm_simt(const float* __restrict__ x, const float* __restrict__ wg,
              const float* __restrict__ wu, float* __restrict__ out, int C,
              int K, int N, int vec) {
  constexpr int NW = SWIGLU ? 2 : 1;
  constexpr int BC = WARPS * CPW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);

  const int e = blockIdx.z, c0 = blockIdx.x * BC, n0 = blockIdx.y * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* xe = x + (size_t)e * C * K;
  const float* w[NW];
  w[0] = wg + (size_t)e * K * N;
  if constexpr (SWIGLU) w[NW - 1] = wu + (size_t)e * K * N;
  // a warp whose first row is past C has only zero rows: it copies, but
  // does not multiply
  const bool active = c0 + warp < C;

  float acc[NW][CPW][4] = {};
  chunk_loop<float, NW, BC, BN, BD>(
      smem, w, xe, c0, n0, C, K, N, vec, [&](const float* ws) {
        if (!active) return;
        const float* xs = ws + NW * BD * BN;
#pragma unroll 2
        for (int d = 0; d < BD; d += 4) {
          float4 xv[CPW];
#pragma unroll
          for (int r = 0; r < CPW; ++r)
            xv[r] = *reinterpret_cast<const float4*>(xs + (warp + WARPS * r) * BD + d);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float4 wv[NW];
#pragma unroll
            for (int i = 0; i < NW; ++i)
              wv[i] = *reinterpret_cast<const float4*>(ws + (i * BD + d + j) * BN + 4 * lane);
#pragma unroll
            for (int r = 0; r < CPW; ++r) {
              const float xr = j == 0 ? xv[r].x : j == 1 ? xv[r].y : j == 2 ? xv[r].z : xv[r].w;
#pragma unroll
              for (int i = 0; i < NW; ++i) {
                acc[i][r][0] += xr * wv[i].x;
                acc[i][r][1] += xr * wv[i].y;
                acc[i][r][2] += xr * wv[i].z;
                acc[i][r][3] += xr * wv[i].w;
              }
            }
          }
        }
      });

#pragma unroll
  for (int r = 0; r < CPW; ++r) {
    const int c = c0 + warp + WARPS * r;
    if (c >= C) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + 4 * lane + j;
      if (n < N)
        store(out + ((size_t)e * C + c) * N + n,
              epilogue(acc[0][r][j], acc[NW - 1][r][j], SWIGLU));
    }
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

template <typename K_, typename T>
static int launch(K_ kernel, size_t smem, int rows, const void* x,
                  const void* w, const void* wu, void* out, int E, int C,
                  int K, int N, int vec, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((C + rows - 1) / rows, (N + BN - 1) / BN, E);
  kernel<<<grid, THREADS, smem, stream>>>((const T*)x, (const T*)w,
                                          (const T*)wu, (T*)out, C, K, N, vec);
  return (int)cudaGetLastError();
}

template <int MT, bool SWIGLU>
static int launch_mma(const void* x, const void* w, const void* wu, void* out,
                      int E, int C, int K, int N, int vec, cudaStream_t s) {
  constexpr int NW = SWIGLU ? 2 : 1;
  constexpr size_t smem =
      STAGES * Stage<bf16, NW, 16 * MT, WS_MMA, XS_MMA>::ELEMS * sizeof(bf16);
  return launch<decltype(&moe_gemm_mma<MT, SWIGLU>), bf16>(
      moe_gemm_mma<MT, SWIGLU>, smem, 16 * MT, x, w, wu, out, E, C, K, N, vec, s);
}

template <int CPW, bool SWIGLU>
static int launch_simt(const void* x, const void* w, const void* wu, void* out,
                       int E, int C, int K, int N, int vec, cudaStream_t s) {
  constexpr int NW = SWIGLU ? 2 : 1;
  constexpr size_t smem =
      STAGES * Stage<float, NW, WARPS * CPW, BN, BD>::ELEMS * sizeof(float);
  return launch<decltype(&moe_gemm_simt<CPW, SWIGLU>), float>(
      moe_gemm_simt<CPW, SWIGLU>, smem, WARPS * CPW, x, w, wu, out, E, C, K, N,
      vec, s);
}

template <bool SWIGLU>
static int dispatch(const void* x, const void* w, const void* wu, void* out,
                    int E, int C, int K, int N, int bf16_in, int vec,
                    cudaStream_t s) {
  // the fewest rows per block that hold all of C (<= 64: every serving
  // capacity), else 64-row tiles
  if (bf16_in) {
    if (C <= 16) return launch_mma<1, SWIGLU>(x, w, wu, out, E, C, K, N, vec, s);
    if (C <= 32) return launch_mma<2, SWIGLU>(x, w, wu, out, E, C, K, N, vec, s);
    if (C <= 48) return launch_mma<3, SWIGLU>(x, w, wu, out, E, C, K, N, vec, s);
    return launch_mma<4, SWIGLU>(x, w, wu, out, E, C, K, N, vec, s);
  }
  if (C <= 8) return launch_simt<1, SWIGLU>(x, w, wu, out, E, C, K, N, vec, s);
  if (C <= 16) return launch_simt<2, SWIGLU>(x, w, wu, out, E, C, K, N, vec, s);
  if (C <= 24) return launch_simt<3, SWIGLU>(x, w, wu, out, E, C, K, N, vec, s);
  if (C <= 40) return launch_simt<5, SWIGLU>(x, w, wu, out, E, C, K, N, vec, s);
  return launch_simt<8, SWIGLU>(x, w, wu, out, E, C, K, N, vec, s);
}

// Plain C entry point, loaded with ctypes.  x (E,C,K); w (and w_up when
// `swiglu`) (E,K,N); out (E,C,N); `bf16` selects bfloat16 (1) or float32
// (0) for all of them.  Launches on `stream` and returns cudaGetLastError()
// (0 on success), or cudaErrorInvalidValue for a shape the kernel does not
// take; it never synchronises.
extern "C" int moe_gemm_launch(const void* x, const void* w, const void* w_up,
                               void* out, int E, int C, int K, int N,
                               int swiglu, int bf16_in, void* stream) {
  if (E < 0 || C < 0 || K < 0 || N < 0 || E > 65535 ||
      (N + BN - 1) / BN > 65535 || (swiglu && w_up == nullptr))
    return (int)cudaErrorInvalidValue;
  if (E == 0 || C == 0 || N == 0) return 0;
  const int epp = bf16_in ? 8 : 4;   // elements in 16 bytes
  const uintptr_t align = (uintptr_t)x | (uintptr_t)w | (uintptr_t)(swiglu ? w_up : w);
  const int vec = K % epp == 0 && N % epp == 0 && align % 16 == 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (swiglu) return dispatch<true>(x, w, w_up, out, E, C, K, N, bf16_in, vec, s);
  return dispatch<false>(x, w, w_up, out, E, C, K, N, bf16_in, vec, s);
}
