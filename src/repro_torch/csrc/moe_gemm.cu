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
// B4a in bfloat16 (the serving path), where K and N are multiples of 8
// (TMA's 16-byte strides), has a design of its own for Hopper
// (`moe_gemm_tma`).  The grid above is 1.2-1.5 waves at dbrx's shapes
// (E=16, K=10752, N=6144: 768 blocks, 4-5 resident per SM), so the weight
// stream thins out in the last wave.  Here one CTA per SM walks a static
// share of the work: the units (expert, row tile of up to 64, column tile
// of 256, contraction chunk of 64) in that order, chunk fastest, split into
// equal contiguous ranges, one per CTA.  The split is a function of the
// shapes and the SM count alone (kernels/moe_gemm/ref.py gemm_plan, whose
// CTA count the wrapper passes in): the most CTAs, within a tenth of the SM
// count, that take the tiles whole and alike (dbrx: 384 tiles on 128 CTAs,
// 3 each), so every CTA walks the contraction in step with the others and
// their weight reads meet in DRAM, as a tile grid's do; else one CTA per
// SM.  A tile that a range boundary cuts is summed in float32 by each CTA
// over its chunks into a workspace slot, and `moe_gemm_merge`, a second
// launch, adds the slots in CTA order (so in contraction order) and rounds
// once: a call gives the same bits every time.  One producer warp issues
// each chunk's weights (four 64 x 64 boxes) and x (64 x rows) by TMA into a
// ring of mbarriers (5-6 stages), 128-byte swizzled; the weights, read once, are marked first to leave L2 and x,
// read once per column tile, last.  One consumer warpgroup multiplies on
// wgmma with the operands swapped: out^T = w^T x^T, so each 64-column
// weight box is the M side, read from shared memory as it lies (MN-major:
// the transpose bit), and C, padded to a multiple of 8, is the N side (x,
// K-major).  TMA's zero fill gives the ragged edges in C, K and N.
//
// Floating point: products and sums in float32 (nvcc's default FMA
// contraction on the CUDA cores; the tensor cores' f32 accumulation for
// bf16), expf (not __expf) and IEEE division in the SiLU; the output rounds
// to nearest even.  B4a's split tiles add their partial sums in float32 in
// a fixed order before the one rounding.
#include <cuda.h>
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

// ---------------------------------------------------------------------------
// B4a in bfloat16 for Hopper: persistent grid, TMA ring, split merge
// ---------------------------------------------------------------------------

#define T_NB 4             // 64-column weight boxes per unit
#define T_N (64 * T_NB)    // output columns per tile
#define T_K 64             // contraction rows per unit
#define T_C 64             // rows of C per tile at most
#define T_SMEM 232448      // shared memory a block may take
#define T_CONSUMERS 128    // one warpgroup
#define T_THREADS (T_CONSUMERS + 32)
#define T_WBOX 8192        // one 64 x 64 bf16 weight box

// The static split: units (e, ct, nt, kc), kc fastest; CTA g takes units
// [g * units / G, (g + 1) * units / G).
struct GemmPlan {
  bf16* out;
  float* ws;       // 2 slots per CTA of rows x T_N float32 partial sums
  int C, N, CT, NT, KC, G;
  long long units;
};

__device__ __forceinline__ long long unit_start(const GemmPlan& p, int g) {
  return (long long)g * p.units / p.G;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// Wait until the barrier's phase of parity `parity` has completed; a phase
// that never completes (a fault of the copies) traps instead of hanging.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done, tries = 0;
  do {
    if (++tries == (1u << 26)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// L2 cache policies of a TMA load (the encodings CUTLASS's TMA::CacheHintSm90
// names): data read once leaves L2 first, data read again stays longest.
#define L2_EVICT_FIRST 0x12F0000000000000ull
#define L2_EVICT_LAST 0x14F0000000000000ull

// One box of a 3-d tensor map into shared memory, completing on `bar`, with
// an L2 cache policy.
__device__ __forceinline__ void tma_load3(uint32_t dst, const CUtensorMap* map,
                                          int c0, int c1, int c2, uint32_t bar,
                                          uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1, {%2, %3, %4}], [%5], %6;\n" ::"r"(dst),
      "l"((uint64_t)map), "r"(c0), "r"(c1), "r"(c2), "r"(bar), "l"(policy)
      : "memory");
}
// A wgmma shared-memory descriptor for a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Pins register values in place between the wgmma fence, issue and wait.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D (64 x N, f32) += A (64 x 16, shared memory, MN-major: the transpose
// bit) * B (16 x N, shared memory, K-major), N a multiple of 8 up to 64.
template <int N>
__device__ __forceinline__ void wgmma_tn(float* d, uint64_t da, uint64_t db);

template <>
__device__ __forceinline__ void wgmma_tn<8>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tn<16>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tn<24>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %14, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11"
      "}, %12, %13, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tn<32>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tn<40>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %22, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19"
      "}, %20, %21, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tn<48>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, %24, %25, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tn<56>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %30, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n56k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27"
      "}, %28, %29, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_tn<64>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// Stages of the ring for tiles of CB rows: as many as a block's shared memory holds.
template <int CB>
struct Ring {
  static constexpr int STAGE = T_NB * T_WBOX + CB * 128;  // weights, then x
  static constexpr int DEPTH = (T_SMEM - 1024 - 256) / STAGE;
  static constexpr int SMEM = DEPTH * STAGE + 1024 + 2 * DEPTH * 8;
  static_assert(DEPTH >= 2 && SMEM <= T_SMEM, "the ring must fit");
};

// NT8 tiles of 8 on the N side: tiles of up to 8 * NT8 rows of C.
template <int NT8>
__global__ void __launch_bounds__(T_THREADS, 1)
moe_gemm_tma(const __grid_constant__ CUtensorMap tmw,
             const __grid_constant__ CUtensorMap tmx, const GemmPlan p) {
  constexpr int CB = 8 * NT8;                   // rows of C per tile
  constexpr int STAGE = Ring<CB>::STAGE;
  constexpr int T_STAGES = Ring<CB>::DEPTH;
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1,024 bytes: align the boxes to it
  uint8_t* smem = (uint8_t*)(((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);
  const uint32_t s0 = (uint32_t)__cvta_generic_to_shared(smem);
  const uint32_t bars = s0 + T_STAGES * STAGE;  // full, then empty
  const int tid = threadIdx.x, g = blockIdx.x;
  const long long u0 = unit_start(p, g), u1 = unit_start(p, g + 1);

  if (tid == 0) {
    for (int s = 0; s < T_STAGES; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (T_STAGES + s), T_CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= T_CONSUMERS) {  // producer warp: one thread issues every copy
    if (tid == T_CONSUMERS) {
      // the first unit's coordinates, then each next one by counting
      const long long t0 = u0 / p.KC;
      int kc = (int)(u0 - t0 * p.KC), nt = (int)(t0 % p.NT);
      int ct = (int)(t0 / p.NT % p.CT), e = (int)(t0 / p.NT / p.CT);
      int s = 0, phase = 0;
      for (long long i = 0; i < u1 - u0; ++i) {
        if (i >= T_STAGES) mbar_wait(bars + 8 * (T_STAGES + s), phase ^ 1);
        const uint32_t full = bars + 8 * s, st = s0 + s * STAGE;
        mbar_expect_tx(full, STAGE);
#pragma unroll
        for (int b = 0; b < T_NB; ++b)
          tma_load3(st + b * T_WBOX, &tmw, nt * T_N + 64 * b, kc * T_K, e, full,
                    L2_EVICT_FIRST);
        tma_load3(st + T_NB * T_WBOX, &tmx, kc * T_K, ct * T_C, e, full, L2_EVICT_LAST);
        if (++s == T_STAGES) { s = 0; phase ^= 1; }
        if (++kc == p.KC) {
          kc = 0;
          if (++nt == p.NT) {
            nt = 0;
            if (++ct == p.CT) { ct = 0; ++e; }
          }
        }
      }
    }
    return;
  }

  const int warp = tid / 32, lane = tid % 32;
  const long long t_first = u0 / p.KC;

  int s = 0, phase = 0;
  for (long long u = u0; u < u1;) {
    const long long t = u / p.KC;
    const long long lo = u, hi = min(u1, (t + 1) * p.KC);
    // acc[box]: the 64 x CB fragment of wgmma, rows = output columns
    float acc[T_NB][CB / 2];
#pragma unroll
    for (int b = 0; b < T_NB; ++b)
#pragma unroll
      for (int i = 0; i < CB / 2; ++i) acc[b][i] = 0.f;
    for (; u < hi; ++u) {
      mbar_wait(bars + 8 * s, phase);
      const uint32_t st = s0 + s * STAGE, xst = st + T_NB * T_WBOX;
#pragma unroll
      for (int b = 0; b < T_NB; ++b) fence_regs<CB / 2>(acc[b]);
      wgmma_fence();
      // k-steps of 16: the weights' 16 rows (2,048 bytes), x's 32 bytes
#pragma unroll
      for (int b = 0; b < T_NB; ++b)
#pragma unroll
        for (int kk = 0; kk < T_K / 16; ++kk)
          wgmma_tn<CB>(acc[b], desc_sw128(st + b * T_WBOX + 2048 * kk, T_WBOX, 1024),
                       desc_sw128(xst + 32 * kk, 16, 1024));
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int b = 0; b < T_NB; ++b) fence_regs<CB / 2>(acc[b]);
      __syncwarp();
      if (lane == 0) mbar_arrive(bars + 8 * (T_STAGES + s));
      if (++s == T_STAGES) { s = 0; phase ^= 1; }
    }

    // element i of box b's fragment: output column 64 b + 16 warp + lane/4
    // + 8 ((i / 2) % 2), row of C 8 (i / 4) + 2 (lane % 4) + i % 2
    const int nt = (int)(t % p.NT), ct = (int)(t / p.NT % p.CT);
    const long long e = t / p.NT / p.CT;
    const bool whole = lo == t * p.KC && hi == (t + 1) * p.KC;
    float* slot = p.ws + (size_t)(2 * g + (t == t_first ? 0 : 1)) * CB * T_N;
#pragma unroll
    for (int b = 0; b < T_NB; ++b)
#pragma unroll
      for (int i = 0; i < CB / 2; ++i) {
        const int nl = 64 * b + 16 * warp + lane / 4 + 8 * ((i / 2) % 2);
        const int cl = 8 * (i / 4) + 2 * (lane % 4) + i % 2;
        const int c = ct * T_C + cl, n = nt * T_N + nl;
        if (!whole)
          slot[cl * T_N + nl] = acc[b][i];
        else if (c < p.C && n < p.N)
          store(p.out + ((size_t)e * p.C + c) * p.N + n, acc[b][i]);
      }
  }
}

// The tiles that range boundaries cut: block b takes the boundary of CTA
// b + 1 and, if that is the first boundary inside its tile, adds the
// tile's partial sums in CTA order and stores them.
__global__ void __launch_bounds__(256)
moe_gemm_merge(const GemmPlan p, int CB) {
  const int g = blockIdx.x + 1;
  const long long s = unit_start(p, g);
  if (s % p.KC == 0) return;
  const long long t = s / p.KC;
  const long long s_prev = unit_start(p, g - 1);
  if (s_prev > t * p.KC) return;  // an earlier boundary's tile
  int g_last = g;
  while (g_last + 1 < p.G && unit_start(p, g_last + 1) < (t + 1) * p.KC) ++g_last;
  // CTA g - 1's slot of this tile is its first if it starts the tile, else
  // its last; every later CTA starts inside the tile: its first
  const int first = 2 * (g - 1) + (s_prev == t * p.KC ? 0 : 1);
  const int nt = (int)(t % p.NT), ct = (int)(t / p.NT % p.CT);
  const long long e = t / p.NT / p.CT;
  const size_t stride = (size_t)CB * T_N;
  for (int idx = threadIdx.x; idx < CB * T_N; idx += blockDim.x) {
    const int c = ct * T_C + idx / T_N, n = nt * T_N + idx % T_N;
    if (c >= p.C || n >= p.N) continue;
    float sum = p.ws[first * stride + idx];
    for (int gg = g; gg <= g_last; ++gg) sum += p.ws[2 * gg * stride + idx];
    store(p.out + ((size_t)e * p.C + c) * p.N + n, sum);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime, so the library needs no -lcuda.
static EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault,
                                &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = (EncodeTiled)ptr;
  }
  return fn;
}

// A 3-d tensor map of a contiguous bf16 (d2, d1, d0) array, boxes of 64 x
// box1 (x 1), 128-byte swizzle, zeros past every edge.
static int map3(CUtensorMap* map, const void* base, long long d0, long long d1,
                long long d2, int box1) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)d0, (cuuint64_t)d1, (cuuint64_t)d2};
  const cuuint64_t strides[2] = {(cuuint64_t)(d0 * 2), (cuuint64_t)(d0 * d1 * 2)};
  const cuuint32_t box[3] = {64, (cuuint32_t)box1, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, (void*)base, dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int NT8>
static int launch_tma(const void* x, const void* w, const GemmPlan& p, int E,
                      int K, bool merge, cudaStream_t stream) {
  constexpr int CB = 8 * NT8;
  constexpr int smem = Ring<CB>::SMEM;
  static bool ready = false;  // the shared-memory limit, set once
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        moe_gemm_tma<NT8>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    ready = true;
  }
  CUtensorMap tmw, tmx;
  int rc = map3(&tmw, w, p.N, K, E, T_K);
  if (rc == 0) rc = map3(&tmx, x, K, p.C, E, CB);
  if (rc != 0) return rc;
  moe_gemm_tma<NT8><<<p.G, T_THREADS, smem, stream>>>(tmw, tmx, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !merge) return (int)err;
  moe_gemm_merge<<<p.G - 1, 256, 0, stream>>>(p, CB);
  return (int)cudaGetLastError();
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

// B4a's entry point, loaded with ctypes: x (E,C,K), w (E,K,N), out (E,C,N).
// In bfloat16 with K and N multiples of 8 (16-byte rows for TMA), x and w
// 16-byte aligned and K > 0, it launches the persistent kernel on the
// `ctas` CTAs of kernels/moe_gemm/ref.py gemm_plan (and the merge when
// `merge`, the plan cutting a tile), with `ws` holding 2 * ctas * rows * 256
// floats, rows = min(64, C rounded up to 8); otherwise it runs
// moe_gemm_launch's kernels and ignores ws, ctas and merge.
// Launches on `stream`, returns cudaGetLastError() (0 on success) or
// cudaErrorInvalidValue; it never synchronises.
extern "C" int grouped_gemm_launch(const void* x, const void* w, void* out,
                                   void* ws, int E, int C, int K, int N,
                                   int bf16_in, int ctas, int merge,
                                   void* stream) {
  if (!bf16_in || K <= 0 || K % 8 || N % 8 || ((uintptr_t)x | (uintptr_t)w) % 16)
    return moe_gemm_launch(x, w, nullptr, out, E, C, K, N, 0, bf16_in, stream);
  if (E < 0 || C < 0 || N < 0 || ctas < 1 || ws == nullptr)
    return (int)cudaErrorInvalidValue;
  if (E == 0 || C == 0 || N == 0) return 0;
  GemmPlan p;
  p.out = (bf16*)out;
  p.ws = (float*)ws;
  p.C = C; p.N = N;
  p.CT = (C + T_C - 1) / T_C;
  p.NT = (N + T_N - 1) / T_N;
  p.KC = (K + T_K - 1) / T_K;
  p.units = (long long)E * p.CT * p.NT * p.KC;
  if (ctas > p.units) return (int)cudaErrorInvalidValue;
  p.G = ctas;
  const int nt8 = (C < T_C ? (C + 7) / 8 : T_C / 8);
  cudaStream_t s = (cudaStream_t)stream;
  switch (nt8) {
    case 1: return launch_tma<1>(x, w, p, E, K, merge, s);
    case 2: return launch_tma<2>(x, w, p, E, K, merge, s);
    case 3: return launch_tma<3>(x, w, p, E, K, merge, s);
    case 4: return launch_tma<4>(x, w, p, E, K, merge, s);
    case 5: return launch_tma<5>(x, w, p, E, K, merge, s);
    case 6: return launch_tma<6>(x, w, p, E, K, merge, s);
    case 7: return launch_tma<7>(x, w, p, E, K, merge, s);
    default: return launch_tma<8>(x, w, p, E, K, merge, s);
  }
}
