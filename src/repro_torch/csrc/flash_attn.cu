// Flash-attention kernel (prefill) for Hopper, hand-written in CUDA C++.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attn/kernel.py
// (`_flash_kernel`, launched by `flash_attention`).  Semantics are those of
// repro_torch/kernels/flash_attn/ref.py, its plain version:
//   q (B,H,Sq,dh), k/v (B,KV,Skv,dh), float32 or bfloat16, any element
//   strides with dh contiguous; o written through its own strides;
//   query head h reads KV head h / (H/KV) (GQA, no KV copy);
//   s = (q . k) / sqrt(dh), key j visible to query i when j < Skv,
//   j <= i (causal) and j > i - window (window > 0);
//   float32 online softmax; a row that sees no key gives 0 through the
//   max(l, 1e-30) denominator; output in q's dtype.
//
// The TPU kernel walks a sequential grid axis over KV blocks and carries
// (m, l, acc) in VMEM scratch.  Blocks here run in no order, so a block
// owns a tile of query rows and loops over the KV tiles itself, carrying
// (m, l, acc) in registers.  Tiles the mask leaves empty are skipped, as
// the TPU kernel's pl.when skips them.  Two paths, chosen by dtype:
//
// bfloat16 (every full-width expert): QK^T and PV on the tensor cores.
//  - Work unit: one block per (b, KV head, tile of 64 packed query rows).
//    The G = H/KV query heads that share a KV head are packed into the
//    rows, packed row r <-> (position r / G, head r % G), so each K/V tile
//    is fetched once per KV head instead of G times, and the short
//    serving prefills (16-128 positions) still fill the 64-row tile.  A
//    tile may hold part of a position's heads; the mask is per row, by the
//    row's position, and the tile's key range comes from the positions of
//    its first and last rows.  The grid starts the tiles with the most keys
//    (the last positions, under causal) first.
//  - 160 threads: warps 0-3 are one consumer warpgroup (16 rows a warp),
//    warp 4 the producer.  One producer thread copies K and V tiles of 64
//    keys by TMA (cp.async.bulk.tensor) into a 2-stage ring in shared
//    memory; K and V of a stage complete on mbarriers of their own, so QK^T
//    starts while V is still in flight, and the consumers free a stage on
//    a third.  dh is cut into 64-element (128-byte) boxes stored with the
//    128-byte swizzle; the tensor map's dh extent zero-fills the columns
//    past dh (dh = 120 pads to 128 for free), and rows past Skv load as
//    zeros.  Q is loaded once per block by the consumers into the same
//    swizzled layout.
//  - S = Q K^T by wgmma m64n64k16 (both operands in shared memory, K-major),
//    4 k-steps of 16 per 64-column box into float32 registers.  The online
//    softmax runs on the accumulator fragments: a thread holds 2 rows x 16
//    keys, each row's max is taken across the 4 threads that share it,
//    scores are scaled by log2(e)/sqrt(dh) and exponentiated with
//    ex2.approx.  The mask is applied only on tiles that cross the
//    diagonal, the window's lower edge or Skv.  P is rounded to bf16 in
//    registers and is wgmma's register A operand for O += P V
//    (m64n{64,128}k16), V read MN-major through the transpose bit, so V
//    needs no transposed copy.  The row sum l is taken over the float32
//    p, before that rounding, as FlashAttention does.  The 4 threads of a
//    row keep partial sums of l and add them once, in the epilogue.
//
// float32 (the reduced configs): the CUDA cores, so the tolerance of 2e-5
// holds (the tensor cores would round to TF32).  One block owns BQ=32 query
// rows of one (batch, head); each row has TPR=4 adjacent threads, a thread
// holding every fourth 4-value chunk of the head dimension of q and of the
// accumulator, the row's score summed over the four threads with two
// shuffles.  A tile of BKV=32 keys and values is staged through shared
// memory.
//
// What bounds it: operations.  At a long prefill the work is 4*H*dh*(visible
// q-k pairs) flops against ~4*B*H*S*dh*2 bytes, far above the card's ~295
// bf16 flops per byte; at the serving shapes (S <= 128) a launch is bound
// by latency.
//
// Floating point.  bf16: products exact, sums in the tensor cores' float32;
// exp2 of log2e-scaled scores (ex2.approx, about 2 ulp); P rounded to bf16
// before PV (the TPU kernel multiplies p.v in float32); the output rounds
// to nearest even.  float32: nvcc's default FMA contraction, expf (not
// __expf) and IEEE division; the output is float32.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

// ---------------------------------------------------------------------------
// bfloat16 path: wgmma, TMA, mbarriers
// ---------------------------------------------------------------------------

#define BM 64              // packed query rows per block (one warpgroup)
#define BN 64              // keys per K/V tile
#define STAGES 2           // K/V tiles in shared memory
#define BOX_BYTES 8192     // one 64 x 64 bf16 box, 128-byte rows
#define CONSUMERS 128      // one warpgroup
#define TC_THREADS (CONSUMERS + 32)

struct Bf16Params {
  const bf16* q;
  bf16* o;
  long long sq0, sq1, sq2;  // q's element strides over (b, h, position)
  long long so0, so1, so2;  // o's
  int KV, G, Skv, dh, causal, window;
  int rows;                 // packed rows per (b, KV head): Sq * G
  int n_mtiles;
  int kperm, vperm;         // the tensor maps' dims 1-3: 0 key, 1 KV head, 2 b
  float scale_log2;         // log2(e) / sqrt(dh)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
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

// One box of a 4-d tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, int c2, int c3,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"((uint64_t)map), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// The coordinate of tensor-map dim d (1-3) from its role in `perm`.
__device__ __forceinline__ int coord(int perm, int d, int key, int kvh, int b) {
  const int role = (perm >> (2 * (d - 1))) & 3;
  return role == 0 ? key : role == 1 ? kvh : b;
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
// Pins register values in place between the wgmma fence, issue and wait:
// writes to an operand land before the fence, reads of a result after the
// wait.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&t);
}

// D (64 x 64, f32) = or += A (64 x 16, shared memory) * B (16 x 64,
// shared memory, K-major); both operands by descriptor.
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 64, f32) += A (64 x 16, registers) * B (16 x 64, shared
// memory, MN-major: the transpose bit).
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, f32) += A (64 x 16, registers) * B (16 x 128, shared
// memory, MN-major: the transpose bit).
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


// NB: 64-column boxes of the head dimension (1 for dh <= 64, 2 up to 128).
template <int NB>
__global__ void __launch_bounds__(TC_THREADS, 2)
flash_attn_bf16_kernel(const __grid_constant__ CUtensorMap tmk,
                       const __grid_constant__ CUtensorMap tmv,
                       const Bf16Params p) {
  constexpr int TILE = NB * BOX_BYTES;  // a Q, K or V tile
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1,024 bytes: align the tiles to it
  uint8_t* smem = (uint8_t*)(((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);
  const uint32_t q_s = smem_u32(smem);
  const uint32_t k_s = q_s + TILE;                 // STAGES K tiles
  const uint32_t v_s = k_s + STAGES * TILE;        // STAGES V tiles
  const uint32_t bars = v_s + STAGES * TILE;       // full_k, full_v, empty
  const int tid = threadIdx.x;

  const int b = blockIdx.x / p.KV, kvh = blockIdx.x % p.KV;
  const int r0 = (p.n_mtiles - 1 - blockIdx.y) * BM;  // heaviest tiles first
  const int p_lo = r0 / p.G, p_last = (min(r0 + BM, p.rows) - 1) / p.G;
  // the keys any row of this tile can see
  const int kv_end = p.causal ? min(p.Skv, p_last + 1) : p.Skv;
  const int kv_begin = p.window > 0 ? max(0, p_lo - p.window + 1) : 0;
  const int t_first = kv_begin / BN;
  const int n_tiles = kv_begin < kv_end ? (kv_end + BN - 1) / BN - t_first : 0;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (STAGES + s), 1);
      mbar_init(bars + 8 * (2 * STAGES + s), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMERS) {  // producer warp: one thread issues every copy
    if (tid == CONSUMERS) {
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        if (t >= STAGES) mbar_wait(bars + 8 * (2 * STAGES + s), (t / STAGES - 1) & 1);
        const int key = (t_first + t) * BN;
        const uint32_t fk = bars + 8 * s, fv = bars + 8 * (STAGES + s);
        mbar_expect_tx(fk, TILE);
#pragma unroll
        for (int x = 0; x < NB; ++x)
          tma_load(k_s + s * TILE + x * BOX_BYTES, &tmk, 64 * x,
                   coord(p.kperm, 1, key, kvh, b), coord(p.kperm, 2, key, kvh, b),
                   coord(p.kperm, 3, key, kvh, b), fk);
        mbar_expect_tx(fv, TILE);
#pragma unroll
        for (int x = 0; x < NB; ++x)
          tma_load(v_s + s * TILE + x * BOX_BYTES, &tmv, 64 * x,
                   coord(p.vperm, 1, key, kvh, b), coord(p.vperm, 2, key, kvh, b),
                   coord(p.vperm, 3, key, kvh, b), fv);
      }
    }
    return;
  }

  // Q: 64 packed rows, 16-byte chunks into the swizzled layout (chunk c of
  // row r at 16 * (c ^ (r % 8))), zeros past the rows and past dh
  for (int e = tid; e < BM * NB * 8; e += CONSUMERS) {
    const int r = e / (NB * 8), ch = e % (NB * 8);
    const int pr = r0 + r;
    uint4 x = make_uint4(0, 0, 0, 0);
    if (pr < p.rows && ch * 8 < p.dh) {
      const int pos = pr / p.G, h = kvh * p.G + pr % p.G;
      x = *reinterpret_cast<const uint4*>(p.q + b * p.sq0 + h * p.sq1 + pos * p.sq2 +
                                          ch * 8);
    }
    *reinterpret_cast<uint4*>(smem + (ch / 8) * BOX_BYTES + r * 128 +
                              (((ch % 8) ^ (r % 8)) << 4)) = x;
  }
  // generic-proxy stores, read next by wgmma through the async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");

  const int warp = tid / 32, lane = tid % 32;
  // this thread's two rows of the tile (accumulator fragments: rows ra and
  // ra + 8, columns 8j + 2 (lane % 4) + {0, 1})
  const int ra = 16 * warp + lane / 4;
  const int pos_a = (r0 + ra) / p.G, pos_b = (r0 + ra + 8) / p.G;
  const int col0 = 2 * (lane % 4);

  float o[NB * 32];
#pragma unroll
  for (int i = 0; i < NB * 32; ++i) o[i] = 0.f;
  float sc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % STAGES, parity = (t / STAGES) & 1;
    const int key0 = (t_first + t) * BN;
    mbar_wait(bars + 8 * s, parity);

    // S = Q K^T: K-major operands, k-steps of 16 advance 32 bytes in a row
    fence_regs<32>(sc);
    wgmma_fence();
#pragma unroll
    for (int x = 0; x < NB; ++x)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_n64(sc, desc_sw128(q_s + x * BOX_BYTES + 32 * kk, 16, 1024),
                     desc_sw128(k_s + s * TILE + x * BOX_BYTES + 32 * kk, 16, 1024),
                     x + kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<32>(sc);

#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] *= p.scale_log2;
    // mask only tiles that cross Skv, the diagonal or the window's edge
    const bool edge = key0 + BN > p.Skv || (p.causal && key0 + BN - 1 > p_lo) ||
                      (p.window > 0 && key0 <= p_last - p.window);
    if (edge) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int key = key0 + 8 * (i / 4) + col0 + (i % 2);
        const int pos = (i % 4) < 2 ? pos_a : pos_b;
        const bool seen = key < p.Skv && (!p.causal || key <= pos) &&
                          (p.window <= 0 || key > pos - p.window);
        if (!seen) sc[i] = -INFINITY;
      }
    }
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx_a = fmaxf(mx_a, fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx_b = fmaxf(mx_b, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
    const float new_a = fmaxf(m_a, mx_a), new_b = fmaxf(m_b, mx_b);
    const float use_a = new_a == -INFINITY ? 0.f : new_a;
    const float use_b = new_b == -INFINITY ? 0.f : new_b;
    const float corr_a = ex2(m_a - use_a), corr_b = ex2(m_b - use_b);  // -inf -> 0
    m_a = new_a;
    m_b = new_b;
    l_a *= corr_a;
    l_b *= corr_b;
    uint32_t pa[16];  // P as wgmma's A fragments: pa[4k..4k+3] for keys 16k..
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const bool row_a = (i % 2) == 0;
      const float p0 = ex2(sc[2 * i] - (row_a ? use_a : use_b));
      const float p1 = ex2(sc[2 * i + 1] - (row_a ? use_a : use_b));
      if (row_a) l_a += p0 + p1; else l_b += p0 + p1;
      pa[i] = pack_bf16(p0, p1);
    }
#pragma unroll
    for (int i = 0; i < NB * 32; ++i) o[i] *= (i % 4) < 2 ? corr_a : corr_b;

    // O += P V: V is the B operand, MN-major (dh contiguous); a k-step of
    // 16 keys is 16 rows of 128 bytes, the two 64-column boxes TILE / NB apart
    mbar_wait(bars + 8 * (STAGES + s), parity);
    fence_regs<NB * 32>(o);
    fence_regs<16>(pa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dv = desc_sw128(v_s + s * TILE + 2048 * kk, BOX_BYTES, 1024);
      if constexpr (NB == 1) wgmma_rs_n64(o, pa + 4 * kk, dv);
      else wgmma_rs_n128(o, pa + 4 * kk, dv);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<NB * 32>(o);
    mbar_arrive(bars + 8 * (2 * STAGES + s));  // this stage may be refilled
  }

  l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
  const float inv_a = 1.f / fmaxf(l_a, 1e-30f), inv_b = 1.f / fmaxf(l_b, 1e-30f);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int pr = r0 + ra + 8 * half;
    if (pr >= p.rows) continue;
    const int pos = half ? pos_b : pos_a, h = kvh * p.G + pr % p.G;
    bf16* out = p.o + b * p.so0 + h * p.so1 + pos * p.so2;
    const float inv = half ? inv_b : inv_a;
#pragma unroll
    for (int j = 0; j < NB * 8; ++j) {
      const int col = 8 * j + col0;
      if (col < p.dh)
        *reinterpret_cast<uint32_t*>(out + col) =
            pack_bf16(o[4 * j + 2 * half] * inv, o[4 * j + 2 * half + 1] * inv);
    }
  }
}

// ---------------------------------------------------------------------------
// float32 path: CUDA cores
// ---------------------------------------------------------------------------

#define BQ 32          // query rows per block
#define BKV 32         // keys per shared-memory tile
#define TPR 4          // threads per query row
#define THREADS (BQ * TPR)
#define MAX_CHUNKS 32  // head dimension <= 128, in chunks of 4 values

struct Strides {
  long long q0, q1, q2, k0, k1, k2, v0, v1, v2, o0, o1, o2;  // (b, head, position)
};

// NC: chunks of the head dimension per thread (ceil(dh/4 / TPR)).
template <int NC>
__global__ void __launch_bounds__(THREADS)
flash_attn_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      const Strides st, int H, int KV, int Sq, int Skv, int dh,
                      float scale, int causal, int window) {
  __shared__ float4 ks[BKV][MAX_CHUNKS];
  __shared__ float4 vs[BKV][MAX_CHUNKS];

  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int row = threadIdx.x / TPR, lane = threadIdx.x % TPR;
  const int q_lo = blockIdx.x * BQ;
  const int qpos = q_lo + row;
  const bool q_ok = qpos < Sq;
  const int nch = dh / 4;

  const float* qp = q + b * st.q0 + h * st.q1 + (q_ok ? qpos : 0) * st.q2;
  const float* kp = k + b * st.k0 + kvh * st.k1;
  const float* vp = v + b * st.v0 + kvh * st.v1;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  float4 qr[NC], acc[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int c = lane + TPR * i;
    float4 x = zero;
    if (q_ok && c < nch) {
      x = *reinterpret_cast<const float4*>(qp + 4 * c);
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
        kx = *reinterpret_cast<const float4*>(kp + j * st.k2 + 4 * c);
        vx = *reinterpret_cast<const float4*>(vp + j * st.v2 + 4 * c);
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
  float* op = o + b * st.o0 + h * st.o1 + qpos * st.o2;
  const float denom = fmaxf(l, 1e-30f);
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int c = lane + TPR * i;
    if (c < nch) {
      const float4 a = acc[i];
      *reinterpret_cast<float4*>(op + 4 * c) =
          make_float4(a.x / denom, a.y / denom, a.z / denom, a.w / denom);
    }
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

template <int NC>
static int launch_f32(const void* q, const void* k, const void* v, void* o,
                      const Strides& st, int B, int H, int KV, int Sq, int Skv,
                      int dh, float scale, int causal, int window,
                      cudaStream_t stream) {
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_attn_f32_kernel<NC><<<grid, THREADS, 0, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, st, H, KV,
      Sq, Skv, dh, scale, causal, window);
  return (int)cudaGetLastError();
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

// A 4-d tensor map of a bf16 k or v, dims (dh, then key, KV head, b in
// order of their strides), boxes of 64 columns x BN keys, 128-byte swizzle,
// zeros past every edge.  `perm` gets the role of dims 1-3 (2 bits each:
// 0 key, 1 KV head, 2 b).  The stride of a dim of extent 1 is never used;
// it is set past the others'.
static int kv_map(CUtensorMap* map, const void* base, int dh, int Skv, int KV,
                  int B, long long s_key, long long s_kvh, long long s_b,
                  int* perm) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  struct Dim { long long extent, stride; int role; } d[3] = {
      {Skv > 0 ? Skv : 1, s_key * 2, 0}, {KV, s_kvh * 2, 1}, {B, s_b * 2, 2}};
  long long span = 16;
  for (int i = 0; i < 3; ++i)
    if (d[i].extent > 1 && d[i].extent * d[i].stride > span) span = d[i].extent * d[i].stride;
  span = (span + 15) / 16 * 16;
  for (int i = 0; i < 3; ++i)
    if (d[i].extent == 1) d[i].stride = span;
  for (int i = 0; i < 3; ++i)  // sort by stride
    for (int j = 0; j + 1 < 3 - i; ++j)
      if (d[j + 1].stride < d[j].stride) { const Dim x = d[j]; d[j] = d[j + 1]; d[j + 1] = x; }
  const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)d[0].extent,
                              (cuuint64_t)d[1].extent, (cuuint64_t)d[2].extent};
  const cuuint64_t strides[3] = {(cuuint64_t)d[0].stride, (cuuint64_t)d[1].stride,
                                 (cuuint64_t)d[2].stride};
  cuuint32_t box[4] = {64, 1, 1, 1};
  for (int i = 0; i < 3; ++i)
    if (d[i].role == 0) box[i + 1] = BN;
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  *perm = d[0].role | d[1].role << 2 | d[2].role << 4;
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, (void*)base, dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int NB>
static int launch_bf16(const CUtensorMap& tmk, const CUtensorMap& tmv,
                       const Bf16Params& p, int B, cudaStream_t stream) {
  const int smem = (1 + 2 * STAGES) * NB * BOX_BYTES + 1024 + 64;
  static bool ready = false;  // the shared-memory limit, set once
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attn_bf16_kernel<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  const dim3 grid(B * p.KV, p.n_mtiles);
  flash_attn_bf16_kernel<NB><<<grid, TC_THREADS, smem, stream>>>(tmk, tmv, p);
  return (int)cudaGetLastError();
}

// Plain C entry point, loaded with ctypes.  `is_bf16` selects bfloat16 (1) or
// float32 (0) for q, k, v and o alike.  Strides are in elements, over (b,
// head, position), dh contiguous.  Launches on `stream` and returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a shape
// the kernel does not take; it never synchronises.
extern "C" int flash_attn_launch(const void* q, const void* k, const void* v,
                                 void* o, int B, int H, int KV, int Sq, int Skv,
                                 int dh, long long sq0, long long sq1, long long sq2,
                                 long long sk0, long long sk1, long long sk2,
                                 long long sv0, long long sv1, long long sv2,
                                 long long so0, long long so1, long long so2,
                                 float scale, int causal, int window,
                                 int is_bf16, void* stream) {
  if (KV <= 0 || H % KV != 0 || dh <= 0 || dh % (is_bf16 ? 8 : 4) != 0 ||
      dh > 4 * MAX_CHUNKS || H > 65535 || B > 65535 || Skv < 0)
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || H <= 0 || Sq <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (!is_bf16) {
    const Strides st = {sq0, sq1, sq2, sk0, sk1, sk2, sv0, sv1, sv2, so0, so1, so2};
    const int nc = (dh / 4 + TPR - 1) / TPR;
    if (nc <= 1) return launch_f32<1>(q, k, v, o, st, B, H, KV, Sq, Skv, dh, scale, causal, window, s);
    if (nc <= 2) return launch_f32<2>(q, k, v, o, st, B, H, KV, Sq, Skv, dh, scale, causal, window, s);
    if (nc <= 4) return launch_f32<4>(q, k, v, o, st, B, H, KV, Sq, Skv, dh, scale, causal, window, s);
    return launch_f32<8>(q, k, v, o, st, B, H, KV, Sq, Skv, dh, scale, causal, window, s);
  }
  const int G = H / KV;
  const long long rows = (long long)Sq * G;
  const long long n_mtiles = (rows + BM - 1) / BM;
  if (n_mtiles > 65535 || (long long)B * KV > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tmk, tmv;
  Bf16Params p;
  int rc = kv_map(&tmk, k, dh, Skv, KV, B, sk2, sk1, sk0, &p.kperm);
  if (rc == 0) rc = kv_map(&tmv, v, dh, Skv, KV, B, sv2, sv1, sv0, &p.vperm);
  if (rc != 0) return rc;
  p.q = (const bf16*)q;
  p.o = (bf16*)o;
  p.sq0 = sq0; p.sq1 = sq1; p.sq2 = sq2;
  p.so0 = so0; p.so1 = so1; p.so2 = so2;
  p.KV = KV; p.G = G; p.Skv = Skv; p.dh = dh;
  p.causal = causal; p.window = window;
  p.rows = (int)rows;
  p.n_mtiles = (int)n_mtiles;
  p.scale_log2 = (float)(1.4426950408889634 * (double)scale);
  if (dh <= 64) return launch_bf16<1>(tmk, tmv, p, B, s);
  return launch_bf16<2>(tmk, tmv, p, B, s);
}
