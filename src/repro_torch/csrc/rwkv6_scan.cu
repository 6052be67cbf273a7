// Chunked RWKV6 (Finch) WKV scan for Hopper, hand-written in CUDA C++.
//
// Replaces the Pallas TPU kernel repro/kernels/rwkv6_scan/kernel.py
// (`_rwkv_kernel`, launched by `rwkv6_scan`).  Per head, with a (K,V)
// float32 state S from zero:
//   S_t = diag(exp(dlog_t)) S_{t-1} + k_t^T v_t
//   y_t = r_t S_{t-1} + (r_t . (u * k_t)) v_t
// Returns y and the final state S_T (the TPU kernel drops it; prefill hands
// it to decode).  The algorithm below is, step for step,
// repro_torch/kernels/rwkv6_scan/ref.py `wkv_groups_ref`.
//
// Operands.  r, k, dlog logically (B,H,T,K), v and y (B,H,T,V), each read
// or written through its own element strides over (b, h, t) with the last
// dimension contiguous, so the model's (B,T,H,K) projections are read in
// place (a transposed view), without a copy; r, k, v and y float32 or
// bfloat16 alike, dlog float32, u (H,K) float32, state (B,H,K,V) float32.
// K and V at most 64 (padded to 64 with zeros in shared memory).  T need
// not be a multiple of anything: rows past T load as r=k=v=0, dlog=0,
// which leaves S unchanged, and are not stored.
//
// Chunks of 16 rows.  With p the exclusive cumulative sum of dlog from the
// chunk's start, q = p + dlog, p_end = q_15 (all <= 0 and falling):
//   y_i = (r_i e^{p_i}) S + sum_{s<=i} A_is v_s,
//   S'  = e^{p_end} S + sum_s (k_s e^{p_end - q_s})^T v_s,
//   A_is = sum_k r_ik k_sk e^{p_ik - q_sk} (s < i),  A_ii = r_i . (u k_i).
// The decay in A is factored in sub-blocks of 8 rows.  For i in rows 8-15
// and s in rows 0-7, with row 8 as the reference point,
//   A_is = (r_i e^{p_i - p_8}) . (k_s e^{p_8 - q_s}),
// and since q_s <= p_8 <= p_i for every dlog <= 0 both factors are at most
// 1: nothing overflows, whatever the decays (the model's clip dlog >= -e^2
// is not relied on), and an underflow is harmless, the true product being
// smaller still.  That block is one 8 x 8 x 64 matrix product.  The pairs
// s < i inside a sub-block keep one exponential each: 2 x 28 x 64 per
// chunk of 16, a quarter of the 31,744 a whole 32-row chunk takes per 32
// rows (every exponential's argument is <= 0, so e^{-p} never appears).
//
// Passes.  Blocks of 4 warps; warp w owns columns 16w..16w+15 of V, of y
// and of S, and keeps its columns of S in registers (bfloat16 path) or
// shared memory (float32 path) across the chunks it walks.  A prompt is cut
// into groups of `group` tokens (a multiple of 16), and a call is
//   - one prompt group (the card is full with B*H blocks, or T is short):
//     `rwkv6_wkv_out` alone, a block per (b, h) walking every chunk from
//     S = 0, writing y and the final state;
//   - more: `rwkv6_wkv_sums`, a block per (b, h, group) in parallel, walks
//     its group's chunks from S = 0 for the group's increment dS_g and its
//     decay P_g = sum dlog (workspace); `rwkv6_wkv_carry`, a thread per
//     (b, h, k, v), serial over the groups: S_{g+1} = e^{P_g} S_g + dS_g,
//     writing each group's starting state over dS_g and the final state;
//     `rwkv6_wkv_out`, a block per (b, h, group) in parallel, walks its
//     group's chunks from S_g, writing y.
// So at 1 x 4,096 (64 heads) the 8,192 chunks of 16 run on 2,048 blocks
// rather than in one chain per head.  Within a block each chunk's r, k, v
// and dlog are copied by cp.async into a 2-stage ring behind the previous
// chunk's arithmetic.
//
// Per chunk, two barriers.  Phase P: one thread per (column k, sub-block)
// takes the cumulative sums and every exponential of its column (r e^p,
// k e^{p_end-q}, the two factors above, the 28 in-block pairs and the
// bonus) and writes the operands to shared memory; the pair sums over k are
// reduced across the warp (recursive halving: lane l keeps the sum of pair
// l) and the two warps of a sub-block.  Then each warp, in bfloat16 on the
// tensor cores (mma.sync m16n8k16, float32 accumulators): the factored
// block of A, whose accumulators are already A's fragment for A v, the
// in-block entries from the pair sums; y_inter = (r e^p) S and y_intra =
// A v; and the state update (k e^{p_end-q})^T v, its operand read
// transposed by ldmatrix.trans.  Every float32 operand goes in as two
// bfloat16 halves, hi + lo, made once in phase P, and a product takes
// hi*hi + hi*lo + lo*hi (v, exact in bfloat16, needs no lo): y is held to
// 2e-2 of the token recurrence, but S, carried across up to 256 chunks, to
// 2e-4, and one bfloat16 rounding of an operand (2^-9) costs more than that
// where terms cancel.  S's B fragments come from its accumulators by
// movmatrix (a transpose in registers).  The float32 path runs the same
// passes with the products on the CUDA cores (tensor cores would round to
// TF32), with A assembled in shared memory behind a third barrier.
//
// What bounds it: bytes (every input read once, y and the state written
// once); the group passes add the workspace's states, 16 KB per (b, h,
// group) written twice and read twice, mostly in L2.
//
// Floating point: float32, nvcc's default FMA contraction; inputs widen
// exactly to float32, y rounds once.  The cumulative sums are taken in log2
// units (dlog * log2 e), so each exponential is one ex2.approx: relative
// error about 2^-22 plus |x| 2^-24 from the scaling, where every argument
// x <= 0 and the factor e^x is at most 1, so a term's error is at most
// ~1e-7 of its size; factors below 2^-126 flush to 0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

typedef __nv_bfloat16 bf16;

#define CH 16            // rows per chunk
#define SUB 8            // rows per sub-block
#define KP 64            // K and V, padded
#define THREADS 128      // 4 warps, warp w owning columns 16w..16w+15 of V
#define RS 72            // row stride (elements) of the stages and operands
#define AS 24            // row stride (floats) of A (float32 path)
#define SS 68            // row stride (floats) of S (float32 path)
#define NPAIR 28         // pairs s < i inside a sub-block
#define NRED 36          // per sub-block: 28 pair sums and 8 bonus terms
#define CARRY_THREADS 256
#define FULL 0xffffffffu

struct Strides {       // element strides over (b, h, t)
  long long b, h, t;
};

struct Params {
  const void *r, *k, *v;
  const float *dlog, *u;
  void* y;
  float* state;        // (B,H,K,V)
  float* ws;           // (B*H, n_groups, 64, 64): dS_g, then S_g
  float* pws;          // (B*H, n_groups, 64): P_g
  int H, T, K, V, group, n_groups, vec;
  Strides rs, ks, vs, ds, ys;
};

// A chunk's operand matrix of R rows x 64 columns in shared memory: in
// bfloat16 as hi and lo halves (x = hi + lo to about 2^-17), read by
// ldmatrix or 32-bit loads; in float32 as is.
template <typename T, int R>
struct Operand {
  bf16 hi[R * RS], lo[R * RS];
  __device__ __forceinline__ void put(int i, int c, float x) {
    const bf16 h = __float2bfloat16_rn(x);
    hi[i * RS + c] = h;
    lo[i * RS + c] = __float2bfloat16_rn(x - __bfloat162float(h));
  }
};
template <int R>
struct Operand<float, R> {
  float x[R * RS];
  __device__ __forceinline__ void put(int i, int c, float v) { x[i * RS + c] = v; }
};

template <typename T>
struct Smem {
  T r[2][CH * RS], k[2][CH * RS], v[2][CH * RS];   // the chunk ring
  float d[2][CH * KP];
  Operand<T, CH> rt;          // [i][k]: r e^p
  Operand<T, CH> ks;          // [s][k]: k e^{p_end - q}
  Operand<T, SUB> rh;         // rows 8-15: r e^{p - p_8}
  Operand<T, SUB> kh;         // rows 0-7: k e^{p_8 - q}
  float red[2][2][NRED];      // per sub-block, per warp: reduced pair sums
  float ep[KP];               // e^{p_end}
  // float32 path: A (the bonus on its diagonal) and S
  float a[std::is_same<T, float>::value ? CH * AS : 4];
  float s[std::is_same<T, float>::value ? KP * SS : 4];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
// 16 bytes global -> shared, bypassing L1; `bytes` 0 writes zeros and reads
// nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
// c += a (16x16, row-major) @ b (16x8, col-major)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// the 8x8 b16 matrix whose fragment (row lane/4, columns 2(lane%4)+{0,1})
// this lane holds, transposed, in the same fragment layout
__device__ __forceinline__ uint32_t transpose8(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}
__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return *reinterpret_cast<const uint32_t*>(&x);
}
// (x0, x1) as bfloat16 pairs hi and lo, x = hi + lo to about 2^-17
__device__ __forceinline__ void split(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}
__device__ __forceinline__ void split(float2 x, uint32_t& hi, uint32_t& lo) {
  split(x.x, x.y, hi, lo);
}
// c += (a_hi + a_lo)(b_hi + b_lo), dropping lo*lo
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma_bf16(c, ah, bh[0], bh[1]);
  mma_bf16(c, ah, bl[0], bl[1]);
  mma_bf16(c, al, bh[0], bh[1]);
}

// 2^x on the special function unit (ex2.approx, relative error about
// 2^-22; results below 2^-126 flush to 0, which the decays may: the true
// products are smaller still)
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// one step of reduce32: lanes with bit OFF keep the upper OFF values
template <int OFF>
__device__ __forceinline__ void halve(float (&v)[32], int lane) {
  const bool up = lane & OFF;
#pragma unroll
  for (int j = 0; j < OFF; ++j) {
    const float send = up ? v[j] : v[j + OFF];
    const float keep = up ? v[j + OFF] : v[j];
    v[j] = keep + __shfl_xor_sync(FULL, send, OFF);
  }
}
// vals[0..31] summed over the warp; lane l ends with the sum of vals[l] in
// vals[0] (recursive halving: 31 shuffles for 32 sums)
__device__ __forceinline__ void reduce32(float (&v)[32], int lane) {
  halve<16>(v, lane);
  halve<8>(v, lane);
  halve<4>(v, lane);
  halve<2>(v, lane);
  halve<1>(v, lane);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// Copy rows t0 .. t0+15 of r, k, v and dlog into stage `st`: zeros past T,
// K and V.  `vec`: 16-byte cp.async copies (rows, strides and bases 16-byte
// aligned); else element loads, done when the function returns.
template <typename T>
__device__ __forceinline__ void load_chunk(Smem<T>& sm, int st, const Params& P,
                                           const T* rp, const T* kp, const T* vp,
                                           const float* dp, int t0) {
  const int tid = threadIdx.x;
  if (P.vec) {
    constexpr int EPP = 16 / sizeof(T), PPR = KP / EPP;
    for (int e = tid; e < CH * PPR; e += THREADS) {
      const int i = e / PPR, c = e % PPR * EPP, t = t0 + i;
      const bool kin = t < P.T && c < P.K, vin = t < P.T && c < P.V;
      cp_async16(&sm.r[st][i * RS + c], kin ? rp + t * P.rs.t + c : rp, kin ? 16 : 0);
      cp_async16(&sm.k[st][i * RS + c], kin ? kp + t * P.ks.t + c : kp, kin ? 16 : 0);
      cp_async16(&sm.v[st][i * RS + c], vin ? vp + t * P.vs.t + c : vp, vin ? 16 : 0);
    }
    for (int e = tid; e < CH * KP / 4; e += THREADS) {
      const int i = e / (KP / 4), c = e % (KP / 4) * 4, t = t0 + i;
      const bool in = t < P.T && c < P.K;
      cp_async16(&sm.d[st][i * KP + c], in ? dp + t * P.ds.t + c : dp, in ? 16 : 0);
    }
  } else {
    for (int e = tid; e < CH * KP; e += THREADS) {
      const int i = e / KP, c = e % KP, t = t0 + i;
      const bool kin = t < P.T && c < P.K, vin = t < P.T && c < P.V;
      sm.r[st][i * RS + c] = kin ? rp[t * P.rs.t + c] : from_f32<T>(0.f);
      sm.k[st][i * RS + c] = kin ? kp[t * P.ks.t + c] : from_f32<T>(0.f);
      sm.v[st][i * RS + c] = vin ? vp[t * P.vs.t + c] : from_f32<T>(0.f);
      sm.d[st][i * KP + c] = kin ? dp[t * P.ds.t + c] : 0.f;
    }
  }
}

enum { SUMS = 0, OUT = 1 };

// One block's walk over the chunks of group blockIdx.x of head blockIdx.y
// (see the top of the file).  SUMS: from S = 0, the group's dS and P into
// the workspace.  OUT: from S_g (0 for the first group), y; with one group,
// the final state too.
template <typename T, int MODE>
__device__ __forceinline__ void wkv_walk(const Params& P) {
  constexpr bool BF = std::is_same<T, bf16>::value;
  constexpr float LOG2E = 1.4426950408889634f;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<T>& sm = *reinterpret_cast<Smem<T>*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int grp = blockIdx.x, bh = blockIdx.y, b = bh / P.H, h = bh % P.H;
  const int n_chunks = (P.T + CH - 1) / CH, per_group = P.group / CH;
  const int c0 = grp * per_group, c1 = min(c0 + per_group, n_chunks);
  const bool single = P.n_groups == 1;
  const T* rp = static_cast<const T*>(P.r) + b * P.rs.b + h * P.rs.h;
  const T* kp = static_cast<const T*>(P.k) + b * P.ks.b + h * P.ks.h;
  const T* vp = static_cast<const T*>(P.v) + b * P.vs.b + h * P.vs.h;
  const float* dp = P.dlog + b * P.ds.b + h * P.ds.h;
  T* yp = static_cast<T*>(P.y) + b * P.ys.b + h * P.ys.h;
  float* ws = P.ws + ((size_t)bh * P.n_groups + grp) * KP * KP;

  // phase P's column and sub-block
  const int kc = tid & (KP - 1), hb = tid >> 6;
  const float uk = MODE == OUT && kc < P.K ? P.u[h * P.K + kc] : 0.f;

  load_chunk(sm, 0, P, rp, kp, vp, dp, c0 * CH);
  cp_async_commit();
  if constexpr (!BF)
    for (int e = tid; e < CH * AS; e += THREADS) sm.a[e] = 0.f;

  // S: this warp's columns 16 warp .. 16 warp + 15; bf16 path: accumulator
  // fragments [m-tile of 16 rows k][n-tile of 8 columns v], float32 path:
  // sm.s[k][v]
  float sreg[4][2][4];
  const bool from_ws = MODE == OUT && !single && grp > 0;
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      float2 lo = make_float2(0.f, 0.f), hi = lo;
      if (BF && from_ws) {
        const float* src = ws + (16 * m + gq) * KP + 16 * warp + 8 * n + 2 * tq;
        lo = *reinterpret_cast<const float2*>(src);
        hi = *reinterpret_cast<const float2*>(src + 8 * KP);
      }
      sreg[m][n][0] = lo.x; sreg[m][n][1] = lo.y;
      sreg[m][n][2] = hi.x; sreg[m][n][3] = hi.y;
    }
  if constexpr (!BF)
    for (int e = tid; e < KP * KP; e += THREADS)
      sm.s[(e / KP) * SS + e % KP] = from_ws ? ws[e] : 0.f;
  float p_total = 0.f;        // SUMS: P_g of column kc (hb == 0), log2 units

  for (int c = c0; c < c1; ++c) {
    const int st = (c - c0) & 1, t0 = c * CH;
    cp_async_wait_all();      // chunk c has landed ...
    __syncthreads();          // ... for every thread, and chunk c-1 is done
    if (c + 1 < c1) load_chunk(sm, st ^ 1, P, rp, kp, vp, dp, t0 + CH);
    cp_async_commit();
    const bool update = MODE == SUMS || single || c + 1 < c1;
    const bool s_zero = grp == 0 && c == c0;

    // ---- phase P: a thread per (column kc, sub-block hb).  Sums in log2
    // units, so every exponential is one ex2, and each exponent is a sum
    // over the rows between its two ends, within a sub-block or to the
    // chunk's end, never a difference of two long cumulative sums ----
    {
      const float* dd = sm.d[st];
      float tot[2] = {0.f, 0.f};            // each sub-block's sum of dlog
#pragma unroll
      for (int i = 0; i < CH; ++i) tot[i / SUB] += dd[i * KP + kc] * LOG2E;
      // own rows: lp exclusive and lq inclusive sums from the sub-block's
      // first row
      float lp[SUB], lq[SUB], rr[SUB], kk[SUB];
      float p = 0.f;
#pragma unroll
      for (int j = 0; j < SUB; ++j) {
        const int i = SUB * hb + j;
        lp[j] = p;
        p += dd[i * KP + kc] * LOG2E;
        lq[j] = p;
        rr[j] = to_f32(sm.r[st][i * RS + kc]);
        kk[j] = to_f32(sm.k[st][i * RS + kc]);
      }
      const float before = hb ? tot[0] : 0.f;  // p at the sub-block's row 0
      const float after = hb ? 0.f : tot[1];   // dlog after the sub-block
      const float pe = tot[0] + tot[1];
      // k e^{p_end - q}: the rest of the sub-block, then the sub-blocks after
#pragma unroll
      for (int j = 0; j < SUB; ++j)
        sm.ks.put(SUB * hb + j, kc, kk[j] * exp2_fast((p - lq[j]) + after));
      if (hb == 0) {
        sm.ep[kc] = exp2_fast(pe);
        p_total += pe;
      }
      if (MODE == OUT) {
#pragma unroll
        for (int j = 0; j < SUB; ++j)
          sm.rt.put(SUB * hb + j, kc, rr[j] * exp2_fast(before + lp[j]));
        if (hb)                // r e^{p - p_8}: within sub-block 1
#pragma unroll
          for (int j = 0; j < SUB; ++j) sm.rh.put(j, kc, rr[j] * exp2_fast(lp[j]));
        else                   // k e^{p_8 - q}: the rest of sub-block 0
#pragma unroll
          for (int j = 0; j < SUB; ++j) sm.kh.put(j, kc, kk[j] * exp2_fast(p - lq[j]));
        // the in-block pairs (i, s < i) and the bonus terms of column kc
        float vals[32], bonus[4];
#pragma unroll
        for (int i = 1; i < SUB; ++i)
#pragma unroll
          for (int s = 0; s < i; ++s)
            vals[i * (i - 1) / 2 + s] = rr[i] * kk[s] * exp2_fast(lp[i] - lq[s]);
#pragma unroll
        for (int i = 0; i < 4; ++i) vals[NPAIR + i] = rr[i] * uk * kk[i];
#pragma unroll
        for (int i = 0; i < 4; ++i) bonus[i] = rr[4 + i] * uk * kk[4 + i];
        reduce32(vals, lane);
#pragma unroll
        for (int off = 16; off >= 1; off >>= 1)
#pragma unroll
          for (int i = 0; i < 4; ++i) bonus[i] += __shfl_xor_sync(FULL, bonus[i], off);
        float* red = sm.red[hb][warp & 1];
        red[lane] = vals[0];
        if (lane < 4)
          red[32 + lane] = lane == 0 ? bonus[0] : lane == 1 ? bonus[1]
                         : lane == 2 ? bonus[2] : bonus[3];
      }
    }
    __syncthreads();

    if constexpr (BF) {
      // v's B fragments for this warp's columns: n-tile n in vb[2n..2n+1]
      uint32_t vb[4];
      ldmatrix_x4_trans(vb, &sm.v[st][(lane & 15) * RS + 16 * warp + 8 * (lane >> 4)]);
      if (MODE == OUT) {
        // A's fragments, built by each warp: rows 0-7 x 0-7 and 8-15 x 8-15
        // from the pair sums (the bonus on the diagonal), rows 8-15 x 0-7
        // the factored block on the tensor cores, rows 0-7 x 8-15 zero
        float q[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int j = 0; j < KP / 16; ++j) {
          const int o = gq * RS + 16 * j + 2 * tq;
          const uint32_t ah[4] = {0u, ld32(sm.rh.hi + o), 0u, ld32(sm.rh.hi + o + 8)};
          const uint32_t al[4] = {0u, ld32(sm.rh.lo + o), 0u, ld32(sm.rh.lo + o + 8)};
          const uint32_t bhi[2] = {ld32(sm.kh.hi + o), ld32(sm.kh.hi + o + 8)};
          const uint32_t blo[2] = {ld32(sm.kh.lo + o), ld32(sm.kh.lo + o + 8)};
          mma3(q, ah, al, bhi, blo);
        }
        float in_block[2][2];          // [sub-block][column 2tq + e]
#pragma unroll
        for (int sb = 0; sb < 2; ++sb)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = gq, s = 2 * tq + e;
            const int x = s < i ? i * (i - 1) / 2 + s : NPAIR + i;
            in_block[sb][e] = s <= i ? sm.red[sb][0][x] + sm.red[sb][1][x] : 0.f;
          }
        uint32_t aah[4], aal[4];
        split(in_block[0][0], in_block[0][1], aah[0], aal[0]);
        split(q[2], q[3], aah[1], aal[1]);
        aah[2] = aal[2] = 0u;
        split(in_block[1][0], in_block[1][1], aah[3], aal[3]);

        // ---- y = (r e^p) S + A v for this warp's columns ----
        float yacc[2][4] = {};
        if (!s_zero) {
#pragma unroll
          for (int j = 0; j < KP / 16; ++j) {
            uint32_t ah[4], al[4];
            const int o = (lane & 15) * RS + 16 * j + 8 * (lane >> 4);
            ldmatrix_x4(ah, sm.rt.hi + o);
            ldmatrix_x4(al, sm.rt.lo + o);
#pragma unroll
            for (int n = 0; n < 2; ++n) {
              uint32_t h01, l01, h23, l23;
              split(sreg[j][n][0], sreg[j][n][1], h01, l01);
              split(sreg[j][n][2], sreg[j][n][3], h23, l23);
              const uint32_t bhi[2] = {transpose8(h01), transpose8(h23)};
              const uint32_t blo[2] = {transpose8(l01), transpose8(l23)};
              mma3(yacc[n], ah, al, bhi, blo);
            }
          }
        }
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          mma_bf16(yacc[n], aah, vb[2 * n], vb[2 * n + 1]);
          mma_bf16(yacc[n], aal, vb[2 * n], vb[2 * n + 1]);
        }
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = gq + 8 * (e >> 1), col = 16 * warp + 8 * n + 2 * tq + (e & 1);
            if (t0 + i < P.T && col < P.V)
              yp[(long long)(t0 + i) * P.ys.t + col] = from_f32<T>(yacc[n][e]);
          }
      }
      // ---- S = e^{p_end} S + (k e^{p_end - q})^T v ----
      if (update) {
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const float e0 = sm.ep[16 * m + gq], e1 = sm.ep[16 * m + gq + 8];
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            sreg[m][n][0] *= e0; sreg[m][n][1] *= e0;
            sreg[m][n][2] *= e1; sreg[m][n][3] *= e1;
          }
          // A = ks^T: rows k 16m.., columns s, by transposed loads of ks
          uint32_t ah[4], al[4];
          const int o = ((lane & 7) + 8 * (lane >> 4)) * RS + 16 * m + 8 * ((lane >> 3) & 1);
          ldmatrix_x4_trans(ah, sm.ks.hi + o);
          ldmatrix_x4_trans(al, sm.ks.lo + o);
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            mma_bf16(sreg[m][n], ah, vb[2 * n], vb[2 * n + 1]);
            mma_bf16(sreg[m][n], al, vb[2 * n], vb[2 * n + 1]);
          }
        }
      }
    } else {
      const float* vv = sm.v[st];
      if (MODE == OUT) {
        // ---- A's in-block entries and its factored block, CUDA cores ----
        if (tid < 2 * NRED) {
          const int sb = tid / NRED, x = tid % NRED;
          int i, s;
          if (x < NPAIR) {
            i = 1;
            while (i * (i + 1) / 2 <= x) ++i;
            s = x - i * (i - 1) / 2;
          } else {
            i = s = x - NPAIR;
          }
          sm.a[(SUB * sb + i) * AS + SUB * sb + s] = sm.red[sb][0][x] + sm.red[sb][1][x];
        }
        {
          const int x = tid >> 1, half = tid & 1, i = x >> 3, s = x & 7;
          float acc = 0.f;
#pragma unroll 8
          for (int kx = 32 * half; kx < 32 * half + 32; ++kx)
            acc += sm.rh.x[i * RS + kx] * sm.kh.x[s * RS + kx];
          acc += __shfl_xor_sync(FULL, acc, 1);
          if (!half) sm.a[(SUB + i) * AS + s] = acc;
        }
        __syncthreads();
        // ---- y = (r e^p) S + A v for this warp's columns ----
        const int i = lane >> 1, cb = 16 * warp + 8 * (lane & 1);
        float acc[8] = {};
        if (!s_zero)
#pragma unroll 4
          for (int kx = 0; kx < KP; ++kx) {
            const float rv = sm.rt.x[i * RS + kx];
            const float4 s0 = *reinterpret_cast<const float4*>(&sm.s[kx * SS + cb]);
            const float4 s1 = *reinterpret_cast<const float4*>(&sm.s[kx * SS + cb + 4]);
            acc[0] += rv * s0.x; acc[1] += rv * s0.y; acc[2] += rv * s0.z; acc[3] += rv * s0.w;
            acc[4] += rv * s1.x; acc[5] += rv * s1.y; acc[6] += rv * s1.z; acc[7] += rv * s1.w;
          }
#pragma unroll
        for (int s = 0; s < CH; ++s) {
          const float av = sm.a[i * AS + s];
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[e] += av * vv[s * RS + cb + e];
        }
        if (t0 + i < P.T)
#pragma unroll
          for (int e = 0; e < 8; ++e)
            if (cb + e < P.V) yp[(long long)(t0 + i) * P.ys.t + cb + e] = from_f32<T>(acc[e]);
        __syncwarp();          // this warp's reads of S are done
      }
      // ---- S = e^{p_end} S + (k e^{p_end - q})^T v ----
      if (update) {
#pragma unroll
        for (int rr2 = 0; rr2 < 2; ++rr2) {
          const int kx = lane + 32 * rr2;
          const float e = sm.ep[kx];
          float acc[16];
#pragma unroll
          for (int x = 0; x < 16; ++x) acc[x] = e * sm.s[kx * SS + 16 * warp + x];
#pragma unroll 4
          for (int s = 0; s < CH; ++s) {
            const float kv = sm.ks.x[s * RS + kx];
#pragma unroll
            for (int x = 0; x < 16; ++x) acc[x] += kv * vv[s * RS + 16 * warp + x];
          }
#pragma unroll
          for (int x = 0; x < 16; ++x) sm.s[kx * SS + 16 * warp + x] = acc[x];
        }
        __syncwarp();
      }
    }
  }

  // ---- the block's result: dS_g and P_g, or the final state ----
  if (MODE == SUMS && tid < KP) P.pws[((size_t)bh * P.n_groups + grp) * KP + tid] = p_total;
  if (MODE == SUMS || single) {
    if constexpr (BF) {
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kx = 16 * m + gq + 8 * (e >> 1), vx = 16 * warp + 8 * n + 2 * tq + (e & 1);
            if (MODE == SUMS)
              ws[kx * KP + vx] = sreg[m][n][e];
            else if (kx < P.K && vx < P.V)
              P.state[((size_t)bh * P.K + kx) * P.V + vx] = sreg[m][n][e];
          }
    } else {
      __syncthreads();
      for (int e = tid; e < KP * KP; e += THREADS) {
        const int kx = e / KP, vx = e % KP;
        if (MODE == SUMS)
          ws[e] = sm.s[kx * SS + vx];
        else if (kx < P.K && vx < P.V)
          P.state[((size_t)bh * P.K + kx) * P.V + vx] = sm.s[kx * SS + vx];
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 4) rwkv6_wkv_sums(const Params P) {
  wkv_walk<T, SUMS>(P);
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 4) rwkv6_wkv_out(const Params P) {
  wkv_walk<T, OUT>(P);
}

// S_{g+1} = e^{P_g} S_g + dS_g (P_g in log2 units), a thread per (b, h,
// k, v) serial over the groups: S_g over dS_g in the workspace, S_{n_groups} into `state`.  Grid
// (B*H, 64*64 / CARRY_THREADS).
__global__ void __launch_bounds__(CARRY_THREADS) rwkv6_wkv_carry(const Params P) {
  constexpr int U = 8;
  const int bh = blockIdx.x, e = blockIdx.y * CARRY_THREADS + threadIdx.x;
  const int kx = e / KP, vx = e % KP, n = P.n_groups;
  float* ws = P.ws + (size_t)bh * n * KP * KP + e;
  const float* pw = P.pws + (size_t)bh * n * KP + kx;
  float s = 0.f;
  for (int g0 = 0; g0 < n; g0 += U) {
    float d[U], pg[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int g = min(g0 + u, n - 1);
      d[u] = ws[(size_t)g * KP * KP];
      pg[u] = pw[(size_t)g * KP];
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (g0 + u < n) {
        ws[(size_t)(g0 + u) * KP * KP] = s;
        s = fmaf(exp2_fast(pg[u]), s, d[u]);
      }
  }
  if (kx < P.K && vx < P.V) P.state[((size_t)bh * P.K + kx) * P.V + vx] = s;
}

template <typename K_>
static int prepare(K_ kernel, bool& ready, int smem) {
  if (ready) return 0;       // the shared-memory limit, set once
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  ready = true;
  return 0;
}

template <typename T>
static int launch(const Params& p, int BH, cudaStream_t s) {
  static bool ready_sums = false, ready_out = false;
  const int smem = (int)sizeof(Smem<T>);
  int rc = prepare(rwkv6_wkv_sums<T>, ready_sums, smem);
  if (rc == 0) rc = prepare(rwkv6_wkv_out<T>, ready_out, smem);
  if (rc != 0) return rc;
  const dim3 grid(p.n_groups, BH);
  if (p.n_groups > 1) {
    rwkv6_wkv_sums<T><<<grid, THREADS, smem, s>>>(p);
    rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
    rwkv6_wkv_carry<<<dim3(BH, KP * KP / CARRY_THREADS), CARRY_THREADS, 0, s>>>(p);
    rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
  }
  rwkv6_wkv_out<T><<<grid, THREADS, smem, s>>>(p);
  return (int)cudaGetLastError();
}

// Plain C entry point, loaded with ctypes.  Pointers as described at the
// top; strides in elements, five triples (b, h, t) for r, k, v, dlog and y.
// `group` is the tokens per group (a multiple of 16): with ceil(T/group) >
// 1 groups the three passes run and `ws` holds B*H*ceil(T/group)*64*64
// floats and `pws` B*H*ceil(T/group)*64 floats of workspace; with one group
// only `rwkv6_wkv_out` runs and neither is read.  `vec` (1) says that r, k,
// v and dlog may be copied in 16-byte pieces: their base pointers and
// strides 16-byte aligned, K and V times the element size multiples of 16.
// `bf16` selects bfloat16 (1) or float32 (0) for r, k, v and y alike.
// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a shape the kernel does not take; it never
// synchronises.
extern "C" int rwkv6_scan_launch(
    const void* r, const void* k, const void* v, const float* dlog,
    const float* u, void* y, float* state, float* ws, float* pws, int B, int H,
    int T, int K, int V, int group, long long rb, long long rh, long long rt,
    long long kb, long long kh, long long kt, long long vb, long long vh,
    long long vt, long long db, long long dh, long long dt, long long yb,
    long long yh, long long yt, int vec, int bf16_in, void* stream) {
  if (B < 0 || H < 0 || T < 0 || K <= 0 || V <= 0 || K > KP || V > KP ||
      group < CH || group % CH != 0 || (long long)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0 || T == 0) return 0;
  Params p;
  p.r = r; p.k = k; p.v = v; p.dlog = dlog; p.u = u; p.y = y; p.state = state;
  p.ws = ws; p.pws = pws;
  p.H = H; p.T = T; p.K = K; p.V = V; p.group = group;
  p.n_groups = (T + group - 1) / group;
  p.vec = vec;
  p.rs = {rb, rh, rt}; p.ks = {kb, kh, kt}; p.vs = {vb, vh, vt};
  p.ds = {db, dh, dt}; p.ys = {yb, yh, yt};
  if (p.n_groups > 65535 || (p.n_groups > 1 && (ws == nullptr || pws == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16_in) return launch<bf16>(p, B * H, s);
  return launch<float>(p, B * H, s);
}
