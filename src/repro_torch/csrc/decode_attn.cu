// Decode attention for Hopper, hand-written in CUDA C++: one query token
// per sequence against a KV cache, GQA, under one of two masks.
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attn/kernel.py
// (`_decode_kernel`, launched by `decode_attention`).  Semantics are those
// of repro_torch/kernels/decode_attn/ref.py, its plain versions:
//   q (B,H,dh); k, v logically (B,KV,S,dh), read through element strides
//   over (b, kv head, s) with dh contiguous, so the serving cache
//   (B,S,KV,dh) is read in place, without a transposed copy;
//   query head h reads KV head h / (H/KV);
//   the mask is either
//     lengths (B,) int32: key j counts when j < min(lengths[b], S), and keys
//       past the length are never read (the TPU kernel's contract), or
//     kv_pos (B,S) int32 with pos (B,) or a scalar: slot j counts when
//       0 <= kv_pos[b,j] <= pos[b] (a ring cache; every slot is read);
//   s = (q . k) / sqrt(dh), float32 softmax; a row with no valid key gives 0
//   through the max(l, 1e-30) denominator; output in q's dtype;
//   optionally the row's log-sum-exp ln(sum_j exp(s_j)) over its valid
//   keys, float32 (B,H), -inf for a row with no valid key: what a merge of
//   partial softmaxes over caches split across ranks reads.
//
// What bounds it: bytes.  A decode reads each K and V row once and does 4
// flops per (query head, key, dh) on it, G = H/KV heads per row: at most 12
// flops per byte here, far below the ~295 at which the tensor cores would
// be the limit.  So the kernel must (1) read every K/V row from device
// memory once, (2) keep enough bytes in flight to fill the card even when B
// x KV is 4 or 16, and (3) cost little beyond one launch at the serving
// cache (S = 192), where the whole call is a few microseconds.
//
// Design.  The TPU kernel walks a sequential grid axis over KV blocks for
// all heads of a sequence, with (m, l, acc) in VMEM.  Here:
//  - one block owns one (b, KV head, split of the keys) and all G query
//    heads of that KV head, packed as the rows of one 16-row tile (G > 16
//    takes ceil(G/16) tiles, one block each), so each K/V row is read once;
//  - the keys are split across blocks.  The number of splits comes from S,
//    the block count B x KV x ceil(G/16) and the SM count (ref.split_plan),
//    never from the lengths, so a captured CUDA graph stays valid as
//    lengths change.  With one split the block writes the output; with
//    more, each writes its float32 (m, l, acc) to scratch and a second
//    small kernel merges the splits in split order (deterministic: a replay
//    equals an eager call).  A split wholly past a length writes m = -inf
//    and reads nothing;
//  - K/V tiles of 64 keys (32 in float32) are staged through shared memory
//    by a 3-stage cp.async pipeline; columns past dh (dh 120 in a 128-wide
//    tile) are zero-filled there, not read;
//  - bfloat16 (the serving path) runs both products on the tensor cores:
//    mma.sync m16n8k16, bf16 in, float32 accumulators.  Key group w takes
//    keys 16w..16w+15 of every tile: S = Q K^T from Q (ldmatrix) and K
//    (ldmatrix: the cache's dh-contiguous rows are the col-major B operand),
//    its own online softmax on the fragments (log2 domain), P rounded to
//    bf16 straight from the S fragments into the A operand of O += P V (V
//    by ldmatrix.trans); l sums the float32 p.  A key group is dh/64 warps
//    (one at dh <= 64) that compute the same scores and each keep 64 of
//    O's columns, so a warp holds 32 accumulators and a block has up to 16
//    warps to hide the latency of a decode's short chains.  The four key
//    groups' states are merged in order through shared memory at the end;
//  - float32 stays on the CUDA cores (the tensor cores would round the
//    inputs to TF32): warp w owns the query rows w, w+4, w+8, w+12, a lane 1
//    to 8 adjacent values of dh, a score is a warp sum over lanes, and the
//    online softmax steps over groups of 8 keys.
//
// Floating point: float32 sums and softmax, exp2f of log2-scaled scores;
// the merges run in a fixed order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

#define THREADS 128
#define WARPS 4
#define ROWS 16          // query rows of a block: G heads of a KV head, padded
#define SPLIT_KEYS 64    // a split's keys are a multiple of this (ref.SPLIT_KEYS)
#define STAGES 3
#define MERGE_THREADS 128
#define MAX_SPLITS 1024
#define FULL 0xffffffffu

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const int* lengths;  // lengths mode, else null
  const int* kv_pos;   // kv_pos mode, else null
  const int* pos;
  float2* part_ml;     // (B, H, splits) when splits > 1
  float* part_acc;     // (B, H, splits, dh)
  float* lse;          // (B, H) log-sum-exp, or null
  int H, KV, S, dh, G, gtiles, splits, split_keys, pos_stride;
  long long kb, kh, ks, vb, vh, vs, pb;
  float scale_log2;
};

// What one block owns: keys [j0, j_end) of sequence b, query rows g0 ..
// g0+rows-1 of KV head kvh; keys at or past `limit` are not read.
struct Block {
  int b, kvh, g0, rows, split, j0, limit, pos;
  const int* kvp;

  __device__ __forceinline__ bool valid(int j) const {
    if (j >= limit) return false;
    if (kvp == nullptr) return true;
    const int p = kvp[j];
    return p >= 0 && p <= pos;
  }
};

__device__ __forceinline__ Block block_setup(const Params& P) {
  Block B;
  B.split = blockIdx.x;
  B.kvh = blockIdx.y / P.gtiles;
  B.g0 = blockIdx.y % P.gtiles * ROWS;
  B.rows = min(ROWS, P.G - B.g0);
  B.b = blockIdx.z;
  B.j0 = B.split * P.split_keys;
  const int j_end = min(P.S, B.j0 + P.split_keys);
  if (P.lengths != nullptr) {
    B.limit = min(j_end, max(0, min(P.lengths[B.b], P.S)));
    B.kvp = nullptr;
    B.pos = 0;
  } else {
    B.limit = j_end;
    B.kvp = P.kv_pos + B.b * P.pb;
    B.pos = P.pos[(size_t)B.b * P.pos_stride];
  }
  return B;
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }

// The natural log-sum-exp of a row from its (m in log2 units, l) state:
// -inf where no key counted (l = 0).
__device__ __forceinline__ float row_lse(float m, float l) {
  return l > 0.f ? m * 0.69314718055994531f + logf(l) : -INFINITY;
}
__device__ __forceinline__ void store(bf16* p, float x) { *p = __float2bfloat16_rn(x); }

// Row r (< rows) of the block at column c (< dh): the split's state (m in
// log2 units, l, unnormalised acc), as the output when there is one split.
template <typename T>
__device__ __forceinline__ void write_state(const Params& P, const Block& B,
                                            int r, int c, float m, float l,
                                            float acc) {
  const size_t row = (size_t)B.b * P.H + B.kvh * P.G + B.g0 + r;
  if (P.splits == 1) {
    store(static_cast<T*>(P.o) + row * P.dh + c, acc / fmaxf(l, 1e-30f));
    if (c == 0 && P.lse != nullptr) P.lse[row] = row_lse(m, l);
    return;
  }
  const size_t at = row * P.splits + B.split;
  P.part_acc[at * P.dh + c] = acc;
  if (c == 0) P.part_ml[at] = make_float2(m, l);
}

// write_state of columns c .. c+3 (c a multiple of 4, below dh), in one
// store each.
__device__ __forceinline__ void write_state4(const Params& P, const Block& B, int r,
                                             int c, float m, float l,
                                             const float (&acc)[4]) {
  const size_t row = (size_t)B.b * P.H + B.kvh * P.G + B.g0 + r;
  if (P.splits == 1) {
    const float d = fmaxf(l, 1e-30f);
    const __nv_bfloat162 lo = __floats2bfloat162_rn(acc[0] / d, acc[1] / d);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(acc[2] / d, acc[3] / d);
    uint2 raw;
    raw.x = *reinterpret_cast<const uint32_t*>(&lo);
    raw.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(static_cast<bf16*>(P.o) + row * P.dh + c) = raw;
    if (c == 0 && P.lse != nullptr) P.lse[row] = row_lse(m, l);
    return;
  }
  const size_t at = row * P.splits + B.split;
  *reinterpret_cast<float4*>(P.part_acc + at * P.dh + c) =
      make_float4(acc[0], acc[1], acc[2], acc[3]);
  if (c == 0) P.part_ml[at] = make_float2(m, l);
}

// A block with no key to read: zeros, or m = -inf for the merge.
template <typename T>
__device__ void empty_block(const Params& P, const Block& B) {
  for (int i = threadIdx.x; i < B.rows * P.dh; i += blockDim.x) {
    const int r = i / P.dh, c = i % P.dh;
    if (P.splits == 1)
      write_state<T>(P, B, r, c, -INFINITY, 0.f, 0.f);
    else if (c == 0)
      P.part_ml[((size_t)B.b * P.H + B.kvh * P.G + B.g0 + r) * P.splits + B.split] =
          make_float2(-INFINITY, 0.f);
  }
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
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy the K and V rows of keys t0 .. t0+BKT-1 into a stage (K tile, then V
// tile, rows of RS elements); zeros past `limit` and past dh.  NT threads:
// each copies one 16-byte column piece of every NT/PPR-th row, so its
// addresses step by a constant.
template <typename T, int DHT, int BKT, int RS, int NT>
__device__ __forceinline__ void load_tile(T* stage, const Params& P, const Block& B,
                                          const T* kbase, const T* vbase, int t0) {
  constexpr int EPP = 16 / sizeof(T);  // elements per 16-byte piece
  constexpr int PPR = DHT / EPP;       // pieces per row
  constexpr int RPP = NT / PPR;        // rows per pass
  static_assert(NT % PPR == 0 && BKT % RPP == 0, "threads must tile the rows");
  const int d = threadIdx.x % PPR * EPP, r0 = threadIdx.x / PPR;
  const bool col = d < P.dh;
#pragma unroll
  for (int i = 0; i < BKT / RPP; ++i) {
    const int r = r0 + i * RPP, j = t0 + r;
    const bool in = col && j < B.limit;
    cp_async16(stage + r * RS + d, in ? kbase + j * P.ks + d : kbase, in ? 16 : 0);
    cp_async16(stage + (BKT + r) * RS + d, in ? vbase + j * P.vs + d : vbase,
               in ? 16 : 0);
  }
}

// The tile loop both kernels share: stage tiles STAGES-1 ahead and call
// `compute(stage, t0)` on each once it has landed.  Copies issued before
// it (the bf16 kernel's Q rows) land with the first tile.
template <typename T, int DHT, int BKT, int RS, int NT, typename F>
__device__ __forceinline__ void tile_loop(T* stages, const Params& P, const Block& B,
                                          F compute) {
  constexpr int STAGE = 2 * BKT * RS;
  const T* kbase = static_cast<const T*>(P.k) + B.b * P.kb + B.kvh * P.kh;
  const T* vbase = static_cast<const T*>(P.v) + B.b * P.vb + B.kvh * P.vh;
  const int ntiles = (B.limit - B.j0 + BKT - 1) / BKT;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ntiles)
      load_tile<T, DHT, BKT, RS, NT>(stages + s * STAGE, P, B, kbase, vbase,
                                     B.j0 + s * BKT);
    cp_async_commit();
  }
  for (int t = 0; t < ntiles; ++t) {
    // tile t has landed, and every warp is done with the stage of tile t-1
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int next = t + STAGES - 1;
    if (next < ntiles)
      load_tile<T, DHT, BKT, RS, NT>(stages + next % STAGES * STAGE, P, B, kbase,
                                     vbase, B.j0 + next * BKT);
    cp_async_commit();
    compute(stages + t % STAGES * STAGE, B.j0 + t * BKT);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores
// ---------------------------------------------------------------------------

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
// c += a (16x16, row-major) @ b (16x8, col-major)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

template <int DHT>
struct MmaShape {
  static constexpr int BKT = 64;                 // keys per tile: 16 per warp
  static constexpr int RS = DHT + 8;             // padded rows: ldmatrix's 8
                                                 // rows hit distinct banks
  // NCH warps share each 16 keys, each with 64 of O's columns: they
  // compute the same scores and softmax, so their states agree, and the
  // block has 4 NCH warps to hide latency with
  static constexpr int NCH = DHT > 64 ? DHT / 64 : 1;
  static constexpr int COLS = DHT / NCH;         // O columns per warp
  static constexpr int THREADS_ = THREADS * NCH;
  static constexpr int Q_ELEMS = ROWS * RS;
  static constexpr int SMEM = (Q_ELEMS + STAGES * 2 * BKT * RS) * 2;
  // the epilogue's O rows, padded so that a quad's rows fall in other banks
  static constexpr int OS = DHT + 8;
  static constexpr int FS = WARPS + 2;           // per row: factors, max, sum
  static_assert((WARPS * ROWS * (2 + OS) + ROWS * FS) * 4 <= STAGES * 2 * BKT * RS * 2,
                "the warps' states must fit the stages");
};

template <int DHT>
__global__ void __launch_bounds__(MmaShape<DHT>::THREADS_)
decode_attn_mma(const Params P) {
  using Shape = MmaShape<DHT>;
  constexpr int RS = Shape::RS, COLS = Shape::COLS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* stages = qs + Shape::Q_ELEMS;

  const Block B = block_setup(P);
  if (B.limit <= B.j0) {
    empty_block<bf16>(P, B);
    return;
  }
  // warp (a key group): keys 16 warp .. 16 warp + 15 of each tile; ch: the
  // warp's part of O's columns
  const int warp = threadIdx.x / 32 % WARPS, ch = threadIdx.x / 32 / WARPS;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;

  // the block's query rows, zeros past its rows and past dh (committed with
  // the first tile)
  const bf16* qg = static_cast<const bf16*>(P.q) +
                   ((size_t)B.b * P.H + B.kvh * P.G + B.g0) * P.dh;
  for (int p = threadIdx.x; p < ROWS * (DHT / 8); p += blockDim.x) {
    const int r = p / (DHT / 8), d = p % (DHT / 8) * 8;
    const bool in = r < B.rows && d < P.dh;
    cp_async16(qs + r * RS + d, in ? qg + (size_t)r * P.dh + d : qg, in ? 16 : 0);
  }

  // O (rows g, g+8; columns ch COLS + 8n + 2 t4 + {0,1}); m, l of rows g
  // and g+8
  float o[COLS / 8][4];
#pragma unroll
  for (int n = 0; n < COLS / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  // ldmatrix addresses: Q rows (lane & 15) at dh + 8 (lane >> 4); K rows
  // (keys) 8 ((lane >> 4) & 1) + (lane & 7) at dh + 8 ((lane >> 3) & 1); V
  // rows (keys) (lane & 15) at dh + 8 (lane >> 4), transposed
  const int q_off = (lane & 15) * RS + (lane >> 4) * 8;
  const int k_off = (warp * 16 + ((lane >> 4) & 1) * 8 + (lane & 7)) * RS +
                    ((lane >> 3) & 1) * 8;
  const int v_off = (warp * 16 + (lane & 15)) * RS + ch * COLS + (lane >> 4) * 8;

  tile_loop<bf16, DHT, Shape::BKT, RS, Shape::THREADS_>(
      stages, P, B, [&](const bf16* ks, int t0) {
    const bf16* vs = ks + Shape::BKT * RS;
    float s[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < DHT; kk += 16) {
      uint32_t a[4], b[4];
      ldmatrix_x4(a, qs + q_off + kk);
      ldmatrix_x4(b, ks + k_off + kk);
      mma_bf16(s[0], a, b[0], b[1]);
      mma_bf16(s[1], a, b[2], b[3]);
    }
    // element (n, e): row g + 8 (e >> 1), key t0 + 16 warp + 8 n + 2 t4 + (e & 1)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = t0 + warp * 16 + n * 8 + 2 * t4 + (e & 1);
        s[n][e] = B.valid(j) ? s[n][e] * P.scale_log2 : -INFINITY;
      }
    float p[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = fmaxf(fmaxf(s[0][2 * h], s[0][2 * h + 1]),
                       fmaxf(s[1][2 * h], s[1][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      const float base = m_new == -INFINITY ? 0.f : m_new;
      const float corr = exp2f(m[h] - base);  // m = -inf: 0
      m[h] = m_new;
      l[h] *= corr;
#pragma unroll
      for (int n = 0; n < COLS / 8; ++n) {
        o[n][2 * h] *= corr;
        o[n][2 * h + 1] *= corr;
      }
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          p[n][2 * h + e] = exp2f(s[n][2 * h + e] - base);  // masked: 0
          l[h] += p[n][2 * h + e];
        }
    }
    // the S fragments of the two key octets are the A fragment of P V
    uint32_t pa[4] = {pack_bf16(p[0][0], p[0][1]), pack_bf16(p[0][2], p[0][3]),
                      pack_bf16(p[1][0], p[1][1]), pack_bf16(p[1][2], p[1][3])};
#pragma unroll
    for (int d = 0; d < COLS; d += 16) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, vs + v_off + d);
      mma_bf16(o[d / 8], pa, b[0], b[1]);
      mma_bf16(o[d / 8 + 1], pa, b[2], b[3]);
    }
  });

  // the four key groups' states, merged in order through shared memory
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(FULL, l[h], 1);
    l[h] += __shfl_xor_sync(FULL, l[h], 2);
  }
  constexpr int OS = Shape::OS, FS = Shape::FS;
  float* wm = reinterpret_cast<float*>(stages);
  float* wl = wm + WARPS * ROWS;
  float* wf = wl + WARPS * ROWS;
  float* wo = wf + ROWS * FS;
  if (t4 == 0 && ch == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      wm[warp * ROWS + g + 8 * h] = m[h];
      wl[warp * ROWS + g + 8 * h] = l[h];
    }
  }
#pragma unroll
  for (int n = 0; n < COLS / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      wo[(warp * ROWS + g + 8 * (e >> 1)) * OS + ch * COLS + n * 8 + 2 * t4 +
         (e & 1)] = o[n][e];
  __syncthreads();
  // per row: each key group's factor exp2(m_w - max), the max, the sum
  if (threadIdx.x < ROWS) {
    const int r = threadIdx.x;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, wm[w * ROWS + r]);
    float lsum = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float mw = wm[w * ROWS + r];
      const float f = mx == -INFINITY || mw == -INFINITY ? 0.f : exp2f(mw - mx);
      wf[r * FS + w] = f;
      lsum += wl[w * ROWS + r] * f;
    }
    wf[r * FS + WARPS] = mx;
    wf[r * FS + WARPS + 1] = lsum;
  }
  __syncthreads();
  // then 4 adjacent columns a thread
  for (int i = threadIdx.x; i < ROWS * (DHT / 4); i += Shape::THREADS_) {
    const int r = i / (DHT / 4), c = i % (DHT / 4) * 4;
    if (r >= B.rows || c >= P.dh) continue;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float f = wf[r * FS + w];
      const float4 x = *reinterpret_cast<const float4*>(wo + (w * ROWS + r) * OS + c);
      acc[0] += x.x * f; acc[1] += x.y * f; acc[2] += x.z * f; acc[3] += x.w * f;
    }
    write_state4(P, B, r, c, wf[r * FS + WARPS], wf[r * FS + WARPS + 1], acc);
  }
}

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

// A lane's VPL adjacent values of a row in shared memory, in 16-byte loads
// where they fill them.
template <int VPL>
__device__ __forceinline__ void load_row(float (&x)[VPL], const float* p) {
  if constexpr (VPL % 4 == 0) {
#pragma unroll
    for (int u = 0; u < VPL; u += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + u);
      x[u] = t.x; x[u + 1] = t.y; x[u + 2] = t.z; x[u + 3] = t.w;
    }
  } else if constexpr (VPL == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    x[0] = t.x; x[1] = t.y;
  } else {
    x[0] = p[0];
  }
}

template <int DHT>
struct SimtShape {
  static constexpr int BKT = 32;                 // keys per tile
  static constexpr int VPL = DHT / 32;           // dh values per lane
  static constexpr int HPW = ROWS / WARPS;       // query rows per warp
  static constexpr int SMEM = STAGES * 2 * BKT * DHT * 4;
};

template <int DHT>
__global__ void __launch_bounds__(THREADS)
decode_attn_simt(const Params P) {
  using Shape = SimtShape<DHT>;
  constexpr int VPL = Shape::VPL, HPW = Shape::HPW, KPS = 8;  // keys per step
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* stages = reinterpret_cast<float*>(smem_raw);

  const Block B = block_setup(P);
  if (B.limit <= B.j0) {
    empty_block<float>(P, B);
    return;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // rows warp + 4 i; columns lane VPL + u (zeros past dh: the tiles' columns
  // there are zeros too)
  float q[HPW][VPL], acc[HPW][VPL], m[HPW], l[HPW];
  const float* qg = static_cast<const float*>(P.q) +
                    ((size_t)B.b * P.H + B.kvh * P.G + B.g0) * P.dh;
#pragma unroll
  for (int i = 0; i < HPW; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
    const int r = warp + WARPS * i;
#pragma unroll
    for (int u = 0; u < VPL; ++u) {
      const int c = lane * VPL + u;
      q[i][u] = r < B.rows && c < P.dh ? qg[(size_t)r * P.dh + c] : 0.f;
      acc[i][u] = 0.f;
    }
  }

  tile_loop<float, DHT, Shape::BKT, DHT, THREADS>(stages, P, B, [&](const float* ks,
                                                                      int t0) {
    const float* vs = ks + Shape::BKT * DHT;
    for (int j8 = 0; j8 < Shape::BKT; j8 += KPS) {
      float s[HPW][KPS], vx[KPS][VPL];
#pragma unroll
      for (int t = 0; t < KPS; ++t) {
        float kx[VPL];
        load_row<VPL>(kx, ks + (j8 + t) * DHT + lane * VPL);
        load_row<VPL>(vx[t], vs + (j8 + t) * DHT + lane * VPL);
#pragma unroll
        for (int i = 0; i < HPW; ++i) {
          float d = 0.f;
#pragma unroll
          for (int u = 0; u < VPL; ++u) d += q[i][u] * kx[u];
          s[i][t] = d;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int i = 0; i < HPW; ++i)
#pragma unroll
          for (int t = 0; t < KPS; ++t) s[i][t] += __shfl_xor_sync(FULL, s[i][t], off);
      bool ok[KPS];
#pragma unroll
      for (int t = 0; t < KPS; ++t) ok[t] = B.valid(t0 + j8 + t);
#pragma unroll
      for (int i = 0; i < HPW; ++i) {
        if (warp + WARPS * i >= B.rows) continue;  // warp-uniform
        float mx = -INFINITY;
#pragma unroll
        for (int t = 0; t < KPS; ++t) {
          s[i][t] = ok[t] ? s[i][t] * P.scale_log2 : -INFINITY;
          mx = fmaxf(mx, s[i][t]);
        }
        const float m_new = fmaxf(m[i], mx);
        const float base = m_new == -INFINITY ? 0.f : m_new;
        const float corr = exp2f(m[i] - base);
        m[i] = m_new;
        l[i] *= corr;
#pragma unroll
        for (int u = 0; u < VPL; ++u) acc[i][u] *= corr;
#pragma unroll
        for (int t = 0; t < KPS; ++t) {
          const float p = exp2f(s[i][t] - base);
          l[i] += p;
#pragma unroll
          for (int u = 0; u < VPL; ++u) acc[i][u] += p * vx[t][u];
        }
      }
    }
  });

#pragma unroll
  for (int i = 0; i < HPW; ++i) {
    const int r = warp + WARPS * i;
    if (r >= B.rows) continue;
#pragma unroll
    for (int u = 0; u < VPL; ++u) {
      const int c = lane * VPL + u;
      if (c < P.dh) write_state<float>(P, B, r, c, m[i], l[i], acc[i][u]);
    }
  }
}

// ---------------------------------------------------------------------------
// Merge of the splits, in split order
// ---------------------------------------------------------------------------

// A block per (b, query head): each split's factor exp2(m_s - max) into
// shared memory (0 where m_s = -inf: that split wrote no acc), then the
// sums in split order, a thread per column, the loads of several splits in
// flight at once.
template <typename T>
__global__ void __launch_bounds__(MERGE_THREADS)
decode_attn_merge(const Params P) {
  __shared__ float sm_m[MAX_SPLITS], sm_l[MAX_SPLITS], sm_f[MAX_SPLITS];
  const size_t row = (size_t)blockIdx.y * P.H + blockIdx.x;  // (b, h)
  const float2* ml = P.part_ml + row * P.splits;
  for (int s = threadIdx.x; s < P.splits; s += MERGE_THREADS) {
    const float2 x = ml[s];
    sm_m[s] = x.x;
    sm_l[s] = x.y;
  }
  __syncthreads();
  float mx = -INFINITY;
  for (int s = 0; s < P.splits; ++s) mx = fmaxf(mx, sm_m[s]);
  for (int s = threadIdx.x; s < P.splits; s += MERGE_THREADS)
    sm_f[s] = mx == -INFINITY || sm_m[s] == -INFINITY ? 0.f : exp2f(sm_m[s] - mx);
  __syncthreads();
  float lsum = 0.f;
  for (int s = 0; s < P.splits; ++s) lsum += sm_f[s] == 0.f ? 0.f : sm_l[s] * sm_f[s];
  const float d = fmaxf(lsum, 1e-30f);
  for (int c = threadIdx.x; c < P.dh; c += MERGE_THREADS) {
    const float* acc_c = P.part_acc + row * P.splits * P.dh + c;
    float acc = 0.f;
#pragma unroll 4
    for (int s = 0; s < P.splits; ++s) {
      const float x = acc_c[(size_t)s * P.dh];
      acc += sm_f[s] == 0.f ? 0.f : x * sm_f[s];
    }
    store(static_cast<T*>(P.o) + row * P.dh + c, acc / d);
  }
  if (threadIdx.x == 0 && P.lse != nullptr) P.lse[row] = row_lse(mx, lsum);
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

template <typename K_>
static int launch_main(K_ kernel, int threads, int smem, bool& ready,
                       const Params& p, int B, cudaStream_t stream) {
  if (!ready) {  // the shared-memory limit, set once
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  const dim3 grid(p.splits, p.KV * p.gtiles, B);
  kernel<<<grid, threads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int DHT>
static int launch_dht(const Params& p, int B, int bf16_in, cudaStream_t s) {
  static bool ready_mma = false, ready_simt = false;
  if (bf16_in)
    return launch_main(decode_attn_mma<DHT>, MmaShape<DHT>::THREADS_,
                       MmaShape<DHT>::SMEM, ready_mma, p, B, s);
  return launch_main(decode_attn_simt<DHT>, THREADS, SimtShape<DHT>::SMEM, ready_simt,
                     p, B, s);
}

// Plain C entry point, loaded with ctypes.  q and o (B,H,dh) contiguous; k
// and v addressed as base + b*kb + kv*kh + s*ks (+ d), likewise v, strides in
// elements, multiples of 16 bytes, bases 16-byte aligned; dh a multiple of
// 8, at most 256.  One mask: `lengths` (B,), or `kv_pos` (B rows of stride
// `pb`) with `pos` (element b at b*pos_stride; stride 0 for a scalar).  The
// keys are cut into `splits` ranges of `split_keys` (a multiple of 64; the
// last may be shorter, none empty); with splits > 1, `part_ml` (B,H,splits)
// float2 and `part_acc` (B,H,splits,dh) float32 are the merge's scratch.
// `lse`, when not null, takes each row's log-sum-exp, float32 (B,H).
// `bf16` selects bfloat16 (1) or float32 (0) for q, k, v and o alike.
// Launches on `stream` (the merge too, when splits > 1) and returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a shape
// the kernel does not take; it never synchronises.
extern "C" int decode_attn_launch(const void* q, const void* k, const void* v,
                                  void* o, const int* lengths, const int* kv_pos,
                                  const int* pos, void* part_ml, void* part_acc,
                                  float* lse, int B, int H, int KV, int S, int dh, int splits,
                                  int split_keys, long long kb, long long kh,
                                  long long ks, long long vb, long long vh,
                                  long long vs, long long pb, int pos_stride,
                                  float scale, int bf16_in, void* stream) {
  if (KV <= 0 || H % KV != 0 || dh < 8 || dh % 8 != 0 || dh > 256 || B < 0 ||
      B > 65535 || S < 0 || splits < 1 || splits > MAX_SPLITS || split_keys <= 0 ||
      split_keys % SPLIT_KEYS != 0 || (long long)(splits - 1) * split_keys >= (S > 0 ? S : 1) ||
      (lengths == nullptr) == (kv_pos == nullptr) || (kv_pos != nullptr && pos == nullptr) ||
      (splits > 1 && (part_ml == nullptr || part_acc == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0) return 0;
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.lengths = lengths; p.kv_pos = kv_pos; p.pos = pos;
  p.part_ml = (float2*)part_ml; p.part_acc = (float*)part_acc; p.lse = lse;
  p.H = H; p.KV = KV; p.S = S; p.dh = dh; p.G = H / KV;
  p.gtiles = (p.G + ROWS - 1) / ROWS;
  p.splits = splits; p.split_keys = split_keys; p.pos_stride = pos_stride;
  p.kb = kb; p.kh = kh; p.ks = ks; p.vb = vb; p.vh = vh; p.vs = vs; p.pb = pb;
  p.scale_log2 = (float)(1.4426950408889634 * (double)scale);
  if ((long long)KV * p.gtiles > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int rc;
  if (dh <= 32) rc = launch_dht<32>(p, B, bf16_in, s);
  else if (dh <= 64) rc = launch_dht<64>(p, B, bf16_in, s);
  else if (dh <= 128) rc = launch_dht<128>(p, B, bf16_in, s);
  else rc = launch_dht<256>(p, B, bf16_in, s);
  if (rc != 0 || splits == 1) return rc;
  const dim3 grid(H, B);
  if (bf16_in)
    decode_attn_merge<bf16><<<grid, MERGE_THREADS, 0, s>>>(p);
  else
    decode_attn_merge<float><<<grid, MERGE_THREADS, 0, s>>>(p);
  return (int)cudaGetLastError();
}
