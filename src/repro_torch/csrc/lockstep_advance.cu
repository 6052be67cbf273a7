// Lockstep-advance kernel for the scheduling engine, hand-written for Hopper.
//
// Replaces the Pallas TPU kernel repro/kernels/lockstep_advance/kernel.py
// (`_lockstep_kernel`, launched by `lockstep_advance_call`).  Semantics are
// those of repro_torch/env/engine.py `advance_shard`, its plain version:
// each row (one expert of one env) loops until its clock reaches its own
// t_next or it has no work; each turn takes exactly one action -- admit
// (clock += k1*p), decode (clock += k2*sum(p+d), finished requests add to
// the accumulator) or idle (clock = t_next).
//
// What bounds it: bytes, in principle.  A row reads about 400 B (run_i/run_f
// 2*R*5*4, wait_i/wait_f 2*W*4*4, par 32, clock and t_next 8 at R=W=5) and
// writes about 250 B (run_i/run_f, W wait-valid ints, clock, 6
// accumulators), and does a few hundred scalar operations.  In practice a
// row's turns are a chain of dependent steps, so the time is that chain's
// latency on the busiest rows, and the loads and stores around it.
//
// Design.  Rows are independent (the TPU kernel's lockstep over a block was
// a vectorisation device).  A group of G lanes owns one row: G = 8 when R
// and W are at most 8, else a full warp (G = 32, up to MAX_SLOTS).  Lane j
// holds run slot j and wait slot j in registers.  What a turn reads is
// kept per row in registers that every lane of the group holds alike, and
// changes only at an admission or a finish, so a plain decode turn is a
// few arithmetic instructions and no communication:
//  - the token sum (an integer, exact in any order): an admission adds
//    p + 1, a decode the number of running slots, a finish subtracts the
//    leaving slots' p + d;
//  - running and free slots as bit masks;
//  - the head waiter (least key among live waiters, ties to the lowest
//    slot, by a shuffle reduction over (key, slot)) and its memory term
//    mpt * (p + 1): keys never change and waiters only leave by admission,
//    so the head is picked again only after one;
//  - the decodes left until the next finish (min over running slots of
//    max(1, d_true - d_cur)): a decode that brings it to 0 finishes
//    requests, and only then are the slots read, their sums added to the
//    accumulators in slot order (each pulled from its lane, as the plain
//    version adds them) and the count taken again.
// The groups of a warp turn in lockstep (the warp loops while any of its
// rows is active) and every shuffle runs on the whole warp, so no group
// waits on another's divergent path.  A block of 128 threads (16 rows, or
// 4 at G = 32) stages its rows' run, wait, par, clock and t_next words
// through shared memory with block-wide coalesced copies (16 bytes a
// thread where aligned), and writes its outputs back the same way.  One
// launch per env step, as before.
//
// Floating point: built with --fmad=false, so nothing contracts except the
// four sites written as __fmaf_rn below, which are exactly the sites where
// the reference engine is contracted to FMA (see engine.py).  Division is
// IEEE (__fdiv_rn).  Ties in every pick go to the lowest index.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define MAX_SLOTS 32

// channel order: repro_torch/env/engine_layout.py
#define RI_VALID 0
#define RI_P 1
#define RI_D_TRUE 2
#define RI_D_CUR 3
#define RI_RETRY 4
#define RUN_I_CH 5
#define RF_SCORE 0
#define RF_PRED_S 1
#define RF_PRED_D 2
#define RF_T_ARRIVE 3
#define RF_T_ADMIT 4
#define RUN_F_CH 5
#define WI_VALID 0
#define WI_P 1
#define WI_D_TRUE 2
#define WI_RETRY 3
#define WAIT_I_CH 4
#define WF_SCORE 0
#define WF_PRED_S 1
#define WF_PRED_D 2
#define WF_T_ARRIVE 3
#define WAIT_F_CH 4
#define PAR_K1 0
#define PAR_K2 1
#define PAR_MEM_CAP 2
#define PAR_MPT 3
#define PAR_RUN_CAP 4
#define PAR_WAIT_CAP 5
#define PAR_UP 6
#define PAR_ADMIT_MIN 7
#define PAR_CH 8
#define N_ACC 6  // phi, lat, score, wait, done, viol

// admit orders, as engine.ADMIT_ORDERS
#define ORDER_FIFO 0
#define ORDER_QOS 1
#define ORDER_QOS_AGED 2
#define ORDER_EDF 3

#define KEY_INF 1e30f
#define THREADS 128

// n 32-bit words, block-wide: 16-byte pieces where both ends are 16-byte
// aligned, else word by word (still coalesced).
__device__ __forceinline__ void copy_words(uint32_t* __restrict__ dst,
                                           const uint32_t* __restrict__ src, int n) {
  int done = 0;
  if ((((uintptr_t)dst | (uintptr_t)src) & 15) == 0) {
    const int n4 = n / 4;
    for (int i = threadIdx.x; i < n4; i += THREADS)
      reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
    done = 4 * n4;
  }
  for (int i = done + threadIdx.x; i < n; i += THREADS) dst[i] = src[i];
}

// Words of each shared-memory region of a block of `rows` rows, rounded up
// to 16 bytes.
__host__ __device__ __forceinline__ int region(int rows, int per_row) {
  return (rows * per_row + 3) / 4 * 4;
}

template <int G>
__global__ void __launch_bounds__(THREADS) lockstep_advance_kernel(
    const int32_t* __restrict__ run_i, const float* __restrict__ run_f,
    const int32_t* __restrict__ wait_i, const float* __restrict__ wait_f,
    const float* __restrict__ par, const float* __restrict__ clocks,
    const float* __restrict__ t_next,
    int32_t* __restrict__ run_i_out, float* __restrict__ run_f_out,
    int32_t* __restrict__ wvalid_out, float* __restrict__ clocks_out,
    float* __restrict__ acc_out,
    int rows, int R, int W, float latency_L, int admit_order) {
  constexpr int ROWS = THREADS / G;  // rows per block
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* s_ri = smem;
  uint32_t* s_rf = s_ri + region(ROWS, R * RUN_I_CH);
  uint32_t* s_wi = s_rf + region(ROWS, R * RUN_F_CH);
  uint32_t* s_wf = s_wi + region(ROWS, W * WAIT_I_CH);
  uint32_t* s_par = s_wf + region(ROWS, W * WAIT_F_CH);
  uint32_t* s_clk = s_par + region(ROWS, PAR_CH);
  uint32_t* s_tn = s_clk + region(ROWS, 1);
  uint32_t* s_wv = s_tn + region(ROWS, 1);
  uint32_t* s_acc = s_wv + region(ROWS, W);

  const int row0 = blockIdx.x * ROWS;
  const int nrows = min(ROWS, rows - row0);
  copy_words(s_ri, (const uint32_t*)run_i + (size_t)row0 * R * RUN_I_CH, nrows * R * RUN_I_CH);
  copy_words(s_rf, (const uint32_t*)run_f + (size_t)row0 * R * RUN_F_CH, nrows * R * RUN_F_CH);
  copy_words(s_wi, (const uint32_t*)wait_i + (size_t)row0 * W * WAIT_I_CH, nrows * W * WAIT_I_CH);
  copy_words(s_wf, (const uint32_t*)wait_f + (size_t)row0 * W * WAIT_F_CH, nrows * W * WAIT_F_CH);
  copy_words(s_par, (const uint32_t*)par + (size_t)row0 * PAR_CH, nrows * PAR_CH);
  copy_words(s_clk, (const uint32_t*)clocks + row0, nrows);
  copy_words(s_tn, (const uint32_t*)t_next + row0, nrows);
  __syncthreads();

  const int grp = threadIdx.x / G, j = threadIdx.x % G;
  const bool here = grp < nrows;  // the group has a row
  // the group's lanes of the warp; every shuffle and vote runs on the
  // whole warp, width G
  constexpr unsigned FULL = 0xffffffffu;
  constexpr uint32_t LANES = G == 32 ? 0xffffffffu : (1u << (G % 32)) - 1u;
  const int base = (threadIdx.x % 32) / G * G;
  const auto ballot = [&](bool b) -> uint32_t {
    return (__ballot_sync(FULL, b) >> base) & LANES;
  };

  int32_t* ri = (int32_t*)s_ri + (grp * R + j) * RUN_I_CH;
  float* rf = (float*)s_rf + (grp * R + j) * RUN_F_CH;
  const int32_t* wi = (const int32_t*)s_wi + (grp * W + j) * WAIT_I_CH;
  const float* wf = (const float*)s_wf + (grp * W + j) * WAIT_F_CH;
  const float* pr = (const float*)s_par + grp * PAR_CH;

  float k1 = 0.f, k2 = 0.f, mem_cap = 0.f, mpt = 0.f, admit_min = 0.f;
  int run_cap = 0, wait_cap = 0;
  bool up = false;
  float clk = 0.f, tn = 0.f;
  if (here) {
    k1 = pr[PAR_K1]; k2 = pr[PAR_K2];
    mem_cap = pr[PAR_MEM_CAP]; mpt = pr[PAR_MPT];
    run_cap = (int)pr[PAR_RUN_CAP];
    wait_cap = (int)pr[PAR_WAIT_CAP];
    up = pr[PAR_UP] > 0.5f;
    admit_min = pr[PAR_ADMIT_MIN];
    clk = __uint_as_float(s_clk[grp]);
    tn = __uint_as_float(s_tn[grp]);
  }

  // this lane's run slot j
  const bool has_r = here && j < R;
  int r_valid = 0, r_p = 0, r_dtrue = 0, r_dcur = 0, r_retry = 0;
  float r_score = 0.f, r_preds = 0.f, r_predd = 0.f, r_tarr = 0.f, r_tadm = 0.f;
  if (has_r) {
    r_valid = ri[RI_VALID]; r_p = ri[RI_P]; r_dtrue = ri[RI_D_TRUE];
    r_dcur = ri[RI_D_CUR]; r_retry = ri[RI_RETRY];
    r_score = rf[RF_SCORE]; r_preds = rf[RF_PRED_S]; r_predd = rf[RF_PRED_D];
    r_tarr = rf[RF_T_ARRIVE]; r_tadm = rf[RF_T_ADMIT];
  }
  // this lane's wait slot j: everything but the valid bit is loop-invariant
  int w_p = 0, w_dtrue = 0, w_retry = 0;
  float w_score = 0.f, w_preds = 0.f, w_predd = 0.f, w_tarr = 0.f, wkey = KEY_INF;
  bool w_valid = false, w_pick = false;
  if (here && j < W) {
    w_p = wi[WI_P]; w_dtrue = wi[WI_D_TRUE]; w_retry = wi[WI_RETRY];
    w_score = wf[WF_SCORE]; w_preds = wf[WF_PRED_S]; w_predd = wf[WF_PRED_D];
    w_tarr = wf[WF_T_ARRIVE];
    switch (admit_order) {
      case ORDER_FIFO: wkey = w_tarr; break;
      case ORDER_QOS: wkey = -w_preds; break;
      case ORDER_EDF: wkey = __fmaf_rn(latency_L, w_predd, w_tarr); break;
      default: wkey = __fsub_rn(__fmul_rn(0.5f, w_tarr), w_preds); break;
    }
    w_valid = wi[WI_VALID] > 0;
    w_pick = j < wait_cap && w_preds >= admit_min;
  }
  // the row's state, alike in every lane of the group: bit j of a mask is
  // slot j
  uint32_t wvalid = ballot(w_valid);
  const uint32_t wpick = ballot(w_pick);
  uint32_t rvalid = ballot(has_r && r_valid > 0);
  const uint32_t r_ok = ballot(has_r && j < run_cap);  // live run slots
  int tokens = (rvalid >> j) & 1u ? r_p + r_dcur : 0;
  int next = (rvalid >> j) & 1u ? max(1, r_dtrue - r_dcur) : INT_MAX;
#pragma unroll
  for (int o = G / 2; o > 0; o /= 2) {
    tokens += __shfl_xor_sync(FULL, tokens, o, G);
    next = min(next, __shfl_xor_sync(FULL, next, o, G));
  }

  // the head waiter: least key among live waiters, ties to the lowest slot
  int w_idx = 0, head_pi = 0;
  float head_mem = 0.f;  // mpt * (p + 1) of the head
  const auto pick = [&]() {
    const uint32_t live = wvalid & wpick;
    float best = ((live >> j) & 1u) ? wkey : KEY_INF;
    int idx = j;
#pragma unroll
    for (int o = G / 2; o > 0; o /= 2) {
      const float k = __shfl_xor_sync(FULL, best, o, G);
      const int i = __shfl_xor_sync(FULL, idx, o, G);
      if (k < best || (k == best && i < idx)) { best = k; idx = i; }
    }
    w_idx = idx;
    head_pi = __shfl_sync(FULL, w_p, idx, G);
    head_mem = __fmul_rn(mpt, __fadd_rn((float)head_pi, 1.0f));
  };
  pick();

  float acc[N_ACC] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  bool active = here && clk < tn && (rvalid != 0u || wvalid != 0u);

  while (__any_sync(FULL, active)) {
    const uint32_t live = wvalid & wpick;
    const uint32_t free_slots = r_ok & ~rvalid;
    const float tok = (float)tokens;
    const bool fits = __fmaf_rn(tok, mpt, head_mem) <= mem_cap;
    const bool admit = active && live != 0u && free_slots != 0u && fits && up;
    const bool decode = active && !admit && rvalid != 0u && up;

    if (__any_sync(FULL, admit)) {
      const int h_dtrue = __shfl_sync(FULL, w_dtrue, w_idx, G);
      const int h_retry = __shfl_sync(FULL, w_retry, w_idx, G);
      const float h_score = __shfl_sync(FULL, w_score, w_idx, G);
      const float h_preds = __shfl_sync(FULL, w_preds, w_idx, G);
      const float h_predd = __shfl_sync(FULL, w_predd, w_idx, G);
      const float h_tarr = __shfl_sync(FULL, w_tarr, w_idx, G);
      if (admit) {
        const int r_free = __ffs(free_slots) - 1;
        if (j == r_free) {
          r_p = head_pi; r_dtrue = h_dtrue;
          r_dcur = 1;  // prefill emits the first token
          r_retry = h_retry;
          r_score = h_score; r_preds = h_preds; r_predd = h_predd;
          r_tarr = h_tarr; r_tadm = clk;
        }
        rvalid |= 1u << r_free;
        wvalid &= ~(1u << w_idx);
        tokens += head_pi + 1;
        next = min(next, max(1, h_dtrue - 1));
        clk = __fmaf_rn(k1, (float)head_pi, clk);
      }
      pick();  // rows that did not admit pick the same head again
    }

    float clock_dec = clk;
    if (decode) {
      clock_dec = __fmaf_rn(k2, tok, clk);
      if ((rvalid >> j) & 1u) r_dcur += 1;
      tokens += __popc(rvalid);
      next -= 1;
    }
    const bool finishing = decode && next == 0;
    if (__any_sync(FULL, finishing)) {
      const bool fin = finishing && ((rvalid >> j) & 1u) && r_dcur >= r_dtrue;
      float c_phi = 0.f, c_lat = 0.f, c_wait = 0.f;
      bool ok = true;
      if (fin) {
        c_lat = __fdiv_rn(__fsub_rn(clock_dec, r_tarr), fmaxf((float)r_dtrue, 1.0f));
        ok = c_lat <= latency_L;
        c_phi = ok ? r_score : 0.f;
        c_wait = __fsub_rn(r_tadm, r_tarr);
      }
      const uint32_t fin_m = ballot(fin);
      const uint32_t viol_m = ballot(fin && !ok);
      // the finished requests' sums in slot order, as the plain version
      float s_phi = 0.f, s_lat = 0.f, s_score = 0.f, s_wait = 0.f;
      int gone = 0;
      for (int k = 0; k < R; ++k) {
        const float a = __shfl_sync(FULL, c_phi, k, G);
        const float b = __shfl_sync(FULL, c_lat, k, G);
        const float c = __shfl_sync(FULL, r_score, k, G);
        const float d = __shfl_sync(FULL, c_wait, k, G);
        const int t = __shfl_sync(FULL, r_p + r_dcur, k, G);
        if ((fin_m >> k) & 1u) {
          s_phi = __fadd_rn(s_phi, a);
          s_lat = __fadd_rn(s_lat, b);
          s_score = __fadd_rn(s_score, c);
          s_wait = __fadd_rn(s_wait, d);
          gone += t;
        }
      }
      if (finishing) {
        acc[0] = __fadd_rn(acc[0], s_phi);
        acc[1] = __fadd_rn(acc[1], s_lat);
        acc[2] = __fadd_rn(acc[2], s_score);
        acc[3] = __fadd_rn(acc[3], s_wait);
        acc[4] += (float)__popc(fin_m);
        acc[5] += (float)__popc(viol_m);
        rvalid &= ~fin_m;
        tokens -= gone;
      }
      int cd = (rvalid >> j) & 1u ? max(1, r_dtrue - r_dcur) : INT_MAX;
#pragma unroll
      for (int o = G / 2; o > 0; o /= 2) cd = min(cd, __shfl_xor_sync(FULL, cd, o, G));
      if (finishing) next = cd;
    }

    if (decode) clk = clock_dec;
    else if (active && !admit) clk = tn;  // idle
    active = active && clk < tn && (rvalid != 0u || wvalid != 0u);
  }

  if (has_r) {
    ri[RI_VALID] = (rvalid >> j) & 1u; ri[RI_P] = r_p; ri[RI_D_TRUE] = r_dtrue;
    ri[RI_D_CUR] = r_dcur; ri[RI_RETRY] = r_retry;
    rf[RF_SCORE] = r_score; rf[RF_PRED_S] = r_preds; rf[RF_PRED_D] = r_predd;
    rf[RF_T_ARRIVE] = r_tarr; rf[RF_T_ADMIT] = r_tadm;
  }
  if (here && j < W) s_wv[grp * W + j] = (wvalid >> j) & 1u;
  if (here && j == 0) {
    s_clk[grp] = __float_as_uint(fmaxf(clk, tn));
#pragma unroll
    for (int k = 0; k < N_ACC; ++k) s_acc[grp * N_ACC + k] = __float_as_uint(acc[k]);
  }
  __syncthreads();

  copy_words((uint32_t*)run_i_out + (size_t)row0 * R * RUN_I_CH, s_ri, nrows * R * RUN_I_CH);
  copy_words((uint32_t*)run_f_out + (size_t)row0 * R * RUN_F_CH, s_rf, nrows * R * RUN_F_CH);
  copy_words((uint32_t*)wvalid_out + (size_t)row0 * W, s_wv, nrows * W);
  copy_words((uint32_t*)clocks_out + row0, s_clk, nrows);
  copy_words((uint32_t*)acc_out + (size_t)row0 * N_ACC, s_acc, nrows * N_ACC);
}

template <int G>
static int launch(const void* run_i, const void* run_f, const void* wait_i,
                  const void* wait_f, const void* par, const void* clocks,
                  const void* t_next, void* run_i_out, void* run_f_out,
                  void* wvalid_out, void* clocks_out, void* acc_out, int rows,
                  int R, int W, float latency_L, int admit_order,
                  cudaStream_t stream) {
  constexpr int ROWS = THREADS / G;
  const int words = region(ROWS, R * RUN_I_CH) + region(ROWS, R * RUN_F_CH) +
                    region(ROWS, W * WAIT_I_CH) + region(ROWS, W * WAIT_F_CH) +
                    region(ROWS, PAR_CH) + 2 * region(ROWS, 1) + region(ROWS, W) +
                    region(ROWS, N_ACC);
  const int blocks = (rows + ROWS - 1) / ROWS;
  lockstep_advance_kernel<G><<<blocks, THREADS, words * 4, stream>>>(
      (const int32_t*)run_i, (const float*)run_f, (const int32_t*)wait_i,
      (const float*)wait_f, (const float*)par, (const float*)clocks,
      (const float*)t_next, (int32_t*)run_i_out, (float*)run_f_out,
      (int32_t*)wvalid_out, (float*)clocks_out, (float*)acc_out, rows, R, W,
      latency_L, admit_order);
  return (int)cudaGetLastError();
}

// Plain C entry point, loaded with ctypes.  Launches on `stream` and
// returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue for
// widths past MAX_SLOTS; it never synchronises.
extern "C" int lockstep_advance_launch(
    const void* run_i, const void* run_f, const void* wait_i,
    const void* wait_f, const void* par, const void* clocks,
    const void* t_next, void* run_i_out, void* run_f_out, void* wvalid_out,
    void* clocks_out, void* acc_out, int rows, int R, int W,
    float latency_L, int admit_order, void* stream) {
  if (R < 1 || W < 1 || R > MAX_SLOTS || W > MAX_SLOTS)
    return (int)cudaErrorInvalidValue;
  if (rows <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (R <= 8 && W <= 8)
    return launch<8>(run_i, run_f, wait_i, wait_f, par, clocks, t_next,
                     run_i_out, run_f_out, wvalid_out, clocks_out, acc_out,
                     rows, R, W, latency_L, admit_order, s);
  return launch<32>(run_i, run_f, wait_i, wait_f, par, clocks, t_next,
                    run_i_out, run_f_out, wvalid_out, clocks_out, acc_out,
                    rows, R, W, latency_L, admit_order, s);
}
