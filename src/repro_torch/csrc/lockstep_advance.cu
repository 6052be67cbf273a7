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
// What bounds it: bytes.  A row reads about 400 B (run_i/run_f 2*R*5*4,
// wait_i/wait_f 2*W*4*4, par 32, clock and t_next 8 at R=W=5) and writes
// about 250 B (run_i/run_f, W wait-valid ints, clock, 6 accumulators), and
// does a few hundred scalar operations.  This first version is
// latency-bound instead: one thread runs one row's serial loop, with the
// row's queues in per-thread arrays, so a launch takes as long as the
// longest row's loop.  Rows are independent (the TPU kernel's lockstep over
// a block was a vectorisation device), so no thread waits on another.  A
// later version can give each row a warp, lanes over slots.
//
// Floating point: built with --fmad=false, so nothing contracts except the
// four sites written as __fmaf_rn below, which are exactly the sites where
// the reference engine is contracted to FMA (see engine.py).  Division is
// IEEE (__fdiv_rn).  Ties in every pick go to the lowest index.
#include <cuda_runtime.h>
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

__global__ void lockstep_advance_kernel(
    const int32_t* __restrict__ run_i, const float* __restrict__ run_f,
    const int32_t* __restrict__ wait_i, const float* __restrict__ wait_f,
    const float* __restrict__ par, const float* __restrict__ clocks,
    const float* __restrict__ t_next,
    int32_t* __restrict__ run_i_out, float* __restrict__ run_f_out,
    int32_t* __restrict__ wvalid_out, float* __restrict__ clocks_out,
    float* __restrict__ acc_out,
    int rows, int R, int W, float latency_L, int admit_order) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= rows) return;

  const int32_t* ri_in = run_i + (size_t)row * R * RUN_I_CH;
  const float* rf_in = run_f + (size_t)row * R * RUN_F_CH;
  const int32_t* wi = wait_i + (size_t)row * W * WAIT_I_CH;
  const float* wf = wait_f + (size_t)row * W * WAIT_F_CH;
  const float* pr = par + (size_t)row * PAR_CH;

  int32_t ri[MAX_SLOTS * RUN_I_CH];
  float rf[MAX_SLOTS * RUN_F_CH];
  for (int j = 0; j < R * RUN_I_CH; ++j) ri[j] = ri_in[j];
  for (int j = 0; j < R * RUN_F_CH; ++j) rf[j] = rf_in[j];

  const float k1 = pr[PAR_K1], k2 = pr[PAR_K2];
  const float mem_cap = pr[PAR_MEM_CAP], mpt = pr[PAR_MPT];
  const int run_cap = (int)pr[PAR_RUN_CAP];
  const int wait_cap = (int)pr[PAR_WAIT_CAP];
  const bool up = pr[PAR_UP] > 0.5f;
  const float admit_min = pr[PAR_ADMIT_MIN];

  // wait side: everything but the valid bit is loop-invariant
  float wkey[MAX_SLOTS];
  uint32_t wvalid = 0, wpick = 0;  // bit j: slot j valid / pickable
  for (int j = 0; j < W; ++j) {
    const float* f = wf + j * WAIT_F_CH;
    float key;
    switch (admit_order) {
      case ORDER_FIFO: key = f[WF_T_ARRIVE]; break;
      case ORDER_QOS: key = -f[WF_PRED_S]; break;
      case ORDER_EDF: key = __fmaf_rn(latency_L, f[WF_PRED_D], f[WF_T_ARRIVE]); break;
      default: key = __fsub_rn(__fmul_rn(0.5f, f[WF_T_ARRIVE]), f[WF_PRED_S]); break;
    }
    wkey[j] = key;
    if (wi[j * WAIT_I_CH + WI_VALID] > 0) wvalid |= 1u << j;
    if (j < wait_cap && f[WF_PRED_S] >= admit_min) wpick |= 1u << j;
  }

  float clk = clocks[row];
  const float tn = t_next[row];
  float acc[N_ACC] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};

  bool any_run = false;
  for (int j = 0; j < R; ++j) any_run |= ri[j * RUN_I_CH + RI_VALID] > 0;
  bool active = clk < tn && (any_run || wvalid != 0u);

  while (active) {
    int tokens = 0, r_free = 0;
    bool r_has = false, r_space = false;
    for (int j = 0; j < R; ++j) {
      const int32_t* s = ri + j * RUN_I_CH;
      if (s[RI_VALID] > 0) {
        tokens += s[RI_P] + s[RI_D_CUR];
        r_has = true;
      } else if (j < run_cap && !r_space) {
        r_free = j;
        r_space = true;
      }
    }
    const float tok = (float)tokens;

    const uint32_t live = wvalid & wpick;
    int w_idx = 0;
    float best = (live & 1u) ? wkey[0] : KEY_INF;
    for (int j = 1; j < W; ++j) {
      const float k = ((live >> j) & 1u) ? wkey[j] : KEY_INF;
      if (k < best) { best = k; w_idx = j; }
    }
    const int32_t* head_i = wi + w_idx * WAIT_I_CH;
    const float head_p = (float)head_i[WI_P];
    const bool fits =
        __fmaf_rn(tok, mpt, __fmul_rn(mpt, __fadd_rn(head_p, 1.0f))) <= mem_cap;
    const bool admit = live != 0u && r_space && fits && up;

    if (admit) {
      const float* head_f = wf + w_idx * WAIT_F_CH;
      int32_t* s = ri + r_free * RUN_I_CH;
      s[RI_VALID] = 1;
      s[RI_P] = head_i[WI_P];
      s[RI_D_TRUE] = head_i[WI_D_TRUE];
      s[RI_D_CUR] = 1;  // prefill emits the first token
      s[RI_RETRY] = head_i[WI_RETRY];
      float* g = rf + r_free * RUN_F_CH;
      g[RF_SCORE] = head_f[WF_SCORE];
      g[RF_PRED_S] = head_f[WF_PRED_S];
      g[RF_PRED_D] = head_f[WF_PRED_D];
      g[RF_T_ARRIVE] = head_f[WF_T_ARRIVE];
      g[RF_T_ADMIT] = clk;
      wvalid &= ~(1u << w_idx);
      clk = __fmaf_rn(k1, head_p, clk);
    } else if (r_has && up) {
      const float clock_dec = __fmaf_rn(k2, tok, clk);
      float s_phi = 0.f, s_lat = 0.f, s_score = 0.f, s_wait = 0.f;
      float s_done = 0.f, s_viol = 0.f;
      for (int j = 0; j < R; ++j) {
        int32_t* s = ri + j * RUN_I_CH;
        if (s[RI_VALID] <= 0) continue;
        const int d_new = s[RI_D_CUR] + 1;
        s[RI_D_CUR] = d_new;
        if (d_new < s[RI_D_TRUE]) continue;
        const float* g = rf + j * RUN_F_CH;
        const float lat = __fdiv_rn(__fsub_rn(clock_dec, g[RF_T_ARRIVE]),
                                    fmaxf((float)s[RI_D_TRUE], 1.0f));
        const bool ok = lat <= latency_L;
        s_phi = __fadd_rn(s_phi, ok ? g[RF_SCORE] : 0.f);
        s_lat = __fadd_rn(s_lat, lat);
        s_score = __fadd_rn(s_score, g[RF_SCORE]);
        s_wait = __fadd_rn(s_wait, __fsub_rn(g[RF_T_ADMIT], g[RF_T_ARRIVE]));
        s_done += 1.f;
        s_viol += ok ? 0.f : 1.f;
        s[RI_VALID] = 0;
      }
      acc[0] = __fadd_rn(acc[0], s_phi);
      acc[1] = __fadd_rn(acc[1], s_lat);
      acc[2] = __fadd_rn(acc[2], s_score);
      acc[3] = __fadd_rn(acc[3], s_wait);
      acc[4] += s_done;
      acc[5] += s_viol;
      clk = clock_dec;
    } else {
      clk = tn;
    }

    any_run = false;
    for (int j = 0; j < R; ++j) any_run |= ri[j * RUN_I_CH + RI_VALID] > 0;
    active = clk < tn && (any_run || wvalid != 0u);
  }

  int32_t* ri_o = run_i_out + (size_t)row * R * RUN_I_CH;
  float* rf_o = run_f_out + (size_t)row * R * RUN_F_CH;
  for (int j = 0; j < R * RUN_I_CH; ++j) ri_o[j] = ri[j];
  for (int j = 0; j < R * RUN_F_CH; ++j) rf_o[j] = rf[j];
  for (int j = 0; j < W; ++j) wvalid_out[(size_t)row * W + j] = (wvalid >> j) & 1u;
  clocks_out[row] = fmaxf(clk, tn);
  for (int k = 0; k < N_ACC; ++k) acc_out[(size_t)row * N_ACC + k] = acc[k];
}

// Plain C entry point, loaded with ctypes.  Launches on `stream` and
// returns cudaGetLastError() (0 on success); it never synchronises.
extern "C" int lockstep_advance_launch(
    const void* run_i, const void* run_f, const void* wait_i,
    const void* wait_f, const void* par, const void* clocks,
    const void* t_next, void* run_i_out, void* run_f_out, void* wvalid_out,
    void* clocks_out, void* acc_out, int rows, int R, int W,
    float latency_L, int admit_order, void* stream) {
  if (rows <= 0) return 0;
  const int threads = 128;
  const int blocks = (rows + threads - 1) / threads;
  lockstep_advance_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)run_i, (const float*)run_f, (const int32_t*)wait_i,
      (const float*)wait_f, (const float*)par, (const float*)clocks,
      (const float*)t_next, (int32_t*)run_i_out, (float*)run_f_out,
      (int32_t*)wvalid_out, (float*)clocks_out, (float*)acc_out, rows, R, W,
      latency_L, admit_order);
  return (int)cudaGetLastError();
}
