// Kernel K7: one whole training slot of S scenarios in one launch, for
// Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
// p2pmicrogrid_tpu/ops/pallas_slot.py::slot_step_fused (body _make_kernel).
// It computes what the port's unfused slot chain computes
// (envs/community.py::slot_dynamics_batched, and ops/slot_fused.py::
// slot_step_fused_plain, the plain version beside this kernel):
//
//   tariff -> battery rule -> observation features -> R decision passes
//   (tabular Q-row argmax, or the per-agent DQN 5->64->64->1 forward over the
//   3 enumerated actions; epsilon-greedy from draws made outside) -> market
//   clearing (factored rounds 0/1, the matrix negotiation at any rounds, or no
//   trading) -> settlement cost, comfort penalty, reward -> 2R2C thermal step.
//
// Layout. One thread block per scenario; threads stride over agents. The
// scenario's per-agent vectors live in dynamic shared memory (18 * A floats,
// 72 KB at A = 1000; the launcher opts in above 48 KB). The DQN weights are
// read in place from global memory in flax's layout ([A, in, out] kernels,
// [A, out] biases; 18 KB per agent, 18 MB at A = 1000, which stays in L2),
// one warp per agent: lane l owns hidden units l and l + 32 of the three
// action passes, reads each weight row coalesced once for all three
// actions, takes the other hidden units through warp shuffles, and sums the
// output layer with a butterfly reduction (every lane ends with the same
// bits). The tabular act reads the Q-table cell [a, ti, tpi, bi, pi, :]
// directly (CUDA gathers; the Pallas kernel needed a pre-gathered operand).
//
// Clearing. Factored: the merged min row and column sums of K1, with K1's
// device functions and summation order (slot_ops.cuh), over the block's own
// shared vectors. Matrix: a float32 workspace [S, A, A] from the caller; round
// 0 writes the rank-1 equal split, each later round sums its columns (the
// mean observation and the opposite-sign totals) and rewrites the matrix in
// place, one thread per unordered pair (i, j) so that the new [i, j] and
// [j, i] both come from the old pair; then the sign-opposition clearing.
//
// Rounding. Every product and sum of the chain is written with __fmul_rn /
// __fadd_rn / __fsub_rn, so nvcc cannot contract it into a fused
// multiply-add the chain does not do; divisions are IEEE divisions (no fast
// math); the constants come from the host as the chain rounds them. Sums
// over agents (the round-1 mean, the factored weight totals, the matrix
// columns and rows) run in a fixed order of their own, so the result is the
// same on every launch but may differ from torch.sum in the last bits. The
// matrix sums add blocks of 32 terms (blocked_sum), whose rounding error at
// A = 1000 is near torch.sum's; one running sum over 1000 terms of ~1e3 W
// drifts by a few 1e-2 W.
//
// What bounds it. Factored at S = 64, A = 1000: the merged min pass, about
// 0.45 G min/add operations, against ~10 MB of traffic; the DQN act adds
// ~3.4 GFLOP of float32 work per slot (S * A * R * 3 forwards of ~8.9 kFLOP)
// and ~2.3 GB of weight reads served by L2. Only S blocks run, so at S = 64
// half the 132 SMs idle: a simple design first, made fast in later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "slot_ops.cuh"

namespace {

using slot_ops::merged_min_entry;
using slot_ops::min_nan;
using slot_ops::tile_sum;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kHidden = 64;  // the published DQN width (config.py DQNConfig)
constexpr int kObs = 4;
constexpr int kActions = 3;  // ACTION_VALUES = (0, 0.5, 1)
constexpr unsigned kFull = 0xffffffffu;

enum Market { kNoTrading = 0, kFactored = 1, kMatrix = 2 };
enum Policy { kTabular = 0, kDQN = 1 };

// Pointer, constant and integer arguments, in the order the Python wrapper
// (ops/slot_fused.py) passes them.
enum PtrArg {
  P_TIME, P_TOUT, P_LOAD, P_PV, P_TIN, P_TBM, P_SOC, P_HPFRAC, P_MAXIN,
  P_UNIFORM, P_RAND, P_EPS, P_QTABLE, P_W0, P_B0, P_W1, P_B1, P_W2, P_B2,
  P_OUT, P_DECISIONS, P_WORK, N_PTR
};
enum ConstArg {
  C_FREQ, C_PHASE, C_COST_AVG, C_COST_AMP, C_INV_CENTS, C_INJECTION,
  C_DT, C_MIN_SOC, C_MAX_SOC, C_CAPACITY, C_SQRT_EFF, C_INV_SQRT_EFF,
  C_INV_CAP, C_INV_ETA_CAP, C_INV_DT,
  C_SETPOINT, C_INV_MARGIN, C_LOWER, C_UPPER,
  C_HP_MAX, C_COP, C_C_CI, C_C_CM, C_INV_RI, C_INV_RVENT, C_INV_RE,
  C_ONE_MINUS_FRAD, C_FRAD, C_SLOT_HOURS, C_INV_A, C_INV_A2, N_CONST
};
enum IntArg {
  I_S, I_A, I_R, I_POLICY, I_MARKET, I_EXPLORE, I_BATTERY, I_BF16,
  I_NT, I_NTP, I_NB, I_NP, I_NACT, N_INT
};

// The 14 [S, A] outputs, in the order of pallas_slot.py's kernel outputs.
enum Out {
  O_TIN, O_TBM, O_SOC, O_FRAC, O_COST, O_REWARD, O_PGRID, O_PP2P, O_Q, O_AUX,
  O_FTIME, O_FTEMP, O_FBAL, O_FP2P, N_OUT
};

// Shared per-agent vectors, each A floats.
enum Vec {
  V_BAL, V_NTEMP, V_NBAL, V_FEAT, V_FRAC, V_AUX, V_Q, V_OUT0, V_OUT,
  V_ALPHA, V_WPLUS, V_WMINUS, V_GAMMA, V_PB, V_PS, V_PGRID, V_PP2P, V_INVMAX,
  N_VEC
};

struct Args {
  void* p[N_PTR];
  float c[N_CONST];
  int n[N_INT];
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// torch.sign compared by value: -1, 0 or 1 (NaN stays NaN).
__device__ __forceinline__ float sgn(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : (x == 0.f ? 0.f : x));
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// ``clamp(int(x), 0, hi)``: float -> int truncates toward zero.
__device__ __forceinline__ int bin_of(float x, int hi) {
  const int b = static_cast<int>(x);
  return b < 0 ? 0 : (b > hi ? hi : b);
}

// Sum of v over the block, in a fixed order (a shared-memory tree).
__device__ float block_sum(float v, float* red) {
  red[threadIdx.x] = v;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] = add(red[threadIdx.x], red[threadIdx.x + s]);
    __syncthreads();
  }
  const float r = red[0];
  __syncthreads();
  return r;
}

// Sum of entry(t) over t < n by one thread: the running sum of each block
// of 32 terms, added in order.
template <typename Entry>
__device__ __forceinline__ float blocked_sum(int n, Entry entry) {
  float total = 0.f;
  for (int t0 = 0; t0 < n; t0 += 32) {
    const int t1 = min(n, t0 + 32);
    float part = 0.f;
    for (int t = t0; t < t1; ++t) part = add(part, entry(t));
    total = add(total, part);
  }
  return total;
}

// argmax with torch's rules (first of tied maxima; a NaN wins) and its value.
__device__ __forceinline__ void greedy3(const float* q, int* best, float* best_q) {
  int g = 0;
  float v = q[0];
#pragma unroll
  for (int k = 1; k < kActions; ++k) {
    if (v == v && (q[k] > v || q[k] != q[k])) {
      g = k;
      v = q[k];
    }
  }
  *best = g;
  *best_q = v;
}

__device__ __forceinline__ float action_value(int a) {
  return a == 0 ? 0.f : (a == 1 ? 0.5f : 1.f);
}

// The epsilon-greedy choice of agent i in round r from its three Q-values:
// writes frac, aux and q to shared memory.
__device__ __forceinline__ void choose(const Args& g, float* vec, int A, int s, int r,
                                       int i, const float* qv) {
  int action;
  float q;
  greedy3(qv, &action, &q);
  if (g.n[I_EXPLORE]) {
    const size_t k = (static_cast<size_t>(r) * g.n[I_S] + s) * A + i;
    const float u = static_cast<const float*>(g.p[P_UNIFORM])[k];
    if (u < *static_cast<const float*>(g.p[P_EPS])) {
      action = static_cast<int>(static_cast<const long long*>(g.p[P_RAND])[k]);
      q = 0.f;
    }
  }
  vec[V_FRAC * A + i] = action_value(action);
  vec[V_AUX * A + i] = static_cast<float>(action);
  vec[V_Q * A + i] = q;
}

// Tabular act: thread per agent, the Q-row read in place.
__device__ void act_tabular(const Args& g, float* vec, int A, int s, int r, float f_time) {
  const int nt = g.n[I_NT], ntp = g.n[I_NTP], nb = g.n[I_NB], np = g.n[I_NP];
  const float* qt = static_cast<const float*>(g.p[P_QTABLE]);
  const int ti = bin_of(mul(f_time, static_cast<float>(nt)), nt - 1);
  for (int i = threadIdx.x; i < A; i += kThreads) {
    const float tp = add(mul(mul(add(vec[V_NTEMP * A + i], 1.f), 0.5f),
                             static_cast<float>(ntp - 2)), 1.f);
    const int tpi = bin_of(tp, ntp - 1);
    const int bi = bin_of(mul(mul(add(vec[V_NBAL * A + i], 1.f), 0.5f),
                              static_cast<float>(nb)), nb - 1);
    const int pi = bin_of(mul(mul(add(vec[V_FEAT * A + i], 1.f), 0.5f),
                              static_cast<float>(np)), np - 1);
    const size_t cell =
        ((((static_cast<size_t>(i) * nt + ti) * ntp + tpi) * nb + bi) * np + pi);
    const float* row = qt + cell * g.n[I_NACT];
    const float qv[kActions] = {row[0], row[1], row[2]};
    choose(g, vec, A, s, r, i, qv);
  }
}

// DQN act: warp per agent, the per-agent network read in place.
__device__ void act_dqn(const Args& g, float* vec, int A, int s, int r, float f_time) {
  const float* w0 = static_cast<const float*>(g.p[P_W0]);
  const float* b0 = static_cast<const float*>(g.p[P_B0]);
  const float* w1 = static_cast<const float*>(g.p[P_W1]);
  const float* b1 = static_cast<const float*>(g.p[P_B1]);
  const float* w2 = static_cast<const float*>(g.p[P_W2]);
  const float* b2 = static_cast<const float*>(g.p[P_B2]);
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x >> 5; i < A; i += kWarps) {
    const float x[kObs] = {f_time, vec[V_NTEMP * A + i], vec[V_NBAL * A + i],
                           vec[V_FEAT * A + i]};
    const float* W0 = w0 + static_cast<size_t>(i) * (kObs + 1) * kHidden;
    const float* W1 = w1 + static_cast<size_t>(i) * kHidden * kHidden;
    const float* W2 = w2 + static_cast<size_t>(i) * kHidden;
    // Layer 0: hidden units lane and lane + 32 of each action pass.
    float h[2][kActions];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int k = lane + 32 * half;
      float base = 0.f;
#pragma unroll
      for (int d = 0; d < kObs; ++d) base = fmaf(x[d], W0[d * kHidden + k], base);
      const float wa = W0[kObs * kHidden + k];
      const float bias = b0[i * kHidden + k];
#pragma unroll
      for (int a = 0; a < kActions; ++a)
        h[half][a] = fmaxf(fmaf(action_value(a), wa, base) + bias, 0.f);
    }
    // Layer 1: units lane and lane + 32; the inputs come by shuffle.
    float acc[2][kActions] = {};
#pragma unroll
    for (int half = 0; half < 2; ++half) {
#pragma unroll 8
      for (int src = 0; src < 32; ++src) {
        const int k = src + 32 * half;
        const float wl = W1[k * kHidden + lane];
        const float wh = W1[k * kHidden + lane + 32];
#pragma unroll
        for (int a = 0; a < kActions; ++a) {
          const float v = __shfl_sync(kFull, h[half][a], src);
          acc[0][a] = fmaf(v, wl, acc[0][a]);
          acc[1][a] = fmaf(v, wh, acc[1][a]);
        }
      }
    }
    float qv[kActions];
#pragma unroll
    for (int a = 0; a < kActions; ++a) {
      const float h_lo = fmaxf(acc[0][a] + b1[i * kHidden + lane], 0.f);
      const float h_hi = fmaxf(acc[1][a] + b1[i * kHidden + lane + 32], 0.f);
      float part = fmaf(h_hi, W2[lane + 32], h_lo * W2[lane]);
#pragma unroll
      for (int m = 16; m > 0; m >>= 1) part += __shfl_xor_sync(kFull, part, m);
      qv[a] = part + b2[i];
    }
    if (lane == 0) choose(g, vec, A, s, r, i, qv);
  }
}

// One decision pass on the features in shared memory; then, per agent, the
// round's heat-pump power into ``decisions`` and its net power into V_OUT.
__device__ void decide(const Args& g, float* vec, int A, int s, int r, float f_time) {
  if (g.n[I_POLICY] == kTabular) {
    act_tabular(g, vec, A, s, r, f_time);
  } else {
    act_dqn(g, vec, A, s, r, f_time);
  }
  __syncthreads();
  float* decisions = static_cast<float*>(g.p[P_DECISIONS]);
  const float hp_max = g.c[C_HP_MAX];
  for (int i = threadIdx.x; i < A; i += kThreads) {
    const float hp = mul(vec[V_FRAC * A + i], hp_max);
    decisions[(static_cast<size_t>(s) * g.n[I_R] + r) * A + i] = hp;
    vec[V_OUT * A + i] = add(vec[V_BAL * A + i], hp);
  }
  __syncthreads();
}

// Merged min row and column sums over the block's factor vectors, K1's
// order: row sums into V_PGRID, column sums into V_PP2P (scratch).
__device__ void merged_min(float* vec, int A) {
  const float* al = vec + V_ALPHA * A;
  const float* wp = vec + V_WPLUS * A;
  const float* wm = vec + V_WMINUS * A;
  const float* ga = vec + V_GAMMA * A;
  const float* pb = vec + V_PB * A;
  const float* ps = vec + V_PS * A;
  constexpr int kTile = slot_ops::kMergedMinTile;
  for (int i = threadIdx.x; i < A; i += kThreads) {
    float row = 0.f, col = 0.f;
    for (int j0 = 0; j0 < A; j0 += kTile) {
      const int n = min(kTile, A - j0);
      row += tile_sum(n, [&](int t) {
        return merged_min_entry(al[i], wm[i], pb[i], wp[j0 + t], ga[j0 + t], ps[j0 + t]);
      });
      col += tile_sum(n, [&](int t) {
        return merged_min_entry(al[j0 + t], wm[j0 + t], pb[j0 + t], wp[i], ga[i], ps[i]);
      });
    }
    vec[V_PGRID * A + i] = row;
    vec[V_PP2P * A + i] = col;
  }
  __syncthreads();
}

// _settle: p_p2p = buyer ? row : (seller ? -col : 0), p_grid = b - p_p2p.
__device__ void settle(float* vec, int A, const float* b) {
  for (int i = threadIdx.x; i < A; i += kThreads) {
    const float bi = b[i];
    const float row = vec[V_PGRID * A + i];
    const float col = vec[V_PP2P * A + i];
    const float p2p = bi > 0.f ? row : (bi < 0.f ? -col : 0.f);
    vec[V_PP2P * A + i] = p2p;
    vec[V_PGRID * A + i] = sub(bi, p2p);
  }
  __syncthreads();
}

// ops/factored_market.py::clear_factored_rounds0 on V_OUT0.
__device__ void clear_rounds0(const Args& g, float* vec, int A) {
  const float inv_a = g.c[C_INV_A];
  const bool bf16 = g.n[I_BF16];
  for (int i = threadIdx.x; i < A; i += kThreads) {
    const float b = vec[V_OUT0 * A + i];
    float a_e = b > 0.f ? mul(fabsf(b), inv_a) : 0.f;
    float g_e = b < 0.f ? mul(fabsf(b), inv_a) : 0.f;
    if (bf16) {
      a_e = round_bf16(a_e);
      g_e = round_bf16(g_e);
    }
    vec[V_ALPHA * A + i] = a_e;
    vec[V_GAMMA * A + i] = g_e;
    vec[V_WPLUS * A + i] = 0.f;
    vec[V_WMINUS * A + i] = 0.f;
    vec[V_PB * A + i] = 0.f;
    vec[V_PS * A + i] = 0.f;
  }
  __syncthreads();
  merged_min(vec, A);
  settle(vec, A, vec + V_OUT0 * A);
}

// ops/factored_market.py::clear_factored_rounds1(b0 = V_OUT0, b1 = V_OUT).
__device__ void clear_rounds1(const Args& g, float* vec, int A, float* red) {
  float sp = 0.f, sn = 0.f;
  for (int i = threadIdx.x; i < A; i += kThreads) {
    const float b0 = vec[V_OUT0 * A + i];
    sp = add(sp, fmaxf(b0, 0.f));
    sn = add(sn, fmaxf(-b0, 0.f));
  }
  sp = block_sum(sp, red);
  sn = block_sum(sn, red);
  const float inv_a = g.c[C_INV_A];
  const bool bf16 = g.n[I_BF16];
  for (int i = threadIdx.x; i < A; i += kThreads) {
    const float b0 = vec[V_OUT0 * A + i];
    const float b1 = vec[V_OUT * A + i];
    float wplus = fmaxf(b0, 0.f);
    float wminus = fmaxf(-b0, 0.f);
    const bool buyer = b1 > 0.f, seller = b1 < 0.f;
    const float opp = buyer ? sub(sp, wplus) : (seller ? sub(sn, wminus) : 0.f);
    const bool prop = opp > 0.f;
    const float absb1 = fabsf(b1);
    const float scaled = prop ? __fdiv_rn(absb1, opp) : mul(absb1, inv_a);
    float alpha = buyer ? scaled : 0.f;
    float gamma = seller ? scaled : 0.f;
    if (bf16) {
      alpha = round_bf16(alpha);
      wplus = round_bf16(wplus);
      wminus = round_bf16(wminus);
      gamma = round_bf16(gamma);
    }
    vec[V_ALPHA * A + i] = alpha;
    vec[V_WPLUS * A + i] = wplus;
    vec[V_WMINUS * A + i] = wminus;
    vec[V_GAMMA * A + i] = gamma;
    vec[V_PB * A + i] = (buyer && prop) ? 1.f : 0.f;
    vec[V_PS * A + i] = (seller && prop) ? 1.f : 0.f;
  }
  __syncthreads();
  merged_min(vec, A);
  settle(vec, A, vec + V_OUT * A);
}

// The matrix negotiation: R decision passes on the workspace P (this
// scenario's [A, A] slice), then ops/market.py::clear_market.
__device__ void matrix_market(const Args& g, float* vec, int A, int s, float f_time,
                              float* P) {
  const int R = g.n[I_R];
  const float inv_a = g.c[C_INV_A];
  // Round 0 splits against a zero matrix: feature 0, the equal split
  // out_i / A in every column (the diagonal included).
  for (int i = threadIdx.x; i < A; i += kThreads) vec[V_FEAT * A + i] = 0.f;
  __syncthreads();
  decide(g, vec, A, s, 0, f_time);
  const size_t AA = static_cast<size_t>(A) * A;
  for (size_t k = threadIdx.x; k < AA; k += kThreads) {
    P[k] = mul(vec[V_OUT * A + k / A], inv_a);
  }
  __syncthreads();
  for (int r = 1; r < R; ++r) {
    // powers[i, j] = -P[j, i] off the diagonal, 0 on it; the observation is
    // their mean over j.
    for (int i = threadIdx.x; i < A; i += kThreads) {
      const float col = blocked_sum(A, [&](int j) {
        return j == i ? 0.f : -P[static_cast<size_t>(j) * A + i];
      });
      vec[V_FEAT * A + i] = mul(mul(col, inv_a), vec[V_INVMAX * A + i]);
    }
    __syncthreads();
    decide(g, vec, A, s, r, f_time);
    // |sum of the powers whose sign opposes out_i| (divide_power's total).
    for (int i = threadIdx.x; i < A; i += kThreads) {
      const float so = sgn(vec[V_OUT * A + i]);
      const float tot = blocked_sum(A, [&](int j) {
        const float pw = j == i ? 0.f : -P[static_cast<size_t>(j) * A + i];
        return so != sgn(pw) ? pw : 0.f;
      });
      vec[V_PGRID * A + i] = fabsf(tot);  // scratch: the totals
    }
    __syncthreads();
    // The split, in place: new[i, j] from old[j, i] and new[j, i] from
    // old[i, j], both by the thread that owns the pair.
    for (size_t k = threadIdx.x; k < AA; k += kThreads) {
      const int i = static_cast<int>(k / A), j = static_cast<int>(k % A);
      if (j < i) continue;
      const int ij[2][2] = {{i, j}, {j, i}};
      const float old_ij = P[k];
      const float old_ji = P[static_cast<size_t>(j) * A + i];
      float nv[2];
      for (int e = 0; e < (i == j ? 1 : 2); ++e) {
        const int a = ij[e][0];
        const float pw = i == j ? 0.f : -(e == 0 ? old_ji : old_ij);
        const float out = vec[V_OUT * A + a];
        const float total = vec[V_PGRID * A + a];
        const float filtered = sgn(out) != sgn(pw) ? pw : 0.f;
        nv[e] = total > 0.f ? __fdiv_rn(mul(out, fabsf(filtered)), total)
                            : mul(out, inv_a);
      }
      P[k] = nv[0];
      if (i != j) P[static_cast<size_t>(j) * A + i] = nv[1];
    }
    __syncthreads();
  }
  // clear_market on the final matrix (its diagonal as the split left it),
  // both row sums blocked as blocked_sum blocks them.
  for (int i = threadIdx.x; i < A; i += kThreads) {
    float grid = 0.f, peer = 0.f;
    for (int j0 = 0; j0 < A; j0 += 32) {
      const int j1 = min(A, j0 + 32);
      float grid_part = 0.f, peer_part = 0.f;
      for (int j = j0; j < j1; ++j) {
        const float pij = P[static_cast<size_t>(i) * A + j];
        const float pji = P[static_cast<size_t>(j) * A + i];
        float ex = 0.f;
        if (sgn(pij) != sgn(pji)) ex = mul(sgn(pij), fminf(fabsf(pij), fabsf(pji)));
        grid_part = add(grid_part, sub(pij, ex));
        peer_part = add(peer_part, ex);
      }
      grid = add(grid, grid_part);
      peer = add(peer, peer_part);
    }
    vec[V_PGRID * A + i] = grid;
    vec[V_PP2P * A + i] = peer;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads) slot_fused_kernel(const Args g) {
  extern __shared__ float smem[];
  const int s = blockIdx.x;
  const int S = g.n[I_S], A = g.n[I_A], R = g.n[I_R];
  float* vec = smem;
  float* red = smem + static_cast<size_t>(N_VEC) * A;
  const size_t base = static_cast<size_t>(s) * A;
  auto in = [&](int k) { return static_cast<const float*>(g.p[k]); };
  float* out = static_cast<float*>(g.p[P_OUT]);
  auto put = [&](int o, int i, float v) {
    out[(static_cast<size_t>(o) * S + s) * A + i] = v;
  };

  // Tariff (ops/tariff.py).
  const float f_time = in(P_TIME)[s];
  const float buy = mul(add(g.c[C_COST_AVG],
                            mul(g.c[C_COST_AMP],
                                sinf(sub(mul(f_time, g.c[C_FREQ]), g.c[C_PHASE])))),
                        g.c[C_INV_CENTS]);
  const float inj = g.c[C_INJECTION];
  const float trade = mul(0.5f, add(buy, inj));

  // Battery rule (ops/battery.py) and the slot's fixed features.
  for (int i = threadIdx.x; i < A; i += kThreads) {
    float balance = sub(in(P_LOAD)[base + i], in(P_PV)[base + i]);
    float soc = in(P_SOC)[base + i];
    if (g.n[I_BATTERY]) {
      const float energy = mul(balance, g.c[C_DT]);
      const float avail_e = mul(mul(fmaxf(sub(soc, g.c[C_MIN_SOC]), 0.f), g.c[C_CAPACITY]),
                                g.c[C_SQRT_EFF]);
      const float avail_s = mul(mul(fmaxf(sub(g.c[C_MAX_SOC], soc), 0.f), g.c[C_CAPACITY]),
                                g.c[C_INV_SQRT_EFF]);
      const float discharge = balance > 0.f ? min_nan(energy, avail_e) : 0.f;
      const float charge = balance < 0.f ? min_nan(-energy, avail_s) : 0.f;
      soc = sub(add(soc, mul(mul(charge, g.c[C_SQRT_EFF]), g.c[C_INV_CAP])),
                mul(discharge, g.c[C_INV_ETA_CAP]));
      balance = add(sub(balance, mul(discharge, g.c[C_INV_DT])), mul(charge, g.c[C_INV_DT]));
    }
    const float inv_max = 1.f / in(P_MAXIN)[i];
    put(O_SOC, i, soc);
    vec[V_BAL * A + i] = balance;
    vec[V_INVMAX * A + i] = inv_max;
    vec[V_NBAL * A + i] = mul(balance, inv_max);
    vec[V_NTEMP * A + i] = mul(sub(in(P_TIN)[base + i], g.c[C_SETPOINT]), g.c[C_INV_MARGIN]);
    vec[V_FEAT * A + i] = 0.f;
  }
  __syncthreads();

  // Negotiation and clearing.
  const int market = g.n[I_MARKET];
  if (market == kNoTrading) {
    decide(g, vec, A, s, 0, f_time);
    for (int i = threadIdx.x; i < A; i += kThreads) {
      vec[V_PGRID * A + i] = vec[V_OUT * A + i];
      vec[V_PP2P * A + i] = 0.f;
    }
    __syncthreads();
  } else if (market == kFactored) {
    decide(g, vec, A, s, 0, f_time);
    for (int i = threadIdx.x; i < A; i += kThreads) vec[V_OUT0 * A + i] = vec[V_OUT * A + i];
    __syncthreads();
    if (R == 1) {
      clear_rounds0(g, vec, A);
    } else {
      // Round 0's matrix is out0_i / A in every column, so the mean each
      // agent sees has a closed form.
      float part = 0.f;
      for (int i = threadIdx.x; i < A; i += kThreads) part = add(part, vec[V_OUT0 * A + i]);
      const float tot = block_sum(part, red);
      for (int i = threadIdx.x; i < A; i += kThreads) {
        const float mean_raw = mul(-sub(tot, vec[V_OUT0 * A + i]), g.c[C_INV_A2]);
        vec[V_FEAT * A + i] = mul(mean_raw, vec[V_INVMAX * A + i]);
      }
      __syncthreads();
      decide(g, vec, A, s, 1, f_time);
      clear_rounds1(g, vec, A, red);
    }
  } else {
    matrix_market(g, vec, A, s, f_time,
                  static_cast<float*>(g.p[P_WORK]) + static_cast<size_t>(s) * A * A);
  }

  // Settlement, reward and the thermal step (ops/market.py, ops/thermal.py).
  const float t_out = in(P_TOUT)[s];
  for (int i = threadIdx.x; i < A; i += kThreads) {
    const float p_grid = vec[V_PGRID * A + i];
    const float p_p2p = vec[V_PP2P * A + i];
    const float grid_cost = p_grid >= 0.f ? mul(p_grid, buy) : mul(p_grid, inj);
    const float cost = mul(mul(add(grid_cost, mul(p_p2p, trade)), g.c[C_SLOT_HOURS]), 1e-3f);
    const float t_in = in(P_TIN)[base + i];
    const float t_bm = in(P_TBM)[base + i];
    const float excess = fmaxf(fmaxf(sub(g.c[C_LOWER], t_in), 0.f),
                               fmaxf(sub(t_in, g.c[C_UPPER]), 0.f));
    const float penalty = excess > 0.f ? add(excess, 1.f) : 0.f;
    const float reward = -add(cost, mul(penalty, 10.f));
    const float frac = vec[V_FRAC * A + i];
    const float heat = mul(mul(frac, g.c[C_HP_MAX]), g.c[C_COP]);
    const float d_tin = mul(g.c[C_C_CI],
                            add(add(mul(sub(t_bm, t_in), g.c[C_INV_RI]),
                                    mul(sub(t_out, t_in), g.c[C_INV_RVENT])),
                                mul(heat, g.c[C_ONE_MINUS_FRAD])));
    const float d_tbm = mul(g.c[C_C_CM],
                            add(add(mul(sub(t_in, t_bm), g.c[C_INV_RI]),
                                    mul(sub(t_out, t_bm), g.c[C_INV_RE])),
                                mul(heat, g.c[C_FRAD])));
    put(O_TIN, i, add(t_in, mul(d_tin, g.c[C_DT])));
    put(O_TBM, i, add(t_bm, mul(d_tbm, g.c[C_DT])));
    put(O_FRAC, i, frac);
    put(O_COST, i, cost);
    put(O_REWARD, i, reward);
    put(O_PGRID, i, p_grid);
    put(O_PP2P, i, p_p2p);
    put(O_Q, i, vec[V_Q * A + i]);
    put(O_AUX, i, vec[V_AUX * A + i]);
    put(O_FTIME, i, f_time);
    put(O_FTEMP, i, vec[V_NTEMP * A + i]);
    put(O_FBAL, i, vec[V_NBAL * A + i]);
    put(O_FP2P, i, vec[V_FEAT * A + i]);
  }
}

size_t smem_bytes(int A) {
  return (static_cast<size_t>(N_VEC) * A + kThreads) * sizeof(float);
}

// Opts the kernel in to the device's whole dynamic shared memory per block
// (227 KB on sm_90), once per device.
cudaError_t opt_in_shared_memory() {
  constexpr int kMaxDevices = 64;
  static bool done[kMaxDevices] = {};
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < kMaxDevices && done[dev])) return err;
  err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(slot_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

}  // namespace

extern "C" int slot_fused_counts(int* n_ptr, int* n_const, int* n_int, int* n_out) {
  *n_ptr = N_PTR;
  *n_const = N_CONST;
  *n_int = N_INT;
  *n_out = N_OUT;
  return 0;
}

// Plain C entry point for ctypes: one launch of S blocks on `stream`; returns
// cudaGetLastError() (0 on success) and does not synchronise.
extern "C" int slot_fused_launch(const void* const* ptrs, int n_ptr, const float* consts,
                                 int n_const, const int* ints, int n_int,
                                 cudaStream_t stream) {
  if (n_ptr != N_PTR || n_const != N_CONST || n_int != N_INT)
    return static_cast<int>(cudaErrorInvalidValue);
  Args g;
  for (int k = 0; k < N_PTR; ++k) g.p[k] = const_cast<void*>(ptrs[k]);
  for (int k = 0; k < N_CONST; ++k) g.c[k] = consts[k];
  for (int k = 0; k < N_INT; ++k) g.n[k] = ints[k];
  const int S = g.n[I_S], A = g.n[I_A];
  if (S <= 0 || A <= 0 || g.n[I_R] <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = opt_in_shared_memory();
  if (err != cudaSuccess) return static_cast<int>(err);
  // A launch that needs more than the opt-in limit fails here, and its error
  // is returned.
  slot_fused_kernel<<<S, kThreads, smem_bytes(A), stream>>>(g);
  return static_cast<int>(cudaGetLastError());
}
