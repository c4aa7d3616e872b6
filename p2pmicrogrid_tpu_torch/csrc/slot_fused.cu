// Kernel K7: one whole training slot of S scenarios in one cooperative
// launch, for Hopper (sm_90a).
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
// What bounds it on this card (S = 64, A = 1000), and what the design does.
//
// * Every variant needs whole-scenario sums between its phases, so one
//   thread block per scenario (64 of 132 SMs busy) was the simple design.
//   Now one cooperative launch fills the card: the grid is as many blocks
//   as can be resident (the occupancy query times the SM count, capped at
//   the largest phase's work items), phases are separated by grid-wide
//   barriers (cooperative_groups::this_grid().sync()), and each phase hands
//   out work items over the whole grid. The per-agent vectors live in a
//   float32 scratch buffer [n_vectors, S, A] in device memory (a few MB,
//   which stays in L2). A phase that needs a whole scenario's vectors copies
//   them into its block's shared memory.
// * Factored clearing: operations, the merged min (about 7 per entry of each
//   scenario's A x A). Items are (scenario, tile of rows); a row's sum and
//   the column sum of the same index are split over the threads of the item
//   by tiles of 256 entries and added in order, with slot_ops.cuh's device
//   functions. K1 sums the same entries in another order (merged_min.cu),
//   so the two agree to rounding, not bit for bit.
// * DQN act: operations, S * A * R * 3 forwards of ~8.9 kFLOP in float32
//   (3.4 GFLOP per slot at rounds=1). A work item owns one agent: its 18 KB
//   of weights come once per round into shared memory by cp.async, double
//   buffered (the next agent's copy runs while this one computes), and the
//   [3 * 64, 64] x [64, 64] product over a chunk of 64 scenarios is register
//   tiled (6 rows x 8 hidden units per thread, no shuffles in the product;
//   3 per output row to finish the last layer's sum). It stays float32
//   on the CUDA cores: TF32 would flip argmax decisions against the
//   reference. The accumulation order is the one-warp-per-agent kernel's:
//   layer 0 fmaf over the 4 observations, then the action, then + bias;
//   layer 1 fmaf over k = 0..63; layer 2 the product pair (l, l + 32), then
//   the xor-butterfly's pairing tree 16, 8, 4, 2, 1.
// * Matrix negotiation: operations, an IEEE division per split (its fast
//   path is ~10 instructions; a zero numerator would take the slow path, so
//   it is not divided). The [A, A] proposal matrix never leaves the kernel,
//   so it is never stored: every entry has a closed form in per-agent
//   vectors,
//     N_0[i, j] = out_0[i] / A
//     N_r[i, j] = split(out_r[i], total_r[i], i == j ? 0 : -N_{r-1}[j, i])
//     split(o, t, pw) = t > 0 ? (o * |sgn(o) != sgn(pw) ? pw : 0|) / t : o / A
//   so the pair (N_r[i, j], N_r[j, i]) is a chain of r steps over the
//   vectors out_k and total_k of agents i and j. Round r >= 1 walks each
//   column i in blocks of 32 rows (the mean observation and, for each of
//   the three signs out_r[i] may take, the opposite-sign total, so one pass
//   serves both); in round 1 the terms do not depend on i, so whole blocks
//   are summed once per scenario. The clearing runs each unordered pair's
//   chain once, in tiles of 64 x 64 agents, and sums rows in blocks of 32.
//   At rounds=2 that is 3 splits per ordered pair, and no [S, A, A] buffer:
//   the clearing keeps 2 * ceil(A / 32) [S, A] planes of partial sums
//   (16 MB at S = 64, A = 1000).
//
// Learners. The Q-table [L, ...] and the DQN weights [L, ...] hold L
// learners: L = A, one learner for all S scenarios (the shared trainer), or
// L = S * A, one per (scenario, agent) (the independent trainer, the
// JAX package's vmap of the single fused slot over scenarios,
// pallas_slot.py:566): agent i of scenario s reads row s * A + i
// (I_PER_SCENARIO). Nothing else depends on it, and every sum runs within
// one scenario, so scenario s of a launch at [S, A] equals a launch at
// [1, A] with its learners bit for bit. The DQN act's work items are the
// learners: with one per scenario each item's chunk holds its one scenario.
//
// Rounding. Every product and sum of the chain is written with __fmul_rn /
// __fadd_rn / __fsub_rn, so nvcc cannot contract it into a fused
// multiply-add the chain does not do; divisions are IEEE divisions (no fast
// math); the constants come from the host as the chain rounds them. Sums
// over agents run in fixed orders of their own: the round-1 total of out_0
// and the factored weight totals as a 512-thread block's reduction tree
// (scenario_sum), the merged min by slot_ops.cuh's tile_sum, the matrix
// sums in blocks of 32. So
// the result is the same on every launch, whatever the grid, but may differ
// from torch.sum in the last bits.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <mutex>

#include "slot_ops.cuh"

namespace {

namespace cg = cooperative_groups;
using slot_ops::merged_min_entry;
using slot_ops::min_nan;
using slot_ops::tile_sum;

constexpr int kThreads = 256;
constexpr int kSumThreads = 512;  // the reduction tree the scenario sums keep
constexpr int kHidden = 64;       // the published DQN width (config.py DQNConfig)
constexpr int kObs = 4;
constexpr int kActions = 3;  // ACTION_VALUES = (0, 0.5, 1)
constexpr int kBlock = 32;  // blocked_sum's block of terms
constexpr int kPairTile = 2 * kBlock;  // agents on each side of a clearing tile
constexpr int kLevelFloats = 4;        // floats of one agent's staged level
constexpr int kTile = slot_ops::kMergedMinTile;
constexpr int kMaxGroups = 8;  // threads that share one row's blocks
constexpr unsigned kFull = 0xffffffffu;
// Shared memory starts with the block's reduction scratch.
constexpr int kRed = kThreads;

// The DQN act: a chunk of 64 scenarios of one agent, rows m = 3 * s + a of
// the layer-1 product; thread (row group rg, column group c) owns the rows
// 6 rg .. 6 rg + 5 (two scenarios) and the hidden units c, c + 8, ..., c + 56.
constexpr int kChunk = 64;
constexpr int kRows = kActions * kChunk;
constexpr int kRowsPerThread = 6;
constexpr int kColsPerThread = 8;
static_assert(kThreads / kColsPerThread * kRowsPerThread == kRows, "DQN tiling");
static_assert(kColsPerThread * kColsPerThread == kHidden, "DQN tiling");
// One agent's weights in shared memory: W1 [64, 64], W0 [5, 64], b0, b1, W2.
constexpr int kOffW0 = kHidden * kHidden;
constexpr int kOffB0 = kOffW0 + (kObs + 1) * kHidden;
constexpr int kOffB1 = kOffB0 + kHidden;
constexpr int kOffW2 = kOffB1 + kHidden;
constexpr int kWeights = kOffW2 + kHidden;
static_assert(kWeights % 4 == 0, "16-byte copies");

enum Market { kNoTrading = 0, kFactored = 1, kMatrix = 2 };
enum Policy { kTabular = 0, kDQN = 1 };

// Pointer, constant and integer arguments, in the order the Python wrapper
// (ops/slot_fused.py) passes them.
enum PtrArg {
  P_TIME, P_TOUT, P_LOAD, P_PV, P_TIN, P_TBM, P_SOC, P_HPFRAC, P_MAXIN,
  P_UNIFORM, P_RAND, P_EPS, P_QTABLE, P_W0, P_B0, P_W1, P_B1, P_W2, P_B2,
  P_OUT, P_DECISIONS, P_SCRATCH, N_PTR
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
  I_NT, I_NTP, I_NB, I_NP, I_NACT, I_PER_SCENARIO, N_INT
};

// The 14 [S, A] outputs, in the order of pallas_slot.py's kernel outputs.
enum Out {
  O_TIN, O_TBM, O_SOC, O_FRAC, O_COST, O_REWARD, O_PGRID, O_PP2P, O_Q, O_AUX,
  O_FTIME, O_FTEMP, O_FBAL, O_FP2P, N_OUT
};

// The scratch buffer's [S, A] vectors: V_CAND + c holds the opposite-sign
// total of round r for sign(out_r) = c - 1 (DQN matrix rounds); V_OUTK + r
// round r's net powers and V_OUTK + R + r its opposite-sign totals; then,
// for the matrix clearing, the grid and peer sums of each block of 32
// columns of each row (2 * ceil(A / 32) vectors).
enum Vec { V_BAL, V_NTEMP, V_NBAL, V_FEAT, V_FRAC, V_AUX, V_Q, V_CAND, V_OUTK = V_CAND + 3 };

__host__ __device__ constexpr int n_vectors(int R, int A, int market) {
  return V_OUTK + 2 * R + (market == kMatrix ? 2 * ((A + kBlock - 1) / kBlock) : 0);
}

struct Args {
  void* p[N_PTR];
  float c[N_CONST];
  int n[N_INT];
};

// How a pass over each index's blocks of `len` terms is split: `groups`
// threads share a row, an item owns `rows` rows of one scenario.
struct Tiling {
  int blocks, groups, rows, items_per_s;
};

__host__ __device__ inline Tiling tiling(int A, int len) {
  Tiling t;
  t.blocks = (A + len - 1) / len;
  const int m = t.blocks < kMaxGroups ? t.blocks : kMaxGroups;
  t.groups = 1;
  while (t.groups * 2 <= m) t.groups *= 2;
  t.rows = kThreads / t.groups;
  t.items_per_s = (A + t.rows - 1) / t.rows;
  return t;
}

// Floats of dynamic shared memory a launch needs: the largest of its phases.
__host__ __device__ inline size_t smem_floats(int A, int R, int policy, int market) {
  size_t need = 0;
  if (market == kFactored) {
    const Tiling t = tiling(A, kTile);
    need = 8 * static_cast<size_t>(A) + 2 * static_cast<size_t>(t.blocks) * t.rows;
  } else if (market == kMatrix) {
    const Tiling t = tiling(A, kBlock);
    need = kLevelFloats * static_cast<size_t>(R - 1) * A +
           4 * static_cast<size_t>(t.blocks) * (t.rows + 1);
    const size_t tile = 2 * kLevelFloats * static_cast<size_t>(R) * kPairTile +
                        2 * kPairTile * (kPairTile + 1);
    if (tile > need) need = tile;
  }
  if (policy == kDQN) {
    const size_t dqn = 2 * kWeights + kHidden * kRows + kObs * kChunk;
    if (dqn > need) need = dqn;
  }
  return kRed + need;
}

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

__device__ __forceinline__ const float* in(const Args& g, int k) {
  return static_cast<const float*>(g.p[k]);
}

// The scratch vector v, [S, A].
__device__ __forceinline__ float* vec(const Args& g, int v) {
  return static_cast<float*>(g.p[P_SCRATCH]) +
         static_cast<size_t>(v) * g.n[I_S] * g.n[I_A];
}

__device__ __forceinline__ size_t at(const Args& g, int s, int i) {
  return static_cast<size_t>(s) * g.n[I_A] + i;
}

// The learner of agent i of scenario s: its row of the Q-table or weights.
__device__ __forceinline__ size_t learner(const Args& g, int s, int i) {
  return g.n[I_PER_SCENARIO] ? at(g, s, i) : static_cast<size_t>(i);
}

// Sum of f(i) over i < A in the order of a 512-thread block: running sums
// of i = t, t + 512, ..., then a shared-memory tree. Each thread of this
// 256-thread block keeps the running sums of t and t + 256, which the tree's
// first level adds.
template <typename F>
__device__ __forceinline__ float scenario_sum(int A, F f, float* red) {
  float part[kSumThreads / kThreads];
#pragma unroll
  for (int u = 0; u < kSumThreads / kThreads; ++u) {
    float acc = 0.f;
    for (int i = threadIdx.x + u * kThreads; i < A; i += kSumThreads) acc = add(acc, f(i));
    part[u] = acc;
  }
  static_assert(kSumThreads == 2 * kThreads, "one level of the tree per thread");
  red[threadIdx.x] = add(part[0], part[1]);
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] = add(red[threadIdx.x], red[threadIdx.x + s]);
    __syncthreads();
  }
  const float r = red[0];
  __syncthreads();
  return r;
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

// The epsilon-greedy choice of agent i in round r of scenario s from its
// three Q-values: writes frac, aux, q, the round's heat-pump power into
// ``decisions`` and its net power into V_OUTK + r; returns the net power.
__device__ __forceinline__ float act_record(const Args& g, int s, int r, int i, const float* qv) {
  int action;
  float q;
  greedy3(qv, &action, &q);
  const int S = g.n[I_S], A = g.n[I_A];
  if (g.n[I_EXPLORE]) {
    const size_t k = (static_cast<size_t>(r) * S + s) * A + i;
    const float u = in(g, P_UNIFORM)[k];
    if (u < *in(g, P_EPS)) {
      action = static_cast<int>(static_cast<const long long*>(g.p[P_RAND])[k]);
      q = 0.f;
    }
  }
  const size_t k = at(g, s, i);
  const float frac = action_value(action);
  vec(g, V_FRAC)[k] = frac;
  vec(g, V_AUX)[k] = static_cast<float>(action);
  vec(g, V_Q)[k] = q;
  const float hp = mul(frac, g.c[C_HP_MAX]);
  static_cast<float*>(g.p[P_DECISIONS])[(static_cast<size_t>(s) * g.n[I_R] + r) * A + i] = hp;
  const float out = add(vec(g, V_BAL)[k], hp);
  vec(g, V_OUTK + r)[k] = out;
  return out;
}

// Tabular act of agent i in round r: the Q-row read in place.
__device__ __forceinline__ float act_tabular(const Args& g, int s, int r, int i, float feat) {
  const int nt = g.n[I_NT], ntp = g.n[I_NTP], nb = g.n[I_NB], np = g.n[I_NP];
  const size_t k = at(g, s, i);
  const float f_time = in(g, P_TIME)[s];
  const int ti = bin_of(mul(f_time, static_cast<float>(nt)), nt - 1);
  const float tp = add(mul(mul(add(vec(g, V_NTEMP)[k], 1.f), 0.5f), static_cast<float>(ntp - 2)), 1.f);
  const int tpi = bin_of(tp, ntp - 1);
  const int bi = bin_of(mul(mul(add(vec(g, V_NBAL)[k], 1.f), 0.5f), static_cast<float>(nb)), nb - 1);
  const int pi = bin_of(mul(mul(add(feat, 1.f), 0.5f), static_cast<float>(np)), np - 1);
  const size_t cell = (((learner(g, s, i) * nt + ti) * ntp + tpi) * nb + bi) * np + pi;
  const float* row = in(g, P_QTABLE) + cell * g.n[I_NACT];
  const float qv[kActions] = {row[0], row[1], row[2]};
  return act_record(g, s, r, i, qv);
}

// Settlement, reward and the thermal step of agent i of scenario s
// (ops/market.py, ops/thermal.py): writes its 13 outputs besides soc.
__device__ __forceinline__ void finish(const Args& g, int s, int i, float p_grid, float p_p2p) {
  const int S = g.n[I_S], A = g.n[I_A];
  const size_t k = at(g, s, i);
  float* out = static_cast<float*>(g.p[P_OUT]);
  auto put = [&](int o, float v) { out[static_cast<size_t>(o) * S * A + k] = v; };
  // Tariff (ops/tariff.py).
  const float f_time = in(g, P_TIME)[s];
  const float buy = mul(add(g.c[C_COST_AVG],
                            mul(g.c[C_COST_AMP],
                                sinf(sub(mul(f_time, g.c[C_FREQ]), g.c[C_PHASE])))),
                        g.c[C_INV_CENTS]);
  const float inj = g.c[C_INJECTION];
  const float trade = mul(0.5f, add(buy, inj));
  const float t_out = in(g, P_TOUT)[s];
  const float grid_cost = p_grid >= 0.f ? mul(p_grid, buy) : mul(p_grid, inj);
  const float cost = mul(mul(add(grid_cost, mul(p_p2p, trade)), g.c[C_SLOT_HOURS]), 1e-3f);
  const float t_in = in(g, P_TIN)[k];
  const float t_bm = in(g, P_TBM)[k];
  const float excess = fmaxf(fmaxf(sub(g.c[C_LOWER], t_in), 0.f),
                             fmaxf(sub(t_in, g.c[C_UPPER]), 0.f));
  const float penalty = excess > 0.f ? add(excess, 1.f) : 0.f;
  const float reward = -add(cost, mul(penalty, 10.f));
  const float frac = vec(g, V_FRAC)[k];
  const float heat = mul(mul(frac, g.c[C_HP_MAX]), g.c[C_COP]);
  const float d_tin = mul(g.c[C_C_CI],
                          add(add(mul(sub(t_bm, t_in), g.c[C_INV_RI]),
                                  mul(sub(t_out, t_in), g.c[C_INV_RVENT])),
                              mul(heat, g.c[C_ONE_MINUS_FRAD])));
  const float d_tbm = mul(g.c[C_C_CM],
                          add(add(mul(sub(t_in, t_bm), g.c[C_INV_RI]),
                                  mul(sub(t_out, t_bm), g.c[C_INV_RE])),
                              mul(heat, g.c[C_FRAD])));
  put(O_TIN, add(t_in, mul(d_tin, g.c[C_DT])));
  put(O_TBM, add(t_bm, mul(d_tbm, g.c[C_DT])));
  put(O_FRAC, frac);
  put(O_COST, cost);
  put(O_REWARD, reward);
  put(O_PGRID, p_grid);
  put(O_PP2P, p_p2p);
  put(O_Q, vec(g, V_Q)[k]);
  put(O_AUX, vec(g, V_AUX)[k]);
  put(O_FTIME, f_time);
  put(O_FTEMP, vec(g, V_NTEMP)[k]);
  put(O_FBAL, vec(g, V_NBAL)[k]);
  put(O_FP2P, vec(g, V_FEAT)[k]);
}

// Work items [first, last) of a phase's n items for this block: a
// contiguous range, so a block's items mostly share a scenario.
__device__ __forceinline__ void item_range(int n, int* first, int* last) {
  *first = static_cast<int>(static_cast<long long>(blockIdx.x) * n / gridDim.x);
  *last = static_cast<int>(static_cast<long long>(blockIdx.x + 1) * n / gridDim.x);
}

// --- phase: battery rule and features (items: scenario x tile of agents) ------

template <int kPolicy>
__device__ __forceinline__ void phase_prep(const Args& g) {
  const int S = g.n[I_S], A = g.n[I_A];
  const int tiles = (A + kThreads - 1) / kThreads;
  float* out = static_cast<float*>(g.p[P_OUT]);
  for (int item = blockIdx.x; item < S * tiles; item += gridDim.x) {
    const int s = item / tiles, i = (item % tiles) * kThreads + threadIdx.x;
    if (i >= A) continue;
    const size_t k = at(g, s, i);
    // Battery rule (ops/battery.py).
    float balance = sub(in(g, P_LOAD)[k], in(g, P_PV)[k]);
    float soc = in(g, P_SOC)[k];
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
    out[static_cast<size_t>(O_SOC) * S * A + k] = soc;
    vec(g, V_BAL)[k] = balance;
    vec(g, V_NBAL)[k] = mul(balance, 1.f / in(g, P_MAXIN)[i]);
    vec(g, V_NTEMP)[k] = mul(sub(in(g, P_TIN)[k], g.c[C_SETPOINT]), g.c[C_INV_MARGIN]);
    vec(g, V_FEAT)[k] = 0.f;
    if constexpr (kPolicy == kTabular) {
      const float o = act_tabular(g, s, 0, i, 0.f);
      if (g.n[I_MARKET] == kNoTrading) finish(g, s, i, o, 0.f);
    }
  }
}

// --- phase: the DQN act of round r (items: agents) -----------------------------

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Starts the copy of learner l's weights (flax's layout: kernels [L, in,
// out], biases [L, out]) into buf, as one commit group.
__device__ __forceinline__ void load_weights(const Args& g, int l, float* buf) {
  const float* src[5] = {
      in(g, P_W1) + static_cast<size_t>(l) * kHidden * kHidden,
      in(g, P_W0) + static_cast<size_t>(l) * (kObs + 1) * kHidden,
      in(g, P_B0) + static_cast<size_t>(l) * kHidden,
      in(g, P_B1) + static_cast<size_t>(l) * kHidden,
      in(g, P_W2) + static_cast<size_t>(l) * kHidden,
  };
  const int off[6] = {0, kOffW0, kOffB0, kOffB1, kOffW2, kWeights};
#pragma unroll
  for (int p = 0; p < 5; ++p) {
    for (int c = threadIdx.x; c < (off[p + 1] - off[p]) / 4; c += kThreads)
      cp_async16(buf + off[p] + 4 * c, src[p] + 4 * c);
  }
  cp_async_commit();
}

__device__ __forceinline__ int cand_index(float out) {
  const float so = sgn(out);
  return so > 0.f ? 2 : (so < 0.f ? 0 : 1);  // NaN counts as 0: same total
}

__device__ __forceinline__ void phase_act_dqn(const Args& g, float* smem, int r) {
  const int S = g.n[I_S], A = g.n[I_A];
  const int market = g.n[I_MARKET];
  float* wbuf = smem + kRed;                // [2][kWeights]
  float* h0 = wbuf + 2 * kWeights;          // [kHidden][kRows]
  float* xs = h0 + kHidden * kRows;         // [kObs][kChunk]
  const int lane = threadIdx.x & 31;
  const int col = lane & (kColsPerThread - 1);
  const int rg = (threadIdx.x >> 5) * (32 / kColsPerThread) + (lane >> 3);
  // Work items are learners: learner l is agent i over the scenarios
  // [s_lo, s_hi), all S with a shared learner, its own one otherwise.
  const bool per_scenario = g.n[I_PER_SCENARIO];
  const int n_learners = per_scenario ? S * A : A;
  int buf = 0;
  if (blockIdx.x < n_learners) load_weights(g, blockIdx.x, wbuf);
  for (int l = blockIdx.x; l < n_learners; l += gridDim.x) {
    const int next = l + gridDim.x;
    if (next < n_learners) {
      load_weights(g, next, wbuf + (buf ^ 1) * kWeights);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int i = per_scenario ? l % A : l;
    const int s_lo = per_scenario ? l / A : 0;
    const int s_hi = per_scenario ? s_lo + 1 : S;
    const float* w = wbuf + buf * kWeights;
    const float b2 = in(g, P_B2)[l];
    for (int c0 = s_lo; c0 < s_hi; c0 += kChunk) {
      if (threadIdx.x < kChunk) {
        const int s = c0 + threadIdx.x;
        const bool ok = s < s_hi;
        const size_t k = ok ? at(g, s, i) : 0;
        xs[0 * kChunk + threadIdx.x] = ok ? in(g, P_TIME)[s] : 0.f;
        xs[1 * kChunk + threadIdx.x] = ok ? vec(g, V_NTEMP)[k] : 0.f;
        xs[2 * kChunk + threadIdx.x] = ok ? vec(g, V_NBAL)[k] : 0.f;
        xs[3 * kChunk + threadIdx.x] = ok ? vec(g, V_FEAT)[k] : 0.f;
      }
      __syncthreads();
      // Layer 0: h0[k][3 s + a] = relu(x . W0[:4, k] + a_value * W0[4, k] + b0[k]).
      {
        const int sl = threadIdx.x % kChunk;
        for (int k = threadIdx.x / kChunk; k < kHidden; k += kThreads / kChunk) {
          float base = 0.f;
#pragma unroll
          for (int d = 0; d < kObs; ++d) base = fmaf(xs[d * kChunk + sl], w[kOffW0 + d * kHidden + k], base);
          const float wa = w[kOffW0 + kObs * kHidden + k];
          const float bias = w[kOffB0 + k];
#pragma unroll
          for (int a = 0; a < kActions; ++a)
            h0[k * kRows + sl * kActions + a] = fmaxf(add(fmaf(action_value(a), wa, base), bias), 0.f);
        }
      }
      __syncthreads();
      // Layer 1: acc[row][t] = sum over k in order of h0[k][row] * W1[k][col + 8 t].
      float acc[kRowsPerThread][kColsPerThread];
#pragma unroll
      for (int m = 0; m < kRowsPerThread; ++m)
#pragma unroll
        for (int t = 0; t < kColsPerThread; ++t) acc[m][t] = 0.f;
      const float* hp = h0 + rg * kRowsPerThread;
      const float* w1 = w + col;
#pragma unroll 2
      for (int k = 0; k < kHidden; ++k) {
        const float2 a0 = *reinterpret_cast<const float2*>(hp + k * kRows);
        const float2 a1 = *reinterpret_cast<const float2*>(hp + k * kRows + 2);
        const float2 a2 = *reinterpret_cast<const float2*>(hp + k * kRows + 4);
        const float hv[kRowsPerThread] = {a0.x, a0.y, a1.x, a1.y, a2.x, a2.y};
        float wv[kColsPerThread];
#pragma unroll
        for (int t = 0; t < kColsPerThread; ++t) wv[t] = w1[k * kHidden + kColsPerThread * t];
#pragma unroll
        for (int m = 0; m < kRowsPerThread; ++m)
#pragma unroll
          for (int t = 0; t < kColsPerThread; ++t) acc[m][t] = fmaf(hv[m], wv[t], acc[m][t]);
      }
      // Layer 2: p[l] = h1[l + 32] W2[l + 32] + h1[l] W2[l] for l < 32, then
      // the pairing tree (l, l + 16), (l, l + 8), (l, l + 4), (l, l + 2),
      // (l, l + 1): this thread holds l = col, col + 8, col + 16, col + 24;
      // the last three levels pair the 8 column groups of a row by shuffle.
      float q[kRowsPerThread];
#pragma unroll
      for (int m = 0; m < kRowsPerThread; ++m) {
        float h1[kColsPerThread];
#pragma unroll
        for (int t = 0; t < kColsPerThread; ++t)
          h1[t] = fmaxf(add(acc[m][t], w[kOffB1 + col + kColsPerThread * t]), 0.f);
        float p[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          p[u] = fmaf(h1[u + 4], w[kOffW2 + col + kColsPerThread * u + 32],
                      mul(h1[u], w[kOffW2 + col + kColsPerThread * u]));
        float v = add(add(p[0], p[2]), add(p[1], p[3]));
        v = add(v, __shfl_xor_sync(kFull, v, 4));
        v = add(v, __shfl_xor_sync(kFull, v, 2));
        v = add(v, __shfl_xor_sync(kFull, v, 1));
        q[m] = add(v, b2);
      }
      if (col == 0) {
#pragma unroll
        for (int e = 0; e < kRowsPerThread / kActions; ++e) {
          const int s = c0 + rg * (kRowsPerThread / kActions) + e;
          if (s < s_hi) {
            const float o = act_record(g, s, r, i, q + kActions * e);
            const size_t k = at(g, s, i);
            if (market == kMatrix && r > 0) {
              vec(g, V_OUTK + g.n[I_R] + r)[k] = fabsf(vec(g, V_CAND + cand_index(o))[k]);
            } else if (market == kNoTrading) {
              finish(g, s, i, o, 0.f);
            }
          }
        }
      }
      __syncthreads();
    }
    buf ^= 1;
  }
}

// --- phase: the factored round-1 mean feature (items: scenario x tile) --------

template <int kPolicy>
__device__ __forceinline__ void phase_mean_feature(const Args& g, float* red) {
  const int S = g.n[I_S], A = g.n[I_A];
  const int tiles = (A + kThreads - 1) / kThreads;
  for (int item = blockIdx.x; item < S * tiles; item += gridDim.x) {
    const int s = item / tiles, i = (item % tiles) * kThreads + threadIdx.x;
    // Round 0's matrix is out0_i / A in every column, so the mean each agent
    // sees has a closed form.
    const float* o = vec(g, V_OUTK) + at(g, s, 0);
    const float tot = scenario_sum(A, [&](int j) { return o[j]; }, red);
    if (i < A) {
      const float mean_raw = mul(-sub(tot, o[i]), g.c[C_INV_A2]);
      const float feat = mul(mean_raw, 1.f / in(g, P_MAXIN)[i]);
      vec(g, V_FEAT)[at(g, s, i)] = feat;
      if constexpr (kPolicy == kTabular) act_tabular(g, s, 1, i, feat);
    }
  }
}

// --- phase: factored clearing (items: scenario x tile of rows) -----------------

// ops/factored_market.py::clear_factored_rounds0 (R = 1, on out_0) or
// clear_factored_rounds1 (R = 2, out_0 and out_1): the merged min's row and
// column sums in tile_sum's order (slot_ops.cuh), then _settle, then the
// agent's outputs.
__device__ __forceinline__ void phase_merged_min(const Args& g, float* smem) {
  const int S = g.n[I_S], A = g.n[I_A], R = g.n[I_R];
  const float inv_a = g.c[C_INV_A];
  const bool bf16 = g.n[I_BF16];
  const Tiling t = tiling(A, kTile);
  // Each agent's factors as a row (alpha, wminus, pb) and as a column
  // (wplus, gamma, ps), one 16-byte load each.
  float* red = smem;
  float4* fr = reinterpret_cast<float4*>(smem + kRed);
  float4* fc = fr + A;
  float* prow = reinterpret_cast<float*>(fc + A);  // [blocks][rows]
  float* pcol = prow + t.blocks * t.rows;          // [blocks][rows]
  int first, last;
  item_range(S * t.items_per_s, &first, &last);
  int staged = -1;
  for (int item = first; item < last; ++item) {
    const int s = item / t.items_per_s, it = item % t.items_per_s;
    const float* b0 = vec(g, V_OUTK) + at(g, s, 0);
    const float* b1 = vec(g, V_OUTK + R - 1) + at(g, s, 0);
    if (s != staged) {
      float sp = 0.f, sn = 0.f;
      if (R == 2) {
        sp = scenario_sum(A, [&](int j) { return fmaxf(b0[j], 0.f); }, red);
        sn = scenario_sum(A, [&](int j) { return fmaxf(-b0[j], 0.f); }, red);
      }
      for (int j = threadIdx.x; j < A; j += kThreads) {
        const float x0 = b0[j];
        if (R == 1) {
          float a_e = x0 > 0.f ? mul(fabsf(x0), inv_a) : 0.f;
          float g_e = x0 < 0.f ? mul(fabsf(x0), inv_a) : 0.f;
          if (bf16) {
            a_e = round_bf16(a_e);
            g_e = round_bf16(g_e);
          }
          fr[j] = make_float4(a_e, 0.f, 0.f, 0.f);
          fc[j] = make_float4(0.f, g_e, 0.f, 0.f);
        } else {
          const float x1 = b1[j];
          float wplus = fmaxf(x0, 0.f);
          float wminus = fmaxf(-x0, 0.f);
          const bool buyer = x1 > 0.f, seller = x1 < 0.f;
          const float opp = buyer ? sub(sp, wplus) : (seller ? sub(sn, wminus) : 0.f);
          const bool prop = opp > 0.f;
          const float absb1 = fabsf(x1);
          const float scaled = prop ? __fdiv_rn(absb1, opp) : mul(absb1, inv_a);
          float alpha = buyer ? scaled : 0.f;
          float gamma = seller ? scaled : 0.f;
          if (bf16) {
            alpha = round_bf16(alpha);
            wplus = round_bf16(wplus);
            wminus = round_bf16(wminus);
            gamma = round_bf16(gamma);
          }
          fr[j] = make_float4(alpha, wminus, (buyer && prop) ? 1.f : 0.f, 0.f);
          fc[j] = make_float4(wplus, gamma, (seller && prop) ? 1.f : 0.f, 0.f);
        }
      }
      staged = s;
    }
    __syncthreads();
    const int r = threadIdx.x % t.rows, grp = threadIdx.x / t.rows;
    const int i = it * t.rows + r;
    if (i < A) {
      const float4 ri = fr[i], ci = fc[i];
      for (int jt = grp; jt < t.blocks; jt += t.groups) {
        const int j0 = jt * kTile, n = min(kTile, A - j0);
        prow[jt * t.rows + r] = tile_sum(n, [&](int u) {
          const float4 cj = fc[j0 + u];
          return merged_min_entry(ri.x, ri.y, ri.z, cj.x, cj.y, cj.z);
        });
        pcol[jt * t.rows + r] = tile_sum(n, [&](int u) {
          const float4 rj = fr[j0 + u];
          return merged_min_entry(rj.x, rj.y, rj.z, ci.x, ci.y, ci.z);
        });
      }
    }
    __syncthreads();
    if (grp == 0 && i < A) {
      float row = 0.f, colsum = 0.f;
      for (int jt = 0; jt < t.blocks; ++jt) {
        row = add(row, prow[jt * t.rows + r]);
        colsum = add(colsum, pcol[jt * t.rows + r]);
      }
      // _settle: p_p2p = buyer ? row : (seller ? -col : 0), p_grid = b - p_p2p.
      const float b = b1[i];
      const float p2p = b > 0.f ? row : (b < 0.f ? -colsum : 0.f);
      finish(g, s, i, sub(b, p2p), p2p);
    }
    __syncthreads();
  }
}

// --- the matrix negotiation, matrix-free ------------------------------------------

// The chain reads staged levels. For a set of n agents, agent a's level k
// is four floats: out_k at L[4 k n + a], total_k at L[(4 k + 1) n + a], and
// the bounds [lo, hi] of the values whose sign equals sgn(out_k) at
// L[(4 k + 2) n + a] and L[(4 k + 3) n + a]: (0, inf] for a positive out,
// [-inf, 0) for a negative one, [-0, +0] for zero, and none (NaN) for NaN.

struct Level {
  float o, t, lo, hi;
};

__device__ __forceinline__ Level level(const float* L, int n, int k, int a) {
  const float* p = L + kLevelFloats * k * n + a;
  return {p[0], p[n], p[2 * n], p[3 * n]};
}

// Stores agent a's level (o, t) into L.
__device__ __forceinline__ void put_level(float* L, int n, int k, int a, float o, float t) {
  const float least = __int_as_float(1);  // the least positive float
  float* p = L + kLevelFloats * k * n + a;
  p[0] = o;
  p[n] = t;
  p[2 * n] = o > 0.f ? least : (o < 0.f ? -INFINITY : (o == 0.f ? -0.f : o));
  p[3 * n] = o > 0.f ? INFINITY : (o < 0.f ? -least : (o == 0.f ? 0.f : o));
}

// divide_power's split of agent level l for one counterparty's proposal pw:
// sgn(o) != sgn(pw) is pw outside [lo, hi]. Branch-free, so a warp's lanes
// do not diverge: the division runs on 1 / 1 where its result is not taken.
// A zero numerator (the signs agree) divided by a positive total is itself,
// sign included, so it is not divided: the division's range check would
// send a zero to its slow path.
__device__ __forceinline__ float split(const Level& l, float pw, float inv_a) {
  const float filtered = (pw >= l.lo && pw <= l.hi) ? 0.f : pw;
  const float num = mul(l.o, fabsf(filtered));
  const bool divide = l.t > 0.f && num != 0.f;
  const float q = __fdiv_rn(divide ? num : 1.f, divide ? l.t : 1.f);
  return l.t > 0.f ? (divide ? q : num) : mul(l.o, inv_a);
}

// Copies scenario s's levels k < levels into shared memory (a set of A).
__device__ __forceinline__ void stage_levels(const Args& g, int s, int levels, float* L) {
  const int A = g.n[I_A], R = g.n[I_R];
  for (int k = 0; k < levels; ++k) {
    const float* o = vec(g, V_OUTK + k) + at(g, s, 0);
    const float* t = vec(g, V_OUTK + R + k) + at(g, s, 0);
    for (int j = threadIdx.x; j < A; j += kThreads)
      put_level(L, A, k, j, o[j], k > 0 ? t[j] : 0.f);  // round 0 splits equally
  }
}

// N_m[a, b] for a != b, a and b of the same staged set.
__device__ __forceinline__ float chain_entry(const float* L, int n, int m, int a, int b,
                                             float inv_a) {
  const float x0 = mul(L[a], inv_a);
  if (m == 0) return x0;
  float x = x0, y = mul(L[b], inv_a);
  for (int k = 1; k < m; ++k) {
    const float nx = split(level(L, n, k, a), -y, inv_a);
    const float ny = split(level(L, n, k, b), -x, inv_a);
    x = nx;
    y = ny;
  }
  return split(level(L, n, m, a), -y, inv_a);
}

// (N_m[a, b], N_m[b, a]) for agent a of the set La and agent b of the set
// Lb, each of n agents; on the diagonal (the same agent) the split saw a
// zero proposal.
__device__ __forceinline__ void chain_pair(const float* La, int a, const float* Lb, int b, int n,
                                           int m, bool diagonal, float inv_a, float* ab,
                                           float* ba) {
  if (diagonal) {
    *ab = *ba = m == 0 ? mul(La[a], inv_a) : split(level(La, n, m, a), 0.f, inv_a);
    return;
  }
  float x = mul(La[a], inv_a), y = mul(Lb[b], inv_a);
  for (int k = 1; k <= m; ++k) {
    const float nx = split(level(La, n, k, a), -y, inv_a);
    const float ny = split(level(Lb, n, k, b), -x, inv_a);
    x = nx;
    y = ny;
  }
  *ab = x;
  *ba = y;
}

// The four sums of column i's terms pw = -N_m[j, i] over the rows j of
// block jb (0 at j == i): the mean observation's, and divide_power's
// opposite-sign total's for sign(out_r[i]) = -1, 0 and 1, which keeps pw
// where sgn(pw) differs: pw not below 0, not 0, not above 0.
__device__ __forceinline__ void column_block(const float* L, int A, int m, int i, int jb,
                                             float inv_a, float* sums) {
  const int j1 = min(A, (jb + 1) * kBlock);
  float f = 0.f, c0 = 0.f, c1 = 0.f, c2 = 0.f;
#pragma unroll 4
  for (int j = jb * kBlock; j < j1; ++j) {
    const float pw = j == i ? 0.f : -chain_entry(L, A, m, j, i, inv_a);
    f = add(f, pw);
    c0 = add(c0, pw < 0.f ? 0.f : pw);
    c1 = add(c1, pw == 0.f ? 0.f : pw);
    c2 = add(c2, pw > 0.f ? 0.f : pw);
  }
  sums[0] = f;
  sums[1] = c0;
  sums[2] = c1;
  sums[3] = c2;
}

// Round r >= 1 (items: scenario x tile of columns i): column i's four sums
// over j != i, in blocks of 32 added in order. The tabular act then decides
// and keeps its total; the DQN act, a phase later. In round 1 the terms
// -out_0[j] / A do not depend on i, so a block that does not hold row i has
// the same sums for every column: they are summed once per scenario.
template <int kPolicy>
__device__ __forceinline__ void phase_matrix_round(const Args& g, float* smem, int r) {
  const int S = g.n[I_S], A = g.n[I_A], R = g.n[I_R];
  const float inv_a = g.c[C_INV_A];
  const Tiling t = tiling(A, kBlock);
  float* outs = smem + kRed;                     // levels 0 .. r - 1
  float* parts = outs + kLevelFloats * (R - 1) * A;  // [4][blocks][rows]
  const int plane = t.blocks * t.rows;
  float* whole = parts + 4 * plane;  // [4][blocks]: round 1's sums of whole blocks
  int first, last;
  item_range(S * t.items_per_s, &first, &last);
  int staged = -1;
  for (int item = first; item < last; ++item) {
    const int s = item / t.items_per_s, it = item % t.items_per_s;
    if (s != staged) {
      __syncthreads();
      stage_levels(g, s, r, outs);
      if (r == 1) {
        __syncthreads();
        for (int jb = threadIdx.x; jb < t.blocks; jb += kThreads) {
          float sums[4];
          column_block(outs, A, 0, -1, jb, inv_a, sums);
#pragma unroll
          for (int q = 0; q < 4; ++q) whole[q * t.blocks + jb] = sums[q];
        }
      }
      staged = s;
    }
    __syncthreads();
    const int row = threadIdx.x % t.rows, grp = threadIdx.x / t.rows;
    const int i = it * t.rows + row;
    if (i < A) {
      for (int jb = grp; jb < t.blocks; jb += t.groups) {
        float sums[4];
        if (r == 1 && jb != i / kBlock) {
#pragma unroll
          for (int q = 0; q < 4; ++q) sums[q] = whole[q * t.blocks + jb];
        } else {
          column_block(outs, A, r - 1, i, jb, inv_a, sums);
        }
        const int o = jb * t.rows + row;
#pragma unroll
        for (int q = 0; q < 4; ++q) parts[q * plane + o] = sums[q];
      }
    }
    __syncthreads();
    if (grp == 0 && i < A) {
      float f = 0.f, c[3] = {0.f, 0.f, 0.f};
      for (int jb = 0; jb < t.blocks; ++jb) {
        const int o = jb * t.rows + row;
        f = add(f, parts[o]);
#pragma unroll
        for (int q = 0; q < 3; ++q) c[q] = add(c[q], parts[(q + 1) * plane + o]);
      }
      const size_t k = at(g, s, i);
      const float feat = mul(mul(f, inv_a), 1.f / in(g, P_MAXIN)[i]);
      vec(g, V_FEAT)[k] = feat;
      if constexpr (kPolicy == kTabular) {
        const float o = act_tabular(g, s, r, i, feat);
        vec(g, V_OUTK + R + r)[k] = fabsf(c[cand_index(o)]);
      } else {
#pragma unroll
        for (int q = 0; q < 3; ++q) vec(g, V_CAND + q)[k] = c[q];
      }
    }
  }
}

// ops/market.py::clear_market on N_{R-1}, pass 1 (items: scenario x tile
// pair IB <= JB of 64-agent blocks): each unordered pair's chain runs once,
// for (N[i, j], N[j, i]); then row i's grid and peer sums over each block of
// 32 columns j of the tile, and (off the diagonal) row j's over each block
// of 32 rows i, each summed in order into the scratch parts.
__device__ __forceinline__ void phase_matrix_clear_tiles(const Args& g, float* smem) {
  const int S = g.n[I_S], A = g.n[I_A], R = g.n[I_R];
  const float inv_a = g.c[C_INV_A];
  constexpr int kT = kPairTile, kLd = kPairTile + 1;
  const int nt = (A + kT - 1) / kT;
  const int per_s = nt * (nt + 1) / 2;
  const int nb = (A + kBlock - 1) / kBlock;
  float* la = smem + kRed;                 // levels of the tile's rows i
  float* lb = la + kLevelFloats * R * kT;  // levels of its columns j
  float* P = lb + kLevelFloats * R * kT;   // [kT][kLd]: N[i, j]
  float* Q = P + kT * kLd;      // [kT][kLd]: N[j, i]
  float* grid_parts = vec(g, V_OUTK + 2 * R);
  float* peer_parts = vec(g, V_OUTK + 2 * R + nb);
  const size_t plane = static_cast<size_t>(S) * A;
  int first, last;
  item_range(S * per_s, &first, &last);
  for (int item = first; item < last; ++item) {
    const int s = item / per_s;
    int tt = item % per_s, ib = 0;
    while (tt >= nt - ib) {
      tt -= nt - ib;
      ++ib;
    }
    const int i0 = ib * kT, j0 = (ib + tt) * kT;
    const bool diagonal_tile = tt == 0;
    __syncthreads();  // the previous item's readers are done
    for (int u = threadIdx.x; u < 2 * R * kT; u += kThreads) {
      const int side = u / (R * kT), k = (u / kT) % R, a = u % kT;
      const int agent = (side == 0 ? i0 : j0) + a;
      const bool real = agent < A;
      const float o = real ? vec(g, V_OUTK + k)[at(g, s, agent)] : 0.f;
      const float t = real && k > 0 ? vec(g, V_OUTK + R + k)[at(g, s, agent)] : 0.f;
      put_level(side == 0 ? la : lb, kT, k, a, o, t);
    }
    __syncthreads();
#pragma unroll 4
    for (int u = threadIdx.x; u < kT * kT; u += kThreads) {
      const int a = u / kT, b = u % kT;
      float nij = 0.f, nji = 0.f;
      if (i0 + a < A && j0 + b < A)
        chain_pair(la, a, lb, b, kT, R - 1, i0 + a == j0 + b, inv_a, &nij, &nji);
      P[a * kLd + b] = nij;
      Q[a * kLd + b] = nji;
    }
    __syncthreads();
    // Threads 0..127: row i = i0 + (t % 64) over the column block (t / 64);
    // threads 128..255, off the diagonal: row j = j0 + (t % 64) over the row
    // block (t / 64) - 2.
    const int side = threadIdx.x / (2 * kT);
    const int own = threadIdx.x % kT;
    const int other0 = (side == 0 ? j0 : i0) + ((threadIdx.x / kT) % 2) * kBlock;
    const int row = (side == 0 ? i0 : j0) + own;
    const int n = min(kBlock, A - other0);
    if ((side == 0 || !diagonal_tile) && row < A && n > 0) {
      const int e0 = other0 - (side == 0 ? j0 : i0);
      float grid_part = 0.f, peer_part = 0.f;
      for (int q = 0; q < n; ++q) {
        const int o = side == 0 ? own * kLd + e0 + q : (e0 + q) * kLd + own;
        const float pij = side == 0 ? P[o] : Q[o];
        const float pji = side == 0 ? Q[o] : P[o];
        float ex = 0.f;
        if (sgn(pij) != sgn(pji)) ex = mul(sgn(pij), fminf(fabsf(pij), fabsf(pji)));
        grid_part = add(grid_part, sub(pij, ex));
        peer_part = add(peer_part, ex);
      }
      const size_t k = static_cast<size_t>(other0 / kBlock) * plane + at(g, s, row);
      grid_parts[k] = grid_part;
      peer_parts[k] = peer_part;
    }
  }
}

// clear_market, pass 2 (items: scenario x tile of agents): row i's grid and
// peer sums, its blocks of 32 added in order, then the agent's outputs.
__device__ __forceinline__ void phase_matrix_clear_sums(const Args& g) {
  const int S = g.n[I_S], A = g.n[I_A], R = g.n[I_R];
  const int nb = (A + kBlock - 1) / kBlock;
  const float* grid_parts = vec(g, V_OUTK + 2 * R);
  const float* peer_parts = vec(g, V_OUTK + 2 * R + nb);
  const size_t plane = static_cast<size_t>(S) * A;
  const int tiles = (A + kThreads - 1) / kThreads;
  for (int item = blockIdx.x; item < S * tiles; item += gridDim.x) {
    const int s = item / tiles, i = (item % tiles) * kThreads + threadIdx.x;
    if (i >= A) continue;
    const size_t k = at(g, s, i);
    float grid = 0.f, peer = 0.f;
    for (int jb = 0; jb < nb; ++jb) {
      grid = add(grid, grid_parts[jb * plane + k]);
      peer = add(peer, peer_parts[jb * plane + k]);
    }
    finish(g, s, i, grid, peer);
  }
}

// --- the kernel --------------------------------------------------------------------

template <int kPolicy>
__global__ void __launch_bounds__(kThreads, kPolicy == kDQN ? 2 : 4)
slot_fused_kernel(const __grid_constant__ Args g) {
  extern __shared__ __align__(16) float smem[];
  cg::grid_group grid = cg::this_grid();
  const int market = g.n[I_MARKET], R = g.n[I_R];
  phase_prep<kPolicy>(g);
  if constexpr (kPolicy == kDQN) {
    grid.sync();
    phase_act_dqn(g, smem, 0);
  }
  if (market == kNoTrading) return;
  grid.sync();
  if (market == kFactored) {
    if (R == 2) {
      phase_mean_feature<kPolicy>(g, smem);
      grid.sync();
      if constexpr (kPolicy == kDQN) {
        phase_act_dqn(g, smem, 1);
        grid.sync();
      }
    }
    phase_merged_min(g, smem);
  } else {
    for (int r = 1; r < R; ++r) {
      phase_matrix_round<kPolicy>(g, smem, r);
      grid.sync();
      if constexpr (kPolicy == kDQN) {
        phase_act_dqn(g, smem, r);
        grid.sync();
      }
    }
    phase_matrix_clear_tiles(g, smem);
    grid.sync();
    phase_matrix_clear_sums(g);
  }
}

// The most work items any phase of a launch hands out: a larger grid would
// leave blocks without work in every phase and only slow the barriers.
int max_items(int S, int A, int policy, int market, int per_scenario) {
  long long n = static_cast<long long>(S) * ((A + kThreads - 1) / kThreads);
  auto at_least = [&n](long long m) { n = m > n ? m : n; };
  if (policy == kDQN) at_least(per_scenario ? static_cast<long long>(S) * A : A);
  if (market == kFactored) at_least(static_cast<long long>(S) * tiling(A, kTile).items_per_s);
  if (market == kMatrix) {
    const int nt = (A + kPairTile - 1) / kPairTile;
    at_least(static_cast<long long>(S) * tiling(A, kBlock).items_per_s);
    at_least(static_cast<long long>(S) * nt * (nt + 1) / 2);
  }
  return n < (1 << 30) ? static_cast<int>(n) : (1 << 30);
}

// Opts the kernel in to the device's whole dynamic shared memory per block
// (227 KB on sm_90) and the largest shared-memory carveout, once per device.
template <int kPolicy>
cudaError_t opt_in(int dev) {
  constexpr int kMaxDevices = 64;
  static bool done[kMaxDevices] = {};
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  int limit = 0;
  cudaError_t err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(slot_fused_kernel<kPolicy>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(slot_fused_kernel<kPolicy>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

// The cooperative grid on the current device: as many blocks as fit at
// once, or as the largest phase has work items if fewer. grid gets (blocks,
// blocks per SM, SMs, shared memory bytes per block).
template <int kPolicy>
cudaError_t query_grid(int dev, int S, int A, int R, int market, int per_scenario, int* grid) {
  int coop = 0, sms = 0, limit = 0, per_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = opt_in<kPolicy>(dev);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  const size_t smem = smem_floats(A, R, kPolicy, market) * sizeof(float);
  if (smem > static_cast<size_t>(limit)) return cudaErrorInvalidValue;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, slot_fused_kernel<kPolicy>,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int most = max_items(S, A, kPolicy, market, per_scenario);
  grid[0] = per_sm * sms < most ? per_sm * sms : most;
  grid[1] = per_sm;
  grid[2] = sms;
  grid[3] = static_cast<int>(smem);
  return cudaSuccess;
}

// The grid of query_grid, asked of the device once per (device, shape,
// rounds, market, learners) and kept: a launch then makes no device query, which also
// keeps the launch path free of calls that a CUDA graph capture would not
// record (parallel/graph.py captures K7 inside a whole episode).
template <int kPolicy>
cudaError_t grid_of(int S, int A, int R, int market, int per_scenario, int* grid) {
  struct Entry {
    int dev, S, A, R, market, per_scenario;
    int grid[4];
  };
  constexpr int kEntries = 64;
  static Entry cache[kEntries];
  static int filled = 0;
  static std::mutex lock;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> guard(lock);
  for (int k = 0; k < filled; ++k) {
    const Entry& e = cache[k];
    if (e.dev == dev && e.S == S && e.A == A && e.R == R && e.market == market &&
        e.per_scenario == per_scenario) {
      for (int j = 0; j < 4; ++j) grid[j] = e.grid[j];
      return cudaSuccess;
    }
  }
  err = query_grid<kPolicy>(dev, S, A, R, market, per_scenario, grid);
  if (err == cudaSuccess && filled < kEntries) {
    Entry& e = cache[filled++];
    e = Entry{dev, S, A, R, market, per_scenario, {grid[0], grid[1], grid[2], grid[3]}};
  }
  return err;
}

cudaError_t check_ints(const int* ints) {
  const int S = ints[I_S], A = ints[I_A], R = ints[I_R];
  if (S <= 0 || A <= 0 || R <= 0 || (ints[I_MARKET] == kFactored && R > 2))
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

template <int kPolicy>
cudaError_t launch_policy(const Args& g, cudaStream_t stream) {
  int grid[4];
  cudaError_t err = grid_of<kPolicy>(g.n[I_S], g.n[I_A], g.n[I_R], g.n[I_MARKET],
                                     g.n[I_PER_SCENARIO], grid);
  if (err != cudaSuccess) return err;
  Args a = g;
  void* args[] = {&a};
  // A cooperative launch through the extensible launch API: stream capture
  // keeps the cooperative attribute on the graph's kernel node, so a replay
  // launches the whole grid co-resident, as the grid barriers need.
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(grid[0]);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = static_cast<size_t>(grid[3]);
  config.stream = stream;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelExC(&config, reinterpret_cast<const void*>(slot_fused_kernel<kPolicy>),
                            args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" int slot_fused_counts(int* n_ptr, int* n_const, int* n_int, int* n_out) {
  *n_ptr = N_PTR;
  *n_const = N_CONST;
  *n_int = N_INT;
  *n_out = N_OUT;
  return 0;
}

// The scratch buffer's vector count for R decision passes at A agents and
// the market variant: the wrapper allocates
// [slot_fused_scratch_vectors(R, A, market), S, A] float32.
extern "C" int slot_fused_scratch_vectors(int R, int A, int market) {
  return n_vectors(R, A, market);
}

// The grid slot_fused_launch would launch for these integer arguments on
// the current device: grid[0..3] = (blocks, blocks per SM, SMs, shared
// bytes per block). Returns a CUDA error code (0 on success).
extern "C" int slot_fused_grid(const int* ints, int n_int, int* grid) {
  if (n_int != N_INT) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = check_ints(ints);
  if (err == cudaSuccess)
    err = ints[I_POLICY] == kDQN
              ? grid_of<kDQN>(ints[I_S], ints[I_A], ints[I_R], ints[I_MARKET],
                              ints[I_PER_SCENARIO], grid)
              : grid_of<kTabular>(ints[I_S], ints[I_A], ints[I_R], ints[I_MARKET],
                                  ints[I_PER_SCENARIO], grid);
  return static_cast<int>(err);
}

// Plain C entry point for ctypes: one cooperative launch on `stream`;
// returns the launch's CUDA error (0 on success); it does not synchronise.
extern "C" int slot_fused_launch(const void* const* ptrs, int n_ptr, const float* consts,
                                 int n_const, const int* ints, int n_int,
                                 cudaStream_t stream) {
  if (n_ptr != N_PTR || n_const != N_CONST || n_int != N_INT)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t bad = check_ints(ints);
  if (bad != cudaSuccess) return static_cast<int>(bad);
  Args g;
  for (int k = 0; k < N_PTR; ++k) g.p[k] = const_cast<void*>(ptrs[k]);
  for (int k = 0; k < N_CONST; ++k) g.c[k] = consts[k];
  for (int k = 0; k < N_INT; ++k) g.n[k] = ints[k];
  const cudaError_t err = g.n[I_POLICY] == kDQN ? launch_policy<kDQN>(g, stream)
                                                : launch_policy<kTabular>(g, stream);
  return static_cast<int>(err);
}
