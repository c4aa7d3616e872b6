"""The P2P community simulator: the scenario-batched slot step and the
single community's episode.

The port of the JAX package's ``envs/community.py``. All per-agent state is
a NamedTuple of tensors with leading scenario and agent axes ``[S, A]``; an
episode is a Python loop over slots (``parallel/scenarios.py`` for the
shared trainers, ``run_episode`` here for one community, whose ``[A]`` state
runs as a one-scenario batch). Reference semantics kept (SURVEY.md section
7):

* Within a negotiation round every agent sees the previous round's proposals
  (community.py:75-86); round 0's mean has a closed form because round 0
  splits against a zero matrix.
* Reward = -(cost + 10 * comfort penalty), penalty offset +1, evaluated at the
  pre-step indoor temperature (agent.py:225-232).
* The next-state observation reuses the stale (pre-step) indoor temperature
  and a zero p2p signal (agent.py:293-296, community.py:161) — toggleable via
  ``SimConfig.stale_next_temp``.
* Assets advance after the market settles (community.py:158-170).

The market branches are the factored clearing (``rounds <= 1``, kernel K1),
the matrix negotiation (any ``rounds``, kernels K5, K4 and K6 of
``ops/matrix_market.py``) and the no-trading community. ``fused=True`` runs
the whole slot as the one kernel K7 instead (``ops/slot_fused.py``). The
single community always negotiates through the matrix path in float32, as
the JAX package's single chain does (``single_chain_config``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from p2pmicrogrid_tpu_torch.config import ExperimentConfig
from p2pmicrogrid_tpu_torch.device import resolve_device
from p2pmicrogrid_tpu_torch.models.replay import sample_indices
from p2pmicrogrid_tpu_torch.ops._f32 import recip
from p2pmicrogrid_tpu_torch.ops.battery import battery_rule_update
from p2pmicrogrid_tpu_torch.ops.factored_market import (
    clear_factored_rounds0,
    clear_factored_rounds1,
)
from p2pmicrogrid_tpu_torch.ops.market import compute_costs
from p2pmicrogrid_tpu_torch.ops.matrix_market import (
    clear_market_fused,
    divide_power_fused_with_mean,
    divide_rank1_fused,
)
from p2pmicrogrid_tpu_torch.ops.obs import make_observation
from p2pmicrogrid_tpu_torch.ops.tariff import grid_prices, p2p_price as p2p_price_fn
from p2pmicrogrid_tpu_torch.ops.thermal import (
    comfort_penalty,
    normalized_temperature,
    thermal_step,
)
from p2pmicrogrid_tpu_torch.telemetry.device_metrics import dc_from_slot


class Policy(NamedTuple):
    """A policy as three functions closing over their config.

    act(pol_state, obs [S, A, 4], prev_frac [S, A], draws, explore,
        explore_state) -> (hp_frac [S, A], aux [S, A], q [S, A],
        explore_state'); ``draws`` is the round's exploration draws, each
        [S, A]: ``(uniform, randint)`` for tabular and DQN, ``(normals,)`` for
        DDPG; None when ``explore`` is false. ``explore_state`` is
        per-scenario exploration state that threads through the rounds
        (DDPG's OU noise [S, A]; None otherwise).
    learn(pol_state, obs [A, 4], aux [A], reward [A], next_obs [A, 4], idx)
        -> (pol_state, loss [A]): the single-community learn step; ``idx``
        [A, replay_batch] are the per-agent replay indices it samples (None
        where ``replay_batch`` is None).
    decay(pol_state) -> pol_state   (exploration schedule, community.py:283-285)
    replay_batch: the per-agent batch ``learn`` samples from its replay ring
        (DQN, DDPG), or None where it samples nothing (tabular, the DQN
        record-only warmup).
    """

    act: Callable
    learn: Callable
    decay: Callable
    replay_batch: Optional[int] = None


class AgentRatings(NamedTuple):
    """Static per-agent ratings, [A] each (community.py:210-228): numpy from
    ``make_ratings``, tensors once moved to a device."""

    load_rating_w: object
    pv_rating_w: object
    max_in: object
    max_out: object


class EpisodeArrays(NamedTuple):
    """Per-slot inputs of an episode. ``next_*`` is the reference's np.roll
    (state, next_state) pairing (dataset.py:98-103); the last slot wraps.
    Scenario-stacked arrays have a leading [S] axis: time [S, T],
    load_w [S, T, A]."""

    time: torch.Tensor
    t_out: torch.Tensor
    load_w: torch.Tensor
    pv_w: torch.Tensor
    next_time: torch.Tensor
    next_load_w: torch.Tensor
    next_pv_w: torch.Tensor


class PhysState(NamedTuple):
    """Physical asset state, [..., A] each."""

    t_in: torch.Tensor     # indoor air temperature [°C]
    t_bm: torch.Tensor     # building-mass temperature [°C]
    soc: torch.Tensor      # battery state of charge in [0, 1]
    hp_frac: torch.Tensor  # heat-pump power fraction in [0, 1]


class SlotOutputs(NamedTuple):
    """Per-slot trace (what the reference logs: community.py:341-361)."""

    cost: torch.Tensor        # [S, A] €
    reward: torch.Tensor      # [S, A]
    loss: torch.Tensor        # [S, A]
    p_grid: torch.Tensor      # [S, A] W
    p_p2p: torch.Tensor       # [S, A] W
    buy_price: torch.Tensor   # [S] €/kWh
    injection_price: torch.Tensor
    trade_price: torch.Tensor
    t_in: torch.Tensor        # [S, A] pre-step indoor temperature
    hp_power_w: torch.Tensor  # [S, A] final heat-pump electrical power
    decisions: torch.Tensor   # [S, rounds+1, A] per-round hp power [W]
    q: torch.Tensor           # [S, A] actor value estimate


class SlotTransition(NamedTuple):
    """The learning transition of a slot (agent.py:293-296)."""

    obs: torch.Tensor       # [S, A, 4] last-round observation
    aux: torch.Tensor       # [S, A] action: index as float32 (tabular, DQN),
                            # heat-pump fraction (DDPG)
    reward: torch.Tensor    # [S, A]
    next_obs: torch.Tensor  # [S, A, 4]


def draw_rating_scales(
    cfg: ExperimentConfig, rng: np.random.Generator
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-agent load/PV scales in kW: ~N(0.7,0.2)/N(4,0.2), or the means when
    homogeneous (community.py:210-211)."""
    p = cfg.population
    n = cfg.sim.n_agents
    if cfg.sim.homogeneous:
        return np.full(n, p.load_rating_mean), np.full(n, p.pv_rating_mean)
    return (
        rng.normal(p.load_rating_mean, p.load_rating_std, n),
        rng.normal(p.pv_rating_mean, p.pv_rating_std, n),
    )


def make_ratings(cfg: ExperimentConfig, rng: np.random.Generator) -> AgentRatings:
    """Draw heterogeneous load/PV ratings (community.py:210-228), as numpy.

    ``max_out`` uses the multiplicative form — the reference's
    ``-(max_power + safety*1e3)`` (community.py:228) is a typo not copied.
    """
    p = cfg.population
    load_r, pv_r = draw_rating_scales(cfg, rng)
    max_power = np.maximum(load_r, pv_r)
    return AgentRatings(
        load_rating_w=(load_r * 1e3).astype(np.float32),
        pv_rating_w=(pv_r * 1e3).astype(np.float32),
        max_in=(max_power * p.safety * 1e3).astype(np.float32),
        max_out=(-max_power * p.safety * 1e3).astype(np.float32),
    )


def ratings_to(ratings: AgentRatings, device="cuda") -> AgentRatings:
    """The ratings as float32 tensors on ``device``."""
    dev = resolve_device(device)
    return AgentRatings(
        *(torch.as_tensor(np.asarray(r), dtype=torch.float32).to(dev) for r in ratings)
    )


def init_physical(
    cfg: ExperimentConfig,
    normals: Optional[torch.Tensor] = None,
    batch_shape: Tuple[int, ...] = (),
    device="cuda",
) -> PhysState:
    """Initial state: temperatures N(setpoint, 0.3) per agent
    (heating.py:101-104), or the setpoint exactly when homogeneous; battery
    at its init SoC; heat pump off.

    ``normals`` [*batch, 2, A] are the standard-normal draws for (t_in, t_bm);
    they are ignored (and may be None) for a homogeneous community.
    """
    dev = resolve_device(device)
    n = cfg.sim.n_agents
    th = cfg.thermal
    shape = tuple(batch_shape) + (n,)
    full = lambda v: torch.full(shape, v, dtype=torch.float32, device=dev)
    if cfg.sim.homogeneous:
        t_in, t_bm = full(th.setpoint), full(th.setpoint)
    else:
        if normals is None or tuple(normals.shape) != tuple(batch_shape) + (2, n):
            raise ValueError(
                f"init_physical needs normals of shape {tuple(batch_shape) + (2, n)}"
            )
        normals = normals.to(dev)
        t_in = th.setpoint + th.init_temp_std * normals[..., 0, :]
        t_bm = th.setpoint + th.init_temp_std * normals[..., 1, :]
    return PhysState(
        t_in=t_in,
        t_bm=t_bm,
        soc=full(cfg.battery.init_soc),
        hp_frac=full(0.0),  # HeatPump(power=0), community.py:226
    )


def _on_card(cfg: ExperimentConfig, device: torch.device) -> bool:
    """The port's counterpart of the JAX package's ``resolve_use_pallas``: the
    auto choices key on tensors on a CUDA device, where the JAX package keys
    on ``jax.default_backend() == "tpu"``."""
    if cfg.sim.use_pallas is not None:
        return bool(cfg.sim.use_pallas)
    return torch.device(device).type == "cuda"


# Smallest community size at which the auto market dtype compresses to
# bfloat16 (the JAX package's value).
MARKET_BF16_MIN_AGENTS = 256


def resolve_market_dtype(cfg: ExperimentConfig, device) -> str:
    """Resolve ``SimConfig.market_dtype``'s "auto": bfloat16 on the card at
    ``n_agents >= MARKET_BF16_MIN_AGENTS``, float32 otherwise."""
    md = cfg.sim.market_dtype
    if md != "auto":
        return md
    if _on_card(cfg, device) and cfg.sim.n_agents >= MARKET_BF16_MIN_AGENTS:
        return "bfloat16"
    return "float32"


def resolve_market_impl(cfg: ExperimentConfig, device) -> str:
    """Resolve ``SimConfig.market_impl``'s "auto" to "matrix" | "factored".

    Auto takes the factored clearing on the card when trading with
    ``rounds <= 1``, and the matrix path elsewhere (on the CPU too, as the
    JAX package does off the TPU).
    """
    mi = cfg.sim.market_impl
    if mi != "auto":
        return mi
    if cfg.sim.trading and cfg.sim.rounds <= 1 and _on_card(cfg, device):
        return "factored"
    return "matrix"


def resolve_use_fused(cfg: ExperimentConfig) -> bool:
    """Resolve ``SimConfig.fused_slot``: None (the default) is off, as in the
    JAX package, where the unfused chain is the reference; the fused slot
    takes tabular and DQN only and refuses DDPG (its exploration noise
    advances inside the act)."""
    f = cfg.sim.fused_slot
    if not f:
        return False
    if cfg.train.implementation not in ("tabular", "dqn"):
        raise ValueError(
            "fused_slot=True supports tabular/dqn policies only (ddpg "
            f"advances OU state inside act), got {cfg.train.implementation!r}"
        )
    return True


def slot_dynamics_batched(
    cfg: ExperimentConfig,
    policy: Policy,
    pol_state,
    phys_s: PhysState,
    xs,
    draws,
    ratings: AgentRatings,
    explore: bool,
    fused: bool = False,
    explore_state=None,
    settlement_hook: Optional[Callable] = None,
):
    """One slot of S scenarios except learning: negotiate -> clear -> settle
    -> reward -> step assets (community.py:149-157,170).

    ``xs`` = (time [S], t_out [S], load_w [S, A], pv_w [S, A], next_time [S],
    next_load_w, next_pv_w); ``draws``, the exploration draws of every round,
    each [rounds+1, S, A]: (uniform, randint) for tabular and DQN, (normals,)
    for DDPG, or None when ``explore`` is false; ``ratings`` as tensors on
    the state's device. ``explore_state`` (DDPG's OU noise [S, A]) threads
    through every negotiation round's act and is returned.

    ``fused=True`` runs the slot through ``ops/slot_fused.py::
    slot_step_fused`` (kernel K7 on the card, its plain version on the CPU),
    with the market resolved as the JAX fused path resolves it: the factored
    clearing computes in bfloat16 only for ``factored`` with the bfloat16
    market dtype, and the matrix negotiation is always float32.

    ``settlement_hook(p_grid, p_p2p, buy, inj, trade) -> cost [S, A]``
    replaces the default per-agent settlement (``p_grid``, ``p_p2p`` [S, A];
    the prices [S]): the extension point for inter-community trading
    (``envs/multi_community.py``), where the leading axis is communities.
    The fused slot owns settlement, so it refuses a hook.

    Returns (phys', pol_state, outputs, transition, explore_state').
    """
    if fused:
        if settlement_hook is not None:
            raise ValueError(
                "fused slot dynamics cannot take a settlement_hook: the fused "
                "slot owns settlement (use fused=False for multi-community paths)"
            )
        # Imported here: ops/slot_fused.py builds this module's NamedTuples.
        from p2pmicrogrid_tpu_torch.ops.slot_fused import slot_step_fused

        device = xs[2].device
        market_impl_f = resolve_market_impl(cfg, device) if cfg.sim.trading else "matrix"
        f_dtype = (
            torch.bfloat16
            if cfg.sim.trading
            and market_impl_f == "factored"
            and resolve_market_dtype(cfg, device) == "bfloat16"
            else None
        )
        phys_f, outputs_f, tr_f = slot_step_fused(
            cfg, pol_state, phys_s, xs, draws, ratings, explore,
            market_impl=market_impl_f, compute_dtype=f_dtype,
        )
        return phys_f, pol_state, outputs_f, tr_f, explore_state

    time_s, t_out_s, load_w, pv_w, next_time_s, next_load_w, next_pv_w = xs
    th = cfg.thermal
    device = load_w.device
    inv_max_in = torch.reciprocal(ratings.max_in)

    buy, inj = grid_prices(cfg.tariff, time_s)  # [S]
    trade = p2p_price_fn(buy, inj)

    balance_w = load_w - pv_w  # [S, A]
    soc = phys_s.soc
    if cfg.battery.enabled:
        soc, balance_w = battery_rule_update(
            cfg.battery, soc, balance_w, cfg.sim.dt_seconds
        )
    norm_balance = balance_w * inv_max_in
    norm_temp = normalized_temperature(th, phys_s.t_in)

    ex = explore_state

    def round_obs_act(p2p_mean, hp_frac, r):
        nonlocal ex
        obs = make_observation(time_s[:, None], norm_temp, norm_balance, p2p_mean)
        round_draws = None if draws is None else tuple(d[r] for d in draws)
        hp_frac, aux, q, ex = policy.act(pol_state, obs, hp_frac, round_draws, explore, ex)
        return obs, hp_frac, aux, q, balance_w + hp_frac * th.hp_max_power

    market_impl = resolve_market_impl(cfg, device) if cfg.sim.trading else None
    if market_impl == "factored":
        f_dtype = (
            torch.bfloat16
            if resolve_market_dtype(cfg, device) == "bfloat16"
            else None
        )
        A = load_w.shape[1]
        obs, hp_frac, aux, q, out0 = round_obs_act(
            torch.zeros_like(balance_w), phys_s.hp_frac, 0
        )
        hp_power_l = [hp_frac * th.hp_max_power]
        if cfg.sim.rounds == 0:
            p_grid, p_p2p = clear_factored_rounds0(out0, compute_dtype=f_dtype)
        else:
            # Round 0's matrix is out0_i / A in every column, so the mean of
            # what agent i sees has this closed form (JAX source :645-646).
            tot = out0.sum(dim=-1, keepdim=True)
            mean_raw = -(tot - out0) * recip(A * A)
            obs, hp_frac, aux, q, out1 = round_obs_act(
                mean_raw * inv_max_in, hp_frac, 1
            )
            hp_power_l.append(hp_frac * th.hp_max_power)
            p_grid, p_p2p = clear_factored_rounds1(out0, out1, compute_dtype=f_dtype)
        hp_power_r = torch.stack(hp_power_l, dim=1)  # [S, rounds+1, A]
    elif market_impl is not None:
        # The matrix negotiation, in the JAX package's Pallas structure
        # (envs/community.py:656-704). Round 0 splits against a zero matrix,
        # so its output is the rank-1 matrix out_0 / A and its mean has a
        # closed form; round 1 rebuilds that matrix from the vector (K5);
        # later rounds split the stored matrix and emit the next round's
        # mean (K4); K6 clears the final matrix.
        mdt = (
            torch.bfloat16
            if resolve_market_dtype(cfg, device) == "bfloat16"
            else torch.float32
        )
        S, A = load_w.shape
        mean_raw = torch.zeros_like(balance_w)
        hp_frac = phys_s.hp_frac
        prev_vec = p2p = None
        hp_power_l = []
        for r in range(cfg.sim.rounds + 1):
            obs, hp_frac, aux, q, out_power = round_obs_act(
                mean_raw * inv_max_in, hp_frac, r
            )
            hp_power_l.append(hp_frac * th.hp_max_power)
            if r == 0:
                prev_vec = out_power
                tot = out_power.sum(dim=-1, keepdim=True)
                mean_raw = -(tot - out_power) * recip(A * A)
            elif prev_vec is not None:
                p2p, mean_raw = divide_rank1_fused(prev_vec, out_power, out_dtype=mdt)
                prev_vec = None
            else:
                p2p, mean_raw = divide_power_fused_with_mean(p2p, out_power)
        if p2p is None:
            # rounds == 0: clear the rank-1 matrix of the single pass.
            p2p = (
                (prev_vec * recip(A))[:, :, None].expand(S, A, A).to(mdt).contiguous()
            )
        p_grid, p_p2p = clear_market_fused(p2p)
        hp_power_r = torch.stack(hp_power_l, dim=1)  # [S, rounds+1, A]
    else:
        # No-com community: one decision pass, zero p2p signal, grid-only
        # settlement.
        obs, hp_frac, aux, q, p_grid = round_obs_act(
            torch.zeros_like(norm_balance), phys_s.hp_frac, 0
        )
        p_p2p = torch.zeros_like(p_grid)
        hp_power_r = (hp_frac * th.hp_max_power)[:, None]
    if settlement_hook is not None:
        cost = settlement_hook(p_grid, p_p2p, buy, inj, trade)
    else:
        cost = compute_costs(
            p_grid, p_p2p, buy[:, None], inj[:, None], trade[:, None], cfg.sim.slot_hours
        )

    penalty = comfort_penalty(th, phys_s.t_in)
    reward = -(cost + 10.0 * penalty)

    hp_power = hp_frac * th.hp_max_power
    t_in_new, t_bm_new = thermal_step(
        th, cfg.sim.dt_seconds, t_out_s[:, None], phys_s.t_in, phys_s.t_bm, hp_power
    )

    next_temp = phys_s.t_in if cfg.sim.stale_next_temp else t_in_new
    next_balance = (next_load_w - next_pv_w) * inv_max_in
    next_obs = make_observation(
        next_time_s[:, None],
        normalized_temperature(th, next_temp),
        next_balance,
        torch.zeros_like(next_balance),
    )

    outputs = SlotOutputs(
        cost=cost,
        reward=reward,
        loss=torch.zeros_like(reward),
        p_grid=p_grid,
        p_p2p=p_p2p,
        buy_price=buy,
        injection_price=inj,
        trade_price=trade,
        t_in=phys_s.t_in,
        hp_power_w=hp_power,
        decisions=hp_power_r,
        q=q,
    )
    phys_s = PhysState(t_in=t_in_new, t_bm=t_bm_new, soc=soc, hp_frac=hp_frac)
    transition = SlotTransition(obs=obs, aux=aux, reward=reward, next_obs=next_obs)
    return phys_s, pol_state, outputs, transition, ex


# --- the single community ------------------------------------------------------


class SingleEpisodeDraws(NamedTuple):
    """Every random draw of one single-community episode, in the JAX
    package's single key structure: one draw per negotiation round, with no
    per-scenario split (envs/community.py:259-260). R is ``rounds + 1`` with
    trading, 1 without.

    uniform: [T, R, A] float32 in [0, 1) — the exploration coin per round
        (tabular, DQN; None for DDPG)
    randint: [T, R, A] integer in [0, n_actions) — the random action
        (``num_actions`` for tabular, 3 for DQN; None for DDPG)
    ou_normals: [T, R, A] float32 — DDPG's OU noise normals per round (None
        otherwise)
    replay_idx: [T, A, B] integer — each agent's replay sample indices per
        slot, in [0, max(count, 1)) of its ring after the slot's add (DQN and
        DDPG learning; None otherwise)
    normals: [2, A] float32 — the initial (t_in, t_bm) standard normals,
        which the training loop reads (``run_episode`` takes a state)
    """

    uniform: Optional[torch.Tensor] = None
    randint: Optional[torch.Tensor] = None
    ou_normals: Optional[torch.Tensor] = None
    replay_idx: Optional[torch.Tensor] = None
    normals: Optional[torch.Tensor] = None


def build_episode_arrays(
    cfg: ExperimentConfig, traces, ratings: AgentRatings, device="cuda"
) -> EpisodeArrays:
    """One community's episode inputs as float32 tensors on ``device``: the
    denormalised per-agent profiles [T, A] and the next-slot pairing
    (community.py:157-176)."""
    from p2pmicrogrid_tpu_torch.data.traces import agent_profiles, next_slot

    dev = resolve_device(device)
    load_w, pv_w = agent_profiles(
        traces,
        cfg.sim.n_agents,
        np.asarray(ratings.load_rating_w),
        np.asarray(ratings.pv_rating_w),
        homogeneous=cfg.sim.homogeneous,
    )
    to = lambda x: torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(dev)
    return EpisodeArrays(
        time=to(traces.time),
        t_out=to(traces.t_out),
        load_w=to(load_w),
        pv_w=to(pv_w),
        next_time=to(next_slot(traces.time)),
        next_load_w=to(next_slot(load_w)),
        next_pv_w=to(next_slot(pv_w)),
    )


def with_pv_drop(
    arrays: EpisodeArrays, agent: int, start_slot: int = 0, factor: float = 0.0
) -> EpisodeArrays:
    """Fault injection: scale one agent's PV production by ``factor`` from
    ``start_slot`` on (the reference's "PV drop" scenario,
    data_analysis.py:1099-1211). ``next_pv_w`` takes the rolled scale, so
    the transition of slot ``start_slot - 1`` already sees the fault."""
    n_agents = arrays.pv_w.shape[1]
    if not 0 <= agent < n_agents:
        raise ValueError(f"agent {agent} out of range [0, {n_agents})")
    T = arrays.time.shape[0]
    mask = (torch.arange(T, device=arrays.pv_w.device) >= start_slot).to(torch.float32)
    scale = 1.0 - (1.0 - factor) * mask  # 1 before the drop, `factor` after
    pv_w = arrays.pv_w.clone()
    pv_w[:, agent] *= scale
    next_pv_w = arrays.next_pv_w.clone()
    next_pv_w[:, agent] *= torch.roll(scale, -1)
    return arrays._replace(pv_w=pv_w, next_pv_w=next_pv_w)


@functools.lru_cache(maxsize=None)
def single_chain_config(cfg: ExperimentConfig) -> ExperimentConfig:
    """The config the single community's slot runs: ``cfg`` with the matrix
    negotiation in float32 (``market_impl="matrix"``,
    ``market_dtype="float32"``), the only market the JAX package's single
    chain implements (envs/community.py:320-326), whatever ``cfg`` resolves
    to on the card."""
    sim = dataclasses.replace(cfg.sim, market_impl="matrix", market_dtype="float32")
    return dataclasses.replace(cfg, sim=sim)


def lift(tree):
    """A NamedTuple of tensors as a one-scenario batch: each leaf [1, ...]."""
    return type(tree)(*(x[None] for x in tree))


def squeeze(tree):
    """``lift``'s inverse: each leaf's leading axis of 1 dropped."""
    return type(tree)(*(x[0] for x in tree))


def lift_slot_inputs(xs):
    """One slot's inputs (time [], t_out [], load_w [A], pv_w [A], next_time
    [], next_load_w [A], next_pv_w [A]) as a one-scenario batch."""
    return tuple(x[None] for x in xs)


def slot_dynamics(
    cfg: ExperimentConfig,
    policy: Policy,
    pol_state,
    phys: PhysState,
    xs,
    draws,
    ratings: AgentRatings,
    explore: bool,
    fused: bool = False,
):
    """One slot of one community except learning (community.py:285-379):
    negotiate, clear, settle, reward, step assets.

    The one-scenario lift of ``slot_dynamics_batched``, as the JAX package
    lifts its fused single slot (ops/pallas_slot.py:566-604): the [A] state
    becomes [1, A], each round's draws ``draws`` (each [R, A], or None when
    ``explore`` is false) go to the policy as they are, and the market is
    the matrix negotiation in float32 (K5, K4 and K6 on the card), the only
    market the JAX single chain implements, whatever the config resolves to.
    A DDPG state's OU noise (``ou_state`` [A]) threads through the rounds.
    ``fused=True`` runs ``ops/slot_fused.py::slot_step_fused_single`` (K7 at
    [1, A]; tabular and DQN).

    Returns (phys', pol_state', outputs, transition), [A]-shaped.
    """
    if fused:
        from p2pmicrogrid_tpu_torch.ops.slot_fused import slot_step_fused_single

        phys, outputs, tr = slot_step_fused_single(
            cfg, pol_state, phys, xs, draws, ratings, explore
        )
        return phys, pol_state, outputs, tr
    ou = getattr(pol_state, "ou_state", None)
    phys_b, pol_state, outputs, tr, ou = slot_dynamics_batched(
        single_chain_config(cfg), policy, pol_state, lift(phys), lift_slot_inputs(xs),
        None if draws is None else tuple(d[:, None] for d in draws),
        ratings, explore, explore_state=None if ou is None else ou[None],
    )
    if ou is not None:
        pol_state = pol_state._replace(ou_state=ou[0])
    return squeeze(phys_b), pol_state, squeeze(outputs), squeeze(tr)


def community_slot(
    cfg: ExperimentConfig,
    policy: Policy,
    pol_state,
    phys: PhysState,
    xs,
    draws,
    replay_idx: Optional[torch.Tensor],
    training: bool,
    ratings: AgentRatings,
    fused: bool = False,
):
    """One 15-minute slot (community.py:793-826): the dynamics, then, when
    training, the learn step on the last round's transition with the
    per-agent replay indices ``replay_idx`` [A, B] (DQN, DDPG). Returns
    (phys', pol_state', outputs)."""
    phys, pol_state, outputs, tr = slot_dynamics(
        cfg, policy, pol_state, phys, xs, draws, ratings, explore=training, fused=fused
    )
    if training:
        pol_state, loss = policy.learn(
            pol_state, tr.obs, tr.aux, tr.reward, tr.next_obs, replay_idx
        )
        outputs = outputs._replace(loss=loss)
    return phys, pol_state, outputs


def _n_round_draws(cfg: ExperimentConfig) -> int:
    return cfg.sim.rounds + 1 if cfg.sim.trading else 1


def run_episode(
    cfg: ExperimentConfig,
    policy: Policy,
    pol_state,
    phys: PhysState,
    arrays: EpisodeArrays,
    ratings: AgentRatings,
    generator: Optional[torch.Generator] = None,
    training: bool = True,
    draws: Optional[SingleEpisodeDraws] = None,
    collect_device_metrics: bool = False,
    fused: Optional[bool] = None,
) -> Tuple[PhysState, object, SlotOutputs]:
    """One episode of one community (community.py:829-894): a Python loop
    over the slots of ``arrays`` ([T, ...] tensors on the state's device).

    Training explores and learns every slot; a greedy episode
    (``training=False``) does neither and draws nothing. A training
    episode's draws come from ``generator`` (a ``torch.Generator``: per slot
    each round's exploration draws, then the learn step's replay indices
    where ``policy.replay_batch`` is set, each drawn on the generator's
    device and moved to the state's, so a CPU generator gives the card the
    CPU's draws) or from ``draws`` (``SingleEpisodeDraws``). The learner state updates in
    place.

    ``fused`` runs every slot through K7 at [1, A] (tabular and DQN); None
    resolves ``SimConfig.fused_slot``. With ``collect_device_metrics`` the
    episode's ``telemetry.DeviceCounters`` (the learn loss included), summed
    on the device over the stacked outputs, are returned as a 4th element.

    Returns (final physical state, policy state, outputs with a leading [T]
    axis on every leaf[, the episode's counters]).
    """
    use_fused = resolve_use_fused(cfg) if fused is None else bool(fused)
    impl = cfg.train.implementation
    if use_fused and impl not in ("tabular", "dqn"):
        raise ValueError("run_episode(fused=True) supports tabular/dqn policies only")
    device = arrays.load_w.device
    T, A = arrays.load_w.shape
    R = _n_round_draws(cfg)
    if training and draws is None and generator is None:
        raise ValueError("a training episode needs a torch.Generator or SingleEpisodeDraws")
    if training and draws is not None:
        need = ("ou_normals",) if impl == "ddpg" else ("uniform", "randint")
        need += ("replay_idx",) if policy.replay_batch is not None else ()
        missing = [f for f in need if getattr(draws, f) is None]
        if missing:
            raise ValueError(f"a {impl} training episode needs SingleEpisodeDraws.{', '.join(missing)}")
    n_actions = cfg.qlearning.num_actions if impl == "tabular" else 3
    gen_dev = None if generator is None else generator.device
    ratings_d = ratings_to(ratings, device)
    outs = []
    for t in range(T):
        xs = tuple(x[t] for x in arrays)
        slot_draws = idx = None
        if training and draws is not None:
            slot_draws = (
                (draws.ou_normals[t],) if impl == "ddpg" else (draws.uniform[t], draws.randint[t])
            )
            if policy.replay_batch is not None:
                idx = draws.replay_idx[t]
        elif training:
            if impl == "ddpg":
                slot_draws = (torch.randn((R, A), generator=generator, device=gen_dev).to(device),)
            else:
                slot_draws = (
                    torch.rand((R, A), generator=generator, device=gen_dev).to(device),
                    torch.randint(0, n_actions, (R, A), generator=generator, device=gen_dev).to(device),
                )
            if policy.replay_batch is not None:
                # The ring holds this slot's transition when it is sampled.
                ring = pol_state.replay
                count = min(ring.count + 1, ring.capacity)
                idx = sample_indices(count, A, policy.replay_batch, generator, gen_dev).to(device)
        phys, pol_state, out = community_slot(
            cfg, policy, pol_state, phys, xs, slot_draws, idx, training, ratings_d,
            fused=use_fused,
        )
        outs.append(out)
    outputs = SlotOutputs(*(torch.stack(leaf) for leaf in zip(*outs)))
    if collect_device_metrics:
        # The stacked [T, A] outputs: one reduction over every slot.
        return phys, pol_state, outputs, dc_from_slot(cfg, outputs)
    return phys, pol_state, outputs


def _thermostat_episode(
    cfg: ExperimentConfig, phys: PhysState, arrays: EpisodeArrays, hp_rule: Callable
) -> Tuple[PhysState, SlotOutputs]:
    """The rule baselines' scaffold: grid-only settlement, no learning, no
    draws; ``hp_rule(phys, buy_price) -> hp_frac [A]`` is the heat-pump
    policy (community.py:897-946)."""
    th = cfg.thermal
    outs = []
    for t in range(arrays.time.shape[0]):
        time_n, t_out, load_w, pv_w = (x[t] for x in arrays[:4])
        buy, inj = grid_prices(cfg.tariff, time_n)
        trade = p2p_price_fn(buy, inj)
        hp_frac = hp_rule(phys, buy)
        hp_power = hp_frac * th.hp_max_power
        balance_w = load_w - pv_w
        soc = phys.soc
        if cfg.battery.enabled:
            soc, balance_w = battery_rule_update(cfg.battery, soc, balance_w, cfg.sim.dt_seconds)
        p_grid = balance_w + hp_power
        p_p2p = torch.zeros_like(p_grid)
        cost = compute_costs(p_grid, p_p2p, buy, inj, trade, cfg.sim.slot_hours)
        penalty = comfort_penalty(th, phys.t_in)
        reward = -(cost + 10.0 * penalty)
        t_in_new, t_bm_new = thermal_step(
            th, cfg.sim.dt_seconds, t_out, phys.t_in, phys.t_bm, hp_power
        )
        outs.append(SlotOutputs(
            cost=cost,
            reward=reward,
            loss=torch.zeros_like(reward),
            p_grid=p_grid,
            p_p2p=p_p2p,
            buy_price=buy,
            injection_price=inj,
            trade_price=trade,
            t_in=phys.t_in,
            hp_power_w=hp_power,
            decisions=hp_power[None, :],
            q=torch.zeros_like(reward),
        ))
        phys = PhysState(t_in=t_in_new, t_bm=t_bm_new, soc=soc, hp_frac=hp_frac)
    return phys, SlotOutputs(*(torch.stack(leaf) for leaf in zip(*outs)))


def _bang_bang(cfg: ExperimentConfig, phys: PhysState) -> torch.Tensor:
    """Bang-bang thermostat (agent.py:130-136): full power at or below the
    comfort band, off at or above it, the previous command inside it."""
    th = cfg.thermal
    one = torch.ones_like(phys.hp_frac)
    return torch.where(
        phys.t_in <= th.lower_bound,
        one,
        torch.where(phys.t_in >= th.upper_bound, torch.zeros_like(one), phys.hp_frac),
    )


def rule_baseline_episode(
    cfg: ExperimentConfig, phys: PhysState, arrays: EpisodeArrays
) -> Tuple[PhysState, SlotOutputs]:
    """Thermostat bang-bang baseline, grid-only settlement: the reference's
    ``RuleAgent`` (agent.py:106-136)."""
    return _thermostat_episode(cfg, phys, arrays, lambda phys, buy: _bang_bang(cfg, phys))


def semi_intelligent_baseline_episode(
    cfg: ExperimentConfig, phys: PhysState, arrays: EpisodeArrays
) -> Tuple[PhysState, SlotOutputs]:
    """Price-aware thermostat baseline, grid-only settlement
    (community.py:949-978): the bang-bang rule, plus pre-heating at half
    power up to the comfort band's upper bound whenever the buy price is
    below its daily average (the tariff's ``cost_avg``)."""
    th = cfg.thermal
    avg_price = cfg.tariff.cost_avg / 100.0

    def rule(phys, buy):
        hp_frac = _bang_bang(cfg, phys)
        cheap = buy < avg_price
        return torch.where(
            cheap & (phys.t_in < th.upper_bound), torch.clamp_min(hp_frac, 0.5), hp_frac
        )

    return _thermostat_episode(cfg, phys, arrays, rule)
