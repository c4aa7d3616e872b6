"""The P2P community simulator: one scenario-batched slot step.

The port of the JAX package's ``envs/community.py`` for the shared-scenario
training path. All per-agent state is a NamedTuple of tensors with leading
scenario and agent axes ``[S, A]``; an episode is a Python loop over slots
(``parallel/scenarios.py``). Reference semantics kept (SURVEY.md section 7):

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
the whole slot as the one kernel K7 instead (``ops/slot_fused.py``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from p2pmicrogrid_tpu_torch.config import ExperimentConfig
from p2pmicrogrid_tpu_torch.device import resolve_device
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


class Policy(NamedTuple):
    """A policy as three functions closing over their config.

    act(pol_state, obs [S, A, 4], prev_frac [S, A], draws, explore,
        explore_state) -> (hp_frac [S, A], aux [S, A], q [S, A],
        explore_state'); ``draws`` is the round's exploration draws, each
        [S, A]: ``(uniform, randint)`` for tabular and DQN, ``(normals,)`` for
        DDPG. ``explore_state`` is per-scenario exploration state that
        threads through the rounds (DDPG's OU noise [S, A]; None otherwise).
    learn(pol_state, obs, aux, reward, next_obs) -> (pol_state, loss)
    decay(pol_state) -> pol_state   (exploration schedule, community.py:283-285)
    """

    act: Callable
    learn: Callable
    decay: Callable


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
):
    """One slot of S scenarios except learning: negotiate -> clear -> settle
    -> reward -> step assets (community.py:149-157,170).

    ``xs`` = (time [S], t_out [S], load_w [S, A], pv_w [S, A], next_time [S],
    next_load_w, next_pv_w); ``draws``, the exploration draws of every round,
    each [rounds+1, S, A]: (uniform, randint) for tabular and DQN, (normals,)
    for DDPG; ``ratings`` as tensors on the state's device.
    ``explore_state`` (DDPG's OU noise [S, A]) threads through every
    negotiation round's act and is returned.

    ``fused=True`` runs the slot through ``ops/slot_fused.py::
    slot_step_fused`` (kernel K7 on the card, its plain version on the CPU),
    with the market resolved as the JAX fused path resolves it: the factored
    clearing computes in bfloat16 only for ``factored`` with the bfloat16
    market dtype, and the matrix negotiation is always float32.

    Returns (phys', pol_state, outputs, transition, explore_state').
    """
    if fused:
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
        hp_frac, aux, q, ex = policy.act(
            pol_state, obs, hp_frac, tuple(d[r] for d in draws), explore, ex
        )
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
