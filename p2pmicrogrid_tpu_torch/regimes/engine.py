"""The regime-aware slot: weather, EV, event windows, market mechanisms.

The port of the JAX package's ``regimes/engine.py``. ``regime_slot_batched``
wraps ``envs/community.py::slot_dynamics_batched`` with the four regime
composition points, all driven by ``RegimeParams`` [S] tensors (one episode
program, one chunk graph, mixed regimes):

* **weather** happens before the slots: ``apply_weather_regimes`` scales
  the episode arrays once an episode (host-built or made on the device).
* **EV charging** happens before negotiation: the deadline-feasible charge
  rate is added to the slot's load, so it flows through the balance
  observation, the negotiation, every mechanism's settlement and the
  reward.
* **events + mechanism** happen at settlement, through the
  ``settlement_hook`` of ``slot_dynamics_batched``: the hook re-prices the
  slot (spike multiplier, per-scenario mechanism on the PRE-clearing book),
  masks grid exchange to zero in islanding windows (billing curtailed load
  at the value-of-lost-load price; spilled surplus earns nothing) and bills
  EV deadline misses, so the regime economics land in the reward.

An all-default (baseline) regime is the identity: the wrapped slot equals
the plain ``slot_dynamics_batched`` bit for bit. ``RegimeCounters`` are
per-regime episode totals, reduced through the [S, R] assignment one-hot.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from p2pmicrogrid_tpu_torch.config import KWH_TO_WS, ExperimentConfig
from p2pmicrogrid_tpu_torch.envs.community import EpisodeArrays, slot_dynamics_batched
from p2pmicrogrid_tpu_torch.ops._f32 import recip
from p2pmicrogrid_tpu_torch.ops.auction import mechanism_trade_price, trade_volumes
from p2pmicrogrid_tpu_torch.ops.market import compute_costs
from p2pmicrogrid_tpu_torch.regimes.spec import RegimeParams


def apply_weather_regimes(arrays: EpisodeArrays, rp: RegimeParams) -> EpisodeArrays:
    """Per-scenario weather over [S, T(, A)] episode arrays. Scales are
    time-invariant per scenario, so the rolled ``next_*`` arrays scale by
    the same factor; neutral params (offset 0, scales 1) are the identity
    bit for bit."""
    off = rp.temp_offset_c[:, None]
    pv = rp.pv_scale[:, None, None]
    load = rp.load_scale[:, None, None]
    return arrays._replace(
        t_out=arrays.t_out + off,
        load_w=arrays.load_w * load,
        pv_w=arrays.pv_w * pv,
        next_load_w=arrays.next_load_w * load,
        next_pv_w=arrays.next_pv_w * pv,
    )


def init_ev_need(rp: RegimeParams, n_agents: int) -> torch.Tensor:
    """[S, A] energy (Ws) each agent's EV still owes at episode start."""
    per_scenario = rp.ev_energy_ws * rp.ev_present  # [S]
    return per_scenario[:, None].expand(per_scenario.shape[0], n_agents).contiguous()


def ev_charge_step(
    cfg: ExperimentConfig,
    rp: RegimeParams,
    ev_need: torch.Tensor,   # [S, A] Ws still owed
    slot_idx: torch.Tensor,  # [S] int32 slot of day
    dial: torch.Tensor,      # [S, A] flexibility dial in [0, 1] (prev hp_frac)
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One slot of deadline-constrained EV charging.

    The rate is the dial times the charger rating, floored at the
    deadline-feasibility rate (``need / time_left``) and capped at the
    rating and at the remaining need; charging only happens inside the
    availability window. At the slot entering the deadline the remaining
    need becomes the MISS and the window closes.

    Returns ``(ev_power_w [S, A], ev_need' [S, A], miss_ws [S, A])``.
    """
    dt = cfg.sim.dt_seconds
    present = rp.ev_present[:, None] > 0.0
    deadline = rp.ev_deadline_slot[:, None]
    slot = slot_idx[:, None]
    in_window = present & (slot >= rp.ev_arrival_slot[:, None]) & (slot < deadline) & (ev_need > 0.0)
    slots_left = torch.clamp(deadline - slot, min=1).to(torch.float32)
    floor_w = ev_need / (slots_left * dt)
    max_w = rp.ev_max_power_w[:, None]
    want_w = torch.clamp(dial, 0.0, 1.0) * max_w
    rate_w = torch.minimum(torch.clamp(torch.maximum(want_w, floor_w), min=0.0), max_w)
    rate_w = torch.minimum(rate_w, ev_need * recip(dt))  # never overshoot the need
    ev_power = torch.where(in_window, rate_w, 0.0)
    new_need = torch.clamp(ev_need - ev_power * dt, min=0.0)
    at_deadline = (slot + 1 >= deadline) & present
    miss_ws = torch.where(at_deadline, new_need, 0.0)
    new_need = torch.where(at_deadline, 0.0, new_need)
    return ev_power, new_need, miss_ws


def regime_slot_batched(
    cfg: ExperimentConfig,
    policy,
    pol_state,
    phys_s,
    ev_need: torch.Tensor,
    xs_t,
    draws,
    ratings,
    rp: RegimeParams,
    explore: bool,
    explore_state=None,
):
    """Scenario-batched slot with the regime composition applied.

    ``slot_dynamics_batched``'s contract (``draws`` its exploration draws)
    plus the EV-need carry: returns ``(phys', pol_state, outputs,
    transition, explore_state', ev_need', extras)``, ``extras`` the slot's
    regime series ``ev_power_w``, ``curtailed_w``, ``ev_miss_ws`` [S, A].
    ``outputs`` records the regime-effective market: masked grid power,
    spiked buy price, the mechanism's trade price; its cost (and so the
    reward) includes curtailment and EV-miss billing. The slot always runs
    unfused: the fused slot owns settlement.
    """
    time_s = xs_t[0]
    slot_idx = torch.round(time_s * cfg.sim.slots_per_day).to(torch.int32)  # half to even

    ev_power, ev_need, miss_ws = ev_charge_step(cfg, rp, ev_need, slot_idx, phys_s.hp_frac)
    # The EV charge joins the slot's inflexible load before negotiation;
    # the next-slot observation keeps the non-EV balance (the reference's
    # stale next-state convention).
    xs_mod = (time_s, xs_t[1], xs_t[2] + ev_power) + tuple(xs_t[3:])

    islanded = (slot_idx >= rp.outage_start_slot) & (slot_idx < rp.outage_end_slot)  # [S]
    spiked = (slot_idx >= rp.spike_start_slot) & (slot_idx < rp.spike_end_slot)
    spike_mult = torch.where(spiked, rp.spike_mult, 1.0)  # [S]
    recorded = {}

    def settlement(p_grid, p_p2p, buy, inj, trade):
        del trade  # the mechanism select owns the trade price
        buy_eff = buy * spike_mult  # [S]
        # The mechanisms price the PRE-clearing book (matched + residual).
        demand_w, supply_w = trade_volumes(p_grid + p_p2p)
        trade_eff = mechanism_trade_price(rp.mechanism, buy_eff, inj, demand_w, supply_w, rp.auction_k)
        # Islanding: the grid tie is open, matched P2P trades stand, the
        # grid residual is curtailed; unserved load bills at the value of
        # lost load, spilled surplus earns nothing.
        p_grid_eff = torch.where(islanded[:, None], 0.0, p_grid)
        curtailed = p_grid - p_grid_eff  # [S, A], nonzero only islanded
        cost = compute_costs(
            p_grid_eff, p_p2p, buy_eff[:, None], inj[:, None], trade_eff[:, None], cfg.sim.slot_hours
        )
        cost = cost + (
            torch.clamp(curtailed, min=0.0) * rp.curtail_price_eur_kwh[:, None] * cfg.sim.slot_hours * 1e-3
        )
        cost = cost + miss_ws * recip(KWH_TO_WS) * rp.ev_miss_price_eur_kwh[:, None]
        recorded.update(p_grid=p_grid_eff, curtailed=curtailed, buy=buy_eff, trade=trade_eff)
        return cost

    phys_s, pol_state, outputs, transition, explore_state = slot_dynamics_batched(
        cfg, policy, pol_state, phys_s, xs_mod, draws, ratings, explore=explore,
        explore_state=explore_state, settlement_hook=settlement,
    )
    outputs = outputs._replace(
        p_grid=recorded["p_grid"], buy_price=recorded["buy"], trade_price=recorded["trade"]
    )
    extras = {"ev_power_w": ev_power, "curtailed_w": recorded["curtailed"], "ev_miss_ws": miss_ws}
    return phys_s, pol_state, outputs, transition, explore_state, ev_need, extras


class RegimeCounters(NamedTuple):
    """Per-regime episode totals ([R] float32 tensors), the
    regime-attributed mirror of ``telemetry.DeviceCounters``."""

    cost_eur: torch.Tensor            # [R] settlement cost (incl. penalties)
    reward: torch.Tensor              # [R] agent-mean reward sum
    comfort_violations: torch.Tensor  # [R] agent-slots outside the band
    trade_wh: torch.Tensor            # [R] P2P-matched energy
    grid_wh: torch.Tensor             # [R] |grid| energy (post-islanding)
    curtailed_wh: torch.Tensor        # [R] islanded unserved-load energy
    ev_charged_wh: torch.Tensor       # [R] EV energy delivered
    ev_missed_wh: torch.Tensor        # [R] EV energy undelivered at deadline


def rc_zero(n_regimes: int, device) -> RegimeCounters:
    """Zero counters for ``n_regimes`` regimes on ``device``, which the
    caller names (as ``telemetry.device_metrics.dc_zero``)."""
    return RegimeCounters(*(torch.zeros((n_regimes,), dtype=torch.float32, device=device) for _ in range(8)))


def rc_add(a: RegimeCounters, b: RegimeCounters) -> RegimeCounters:
    return RegimeCounters(*(x + y for x, y in zip(a, b)))


def rc_from_slot(
    cfg: ExperimentConfig,
    outputs,
    extras: dict,
    one_hot_sr: torch.Tensor,  # [S, R] assignment one-hot
) -> RegimeCounters:
    """One slot's per-regime contribution: agent-axis reductions, then one
    [S] x [S, R] segment product per series."""
    th = cfg.thermal
    hours = cfg.sim.slot_hours
    seg = lambda x_s: x_s @ one_hot_sr  # [S] -> [R]
    t = outputs.t_in
    return RegimeCounters(
        cost_eur=seg(outputs.cost.sum(dim=-1)),
        reward=seg(outputs.reward.mean(dim=-1)),
        comfort_violations=seg(((t < th.lower_bound) | (t > th.upper_bound)).to(torch.float32).sum(dim=-1)),
        trade_wh=seg(torch.clamp(outputs.p_p2p, min=0.0).sum(dim=-1) * hours),
        grid_wh=seg(outputs.p_grid.abs().sum(dim=-1) * hours),
        curtailed_wh=seg(torch.clamp(extras["curtailed_w"], min=0.0).sum(dim=-1) * hours),
        ev_charged_wh=seg(extras["ev_power_w"].sum(dim=-1) * hours),
        ev_missed_wh=seg(extras["ev_miss_ws"].sum(dim=-1) * recip(3600.0)),
    )


def rc_to_dicts(rc: RegimeCounters, regime_names: Optional[list] = None) -> list:
    """Host-side per-regime dicts, one read of all the counters."""
    # host-sync: the once-per-call counter transfer (mirrors dc_to_dict).
    leaves = torch.stack(list(rc)).cpu().numpy().astype(np.float64)
    n = leaves.shape[1]
    names = regime_names or [f"regime_{i}" for i in range(n)]
    return [
        {"regime": names[i], **{k: float(leaves[j, i]) for j, k in enumerate(RegimeCounters._fields)}}
        for i in range(n)
    ]
