"""Several communities with inter-community trading (BASELINE config 5).

The port of the JAX package's ``envs/multi_community.py``. C communities of
A agents share one learner and ride the leading batch axis the shared trainer
uses for scenarios. After the intra-community clearing, each community's
residual grid power ``r_c = sum_a p_grid`` is offered equally to the other
communities, the pairwise sign-opposition matching of ``ops/market.py::
clear_market`` clears the ``[C, C]`` proposals, and the matched share of each
residual settles at the P2P trade price instead of the grid tariff. The
matched power ``f_c * r_c`` is re-priced pro-rata over the agents whose grid
power has the residual's sign (they back the exchange), so the energy
re-priced at the trade price equals the matched energy; counter-sign agents
settle at the plain tariff.

The settlement is a ``settlement_hook`` of ``envs/community.py::
slot_dynamics_batched``, so the slot is the unfused chain (the fused slot
owns settlement and refuses a hook): on the card the factored clearing (K1)
at ``rounds <= 1``, the matrix negotiation (K5, K4, K6) otherwise. The
functions here take any leading axes before the communities' ``[C, A]``, so
the greedy evaluation clears each day's C communities among themselves.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from p2pmicrogrid_tpu_torch.config import ExperimentConfig
from p2pmicrogrid_tpu_torch.envs.community import (
    AgentRatings,
    EpisodeArrays,
    Policy,
    SlotOutputs,
    build_episode_arrays,
    draw_rating_scales,
    init_physical,
    ratings_to,
    slot_dynamics_batched,
)
from p2pmicrogrid_tpu_torch.ops._f32 import recip
from p2pmicrogrid_tpu_torch.ops.market import clear_market

# Residuals and backing powers below this many W count as zero (JAX source
# :63-64, :88-89).
_ZERO_W = 1e-6


def _safe_ratio(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """``num / den`` where ``|den| > 1e-6``, else 0. ``torch.where``
    evaluates both branches, so the untaken one divides by 1."""
    big = den.abs() > _ZERO_W
    return torch.where(big, num / torch.where(big, den, torch.ones_like(den)), torch.zeros_like(num))


def inter_community_traded_fraction(p_grid: torch.Tensor) -> torch.Tensor:
    """The fraction of each community's grid residual matched with the other
    communities (JAX source :47).

    p_grid: [..., C, A] per-agent grid power after the intra-community
    clearing. Returns f [..., C] in [0, 1]: each community offers its
    residual equally to the other C - 1, and the sign-opposition matching
    clears the [C, C] proposals as the intra-community market clears its
    agents'. A lone community has no one to trade with: f = 0.
    """
    r = p_grid.sum(dim=-1)  # [..., C]
    c = r.shape[-1]
    if c < 2:
        return torch.zeros_like(r)
    eye = torch.eye(c, dtype=p_grid.dtype, device=p_grid.device)
    proposals = r[..., :, None] * (1.0 - eye) * recip(c - 1)
    _, matched = clear_market(proposals)  # [..., C], the sign of r
    return torch.clamp(_safe_ratio(matched, r), 0.0, 1.0)


def make_inter_community_settlement(cfg: ExperimentConfig) -> Callable:
    """The settlement hook of ``slot_dynamics_batched`` whose leading axis is
    communities (JAX source :69): ``settle(p_grid, p_p2p, buy, inj, trade) ->
    cost``, powers [..., C, A] and prices [..., C]. Intra-community P2P
    settles at the trade price as usual; the inter-community matched share
    of the grid power is re-priced from the tariff to the trade price over
    the agents that back the residual, so re-priced energy equals matched
    energy."""
    slot_hours = cfg.sim.slot_hours

    def settle(p_grid, p_p2p, buy, inj, trade):
        f = inter_community_traded_fraction(p_grid)  # [..., C]
        r = p_grid.sum(dim=-1)
        matched = f * r
        same_sign = torch.sign(p_grid) == torch.sign(r)[..., None]  # [..., C, A]
        backing = torch.where(same_sign, p_grid, torch.zeros_like(p_grid)).sum(dim=-1)
        # |backing| >= |r| >= |matched|, so the share stays in [0, 1].
        share = _safe_ratio(matched, backing)
        frac = torch.where(same_sign, share[..., None], torch.zeros_like(p_grid))
        tariff = torch.where(p_grid >= 0.0, buy[..., None], inj[..., None])
        grid_price = (1.0 - frac) * tariff + frac * trade[..., None]
        return (p_grid * grid_price + p_p2p * trade[..., None]) * slot_hours * 1e-3

    return settle


def make_multi_community_episode_fn(
    cfg: ExperimentConfig, policy: Policy, arrays_c: EpisodeArrays, ratings: AgentRatings
) -> Callable:
    """One shared-learner training episode over the C communities of
    ``arrays_c`` (its leading axis) with inter-community trading (JAX source
    :100): ``make_shared_episode_fn`` with the inter-community settlement."""
    # Imported here: parallel/scenarios.py imports this package's community.
    from p2pmicrogrid_tpu_torch.parallel.scenarios import make_shared_episode_fn

    return make_shared_episode_fn(
        cfg, policy, arrays_c, ratings, settlement_hook=make_inter_community_settlement(cfg)
    )


def train_multi_community(
    cfg: ExperimentConfig,
    policy: Policy,
    pol_state,
    arrays_c: EpisodeArrays,
    ratings: AgentRatings,
    generator: Optional[torch.Generator],
    n_episodes: int,
    replay_s=None,
    episode0: int = 0,
    episode_cb: Optional[Callable] = None,
    telemetry=None,
) -> Tuple[object, object, np.ndarray, np.ndarray, float]:
    """Train C communities with inter-community trading and one shared
    learner (JAX source :121): ``train_scenarios_shared``'s contract and
    return value, (pol_state, scen_state, rewards [episodes, C], losses
    [episodes, C], seconds), over ``make_multi_community_episode_fn``'s
    episode. Communities are the leading axis of ``arrays_c`` (build it with
    ``stack_scenario_arrays`` over one trace draw per community).
    ``episode_cb`` and ``telemetry`` are ``train_scenarios_shared``'s."""
    from p2pmicrogrid_tpu_torch.parallel.scenarios import train_scenarios_shared

    episode_fn = make_multi_community_episode_fn(cfg, policy, arrays_c, ratings)
    return train_scenarios_shared(
        cfg, policy, pol_state, arrays_c, ratings, generator, n_episodes,
        replay_s=replay_s, episode_fn=episode_fn, episode0=episode0,
        episode_cb=episode_cb, telemetry=telemetry,
    )


def evaluate_multi_community(
    cfg: ExperimentConfig,
    policy: Policy,
    pol_state,
    traces,
    ratings: AgentRatings,
    generator: Optional[torch.Generator] = None,
    redraw_profile_scales: bool = True,
    rng: Optional[np.random.Generator] = None,
    normals: Optional[torch.Tensor] = None,
    device="cuda",
) -> Tuple[np.ndarray, SlotOutputs, EpisodeArrays]:
    """Greedy per-day evaluation of C communities with inter-community
    trading (JAX source :170; the reference's ``load_and_run``,
    community.py:364-412, lifted to BASELINE config 5). C is
    ``cfg.sim.n_scenarios``.

    ``pol_state`` is the shared learner of ``train_multi_community``
    (``TabularState``, ``DQNState`` or ``DDPGParams``; DDPG acts greedily,
    its OU noise untouched). Each (day, community) redraws its per-agent load
    and PV scales from ``rng`` (default ``np.random.default_rng(0)``), day by
    day, community by community, keeping the ratings' ``max_in``/``max_out``
    (community.py:386-391). All D days x C communities run as one ``[D * C,
    A]`` batch of slots, each day's C communities trading only among
    themselves. The initial-temperature normals ``normals`` [D, C, 2, A]
    come from ``generator`` when not given.

    Returns (days, outputs with leaves [D, T, C, ...], the day arrays with
    leaves [D, C, T, ...]).
    """
    C, A = cfg.sim.n_scenarios, cfg.sim.n_agents
    by_day = traces.split_by_day()
    days = np.array(sorted(by_day), dtype=np.int32)
    D = len(days)
    gen = rng if rng is not None else np.random.default_rng(0)
    per_day = []
    for d in days:
        per_community = []
        for _ in range(C):
            r = ratings
            if redraw_profile_scales:
                load_r, pv_r = draw_rating_scales(cfg, gen)
                r = AgentRatings(
                    load_rating_w=(load_r * 1e3).astype(np.float32),
                    pv_rating_w=(pv_r * 1e3).astype(np.float32),
                    max_in=ratings.max_in,
                    max_out=ratings.max_out,
                )
            per_community.append(build_episode_arrays(cfg, by_day[int(d)], r, device))
        per_day.append(EpisodeArrays(*(torch.stack(leaves) for leaves in zip(*per_community))))
    stacked = EpisodeArrays(*(torch.stack(leaves) for leaves in zip(*per_day)))  # [D, C, T, ...]
    dev = stacked.load_w.device
    if normals is None:
        if generator is None:
            raise ValueError("evaluate_multi_community needs a torch.Generator or normals")
        normals = torch.randn((D, C, 2, A), generator=generator, device=dev)
    settle = make_inter_community_settlement(cfg)

    def settle_by_day(p_grid, p_p2p, buy, inj, trade):
        day = lambda x: x.reshape((D, C) + tuple(x.shape[1:]))
        return settle(day(p_grid), day(p_p2p), day(buy), day(inj), day(trade)).reshape(D * C, A)

    ratings_d = ratings_to(ratings, dev)
    # Time-major [T, D * C, ...] rows, day-major within a slot.
    xs = tuple(x.flatten(0, 1).transpose(0, 1).contiguous() for x in stacked)
    phys = init_physical(cfg, normals.reshape(D * C, 2, A), (D * C,), device=dev)
    outs = []
    for t in range(xs[0].shape[0]):
        phys, pol_state, out, _, _ = slot_dynamics_batched(
            cfg, policy, pol_state, phys, tuple(x[t] for x in xs), None, ratings_d,
            explore=False, settlement_hook=settle_by_day,
        )
        outs.append(out)
    outputs = SlotOutputs(
        *(torch.stack(leaf).reshape((-1, D, C) + tuple(leaf[0].shape[1:])).transpose(0, 1)
          for leaf in zip(*outs))
    )
    return days, outputs, stacked
