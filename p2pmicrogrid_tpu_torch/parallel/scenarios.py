"""Monte-Carlo scenario batching with one shared learner.

A *scenario* is an independent draw of the synthetic load/PV/weather
generator; scenarios form the leading ``[S]`` axis of the whole simulation.
In the shared mode ported here, one set of policy parameters serves all
scenarios and each slot applies one update averaged over the scenario axis
(the "shared-critic" mode of BASELINE.md config 4): the tabular Q-learner,
DQN with per-scenario lockstep replay, or DDPG with per-scenario lockstep
replay and OU noise (one actor-critic for every agent, or one per agent).
``fused=True`` runs every slot as the one kernel K7 (``ops/slot_fused.py``;
tabular and DQN). Exploration decays on the reference cadence (every
``min_episodes_criterion`` episodes, community.py:279-287), starting after
episode 0.

An episode is a Python loop over the 96 slots on the device; it makes no
host synchronisation inside the loop. Randomness comes from an explicit
``torch.Generator``, or from precomputed ``EpisodeDraws`` (the tests feed the
JAX package's own draws through them).
"""

from __future__ import annotations

import dataclasses
import time as _time
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from p2pmicrogrid_tpu_torch.config import ExperimentConfig
from p2pmicrogrid_tpu_torch.data.traces import (
    TraceSet,
    agent_profiles,
    next_slot,
    synthetic_traces,
)
from p2pmicrogrid_tpu_torch.device import resolve_device
from p2pmicrogrid_tpu_torch.envs.community import (
    AgentRatings,
    EpisodeArrays,
    Policy,
    init_physical,
    ratings_to,
    resolve_use_fused,
    slot_dynamics_batched,
)
from p2pmicrogrid_tpu_torch.models.ddpg import (
    DDPGParams,
    ddpg_learn_batch,
    set_learning_rates,
)
from p2pmicrogrid_tpu_torch.models.dqn import (
    ACTION_VALUES,
    OBS_DIM,
    DQNState,
    _td_loss,
    action_values_on,
    apply_td_update,
    dqn_initialize_target,
)
from p2pmicrogrid_tpu_torch.models.replay import (
    LockstepReplay,
    lockstep_replay_add,
    lockstep_replay_init,
    lockstep_replay_sample,
    lockstep_sample_indices,
)
from p2pmicrogrid_tpu_torch.models.tabular import TabularState, q_rows
from p2pmicrogrid_tpu_torch.ops._f32 import recip
from p2pmicrogrid_tpu_torch.ops.obs import discretize
from p2pmicrogrid_tpu_torch.train.policies import init_policy_state


class EpisodeDraws(NamedTuple):
    """Every random draw of one shared episode.

    uniform: [T, rounds+1, S, A] float32 in [0, 1) — exploration coin per round
    randint: [T, rounds+1, S, A] integer in [0, n_actions) — random action
        (n_actions is ``num_actions`` for tabular, 3 for DQN); both None for
        DDPG
    normals: [S, 2, A] float32 standard normals for the initial (t_in, t_bm)
    replay_idx: [T, B] integer — DQN's and DDPG's replay sample indices per
        slot, each in [0, max(count, 1)) of that slot's ring (None for
        tabular and for the record-only warmup)
    ou_normals: [T, rounds+1, S, A] float32 — DDPG's OU noise normals per
        round (None otherwise)
    stripe_starts: [T, n_stripes] integer in [0, B * S * A) — DDPG's stripe
        offsets into the pooled batch where ``learn_batch_cap`` caps it
        (``ddpg_stripes``; None otherwise)
    """

    uniform: Optional[torch.Tensor]
    randint: Optional[torch.Tensor]
    normals: torch.Tensor
    replay_idx: Optional[torch.Tensor] = None
    ou_normals: Optional[torch.Tensor] = None
    stripe_starts: Optional[torch.Tensor] = None


def make_scenario_traces(
    cfg: ExperimentConfig,
    n_scenarios: Optional[int] = None,
    n_days: int = 1,
    seed: int = 0,
    start_day: int = 11,
) -> TraceSet:
    """S independent synthetic draws (S = ``cfg.sim.n_scenarios`` unless
    overridden), stacked on a leading scenario axis: leaves are [S, T(, P)].
    Scenario s draws from ``synthetic_traces(seed=seed + s)``, normalized
    within itself, as the JAX package's numpy backend does."""
    S = cfg.sim.n_scenarios if n_scenarios is None else n_scenarios
    draws = [
        synthetic_traces(n_days=n_days, seed=seed + s, start_day=start_day).normalized()
        for s in range(S)
    ]
    return TraceSet(*(np.stack(leaves) for leaves in zip(*draws)))


def stack_scenario_arrays(
    cfg: ExperimentConfig, traces: TraceSet, ratings: AgentRatings, device="cuda"
) -> EpisodeArrays:
    """Per-scenario episode inputs as tensors [S, T, ...] on ``device``.

    All scenarios must share one slot grid (identical time columns): the
    shared tabular update relies on it (``_tabular_update_shared``).
    """
    dev = resolve_device(device)
    times = np.asarray(traces.time)
    if not (times == times[:1]).all():
        raise ValueError("scenario traces must share one slot/time grid")
    S, T = np.asarray(traces.load).shape[:2]
    # Fold the scenario axis into time so agent_profiles assigns profiles
    # and ratings in one vectorized pass.
    flat = TraceSet(
        *(np.asarray(leaf).reshape((S * T,) + np.asarray(leaf).shape[2:]) for leaf in traces)
    )
    load_w, pv_w = agent_profiles(
        flat,
        cfg.sim.n_agents,
        np.asarray(ratings.load_rating_w),
        np.asarray(ratings.pv_rating_w),
        homogeneous=cfg.sim.homogeneous,
    )
    load_w = load_w.reshape(S, T, -1)
    pv_w = pv_w.reshape(S, T, -1)
    roll = lambda x: np.moveaxis(next_slot(np.moveaxis(x, 1, 0)), 0, 1)
    to = lambda x: torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(dev)
    return EpisodeArrays(
        time=to(times),
        t_out=to(traces.t_out),
        load_w=to(load_w),
        pv_w=to(pv_w),
        next_time=to(roll(times[:, :, None])[:, :, 0]),
        next_load_w=to(roll(load_w)),
        next_pv_w=to(roll(pv_w)),
    )


class DDPGScenState(NamedTuple):
    """Shared DDPG's per-scenario state: the learnable ``DDPGParams`` are
    shared across scenarios, but each scenario keeps its own replay history
    and Ornstein-Uhlenbeck noise trajectory.

    replay: ``LockstepReplay`` with ``[cap, S, A, ...]`` rings
    ou:     [S, A] float32, the OU noise
    """

    replay: LockstepReplay
    ou: torch.Tensor


def init_shared_pol_state(
    cfg: ExperimentConfig, device="cuda", generator: Optional[torch.Generator] = None
):
    """The shared learnable state (a ``TabularState``, a ``DQNState`` or
    ``DDPGParams``, whose networks draw their weights from ``generator``)."""
    return init_policy_state(cfg, device=device, generator=generator)


def init_scen_state_only(
    cfg: ExperimentConfig,
    device="cuda",
    generator: Optional[torch.Generator] = None,
    n_scenarios: Optional[int] = None,
):
    """The per-scenario state alone: None for tabular, a ``LockstepReplay``
    for DQN, a ``DDPGScenState`` for DDPG (its OU noise starts at
    ``ou_init_sd`` times standard normals from ``generator``,
    rl_backup.py:81,102)."""
    S = cfg.sim.n_scenarios if n_scenarios is None else n_scenarios
    A = cfg.sim.n_agents
    impl = cfg.train.implementation
    if impl == "tabular":
        return None
    if impl == "dqn":
        return lockstep_replay_init(S, A, cfg.dqn.buffer_size, OBS_DIM, 1, device=device)
    if impl == "ddpg":
        replay = lockstep_replay_init(S, A, cfg.ddpg.buffer_size, OBS_DIM, 1, device=device)
        normals = torch.randn((S, A), generator=generator, device=replay.obs.device)
        return DDPGScenState(replay=replay, ou=cfg.ddpg.ou_init_sd * normals)
    raise ValueError(f"unknown implementation {impl!r}")


def init_shared_state(
    cfg: ExperimentConfig, device="cuda", generator: Optional[torch.Generator] = None
) -> Tuple[object, object]:
    """(pol_state, scen_state) for ``train_scenarios_shared``, the policy
    state drawn from ``generator`` first:

    * tabular -> (TabularState, None): no per-scenario state;
    * dqn     -> (DQNState, LockstepReplay) with ``[cap, S, A, ...]`` rings;
    * ddpg    -> (DDPGParams, DDPGScenState).
    """
    pol_state = init_shared_pol_state(cfg, device=device, generator=generator)
    return pol_state, init_scen_state_only(cfg, device=device, generator=generator)


def _tabular_update_shared(
    cfg: ExperimentConfig, state: TabularState, tr
) -> Tuple[TabularState, torch.Tensor]:
    """Shared Q-table Bellman update averaged over the scenario axis, in place.

    tr leaves are [S, A, ...]. Per-agent tables stay exact along the agent
    axis; along the scenario axis each scenario's TD delta, scaled 1/S, is
    added at its own cell (colliding cells sum, which matches averaging the
    sequential updates to first order in alpha). Every scenario shares the
    slot's time bin (one slot grid, ``stack_scenario_arrays``), so the S * A
    updates land in the ``[A, ntemp * nb * np2p * n_actions]`` slice of that
    bin; the bin is read on the device, with no host synchronisation.

    ``index_put_(accumulate=True)`` adds colliding updates in index order
    (scenario-major): serially on the CPU, and on CUDA through PyTorch's
    sort-based accumulation, which keeps that order, so the result is the
    same from run to run without float atomics.

    Returns (state, loss [S]): the agent-mean squared TD error per scenario.
    """
    q = cfg.qlearning
    S, A = tr.reward.shape
    flat = state.q_table.view(-1)
    ti, tpi, bi, pi = (x.to(torch.int64) for x in discretize(q, tr.obs))
    action = tr.aux.to(torch.int64)
    a_idx = torch.arange(A, device=flat.device)

    compact = ((tpi * q.num_balance_states + bi) * q.num_p2p_states + pi) * (
        q.num_actions
    ) + action  # [S, A] in [0, m)
    m = q.num_temp_states * q.num_balance_states * q.num_p2p_states * q.num_actions
    q_sa = flat[((a_idx * q.num_time_states + ti) * m) + compact]
    q_next = q_rows(q, state.q_table, tr.next_obs).amax(dim=-1)
    td = tr.reward + q.gamma * q_next - q_sa
    vals = q.alpha * td * recip(S)  # [S, A]

    tbin = ti[0, 0]  # shared slot grid
    dest = (a_idx * q.num_time_states + tbin) * m + compact
    flat.index_put_((dest.reshape(-1),), vals.reshape(-1), accumulate=True)
    return state, td.square().mean(dim=1)


def _record_shared(replay_s: LockstepReplay, tr) -> LockstepReplay:
    """Add the slot's transitions to the lockstep ring, the action as its
    heat-pump fraction (``ACTION_VALUES[aux]``)."""
    act_frac = action_values_on(tr.aux.device)[tr.aux.to(torch.int64)][..., None]
    return lockstep_replay_add(replay_s, tr.obs, act_frac, tr.reward, tr.next_obs)


def _dqn_update_shared(
    cfg: ExperimentConfig, state: DQNState, replay_s: LockstepReplay, tr, idx: torch.Tensor
) -> Tuple[DQNState, LockstepReplay, torch.Tensor]:
    """Shared per-agent DQN parameters, per-scenario replay: add the slot's
    transitions, sample the B shared indices ``idx``, and take one learn
    step on each agent's scenario-pooled batch (JAX source, :495-535). The
    networks, Adam and the ring update in place.

    The pool moves ``[B, S, A, ...]`` to ``[A, B * S, ...]``; the pooled-mean
    TD loss is the scenario mean of the per-scenario losses (equal batch
    sizes). Returns (state, replay, loss [S]): the per-scenario mean of the
    per-sample squared TD residuals, unflattened from the pool's (B, S)
    order.
    """
    d = cfg.dqn
    S = tr.reward.shape[0]
    replay_s = _record_shared(replay_s, tr)
    s, a, r, ns = lockstep_replay_sample(replay_s, idx)  # [B, S, A, ...]
    pool = lambda x: x.movedim(2, 0).reshape((x.shape[2], -1) + tuple(x.shape[3:]))
    _, sq = apply_td_update(
        d,
        lambda: _td_loss(d, state.online, state.target, pool(s), pool(a), pool(r), pool(ns)),
        state.online,
        state.target,
        state.opt_state,
    )
    per_scenario = sq.reshape(sq.shape[0], -1, S).mean(dim=(0, 1))
    return state, replay_s, per_scenario


def ddpg_stripes(cfg: ExperimentConfig, n_scenarios: int, n_agents: int) -> Optional[Tuple[int, int]]:
    """(stripes, rows a stripe) of the capped agent-shared DDPG learn batch,
    or None where the update takes the whole pool.

    With one actor-critic for every agent and ``learn_batch_cap`` below the
    pool ``B * S * A``, each update takes ``cap`` rows of the flattened
    ``[B, S, A]`` sample as contiguous stripes at random offsets, wrapping
    around (JAX source, :580-604): the largest stripe count up to 8 that
    divides the cap, so a cap not a multiple of 8 does not collapse into one
    block.
    """
    d = cfg.ddpg
    cap = d.learn_batch_cap
    if not d.share_across_agents or cap is None or cap >= d.batch_size * n_scenarios * n_agents:
        return None
    n = next(n for n in range(8, 0, -1) if cap % n == 0)
    return n, cap // n


def _ddpg_update_shared(
    cfg: ExperimentConfig,
    params: DDPGParams,
    scen: DDPGScenState,
    tr,
    idx: torch.Tensor,
    starts: Optional[torch.Tensor] = None,
) -> Tuple[DDPGParams, DDPGScenState, torch.Tensor]:
    """Shared DDPG parameters, per-scenario replay (JAX source, :547-708):
    add the slot's transitions (the action as its clipped fraction), sample
    the B shared indices ``idx``, and take one learn step whose gradient is
    the average over every scenario's sampled batch. The networks, Adam and
    the ring update in place.

    * per-agent parameters: each agent learns on its scenario-pooled batch
      ``[A, B * S, ...]``;
    * one actor-critic for every agent: it learns on the pooled ``[B * S *
      A]`` batch, or, where ``ddpg_stripes`` caps it, on the stripes at
      offsets ``starts`` [n_stripes] into that flattened batch, the rows
      gathered by ``index_select`` on the device.

    Returns (params, scen, loss [S]): the per-scenario mean of the per-sample
    squared critic residuals; under the cap, the mean over each scenario's
    rows in the stripes, by a one-hot ``[cap, S]`` product in float32, and
    the mean of all rows for a scenario that no stripe covered.
    """
    d = cfg.ddpg
    S, A = tr.reward.shape
    replay = lockstep_replay_add(scen.replay, tr.obs, tr.aux[..., None], tr.reward, tr.next_obs)
    s, a, r, ns = lockstep_replay_sample(replay, idx)  # [B, S, A, ...]
    stripes = ddpg_stripes(cfg, S, A)
    if stripes is not None:
        _, length = stripes
        pool = s.shape[0] * S * A
        rows = (starts[:, None] + torch.arange(length, device=starts.device)).reshape(-1) % pool
        take = lambda x: x.reshape((pool,) + tuple(x.shape[3:])).index_select(0, rows)
        sq = ddpg_learn_batch(d, params, take(s), take(a), take(r), take(ns))
        # Row i of the flattened [B, S, A] sample is scenario (i // A) % S.
        scenario = (rows // A) % S
        one_hot = (scenario[:, None] == torch.arange(S, device=rows.device)).to(sq.dtype)
        hit = one_hot.sum(dim=0)
        loss = torch.where(hit > 0, (sq @ one_hot) / hit.clamp(min=1.0), sq.mean())
    elif d.share_across_agents:
        flat = lambda x: x.reshape((-1,) + tuple(x.shape[3:]))
        sq = ddpg_learn_batch(d, params, flat(s), flat(a), flat(r), flat(ns))
        loss = sq.reshape(-1, S, A).mean(dim=(0, 2))  # [B * S * A] in (B, S, A) order
    else:
        pool = lambda x: x.movedim(2, 0).reshape((A, -1) + tuple(x.shape[3:]))
        sq = ddpg_learn_batch(d, params, pool(s), pool(a), pool(r), pool(ns))
        loss = sq.reshape(A, -1, S).mean(dim=(0, 1))  # [A, B * S] in (B, S) order
    return params, scen._replace(replay=replay), loss


# The pooled-batch lr rule (JAX source, :710-720, calibrated there on the
# JAX package's runs): below DDPG_LR_REF_POOLED pooled transitions per update
# the config lrs hold; above it they fall off as pooled^(-DDPG_LR_EXP).
DDPG_LR_REF_POOLED = 400.0
DDPG_LR_EXP = 0.5


def ddpg_pooled_batch(cfg: ExperimentConfig, n_scenarios: Optional[int] = None) -> int:
    """Transitions one shared-DDPG gradient step consumes per slot:
    ``batch_size * S`` per agent, ``* n_agents`` when one actor-critic is
    shared across agents, capped there at ``learn_batch_cap``."""
    S = cfg.sim.n_scenarios if n_scenarios is None else n_scenarios
    A = cfg.sim.n_agents if cfg.ddpg.share_across_agents else 1
    pooled = cfg.ddpg.batch_size * S * A
    cap = cfg.ddpg.learn_batch_cap
    if cfg.ddpg.share_across_agents and cap is not None:
        pooled = min(pooled, cap)
    return pooled


def auto_scale_ddpg_lrs(
    cfg: ExperimentConfig, n_scenarios: Optional[int] = None
) -> ExperimentConfig:
    """The config with DDPG's actor and critic lrs scaled by
    ``(DDPG_LR_REF_POOLED / pooled) ** DDPG_LR_EXP`` where the pooled update
    batch exceeds the reference pool; ``cfg`` itself when ``lr_auto_scale``
    is off, the pool is small, or the learner is not DDPG. The shared
    episode function applies the result."""
    if cfg.train.implementation != "ddpg" or not cfg.ddpg.lr_auto_scale:
        return cfg
    pooled = ddpg_pooled_batch(cfg, n_scenarios)
    if pooled <= DDPG_LR_REF_POOLED:
        return cfg
    scale = (DDPG_LR_REF_POOLED / pooled) ** DDPG_LR_EXP
    return dataclasses.replace(
        cfg,
        ddpg=dataclasses.replace(
            cfg.ddpg,
            actor_lr=cfg.ddpg.actor_lr * scale,
            critic_lr=cfg.ddpg.critic_lr * scale,
        ),
    )


def make_shared_episode_fn(
    cfg: ExperimentConfig,
    policy: Policy,
    arrays_s: EpisodeArrays,
    ratings: AgentRatings,
    record_only: bool = False,
    fused: Optional[bool] = None,
) -> Callable:
    """One shared-parameter training episode over S scenarios.

    Returns ``episode(carry, generator=None, draws=None) -> (carry,
    (rewards [S], losses [S]))`` with ``carry = (pol_state, scen_state)``
    (``init_shared_state``). Draws come from ``generator`` (a
    ``torch.Generator`` on the arrays' device: the initial-temperature
    normals, then per slot the exploration draws of every round (tabular and
    DQN: uniforms and random actions; DDPG: OU normals) and, for a learn
    step, the B replay indices and DDPG's stripe offsets), or, when
    ``draws`` (``EpisodeDraws``) is given, from it alone. Rewards are the
    per-scenario sums over slots of the agent-mean reward; losses the
    per-scenario means over slots of the learn loss. The learner state
    updates in place.

    DDPG learns at the lrs of ``auto_scale_ddpg_lrs`` for this S, which the
    episode sets on its optimizers each time it runs (the JAX package bakes
    them into its episode program).

    ``fused`` runs every slot through the fused slot (kernel K7 on the card;
    tabular and DQN only); None resolves ``SimConfig.fused_slot``.
    ``record_only=True`` (DQN only) builds the replay-warmup episode: act and
    record transitions, no parameter update, loss 0 (the reference's
    ``init_buffers``, community.py:125-147).
    """
    impl = cfg.train.implementation
    if impl not in ("tabular", "dqn", "ddpg"):
        raise ValueError(f"shared-scenario training supports tabular/dqn/ddpg, got {impl!r}")
    if record_only and impl != "dqn":
        raise ValueError("record_only warmup applies to dqn only")
    if fused is None:
        fused = resolve_use_fused(cfg)
    if fused and impl == "ddpg":
        raise ValueError(f"fused episodes support tabular/dqn, got {impl!r}")
    device = arrays_s.load_w.device
    S, T, A = arrays_s.load_w.shape
    R = cfg.sim.rounds + 1 if cfg.sim.trading else 1
    cfg = auto_scale_ddpg_lrs(cfg, S)
    stripes = ddpg_stripes(cfg, S, A) if impl == "ddpg" else None
    ratings_d = ratings_to(ratings, device)
    # Time-major copies, so each slot reads contiguous [S, ...] rows.
    xs = tuple(
        x.transpose(0, 1).contiguous()
        for x in (
            arrays_s.time,
            arrays_s.t_out,
            arrays_s.load_w,
            arrays_s.pv_w,
            arrays_s.next_time,
            arrays_s.next_load_w,
            arrays_s.next_pv_w,
        )
    )
    # The random-action bound (pallas_slot.py:339-341).
    n_actions = cfg.qlearning.num_actions if impl == "tabular" else len(ACTION_VALUES)
    learns_from_replay = impl == "ddpg" or (impl == "dqn" and not record_only)
    batch_size = cfg.ddpg.batch_size if impl == "ddpg" else cfg.dqn.batch_size

    def check_draws(draws):
        missing = []
        if learns_from_replay and draws.replay_idx is None:
            missing.append("replay_idx")
        if impl == "ddpg" and draws.ou_normals is None:
            missing.append("ou_normals")
        if stripes is not None and draws.stripe_starts is None:
            missing.append("stripe_starts")
        if missing:
            raise ValueError(f"a {impl} episode needs EpisodeDraws.{' and '.join(missing)}")

    def slot_draws(t, generator, draws):
        """The exploration draws of slot t's rounds, each [R, S, A]."""
        if draws is not None:
            return (draws.ou_normals[t],) if impl == "ddpg" else (draws.uniform[t], draws.randint[t])
        if impl == "ddpg":
            return (torch.randn((R, S, A), generator=generator, device=device),)
        return (
            torch.rand((R, S, A), generator=generator, device=device),
            torch.randint(0, n_actions, (R, S, A), generator=generator, device=device),
        )

    def learn_draws(t, generator, draws, replay):
        """Slot t's replay indices [B] and, under the cap, stripe offsets."""
        if draws is not None:
            return draws.replay_idx[t], None if stripes is None else draws.stripe_starts[t]
        # The ring holds this slot's transition when it is sampled.
        count = min(replay.count + 1, replay.capacity)
        idx = lockstep_sample_indices(count, batch_size, generator, device)
        if stripes is None:
            return idx, None
        pool = batch_size * S * A
        return idx, torch.randint(0, pool, (stripes[0],), generator=generator, device=device)

    def episode(carry, generator: Optional[torch.Generator] = None, draws=None):
        pol_state, scen_state = carry
        if draws is None and generator is None:
            raise ValueError("episode needs a torch.Generator or EpisodeDraws")
        if draws is not None:
            check_draws(draws)
            normals = draws.normals
        else:
            normals = torch.randn((S, 2, A), generator=generator, device=device)
        if impl == "ddpg":
            set_learning_rates(cfg.ddpg, pol_state)
        phys_s = init_physical(cfg, normals, (S,), device=device)
        rewards = torch.empty((T, S), dtype=torch.float32, device=device)
        losses = torch.empty((T, S), dtype=torch.float32, device=device)
        for t in range(T):
            phys_s, _, outputs, tr, ou = slot_dynamics_batched(
                cfg, policy, pol_state, phys_s, tuple(x[t] for x in xs),
                slot_draws(t, generator, draws), ratings_d, explore=True, fused=fused,
                explore_state=scen_state.ou if impl == "ddpg" else None,
            )
            if impl == "tabular":
                pol_state, loss = _tabular_update_shared(cfg, pol_state, tr)
            elif record_only:
                scen_state = _record_shared(scen_state, tr)
                loss = torch.zeros((S,), dtype=torch.float32, device=device)
            elif impl == "dqn":
                idx, _ = learn_draws(t, generator, draws, scen_state)
                pol_state, scen_state, loss = _dqn_update_shared(
                    cfg, pol_state, scen_state, tr, idx
                )
            else:
                idx, starts = learn_draws(t, generator, draws, scen_state.replay)
                pol_state, scen_state, loss = _ddpg_update_shared(
                    cfg, pol_state, scen_state._replace(ou=ou), tr, idx, starts
                )
            rewards[t] = outputs.reward.mean(dim=-1)
            losses[t] = loss
        return (pol_state, scen_state), (rewards.sum(dim=0), losses.mean(dim=0))

    return episode


def warmup_shared_dqn(
    cfg: ExperimentConfig,
    policy: Policy,
    pol_state: DQNState,
    scen_state: LockstepReplay,
    arrays_s: EpisodeArrays,
    ratings: AgentRatings,
    generator: Optional[torch.Generator] = None,
    draws: Optional[Sequence[EpisodeDraws]] = None,
    fused: Optional[bool] = None,
) -> Tuple[DQNState, LockstepReplay]:
    """Scenario-batched DQN replay warmup (the reference's ``init_buffers``,
    community.py:125-147): ``cfg.dqn.warmup_passes`` record-only
    epsilon-greedy episodes, then a hard online -> target copy. ``draws``,
    one ``EpisodeDraws`` per pass, replaces ``generator``."""
    n = cfg.dqn.warmup_passes
    if draws is not None and len(draws) != n:
        raise ValueError(f"need {n} EpisodeDraws, got {len(draws)}")
    episode_fn = make_shared_episode_fn(
        cfg, policy, arrays_s, ratings, record_only=True, fused=fused
    )
    carry = (pol_state, scen_state)
    for k in range(n):
        carry, _ = episode_fn(carry, generator, None if draws is None else draws[k])
    pol_state, scen_state = carry
    return dqn_initialize_target(pol_state), scen_state


def train_scenarios_shared(
    cfg: ExperimentConfig,
    policy: Policy,
    pol_state,
    arrays_s: EpisodeArrays,
    ratings: AgentRatings,
    generator: Optional[torch.Generator],
    n_episodes: int,
    replay_s=None,
    episode_fn: Optional[Callable] = None,
    episode0: int = 0,
    draws: Optional[Sequence[EpisodeDraws]] = None,
    fused: Optional[bool] = None,
) -> Tuple[object, object, np.ndarray, np.ndarray, float]:
    """One shared learner over S scenarios for ``n_episodes`` episodes.

    Exploration decays after episode e when ``(episode0 + e) %
    min_episodes_criterion == 0`` (so after episode 0 too). ``draws``, one
    ``EpisodeDraws`` per episode, replaces ``generator``. Pass a prebuilt
    ``episode_fn`` (``make_shared_episode_fn``) to reuse it across calls;
    otherwise one is built with ``fused`` (None resolves
    ``SimConfig.fused_slot``). ``replay_s`` is the per-scenario state of
    ``init_shared_state`` (None for tabular, the ``LockstepReplay`` for DQN,
    the ``DDPGScenState`` for DDPG); DDPG anneals its OU noise where the
    discrete learners decay epsilon.

    Returns (pol_state, scen_state, rewards [episodes, S], losses
    [episodes, S], seconds); the seconds end after the device finished.
    """
    if episode_fn is None:
        episode_fn = make_shared_episode_fn(cfg, policy, arrays_s, ratings, fused=fused)
    if draws is not None and len(draws) != n_episodes:
        raise ValueError(f"need {n_episodes} EpisodeDraws, got {len(draws)}")
    decay_every = cfg.train.min_episodes_criterion
    carry = (pol_state, replay_s)
    rewards, losses = [], []
    start = _time.perf_counter()
    for e in range(n_episodes):
        carry, (r, l) = episode_fn(
            carry, generator, None if draws is None else draws[e]
        )
        if decay_every and (episode0 + e) % decay_every == 0:
            carry = (policy.decay(carry[0]), carry[1])
        rewards.append(r)
        losses.append(l)
    # One readback for the whole run; it also waits for the device.
    rewards_np = torch.stack(rewards).cpu().numpy()
    losses_np = torch.stack(losses).cpu().numpy()
    seconds = _time.perf_counter() - start
    pol_state, scen_state = carry
    return pol_state, scen_state, rewards_np, losses_np, seconds
