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

The chunked mode (``train_scenarios_chunked``) runs K chunks of S scenarios
an episode, each with traces made on the device (``device_gen.py``) and a
fresh per-chunk state, and applies the mean of the chunks' parameter
deltas; on the card each chunk is one CUDA graph replay (``graph.py``).
"""

from __future__ import annotations

import dataclasses
import time as _time
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from p2pmicrogrid_tpu_torch.config import ExperimentConfig
from p2pmicrogrid_tpu_torch.data.traces import (
    SLOTS_PER_DAY,
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
    SingleEpisodeDraws,
    init_physical,
    ratings_to,
    resolve_use_fused,
    single_chain_config,
    slot_dynamics_batched,
)
from p2pmicrogrid_tpu_torch.models.ddpg import (
    DDPGParams,
    adam_count,
    ddpg_learn_batch,
    ddpg_params_init,
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
from p2pmicrogrid_tpu_torch.models.networks import QNetwork
from p2pmicrogrid_tpu_torch.models.replay import (
    LockstepReplay,
    lockstep_replay_add,
    lockstep_replay_init,
    lockstep_replay_sample,
    lockstep_sample_indices,
    sample_indices,
)
from p2pmicrogrid_tpu_torch.models.tabular import TabularState, q_rows
from p2pmicrogrid_tpu_torch.ops._f32 import recip
from p2pmicrogrid_tpu_torch.ops.obs import discretize
from p2pmicrogrid_tpu_torch.parallel.device_gen import TraceDraws, device_episode_arrays, draw_traces
from p2pmicrogrid_tpu_torch.telemetry.async_drain import AsyncDrain
from p2pmicrogrid_tpu_torch.telemetry.device_metrics import (
    SlotTally,
    dc_add_,
    dc_from_tally,
    dc_reset_,
    dc_tally_slot_,
    dc_to_dict,
    dc_zero,
    replay_fill_fraction,
)
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
    traces: ``TraceDraws`` — the draws the episode's traces are made from
        where its episode function makes them on the device (``arrays_fn``;
        None otherwise)
    """

    uniform: Optional[torch.Tensor]
    randint: Optional[torch.Tensor]
    normals: torch.Tensor
    replay_idx: Optional[torch.Tensor] = None
    ou_normals: Optional[torch.Tensor] = None
    stripe_starts: Optional[torch.Tensor] = None
    traces: Optional[TraceDraws] = None


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
    if cfg.train.implementation == "ddpg":
        return ddpg_params_init(cfg.ddpg, cfg.sim.n_agents, generator, device=device)
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
    actor_step: Optional[bool] = None,
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

    ``actor_step`` is ``ddpg_learn_batch``'s (the delayed actor's decision
    from a count known on the host).

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
        sq = ddpg_learn_batch(d, params, take(s), take(a), take(r), take(ns), actor_step)
        # Row i of the flattened [B, S, A] sample is scenario (i // A) % S.
        scenario = (rows // A) % S
        one_hot = (scenario[:, None] == torch.arange(S, device=rows.device)).to(sq.dtype)
        hit = one_hot.sum(dim=0)
        loss = torch.where(hit > 0, (sq @ one_hot) / hit.clamp(min=1.0), sq.mean())
    elif d.share_across_agents:
        flat = lambda x: x.reshape((-1,) + tuple(x.shape[3:]))
        sq = ddpg_learn_batch(d, params, flat(s), flat(a), flat(r), flat(ns), actor_step)
        loss = sq.reshape(-1, S, A).mean(dim=(0, 2))  # [B * S * A] in (B, S, A) order
    else:
        pool = lambda x: x.movedim(2, 0).reshape((A, -1) + tuple(x.shape[3:]))
        sq = ddpg_learn_batch(d, params, pool(s), pool(a), pool(r), pool(ns), actor_step)
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
    arrays_s: Optional[EpisodeArrays],
    ratings: AgentRatings,
    settlement_hook: Optional[Callable] = None,
    record_only: bool = False,
    fused: Optional[bool] = None,
    arrays_fn: Optional[Callable[[TraceDraws], EpisodeArrays]] = None,
    n_scenarios: Optional[int] = None,
    collect_device_metrics: bool = False,
    device="cuda",
    slot_hooks=None,
) -> Callable:
    """One shared-parameter training episode over S scenarios.

    Returns ``episode(carry, generator=None, draws=None, learn_steps=None)
    -> (carry, (rewards [S], losses [S]))`` with ``carry = (pol_state,
    scen_state)`` (``init_shared_state``). Draws come from ``generator`` (a
    ``torch.Generator`` on the episode's device: the initial-temperature
    normals, the trace draws where ``arrays_fn`` makes the traces, then per
    slot the exploration draws of every round (tabular and DQN: uniforms and
    random actions; DDPG: OU normals) and, for a learn step, the B replay
    indices and DDPG's stripe offsets, each drawn as the slot needs it), or,
    when ``draws`` (``EpisodeDraws``) is given, from it alone. Rewards are
    the per-scenario sums over slots of the agent-mean reward; losses the
    per-scenario means over slots of the learn loss. The learner state
    updates in place.

    The episode's inputs are ``arrays_s`` (fixed arrays [S, T, ...] on the
    device), or, given ``arrays_fn(trace_draws) -> EpisodeArrays`` with
    ``n_scenarios`` instead, made anew every episode on ``device`` from the
    episode's ``TraceDraws`` (``device_gen.py``; one day, T = 96). Either way
    each slot reads time-major buffers allocated here once, so a CUDA graph
    of the episode reads fixed addresses (``parallel/graph.py``).

    DDPG learns at the lrs of ``auto_scale_ddpg_lrs`` for this S, which the
    episode sets on its optimizers each time it runs (the JAX package bakes
    them into its episode program). With ``actor_delay_updates`` the actor
    steps once the critic's count reaches it: ``learn_steps``, the critic's
    count before the episode as the caller knows it on the host, decides
    each slot's step there; None reads the count once, before the slots.

    ``fused`` runs every slot through the fused slot (kernel K7 on the card;
    tabular and DQN only); None resolves ``SimConfig.fused_slot``.
    ``collect_device_metrics`` writes each slot's counts (the learn step's
    loss in place of the outputs') into one ``telemetry.SlotTally`` that
    every episode reuses, as a CUDA graph of the episode needs, and returns
    the episode's ``telemetry.DeviceCounters`` as a third element of its
    outputs.
    ``settlement_hook`` is forwarded to ``slot_dynamics_batched``
    (inter-community trading, ``envs/multi_community.py``); the fused slot
    owns settlement and refuses it. ``record_only=True`` (DQN only) builds the replay-warmup episode: act and
    record transitions, no parameter update, loss 0 (the reference's
    ``init_buffers``, community.py:125-147).

    ``slot_hooks`` changes the world the slots simulate (the regime engine,
    ``regimes/train.py``): ``slot_hooks.begin(xs) -> xs'`` runs at the
    start of every episode, after its traces are in place, on the
    time-major slot inputs (the 7 ``EpisodeArrays`` fields, [T, S(, A)]) and
    returns the inputs the slots read; ``slot_hooks.slot`` replaces
    ``slot_dynamics_batched`` (same arguments and returns). Both run inside
    a CUDA graph of the episode.

    ``episode.draw(generator, replay_count=0)`` makes every draw of one
    episode up front, on the device, as one ``EpisodeDraws`` (what a CUDA
    graph of the episode reads; the chunked trainer's, ``ChunkDraws``):
    ``replay_count`` is the ring's fill count when the episode starts, which
    bounds each slot's replay indices. The generator path above draws slot
    by slot instead, which keeps the episode's draws out of device memory
    (at A=1000, S=64, rounds=2 they would be 221 MB). ``episode.n_scenarios``,
    ``episode.n_slots`` and ``episode.device`` say what it runs on.
    """
    impl = cfg.train.implementation
    if impl not in ("tabular", "dqn", "ddpg"):
        raise ValueError(f"shared-scenario training supports tabular/dqn/ddpg, got {impl!r}")
    if record_only and impl != "dqn":
        raise ValueError("record_only warmup applies to dqn only")
    if (arrays_s is None) == (arrays_fn is None):
        raise ValueError("pass exactly one of arrays_s or arrays_fn")
    if arrays_fn is not None and n_scenarios is None:
        raise ValueError("arrays_fn requires an explicit n_scenarios")
    if fused is None:
        fused = resolve_use_fused(cfg)
    if fused and impl == "ddpg":
        raise ValueError(f"fused episodes support tabular/dqn, got {impl!r}")
    if fused and settlement_hook is not None:
        raise ValueError(
            "fused episodes cannot take a settlement_hook (the fused slot owns "
            "settlement): multi-community training stays unfused"
        )
    A = cfg.sim.n_agents
    if arrays_s is not None:
        device = arrays_s.load_w.device
        S, T, A = arrays_s.load_w.shape
    else:
        device = resolve_device(device)
        S, T = n_scenarios, SLOTS_PER_DAY
    R = cfg.sim.rounds + 1 if cfg.sim.trading else 1
    cfg = auto_scale_ddpg_lrs(cfg, S)
    stripes = ddpg_stripes(cfg, S, A) if impl == "ddpg" else None
    ratings_d = ratings_to(ratings, device)
    # Time-major buffers, so each slot reads contiguous [S, ...] rows at
    # addresses fixed for the episode function's life.
    if arrays_s is not None:
        xs = tuple(x.transpose(0, 1).contiguous() for x in arrays_s)
    else:
        per_agent = ("load_w", "pv_w", "next_load_w", "next_pv_w")
        xs = tuple(
            torch.empty((T, S, A) if f in per_agent else (T, S), dtype=torch.float32, device=device)
            for f in EpisodeArrays._fields
        )
    # The random-action bound (pallas_slot.py:339-341).
    n_actions = cfg.qlearning.num_actions if impl == "tabular" else len(ACTION_VALUES)
    learns_from_replay = impl == "ddpg" or (impl == "dqn" and not record_only)
    batch_size = cfg.ddpg.batch_size if impl == "ddpg" else cfg.dqn.batch_size
    delay = cfg.ddpg.actor_delay_updates if impl == "ddpg" else 0
    tally = SlotTally(T) if collect_device_metrics else None
    slot_fn = slot_dynamics_batched if slot_hooks is None else slot_hooks.slot

    def check_draws(draws):
        missing = []
        if learns_from_replay and draws.replay_idx is None:
            missing.append("replay_idx")
        if impl == "ddpg" and draws.ou_normals is None:
            missing.append("ou_normals")
        if stripes is not None and draws.stripe_starts is None:
            missing.append("stripe_starts")
        if arrays_fn is not None and draws.traces is None:
            missing.append("traces")
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

    def draw(generator: torch.Generator, replay_count: int = 0) -> EpisodeDraws:
        """Every draw of one episode from ``generator``, made up front."""
        normals = torch.randn((S, 2, A), generator=generator, device=device)
        traces = None if arrays_fn is None else draw_traces(S, generator, device=device)
        uniform = randint = ou = idx = starts = None
        if impl == "ddpg":
            ou = torch.randn((T, R, S, A), generator=generator, device=device)
        else:
            uniform = torch.rand((T, R, S, A), generator=generator, device=device)
            randint = torch.randint(0, n_actions, (T, R, S, A), generator=generator, device=device)
        if learns_from_replay:
            # Slot t samples the ring after its add: uniform over its first
            # min(replay_count + t + 1, capacity) entries.
            cap = cfg.ddpg.buffer_size if impl == "ddpg" else cfg.dqn.buffer_size
            count = (torch.arange(1, T + 1, device=device) + replay_count).clamp_(max=cap)[:, None]
            u = torch.rand((T, batch_size), generator=generator, device=device)
            idx = torch.minimum((u * count).long(), count - 1)
            if stripes is not None:
                pool = batch_size * S * A
                starts = torch.randint(0, pool, (T, stripes[0]), generator=generator, device=device)
        return EpisodeDraws(
            uniform=uniform, randint=randint, normals=normals, replay_idx=idx,
            ou_normals=ou, stripe_starts=starts, traces=traces,
        )

    def episode(
        carry,
        generator: Optional[torch.Generator] = None,
        draws: Optional[EpisodeDraws] = None,
        learn_steps: Optional[int] = None,
    ):
        pol_state, scen_state = carry
        if draws is None and generator is None:
            raise ValueError("episode needs a torch.Generator or EpisodeDraws")
        if draws is not None:
            check_draws(draws)
            normals = draws.normals
        else:
            normals = torch.randn((S, 2, A), generator=generator, device=device)
        if arrays_fn is not None:
            traces = draws.traces if draws is not None else draw_traces(S, generator, device=device)
            for buf, x in zip(xs, arrays_fn(traces)):
                buf.copy_(x.transpose(0, 1))
        learning_rates(pol_state)
        if impl == "ddpg":
            if delay > 0 and learn_steps is None:
                learn_steps = adam_count(pol_state.critic_opt)
        phys_s = init_physical(cfg, normals, (S,), device=device)
        rewards = torch.empty((T, S), dtype=torch.float32, device=device)
        losses = torch.empty((T, S), dtype=torch.float32, device=device)
        xs_ep = xs if slot_hooks is None else slot_hooks.begin(xs)
        for t in range(T):
            phys_s, _, outputs, tr, ou = slot_fn(
                cfg, policy, pol_state, phys_s, tuple(x[t] for x in xs_ep),
                slot_draws(t, generator, draws), ratings_d, explore=True, fused=fused,
                explore_state=scen_state.ou if impl == "ddpg" else None,
                settlement_hook=settlement_hook,
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
                # The critic steps once a slot: its count after slot t's step.
                actor_step = None if delay <= 0 else learn_steps + t + 1 >= delay
                pol_state, scen_state, loss = _ddpg_update_shared(
                    cfg, pol_state, scen_state._replace(ou=ou), tr, idx, starts, actor_step
                )
            if tally is not None:
                dc_tally_slot_(tally, t, cfg, outputs, loss=loss)
            rewards[t] = outputs.reward.mean(dim=-1)
            losses[t] = loss
        ys = (rewards.sum(dim=0), losses.mean(dim=0))
        return (pol_state, scen_state), ys if tally is None else ys + (dc_from_tally(cfg, tally),)

    def learning_rates(pol_state) -> None:
        """Set the optimisers to the rates this episode learns at (DDPG)."""
        if impl == "ddpg":
            set_learning_rates(cfg.ddpg, pol_state)

    episode.draw = draw
    episode.learning_rates = learning_rates
    episode.n_scenarios = S
    episode.n_slots = T
    episode.device = device
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


def _run_episode_loop(
    episode_fn: Callable,
    carry,
    generator: Optional[torch.Generator],
    n_episodes: int,
    decay: Callable,
    episode0: int,
    draws: Optional[Sequence],
    episode_cb: Optional[Callable],
    telemetry=None,
) -> Tuple[object, np.ndarray, np.ndarray, float]:
    """The trainers' host loop (JAX source :267): ``episode_fn(carry,
    generator, draws) -> (carry, (rewards [S], losses [S], ...))`` for each
    episode, then ``carry = decay(carry)`` after episode e when ``(episode0
    + e) % min_episodes_criterion == 0`` (the caller's ``decay`` holds the
    criterion). Each episode's rewards and losses are read back through a
    depth-2 ``telemetry.AsyncDrain`` (``telemetry``'s spans and gauges):
    ``episode_cb(episode, rewards [S], losses [S], carry)`` runs on them, in
    order. The learner state updates in place, so with an ``episode_cb``,
    which may read the carry, each episode drains before the next starts.
    Returns (carry, rewards [episodes, S], losses [episodes, S], seconds);
    the seconds end after the device finished."""
    if draws is not None and len(draws) != n_episodes:
        raise ValueError(f"need {n_episodes} episode draws, got {len(draws)}")
    drain = AsyncDrain(depth=2, telemetry=telemetry)
    rewards: list = [None] * n_episodes
    losses: list = [None] * n_episodes

    def consume(e, host, carry_e):
        rewards[e], losses[e] = host
        if episode_cb is not None:
            episode_cb(episode0 + e, host[0], host[1], carry_e)

    start = _time.perf_counter()
    for e in range(n_episodes):
        with drain.dispatch_span(episode=episode0 + e):
            carry, ys = episode_fn(carry, generator, None if draws is None else draws[e])
            carry = decay(episode0 + e, carry)
        drain.push(e, (ys[0], ys[1]), lambda e_, host, c=carry: consume(e_, host, c))
        if episode_cb is not None:
            drain.flush()
    # The last readback waits for the device.
    drain.finish()
    return carry, np.stack(rewards), np.stack(losses), _time.perf_counter() - start


def _decays_after(cfg: ExperimentConfig, episode: int) -> bool:
    """Whether exploration decays after ``episode`` (community.py:279-287)."""
    every = cfg.train.min_episodes_criterion
    return bool(every) and episode % every == 0


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
    episode_cb: Optional[Callable] = None,
    draws: Optional[Sequence[EpisodeDraws]] = None,
    fused: Optional[bool] = None,
    telemetry=None,
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
    discrete learners decay epsilon. ``episode_cb(episode, rewards [S],
    losses [S], (pol_state, scen_state))`` runs after each episode, the
    rewards and losses read back for it; ``telemetry`` gets the readback's
    spans and gauges (``_run_episode_loop``).

    Returns (pol_state, scen_state, rewards [episodes, S], losses
    [episodes, S], seconds); the seconds end after the device finished.
    """
    if episode_fn is None:
        episode_fn = make_shared_episode_fn(cfg, policy, arrays_s, ratings, fused=fused)

    def decay(episode, carry):
        return (policy.decay(carry[0]), carry[1]) if _decays_after(cfg, episode) else carry

    (pol_state, scen_state), rewards, losses, seconds = _run_episode_loop(
        episode_fn, (pol_state, replay_s), generator, n_episodes, decay, episode0, draws,
        episode_cb, telemetry,
    )
    return pol_state, scen_state, rewards, losses, seconds


# --- independent mode -------------------------------------------------------------


def _per_scenario_policy(policy: Policy) -> Policy:
    """``policy`` with an act over S scenarios that each have their own
    learners: the agents of ``obs`` [S, A, 4] act as one row of S * A
    learners, scenario-major (the layout ``init_independent_state`` and
    ``convert.stacked_state_from_jax`` give), and the results come back as
    [S, A]. Its ``learn`` is ``policy``'s, on the [S * A] flattening."""

    def act(pol_state, obs, prev_frac, draws, explore, ex):
        S, A = obs.shape[:2]
        row = lambda x: None if x is None else x.reshape((1, S * A) + tuple(x.shape[2:]))
        frac, aux, q, ex = policy.act(
            pol_state, row(obs), row(prev_frac),
            None if draws is None else tuple(row(d) for d in draws), explore, row(ex),
        )
        back = lambda x: None if x is None else x.reshape(S, A)
        return back(frac), back(aux), back(q), back(ex)

    return policy._replace(act=act)


def init_independent_state(
    cfg: ExperimentConfig,
    n_scenarios: int,
    device="cuda",
    generator: Optional[torch.Generator] = None,
):
    """S independent learner states as one state of S * A per-agent
    learners, scenario-major (learner ``s * A + a`` is agent a of scenario
    s): ``init_policy_state`` at ``n_agents = S * A``, drawing from
    ``generator``. The counterpart of the JAX package's ``vmap`` of
    ``init_policy_state`` over S keys; ``convert.stacked_state_from_jax``
    takes that stack."""
    sim = dataclasses.replace(cfg.sim, n_agents=n_scenarios * cfg.sim.n_agents)
    return init_policy_state(dataclasses.replace(cfg, sim=sim), device=device, generator=generator)


def scenario_learners(pol_state, s: int, A: int):
    """Scenario s's A learners of an S * A-learner tabular or DQN state
    (``init_independent_state``'s scenario-major layout) as a state of A
    learners, for the act: its Q-table rows, or its online network's (the
    rest of a DQN state is left as it is). What the single community's act,
    and K7 at [1, A], read for that scenario."""
    rows = slice(s * A, (s + 1) * A)
    if hasattr(pol_state, "q_table"):
        return pol_state._replace(q_table=pol_state.q_table[rows].contiguous())
    k0 = pol_state.online.Dense_0.kernel
    net = QNetwork(A, k0.shape[-1], k0.shape[-2] - 1, device=k0.device)
    with torch.no_grad():
        for dst, src in zip(net.parameters(), pol_state.online.parameters()):
            dst.copy_(src[rows])
    return pol_state._replace(online=net)


def make_independent_episode_fn(
    cfg: ExperimentConfig,
    policy: Policy,
    arrays_s: EpisodeArrays,
    ratings: AgentRatings,
    fused: Optional[bool] = None,
    slot_hooks=None,
) -> Callable:
    """One training episode for each of S independent communities, each with
    its own per-agent learners (JAX source :336, the single community's
    ``run_episode`` vmapped over scenarios).

    Returns ``episode(pol_state_s, generator=None, draws=None) ->
    (pol_state_s, (rewards [S], losses [S]))``: ``pol_state_s`` holds the S
    * A learners scenario-major (``init_independent_state``). The S
    communities run as one slot over [S, A]: the single community's chain
    (``single_chain_config``: the matrix negotiation in float32, K5 and K6
    on the card, K4 from round 2; ``fused=True`` K7 with one learner per
    scenario), the act through ``_per_scenario_policy``, and each slot's
    learn step on the [S * A] flattening of the transition (``policy.learn``
    with each learner's B replay indices for DQN and DDPG). Draws come from
    ``generator`` (the initial-temperature normals [S, 2, A], then per slot
    each round's exploration draws [R, S, A] and the replay indices [S * A,
    B]) or from ``draws``, a ``SingleEpisodeDraws`` whose leaves carry a
    leading [S] axis (S episodes' draws stacked, ``normals`` included).
    Rewards are the per-scenario sums over slots of the agent-mean reward,
    losses the per-scenario means of the learn loss. The learners update in
    place. ``fused`` (tabular and DQN) None resolves ``SimConfig.fused_slot``.
    ``slot_hooks`` is ``make_shared_episode_fn``'s (the regime engine).
    """
    impl = cfg.train.implementation
    fused = resolve_use_fused(cfg) if fused is None else bool(fused)
    slot_fn = slot_dynamics_batched if slot_hooks is None else slot_hooks.slot
    if fused and impl not in ("tabular", "dqn"):
        raise ValueError(f"fused episodes support tabular/dqn, got {impl!r}")
    device = arrays_s.load_w.device
    S, T, A = arrays_s.load_w.shape
    R = cfg.sim.rounds + 1 if cfg.sim.trading else 1
    cfg_single = single_chain_config(cfg)
    lifted = _per_scenario_policy(policy)
    ratings_d = ratings_to(ratings, device)
    xs = tuple(x.transpose(0, 1).contiguous() for x in arrays_s)  # time-major
    n_actions = cfg.qlearning.num_actions if impl == "tabular" else len(ACTION_VALUES)
    B = policy.replay_batch
    need = ("ou_normals",) if impl == "ddpg" else ("uniform", "randint")
    need += ("replay_idx",) if B is not None else ()

    def episode_draws(draws: SingleEpisodeDraws):
        """The stacked draws time-major: rounds [T, R, S, A], indices [T, S * A, B]."""
        missing = [f for f in need + ("normals",) if getattr(draws, f) is None]
        if missing:
            raise ValueError(f"a {impl} episode needs SingleEpisodeDraws.{', '.join(missing)}")
        rounds = tuple(
            getattr(draws, f).permute(1, 2, 0, 3).contiguous() for f in need if f != "replay_idx"
        )
        idx = None if B is None else draws.replay_idx.transpose(0, 1).flatten(1, 2)
        return rounds, idx

    def episode(pol_state, generator: Optional[torch.Generator] = None,
                draws: Optional[SingleEpisodeDraws] = None):
        if draws is None and generator is None:
            raise ValueError("episode needs a torch.Generator or SingleEpisodeDraws")
        if draws is not None:
            rounds, idx_all = episode_draws(draws)
            normals = draws.normals
        else:
            normals = torch.randn((S, 2, A), generator=generator, device=device)
        phys = init_physical(cfg, normals, (S,), device=device)
        rewards = torch.empty((T, S), dtype=torch.float32, device=device)
        losses = torch.empty((T, S), dtype=torch.float32, device=device)
        xs_ep = xs if slot_hooks is None else slot_hooks.begin(xs)
        for t in range(T):
            if draws is not None:
                slot_draws = tuple(d[t] for d in rounds)
                idx = None if idx_all is None else idx_all[t]
            else:
                if impl == "ddpg":
                    slot_draws = (torch.randn((R, S, A), generator=generator, device=device),)
                else:
                    slot_draws = (
                        torch.rand((R, S, A), generator=generator, device=device),
                        torch.randint(0, n_actions, (R, S, A), generator=generator, device=device),
                    )
                idx = None
                if B is not None:
                    # The rings hold this slot's transition when they are sampled.
                    ring = pol_state.replay
                    count = min(ring.count + 1, ring.capacity)
                    idx = sample_indices(count, S * A, B, generator, device)
            ou = getattr(pol_state, "ou_state", None)
            phys, pol_state, out, tr, ou = slot_fn(
                cfg_single, lifted, pol_state, phys, tuple(x[t] for x in xs_ep), slot_draws,
                ratings_d, explore=True, fused=fused,
                explore_state=None if ou is None else ou.reshape(S, A),
            )
            if ou is not None:
                pol_state = pol_state._replace(ou_state=ou.reshape(-1))
            flat = lambda x: x.reshape((S * A,) + tuple(x.shape[2:]))
            pol_state, loss = policy.learn(
                pol_state, flat(tr.obs), flat(tr.aux), flat(tr.reward), flat(tr.next_obs), idx
            )
            rewards[t] = out.reward.mean(dim=-1)
            losses[t] = loss.reshape(S, A).mean(dim=-1)
        return pol_state, (rewards.sum(dim=0), losses.mean(dim=0))

    episode.n_scenarios = S
    episode.n_slots = T
    episode.device = device
    return episode


def train_scenarios_independent(
    cfg: ExperimentConfig,
    policy: Policy,
    pol_state_s,
    arrays_s: EpisodeArrays,
    ratings: AgentRatings,
    generator: Optional[torch.Generator],
    n_episodes: int,
    episode_fn: Optional[Callable] = None,
    episode0: int = 0,
    episode_cb: Optional[Callable] = None,
    telemetry=None,
    fused: Optional[bool] = None,
) -> Tuple[object, np.ndarray, np.ndarray, float]:
    """S independent learners, one episode of each a loop step (JAX source
    :376).

    ``pol_state_s`` holds the S * A per-agent learners scenario-major
    (``init_independent_state``, or ``convert.stacked_state_from_jax`` of the
    JAX package's ``vmap``-ed state). Pass a prebuilt ``episode_fn``
    (``make_independent_episode_fn``) to reuse it; otherwise one is built
    with ``fused``. Exploration decays after episode e when
    ``(episode0 + e) % min_episodes_criterion == 0``, for every learner at
    once; ``episode_cb(episode, rewards [S], losses [S], pol_state_s)`` runs
    after each episode; ``telemetry`` is ``_run_episode_loop``'s. The
    learners update in place.

    Returns (pol_state_s, rewards [episodes, S], losses [episodes, S],
    seconds); the seconds end after the device finished.
    """
    if episode_fn is None:
        episode_fn = make_independent_episode_fn(cfg, policy, arrays_s, ratings, fused=fused)

    def decay(episode, pol_state):
        return policy.decay(pol_state) if _decays_after(cfg, episode) else pol_state

    return _run_episode_loop(
        episode_fn, pol_state_s, generator, n_episodes, decay, episode0, None, episode_cb,
        telemetry,
    )


# --- chunked aggregate-scenario training --------------------------------------


class ChunkDraws(NamedTuple):
    """Every random draw of one chunk, made up front.

    ou_init: [S, A] float32 standard normals — DDPG's initial OU noise (None
        otherwise)
    warmup: one ``EpisodeDraws`` per DQN record-only pass (empty otherwise)
    episode: the learning episode's ``EpisodeDraws``, with its ``traces``
    """

    ou_init: Optional[torch.Tensor]
    warmup: Tuple[EpisodeDraws, ...]
    episode: EpisodeDraws


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """splitmix64's finaliser on uint64 arrays (wrapping arithmetic)."""
    x = x + np.uint64(0x9E3779B97F4A7C15)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def chunk_seed_schedule(seed: int, episode0: int, n_episodes: int, n_chunks: int) -> np.ndarray:
    """Every (episode, chunk) seed of a chunked run at once: [E, K] int64,
    chunk c of episode ``episode0 + e`` hashing (seed, episode, chunk) with
    splitmix64, on the host. The counterpart of the JAX package's
    ``chunk_key_schedule`` (``fold_in(fold_in(key, episode), chunk)``): the
    port draws from ``torch.Generator``s seeded with these, not from
    threefry keys."""
    if seed < 0:
        raise ValueError(f"seed must be non-negative, got {seed}")
    episodes = np.arange(episode0, episode0 + n_episodes, dtype=np.uint64)[:, None]
    chunks = np.arange(n_chunks, dtype=np.uint64)[None, :]
    mixed = _splitmix64(_splitmix64(_splitmix64(np.array([seed], np.uint64)) + episodes) + chunks)
    return (mixed >> np.uint64(1)).astype(np.int64)


def _adam_leaves(opt: torch.optim.Adam, net: torch.nn.Module) -> List[Tuple[torch.Tensor, bool]]:
    """Adam's moments and step count for each of ``net``'s parameters, with
    the state torch would make at the first step made now where there is none
    yet, so that the chunk average and a CUDA graph see it."""
    leaves = []
    for p in net.parameters():
        st = opt.state[p]
        if not st:
            on = p.device if opt.defaults["capturable"] else "cpu"
            st["step"] = torch.zeros((), dtype=torch.float32, device=on)
            st["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
            st["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
        leaves += [(st["exp_avg"], False), (st["exp_avg_sq"], False), (st["step"], True)]
    return leaves


def learner_leaves(pol_state) -> List[Tuple[torch.Tensor, bool]]:
    """Every tensor of a shared learner state that the chunked update
    averages (what the JAX package's ``tree_map`` covers), each with whether
    it is an Adam step count: the tabular Q-table; DQN's online and target
    networks; DDPG's actor, critic and both targets; each Adam's moments and
    count; and the exploration scale (``epsilon``, ``noise_scale``)."""
    if isinstance(pol_state, TabularState):
        return [(pol_state.q_table, False), (pol_state.epsilon, False)]
    if isinstance(pol_state, DQNState):
        nets = (pol_state.online, pol_state.target)
        opts = ((pol_state.opt_state, pol_state.online),)
        scale = pol_state.epsilon
    elif isinstance(pol_state, DDPGParams):
        nets = (pol_state.actor, pol_state.critic, pol_state.actor_target, pol_state.critic_target)
        opts = ((pol_state.actor_opt, pol_state.actor), (pol_state.critic_opt, pol_state.critic))
        scale = pol_state.noise_scale
    else:
        raise TypeError(f"no chunked update for {type(pol_state).__name__}")
    leaves = [(p.data, False) for net in nets for p in net.parameters()]
    for opt, net in opts:
        leaves += _adam_leaves(opt, net)
    return leaves + [(scale, False)]


def _learning_rates(pol_state) -> Tuple[float, ...]:
    """Every learning rate of the learner's optimisers (none for tabular)."""
    if isinstance(pol_state, DDPGParams):
        opts = (pol_state.actor_opt, pol_state.critic_opt)
    elif isinstance(pol_state, DQNState):
        opts = (pol_state.opt_state,)
    else:
        opts = ()
    return tuple(g["lr"] for opt in opts for g in opt.param_groups)


def _tensors(tree) -> List[torch.Tensor]:
    """The tensors of a tree of NamedTuples and tuples, in order (other
    leaves, such as a ring's integer cursor, are skipped)."""
    if torch.is_tensor(tree):
        return [tree]
    if not isinstance(tree, tuple):
        return []
    return [t for x in tree for t in _tensors(x)]


def _map_tensors(fn: Callable, tree):
    """The tree with ``fn`` applied to each tensor."""
    if torch.is_tensor(tree):
        return fn(tree)
    if not isinstance(tree, tuple):
        return tree
    items = [_map_tensors(fn, x) for x in tree]
    return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)


def make_device_episode_fn(
    cfg: ExperimentConfig,
    policy: Policy,
    ratings: AgentRatings,
    record_only: bool = False,
    device="cuda",
    collect_device_metrics: bool = False,
) -> Callable:
    """``make_shared_episode_fn`` over ``cfg.sim.n_scenarios`` scenarios
    whose traces are made on ``device`` each episode
    (``device_gen.py::device_episode_arrays``), the ratings copied there
    once: the chunked trainer's episode function (``SimConfig.fused_slot``
    selects the fused slot; ``collect_device_metrics`` is
    ``make_shared_episode_fn``'s)."""
    dev = resolve_device(device)
    S = cfg.sim.n_scenarios
    ratings_d = ratings_to(ratings, dev)
    return make_shared_episode_fn(
        cfg, policy, None, ratings, record_only=record_only,
        arrays_fn=lambda d: device_episode_arrays(cfg, ratings_d, S, draws=d),
        n_scenarios=S, collect_device_metrics=collect_device_metrics, device=dev,
    )


def make_chunked_episode_runner(
    cfg: ExperimentConfig,
    episode_fn: Callable,
    n_chunks: int,
    warmup_fn: Optional[Callable] = None,
    chunk_parallel: int = 1,
    graph: Optional[bool] = None,
    collect_device_metrics: bool = False,
) -> Callable:
    """The K-chunk episode: each chunk runs one episode from the episode's
    starting state theta0 on its own fresh per-chunk state, and the update is
    theta0 + mean_c(theta_c - theta0) over every leaf of ``learner_leaves``
    (JAX source :1099-1255).

    ``runner(theta0, seeds=None, draws=None, learn_steps=None) -> (state,
    rewards [K*S], losses [K*S])`` in chunk-major order. Chunk c's draws come
    from a ``torch.Generator`` seeded with ``seeds[c]`` (``ChunkDraws``:
    DDPG's initial OU normals, then each DQN warmup pass's draws, then the
    learning episode's), or are ``draws[c]`` (``ChunkDraws``; the tests feed
    the JAX package's own through them). A chunk zeroes the runner's replay
    ring (``init_scen_state_only``'s fresh state, its buffers allocated
    once), runs ``cfg.dqn.warmup_passes`` record-only passes of
    ``warmup_fn`` for DQN (JAX source :1173-1182; only the ring fills), then
    ``episode_fn`` (a ``make_shared_episode_fn``). ``learn_steps`` is the DDPG
    critic's Adam count at theta0, where ``actor_delay_updates`` needs it
    (None reads it once).

    The deltas are summed in chunk order from zero and scaled by the float32
    reciprocal of K; Adam's step counts are truncated back to integers, as
    the JAX package's ``(b + a / K).astype(b.dtype)`` does. The state
    updates in place: the runner returns the learner state it holds.

    ``graph`` (default: on a CUDA device) runs each chunk as the replay of
    one CUDA graph of the whole chunk (``parallel/graph.py``), captured at
    the first call, one for each pattern of the delayed actor's steps;
    ``runner.graphs`` holds the captures. Without it the chunks run eagerly:
    the reference the graph is held to.

    ``collect_device_metrics`` (with an ``episode_fn`` built with it) makes
    the runner return ``(state, rewards, losses, counters, fills)``: the
    chunks' ``telemetry.DeviceCounters`` summed on the device (each chunk's
    added to the runner's total after its replay, before the next replay
    overwrites them) and each chunk's replay fill fraction [K], a CPU
    tensor (0 for tabular): every chunk fills a fresh ring over the same
    slots, and the ring's count is a host integer.

    ``chunk_parallel`` other than 1 (the JAX package's vmapped chunks) is
    not ported: it raises ``NotImplementedError`` (ROADMAP.md, Queue 1).
    """
    if chunk_parallel != 1:
        raise NotImplementedError(
            f"chunk_parallel={chunk_parallel}: only chunk_parallel=1 is ported "
            "(ROADMAP.md, Queue 1, chunk_parallel > 1)"
        )
    if n_chunks < 1:
        raise ValueError(f"n_chunks must be >= 1, got {n_chunks}")
    from p2pmicrogrid_tpu_torch.parallel import graph as cuda_graph

    impl = cfg.train.implementation
    device = episode_fn.device
    S, T, A = episode_fn.n_scenarios, episode_fn.n_slots, cfg.sim.n_agents
    use_graph = device.type == "cuda" if graph is None else graph
    if use_graph and device.type != "cuda":
        raise ValueError(f"a CUDA graph needs an episode on a CUDA device, got {device}")
    n_warm = cfg.dqn.warmup_passes if impl == "dqn" and warmup_fn is not None else 0
    delay = cfg.ddpg.actor_delay_updates if impl == "ddpg" else 0
    # The per-chunk replay ring, allocated once and zeroed by every chunk.
    capacity = {"dqn": cfg.dqn.buffer_size, "ddpg": cfg.ddpg.buffer_size}.get(impl)
    ring = None if capacity is None else lockstep_replay_init(S, A, capacity, OBS_DIM, 1, device=device)
    generator = torch.Generator(device=device)
    graphs = {}
    dc_tot = dc_zero(device) if collect_device_metrics else None

    def draw_chunk(seed: int) -> ChunkDraws:
        generator.manual_seed(int(seed))
        ou = torch.randn((S, A), generator=generator, device=device) if impl == "ddpg" else None
        warm = tuple(warmup_fn.draw(generator) for _ in range(n_warm))
        return ChunkDraws(ou, warm, episode_fn.draw(generator, replay_count=n_warm * T))

    def fresh_scen(ou_init):
        """The chunk's fresh per-scenario state (``init_scen_state_only``'s)
        in the runner's ring."""
        if ring is None:
            return None
        for buf in _tensors(ring):
            buf.zero_()
        if impl == "dqn":
            return ring
        return DDPGScenState(replay=ring, ou=cfg.ddpg.ou_init_sd * ou_init)

    def run_chunk(theta, cd: ChunkDraws, learn_steps):
        """(rewards [S], losses [S]), with the chunk's counters (the episode
        function's own tensors) and its ring's fill when collecting."""
        carry = (theta, fresh_scen(cd.ou_init))
        for wd in cd.warmup:
            carry, _ = warmup_fn(carry, draws=wd)
        (_, scen), ys = episode_fn(carry, draws=cd.episode, learn_steps=learn_steps)
        if not collect_device_metrics:
            return ys[0], ys[1]
        if len(ys) < 3:
            raise ValueError("collect_device_metrics needs an episode_fn built with collect_device_metrics=True")
        fill = replay_fill_fraction(scen)
        return ys[0], ys[1], ys[2], 0.0 if fill is None else fill

    def captured_for(key, theta0, snap, cd0, learn_steps):
        """The chunk graph for this actor-step pattern, captured on first use
        with theta0 as the state it holds."""
        if key not in graphs:
            live = [x for x, _ in learner_leaves(theta0)]
            static = _map_tensors(torch.clone, cd0)

            def stage():
                torch._foreach_copy_(live, snap)
                torch._foreach_copy_(_tensors(static), _tensors(cd0))

            cap = cuda_graph.capture(lambda: run_chunk(theta0, static, learn_steps), stage)
            graphs[key] = (cap, theta0, static, _learning_rates(theta0))
        return graphs[key]

    def runner(theta0, seeds=None, draws=None, learn_steps: Optional[int] = None):
        if (seeds is None) == (draws is None):
            raise ValueError("pass exactly one of seeds or draws")
        chunks = list(seeds if draws is None else draws)
        if len(chunks) != n_chunks:
            raise ValueError(f"need {n_chunks} chunk seeds or ChunkDraws, got {len(chunks)}")
        chunk_draws = (lambda c: chunks[c]) if draws is not None else (lambda c: draw_chunk(chunks[c]))
        if delay > 0 and learn_steps is None:
            learn_steps = adam_count(theta0.critic_opt)
        snap = [x.clone() for x, _ in learner_leaves(theta0)]
        cd = chunk_draws(0)
        live = theta0
        if use_graph:
            # The delayed actor steps from slot `key` on in every chunk.
            key = 0 if delay <= 0 else min(max(delay - learn_steps - 1, 0), T)
            cap, live, static, lrs = captured_for(key, theta0, snap, cd, learn_steps)
        leaves = learner_leaves(live)
        live_t = [x for x, _ in leaves]
        acc = [torch.zeros_like(x) for x in snap]
        rewards = torch.empty((n_chunks, S), dtype=torch.float32, device=device)
        losses = torch.empty((n_chunks, S), dtype=torch.float32, device=device)
        fills = torch.zeros((n_chunks,), dtype=torch.float32)
        if dc_tot is not None:
            dc_reset_(dc_tot)
        for c in range(n_chunks):
            if c:
                cd = chunk_draws(c)
            torch._foreach_copy_(live_t, snap)
            if use_graph:
                # Another runner on this state may have set other rates.
                episode_fn.learning_rates(live)
                if _learning_rates(live) != lrs:
                    raise RuntimeError(
                        f"learning rates {_learning_rates(live)} differ from the captured {lrs}"
                    )
                torch._foreach_copy_(_tensors(static), _tensors(cd))
                cuda_graph.replay(cap)
                out = cap.outputs
            else:
                out = run_chunk(live, cd, learn_steps)
            rewards[c].copy_(out[0])
            losses[c].copy_(out[1])
            if dc_tot is not None:
                dc_add_(dc_tot, out[2])
                fills[c] = out[3]
            torch._foreach_add_(acc, torch._foreach_sub(live_t, snap))
        scale = recip(n_chunks)
        for (x, is_count), b, a in zip(leaves, snap, acc):
            new = b + a * scale
            x.copy_(torch.trunc(new) if is_count else new)
        if dc_tot is None:
            return live, rewards.reshape(-1), losses.reshape(-1)
        counters = type(dc_tot)(*(x.clone() for x in dc_tot))
        return live, rewards.reshape(-1), losses.reshape(-1), counters, fills

    runner.graphs = graphs
    runner.episode_fn = episode_fn
    return runner


def train_scenarios_chunked(
    cfg: ExperimentConfig,
    policy: Policy,
    pol_state,
    ratings: AgentRatings,
    seed: int,
    n_episodes: int,
    n_chunks: int,
    episode0: int = 0,
    chunk_seed_fn: Optional[Callable[[int, int, int], int]] = None,
    runner: Optional[Callable] = None,
    chunk_parallel: int = 1,
    draws: Optional[Sequence[Sequence[ChunkDraws]]] = None,
    graph: Optional[bool] = None,
    device="cuda",
    *,
    episode_cb: Optional[Callable] = None,
    telemetry=None,
    pipeline: bool = True,
    carry_sync: Optional[Callable[[int], bool]] = None,
    drain: Optional[AsyncDrain] = None,
    finalize: bool = True,
) -> Tuple[object, object, object, float]:
    """Aggregate-scenario training: ``n_chunks x cfg.sim.n_scenarios``
    Monte-Carlo scenarios an episode through one chunk-sized episode
    function (JAX source :1257-1475).

    Each chunk makes its own traces on ``device`` (``device_gen.py``) and
    trains a whole episode from the episode's starting state; the applied
    update is the mean of the chunks' parameter deltas
    (``make_chunked_episode_runner``). Exploration decays after episode e
    when ``(episode0 + e) % min_episodes_criterion == 0``. Chunk c of
    episode e draws from ``chunk_seed_schedule(seed, ...)[e, c]`` (keyed by
    the absolute episode, so a resumed run draws what the whole run would),
    or from ``chunk_seed_fn(seed, episode0 + e, c)`` (the tests collapse
    chunks onto one draw with it), or from ``draws[e][c]`` (``ChunkDraws``).
    Pass a prebuilt ``runner`` to reuse it, and its captured graphs, across
    calls; otherwise one is built on ``device`` with ``graph`` (default: a
    CUDA graph on the card, ``parallel/graph.py``). DQN chunks warm their fresh replay with
    ``cfg.dqn.warmup_passes`` record-only passes. ``chunk_parallel`` other
    than 1 raises ``NotImplementedError``.

    Every episode's records are read back through a ``telemetry.AsyncDrain``
    (``drain``, or one of depth 2 with ``pipeline``, else 1):
    ``episode_cb(episode, rewards [K*S], losses [K*S], pol_state)`` runs on
    them in order. The learner state updates in place, so a callback that
    reads it needs its episode drained before the next starts:
    ``carry_sync(episode) -> bool`` marks those (checkpoint cadence); with an
    ``episode_cb`` and no ``carry_sync`` every episode is. ``telemetry``
    turns on the device counters of the episodes this function builds
    (a prebuilt ``runner`` must collect them itself): each episode records
    its ``device.*`` counters, a ``replay.fill_fraction`` gauge and a
    ``device_counters`` event (``phase: "train"``).

    Returns (pol_state, rewards [episodes, K*S], losses [episodes, K*S],
    seconds): chunk-major per-scenario records, the seconds ending after the
    device finished. With ``finalize=False`` the caller owns ``drain``:
    nothing is flushed, and rewards and losses are lists that its consumers
    fill, complete after the caller's ``drain.flush()``
    (``train/health.py::train_chunked_with_health``). The learner state
    updates in place.
    """
    if chunk_parallel != 1:
        raise NotImplementedError(
            f"chunk_parallel={chunk_parallel}: only chunk_parallel=1 is ported "
            "(ROADMAP.md, Queue 1, chunk_parallel > 1)"
        )
    if draws is not None and len(draws) != n_episodes:
        raise ValueError(f"need {n_episodes} lists of ChunkDraws, got {len(draws)}")
    if runner is None:
        collect = telemetry is not None
        episode_fn = make_device_episode_fn(cfg, policy, ratings, device=device, collect_device_metrics=collect)
        warmup_fn = None
        if cfg.train.implementation == "dqn" and cfg.dqn.warmup_passes > 0:
            warmup_fn = make_device_episode_fn(cfg, policy, ratings, record_only=True, device=device)
        runner = make_chunked_episode_runner(
            cfg, episode_fn, n_chunks, warmup_fn, graph=graph, collect_device_metrics=collect
        )
    if draws is None and chunk_seed_fn is None:
        seeds = chunk_seed_schedule(seed, episode0, n_episodes, n_chunks)
    elif draws is None:
        seeds = [[chunk_seed_fn(seed, episode0 + e, c) for c in range(n_chunks)] for e in range(n_episodes)]
    learn_steps = None
    if cfg.train.implementation == "ddpg" and cfg.ddpg.actor_delay_updates > 0:
        # Read once: each episode adds one critic step a slot.
        learn_steps = adam_count(pol_state.critic_opt)
    if carry_sync is None and episode_cb is not None:
        carry_sync = lambda episode: True
    if drain is None:
        drain = AsyncDrain(depth=2 if pipeline else 1, telemetry=telemetry)
    decay_every = cfg.train.min_episodes_criterion
    rewards: list = [None] * n_episodes
    losses: list = [None] * n_episodes

    def consume(e, host, carry_e):
        r, l = host[0], host[1]
        if len(host) > 2 and telemetry is not None:
            dcd = dc_to_dict(host[2])
            # Every chunk fills a fresh ring over the same slots: the mean
            # is the episode's replay saturation.
            fill = float(host[3].mean())
            telemetry.record_device_counters(dcd)
            telemetry.gauge("replay.fill_fraction", fill)
            telemetry.event(
                "device_counters", episode=episode0 + e, phase="train",
                replay_fill_fraction=round(fill, 4), **dcd,
            )
        rewards[e] = r
        losses[e] = l
        if episode_cb:
            episode_cb(episode0 + e, r, l, carry_e)

    start = _time.perf_counter()
    for e in range(n_episodes):
        with drain.dispatch_span(episode=episode0 + e):
            if draws is None:
                out = runner(pol_state, seeds=seeds[e], learn_steps=learn_steps)
            else:
                out = runner(pol_state, draws=draws[e], learn_steps=learn_steps)
            pol_state = out[0]
            if learn_steps is not None:
                learn_steps += runner.episode_fn.n_slots
            if decay_every and (episode0 + e) % decay_every == 0:
                pol_state = policy.decay(pol_state)
        payload = out[1:3] if telemetry is None else out[1:]
        drain.push(e, payload, lambda e_, host, c=pol_state: consume(e_, host, c))
        if carry_sync is not None and carry_sync(episode0 + e):
            drain.flush()
    if not finalize:
        return pol_state, rewards, losses, _time.perf_counter() - start
    # The last readback waits for the device.
    drain.finish()
    return pol_state, np.stack(rewards), np.stack(losses), _time.perf_counter() - start
