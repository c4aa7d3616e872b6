"""Monte-Carlo scenario batching with one shared learner.

A *scenario* is an independent draw of the synthetic load/PV/weather
generator; scenarios form the leading ``[S]`` axis of the whole simulation.
In the shared mode ported here, one set of policy parameters serves all
scenarios and each slot applies one update averaged over the scenario axis
(the "shared-critic" mode of BASELINE.md config 4): the tabular Q-learner, or
DQN with per-scenario lockstep replay. ``fused=True`` runs every slot as the
one kernel K7 (``ops/slot_fused.py``). Exploration decays on the
reference cadence (every ``min_episodes_criterion`` episodes,
community.py:279-287), starting after episode 0.

An episode is a Python loop over the 96 slots on the device; it makes no
host synchronisation inside the loop. Randomness comes from an explicit
``torch.Generator``, or from precomputed ``EpisodeDraws`` (the tests feed the
JAX package's own draws through them).
"""

from __future__ import annotations

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
        (n_actions is ``num_actions`` for tabular, 3 for DQN)
    normals: [S, 2, A] float32 standard normals for the initial (t_in, t_bm)
    replay_idx: [T, B] integer — DQN's replay sample indices per slot, each
        in [0, max(count, 1)) of that slot's ring (None for tabular and for
        the record-only warmup)
    """

    uniform: torch.Tensor
    randint: torch.Tensor
    normals: torch.Tensor
    replay_idx: Optional[torch.Tensor] = None


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


def init_shared_pol_state(
    cfg: ExperimentConfig, device="cuda", generator: Optional[torch.Generator] = None
):
    """The shared learnable state (a ``TabularState`` or a ``DQNState``,
    whose networks draw their weights from ``generator``)."""
    return init_policy_state(cfg, device=device, generator=generator)


def init_shared_state(
    cfg: ExperimentConfig, device="cuda", generator: Optional[torch.Generator] = None
) -> Tuple[object, object]:
    """(pol_state, scen_state) for ``train_scenarios_shared``:

    * tabular -> (TabularState, None): no per-scenario state;
    * dqn     -> (DQNState, LockstepReplay) with ``[cap, S, A, ...]`` rings.
    """
    pol_state = init_shared_pol_state(cfg, device=device, generator=generator)
    if cfg.train.implementation == "dqn":
        replay = lockstep_replay_init(
            cfg.sim.n_scenarios, cfg.sim.n_agents, cfg.dqn.buffer_size, OBS_DIM, 1,
            device=device,
        )
        return pol_state, replay
    return pol_state, None


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
    normals, then per slot the uniforms and random actions of every round
    and, for a DQN learn step, the B replay indices), or, when ``draws``
    (``EpisodeDraws``) is given, from it alone. Rewards are the per-scenario
    sums over slots of the agent-mean reward; losses the per-scenario means
    over slots of the learn loss. The learner state updates in place.

    ``fused`` runs every slot through the fused slot (kernel K7 on the card;
    tabular and DQN only); None resolves ``SimConfig.fused_slot``.
    ``record_only=True`` (DQN only) builds the replay-warmup episode: act and
    record transitions, no parameter update, loss 0 (the reference's
    ``init_buffers``, community.py:125-147).
    """
    impl = cfg.train.implementation
    if impl not in ("tabular", "dqn"):
        raise NotImplementedError(
            f"shared-scenario training of {impl!r} is not ported yet "
            "(ROADMAP.md, Queue 1: DDPG)"
        )
    if record_only and impl != "dqn":
        raise ValueError("record_only warmup applies to dqn only")
    if fused is None:
        fused = resolve_use_fused(cfg)
    device = arrays_s.load_w.device
    S, T, A = arrays_s.load_w.shape
    R = cfg.sim.rounds + 1 if cfg.sim.trading else 1
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
    learns_dqn = impl == "dqn" and not record_only

    def episode(carry, generator: Optional[torch.Generator] = None, draws=None):
        pol_state, scen_state = carry
        if draws is None and generator is None:
            raise ValueError("episode needs a torch.Generator or EpisodeDraws")
        if draws is not None and learns_dqn and draws.replay_idx is None:
            raise ValueError("a DQN learning episode needs EpisodeDraws.replay_idx")
        if draws is None:
            normals = torch.randn((S, 2, A), generator=generator, device=device)
        else:
            normals = draws.normals
        phys_s = init_physical(cfg, normals, (S,), device=device)
        rewards = torch.empty((T, S), dtype=torch.float32, device=device)
        losses = torch.empty((T, S), dtype=torch.float32, device=device)
        for t in range(T):
            if draws is None:
                slot_draws = (
                    torch.rand((R, S, A), generator=generator, device=device),
                    torch.randint(
                        0, n_actions, (R, S, A), generator=generator, device=device
                    ),
                )
            else:
                slot_draws = (draws.uniform[t], draws.randint[t])
            phys_s, _, outputs, tr = slot_dynamics_batched(
                cfg, policy, pol_state, phys_s, tuple(x[t] for x in xs),
                slot_draws, ratings_d, explore=True, fused=fused,
            )
            if impl == "tabular":
                pol_state, loss = _tabular_update_shared(cfg, pol_state, tr)
            elif record_only:
                scen_state = _record_shared(scen_state, tr)
                loss = torch.zeros((S,), dtype=torch.float32, device=device)
            else:
                if draws is None:
                    # The ring holds this slot's transition when it is sampled.
                    count = min(scen_state.count + 1, scen_state.capacity)
                    idx = lockstep_sample_indices(count, cfg.dqn.batch_size, generator, device)
                else:
                    idx = draws.replay_idx[t]
                pol_state, scen_state, loss = _dqn_update_shared(
                    cfg, pol_state, scen_state, tr, idx
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
    ``init_shared_state`` (None for tabular, the ``LockstepReplay`` for DQN).

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
