"""The single community's training and evaluation loops.

The port of the JAX package's ``train/loop.py`` (the reference's
``community.main`` episode loop, community.py:272-298; ``init_buffers``' DQN
warmup, community.py:125-147; ``load_and_run``'s per-day greedy evaluation,
community.py:364-412).

An episode is a Python loop over the 96 slots (``envs/community.py::
run_episode``); a block of ``episodes_per_jit_block`` episodes runs without
a host synchronisation, decays exploration inside the block on the
reference cadence, and is read back once, through the async drain
(``telemetry/async_drain.py``). Draws come from a
``torch.Generator`` or are injected (``SingleEpisodeDraws``; the tests feed
the JAX package's own). The learner state updates in place: copy it
(``convert.state_from_jax(convert.state_to_numpy(s), ...)``) to keep the
caller's.
"""

from __future__ import annotations

import collections
import contextlib
import inspect
import statistics
import time as _time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from p2pmicrogrid_tpu_torch.config import ExperimentConfig
from p2pmicrogrid_tpu_torch.data.traces import TraceSet
from p2pmicrogrid_tpu_torch.envs.community import (
    AgentRatings,
    EpisodeArrays,
    PhysState,
    Policy,
    SingleEpisodeDraws,
    SlotOutputs,
    build_episode_arrays,
    draw_rating_scales,
    init_physical,
    ratings_to,
    resolve_use_fused,
    run_episode,
    single_chain_config,
    slot_dynamics_batched,
)
from p2pmicrogrid_tpu_torch.models.dqn import action_values_on, dqn_initialize_target
from p2pmicrogrid_tpu_torch.models.replay import replay_add
from p2pmicrogrid_tpu_torch.ops._build import kernel_launches
from p2pmicrogrid_tpu_torch.telemetry.async_drain import AsyncDrain
from p2pmicrogrid_tpu_torch.telemetry.device_metrics import dc_add_, dc_to_dict, dc_zero
from p2pmicrogrid_tpu_torch.telemetry.profiling import profile_training


@dataclass
class TrainResult:
    """What ``train_community`` accumulates: per-episode reward and loss and
    the periodic progress records (community.py:276-296).

    ``rng_state`` is the generator's state at the end of the run (None with
    injected draws): set it on a generator to continue the run's stream.
    """

    pol_state: object
    phys: Optional[PhysState]
    episode_rewards: List[float] = field(default_factory=list)
    episode_losses: List[float] = field(default_factory=list)
    progress: List[Tuple[int, float, float]] = field(default_factory=list)
    train_seconds: float = 0.0
    env_steps: int = 0
    rng_state: Optional[torch.Tensor] = None

    @property
    def env_steps_per_sec(self) -> float:
        return self.env_steps / self.train_seconds if self.train_seconds else 0.0


def _episode_metrics(outputs: SlotOutputs) -> Tuple[torch.Tensor, torch.Tensor]:
    """Episode reward = sum over slots of the agent-mean reward
    (community.py:179); loss = the mean (community.py:180)."""
    return outputs.reward.mean(dim=-1).sum(), outputs.loss.mean()


def _initial_state(cfg, generator, draws, device) -> PhysState:
    """An episode's fresh physical state from the draws' normals [2, A] or
    the generator's (drawn on its device whether or not the community is
    homogeneous)."""
    if draws is not None:
        normals = draws.normals
    else:
        normals = torch.randn((2, cfg.sim.n_agents), generator=generator, device=generator.device)
    return init_physical(cfg, normals.to(device), device=device)


def train_block(
    cfg: ExperimentConfig,
    policy: Policy,
    pol_state,
    arrays: EpisodeArrays,
    ratings: AgentRatings,
    episode0: int,
    block: int,
    generator: Optional[torch.Generator] = None,
    draws: Optional[Sequence[SingleEpisodeDraws]] = None,
    collect_device_metrics: bool = False,
):
    """``block`` training episodes from episode ``episode0`` (the JAX
    package's ``make_train_step`` block), each from a fresh physical state,
    with no host synchronisation: returns (pol_state, last_phys, rewards
    [block], losses [block]), the rewards and losses on the device, and with
    ``collect_device_metrics`` a 5th element, the block's
    ``telemetry.DeviceCounters`` total.

    ``draws``, one ``SingleEpisodeDraws`` per episode (with ``normals``),
    replaces ``generator``. Exploration decays after episode ``episode0 + i``
    when it is a multiple of ``min_episodes_criterion`` (community.py:
    279-287), so after episode 0 too.
    """
    if draws is not None and len(draws) != block:
        raise ValueError(f"need {block} SingleEpisodeDraws, got {len(draws)}")
    criterion = cfg.train.min_episodes_criterion
    device = arrays.load_w.device
    dc_tot = dc_zero(device) if collect_device_metrics else None
    rewards, losses = [], []
    phys = None
    for i in range(block):
        d = None if draws is None else draws[i]
        phys = _initial_state(cfg, generator, d, device)
        out = run_episode(
            cfg, policy, pol_state, phys, arrays, ratings, generator, training=True, draws=d,
            collect_device_metrics=collect_device_metrics,
        )
        phys, pol_state, outputs = out[:3]
        if dc_tot is not None:
            dc_add_(dc_tot, out[3])
        reward, loss = _episode_metrics(outputs)
        rewards.append(reward)
        losses.append(loss)
        if (episode0 + i) % criterion == 0:
            pol_state = policy.decay(pol_state)
    if dc_tot is not None:
        return pol_state, phys, torch.stack(rewards), torch.stack(losses), dc_tot
    return pol_state, phys, torch.stack(rewards), torch.stack(losses)


def init_dqn_buffers(
    cfg: ExperimentConfig,
    policy: Policy,
    pol_state,
    arrays: EpisodeArrays,
    ratings: AgentRatings,
    generator: Optional[torch.Generator] = None,
    draws: Optional[Sequence[SingleEpisodeDraws]] = None,
):
    """DQN replay warmup (community.py:125-147): ``warmup_passes`` exploring
    passes that only record transitions (the action as ``ACTION_VALUES
    [aux]``, no gradient step), then a hard online -> target copy. ``draws``,
    one ``SingleEpisodeDraws`` per pass (with ``normals``, without
    ``replay_idx``), replaces ``generator``."""
    n = cfg.dqn.warmup_passes
    if draws is not None and len(draws) != n:
        raise ValueError(f"need {n} SingleEpisodeDraws, got {len(draws)}")

    def record_only(pol_state, obs, aux, reward, next_obs, idx=None):
        act_frac = action_values_on(aux.device)[aux.to(torch.int64)][:, None]
        replay = replay_add(pol_state.replay, obs, act_frac, reward, next_obs)
        return pol_state._replace(replay=replay), torch.zeros_like(reward)

    warmup_policy = Policy(act=policy.act, learn=record_only, decay=policy.decay)
    device = arrays.load_w.device
    for k in range(n):
        d = None if draws is None else draws[k]
        phys = _initial_state(cfg, generator, d, device)
        _, pol_state, _ = run_episode(
            cfg, warmup_policy, pol_state, phys, arrays, ratings, generator, training=True, draws=d
        )
    return dqn_initialize_target(pol_state)


def _checkpoint_wants_key(checkpoint_cb: Callable) -> bool:
    """Whether the callback takes a third positional argument (the
    generator's state)."""
    try:
        params = [
            p
            for p in inspect.signature(checkpoint_cb).parameters.values()
            if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD, p.VAR_POSITIONAL)
        ]
    except (TypeError, ValueError):
        return False
    return len(params) >= 3 or any(p.kind is p.VAR_POSITIONAL for p in params)


def train_community(
    cfg: ExperimentConfig,
    policy: Policy,
    pol_state,
    traces: TraceSet,
    ratings: AgentRatings,
    generator: Optional[torch.Generator] = None,
    progress_cb: Optional[Callable[[int, float, float], None]] = None,
    checkpoint_cb: Optional[Callable] = None,
    verbose: bool = False,
    telemetry=None,
    pipeline: bool = True,
    guard=None,
    fault_hook: Optional[Callable] = None,
    warmup: bool = True,
    draws: Optional[Sequence[SingleEpisodeDraws]] = None,
    warmup_draws: Optional[Sequence[SingleEpisodeDraws]] = None,
    device="cuda",
) -> TrainResult:
    """The reference's training loop for one community (community.py:
    248-298), episodes ``starting_episodes`` to ``max_episodes``.

    DQN first warms its rings (``init_dqn_buffers``; ``warmup=False`` skips
    it, as when resuming). Episodes run in blocks of
    ``episodes_per_jit_block``, the last clamped to ``max_episodes``; with a
    ``checkpoint_cb`` each block also ends on a ``save_episodes`` boundary.
    Every ``min_episodes_criterion`` episodes exploration decays (inside the
    block) and a running-average progress record ``(episode, avg reward,
    avg loss)`` is kept (and passed to ``progress_cb``); every
    ``save_episodes`` episodes ``checkpoint_cb(ep, pol_state)`` runs, or
    ``checkpoint_cb(ep, pol_state, rng_state)`` when it takes a third
    argument: the generator's state after the block (None with injected
    draws), from which a restored run continues the stream exactly
    (``train/resilience.py``).

    ``pipeline`` (default) reads the blocks back through a depth-2
    ``telemetry.AsyncDrain``: block b+1 is launched before block b's
    rewards, losses and counters are read; ``pipeline=False`` is the
    synchronous driver on the same code path (the same results). A block
    that ends on a checkpoint boundary drains before the next launch, so the
    callback sees the state after exactly its episode. ``guard`` (a
    ``resilience.DivergenceGuard``) observes each block's device counters
    before that block's checkpoint callback, so a diverged state is never
    saved. ``fault_hook(episode, pol_state)`` runs at each block start
    (``train/faults.py``); a non-None return replaces the state.
    ``telemetry`` (a ``telemetry.Telemetry``) records ``progress`` events, a
    ``train_block`` span per block, the blocks' ``device.*`` counters, the
    first block's profile (``telemetry/profiling.py``) and the run's
    ``train.seconds_total`` and ``train.env_steps_per_sec``.

    Draws come from ``generator``, or from ``draws`` (one
    ``SingleEpisodeDraws`` with ``normals`` per episode) and ``warmup_draws``
    (one per DQN warmup pass). The learner state updates in place.
    """
    t = cfg.train
    n_episodes = t.max_episodes - t.starting_episodes
    if draws is None and generator is None:
        raise ValueError("train_community needs a torch.Generator or SingleEpisodeDraws")
    if draws is not None and len(draws) != n_episodes:
        raise ValueError(f"need {n_episodes} SingleEpisodeDraws, got {len(draws)}")
    arrays = build_episode_arrays(cfg, traces, ratings, device)

    if t.implementation == "dqn" and warmup:
        pol_state = init_dqn_buffers(
            cfg, policy, pol_state, arrays, ratings,
            generator if warmup_draws is None else None, warmup_draws,
        )

    collect_dc = telemetry is not None or guard is not None
    ckpt_wants_key = checkpoint_cb is not None and _checkpoint_wants_key(checkpoint_cb)
    result = TrainResult(pol_state=pol_state, phys=None)
    window_r = collections.deque(maxlen=t.min_episodes_criterion)
    window_l = collections.deque(maxlen=t.min_episodes_criterion)
    drain = AsyncDrain(depth=2 if pipeline else 1, telemetry=telemetry)

    def consume_block(episode0_b, host, pol_state_b, rng_b):
        rewards, losses = host[0], host[1]
        if collect_dc:
            dcd = dc_to_dict(host[2])
            if telemetry is not None:
                telemetry.record_device_counters(dcd)
            if guard is not None:
                # Before the episodes below: a trip raises out of the drain
                # before this block's checkpoint can save the diverged state.
                guard.observe_counters(episode0_b + rewards.shape[0] - 1, dcd)
        for i in range(rewards.shape[0]):
            window_r.append(float(rewards[i]))
            window_l.append(float(losses[i]))
            result.episode_rewards.append(float(rewards[i]))
            result.episode_losses.append(float(losses[i]))
            ep = episode0_b + i
            # Exploration decayed in the block; the record keeps its cadence.
            if ep % t.min_episodes_criterion == 0:
                avg_r, avg_l = statistics.mean(window_r), statistics.mean(window_l)
                result.progress.append((ep, avg_r, avg_l))
                if progress_cb:
                    progress_cb(ep, avg_r, avg_l)
                if telemetry is not None:
                    telemetry.event("progress", episode=ep, avg_reward=avg_r, avg_error=avg_l)
                if verbose:
                    print(f"episode {ep}: avg reward {avg_r:.3f}, avg error {avg_l:.3f}")
            # Block ends lie on the save cadence and such a block drains
            # before the next launch, so pol_state_b is the state after ep.
            if (ep + 1) % t.save_episodes == 0 and checkpoint_cb:
                if ckpt_wants_key:
                    checkpoint_cb(ep, pol_state_b, rng_b)
                else:
                    checkpoint_cb(ep, pol_state_b)

    start = _time.perf_counter()
    episode = t.starting_episodes
    phys = None
    profiled = False
    while episode < t.max_episodes:
        if fault_hook is not None:
            mutated = fault_hook(episode, pol_state)
            if mutated is not None:
                pol_state = mutated
        step_size = min(t.episodes_per_jit_block, t.max_episodes - episode)
        if checkpoint_cb:
            # Block ends on the save cadence, so every checkpoint holds the
            # state after exactly its episode.
            step_size = min(step_size, t.save_episodes - episode % t.save_episodes)
        i0 = episode - t.starting_episodes
        block_draws = None if draws is None else draws[i0 : i0 + step_size]
        profile = telemetry is not None and not profiled
        launches0 = kernel_launches() if profile else None
        block_span = (
            telemetry.span("train_block", episode0=episode, episodes=step_size)
            if telemetry is not None
            else contextlib.nullcontext()
        )
        with block_span, drain.dispatch_span(episode=episode):
            out = train_block(
                cfg, policy, pol_state, arrays, ratings, episode, step_size,
                None if draws is not None else generator, block_draws,
                collect_device_metrics=collect_dc,
            )
        pol_state, phys = out[0], out[1]
        if profile:
            # One episode's kernel launches, from the first block.
            profiled = True
            profile_training(
                "episode_scan", telemetry,
                launches={k: (n - launches0[k]) // step_size for k, n in kernel_launches().items()},
                extra={"episodes_per_block": step_size, "slots_per_episode": arrays.time.shape[0]},
            )
        rng_state = None if draws is not None else generator.get_state()
        drain.push(
            episode, out[2:],
            lambda e0, host, ps=pol_state, rng=rng_state: consume_block(e0, host, ps, rng),
        )
        if checkpoint_cb and (episode + step_size) % t.save_episodes == 0:
            # This block's consumption checkpoints: drain before the next
            # launch changes the state the callback must save.
            drain.flush()
        episode += step_size
    drain.finish()
    result.train_seconds = _time.perf_counter() - start
    result.env_steps = (episode - t.starting_episodes) * arrays.time.shape[0]
    result.pol_state = pol_state
    result.phys = phys
    result.rng_state = None if draws is not None else generator.get_state()
    if telemetry is not None:
        telemetry.gauge("train.seconds_total", result.train_seconds)
        telemetry.gauge("train.env_steps_per_sec", result.env_steps_per_sec)
    return result


def evaluate_community(
    cfg: ExperimentConfig,
    policy: Policy,
    pol_state,
    traces: TraceSet,
    ratings: AgentRatings,
    generator: Optional[torch.Generator] = None,
    normals: Optional[torch.Tensor] = None,
    redraw_profile_scales: bool = True,
    rng: Optional[np.random.Generator] = None,
    arrays_transform: Optional[Callable[[EpisodeArrays], EpisodeArrays]] = None,
    device="cuda",
) -> Tuple[np.ndarray, SlotOutputs, EpisodeArrays]:
    """Greedy per-day evaluation (community.py:364-412): each day of
    ``traces`` runs from a fresh physical state, so one day's decisions do
    not carry into the next (community.py:380).

    The days run side by side as one ``[n_days, A]`` batch of the single
    chain (the JAX package vmaps them): the matrix negotiation in float32,
    no exploration, no learning. ``redraw_profile_scales`` redraws each
    day's load and PV scales ~N(0.7,0.2)/N(4,0.2) kW from ``rng`` (default
    ``np.random.default_rng(0)``) as community.py:386-391 does, keeping the
    ratings' ``max_in``/``max_out``. The initial-temperature normals
    ``normals`` [n_days, 2, A] come from ``generator`` when not given.
    ``arrays_transform`` maps each day's ``EpisodeArrays`` (e.g.
    ``with_pv_drop``). ``SimConfig.fused_slot`` runs the slots through K7
    at [n_days, A].

    Returns (days, outputs with leaves [n_days, T, ...], the stacked day
    arrays [n_days, T, ...]).
    """
    by_day = traces.split_by_day()
    days = np.array(sorted(by_day), dtype=np.int32)
    D, A = len(days), cfg.sim.n_agents
    gen = rng if rng is not None else np.random.default_rng(0)
    day_arrays = []
    for d in days:
        r = ratings
        if redraw_profile_scales:
            load_r, pv_r = draw_rating_scales(cfg, gen)
            r = AgentRatings(
                load_rating_w=(load_r * 1e3).astype(np.float32),
                pv_rating_w=(pv_r * 1e3).astype(np.float32),
                max_in=ratings.max_in,
                max_out=ratings.max_out,
            )
        arrays = build_episode_arrays(cfg, by_day[int(d)], r, device)
        if arrays_transform is not None:
            arrays = arrays_transform(arrays)
        day_arrays.append(arrays)
    stacked = EpisodeArrays(*(torch.stack(leaves) for leaves in zip(*day_arrays)))
    dev = stacked.load_w.device
    if normals is None:
        if generator is None:
            raise ValueError("evaluate_community needs a torch.Generator or normals")
        normals = torch.randn((D, 2, A), generator=generator, device=dev)
    use_fused = resolve_use_fused(cfg)
    ratings_d = ratings_to(ratings, dev)
    xs = tuple(x.transpose(0, 1).contiguous() for x in stacked)  # time-major
    phys = init_physical(cfg, normals, (D,), device=dev)
    outs = []
    cfg_single = single_chain_config(cfg)
    for t in range(xs[0].shape[0]):
        phys, pol_state, out, _, _ = slot_dynamics_batched(
            cfg_single, policy, pol_state, phys, tuple(x[t] for x in xs), None, ratings_d,
            explore=False, fused=use_fused,
        )
        outs.append(out)
    outputs = SlotOutputs(*(torch.stack(leaf, dim=1) for leaf in zip(*outs)))
    return days, outputs, stacked
