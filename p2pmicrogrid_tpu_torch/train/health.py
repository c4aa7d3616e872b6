"""The training-health surface of the chunked trainer.

The port of the JAX package's ``train/health.py``. At the chunked scale the
training reward is noise-dominated and blind to a measured metastable
"don't-heat" basin where the greedy policy sells PV instead of heating:
community cost goes negative (looks good) while the greedy reward collapses
(comfort lost). The greedy held-out evaluation sees it:

- ``make_greedy_eval``   greedy (explore=False) episode over a fixed held-out
                         scenario set -> (community cost, reward).
- ``classify_health``    the basin/slide detector (thresholds as the JAX
                         package's, calibrated on its committed seed curves).
- ``HealthMonitor``      feeds evals to the classifier, records alerts,
                         serializes for checkpoints.
- ``train_chunked_with_health``  ``train_scenarios_chunked`` in blocks of
                         ``eval_every`` episodes with an evaluation between
                         blocks, and (opt-in) the lr-boost mitigation, a
                         second runner with its own CUDA graphs, while the
                         policy is in the basin.

Detector calibration (per-episode sums over ``slots_per_day`` slots, reward
mean over agents, cost summed over the community, both averaged over the
held-out scenarios):

===========  ==========  ============  ====================================
state        cost (EUR)   reward        example
===========  ==========  ============  ====================================
healthy      ~1000-1700   -1 .. -2      seed 0 episodes 20-240
untrained    ~2400-4800   -600..-2600   every seed at episode 0 (cost HIGH)
slide        ~500-700     -50..-200     seed 3 episodes 60-100 (recovered)
basin        < 0          -1300..-1733  seed 2 episodes 40-200
===========  ==========  ============  ====================================

Reward collapse with low or negative cost is the signature: an untrained
policy has a terrible reward too, but a high cost.
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from p2pmicrogrid_tpu_torch.config import ExperimentConfig
from p2pmicrogrid_tpu_torch.device import resolve_device
from p2pmicrogrid_tpu_torch.envs.community import init_physical, ratings_to, slot_dynamics_batched
from p2pmicrogrid_tpu_torch.parallel.device_gen import TraceDraws, device_episode_arrays, draw_traces
from p2pmicrogrid_tpu_torch.telemetry.async_drain import AsyncDrain
from p2pmicrogrid_tpu_torch.telemetry.device_metrics import (
    SlotTally,
    dc_from_tally,
    dc_tally_slot_,
    dc_to_dict,
)

# Per-slot reward thresholds (reward here is the per-episode sum over slots,
# so divide by slots_per_day before comparing). Healthy ~-0.01/slot; a deep
# comfort violation costs ~-10/slot (the x10 offset band penalty,
# ops/thermal.py); the basin sits at -14..-18/slot.
BASIN_REWARD_PER_SLOT = -2.0   # >=~20% of agent-slots in deep violation
SLIDE_REWARD_PER_SLOT = -0.25
# Cost conditions, relative to the episode-0 (untrained) greedy cost of the
# same run — scale-free across agent counts and tariffs.
BASIN_COST_FRAC = 0.10   # cost below 10% of untrained => "earning by not heating"
SLIDE_COST_FRAC = 0.50


def make_greedy_eval(
    cfg: ExperimentConfig,
    policy,
    ratings,
    s_eval: int = 8,
    eval_seed: int = 10_000,
    collect_device_metrics: bool = False,
    draws: Optional[TraceDraws] = None,
    normals: Optional[torch.Tensor] = None,
    device="cuda",
) -> Callable:
    """Greedy held-out evaluation: ``fn(pol_state) -> (cost, reward)``, 0-d
    tensors on the device.

    One explore=False episode over a fixed set of ``s_eval`` held-out
    scenarios (never trained on): the community cost (EUR, summed over slots
    and agents, mean over scenarios) and the greedy reward (summed over
    slots, mean over agents and scenarios), the two numbers whose divergence
    is the basin signature. DDPG acts through its deterministic actor. The
    scenarios come from ``device_gen``; their ``TraceDraws`` are drawn on the
    CPU from ``eval_seed`` and moved to the device, so the held-out set is
    the same on the CPU and on the card (a CUDA generator draws another
    stream), or are ``draws`` (the tests inject the JAX package's). The
    initial-temperature normals [s_eval, 2, A] likewise: drawn on the CPU
    from seed 1 (the JAX package evaluates at ``PRNGKey(1)``), or
    ``normals``.

    ``collect_device_metrics`` tallies each slot's counts
    (``telemetry.SlotTally``) and the eval returns ``(cost, reward,
    counters)``, its ``telemetry.DeviceCounters``.
    """
    dev = resolve_device(device)
    A = cfg.sim.n_agents
    if draws is None:
        draws = draw_traces(s_eval, torch.Generator().manual_seed(eval_seed), device="cpu")
    draws = TraceDraws(*(x.to(dev) for x in draws))
    if normals is None:
        normals = torch.randn((s_eval, 2, A), generator=torch.Generator().manual_seed(1))
    normals = normals.to(dev)
    ratings_d = ratings_to(ratings, dev)
    arrays = device_episode_arrays(cfg, ratings_d, s_eval, draws=draws, device=dev)
    xs = tuple(x.transpose(0, 1).contiguous() for x in arrays)  # time-major
    tally = SlotTally(xs[0].shape[0]) if collect_device_metrics else None

    def greedy_eval(pol_state):
        phys = init_physical(cfg, normals, (s_eval,), device=dev)
        cost = torch.zeros((s_eval,), dtype=torch.float32, device=dev)
        reward = torch.zeros((s_eval,), dtype=torch.float32, device=dev)
        for t in range(xs[0].shape[0]):
            phys, _, out, _, _ = slot_dynamics_batched(
                cfg, policy, pol_state, phys, tuple(x[t] for x in xs), None, ratings_d,
                explore=False,
            )
            if tally is not None:
                dc_tally_slot_(tally, t, cfg, out)
            cost += out.cost.sum(dim=-1)
            reward += out.reward.mean(dim=-1)
        c, r = cost.mean(), reward.mean()
        return (c, r, dc_from_tally(cfg, tally)) if tally is not None else (c, r)

    greedy_eval.n_slots = xs[0].shape[0]
    greedy_eval.device = dev
    return greedy_eval


def classify_health(
    cost: float, reward: float, slots: int, initial_cost: float
) -> str:
    """Classify one greedy eval point: 'healthy' | 'slide' | 'basin'.

    ``initial_cost`` is the same run's episode-0 greedy cost (the untrained
    reference point); see the module docstring's calibration table.
    """
    r_slot = reward / max(slots, 1)
    ref = abs(initial_cost)
    if r_slot < BASIN_REWARD_PER_SLOT and cost < BASIN_COST_FRAC * ref:
        return "basin"
    if r_slot < SLIDE_REWARD_PER_SLOT and cost < SLIDE_COST_FRAC * ref:
        return "slide"
    return "healthy"


class HealthPoint(NamedTuple):
    episode: int
    greedy_cost_eur: float
    greedy_reward: float
    status: str


class HealthMonitor:
    """Tracks greedy held-out evals and flags comfort collapse.

    Feed it one ``update(episode, cost, reward)`` per eval; it classifies
    against the UNTRAINED-policy greedy cost (``initial_cost`` — taken from
    the first point when starting fresh, or measured explicitly on a fresh
    init when resuming, see ``train_chunked_with_health``), remembers basin
    entry/exit episodes, and prints a loud warning to stderr on every
    non-healthy point (an alert the user sees within one eval period of
    entry — the committed seed-2 curve enters between episodes 20 and 40
    and is flagged at the first in-basin eval).
    """

    def __init__(
        self, slots: int, warn_stream=None, initial_cost=None, telemetry=None
    ):
        self.slots = slots
        self.warn_stream = warn_stream if warn_stream is not None else sys.stderr
        self.points: list[HealthPoint] = []
        self.initial_cost: Optional[float] = (
            None if initial_cost is None else float(initial_cost)
        )
        self.basin_entries: list[int] = []   # first flagged episode per entry
        self.basin_exits: list[int] = []     # first healthy episode after one
        # Optional telemetry.Telemetry: every eval point and basin
        # entry/exit is emitted as an event, so alerts land in the SAME run
        # directory (metrics.jsonl) as the training metrics instead of a
        # bespoke side file.
        self.telemetry = telemetry

    @property
    def in_basin(self) -> bool:
        return len(self.basin_entries) > len(self.basin_exits)

    def update(self, episode: int, cost: float, reward: float) -> str:
        cost, reward = float(cost), float(reward)
        if self.initial_cost is None:
            self.initial_cost = cost
        status = classify_health(cost, reward, self.slots, self.initial_cost)
        was_in_basin = self.in_basin
        if self.telemetry is not None:
            self.telemetry.event(
                "health",
                episode=episode,
                greedy_cost_eur=cost,
                greedy_reward=reward,
                status=status,
            )
        if status == "basin" and not was_in_basin:
            self.basin_entries.append(episode)
            if self.telemetry is not None:
                self.telemetry.event(
                    "basin_alert",
                    episode=episode,
                    greedy_cost_eur=cost,
                    greedy_reward=reward,
                )
                self.telemetry.counter("health.basin_entries")
            print(
                f"HEALTH ALERT (episode {episode}): greedy reward "
                f"{reward:.0f} with community cost {cost:.0f} EUR — the "
                "policy is profiting by NOT heating (comfort collapse, the "
                "metastable don't-heat basin). Mitigation: --basin-mitigate "
                "lr-boost (default for chunked ddpg; requires --chunks > 1 "
                "— non-chunked runs should rerun chunked to mitigate; "
                "measured 4.25x dwell cut). Do NOT switch to lower lrs: "
                "the 10-seed sweep "
                "(artifacts/BASIN_STATS_r05.json) measured uncapped/half-lr "
                "runs entering MORE often and staying captured at the "
                "240-episode horizon — escape is lr-limited too.",
                file=self.warn_stream, flush=True,
            )
        elif status == "slide" and not was_in_basin:
            print(
                f"health warning (episode {episode}): greedy reward "
                f"{reward:.0f} at cost {cost:.0f} EUR — comfort degrading "
                "while cost falls; watching for basin entry.",
                file=self.warn_stream, flush=True,
            )
        elif status == "healthy" and was_in_basin:
            self.basin_exits.append(episode)
            if self.telemetry is not None:
                self.telemetry.event("basin_exit", episode=episode)
            print(
                f"health: recovered at episode {episode} (greedy reward "
                f"{reward:.0f}, cost {cost:.0f} EUR).",
                file=self.warn_stream, flush=True,
            )
        self.points.append(HealthPoint(episode, cost, reward, status))
        return status

    def to_dict(self) -> dict:
        return {
            "slots": self.slots,
            "initial_cost": self.initial_cost,
            "basin_entries": self.basin_entries,
            "basin_exits": self.basin_exits,
            "points": [p._asdict() for p in self.points],
        }

    @classmethod
    def from_dict(cls, d: dict, warn_stream=None, telemetry=None) -> "HealthMonitor":
        """Rebuild a monitor from ``to_dict()`` output — the exact-resume
        path (train/checkpoint.py stores the record in the step manifest's
        ``extra``): basin entry/exit bookkeeping and the untrained-cost
        calibration survive a preemption instead of being re-derived, so a
        resumed run classifies (and mitigates) exactly like the original
        would have."""
        m = cls(
            slots=int(d.get("slots", 0)),
            warn_stream=warn_stream,
            initial_cost=d.get("initial_cost"),
            telemetry=telemetry,
        )
        m.basin_entries = [int(e) for e in d.get("basin_entries", [])]
        m.basin_exits = [int(e) for e in d.get("basin_exits", [])]
        m.points = [
            HealthPoint(
                int(p["episode"]), float(p["greedy_cost_eur"]),
                float(p["greedy_reward"]), str(p["status"]),
            )
            for p in d.get("points", [])
        ]
        return m

    def emit_summary(self) -> None:
        """Serialize through the telemetry sink (one ``health_summary``
        event in the run's metrics.jsonl) — the replacement for callers
        hand-writing ``to_dict()`` to bespoke side files."""
        if self.telemetry is not None:
            d = self.to_dict()
            d.pop("points")  # every point is already an event of its own
            self.telemetry.event("health_summary", **d)


def untrained_reference_cost(cfg: ExperimentConfig, policy, greedy_eval, seed: int = 0) -> float:
    """Greedy cost of a freshly initialised shared policy (drawn on the CPU
    from ``seed`` and moved to the eval's device): the classifier's
    calibration reference when resuming, where the restored policy's first
    eval reflects training already done."""
    from p2pmicrogrid_tpu_torch.convert import state_from_jax, state_to_numpy
    from p2pmicrogrid_tpu_torch.parallel.scenarios import init_shared_pol_state

    ref = init_shared_pol_state(cfg, "cpu", torch.Generator().manual_seed(seed))
    sub = {"ddpg": cfg.ddpg, "dqn": cfg.dqn}.get(cfg.train.implementation)
    ref = state_from_jax(state_to_numpy(ref), greedy_eval.device, cfg=sub)
    return float(greedy_eval(ref)[0])


def _lr_boosted_cfg(cfg: ExperimentConfig, mult: float) -> ExperimentConfig:
    """The auto rule's effective lrs x ``mult``, with the rule switched off
    so the episode builder does not scale them again (the mitigation's
    config)."""
    from p2pmicrogrid_tpu_torch.parallel.scenarios import auto_scale_ddpg_lrs

    scaled = auto_scale_ddpg_lrs(cfg)
    return dataclasses.replace(
        cfg,
        ddpg=dataclasses.replace(
            cfg.ddpg,
            actor_lr=scaled.ddpg.actor_lr * mult,
            critic_lr=scaled.ddpg.critic_lr * mult,
            lr_auto_scale=False,
        ),
    )


def train_chunked_with_health(
    cfg: ExperimentConfig,
    policy,
    pol_state,
    ratings,
    seed: int,
    n_episodes: int,
    n_chunks: int,
    eval_every: int = 10,
    episode0: int = 0,
    episode_cb: Optional[Callable] = None,
    chunk_parallel: int = 1,
    mitigate: str = "warn",
    lr_boost: float = 3.0,
    monitor: Optional[HealthMonitor] = None,
    health_cb: Optional[Callable] = None,
    s_eval: int = 8,
    telemetry="auto",
    pipeline: bool = True,
    carry_sync: Optional[Callable] = None,
    guard=None,
    greedy_eval: Optional[Callable] = None,
    draws=None,
    device="cuda",
    results_db: Optional[str] = None,
) -> Tuple[object, np.ndarray, np.ndarray, float, HealthMonitor]:
    """``train_scenarios_chunked`` with the health surface on (JAX source
    :357-673).

    Runs the chunked trainer in blocks of ``eval_every`` episodes; before
    the first block and after each, the greedy held-out eval
    (``make_greedy_eval``, or ``greedy_eval``) runs on the live state and
    the monitor classifies it. ``mitigate``: ``"warn"`` (alert on basin
    entry, train on unchanged) or ``"lr-boost"`` (DDPG only: while in the
    basin, train through a second runner built at the first basin entry
    from ``_lr_boosted_cfg(cfg, lr_boost)``, with its own CUDA graphs: a
    capture bakes its learning rates in). ``health_cb(point)`` fires after
    every eval. Returns (pol_state, rewards, losses, seconds, monitor);
    rewards and losses concatenate the blocks'.

    ``telemetry``: a ``telemetry.Telemetry``, None, or ``"auto"`` (a run
    directory under ``P2P_TELEMETRY_DIR`` or ``artifacts/runs``, closed
    before returning; ``P2P_TELEMETRY=0`` suppresses it). With telemetry the
    training episodes and the evals collect the device counters (events
    ``device_counters`` with ``phase`` ``train`` or ``eval``), eval points
    and basin alerts are events, blocks and evals are spans, and the first
    block's graph is profiled (``telemetry/profiling.py``).

    ``results_db``: path to a results SQLite store (``data/results.py``): an
    auto-created telemetry also streams into its warehouse tables through a
    ``SqliteSink`` (the ``--results-db`` contract of ``train``); a
    caller-supplied ``telemetry`` keeps its own sinks and ignores it.

    ``pipeline`` (default) reads the blocks and the evals back through one
    shared depth-2 drain: the eval is launched on the live state between
    blocks, before the next block changes it on the same stream, and read
    one slot later. The drain turns synchronous after each eval when
    something reads it before the next block may start: a ``guard`` (its
    trip must precede the next block's checkpoint) or ``"lr-boost"`` (the
    next block's runner depends on ``monitor.in_basin``). ``carry_sync`` and
    ``episode_cb`` go to the chunked driver. ``guard`` (a
    ``resilience.DivergenceGuard``) observes each eval's counters (with
    telemetry) and its verdict. ``draws`` (one list of ``ChunkDraws`` an
    episode) and ``greedy_eval`` replace the seeded draws and the eval (the
    tests inject the JAX package's).
    """
    from p2pmicrogrid_tpu_torch.parallel.scenarios import (
        make_chunked_episode_runner,
        make_device_episode_fn,
        train_scenarios_chunked,
    )
    from p2pmicrogrid_tpu_torch.telemetry.profiling import profile_training

    if mitigate not in ("warn", "lr-boost"):
        raise ValueError(f"mitigate must be 'warn' or 'lr-boost', got {mitigate!r}")
    if mitigate == "lr-boost" and cfg.train.implementation != "ddpg":
        raise ValueError(
            "basin mitigation 'lr-boost' is only implemented for ddpg "
            f"(got {cfg.train.implementation!r}); use 'warn'"
        )
    dev = resolve_device(device)
    S = cfg.sim.n_scenarios
    owns_telemetry = False
    if telemetry == "auto":
        from p2pmicrogrid_tpu_torch.telemetry.registry import SqliteSink, Telemetry

        telemetry = Telemetry.maybe_create(
            "train-chunked", cfg=cfg,
            extra_sinks=[SqliteSink(results_db)] if results_db else (),
            extra_manifest={
                "n_episodes": n_episodes, "n_chunks": n_chunks,
                "aggregate_scenarios": S * n_chunks, "mitigate": mitigate,
            },
        )
        owns_telemetry = telemetry is not None
    if telemetry is not None and telemetry.run_dir:
        print(f"telemetry run: {telemetry.run_dir}", file=sys.stderr, flush=True)
    collect = telemetry is not None

    def build_runner(run_cfg):
        episode_fn = make_device_episode_fn(
            run_cfg, policy, ratings, device=dev, collect_device_metrics=collect
        )
        warmup_fn = None
        if run_cfg.train.implementation == "dqn" and run_cfg.dqn.warmup_passes > 0:
            warmup_fn = make_device_episode_fn(run_cfg, policy, ratings, record_only=True, device=dev)
        return make_chunked_episode_runner(
            run_cfg, episode_fn, n_chunks, warmup_fn, chunk_parallel=chunk_parallel,
            collect_device_metrics=collect,
        )

    normal_runner = build_runner(cfg)
    boosted = None  # built at the first basin entry
    if greedy_eval is None:
        greedy_eval = make_greedy_eval(
            cfg, policy, ratings, s_eval=s_eval, collect_device_metrics=collect, device=dev
        )
    monitor = monitor or HealthMonitor(cfg.sim.slots_per_day)
    if monitor.telemetry is None:
        monitor.telemetry = telemetry
    if monitor.initial_cost is None and episode0 > 0:
        # Resuming: calibrate against a fresh init, not the restored policy.
        monitor.initial_cost = untrained_reference_cost(cfg, policy, greedy_eval, seed=cfg.train.seed)

    sync_evals = not pipeline or guard is not None or mitigate == "lr-boost"
    drain = AsyncDrain(depth=2 if pipeline else 1, telemetry=telemetry)

    def consume_eval(tag, host):
        ep = tag[1]
        c, r = host[0], host[1]
        if len(host) > 2:
            dcd = dc_to_dict(host[2])
            if telemetry is not None:
                telemetry.record_device_counters(dcd)
                telemetry.event("device_counters", episode=ep, phase="eval", **dcd)
            if guard is not None:
                guard.observe_counters(ep, dcd)
        status = monitor.update(ep, float(c), float(r))
        if guard is not None:
            guard.observe_health(ep, status)
        if health_cb:
            health_cb(monitor.points[-1])

    def dispatch_eval(ep):
        # Launch only: the readback is the drain's, one slot later. It must
        # be launched before the next block changes the state it reads.
        span = telemetry.span("greedy_eval", episode=ep) if telemetry is not None else contextlib.nullcontext()
        with span:
            out = greedy_eval(pol_state)
        drain.push(("eval", ep), out, consume_eval)
        if sync_evals:
            drain.flush()

    def push_block_record(ep0, block, r_list, l_list, secs, boosting):
        # Behind the block's own episodes in the FIFO: when this drains,
        # r_list and l_list are complete.
        def consume(_tag, _host):
            if telemetry is not None:
                telemetry.event(
                    "train_block", episode0=ep0, episodes=block, seconds=round(secs, 3),
                    mean_reward=float(np.mean(np.stack(r_list))),
                    mean_loss=float(np.mean(np.stack(l_list))), lr_boosted=boosting,
                )
                telemetry.counter("train.episodes", block)
                telemetry.histogram("train.block_seconds", secs)

        drain.push(("block", ep0), (), consume)

    block_arrays: list = []
    seconds = 0.0
    done = 0
    profiled = set()
    try:
        dispatch_eval(episode0)
        while done < n_episodes:
            block = min(eval_every, n_episodes - done)
            runner = normal_runner
            # Current here: lr-boost makes every eval synchronous.
            boosting = mitigate == "lr-boost" and monitor.in_basin
            if boosting:
                if boosted is None:
                    boosted = build_runner(_lr_boosted_cfg(cfg, lr_boost))
                runner = boosted
            span = (
                telemetry.span("train_block", episode0=episode0 + done, episodes=block, lr_boosted=boosting)
                if telemetry is not None
                else contextlib.nullcontext()
            )
            with span:
                pol_state, r, l, secs = train_scenarios_chunked(
                    cfg, policy, pol_state, ratings, seed, n_episodes=block, n_chunks=n_chunks,
                    episode0=episode0 + done, episode_cb=episode_cb, runner=runner,
                    telemetry=telemetry, pipeline=pipeline, carry_sync=carry_sync,
                    drain=drain, finalize=False,
                    draws=None if draws is None else draws[done : done + block], device=dev,
                )
            if telemetry is not None and runner.graphs and id(runner) not in profiled:
                profiled.add(id(runner))
                (cap, *_), *_ = runner.graphs.values()
                profile_training(
                    "chunk_graph_boosted" if boosting else "chunk_graph", telemetry, captured=cap,
                    launches={w.__name__: n * n_chunks for w, n in cap.launches.items()},
                    extra={"n_chunks": n_chunks, "n_scenarios": S},
                )
            push_block_record(episode0 + done, block, r, l, secs, boosting)
            block_arrays.append((r, l))
            seconds += secs
            done += block
            dispatch_eval(episode0 + done)
        drain.finish()
        rewards = np.concatenate([np.stack(r) for r, _ in block_arrays], axis=0)
        losses = np.concatenate([np.stack(l) for _, l in block_arrays], axis=0)
        if telemetry is not None:
            telemetry.gauge("train.seconds_total", seconds)
            monitor.emit_summary()
    finally:
        if owns_telemetry:
            telemetry.close()
    return pol_state, rewards, losses, seconds, monitor
