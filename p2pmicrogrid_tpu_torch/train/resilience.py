"""Training-side resilience: divergence rollback, exact resume, supervision.

The port of the JAX package's ``train/resilience.py``. Three layers:

* **DivergenceGuard** — watches the ``nonfinite_q``/``nonfinite_loss``
  device counters (``telemetry/device_metrics.py``) and the
  ``classify_health`` basin verdicts (``train/health.py``) and raises
  ``DivergenceTripped`` the moment training goes non-finite or enters the
  don't-heat basin with rollback armed. ``train_community`` runs the guard
  before each block's checkpoint callback, so a diverged state is never
  saved as good.

* **train_community_with_rollback** / **train_chunked_with_rollback** — on
  a trip: restore the newest verified checkpoint into the live state
  (``train/checkpoint.py`` falls back past corrupt steps), scale the
  effective learning rates by ``lr_drop**attempt``, branch the random
  stream deterministically (replaying the stream that diverged would
  diverge again) and re-enter, up to ``max_rollbacks`` times. Each rollback
  is a ``train.rollback`` counter, a ``rollback`` event and a span.

* **supervise** — relaunches a training child process on a crash with
  capped exponential backoff, appending ``--resume`` from the second
  attempt and exporting ``P2P_TRAIN_ATTEMPT`` so the deterministic fault
  plan (``train/faults.py``) does not fire again. With exact resume
  (``prepare_resume``) the supervised run ends in the uninterrupted run's
  state, bit for bit. ``python -m p2pmicrogrid_tpu_torch.train.resilience
  --child ...`` is a chunked training child for it (``child_main``).

Where the JAX package branches its key with ``fold_in``, the port seeds a
new generator from a hash (``branch_generator``, ``branch_seed``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

ROLLBACK_KEY_SALT = 7919  # fixed prime: rollback r branches the stream with SALT + r


class DivergenceTripped(RuntimeError):
    """Training diverged (non-finite counters / basin verdict)."""

    def __init__(self, episode: int, reason: str, counters: Optional[dict] = None):
        super().__init__(f"divergence at episode {episode}: {reason}")
        self.episode = episode
        self.reason = reason
        self.counters = counters or {}


class RollbackExhausted(RuntimeError):
    """The rollback budget ran out without recovering."""


@dataclass(frozen=True)
class GuardPolicy:
    """When to trip and how to perturb on rollback."""

    nonfinite_q_tolerance: int = 0      # trip when a block exceeds this
    nonfinite_loss_tolerance: int = 0
    trip_on_basin: bool = False         # also trip on a 'basin' health verdict
    max_rollbacks: int = 3
    lr_drop: float = 0.5                # effective lrs x lr_drop**attempt


class DivergenceGuard:
    """Feeds block counters / health verdicts to the trip rule.

    ``observe_counters(episode, counters)`` takes the per-block device-
    counter dict (``dc_to_dict``); ``observe_health(episode, status)`` takes
    a ``classify_health`` verdict. Both raise ``DivergenceTripped`` on trip
    (once — a tripped guard is spent; the rollback driver builds a fresh one
    per attempt). Trips are recorded as ``train.divergence`` counters +
    ``divergence`` events when telemetry is attached.
    """

    def __init__(self, policy: GuardPolicy = GuardPolicy(), telemetry=None):
        self.policy = policy
        self.telemetry = telemetry
        self.tripped: Optional[DivergenceTripped] = None
        self.observations = 0

    def _trip(self, episode: int, reason: str, counters: Optional[dict] = None):
        trip = DivergenceTripped(episode, reason, counters)
        self.tripped = trip
        if self.telemetry is not None:
            self.telemetry.counter("train.divergence")
            self.telemetry.event(
                "divergence", episode=episode, reason=reason, **(counters or {})
            )
        raise trip

    def observe_counters(self, episode: int, counters: dict) -> None:
        if self.tripped is not None:
            return
        self.observations += 1
        nq = int(counters.get("nonfinite_q", 0) or 0)
        nl = int(counters.get("nonfinite_loss", 0) or 0)
        if nq > self.policy.nonfinite_q_tolerance or nl > self.policy.nonfinite_loss_tolerance:
            self._trip(
                episode,
                f"nonfinite_q={nq} nonfinite_loss={nl}",
                {"nonfinite_q": nq, "nonfinite_loss": nl},
            )

    def observe_health(self, episode: int, status: str) -> None:
        if self.tripped is not None:
            return
        self.observations += 1
        if self.policy.trip_on_basin and status == "basin":
            self._trip(episode, "health classifier verdict 'basin'")


# --- deterministic perturbation ----------------------------------------------


def scaled_lr_cfg(cfg, scale: float):
    """The rollback perturbation's LR half: the implementation's effective
    learning rates x ``scale`` (tabular alpha, DQN learning_rate, DDPG
    actor/critic lrs — the auto-scale rule, where active, applies on top of
    the scaled bases, so the drop composes deterministically)."""
    if scale == 1.0:
        return cfg
    impl = cfg.train.implementation
    if impl == "tabular":
        return cfg.replace(
            qlearning=dataclasses.replace(cfg.qlearning, alpha=cfg.qlearning.alpha * scale)
        )
    if impl == "dqn":
        return cfg.replace(
            dqn=dataclasses.replace(cfg.dqn, learning_rate=cfg.dqn.learning_rate * scale)
        )
    if impl == "ddpg":
        return cfg.replace(
            ddpg=dataclasses.replace(
                cfg.ddpg,
                actor_lr=cfg.ddpg.actor_lr * scale,
                critic_lr=cfg.ddpg.critic_lr * scale,
            )
        )
    return cfg


# --- deterministic perturbation ----------------------------------------------


def scaled_lr_cfg(cfg, scale: float):
    """The rollback perturbation's LR half: the implementation's effective
    learning rates x ``scale`` (tabular alpha, DQN learning_rate, DDPG
    actor/critic lrs — the auto-scale rule, where active, applies on top of
    the scaled bases, so the drop composes deterministically)."""
    if scale == 1.0:
        return cfg
    impl = cfg.train.implementation
    if impl == "tabular":
        return cfg.replace(
            qlearning=dataclasses.replace(cfg.qlearning, alpha=cfg.qlearning.alpha * scale)
        )
    if impl == "dqn":
        return cfg.replace(
            dqn=dataclasses.replace(cfg.dqn, learning_rate=cfg.dqn.learning_rate * scale)
        )
    if impl == "ddpg":
        return cfg.replace(
            ddpg=dataclasses.replace(
                cfg.ddpg,
                actor_lr=cfg.ddpg.actor_lr * scale,
                critic_lr=cfg.ddpg.critic_lr * scale,
            )
        )
    return cfg


def apply_learning_rates(cfg, pol_state) -> None:
    """Set the state's optimisers to ``cfg``'s learning rates: torch's Adam
    keeps its rate in its param groups, where optax reads it from the
    config the policy was built with."""
    from p2pmicrogrid_tpu_torch.models.ddpg import DDPGParams, DDPGState, set_learning_rates
    from p2pmicrogrid_tpu_torch.models.dqn import DQNState

    if isinstance(pol_state, (DDPGParams, DDPGState)):
        set_learning_rates(cfg.ddpg, pol_state)
    elif isinstance(pol_state, DQNState):
        for group in pol_state.opt_state.param_groups:
            group["lr"] = cfg.dqn.learning_rate


def branch_seed(seed: int, data: int) -> int:
    """A new seed from ``seed`` and ``data`` (splitmix64, as
    ``chunk_seed_schedule`` hashes), in place of ``fold_in``."""
    from p2pmicrogrid_tpu_torch.parallel.scenarios import chunk_seed_schedule

    return int(chunk_seed_schedule(int(seed), int(data), 1, 1)[0, 0])


def branch_generator(generator, data: int):
    """A new generator on ``generator``'s device, seeded from a hash of its
    state and ``data``: a fresh stream that is a function of the old one."""
    import torch

    h = hashlib.sha256(generator.get_state().numpy().tobytes() + str(int(data)).encode())
    seed = int.from_bytes(h.digest()[:8], "big") >> 1
    return torch.Generator(device=generator.device).manual_seed(seed)


# --- exact resume ------------------------------------------------------------


@dataclass
class ResumePlan:
    """What ``prepare_resume`` decided (feeds ``train_community`` directly)."""

    pol_state: object
    cfg: object
    key: object                 # the generator (or seed) to continue with
    warmup: bool
    resumed: bool
    exact: bool
    episode: int = -1           # checkpoint episode (-1 = fresh start)
    extra: dict = field(default_factory=dict)


def prepare_resume(cfg, ckpt_dir: str, template_pol_state, base_key) -> ResumePlan:
    """Resolve a ``--resume`` request against what the checkpoint knows.

    The newest verified step is loaded into ``template_pol_state`` in place.
    A step carrying its generator state resumes exactly: ``base_key`` (a
    ``torch.Generator``) takes that state, the DQN warmup is skipped (its
    replay contents and target copy ride in the restored state), and the
    surviving episodes replay bit for bit. A step without one continues on
    a branch of ``base_key`` (a generator or an integer seed) with a fresh
    warmup: a valid continuation, not the original stream. No checkpoint at
    all gives a fresh-start plan (a child that died before its first save
    starts over).
    """
    import numpy as np
    import torch

    from p2pmicrogrid_tpu_torch.train.checkpoint import restore_resume_state

    try:
        st = restore_resume_state(ckpt_dir, template_pol_state)
    except FileNotFoundError:
        return ResumePlan(
            pol_state=template_pol_state, cfg=cfg, key=base_key,
            warmup=True, resumed=False, exact=False,
        )
    episode0 = st.episode + 1
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, starting_episodes=episode0))
    if st.rng_key is not None and isinstance(base_key, torch.Generator):
        base_key.set_state(torch.from_numpy(np.asarray(st.rng_key, dtype=np.uint8)))
        return ResumePlan(
            pol_state=st.pol_state, cfg=cfg, key=base_key, warmup=False,
            resumed=True, exact=True, episode=st.episode, extra=st.extra,
        )
    key = (
        branch_generator(base_key, episode0)
        if isinstance(base_key, torch.Generator) else branch_seed(base_key, episode0)
    )
    return ResumePlan(
        pol_state=st.pol_state, cfg=cfg, key=key, warmup=True,
        resumed=True, exact=False, episode=st.episode, extra=st.extra,
    )


def checkpoint_callback(
    ckpt_dir: str,
    cfg,
    injector=None,
    extra_fn: Optional[Callable[[], dict]] = None,
    keep_last: int = 2,
) -> Callable:
    """The resumable checkpoint callback for ``train_community``: saves the
    learner state with the generator's state (the 3-argument form: the loop
    hands over the state after the block), the ``extra_fn()`` record and the
    config hash, then runs the fault injector's post-save hooks."""
    from p2pmicrogrid_tpu_torch.train.checkpoint import save_checkpoint

    def cb(ep, ps, rng_key=None):
        step = save_checkpoint(
            ckpt_dir, ps, ep, rng_key=rng_key,
            extra=extra_fn() if extra_fn else None, cfg=cfg, keep_last=keep_last,
        )
        if injector is not None:
            injector.on_checkpoint_saved(ep, step)
            injector.on_callback(ep)
        return step

    return cb


# --- divergence rollback drivers ----------------------------------------------


@dataclass
class RollbackRecord:
    index: int                 # 1-based rollback count
    tripped_episode: int
    reason: str
    restored_episode: int      # -1 = restored the initial state
    lr_scale: float


def _record_rollback(telemetry, record: RollbackRecord, on_rollback) -> None:
    if telemetry is not None:
        telemetry.counter("train.rollback")
        telemetry.event(
            "rollback", attempt=record.index, episode=record.tripped_episode,
            restored_episode=record.restored_episode, lr_scale=record.lr_scale,
            reason=record.reason,
        )
    if on_rollback is not None:
        on_rollback(record)


def train_community_with_rollback(
    cfg,
    pol_state,
    traces,
    ratings,
    generator,
    ckpt_dir: str,
    policy_factory: Optional[Callable] = None,
    guard_policy: GuardPolicy = GuardPolicy(),
    telemetry=None,
    fault_injector=None,
    on_rollback: Optional[Callable[[RollbackRecord], None]] = None,
    warmup: bool = True,
    extra_fn: Optional[Callable[[], dict]] = None,
    keep_last: int = 2,
    **train_kw,
) -> Tuple[object, List[RollbackRecord]]:
    """``train_community`` under the divergence guard, with capped rollback.

    On a ``DivergenceTripped``: load the newest verified checkpoint into the
    live state, or the state and generator as this call received them when
    none exists yet; take the effective learning rates x
    ``lr_drop**attempt`` (set on the optimisers too); continue on
    ``branch_generator(restored generator, ROLLBACK_KEY_SALT + attempt)``;
    re-enter. ``policy_factory(cfg)`` rebuilds the policy for the scaled
    config (default ``train.make_policy``). Raises ``RollbackExhausted``
    after ``max_rollbacks`` failed recoveries. Returns ``(TrainResult,
    rollback_records)``; ``**train_kw`` goes to ``train_community``.
    """
    from p2pmicrogrid_tpu_torch.convert import load_state_, state_to_numpy
    from p2pmicrogrid_tpu_torch.train.checkpoint import restore_resume_state
    from p2pmicrogrid_tpu_torch.train.loop import train_community
    from p2pmicrogrid_tpu_torch.train.policies import make_policy

    import torch

    if policy_factory is None:
        policy_factory = make_policy
    initial = state_to_numpy(pol_state)
    initial_rng = generator.get_state()
    base_cfg = cfg
    cur_cfg, cur_ps, cur_gen, cur_warmup = cfg, pol_state, generator, warmup
    rollbacks: List[RollbackRecord] = []
    attempt = 0
    while True:
        guard = DivergenceGuard(guard_policy, telemetry=telemetry)
        ckpt_cb = checkpoint_callback(
            ckpt_dir, cur_cfg, injector=fault_injector, extra_fn=extra_fn, keep_last=keep_last
        )
        fault_hook = fault_injector.on_block_start if fault_injector is not None else None
        try:
            result = train_community(
                cur_cfg, policy_factory(cur_cfg), cur_ps, traces, ratings, cur_gen,
                checkpoint_cb=ckpt_cb, telemetry=telemetry, guard=guard,
                fault_hook=fault_hook, warmup=cur_warmup, **train_kw,
            )
            return result, rollbacks
        except DivergenceTripped as trip:
            attempt += 1
            if attempt > guard_policy.max_rollbacks:
                raise RollbackExhausted(
                    f"divergence persisted through {guard_policy.max_rollbacks} "
                    f"rollback(s); last trip: {trip}"
                ) from trip
            span = (
                telemetry.span("rollback", attempt=attempt, episode=trip.episode)
                if telemetry is not None
                else contextlib.nullcontext()
            )
            restored_gen = torch.Generator(device=generator.device)
            with span:
                try:
                    st = restore_resume_state(ckpt_dir, cur_ps)
                    restored_ep, cur_ps = st.episode, st.pol_state
                    restored_gen.set_state(torch.from_numpy(st.rng_key))
                    episode0 = st.episode + 1
                    cur_warmup = False
                except FileNotFoundError:
                    # Tripped before the first save: the initial state is
                    # the last good one.
                    restored_ep, cur_ps = -1, load_state_(cur_ps, initial)
                    restored_gen.set_state(initial_rng)
                    episode0 = base_cfg.train.starting_episodes
                    cur_warmup = warmup
            lr_scale = guard_policy.lr_drop ** attempt
            cur_cfg = scaled_lr_cfg(base_cfg, lr_scale).replace(
                train=dataclasses.replace(base_cfg.train, starting_episodes=episode0)
            )
            apply_learning_rates(cur_cfg, cur_ps)
            cur_gen = branch_generator(restored_gen, ROLLBACK_KEY_SALT + attempt)
            record = RollbackRecord(
                index=attempt, tripped_episode=trip.episode, reason=trip.reason,
                restored_episode=restored_ep, lr_scale=lr_scale,
            )
            rollbacks.append(record)
            _record_rollback(telemetry, record, on_rollback)


def train_chunked_with_rollback(
    cfg,
    pol_state,
    ratings,
    seed: int,
    ckpt_dir: str,
    n_episodes: int,
    n_chunks: int,
    eval_every: int = 10,
    episode0: int = 0,
    guard_policy: GuardPolicy = GuardPolicy(),
    telemetry=None,
    policy_factory: Optional[Callable] = None,
    on_rollback: Optional[Callable[[RollbackRecord], None]] = None,
    save_every: Optional[int] = None,
    keep_last: int = 2,
    health_cb: Optional[Callable] = None,
    episode_cb: Optional[Callable] = None,
    carry_sync: Optional[Callable] = None,
    monitor=None,
    pipeline: bool = True,
    chunk_parallel: int = 1,
    mitigate: str = "warn",
    s_eval: int = 8,
    device="cuda",
) -> Tuple[tuple, List[RollbackRecord]]:
    """``train_chunked_with_health`` under the divergence guard, with the
    same restore/perturb/re-enter discipline as
    ``train_community_with_rollback``.

    Each attempt runs the chunked trainer with a fresh ``DivergenceGuard``
    fed by the block-boundary evals. On a trip: load the newest verified
    checkpoint under ``ckpt_dir`` into the live state (the state as this
    call received it before the first save), scale the effective lrs by
    ``lr_drop**attempt``, and re-enter from the restored episode with
    ``branch_seed(seed, ROLLBACK_KEY_SALT + attempt)``: chunks are keyed by
    the absolute episode off the seed, so the surviving episodes draw a
    fresh, deterministic stream. Without a caller ``episode_cb`` the driver
    checkpoints on the ``save_every`` cadence itself (with the matching
    ``carry_sync``). Returns ``((pol_state, rewards, losses, seconds,
    monitor), rollback_records)``, the trainer's outputs the final
    attempt's.
    """
    from p2pmicrogrid_tpu_torch.convert import load_state_, state_to_numpy
    from p2pmicrogrid_tpu_torch.train.checkpoint import restore_resume_state, save_checkpoint
    from p2pmicrogrid_tpu_torch.train.health import train_chunked_with_health
    from p2pmicrogrid_tpu_torch.train.policies import make_policy

    if policy_factory is None:
        policy_factory = make_policy
    save_every = save_every or cfg.train.save_episodes
    initial = state_to_numpy(pol_state)
    base_cfg, base_episode0 = cfg, episode0
    cur_cfg, cur_ps, cur_seed = cfg, pol_state, seed
    end_episode = episode0 + n_episodes
    rollbacks: List[RollbackRecord] = []
    attempt = 0
    while True:
        guard = DivergenceGuard(guard_policy, telemetry=telemetry)
        if episode_cb is None:

            def cb(ep, r, l, carry, _cfg=cur_cfg):
                if (ep + 1) % save_every == 0:
                    save_checkpoint(ckpt_dir, carry, ep, cfg=_cfg, keep_last=keep_last)

            sync = carry_sync or (lambda ep: (ep + 1) % save_every == 0)
        else:
            cb, sync = episode_cb, carry_sync
        try:
            result = train_chunked_with_health(
                cur_cfg, policy_factory(cur_cfg), cur_ps, ratings, cur_seed,
                n_episodes=end_episode - episode0, n_chunks=n_chunks, eval_every=eval_every,
                episode0=episode0, episode_cb=cb, chunk_parallel=chunk_parallel,
                mitigate=mitigate, health_cb=health_cb,
                # The caller's monitor rides the first attempt only: after a
                # trip its history is the diverged trajectory's.
                monitor=monitor if attempt == 0 else None,
                s_eval=s_eval, telemetry=telemetry, pipeline=pipeline,
                carry_sync=sync, guard=guard, device=device,
            )
            return result, rollbacks
        except DivergenceTripped as trip:
            attempt += 1
            if attempt > guard_policy.max_rollbacks:
                raise RollbackExhausted(
                    f"divergence persisted through {guard_policy.max_rollbacks} "
                    f"rollback(s); last trip: {trip}"
                ) from trip
            span = (
                telemetry.span("rollback", attempt=attempt, episode=trip.episode)
                if telemetry is not None
                else contextlib.nullcontext()
            )
            with span:
                try:
                    st = restore_resume_state(ckpt_dir, cur_ps)
                    restored_ep, cur_ps = st.episode, st.pol_state
                    episode0 = st.episode + 1
                except FileNotFoundError:
                    restored_ep, cur_ps = -1, load_state_(cur_ps, initial)
                    episode0 = base_episode0
            lr_scale = guard_policy.lr_drop ** attempt
            cur_cfg = scaled_lr_cfg(base_cfg, lr_scale)
            cur_seed = branch_seed(seed, ROLLBACK_KEY_SALT + attempt)
            record = RollbackRecord(
                index=attempt, tripped_episode=trip.episode, reason=trip.reason,
                restored_episode=restored_ep, lr_scale=lr_scale,
            )
            rollbacks.append(record)
            _record_rollback(telemetry, record, on_rollback)


# --- crash supervisor ---------------------------------------------------------


ATTEMPT_ENV = "P2P_TRAIN_ATTEMPT"


@dataclass
class SuperviseResult:
    exit_code: int
    attempts: List[dict] = field(default_factory=list)
    kills: int = 0              # attempts that died to a signal
    resumes: int = 0            # relaunches (attempts after the first)
    rollbacks: int = 0          # train_rollback rows seen in child stdout

    @property
    def succeeded(self) -> bool:
        return self.exit_code == 0


def supervise(
    child_argv: List[str],
    max_restarts: int = 8,
    backoff_s: float = 0.5,
    backoff_cap_s: float = 8.0,
    resume_flag: Optional[str] = "--resume",
    env: Optional[dict] = None,
    emit: Optional[Callable[[dict], None]] = None,
    sleep: Callable[[float], None] = time.sleep,
    passthrough=None,
) -> SuperviseResult:
    """Run a training child under crash supervision.

    The child is relaunched on any non-zero exit (SIGKILL preemption, OOM,
    divergence the child could not roll back from) with deterministic capped
    exponential backoff (``min(backoff_cap_s, backoff_s * 2**restarts)`` —
    no jitter: replayability over thundering herds of one). From the second
    attempt on ``resume_flag`` is appended (unless already present) so the
    child continues from its newest verified checkpoint, and every attempt
    exports ``P2P_TRAIN_ATTEMPT`` so a deterministic fault plan
    (train/faults.py) fires each crash exactly once.

    Child stdout is streamed through (``passthrough``, default this
    process's stdout) and scanned for ``train_rollback`` metric rows so the
    harness can report rollback counts without a side channel. ``emit`` (if
    given) receives one ``supervise_attempt`` metric row per attempt.
    """
    out = passthrough if passthrough is not None else sys.stdout
    result = SuperviseResult(exit_code=1)
    attempt = 0
    while True:
        argv = list(child_argv)
        if attempt > 0 and resume_flag and resume_flag not in argv:
            argv.append(resume_flag)
        child_env = dict(os.environ)
        child_env.update(env or {})
        child_env[ATTEMPT_ENV] = str(attempt)
        t0 = time.time()
        proc = subprocess.Popen(
            argv, stdout=subprocess.PIPE, stderr=None, text=True, env=child_env
        )
        rollbacks_this = 0
        assert proc.stdout is not None
        for line in proc.stdout:
            out.write(line)
            if '"train_rollback"' in line:
                try:
                    row = json.loads(line)
                    if isinstance(row, dict) and row.get("metric") == "train_rollback":
                        rollbacks_this += 1
                except json.JSONDecodeError:
                    pass
        rc = proc.wait()
        duration = time.time() - t0
        row = {
            "metric": "supervise_attempt",
            "value": attempt,
            "unit": "attempt",
            "vs_baseline": 0.0,
            "exit_code": rc,
            "signal": -rc if rc < 0 else 0,
            "duration_s": round(duration, 3),
            "resumed": attempt > 0,
            "rollbacks": rollbacks_this,
        }
        result.attempts.append(row)
        result.rollbacks += rollbacks_this
        if rc < 0:
            result.kills += 1
        if attempt > 0:
            result.resumes += 1
        if emit is not None:
            emit(row)
        if rc == 0:
            result.exit_code = 0
            return result
        if attempt >= max_restarts:
            result.exit_code = rc if rc > 0 else 1
            return result
        sleep(min(backoff_cap_s, backoff_s * (2 ** attempt)))
        attempt += 1


# --- a training child for supervise -------------------------------------------


def _process_age_s() -> Optional[float]:
    """Seconds since this process started (``/proc``; None elsewhere): at
    ``child_main``'s entry, the interpreter's start and the imports."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None


def child_main(argv: Optional[List[str]] = None) -> int:
    """A chunked training child that ``supervise`` can relaunch: shared DDPG
    at A agents, S scenarios and K chunks (battery on, market "auto"), one
    ``train_scenarios_chunked`` call an episode, a verified checkpoint after
    every episode, ``--fault-plan`` (a ``TrainFaultPlan`` JSON file) fired at
    each episode's start, ``--resume`` from the newest verified step. Prints
    one JSON line after its first episode (``child_startup``: the process's
    age when training code started, i.e. interpreter start and imports; the
    kernel library's load; the graph's capture) and one when it ends
    (``child_done``: the final state's ``tree_digest``)."""
    import argparse

    import numpy as np
    import torch

    from p2pmicrogrid_tpu_torch import config as tc
    from p2pmicrogrid_tpu_torch.convert import state_from_jax, state_to_numpy
    from p2pmicrogrid_tpu_torch.envs.community import make_ratings
    from p2pmicrogrid_tpu_torch.parallel import scenarios as sc
    from p2pmicrogrid_tpu_torch.train.checkpoint import save_checkpoint, tree_digest
    from p2pmicrogrid_tpu_torch.train.faults import TrainFaultInjector, TrainFaultPlan
    from p2pmicrogrid_tpu_torch.train.policies import make_policy

    import_s = _process_age_s()
    p = argparse.ArgumentParser(prog="python -m p2pmicrogrid_tpu_torch.train.resilience")
    p.add_argument("--child", action="store_true", required=True)
    p.add_argument("--ckpt-dir", required=True)
    p.add_argument("--episodes", type=int, default=3)
    p.add_argument("--agents", type=int, default=1000)
    p.add_argument("--scenarios", type=int, default=128)
    p.add_argument("--chunks", type=int, default=8)
    p.add_argument("--buffer", type=int, default=96)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--fault-plan")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    cfg = tc.default_config(
        sim=tc.SimConfig(n_agents=args.agents, n_scenarios=args.scenarios),
        battery=tc.BatteryConfig(enabled=True),
        train=tc.TrainConfig(implementation="ddpg"),
        ddpg=tc.DDPGConfig(share_across_agents=True, buffer_size=args.buffer, batch_size=args.batch),
    )
    t1 = time.perf_counter()
    load_s = None
    if args.device != "cpu":
        from p2pmicrogrid_tpu_torch.ops.merged_min import LIBRARY

        LIBRARY.load()
        load_s = time.perf_counter() - t1
    ratings = make_ratings(cfg, np.random.default_rng(42))
    policy = make_policy(cfg)
    pol = sc.init_shared_pol_state(cfg, "cpu", torch.Generator().manual_seed(args.seed))
    pol = state_from_jax(state_to_numpy(pol), args.device, cfg=cfg.ddpg)
    episode_fn = sc.make_device_episode_fn(cfg, policy, ratings, device=args.device)
    runner = sc.make_chunked_episode_runner(cfg, episode_fn, args.chunks)
    episode0, resumed_from = 0, None
    if args.resume:
        plan = prepare_resume(cfg, args.ckpt_dir, pol, args.seed)
        pol = plan.pol_state
        if plan.resumed:
            episode0, resumed_from = plan.episode + 1, plan.episode
    injector = None
    if args.fault_plan:
        with open(args.fault_plan) as f:
            fault_plan = TrainFaultPlan.from_json(f.read())
        injector = TrainFaultInjector(fault_plan, attempt=int(os.environ.get(ATTEMPT_ENV, "0")))

    def save(ep, r, l, state):
        save_checkpoint(args.ckpt_dir, state, ep, cfg=cfg)

    capture_s = None
    for e in range(episode0, args.episodes):
        if injector is not None:
            injector.on_block_start(e, pol)
        pol, _, _, _ = sc.train_scenarios_chunked(
            cfg, policy, pol, ratings, args.seed, 1, args.chunks, episode0=e,
            runner=runner, episode_cb=save,
        )
        if capture_s is None:
            capture_s = sum(cap.capture_seconds + cap.instantiate_seconds for cap, *_ in runner.graphs.values())
            print(json.dumps({
                "child_startup": {
                    "attempt": int(os.environ.get(ATTEMPT_ENV, "0")), "import_s": import_s,
                    "library_load_s": load_s, "capture_s": capture_s, "resumed_from": resumed_from,
                }
            }), flush=True)
    digest, _ = tree_digest({"pol_state": state_to_numpy(pol)})
    print(json.dumps({"child_done": {"episodes": args.episodes, "digest": digest}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(child_main())
