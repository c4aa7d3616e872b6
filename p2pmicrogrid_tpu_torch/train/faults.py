"""Deterministic fault injection for the training tier.

The port of the JAX package's ``train/faults.py`` (the same plans, the same
JSON, the same hash-chosen episodes).

Every injected fault is a pure function of a seed, so failing runs replay
exactly. A crash-resilience claim ("SIGKILL mid-training,
auto-resume, bit-identical final params") is only testable when the kill
lands at the SAME episode every run — wall-clock kill timers would turn the
acceptance test into a flake.

Fault kinds (all single-shot per event, applied at episode boundaries):

* ``kill``                SIGKILL the training process when the loop reaches
                          the event's episode (block granularity — the hook
                          runs between blocks). ``kill_mode="raise"``
                          raises ``SimulatedPreemption`` instead, so tier-1
                          tests can exercise the full save→die→restore→resume
                          path in one process.
* ``corrupt_checkpoint``  after the checkpoint save at/after the event's
                          episode, flip bytes in the step's largest payload
                          file — the restore-time digest verification must
                          catch it and fall back (``train/checkpoint.py``).
* ``stall_callback``      sleep ``stall_s`` inside the host callback (the
                          preemption-window widener: a slow host callback is
                          exactly when SIGKILL likes to land).
* ``poison_nan``          overwrite every floating tensor of the learner
                          state with NaN, in place, at the event's episode —
                          the divergence
                          the rollback guard (``train/resilience.py``) must
                          detect via the in-program ``nonfinite_q``/
                          ``nonfinite_loss`` counters and roll back from.

**Attempts.** Crash faults must not re-fire after the supervisor relaunches
the run (a kill that fires on every attempt is a crash loop, useful only for
testing the supervisor's restart cap). Each event carries an ``attempt``
index: ``None`` fires on every attempt; ``k`` fires only when the injector
is constructed with ``attempt == k`` (the supervisor exports
``P2P_TRAIN_ATTEMPT`` to the child). ``kill_plan``'s k-th kill fires on
attempt k, so a plan of N kills crashes exactly N times and then completes.

**Determinism.** ``kill_plan`` derives its kill episodes from
``sha256(seed : kill : k)`` mapped into the run's episode range — no RNG
state, no wall clock. A plan's JSON (``TrainFaultPlan.to_json`` /
``from_json``) is the JAX package's, so one plan drives either package.
"""

from __future__ import annotations

import hashlib
import json
import os
import signal
import time
from dataclasses import asdict, dataclass
from typing import List, Optional, Tuple

FAULT_KINDS = ("kill", "corrupt_checkpoint", "stall_callback", "poison_nan")


class SimulatedPreemption(RuntimeError):
    """Raised instead of SIGKILL in ``kill_mode="raise"`` (in-process tests)."""

    def __init__(self, episode: int):
        super().__init__(f"simulated preemption at episode {episode}")
        self.episode = episode


@dataclass(frozen=True)
class TrainFaultEvent:
    """One training fault. ``episode`` is the trigger boundary (the event
    fires at the first block whose start episode is >= it); ``attempt``
    scopes it to one supervisor attempt (``None`` = every attempt)."""

    kind: str
    episode: int
    attempt: Optional[int] = 0
    stall_s: float = 0.0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown train fault kind {self.kind!r}")
        if self.episode < 0:
            raise ValueError(f"episode must be >= 0, got {self.episode}")
        if self.kind == "stall_callback" and self.stall_s <= 0.0:
            raise ValueError("stall_callback events need stall_s > 0")


@dataclass(frozen=True)
class TrainFaultPlan:
    """A seed plus an ordered tuple of events — one whole chaos run."""

    seed: int
    events: Tuple[TrainFaultEvent, ...] = ()

    def __post_init__(self):
        if not isinstance(self.events, tuple):
            object.__setattr__(self, "events", tuple(self.events))

    def to_json(self) -> str:
        return json.dumps(
            {
                "kind": "train_fault_plan",
                "seed": self.seed,
                "events": [asdict(e) for e in self.events],
            },
            indent=2,
        )

    @classmethod
    def from_json(cls, text: str) -> "TrainFaultPlan":
        doc = json.loads(text)
        if not isinstance(doc, dict) or doc.get("kind") != "train_fault_plan":
            raise ValueError("not a train_fault_plan document")
        events = tuple(
            TrainFaultEvent(**{str(k): v for k, v in e.items()})
            for e in doc.get("events", [])
        )
        return cls(seed=int(doc["seed"]), events=events)


def _episode_of(seed: int, label: str, k: int, lo: int, hi: int) -> int:
    """Deterministic episode in [lo, hi) for the k-th event of a kind."""
    if hi <= lo:
        return lo
    digest = hashlib.sha256(f"{seed}:{label}:{k}".encode()).digest()
    return lo + int.from_bytes(digest[:8], "big") % (hi - lo)


def kill_plan(
    seed: int,
    n_episodes: int,
    n_kills: int = 1,
    min_episode: int = 1,
) -> TrainFaultPlan:
    """The canonical preemption plan: ``n_kills`` SIGKILLs at seed-derived
    episodes in [``min_episode``, ``n_episodes``), the k-th firing on
    supervisor attempt k — so the supervised run crashes exactly
    ``n_kills`` times, resumes each time, and completes on attempt
    ``n_kills``."""
    events = tuple(
        TrainFaultEvent(
            kind="kill",
            episode=_episode_of(seed, "kill", k, min_episode, max(n_episodes, min_episode + 1)),
            attempt=k,
        )
        for k in range(n_kills)
    )
    return TrainFaultPlan(seed=seed, events=events)


def corrupt_step_files(step_path: str, n_bytes: int = 4) -> Optional[str]:
    """Flip ``n_bytes`` in the middle of the step's largest payload file
    (deterministic: same step layout → same bytes). Returns the corrupted
    file's path, or ``None`` when the step has no file large enough. The
    integrity manifest itself is left intact — the DIGEST must catch this,
    not a JSON parse error."""
    from p2pmicrogrid_tpu_torch.train.checkpoint import MANIFEST_NAME

    candidates = []
    for dirpath, _dirs, files in os.walk(step_path):
        for f in files:
            if f == MANIFEST_NAME:
                continue
            p = os.path.join(dirpath, f)
            try:
                candidates.append((os.path.getsize(p), p))
            except OSError:
                continue
    candidates.sort(reverse=True)
    for size, p in candidates:
        if size < n_bytes:
            continue
        with open(p, "r+b") as f:
            f.seek(size // 2)
            chunk = f.read(n_bytes)
            f.seek(size // 2)
            f.write(bytes(b ^ 0xFF for b in chunk))
        return p
    return None


def poison_pol_state(pol_state):
    """Every floating tensor of the learner state becomes NaN, in place:
    Q-tables, network parameters, Adam's moments, ring buffers, exploration
    scales. Integer values survive (the rings' cursors, Adam's step counts,
    which the JAX package keeps as integers), so the poisoned state still
    runs and the divergence shows in the device counters. Returns the
    state."""
    import torch

    def poison(x):
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            x.fill_(float("nan"))

    def walk(node):
        if isinstance(node, torch.Tensor):
            poison(node)
        elif isinstance(node, torch.nn.Module):
            for t in node.parameters():
                poison(t.data)
        elif isinstance(node, torch.optim.Optimizer):
            for st in node.state.values():
                for k, v in st.items():
                    if k != "step":
                        poison(v)
        elif isinstance(node, tuple):
            for x in node:
                walk(x)

    with torch.no_grad():
        walk(pol_state)
    return pol_state


class TrainFaultInjector:
    """Applies a plan's events against one training process.

    Hook points (train/loop.py + the CLI checkpoint callback):

    * ``on_block_start(episode, pol_state)`` — at each fused-block boundary;
      fires ``kill`` (SIGKILL / ``SimulatedPreemption``) and ``poison_nan``
      (returns the poisoned carry, else ``None``).
    * ``on_checkpoint_saved(episode, step_path)`` — after a save; fires
      ``corrupt_checkpoint``.
    * ``on_callback(episode)`` — inside host callbacks; fires
      ``stall_callback``.

    Every event is single-shot (``fired``); ``history`` records
    ``(kind, episode, event_index)`` for replay assertions.
    """

    def __init__(
        self,
        plan: TrainFaultPlan,
        attempt: int = 0,
        kill_mode: str = "sigkill",
        sleep=time.sleep,
    ):
        if kill_mode not in ("sigkill", "raise"):
            raise ValueError(f"kill_mode must be 'sigkill' or 'raise', got {kill_mode!r}")
        self.plan = plan
        self.attempt = attempt
        self.kill_mode = kill_mode
        self._sleep = sleep
        self._fired: set = set()
        self.history: List[Tuple[str, int, int]] = []

    def _pending(self, kind: str, episode: int):
        for i, e in enumerate(self.plan.events):
            if e.kind != kind or i in self._fired:
                continue
            if e.attempt is not None and e.attempt != self.attempt:
                continue
            if episode >= e.episode:
                yield i, e

    def _fire(self, i: int, e: TrainFaultEvent, episode: int) -> None:
        self._fired.add(i)
        self.history.append((e.kind, episode, i))

    def on_block_start(self, episode: int, pol_state=None):
        for i, e in self._pending("kill", episode):
            self._fire(i, e, episode)
            if self.kill_mode == "raise":
                raise SimulatedPreemption(episode)
            os.kill(os.getpid(), signal.SIGKILL)
        poisoned = None
        for i, e in self._pending("poison_nan", episode):
            self._fire(i, e, episode)
            if pol_state is not None:
                poisoned = poison_pol_state(
                    pol_state if poisoned is None else poisoned
                )
        return poisoned

    def on_checkpoint_saved(self, episode: int, step_path: str) -> None:
        for i, e in self._pending("corrupt_checkpoint", episode):
            self._fire(i, e, episode)
            corrupt_step_files(step_path)

    def on_callback(self, episode: int) -> None:
        for i, e in self._pending("stall_callback", episode):
            self._fire(i, e, episode)
            self._sleep(e.stall_s)
