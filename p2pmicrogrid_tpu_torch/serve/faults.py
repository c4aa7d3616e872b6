"""Deterministic fault injection for the serve fleet.

The port of the JAX package's ``serve/faults.py``, copied as it is (it
imports nothing of either package): the same plans, JSON and sha256
coins, so one plan replays the same faults in both packages.

Chaos testing is only trustworthy when a failing run can be REPLAYED: a
flaky injected fault that appears in one run and not the next turns every
fleet regression into an unreproducible heisenbug. This module makes the
whole fault surface a pure function of a seed:

* ``FaultPlan`` — a seed plus an ordered tuple of ``FaultEvent``s. Two
  kinds of event:

  - **lifecycle** (``kill`` / ``restart``): replica-process faults applied
    at a scheduled instant by a ``FaultSchedule`` driving a fleet's
    ``kill``/``restart`` hooks (serve/router.py ``LocalFleet``).
  - **request** (``stall`` / ``error`` / ``drop`` / ``corrupt``): per-
    request faults decided by a ``FaultInjector`` hooked into
    ``ServeGateway`` — stall the response ``stall_s`` seconds, answer an
    injected 500, drop the connection without answering, or corrupt the
    response payload (always DETECTABLY: the corruption breaks JSON
    parsing, so a client can never mistake a corrupted answer for a real
    one — silent wrong-answer faults would poison the fleet bench's
    bit-exactness acceptance check).

* **Determinism.** Every request-fault coin is
  ``sha256(seed : replica : event-index : request-index)`` mapped to
  [0, 1) and compared against the event's ``rate`` — no RNG state, no
  wall-clock in the coin. The request index counts per SCOPE (act /
  health / other), so the router's timing-driven health probes can never
  shift the coins of act-scope faults: given the same plan and the same
  per-replica order of requests *within a scope*, the injected fault
  sequence for that scope is bit-identical across runs.
  ``FaultInjector.history`` records it for replay assertions
  (tests/test_torch_fleet.py).

* **Windows.** Request events apply while ``at_s <= t < until_s`` on the
  injector's clock (anchored by ``activate(t0)`` — the fleet bench
  activates every replica's injector at the loadgen start instant, so a
  plan's windows line up across the fleet). Events with the default
  window (0, inf) are always active, which keeps the determinism tests
  independent of timing.

JSON round-trip (``FaultPlan.to_json``/``from_json``) so chaos runs are
shareable as committed artifacts and CLI inputs (``serve-bench --fleet
--chaos-plan plan.json``).
"""

from __future__ import annotations

import hashlib
import json
import math
import threading
import time
from dataclasses import asdict, dataclass
from typing import Callable, Dict, List, Optional, Tuple

LIFECYCLE_KINDS = ("kill", "restart")
REQUEST_KINDS = ("stall", "error", "drop", "corrupt")
SCOPES = ("act", "health", "all")


@dataclass(frozen=True)
class FaultEvent:
    """One fault in a plan.

    ``replica=None`` targets every replica. Lifecycle kinds use ``at_s``
    as the scheduled instant; request kinds use [``at_s``, ``until_s``)
    as the active window (``until_s=None`` = open-ended) and flip a
    deterministic coin against ``rate`` per request. ``scope`` picks the
    endpoints a request fault applies to: ``act`` (``POST /v1/act``),
    ``health`` (``/healthz`` + ``/readyz`` — lets a plan fail probes
    without failing traffic, the health-ejection test fixture), or
    ``all``.
    """

    kind: str
    replica: Optional[str] = None
    at_s: float = 0.0
    until_s: Optional[float] = None
    rate: float = 1.0
    stall_s: float = 0.0
    scope: str = "act"

    def __post_init__(self):
        if self.kind not in LIFECYCLE_KINDS + REQUEST_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.scope not in SCOPES:
            raise ValueError(f"unknown fault scope {self.scope!r}")
        if not 0.0 <= self.rate <= 1.0:
            raise ValueError(f"rate must be in [0, 1], got {self.rate}")
        if self.kind in LIFECYCLE_KINDS and self.replica is None:
            raise ValueError(f"{self.kind} events must name a replica")
        if self.until_s is not None and self.until_s <= self.at_s:
            raise ValueError(
                f"until_s {self.until_s} must exceed at_s {self.at_s}"
            )
        if self.kind == "stall" and self.stall_s <= 0.0:
            raise ValueError("stall events need stall_s > 0")

    def active_at(self, t: float) -> bool:
        until = math.inf if self.until_s is None else self.until_s
        return self.at_s <= t < until


@dataclass(frozen=True)
class FaultPlan:
    """A seed plus an ordered tuple of events — the whole chaos run."""

    seed: int
    events: Tuple[FaultEvent, ...] = ()

    def __post_init__(self):
        # Accept lists for ergonomic literals; store a tuple (hashable,
        # immutable — a plan is an identity, not a mutable builder).
        if not isinstance(self.events, tuple):
            object.__setattr__(self, "events", tuple(self.events))

    # -- views ---------------------------------------------------------------

    def lifecycle_events(self) -> List[FaultEvent]:
        """kill/restart events in schedule order."""
        return sorted(
            (e for e in self.events if e.kind in LIFECYCLE_KINDS),
            key=lambda e: e.at_s,
        )

    def request_events(self) -> List[Tuple[int, FaultEvent]]:
        """(plan index, event) for request-kind events, plan order. The
        plan index — not the position in this filtered list — feeds the
        coin, so editing lifecycle events never shifts request coins."""
        return [
            (i, e)
            for i, e in enumerate(self.events)
            if e.kind in REQUEST_KINDS
        ]

    # -- serialization -------------------------------------------------------

    def to_json(self) -> str:
        return json.dumps(
            {
                "kind": "fault_plan",
                "seed": self.seed,
                "events": [asdict(e) for e in self.events],
            },
            indent=2,
        )

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        doc = json.loads(text)
        if not isinstance(doc, dict) or doc.get("kind") != "fault_plan":
            raise ValueError("not a fault_plan document")
        events = tuple(
            FaultEvent(**{str(k): v for k, v in e.items()})
            for e in doc.get("events", [])
        )
        return cls(seed=int(doc["seed"]), events=events)


def kill_restart_plan(
    replica: str,
    kill_at_s: float,
    restart_at_s: float,
    seed: int = 0,
    extra_events: Tuple[FaultEvent, ...] = (),
) -> FaultPlan:
    """The canonical chaos plan: kill one replica mid-run, restart it
    later (the ``serve-bench --fleet --chaos`` default)."""
    if restart_at_s <= kill_at_s:
        raise ValueError(
            f"restart_at_s {restart_at_s} must exceed kill_at_s {kill_at_s}"
        )
    return FaultPlan(
        seed=seed,
        events=(
            FaultEvent(kind="kill", replica=replica, at_s=kill_at_s),
            FaultEvent(kind="restart", replica=replica, at_s=restart_at_s),
        )
        + tuple(extra_events),
    )


@dataclass(frozen=True)
class FaultDecision:
    """What the injector chose for one request (``None`` = no fault)."""

    kind: str                # one of REQUEST_KINDS
    event_index: int         # plan index of the deciding event
    request_index: int       # per-replica request counter value
    stall_s: float = 0.0


def _coin(seed: int, replica_id: str, event_index: int, n: int) -> float:
    """Deterministic uniform [0, 1) for one (event, request) pair."""
    digest = hashlib.sha256(
        f"{seed}:{replica_id}:{event_index}:{n}".encode()
    ).digest()
    return int.from_bytes(digest[:8], "big") / float(1 << 64)


class FaultInjector:
    """Per-replica request-fault decider (hooked into ``ServeGateway``).

    ``decide(scope)`` is called once per incoming request; the coin is a
    pure function of (plan seed, replica id, event index, request index),
    so the fault sequence replays exactly for a given request order. The
    first matching event in plan order wins — plans encode precedence by
    ordering. Thread-safe: the request counter is the only mutable state.
    """

    def __init__(
        self,
        plan: FaultPlan,
        replica_id: str,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.plan = plan
        self.replica_id = replica_id
        self._clock = clock
        self._t0: Optional[float] = None
        # Per-SCOPE request counters: health probes arrive on their own
        # nondeterministic timer, and a shared counter would let them
        # shift the coin indices of act-scope faults between otherwise
        # identical runs — breaking the replay guarantee for exactly the
        # traffic chaos runs care about.
        self._n: Dict[str, int] = {}
        self._lock = threading.Lock()
        self.history: List[Optional[FaultDecision]] = []
        self.injected: Dict[str, int] = {k: 0 for k in REQUEST_KINDS}

    def activate(self, t0: Optional[float] = None) -> None:
        """Anchor the fault windows' clock (idempotent; the first
        ``decide`` self-activates if never called)."""
        with self._lock:
            if self._t0 is None:
                self._t0 = self._clock() if t0 is None else t0

    def decide(self, scope: str = "act") -> Optional[FaultDecision]:
        with self._lock:
            if self._t0 is None:
                self._t0 = self._clock()
            n = self._n.get(scope, 0)
            self._n[scope] = n + 1
            t = self._clock() - self._t0
            decision = None
            for i, event in self.plan.request_events():
                if event.replica is not None and event.replica != self.replica_id:
                    continue
                if event.scope != "all" and event.scope != scope:
                    continue
                if not event.active_at(t):
                    continue
                if _coin(self.plan.seed, self.replica_id, i, n) < event.rate:
                    decision = FaultDecision(
                        kind=event.kind,
                        event_index=i,
                        request_index=n,
                        stall_s=event.stall_s,
                    )
                    self.injected[event.kind] += 1
                    break
            self.history.append(decision)
            return decision

    def stats(self) -> dict:
        with self._lock:
            return {
                "replica_id": self.replica_id,
                "requests_seen": sum(self._n.values()),
                "requests_by_scope": dict(self._n),
                "injected": dict(self.injected),
            }


class FaultSchedule:
    """Drives a plan's lifecycle (kill/restart) events against a fleet.

    ``kill_fn``/``restart_fn`` take the replica id; the schedule thread
    waits out each event's ``at_s`` relative to ``start()`` and applies
    it. ``stop()`` cancels outstanding events (bounded join — a restart
    scheduled past the end of a bench run must not pin the process).
    """

    def __init__(
        self,
        plan: FaultPlan,
        kill_fn: Callable[[str], None],
        restart_fn: Callable[[str], None],
    ):
        self.plan = plan
        self._kill_fn = kill_fn
        self._restart_fn = restart_fn
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.applied: List[Tuple[float, str, str]] = []  # (t, kind, replica)
        self.errors: List[str] = []

    def start(self) -> None:
        if self._thread is not None:
            raise RuntimeError("schedule already started")
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._t0 = time.monotonic()
        self._thread.start()

    def _run(self) -> None:
        for event in self.plan.lifecycle_events():
            delay = event.at_s - (time.monotonic() - self._t0)
            if delay > 0 and self._stop.wait(delay):
                return  # cancelled
            if self._stop.is_set():
                return
            fn = self._kill_fn if event.kind == "kill" else self._restart_fn
            try:
                fn(event.replica)
                self.applied.append(
                    (round(time.monotonic() - self._t0, 3), event.kind,
                     event.replica)
                )
            except Exception as err:  # noqa: BLE001 — a failed restart must
                # surface in the bench report, not kill the schedule thread
                # (later events may still apply).
                self.errors.append(f"{event.kind} {event.replica}: {err}")

    def stop(self, timeout_s: float = 10.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout_s)

    def join(self, timeout_s: float) -> None:
        """Wait for every scheduled event to apply (bench teardown)."""
        if self._thread is not None:
            self._thread.join(timeout=timeout_s)
