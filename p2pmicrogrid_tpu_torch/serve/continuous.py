"""Slot-level continuous batching: join/leave serving.

The port of the JAX package's ``serve/continuous.py`` for feed-forward
bundles. ``MicroBatchQueue`` (serve/engine.py) dispatches a microbatch as
ONE unit: the coalescing window holds early arrivals back up to
``max_wait_s``, and a request that misses a dispatch waits out the whole
in-flight batch before its own batch even forms. Iteration-level scheduling
removes that wait class: the engine steps continuously, requests JOIN the
padded in-flight batch between steps and completed rows RETIRE between
steps.

``ContinuousBatcher`` is that front, duck-typing ``MicroBatchQueue``
(``submit``/``depth``/``recent_wait_ms``/``close``) so the gateway,
registry stats and admission control work unchanged:

* **Step loop.** A worker thread runs engine steps back-to-back whenever
  work is pending. Each step takes up to ``max_batch`` queued requests
  (FIFO), pads to the engine's power-of-two bucket, executes, and delivers
  — then immediately composes the next step from whatever arrived in the
  meantime. No window, no barrier.
* **Row slots + household affinity.** With ``sessions`` on, each household
  owns a row slot carrying its cross-slot session (served-action /
  slot-count metadata), kept while the household stays on this replica.
* **Generation counters.** Every slot carries a generation, bumped on
  every retire/evict/reassign. A request's slot resolution is tagged
  ``(slot, gen)`` when it joins a step, and state is only written under a
  matching generation — a late joiner never touches a RETIRED row's state.
* **Stateless bit-exactness.** Every step executes through ``engine.act``,
  the same per-bucket graphs the microbatch path replays, so continuous
  serving answers what the microbatch queue answers — only the queueing
  schedule moves, never the math.
* **Observability.** Every step emits ``serve.batch_occupancy`` (live
  rows / padded bucket) and per-request ``serve.slot_wait_ms`` histograms
  plus the same ``serve_request`` trace events the microbatch queue
  streams (``source="continuous"``).

Households beyond ``max_slots`` with nothing to evict overflow to the
scratch row: their actions depend only on the observation, so only session
metadata is lost. Recurrent bundles, whose hidden-state ring this front
carries in the JAX package, are not ported yet (ROADMAP.md, Queue 1, item
9): the engine refuses them. The JAX package's
``serve_bench_continuous_compare`` needs the load generator, which comes
with the fleet (item 14).
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import Future, InvalidStateError
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np


@dataclass
class _SlotMeta:
    """Host-side bookkeeping for one row slot."""

    household: Optional[str] = None
    gen: int = 0
    last_used: int = -1       # step counter, for deterministic LRU
    served: int = 0           # session slot counter (Sessions.slots mirror)
    hp_frac: Optional[np.ndarray] = None  # [A] last served action


@dataclass
class _Request:
    obs: np.ndarray
    future: Future
    t_enq: float
    household: Optional[str]
    slot: int = -1
    gen: int = -1
    trace: object = None        # TraceContext when the caller is traced
    request_id: Optional[str] = None
    t_enq_epoch: float = 0.0


class ContinuousBatcher:
    """Slot-level continuous batching front over a ``PolicyEngine``.

    Duck-types ``MicroBatchQueue`` for the gateway/registry. ``max_slots``
    bounds resident sessions (LRU eviction past it, re-init on return);
    ``sessions=False`` disables per-household state entirely.
    ``max_wait_s`` is accepted for interface compatibility and ignored —
    continuous batching has no coalescing window, which is the point.
    ``autostart=False`` is the manual-stepping mode: no worker thread; the
    owner drives ``step_once()`` (an external control loop, and the
    deterministic tests).
    """

    SCRATCH = -1  # sentinel: request runs from the scratch row, no session

    def __init__(
        self,
        engine,
        max_batch: Optional[int] = None,
        max_wait_s: float = 0.0,
        max_slots: int = 256,
        sessions: bool = True,
        autostart: bool = True,
    ):
        del max_wait_s  # no coalescing window by design
        if max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {max_slots}")
        self.engine = engine
        self.max_batch = min(max_batch or engine.max_batch, engine.max_batch)
        self.sessions_enabled = sessions
        self.max_slots = max_slots
        self._pending: List[_Request] = []
        self._cv = threading.Condition()
        self._closed = False
        # Admission signal window, same shape as MicroBatchQueue's:
        # (monotonic dispatch instant, enqueue->dispatch wait ms).
        self.recent_wait_ms: deque = deque(maxlen=512)
        # Host-side slot table: WHO owns a row and under which generation.
        self._slots: List[_SlotMeta] = [_SlotMeta() for _ in range(max_slots)]
        self._by_household: Dict[str, int] = {}
        self._free: deque = deque(range(max_slots))
        self._step_counter = 0
        self.stats = {
            "steps": 0, "joins": 0, "evictions": 0, "retired": 0,
            "scratch_rows": 0, "stale_generation_drops": 0,
            "cancelled_drops": 0, "spill_rejoins": 0,
        }
        # Spill meter: households seen returning after an LRU eviction. A
        # high rejoin share means max_slots is below the live working set.
        # Bounded at 4x max_slots; only recency matters for the signal.
        self._recently_evicted: OrderedDict = OrderedDict()
        self._recently_evicted_cap = 4 * max_slots
        self._thread: Optional[threading.Thread] = None
        if autostart:
            self._thread = threading.Thread(target=self._worker, daemon=True)
            self._thread.start()

    def warmup(self, buckets=None) -> List[int]:
        """Prepare the engine's act buckets up to ``max_batch``
        (``PolicyEngine.warmup``: their CUDA graphs on the card) so the
        first request of each size never pays a capture in-slot."""
        buckets = buckets if buckets is not None else self.engine.buckets
        return self.engine.warmup(
            [b for b in buckets if b <= self.max_batch], include_step=False
        )

    # -- public queue interface ----------------------------------------------

    @property
    def depth(self) -> int:
        """Requests queued but not yet joined to a step (admission
        signal)."""
        with self._cv:
            return len(self._pending)

    def submit(
        self, obs_row, household: Optional[str] = None,
        trace=None, request_id: Optional[str] = None,
    ) -> Future:
        """Queue one community observation row; resolves to actions [A].

        ``household`` pins the request to its session slot; ``None`` serves
        from the scratch row. ``trace`` (a TraceContext) and ``request_id``
        flow through to the step's trace records."""
        # host-sync: caller-supplied host observation row.
        obs_row = np.asarray(obs_row, dtype=np.float32)
        fut: Future = Future()
        with self._cv:
            if self._closed:
                raise RuntimeError("queue is closed")
            self._pending.append(
                _Request(
                    obs=obs_row, future=fut, t_enq=time.monotonic(),
                    household=household if self.sessions_enabled else None,
                    trace=trace, request_id=request_id,
                    t_enq_epoch=time.time(),
                )
            )
            self._cv.notify()
        return fut

    def step_once(self) -> int:
        """Compose and execute ONE engine step synchronously; returns the
        number of rows stepped (0 = nothing pending). Manual-stepping
        companion to ``autostart=False`` — never call it with the worker
        thread running."""
        with self._cv:
            batch = self._compose_locked()
        if batch:
            try:
                self._execute(batch)
            except Exception as err:  # noqa: BLE001 — fail waiters too
                for req in batch:
                    if not req.future.done():
                        try:
                            req.future.set_exception(err)
                        except InvalidStateError:
                            pass
                raise
        return len(batch)

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=10.0)

    def __enter__(self) -> "ContinuousBatcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- session lifecycle ----------------------------------------------------

    def session_info(self, household: str) -> Optional[dict]:
        """Test/observability hook: the household's live slot state, or
        None when it holds no slot."""
        with self._cv:
            slot = self._by_household.get(household)
            if slot is None:
                return None
            m = self._slots[slot]
            return {
                "slot": slot,
                "gen": m.gen,
                "served": m.served,
                "hp_frac": None if m.hp_frac is None else m.hp_frac.copy(),
            }

    def end_session(self, household: str) -> bool:
        """Retire a household's slot NOW (gen bump + free-list return).
        Its next request starts a fresh session. Returns whether a session
        existed."""
        with self._cv:
            slot = self._by_household.pop(household, None)
            if slot is None:
                return False
            self._retire_locked(slot)
            self.stats["retired"] += 1
            return True

    def _retire_locked(self, slot: int) -> None:
        m = self._slots[slot]
        m.household = None
        m.gen += 1
        m.served = 0
        m.hp_frac = None
        self._free.append(slot)

    @property
    def occupancy(self) -> int:
        """Resident sessions (slots owned by a household)."""
        with self._cv:
            return self.max_slots - len(self._free)

    # -- slot resolution (lock held) ------------------------------------------

    def _resolve_slot_locked(self, household: str, pending_households) -> int:
        """The household's slot, allocating (and LRU-evicting an idle slot
        of a household with no queued work) when needed. Returns
        ``SCRATCH`` when every slot is unavailable this step."""
        slot = self._by_household.get(household)
        if slot is not None:
            return slot
        if self._free:
            slot = self._free.popleft()
        else:
            # Deterministic LRU eviction among slots whose household has
            # nothing queued: same arrival schedule, same victim.
            candidates = [
                (m.last_used, i) for i, m in enumerate(self._slots)
                if m.household is not None
                and m.household not in pending_households
            ]
            if not candidates:
                return self.SCRATCH
            _, slot = min(candidates)
            victim = self._slots[slot].household
            self._by_household.pop(victim, None)
            self._retire_locked(slot)
            self._free.remove(slot)
            self.stats["evictions"] += 1
            self._recently_evicted[victim] = self._step_counter
            self._recently_evicted.move_to_end(victim)
            while len(self._recently_evicted) > self._recently_evicted_cap:
                self._recently_evicted.popitem(last=False)
        m = self._slots[slot]
        if self._recently_evicted.pop(household, None) is not None:
            self.stats["spill_rejoins"] += 1
        m.household = household
        m.served = 0
        m.hp_frac = None
        self._by_household[household] = slot
        self.stats["joins"] += 1
        return slot

    # -- the step loop --------------------------------------------------------

    def _compose_locked(self) -> List[_Request]:
        """Pop the next step's requests off the FIFO queue (up to
        ``max_batch``), resolving each to a (slot, gen) under the current
        generations. Rows are order-independent for a feed-forward policy,
        so a household's burst rides one step. Cancelled requests are
        dropped."""
        batch: List[_Request] = []
        pending_households = {
            r.household for r in self._pending if r.household is not None
        }
        remaining: List[_Request] = []
        for req in self._pending:
            if req.future.cancelled():
                # The caller gave up (gateway request timeout): dropping
                # the corpse here keeps the admission depth honest.
                self.stats["cancelled_drops"] += 1
                continue
            if len(batch) >= self.max_batch:
                remaining.append(req)
                continue
            slot = self.SCRATCH
            if req.household is not None:
                slot = self._resolve_slot_locked(req.household, pending_households)
            req.slot = slot
            req.gen = -1 if slot == self.SCRATCH else self._slots[slot].gen
            batch.append(req)
        self._pending = remaining
        return batch

    def _worker(self) -> None:
        while True:
            with self._cv:
                while not self._pending and not self._closed:
                    self._cv.wait()
                if not self._pending and self._closed:
                    return
                batch = self._compose_locked()
            if not batch:
                continue  # every pending request was a cancelled one
            try:
                self._execute(batch)
            except Exception as err:  # noqa: BLE001 — fail waiters, not loop
                for req in batch:
                    if not req.future.done():
                        try:
                            req.future.set_exception(err)
                        except InvalidStateError:
                            pass

    def _execute(self, batch: List[_Request]) -> None:
        b = len(batch)
        bucket = self.engine.bucket_for(b)
        obs = np.stack([r.obs for r in batch])
        dispatch_t = time.monotonic()
        dispatch_epoch = time.time()
        for req in batch:
            self.recent_wait_ms.append(
                (dispatch_t, (dispatch_t - req.t_enq) * 1e3)
            )
        # The SAME per-bucket graphs the microbatch path replays —
        # continuous serving answers what MicroBatchQueue answers.
        actions = self.engine.act(obs)
        service_s = time.monotonic() - dispatch_t

        with self._cv:
            self._step_counter += 1
            self.stats["steps"] += 1
            for i, req in enumerate(batch):
                if req.slot == self.SCRATCH:
                    self.stats["scratch_rows"] += 1
                    continue
                m = self._slots[req.slot]
                if m.gen != req.gen or m.household != req.household:
                    # The slot was retired/reassigned between composition
                    # and delivery (end_session racing the step): the
                    # answer is still correct, but the RETIRED slot's state
                    # must not be touched under a stale generation.
                    self.stats["stale_generation_drops"] += 1
                    continue
                m.served += 1
                m.last_used = self._step_counter
                m.hp_frac = actions[i].copy()
        for i, req in enumerate(batch):
            if req.future.cancelled():
                continue
            try:
                req.future.set_result(actions[i].copy())
            except InvalidStateError:
                pass  # cancelled between the check and delivery
        try:
            self._trace(batch, b, bucket, dispatch_t, service_s, dispatch_epoch)
        except Exception:  # noqa: BLE001 — telemetry is best-effort
            pass

    def _trace(
        self, batch, b: int, bucket: int, dispatch_t: float,
        service_s: float, dispatch_epoch: float = 0.0,
    ) -> None:
        """Per-step occupancy + per-request slot-wait records through the
        engine's telemetry: the queueing story the warehouse attributes the
        continuous-vs-microbatch win with. Traced requests additionally get
        real ``queue.wait``/``engine.execute`` spans, one fan-in
        ``engine.step`` span, and a synthetic ``engine.pad`` span — the same
        shapes the microbatch queue emits."""
        from p2pmicrogrid_tpu_torch.telemetry.tracing import record_span

        tel = self.engine.telemetry
        if tel is None:
            return
        tel.counter("serve.steps")
        tel.histogram("serve.batch_occupancy", b / bucket)
        padded = bucket - b
        for row_i, req in enumerate(batch):
            wait_ms = (dispatch_t - req.t_enq) * 1e3
            tel.histogram("serve.slot_wait_ms", wait_ms)
            tel.event(
                "serve_request",
                source="continuous",
                row=row_i,
                batch_size=b,
                bucket=bucket,
                padded_rows=padded,
                slot=None if req.slot == self.SCRATCH else req.slot,
                wait_ms=round(wait_ms, 3),
                service_ms=round(service_s * 1e3, 3),
                latency_ms=round(wait_ms + service_s * 1e3, 3),
                request_id=req.request_id,
            )
        traced = [req for req in batch if req.trace is not None]
        if not traced:
            return
        for req in traced:
            wait_s = max(0.0, dispatch_epoch - req.t_enq_epoch)
            record_span(
                tel, req.trace.child("queue.wait"), "queue.wait",
                req.t_enq_epoch, wait_s, batch_size=b,
            )
            record_span(
                tel, req.trace.child("engine.execute"), "engine.execute",
                dispatch_epoch, service_s,
                bucket=bucket, batch_size=b, padded_rows=padded,
            )
        first_ctx = traced[0].trace
        record_span(
            tel, first_ctx.child("engine.step"), "engine.step",
            dispatch_epoch, service_s,
            bucket=bucket, batch_size=b, linked=len(traced),
        )
        if padded > 0:
            record_span(
                tel, first_ctx.child("engine.pad"), "engine.pad",
                dispatch_epoch, service_s * padded / bucket,
                bucket=bucket, padded_rows=padded, estimated=True,
            )
