"""Slot-level continuous batching: join/leave serving with a hidden-state ring.

The port of the JAX package's ``serve/continuous.py``. ``MicroBatchQueue``
(serve/engine.py) dispatches a microbatch as ONE unit: the coalescing window
holds early arrivals back up to ``max_wait_s``, and a request that misses a
dispatch waits out the whole in-flight batch before its own batch even
forms. Iteration-level scheduling removes that wait class: the engine steps
continuously, requests JOIN the padded in-flight batch between steps and
completed rows RETIRE between steps.

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
  slot-count metadata; for recurrent bundles the policy's hidden state),
  kept while the household stays on this replica.
* **Generation counters.** Every slot carries a generation, bumped on
  every retire/evict/reassign. A request's slot resolution is tagged
  ``(slot, gen)`` when it joins a step, and state is only written under a
  matching generation — a late joiner never touches a RETIRED row's state;
  an evicted slot re-initialises to the fresh (zero) carry.
* **The hidden-state ring.** For recurrent bundles the per-household flat
  LSTM carry lives in ONE tensor ``[max_slots + 1, A, H]`` on the engine's
  device; row ``max_slots`` is the scratch row that pad rows and anonymous
  requests gather from and write into. A step gathers its rows
  (``index_select``), zeroes the fresh-session rows, steps the actor and
  writes the new carries back (``index_copy_``). On the card each bucket's
  step is one CUDA graph with static ``rows`` (int64) and ``fresh`` inputs.
  A graph holds the ring's address, so the ring is allocated once and only
  written in place (the JAX package donates and rebinds its ring; here a
  rebind would leave the graphs writing to a stale buffer).
* **Stateless bit-exactness.** Feed-forward bundles execute through
  ``engine.act``, the same per-bucket graphs the microbatch path replays,
  so continuous serving answers what the microbatch queue answers — only
  the queueing schedule moves, never the math.
* **Observability.** Every step emits ``serve.batch_occupancy`` (live
  rows / padded bucket) and per-request ``serve.slot_wait_ms`` histograms
  plus the same ``serve_request`` trace events the microbatch queue
  streams (``source="continuous"``).

Anonymous requests (no household id) run from a fresh zero carry on the
scratch row. A recurrent bundle with ``sessions=False`` is REFUSED at
construction, a household never steps twice in one batch (its requests
serialize through consecutive steps), and under slot exhaustion a recurrent
household's request is DEFERRED (FIFO position kept) rather than served
from a zero carry; past ``slot_wait_timeout_s`` it fails loudly naming the
fix. Stateless households overflow to the scratch row (their actions
depend only on the observation; only session metadata is lost).

``serve_bench_continuous_compare`` fires one bursty open-loop schedule
(``serve/loadgen.py``) over the mux wire through a microbatch gateway and a
continuous gateway on the same device, and holds both arms' answers to a
direct engine bit for bit.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import Future, InvalidStateError
from dataclasses import dataclass
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch


@dataclass
class _SlotMeta:
    """Host-side bookkeeping for one row slot."""

    household: Optional[str] = None
    gen: int = 0
    last_used: int = -1       # step counter, for deterministic LRU
    fresh: bool = True        # next read must re-init (zero carry)
    served: int = 0           # session slot counter (Sessions.slots mirror)
    hp_frac: Optional[np.ndarray] = None  # [A] last served action


class _RingGraph(NamedTuple):
    """One bucket's captured ring step and its static inputs."""

    captured: Any          # parallel/graph.py::Captured; outputs = actions [b, A]
    obs: torch.Tensor      # [b, A, 4]
    rows: torch.Tensor     # [b] int64 ring rows (scratch for pads)
    fresh: torch.Tensor    # [b] float32, 1 where the carry re-initialises
    host: torch.Tensor     # [b, A * 4 + 2] pinned staging: obs, row, fresh


@dataclass
class _Request:
    obs: np.ndarray
    future: Future
    t_enq: float
    household: Optional[str]
    slot: int = -1
    gen: int = -1
    fresh: bool = True
    trace: object = None        # TraceContext when the caller is traced
    request_id: Optional[str] = None
    t_enq_epoch: float = 0.0


class ContinuousBatcher:
    """Slot-level continuous batching front over a ``PolicyEngine``.

    Duck-types ``MicroBatchQueue`` for the gateway/registry. ``max_slots``
    bounds resident sessions (LRU eviction past it, re-init on return);
    ``sessions=False`` disables per-household state entirely (stateless
    bundles only). ``max_wait_s`` is accepted for interface compatibility and ignored —
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
        slot_wait_timeout_s: float = 5.0,
    ):
        del max_wait_s  # no coalescing window by design
        if max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {max_slots}")
        if getattr(engine, "is_recurrent", False) and not sessions:
            raise ValueError(
                "recurrent bundle needs sessions: serving a hidden-state "
                "policy with sessions disabled would silently act from a "
                "zero carry every slot — a different policy. Enable "
                "sessions (the default) or export a feedforward bundle."
            )
        self.engine = engine
        self.max_batch = min(max_batch or engine.max_batch, engine.max_batch)
        self.sessions_enabled = sessions
        self.max_slots = max_slots
        # How long a recurrent household's request may wait for a session
        # slot under exhaustion before it fails loudly naming the fix.
        self.slot_wait_timeout_s = slot_wait_timeout_s
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
            "slot_deferrals": 0, "slot_wait_expired": 0,
            "cancelled_drops": 0, "spill_rejoins": 0,
        }
        # Spill meter: households seen returning after an LRU eviction. A
        # high rejoin share means max_slots is below the live working set.
        # Bounded at 4x max_slots; only recency matters for the signal.
        self._recently_evicted: OrderedDict = OrderedDict()
        self._recently_evicted_cap = 4 * max_slots
        # The recurrent hidden ring, allocated once (graphs hold its
        # address), and one step graph per bucket on the card.
        self._ring = None
        self._ring_graphs: Dict[int, "_RingGraph"] = {}
        self.graph_pool_bytes = 0
        if engine.is_recurrent:
            self._ring = torch.zeros(
                (max_slots + 1, engine.n_agents, engine.hidden_dim),
                dtype=torch.float32, device=engine.device,
            )
        self._thread: Optional[threading.Thread] = None
        if autostart:
            self.start()

    def start(self) -> None:
        """Start the worker thread (construction does, unless
        ``autostart=False``; the gateway starts it after ``warmup``)."""
        if self._thread is None:
            self._thread = threading.Thread(target=self._worker, daemon=True)
            self._thread.start()

    def warmup(self, buckets=None) -> List[int]:
        """Prepare every padding bucket up to ``max_batch`` before traffic:
        the ring-step graphs of a recurrent bundle (captured on scratch
        rows only), else the engine's act graphs (``PolicyEngine.warmup``).
        On the CPU there is nothing to prepare."""
        buckets = [b for b in (buckets if buckets is not None else self.engine.buckets) if b <= self.max_batch]
        if not self.engine.is_recurrent:
            return self.engine.warmup(buckets, include_step=False)
        if self.engine.device.type == "cuda":
            with self.engine._lock:
                for b in buckets:
                    if b not in self._ring_graphs:
                        self._capture_ring_step(b)
        return buckets

    # -- the hidden-state ring ------------------------------------------------

    def _ring_step(self, obs: torch.Tensor, rows: torch.Tensor, fresh: torch.Tensor) -> torch.Tensor:
        """Gather the stepping rows' carries, zero the fresh-session rows,
        step the actor one slot, write the new carries back (pads and
        anonymous rows into the scratch row). Returns actions [b, A]."""
        h = self._ring.index_select(0, rows)
        h = torch.where(fresh[:, None, None] > 0.5, torch.zeros_like(h), h)
        actions, h2 = self.engine.forward(obs, h)
        self._ring.index_copy_(0, rows, h2)
        return actions

    def _capture_ring_step(self, bucket: int) -> "_RingGraph":
        """One bucket's ring step as a CUDA graph (engine lock held). The
        static rows start on the scratch row and every row is fresh, so the
        capture's warm-up runs write the scratch row only."""
        from p2pmicrogrid_tpu_torch.parallel.graph import capture
        from p2pmicrogrid_tpu_torch.serve.engine import _CAPTURE_LOCK

        dev, A = self.engine.device, self.engine.n_agents
        g = _RingGraph(
            captured=None,
            obs=torch.zeros((bucket, A, 4), device=dev),
            rows=torch.full((bucket,), self.max_slots, dtype=torch.int64, device=dev),
            fresh=torch.ones((bucket,), device=dev),
            host=torch.zeros((bucket, A * 4 + 2), pin_memory=True),
        )
        with _CAPTURE_LOCK, torch.cuda.device(dev):
            captured = capture(
                lambda: self._ring_step(g.obs, g.rows, g.fresh), lambda: None,
                capture_error_mode="thread_local",
            )
        g = g._replace(captured=captured)
        self._ring_graphs[bucket] = g
        self.graph_pool_bytes += captured.pool_bytes
        self.engine.stats["aot_compiles"] += 1
        return g

    def _ring_execute(self, obs: np.ndarray, rows: np.ndarray, fresh: np.ndarray) -> np.ndarray:
        """One padded ring step on the engine's device: host obs [bucket,
        A, 4], rows [bucket], fresh [bucket] -> actions [bucket, A] on the
        host."""
        bucket = obs.shape[0]
        with self.engine._lock:
            if self.engine.device.type != "cuda":
                actions = self._ring_step(
                    torch.from_numpy(obs), torch.from_numpy(rows), torch.from_numpy(fresh)
                )
            else:
                g = self._ring_graphs.get(bucket) or self._capture_ring_step(bucket)
                # One pinned staging row a bucket row: obs, then row, fresh.
                g.host[:, :-2].copy_(torch.from_numpy(obs.reshape(bucket, -1)))
                g.host[:, -2].copy_(torch.from_numpy(rows.astype(np.float32)))
                g.host[:, -1].copy_(torch.from_numpy(fresh))
                staged = g.host.to(g.obs.device, non_blocking=True)
                g.obs.copy_(staged[:, :-2].reshape(g.obs.shape))
                g.rows.copy_(staged[:, -2].long())
                g.fresh.copy_(staged[:, -1])
                g.captured.graph.replay()
                actions = g.captured.outputs
            # host-sync: the step's serving latency boundary.
            return actions.cpu().numpy().copy()

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
        m.fresh = True
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
        m.fresh = True
        m.served = 0
        m.hp_frac = None
        self._by_household[household] = slot
        self.stats["joins"] += 1
        return slot

    # -- the step loop --------------------------------------------------------

    def _compose_locked(self) -> List[_Request]:
        """Pop the next step's requests off the FIFO queue (up to
        ``max_batch``), resolving each to a (slot, gen) under the current
        generations. For a RECURRENT engine, at most one request per slot
        per step: a household's back-to-back requests serialize through
        consecutive steps (each reads the carry the previous one writes);
        later households may overtake its second request, never its first.
        Stateless rows are order-independent, so a household's burst rides
        one step. Cancelled requests are dropped; recurrent requests that
        out-waited ``slot_wait_timeout_s`` for a slot fail loudly naming the
        ``max_slots`` fix."""
        batch: List[_Request] = []
        expired: List[_Request] = []
        taken: set = set()
        deferred: set = set()
        recurrent = self.engine.is_recurrent
        now = time.monotonic()
        pending_households = {
            r.household for r in self._pending if r.household is not None
        }
        remaining: List[_Request] = []
        for req in self._pending:
            if req.future.cancelled():
                # The caller gave up (gateway request timeout): dropping
                # the corpse here keeps the admission depth honest, and
                # never advances a household's carry for nobody.
                self.stats["cancelled_drops"] += 1
                continue
            if len(batch) >= self.max_batch:
                remaining.append(req)
                continue
            if req.household is None:
                req.slot, req.gen, req.fresh = self.SCRATCH, -1, True
                batch.append(req)
                continue
            if req.household in deferred:
                remaining.append(req)
                continue
            slot = self._by_household.get(req.household)
            if recurrent and slot is not None and slot in taken:
                # This household already steps this round: its next
                # request reads the carry this step writes.
                deferred.add(req.household)
                remaining.append(req)
                continue
            if slot is None:
                slot = self._resolve_slot_locked(req.household, pending_households)
            if slot == self.SCRATCH:
                if recurrent:
                    # Slot exhaustion: a hidden-state household never serves
                    # from the scratch row's zero carry. It keeps its FIFO
                    # place and joins once a resident household goes idle,
                    # or fails past slot_wait_timeout_s.
                    if now - req.t_enq > self.slot_wait_timeout_s:
                        expired.append(req)
                        continue
                    self.stats["slot_deferrals"] += 1
                    deferred.add(req.household)
                    remaining.append(req)
                    continue
                req.slot, req.gen, req.fresh = self.SCRATCH, -1, True
                batch.append(req)
                continue
            m = self._slots[slot]
            req.slot, req.gen, req.fresh = slot, m.gen, m.fresh
            taken.add(slot)
            batch.append(req)
        self._pending = remaining
        for req in expired:
            self.stats["slot_wait_expired"] += 1
            if not req.future.done():
                try:
                    req.future.set_exception(
                        RuntimeError(
                            "no session slot freed within "
                            f"{self.slot_wait_timeout_s:g}s: max_slots="
                            f"{self.max_slots} is below this replica's "
                            "concurrent recurrent household count — raise "
                            "--max-sessions (or spread households over "
                            "more replicas)"
                        )
                    )
                except InvalidStateError:
                    pass
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
                # Every pending request was cancelled or is deferred: park
                # briefly rather than spin on the lock.
                with self._cv:
                    self._cv.wait(timeout=0.001)
                continue
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
        if self.engine.is_recurrent:
            rows = np.full((bucket,), self.max_slots, np.int64)
            fresh = np.ones((bucket,), np.float32)
            for i, req in enumerate(batch):
                if req.slot != self.SCRATCH:
                    rows[i] = req.slot
                    fresh[i] = 1.0 if req.fresh else 0.0
            padded = np.zeros((bucket,) + obs.shape[1:], np.float32)
            padded[:b] = obs
            actions = self._ring_execute(padded, rows, fresh)[:b]
            self.engine.stats["rows"] += b
            self.engine.stats["batches"] += 1
            self.engine.stats["padded_rows"] += bucket - b
            tel = self.engine.telemetry
            if tel is not None:
                tel.counter("serve.requests", b)
                tel.counter("serve.batches")
                tel.counter("serve.padded_rows", bucket - b)
        else:
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
                m.fresh = False
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


# -- the acceptance measurement -----------------------------------------------
#
# The SAME bursty open-loop schedule fired over the persistent mux wire
# through a microbatch gateway and a continuous-batching gateway in ONE
# process, same bundle, same observations — per-arm wire percentiles, a
# bit-exactness verdict across the arms AND against a direct engine, and
# the continuous arm's occupancy/slot-wait distributions.


def serve_bench_continuous_compare(
    bundle_dir: str,
    rate_hz: float = 256.0,
    n_requests: int = 1024,
    n_households: int = 32,
    seed: int = 0,
    slo_ms: float = 100.0,
    burst_factor: float = 8.0,
    burst_dwell_s: float = 0.25,
    max_batch: int = 64,
    max_wait_s: float = 0.002,
    max_slots: int = 256,
    device="cuda",
    results_db: Optional[str] = None,
    timeout_s: float = 30.0,
    emit=None,
) -> List[dict]:
    """Continuous vs microbatch at the mux wire, one process, one bundle.

    Emits (and returns) metric rows; the LAST row is the ``serve_continuous``
    headline carrying both arms' percentiles, ``vs_microbatch`` (microbatch
    p99 / continuous p99 — > 1 means continuous wins), the
    ``bit_exact_stateless`` verdict, the continuous arm's
    occupancy/slot-wait stats and the generating ``burst_config``.
    Stateless bundles only: the microbatch arm cannot serve a recurrent
    bundle at all, so there is nothing to compare (refused loudly)."""
    from p2pmicrogrid_tpu_torch.serve.engine import PolicyEngine
    from p2pmicrogrid_tpu_torch.serve.gateway import (
        AdmissionConfig,
        GatewayServer,
        build_gateway,
    )
    from p2pmicrogrid_tpu_torch.serve.loadgen import (
        make_arrivals,
        run_network_loadgen,
        synthetic_obs,
    )

    from p2pmicrogrid_tpu_torch.device import resolve_device

    device = resolve_device(device)
    reference = PolicyEngine(
        bundle_dir=bundle_dir, max_batch=max_batch, device=device
    )
    if reference.is_recurrent:
        raise ValueError(
            "--continuous-compare needs a stateless bundle: the microbatch "
            "arm refuses recurrent bundles, so there is no baseline to "
            "beat — bench a recurrent bundle through serve-bench --fleet "
            "--batching continuous instead"
        )
    arrivals, burst_config = make_arrivals(
        rate_hz, n_requests, seed=seed,
        burst_factor=burst_factor, burst_dwell_s=burst_dwell_s,
    )
    obs = synthetic_obs(n_requests, reference.n_agents, seed=seed)
    households = [f"house-{i:04d}" for i in range(n_households)]
    # Admission wide open: the comparison measures queueing discipline, not
    # shedding — a shed request would vanish from exactly the tail this
    # capture exists to show.
    admission = AdmissionConfig(max_queue_depth=1 << 16, wait_budget_ms=1e9)

    results, arm_tel = {}, {}
    for batching in ("micro", "continuous"):
        gateway = build_gateway(
            [bundle_dir],
            max_batch=max_batch,
            max_wait_s=max_wait_s,
            results_db=results_db,
            device=device,
            admission=admission,
            run_name=f"serve-cb-{batching}",
            mux_port=0,
            batching=batching,
            max_slots=max_slots,
        )
        server = GatewayServer(gateway)
        try:
            host, _port = server.start()
            results[batching] = run_network_loadgen(
                host, gateway.mux_port, obs, arrivals, households,
                timeout_s=timeout_s, transport="mux",
                record_actions=True,
            )
            default = gateway.registry.get(gateway.registry.default_hash)
            arm_tel[batching] = (
                default.telemetry.summary() if default.telemetry else {}
            )
        finally:
            server.stop()

    micro, cont = results["micro"], results["continuous"]
    # Bit-exactness across the arms AND against the direct engine, on every
    # request both arms answered.
    ok = [
        i for i in range(n_requests)
        if micro.statuses[i] == 200 and cont.statuses[i] == 200
        and micro.actions[i] is not None and cont.actions[i] is not None
    ]
    if not ok:
        # A verdict over zero compared requests would be indistinguishable
        # from a real bit-exactness failure in the schema-checked capture —
        # refuse to produce a meaningless acceptance row.
        raise RuntimeError(
            "continuous compare: no request succeeded on BOTH arms "
            f"(micro ok={micro.n_ok}, continuous ok={cont.n_ok} of "
            f"{n_requests}) — nothing compared; raise timeout_s or loosen "
            "the schedule before trusting any capture from this host"
        )
    got_m = np.asarray(  # host-sync: wire responses, host data
        [micro.actions[i] for i in ok], np.float32
    )
    got_c = np.asarray(  # host-sync: wire responses, host data
        [cont.actions[i] for i in ok], np.float32
    )
    want = reference.act(obs[ok])
    mismatches = int(
        ((got_m != want) | (got_c != want)).any(axis=-1).sum()
    )
    bit_exact = mismatches == 0

    p50_c, p95_c, p99_c = (cont.latency_ms(q) for q in (50, 95, 99))
    p50_m, p95_m, p99_m = (micro.latency_ms(q) for q in (50, 95, 99))
    vs_microbatch = round(p99_m / p99_c, 3) if p99_c > 0 else 0.0
    hists = arm_tel.get("continuous", {}).get("histograms", {})
    occupancy = hists.get("serve.batch_occupancy", {})
    slot_wait = hists.get("serve.slot_wait_ms", {})

    rows = [
        {
            "metric": f"serve_continuous_latency_ms_p{q}",
            "value": round(v, 3),
            "unit": "ms",
            "vs_baseline": round(slo_ms / v, 2) if v > 0 else 0.0,
        }
        for q, v in (("50", p50_c), ("95", p95_c), ("99", p99_c))
    ]
    rows.append(
        {
            "metric": "serve_microbatch_latency_ms_p99",
            "value": round(p99_m, 3),
            "unit": "ms",
            "vs_baseline": round(slo_ms / p99_m, 2) if p99_m > 0 else 0.0,
        }
    )
    rows.append(
        {
            "metric": "serve_continuous",
            "value": vs_microbatch,
            "unit": "x_p99_speedup",
            # >= 1.0 means slot-level continuous batching beats the
            # full-batch microbatch queue on p99 under this schedule.
            "vs_baseline": vs_microbatch,
            "p50_ms": round(p50_c, 3),
            "p95_ms": round(p95_c, 3),
            "p99_ms": round(p99_c, 3),
            "micro_p50_ms": round(p50_m, 3),
            "micro_p95_ms": round(p95_m, 3),
            "micro_p99_ms": round(p99_m, 3),
            "vs_microbatch": vs_microbatch,
            "bit_exact_stateless": bit_exact,
            "bit_exact_mismatches": mismatches,
            "n_compared": len(ok),
            "occupancy_mean": round(float(occupancy.get("mean", 0.0)), 4),
            "occupancy_p50": round(float(occupancy.get("p50", 0.0)), 4),
            "occupancy_p95": round(float(occupancy.get("p95", 0.0)), 4),
            "slot_wait_p50_ms": round(float(slot_wait.get("p50", 0.0)), 3),
            "slot_wait_p95_ms": round(float(slot_wait.get("p95", 0.0)), 3),
            "engine_steps": int(
                arm_tel.get("continuous", {}).get("counters", {}).get(
                    "serve.steps", 0
                )
            ),
            "throughput_rps": round(cont.throughput_rps, 1),
            "micro_throughput_rps": round(micro.throughput_rps, 1),
            "n_requests": n_requests,
            "n_ok": cont.n_ok,
            "micro_n_ok": micro.n_ok,
            "n_households": n_households,
            "offered_rate_rps": rate_hz,
            "slo_ms": slo_ms,
            "transport": "mux",
            "max_batch": max_batch,
            "max_wait_ms": round(max_wait_s * 1e3, 3),
            "max_sessions": max_slots,
            "burst_config": burst_config,
            "implementation": reference.manifest.get("implementation"),
            "n_agents": reference.n_agents,
            "config_hash": reference.manifest.get("config_hash"),
        }
    )
    if emit is not None:
        for row in rows:
            emit(row)
    return rows
