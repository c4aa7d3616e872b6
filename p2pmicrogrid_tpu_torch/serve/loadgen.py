"""Open-loop load generation + SLO reporting for the serving engine.

The port of the JAX package's ``serve/loadgen.py``, host code copied as it
is (it imports only ``serve/wire.py`` and ``telemetry/tracing.py``): the
arrival processes draw from numpy exactly as the JAX package's do, so a seed
gives the same schedule and the same ``synthetic_obs`` bit for bit.
``serve_bench`` drives the port's ``PolicyEngine``; on the card it captures
every bucket's CUDA graph before the timed window (``engine.warmup``), so
tail latency never reads a capture.

The question serve-bench answers: at a given request rate, what latency do
households see from the batched engine, and how much compute does padding
waste? Methodology:

* **Arrivals are open-loop** (Poisson, fixed rate, independent of service
  times) — the standard way to expose queueing delay; a closed loop would
  let a slow server throttle its own offered load and flatter the tail.
* **Batching runs on a virtual clock.** ``plan_open_loop`` replays the
  microbatch policy (dispatch at ``max_batch`` queued or ``max_wait`` after
  the oldest arrival, server serially busy) deterministically over the
  arrival times, asking a ``service_time_fn`` how long each dispatched
  batch takes. serve-bench passes a ``service_time_fn`` that EXECUTES the
  batch on the real engine and returns the measured wall time, so queueing
  waits are exactly reproducible while service times are real; tests pass a
  synthetic model, making the whole percentile pipeline deterministic under
  a fixed seed.
* **Per-request latency** = batch completion - request arrival (queue wait
  + padded-batch service). Reported as p50/p95/p99 against an SLO budget,
  plus throughput (completed / makespan) and the padding-waste fraction.

Output goes through the telemetry stdout sink with the same one-JSON-per-
line hygiene as ``bench`` (rows follow the metric-row schema that
``tools/check_artifacts_schema.py`` validates; the LAST line is the
headline row carrying every stat).
"""

from __future__ import annotations

import asyncio
import json
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np

from p2pmicrogrid_tpu_torch.serve.wire import FrameTooLarge, WireProtocolError
from p2pmicrogrid_tpu_torch.telemetry.tracing import record_span, root_context


# --- client retry primitives --------------------------------------------------
#
# Shared by the network loadgen's optional retry mode (below) and the fleet
# router (serve/router.py), which layers failover re-routing on top. They
# live here — not in router.py — so the import direction stays acyclic
# (router imports loadgen for the open-loop schedule machinery).


@dataclass(frozen=True)
class RetryPolicy:
    """Client-side retry discipline for transient serve failures.

    * ``max_attempts`` bounds tries per request (1 = never retry).
    * ``deadline_s`` is the per-request wall budget: no attempt or backoff
      sleep may start past it — a household's 15-minute-slot decision is
      worthless late, so requests fail fast rather than queue forever.
    * Backoff between attempts is capped exponential with multiplicative
      jitter: ``base * 2^attempt`` clipped to ``backoff_cap_s``, scaled by
      a uniform draw from [1 - jitter, 1]. Jitter de-synchronizes retry
      waves — a fleet-wide brown-out must not turn into a synchronized
      retry hammer on the recovering replica.
    * A server-supplied ``Retry-After`` (429/503 sheds carry one) takes
      precedence over the computed backoff when larger — the server knows
      its own recovery horizon better than the client's guess.
    """

    max_attempts: int = 4
    deadline_s: float = 10.0
    backoff_base_s: float = 0.05
    backoff_cap_s: float = 2.0
    jitter: float = 0.5
    honor_retry_after: bool = True

    def backoff_s(
        self,
        attempt: int,
        rng: random.Random,
        retry_after_s: Optional[float] = None,
    ) -> float:
        """Sleep before attempt ``attempt + 1`` (attempt counts from 0)."""
        base = min(self.backoff_cap_s, self.backoff_base_s * (2.0 ** attempt))
        delay = base * (1.0 - self.jitter * rng.random())
        if retry_after_s is not None and self.honor_retry_after:
            delay = max(delay, retry_after_s)
        return delay


class RetryBudget:
    """Token-bucket retry budget (the anti-retry-storm governor).

    Every first attempt deposits ``ratio`` tokens (capped); every retry
    withdraws one. Under a brown-out the bucket drains and retries STOP
    fleet-wide at ~``ratio`` of offered load, instead of each client
    multiplying the overload by ``max_attempts`` — the retry-storm
    failure mode. ``min_tokens`` is the starting balance so low-traffic
    periods can still retry. Thread-safe (the router's probe thread and
    event loop share it).
    """

    def __init__(
        self, ratio: float = 0.2, min_tokens: float = 8.0,
        cap: float = 64.0,
    ):
        if ratio < 0:
            raise ValueError(f"ratio must be >= 0, got {ratio}")
        self.ratio = ratio
        self.cap = max(cap, min_tokens)
        self._tokens = min(min_tokens, self.cap)
        self._lock = threading.Lock()
        self.spent = 0
        self.denied = 0

    @property
    def tokens(self) -> float:
        with self._lock:
            return self._tokens

    def on_attempt(self) -> None:
        """Deposit for one FIRST attempt (not retries)."""
        with self._lock:
            self._tokens = min(self.cap, self._tokens + self.ratio)

    def try_spend(self) -> bool:
        """Withdraw one token for a retry; False = budget exhausted."""
        with self._lock:
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                self.spent += 1
                return True
            self.denied += 1
            return False


# Arrival schedules are built on an integer-nanosecond virtual clock and
# only converted to float seconds at the edge. A float64 cumsum of ~10 us
# exponential gaps accumulates rounding drift that grows with n — at
# 100k rps x minutes (10^7+ arrivals) the drift reaches the same order as
# the gaps themselves, silently reshaping batch composition between runs
# of different lengths. int64 addition is exact; 2^53 ns (~104 days of
# virtual time) bounds where the final float conversion stays exact too.
_MAX_EXACT_NS = 1 << 53


def gaps_to_schedule_ns(gaps_s: np.ndarray) -> np.ndarray:
    """Quantize inter-arrival gaps (seconds) to >= 1 ns each and cumsum on
    the int64 nanosecond clock — the exact arrival schedule. The 1 ns
    floor keeps the schedule STRICTLY increasing (a zero-quantized gap
    would make two arrivals simultaneous and dispatch-order ambiguous)."""
    gaps_ns = np.rint(np.asarray(gaps_s, dtype=float) * 1e9).astype(np.int64)
    np.maximum(gaps_ns, 1, out=gaps_ns)
    t_ns = np.cumsum(gaps_ns)
    if t_ns.size and int(t_ns[-1]) >= _MAX_EXACT_NS:
        raise OverflowError(
            f"arrival schedule spans {int(t_ns[-1])} ns >= 2^53 — beyond "
            "~104 days of virtual time the float64 second conversion "
            "stops being nanosecond-exact; split the schedule"
        )
    return t_ns


def schedule_ns_to_s(t_ns: np.ndarray) -> np.ndarray:
    """int64 nanosecond schedule -> float64 seconds. Below 2^53 ns every
    tick is exactly representable, so ``round(t * 1e9)`` round-trips to
    the integer schedule (regression-tested in tests/test_scale.py)."""
    t_ns = np.asarray(t_ns, dtype=np.int64)
    if t_ns.size and int(t_ns[-1]) >= _MAX_EXACT_NS:
        raise OverflowError(
            f"schedule tick {int(t_ns[-1])} ns >= 2^53 is not exactly "
            "representable in float64 seconds"
        )
    return t_ns.astype(np.float64) / 1e9


def poisson_arrivals(rate_hz: float, n: int, seed: int = 0) -> np.ndarray:
    """Cumulative arrival times (seconds) of ``n`` Poisson requests,
    exact on the integer-nanosecond virtual clock (no cumsum drift at
    100k+ rps x minutes — see ``gaps_to_schedule_ns``)."""
    if rate_hz <= 0:
        raise ValueError(f"rate_hz must be > 0, got {rate_hz}")
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate_hz, size=n)
    return schedule_ns_to_s(gaps_to_schedule_ns(gaps))


def bursty_arrivals(
    rate_hz: float,
    n: int,
    burst_factor: float = 8.0,
    burst_dwell_s: float = 0.25,
    seed: int = 0,
) -> np.ndarray:
    """Markov-modulated on/off Poisson arrivals (MMPP-2): ``n`` arrival
    times under a two-state process that alternates exponential dwells
    (mean ``burst_dwell_s``) between an ON rate ``burst_factor`` times the
    OFF rate, scaled so the MEAN offered rate stays ``rate_hz``:

        rate_on  = rate_hz * 2 * f / (1 + f)
        rate_off = rate_hz * 2     / (1 + f)        (f = burst_factor)

    This is the arrival family that exposes the batch-boundary-wait
    pathology the continuous batcher removes: every burst onset lands a
    clump of requests behind whatever the microbatch queue has in flight
    plus its coalescing window, so the p99 is set by waits, not compute.
    ``burst_factor=1`` degenerates to plain Poisson. Deterministic given
    the seed (one ``np.random.default_rng`` stream drives dwells and gaps
    in a fixed order).
    """
    if rate_hz <= 0:
        raise ValueError(f"rate_hz must be > 0, got {rate_hz}")
    if burst_factor < 1.0:
        raise ValueError(f"burst_factor must be >= 1, got {burst_factor}")
    if burst_factor == 1.0:
        return poisson_arrivals(rate_hz, n, seed=seed)
    if burst_dwell_s <= 0:
        raise ValueError(f"burst_dwell_s must be > 0, got {burst_dwell_s}")
    rng = np.random.default_rng(seed)
    rate_on = rate_hz * 2.0 * burst_factor / (1.0 + burst_factor)
    rate_off = rate_hz * 2.0 / (1.0 + burst_factor)
    # Same integer-nanosecond clock as poisson_arrivals: each drawn dwell
    # and gap is quantized to >= 1 ns at the draw, and the running clocks
    # are Python ints — exact at any n, so long schedules cannot drift a
    # request across a dwell boundary relative to short ones.
    arrivals_ns: List[int] = []
    t_ns = 0
    on = True  # start in a burst: the first dispatch already sees a clump
    while len(arrivals_ns) < n:
        dwell_ns = max(1, round(rng.exponential(burst_dwell_s) * 1e9))
        rate = rate_on if on else rate_off
        tt_ns = t_ns
        while len(arrivals_ns) < n:
            tt_ns += max(1, round(rng.exponential(1.0 / rate) * 1e9))
            if tt_ns >= t_ns + dwell_ns:
                break
            arrivals_ns.append(tt_ns)
        t_ns += dwell_ns
        on = not on
    return schedule_ns_to_s(np.asarray(arrivals_ns[:n], dtype=np.int64))


def make_arrivals(
    rate_hz: float,
    n: int,
    seed: int = 0,
    burst_factor: float = 1.0,
    burst_dwell_s: float = 0.25,
):
    """(arrivals, burst_config) — the one place the bench entry points
    resolve their arrival mode, so every headline reports the SAME
    ``burst_config`` block the schedule was actually generated under.
    ``burst_factor != 1`` routes through ``bursty_arrivals``, so an
    out-of-range value (< 1) fails ITS loud validation instead of being
    silently benched as plain Poisson."""
    if burst_factor != 1.0:
        return (
            bursty_arrivals(
                rate_hz, n, burst_factor=burst_factor,
                burst_dwell_s=burst_dwell_s, seed=seed,
            ),
            {
                "mode": "bursty",
                "burst_factor": burst_factor,
                "burst_dwell_s": burst_dwell_s,
                "seed": seed,
            },
        )
    return (
        poisson_arrivals(rate_hz, n, seed=seed),
        {"mode": "poisson", "seed": seed},
    )


@dataclass
class LoadgenResult:
    """Per-request latencies plus the batch schedule that produced them."""

    latencies_s: np.ndarray      # [N]
    batch_sizes: List[int]
    bucket_sizes: List[int]
    makespan_s: float            # first arrival -> last completion
    # Full batch schedule (per batch): first request index, dispatch instant
    # and measured/modeled service seconds — enough to reconstruct every
    # request's enqueue->dispatch wait for the per-request trace records.
    batch_starts: List[int] = field(default_factory=list)
    dispatch_s: List[float] = field(default_factory=list)
    service_s: List[float] = field(default_factory=list)

    @property
    def n_requests(self) -> int:
        return int(self.latencies_s.shape[0])

    @property
    def throughput_rps(self) -> float:
        return self.n_requests / self.makespan_s if self.makespan_s > 0 else 0.0

    @property
    def padding_waste(self) -> float:
        """Fraction of computed batch rows that were padding."""
        total = sum(self.bucket_sizes)
        return 1.0 - sum(self.batch_sizes) / total if total else 0.0

    def latency_ms(self, q: float) -> float:
        return float(np.percentile(self.latencies_s, q) * 1e3)


def plan_open_loop(
    arrivals: np.ndarray,
    service_time_fn: Callable[[int, int], float],
    max_batch: int,
    max_wait_s: float,
    bucket_fn: Optional[Callable[[int], int]] = None,
) -> LoadgenResult:
    """Deterministic replay of the microbatch policy over ``arrivals``.

    ``service_time_fn(i, j)`` serves requests [i, j) and returns the batch's
    service seconds (measured on a real engine, or modeled in tests).
    Dispatch rule, matching ``engine.MicroBatchQueue`` exactly: the batch's
    coalescing window is anchored at its OLDEST request's arrival — dispatch
    at ``max(server_free, oldest_arrival + max_wait_s)``, or as soon as
    ``max_batch`` requests have queued (but never before the server frees);
    every request arrived by the dispatch instant joins, up to the cap.
    """
    if bucket_fn is None:
        bucket_fn = lambda n: n
    arrivals = np.asarray(arrivals, dtype=float)
    n = arrivals.shape[0]
    latencies = np.zeros(n)
    batch_sizes: List[int] = []
    bucket_sizes: List[int] = []
    batch_starts: List[int] = []
    dispatch_s: List[float] = []
    service_s: List[float] = []
    free = 0.0
    i = 0
    while i < n:
        dispatch = max(free, arrivals[i] + max_wait_s)
        j = i + 1
        while j < n and (j - i) < max_batch and arrivals[j] <= dispatch:
            j += 1
        if (j - i) == max_batch:
            # Filled before the window closed: dispatch at the filling
            # arrival (or the moment the server frees, whichever is later).
            dispatch = max(free, arrivals[j - 1])
        service = service_time_fn(i, j)
        done = dispatch + service
        latencies[i:j] = done - arrivals[i:j]
        batch_sizes.append(j - i)
        bucket_sizes.append(bucket_fn(j - i))
        batch_starts.append(i)
        dispatch_s.append(float(dispatch))
        service_s.append(float(service))
        free = done
        i = j
    return LoadgenResult(
        latencies_s=latencies,
        batch_sizes=batch_sizes,
        bucket_sizes=bucket_sizes,
        makespan_s=float(free - arrivals[0]),
        batch_starts=batch_starts,
        dispatch_s=dispatch_s,
        service_s=service_s,
    )


def synthetic_obs(n: int, n_agents: int, seed: int = 0) -> np.ndarray:
    """Request observations drawn uniformly over the serving contract's
    feature ranges (obs_spec: time in [0,1), the normalized features in
    [-1, 1])."""
    rng = np.random.default_rng(seed)
    obs = np.empty((n, n_agents, 4), dtype=np.float32)
    obs[..., 0] = rng.uniform(0.0, 1.0, (n, n_agents))
    obs[..., 1:] = rng.uniform(-1.0, 1.0, (n, n_agents, 3))
    return obs


def _emit_request_traces(tel, arrivals: np.ndarray, result: LoadgenResult) -> None:
    """One ``serve_request`` event per request from the replayed batch
    schedule (same fields as ``MicroBatchQueue``'s live traces, plus the
    virtual-clock arrival/dispatch instants)."""
    for b, start in enumerate(result.batch_starts):
        size = result.batch_sizes[b]
        bucket = result.bucket_sizes[b]
        dispatch = result.dispatch_s[b]
        service_ms = result.service_s[b] * 1e3
        for r in range(start, start + size):
            wait_ms = (dispatch - arrivals[r]) * 1e3
            tel.event(
                "serve_request",
                source="loadgen",
                request=r,
                batch=b,
                batch_size=size,
                bucket=bucket,
                padded_rows=bucket - size,
                arrival_s=round(float(arrivals[r]), 6),
                dispatch_s=round(dispatch, 6),
                wait_ms=round(wait_ms, 3),
                service_ms=round(service_ms, 3),
                latency_ms=round(float(result.latencies_s[r]) * 1e3, 3),
            )


# --- wire-level load generation (serve-bench --network) ----------------------
#
# The virtual-clock planner above answers "what do the QUEUE + DEVICE cost?";
# the network mode answers "what does a household actually SEE?" — the same
# open-loop Poisson schedule fired over real sockets at the serve gateway
# (serve/gateway.py), so wire latencies include HTTP framing, the asyncio
# handler, queue coalescing and the engine batch. Shed requests (admission
# control answering 429) are a first-class stat, not an error.


@dataclass
class NetworkLoadgenResult:
    """Per-request wire measurements from one network loadgen run."""

    latencies_s: np.ndarray    # [N] send -> FINAL response (incl. retries)
    statuses: np.ndarray       # [N] final HTTP status (-1 = transport error)
    config_hashes: List       # per request: serving bundle hash (None if shed)
    makespan_s: float          # first send -> last completion
    # Per-request retry counts and gave-up flags (all-zero when the
    # loadgen runs in its default no-retry mode).
    retries: Optional[np.ndarray] = None
    gave_up: Optional[np.ndarray] = None
    # Wire bookkeeping: which transport ran, and (mux) how many physical
    # connections it cost — the whole point of the persistent wire is
    # that wire_connects stays tiny while n_requests grows.
    transport: str = "http"
    wire_connects: int = 0
    wire_reconnects: int = 0
    wire_replays: int = 0
    # Per-request served actions (lists, None when shed/failed) — recorded
    # only when the loadgen ran with record_actions=True (the
    # continuous-vs-microbatch bit-exactness comparison needs the payloads,
    # not just the latencies).
    actions: Optional[List] = None

    def __post_init__(self):
        n = int(self.statuses.shape[0])
        if self.retries is None:
            self.retries = np.zeros(n, dtype=np.int64)
        if self.gave_up is None:
            self.gave_up = np.zeros(n, dtype=bool)

    @property
    def n_requests(self) -> int:
        return int(self.statuses.shape[0])

    @property
    def n_ok(self) -> int:
        return int((self.statuses == 200).sum())

    @property
    def n_shed(self) -> int:
        return int((self.statuses == 429).sum())

    @property
    def n_errors(self) -> int:
        return int(
            ((self.statuses != 200) & (self.statuses != 429)).sum()
        )

    @property
    def shed_rate(self) -> float:
        return self.n_shed / self.n_requests if self.n_requests else 0.0

    @property
    def total_retries(self) -> int:
        return int(self.retries.sum())

    @property
    def retry_rate(self) -> float:
        """Retries per offered request (0.0 in no-retry mode)."""
        return self.total_retries / self.n_requests if self.n_requests else 0.0

    @property
    def n_gave_up(self) -> int:
        """Requests that retried and still failed (exhausted attempts,
        budget or deadline)."""
        return int(self.gave_up.sum())

    @property
    def throughput_rps(self) -> float:
        return self.n_ok / self.makespan_s if self.makespan_s > 0 else 0.0

    def latency_ms(self, q: float) -> float:
        """Percentile over SERVED requests (shed answers return in
        microseconds and would flatter the tail)."""
        ok = self.latencies_s[self.statuses == 200]
        return float(np.percentile(ok, q) * 1e3) if ok.size else 0.0


async def _http_request_json(
    host: str,
    port: int,
    method: str,
    path: str,
    payload: Optional[dict],
    timeout_s: float,
    ssl=None,
    token: Optional[str] = None,
    trace: Optional[str] = None,
):
    """One JSON request over a fresh connection; returns (status, parsed
    body, response headers). A non-empty body that fails to parse comes
    back as ``None`` (NOT ``{}``) so callers can tell payload corruption
    from an intentionally empty response and retry it. Stdlib-only
    HTTP/1.1 — mirrors the gateway's server side; the ONE copy of the
    client framing logic (the fleet router's GETs share it). ``ssl`` is a
    client SSLContext for TLS-terminating gateways; ``token`` rides as the
    ``Authorization: Bearer`` credential (serve/auth.py); ``trace`` is an
    encoded distributed-trace context (telemetry/tracing.py) carried as
    the ``x-p2p-trace`` header — the HTTP front's propagation channel."""
    body = json.dumps(payload).encode() if payload is not None else b""
    head = f"{method} {path} HTTP/1.1\r\nHost: {host}:{port}\r\n"
    if token is not None:
        head += f"Authorization: Bearer {token}\r\n"
    if trace is not None:
        head += f"x-p2p-trace: {trace}\r\n"
    if payload is not None:
        head += (
            "Content-Type: application/json\r\n"
            f"Content-Length: {len(body)}\r\n"
        )
    request = (head + "Connection: close\r\n\r\n").encode() + body
    reader, writer = await asyncio.wait_for(
        asyncio.open_connection(host, port, ssl=ssl), timeout_s
    )
    try:
        writer.write(request)
        await writer.drain()
        status_line = await asyncio.wait_for(reader.readline(), timeout_s)
        parts = status_line.decode("latin-1").split()
        status = int(parts[1]) if len(parts) >= 2 else -1
        length = 0
        headers = {}
        while True:
            h = await asyncio.wait_for(reader.readline(), timeout_s)
            if h in (b"\r\n", b"\n", b""):
                break
            name, _, value = h.decode("latin-1").partition(":")
            headers[name.strip().lower()] = value.strip()
            if name.strip().lower() == "content-length":
                length = int(value.strip())
        raw = (
            await asyncio.wait_for(reader.readexactly(length), timeout_s)
            if length else b""
        )
        try:
            doc = json.loads(raw.decode()) if raw else {}
        except (UnicodeDecodeError, json.JSONDecodeError):
            doc = None  # detectably corrupt payload
        return status, doc, headers
    finally:
        writer.close()
        try:
            await writer.wait_closed()
        except (ConnectionError, OSError):
            pass


async def _http_post_json(
    host: str, port: int, path: str, payload: dict, timeout_s: float,
    ssl=None, token: Optional[str] = None, trace: Optional[str] = None,
):
    """(status, doc, headers) of one POST — see ``_http_request_json``."""
    return await _http_request_json(
        host, port, "POST", path, payload, timeout_s, ssl=ssl, token=token,
        trace=trace,
    )


def _retry_after_s(headers: Optional[dict]) -> Optional[float]:
    """The Retry-After header as seconds, when present and numeric."""
    if not headers:
        return None
    try:
        value = headers.get("retry-after")
        return float(value) if value is not None else None
    except (TypeError, ValueError):
        return None


def run_network_loadgen(
    host: str,
    port: int,
    obs: np.ndarray,
    arrivals: np.ndarray,
    households: List[str],
    path: str = "/v1/act",
    timeout_s: float = 30.0,
    retry: Optional[RetryPolicy] = None,
    retry_seed: int = 0,
    transport: str = "http",
    ssl=None,
    token_fn=None,
    mux_pool_size: int = 2,
    mux_max_frame_bytes: Optional[int] = None,
    record_actions: bool = False,
    trace_seed: Optional[int] = None,
    trace_telemetry=None,
) -> NetworkLoadgenResult:
    """Fire ``obs[i]`` at the gateway at ``arrivals[i]`` seconds (open loop:
    send times never wait on completions) and measure wire latencies.

    ``transport="http"`` (the committed-capture default) opens one
    connection per request — each simulated household is an independent
    remote client, and this is exactly the per-request wire cost the
    persistent protocol exists to kill. ``transport="mux"`` drives the
    SAME schedule through a shared persistent multiplexed pool
    (serve/wire.py ``MuxPool`` against the gateway's mux listener at
    ``port``): keep-alive framed connections, responses matched by id —
    the head-to-head comparison ``serve-bench --wire-compare`` reports.

    ``ssl`` is a client SSLContext (TLS gateways); ``token_fn(household)``
    supplies the per-household bearer (None = unauthenticated). 401/403
    answers are TERMINAL: never retried, never charged to the retry
    machinery — an auth failure cannot become a retry storm.

    ``retry=None`` (the default) preserves the capture semantics every
    committed ``SERVE_GATEWAY_*`` row was measured under: a 429 is a
    terminal shed, a transport error a terminal failure. With a
    ``RetryPolicy``, shed (429) and transient-failure (5xx / transport /
    corrupt-payload) responses are retried with capped jittered backoff,
    honoring the server's ``Retry-After``, inside the policy's deadline;
    the result then reports ``retry_rate`` and ``n_gave_up`` next to
    ``shed_rate``, and latency includes the backoff time a real client
    would spend. Retry sleeps are seeded (``retry_seed``) so two runs
    draw identical jitter.

    ``trace_seed`` (not None) turns on distributed tracing: request ``i``
    carries the deterministic root context ``root_context(trace_seed, i)``
    on the wire (HTTP header / mux frame field), so the server-side spans
    of two replays of one schedule stitch into byte-identical trees. With
    ``trace_telemetry`` the loadgen also records the client-side root span
    (``client.request``: send -> final response, retries included) — the
    tree's top without a router in front.
    """
    if transport not in ("http", "mux"):
        raise ValueError(f"transport must be 'http' or 'mux', got {transport!r}")
    obs = np.asarray(obs, dtype=np.float32)  # host-sync: host-side inputs
    arrivals = np.asarray(arrivals, dtype=float)
    n = int(arrivals.shape[0])
    latencies = np.zeros(n)
    statuses = np.full(n, -1, dtype=np.int64)
    retries = np.zeros(n, dtype=np.int64)
    gave_up = np.zeros(n, dtype=bool)
    hashes: List = [None] * n
    actions_out: Optional[List] = [None] * n if record_actions else None
    pool_box: List = [None]  # MuxPool, created inside the event loop

    async def attempt(
        payload: dict, attempt_timeout_s: float, token: Optional[str],
        trace: Optional[str] = None,
    ):
        """(status, doc, headers); transport failures -> status -1."""
        try:
            if transport == "mux":
                if pool_box[0] is None:
                    from p2pmicrogrid_tpu_torch.serve.wire import MuxPool

                    # Match the gateway's admission.max_body_bytes when
                    # it is configured below the wire default: the
                    # client-side cap is what makes an over-cap request
                    # a terminal 413 instead of an unattributable hang.
                    kw = {}
                    if mux_max_frame_bytes is not None:
                        kw["max_frame_bytes"] = mux_max_frame_bytes
                    pool_box[0] = MuxPool(
                        host, port, size=mux_pool_size, ssl=ssl, **kw
                    )
                return await pool_box[0].request(
                    path, payload, attempt_timeout_s, token=token,
                    trace=trace,
                )
            return await _http_post_json(
                host, port, path, payload, attempt_timeout_s,
                ssl=ssl, token=token, trace=trace,
            )
        except FrameTooLarge as err:
            # Over-cap REQUEST on the mux wire: the terminal 413 the HTTP
            # wire answers for the same payload, not a transport failure.
            return 413, {"error": str(err)}, {}
        except (
            ConnectionError, OSError, EOFError, ValueError,
            asyncio.TimeoutError, asyncio.IncompleteReadError,
            WireProtocolError,  # malformed peer frames (mux transport)
        ):
            # Transport failures score as status -1 (n_errors), they must
            # not abort the whole open-loop schedule mid-run.
            return -1, {}, {}

    async def one(i: int, t0: float) -> None:
        delay = (arrivals[i] - arrivals[0]) - (time.perf_counter() - t0)
        if delay > 0:
            await asyncio.sleep(delay)
        household = households[i % len(households)]
        payload = {"household": household, "obs": obs[i].tolist()}
        token = token_fn(household) if token_fn is not None else None
        rng = random.Random((retry_seed << 20) ^ i)
        ctx = root_context(trace_seed, i) if trace_seed is not None else None
        t_send = time.perf_counter()
        t_send_epoch = time.time()
        deadline = t_send + (retry.deadline_s if retry else timeout_s)
        tries = 0
        while True:
            # In retry mode the per-request deadline caps every attempt's
            # socket timeout too — one hung attempt must not overrun the
            # policy's wall budget by the full transport timeout.
            attempt_timeout = timeout_s if retry is None else max(
                0.05, min(timeout_s, deadline - time.perf_counter())
            )
            status, doc, headers = await attempt(
                payload, attempt_timeout, token,
                trace=ctx.encode() if ctx is not None else None,
            )
            tries += 1
            # A 200 whose payload failed to parse is a corrupt answer —
            # retryable, never reported as success.
            corrupt = status == 200 and doc is None
            ok = status == 200 and not corrupt
            # 401/403 join the terminal set: retrying a rejected
            # credential cannot succeed and must not consume the retry
            # machinery honest failures depend on.
            terminal_client_err = status in (400, 401, 403, 404, 405, 413)
            if corrupt:
                status = -1
            if (
                retry is None or ok or terminal_client_err
                or tries >= retry.max_attempts
            ):
                gave_up[i] = retry is not None and tries > 1 and not ok
                break
            # Past here the failure is retryable (shed/5xx/transport/
            # corrupt) and attempts remain — back off unless the sleep
            # itself would overrun the request deadline.
            backoff = retry.backoff_s(
                tries - 1, rng, _retry_after_s(headers)
            )
            if time.perf_counter() + backoff >= deadline:
                gave_up[i] = True
                break
            retries[i] += 1
            await asyncio.sleep(backoff)
        latencies[i] = time.perf_counter() - t_send
        statuses[i] = status
        hashes[i] = (doc or {}).get("config_hash")
        if actions_out is not None:
            actions_out[i] = (doc or {}).get("actions")
        if ctx is not None and trace_telemetry is not None:
            record_span(
                trace_telemetry, ctx, "client.request",
                t_send_epoch, float(latencies[i]),
                status=int(status), retries=int(retries[i]),
            )
            trace_telemetry.histogram(
                "client.latency_ms", float(latencies[i]) * 1e3,
                trace_id=ctx.trace_id,
            )

    async def run() -> float:
        t0 = time.perf_counter()
        try:
            await asyncio.gather(*(one(i, t0) for i in range(n)))
        finally:
            if pool_box[0] is not None:
                await pool_box[0].close()
        return time.perf_counter() - t0

    makespan = asyncio.run(run())
    pool = pool_box[0]
    return NetworkLoadgenResult(
        latencies_s=latencies,
        statuses=statuses,
        config_hashes=hashes,
        makespan_s=makespan,
        retries=retries,
        gave_up=gave_up,
        transport=transport,
        wire_connects=pool.connects if pool is not None else 0,
        wire_reconnects=pool.reconnects if pool is not None else 0,
        wire_replays=pool.replays if pool is not None else 0,
        actions=actions_out,
    )


def serve_bench_network(
    host: str,
    port: int,
    n_agents: int,
    rate_hz: float = 256.0,
    n_requests: int = 1024,
    n_households: int = 16,
    seed: int = 0,
    slo_ms: float = 100.0,
    timeout_s: float = 30.0,
    emit: Optional[Callable[[dict], None]] = None,
    extra_headline: Optional[dict] = None,
    retry: Optional[RetryPolicy] = None,
    transport: str = "http",
    ssl=None,
    token_fn=None,
    burst_factor: float = 1.0,
    burst_dwell_s: float = 0.25,
) -> List[dict]:
    """Wire-level SLO benchmark: the serve-bench schedule over real sockets.

    Same row contract as ``serve_bench`` (metric rows, headline LAST), with
    wire percentiles and the admission-control shed rate. ``vs_baseline``:
    SLO headroom for latency rows, served/offered for throughput, and the
    served fraction (1 - shed_rate) for the shed row. With ``retry`` the
    client retries sheds/transients (see ``run_network_loadgen``) and the
    headline grows ``retry_rate``/``n_gave_up``. ``transport``/``ssl``/
    ``token_fn`` select the wire (see ``run_network_loadgen``); with
    ``transport="mux"``, ``port`` is the gateway's MUX port.
    """
    arrivals, burst_config = make_arrivals(
        rate_hz, n_requests, seed=seed,
        burst_factor=burst_factor, burst_dwell_s=burst_dwell_s,
    )
    obs = synthetic_obs(n_requests, n_agents, seed=seed)
    households = [f"house-{i:04d}" for i in range(n_households)]
    result = run_network_loadgen(
        host, port, obs, arrivals, households, timeout_s=timeout_s,
        retry=retry, retry_seed=seed,
        transport=transport, ssl=ssl, token_fn=token_fn,
    )
    p50, p95, p99 = (result.latency_ms(q) for q in (50, 95, 99))
    rows = [
        {
            "metric": f"serve_gateway_latency_ms_p{q}",
            "value": round(v, 3),
            "unit": "ms",
            "vs_baseline": round(slo_ms / v, 2) if v > 0 else 0.0,
        }
        for q, v in (("50", p50), ("95", p95), ("99", p99))
    ]
    rows.append(
        {
            "metric": "serve_gateway_throughput_rps",
            "value": round(result.throughput_rps, 1),
            "unit": "requests/sec",
            "vs_baseline": round(result.throughput_rps / rate_hz, 3),
        }
    )
    rows.append(
        {
            "metric": "serve_gateway_shed_rate",
            "value": round(result.shed_rate, 4),
            "unit": "fraction",
            "vs_baseline": round(1.0 - result.shed_rate, 4),
        }
    )
    served_hashes = sorted(
        {h for h in result.config_hashes if h is not None}
    )
    rows.append(
        {
            "metric": "serve_bench_network",
            "value": round(p99, 3),
            "unit": "ms",
            "vs_baseline": round(slo_ms / p99, 2) if p99 > 0 else 0.0,
            "p50_ms": round(p50, 3),
            "p95_ms": round(p95, 3),
            "p99_ms": round(p99, 3),
            "throughput_rps": round(result.throughput_rps, 1),
            "shed_rate": round(result.shed_rate, 4),
            "n_requests": n_requests,
            "n_ok": result.n_ok,
            "n_shed": result.n_shed,
            "n_errors": result.n_errors,
            "retry_rate": round(result.retry_rate, 4),
            "n_gave_up": result.n_gave_up,
            "retry_enabled": retry is not None,
            "transport": transport,
            "tls": ssl is not None,
            "auth": token_fn is not None,
            "wire_connects": result.wire_connects,
            "wire_reconnects": result.wire_reconnects,
            "n_households": n_households,
            "offered_rate_rps": rate_hz,
            "slo_ms": slo_ms,
            "burst_config": burst_config,
            "served_config_hashes": served_hashes,
            **(extra_headline or {}),
        }
    )
    if emit is not None:
        for row in rows:
            emit(row)
    return rows


def serve_bench_wire_compare(
    host: str,
    http_port: int,
    mux_port: int,
    n_agents: int,
    rate_hz: float = 256.0,
    n_requests: int = 512,
    n_households: int = 16,
    seed: int = 0,
    timeout_s: float = 30.0,
    ssl=None,
    token_fn=None,
    emit: Optional[Callable[[dict], None]] = None,
) -> dict:
    """The per-request-connection client vs the persistent multiplexed
    wire, SAME open-loop schedule and observations, one ``wire_comparison``
    row: per-transport p50/p95/p99 and the mux/http speedups: the
    acceptance measurement for the persistent wire."""
    arrivals = poisson_arrivals(rate_hz, n_requests, seed=seed)
    obs = synthetic_obs(n_requests, n_agents, seed=seed)
    households = [f"house-{i:04d}" for i in range(n_households)]
    results = {}
    for transport, port in (("http", http_port), ("mux", mux_port)):
        results[transport] = run_network_loadgen(
            host, port, obs, arrivals, households, timeout_s=timeout_s,
            transport=transport, ssl=ssl, token_fn=token_fn,
        )
    http_r, mux_r = results["http"], results["mux"]
    p95_http, p95_mux = http_r.latency_ms(95), mux_r.latency_ms(95)
    row = {
        "metric": "wire_comparison",
        "value": round(p95_http / p95_mux, 3) if p95_mux > 0 else 0.0,
        "unit": "x_p95_speedup",
        # >= 1.0 means the persistent wire beats per-request connections
        # on p95 — the acceptance bar.
        "vs_baseline": round(p95_http / p95_mux, 3) if p95_mux > 0 else 0.0,
        "n_requests": n_requests,
        "offered_rate_rps": rate_hz,
        "tls": ssl is not None,
        "auth": token_fn is not None,
        "http_p50_ms": round(http_r.latency_ms(50), 3),
        "http_p95_ms": round(p95_http, 3),
        "http_p99_ms": round(http_r.latency_ms(99), 3),
        "http_n_ok": http_r.n_ok,
        "mux_p50_ms": round(mux_r.latency_ms(50), 3),
        "mux_p95_ms": round(p95_mux, 3),
        "mux_p99_ms": round(mux_r.latency_ms(99), 3),
        "mux_n_ok": mux_r.n_ok,
        "mux_connections": mux_r.wire_connects,
    }
    if emit is not None:
        emit(row)
    return row


def serve_bench(
    engine,
    rate_hz: float = 256.0,
    n_requests: int = 2048,
    max_batch: Optional[int] = None,
    max_wait_s: float = 0.002,
    seed: int = 0,
    slo_ms: float = 100.0,
    emit: Optional[Callable[[dict], None]] = None,
    service_time_fn: Optional[Callable[[int, int], float]] = None,
    burst_factor: float = 1.0,
    burst_dwell_s: float = 0.25,
) -> List[dict]:
    """Drive ``engine`` with an open-loop Poisson stream; report SLO metrics.

    Emits (and returns) metric rows in the bench schema. ``vs_baseline``
    semantics per row: latency rows report SLO headroom (``slo_ms / pXX`` —
    > 1 means inside budget); throughput reports achieved/offered;
    padding-waste reports the useful-row fraction (1 - waste). The LAST row
    is the headline, carrying all stats plus compile/execute span timings.
    """
    from p2pmicrogrid_tpu_torch.telemetry import current, phase_timings

    max_batch = min(max_batch or engine.max_batch, engine.max_batch)
    arrivals, burst_config = make_arrivals(
        rate_hz, n_requests, seed=seed,
        burst_factor=burst_factor, burst_dwell_s=burst_dwell_s,
    )
    obs = synthetic_obs(n_requests, engine.n_agents, seed=seed)

    tel = current()
    with tel.span("compile:serve", max_batch=max_batch):
        # Capture every bucket the planner can hit (one CUDA graph each on
        # the card): tail latency must measure the queue + device, not a
        # bucket's first-use capture. The limit is
        # the bucket a full max_batch PADS to — with a non-power-of-two
        # max_batch, batches between the last smaller bucket and max_batch
        # land in bucket_for(max_batch), which must be warm too.
        limit = engine.bucket_for(max_batch)
        # include_step=False: this benchmark only drives act(); capturing
        # the session-step graphs would double compile_s for nothing.
        engine.warmup(
            [b for b in engine.buckets if b <= limit], include_step=False
        )

    if service_time_fn is None:

        def service_time_fn(i, j):
            t0 = time.perf_counter()
            engine.act(obs[i:j])
            return time.perf_counter() - t0

    with tel.span("execute:serve", n_requests=n_requests, rate_hz=rate_hz):
        result = plan_open_loop(
            arrivals,
            service_time_fn,
            max_batch=max_batch,
            max_wait_s=max_wait_s,
            bucket_fn=engine.bucket_for,
        )

    if tel.sinks:
        # Per-request trace records through the run's sinks (the SQLite
        # warehouse when serve-bench got --results-db): every request's
        # enqueue->dispatch wait, its batch's bucket/padding and the shared
        # service span — the raw rows behind the percentile summary, SQL-
        # queryable next to training telemetry. Skipped sink-less: the
        # records would go nowhere.
        _emit_request_traces(tel, arrivals, result)

    p50, p95, p99 = (result.latency_ms(q) for q in (50, 95, 99))
    waste = result.padding_waste
    rows = [
        {
            "metric": f"serve_latency_ms_p{q}",
            "value": round(v, 3),
            "unit": "ms",
            "vs_baseline": round(slo_ms / v, 2) if v > 0 else 0.0,
        }
        for q, v in (("50", p50), ("95", p95), ("99", p99))
    ]
    rows.append(
        {
            "metric": "serve_throughput_rps",
            "value": round(result.throughput_rps, 1),
            "unit": "requests/sec",
            "vs_baseline": round(result.throughput_rps / rate_hz, 3),
        }
    )
    rows.append(
        {
            "metric": "serve_padding_waste",
            "value": round(waste, 4),
            "unit": "fraction",
            "vs_baseline": round(1.0 - waste, 4),
        }
    )
    rows.append(
        {
            "metric": "serve_bench",
            "value": round(p99, 3),
            "unit": "ms",
            "vs_baseline": round(slo_ms / p99, 2) if p99 > 0 else 0.0,
            "p50_ms": round(p50, 3),
            "p95_ms": round(p95, 3),
            "p99_ms": round(p99, 3),
            "throughput_rps": round(result.throughput_rps, 1),
            "padding_waste": round(waste, 4),
            "n_requests": n_requests,
            "offered_rate_rps": rate_hz,
            "max_batch": max_batch,
            "max_wait_ms": round(max_wait_s * 1e3, 3),
            "slo_ms": slo_ms,
            "n_batches": len(result.batch_sizes),
            "burst_config": burst_config,
            "implementation": engine.manifest.get("implementation"),
            "n_agents": engine.n_agents,
            "config_hash": engine.manifest.get("config_hash"),
            **phase_timings("serve"),
        }
    )
    if emit is not None:
        for row in rows:
            emit(row)
    return rows
