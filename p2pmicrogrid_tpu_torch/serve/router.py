"""Resilient fleet tier: consistent-hash routing over N gateway replicas.

The port of the JAX package's ``serve/router.py``: host code over the port's
gateway, copied with the same routing, retry, swap and bench semantics. Two
things differ on the card. ``LocalFleet`` runs its replicas on
``device="cuda"`` by default (and raises without a card unless
``device="cpu"``); each replica's engines capture one CUDA graph per
padding bucket, and a restart rebinds a gateway over the warm registry, so
it captures nothing. Every in-process replica replays on the same card and
the same stream, so a replica's result copy also waits for the work the
others queued before it.

One gateway process (serve/gateway.py) fronts one host's engines — a
single point of failure for the whole community. This module is the tier
above it, sized for the paper's deployment story (millions of households
deciding every 15-minute slot):

* **Consistent-hash routing.** Households map onto a ring of replica
  virtual nodes by the same deterministic sha256 household hash
  ``serve/registry.py`` uses for A/B splits. Losing a replica moves ONLY
  the households that hashed to it (they slide clockwise to the next
  healthy replica); every other household keeps its replica — and with it
  the warm per-household session/affinity state that replica holds.

* **Health: active probes + passive signals.** A prober sweeps each
  replica's ``/readyz`` on an interval; ``fail_threshold`` consecutive
  failures eject a replica from routing, ``ok_threshold`` consecutive
  successes re-admit it. Request-path transport errors and 5xx responses
  feed the same consecutive counters, so a crashed replica stops
  receiving traffic after a handful of failed requests — typically well
  before the next probe sweep notices.

* **Retry discipline** (``loadgen.RetryPolicy``): per-request deadline,
  capped jittered exponential backoff, server ``Retry-After`` honored,
  and a token-bucket ``RetryBudget`` so a fleet-wide brown-out degrades
  to ~budget-ratio extra load instead of a retry storm. A replica dying
  mid-request fails over: the failed replica is excluded for the rest of
  that request, the household re-routes to the next healthy replica on
  the ring, and a success there RE-PINS the household (it stays on its
  failover target — flapping back the moment the original recovers would
  tear warm session state twice).

* **Graceful degradation.** No healthy replica, or a retry the budget
  refuses: the router sheds locally — an immediate 503 with
  ``Retry-After`` — rather than queueing unboundedly in front of a fleet
  that cannot absorb the load.

* **Two-phase fleet swap.** ``swap_fleet(config_hash)`` pushes
  ``POST /admin/swap`` to every healthy replica, then verifies each
  replica's ``/readyz`` reports the new ``config_hash`` before declaring
  the flip (failed pushes/verifies roll the pushed replicas back). Each
  per-replica swap is atomic and in-flight requests finish on the bundle
  that admitted them, so a fleet-wide swap drops zero requests.

* **One fleet view.** ``fleet_stats()`` aggregates per-replica
  ``GET /stats`` into a single snapshot; router counters (ejections,
  failovers, retries, backoff time, sheds) stream through the attached
  ``Telemetry`` into the SQLite warehouse next to the per-bundle serve
  traces (``data/results.py::FLEET_VIEW_SQL`` joins them back together).

``LocalFleet`` runs N in-process replicas (each its own engines + queues +
asyncio loop thread) with kill/restart hooks for the deterministic fault
harness (serve/faults.py); ``serve_bench_fleet`` drives the open-loop
Poisson loadgen through the router over a live fleet while a fault plan
kills and restarts replicas mid-run — the ``serve-bench --fleet --chaos``
CLI.
"""

from __future__ import annotations

import asyncio
import bisect
import hashlib
import http.client
import json
import random
import threading
import time
import weakref
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from p2pmicrogrid_tpu_torch.device import resolve_device
from p2pmicrogrid_tpu_torch.serve.faults import FaultInjector, FaultPlan, FaultSchedule
from p2pmicrogrid_tpu_torch.serve.loadgen import (
    RetryBudget,
    RetryPolicy,
    _http_post_json,
    _http_request_json,
    _retry_after_s,
    make_arrivals,
    synthetic_obs,
)
from p2pmicrogrid_tpu_torch.serve.wire import (
    FrameTooLarge,
    MuxPool,
    SyncMuxProbe,
    WireProtocolError,
)
from p2pmicrogrid_tpu_torch.telemetry.tracing import (
    TraceContext,
    record_span,
    root_context,
)

# WireProtocolError covers a peer answering malformed frames (version
# skew, corruption): act() must score it as one failed request, never let
# it escape and crash the caller's gather.
_TRANSPORT_ERRORS = (
    ConnectionError, OSError, EOFError, ValueError,
    asyncio.TimeoutError, asyncio.IncompleteReadError, WireProtocolError,
)

# Client errors that re-routing or retrying cannot fix: the REQUEST (or its
# credential) is wrong, not the replica. 401/403 matter here: a rejected
# bearer must be terminal — it never consumes the retry budget, so garbage
# credentials cannot starve the budget honest retries depend on.
_TERMINAL_CLIENT_STATUSES = (400, 401, 403, 404, 405, 413)


@dataclass(frozen=True)
class Replica:
    """One addressable gateway replica. ``mux_port`` is the persistent
    multiplexed listener (serve/wire.py) when the replica exposes one —
    the router prefers it; ``port`` stays the HTTP/1.1 compatibility
    endpoint (probes, swaps, stats)."""

    replica_id: str
    host: str
    port: int
    mux_port: Optional[int] = None


class NoHealthyReplicas(RuntimeError):
    """Every replica is ejected — the router must shed, not queue."""


class FleetSwapError(RuntimeError):
    """A two-phase fleet swap failed (pushed replicas were rolled back)."""


# -- consistent-hash ring ------------------------------------------------------


def _ring_point(key: str) -> int:
    """Deterministic 64-bit ring position (stable across processes —
    hashlib, not the salted builtin ``hash``)."""
    return int.from_bytes(hashlib.sha256(key.encode()).digest()[:8], "big")


class ConsistentHashRing:
    """Classic consistent hashing with virtual nodes.

    Each replica owns ``vnodes`` points; a key routes to the first point
    clockwise. ``vnodes`` trades balance for lookup-table size: at 64
    vnodes a 3-replica ring splits keys within a few percent of evenly.
    ``lookup(key, accept)`` walks clockwise past points whose replica the
    predicate rejects — the consistent-hashing failover rule that moves
    ONLY the rejected replica's keys, to their next-clockwise survivor.
    """

    def __init__(self, vnodes: int = 64):
        if vnodes < 1:
            raise ValueError(f"vnodes must be >= 1, got {vnodes}")
        self.vnodes = vnodes
        self._points: List[int] = []       # sorted vnode positions
        self._owners: List[str] = []       # replica id per point
        self._replicas: set = set()

    def add(self, replica_id: str) -> None:
        if replica_id in self._replicas:
            raise ValueError(f"replica {replica_id!r} already on the ring")
        self._replicas.add(replica_id)
        for v in range(self.vnodes):
            point = _ring_point(f"{replica_id}#{v}")
            i = bisect.bisect_left(self._points, point)
            self._points.insert(i, point)
            self._owners.insert(i, replica_id)

    def remove(self, replica_id: str) -> None:
        if replica_id not in self._replicas:
            raise KeyError(f"replica {replica_id!r} not on the ring")
        self._replicas.discard(replica_id)
        keep = [
            (p, o)
            for p, o in zip(self._points, self._owners)
            if o != replica_id
        ]
        self._points = [p for p, _ in keep]
        self._owners = [o for _, o in keep]

    def __len__(self) -> int:
        return len(self._replicas)

    def lookup(
        self, key: str, accept: Optional[Callable[[str], bool]] = None
    ) -> Optional[str]:
        """First replica clockwise from ``key`` whose id passes
        ``accept`` (default: any). None on an empty/filtered-out ring."""
        if not self._points:
            return None
        start = bisect.bisect_right(self._points, _ring_point(key))
        n = len(self._points)
        seen: set = set()
        for step in range(n):
            owner = self._owners[(start + step) % n]
            if owner in seen:
                continue
            if accept is None or accept(owner):
                return owner
            seen.add(owner)
        return None


# -- router --------------------------------------------------------------------


@dataclass
class _ReplicaState:
    replica: Replica
    healthy: bool = True
    consecutive_fail: int = 0
    consecutive_ok: int = 0
    ejections: int = 0
    last_error: str = ""


@dataclass
class RouterResult:
    """One routed request's outcome."""

    status: int                      # final HTTP status (-1 transport, 503 shed)
    actions: Optional[list] = None
    config_hash: Optional[str] = None
    replica_id: Optional[str] = None
    retries: int = 0
    failovers: int = 0
    shed: bool = False               # the ROUTER refused (budget/no replicas)
    retry_after_s: Optional[float] = None
    error: Optional[str] = None
    gave_up: bool = False

    @property
    def ok(self) -> bool:
        return self.status == 200


class FleetRouter:
    """Client-side fleet front: consistent-hash routing + health + retry.

    Thread-safe: routing state is lock-held, ``act`` runs on an asyncio
    loop while the prober thread updates health concurrently.
    """

    def __init__(
        self,
        replicas: Sequence[Replica],
        retry: Optional[RetryPolicy] = None,
        budget: Optional[RetryBudget] = None,
        vnodes: int = 64,
        fail_threshold: int = 3,
        ok_threshold: int = 2,
        probe_timeout_s: float = 2.0,
        request_timeout_s: float = 30.0,
        shed_retry_after_s: float = 1.0,
        telemetry=None,
        jitter_seed: int = 0,
        ssl_context=None,
        token: Optional[str] = None,
        transport: str = "auto",
        mux_pool_size: int = 2,
        mux_max_frame_bytes: Optional[int] = None,
        probe_transport: str = "auto",
    ):
        if not replicas:
            raise ValueError("pass at least one replica")
        if transport not in ("auto", "http", "mux"):
            raise ValueError(
                f"transport must be 'auto', 'http' or 'mux', got {transport!r}"
            )
        if probe_transport not in ("auto", "http", "mux"):
            raise ValueError(
                "probe_transport must be 'auto', 'http' or 'mux', got "
                f"{probe_transport!r}"
            )
        self.retry = retry or RetryPolicy()
        self.budget = budget or RetryBudget()
        self.fail_threshold = fail_threshold
        self.ok_threshold = ok_threshold
        self.probe_timeout_s = probe_timeout_s
        self.request_timeout_s = request_timeout_s
        self.shed_retry_after_s = shed_retry_after_s
        self.telemetry = telemetry
        # Trust termination toward the replicas: a client SSLContext when
        # the fleet serves TLS, and the router's own bearer (normally the
        # operator wildcard — it must probe /stats and push /admin/swap).
        self.ssl_context = ssl_context
        self.token = token
        # 'auto' uses a replica's mux listener when it advertises one and
        # falls back to per-request HTTP; 'http'/'mux' force a wire.
        self.transport = transport
        self.mux_pool_size = mux_pool_size
        # MUST match the replicas' admission.max_body_bytes when that is
        # configured below the 1 MiB wire default: the client-side cap is
        # what turns an over-cap request into a terminal 413 here — with
        # a larger client cap the server drains + answers an id-less 413
        # the pool cannot attribute, and the request dies as a timeout
        # that (wrongly) penalizes replica health.
        self.mux_max_frame_bytes = mux_max_frame_bytes
        # Mux pools are event-loop-bound (asyncio futures); tests drive
        # act() through many short-lived loops, so pools key on the loop
        # weakly — a dead loop's pools (and their sockets) fall away with
        # it instead of poisoning the next loop's requests.
        self._mux_pools: "weakref.WeakKeyDictionary" = (
            weakref.WeakKeyDictionary()
        )
        # Probe sweeps reuse ONE persistent framed connection per replica
        # (wire.SyncMuxProbe) instead of a fresh (TLS) handshake per
        # replica per sweep — the per-sweep cost that dominated at fleet
        # scale. 'auto' probes over mux when the replica advertises a
        # listener, HTTP otherwise; half-open connections fail the probe
        # via timeout/reset exactly like a dead HTTP endpoint would.
        self.probe_transport = probe_transport
        self._probe_conns: Dict[str, SyncMuxProbe] = {}
        self._lock = threading.RLock()
        self._ring = ConsistentHashRing(vnodes=vnodes)
        self._state: Dict[str, _ReplicaState] = {}
        self._order: List[str] = []
        missing = [r.replica_id for r in replicas if r.mux_port is None]
        if transport == "mux" and missing:
            # Fail at construction, not as per-request "transport errors"
            # that would eject every (healthy) replica and read as a
            # fleet-wide outage instead of a configuration mistake.
            raise ValueError(
                "transport='mux' but replica(s) advertise no "
                f"mux_port: {', '.join(missing)}"
            )
        if probe_transport == "mux" and missing:
            # Same construction-time refusal: a forced mux probe against a
            # mux-less replica would read as that replica being down
            # forever.
            raise ValueError(
                "probe_transport='mux' but replica(s) advertise no "
                f"mux_port: {', '.join(missing)}"
            )
        for r in replicas:
            self._state[r.replica_id] = _ReplicaState(replica=r)
            self._order.append(r.replica_id)
            self._ring.add(r.replica_id)
        self._pins: Dict[str, str] = {}   # household -> failover target
        # config_hash -> bundle_dir learned through register_fleet: what
        # lets the prober RE-register a runtime candidate on a relaunched
        # replica before re-pushing a missed fleet swap (_push_swap).
        self.known_bundles: Dict[str, str] = {}
        self.register_timeout_s = 180.0
        # In-flight per-replica re-register workers (_push_swap): the
        # engine warmup a register costs must never block the prober.
        self._realigners: Dict[str, threading.Thread] = {}
        self._anon_rr = 0
        self._rng = random.Random(jitter_seed)
        self._prober: Optional[threading.Thread] = None
        self._prober_stop = threading.Event()
        self.fleet_config_hash: Optional[str] = None
        self.counters: Dict[str, float] = {
            "requests": 0, "retries": 0, "failovers": 0, "repins": 0,
            "ejections": 0, "readmissions": 0, "shed": 0,
            "budget_denied": 0, "corrupt_detected": 0, "swaps": 0,
            "swap_aligns": 0, "probes": 0, "backoff_ms": 0.0,
            "reconnects": 0, "auth_denied": 0, "registers": 0,
        }

    # -- counters / telemetry ------------------------------------------------

    def _bump(self, name: str, inc: float = 1) -> None:
        # Telemetry.counter is an unlocked read-modify-write; the router's
        # lock serializes the prober thread against the act() event loop so
        # the warehouse counters can't lose increments.
        with self._lock:
            self.counters[name] += inc
            if self.telemetry is not None:
                self.telemetry.counter(f"router.{name}", inc)

    # -- wire ----------------------------------------------------------------

    def _http_conn(self, rep: Replica, timeout_s: float):
        """A synchronous probe/stats connection honoring the fleet TLS."""
        if self.ssl_context is not None:
            return http.client.HTTPSConnection(
                rep.host, rep.port, timeout=timeout_s,
                context=self.ssl_context,
            )
        return http.client.HTTPConnection(rep.host, rep.port, timeout=timeout_s)

    def _auth_headers(self) -> dict:
        headers = {"Content-Type": "application/json"}
        if self.token is not None:
            headers["Authorization"] = f"Bearer {self.token}"
        return headers

    def _pool_for(self, rep: Replica) -> Optional[MuxPool]:
        """The replica's persistent mux pool on the RUNNING loop, or None
        when this replica (or the configured transport) is HTTP-only.
        (transport='mux' against mux-less replicas is rejected at
        construction, so the fall-through here is always intentional.)"""
        if self.transport == "http" or rep.mux_port is None:
            return None
        loop = asyncio.get_running_loop()
        pools = self._mux_pools.get(loop)
        if pools is None:
            pools = {}
            self._mux_pools[loop] = pools
        pool = pools.get(rep.replica_id)
        if pool is None:
            kw = {}
            if self.mux_max_frame_bytes is not None:
                kw["max_frame_bytes"] = self.mux_max_frame_bytes
            pool = MuxPool(
                rep.host, rep.mux_port, size=self.mux_pool_size,
                ssl=self.ssl_context,
                on_reconnect=lambda: self._bump("reconnects"),
                **kw,
            )
            pools[rep.replica_id] = pool
        return pool

    async def _post_act(
        self, rep: Replica, payload: dict, timeout_s: float,
        trace: Optional[str] = None,
    ):
        """(status, doc, headers) over the replica's preferred wire. Pool
        replay is OFF here: the router's own retry/failover loop is the
        retry authority — the pool reconnects, the router re-sends.
        ``trace`` is the encoded per-attempt trace context (mux frame
        field / HTTP header)."""
        pool = self._pool_for(rep)
        if pool is not None:
            return await pool.request(
                "/v1/act", payload, timeout_s, token=self.token,
                replay=False, trace=trace,
            )
        return await _http_post_json(
            rep.host, rep.port, "/v1/act", payload, timeout_s,
            ssl=self.ssl_context, token=self.token, trace=trace,
        )

    async def close_pools(self) -> None:
        """Close the RUNNING loop's mux pools (bench teardown). Pools on
        already-dead loops were dropped with their loops."""
        pools = self._mux_pools.get(asyncio.get_running_loop())
        if pools:
            for pool in list(pools.values()):
                await pool.close()
            pools.clear()

    # -- membership / health -------------------------------------------------

    @property
    def replica_ids(self) -> List[str]:
        with self._lock:
            return list(self._order)

    def replica(self, replica_id: str) -> Replica:
        with self._lock:
            return self._state[replica_id].replica

    def healthy_ids(self) -> List[str]:
        with self._lock:
            return [r for r in self._order if self._state[r].healthy]

    def is_healthy(self, replica_id: str) -> bool:
        with self._lock:
            return self._state[replica_id].healthy

    def mark_result(
        self, replica_id: str, ok: bool, error: str = ""
    ) -> None:
        """Feed one health observation (probe or request outcome) into a
        replica's consecutive counters; flips eject/re-admit at the
        thresholds."""
        with self._lock:
            st = self._state.get(replica_id)
            if st is None:
                return
            if ok:
                st.consecutive_ok += 1
                st.consecutive_fail = 0
                if (
                    not st.healthy
                    and st.consecutive_ok >= self.ok_threshold
                ):
                    st.healthy = True
                    readmitted = True
                else:
                    readmitted = False
                ejected = False
            else:
                st.consecutive_fail += 1
                st.consecutive_ok = 0
                st.last_error = error
                if (
                    st.healthy
                    and st.consecutive_fail >= self.fail_threshold
                ):
                    st.healthy = False
                    st.ejections += 1
                    ejected = True
                else:
                    ejected = False
                readmitted = False
        if ejected:
            self._bump("ejections")
        if readmitted:
            self._bump("readmissions")

    def probe_once(self) -> Dict[str, bool]:
        """One synchronous ``/readyz`` sweep over every replica; returns
        {replica_id: probe ok}. Drives eject/re-admit via mark_result —
        callable directly (tests, deterministic sweeps) or from the
        background prober."""
        results: Dict[str, bool] = {}
        for rid in self.replica_ids:
            rep = self.replica(rid)
            ok, error = self._probe(rep)
            results[rid] = ok
            self._bump("probes")
            self.mark_result(rid, ok, error=error)
        return results

    def _probe_conn_for(self, rep: Replica) -> SyncMuxProbe:
        """The replica's persistent probe connection (created lazily; it
        survives across sweeps — that persistence IS the point)."""
        with self._lock:
            conn = self._probe_conns.get(rep.replica_id)
            if conn is None:
                conn = SyncMuxProbe(
                    rep.host, rep.mux_port,
                    ssl_context=self.ssl_context,
                    timeout_s=self.probe_timeout_s,
                )
                self._probe_conns[rep.replica_id] = conn
        return conn

    def _probe_readyz(self, rep: Replica) -> Tuple[int, Optional[dict]]:
        """One ``GET /readyz`` over the probe transport: the replica's
        persistent mux connection when it advertises one (no fresh TLS
        handshake per sweep), a fresh HTTP connection otherwise. Raises
        OSError-family on transport failure — a half-open mux connection
        (SIGKILLed peer, stalled stream) surfaces as a timeout/reset here
        exactly like a dead HTTP endpoint."""
        use_mux = self.probe_transport == "mux" or (
            self.probe_transport == "auto" and rep.mux_port is not None
        )
        if use_mux:
            return self._probe_conn_for(rep).request("/readyz")
        conn = self._http_conn(rep, self.probe_timeout_s)
        try:
            conn.request("GET", "/readyz")
            resp = conn.getresponse()
            raw = resp.read()
            try:
                doc = json.loads(raw) if raw else {}
            except (UnicodeDecodeError, json.JSONDecodeError):
                doc = {}
            return resp.status, doc if isinstance(doc, dict) else None
        finally:
            conn.close()

    def _probe(self, rep: Replica) -> Tuple[bool, str]:
        try:
            status, doc = self._probe_readyz(rep)
            if status != 200:
                return False, f"/readyz answered {status}"
            with self._lock:
                fleet_hash = self.fleet_config_hash
            served = (doc or {}).get("config_hash")
            if fleet_hash and served and served != fleet_hash:
                # A replica that missed a fleet swap (killed/restarted
                # around it) must NOT be re-admitted on its stale default —
                # it would serve the old config to its households forever,
                # a silent half-swapped fleet. Push the swap so it
                # converges, and stay unready until a later probe verifies.
                self._push_swap(rep, fleet_hash)
                self._bump("swap_aligns")
                return False, (
                    f"/readyz config_hash {served} != fleet "
                    f"{fleet_hash} (swap re-pushed)"
                )
            return True, ""
        except (
            OSError, http.client.HTTPException, WireProtocolError,
        ) as err:
            return False, f"{type(err).__name__}: {err}"

    def _push_swap(self, rep: Replica, config_hash: str) -> None:
        """Best-effort synchronous ``/admin/swap`` push (probe thread).

        A 404 means the replica does not KNOW the hash — the process-mode
        failure the autopilot hits when a replica relaunches after a
        promotion: the fresh child only loaded its launch-time bundles,
        and the promoted candidate was registered at runtime. When the
        router learned the candidate's bundle dir (``register_fleet``
        records it in ``known_bundles``), it re-registers the bundle on
        the replica and re-pushes the swap — otherwise a crashed replica
        would resurrect the retired incumbent for its households forever."""
        status = self._admin_post_sync(
            rep, "/admin/swap", {"config_hash": config_hash}
        )
        if status == 404:
            with self._lock:
                bundle_dir = self.known_bundles.get(config_hash)
                # The register is an engine load + graph captures on the
                # replica (seconds) — it must NOT run on the
                # probe thread, or one realigning replica freezes health
                # sweeps (and therefore ejection/failover) for the whole
                # fleet. One realign worker per replica at a time; the
                # replica stays unready until a later sweep verifies.
                busy = self._realigners.get(rep.replica_id)
                if bundle_dir is None or (busy is not None and
                                          busy.is_alive()):
                    return

                def realign() -> None:
                    reg = self._admin_post_sync(
                        rep, "/admin/register",
                        {"bundle_dir": bundle_dir},
                        timeout_s=self.register_timeout_s,
                    )
                    if reg == 200:
                        self._admin_post_sync(
                            rep, "/admin/swap",
                            {"config_hash": config_hash},
                        )

                worker = threading.Thread(target=realign, daemon=True)
                self._realigners[rep.replica_id] = worker
            worker.start()

    def _admin_post_sync(
        self, rep: Replica, path: str, payload: dict,
        timeout_s: Optional[float] = None,
    ) -> Optional[int]:
        """One synchronous admin POST (probe thread); returns the HTTP
        status or None on transport failure — best-effort, the caller's
        next probe sweep retries."""
        body = json.dumps(payload)
        conn = self._http_conn(rep, timeout_s or self.probe_timeout_s)
        try:
            conn.request(
                "POST", path, body=body, headers=self._auth_headers(),
            )
            resp = conn.getresponse()
            resp.read()
            return resp.status
        except (OSError, http.client.HTTPException):
            return None  # the replica stays unready; a later probe retries
        finally:
            conn.close()

    def start_probing(self, interval_s: float = 0.5) -> None:
        """Background prober: ``probe_once`` every ``interval_s``."""
        if self._prober is not None:
            raise RuntimeError("prober already running")
        self._prober_stop.clear()

        def run() -> None:
            while not self._prober_stop.wait(interval_s):
                self.probe_once()

        self._prober = threading.Thread(target=run, daemon=True)
        self._prober.start()

    def stop_probing(self) -> None:
        self._prober_stop.set()
        if self._prober is not None:
            self._prober.join(timeout=10.0)
            self._prober = None
        self.close_probe_conns()

    def close_probe_conns(self) -> None:
        """Close the persistent per-replica probe connections (teardown;
        the next probe_once reconnects on demand)."""
        with self._lock:
            conns = list(self._probe_conns.values())
            self._probe_conns.clear()
        for conn in conns:
            conn.close()

    # -- routing -------------------------------------------------------------

    def route(
        self, household: Optional[str], exclude: frozenset = frozenset()
    ) -> str:
        """The replica id serving this household right now.

        Ring lookup among healthy replicas, honoring a failover pin when
        its target is still usable. ``exclude`` is per-request state: the
        replicas that already failed THIS request — skipped unless that
        would leave nowhere to go. Anonymous requests round-robin over
        healthy replicas (hashing the constant empty key would pile all
        anonymous traffic onto one replica)."""
        with self._lock:
            healthy = [r for r in self._order if self._state[r].healthy]
            if not healthy:
                raise NoHealthyReplicas(
                    f"all {len(self._order)} replicas unhealthy"
                )
            candidates = [r for r in healthy if r not in exclude] or healthy
            if not household:
                rid = candidates[self._anon_rr % len(candidates)]
                self._anon_rr += 1
                return rid
            pinned = self._pins.get(household)
            if pinned is not None and pinned in candidates:
                return pinned
            allowed = set(candidates)
            rid = self._ring.lookup(household, accept=allowed.__contains__)
            if rid is None:  # unreachable: candidates is non-empty
                raise NoHealthyReplicas("ring lookup found no candidate")
            return rid

    def _record_route(self, household: Optional[str], rid: str) -> None:
        """After a SUCCESS on ``rid``: pin the household iff it is not on
        its home (pure-ring) replica. Pins are recorded only for failover
        placements, so the pin map grows with failovers, not with
        households; a household whose pin target dies re-pins on its next
        request, and one that lands home again drops its pin."""
        if not household:
            return
        repinned = False
        with self._lock:
            home = self._ring.lookup(household)
            if rid == home:
                self._pins.pop(household, None)
            elif self._pins.get(household) != rid:
                self._pins[household] = rid
                repinned = True
        if repinned:
            self._bump("repins")

    @property
    def pinned_count(self) -> int:
        with self._lock:
            return len(self._pins)

    def pinned_households(self, limit: int = 10_000) -> Dict[str, str]:
        """A snapshot of failover pins, CAPPED at ``limit`` entries:
        pins record only failover placements so the map
        stays small in steady state, but after a chaos storm at a
        million-household population an uncapped copy would materialize
        per-household state on every observability poll. ``pinned_count``
        is the O(1) total; pass a larger limit explicitly to widen the
        sample."""
        with self._lock:
            if len(self._pins) <= limit:
                return dict(self._pins)
            out: Dict[str, str] = {}
            for h, rid in self._pins.items():
                if len(out) >= limit:
                    break
                out[h] = rid
            return out

    # -- request path --------------------------------------------------------

    async def act(
        self,
        household: Optional[str],
        obs_row,
        deadline_s: Optional[float] = None,
        trace: Optional[TraceContext] = None,
    ) -> RouterResult:
        """Route one act request with retry/failover; never raises for
        server-side failure — the outcome (including router-side sheds)
        comes back as a ``RouterResult``.

        With a ``trace`` (telemetry/tracing.py ``TraceContext``), the
        whole retry/failover anatomy becomes spans in the attached
        telemetry's warehouse: one ``router.act`` root per request, a
        ``router.attempt`` child per try (attrs: replica_id, status,
        whether it was a failover hop) and a ``router.backoff`` child per
        sleep — and each attempt's child context rides the wire, so the
        server-side spans hang off the exact attempt that caused them."""
        policy = self.retry
        t0 = time.monotonic()
        t0_epoch = time.time()
        deadline = t0 + (
            deadline_s if deadline_s is not None else policy.deadline_s
        )

        def finish(result: RouterResult) -> RouterResult:
            if trace is not None and self.telemetry is not None:
                elapsed = time.monotonic() - t0
                record_span(
                    self.telemetry, trace, "router.act", t0_epoch, elapsed,
                    status=result.status, retries=result.retries,
                    failovers=result.failovers, replica_id=result.replica_id,
                    household=household,
                )
                self.telemetry.histogram(
                    "router.latency_ms", elapsed * 1e3,
                    trace_id=trace.trace_id,
                )
            return result
        # host-sync: caller-supplied host observation row, not device data.
        payload = {"obs": np.asarray(obs_row, dtype=np.float32).tolist()}
        if household:
            payload["household"] = household
        self._bump("requests")
        self.budget.on_attempt()
        exclude: set = set()
        prev_rid: Optional[str] = None
        tries = 0
        failovers = 0
        status, doc, headers = -1, None, {}
        rid = None
        while True:
            try:
                rid = self.route(household, exclude=frozenset(exclude))
            except NoHealthyReplicas as err:
                self._bump("shed")
                return finish(RouterResult(
                    status=503, shed=True,
                    retry_after_s=self.shed_retry_after_s,
                    error=str(err), retries=tries, failovers=failovers,
                ))
            was_failover = (
                prev_rid is not None and rid != prev_rid
                and prev_rid in exclude
            )
            if was_failover:
                # A failover is leaving a FAULTED replica — a 429 retry
                # that round-robins (anonymous traffic) or re-routes is
                # load balancing, not failover, and must not pollute the
                # failover_count SLO.
                failovers += 1
                self._bump("failovers")
            rep = self.replica(rid)
            timeout = max(0.05, min(
                self.request_timeout_s, deadline - time.monotonic()
            ))
            # Per-attempt child context: deterministic from the root +
            # attempt index, encoded onto the wire so the replica's spans
            # hang off THIS attempt (not the request in the abstract).
            attempt_ctx = (
                trace.child(f"attempt{tries}") if trace is not None else None
            )
            t_att = time.monotonic()
            t_att_epoch = time.time()
            try:
                status, doc, headers = await self._post_act(
                    rep, payload, timeout,
                    trace=attempt_ctx.encode() if attempt_ctx else None,
                )
            except FrameTooLarge as err:
                # The REQUEST is over the wire cap — the mux mirror of an
                # HTTP 413: terminal client error, no health penalty, no
                # failover (the same payload would "fail" every replica
                # in turn and read as a fleet outage).
                return finish(RouterResult(
                    status=413, replica_id=rid, error=str(err),
                    retries=tries, failovers=failovers,
                ))
            except _TRANSPORT_ERRORS as err:
                status, doc, headers = -1, None, {}
                transport_error = f"{type(err).__name__}: {err}"
            else:
                transport_error = ""
            tries += 1
            corrupt = status == 200 and doc is None
            if corrupt:
                self._bump("corrupt_detected")
                status = -1
            if attempt_ctx is not None and self.telemetry is not None:
                record_span(
                    self.telemetry, attempt_ctx, "router.attempt",
                    t_att_epoch, time.monotonic() - t_att,
                    replica_id=rid, try_index=tries - 1, status=status,
                    failover=was_failover,
                    error=transport_error or None,
                )
            if status == 200:
                self.mark_result(rid, True)
                self._record_route(household, rid)
                return finish(RouterResult(
                    status=200,
                    actions=doc.get("actions"),
                    config_hash=doc.get("config_hash"),
                    replica_id=rid,
                    retries=tries - 1,
                    failovers=failovers,
                ))
            if status in _TERMINAL_CLIENT_STATUSES:
                # The REQUEST (or its credential) is bad, not the replica
                # — retrying the same payload elsewhere cannot help, and
                # auth rejections must never charge the retry budget.
                if status in (401, 403):
                    self._bump("auth_denied")
                return finish(RouterResult(
                    status=status, replica_id=rid,
                    error=(doc or {}).get("error"),
                    retries=tries - 1, failovers=failovers,
                ))
            if status == -1 or status >= 500 or corrupt:
                # Replica fault: feed health, fail over away from it for
                # the remainder of this request.
                self.mark_result(
                    rid, False,
                    error=transport_error or f"status {status}",
                )
                exclude.add(rid)
            # 429 = saturated-but-alive: no health penalty, no exclusion —
            # backing off and re-trying (possibly the same replica) is the
            # correct response to admission-control shed.
            prev_rid = rid
            now = time.monotonic()
            if tries >= policy.max_attempts or now >= deadline:
                break
            if not self.budget.try_spend():
                # Budget-governed degradation: a brown-out must not turn
                # into a retry storm. Shed at the router with Retry-After.
                self._bump("budget_denied")
                self._bump("shed")
                return finish(RouterResult(
                    status=503, shed=True,
                    retry_after_s=self.shed_retry_after_s,
                    error="retry budget exhausted",
                    replica_id=rid, retries=tries - 1,
                    failovers=failovers, gave_up=True,
                ))
            with self._lock:
                backoff = policy.backoff_s(
                    tries - 1, self._rng, _retry_after_s(headers)
                )
            if now + backoff >= deadline:
                break
            self._bump("retries")
            self._bump("backoff_ms", backoff * 1e3)
            await asyncio.sleep(backoff)
            if trace is not None and self.telemetry is not None:
                record_span(
                    self.telemetry, trace.child(f"backoff{tries - 1}"),
                    "router.backoff", time.time() - backoff, backoff,
                    try_index=tries - 1,
                )
        return finish(RouterResult(
            status=status, replica_id=rid,
            error=(doc or {}).get("error") if isinstance(doc, dict) else None,
            retries=tries - 1, failovers=failovers,
            retry_after_s=_retry_after_s(headers),
            gave_up=tries > 1,
        ))

    # -- fleet orchestration -------------------------------------------------

    async def _get_json(
        self, rep: Replica, path: str, timeout_s: float
    ) -> Tuple[int, Optional[dict]]:
        """Async GET over a fresh connection (swap verify) — delegates
        the wire framing to loadgen's one shared HTTP client."""
        status, doc, _ = await _http_request_json(
            rep.host, rep.port, "GET", path, None, timeout_s,
            ssl=self.ssl_context, token=self.token,
        )
        return status, doc

    async def swap_fleet(
        self,
        config_hash: str,
        timeout_s: float = 10.0,
        poll_interval_s: float = 0.05,
    ) -> dict:
        """Two-phase fleet-wide hot-swap: push ``/admin/swap`` to every
        healthy replica, verify each ``/readyz`` reports the new
        ``config_hash``, then flip (clear failover pins, record the fleet
        hash). Any push/verify failure rolls the pushed replicas back to
        their previous defaults and raises ``FleetSwapError`` — the fleet
        is never left half-swapped. Zero requests drop: each per-replica
        swap is atomic and in-flight requests finish on the bundle that
        admitted them."""
        targets = [
            (rid, self.replica(rid)) for rid in self.healthy_ids()
        ]
        if not targets:
            raise FleetSwapError("no healthy replicas to swap")
        previous: Dict[str, Optional[str]] = {}
        for rid, rep in targets:
            try:
                _, doc = await self._get_json(rep, "/readyz", timeout_s)
            except _TRANSPORT_ERRORS as err:
                raise FleetSwapError(
                    f"{rid}: unreachable before swap ({err})"
                ) from None
            previous[rid] = (doc or {}).get("config_hash")
        pushed: List[str] = []
        try:
            for rid, rep in targets:
                try:
                    status, doc, _ = await _http_post_json(
                        rep.host, rep.port, "/admin/swap",
                        {"config_hash": config_hash}, timeout_s,
                        ssl=self.ssl_context, token=self.token,
                    )
                except _TRANSPORT_ERRORS as err:
                    raise FleetSwapError(
                        f"{rid}: swap push failed ({err})"
                    ) from None
                if status != 200:
                    raise FleetSwapError(
                        f"{rid}: swap push answered {status}: "
                        f"{(doc or {}).get('error')}"
                    )
                pushed.append(rid)
            for rid, rep in targets:
                end = time.monotonic() + timeout_s
                while True:
                    try:
                        status, doc = await self._get_json(
                            rep, "/readyz", timeout_s
                        )
                    except _TRANSPORT_ERRORS:
                        status, doc = -1, None
                    if (
                        status == 200
                        and (doc or {}).get("config_hash") == config_hash
                    ):
                        break
                    if time.monotonic() >= end:
                        raise FleetSwapError(
                            f"{rid}: /readyz never confirmed "
                            f"{config_hash} (last: {doc})"
                        )
                    await asyncio.sleep(poll_interval_s)
        except FleetSwapError:
            # Roll back best-effort: a half-swapped fleet double-serves
            # configs indefinitely; a rolled-back fleet is merely stale.
            for rid in pushed:
                prev = previous.get(rid)
                if prev and prev != config_hash:
                    rep = self.replica(rid)
                    try:
                        await _http_post_json(
                            rep.host, rep.port, "/admin/swap",
                            {"config_hash": prev}, timeout_s,
                            ssl=self.ssl_context, token=self.token,
                        )
                    except _TRANSPORT_ERRORS:
                        pass
            raise
        with self._lock:
            # Mirror the per-gateway swap semantics fleet-wide: every
            # household re-routes fresh against the new default.
            self._pins.clear()
            self.fleet_config_hash = config_hash
        self._bump("swaps")
        if self.telemetry is not None:
            self.telemetry.event(
                "fleet_swap", config_hash=config_hash,
                replicas=[rid for rid, _ in targets],
            )
        return {
            "config_hash": config_hash,
            "replicas": [rid for rid, _ in targets],
            "previous": previous,
        }

    # -- fleet-wide candidate lifecycle ---------------------------------------

    async def _admin_post(
        self, rep: Replica, path: str, payload: dict, timeout_s: float
    ):
        return await _http_post_json(
            rep.host, rep.port, path, payload, timeout_s,
            ssl=self.ssl_context, token=self.token,
        )

    async def register_fleet(
        self, bundle_dir: str, timeout_s: float = 180.0
    ) -> str:
        """Push ``/admin/register {bundle_dir}`` to every healthy replica
        (the bundle dir must be reachable from the replica processes — a
        shared filesystem, which one-host fleets trivially have). ALL
        replicas must load it; any failure unregisters the bundle from the
        replicas that did (best-effort) and raises ``FleetSwapError`` — a
        candidate half-known to the fleet would turn the later split/swap
        pushes into partial failures. Returns the registered config_hash.
        The generous timeout covers an engine load + warmup per
        replica. Idempotent: replicas already serving the hash answer
        ``already_registered``."""
        targets = [(rid, self.replica(rid)) for rid in self.healthy_ids()]
        if not targets:
            raise FleetSwapError("no healthy replicas to register on")

        # Concurrent pushes: a register costs an engine load + warmup
        # PER REPLICA (the 180 s budget exists for it) — serial awaits
        # would multiply every canary phase's wall-clock by fleet size.
        async def push_one(rid: str, rep: Replica):
            try:
                status, doc, _ = await self._admin_post(
                    rep, "/admin/register",
                    {"bundle_dir": bundle_dir}, timeout_s,
                )
            except _TRANSPORT_ERRORS as err:
                return rid, None, f"register push failed ({err})"
            if status != 200:
                return rid, None, (
                    f"register answered {status}: "
                    f"{(doc or {}).get('error')}"
                )
            return rid, (doc or {}).get("config_hash"), None

        results = await asyncio.gather(
            *(push_one(rid, rep) for rid, rep in targets)
        )
        config_hash = next((h for _, h, _ in results if h), None)
        failures = [(rid, err) for rid, _, err in results if err]
        if failures:
            # All-or-nothing: roll the successes back (unregister is
            # idempotent, so pushing to every target is safe).
            if config_hash:
                await self.unregister_fleet(config_hash, timeout_s)
            raise FleetSwapError(
                "; ".join(f"{rid}: {err}" for rid, err in failures)
            )
        self._bump("registers")
        with self._lock:
            if config_hash:
                self.known_bundles[config_hash] = bundle_dir
        if self.telemetry is not None:
            self.telemetry.event(
                "fleet_register", config_hash=config_hash,
                bundle_dir=bundle_dir, replicas=[rid for rid, _ in targets],
            )
        return config_hash

    async def unregister_fleet(
        self, config_hash: str, timeout_s: float = 30.0
    ) -> dict:
        """Best-effort ``/admin/unregister`` on EVERY replica (healthy or
        not — an ejected replica that re-admits must not keep serving an
        orphaned candidate). Per-replica outcomes are returned, never
        raised: unregistration is cleanup, and cleanup retries are the
        caller's cadence loop."""
        return await self._admin_broadcast(
            "/admin/unregister", {"config_hash": config_hash}, timeout_s
        )

    async def _admin_broadcast(
        self, path: str, payload: dict, timeout_s: float
    ) -> Dict[str, str]:
        """One admin POST to EVERY replica concurrently, best-effort;
        per-replica outcomes, never raises (cleanup semantics)."""
        async def one(rid: str) -> tuple:
            rep = self.replica(rid)
            try:
                status, doc, _ = await self._admin_post(
                    rep, path, payload, timeout_s
                )
                return rid, (
                    "ok" if status == 200
                    else f"{status}: {(doc or {}).get('error')}"
                )
            except _TRANSPORT_ERRORS as err:
                return rid, f"unreachable: {err}"

        return dict(await asyncio.gather(
            *(one(rid) for rid in self.replica_ids)
        ))

    async def split_fleet(
        self, config_hash: str, percent: float, timeout_s: float = 10.0
    ) -> None:
        """Push the canary split to every healthy replica (clearing pins
        so the stage re-rolls household routing — the fleet analogue of
        ``registry.clear_pins`` + ``set_split``). Any failure rolls the
        split back off the replicas that took it and raises: a
        half-split fleet would expose the candidate to an unknown,
        unattributable traffic share."""
        targets = [(rid, self.replica(rid)) for rid in self.healthy_ids()]
        if not targets:
            raise FleetSwapError("no healthy replicas to split")
        payload = {
            "split": {"config_hash": config_hash, "percent": percent},
            "clear_pins": True,
        }

        async def push_one(rid: str, rep: Replica) -> tuple:
            try:
                status, doc, _ = await self._admin_post(
                    rep, "/admin/swap", payload, timeout_s
                )
            except _TRANSPORT_ERRORS as err:
                return rid, f"split push failed ({err})"
            if status != 200:
                return rid, (
                    f"split answered {status}: {(doc or {}).get('error')}"
                )
            return rid, None

        results = await asyncio.gather(
            *(push_one(rid, rep) for rid, rep in targets)
        )
        failures = [(rid, err) for rid, err in results if err]
        if failures:
            # Roll the split back off every replica that took it.
            await self._admin_broadcast(
                "/admin/swap", {"split": None, "clear_pins": True},
                timeout_s,
            )
            raise FleetSwapError(
                "; ".join(f"{rid}: {err}" for rid, err in failures)
            )

    async def clear_split_fleet(self, timeout_s: float = 10.0) -> dict:
        """Best-effort split + pin clear on EVERY replica, plus this
        router's own failover pins — the canary abort's routing reset.
        Returns per-replica outcomes (cleanup semantics, like
        ``unregister_fleet``)."""
        outcomes = await self._admin_broadcast(
            "/admin/swap", {"split": None, "clear_pins": True}, timeout_s
        )
        with self._lock:
            self._pins.clear()
        return outcomes

    async def clear_pins_fleet(self, timeout_s: float = 10.0) -> dict:
        """Best-effort household-pin clear on every replica (stage
        widening: re-roll routing without touching the split) + the
        router's failover pins."""
        outcomes = await self._admin_broadcast(
            "/admin/swap", {"clear_pins": True}, timeout_s
        )
        with self._lock:
            self._pins.clear()
        return outcomes

    async def flush_fleet(self, timeout_s: float = 30.0) -> dict:
        """Best-effort ``/admin/flush`` on every replica: buffered
        per-bundle telemetry lands in the warehouse before a canary
        stage's attribution read."""
        return await self._admin_broadcast("/admin/flush", {}, timeout_s)

    # -- observability -------------------------------------------------------

    def fleet_stats(self, timeout_s: float = 5.0) -> dict:
        """One aggregated fleet view over per-replica ``GET /stats``.

        Dead replicas appear with an ``error`` instead of a snapshot; the
        totals sum whatever answered. Emitted as a ``fleet_stats`` event
        through the router telemetry (-> warehouse) when attached."""
        per_replica: Dict[str, dict] = {}
        processes: Dict[str, dict] = {}
        totals = {
            "requests": 0, "act_requests": 0, "act_ok": 0, "act_rows": 0,
            "shed": 0, "http_errors": 0, "swaps": 0, "faults_injected": 0,
            "auth_401": 0, "auth_403": 0, "mux_requests": 0,
            "mux_connections": 0,
        }
        engine_totals = {"requests": 0, "batches": 0, "padded_rows": 0}
        for rid in self.replica_ids:
            rep = self.replica(rid)
            conn = self._http_conn(rep, timeout_s)
            try:
                conn.request("GET", "/stats", headers=self._auth_headers())
                resp = conn.getresponse()
                doc = json.loads(resp.read())
                per_replica[rid] = doc
                gw = doc.get("gateway", {})
                for key in totals:
                    v = gw.get(key)
                    if isinstance(v, (int, float)):
                        totals[key] += v
                for b in doc.get("bundles", {}).values():
                    for key in engine_totals:
                        v = b.get(key)
                        if isinstance(v, (int, float)):
                            engine_totals[key] += v
                # Per-replica process attribution (pid, RSS, relaunch
                # count) — in process mode each replica is its own pid,
                # so memory and churn are attributable per replica.
                proc = doc.get("process")
                if isinstance(proc, dict):
                    processes[rid] = {
                        "pid": proc.get("pid"),
                        "rss_bytes": proc.get("rss_bytes"),
                        "restarts": proc.get("restarts"),
                    }
            except (OSError, ValueError, http.client.HTTPException) as err:
                per_replica[rid] = {
                    "error": f"{type(err).__name__}: {err}"
                }
            finally:
                conn.close()
        with self._lock:
            health = {
                rid: {
                    "healthy": st.healthy,
                    "consecutive_fail": st.consecutive_fail,
                    "ejections": st.ejections,
                    "last_error": st.last_error,
                }
                for rid, st in self._state.items()
            }
            counters = dict(self.counters)
            pinned = len(self._pins)
        snapshot = {
            "kind": "fleet_stats",
            "n_replicas": len(per_replica),
            "n_healthy": sum(1 for h in health.values() if h["healthy"]),
            "fleet_config_hash": self.fleet_config_hash,
            "transport": self.transport,
            "tls": self.ssl_context is not None,
            "router": counters,
            "retry_budget": {
                "tokens": self.budget.tokens,
                "spent": self.budget.spent,
                "denied": self.budget.denied,
            },
            "pinned_households": pinned,
            "gateway_totals": totals,
            "engine_totals": engine_totals,
            "processes": processes,
            "health": health,
            "replicas": per_replica,
        }
        if self.telemetry is not None:
            self.telemetry.event(
                "fleet_stats",
                n_replicas=snapshot["n_replicas"],
                n_healthy=snapshot["n_healthy"],
                pinned_households=pinned,
                gateway_totals=totals,
                router=counters,
                processes=processes,
            )
        return snapshot


# -- in-process fleet harness --------------------------------------------------


class LocalFleet:
    """N in-process gateway replicas over the same bundle set.

    Each replica owns its engines/queues (``build_registry``) and serves
    from its own ``GatewayServer`` loop thread on an ephemeral port.
    ``kill`` severs a replica abruptly (connection resets, no drain) but
    keeps its registry warm; ``restart`` rebinds the SAME port with a
    fresh gateway over the warm registry — the fault harness's
    kill/restart cycle without recapturing a CUDA graph mid-bench. The
    per-replica ``FaultInjector`` (when a plan is given) survives
    restarts, so request-fault determinism spans the kill window.
    """

    def __init__(
        self,
        bundle_dirs: Sequence[str],
        n_replicas: int = 3,
        max_batch: int = 64,
        max_wait_s: float = 0.002,
        admission=None,
        results_db: Optional[str] = None,
        device="cuda",
        warmup: bool = True,
        fault_plan: Optional[FaultPlan] = None,
        host: str = "127.0.0.1",
        run_name: str = "fleet",
        mux: bool = False,
        tls=None,
        authenticator=None,
        batching: str = "micro",
        max_slots: int = 256,
        shard_warehouse: bool = False,
    ):
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
        resolve_device(device)
        self.bundle_dirs = list(bundle_dirs)
        self.n_replicas = n_replicas
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self.admission = admission
        self.results_db = results_db
        self.device = device
        self.warmup = warmup
        self.fault_plan = fault_plan
        self.host = host
        self.run_name = run_name
        # Wire/trust knobs mirrored from the gateway: each replica serves
        # the mux listener / TLS / token auth the process fleet does, so
        # the in-process harness exercises the same surfaces the real
        # fleet deploys.
        self.mux = mux
        self.tls = tls
        self.authenticator = authenticator
        # Queue front per replica bundle: "continuous" (slot-level
        # join/leave sessions — required for recurrent bundles) or the
        # classic "micro" coalescing queue.
        self.batching = batching
        self.max_slots = max_slots
        # Sharded warehouse write path: with
        # ``shard_warehouse`` on, each replica binds its OWN WAL-mode
        # SQLite shard (``<results_db stem>.shard-<rid><ext>``) instead of
        # funneling every per-request row into one file — the single-DB
        # funnel is the first thing to fall over at a million households.
        # ``shard_paths`` lists the files for a read-time federation
        # (``telemetry-query --shard`` / merge_warehouse_shards).
        self.shard_warehouse = shard_warehouse
        self.shard_paths: List[str] = []
        self._lock = threading.Lock()
        self._entries: Dict[str, dict] = {}
        self.kills: List[str] = []
        self.restarts: List[str] = []

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> List[Replica]:
        from p2pmicrogrid_tpu_torch.serve.gateway import (
            GatewayServer,
            ServeGateway,
            build_registry,
            make_bundle_factory,
        )

        try:
            for i in range(self.n_replicas):
                rid = f"replica-{i}"
                t_start = time.monotonic()
                injector = (
                    FaultInjector(self.fault_plan, rid)
                    if self.fault_plan is not None else None
                )
                rep_db, shard_id = self.results_db, None
                if self.shard_warehouse and self.results_db:
                    from p2pmicrogrid_tpu_torch.data.results import shard_db_path

                    rep_db, shard_id = shard_db_path(self.results_db, rid), rid
                    self.shard_paths.append(rep_db)
                registry = build_registry(
                    self.bundle_dirs,
                    max_batch=self.max_batch,
                    max_wait_s=self.max_wait_s,
                    results_db=rep_db,
                    device=self.device,
                    warmup=self.warmup,
                    run_name=f"{self.run_name}-{rid}",
                    batching=self.batching,
                    max_slots=self.max_slots,
                    shard_id=shard_id,
                )
                factory = make_bundle_factory(
                    max_batch=self.max_batch,
                    max_wait_s=self.max_wait_s,
                    results_db=rep_db,
                    device=self.device,
                    warmup=self.warmup,
                    run_name=f"{self.run_name}-{rid}",
                    batching=self.batching,
                    max_slots=self.max_slots,
                    shard_id=shard_id,
                )
                gateway = ServeGateway(
                    registry, admission=self.admission, host=self.host,
                    port=0, own_bundles=False, fault_injector=injector,
                    replica_id=rid,
                    mux_port=0 if self.mux else None,
                    tls=self.tls, authenticator=self.authenticator,
                    bundle_factory=factory,
                )
                server = GatewayServer(gateway)
                try:
                    host, port = server.start()
                except BaseException:
                    registry.close_all()
                    raise
                with self._lock:
                    self._entries[rid] = {
                        "registry": registry,
                        "gateway": gateway,
                        "server": server,
                        "injector": injector,
                        "factory": factory,
                        "host": host,
                        "port": port,
                        "mux_port": gateway.mux_port,
                        "alive": True,
                        # Seconds from this replica's first engine load to
                        # its listening socket (on the card: its captures).
                        "start_s": time.monotonic() - t_start,
                    }
        except BaseException:
            self.stop_all()
            raise
        return self.replicas

    @property
    def replicas(self) -> List[Replica]:
        with self._lock:
            return [
                Replica(
                    replica_id=rid, host=e["host"], port=e["port"],
                    mux_port=e.get("mux_port"),
                )
                for rid, e in self._entries.items()
            ]

    def entry(self, replica_id: str) -> dict:
        with self._lock:
            return self._entries[replica_id]

    def reference_engine(self):
        """The default bundle's engine on the first replica — the direct
        comparator for the fleet bench's bit-exactness check."""
        with self._lock:
            first = self._entries[next(iter(self._entries))]
        registry = first["registry"]
        return registry.get(registry.default_hash).engine

    def activate_faults(self, t0: Optional[float] = None) -> None:
        """Anchor every replica injector's fault windows at one instant
        (the loadgen start), so a plan's windows line up fleet-wide."""
        t0 = time.monotonic() if t0 is None else t0
        with self._lock:
            injectors = [
                e["injector"] for e in self._entries.values()
                if e["injector"] is not None
            ]
        for injector in injectors:
            injector.activate(t0)

    # -- chaos hooks ---------------------------------------------------------

    def kill(self, replica_id: str) -> None:
        """Abrupt replica death: open connections reset, no drain; the
        registry (engines, queues, telemetry) stays warm for restart."""
        with self._lock:
            e = self._entries[replica_id]
            server, alive = e["server"], e["alive"]
            e["alive"] = False
            self.kills.append(replica_id)
        if alive and server is not None:
            server.kill()

    def restart(self, replica_id: str) -> None:
        """Bring a killed replica back on its ORIGINAL port (the router's
        address book must stay valid) over the warm registry."""
        from p2pmicrogrid_tpu_torch.serve.gateway import (
            GatewayServer,
            ServeGateway,
        )

        with self._lock:
            e = self._entries[replica_id]
            if e["alive"]:
                raise RuntimeError(f"{replica_id} is already running")
            gateway = ServeGateway(
                e["registry"], admission=self.admission, host=e["host"],
                port=e["port"], own_bundles=False,
                fault_injector=e["injector"], replica_id=replica_id,
                mux_port=e.get("mux_port"),
                tls=self.tls, authenticator=self.authenticator,
                bundle_factory=e.get("factory"),
            )
            server = GatewayServer(gateway)
        server.start()
        with self._lock:
            e["gateway"] = gateway
            e["server"] = server
            e["alive"] = True
            self.restarts.append(replica_id)

    def stop_all(self) -> None:
        """Drain-stop every live replica, then close every registry
        (queues + telemetry). Idempotent."""
        with self._lock:
            entries = list(self._entries.values())
        for e in entries:
            if e["alive"] and e["server"] is not None:
                try:
                    e["server"].stop()
                except Exception:  # noqa: BLE001 — close every replica
                    pass
                e["alive"] = False
        for e in entries:
            e["registry"].close_all()

    def __enter__(self) -> "LocalFleet":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop_all()


# -- fleet loadgen + bench -----------------------------------------------------


@dataclass
class FleetLoadgenResult:
    """Per-request outcomes of one open-loop run through the router."""

    latencies_s: np.ndarray      # [N] send -> final outcome (incl. retries)
    statuses: np.ndarray         # [N] final status (-1 transport, 503 shed)
    retries: np.ndarray          # [N]
    failovers: np.ndarray        # [N]
    router_shed: np.ndarray      # [N] bool: the ROUTER refused this request
    config_hashes: List
    replica_ids: List
    actions: List                # per request: served actions (None if not ok)
    makespan_s: float

    @property
    def n_requests(self) -> int:
        return int(self.statuses.shape[0])

    @property
    def n_ok(self) -> int:
        return int((self.statuses == 200).sum())

    @property
    def n_shed(self) -> int:
        """Requests refused honestly under back-pressure: replica 429s
        and ROUTER sheds (RouterResult.shed — no healthy replicas, or
        retry budget spent). A replica-originated 503 (draining, queue
        shutdown) is NOT a shed: that request was admitted and then
        refused, which is exactly the broken promise availability must
        count against the fleet."""
        return int(
            (self.statuses == 429).sum() + self.router_shed.sum()
        )

    @property
    def n_failed(self) -> int:
        return self.n_requests - self.n_ok - self.n_shed

    @property
    def shed_rate(self) -> float:
        return self.n_shed / self.n_requests if self.n_requests else 0.0

    @property
    def availability(self) -> float:
        """Answered fraction of ADMITTED requests — the chaos SLO: a shed
        request was refused honestly (and told when to retry); an
        admitted-but-unanswered one is a broken promise."""
        admitted = self.n_requests - self.n_shed
        return self.n_ok / admitted if admitted else 1.0

    @property
    def total_retries(self) -> int:
        return int(self.retries.sum())

    @property
    def retry_rate(self) -> float:
        return self.total_retries / self.n_requests if self.n_requests else 0.0

    @property
    def failover_total(self) -> int:
        return int(self.failovers.sum())

    @property
    def throughput_rps(self) -> float:
        return self.n_ok / self.makespan_s if self.makespan_s > 0 else 0.0

    def latency_ms(self, q: float) -> float:
        ok = self.latencies_s[self.statuses == 200]
        return float(np.percentile(ok, q) * 1e3) if ok.size else 0.0


def run_fleet_loadgen(
    router: FleetRouter,
    obs: np.ndarray,
    arrivals: np.ndarray,
    households: List[str],
    deadline_s: Optional[float] = None,
    trace_seed: Optional[int] = None,
    household_ids: Optional[List[str]] = None,
) -> FleetLoadgenResult:
    """The open-loop Poisson schedule fired through the ROUTER (retry,
    failover and shed semantics included) instead of at one gateway.

    ``trace_seed`` (not None) traces every request: request ``i`` carries
    ``root_context(trace_seed, i)`` through ``router.act`` — the router
    records the root + attempt/backoff spans, the replicas their server
    spans, and the warehouse stitches the cross-process tree back
    together (``TRACE_TREE_SQL``).

    ``household_ids`` (one id PER REQUEST, len == len(arrivals)) replaces
    the default round-robin over ``households`` — the hook a synthetic
    population uses to drive a realistic Zipf-skewed household mix
    through the same router path."""
    obs = np.asarray(obs, dtype=np.float32)  # host-sync: host-side inputs
    arrivals = np.asarray(arrivals, dtype=float)  # host-sync: host schedule
    n = int(arrivals.shape[0])
    if household_ids is not None and len(household_ids) != n:
        raise ValueError(
            f"household_ids carries {len(household_ids)} ids for "
            f"{n} arrivals — the population sequence must be per-request"
        )
    latencies = np.zeros(n)
    statuses = np.full(n, -1, dtype=np.int64)
    retries = np.zeros(n, dtype=np.int64)
    failovers = np.zeros(n, dtype=np.int64)
    router_shed = np.zeros(n, dtype=bool)
    hashes: List = [None] * n
    replica_ids: List = [None] * n
    actions: List = [None] * n

    async def one(i: int, t0: float) -> None:
        delay = (arrivals[i] - arrivals[0]) - (time.perf_counter() - t0)
        if delay > 0:
            await asyncio.sleep(delay)
        t_send = time.perf_counter()
        hid = (
            household_ids[i] if household_ids is not None
            else households[i % len(households)]
        )
        result = await router.act(
            hid, obs[i], deadline_s=deadline_s,
            trace=(
                root_context(trace_seed, i)
                if trace_seed is not None else None
            ),
        )
        latencies[i] = time.perf_counter() - t_send
        statuses[i] = result.status
        retries[i] = result.retries
        failovers[i] = result.failovers
        router_shed[i] = result.shed
        hashes[i] = result.config_hash
        replica_ids[i] = result.replica_id
        actions[i] = result.actions

    async def run() -> float:
        t0 = time.perf_counter()
        try:
            await asyncio.gather(*(one(i, t0) for i in range(n)))
        finally:
            # The mux pools are bound to THIS loop: close them before it
            # dies so their sockets FIN now, not at garbage collection.
            await router.close_pools()
        return time.perf_counter() - t0

    makespan = asyncio.run(run())
    return FleetLoadgenResult(
        latencies_s=latencies,
        statuses=statuses,
        retries=retries,
        failovers=failovers,
        router_shed=router_shed,
        config_hashes=hashes,
        replica_ids=replica_ids,
        actions=actions,
        makespan_s=makespan,
    )


def serve_bench_fleet(
    router: FleetRouter,
    n_agents: int,
    fleet: Optional[LocalFleet] = None,
    fault_plan: Optional[FaultPlan] = None,
    reference_engine=None,
    rate_hz: float = 256.0,
    n_requests: int = 1024,
    n_households: int = 16,
    seed: int = 0,
    slo_ms: float = 100.0,
    deadline_s: Optional[float] = None,
    probe_interval_s: float = 0.1,
    emit: Optional[Callable[[dict], None]] = None,
    extra_headline: Optional[dict] = None,
    unauth_router: Optional["FleetRouter"] = None,
    unauth_probe_requests: int = 32,
    chaos_join_grace_s: float = 10.0,
    recover_wait_s: float = 0.0,
    gateway_baseline: Optional[dict] = None,
    burst_factor: float = 1.0,
    burst_dwell_s: float = 0.25,
    trace_seed: Optional[int] = None,
    household_ids: Optional[List[str]] = None,
) -> List[dict]:
    """Fleet-level SLO benchmark: the serve-bench open-loop schedule
    through the router over a live fleet, optionally with a fault plan
    killing/restarting replicas mid-run (``serve-bench --fleet --chaos``).

    Emits metric rows (headline LAST, ``serve_bench_fleet``) with the
    chaos SLOs: wire percentiles over served requests, availability over
    admitted requests, failover/retry counts, and — when a
    ``reference_engine`` is given — a bit-exactness verdict comparing
    every served action against a direct ``PolicyEngine.act`` on the same
    observations.

    ``unauth_router`` (a second router over the same fleet holding NO
    bearer token) runs the auth acceptance check after the main schedule:
    ``unauth_probe_requests`` credential-less requests must come back 401
    with ZERO retries and ZERO retry-budget spend — the headline's
    ``auth_probe`` block records it, and ``auth_shed_rate`` reports the
    gateways' 401/403 fraction of all act requests.

    ``household_ids`` (one per request) overrides the round-robin
    ``n_households`` mix with an explicit per-request id sequence — a
    synthetic population's entry point.

    ``gateway_baseline`` (a prior ``fleet_stats()['gateway_totals']``):
    gateway stats are cumulative per process, so pre-run traffic (the
    ``--wire-compare`` pass) would dilute the headline's auth-shed rate
    and request attribution — the baseline is subtracted from the totals
    this run reports.
    """
    arrivals, burst_config = make_arrivals(
        rate_hz, n_requests, seed=seed,
        burst_factor=burst_factor, burst_dwell_s=burst_dwell_s,
    )
    obs = synthetic_obs(n_requests, n_agents, seed=seed)
    households = [f"house-{i:04d}" for i in range(n_households)]
    schedule = None
    if fault_plan is not None and fleet is not None:
        schedule = FaultSchedule(fault_plan, fleet.kill, fleet.restart)
        fleet.activate_faults()
    router.start_probing(probe_interval_s)
    try:
        if schedule is not None:
            schedule.start()
        result = run_fleet_loadgen(
            router, obs, arrivals, households, deadline_s=deadline_s,
            trace_seed=trace_seed, household_ids=household_ids,
        )
        if schedule is not None:
            # Let a restart scheduled NEAR the run's end still apply (the
            # fleet should come back whole), but never block teardown on
            # events planned far past the run — those are cancelled, and
            # the headline's chaos.applied vs the plan shows the gap.
            last = max(
                (e.at_s for e in fault_plan.lifecycle_events()),
                default=0.0,
            )
            # Process-mode relaunches pay a child's full startup (torch
            # import, CUDA context, graph captures), so the harness passes a larger
            # grace there; in-process restarts finish in milliseconds.
            schedule.join(timeout_s=min(
                max(0.0, last - result.makespan_s) + 5.0,
                chaos_join_grace_s,
            ))
            schedule.stop()
    finally:
        router.stop_probing()
    # One post-chaos sweep so health/pins reflect the recovered fleet.
    router.probe_once()
    if recover_wait_s > 0:
        # Wait (bounded) for the whole fleet to report healthy — process
        # mode's supervisor relaunch must be VISIBLE in the headline's
        # fleet stats (restart counts, fresh pid), not racing past it.
        end = time.monotonic() + recover_wait_s
        while time.monotonic() < end:
            if all(router.probe_once().values()):
                break
            time.sleep(0.5)

    bit_exact = None
    mismatches = 0
    if reference_engine is not None:
        ok_idx = [
            i for i in range(result.n_requests)
            if result.statuses[i] == 200 and result.actions[i] is not None
        ]
        if ok_idx:
            got = np.asarray(  # host-sync: wire responses, host data
                [result.actions[i] for i in ok_idx], dtype=np.float32
            )
            want = reference_engine.act(obs[ok_idx])
            mismatches = int((got != want).any(axis=-1).sum())
            bit_exact = mismatches == 0

    auth_probe = None
    if unauth_router is not None and unauth_probe_requests > 0:
        # Fire credential-less requests through a token-less router over
        # the SAME fleet: every one must terminate 401 on its FIRST
        # attempt. Any retry or budget spend here means auth failures
        # leak into the retry machinery — the regression this guards.
        probe_obs = synthetic_obs(
            unauth_probe_requests, n_agents, seed=seed + 1
        )
        spent_before = unauth_router.budget.spent

        async def _probe_unauth():
            try:
                return await asyncio.gather(*(
                    unauth_router.act(f"intruder-{i:03d}", probe_obs[i])
                    for i in range(unauth_probe_requests)
                ))
            finally:
                await unauth_router.close_pools()

        probe_results = asyncio.run(_probe_unauth())
        auth_probe = {
            "requests": unauth_probe_requests,
            "n_401": sum(1 for r in probe_results if r.status == 401),
            "retries": sum(r.retries for r in probe_results),
            "budget_spent": unauth_router.budget.spent - spent_before,
        }

    stats = router.fleet_stats()
    base = gateway_baseline or {}

    def _net_total(key: str) -> float:
        return max(0, stats["gateway_totals"].get(key, 0) - base.get(key, 0))

    p50, p95, p99 = (result.latency_ms(q) for q in (50, 95, 99))
    rows = [
        {
            "metric": f"fleet_latency_ms_p{q}",
            "value": round(v, 3),
            "unit": "ms",
            "vs_baseline": round(slo_ms / v, 2) if v > 0 else 0.0,
        }
        for q, v in (("50", p50), ("95", p95), ("99", p99))
    ]
    rows.append(
        {
            "metric": "fleet_availability",
            "value": round(result.availability, 6),
            "unit": "fraction",
            "vs_baseline": round(result.availability, 6),
        }
    )
    rows.append(
        {
            "metric": "fleet_throughput_rps",
            "value": round(result.throughput_rps, 1),
            "unit": "requests/sec",
            "vs_baseline": round(result.throughput_rps / rate_hz, 3),
        }
    )
    rows.append(
        {
            "metric": "fleet_retry_rate",
            "value": round(result.retry_rate, 4),
            "unit": "retries/request",
            "vs_baseline": round(
                max(0.0, 1.0 - min(1.0, result.retry_rate)), 4
            ),
        }
    )
    counters = stats["router"]
    chaos = {
        "seed": fault_plan.seed if fault_plan is not None else None,
        "events": len(fault_plan.events) if fault_plan is not None else 0,
        "applied": schedule.applied if schedule is not None else [],
        "errors": schedule.errors if schedule is not None else [],
        "kills": list(fleet.kills) if fleet is not None else [],
        "restarts": list(fleet.restarts) if fleet is not None else [],
    }
    rows.append(
        {
            "metric": "serve_bench_fleet",
            "value": round(p99, 3),
            "unit": "ms",
            "vs_baseline": round(slo_ms / p99, 2) if p99 > 0 else 0.0,
            "p50_ms": round(p50, 3),
            "p95_ms": round(p95, 3),
            "p99_ms": round(p99, 3),
            "throughput_rps": round(result.throughput_rps, 1),
            "availability": round(result.availability, 6),
            "failover_count": int(counters["failovers"]),
            "retry_rate": round(result.retry_rate, 4),
            "shed_rate": round(result.shed_rate, 4),
            "n_requests": result.n_requests,
            "n_ok": result.n_ok,
            "n_shed": result.n_shed,
            "n_failed": result.n_failed,
            "n_replicas": stats["n_replicas"],
            "n_healthy": stats["n_healthy"],
            "ejections": int(counters["ejections"]),
            "readmissions": int(counters["readmissions"]),
            "repins": int(counters["repins"]),
            "pinned_households": stats["pinned_households"],
            "budget_denied": int(counters["budget_denied"]),
            "backoff_ms_total": round(counters["backoff_ms"], 3),
            "reconnects": int(counters["reconnects"]),
            "transport": router.transport,
            "tls": router.ssl_context is not None,
            "auth_shed_rate": round(
                (_net_total("auth_401") + _net_total("auth_403"))
                / max(1, _net_total("act_requests")),
                6,
            ),
            "auth_401": int(_net_total("auth_401")),
            "auth_403": int(_net_total("auth_403")),
            "auth_probe": auth_probe,
            "processes": stats["processes"],
            "bit_exact": bit_exact,
            "bit_exact_mismatches": mismatches,
            "served_replicas": sorted(
                {r for r in result.replica_ids if r is not None}
            ),
            "served_config_hashes": sorted(
                {h for h in result.config_hashes if h is not None}
            ),
            "chaos": chaos,
            "n_households": n_households,
            "offered_rate_rps": rate_hz,
            "slo_ms": slo_ms,
            "burst_config": burst_config,
            "trace_seed": trace_seed,
            **(extra_headline or {}),
        }
    )
    if emit is not None:
        for row in rows:
            emit(row)
    return rows
