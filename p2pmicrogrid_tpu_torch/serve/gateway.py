"""Serve gateway: asyncio HTTP/1.1 network front over the inference engine.

The port of the JAX package's ``serve/gateway.py``, over the port's engine
(one CUDA graph per padding bucket on the card, ``serve/engine.py``). The
routes, status codes, admission shedding, drain and auth checks are the JAX
package's; ``results_db=`` streams each bundle's telemetry into the results
store's warehouse (``telemetry.SqliteSink``); ``fault_injector=`` takes the
fleet's ``serve/faults.py::FaultInjector``. ``stop`` closes the
connections left after the drain before it waits for the listeners to
close, since Python 3.12's ``wait_closed`` also waits for every client
connection.

The engine + microbatch queue (serve/engine.py) serve in-process callers;
real households are remote. This module is the wire between them — a
stdlib-only (asyncio, no aiohttp) HTTP/1.1 server whose handlers submit
into the SAME ``MicroBatchQueue`` the serve-bench SLO planner models, so
the coalescing/padding-bucket behavior — and therefore the measured
latency percentiles — transfer unchanged to network serving.

Endpoints:

* ``POST /v1/act``     ``{"household": id, "obs": [A][4] | [B][A][4]}`` ->
                       ``{"actions": [A] | [B][A], "config_hash": ...}``.
                       Each obs row is one queue submit: concurrent
                       households coalesce into one padded engine batch
                       exactly as in-process callers do.
* ``GET  /healthz``    process liveness (200 once the server accepts).
* ``GET  /readyz``     traffic readiness (503 while draining/bundle-less);
                       the 200 body carries the active default
                       ``config_hash`` (and ``replica_id`` when set) — the
                       fleet two-phase swap verifies each replica flipped
                       against it (serve/router.py).
* ``GET  /stats``      gateway + per-bundle snapshot (the schema
                       ``tools/check_artifacts_schema.py`` validates for
                       committed ``GATEWAY_STATS_*.json`` captures).
* ``POST /admin/swap`` atomic default hot-swap and/or percentage-split A/B
                       (``registry.BundleRegistry`` semantics); a
                       ``clear_pins`` flag re-rolls household affinity
                       (the canary's stage-widening hook).
* ``POST /admin/drain``stop admitting act requests; in-flight complete.
* ``POST /admin/register``   load a NEW bundle dir into the live registry
                       (``bundle_factory`` — how a continual candidate
                       reaches replicas launched before it existed).
* ``POST /admin/unregister`` remove + close a non-default bundle (the
                       rolled-back candidate's exit).
* ``POST /admin/flush``      push buffered per-bundle telemetry into the
                       warehouse (mid-canary attribution reads).

Design points:

* **Admission control.** Accepting every request under overload just moves
  queueing into the kernel and blows the tail; production batched servers
  shed instead (PAPERS.md: Orca/AlpaServe). Before submitting, the gateway
  checks the routed bundle's queue depth and recent p95 coalescing wait
  against the configured budgets and answers ``429 Retry-After`` when
  either is crossed — the shed rate is a headline serve-bench --network
  stat, not a hidden failure mode.
* **Telemetry joins on the SERVING bundle.** Every bundle gets its own
  telemetry whose manifest carries that bundle's config_hash, and the
  queue's existing per-request ``serve_request`` trace path streams into
  it — so warehouse rows attribute each request to the exact config that
  answered it, across swaps.
* **Drain before close.** ``stop()`` (and SIGTERM handling in the CLI)
  flips readiness, rejects new act requests with 503, waits for in-flight
  requests to resolve, then closes queues/telemetry. A rolling restart
  loses zero admitted requests.
* **Bit-exact over the wire.** Responses serialize float32 actions through
  JSON float64 repr, which round-trips binary32 exactly — the end-to-end
  test asserts network responses byte-equal to a direct
  ``PolicyEngine.act`` on the same observations.
* **Fault injection is a first-class hook.** A ``faults.FaultInjector``
  (deterministic, seed-driven) can stall, 500, drop or detectably corrupt
  responses per request — the chaos harness the fleet router's
  retry/failover paths are tested against. ``abort()`` is the replica
  kill switch: sever every open connection with a reset, no drain.
* **Two wires, one trust boundary.** ``mux_port`` serves the
  persistent multiplexed framed wire (serve/wire.py) next to HTTP/1.1
  (which stays as the compatibility endpoint); both listeners terminate
  TLS (``tls=ssl.SSLContext``) and enforce per-household bearer tokens
  (``authenticator=auth.TokenAuthenticator``): 401/403 are auth sheds
  counted on their own stats — never server errors, never retryable —
  with the admin surface (/stats, /admin/*) gated on the operator
  wildcard and health endpoints left open for probes.
"""

from __future__ import annotations

import asyncio
import json
import os
import threading
import time
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from p2pmicrogrid_tpu_torch.device import resolve_device
from p2pmicrogrid_tpu_torch.serve.auth import AuthError
from p2pmicrogrid_tpu_torch.serve.registry import BundleRegistry, ServingBundle
from p2pmicrogrid_tpu_torch.serve.wire import serve_mux_connection
from p2pmicrogrid_tpu_torch.telemetry.tracing import (
    TRACE_HEADER,
    new_span_id,
    record_span,
)
from p2pmicrogrid_tpu_torch.telemetry.tracing import decode as decode_trace

_JSON_HEADERS = (("Content-Type", "application/json"),)
_REASONS = {
    200: "OK", 400: "Bad Request", 401: "Unauthorized", 403: "Forbidden",
    404: "Not Found", 405: "Method Not Allowed", 409: "Conflict",
    413: "Payload Too Large", 429: "Too Many Requests",
    500: "Internal Server Error", 501: "Not Implemented",
    503: "Service Unavailable",
}


def _process_rss_bytes() -> int:
    """This process's resident set (bytes) — /proc on Linux, ru_maxrss as
    the portable fallback (peak, not current; documented in the README)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except (OSError, ValueError, IndexError):
        pass
    try:
        import resource

        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    except Exception:  # noqa: BLE001 — stats must never fail a request
        return 0


def enforce_auth(check, stats: dict):
    """Run one ``TokenAuthenticator`` check, translating an ``AuthError``
    into the HTTP taxonomy: bump the ``auth_401``/``auth_403`` stat and
    raise the matching ``_HttpError``. Returns the verified claims. The
    ONE copy of the auth-shed accounting — the gateway's act/admin checks
    and the router proxy's (serve/proxy.py) all route through here."""
    try:
        return check()
    except AuthError as err:
        stats["auth_401" if err.status == 401 else "auth_403"] += 1
        raise _HttpError(err.status, str(err)) from None


async def route_safely(route_call, stats: dict):
    """Await one routing coroutine, translating failures into the wire's
    ``(status, payload, extra_headers)`` shape: ``_HttpError`` keeps its
    status (with ``Retry-After`` when set), anything else answers 500.
    ``http_errors`` counts server-side failures only — 429 is an honest
    shed and 401/403 are auth sheds with their own stats. The ONE copy of
    this accounting, shared by the gateway's HTTP and mux fronts and the
    router proxy's (serve/proxy.py)."""
    try:
        return await route_call
    except _HttpError as err:
        extra = (
            [("Retry-After", f"{err.retry_after_s:g}")]
            if err.retry_after_s is not None else []
        )
        if err.status not in (401, 403, 429):
            stats["http_errors"] += 1
        return err.status, err.payload, extra
    except Exception as err:  # noqa: BLE001 — a handler bug must answer
        # 500, not kill the connection loop for every other request
        # multiplexed onto this server.
        stats["http_errors"] += 1
        return 500, {"error": f"{type(err).__name__}: {err}"}, []


def bearer_token(headers: dict) -> Optional[str]:
    """The bearer credential out of a parsed header dict (lower-cased
    names), or None when absent."""
    value = headers.get("authorization")
    if not value:
        return None
    if value.lower().startswith("bearer "):
        return value[7:].strip() or None
    return value.strip() or None


@dataclass(frozen=True)
class AdmissionConfig:
    """Load-shedding budgets for ``POST /v1/act``.

    A request is shed (429 + ``Retry-After``) when the routed bundle's
    queue depth reaches ``max_queue_depth``, or when the queue's recent
    p95 enqueue->dispatch wait (over >= ``min_wait_samples`` samples)
    exceeds ``wait_budget_ms``. ``max_request_rows`` bounds one request's
    batch (413 above it); ``max_body_bytes`` bounds the HTTP body.
    """

    max_queue_depth: int = 256
    wait_budget_ms: float = 50.0
    retry_after_s: float = 1.0
    min_wait_samples: int = 32
    # Only wait samples younger than this enter the p95: the window is
    # refreshed by dispatches, and shed requests never dispatch — without
    # expiry, one overload burst would shed ALL traffic forever.
    wait_window_s: float = 30.0
    max_request_rows: int = 64
    max_body_bytes: int = 1 << 20


class _HttpError(Exception):
    def __init__(self, status: int, message: str, retry_after_s=None):
        super().__init__(message)
        self.status = status
        self.payload = {"error": message}
        self.retry_after_s = retry_after_s


_MAX_HEADERS = 128


async def read_http_request(
    reader, max_body_bytes: int, max_headers: int = _MAX_HEADERS
):
    """One HTTP/1.1 request: (method, path, headers, body), or None on a
    cleanly closed connection. Module-level so the standalone router proxy
    (serve/proxy.py) parses the wire exactly like the gateway does."""
    try:
        line = await reader.readline()
    except ValueError:
        # asyncio's stream limit (64 KiB) overran mid-line
        # (LimitOverrunError is a ValueError): an abusive or broken
        # client, not a server fault.
        raise _HttpError(400, "request line too long") from None
    if not line:
        return None
    parts = line.decode("latin-1").split()
    if len(parts) < 3:
        raise _HttpError(400, "malformed request line")
    method, path = parts[0].upper(), parts[1]
    headers = {}
    while True:
        if len(headers) >= max_headers:
            # An endless header stream would grow this dict without
            # ever reaching the body-size check — cap it.
            raise _HttpError(400, "too many headers")
        try:
            h = await reader.readline()
        except ValueError:
            raise _HttpError(400, "header line too long") from None
        if h in (b"\r\n", b"\n", b""):
            break
        name, _, value = h.decode("latin-1").partition(":")
        headers[name.strip().lower()] = value.strip()
    try:
        length = int(headers.get("content-length", 0))
    except ValueError:
        raise _HttpError(400, "malformed Content-Length") from None
    if length > max_body_bytes:
        raise _HttpError(
            413,
            f"body {length} bytes exceeds the {max_body_bytes}-byte limit",
        )
    body = await reader.readexactly(length) if length else b""
    return method, path, headers, body


async def send_http_response(
    writer, status: int, payload: dict, extra_headers, keep_alive,
    corrupt: bool = False,
) -> None:
    body = json.dumps(payload).encode()
    if corrupt:
        # Injected payload corruption (faults.py): same length so the
        # HTTP framing stays valid, but 0xff bytes are never valid
        # UTF-8/JSON — every client DETECTS the corruption instead of
        # mistaking it for a real answer.
        k = min(8, len(body))
        body = b"\xff" * k + body[k:]
    headers = [
        f"HTTP/1.1 {status} {_REASONS.get(status, 'Unknown')}",
        f"Content-Length: {len(body)}",
        f"Connection: {'keep-alive' if keep_alive else 'close'}",
    ]
    headers.extend(f"{k}: {v}" for k, v in _JSON_HEADERS)
    headers.extend(f"{k}: {v}" for k, v in extra_headers)
    writer.write(("\r\n".join(headers) + "\r\n\r\n").encode() + body)
    await writer.drain()


class ServeGateway:
    """Asyncio HTTP front over a ``BundleRegistry``.

    ``own_bundles=True`` makes ``stop()`` close the registry's queues and
    telemetry (set by ``build_gateway``, which created them)."""

    def __init__(
        self,
        registry: BundleRegistry,
        admission: Optional[AdmissionConfig] = None,
        host: str = "127.0.0.1",
        port: int = 0,
        request_timeout_s: float = 30.0,
        own_bundles: bool = False,
        fault_injector=None,
        replica_id: Optional[str] = None,
        mux_port: Optional[int] = None,
        tls=None,
        authenticator=None,
        restarts: int = 0,
        trace_decisions: bool = True,
        bundle_factory=None,
    ):
        self.registry = registry
        # Callable(bundle_dir) -> (engine, queue, telemetry) building ONE
        # serving bundle with this gateway's engine settings — what
        # ``POST /admin/register`` loads a NEW candidate bundle through at
        # runtime (the autopilot pushes continual candidates into a live
        # fleet this way). None disables dynamic registration (501).
        self.bundle_factory = bundle_factory
        self.admission = admission or AdmissionConfig()
        self.host = host
        self.port = port
        self.request_timeout_s = request_timeout_s
        self.own_bundles = own_bundles
        # Chaos hook (serve/faults.py): decides per request whether to
        # stall/500/drop/corrupt. None in production; the fleet bench and
        # the failure-path tests wire one in.
        self.fault_injector = fault_injector
        self.replica_id = replica_id
        # The persistent multiplexed listener (serve/wire.py): None keeps
        # it off, 0 binds an ephemeral port (resolved by start()). The
        # HTTP/1.1 port stays up regardless — the compatibility endpoint.
        self.mux_port = mux_port
        # ssl.SSLContext terminating TLS on BOTH listeners, or None for
        # plaintext (in-process tests, trusted networks).
        self.tls = tls
        # auth.TokenAuthenticator enforcing per-household bearers on
        # /v1/act and the operator wildcard on /stats + /admin/*; None
        # leaves the gateway open.
        self.authenticator = authenticator
        # Relaunch count (set by the process-fleet supervisor via
        # --restarts) so fleet stats attribute churn per replica.
        self.restarts = restarts
        # Per-request (household, obs, action) decision traces into each
        # bundle's telemetry — what data/trace_export.py replays back into
        # continual-training buffers. Costless without a warehouse sink.
        self.trace_decisions = trace_decisions
        self.created = time.strftime("%Y-%m-%dT%H:%M:%S%z")
        self._t0 = time.monotonic()
        self._server: Optional[asyncio.AbstractServer] = None
        self._mux_server: Optional[asyncio.AbstractServer] = None
        self._draining = False
        self._inflight = 0
        self._idle = asyncio.Event()
        self._idle.set()
        # stop() must be safe under repeated AND concurrent calls (a
        # signal handler racing a --serve-seconds timer, a fleet teardown
        # racing a test's context manager): the lock serializes, the flag
        # short-circuits repeats.
        self._stop_lock = asyncio.Lock()
        self._stopped = False
        self._conns: set = set()
        self.stats = {
            "requests": 0, "act_requests": 0, "act_rows": 0, "act_ok": 0,
            "shed": 0, "http_errors": 0, "swaps": 0, "drained": 0,
            "faults_injected": 0, "auth_401": 0, "auth_403": 0,
            "mux_connections": 0, "mux_requests": 0,
        }

    # -- lifecycle -----------------------------------------------------------

    async def start(self) -> Tuple[str, int]:
        """Bind and accept; returns (host, port) — port resolved when 0.
        With ``mux_port`` set, the framed multiplexed listener comes up
        next to the HTTP one (``self.mux_port`` resolves its port)."""
        self._server = await asyncio.start_server(
            self._handle_connection, self.host, self.port, ssl=self.tls
        )
        self.port = self._server.sockets[0].getsockname()[1]
        if self.mux_port is not None:
            self._mux_server = await asyncio.start_server(
                self._handle_mux, self.host, self.mux_port, ssl=self.tls
            )
            self.mux_port = self._mux_server.sockets[0].getsockname()[1]
        # NOTE: the fault injector is deliberately NOT activated here. Its
        # windows anchor either at the harness's explicit activate() (the
        # fleet bench pins every replica to the loadgen start instant —
        # anchoring at server start would skew windows by each replica's
        # warmup) or lazily at the first request it sees.
        return self.host, self.port

    @property
    def draining(self) -> bool:
        return self._draining

    def begin_drain(self) -> None:
        """Stop admitting act requests; already-admitted ones complete."""
        self._draining = True
        self.stats["drained"] += 1

    async def drain(self, timeout_s: float = 30.0) -> None:
        """``begin_drain`` then wait until no act request is in flight."""
        self.begin_drain()
        if self._inflight:
            try:
                await asyncio.wait_for(self._idle.wait(), timeout_s)
            except asyncio.TimeoutError:
                pass

    async def stop(self, drain: bool = True, timeout_s: float = 30.0) -> None:
        """Drain (optionally), stop accepting, close owned bundles.

        Idempotent under repeated and concurrent calls: the first caller
        does the work, later callers wait on the lock and return — a
        rolling-restart controller retrying stop must not re-close
        bundles or hang on a dead server."""
        async with self._stop_lock:
            if self._stopped:
                return
            if drain:
                await self.drain(timeout_s)
            for attr in ("_server", "_mux_server"):
                server = getattr(self, attr)
                if server is not None:
                    server.close()
            # Since Python 3.12 wait_closed() also waits for every open
            # client connection. After the drain the ones left carry no
            # admitted act request: idle keep-alive and persistent mux
            # clients, and requests held by an injected stall. Close them
            # (a response already written still flushes), or stop() would
            # wait out the stall, the read timeout or a client that never
            # hangs up.
            for writer in list(self._conns):
                writer.close()
            for attr in ("_server", "_mux_server"):
                server = getattr(self, attr)
                if server is not None:
                    await server.wait_closed()
                    setattr(self, attr, None)
            if self.own_bundles:
                self.registry.close_all()
            self._stopped = True

    async def abort(self) -> None:
        """The replica KILL switch (fault harness): stop accepting and
        sever every open connection with a reset — no drain, in-flight
        clients see a dropped connection, engines/queues stay untouched
        (a restart reuses them warm). This is deliberately NOT stop():
        a kill must look like a crash to clients, not a rolling drain."""
        self._draining = True
        for attr in ("_server", "_mux_server"):
            server = getattr(self, attr)
            if server is not None:
                server.close()
                setattr(self, attr, None)
        for writer in list(self._conns):
            transport = writer.transport
            if transport is not None:
                transport.abort()

    # -- HTTP plumbing -------------------------------------------------------

    @staticmethod
    def _fault_scope(path: str) -> str:
        if path == "/v1/act":
            return "act"
        if path in ("/healthz", "/readyz"):
            return "health"
        return "other"

    async def _handle_connection(self, reader, writer) -> None:
        self._conns.add(writer)
        try:
            while True:
                try:
                    # The framing reads are bounded too: a client that
                    # stalls mid-request (short body vs Content-Length) or
                    # idles a keep-alive connection would otherwise pin a
                    # handler task and socket forever.
                    request = await asyncio.wait_for(
                        self._read_request(reader), self.request_timeout_s
                    )
                except asyncio.TimeoutError:
                    break
                except _HttpError as err:
                    # Framing-level failure (bad request line, oversized
                    # body): answer it, then close — the stream position
                    # is unknown, so the connection cannot be reused.
                    self.stats["requests"] += 1
                    self.stats["http_errors"] += 1
                    await self._send(
                        writer, err.status, err.payload, [], False
                    )
                    break
                if request is None:
                    break
                method, path, headers, body = request
                self.stats["requests"] += 1
                fault = None
                if self.fault_injector is not None:
                    fault = self.fault_injector.decide(
                        self._fault_scope(path)
                    )
                if fault is not None:
                    self.stats["faults_injected"] += 1
                    if fault.kind == "drop":
                        # Vanish mid-exchange: the client sees EOF with no
                        # response — the transport-failure path the router
                        # must survive.
                        break
                    if fault.kind == "stall":
                        await asyncio.sleep(fault.stall_s)
                async def _call(fault=fault, method=method, path=path,
                                body=body, headers=headers):
                    if fault is not None and fault.kind == "error":
                        raise _HttpError(500, "injected fault")
                    return await self._route(
                        method, path, body, token=bearer_token(headers),
                        trace=headers.get(TRACE_HEADER),
                    )

                status, payload, extra = await route_safely(
                    _call(), self.stats
                )
                keep_alive = headers.get("connection", "").lower() != "close"
                await self._send(
                    writer, status, payload, extra, keep_alive,
                    corrupt=fault is not None and fault.kind == "corrupt",
                )
                if not keep_alive:
                    break
        except (asyncio.IncompleteReadError, ConnectionError):
            pass  # client went away mid-request
        finally:
            self._conns.discard(writer)
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    async def _read_request(self, reader):
        return await read_http_request(reader, self.admission.max_body_bytes)

    async def _send(
        self, writer, status: int, payload: dict, extra_headers, keep_alive,
        corrupt: bool = False,
    ) -> None:
        await send_http_response(
            writer, status, payload, extra_headers, keep_alive,
            corrupt=corrupt,
        )

    # -- the multiplexed listener --------------------------------------------

    async def _mux_route(
        self, method: str, path: str, body_doc, token, trace=None
    ):
        """One mux frame's request through the SAME routing/admission/auth
        path HTTP requests take (the frame body re-serializes so /v1/act
        and /admin/swap parse identically on both wires). ``trace`` is
        the frame's encoded trace context (serve_mux_connection passes it
        because this route declares the parameter)."""
        self.stats["requests"] += 1
        self.stats["mux_requests"] += 1
        body = json.dumps(body_doc).encode() if body_doc is not None else b""
        return await route_safely(
            self._route(method, path, body, token=token, trace=trace),
            self.stats,
        )

    def _on_mux_fault(self, fault) -> None:
        self.stats["faults_injected"] += 1
        if fault.kind == "error":
            # Mirror the HTTP path, where the injected 500 raises
            # _HttpError through route_safely and counts as a server
            # error: identical fault plans must produce identical
            # http_errors totals on both wires.
            self.stats["http_errors"] += 1

    async def _handle_mux(self, reader, writer) -> None:
        self._conns.add(writer)
        self.stats["mux_connections"] += 1
        try:
            await serve_mux_connection(
                reader, writer, self._mux_route,
                max_frame_bytes=self.admission.max_body_bytes,
                fault_decide=(
                    self.fault_injector.decide
                    if self.fault_injector is not None else None
                ),
                on_fault=self._on_mux_fault,
            )
        finally:
            self._conns.discard(writer)
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    # -- routing -------------------------------------------------------------

    def _check_act_auth(self, token, household) -> Optional[str]:
        """Per-household bearer check for /v1/act (no-op with auth off).
        401 = authenticates nobody, 403 = wrong household; both are
        counted as auth sheds, not server errors, and clients treat them
        as terminal (never retried, never charged to the retry budget).

        Returns the EFFECTIVE household: a request that omits the field
        while presenting a non-wildcard token routes as the token's
        household — the token IS the identity, and letting an
        authenticated household drop the field would let it escape its
        A/B-split pinning into the default bundle."""
        if self.authenticator is None:
            return household
        claims = enforce_auth(
            lambda: self.authenticator.check(token, household),
            self.stats,
        )
        from p2pmicrogrid_tpu_torch.serve.auth import WILDCARD_HOUSEHOLD

        claimed = claims.get("household")
        if household is None and claimed != WILDCARD_HOUSEHOLD:
            return claimed
        return household

    def _check_admin_auth(self, token) -> None:
        """Operator-wildcard check for /stats + /admin/* (no-op with auth
        off). Health endpoints stay open — load balancers probe them."""
        if self.authenticator is not None:
            enforce_auth(
                lambda: self.authenticator.check_admin(token), self.stats
            )

    async def _route(
        self, method: str, path: str, body: bytes, token=None, trace=None
    ):
        if path == "/healthz":
            if method != "GET":
                raise _HttpError(405, "GET only")
            return 200, {"ok": True, "uptime_s": self.uptime_s}, []
        if path == "/readyz":
            if method != "GET":
                raise _HttpError(405, "GET only")
            default_hash = self.registry.default_hash
            doc = {"config_hash": default_hash}
            if self.replica_id is not None:
                doc["replica_id"] = self.replica_id
            if self._draining or not default_hash:
                return 503, {
                    "ready": False,
                    "reason": "draining" if self._draining else "no bundles",
                    **doc,
                }, []
            # The ACTIVE default config_hash rides readiness: the fleet
            # two-phase swap pushes to every replica, then verifies each
            # one reports the new hash here before declaring the flip.
            return 200, {"ready": True, **doc}, []
        if path == "/stats":
            if method != "GET":
                raise _HttpError(405, "GET only")
            self._check_admin_auth(token)
            return 200, self.stats_snapshot(), []
        if path == "/v1/act":
            if method != "POST":
                raise _HttpError(405, "POST only")
            return await self._act(body, token=token, trace=trace)
        if path == "/admin/swap":
            if method != "POST":
                raise _HttpError(405, "POST only")
            self._check_admin_auth(token)
            return self._swap(body)
        if path == "/admin/drain":
            if method != "POST":
                raise _HttpError(405, "POST only")
            self._check_admin_auth(token)
            self.begin_drain()
            return 200, {"draining": True, "inflight": self._inflight}, []
        if path == "/admin/register":
            if method != "POST":
                raise _HttpError(405, "POST only")
            self._check_admin_auth(token)
            return await self._register(body)
        if path == "/admin/unregister":
            if method != "POST":
                raise _HttpError(405, "POST only")
            self._check_admin_auth(token)
            return await self._unregister(body)
        if path == "/admin/flush":
            if method != "POST":
                raise _HttpError(405, "POST only")
            self._check_admin_auth(token)
            return await self._flush_telemetry()
        raise _HttpError(404, f"no route {path}")

    @staticmethod
    def _parse_json(body: bytes) -> dict:
        try:
            doc = json.loads(body.decode())
        except (UnicodeDecodeError, json.JSONDecodeError) as err:
            raise _HttpError(400, f"body is not valid JSON: {err}") from None
        if not isinstance(doc, dict):
            raise _HttpError(400, "body must be a JSON object")
        return doc

    def _parse_obs(self, doc: dict, n_agents: int):
        """(obs [B, A, 4] float32, batched: bool) from the request body."""
        if "obs" not in doc:
            raise _HttpError(400, "missing 'obs'")
        try:
            # host-sync: caller-supplied JSON observations, not device values.
            obs = np.asarray(doc["obs"], dtype=np.float32)
        except (TypeError, ValueError) as err:
            raise _HttpError(400, f"obs is not numeric: {err}") from None
        batched = obs.ndim == 3
        if obs.ndim == 2:
            obs = obs[None]
        if obs.ndim != 3 or obs.shape[1:] != (n_agents, 4):
            raise _HttpError(
                400,
                f"obs must be [{n_agents}, 4] or [B, {n_agents}, 4] "
                f"for this bundle, got {list(obs.shape)}",
            )
        if obs.shape[0] > self.admission.max_request_rows:
            raise _HttpError(
                413,
                f"batch of {obs.shape[0]} exceeds the "
                f"{self.admission.max_request_rows}-row request limit",
            )
        return obs, batched

    def _admit(self, bundle: ServingBundle) -> None:
        """Raise 429 when the routed bundle's queue is over budget."""
        adm = self.admission
        depth = bundle.queue.depth
        if depth >= adm.max_queue_depth:
            self.stats["shed"] += 1
            raise _HttpError(
                429,
                f"queue depth {depth} at/above budget {adm.max_queue_depth}",
                retry_after_s=adm.retry_after_s,
            )
        now = time.monotonic()
        waits = [
            w for t, w in list(bundle.queue.recent_wait_ms)
            if now - t <= adm.wait_window_s
        ]
        if len(waits) >= adm.min_wait_samples:
            p95 = float(np.percentile(waits, 95))
            if p95 > adm.wait_budget_ms:
                self.stats["shed"] += 1
                raise _HttpError(
                    429,
                    f"p95 queue wait {p95:.1f} ms over the "
                    f"{adm.wait_budget_ms:g} ms budget",
                    retry_after_s=adm.retry_after_s,
                )

    async def _act(self, body: bytes, token=None, trace=None):
        self.stats["act_requests"] += 1
        # Decoded ONCE at the door; a malformed value means untraced, not
        # 400 — observability must never fail a request it observes.
        ctx = decode_trace(trace)
        t_req = time.monotonic()
        t_req_epoch = time.time()
        if self._draining:
            raise _HttpError(
                503, "gateway is draining",
                retry_after_s=self.admission.retry_after_s,
            )
        doc = self._parse_json(body)
        household = doc.get("household")
        if household is not None and not isinstance(household, str):
            raise _HttpError(400, "household must be a string")
        # Auth BEFORE admission: an unauthenticated request must be
        # refused at the door, never counted against (or shed by) the
        # capacity budgets honest households share.
        household = self._check_act_auth(token, household)
        try:
            bundle = self.registry.route(household)
        except RuntimeError as err:
            raise _HttpError(503, str(err)) from None
        obs, batched = self._parse_obs(doc, bundle.engine.n_agents)
        self._admit(bundle)
        gw_ctx = ctx.child("gateway.act") if ctx is not None else None
        if gw_ctx is not None and bundle.telemetry is not None:
            # Admission/auth/parse cost up to this point, as its own span.
            record_span(
                bundle.telemetry, gw_ctx.child("gateway.admit"),
                "gateway.admit", t_req_epoch, time.monotonic() - t_req,
                replica_id=self.replica_id,
            )
        self._inflight += 1
        self._idle.clear()
        try:
            # The household id rides into the queue: the continuous
            # batcher pins it to its session slot (hidden-state
            # continuity); the microbatch queue ignores it. Every row gets
            # a request_id — the per-row trace span id when traced, a
            # random one otherwise — so serve_request/serve_decision
            # events pair EXACTLY by id (data/trace_export.py), never by
            # household+timestamp ordering.
            row_ctxs = [
                gw_ctx.child(f"row{b}") if gw_ctx is not None else None
                for b in range(obs.shape[0])
            ]
            row_ids = [
                (rc.span_id if rc is not None else new_span_id())
                for rc in row_ctxs
            ]
            futures = [
                bundle.queue.submit(
                    row, household=household,
                    trace=row_ctxs[b], request_id=row_ids[b],
                )
                for b, row in enumerate(obs)
            ]
            rows = await asyncio.wait_for(
                asyncio.gather(*(asyncio.wrap_future(f) for f in futures)),
                timeout=self.request_timeout_s,
            )
        except asyncio.TimeoutError:
            raise _HttpError(
                500, f"inference timed out after {self.request_timeout_s:g}s"
            ) from None
        except RuntimeError as err:
            # ONLY the queue's own shutdown-race signal is a retriable 503;
            # other RuntimeErrors include engine faults (a CUDA error is a
            # RuntimeError) which must answer 500 — a client
            # retrying a permanently broken engine on 503 never stops.
            if "queue is closed" in str(err):
                raise _HttpError(503, str(err)) from None
            raise
        finally:
            self._inflight -= 1
            if self._inflight == 0:
                self._idle.set()
        self.stats["act_rows"] += len(rows)
        self.stats["act_ok"] += 1
        # float32 -> Python float (binary64) is exact, and json round-trips
        # binary64 — network actions are bit-identical to engine.act's.
        actions: List = [[float(a) for a in row] for row in rows]
        if self.trace_decisions and bundle.telemetry is not None:
            # The continual-learning flywheel's data source
            # (data/trace_export.py): one ``serve_decision`` event per obs
            # row — the household, the observation it sent and the action
            # the SERVING bundle answered, keyed by that bundle's
            # config_hash through its telemetry run. Fenced: a sink
            # hiccup must not fail a request whose inference succeeded.
            try:
                for b in range(obs.shape[0]):
                    bundle.telemetry.event(
                        "serve_decision",
                        household=household,
                        row=b,
                        request_id=row_ids[b],
                        obs=obs[b].tolist(),
                        action=actions[b],
                    )
            except Exception:  # noqa: BLE001 — telemetry is best-effort
                pass
        if gw_ctx is not None and bundle.telemetry is not None:
            # One span per row at the ROW context itself (the queue's
            # queue.wait/engine.execute spans are its children) — without
            # it every queue span would be an orphan in the stitched tree.
            for b, rc in enumerate(row_ctxs):
                record_span(
                    bundle.telemetry, rc, "gateway.row",
                    t_req_epoch, time.monotonic() - t_req,
                    row=b, request_id=row_ids[b],
                )
            record_span(
                bundle.telemetry, gw_ctx, "gateway.act",
                t_req_epoch, time.monotonic() - t_req,
                replica_id=self.replica_id, hop=ctx.hop,
                n_rows=len(rows), household=household,
                config_hash=bundle.config_hash,
            )
            # Flush NOW, per traced request: a replica SIGKILLed seconds
            # from now must not take this request's spans down with its
            # 64-record batch buffer — the chaos capture's cross-process
            # trees depend on the victim's spans surviving it.
            try:
                bundle.telemetry.flush()
            except Exception:  # noqa: BLE001 — telemetry is best-effort
                pass
        return 200, {
            "actions": actions if batched else actions[0],
            "config_hash": bundle.config_hash,
        }, []

    async def _register(self, body: bytes):
        """``POST /admin/register {"bundle_dir": ...}``: load a bundle
        into the LIVE registry — the runtime path a continual candidate
        takes into an already-running fleet (the replicas were launched
        before the candidate existed). The build (manifest load + engine
        graph captures) runs on an executor thread so in-flight serving
        never stalls behind a warmup; registration itself is the
        registry's atomic insert. Idempotent: registering a config_hash
        that is already serving answers 200 with ``already_registered`` —
        fleet-wide pushes retry per replica and must converge, not 409."""
        if self.bundle_factory is None:
            raise _HttpError(
                501,
                "this gateway was built without a bundle_factory — "
                "dynamic bundle registration is disabled",
            )
        doc = self._parse_json(body)
        bundle_dir = doc.get("bundle_dir")
        if not isinstance(bundle_dir, str) or not bundle_dir:
            raise _HttpError(400, "pass 'bundle_dir' (a string path)")
        loop = asyncio.get_running_loop()
        try:
            engine, queue, telemetry = await loop.run_in_executor(
                None, self.bundle_factory, bundle_dir
            )
        except (OSError, ValueError, KeyError) as err:
            raise _HttpError(
                400, f"bundle {bundle_dir} failed to load: {err}"
            ) from None
        config_hash = engine.manifest.get("config_hash")
        if not config_hash:
            # registry.register would also raise ValueError here, but
            # that must NOT read as the idempotent already-registered
            # case: an unroutable bundle is a client error, loudly.
            await loop.run_in_executor(None, queue.close)
            if telemetry is not None:
                await loop.run_in_executor(None, telemetry.close)
            raise _HttpError(
                400,
                f"bundle {bundle_dir} carries no config_hash — "
                "unregisterable",
            )
        try:
            self.registry.register(engine, queue, telemetry)
        except ValueError:
            # Already registered (a fleet push retrying, or two pushes
            # racing): close the duplicate we just built and converge.
            await loop.run_in_executor(None, queue.close)
            if telemetry is not None:
                await loop.run_in_executor(None, telemetry.close)
            return 200, {
                "config_hash": config_hash,
                "already_registered": True,
                "bundles": self.registry.hashes,
            }, []
        self.stats["registers"] = self.stats.get("registers", 0) + 1
        return 200, {
            "config_hash": config_hash,
            "already_registered": False,
            "bundles": self.registry.hashes,
        }, []

    async def _unregister(self, body: bytes):
        """``POST /admin/unregister {"config_hash": ...}``: remove a
        non-default, non-split bundle and close its queue/telemetry (on an
        executor thread — the queue join and warehouse flush must not
        stall the loop). The abort path for an orphaned candidate: a
        rolled-back cycle must not leave the loser registered forever.
        Idempotent: an unknown hash answers 200 ``was_registered: false``."""
        doc = self._parse_json(body)
        config_hash = doc.get("config_hash")
        if not isinstance(config_hash, str) or not config_hash:
            raise _HttpError(400, "pass 'config_hash' (a string)")
        try:
            bundle = self.registry.remove(config_hash)
        except KeyError:
            return 200, {
                "config_hash": config_hash,
                "was_registered": False,
                "bundles": self.registry.hashes,
            }, []
        except ValueError as err:
            # Removing the default or the live split arm is an operator
            # sequencing error (swap/clear first), not a missing resource.
            raise _HttpError(409, str(err)) from None
        loop = asyncio.get_running_loop()
        await loop.run_in_executor(None, bundle.queue.close)
        if bundle.telemetry is not None:
            await loop.run_in_executor(None, bundle.telemetry.close)
        return 200, {
            "config_hash": config_hash,
            "was_registered": True,
            "bundles": self.registry.hashes,
        }, []

    async def _flush_telemetry(self):
        """``POST /admin/flush``: push every bundle's buffered telemetry
        rows into the warehouse NOW. The canary controller reads per-arm
        ``serve_decision``/``serve_request`` attribution mid-stage; in
        process-fleet mode those rows buffer inside the replica processes
        (SqliteSink batches), so the controller flushes the fleet before
        each warehouse read."""
        loop = asyncio.get_running_loop()
        flushed = 0
        for config_hash in self.registry.hashes:
            try:
                bundle = self.registry.get(config_hash)
            except KeyError:
                continue  # removed between listing and get
            if bundle.telemetry is not None:
                await loop.run_in_executor(None, bundle.telemetry.flush)
                flushed += 1
        return 200, {"flushed": flushed}, []

    def _swap(self, body: bytes):
        doc = self._parse_json(body)
        new_default = doc.get("config_hash")
        split = doc.get("split", "__absent__")
        clear_pins = bool(doc.get("clear_pins", False))
        if new_default is None and split == "__absent__" and not clear_pins:
            raise _HttpError(
                400, "pass 'config_hash', 'split' and/or 'clear_pins'"
            )
        # Validate the WHOLE request before mutating anything: a combined
        # swap+split must not retarget the default (and clear every
        # household pin) and then 404 on the split half — the operator
        # would read the error as "nothing happened" while traffic had
        # already re-routed. Handlers run on one event loop, so nothing
        # races between this validation and the mutations below.
        hashes = self.registry.hashes
        arm = percent = None
        if new_default is not None:
            if not isinstance(new_default, str):
                raise _HttpError(400, "config_hash must be a string")
            if new_default not in hashes:
                raise _HttpError(
                    404, f"unknown config_hash: {new_default}"
                )
        if split != "__absent__" and split is not None:
            if not isinstance(split, dict):
                raise _HttpError(
                    400, "split must be {'config_hash':, 'percent':} or null"
                )
            arm = split.get("config_hash")
            if not isinstance(arm, str):
                raise _HttpError(400, "split config_hash must be a string")
            if arm not in hashes:
                raise _HttpError(404, f"unknown config_hash: {arm}")
            try:
                percent = float(split.get("percent", 0.0))
            except (TypeError, ValueError):
                raise _HttpError(400, "split percent must be a number") from None
            if not 0.0 < percent < 100.0:
                raise _HttpError(
                    400, f"percent must be in (0, 100), got {percent:g}"
                )
            effective_default = (
                new_default if new_default is not None
                else self.registry.default_hash
            )
            if arm == effective_default:
                raise _HttpError(
                    400, "split arm must differ from the default bundle"
                )
        try:
            if new_default is not None:
                self.registry.swap(new_default)
                self.stats["swaps"] += 1
            if split != "__absent__":
                if split is None:
                    self.registry.clear_split()
                else:
                    self.registry.set_split(arm, percent)
            if clear_pins:
                # The canary's stage-widening hook (registry.clear_pins
                # semantics): every household re-routes against the
                # current default/split on its next request.
                self.registry.clear_pins()
        except KeyError as err:  # backstop — pre-validated above
            raise _HttpError(
                404, f"unknown config_hash: {err.args[0]}"
            ) from None
        except (ValueError, TypeError) as err:
            raise _HttpError(400, str(err)) from None
        return 200, {
            "default": self.registry.default_hash,
            "split": (
                {"config_hash": self.registry.split[0],
                 "percent": self.registry.split[1]}
                if self.registry.split else None
            ),
            "bundles": self.registry.hashes,
        }, []

    # -- stats ---------------------------------------------------------------

    @property
    def uptime_s(self) -> float:
        return round(time.monotonic() - self._t0, 3)

    def stats_snapshot(self) -> dict:
        """The ``/stats`` document (and the committed ``GATEWAY_STATS_*``
        capture schema tools/check_artifacts_schema.py validates)."""
        reg = self.registry.stats()
        return {
            "kind": "gateway_stats",
            "replica_id": self.replica_id,
            "created": self.created,
            "uptime_s": self.uptime_s,
            "draining": self._draining,
            # Process identity: in process-fleet mode every replica is its
            # own pid, so fleet stats attribute RSS + restart churn per
            # replica (in-process fleets share one pid — also true).
            "process": {
                "pid": os.getpid(),
                "rss_bytes": _process_rss_bytes(),
                "restarts": self.restarts,
            },
            "wire": {
                "mux_port": self.mux_port,
                "tls": self.tls is not None,
                "auth": self.authenticator is not None,
            },
            "default": reg["default"],
            "split": reg["split"],
            "swap_count": reg["swap_count"],
            "gateway": dict(self.stats, inflight=self._inflight),
            "admission": {
                "max_queue_depth": self.admission.max_queue_depth,
                "wait_budget_ms": self.admission.wait_budget_ms,
                "retry_after_s": self.admission.retry_after_s,
                "max_request_rows": self.admission.max_request_rows,
                "shed_total": self.stats["shed"],
            },
            "bundles": reg["bundles"],
        }


# -- construction -------------------------------------------------------------

def build_bundle(
    bundle_dir: str,
    max_batch: int = 64,
    max_wait_s: float = 0.002,
    results_db: Optional[str] = None,
    device="cuda",
    warmup: bool = True,
    run_name: str = "gateway",
    serve_role: str = "candidate",
    batching: str = "micro",
    max_slots: int = 256,
    shard_id: Optional[str] = None,
):
    """Load ONE bundle dir into ``(engine, queue, telemetry)`` — the unit
    ``build_registry`` loops over at startup and ``/admin/register`` runs
    at runtime (``make_bundle_factory``). The telemetry run's manifest
    carries THIS bundle's config_hash, so its records attribute to the
    config that answered.

    ``batching`` selects the queue front: ``"micro"`` (the full-batch
    coalescing ``MicroBatchQueue``) or ``"continuous"`` (the slot-level
    ``ContinuousBatcher`` with per-household session slots; ``max_slots``
    bounds resident sessions per bundle). With ``warmup`` every padding
    bucket's graph is captured before the front's worker thread starts.

    With ``results_db`` the bundle's telemetry streams into that SQLite
    warehouse through a ``SqliteSink`` (its lock serializes the front's
    worker thread and the caller's); ``shard_id`` names the warehouse shard
    the sink writes, and rides the run manifest."""
    from p2pmicrogrid_tpu_torch.serve.continuous import ContinuousBatcher
    from p2pmicrogrid_tpu_torch.serve.engine import MicroBatchQueue, PolicyEngine
    from p2pmicrogrid_tpu_torch.serve.export import load_policy_bundle
    from p2pmicrogrid_tpu_torch.telemetry import SqliteSink, Telemetry, run_manifest
    from p2pmicrogrid_tpu_torch.telemetry.registry import run_stamp

    import uuid

    resolve_device(device)
    if batching not in ("micro", "continuous"):
        raise ValueError(
            f"batching must be 'micro' or 'continuous', got {batching!r}"
        )
    manifest, params = load_policy_bundle(bundle_dir)
    config_hash = manifest.get("config_hash")
    telemetry = Telemetry(
        # run_stamp is second+pid resolution — the hex suffix keeps two
        # bundles built back-to-back (registry startup loop, racing
        # /admin/register pushes) from colliding on one run id.
        run_id=f"{run_name}-{run_stamp()}-{uuid.uuid4().hex[:6]}",
        sinks=(
            [SqliteSink(results_db, shard_id=shard_id)] if results_db else []
        ),
        manifest=run_manifest(
            extra={
                "config_hash": config_hash,
                "setting": manifest.get("setting"),
                "serve_bundle": bundle_dir,
                "serve_role": serve_role,
                "serve_batching": batching,
            }
        ),
    )
    try:
        engine = PolicyEngine(
            manifest=manifest, params=params, max_batch=max_batch,
            telemetry=telemetry, device=device,
        )
        if batching == "continuous":
            queue = ContinuousBatcher(engine, max_slots=max_slots, autostart=False)
            if warmup:
                # A recurrent bundle's ring-step graphs, else the act graphs.
                queue.warmup()
            queue.start()
        else:
            if warmup:
                engine.warmup(include_step=False)
            queue = MicroBatchQueue(engine, max_wait_s=max_wait_s)  # refuses a recurrent bundle
    except BaseException:
        telemetry.close()
        raise
    return engine, queue, telemetry


def make_bundle_factory(
    max_batch: int = 64,
    max_wait_s: float = 0.002,
    results_db: Optional[str] = None,
    device="cuda",
    warmup: bool = True,
    run_name: str = "gateway",
    batching: str = "micro",
    max_slots: int = 256,
    shard_id: Optional[str] = None,
):
    """The ``/admin/register`` hook: a closure over this gateway's engine
    settings building one runtime-registered bundle per call."""
    resolve_device(device)

    def factory(bundle_dir: str):
        return build_bundle(
            bundle_dir,
            max_batch=max_batch,
            max_wait_s=max_wait_s,
            results_db=results_db,
            device=device,
            warmup=warmup,
            run_name=run_name,
            serve_role="candidate",
            batching=batching,
            max_slots=max_slots,
            shard_id=shard_id,
        )

    return factory


def build_registry(
    bundle_dirs,
    max_batch: int = 64,
    max_wait_s: float = 0.002,
    results_db: Optional[str] = None,
    device="cuda",
    warmup: bool = True,
    run_name: str = "gateway",
    batching: str = "micro",
    max_slots: int = 256,
    shard_id: Optional[str] = None,
) -> BundleRegistry:
    """Load each bundle dir into an engine + queue + per-bundle telemetry
    registered in a fresh ``BundleRegistry`` (first bundle = default).

    The caller owns the registry (``close_all`` on teardown). With
    ``results_db``, every bundle's telemetry streams into the SQLite
    warehouse keyed by THAT bundle's config_hash, so the per-request
    ``serve_request`` traces of the fronts join the training and eval rows
    of the config being served."""
    resolve_device(device)
    if not bundle_dirs:
        raise ValueError("pass at least one bundle directory")
    registry = BundleRegistry()
    pending_tel = pending_queue = None
    try:
        for i, bundle_dir in enumerate(bundle_dirs):
            # Warmup captures every padding bucket before the socket opens
            # — the first remote household must not pay a capture in-slot.
            engine, pending_queue, pending_tel = build_bundle(
                bundle_dir,
                max_batch=max_batch,
                max_wait_s=max_wait_s,
                results_db=results_db,
                device=device,
                warmup=warmup,
                run_name=run_name,
                serve_role="default" if i == 0 else "candidate",
                batching=batching,
                max_slots=max_slots,
                shard_id=shard_id,
            )
            registry.register(
                engine, pending_queue, telemetry=pending_tel,
                default=(i == 0),
            )
            pending_tel = pending_queue = None  # ownership -> registry
    except BaseException:
        # A later bundle failing to load must not strand the earlier
        # bundles' queue worker threads.
        if pending_queue is not None:
            pending_queue.close()
        if pending_tel is not None:
            pending_tel.close()
        registry.close_all()
        raise
    return registry


def build_gateway(
    bundle_dirs,
    max_batch: int = 64,
    max_wait_s: float = 0.002,
    results_db: Optional[str] = None,
    device="cuda",
    admission: Optional[AdmissionConfig] = None,
    host: str = "127.0.0.1",
    port: int = 0,
    warmup: bool = True,
    run_name: str = "gateway",
    fault_injector=None,
    replica_id: Optional[str] = None,
    mux_port: Optional[int] = None,
    tls=None,
    authenticator=None,
    restarts: int = 0,
    batching: str = "micro",
    max_slots: int = 256,
    shard_id: Optional[str] = None,
) -> ServeGateway:
    """``build_registry`` + a gateway owning the result (the one-process
    serving entry point). The gateway gets a ``bundle_factory`` over the
    same engine settings, so ``/admin/register`` loads runtime candidates
    exactly like the startup bundles."""
    registry = build_registry(
        bundle_dirs,
        max_batch=max_batch,
        max_wait_s=max_wait_s,
        results_db=results_db,
        device=device,
        warmup=warmup,
        run_name=run_name,
        batching=batching,
        max_slots=max_slots,
        shard_id=shard_id,
    )
    return ServeGateway(
        registry, admission=admission, host=host, port=port, own_bundles=True,
        fault_injector=fault_injector, replica_id=replica_id,
        mux_port=mux_port, tls=tls, authenticator=authenticator,
        restarts=restarts,
        bundle_factory=make_bundle_factory(
            max_batch=max_batch,
            max_wait_s=max_wait_s,
            results_db=results_db,
            device=device,
            warmup=warmup,
            run_name=run_name,
            batching=batching,
            max_slots=max_slots,
            shard_id=shard_id,
        ),
    )


class GatewayServer:
    """Synchronous facade: run a ``ServeGateway`` on a daemon thread with
    its own event loop (tests, the serve-bench ``--network`` harness, and
    anything else that needs a live socket without owning a loop)."""

    def __init__(self, gateway: ServeGateway):
        self.gateway = gateway
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        # stop()/kill() may race from different threads (fleet chaos
        # schedule vs. test teardown); first caller in wins, the rest
        # no-op against the cleared loop.
        self._stop_lock = threading.Lock()

    def start(self, timeout_s: float = 60.0) -> Tuple[str, int]:
        started = threading.Event()
        failure: list = []

        def run() -> None:
            loop = asyncio.new_event_loop()
            asyncio.set_event_loop(loop)
            try:
                loop.run_until_complete(self.gateway.start())
            except Exception as err:  # noqa: BLE001 — surface to start()
                # self._loop stays unset: stop() must short-circuit, not
                # block scheduling a coroutine on a loop that will never
                # run (that would mask this error behind a timeout).
                failure.append(err)
                loop.close()
                started.set()
                return
            self._loop = loop
            started.set()
            try:
                loop.run_forever()
            finally:
                loop.close()

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
        if not started.wait(timeout_s):
            raise TimeoutError("gateway did not start in time")
        if failure:
            self._thread.join(timeout=5.0)
            self._thread = None
            if self.gateway.own_bundles:
                # The caller gets an exception, not a handle to clean up:
                # the bundles build_gateway created (queue worker threads,
                # buffered warehouse sinks) must not leak here.
                self.gateway.registry.close_all()
            raise failure[0]
        return self.gateway.host, self.gateway.port

    def stop(self, drain: bool = True, timeout_s: float = 30.0) -> None:
        async def teardown() -> None:
            await self.gateway.stop(drain=drain, timeout_s=timeout_s)
            # In-flight act requests drained above; what remains are idle
            # keep-alive connections or fault-stalled handlers. Cancel
            # them and let their finally blocks run before the loop dies,
            # or asyncio logs "Task was destroyed but it is pending!".
            tasks = [
                t for t in asyncio.all_tasks()
                if t is not asyncio.current_task()
            ]
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)

        with self._stop_lock:
            loop = self._loop
            if loop is None:
                return  # already stopped/killed (idempotent)
            future = asyncio.run_coroutine_threadsafe(teardown(), loop)
            try:
                future.result(timeout=timeout_s + 5.0)
            finally:
                loop.call_soon_threadsafe(loop.stop)
                if self._thread is not None:
                    self._thread.join(timeout=10.0)
                self._loop = None
                self._thread = None

    def kill(self, timeout_s: float = 5.0) -> None:
        """Abrupt replica kill (fault harness): abort every connection and
        tear the loop down — clients see resets, nothing drains, engines
        and queues are left untouched for a warm restart. Idempotent, and
        safe to interleave with stop()."""

        async def teardown() -> None:
            await self.gateway.abort()
            # Cancel the orphaned handler tasks and let their finally
            # blocks run before the loop dies — otherwise asyncio logs a
            # "Task was destroyed but it is pending!" per connection.
            tasks = [
                t for t in asyncio.all_tasks()
                if t is not asyncio.current_task()
            ]
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)

        with self._stop_lock:
            loop = self._loop
            if loop is None:
                return
            future = asyncio.run_coroutine_threadsafe(teardown(), loop)
            try:
                future.result(timeout=timeout_s)
            except Exception:  # noqa: BLE001 — a kill must always finish
                pass
            finally:
                loop.call_soon_threadsafe(loop.stop)
                if self._thread is not None:
                    self._thread.join(timeout=10.0)
                self._loop = None
                self._thread = None

    def __enter__(self) -> "GatewayServer":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
