"""Standalone router proxy: the fleet front as its own process.

The port of the JAX package's ``serve/proxy.py``, host code copied as it is
(it runs no model: the replicas behind it hold the engines).

A ``FleetRouter`` inside the client (serve-bench's loadgen imports it as a
library) is fine for benching, wrong for trust:
untrusted households cannot be handed a routing table, health state and
the fleet's admin credentials. ``serve-router`` runs the router as a
PROXY process instead:

    households ──TLS+token──> serve-router ──mux──> replica processes

* The proxy terminates TLS and per-household bearer auth at its own
  socket (the replicas can then live on a trusted segment), exposing the
  same ``/v1/act`` contract as a gateway — single-row or batched obs —
  plus ``/healthz``, ``/readyz`` (ready while ANY replica is healthy,
  body carries the fleet ``config_hash``), ``/stats`` (the aggregated
  ``fleet_stats`` snapshot; operator wildcard token) and ``/admin/swap``
  (two-phase fleet-wide swap; wildcard token).
* Toward the replicas it speaks the persistent multiplexed wire
  (serve/wire.py) with the router's retry/failover/health discipline —
  one pool per replica, reconnect + health-ejection on failure.
* A mux listener (``mux_port``) serves framed clients next to the HTTP
  front, sharing one routing path, so persistent-wire households can
  keep their connection through the proxy too.

``ProxyServer`` is the daemon-thread facade (the ``GatewayServer``
pattern) for tests and the CLI.
"""

from __future__ import annotations

import asyncio
import threading
import time
from typing import Optional, Tuple

import numpy as np

from p2pmicrogrid_tpu_torch.serve.gateway import (
    _HttpError,
    bearer_token,
    enforce_auth,
    read_http_request,
    route_safely,
    send_http_response,
)
from p2pmicrogrid_tpu_torch.serve.router import FleetRouter, FleetSwapError
from p2pmicrogrid_tpu_torch.serve.wire import serve_mux_connection
from p2pmicrogrid_tpu_torch.telemetry.tracing import TRACE_HEADER, record_span
from p2pmicrogrid_tpu_torch.telemetry.tracing import decode as decode_trace


class RouterProxy:
    """Asyncio HTTP(S) + mux front over a ``FleetRouter``."""

    def __init__(
        self,
        router: FleetRouter,
        host: str = "127.0.0.1",
        port: int = 0,
        mux_port: Optional[int] = None,
        tls=None,
        authenticator=None,
        request_timeout_s: float = 30.0,
        max_body_bytes: int = 1 << 20,
        max_request_rows: int = 64,
    ):
        self.router = router
        self.host = host
        self.port = port
        self.mux_port = mux_port
        self.tls = tls
        self.authenticator = authenticator
        self.request_timeout_s = request_timeout_s
        self.max_body_bytes = max_body_bytes
        self.max_request_rows = max_request_rows
        self._t0 = time.monotonic()
        self._server: Optional[asyncio.AbstractServer] = None
        self._mux_server: Optional[asyncio.AbstractServer] = None
        self._conns: set = set()
        self.stats = {
            "requests": 0, "act_requests": 0, "act_ok": 0,
            "auth_401": 0, "auth_403": 0, "http_errors": 0,
            "mux_connections": 0,
        }

    # -- lifecycle -----------------------------------------------------------

    async def start(self) -> Tuple[str, int]:
        self._server = await asyncio.start_server(
            self._handle_http, self.host, self.port, ssl=self.tls
        )
        self.port = self._server.sockets[0].getsockname()[1]
        if self.mux_port is not None:
            self._mux_server = await asyncio.start_server(
                self._handle_mux, self.host, self.mux_port, ssl=self.tls
            )
            self.mux_port = self._mux_server.sockets[0].getsockname()[1]
        return self.host, self.port

    async def stop(self) -> None:
        for attr in ("_server", "_mux_server"):
            server = getattr(self, attr)
            if server is not None:
                server.close()
        # Close the client connections BEFORE waiting on the listeners:
        # since Python 3.12 wait_closed() also waits for every open
        # connection, so a client that keeps its connection would hold
        # stop() forever.
        for writer in list(self._conns):
            writer.close()
        for attr in ("_server", "_mux_server"):
            server = getattr(self, attr)
            if server is not None:
                await server.wait_closed()
                setattr(self, attr, None)
        await self.router.close_pools()

    # -- auth ----------------------------------------------------------------

    def _check_act(self, token, household):
        """Returns the effective household — a field-less request with a
        non-wildcard token routes as the token's household (gateway
        semantics: the token IS the identity)."""
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

    def _check_admin(self, token) -> None:
        if self.authenticator is not None:
            enforce_auth(
                lambda: self.authenticator.check_admin(token), self.stats
            )

    # -- routing -------------------------------------------------------------

    async def _route(self, method: str, path: str, doc, token, trace=None):
        if path == "/healthz":
            if method != "GET":
                raise _HttpError(405, "GET only")
            return 200, {
                "ok": True,
                "uptime_s": round(time.monotonic() - self._t0, 3),
            }, []
        if path == "/readyz":
            if method != "GET":
                raise _HttpError(405, "GET only")
            healthy = self.router.healthy_ids()
            body = {
                "ready": bool(healthy),
                "config_hash": self.router.fleet_config_hash,
                "n_healthy": len(healthy),
            }
            return (200 if healthy else 503), body, []
        if path == "/stats":
            if method != "GET":
                raise _HttpError(405, "GET only")
            self._check_admin(token)
            # fleet_stats fans out synchronous per-replica GETs — off the
            # event loop, or every in-flight act request stalls behind it.
            snapshot = await asyncio.get_running_loop().run_in_executor(
                None, self.router.fleet_stats
            )
            snapshot["proxy"] = dict(self.stats)
            return 200, snapshot, []
        if path == "/v1/act":
            if method != "POST":
                raise _HttpError(405, "POST only")
            return await self._act(doc, token, trace=trace)
        if path == "/admin/swap":
            if method != "POST":
                raise _HttpError(405, "POST only")
            self._check_admin(token)
            if not isinstance(doc, dict) or not isinstance(
                doc.get("config_hash"), str
            ):
                raise _HttpError(400, "pass a string 'config_hash'")
            try:
                outcome = await self.router.swap_fleet(doc["config_hash"])
            except FleetSwapError as err:
                raise _HttpError(502, str(err)) from None
            return 200, outcome, []
        raise _HttpError(404, f"no route {path}")

    async def _act(self, doc, token, trace=None):
        self.stats["act_requests"] += 1
        ctx = decode_trace(trace)
        p_ctx = ctx.child("proxy.act") if ctx is not None else None
        t0 = time.monotonic()
        t0_epoch = time.time()
        if not isinstance(doc, dict):
            raise _HttpError(400, "body must be a JSON object")
        household = doc.get("household")
        if household is not None and not isinstance(household, str):
            raise _HttpError(400, "household must be a string")
        household = self._check_act(token, household)
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
        if obs.ndim != 3:
            raise _HttpError(400, "obs must be [A, 4] or [B, A, 4]")
        if obs.shape[0] > self.max_request_rows:
            raise _HttpError(
                413,
                f"batch of {obs.shape[0]} exceeds the "
                f"{self.max_request_rows}-row request limit",
            )
        results = await asyncio.gather(*(
            self.router.act(
                household, row, deadline_s=self.request_timeout_s,
                trace=(p_ctx.child(f"row{i}") if p_ctx is not None else None),
            )
            for i, row in enumerate(obs)
        ))
        worst = next((r for r in results if not r.ok), None)

        def finish(status: int):
            if p_ctx is not None:
                record_span(
                    self.router.telemetry, p_ctx, "proxy.act",
                    t0_epoch, time.monotonic() - t0,
                    status=status, n_rows=len(obs), hop=ctx.hop,
                )

        if worst is not None:
            extra = (
                [("Retry-After", f"{worst.retry_after_s:g}")]
                if worst.retry_after_s is not None else []
            )
            status = worst.status if worst.status > 0 else 502
            finish(status)
            return status, {"error": worst.error or "replica failure"}, extra
        actions = [r.actions for r in results]
        self.stats["act_ok"] += 1
        finish(200)
        return 200, {
            "actions": actions if batched else actions[0],
            "config_hash": results[0].config_hash,
            "replica_id": results[0].replica_id,
        }, []

    # -- fronts --------------------------------------------------------------

    async def _route_bytes(self, method, path, body: bytes, token, trace=None):
        import json as _json

        doc = None
        if body:
            try:
                doc = _json.loads(body.decode())
            except (UnicodeDecodeError, _json.JSONDecodeError) as err:
                raise _HttpError(
                    400, f"body is not valid JSON: {err}"
                ) from None
        return await self._route(method, path, doc, token, trace=trace)

    async def _handle_http(self, reader, writer) -> None:
        self._conns.add(writer)
        try:
            while True:
                try:
                    request = await asyncio.wait_for(
                        read_http_request(reader, self.max_body_bytes),
                        self.request_timeout_s,
                    )
                except asyncio.TimeoutError:
                    break
                except _HttpError as err:
                    self.stats["requests"] += 1
                    self.stats["http_errors"] += 1
                    await send_http_response(
                        writer, err.status, err.payload, [], False
                    )
                    break
                if request is None:
                    break
                method, path, headers, body = request
                self.stats["requests"] += 1
                status, payload, extra = await route_safely(
                    self._route_bytes(
                        method, path, body, bearer_token(headers),
                        trace=headers.get(TRACE_HEADER),
                    ),
                    self.stats,
                )
                keep_alive = headers.get("connection", "").lower() != "close"
                await send_http_response(
                    writer, status, payload, extra, keep_alive
                )
                if not keep_alive:
                    break
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        finally:
            self._conns.discard(writer)
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    async def _mux_route(self, method, path, body_doc, token, trace=None):
        self.stats["requests"] += 1
        return await route_safely(
            self._route(method, path, body_doc, token, trace=trace),
            self.stats,
        )

    async def _handle_mux(self, reader, writer) -> None:
        self._conns.add(writer)
        self.stats["mux_connections"] += 1
        try:
            await serve_mux_connection(
                reader, writer, self._mux_route,
                max_frame_bytes=self.max_body_bytes,
            )
        finally:
            self._conns.discard(writer)
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass


class ProxyServer:
    """Run a ``RouterProxy`` on a daemon thread with its own loop."""

    def __init__(self, proxy: RouterProxy):
        self.proxy = proxy
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._stop_lock = threading.Lock()

    def start(self, timeout_s: float = 60.0) -> Tuple[str, int]:
        started = threading.Event()
        failure: list = []

        def run() -> None:
            loop = asyncio.new_event_loop()
            asyncio.set_event_loop(loop)
            try:
                loop.run_until_complete(self.proxy.start())
            except Exception as err:  # noqa: BLE001 — surface to start()
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
            raise TimeoutError("router proxy did not start in time")
        if failure:
            self._thread.join(timeout=5.0)
            self._thread = None
            raise failure[0]
        return self.proxy.host, self.proxy.port

    def stop(self, timeout_s: float = 30.0) -> None:
        async def teardown() -> None:
            await self.proxy.stop()
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
            finally:
                loop.call_soon_threadsafe(loop.stop)
                if self._thread is not None:
                    self._thread.join(timeout=10.0)
                self._loop = None
                self._thread = None

    def __enter__(self) -> "ProxyServer":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
