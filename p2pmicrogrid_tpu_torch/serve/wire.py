"""Persistent multiplexed wire: length-prefixed JSON frames over keep-alive
connections.

The r06/r07 wire captures showed the dominant per-request cost was not the
engine batch — it was the fresh HTTP/1.1 connection every request paid
(TCP handshake + slow-start + teardown, and with TLS a full handshake on
top). This module is the replacement transport: ONE connection per
(client, replica) pair stays up for the whole session and carries many
requests concurrently, matched by request id, so responses may complete
out of order (a stalled request never head-of-line-blocks its neighbours
the way a serial keep-alive HTTP/1.1 connection would).

Framing (the spec README documents):

* A frame is a 4-byte big-endian unsigned length ``N`` followed by ``N``
  bytes of UTF-8 JSON (one object). ``N`` is bounded by
  ``max_frame_bytes`` (default 1 MiB) — an oversized or negative length
  is a protocol error and kills the connection (the stream position past
  a bogus prefix is unknowable).
* Request object:  ``{"id": int, "method": "POST", "path": "/v1/act",
  "body": {...}, "token": "p2p1...", "trace": "<trace_id>-<span_id>-<hop>"}``
  — ``token`` optional, carries the per-household bearer (serve/auth.py)
  when the gateway terminates trust; ``trace`` optional, carries the
  encoded distributed-trace context (telemetry/tracing.py — the mux
  counterpart of the ``x-p2p-trace`` HTTP header). ``MuxPool`` replays
  stamp the replayed frame with hop+1, so server spans distinguish the
  original delivery from the post-reconnect one.
* Response object: ``{"id": int, "status": int, "body": {...}}`` plus
  ``"retry_after_s"`` when the server sheds. ``id`` echoes the request.
* A response whose ``body`` is not an object is a DETECTABLY corrupt
  payload (the fault injector's ``corrupt`` kind garbles exactly this
  way): clients report it as ``doc=None`` just like a corrupt HTTP body,
  so the retry machinery treats both transports identically.

Client machinery:

* ``MuxConnection`` — one live framed connection: a reader task resolves
  pending request futures by id; EOF/reset fails EVERY pending future
  with ``ConnectionResetError`` (the half-open case: a SIGKILLed peer
  that never FINs is caught by the per-request timeout, after which the
  caller discards the connection).
* ``MuxPool`` — the per-replica connection pool the router and loadgen
  share: picks a live connection round-robin, reconnects on demand, and
  (``replay=True``) replays a transport-failed request on a fresh
  connection inside the caller's deadline. Replay is safe because
  ``/v1/act`` is idempotent — a greedy action is a pure function of the
  observation; the engine holds no per-request state. ``reconnects`` is
  counted for the fleet stats headline.

Server side: ``serve_mux_connection`` is the shared accept-loop body —
the gateway (serve/gateway.py) and the standalone router proxy
(serve/proxy.py) both hand it a ``route`` coroutine and get identical
framing, fault-injection hooks and concurrent per-frame dispatch.
"""

from __future__ import annotations

import asyncio
import inspect
import json
import time
from typing import Callable, Dict, List, Optional

MAX_FRAME_BYTES = 1 << 20
_LEN_BYTES = 4

# The corrupt-fault body marker: deliberately NOT a JSON object, so every
# client detects the corruption (doc -> None) instead of acting on it.
CORRUPT_BODY = "�" * 8


class WireProtocolError(Exception):
    """The framed stream is unrecoverable (bad length prefix, non-JSON
    frame, non-object frame): the connection must close."""


class FrameTooLarge(WireProtocolError):
    """An inbound frame exceeded the cap but was fully DRAINED — the
    stream is still at a frame boundary, so a server may answer 413 and
    keep the connection (the HTTP wire's behavior for the same input).
    Raised only with ``drain_oversize=True``."""

    def __init__(self, length: int, cap: int):
        super().__init__(
            f"frame of {length} bytes exceeds the {cap}-byte cap"
        )
        self.length = length


# A bogus length prefix can claim gigabytes; drain-and-413 only up to this
# multiple of the cap — past it, closing is cheaper than reading garbage.
_DRAIN_CAP_MULTIPLE = 8


def encode_frame(doc: dict) -> bytes:
    payload = json.dumps(doc).encode()
    return len(payload).to_bytes(_LEN_BYTES, "big") + payload


async def read_frame(
    reader: asyncio.StreamReader,
    max_frame_bytes: int = MAX_FRAME_BYTES,
    drain_oversize: bool = False,
) -> Optional[dict]:
    """One frame, or ``None`` on clean EOF at a frame boundary. Raises
    ``WireProtocolError`` on oversized/garbage frames and
    ``asyncio.IncompleteReadError`` on mid-frame EOF.

    ``drain_oversize=True`` (servers): a frame over the cap — but under
    a bounded drain ceiling — is read and DISCARDED in chunks, then
    raised as ``FrameTooLarge`` with the stream intact, so one client's
    oversized request can answer 413 without severing every other
    request multiplexed on the connection."""
    try:
        prefix = await reader.readexactly(_LEN_BYTES)
    except asyncio.IncompleteReadError as err:
        if not err.partial:
            return None  # clean close between frames
        raise
    length = int.from_bytes(prefix, "big")
    if length > max_frame_bytes:
        if drain_oversize and length <= max_frame_bytes * _DRAIN_CAP_MULTIPLE:
            remaining = length
            while remaining > 0:
                chunk = await reader.read(min(remaining, 1 << 16))
                if not chunk:
                    raise asyncio.IncompleteReadError(b"", remaining)
                remaining -= len(chunk)
            raise FrameTooLarge(length, max_frame_bytes)
        raise WireProtocolError(
            f"frame of {length} bytes exceeds the {max_frame_bytes}-byte cap"
        )
    raw = await reader.readexactly(length) if length else b""
    try:
        doc = json.loads(raw.decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as err:
        raise WireProtocolError(f"frame is not valid JSON: {err}") from None
    if not isinstance(doc, dict):
        raise WireProtocolError("frame must be a JSON object")
    return doc


# -- client: one multiplexed connection ---------------------------------------


class MuxConnection:
    """One live framed connection with id-matched in-flight requests."""

    def __init__(
        self,
        reader: asyncio.StreamReader,
        writer: asyncio.StreamWriter,
        max_frame_bytes: int = MAX_FRAME_BYTES,
    ):
        self._reader = reader
        self._writer = writer
        self.max_frame_bytes = max_frame_bytes
        self._pending: Dict[int, asyncio.Future] = {}
        self._next_id = 0
        self._write_lock = asyncio.Lock()
        self.closed = False
        self._reader_task = asyncio.ensure_future(self._read_loop())

    @classmethod
    async def open(
        cls,
        host: str,
        port: int,
        ssl=None,
        connect_timeout_s: float = 5.0,
        max_frame_bytes: int = MAX_FRAME_BYTES,
    ) -> "MuxConnection":
        reader, writer = await asyncio.wait_for(
            asyncio.open_connection(host, port, ssl=ssl), connect_timeout_s
        )
        return cls(reader, writer, max_frame_bytes=max_frame_bytes)

    async def _read_loop(self) -> None:
        error: Exception = ConnectionResetError("mux connection lost")
        try:
            while True:
                doc = await read_frame(self._reader, self.max_frame_bytes)
                if doc is None:
                    break
                fut = self._pending.pop(doc.get("id"), None)
                if fut is not None and not fut.done():
                    fut.set_result(doc)
        except (
            WireProtocolError, ConnectionError, OSError,
            asyncio.IncompleteReadError,
        ) as err:
            error = ConnectionResetError(f"mux connection lost: {err}")
        finally:
            self.closed = True
            # Half-open/broken stream: every in-flight request on this
            # connection fails NOW, with a transport error the pool can
            # retry on a fresh connection — not a silent hang.
            for fut in self._pending.values():
                if not fut.done():
                    fut.set_exception(error)
            self._pending.clear()

    async def request(
        self,
        path: str,
        body: Optional[dict],
        timeout_s: float,
        method: str = "POST",
        token: Optional[str] = None,
        trace: Optional[str] = None,
    ):
        """(status, body doc | None-if-corrupt, headers-ish dict)."""
        if self.closed:
            raise ConnectionResetError("mux connection is closed")
        loop = asyncio.get_running_loop()
        rid = self._next_id
        self._next_id += 1
        frame: dict = {"id": rid, "method": method, "path": path}
        if body is not None:
            frame["body"] = body
        if token is not None:
            frame["token"] = token
        if trace is not None:
            frame["trace"] = trace
        encoded = encode_frame(frame)
        if len(encoded) > self.max_frame_bytes + _LEN_BYTES:
            # Refuse locally: an over-cap request would only earn a
            # server-side drain+413 with no id to route back — fail it
            # HERE, immediately and terminally, without touching the
            # shared connection.
            raise FrameTooLarge(len(encoded) - _LEN_BYTES,
                                self.max_frame_bytes)
        fut: asyncio.Future = loop.create_future()
        self._pending[rid] = fut
        try:
            async with self._write_lock:
                # Re-checked under the lock: a request queued behind a
                # writer parked in drain() can wake on a connection that
                # was lost and closed meanwhile. Writing to it would not
                # fail as a transport error: a TLS transport closed after
                # its connection_lost raises AttributeError from write().
                if self.closed or self._writer.transport.is_closing():
                    raise ConnectionResetError("mux connection is closed")
                self._writer.write(encoded)
                await self._writer.drain()
            doc = await asyncio.wait_for(fut, timeout_s)
        finally:
            self._pending.pop(rid, None)
            if fut.done() and not fut.cancelled():
                # The read loop fails every pending future when the
                # stream breaks, this one too while its write was still
                # in flight: mark that error seen.
                fut.exception()
        status = doc.get("status")
        if not isinstance(status, int):
            raise WireProtocolError("response frame carries no status")
        resp_body = doc.get("body")
        if resp_body is not None and not isinstance(resp_body, dict):
            resp_body = None  # detectably corrupt payload
        headers = {}
        if doc.get("retry_after_s") is not None:
            headers["retry-after"] = str(doc["retry_after_s"])
        return status, resp_body, headers

    @property
    def inflight(self) -> int:
        return len(self._pending)

    async def close(self) -> None:
        self.closed = True
        self._reader_task.cancel()
        try:
            await self._reader_task
        except (asyncio.CancelledError, Exception):  # noqa: BLE001
            pass
        if not self._writer.transport.is_closing():
            # A second close() of a TLS transport drops its protocol.
            self._writer.close()
        try:
            await self._writer.wait_closed()
        except (ConnectionError, OSError):
            pass


# -- client: per-address pool --------------------------------------------------

_TRANSPORT_ERRORS = (
    ConnectionError, OSError, EOFError,
    asyncio.IncompleteReadError, WireProtocolError,
)


class MuxPool:
    """Persistent multiplexed connections to ONE (host, port).

    ``request`` picks a live connection round-robin (``size`` bounds the
    pool; one mux connection already carries many concurrent requests —
    more than a few only helps by spreading kernel socket buffers),
    reconnecting on demand. A transport failure discards the connection
    and — because act requests are idempotent — replays the request on a
    fresh one, bounded by the per-request deadline. Timeouts do NOT
    discard the connection (a fault-stalled server answers late on a
    healthy stream) and are never replayed (the deadline already passed).
    """

    def __init__(
        self,
        host: str,
        port: int,
        size: int = 2,
        ssl=None,
        connect_timeout_s: float = 5.0,
        max_frame_bytes: int = MAX_FRAME_BYTES,
        on_reconnect: Optional[Callable[[], None]] = None,
    ):
        if size < 1:
            raise ValueError(f"pool size must be >= 1, got {size}")
        self.host = host
        self.port = port
        self.size = size
        self.ssl = ssl
        self.connect_timeout_s = connect_timeout_s
        self.max_frame_bytes = max_frame_bytes
        self.on_reconnect = on_reconnect
        self._conns: List[Optional[MuxConnection]] = [None] * size
        self._locks = [asyncio.Lock() for _ in range(size)]
        # Whether a slot EVER held a connection: a re-open on such a slot
        # is a reconnect no matter which path discarded the old one
        # (idle-detected EOF in _conn_at, or a mid-request transport
        # failure in request()) — the headline reconnect counter must
        # count exactly the losses chaos runs exist to measure.
        self._slot_connected = [False] * size
        self._rr = 0
        self.connects = 0     # total connections ever opened
        self.reconnects = 0   # connections opened after the first per slot
        self.replays = 0      # requests replayed on a fresh connection

    async def _conn_at(self, slot: int) -> MuxConnection:
        async with self._locks[slot]:
            conn = self._conns[slot]
            if conn is None or conn.closed:
                if conn is not None:
                    await conn.close()
                conn = await MuxConnection.open(
                    self.host, self.port, ssl=self.ssl,
                    connect_timeout_s=self.connect_timeout_s,
                    max_frame_bytes=self.max_frame_bytes,
                )
                self.connects += 1
                if self._slot_connected[slot]:
                    self.reconnects += 1
                    if self.on_reconnect is not None:
                        self.on_reconnect()
                self._slot_connected[slot] = True
                self._conns[slot] = conn
            return conn

    async def request(
        self,
        path: str,
        body: Optional[dict],
        timeout_s: float,
        method: str = "POST",
        token: Optional[str] = None,
        replay: bool = True,
        trace: Optional[str] = None,
    ):
        """(status, doc, headers) — see ``MuxConnection.request``."""
        deadline = time.monotonic() + timeout_s
        slot = self._rr % self.size
        self._rr += 1
        replayed = False
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise asyncio.TimeoutError(
                    f"mux request deadline exhausted ({timeout_s:g}s)"
                )
            try:
                conn = await self._conn_at(slot)
                return await conn.request(
                    path, body, remaining, method=method, token=token,
                    trace=trace,
                )
            except FrameTooLarge:
                # The REQUEST is over the cap — terminal, and the
                # connection never saw it: no discard, no replay.
                raise
            except (asyncio.TimeoutError, TimeoutError):
                # Ordered BEFORE the transport tuple: on 3.11+ the
                # builtin TimeoutError (== asyncio.TimeoutError) is an
                # OSError subclass and would match it. A timed-out
                # request must NOT tear down the healthy shared
                # connection every other in-flight request rides on
                # (a stall-faulted server answers late on a good
                # stream), and is never replayed — its deadline passed.
                raise
            except _TRANSPORT_ERRORS:
                # Broken/half-open connection: drop it; replay the (idem-
                # potent) request ONCE on a fresh one while the deadline
                # holds. A second consecutive failure means the replica is
                # down — surface it to the failover layer above.
                conn = self._conns[slot]
                if conn is not None:
                    self._conns[slot] = None
                    await conn.close()
                if not replay or replayed:
                    raise
                replayed = True
                self.replays += 1
                if trace is not None:
                    # Same trace/span identity, one delivery later: the
                    # server spans of the replayed hop must not be
                    # mistaken for the original send's.
                    from p2pmicrogrid_tpu_torch.telemetry.tracing import bump_hop

                    trace = bump_hop(trace)

    async def close(self) -> None:
        for i, conn in enumerate(self._conns):
            if conn is not None:
                await conn.close()
                self._conns[i] = None


# -- client: synchronous probe connection --------------------------------------


class SyncMuxProbe:
    """One persistent framed connection for SYNCHRONOUS health probing.

    The router's prober runs on a plain thread (serve/router.py), so it
    cannot ride the asyncio ``MuxPool``; before this class each ``/readyz``
    sweep opened a fresh HTTP connection per replica — with TLS, a full
    handshake per replica per sweep (ROADMAP item-1 follow-on: fine at
    N=3, ruinous at N=100). This is the sync counterpart: one blocking
    socket per (prober, replica) that stays up ACROSS sweeps and carries
    one ``GET /readyz`` frame per probe over the replica's mux listener.

    Failure semantics match what a probe must detect: connect failure,
    reset, EOF, a protocol error, or a response that never arrives within
    ``timeout_s`` (the half-open case — a SIGKILLed peer never FINs) all
    raise ``OSError``-family errors; the caller scores the probe failed
    and ``close()``s, and the next sweep reconnects. The probe path is
    sequential (one frame in flight), so ids only guard against a stale
    late answer after a timeout: mismatched ids are drained, never
    returned.
    """

    def __init__(
        self,
        host: str,
        port: int,
        ssl_context=None,
        timeout_s: float = 2.0,
        max_frame_bytes: int = MAX_FRAME_BYTES,
    ):
        import socket

        self.host = host
        self.port = port
        self.ssl_context = ssl_context
        self.timeout_s = timeout_s
        self.max_frame_bytes = max_frame_bytes
        self._sock = None
        self._next_id = 0
        self.connects = 0
        self._socket_mod = socket

    @property
    def connected(self) -> bool:
        return self._sock is not None

    def _connect(self):
        sock = self._socket_mod.create_connection(
            (self.host, self.port), timeout=self.timeout_s
        )
        if self.ssl_context is not None:
            sock = self.ssl_context.wrap_socket(
                sock, server_hostname=self.host
            )
        sock.settimeout(self.timeout_s)
        self._sock = sock
        self.connects += 1

    def _recv_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self._sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionResetError("mux probe connection closed")
            buf += chunk
        return buf

    def request(self, path: str, method: str = "GET", token=None):
        """(status, body doc | None) for one frame; raises OSError-family
        on any transport/protocol/timeout failure (the connection is
        closed by then — the next call reconnects)."""
        try:
            if self._sock is None:
                self._connect()
            rid = self._next_id
            self._next_id += 1
            frame: dict = {"id": rid, "method": method, "path": path}
            if token is not None:
                frame["token"] = token
            self._sock.sendall(encode_frame(frame))
            while True:
                prefix = self._recv_exact(_LEN_BYTES)
                length = int.from_bytes(prefix, "big")
                if length > self.max_frame_bytes:
                    raise WireProtocolError(
                        f"frame of {length} bytes exceeds the "
                        f"{self.max_frame_bytes}-byte cap"
                    )
                raw = self._recv_exact(length) if length else b""
                try:
                    doc = json.loads(raw.decode())
                except (UnicodeDecodeError, json.JSONDecodeError) as err:
                    raise WireProtocolError(
                        f"frame is not valid JSON: {err}"
                    ) from None
                if not isinstance(doc, dict):
                    raise WireProtocolError("frame must be a JSON object")
                if doc.get("id") != rid:
                    continue  # stale answer from a timed-out earlier probe
                status = doc.get("status")
                if not isinstance(status, int):
                    raise WireProtocolError("response frame carries no status")
                body = doc.get("body")
                return status, body if isinstance(body, dict) else None
        except (OSError, WireProtocolError):
            # One failure poisons the stream position — close so the next
            # probe reconnects instead of parsing mid-frame garbage.
            self.close()
            raise

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None


# -- server: shared mux accept-loop body --------------------------------------


def _mux_fault_scope(path: str) -> str:
    if path == "/v1/act":
        return "act"
    if path in ("/healthz", "/readyz"):
        return "health"
    return "other"


async def serve_mux_connection(
    reader: asyncio.StreamReader,
    writer: asyncio.StreamWriter,
    route,
    max_frame_bytes: int = MAX_FRAME_BYTES,
    fault_decide=None,
    on_fault: Optional[Callable[[object], None]] = None,
) -> None:
    """Serve one client's framed connection until EOF/protocol error.

    ``route(method, path, body_doc, token)`` is an awaitable returning
    ``(status, payload_dict, extra_headers)`` — the gateway and the router
    proxy each bind their own. A route that also declares a ``trace``
    parameter receives the frame's encoded trace context
    (``trace=<str|None>``, telemetry/tracing.py); 4-arg routes keep
    working untraced, so the wire upgrade never breaks a deployed
    handler. Every frame dispatches CONCURRENTLY (its own task),
    responses interleave by id — the multiplexing. Protocol errors
    answer one ``{"id": null, "status": 400}`` frame, then close.

    ``fault_decide(scope)`` (serve/faults.py ``FaultInjector.decide``)
    applies the chaos kinds at the wire: stall delays the response, error
    answers 500, corrupt garbles the response body detectably, drop
    aborts the whole connection (a vanished process severs every stream
    it carried — exactly what SIGKILL looks like to a mux client).
    """
    write_lock = asyncio.Lock()
    tasks: set = set()
    # Signature sniff ONCE per connection, not per frame: trace-aware
    # routes opt in by declaring the parameter; everything else (including
    # the test suite's minimal 4-arg stubs) stays untraced.
    try:
        route_takes_trace = "trace" in inspect.signature(route).parameters
    except (TypeError, ValueError):
        route_takes_trace = False

    async def send(doc: dict) -> None:
        # A client that vanished mid-exchange (disconnect, drop-fault
        # abort) has nothing to tell: swallowing the write failure here
        # keeps the handler tasks from completing exceptional and
        # logging "Task exception was never retrieved" at teardown; the
        # read loop sees the EOF and winds the connection down.
        try:
            async with write_lock:
                if writer.transport.is_closing():
                    return  # a TLS transport closed twice raises from write()
                writer.write(encode_frame(doc))
                await writer.drain()
        except (ConnectionError, OSError):
            pass

    async def handle(
        rid: int, method: str, path: str, body, token, trace=None
    ) -> None:
        fault = fault_decide(_mux_fault_scope(path)) if fault_decide else None
        if fault is not None:
            if on_fault is not None:
                on_fault(fault)
            if fault.kind == "drop":
                transport = writer.transport
                if transport is not None:
                    transport.abort()
                return
            if fault.kind == "stall":
                await asyncio.sleep(fault.stall_s)
        if fault is not None and fault.kind == "error":
            await send({"id": rid, "status": 500,
                        "body": {"error": "injected fault"}})
            return
        if route_takes_trace:
            status, payload, extra = await route(
                method, path, body, token, trace=trace
            )
        else:
            status, payload, extra = await route(method, path, body, token)
        doc: dict = {"id": rid, "status": status, "body": payload}
        if trace is not None:
            doc["trace"] = trace  # echo: responses stay attributable
        for name, value in extra or ():
            if str(name).lower() == "retry-after":
                try:
                    doc["retry_after_s"] = float(value)
                except (TypeError, ValueError):
                    pass
        if fault is not None and fault.kind == "corrupt":
            doc["body"] = CORRUPT_BODY  # non-object: detectably corrupt
        await send(doc)

    try:
        while True:
            try:
                frame = await read_frame(
                    reader, max_frame_bytes, drain_oversize=True
                )
            except FrameTooLarge as err:
                # The oversized frame was drained — the stream is still
                # at a boundary. Answer 413 (the frame's id was inside
                # the discarded payload) and KEEP the connection: one
                # client's fat request must not sever every other
                # request multiplexed here (the HTTP wire answers the
                # identical input with a clean terminal 413 too).
                await send({"id": None, "status": 413,
                            "body": {"error": str(err)}})
                continue
            except (WireProtocolError, asyncio.IncompleteReadError) as err:
                try:
                    await send({"id": None, "status": 400,
                                "body": {"error": str(err)}})
                except (ConnectionError, OSError):
                    pass
                break
            if frame is None:
                break
            rid = frame.get("id")
            if not isinstance(rid, int) or isinstance(rid, bool):
                await send({"id": None, "status": 400,
                            "body": {"error": "frame carries no integer id"}})
                break
            method = frame.get("method", "POST")
            path = frame.get("path")
            body = frame.get("body")
            token = frame.get("token")
            # Tolerant by design: a malformed trace field downgrades the
            # request to untraced, it never fails the frame.
            trace = frame.get("trace")
            if not isinstance(trace, str):
                trace = None
            if not isinstance(path, str):
                await send({"id": rid, "status": 400,
                            "body": {"error": "frame carries no path"}})
                continue
            if body is not None and not isinstance(body, dict):
                await send({"id": rid, "status": 400,
                            "body": {"error": "body must be an object"}})
                continue
            if token is not None and not isinstance(token, str):
                await send({"id": rid, "status": 400,
                            "body": {"error": "token must be a string"}})
                continue
            task = asyncio.ensure_future(
                handle(rid, str(method).upper(), path, body, token, trace)
            )
            tasks.add(task)
            task.add_done_callback(tasks.discard)
    except (ConnectionError, OSError):
        pass
    finally:
        for task in list(tasks):
            task.cancel()
        if tasks:
            await asyncio.gather(*tasks, return_exceptions=True)
