"""Fleet-wide trace context: deterministic ids, wire encoding, span records.

A copy of the JAX package's ``telemetry/tracing.py`` (the serving fronts
and the gateway of ``serve/`` record their spans through it).

One request entering the serving fleet crosses three processes on the
happy path (client/router -> proxy -> replica gateway) and more under
failover — and before this module every span died inside the process
that emitted it. ``TraceContext`` is the propagated identity that stitches
them back together:

* ``trace_id``        128-bit hex (32 chars), one per client request,
                      derived deterministically from the loadgen seed +
                      request index (``root_context``) so chaos captures
                      replay bit-identically.
* ``span_id``         64-bit hex (16 chars), one per operation. Child ids
                      derive from sha256(trace_id:parent_span:name) —
                      also deterministic, so two replays of the same
                      schedule produce byte-identical trees.
* ``parent_span_id``  links the tree; ``None`` marks the root span.
* ``hop``             mux-replay retry-hop counter: ``MuxPool`` replays an
                      idempotent request once after a reconnect, and the
                      replayed frame carries hop+1 so the warehouse tree
                      shows WHICH delivery of the request each server span
                      belongs to.

Wire encoding (one string, HTTP header ``x-p2p-trace`` and the mux frame's
``trace`` field alike)::

    <trace_id 32 hex>-<span_id 16 hex>-<hop 2 hex>

``decode`` is tolerant: malformed values return ``None`` and the request
proceeds untraced — a bad header must never fail a request.

Spans are plain telemetry events (``kind="trace_span"``) with epoch-anchored
start timestamps; ``SqliteSink`` routes them into the results store's
``trace_spans`` table (``data/results.py``).

Stdlib-only and import-light on purpose: this module sits on every serving
hot path and must not pull in numpy or torch.
"""

from __future__ import annotations

import hashlib
import os
import uuid
from dataclasses import dataclass, replace
from typing import Optional

# The one propagation key, both fronts: HTTP header name (lower-cased by
# the gateway's header parser) and — the same encoded value — the mux
# frame's "trace" field (serve/wire.py).
TRACE_HEADER = "x-p2p-trace"

_TRACE_ID_LEN = 32  # 128-bit
_SPAN_ID_LEN = 16   # 64-bit


def _hex_digest(material: str, length: int) -> str:
    return hashlib.sha256(material.encode()).hexdigest()[:length]


@dataclass(frozen=True)
class TraceContext:
    """One propagated trace position: where in which tree, which delivery."""

    trace_id: str
    span_id: str
    parent_span_id: Optional[str] = None
    hop: int = 0

    def encode(self) -> str:
        """The wire form (header value / mux frame field)."""
        return f"{self.trace_id}-{self.span_id}-{self.hop:02x}"

    def child(self, name: str) -> "TraceContext":
        """A child context whose span_id derives deterministically from
        this position + ``name``. Callers qualify non-unique names
        (``f"attempt{tries}"``, ``f"row{i}"``) — same name under the same
        parent means same id, which is the replay-determinism contract,
        not a bug."""
        span_id = _hex_digest(
            f"{self.trace_id}:{self.span_id}:{name}", _SPAN_ID_LEN
        )
        return TraceContext(
            trace_id=self.trace_id,
            span_id=span_id,
            parent_span_id=self.span_id,
            hop=self.hop,
        )

    def with_hop(self, hop: int) -> "TraceContext":
        return replace(self, hop=int(hop))


def root_context(seed: int, index: int) -> TraceContext:
    """The deterministic root of request ``index`` under loadgen ``seed`` —
    two runs of the same schedule produce identical trace_ids, so a chaos
    capture's trees can be re-queried by id across replays."""
    trace_id = _hex_digest(f"p2p-trace:{seed}:{index}", _TRACE_ID_LEN)
    span_id = _hex_digest(f"p2p-span:{seed}:{index}", _SPAN_ID_LEN)
    return TraceContext(trace_id=trace_id, span_id=span_id)


def new_span_id() -> str:
    """A random span id for UNTRACED requests: serve_request/serve_decision
    events always carry a request_id (data/trace_export.py joins by it),
    even when no trace context arrived on the wire."""
    return uuid.uuid4().hex[:_SPAN_ID_LEN]


def decode(value) -> Optional[TraceContext]:
    """Parse a wire-encoded context; ``None`` on anything malformed (an
    unparseable header downgrades the request to untraced, never fails it).
    The decoded context's parent is unknown on this side of the wire —
    the SENDER recorded the parent linkage; this position is the base
    further children hang from."""
    if not isinstance(value, str):
        return None
    parts = value.strip().split("-")
    if len(parts) != 3:
        return None
    trace_id, span_id, hop_hex = parts
    if len(trace_id) != _TRACE_ID_LEN or len(span_id) != _SPAN_ID_LEN:
        return None
    try:
        int(trace_id, 16)
        int(span_id, 16)
        hop = int(hop_hex, 16)
    except ValueError:
        return None
    return TraceContext(trace_id=trace_id, span_id=span_id, hop=hop)


def bump_hop(encoded: str) -> str:
    """The same encoded context one delivery later (``MuxPool`` stamps the
    replayed frame with this so server spans distinguish the original send
    from the post-reconnect replay). Malformed input passes through
    unchanged — replay must not fail on a bad trace field."""
    ctx = decode(encoded)
    if ctx is None:
        return encoded
    return ctx.with_hop(ctx.hop + 1).encode()


def process_label() -> str:
    """This process's identity in span records (one Perfetto lane per
    process in the merged export): role when a serving component set one,
    pid always."""
    role = os.environ.get("P2P_SERVE_ROLE") or ""
    pid = os.getpid()
    return f"{role}:{pid}" if role else f"pid:{pid}"


def record_span(
    tel,
    ctx: Optional[TraceContext],
    name: str,
    start_ts: float,
    duration_s: float,
    **attrs,
) -> None:
    """Emit one completed span as a telemetry event (``kind="trace_span"``;
    SqliteSink routes these into the warehouse's ``trace_spans`` table).
    ``start_ts`` is EPOCH seconds — cross-process trees only line up on a
    shared clock, so the per-process perf_counter origin the in-process
    span recorder uses is not enough here. No-op without a telemetry or a
    context: tracing off must cost nothing but this check."""
    if tel is None or ctx is None:
        return
    tel.event(
        "trace_span",
        trace_id=ctx.trace_id,
        span_id=ctx.span_id,
        parent_span_id=ctx.parent_span_id,
        name=name,
        start_ts=round(float(start_ts), 6),
        duration_s=round(float(duration_s), 6),
        process=process_label(),
        **attrs,
    )
