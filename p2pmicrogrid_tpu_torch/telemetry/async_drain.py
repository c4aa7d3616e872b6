"""Non-blocking host readback for episode pipelines (the async drain).

The port of the JAX package's ``telemetry/async_drain.py``. A driver that
reads each episode's outputs back right after launching it leaves the card
idle for the host round trip between episodes. ``AsyncDrain`` launches
episode *e+1* before consuming episode *e*'s outputs, whose copies to the host
were started when *e* was pushed:

* ``start_host_copy`` copies every CUDA tensor of a payload into pinned host
  memory with ``non_blocking=True`` on the current stream (the stream the
  episode's work ran on, a graph replay's included) and records one CUDA
  event after the copies. Each copy is ordered after the work that wrote its
  source and before any later work on that stream, so a buffer that the
  next replay overwrites is read first. CPU tensors are copied at once (the
  learner state updates in place).
* ``resolve_host`` waits on that event alone and returns numpy values.

Semantics, as in the JAX package:

* ``depth`` is the software-pipeline depth: ``depth=2`` holds one episode
  in flight; ``depth=1`` is the synchronous driver on the same code path.
* Consumption is FIFO: lagged callbacks see the episodes in order, with the
  values the synchronous driver would see. Only the timing moves; the launch
  order, and so the final learner state, is the same.
* With a ``Telemetry``: a ``train.dispatch_gap_ms`` histogram point per
  push, a ``pipeline_dispatch``/``pipeline_drain`` span pair per episode,
  and, at ``finish()``, ``train.host_blocked_fraction`` (the share of the
  loop's wall time spent waiting on the card) and ``train.pipeline_depth``.
"""

from __future__ import annotations

import contextlib
import time
from collections import deque
from typing import Callable, Optional

import torch


class _HostCopy:
    """A payload's host copies in flight: the tree with each tensor replaced
    by its pinned (or CPU) copy, and the event that marks them done."""

    def __init__(self, tree, event):
        self.tree = tree
        self.event = event


def _map(fn, tree):
    if torch.is_tensor(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [_map(fn, x) for x in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)
    return tree


def start_host_copy(tree) -> _HostCopy:
    """Start device-to-host copies of every tensor of ``tree`` without
    blocking; non-tensor leaves pass through."""
    on_card = []

    def copy(x):
        x = x.detach()
        if x.device.type != "cuda":
            return x.clone()
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x, non_blocking=True)
        on_card.append(x)
        return host

    copied = _map(copy, tree)
    event = None
    if on_card:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(on_card[0].device))
    return _HostCopy(copied, event)


def resolve_host(pending: _HostCopy):
    """The payload of ``start_host_copy`` as host numpy values: waits on the
    copies' event only (the pipeline's one blocking readback)."""
    if pending.event is not None:
        pending.event.synchronize()
    return _map(lambda x: x.numpy(), pending.tree)


class AsyncDrain:
    """Depth-N software pipeline over per-episode device outputs.

    ``push(tag, payload, consume)`` starts host copies of ``payload`` and
    queues it; once ``depth`` items are pending, the oldest is drained: its
    payload resolved to numpy and ``consume(tag, host_payload)`` run.
    ``flush()`` drains everything; ``finish()`` flushes and publishes the
    pipeline gauges.
    """

    def __init__(self, depth: int = 2, telemetry=None):
        if depth < 1:
            raise ValueError(f"pipeline depth must be >= 1, got {depth}")
        self.depth = depth
        self.telemetry = telemetry
        self._pending: deque = deque()
        self._last_dispatch: Optional[float] = None
        self._blocked_s = 0.0
        self._t0 = time.perf_counter()
        self._finished = False

    def dispatch_span(self, **meta):
        """Span for the launch of one episode (pairs with the
        ``pipeline_drain`` span of the same episode)."""
        if self.telemetry is None:
            return contextlib.nullcontext()
        return self.telemetry.span("pipeline_dispatch", **meta)

    def push(self, tag, payload, consume: Callable) -> None:
        """Queue one episode's outputs; drain whatever the depth allows."""
        now = time.perf_counter()
        if self.telemetry is not None and self._last_dispatch is not None:
            self.telemetry.histogram("train.dispatch_gap_ms", (now - self._last_dispatch) * 1e3)
        self._last_dispatch = now
        self._pending.append((tag, start_host_copy(payload), consume))
        while len(self._pending) >= self.depth:
            self._drain_one()

    def _drain_one(self) -> None:
        tag, pending, consume = self._pending.popleft()
        span = (
            self.telemetry.span("pipeline_drain", tag=tag)
            if self.telemetry is not None
            else contextlib.nullcontext()
        )
        t0 = time.perf_counter()
        with span:
            host = resolve_host(pending)
        self._blocked_s += time.perf_counter() - t0
        consume(tag, host)

    def flush(self) -> None:
        """Drain every pending episode, in push order."""
        while self._pending:
            self._drain_one()

    @property
    def host_blocked_fraction(self) -> float:
        total = time.perf_counter() - self._t0
        return self._blocked_s / total if total > 0 else 0.0

    def finish(self) -> float:
        """Flush, publish the pipeline gauges, return the blocked fraction."""
        self.flush()
        frac = self.host_blocked_fraction
        if not self._finished and self.telemetry is not None:
            self._finished = True
            self.telemetry.gauge("train.host_blocked_fraction", round(frac, 4))
            self.telemetry.gauge("train.pipeline_depth", self.depth)
        return frac
