"""Nested timing spans with Chrome-trace export and NVTX ranges.

The port of the JAX package's ``telemetry/spans.py``. A span is a named
wall-clock interval; spans nest through a stack, so ``with tel.span("episode"):
... with tel.span("eval"): ...`` records the eval as a child of the episode.
Two export paths:

* ``chrome_trace()`` — the Chrome trace-event JSON format ("X" complete
  events), loadable in ``chrome://tracing`` or Perfetto.
* NVTX — on a CUDA build with a card, each span also opens an NVTX range of
  the same name (``torch.cuda.nvtx``), so the spans appear in an Nsight
  capture taken around them.

Timing discipline: the card runs asynchronously, so a span that should
measure device execution must close after a synchronisation; a span around
an unsynchronised launch measures the host's launch time only.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import Optional

import torch


@dataclass
class Span:
    """One completed (or open) timing interval."""

    name: str
    start: float                 # perf_counter seconds
    depth: int                   # nesting level at open time
    end: Optional[float] = None
    meta: dict = field(default_factory=dict)

    @property
    def duration(self) -> Optional[float]:
        return None if self.end is None else self.end - self.start


def _nvtx_on() -> bool:
    """NVTX ranges only where a card is present (a CPU build of torch has
    no NVTX library)."""
    return torch.cuda.is_available()


class SpanRecorder:
    """Records nested spans; completed spans are kept in completion order."""

    def __init__(self):
        self._perf0 = time.perf_counter()
        self._epoch0 = time.time()
        self._stack: list = []
        self.completed: list = []
        self._nvtx = _nvtx_on()

    @contextlib.contextmanager
    def span(self, name: str, **meta):
        if self._nvtx:
            torch.cuda.nvtx.range_push(name)
        s = Span(name=name, start=time.perf_counter(), depth=len(self._stack), meta=meta)
        self._stack.append(s)
        try:
            yield s
        finally:
            s.end = time.perf_counter()
            self._stack.pop()
            self.completed.append(s)
            if self._nvtx:
                torch.cuda.nvtx.range_pop()

    def duration(self, name: str) -> Optional[float]:
        """Duration of the most recently completed span with ``name``."""
        for s in reversed(self.completed):
            if s.name == name:
                return s.duration
        return None

    def totals(self) -> dict:
        """{name: {count, total_s}} over all completed spans."""
        out: dict = {}
        for s in self.completed:
            e = out.setdefault(s.name, {"count": 0, "total_s": 0.0})
            e["count"] += 1
            e["total_s"] += s.duration or 0.0
        for e in out.values():
            e["total_s"] = round(e["total_s"], 6)
        return out

    def chrome_trace(self) -> dict:
        """Chrome trace-event JSON ("X" complete events, microsecond grid),
        epoch-anchored so the trace aligns with other captures of the run."""
        pid = os.getpid()
        events = []
        for s in self.completed:
            if s.end is None:
                continue
            events.append({
                "name": s.name,
                "ph": "X",
                "ts": (self._epoch0 + (s.start - self._perf0)) * 1e6,
                "dur": (s.end - s.start) * 1e6,
                "pid": pid,
                "tid": 1,
                "args": {k: repr(v) for k, v in s.meta.items()},
            })
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def write_chrome_trace(self, path: str) -> None:
        import json

        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
