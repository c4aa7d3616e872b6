"""Run-scoped telemetry registry: counters, gauges, histograms and sinks.

The port of the JAX package's ``telemetry/registry.py``: the one funnel every
training surface reports through.

* ``Telemetry``    one object per run: aggregates (counters, gauges,
                   histograms), nested timing spans (``spans.SpanRecorder``),
                   a run manifest, and the sinks every event reaches.
* sinks            ``JsonlSink`` (one JSON object per line, append),
                   ``StdoutSink`` (single-line JSON on stdout), ``MemorySink``
                   (tests), and ``guarded_stdout_sink`` (fd-level stdout
                   hygiene: stray writes from native libraries go to stderr
                   so only metric lines reach stdout), and ``SqliteSink``
                   (the results store's telemetry warehouse,
                   ``data/results.py``; the run row carries this port's
                   torch manifest).

Run directories live under ``artifacts/runs/<run_id>/`` and contain:

* ``manifest.json``   device facts from torch, config hash, git rev, argv,
                      versions (written at creation).
* ``metrics.jsonl``   every event, one JSON object per line, each with
                      ``ts`` (epoch seconds) and ``kind``.
* ``summary.json``    counter totals, last gauges, histogram stats and span
                      totals (written by ``close()``).
* ``trace.json``      Chrome-trace export of the spans (written by
                      ``close()``).

Environment knobs: ``P2P_TELEMETRY=0`` disables ``maybe_create``,
``P2P_TELEMETRY_DIR`` overrides the default ``artifacts/runs`` root.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import sys
import time
from typing import Callable, Optional

from p2pmicrogrid_tpu_torch.telemetry.spans import SpanRecorder

DEFAULT_ROOT = os.path.join("artifacts", "runs")

# Events may carry numpy scalars or 0-d tensors; the encoder must not crash the run.
def _json_default(o):
    try:
        return float(o)
    except (TypeError, ValueError):
        return repr(o)


def _dumps(record: dict) -> str:
    return json.dumps(record, default=_json_default)


class JsonlSink:
    """Append one JSON object per line to ``path`` (created on first emit)."""

    def __init__(self, path: str):
        self.path = path
        self._f = None

    def emit(self, record: dict) -> None:
        if self._f is None:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            self._f = open(self.path, "a", buffering=1)
        self._f.write(_dumps(record) + "\n")

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


class StdoutSink:
    """Single-line JSON records on stdout (the bench contract).

    ``write`` overrides the destination with any ``str -> None`` callable —
    ``guarded_stdout_sink`` binds it to a duplicated stdout fd so metric
    lines bypass Python-level stream redirection entirely.
    """

    def __init__(self, write: Optional[Callable[[str], None]] = None):
        self._write = write

    def emit(self, record: dict) -> None:
        line = _dumps(record)
        if self._write is not None:
            self._write(line + "\n")
        else:
            print(line, flush=True)

    def close(self) -> None:
        pass


class MemorySink:
    """Collects records in a list (tests)."""

    def __init__(self):
        self.records: list = []

    def emit(self, record: dict) -> None:
        self.records.append(record)

    def close(self) -> None:
        pass


class SqliteSink:
    """Stream telemetry into the results store's warehouse tables.

    Events become ``telemetry_points`` rows (one per record; ``metric``
    rows from the bench suites keep their metric name/value as the point's
    name/value), ``close()``-time aggregates explode into ``counter``/
    ``gauge``/``histogram`` points, and completed spans land in
    ``telemetry_spans`` — all keyed by the run's manifest identity row in
    ``telemetry_runs`` (config_hash/git_rev), so ONE SQL join links a run's
    telemetry to the eval/bench rows living in the same SQLite file
    (``data/results.py:TELEMETRY_JOIN_SQL``).

    Inserts are buffered and written in batches (``executemany`` every
    ``batch`` records and on close); the connection runs in WAL mode and is
    lock-guarded, so the serve engine's microbatch worker thread can emit
    concurrently with the main thread.

    ``shard_id`` names the warehouse shard this sink writes: at fleet scale every replica binds its OWN WAL-mode SQLite file
    instead of funneling through one DB, and the identity rides the run
    manifest (``manifest_json.shard_id``) so a federated merge
    (``data/results.py:merge_warehouse_shards``) can attribute every run
    to the shard that wrote it. ``None`` (the default) keeps the
    single-funnel behavior unchanged.
    """

    def __init__(self, path: str, batch: int = 64, shard_id: Optional[str] = None):
        import threading

        self.path = path
        self.shard_id = shard_id
        self.batch = max(1, int(batch))
        self._con = None
        self._lock = threading.Lock()
        self._run_id: Optional[str] = None
        self._manifest: dict = {}
        self._seq = 0
        self._span_seq = 0
        self._points: list = []
        self._trace_seq = 0
        self._trace_rows: list = []
        self._registered = False

    # -- wiring -------------------------------------------------------------

    def _connect(self):
        if self._con is None:
            import sqlite3

            from p2pmicrogrid_tpu_torch.data.results import ensure_telemetry_schema

            # check_same_thread off: emits may arrive from the microbatch
            # worker thread; every access below holds self._lock.
            self._con = sqlite3.connect(self.path, check_same_thread=False)
            self._con.execute("PRAGMA journal_mode=WAL")
            ensure_telemetry_schema(self._con)
        return self._con

    def register_run(self, run_id: str, manifest: dict) -> None:
        """Bind this sink to a run identity (called by ``Telemetry`` on
        attach; re-registering upserts, so a manifest annotated mid-run —
        e.g. with the mesh shape — refreshes its row on close)."""
        self._run_id = run_id
        self._manifest = dict(manifest or {})
        if self.shard_id is not None:
            self._manifest.setdefault("shard_id", self.shard_id)
        with self._lock:
            self._write_run_row()

    def _write_run_row(self) -> None:
        m = self._manifest
        con = self._connect()
        with con:
            con.execute(
                "INSERT OR REPLACE INTO telemetry_runs VALUES "
                "(?,?,?,?,?,?,?,?,?,?,?,?)",
                (
                    self._run_id or "run",
                    m.get("created"),
                    m.get("config_hash"),
                    m.get("git_rev"),
                    m.get("setting"),
                    m.get("backend"),
                    m.get("device_kind"),
                    m.get("device_count"),
                    m.get("process_count"),
                    _dumps(m["mesh_shape"]) if "mesh_shape" in m else None,
                    _dumps(m["mesh_axis_names"])
                    if "mesh_axis_names" in m else None,
                    _dumps(m),
                ),
            )
        self._registered = True

    # -- event stream -------------------------------------------------------

    @staticmethod
    def _point_of(record: dict):
        """(kind, name, value, attrs) split of one emitted record."""
        rec = dict(record)
        ts = rec.pop("ts", None)
        if "metric" in rec and "value" in rec:
            # Bench/serve metric rows (no 'kind'): queryable by metric name.
            kind = rec.pop("kind", "metric")
            name = rec.pop("metric")
            value = rec.pop("value")
        else:
            kind = rec.pop("kind", "event")
            name = rec.pop("name", None)
            value = rec.pop("value", None)
        try:
            value = None if value is None else float(value)
        except (TypeError, ValueError):
            rec["value"] = value
            value = None
        return ts, kind, name, value, rec

    def emit(self, record: dict) -> None:
        if record.get("kind") == "summary":
            # close() streams the monolithic summary event to every sink,
            # then hands this sink the SAME aggregates via write_summary's
            # typed explosion — storing the blob too would duplicate every
            # aggregate as one unqueryable attrs_json row.
            return
        if record.get("kind") == "trace_span":
            # Distributed-trace spans (telemetry/tracing.py) land in the
            # dedicated trace_spans table: trace/span/parent ids and the
            # epoch start become real columns (TRACE_TREE_SQL filters and
            # time-orders on them), not attrs_json payload.
            rec = dict(record)
            rec.pop("ts", None)
            rec.pop("kind", None)
            row = (
                self._run_id or "run", self._trace_seq,
                str(rec.pop("trace_id", "")), str(rec.pop("span_id", "")),
                rec.pop("parent_span_id", None), str(rec.pop("name", "")),
                rec.pop("start_ts", None), rec.pop("duration_s", None),
                rec.pop("process", None), _dumps(rec) if rec else None,
            )
            with self._lock:
                self._trace_rows.append(row)
                self._trace_seq += 1
                if len(self._trace_rows) >= self.batch:
                    try:
                        self._flush_locked()
                    except Exception as err:  # noqa: BLE001 — mirror emit()
                        self._points = []
                        self._trace_rows = []
                        if not getattr(self, "_flush_warned", False):
                            self._flush_warned = True
                            print(
                                f"SqliteSink: dropping telemetry points "
                                f"({type(err).__name__}: {err})",
                                file=sys.stderr,
                            )
            return
        ts, kind, name, value, attrs = self._point_of(record)
        with self._lock:
            self._points.append(
                (
                    self._run_id or "run", self._seq, ts, str(kind), name,
                    value, _dumps(attrs) if attrs else None,
                )
            )
            self._seq += 1
            if len(self._points) >= self.batch:
                # A flush failure (locked/full DB) must not take down the
                # instrumented run: drop the batch, warn once, keep going —
                # close() retries whatever accumulates after.
                try:
                    self._flush_locked()
                except Exception as err:  # noqa: BLE001
                    self._points = []
                    if not getattr(self, "_flush_warned", False):
                        self._flush_warned = True
                        print(
                            f"SqliteSink: dropping telemetry points "
                            f"({type(err).__name__}: {err})",
                            file=sys.stderr,
                        )

    def _flush_locked(self) -> None:
        if not self._registered:
            self._write_run_row()
        if not self._points and not self._trace_rows:
            return
        points = self._points
        if points:
            # Ingest-lag gauge: the oldest event in this
            # batch waited (commit time - event ts) to become queryable —
            # the staleness bound every warehouse reader (the canary's
            # per-stage attribution above all) actually sees. Recorded as
            # one extra point per flush, directly (not via emit: that
            # would re-enter the buffer this flush is draining). Kind
            # "sink_gauge", not "gauge": sink-internal health points must
            # not inflate a run's user-gauge counts/rollups.
            batch_ts = [p[2] for p in points if p[2] is not None]
            if batch_ts:
                now = time.time()
                lag_ms = max(0.0, (now - min(batch_ts)) * 1e3)
                points = points + [(
                    self._run_id or "run", self._seq, round(now, 3),
                    "sink_gauge", "telemetry.ingest_lag_ms", round(lag_ms, 3),
                    None,
                )]
                self._seq += 1
        con = self._connect()
        with con:
            # Plain INSERT: a (run_id, seq) collision means two runs share an
            # id — raising (surfaced as the one-time drop warning in emit)
            # beats OR REPLACE silently interleaving their rows.
            if points:
                con.executemany(
                    "INSERT INTO telemetry_points VALUES (?,?,?,?,?,?,?)",
                    points,
                )
            if self._trace_rows:
                con.executemany(
                    "INSERT INTO trace_spans VALUES (?,?,?,?,?,?,?,?,?,?)",
                    self._trace_rows,
                )
        self._points = []
        self._trace_rows = []

    # -- close-time aggregates (called by Telemetry.close) -------------------

    def write_summary(self, summary: dict) -> None:
        """Explode the run's final aggregates into queryable points."""
        ts = round(time.time(), 3)
        for name, v in summary.get("counters", {}).items():
            self.emit({"ts": ts, "kind": "counter", "name": name, "value": v})
        for name, v in summary.get("gauges", {}).items():
            self.emit({"ts": ts, "kind": "gauge", "name": name, "value": v})
        for name, stats in summary.get("histograms", {}).items():
            self.emit(
                {"ts": ts, "kind": "histogram", "name": name,
                 "value": stats.get("p50"), **stats}
            )
        for name, per_bucket in summary.get("exemplars", {}).items():
            # One point per (histogram, log2 bucket) exemplar: value is the
            # bucket's max sample, attrs carry the trace_id it links to —
            # SLOWEST_TRACES_SQL orders these by value to answer
            # ``telemetry-query --slowest``.
            for bucket, ex in per_bucket.items():
                self.emit(
                    {"ts": ts, "kind": "hist_exemplar", "name": name,
                     "value": ex.get("value"), "bucket": bucket,
                     "trace_id": ex.get("trace_id")}
                )

    def write_spans(self, recorder) -> None:
        """Persist every completed span (``spans.SpanRecorder``)."""
        rows = []
        perf0 = getattr(recorder, "_perf0", 0.0)
        for s in recorder.completed:
            if s.end is None:
                continue
            rows.append(
                (
                    self._run_id or "run", self._span_seq, s.name,
                    round(s.start - perf0, 6), round(s.end - s.start, 6),
                    s.depth, _dumps(s.meta) if s.meta else None,
                )
            )
            self._span_seq += 1
        if not rows:
            return
        with self._lock:
            if not self._registered:
                self._write_run_row()
            try:
                con = self._connect()
                with con:
                    con.executemany(
                        "INSERT INTO telemetry_spans VALUES (?,?,?,?,?,?,?)",
                        rows,
                    )
            except Exception as err:  # noqa: BLE001 — close() must finish
                print(
                    f"SqliteSink: dropping telemetry spans "
                    f"({type(err).__name__}: {err})",
                    file=sys.stderr,
                )

    def flush(self) -> None:
        """Push buffered points to the warehouse NOW (the canary
        controller reads per-bundle attribution between live stages —
        serve/promotion.py — and must not race the 64-record batch
        buffer). Failures fall back to emit()'s drop-and-warn policy."""
        with self._lock:
            try:
                self._flush_locked()
            except Exception as err:  # noqa: BLE001 — mirror emit()
                self._points = []
                if not getattr(self, "_flush_warned", False):
                    self._flush_warned = True
                    print(
                        f"SqliteSink: dropping telemetry points "
                        f"({type(err).__name__}: {err})",
                        file=sys.stderr,
                    )

    def close(self) -> None:
        with self._lock:
            # Re-upsert the run row so late manifest annotations (mesh
            # shape, extra provenance) land in the warehouse.
            if self._run_id is not None:
                self._write_run_row()
            self._flush_locked()
            if self._con is not None:
                self._con.close()
                self._con = None
                self._registered = False


@contextlib.contextmanager
def guarded_stdout_sink():
    """fd-level stdout hygiene for metric emission.

    Duplicates the real stdout fd for the sink, then points BOTH fd 1 and
    the Python-level ``sys.stdout`` at stderr for the duration of the
    context: stray writes — Python prints AND fd-level noise from C++
    runtimes (the ``"d!\\n"`` fragments interleaved into BENCH_r05.json's
    capture) — land on stderr, while ``sink.emit`` writes complete
    single-line JSON records to the original stdout. The original stream/fd
    layout is restored on exit.
    """
    sys.stdout.flush()
    sys.stderr.flush()
    saved = os.dup(1)
    os.dup2(2, 1)
    prev_stdout = sys.stdout
    sys.stdout = sys.stderr

    def write_all(s: str) -> None:
        # os.write may short-write (EINTR, pipes); a truncated metric line
        # would break a reader's last-line JSON parse — loop to completion.
        view = memoryview(s.encode())
        while view:
            view = view[os.write(saved, view):]

    try:
        yield StdoutSink(write=write_all)
    finally:
        sys.stdout = prev_stdout
        os.dup2(saved, 1)
        os.close(saved)


# Process-wide "current run" handle: lets deep helpers (the bench measurement
# functions) record spans without threading a Telemetry through every
# signature. Falls back to a throwaway registry when none is set, so
# instrumented code needs no None-guards.
_CURRENT: list = []


def set_current(tel: Optional["Telemetry"]) -> None:
    _CURRENT[:] = [tel] if tel is not None else []


def current() -> "Telemetry":
    """The process-current Telemetry, or a fresh sink-less one (aggregates
    still work; nothing is persisted)."""
    if not _CURRENT:
        _CURRENT.append(Telemetry(run_id="ephemeral"))
    return _CURRENT[0]


def phase_timings(label: str, spans=None) -> dict:
    """Most recent ``compile:<label>`` / ``execute:<label>`` span durations
    as metric-row fields (``compile_s``/``execute_s``).

    The shared helper behind both benchmark suites' per-phase reporting
    (benchmarks.py rows and serve-bench's headline row): the measurement
    helpers bracket compile+first-run and pure-execution with those span
    names, and this turns them into row fields. ``spans`` overrides the
    process-current recorder (tests).
    """
    rec = spans if spans is not None else current().spans
    out = {}
    c = rec.duration(f"compile:{label}")
    e = rec.duration(f"execute:{label}")
    if c is not None:
        out["compile_s"] = round(c, 3)
    if e is not None:
        out["execute_s"] = round(e, 3)
    return out


def run_stamp() -> str:
    """The time+pid suffix shared by every run id (``Telemetry.create`` and
    the CLI's ad-hoc run ids must stay the same format)."""
    return f"{time.strftime('%Y%m%d-%H%M%S')}-{os.getpid()}"


def config_hash(cfg) -> str:
    """Stable short hash of a frozen ExperimentConfig (repr is deterministic
    for frozen dataclasses of scalars)."""
    return hashlib.sha256(repr(cfg).encode()).hexdigest()[:12]


def git_rev() -> Optional[str]:
    """Best-effort git revision of the working tree (None outside a repo)."""
    import subprocess

    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=10,
            cwd=os.path.dirname(os.path.abspath(__file__)),
        )
        return out.stdout.strip() or None
    except Exception:  # noqa: BLE001 — manifest must never crash the run
        return None


def run_manifest(cfg=None, extra: Optional[dict] = None) -> dict:
    """Device/config/provenance manifest for a run.

    The device facts come from torch: the backend (``cuda`` once the card
    is up, else ``cpu``), the card's name, the device count, the torch and
    CUDA versions. Initialises no device that is not already up: before the
    first CUDA call the manifest says ``cpu`` and names no card.
    """
    import torch

    m: dict = {
        "created": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
        "argv": list(sys.argv),
        "python": sys.version.split()[0],
        "git_rev": git_rev(),
        "backend": None,
        "device_kind": None,
        "device_count": None,
        "process_count": None,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
    }
    try:
        if torch.cuda.is_initialized():
            m["backend"] = "cuda"
            m["device_kind"] = torch.cuda.get_device_name(torch.cuda.current_device())
            m["device_count"] = torch.cuda.device_count()
        else:
            m["backend"] = "cpu"
            m["device_kind"] = "cpu"
            m["device_count"] = 1
        m["process_count"] = 1
    except Exception as err:  # noqa: BLE001 — the manifest must never crash the run
        m["backend_error"] = f"{type(err).__name__}: {err}"[:200]
    if cfg is not None:
        m["config_hash"] = config_hash(cfg)
        try:
            m["setting"] = cfg.setting
        except Exception:  # noqa: BLE001
            pass
    if extra:
        m.update(extra)
    return m


class Telemetry:
    """One run's metric registry: counters, gauges, histograms, spans, sinks.

    Aggregates live in memory and are flushed to ``summary.json`` by
    ``close()``; ``event()`` records are pushed to every sink immediately.
    """

    def __init__(
        self,
        run_id: str = "run",
        sinks=(),
        manifest: Optional[dict] = None,
        run_dir: Optional[str] = None,
    ):
        self.run_id = run_id
        self.run_dir = run_dir
        self.sinks = list(sinks)
        self.manifest = dict(manifest or {})
        self.spans = SpanRecorder()
        self._counters: dict = {}
        self._gauges: dict = {}
        self._hists: dict = {}
        # {hist name: {log2 bucket: (max value, trace_id)}} — distributed-
        # trace exemplars attached via histogram(..., trace_id=...).
        self._exemplars: dict = {}
        self._closed = False
        # Identity-aware sinks (any with ``register_run``) bind to the run
        # manifest here, so their records carry config_hash/git_rev.
        for sink in self.sinks:
            if hasattr(sink, "register_run"):
                sink.register_run(self.run_id, self.manifest)

    # --- creation -----------------------------------------------------------

    @classmethod
    def create(
        cls,
        name: str = "run",
        cfg=None,
        root: Optional[str] = None,
        extra_sinks=(),
        extra_manifest: Optional[dict] = None,
    ) -> "Telemetry":
        """Create a run directory under ``root`` (default ``artifacts/runs``,
        overridable via ``P2P_TELEMETRY_DIR``) with manifest + JSONL sink."""
        root = root or os.environ.get("P2P_TELEMETRY_DIR") or DEFAULT_ROOT
        run_id = f"{name}-{run_stamp()}"
        run_dir = os.path.join(root, run_id)
        os.makedirs(run_dir, exist_ok=True)
        manifest = run_manifest(cfg, extra=extra_manifest)
        manifest["run_id"] = run_id
        with open(os.path.join(run_dir, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=2, default=_json_default)
        sinks = [JsonlSink(os.path.join(run_dir, "metrics.jsonl"))]
        sinks.extend(extra_sinks)
        return cls(run_id=run_id, sinks=sinks, manifest=manifest, run_dir=run_dir)

    @classmethod
    def maybe_create(cls, name: str = "run", cfg=None, **kw) -> Optional["Telemetry"]:
        """``create`` unless telemetry is disabled (``P2P_TELEMETRY=0``)."""
        if os.environ.get("P2P_TELEMETRY", "").lower() in ("0", "off", "false"):
            return None
        return cls.create(name, cfg=cfg, **kw)

    def annotate_manifest(self, **fields) -> None:
        """Add identity fields discovered after creation (e.g. the mesh
        shape once a sharded program is built): updates the in-memory
        manifest, rewrites ``manifest.json`` and re-registers any
        identity-aware sinks."""
        self.manifest.update(fields)
        if self.run_dir:
            with open(os.path.join(self.run_dir, "manifest.json"), "w") as f:
                json.dump(self.manifest, f, indent=2, default=_json_default)
        for sink in self.sinks:
            if hasattr(sink, "register_run"):
                sink.register_run(self.run_id, self.manifest)

    # --- aggregates ---------------------------------------------------------

    def counter(self, name: str, inc=1) -> None:
        self._counters[name] = self._counters.get(name, 0) + inc

    def gauge(self, name: str, value) -> None:
        self._gauges[name] = value

    def histogram(self, name: str, value, trace_id: Optional[str] = None) -> None:
        value = float(value)
        self._hists.setdefault(name, []).append(value)
        if trace_id is not None:
            # One exemplar per log2 latency bucket: the max-value sample's
            # trace_id, so each bucket of the final distribution — the p99
            # bucket above all — links to a REAL trace
            # (``telemetry-query --slowest``). Bucket by magnitude, not
            # rank: percentiles shift as samples arrive, bucket edges don't.
            bucket = 0 if value < 1.0 else int(value).bit_length()
            per_bucket = self._exemplars.setdefault(name, {})
            prev = per_bucket.get(bucket)
            if prev is None or value > prev[0]:
                per_bucket[bucket] = (value, str(trace_id))

    @property
    def counters(self) -> dict:
        return dict(self._counters)

    # --- events -------------------------------------------------------------

    def emit(self, record: dict) -> None:
        """Push a raw record to every sink, verbatim (the bench metric rows
        must keep their exact schema — no decoration)."""
        for sink in self.sinks:
            sink.emit(record)

    def event(self, kind: str, **fields) -> None:
        """Timestamped, kind-tagged record to every sink."""
        self.emit({"ts": round(time.time(), 3), "kind": kind, **fields})

    # --- spans --------------------------------------------------------------

    def span(self, name: str, **meta):
        """Nested timing span context manager (see spans.SpanRecorder)."""
        return self.spans.span(name, **meta)

    def timed(self, name: str, fn, *args, block: bool = True, **meta):
        """Run ``fn(*args)`` under a span; with ``block`` (default) the span
        closes only after the card finished (``torch.cuda.synchronize`` where
        CUDA is up) — the boundary between launch and device time."""
        import torch

        with self.span(name, **meta):
            out = fn(*args)
            if block and torch.cuda.is_initialized():
                torch.cuda.synchronize()
        return out

    # --- device counters ----------------------------------------------------

    def record_device_counters(self, dc, prefix: str = "device.") -> None:
        """Accumulate a ``DeviceCounters`` (or its dict) into counters."""
        from p2pmicrogrid_tpu_torch.telemetry.device_metrics import dc_to_dict

        d = dc if isinstance(dc, dict) else dc_to_dict(dc)
        for k, v in d.items():
            self.counter(prefix + k, v)

    # --- summary / shutdown -------------------------------------------------

    def _hist_stats(self, values) -> dict:
        import numpy as np

        a = np.asarray(values, dtype=float)
        return {
            "count": int(a.size),
            "mean": float(a.mean()),
            "min": float(a.min()),
            "max": float(a.max()),
            "p50": float(np.percentile(a, 50)),
            "p95": float(np.percentile(a, 95)),
        }

    def summary(self) -> dict:
        return {
            "run_id": self.run_id,
            "counters": {k: float(v) for k, v in self._counters.items()},
            "gauges": {k: float(v) for k, v in self._gauges.items()},
            "histograms": {k: self._hist_stats(v) for k, v in self._hists.items()},
            "exemplars": {
                name: {
                    str(bucket): {"value": v, "trace_id": tid}
                    for bucket, (v, tid) in sorted(per.items())
                }
                for name, per in self._exemplars.items()
            },
            "spans": self.spans.totals(),
        }

    def flush(self) -> None:
        """Push buffered records through every flushable sink. Sinks
        without a flush are already unbuffered."""
        for sink in self.sinks:
            if hasattr(sink, "flush"):
                sink.flush()

    def close(self) -> None:
        """Flush the summary + Chrome trace to the run dir and close sinks.
        Idempotent."""
        if self._closed:
            return
        self._closed = True
        s = self.summary()
        self.event("summary", **{k: v for k, v in s.items() if k != "run_id"})
        if self.run_dir:
            with open(os.path.join(self.run_dir, "summary.json"), "w") as f:
                json.dump(s, f, indent=2, default=_json_default)
            self.spans.write_chrome_trace(
                os.path.join(self.run_dir, "trace.json")
            )
        for sink in self.sinks:
            # Sinks that store aggregates and spans structurally get them
            # here.
            if hasattr(sink, "write_summary"):
                sink.write_summary(s)
            if hasattr(sink, "write_spans"):
                sink.write_spans(self.spans)
            sink.close()
