"""Relational results store (SQLite) — the metrics/observability backend.

The port's copy of the JAX package's ``data/results.py``: the same DDL, the
same telemetry warehouse (``TELEMETRY_SCHEMA_VERSION``, the ``*_SQL``
views, the export leases, the shard merge), so one results file holds the
runs of both packages and either package's readers read it. It imports
``sqlite3`` and numpy only; pandas is imported lazily by the DataFrame
getters (``_read``, ``get_*``) and ``derive_additional_load`` alone, which
nothing on the command line's path calls.

Keeps the reference's schema (microgrid/database.py:28-81) so its whole
analysis layer's data model carries over: per-slot validation/test traces,
per-round decisions, training progress, and the single-day sweep tables. Two
reference defects are fixed rather than copied (SURVEY.md section 7):
``training_progress`` gets a CREATE TABLE (the reference inserts into a table
it never creates, database.py:202 vs 28-81), and nothing references undefined
globals (database.py:96-125's ``conn``).

The loggers accept numpy arrays or tensors (on any device) straight from the
simulator's ``SlotOutputs`` (envs/community.py) — the bridge from device land
to the relational store.
"""

from __future__ import annotations

import json
import os
import sqlite3
import time as _time
from typing import Optional, Sequence

import numpy as np

def host_array(x) -> np.ndarray:
    """A numpy view of ``x``: tensors (on any device) are copied to the host
    without naming torch, everything else goes through ``np.asarray``."""
    if hasattr(x, "detach") and hasattr(x, "cpu"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


_DDL = [
    # Measurement ingest tables (database.py:31-43).
    """CREATE TABLE IF NOT EXISTS environment
       (date text NOT NULL, time text NOT NULL, utc text NOT NULL,
        temperature real, cloud_cover real, humidity real, irradiation real,
        pv real,
        PRIMARY KEY (date, time, utc))""",
    """CREATE TABLE IF NOT EXISTS load
       (date text NOT NULL, time text NOT NULL, utc text NOT NULL,
        l0 real, l1 real, l2 real, l3 real, l4 real,
        PRIMARY KEY (date, time, utc))""",
    # Sweep tables (database.py:45-57).
    """CREATE TABLE IF NOT EXISTS hyperparameters_single_day
       (settings text NOT NULL, trial integer NOT NULL,
        episode integer NOT NULL, training real NOT NULL,
        validation real NOT NULL,
        PRIMARY KEY (settings, trial, episode))""",
    """CREATE TABLE IF NOT EXISTS single_day_best_results
       (settings text NOT NULL, date text NOT NULL, time text NOT NULL,
        load real, pv real, target_load real, target_pv real,
        PRIMARY KEY (settings, date, time))""",
    # Run results (database.py:59-78).
    """CREATE TABLE IF NOT EXISTS validation_results
       (setting text NOT NULL, implementation text NOT NULL,
        agent integer NOT NULL, day integer NOT NULL, time real NOT NULL,
        load real, pv real, temperature real, heatpump real, cost real,
        PRIMARY KEY (setting, implementation, agent, day, time))""",
    """CREATE TABLE IF NOT EXISTS test_results
       (setting text NOT NULL, implementation text NOT NULL,
        agent integer NOT NULL, day integer NOT NULL, time real NOT NULL,
        load real, pv real, temperature real, heatpump real, cost real,
        PRIMARY KEY (setting, implementation, agent, day, time))""",
    """CREATE TABLE IF NOT EXISTS rounds_comparison
       (setting text NOT NULL, agent integer NOT NULL, day integer NOT NULL,
        time real NOT NULL, round integer NOT NULL, decision real,
        PRIMARY KEY (setting, agent, day, time, round))""",
    # Missing in the reference (used at database.py:196-209 but never created).
    """CREATE TABLE IF NOT EXISTS training_progress
       (setting text NOT NULL, implementation text NOT NULL,
        episode integer NOT NULL, reward real, error real,
        PRIMARY KEY (setting, implementation, episode))""",
    # No reference counterpart: the greedy held-out health surface
    # (train/health.py). The reference's training_progress logs the noisy
    # training reward only — blind to the measured don't-heat basin where
    # cost improves while comfort collapses (README.md, round 4).
    """CREATE TABLE IF NOT EXISTS training_health
       (setting text NOT NULL, implementation text NOT NULL,
        episode integer NOT NULL, greedy_cost real, greedy_reward real,
        status text NOT NULL,
        PRIMARY KEY (setting, implementation, episode))""",
]

# --- telemetry warehouse ----------------------------------------------------
#
# The observability half of the store : telemetry runs stream into
# the SAME SQLite file the eval/bench rows land in, keyed by the run
# manifest's config_hash/git_rev, so one SQL join links a training run's
# telemetry to its eval results. Versioned via ``PRAGMA user_version`` so a
# pre-warehouse results DB migrates in place on open (CREATE IF NOT EXISTS
# is additive only; bumping TELEMETRY_SCHEMA_VERSION must come with a
# migration branch in ``ensure_telemetry_schema``).

TELEMETRY_SCHEMA_VERSION = 3

_TELEMETRY_DDL = [
    # One row per telemetry run: the manifest identity columns are promoted
    # for joining/filtering; the full manifest rides along as JSON.
    """CREATE TABLE IF NOT EXISTS telemetry_runs
       (run_id text PRIMARY KEY, created text, config_hash text,
        git_rev text, setting text, backend text, device_kind text,
        device_count integer, process_count integer, mesh_shape text,
        mesh_axis_names text, manifest_json text)""",
    # Every streamed event plus the exploded close-time aggregates: kind is
    # the event kind ('counter'/'gauge'/'histogram' for aggregates, 'metric'
    # for bench rows, the raw event kind otherwise); name/value carry the
    # queryable scalar, attrs_json everything else.
    """CREATE TABLE IF NOT EXISTS telemetry_points
       (run_id text NOT NULL REFERENCES telemetry_runs(run_id),
        seq integer NOT NULL, ts real, kind text NOT NULL, name text,
        value real, attrs_json text,
        PRIMARY KEY (run_id, seq))""",
    # Completed timing spans (start is run-relative perf_counter seconds).
    """CREATE TABLE IF NOT EXISTS telemetry_spans
       (run_id text NOT NULL REFERENCES telemetry_runs(run_id),
        seq integer NOT NULL, name text NOT NULL, start_s real,
        duration_s real, depth integer, meta_json text,
        PRIMARY KEY (run_id, seq))""",
    # Eval-run registry: the join anchor on the results side. The per-slot
    # eval tables carry no config identity (reference schema); this row
    # binds a (setting, implementation) eval to the config_hash/git_rev the
    # telemetry manifest also carries.
    """CREATE TABLE IF NOT EXISTS eval_runs
       (setting text NOT NULL, implementation text NOT NULL,
        is_testing integer NOT NULL, config_hash text, git_rev text,
        n_days integer, total_cost_eur real, created text NOT NULL,
        PRIMARY KEY (setting, implementation, is_testing))""",
    """CREATE INDEX IF NOT EXISTS idx_telemetry_points_kind
       ON telemetry_points(kind, name)""",
    """CREATE INDEX IF NOT EXISTS idx_telemetry_runs_config
       ON telemetry_runs(config_hash)""",
    # v2: the export/retention handshake. A trace exporter
    # (data/trace_export.py, serve/autopilot.py) takes a LEASE naming the
    # window start it is about to read; ``compact_serve_telemetry`` caps
    # its retention cutoff at the oldest active lease's window start, so
    # compaction and export coordinate by schedule instead of racing by
    # convention. A released lease records how far the export actually got
    # (``exported_through_ts``) — the next cycle's window start, and the
    # durable watermark retention can safely advance past. ``expires_ts``
    # bounds a crashed exporter: a SIGKILLed autopilot's lease stops
    # gating retention once the TTL passes (and the export, if it somehow
    # resumes after that, still fails loud on the compaction marker).
    """CREATE TABLE IF NOT EXISTS export_leases
       (lease_id text PRIMARY KEY, holder text, config_hash text,
        window_start_ts real NOT NULL, created_ts real NOT NULL,
        expires_ts real NOT NULL, released integer NOT NULL DEFAULT 0,
        exported_through_ts real)""",
    # v3: distributed-trace spans (telemetry/tracing.py). Unlike
    # telemetry_spans (per-process perf_counter origin), these carry EPOCH
    # start timestamps and the propagated trace/span/parent ids — every
    # process writes its own rows, and ``TRACE_TREE_SQL`` stitches one
    # cross-process tree back together by trace_id. ``process`` is the
    # emitter's role:pid label (one Perfetto lane each in the merged
    # export); ``attrs_json`` carries the span's structured attributes
    # (replica_id, bucket, padded_rows, hop, ...).
    """CREATE TABLE IF NOT EXISTS trace_spans
       (run_id text NOT NULL REFERENCES telemetry_runs(run_id),
        seq integer NOT NULL, trace_id text NOT NULL, span_id text NOT NULL,
        parent_span_id text, name text NOT NULL, ts real,
        duration_s real, process text, attrs_json text,
        PRIMARY KEY (run_id, seq))""",
    """CREATE INDEX IF NOT EXISTS idx_trace_spans_trace
       ON trace_spans(trace_id, ts)""",
]


# --- export/retention handshake (schema v2) ----------------------------------


def acquire_export_lease(
    con: sqlite3.Connection,
    holder: str,
    window_start_ts: float,
    ttl_s: float = 600.0,
    config_hash: Optional[str] = None,
    now: Optional[float] = None,
) -> str:
    """Take an export lease: "I am about to read decision traces with
    ``ts >= window_start_ts`` — retention must not delete them." Returns
    the lease id (pass to ``release_export_lease`` when the export lands).
    The TTL bounds a crashed holder: an expired lease stops gating
    compaction, it is never a permanent lock."""
    import uuid

    now = _time.time() if now is None else now
    lease_id = f"lease-{uuid.uuid4().hex[:12]}"
    ensure_telemetry_schema(con)
    with con:
        con.execute(
            "INSERT INTO export_leases "
            "(lease_id, holder, config_hash, window_start_ts, created_ts, "
            " expires_ts, released) VALUES (?,?,?,?,?,?,0)",
            (
                lease_id, holder, config_hash, float(window_start_ts),
                now, now + max(float(ttl_s), 0.0),
            ),
        )
    return lease_id


def release_export_lease(
    con: sqlite3.Connection, lease_id: str, exported_through_ts: float
) -> None:
    """Release a lease, recording how far the export read
    (``exported_through_ts`` — the durable watermark the NEXT export
    window starts from and retention can advance past)."""
    with con:
        cur = con.execute(
            "UPDATE export_leases SET released = 1, exported_through_ts = ? "
            "WHERE lease_id = ?",
            (float(exported_through_ts), lease_id),
        )
        if cur.rowcount == 0:
            raise KeyError(f"no export lease {lease_id}")


def cancel_export_lease(con: sqlite3.Connection, lease_id: str) -> None:
    """Drop a lease whose export FAILED: the row is deleted outright —
    releasing it with a fake watermark would poison
    ``last_export_watermark`` (and pin the retention floor) with a window
    that never actually exported. Idempotent."""
    with con:
        con.execute(
            "DELETE FROM export_leases WHERE lease_id = ?", (lease_id,)
        )


class ExportLeaseScope:
    """The one copy of the lease choreography both exporters use
    (``continual --windowed`` and ``serve/autopilot.py``): acquire on
    enter; the caller calls ``release(exported_through_ts)`` when the
    export LANDED; leaving the scope without a release CANCELS the lease
    (a cleanly-failed export must not gate retention for the TTL — a
    SIGKILL still does, which is what the TTL is for)."""

    def __init__(
        self,
        db_path: str,
        holder: str,
        window_start_ts: float,
        ttl_s: float = 600.0,
        config_hash: Optional[str] = None,
    ):
        self.db_path = db_path
        self.holder = holder
        self.window_start_ts = float(window_start_ts)
        self.ttl_s = ttl_s
        self.config_hash = config_hash
        self.lease_id: Optional[str] = None
        self._released = False

    def __enter__(self) -> "ExportLeaseScope":
        con = sqlite3.connect(self.db_path)
        try:
            self.lease_id = acquire_export_lease(
                con, self.holder, self.window_start_ts,
                ttl_s=self.ttl_s, config_hash=self.config_hash,
            )
        finally:
            con.close()
        return self

    def release(self, exported_through_ts: float) -> None:
        con = sqlite3.connect(self.db_path)
        try:
            release_export_lease(con, self.lease_id, exported_through_ts)
        finally:
            con.close()
        self._released = True

    def __exit__(self, *exc) -> None:
        if not self._released and self.lease_id is not None:
            con = sqlite3.connect(self.db_path)
            try:
                cancel_export_lease(con, self.lease_id)
            finally:
                con.close()


def active_lease_floor(
    con: sqlite3.Connection, now: Optional[float] = None
) -> Optional[float]:
    """The oldest window start of any unreleased, unexpired lease — the
    timestamp retention must not cross — or None with no active lease.
    Reads as None on a pre-v2 warehouse (no lease table yet)."""
    now = _time.time() if now is None else now
    try:
        (floor,) = con.execute(
            "SELECT MIN(window_start_ts) FROM export_leases "
            "WHERE released = 0 AND expires_ts > ?",
            (now,),
        ).fetchone()
    except sqlite3.OperationalError:
        return None  # pre-v2 DB: no leases ever taken
    return float(floor) if floor is not None else None


def released_watermark_floor(
    con: sqlite3.Connection, now: Optional[float] = None
) -> Optional[float]:
    """The oldest export frontier still under LEASED protection: for each
    config whose most recent lease has not yet passed its TTL, the
    newest ``exported_through_ts``. Between one cycle's release and the
    next cycle's acquire, the frontier keeps retention from overtaking
    the export — and the protection EXPIRES with the lease TTL exactly
    like an active lease's does, so a retired config (promoted away,
    never exporting again) stops gating one TTL after its last release
    instead of pinning the retention cutoff forever. The operational
    contract is the same one the active-lease TTL already sets: keep the
    export cadence under the lease TTL, or raise the TTL."""
    now = _time.time() if now is None else now
    try:
        (floor,) = con.execute(
            "SELECT MIN(m) FROM ("
            " SELECT MAX(exported_through_ts) AS m"
            " FROM export_leases"
            " WHERE released = 1 AND exported_through_ts IS NOT NULL"
            " GROUP BY config_hash"
            " HAVING MAX(expires_ts) > ?)",
            (now,),
        ).fetchone()
    except sqlite3.OperationalError:
        return None
    return float(floor) if floor is not None else None


def last_export_watermark(
    con: sqlite3.Connection, config_hash: Optional[str] = None
) -> Optional[float]:
    """The newest ``exported_through_ts`` of a released lease (filtered to
    ``config_hash`` when given, falling back to config-less leases) — where
    the next export window starts. None when nothing was ever exported."""
    try:
        rows = con.execute(
            "SELECT MAX(exported_through_ts) FROM export_leases "
            "WHERE released = 1 AND (config_hash = ? OR config_hash IS NULL)",
            (config_hash,),
        ).fetchone()
    except sqlite3.OperationalError:
        return None
    return float(rows[0]) if rows and rows[0] is not None else None


def compact_serve_telemetry(
    con: sqlite3.Connection,
    older_than_s: float,
    now: Optional[float] = None,
    respect_leases: bool = True,
) -> dict:
    """Roll per-request ``serve_request`` telemetry_points older than
    ``older_than_s`` seconds into per-(run, bucket) aggregate points.

    A long-running gateway emits one ``serve_request`` row per served
    request — unbounded growth for exactly the table that matters most in
    production (ROADMAP warehouse follow-on). Compaction keeps the recent
    window raw (per-request debugging stays possible) and replaces the
    old tail with ``serve_request_agg`` points: one per (run_id, padding
    bucket) per compaction pass, carrying the request count (``value``),
    wait/service/latency stats and the compacted time window, so SLO
    queries over history still work — at per-bucket resolution instead of
    per-request.

    Idempotent over already-compacted history (aggregates are a different
    ``kind`` and are never re-compacted). Returns
    ``{"rows_compacted": n, "aggregates_written": m,
    "decisions_compacted": d}``.

    The same pass also deletes the gateway's per-request
    ``serve_decision`` traces (household/obs/action — the continual-
    training feed, data/trace_export.py) older than the cutoff: they are
    the LARGEST rows in the warehouse (full observation payloads), and
    per-request decisions have no per-bucket aggregate worth keeping.
    ``data/trace_export.py`` refuses to export a run whose window was
    compacted — the presence of ``serve_request_agg`` rows marks it — so
    trimmed history can never silently train a partial buffer.

    Memory stays flat in the number of compacted rows — the whole point
    is warehouses too big to hold: the cursor streams, per-group stats
    keep exact count/mean/max plus a fixed-size deterministic reservoir
    for the percentiles (exact whenever a group has <= 4096 rows), and
    deletion reuses the selection predicate instead of materializing row
    keys. One assumption: the retention window must exceed the sinks'
    flush latency (seconds), or rows flushed between the scan and the
    delete could be dropped un-aggregated.

    ``respect_leases`` (default) is retention's half of the scheduled
    export handshake: the cutoff is capped at the oldest ACTIVE export
    lease's window start (``acquire_export_lease``), so a continual-
    training export in flight can never lose the decision rows it is
    reading — the coordination that used to exist only as the
    ``TracesCompactedError`` convention. The returned dict reports the
    effective ``cutoff_ts`` and whether a lease capped it.
    """
    import json as _json
    import random as _random

    now = _time.time() if now is None else now
    cutoff = now - max(float(older_than_s), 0.0)
    lease_capped = False
    if respect_leases:
        # The export/retention handshake (``acquire_export_lease``): an
        # active lease names the window start a live exporter is reading
        # from — the cutoff never crosses it, so a scheduled retention
        # pass and a scheduled export cannot race. Between cycles (no
        # lease held) the RELEASED watermark frontier gates instead:
        # retention follows export, never overtakes it, so decisions
        # served after the last export survive until the next one lands.
        # ``respect_leases=False`` is the forced-race escape hatch
        # (tests; an operator reclaiming a warehouse NOW) — the export
        # side still fails loud on the aggregate markers it leaves
        # behind.
        for floor in (
            active_lease_floor(con, now=now),
            released_watermark_floor(con, now=now),
        ):
            if floor is not None and floor < cutoff:
                cutoff = floor
                lease_capped = True

    reservoir_k = 4096
    rng = _random.Random(0)

    class _Stream:
        """Exact n/mean/max + reservoir-sampled percentiles."""

        __slots__ = ("n", "total", "max", "sample")

        def __init__(self):
            self.n, self.total, self.max, self.sample = 0, 0.0, None, []

        def add(self, v: float) -> None:
            self.n += 1
            self.total += v
            self.max = v if self.max is None else max(self.max, v)
            if len(self.sample) < reservoir_k:
                self.sample.append(v)
            else:
                j = rng.randrange(self.n)
                if j < reservoir_k:
                    self.sample[j] = v

        def stats(self) -> dict:
            if not self.n:
                return {}
            a = np.asarray(self.sample, dtype=float)
            return {
                "mean": round(self.total / self.n, 3),
                "p50": round(float(np.percentile(a, 50)), 3),
                "p95": round(float(np.percentile(a, 95)), 3),
                "max": round(float(self.max), 3),
            }

    groups: dict = {}
    n_rows = 0
    cursor = con.execute(
        "SELECT run_id, ts, attrs_json FROM telemetry_points "
        "WHERE kind = 'serve_request' AND ts IS NOT NULL AND ts < ?",
        (cutoff,),
    )
    for run_id, ts, attrs_json in cursor:
        n_rows += 1
        try:
            attrs = _json.loads(attrs_json) if attrs_json else {}
        except ValueError:
            attrs = {}
        key = (run_id, int(attrs.get("bucket", -1)))
        g = groups.get(key)
        if g is None:
            g = groups[key] = {
                "n": 0, "ts_min": ts, "ts_max": ts, "padded_rows": 0,
                "wait_ms": _Stream(), "service_ms": _Stream(),
                "latency_ms": _Stream(),
            }
        g["n"] += 1
        g["ts_min"] = min(g["ts_min"], ts)
        g["ts_max"] = max(g["ts_max"], ts)
        for field_name in ("wait_ms", "service_ms", "latency_ms"):
            v = attrs.get(field_name)
            if isinstance(v, (int, float)):
                g[field_name].add(float(v))
        pr = attrs.get("padded_rows")
        if isinstance(pr, (int, float)):
            g["padded_rows"] += int(pr)
    (n_decisions,) = con.execute(
        "SELECT COUNT(*) FROM telemetry_points "
        "WHERE kind = 'serve_decision' AND ts IS NOT NULL AND ts < ?",
        (cutoff,),
    ).fetchone()
    (n_settlements,) = con.execute(
        "SELECT COUNT(*) FROM telemetry_points "
        "WHERE kind = 'settlement' AND ts IS NOT NULL AND ts < ?",
        (cutoff,),
    ).fetchone()
    if not n_rows and not n_decisions and not n_settlements:
        return {
            "rows_compacted": 0,
            "aggregates_written": 0,
            "decisions_compacted": 0,
            "settlements_compacted": 0,
            "cutoff_ts": round(cutoff, 3),
            "lease_capped": lease_capped,
        }

    # Aggregate rows live in a disjoint seq namespace: a LIVE SqliteSink
    # for the same run keeps its own in-memory counter (starting at 0), so
    # allocating MAX(seq)+1 here would collide with the sink's next insert
    # and silently drop its telemetry from then on. Seqs at/above this
    # base are unreachable by a streaming sink (it would need 2^40 points
    # per run), so compacting a live warehouse is safe.
    agg_seq_base = 1 << 40
    agg_rows = []
    next_seq: dict = {}
    for (run_id, bucket), g in sorted(groups.items()):
        if run_id not in next_seq:
            (max_seq,) = con.execute(
                "SELECT COALESCE(MAX(seq), -1) FROM telemetry_points "
                "WHERE run_id = ? AND seq >= ?",
                (run_id, agg_seq_base),
            ).fetchone()
            next_seq[run_id] = max(max_seq + 1, agg_seq_base)
        attrs = {
            "bucket": bucket,
            "requests": g["n"],
            "padded_rows": g["padded_rows"],
            "ts_min": round(g["ts_min"], 3),
            "ts_max": round(g["ts_max"], 3),
            "wait_ms": g["wait_ms"].stats(),
            "service_ms": g["service_ms"].stats(),
            "latency_ms": g["latency_ms"].stats(),
        }
        agg_rows.append(
            (
                run_id, next_seq[run_id], round(g["ts_max"], 3),
                "serve_request_agg", f"bucket_{bucket}",
                float(g["n"]), _json.dumps(attrs),
            )
        )
        next_seq[run_id] += 1

    with con:
        con.executemany(
            "INSERT INTO telemetry_points VALUES (?,?,?,?,?,?,?)", agg_rows
        )
        deleted = con.execute(
            "DELETE FROM telemetry_points WHERE kind = 'serve_request' "
            "AND ts IS NOT NULL AND ts < ?",
            (cutoff,),
        ).rowcount
        decisions_deleted = con.execute(
            "DELETE FROM telemetry_points WHERE kind = 'serve_decision' "
            "AND ts IS NOT NULL AND ts < ?",
            (cutoff,),
        ).rowcount
        # Settlement rows are derived from (and only joinable to) the
        # decisions above — once a window's decisions are exported and
        # retired, the bills for them are too, or the settlement table
        # would be the one warehouse surface that grows forever.
        settlements_deleted = con.execute(
            "DELETE FROM telemetry_points WHERE kind = 'settlement' "
            "AND ts IS NOT NULL AND ts < ?",
            (cutoff,),
        ).rowcount
    return {
        "rows_compacted": int(deleted),
        "aggregates_written": len(agg_rows),
        "decisions_compacted": int(decisions_deleted),
        "settlements_compacted": int(settlements_deleted),
        "cutoff_ts": round(cutoff, 3),
        "lease_capped": lease_capped,
    }


def ensure_telemetry_schema(con: sqlite3.Connection) -> int:
    """Create or migrate the telemetry warehouse tables on ``con``.

    Idempotent; safe on a fresh DB, a legacy (pre-warehouse) results DB and
    an already-current one. Returns the schema version now in effect.
    """
    (version,) = con.execute("PRAGMA user_version").fetchone()
    for ddl in _TELEMETRY_DDL:
        con.execute(ddl)
    if version < TELEMETRY_SCHEMA_VERSION:
        # v0 -> v1 (warehouse tables), v1 -> v2 (export_leases) and
        # v2 -> v3 (trace_spans) are all pure table creation — the DDL loop
        # above is the whole migration; future bumps branch on `version`
        # here with ALTER TABLE migrations.
        con.execute(f"PRAGMA user_version = {TELEMETRY_SCHEMA_VERSION}")
    con.commit()
    return TELEMETRY_SCHEMA_VERSION


# --- per-replica warehouse shards --------------------------------------------
#
# At fleet scale every per-request `serve_request`/`serve_decision` row
# funneling into ONE SQLite file is the first thing to fall over (the
# per-sink `telemetry.ingest_lag_ms` gauge is the meter). The scale tier
# instead binds one WAL-mode shard per replica
# (`SqliteSink(path, shard_id=...)`, `LocalFleet(shard_warehouse=True)`)
# and federates them at read time: `merge_warehouse_shards` unions shard
# tables into one DB, and `telemetry-query --shard A --shard B` runs the
# fleet/continuous/promotion views over the merged set — row-identical to
# the same traffic funneled into a single DB (tests/test_scale.py).

#: Warehouse tables a shard merge copies, in FK-safe order. Every one
#: carries a natural primary key (run_id / (run_id, seq) / lease_id /
#: (setting, implementation, is_testing)), which is what makes the merge
#: idempotent under INSERT OR IGNORE.
SHARD_MERGE_TABLES = (
    "telemetry_runs",
    "telemetry_points",
    "telemetry_spans",
    "trace_spans",
    "eval_runs",
    "export_leases",
)


def shard_db_path(results_db: str, shard: str) -> str:
    """The per-replica shard file for a base warehouse path: sibling files
    ``<stem>.shard-<shard><ext>`` so a shard set globs/sorts together next
    to the base DB it federates into."""
    stem, ext = os.path.splitext(results_db)
    return f"{stem}.shard-{shard}{ext}"


def merge_warehouse_shards(con: sqlite3.Connection, shard_paths) -> dict:
    """Federate per-replica warehouse shards into ``con``.

    Each shard is ATTACHed and its warehouse tables are unioned into the
    destination with ``INSERT OR IGNORE`` keyed on the tables' natural
    primary keys — run ids are unique per sink run, so distinct replicas
    never collide, and the merge is IDEMPOTENT: merging a shard twice, or
    merging shards in any order, yields the same row set. A shard from a
    SIGKILLed replica merges cleanly too: SQLite transactions are atomic,
    so a torn last batch is simply absent — the committed prefix merges
    and the federated view stays consistent (never a half-row).

    Returns per-table inserted-row counts plus the shard count. Shards
    missing a table (older schema, empty sink) contribute nothing for it.
    """
    ensure_telemetry_schema(con)
    stats = {t: 0 for t in SHARD_MERGE_TABLES}
    stats["shards"] = 0
    for path in shard_paths:
        con.execute("ATTACH DATABASE ? AS _shard", (str(path),))
        try:
            have = {
                r[0]
                for r in con.execute(
                    "SELECT name FROM _shard.sqlite_master "
                    "WHERE type = 'table'"
                )
            }
            with con:
                for table in SHARD_MERGE_TABLES:
                    if table not in have:
                        continue
                    cur = con.execute(
                        f"INSERT OR IGNORE INTO main.{table} "
                        f"SELECT * FROM _shard.{table}"
                    )
                    stats[table] += cur.rowcount
            stats["shards"] += 1
        finally:
            con.execute("DETACH DATABASE _shard")
    return stats


# One fleet view over per-replica serving runs (serve/router.py): every
# serve-role telemetry run (replica bundles register one run per bundle,
# the fleet router registers a 'router' run) grouped by config_hash, with
# per-run serve_request trace counts and the router's resilience counters
# (ejections/failovers/retries/sheds) summed alongside. The warehouse
# analogue of aggregating per-replica GET /stats into one snapshot — but
# over EVERYTHING ever recorded, not the live fleet.
FLEET_VIEW_SQL = """
SELECT t.config_hash,
       COUNT(DISTINCT t.run_id) AS n_runs,
       COUNT(DISTINCT CASE
           WHEN json_extract(t.manifest_json, '$.serve_role') = 'router'
           THEN t.run_id END) AS n_router_runs,
       COUNT(CASE WHEN p.kind = 'serve_request' THEN 1 END)
           AS n_serve_traces,
       COALESCE(SUM(CASE WHEN p.kind = 'counter'
           AND p.name = 'router.failovers' THEN p.value END), 0)
           AS router_failovers,
       COALESCE(SUM(CASE WHEN p.kind = 'counter'
           AND p.name = 'router.retries' THEN p.value END), 0)
           AS router_retries,
       COALESCE(SUM(CASE WHEN p.kind = 'counter'
           AND p.name = 'router.ejections' THEN p.value END), 0)
           AS router_ejections,
       COALESCE(SUM(CASE WHEN p.kind = 'counter'
           AND p.name = 'router.shed' THEN p.value END), 0)
           AS router_shed,
       COALESCE(SUM(CASE WHEN p.kind = 'counter'
           AND p.name = 'router.reconnects' THEN p.value END), 0)
           AS router_reconnects,
       COALESCE(SUM(CASE WHEN p.kind = 'counter'
           AND p.name = 'router.auth_denied' THEN p.value END), 0)
           AS router_auth_denied,
       MAX(CASE WHEN p.kind = 'sink_gauge'
           AND p.name = 'telemetry.ingest_lag_ms' THEN p.value END)
           AS ingest_lag_ms,
       (SELECT json_extract(p2.attrs_json, '$.processes')
          FROM telemetry_points p2
          JOIN telemetry_runs t2 ON t2.run_id = p2.run_id
         WHERE t2.config_hash = t.config_hash
           AND p2.kind = 'fleet_stats'
           AND json_extract(p2.attrs_json, '$.processes') IS NOT NULL
         -- seq is per-run (PRIMARY KEY (run_id, seq)); ts orders the
         -- newest event ACROSS the runs sharing this config_hash, seq
         -- breaks ties within one run.
         ORDER BY p2.ts DESC, p2.seq DESC LIMIT 1)
           AS last_processes
FROM telemetry_runs t
LEFT JOIN telemetry_points p ON p.run_id = t.run_id
WHERE json_extract(t.manifest_json, '$.serve_role') IS NOT NULL
  AND t.config_hash IS NOT NULL
GROUP BY t.config_hash
ORDER BY t.config_hash
"""

# One distributed trace tree (schema v3): every process wrote
# its spans into its own run's ``trace_spans`` rows; this stitches the
# cross-process tree back together by trace_id, time-ordered, with the
# emitting run's serve_role alongside so the rendering
# (``telemetry-query --trace``) can show WHICH process answered each hop.
# Depth is resolved by the renderer (parent links can cross runs, so a
# recursive CTE keyed on run-local ids would miss cross-process edges).
TRACE_TREE_SQL = """
SELECT s.trace_id, s.span_id, s.parent_span_id, s.name, s.ts,
       s.duration_s, s.process, s.attrs_json, s.run_id,
       json_extract(t.manifest_json, '$.serve_role') AS serve_role
FROM trace_spans s
LEFT JOIN telemetry_runs t ON t.run_id = s.run_id
WHERE s.trace_id = ?
ORDER BY s.ts, s.seq
"""

# Exemplar traces behind the latency histogram's slowest buckets
# (``telemetry-query --slowest N``): ``Telemetry.histogram`` keeps one
# max-value exemplar per log2 bucket when the caller attaches a trace_id,
# and close() explodes them as ``hist_exemplar`` points — so the p99
# bucket of ``router.latency_ms`` links to REAL trace_ids, not a
# statistical abstraction.
SLOWEST_TRACES_SQL = """
SELECT json_extract(p.attrs_json, '$.trace_id') AS trace_id,
       p.name, p.value AS latency_ms,
       json_extract(p.attrs_json, '$.bucket') AS bucket,
       p.run_id, p.ts
FROM telemetry_points p
WHERE p.kind = 'hist_exemplar'
  AND json_extract(p.attrs_json, '$.trace_id') IS NOT NULL
ORDER BY p.value DESC
LIMIT ?
"""


# The training-resilience view (train/resilience.py): every config_hash
# whose runs recorded divergence trips or rollbacks, with the
# ``train.rollback``/``train.divergence`` counter sums and the last
# rollback event's detail — the warehouse answer to "did this config ever
# self-heal, and from what". One LEFT JOIN pass with conditional
# aggregation (same shape as FLEET_VIEW_SQL).
ROLLBACK_VIEW_SQL = """
SELECT t.config_hash,
       COUNT(DISTINCT t.run_id) AS n_runs,
       COALESCE(SUM(CASE WHEN p.kind = 'counter'
           AND p.name = 'train.rollback' THEN p.value END), 0)
           AS rollbacks,
       COALESCE(SUM(CASE WHEN p.kind = 'counter'
           AND p.name = 'train.divergence' THEN p.value END), 0)
           AS divergence_trips,
       COUNT(CASE WHEN p.kind = 'rollback' THEN 1 END)
           AS rollback_events,
       MAX(CASE WHEN p.kind = 'rollback'
           THEN json_extract(p.attrs_json, '$.episode') END)
           AS last_rollback_episode,
       MAX(CASE WHEN p.kind = 'rollback'
           THEN json_extract(p.attrs_json, '$.restored_episode') END)
           AS last_restored_episode
FROM telemetry_runs t
LEFT JOIN telemetry_points p ON p.run_id = t.run_id
WHERE t.config_hash IS NOT NULL
GROUP BY t.config_hash
HAVING rollbacks > 0 OR divergence_trips > 0 OR rollback_events > 0
ORDER BY t.config_hash
"""


# The promotion view (serve/promotion.py): every candidate bundle that
# ever faced the gate/canary, grouped by its config_hash, with verdict
# counts and the newest decision's detail — the warehouse answer to "what
# happened the last time this config tried to ship". ``promotion`` events
# carry phase ('gate' | 'canary_stage' | 'canary_abort' | 'promoted' |
# 'rolled_back'), the candidate/incumbent hashes and the verdict fields.
PROMOTION_VIEW_SQL = """
SELECT json_extract(p.attrs_json, '$.candidate') AS candidate,
       COUNT(*) AS n_events,
       COUNT(CASE WHEN json_extract(p.attrs_json, '$.phase') = 'gate'
           THEN 1 END) AS gate_events,
       COUNT(CASE WHEN json_extract(p.attrs_json, '$.phase') = 'gate'
           AND json_extract(p.attrs_json, '$.passed') = 1
           THEN 1 END) AS gate_passes,
       COUNT(CASE WHEN json_extract(p.attrs_json, '$.phase') = 'promoted'
           THEN 1 END) AS promotions,
       COUNT(CASE WHEN json_extract(p.attrs_json, '$.phase') = 'rolled_back'
           THEN 1 END) AS rollbacks,
       MAX(p.ts) AS last_ts,
       (SELECT json_extract(p2.attrs_json, '$.phase')
          FROM telemetry_points p2
         WHERE p2.kind = 'promotion'
           AND json_extract(p2.attrs_json, '$.candidate') =
               json_extract(p.attrs_json, '$.candidate')
         ORDER BY p2.ts DESC, p2.seq DESC LIMIT 1) AS last_phase
FROM telemetry_points p
WHERE p.kind = 'promotion'
  AND json_extract(p.attrs_json, '$.candidate') IS NOT NULL
GROUP BY candidate
ORDER BY candidate
"""


# The promotion lineage: every PROMOTED event in warehouse
# time order. Each promotion records (incumbent -> candidate); chaining
# them renders the deployment ancestry a week of unattended autopilot
# cycles produced — incumbent -> candidate -> candidate² — which
# ``telemetry-query --promotions`` prints next to the per-candidate
# verdict counts.
PROMOTION_LINEAGE_SQL = """
SELECT p.ts,
       json_extract(p.attrs_json, '$.incumbent') AS incumbent,
       json_extract(p.attrs_json, '$.candidate') AS candidate,
       t.config_hash AS recorded_by
FROM telemetry_points p
JOIN telemetry_runs t ON t.run_id = p.run_id
WHERE p.kind = 'promotion'
  AND json_extract(p.attrs_json, '$.phase') = 'promoted'
  AND json_extract(p.attrs_json, '$.candidate') IS NOT NULL
ORDER BY p.ts, p.seq
"""


def promotion_lineage(con: sqlite3.Connection) -> dict:
    """The promotion ancestry chain out of ``PROMOTION_LINEAGE_SQL``:
    ``{"links": [{ts, incumbent, candidate}...], "chain": [hash...]}``.
    The chain follows each promotion's incumbent pointer in time order,
    starting a fresh segment whenever a promotion's incumbent is not the
    current chain head (parallel histories stay readable instead of being
    silently merged)."""
    rows = con.execute(PROMOTION_LINEAGE_SQL).fetchall()
    links = [
        {"ts": ts, "incumbent": inc, "candidate": cand}
        for ts, inc, cand, _ in rows
    ]
    chain: list = []
    for link in links:
        if not chain:
            chain = [link["incumbent"], link["candidate"]]
        elif link["incumbent"] == chain[-1]:
            chain.append(link["candidate"])
        else:
            # A promotion whose incumbent is off-chain: new segment marker.
            chain.extend([None, link["incumbent"], link["candidate"]])
    return {"links": links, "chain": chain}


# The regime view (regimes/): per-regime
# cost/comfort/trade-energy breakdown per config_hash out of the
# ``regime_eval`` events the per-regime greedy evaluator emits
# (regimes/evaluate.py) — the warehouse answer to "how does this config
# do in each world, not just on average". One LEFT-JOIN-free pass over
# telemetry_points grouped by (config_hash, bundle, regime); held_out marks
# rows from generalization evals (train on set A, eval on held-out set B),
# and ``bundle`` (when the evaluator tagged one — the promotion gate tags
# candidate/incumbent) keeps two policies of one config in separate rows
# instead of averaging them.
REGIME_VIEW_SQL = """
SELECT t.config_hash,
       json_extract(p.attrs_json, '$.bundle') AS bundle,
       json_extract(p.attrs_json, '$.regime') AS regime,
       COUNT(*) AS n_evals,
       COUNT(CASE WHEN json_extract(p.attrs_json, '$.held_out') = 1
           THEN 1 END) AS n_held_out_evals,
       AVG(json_extract(p.attrs_json, '$.cost_eur')) AS mean_cost_eur,
       AVG(json_extract(p.attrs_json, '$.reward')) AS mean_reward,
       AVG(json_extract(p.attrs_json, '$.comfort_violations'))
           AS mean_comfort_violations,
       AVG(json_extract(p.attrs_json, '$.trade_wh')) AS mean_trade_wh,
       AVG(json_extract(p.attrs_json, '$.grid_wh')) AS mean_grid_wh,
       AVG(json_extract(p.attrs_json, '$.curtailed_wh'))
           AS mean_curtailed_wh,
       AVG(json_extract(p.attrs_json, '$.ev_charged_wh'))
           AS mean_ev_charged_wh,
       AVG(json_extract(p.attrs_json, '$.ev_missed_wh'))
           AS mean_ev_missed_wh,
       MAX(p.ts) AS last_ts
FROM telemetry_points p
JOIN telemetry_runs t ON t.run_id = p.run_id
WHERE p.kind = 'regime_eval'
  AND json_extract(p.attrs_json, '$.regime') IS NOT NULL
GROUP BY t.config_hash, bundle, regime
ORDER BY t.config_hash, bundle, regime
"""


# The continuous-batching view (serve/continuous.py): every
# serving bundle's telemetry run is tagged ``serve_batching`` ("micro" |
# "continuous") in its manifest, each engine step emits
# ``serve.batch_occupancy`` + ``serve.slot_wait_ms`` histograms, and the
# queue fronts stream the same per-request ``serve_request`` traces — so
# one grouped pass renders the continuous-vs-microbatch comparison PER
# CONFIG out of the warehouse itself: request counts, mean wait/latency
# from the traces, and the close-time occupancy/slot-wait distribution
# stats, keyed by (config_hash, batching). ``telemetry-query --continuous``
# prints it.
CONTINUOUS_VIEW_SQL = """
SELECT t.config_hash,
       json_extract(t.manifest_json, '$.serve_batching') AS batching,
       COUNT(DISTINCT t.run_id) AS n_runs,
       COUNT(CASE WHEN p.kind = 'serve_request' THEN 1 END) AS n_requests,
       AVG(CASE WHEN p.kind = 'serve_request'
           THEN json_extract(p.attrs_json, '$.wait_ms') END) AS mean_wait_ms,
       AVG(CASE WHEN p.kind = 'serve_request'
           THEN json_extract(p.attrs_json, '$.latency_ms') END)
           AS mean_latency_ms,
       AVG(CASE WHEN p.kind = 'histogram'
           AND p.name = 'serve.batch_occupancy'
           THEN json_extract(p.attrs_json, '$.mean') END) AS occupancy_mean,
       AVG(CASE WHEN p.kind = 'histogram'
           AND p.name = 'serve.batch_occupancy'
           THEN json_extract(p.attrs_json, '$.p95') END) AS occupancy_p95,
       AVG(CASE WHEN p.kind = 'histogram'
           AND p.name = 'serve.slot_wait_ms'
           THEN json_extract(p.attrs_json, '$.p50') END) AS slot_wait_p50_ms,
       AVG(CASE WHEN p.kind = 'histogram'
           AND p.name = 'serve.slot_wait_ms'
           THEN json_extract(p.attrs_json, '$.p95') END) AS slot_wait_p95_ms,
       MAX(p.ts) AS last_ts
FROM telemetry_runs t
JOIN telemetry_points p ON p.run_id = t.run_id
WHERE json_extract(t.manifest_json, '$.serve_batching') IS NOT NULL
GROUP BY t.config_hash, batching
ORDER BY t.config_hash, batching
"""


# The default telemetry-query join (cli.py `telemetry-query`): one row per
# (telemetry run, eval run) pair sharing a config_hash, with the run's gauge
# points aggregated alongside the eval cost.
TELEMETRY_JOIN_SQL = """
SELECT t.run_id, t.config_hash, t.git_rev,
       t.setting AS telemetry_setting, t.backend, t.device_count,
       t.mesh_shape,
       e.setting AS eval_setting, e.implementation, e.is_testing,
       e.n_days, e.total_cost_eur,
       (SELECT COUNT(*) FROM telemetry_points p
         WHERE p.run_id = t.run_id) AS n_points,
       (SELECT COUNT(*) FROM telemetry_points p
         WHERE p.run_id = t.run_id AND p.kind = 'gauge') AS n_gauges
FROM telemetry_runs t
JOIN eval_runs e ON e.config_hash = t.config_hash
ORDER BY t.run_id, e.setting
"""


class ResultsStore:
    """Thin, explicit wrapper over an SQLite results database."""

    def __init__(self, path: str = ":memory:"):
        self.con = sqlite3.connect(path)
        # WAL lets a SqliteSink stream telemetry while a reader (analyse /
        # telemetry-query) has the same file open; a no-op on :memory:.
        self.con.execute("PRAGMA journal_mode=WAL")
        self.create_tables()

    # -- lifecycle ---------------------------------------------------------

    def create_tables(self) -> None:
        cur = self.con.cursor()
        try:
            for ddl in _DDL:
                cur.execute(ddl)
            self.con.commit()
        finally:
            cur.close()
        ensure_telemetry_schema(self.con)

    def close(self) -> None:
        self.con.close()

    def __enter__(self) -> "ResultsStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- writers -----------------------------------------------------------

    def log_training_progress(
        self,
        setting: str,
        implementation: str,
        episode: int,
        reward: float,
        error: float,
    ) -> None:
        """Running-average reward/error every decay window
        (community.py:288, database.py:196-209)."""
        with self.con:
            self.con.execute(
                "INSERT OR REPLACE INTO training_progress VALUES (?,?,?,?,?)",
                (setting, implementation, episode, float(reward), float(error)),
            )

    def log_training_health(
        self,
        setting: str,
        implementation: str,
        episode: int,
        greedy_cost: float,
        greedy_reward: float,
        status: str,
    ) -> None:
        """Greedy held-out cost/reward + basin classification per eval
        period (train/health.py — the live comfort-collapse signal the
        reference's training_progress cannot express)."""
        with self.con:
            self.con.execute(
                "INSERT OR REPLACE INTO training_health VALUES (?,?,?,?,?,?)",
                (setting, implementation, episode, float(greedy_cost),
                 float(greedy_reward), status),
            )

    def log_run_results(
        self,
        setting: str,
        implementation: str,
        is_testing: bool,
        day: int,
        time: np.ndarray,
        load: np.ndarray,
        pv: np.ndarray,
        temperature: np.ndarray,
        heatpump: np.ndarray,
        cost: np.ndarray,
    ) -> None:
        """Per-slot per-agent traces for one evaluated day
        (community.py:341-356, database.py:226-293).

        Arrays: time [T]; load/pv/temperature/heatpump/cost [T, A].
        """
        table = "test_results" if is_testing else "validation_results"
        t = host_array(time).astype(float)
        arrs = [host_array(a).astype(float) for a in (load, pv, temperature, heatpump, cost)]
        n_slots, n_agents = arrs[0].shape
        records = [
            (
                setting,
                implementation,
                a,
                int(day),
                float(t[s]),
                *(arr[s, a] for arr in arrs),
            )
            for a in range(n_agents)
            for s in range(n_slots)
        ]
        with self.con:
            self.con.executemany(
                f"INSERT OR REPLACE INTO {table} VALUES (?,?,?,?,?,?,?,?,?,?)",
                records,
            )

    def log_rounds_decisions(
        self,
        setting: str,
        day: int,
        time: np.ndarray,
        decisions: np.ndarray,
    ) -> None:
        """Per-round heat-pump decisions (community.py:358-361,
        database.py:296-312). decisions: [T, rounds+1, A]."""
        d = host_array(decisions).astype(float)
        t = host_array(time).astype(float)
        n_slots, n_rounds, n_agents = d.shape
        records = [
            (setting, a, int(day), float(t[s]), r, d[s, r, a])
            for a in range(n_agents)
            for r in range(n_rounds)
            for s in range(n_slots)
        ]
        with self.con:
            self.con.executemany(
                "INSERT OR REPLACE INTO rounds_comparison VALUES (?,?,?,?,?,?)",
                records,
            )

    def log_sweep_point(
        self,
        settings: str,
        trial: int,
        episode: int,
        training: float,
        validation: float,
    ) -> None:
        """Hyperparameter-sweep curve point (database.py:160-173)."""
        with self.con:
            self.con.execute(
                "INSERT OR REPLACE INTO hyperparameters_single_day VALUES (?,?,?,?,?)",
                (settings, trial, episode, float(training), float(validation)),
            )

    def log_predictions(
        self,
        settings: str,
        date: Sequence[str],
        time: Sequence[str],
        load: Sequence[float],
        pv: Sequence[float],
        target_load: Sequence[float],
        target_pv: Sequence[float],
    ) -> None:
        """Forecaster outputs vs targets (database.py:176-193)."""
        records = [
            *zip(
                [settings] * len(load),
                date,
                [str(t) for t in time],
                map(float, load),
                map(float, pv),
                map(float, target_load),
                map(float, target_pv),
            )
        ]
        with self.con:
            self.con.executemany(
                "INSERT OR REPLACE INTO single_day_best_results VALUES (?,?,?,?,?,?,?)",
                records,
            )

    def ingest_measurements(self, df) -> None:
        """Load a measurement DataFrame into the ``environment`` + ``load``
        tables (the reference's ``insert_data_from_dict``, database.py:84-93,
        generalized to the l0..l4 load schema).

        Expects columns: date, time, utc, temperature, cloud_cover, humidity,
        pv, and any subset of l0..l4 (missing ones stored as NULL). This is
        the working replacement for the reference's empty
        ``access_smarthor_data_api.py`` ingestion stub.
        """
        n = len(df)
        zeros = [0.0] * n
        env_records = list(
            zip(
                df["date"],
                df["time"],
                df["utc"],
                df.get("temperature", zeros),
                df.get("cloud_cover", zeros),
                df.get("humidity", zeros),
                df.get("irradiation", zeros),
                df.get("pv", zeros),
            )
        )
        nulls = [None] * n
        load_records = list(
            zip(
                df["date"],
                df["time"],
                df["utc"],
                *(df.get(c, nulls) for c in ("l0", "l1", "l2", "l3", "l4")),
            )
        )
        with self.con:
            self.con.executemany(
                "INSERT OR REPLACE INTO environment VALUES (?,?,?,?,?,?,?,?)",
                env_records,
            )
            self.con.executemany(
                "INSERT OR REPLACE INTO load VALUES (?,?,?,?,?,?,?,?)", load_records
            )

    def derive_additional_load(
        self, source_col: str = "l0", target_col: str = "l4", seed: int = 0
    ) -> None:
        """Synthesize an extra household column by day-permuting an existing
        one (the reference's ``generate_additional_load``, database.py:96-125,
        with its undefined-``conn`` bug fixed): clip outliers at 2x median,
        invert around the max, and permute whole days."""
        import pandas as pd

        df = pd.read_sql_query("SELECT * FROM load", self.con)
        if df.empty:
            return
        src = df[source_col].astype(float)
        med2 = src.median() * 2
        src = src.clip(upper=med2)
        max_l = src.max()
        inverted = 1.0 - src / max_l
        df["_day"] = df["date"]
        days = df["_day"].unique().tolist()
        rng = np.random.default_rng(seed)
        order = rng.permutation(len(days))
        permuted = pd.concat(
            [inverted[df["_day"] == days[i]] for i in order]
        ).reset_index(drop=True)
        values = (permuted * max_l).tolist()
        records = list(zip(values, df["date"], df["time"], df["utc"]))
        with self.con:
            self.con.executemany(
                f"UPDATE load SET {target_col} = ? WHERE date = ? AND time = ? AND utc = ?",
                records,
            )

    # -- telemetry warehouse -------------------------------------------------

    def log_eval_run(
        self,
        setting: str,
        implementation: str,
        is_testing: bool,
        config_hash: Optional[str] = None,
        git_rev: Optional[str] = None,
        n_days: Optional[int] = None,
        total_cost_eur: Optional[float] = None,
    ) -> None:
        """Register an eval run's config identity — the join anchor that
        links its per-slot rows to any telemetry run sharing the
        config_hash."""
        with self.con:
            self.con.execute(
                "INSERT OR REPLACE INTO eval_runs VALUES (?,?,?,?,?,?,?,?)",
                (
                    setting, implementation, int(bool(is_testing)),
                    config_hash, git_rev,
                    None if n_days is None else int(n_days),
                    None if total_cost_eur is None else float(total_cost_eur),
                    _time.strftime("%Y-%m-%dT%H:%M:%S%z"),
                ),
            )

    def compact_serve_telemetry(
        self, older_than_hours: float, now: Optional[float] = None
    ) -> dict:
        """Retention policy entry point (``telemetry-query --compact``):
        roll per-request serve telemetry older than ``older_than_hours``
        into per-bucket aggregates. See ``compact_serve_telemetry``."""
        return compact_serve_telemetry(
            self.con, older_than_s=older_than_hours * 3600.0, now=now
        )

    def get_eval_runs(self):
        return self._read("eval_runs")

    def get_telemetry_runs(self):
        return self._read("telemetry_runs")

    def get_telemetry_points(self, run_id: Optional[str] = None):
        if run_id is None:
            return self._read("telemetry_points")
        return self._read("telemetry_points", "WHERE run_id = ?", (run_id,))

    def get_telemetry_spans(self, run_id: Optional[str] = None):
        if run_id is None:
            return self._read("telemetry_spans")
        return self._read("telemetry_spans", "WHERE run_id = ?", (run_id,))

    def query_telemetry_joined(self) -> list:
        """Telemetry runs joined to eval runs on config_hash, as a list of
        dicts (``TELEMETRY_JOIN_SQL``) — the warehouse's headline query."""
        cur = self.con.execute(TELEMETRY_JOIN_SQL)
        cols = [d[0] for d in cur.description]
        return [dict(zip(cols, row)) for row in cur.fetchall()]

    def query_fleet_view(self) -> list:
        """Serving runs aggregated into one fleet view per config_hash
        (``FLEET_VIEW_SQL``): replica/router run counts, serve-trace
        totals, the router's resilience + wire/auth counters, and the
        newest fleet_stats event's per-replica process attribution
        (pid / RSS / restart count), as dicts."""
        cur = self.con.execute(FLEET_VIEW_SQL)
        cols = [d[0] for d in cur.description]
        rows = [dict(zip(cols, row)) for row in cur.fetchall()]
        for row in rows:
            lp = row.get("last_processes")
            if isinstance(lp, str):
                try:
                    row["last_processes"] = json.loads(lp)
                except json.JSONDecodeError:
                    pass
        return rows

    def query_trace_tree(self, trace_id: str) -> list:
        """Every span of one distributed trace, across ALL the runs in
        this warehouse, time-ordered (``TRACE_TREE_SQL``), as dicts with
        ``attrs`` parsed from attrs_json."""
        cur = self.con.execute(TRACE_TREE_SQL, (trace_id,))
        cols = [d[0] for d in cur.description]
        rows = [dict(zip(cols, row)) for row in cur.fetchall()]
        for row in rows:
            raw = row.pop("attrs_json", None)
            try:
                row["attrs"] = json.loads(raw) if raw else {}
            except json.JSONDecodeError:
                row["attrs"] = {}
        return rows

    def query_slowest_traces(self, n: int = 10) -> list:
        """The ``n`` highest-latency histogram exemplars carrying a
        trace_id (``SLOWEST_TRACES_SQL``) — the p99 bucket's link back to
        real traces — as dicts."""
        cur = self.con.execute(SLOWEST_TRACES_SQL, (int(n),))
        cols = [d[0] for d in cur.description]
        return [dict(zip(cols, row)) for row in cur.fetchall()]

    def query_continuous_view(self) -> list:
        """Continuous-vs-microbatch serving attribution per config_hash
        (``CONTINUOUS_VIEW_SQL``): per-batching request/wait/latency totals
        from the ``serve_request`` traces plus the engine-step
        occupancy/slot-wait distribution stats, as dicts."""
        cur = self.con.execute(CONTINUOUS_VIEW_SQL)
        cols = [d[0] for d in cur.description]
        return [dict(zip(cols, row)) for row in cur.fetchall()]

    def query_promotion_view(self) -> list:
        """Candidate bundles aggregated into one deployment-safety view
        per config_hash (``PROMOTION_VIEW_SQL``): gate verdict counts,
        promotions, rollbacks and the newest decision phase, as dicts."""
        cur = self.con.execute(PROMOTION_VIEW_SQL)
        cols = [d[0] for d in cur.description]
        return [dict(zip(cols, row)) for row in cur.fetchall()]

    def query_promotion_lineage(self) -> dict:
        """The promotion ancestry (``promotion_lineage``): time-ordered
        (incumbent -> candidate) links plus the rendered chain."""
        return promotion_lineage(self.con)

    def query_rollback_view(self) -> list:
        """Training runs aggregated into one resilience view per
        config_hash (``ROLLBACK_VIEW_SQL``): rollback/divergence counter
        sums and the last rollback's episode detail, as dicts."""
        cur = self.con.execute(ROLLBACK_VIEW_SQL)
        cols = [d[0] for d in cur.description]
        return [dict(zip(cols, row)) for row in cur.fetchall()]

    def query_regime_view(self) -> list:
        """Per-(config_hash, regime) breakdown of the ``regime_eval``
        events (``REGIME_VIEW_SQL``): mean cost/comfort/trade-energy and
        EV/curtailment attribution per regime, as dicts."""
        cur = self.con.execute(REGIME_VIEW_SQL)
        cols = [d[0] for d in cur.description]
        return [dict(zip(cols, row)) for row in cur.fetchall()]

    def get_run_gauges(self, run_id: str) -> dict:
        """{name: last value} of a run's streamed gauge points."""
        rows = self.con.execute(
            "SELECT name, value FROM telemetry_points "
            "WHERE run_id = ? AND kind = 'gauge' AND name IS NOT NULL "
            "ORDER BY seq",
            (run_id,),
        ).fetchall()
        return {name: value for name, value in rows}

    # -- readers (database.py:212-345) --------------------------------------

    def _read(self, table: str, where: str = "", params: tuple = ()):
        import pandas as pd

        return pd.read_sql_query(f"SELECT * FROM {table} {where}", self.con, params=params)

    def get_training_progress(self):
        return self._read("training_progress")

    def get_training_health(self):
        return self._read("training_health")

    def get_validation_results(self):
        return self._read("validation_results")

    def get_test_results(self):
        return self._read("test_results")

    def get_rounds_decisions(self):
        return self._read("rounds_comparison")

    def get_sweep_data(self):
        return self._read("hyperparameters_single_day")

    def get_predictions(self):
        return self._read("single_day_best_results")


def save_eval_outputs(
    store: ResultsStore,
    setting: str,
    implementation: str,
    is_testing: bool,
    days: np.ndarray,
    outputs,
    arrays_per_day,
    config_hash: Optional[str] = None,
    git_rev: Optional[str] = None,
) -> None:
    """Persist ``evaluate_community`` outputs for every day in one call
    (the reference's save_community_results, community.py:341-361).

    outputs: SlotOutputs with leaves [D, T, ...]; arrays_per_day: EpisodeArrays
    with leaves [D, T, ...] (for the load/pv traces).

    ``config_hash``/``git_rev`` additionally register the eval in
    ``eval_runs`` so telemetry runs of the same config join against it.
    """
    if config_hash is not None or git_rev is not None:
        store.log_eval_run(
            setting, implementation, is_testing,
            config_hash=config_hash, git_rev=git_rev,
            n_days=int(host_array(days).shape[0]),
            total_cost_eur=float(host_array(outputs.cost).sum()),
        )
    for i, day in enumerate(host_array(days).tolist()):
        store.log_run_results(
            setting,
            implementation,
            is_testing,
            day,
            time=host_array(arrays_per_day.time[i]),
            load=host_array(arrays_per_day.load_w[i]),
            pv=host_array(arrays_per_day.pv_w[i]),
            temperature=host_array(outputs.t_in[i]),
            heatpump=host_array(outputs.hp_power_w[i]),
            cost=host_array(outputs.cost[i]),
        )
        if is_testing:
            store.log_rounds_decisions(
                setting,
                day,
                time=host_array(arrays_per_day.time[i]),
                decisions=host_array(outputs.decisions[i]),
            )
