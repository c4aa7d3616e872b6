"""Render a telemetry run directory into a human-readable summary.

The port's copy of the JAX package's ``telemetry/report.py`` (host-only):
it reads the run directories of either package. Backs ``cli.py telemetry-report``: reads ``manifest.json``,
``metrics.jsonl``, ``summary.json`` and ``trace.json`` (whatever subset
exists) and produces a plain-text report — manifest provenance, event
counts, training/health trajectory highlights, device-counter totals and a
span timing table. ``compare_runs`` diffs two runs side by side, keyed by
their manifests' config_hash/git_rev (``telemetry-report --compare A B``):
the manifest carries those fields precisely so a regression can be
attributed to a config change, a code change, or neither.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Optional


def latest_run_dir(root: str) -> Optional[str]:
    """Most recently modified run directory under ``root``."""
    dirs = [d for d in glob.glob(os.path.join(root, "*")) if os.path.isdir(d)]
    return max(dirs, key=os.path.getmtime) if dirs else None


def load_run(run_dir: str) -> dict:
    """{"manifest": dict|None, "events": [dict], "summary": dict|None,
    "warnings": [str]}.

    Degrades gracefully on empty or partially-written run directories — the
    common shape of a crashed or still-running run: a truncated trailing
    JSONL line (the process died mid-write) or a missing/unparseable
    manifest/summary becomes a warning, never an exception, because a
    partial record is exactly when the report matters most.
    """
    out: dict = {
        "run_dir": run_dir, "manifest": None, "events": [], "summary": None,
        "warnings": [],
    }

    def _load_json(path):
        if not os.path.exists(path):
            return None
        try:
            with open(path) as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError) as err:
            out["warnings"].append(
                f"unreadable {os.path.basename(path)} ({err}); skipped"
            )
            return None

    out["manifest"] = _load_json(os.path.join(run_dir, "manifest.json"))
    jpath = os.path.join(run_dir, "metrics.jsonl")
    if os.path.exists(jpath):
        skipped = 0
        try:
            with open(jpath) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        out["events"].append(json.loads(line))
                    except json.JSONDecodeError:
                        skipped += 1
        except OSError as err:
            out["warnings"].append(f"unreadable metrics.jsonl ({err})")
        if skipped:
            out["warnings"].append(
                f"metrics.jsonl: skipped {skipped} truncated/non-JSON "
                f"line(s) — partially written run?"
            )
    out["summary"] = _load_json(os.path.join(run_dir, "summary.json"))
    return out


def _table(rows, headers) -> str:
    widths = [
        max(len(str(h)), *(len(str(r[i])) for r in rows)) if rows else len(str(h))
        for i, h in enumerate(headers)
    ]
    fmt = "  ".join(f"{{:<{w}}}" for w in widths)
    lines = [fmt.format(*headers), fmt.format(*("-" * w for w in widths))]
    lines += [fmt.format(*(str(c) for c in r)) for r in rows]
    return "\n".join(lines)


def render_run(run_dir: str) -> str:
    data = load_run(run_dir)
    parts = [f"telemetry run: {run_dir}"]
    for w in data["warnings"]:
        parts.append(f"WARNING: {w}")

    m = data["manifest"]
    if m:
        keys = (
            "run_id", "created", "backend", "device_kind", "device_count",
            "process_count", "mesh_shape", "mesh_axis_names",
            "config_hash", "setting", "git_rev", "jax", "torch", "cuda",
        )
        rows = [(k, m[k]) for k in keys if m.get(k) is not None]
        parts.append("\nmanifest\n" + _table(rows, ("field", "value")))
    else:
        parts.append("\n(no manifest.json)")

    events = data["events"]
    if events:
        by_kind: dict = {}
        for e in events:
            by_kind[e.get("kind", "?")] = by_kind.get(e.get("kind", "?"), 0) + 1
        parts.append(
            "\nevents (metrics.jsonl)\n"
            + _table(sorted(by_kind.items()), ("kind", "count"))
        )
        health = [e for e in events if e.get("kind") == "health"]
        if health:
            rows = [
                (e.get("episode"), f"{e.get('greedy_cost_eur', float('nan')):.1f}",
                 f"{e.get('greedy_reward', float('nan')):.1f}", e.get("status"))
                for e in health
            ]
            parts.append(
                "\nhealth evals\n"
                + _table(rows, ("episode", "greedy cost €", "greedy reward", "status"))
            )
            alerts = [e for e in events if e.get("kind") == "basin_alert"]
            if alerts:
                parts.append(
                    "\nBASIN ALERTS at episodes: "
                    + ", ".join(str(e.get("episode")) for e in alerts)
                )
        progress = [e for e in events if e.get("kind") == "progress"]
        if progress:
            last = progress[-1]
            parts.append(
                f"\nprogress: {len(progress)} windows, last at episode "
                f"{last.get('episode')} (avg reward "
                f"{last.get('avg_reward', float('nan')):.3f})"
            )

    s = data["summary"]
    if s:
        counters = s.get("counters", {})
        dev = {k: v for k, v in counters.items() if k.startswith("device.")}
        serve = {k: v for k, v in counters.items() if k.startswith("serve.")}
        other = {
            k: v
            for k, v in counters.items()
            if not k.startswith(("device.", "serve."))
        }
        if dev:
            parts.append(
                "\ndevice counters (episode-scan totals)\n"
                + _table(sorted(dev.items()), ("counter", "total"))
            )
        if serve:
            parts.append(
                "\nserve counters (inference engine)\n"
                + _table(sorted(serve.items()), ("counter", "total"))
            )
        if other:
            parts.append(
                "\ncounters\n" + _table(sorted(other.items()), ("counter", "total"))
            )
        gauges = s.get("gauges", {})
        profile = {k: v for k, v in gauges.items() if k.startswith("profile.")}
        plain = {k: v for k, v in gauges.items() if not k.startswith("profile.")}
        if plain:
            parts.append(
                "\ngauges\n" + _table(sorted(plain.items()), ("gauge", "value"))
            )
        if profile:
            # Compile-profile gauges (telemetry/profiling.py): one row per
            # profiled program — HLO flops/bytes and the executable's peak
            # buffer estimate.
            progs: dict = {}
            for k, v in profile.items():
                _, label, metric = k.split(".", 2)
                progs.setdefault(label, {})[metric] = v
            rows = [
                (
                    label,
                    _fmt_num(d.get("flops", "—")),
                    _fmt_num(d.get("bytes_accessed", "—")),
                    _fmt_num(d.get("peak_bytes", "—")),
                )
                for label, d in sorted(progs.items())
            ]
            parts.append(
                "\ncompile profile (HLO cost / executable memory)\n"
                + _table(rows, ("program", "flops", "bytes accessed",
                                "peak bytes"))
            )
        hists = s.get("histograms", {})
        if hists:
            rows = [
                (
                    name,
                    h.get("count"),
                    f"{h.get('mean', float('nan')):.3f}",
                    f"{h.get('p50', float('nan')):.3f}",
                    f"{h.get('p95', float('nan')):.3f}",
                    f"{h.get('max', float('nan')):.3f}",
                )
                for name, h in sorted(hists.items())
                if isinstance(h, dict)
            ]
            if rows:
                parts.append(
                    "\nhistograms\n"
                    + _table(rows, ("histogram", "count", "mean", "p50",
                                    "p95", "max"))
                )
        spans = s.get("spans", {})
        if spans:
            rows = [
                (name, e["count"], f"{e['total_s']:.3f}")
                for name, e in sorted(
                    spans.items(), key=lambda kv: -kv[1]["total_s"]
                )
            ]
            parts.append(
                "\nspans\n" + _table(rows, ("span", "count", "total s"))
            )
    trace = os.path.join(run_dir, "trace.json")
    if os.path.exists(trace):
        parts.append(f"\nchrome trace: {trace} (load in chrome://tracing / Perfetto)")
    return "\n".join(parts) + "\n"


def _fmt_num(v) -> str:
    if isinstance(v, float) and not v.is_integer():
        return f"{v:.4g}"
    return str(v)


def _delta(a, b) -> str:
    try:
        d = float(b) - float(a)
    except (TypeError, ValueError):
        return "?"
    ratio = f" ({float(b) / float(a):.3g}x)" if a not in (0, 0.0) else ""
    return f"{d:+.4g}{ratio}"


def compare_runs(dir_a: str, dir_b: str) -> str:
    """Side-by-side diff of two run directories' summaries.

    The identity block leads: config_hash and git_rev from each manifest,
    flagged ``match`` / ``DIFFERS`` — a metric delta only means something
    once you know whether the config or the code moved under it. Then
    counters, gauges, histogram p50/p95 and span totals, each as
    (A, B, delta) rows; names present in only one run show ``—`` on the
    other side.
    """
    a, b = load_run(dir_a), load_run(dir_b)
    parts = [f"comparing A={dir_a}\n          B={dir_b}"]

    for side, run in (("A", a), ("B", b)):
        for w in run["warnings"]:
            parts.append(f"WARNING ({side}): {w}")

    ma, mb = a["manifest"] or {}, b["manifest"] or {}
    rows = []
    for key in ("config_hash", "git_rev", "setting", "backend", "device_kind",
                "device_count", "mesh_shape", "mesh_axis_names",
                "run_id", "created"):
        va, vb = ma.get(key), mb.get(key)
        if va is None and vb is None:
            continue
        flag = "match" if va == vb else "DIFFERS"
        rows.append((key, va, vb, flag))
    parts.append("\nidentity\n" + _table(rows, ("field", "A", "B", "")))

    sa, sb = a["summary"] or {}, b["summary"] or {}

    def diff_section(title, da, db, fmt=lambda v: v):
        names = sorted(set(da) | set(db))
        if not names:
            return
        rows = []
        for name in names:
            va, vb = da.get(name), db.get(name)
            rows.append((
                name,
                "—" if va is None else _fmt_num(fmt(va)),
                "—" if vb is None else _fmt_num(fmt(vb)),
                _delta(fmt(va), fmt(vb)) if va is not None and vb is not None
                else "",
            ))
        parts.append(f"\n{title}\n" + _table(rows, ("name", "A", "B", "delta")))

    diff_section("counters", sa.get("counters", {}), sb.get("counters", {}))
    diff_section("gauges", sa.get("gauges", {}), sb.get("gauges", {}))
    diff_section(
        "histogram p95",
        sa.get("histograms", {}),
        sb.get("histograms", {}),
        fmt=lambda h: h.get("p95") if isinstance(h, dict) else h,
    )
    diff_section(
        "span total_s",
        sa.get("spans", {}),
        sb.get("spans", {}),
        fmt=lambda s: s.get("total_s") if isinstance(s, dict) else s,
    )
    return "\n".join(parts) + "\n"

# -- distributed-trace analysis -----------------------------------------------
#
# The span-dict shape below is what ``ResultsStore.query_trace_tree``
# returns: trace_id / span_id / parent_span_id / name / ts (epoch seconds) /
# duration_s / process / attrs (parsed attrs_json) / run_id.

_ROOT_SPAN_PREFERENCE = ("client.request", "router.act", "proxy.act")


def _span_index(spans):
    by_id = {}
    for s in spans:
        sid = s.get("span_id")
        if sid and sid not in by_id:
            by_id[sid] = s
    return by_id


def _find_root(spans):
    """The span whose duration is the request's wall time: the outermost
    recorded observer (client > router > proxy), falling back to the
    longest span — a partial tree (a killed process never flushed its
    root) still decomposes against the best cover we have."""
    for name in _ROOT_SPAN_PREFERENCE:
        named = [s for s in spans if s.get("name") == name]
        if named:
            return max(named, key=lambda s: s.get("duration_s") or 0.0)
    return max(spans, key=lambda s: s.get("duration_s") or 0.0)


def _descends_from(span, ancestor_id, by_id, _limit=64):
    sid = span.get("parent_span_id")
    for _ in range(_limit):
        if sid is None:
            return False
        if sid == ancestor_id:
            return True
        parent = by_id.get(sid)
        sid = parent.get("parent_span_id") if parent else None
    return False


def trace_critical_path(spans) -> Optional[dict]:
    """Decompose ONE trace's end-to-end wall time into additive segments:

    ``retry_ms``    backoff sleeps + every FAILED attempt's wall time
    ``queue_wait_ms`` enqueue->dispatch coalescing wait (winning attempt)
    ``padding_ms``  the padded-lane share of engine execution
    ``execute_ms``  engine execution net of padding
    ``wire_ms``     the remainder: serialization, sockets, framing, auth

    The segments sum to ``total_ms`` (the root span's duration) by
    construction — wire is computed as the remainder, clamped at zero —
    so per-segment attribution is exact against the measured latency, not
    a sum of possibly-overlapping child spans."""
    spans = [s for s in spans if s.get("duration_s") is not None]
    if not spans:
        return None
    by_id = _span_index(spans)
    root = _find_root(spans)
    total_ms = (root.get("duration_s") or 0.0) * 1e3

    attempts = [s for s in spans if s.get("name") == "router.attempt"]
    failed = [
        s for s in attempts
        if (s.get("attrs") or {}).get("status") != 200
    ]
    backoffs = [s for s in spans if s.get("name") == "router.backoff"]
    retry_ms = sum(s["duration_s"] for s in failed + backoffs) * 1e3

    winners = [
        s for s in attempts if (s.get("attrs") or {}).get("status") == 200
    ]
    win_id = winners[-1]["span_id"] if winners else None

    def on_winning_path(span):
        # No router in the tree (single-process gateway trace): every
        # queue/engine span is on the one path there is.
        if win_id is None:
            return not any(
                _descends_from(span, f["span_id"], by_id) for f in failed
            )
        return _descends_from(span, win_id, by_id)

    queue_wait_ms = sum(
        s["duration_s"] for s in spans
        if s.get("name") == "queue.wait" and on_winning_path(s)
    ) * 1e3
    executes = [
        s for s in spans
        if s.get("name") == "engine.execute" and on_winning_path(s)
    ]
    execute_raw_ms = sum(s["duration_s"] for s in executes) * 1e3
    padding_ms = sum(
        s["duration_s"]
        * (s.get("attrs") or {}).get("padded_rows", 0)
        / max(1, (s.get("attrs") or {}).get("bucket", 1))
        for s in executes
    ) * 1e3
    wire_ms = max(
        0.0, total_ms - retry_ms - queue_wait_ms - execute_raw_ms
    )
    return {
        "trace_id": root.get("trace_id"),
        "root": root.get("name"),
        "total_ms": round(total_ms, 3),
        "wire_ms": round(wire_ms, 3),
        "queue_wait_ms": round(queue_wait_ms, 3),
        "padding_ms": round(padding_ms, 3),
        "execute_ms": round(execute_raw_ms - padding_ms, 3),
        "retry_ms": round(retry_ms, 3),
        "n_spans": len(spans),
        "n_processes": len({s.get("process") for s in spans
                            if s.get("process")}),
    }


def aggregate_critical_paths(trees) -> dict:
    """Percentile critical paths over many traces: sort by each tree's
    root duration, pick the p50/p95/p99 exemplar trace, decompose it.
    ``trees`` is a list of span lists (one per trace)."""
    decomposed = [
        cp for cp in (trace_critical_path(t) for t in trees) if cp
    ]
    decomposed.sort(key=lambda cp: cp["total_ms"])
    out = {"n_traces": len(decomposed)}
    if not decomposed:
        return out
    for label, q in (("p50", 0.50), ("p95", 0.95), ("p99", 0.99)):
        idx = min(len(decomposed) - 1, int(q * (len(decomposed) - 1) + 0.5))
        out[label] = decomposed[idx]
    return out


def render_trace_tree(spans) -> str:
    """Plain-text tree of one trace: indentation by parent chain, per-span
    duration, process and the attrs that matter for triage."""
    spans = sorted(
        [s for s in spans if s.get("span_id")],
        key=lambda s: (s.get("ts") or 0.0),
    )
    if not spans:
        return "(no spans)"
    by_id = _span_index(spans)
    children: dict = {}
    roots = []
    for s in spans:
        pid = s.get("parent_span_id")
        if pid and pid in by_id:
            children.setdefault(pid, []).append(s)
        else:
            roots.append(s)
    lines = [f"trace {spans[0].get('trace_id')} — {len(spans)} span(s), "
             f"{len({s.get('process') for s in spans if s.get('process')})} "
             f"process(es)"]

    def walk(span, depth):
        attrs = span.get("attrs") or {}
        keep = {
            k: v for k, v in attrs.items()
            if k in ("replica_id", "status", "failover", "try_index",
                     "bucket", "padded_rows", "batch_size", "linked",
                     "estimated", "retries", "failovers", "household", "hop")
            and v is not None
        }
        extra = (
            " " + " ".join(f"{k}={v}" for k, v in sorted(keep.items()))
            if keep else ""
        )
        dur = span.get("duration_s")
        lines.append(
            f"{'  ' * depth}{span.get('name')}  "
            f"[{(dur or 0.0) * 1e3:.2f} ms]"
            f"  @{span.get('process') or '?'}{extra}"
        )
        for child in sorted(
            children.get(span.get("span_id"), []),
            key=lambda s: (s.get("ts") or 0.0),
        ):
            walk(child, depth + 1)

    for root in roots:
        walk(root, 1)
    return "\n".join(lines)


def chrome_trace_export(spans) -> dict:
    """Merged Chrome-trace (Perfetto-loadable) JSON for ONE distributed
    trace: every process in the tree becomes its own pid lane, spans
    become complete ("X") events on per-span tids so concurrent children
    never visually occlude each other. Timestamps are rebased to the
    earliest span (microseconds), so cross-process clock offsets read as
    honest skew rather than hiding it."""
    spans = [s for s in spans if s.get("duration_s") is not None]
    if not spans:
        return {"traceEvents": [], "displayTimeUnit": "ms"}
    t_min = min(s.get("ts") or 0.0 for s in spans)
    procs = sorted({s.get("process") or "?" for s in spans})
    pid_of = {p: i for i, p in enumerate(procs)}
    events = [
        {
            "ph": "M", "name": "process_name", "pid": pid_of[p], "tid": 0,
            "args": {"name": p},
        }
        for p in procs
    ]
    lane: dict = {}
    for s in sorted(spans, key=lambda s: (s.get("ts") or 0.0)):
        pid = pid_of[s.get("process") or "?"]
        tid = lane.get(pid, 0)
        lane[pid] = tid + 1
        args = dict(s.get("attrs") or {})
        args["span_id"] = s.get("span_id")
        if s.get("parent_span_id"):
            args["parent_span_id"] = s["parent_span_id"]
        events.append({
            "ph": "X",
            "name": s.get("name") or "span",
            "cat": "trace",
            "pid": pid,
            "tid": tid,
            "ts": round(((s.get("ts") or 0.0) - t_min) * 1e6, 1),
            "dur": round(s["duration_s"] * 1e6, 1),
            "args": args,
        })
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {"trace_id": spans[0].get("trace_id")},
    }
