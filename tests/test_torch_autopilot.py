"""The port's autopilot on the CPU: crash-safe unattended continual
deployment over the port's fleet.

Against the JAX package: a cycle journal written by one package verifies
under the other's ``read_journal`` (the same ``_state_digest``), and a
cycle's row carries the JAX row's keys (the same cycle in both packages,
its gate, canary and serving check stubbed alike) plus the port's
``kernel_launches``. Then port copies of the contracts of
``tests/test_autopilot.py`` with ``device="cpu"`` (A=3): the journal, the
export handshake, settlement, the server-side SLO, admin register, the
honest cycle (fewer requests) and the SIGKILL recovery (a shorter kill
window, fewer requests), run as ``python -m p2pmicrogrid_tpu_torch
autopilot``. The post-cycle invariant sends its check requests one at a
time and holds each answer to the engine's act on that one observation.
"""

import io
import json
import os
import signal
import subprocess
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

from p2pmicrogrid_tpu_torch.config import SimConfig, TrainConfig, default_config
from p2pmicrogrid_tpu_torch.data.results import (
    ResultsStore,
    acquire_export_lease,
    last_export_watermark,
    release_export_lease,
)
from p2pmicrogrid_tpu_torch.data.trace_export import (
    TracesCompactedError,
    bill_decisions,
    export_serve_traces,
    settlement_reward_fn,
)
from p2pmicrogrid_tpu_torch.serve import autopilot as tap
from p2pmicrogrid_tpu_torch.serve.autopilot import (
    Autopilot,
    AutopilotState,
    JournalCorrupt,
    journal_path,
    parse_inject_plan,
    read_journal,
    write_journal,
)
from p2pmicrogrid_tpu_torch.serve.loadgen import synthetic_obs
from p2pmicrogrid_tpu_torch.serve.promotion import make_crafted_bundle

A = 3


def _cfg(seed=0):
    return default_config(
        sim=SimConfig(n_agents=A),
        train=TrainConfig(implementation="tabular", seed=seed),
    )


# -- against the JAX package -------------------------------------------------------


def _journal_state():
    return AutopilotState(
        cycle=2, phase="canarying", incumbent_dir="/b/inc", incumbent_hash="inc",
        candidate_dir="/b/cand", candidate_hash="cand", inject_kind="good",
        window_start_ts=1234.5, lease_id="lease-1", promotions=1, blocked=1,
        n_requests=96, n_ok=95, n_shed=1,
        lineage=[{"cycle": 0, "incumbent": "a", "candidate": "inc", "ts": 1.25}],
    )


def test_journal_verifies_across_packages(tmp_path):
    from p2pmicrogrid_tpu.serve import autopilot as jap

    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    write_journal(port_dir, _journal_state())
    back = jap.read_journal(port_dir)
    assert back.to_doc() == read_journal(port_dir).to_doc()
    jstate = jap.AutopilotState(**_journal_state().to_doc())
    jap.write_journal(jax_dir, jstate)
    mine = read_journal(jax_dir)
    assert mine.to_doc() == jstate.to_doc()
    for d in (port_dir, jax_dir):
        record = json.load(open(journal_path(d)))
        assert record["digest"] == tap._state_digest(record["state"])
        assert record["digest"] == jap._state_digest(record["state"])
        assert record["kind"] == jap.JOURNAL_KIND
        assert record["format_version"] == jap.JOURNAL_FORMAT_VERSION


class _RouterStub:
    """The router surface one cycle touches with its gate, canary and
    serving check stubbed."""

    def __init__(self):
        self.known_bundles = {}

    async def flush_fleet(self):
        return None

    async def unregister_fleet(self, config_hash):
        return None


@pytest.mark.parametrize("outcome", ["blocked", "promoted"])
def test_cycle_row_carries_the_jax_keys(outcome, tmp_path, monkeypatch):
    """The same cycle in both packages over the same seeded warehouse (the
    export and the crafted candidate run for real; the gate's verdict, the
    canary's result and the serving check are stubbed alike): the port's
    row has every key of the JAX row, and ``kernel_launches`` besides."""
    from p2pmicrogrid_tpu.config import SimConfig as JSim
    from p2pmicrogrid_tpu.config import TrainConfig as JTrain
    from p2pmicrogrid_tpu.config import default_config as j_default
    from p2pmicrogrid_tpu.serve import autopilot as jap
    from p2pmicrogrid_tpu.serve import promotion as jpromo
    from p2pmicrogrid_tpu_torch.serve import promotion as tpromo

    def run(pkg, promo, cfg, root, **kw):
        inc = promo.make_crafted_bundle(cfg, "incumbent", str(root / "inc"), **kw)
        manifest = json.load(open(os.path.join(inc, "manifest.json")))
        db = str(root / "wh.db")
        _seed_decisions(db, n=6, hash_=manifest["config_hash"], t0=time.time() - 60)
        pilot = pkg.Autopilot(
            cfg, _RouterStub(), incumbent_dir=inc, state_dir=str(root / "state"),
            results_db=db, settlement=False, min_transitions=1,
            **({"serve_device": "cpu"} if kw else {}),
        )
        monkeypatch.setattr(pilot, "_drive_traffic", lambda *a, **k: types.SimpleNamespace(
            n_requests=0, n_ok=0, n_shed=0))
        monkeypatch.setattr(pilot, "_gate", lambda cand_dir: promo.GateVerdict(
            passed=outcome == "promoted", candidate="c", incumbent="i", candidate_cost=1.0,
            incumbent_cost=2.0, candidate_reward=0.0, incumbent_reward=0.0, p95_ms=1.0,
            p99_ms=1.0, shed_rate=0.0, reasons=[] if outcome == "promoted" else ["cost"]))
        monkeypatch.setattr(pilot, "_canary", lambda *a: promo.CanaryResult(promoted=True))
        monkeypatch.setattr(pilot, "_verify_incumbent_serving", lambda: True)
        return pilot.run_cycle("good" if outcome == "promoted" else "cost_regressed")

    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    mine = run(tap, tpromo, _cfg(), tmp_path / "port", device="cpu")
    jcfg = j_default(sim=JSim(n_agents=A), train=JTrain(implementation="tabular", seed=0))
    ref = run(jap, jpromo, jcfg, tmp_path / "jax")
    assert set(ref) <= set(mine)
    assert set(mine) - set(ref) == {"kernel_launches"}
    assert mine["kernel_launches"] == {name: 0 for name in mine["kernel_launches"]}
    assert {k: mine[k] for k in ("promoted", "blocked_at_gate", "outcome_ok", "trace_transitions")} == {
        k: ref[k] for k in ("promoted", "blocked_at_gate", "outcome_ok", "trace_transitions")}


def test_entry_points_default_to_the_card(tmp_path, monkeypatch):
    cfg = _cfg()
    inc = make_crafted_bundle(cfg, "incumbent", str(tmp_path / "inc"), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Autopilot(cfg, _RouterStub(), inc, str(tmp_path / "s"), str(tmp_path / "db"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tap.autopilot_bench(cfg, str(tmp_path / "w"))
    assert not (tmp_path / "s").exists() and not (tmp_path / "w").exists()


# -- journal -------------------------------------------------------------------


class TestJournal:
    def test_round_trip(self, tmp_path):
        state = AutopilotState(
            cycle=3, phase="gating", incumbent_hash="inc",
            candidate_hash="cand", promotions=2,
            lineage=[{"cycle": 0, "incumbent": "a", "candidate": "inc",
                      "ts": 1.0}],
        )
        write_journal(str(tmp_path), state)
        back = read_journal(str(tmp_path))
        assert back.cycle == 3 and back.phase == "gating"
        assert back.lineage[0]["candidate"] == "inc"
        # No temp litter after a successful atomic write.
        leftovers = [f for f in os.listdir(tmp_path) if ".tmp" in f]
        assert leftovers == []

    def test_missing_reads_none(self, tmp_path):
        assert read_journal(str(tmp_path)) is None

    def test_corrupt_digest_fails_loud(self, tmp_path):
        write_journal(str(tmp_path), AutopilotState(cycle=1))
        path = journal_path(str(tmp_path))
        record = json.load(open(path))
        record["state"]["cycle"] = 99  # tamper without re-digesting
        json.dump(record, open(path, "w"))
        with pytest.raises(JournalCorrupt, match="digest"):
            read_journal(str(tmp_path))

    def test_torn_write_fails_loud(self, tmp_path):
        write_journal(str(tmp_path), AutopilotState(cycle=1))
        path = journal_path(str(tmp_path))
        raw = open(path).read()
        open(path, "w").write(raw[: len(raw) // 2])
        with pytest.raises(JournalCorrupt, match="unreadable"):
            read_journal(str(tmp_path))

    def test_unknown_phase_fails_loud(self, tmp_path):
        state = AutopilotState(cycle=0)
        state.phase = "warp-drive"
        write_journal(str(tmp_path), state)
        with pytest.raises(JournalCorrupt, match="phase"):
            read_journal(str(tmp_path))

    def test_parse_inject_plan(self):
        plan = parse_inject_plan("0:good, 2:nan_poisoned,3:continual")
        assert plan == {0: "good", 2: "nan_poisoned", 3: None}
        assert parse_inject_plan(None) == {}
        with pytest.raises(ValueError, match="unknown inject kind"):
            parse_inject_plan("0:sabotage")


# -- export/retention handshake ------------------------------------------------


def _seed_decisions(db, n=8, household="h1", hash_="hash-1", t0=1000.0):
    """A serve-role run with n pairable decisions at 1s spacing."""
    store = ResultsStore(db)
    store.con.execute(
        "INSERT OR REPLACE INTO telemetry_runs VALUES "
        "(?,?,?,?,?,?,?,?,?,?,?,?)",
        ("run-1", None, hash_, None, None, None, None, None, None,
         None, None, json.dumps({"serve_role": "default"})),
    )
    obs = synthetic_obs(n, A, seed=1)
    rows = [
        ("run-1", seq, t0 + seq, "serve_decision", None, None,
         json.dumps({"obs": obs[seq].tolist(), "action": [0.5] * A,
                     "household": household, "row": 0}))
        for seq in range(n)
    ]
    store.con.executemany(
        "INSERT INTO telemetry_points VALUES (?,?,?,?,?,?,?)", rows
    )
    store.con.commit()
    store.close()
    return obs


class TestExportHandshake:
    def test_active_lease_caps_compaction(self, tmp_path):
        db = str(tmp_path / "wh.db")
        t0 = time.time() - 100.0  # real-clock anchored: the lease TTL and
        _seed_decisions(db, n=8, t0=t0)  # the cutoff both use now()
        store = ResultsStore(db)
        lease = acquire_export_lease(
            store.con, "autopilot", window_start_ts=t0 + 4.0, ttl_s=600,
            config_hash="hash-1",
        )
        # Retention wants everything older than now gone — the lease
        # caps the cutoff at its window start instead.
        out = store.compact_serve_telemetry(older_than_hours=0.0)
        assert out["lease_capped"] is True
        (left,) = store.con.execute(
            "SELECT COUNT(*) FROM telemetry_points "
            "WHERE kind='serve_decision'"
        ).fetchone()
        assert left == 4  # ts t0+4..t0+7 survived
        # The export window (>= t0+4) is intact: no overlap, no refusal.
        ds = export_serve_traces(db, cfg=_cfg(), since_ts=t0 + 4.0, device="cpu")
        assert ds.n_transitions == 3
        release_export_lease(store.con, lease, exported_through_ts=t0 + 7.0)
        assert last_export_watermark(store.con, "hash-1") == pytest.approx(
            t0 + 7.0
        )
        # A decision served in the GAP after the release: retention must
        # not overtake the released watermark while unexported work
        # exists past it.
        store.con.execute(
            "INSERT INTO telemetry_points VALUES (?,?,?,?,?,?,?)",
            ("run-1", 99, t0 + 20.0, "serve_decision", None, None,
             json.dumps({"obs": [[0.0] * 4] * A, "action": [0.5] * A,
                         "household": "h1", "row": 0})),
        )
        store.con.commit()
        out = store.compact_serve_telemetry(older_than_hours=0.0)
        assert out["lease_capped"] is True
        assert out["cutoff_ts"] == pytest.approx(t0 + 7.0, abs=0.01)
        (left,) = store.con.execute(
            "SELECT COUNT(*) FROM telemetry_points "
            "WHERE kind='serve_decision'"
        ).fetchone()
        assert left == 2  # the frontier decision + the gap decision
        # The next cycle's export advances the frontier past the gap
        # decision, so retention follows it.
        lease2 = acquire_export_lease(
            store.con, "autopilot", window_start_ts=t0 + 7.0, ttl_s=600,
            config_hash="hash-1",
        )
        release_export_lease(store.con, lease2, exported_through_ts=t0 + 21.0)
        out = store.compact_serve_telemetry(older_than_hours=0.0)
        assert out["cutoff_ts"] == pytest.approx(t0 + 21.0, abs=0.01)
        (left,) = store.con.execute(
            "SELECT COUNT(*) FROM telemetry_points "
            "WHERE kind='serve_decision'"
        ).fetchone()
        assert left == 0
        # Retirement: a config that stops exporting stops gating one
        # lease TTL after its last release — the frontier must never pin
        # retention forever (simulated by aging the leases past expiry).
        store.con.execute(
            "UPDATE export_leases SET expires_ts = ?", (time.time() - 1,)
        )
        store.con.commit()
        out = store.compact_serve_telemetry(older_than_hours=0.0)
        assert out["lease_capped"] is False
        store.close()

    def test_expired_lease_stops_gating(self, tmp_path):
        db = str(tmp_path / "wh.db")
        _seed_decisions(db, n=4, t0=1000.0)
        store = ResultsStore(db)
        acquire_export_lease(
            store.con, "crashed-autopilot", window_start_ts=1000.0,
            ttl_s=1.0, now=1000.0,
        )
        # Long past the TTL: the crashed holder's lease must not block
        # retention forever.
        out = store.compact_serve_telemetry(older_than_hours=0.0)
        assert out["lease_capped"] is False
        assert out["decisions_compacted"] == 4
        store.close()

    def test_cancelled_lease_stops_gating_immediately(self, tmp_path):
        """A FAILED export cancels its lease outright (no fake watermark,
        no TTL wait) — retention resumes on the next pass."""
        from p2pmicrogrid_tpu_torch.data.results import cancel_export_lease

        db = str(tmp_path / "wh.db")
        t0 = time.time() - 100.0
        _seed_decisions(db, n=4, t0=t0)
        store = ResultsStore(db)
        lease = acquire_export_lease(
            store.con, "doomed", window_start_ts=t0, ttl_s=600
        )
        assert store.compact_serve_telemetry(
            older_than_hours=0.0
        )["lease_capped"] is True
        cancel_export_lease(store.con, lease)
        out = store.compact_serve_telemetry(older_than_hours=0.0)
        assert out["lease_capped"] is False
        assert out["decisions_compacted"] == 4
        # No watermark was fabricated by the cancel.
        assert last_export_watermark(store.con, None) is None
        store.close()

    def test_forced_race_still_fails_loud(self, tmp_path):
        """Compaction into the export window (no lease / ignored lease)
        must still raise TracesCompactedError — the backstop contract."""
        db = str(tmp_path / "wh.db")
        _seed_decisions(db, n=8, t0=1000.0)
        store = ResultsStore(db)
        # Aggregate marker overlapping the window (ts_max inside it).
        store.con.execute(
            "INSERT INTO telemetry_points VALUES (?,?,?,?,?,?,?)",
            ("run-1", 1 << 41, 1006.0, "serve_request_agg", "bucket_1",
             4.0, json.dumps({"bucket": 1, "ts_min": 1000.0,
                              "ts_max": 1006.0})),
        )
        store.con.commit()
        store.close()
        with pytest.raises(TracesCompactedError, match="export lease"):
            export_serve_traces(db, cfg=_cfg(), since_ts=1004.0, device="cpu")

    def test_window_scoped_refusal_boundary(self, tmp_path):
        db = str(tmp_path / "wh.db")
        _seed_decisions(db, n=8, t0=1000.0)
        store = ResultsStore(db)
        store.con.execute(
            "INSERT INTO telemetry_points VALUES (?,?,?,?,?,?,?)",
            ("run-1", 1 << 41, 1003.0, "serve_request_agg", "bucket_1",
             4.0, json.dumps({"bucket": 1, "ts_min": 1000.0,
                              "ts_max": 1003.0})),
        )
        store.con.commit()
        store.close()
        # Window starts past the compacted tail: scheduled, not a race.
        ds = export_serve_traces(db, cfg=_cfg(), since_ts=1004.0, device="cpu")
        assert ds.n_transitions == 3
        # Unwindowed export still refuses (pre-handshake contract).
        with pytest.raises(TracesCompactedError):
            export_serve_traces(db, cfg=_cfg(), device="cpu")


# -- metered settlement --------------------------------------------------------


class TestSettlement:
    def test_billed_rows_attribute_reward(self, tmp_path):
        db = str(tmp_path / "wh.db")
        _seed_decisions(db, n=6, t0=1000.0)
        cfg = _cfg()
        # A meter that bills DOUBLE: the joined reward must reflect the
        # bill, not the env model — that difference is the whole point.
        billed = bill_decisions(
            db, cfg, bill_fn=lambda obs, act: np.full(A, 2.0, np.float32),
            device="cpu",
        )
        assert billed == 6
        warn = io.StringIO()
        ds = export_serve_traces(
            db, cfg=cfg,
            reward_fn=settlement_reward_fn(db, cfg, warn_stream=warn, device="cpu"),
            device="cpu",
        )
        assert ds.n_transitions == 5
        assert "settlement WARNING" not in warn.getvalue()
        from p2pmicrogrid_tpu_torch.ops.thermal import comfort_penalty

        t_in = ds.obs[..., 1] * cfg.thermal.margin + cfg.thermal.setpoint
        want = -(2.0 + 10.0 * comfort_penalty(cfg.thermal, torch.from_numpy(t_in)).numpy())
        np.testing.assert_allclose(ds.reward, want, rtol=1e-5)

    def test_missing_rows_fall_back_loud(self, tmp_path):
        from p2pmicrogrid_tpu_torch.data.trace_export import trace_reward

        db = str(tmp_path / "wh.db")
        _seed_decisions(db, n=6, t0=1000.0)
        cfg = _cfg()
        warn = io.StringIO()
        ds = export_serve_traces(
            db, cfg=cfg,
            reward_fn=settlement_reward_fn(db, cfg, warn_stream=warn, device="cpu"),
            device="cpu",
        )
        # No settlement rows at all: EVERY transition falls back, and the
        # warning says so — never silent.
        assert "settlement WARNING: 5/5" in warn.getvalue()
        np.testing.assert_allclose(
            ds.reward, trace_reward(cfg, ds.obs, ds.action, device="cpu"), rtol=1e-6
        )


# -- server-side SLO attribution -----------------------------------------------


class _RegistryStub:
    """The minimal registry surface a controller with explicit routing
    hooks still touches."""

    default_hash = "inc"
    split = None

    def set_split(self, *a):
        pass

    def clear_split(self):
        pass

    def clear_pins(self):
        pass

    def swap(self, *a):
        pass


class TestServerSideSLO:
    def _warehouse_with_spans(self, db, hash_, latencies, since=100.0):
        store = ResultsStore(db)
        store.con.execute(
            "INSERT OR REPLACE INTO telemetry_runs VALUES "
            "(?,?,?,?,?,?,?,?,?,?,?,?)",
            (f"run-{hash_}", None, hash_, None, None, None, None, None,
             None, None, None, json.dumps({"serve_role": "default"})),
        )
        rows = [
            (f"run-{hash_}", i, since + 1.0 + i, "serve_request", None,
             None, json.dumps({"latency_ms": lat}))
            for i, lat in enumerate(latencies)
        ]
        store.con.executemany(
            "INSERT INTO telemetry_points VALUES (?,?,?,?,?,?,?)", rows
        )
        store.con.commit()
        store.close()

    def test_slow_arm_cannot_hide_behind_fast_client_clock(self, tmp_path):
        from p2pmicrogrid_tpu_torch.serve.promotion import (
            CanaryBudgets,
            CanaryController,
            StagePlan,
            StageTraffic,
        )

        db = str(tmp_path / "wh.db")
        self._warehouse_with_spans(db, "cand", [900.0] * 16)
        self._warehouse_with_spans(db, "inc", [1.0] * 16)
        _Reg = _RegistryStub

        controller = CanaryController(
            _Reg(), candidate_hash="cand", incumbent_hash="inc",
            stages=(100.0,),
            budgets=CanaryBudgets(slo_p95_ms=500.0, min_requests=4),
            results_db=db, device="cpu",
        )
        n = 8
        # The CLIENT saw nothing wrong: fast statuses/latencies.
        traffic = StageTraffic(
            statuses=np.full(n, 200), latencies_ms=np.full(n, 2.0),
            config_hashes=["cand"] * n, actions=[[0.0] * A] * n,
            households=[f"h{i}" for i in range(n)],
        )
        plan = StagePlan(index=0, percent=100.0, is_promote=True)
        report = controller._evaluate_stage(plan, traffic, since_ts=100.0)
        assert not report.ok
        assert any("p95" in r for r in report.reasons)
        cand_arm = report.arms["cand"]
        # Server-side number judged; the wire number demoted to detail.
        assert cand_arm["p95_ms"] > 500.0
        assert cand_arm["client_p95_ms"] <= 2.0
        assert cand_arm["server_requests"] == 16

    def test_no_server_rows_keeps_client_latency(self, tmp_path):
        from p2pmicrogrid_tpu_torch.serve.promotion import (
            CanaryBudgets,
            CanaryController,
            StagePlan,
            StageTraffic,
        )

        db = str(tmp_path / "wh.db")
        ResultsStore(db).close()
        _Reg = _RegistryStub

        controller = CanaryController(
            _Reg(), candidate_hash="cand", incumbent_hash="inc",
            stages=(100.0,), budgets=CanaryBudgets(min_requests=4),
            results_db=db, device="cpu",
        )
        n = 4
        traffic = StageTraffic(
            statuses=np.full(n, 200), latencies_ms=np.full(n, 3.0),
            config_hashes=["cand"] * n, actions=[[0.0] * A] * n,
            households=[f"h{i}" for i in range(n)],
        )
        plan = StagePlan(index=0, percent=100.0, is_promote=True)
        report = controller._evaluate_stage(plan, traffic, since_ts=0.0)
        assert report.ok
        assert "client_p95_ms" not in report.arms["cand"]


# -- live fleet fixtures -------------------------------------------------------


@pytest.fixture(scope="module")
def crafted_incumbent(tmp_path_factory):
    cfg = _cfg()
    root = tmp_path_factory.mktemp("autopilot-bundles")
    return cfg, make_crafted_bundle(
        cfg, "incumbent", str(root / "incumbent"), device="cpu"
    )


def _local_fleet(incumbent, db, n=2):
    """Admission effectively off, as in the fleet tests: these check
    serving semantics, and on a loaded machine the default 50 ms wait
    budget sheds the post-cycle check's requests with 429 (its
    ``serving_verified`` then reads False)."""
    from p2pmicrogrid_tpu_torch.serve.gateway import AdmissionConfig
    from p2pmicrogrid_tpu_torch.serve.router import LocalFleet

    return LocalFleet(
        [incumbent], n_replicas=n, max_batch=16, results_db=db,
        device="cpu", run_name="autopilot-test",
        admission=AdmissionConfig(max_queue_depth=100_000, wait_budget_ms=100_000.0),
    )


# -- dynamic bundle registration ----------------------------------------------


def _admin_post(host, port, path, payload):
    import http.client

    conn = http.client.HTTPConnection(host, port, timeout=30)
    try:
        conn.request(
            "POST", path, body=json.dumps(payload),
            headers={"Content-Type": "application/json"},
        )
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


class TestAdminRegister:
    def test_register_route_unregister_flush(self, crafted_incumbent,
                                             tmp_path):
        import dataclasses as dc

        from p2pmicrogrid_tpu_torch.serve.engine import PolicyEngine
        from p2pmicrogrid_tpu_torch.serve.gateway import (
            GatewayServer,
            build_gateway,
        )

        cfg, incumbent = crafted_incumbent
        cand_cfg = cfg.replace(
            train=dc.replace(cfg.train, starting_episodes=777)
        )
        cand_dir = make_crafted_bundle(
            cand_cfg, "good", str(tmp_path / "cand"), device="cpu"
        )
        db = str(tmp_path / "wh.db")
        gateway = build_gateway(
            [incumbent], max_batch=16, device="cpu", results_db=db
        )
        server = GatewayServer(gateway)
        host, port = server.start()
        try:
            status, doc = _admin_post(
                host, port, "/admin/register", {"bundle_dir": cand_dir}
            )
            assert status == 200 and doc["already_registered"] is False
            cand_hash = doc["config_hash"]
            assert cand_hash in doc["bundles"]
            # Idempotent: a fleet push retrying must converge, not 409.
            status, doc = _admin_post(
                host, port, "/admin/register", {"bundle_dir": cand_dir}
            )
            assert status == 200 and doc["already_registered"] is True
            # The runtime-registered bundle actually serves: swap to it
            # and check a real act answer bit-exact against its engine.
            status, _ = _admin_post(
                host, port, "/admin/swap", {"config_hash": cand_hash}
            )
            assert status == 200
            obs = synthetic_obs(2, A, seed=5)
            status, doc = _admin_post(
                host, port, "/v1/act",
                {"household": "h-reg", "obs": obs[0].tolist()},
            )
            assert status == 200 and doc["config_hash"] == cand_hash
            want = PolicyEngine(
                bundle_dir=cand_dir, max_batch=16, device="cpu"
            ).act(obs[:1])[0]
            # host-sync: wire JSON payloads, host data.
            np.testing.assert_array_equal(
                np.asarray(doc["actions"], np.float32), want
            )
            # The default cannot be unregistered (sequencing error)...
            status, doc = _admin_post(
                host, port, "/admin/unregister", {"config_hash": cand_hash}
            )
            assert status == 409
            # ...but after swapping back it can, and the registry shrinks.
            inc_hash = [
                h for h in gateway.registry.hashes if h != cand_hash
            ][0]
            _admin_post(host, port, "/admin/swap", {"config_hash": inc_hash})
            status, doc = _admin_post(
                host, port, "/admin/unregister", {"config_hash": cand_hash}
            )
            assert status == 200 and doc["was_registered"] is True
            assert cand_hash not in gateway.registry.hashes
            # Unknown hash: idempotent cleanup, not an error.
            status, doc = _admin_post(
                host, port, "/admin/unregister", {"config_hash": "nope"}
            )
            assert status == 200 and doc["was_registered"] is False
            status, doc = _admin_post(host, port, "/admin/flush", {})
            assert status == 200 and doc["flushed"] >= 1
        finally:
            server.stop()

    def test_clear_pins_via_swap(self, crafted_incumbent):
        from p2pmicrogrid_tpu_torch.serve.gateway import (
            GatewayServer,
            build_gateway,
        )

        cfg, incumbent = crafted_incumbent
        gateway = build_gateway([incumbent], max_batch=16, device="cpu")
        server = GatewayServer(gateway)
        host, port = server.start()
        try:
            gateway.registry._pins["h1"] = gateway.registry.default_hash
            status, _ = _admin_post(
                host, port, "/admin/swap", {"clear_pins": True}
            )
            assert status == 200
            assert gateway.registry.pinned_count == 0
        finally:
            server.stop()


# -- unattended cycles over a live fleet ---------------------------------------


class TestAutopilotCycles:
    def test_honest_promotes_regressions_blocked(self, crafted_incumbent,
                                                 tmp_path):
        from p2pmicrogrid_tpu_torch.serve.router import FleetRouter

        from p2pmicrogrid_tpu_torch.telemetry import SqliteSink, Telemetry

        cfg, incumbent = crafted_incumbent
        db = str(tmp_path / "wh.db")
        fleet = _local_fleet(incumbent, db)
        reps = fleet.start()
        rows = []
        tel = Telemetry(
            run_id="autopilot-test", sinks=[SqliteSink(db)],
            manifest={"autopilot_role": "supervisor"},
        )
        try:
            router = FleetRouter(reps)
            pilot = Autopilot(
                cfg, router, incumbent_dir=incumbent,
                state_dir=str(tmp_path / "state"), results_db=db,
                telemetry=tel,
                stages=(25.0, 100.0), requests_per_cycle=64,
                canary_requests=48, n_households=12, rate_hz=256.0,
                seed=0, trace_steps=10, emit=rows.append, serve_device="cpu",
            )
            state = pilot.run(
                2, inject_plan=parse_inject_plan(
                    "0:good,1:cost_regressed"
                ),
            )
        finally:
            tel.close()
            fleet.stop_all()
        assert state.promotions == 1 and state.blocked == 1
        assert state.bad_promotions == 0
        assert state.availability == 1.0
        assert [link["cycle"] for link in state.lineage] == [0]
        good, bad = rows[0], rows[1]
        assert good["promoted"] and good["serving_verified"]
        assert bad["blocked_at_gate"] and bad["serving_verified"]
        assert good["outcome_ok"] and bad["outcome_ok"]
        # The promotion advanced the incumbent: cycle 1 gated against
        # cycle 0's candidate, and the journal's lineage says so.
        assert bad["incumbent"] == good["candidate"]
        assert state.incumbent_hash == good["candidate"]
        # Cycle 1's export window started where cycle 0's new incumbent
        # began serving (watermark 0 for a fresh config is cycle 1's
        # first export; the second cycle of the SAME incumbent advances).
        with ResultsStore(db) as store:
            lineage = store.query_promotion_lineage()
        assert lineage["chain"][-1] == good["candidate"]
        # The journal is at rest and verifies.
        final = read_journal(str(tmp_path / "state"))
        assert final.phase == "idle" and final.cycle == 2


# -- SIGKILL crash recovery ----------------------------------------------------


def _autopilot_argv(incumbent, state_dir, db, out, replicas, cycles,
                    inject):
    argv = [
        sys.executable, "-m", "p2pmicrogrid_tpu_torch", "autopilot",
        "--incumbent", incumbent, "--state-dir", state_dir,
        "--results-db", db, "--cycles", str(cycles), "--inject", inject,
        "--out", out, "--requests-per-cycle", "24",
        "--canary-requests", "24", "--households", "8",
        "--stages", "25,100", "--agents", str(A),
        "--implementation", "tabular", "--seed", "0",
        "--trace-steps", "10", "--min-transitions", "4",
        "--device", "cpu",
    ]
    for r in replicas:
        argv += ["--replica", f"{r.host}:{r.port}"]
    return argv


def _spawn_autopilot(argv, env):
    proc = subprocess.Popen(
        argv, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
    )
    lines: list = []
    threading.Thread(
        target=lambda: [lines.append(ln.rstrip()) for ln in proc.stdout],
        daemon=True,
    ).start()
    return proc, lines


def _kill_at_phase(proc, state_dir, cycle, phase, timeout_s=420.0):
    end = time.monotonic() + timeout_s
    while time.monotonic() < end and proc.poll() is None:
        try:
            st = read_journal(state_dir)
        except JournalCorrupt:
            st = None
        if st is not None and st.cycle == cycle and st.phase == phase:
            proc.send_signal(signal.SIGKILL)
            proc.wait(timeout=30)
            return True
        time.sleep(0.1)
    return False


def _run_sigkill_case(cfg, incumbent, tmp_path, phase, inject,
                      expect):
    """SIGKILL the autopilot in ``phase`` of cycle 0, relaunch the SAME
    command line, assert the journal's recovery outcome and that the
    incumbent serves bit-exact afterwards."""
    from p2pmicrogrid_tpu_torch.serve.engine import PolicyEngine

    db = str(tmp_path / "wh.db")
    state_dir = str(tmp_path / "state")
    out = str(tmp_path / "cycles.jsonl")
    fleet = _local_fleet(incumbent, db)
    reps = fleet.start()
    try:
        argv = _autopilot_argv(
            incumbent, state_dir, db, out, reps, cycles=1, inject=inject
        )
        env = dict(os.environ)
        env["P2P_AUTOPILOT_HOLD"] = json.dumps({phase: 3.0})
        env["P2P_TELEMETRY"] = "0"
        proc, lines = _spawn_autopilot(argv, env)
        killed = _kill_at_phase(proc, state_dir, cycle=0, phase=phase)
        assert killed, f"kill window ({phase}) never opened:\n" + "\n".join(
            lines[-20:]
        )
        # Mid-flight state on disk, journal mid-phase: relaunch with the
        # SAME command line — the journal drives recovery.
        proc, lines = _spawn_autopilot(argv, env)
        rc = proc.wait(timeout=600)
        assert rc == 0, "\n".join(lines[-30:])
        final = read_journal(state_dir)
        assert final.cycle == 1 and final.phase == "idle"
        expect(final)
        # The fleet serves the journal's incumbent, bit-exact, with no
        # split and no pins left behind.
        inc_hash = final.incumbent_hash
        obs = synthetic_obs(2, A, seed=9)
        want = PolicyEngine(
            bundle_dir=final.incumbent_dir, max_batch=16, device="cpu"
        ).act(obs[:1])[0]
        for rep in reps:
            status, doc = _admin_post(
                rep.host, rep.port, "/v1/act",
                {"household": "post-crash", "obs": obs[0].tolist()},
            )
            assert status == 200 and doc["config_hash"] == inc_hash
            # host-sync: wire JSON payloads, host data.
            np.testing.assert_array_equal(
                np.asarray(doc["actions"], np.float32), want
            )
            entry = fleet.entry(rep.replica_id)
            assert entry["registry"].split is None
            assert entry["registry"].pinned_count == 0
    finally:
        fleet.stop_all()


class TestSigkillRecovery:
    def test_mid_retrain_rerun_completes_cycle(self, crafted_incumbent,
                                               tmp_path):
        cfg, incumbent = crafted_incumbent

        def expect(final):
            # Re-runnable phase: the cycle re-ran and finished normally —
            # the crafted regression still blocked, no crash abort.
            assert final.blocked == 1
            assert final.crash_aborts == 0
            assert final.promotions == 0

        _run_sigkill_case(
            cfg, incumbent, tmp_path, phase="retraining",
            inject="0:cost_regressed", expect=expect,
        )

    def test_mid_canary_aborts_to_incumbent(self, crafted_incumbent,
                                            tmp_path):
        cfg, incumbent = crafted_incumbent

        def expect(final):
            # Canary crash: abort back to the incumbent — the good
            # candidate is NOT promoted (safety beats progress), the
            # split is gone and the cycle is accounted as a crash abort.
            assert final.crash_aborts == 1
            assert final.promotions == 0
            assert final.candidate_hash is None

        _run_sigkill_case(
            cfg, incumbent, tmp_path, phase="canarying",
            inject="0:good", expect=expect,
        )
