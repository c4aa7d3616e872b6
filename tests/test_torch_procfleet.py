"""The port's process fleet on the CPU: ``serve-gateway`` children of
``python -m p2pmicrogrid_tpu_torch`` under a relaunch supervisor.

Port copies of the contracts of ``tests/test_procfleet.py``: the child argv
(now with the port's ``--device``), the units, the wire-compare guards, one
live SIGKILL and supervised relaunch of one child (the relaunched process
answers bit for bit as before, its startup seconds recorded), the
warehouse fleet view's process columns, and (``slow``, as in the JAX
package) the TLS + auth + chaos end-to-end bench. Children run with
``--device cpu``; without a card a fleet asked for the card raises.
"""

import asyncio
import json
import time

import numpy as np
import pytest
import torch

from p2pmicrogrid_tpu_torch import config as tc
from p2pmicrogrid_tpu_torch.serve import (
    FaultEvent,
    FaultPlan,
    FleetRouter,
    ProcessFleet,
    export_policy_bundle,
)
from p2pmicrogrid_tpu_torch.serve.loadgen import RetryPolicy
from p2pmicrogrid_tpu_torch.train.policies import init_policy_state

A = 3


def _make_bundle(tmp_path, seed, name):
    cfg = tc.default_config(
        sim=tc.SimConfig(n_agents=A),
        train=tc.TrainConfig(implementation="tabular", seed=seed),
    )
    gen = torch.Generator().manual_seed(seed)
    ps = init_policy_state(cfg, "cpu", gen)
    ps = ps._replace(q_table=torch.randn(ps.q_table.shape, generator=gen))
    return export_policy_bundle(cfg, ps, str(tmp_path / name), device="cpu")


def _obs(n, seed=0):
    rng = np.random.default_rng(seed)
    obs = np.empty((n, A, 4), dtype=np.float32)
    obs[..., 0] = rng.uniform(0, 1, (n, A))
    obs[..., 1:] = rng.uniform(-1, 1, (n, A, 3))
    return obs


class TestProcessFleetUnits:
    def test_tls_pair_validated(self):
        with pytest.raises(ValueError):
            ProcessFleet(["b"], tls_cert="cert.pem", serve_device="cpu")

    def test_replica_floor(self):
        with pytest.raises(ValueError):
            ProcessFleet(["b"], n_replicas=0, serve_device="cpu")

    def test_defaults_to_the_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ProcessFleet(["b"])

    @pytest.mark.parametrize("device", ["cuda", "cpu"])
    def test_child_argv_shape(self, device, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        fleet = ProcessFleet(
            ["/bundles/b1"], mux=True, auth_secret_file="/s",
            tls_cert="/c.pem", tls_key="/k.pem", fault_plan_file="/plan.json",
            serve_device=device,
        )
        argv = fleet._child_argv("replica-3", 8441, 8442, restarts=2)
        assert argv[1:4] == ["-m", "p2pmicrogrid_tpu_torch", "serve-gateway"]
        joined = " ".join(argv)
        assert "--bundle /bundles/b1" in joined
        assert "--port 8441" in joined
        assert "--mux-port 8442" in joined
        assert "--replica-id replica-3" in joined
        assert "--restarts 2" in joined
        assert "--tls-cert /c.pem" in joined
        assert "--auth-secret-file /s" in joined
        assert "--chaos-plan /plan.json" in joined
        # The child's device is the fleet's; --serve-device auto follows it.
        assert f"--device {device}" in joined
        assert "--serve-device auto" in joined


class TestWireCompareGuards:
    def test_wire_compare_refuses_request_fault_plan_any_mode(self, tmp_path):
        from p2pmicrogrid_tpu_torch import cli

        plan = FaultPlan(seed=0, events=(FaultEvent(kind="error", rate=0.5),))
        plan_path = tmp_path / "plan.json"
        plan_path.write_text(plan.to_json())
        bundle = _make_bundle(tmp_path, 0, "b1")
        for extra in ([], ["--process"]):
            with pytest.raises(SystemExit) as exc:
                cli.main([
                    "serve-bench", "--fleet", "--wire-compare",
                    "--chaos-plan", str(plan_path),
                    "--bundle", bundle, "--agents", str(A), "--device", "cpu",
                ] + extra)
            assert "fault windows" in str(exc.value)


class TestProcessFleetLive:
    """One real subprocess replica: spawn, SIGKILL, supervised relaunch."""

    def test_sigkill_and_supervised_relaunch(self, tmp_path):
        bundle = _make_bundle(tmp_path, 0, "b1")
        fleet = ProcessFleet(
            [bundle], n_replicas=1, backoff_s=0.1, backoff_cap_s=1.0, serve_device="cpu",
        )
        fleet.start()
        try:
            rep = fleet.replicas[0]
            assert rep.mux_port is not None
            router = FleetRouter(
                [rep], retry=RetryPolicy(max_attempts=4, deadline_s=20.0),
                fail_threshold=2, ok_threshold=1,
            )
            obs = _obs(1)[0]

            def act():
                async def run():
                    try:
                        return await router.act("house-1", obs)
                    finally:
                        await router.close_pools()

                return asyncio.run(run())

            first = act()
            assert first.status == 200
            pid_before = fleet.pid("replica-0")
            assert pid_before is not None
            fleet.kill("replica-0")
            assert fleet.pid("replica-0") is None
            assert fleet.kills == ["replica-0"]
            end = time.monotonic() + 120.0
            recovered = False
            while time.monotonic() < end:
                if all(router.probe_once().values()):
                    recovered = True
                    break
                time.sleep(0.2)
            assert recovered, fleet.log_tail("replica-0")
            assert fleet.restarts == ["replica-0"]
            pid_after = fleet.pid("replica-0")
            assert pid_after is not None and pid_after != pid_before
            assert fleet.replicas[0].port == rep.port
            second = act()
            assert second.status == 200
            assert second.actions == first.actions
            stats = router.fleet_stats()
            proc = stats["processes"]["replica-0"]
            assert proc["pid"] == pid_after
            assert proc["restarts"] == 1
            assert proc["rss_bytes"] > 0
            # Each launch's startup seconds, the first and the relaunch.
            assert [(s["replica_id"], s["restarts"]) for s in fleet.startups] == [
                ("replica-0", 0), ("replica-0", 1)
            ]
            assert [s["pid"] for s in fleet.startups] == [pid_before, pid_after]
            assert all(s["startup_s"] > 0 for s in fleet.startups)
        finally:
            fleet.stop_all()
        assert fleet.pid("replica-0") is None


class TestFleetViewColumns:
    def test_warehouse_fleet_view_gains_wire_auth_process_columns(self, tmp_path):
        from p2pmicrogrid_tpu_torch.data.results import ResultsStore
        from p2pmicrogrid_tpu_torch.telemetry import SqliteSink, Telemetry, run_manifest

        db = str(tmp_path / "results.db")
        old = Telemetry(
            run_id="fleet-router-old", sinks=[SqliteSink(db)],
            manifest=run_manifest(extra={"config_hash": "cfg-abc", "serve_role": "router"}),
        )
        for _ in range(50):
            old.event("noise")
        old.event("fleet_stats", processes={
            "replica-0": {"pid": 999, "rss_bytes": 1, "restarts": 9}
        })
        old.close()
        time.sleep(0.02)
        tel = Telemetry(
            run_id="fleet-router-test", sinks=[SqliteSink(db)],
            manifest=run_manifest(extra={"config_hash": "cfg-abc", "serve_role": "router"}),
        )
        tel.counter("router.reconnects", 3)
        tel.counter("router.auth_denied", 2)
        tel.event("fleet_stats", n_replicas=2, n_healthy=2, processes={
            "replica-0": {"pid": 101, "rss_bytes": 1 << 20, "restarts": 1},
            "replica-1": {"pid": 102, "rss_bytes": 1 << 20, "restarts": 0},
        })
        tel.close()
        store = ResultsStore(db)
        try:
            rows = store.query_fleet_view()
        finally:
            store.close()
        assert len(rows) == 1
        row = rows[0]
        assert row["config_hash"] == "cfg-abc"
        assert row["router_reconnects"] == 3
        assert row["router_auth_denied"] == 2
        assert row["last_processes"]["replica-0"]["pid"] == 101
        assert row["last_processes"]["replica-0"]["restarts"] == 1
        assert "replica-1" in row["last_processes"]


@pytest.mark.slow
class TestProcessChaosEndToEnd:
    def test_serve_bench_process_chaos_tls_auth(self, tmp_path, capfd):
        """Subprocess replicas with TLS and per-household tokens on the
        persistent wire, one SIGKILLed mid-run and relaunched: availability
        and bit-exactness on the headline, the 401 probe charged no retry
        budget, and the persistent wire beats per-request connections on
        p95. Slow as in the JAX package: several child processes and a run
        long enough for the kill and the relaunch (``chip_smoke.py`` phase
        14 checks the same contract on the card)."""
        from p2pmicrogrid_tpu_torch import cli

        bundle = _make_bundle(tmp_path, 0, "b1")
        rc = cli.main([
            "serve-bench", "--fleet", "--process", "--chaos", "--tls", "--auth",
            "--wire-compare", "--bundle", bundle, "--replicas", "2",
            "--requests", "192", "--rate", "64", "--kill-at", "0.9",
            "--restart-at", "2.2", "--agents", str(A), "--device", "cpu",
        ])
        assert rc == 0
        lines = [
            json.loads(line) for line in capfd.readouterr().out.splitlines()
            if line.strip().startswith("{")
        ]
        headline = next(r for r in lines if r.get("metric") == "serve_bench_fleet")
        compare = next(r for r in lines if r.get("metric") == "wire_comparison")
        assert headline["process_mode"] is True
        assert headline["tls"] is True
        assert headline["availability"] >= 0.99
        assert headline["bit_exact"] is True
        assert headline["chaos"]["kills"] == ["replica-1"]
        assert headline["processes"]["replica-1"]["restarts"] >= 1
        assert headline["processes"]["replica-0"]["restarts"] == 0
        assert len({p["pid"] for p in headline["processes"].values()}) == 2
        probe = headline["auth_probe"]
        assert probe["n_401"] == probe["requests"] > 0
        assert probe["retries"] == 0
        assert probe["budget_spent"] == 0
        assert headline["auth_shed_rate"] > 0.0
        assert compare["value"] > 1.0
        assert compare["mux_p95_ms"] < compare["http_p95_ms"]
