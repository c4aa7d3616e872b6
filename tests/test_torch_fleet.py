"""The port's serving fleet on the CPU: fault injection, the consistent-hash
router, ``LocalFleet`` and the fleet bench, against the JAX package's.

Against the JAX package, from the same inputs: fault plans written by one
package read by the other, the injector's ``history`` over 200 decisions
(act, health and other scopes, replica filters, a plan edited by
lifecycle events), the hash ring's lookups for 10,000 household ids at
vnodes 64 and 4096 and its moved keys after a ``remove``, and the keys of
``serve_bench_fleet``'s rows. Then port copies of the fleet contracts of
``tests/test_fleet.py`` over the port's gateway with ``device="cpu"``
(A=3): failover with zero requests lost, repinned and bit-exact; probe
eject and readmit; local shed; the retry budget; 429 accounting; the
two-phase swap and its rollback; the loadgen retry cases (the stall
deadline with its original bounds); the chaos bench's acceptance; one JSON
line a row from the command line; the router proxy's ``/v1/act``,
``/readyz``, ``/stats`` and ``/admin/swap`` (the contracts of
``tests/test_wire.py``'s proxy tests) and the ``serve-router`` command.
"""

import asyncio
import collections
import http.client
import importlib.util
import json
import os
import random
import threading
import time

import numpy as np
import pytest
import torch

from p2pmicrogrid_tpu_torch import config as tc
from p2pmicrogrid_tpu_torch.serve import (
    AdmissionConfig,
    ConsistentHashRing,
    FaultEvent,
    FaultInjector,
    FaultPlan,
    FleetRouter,
    FleetSwapError,
    GatewayServer,
    LocalFleet,
    build_gateway,
    export_policy_bundle,
    kill_restart_plan,
    run_fleet_loadgen,
    serve_bench_fleet,
)
from p2pmicrogrid_tpu_torch.serve.loadgen import RetryBudget, RetryPolicy, run_network_loadgen
from p2pmicrogrid_tpu_torch.train.policies import init_policy_state

A = 3  # community size for all fleet tests

# Admission effectively off for serving-semantics tests: shedding has its
# own tests with forced budgets.
_OPEN_ADMISSION = AdmissionConfig(max_queue_depth=100_000, wait_budget_ms=100_000.0)


def _make_bundle(tmp_path, seed, name):
    """A tabular bundle with a randomly drawn table (distinct seeds give
    distinct config hashes)."""
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


def _act(router, household, obs_row, **kw):
    return asyncio.run(router.act(household, obs_row, **kw))


def _fleet(bundle_dirs, n=3, **kw):
    kw.setdefault("admission", _OPEN_ADMISSION)
    return LocalFleet(list(bundle_dirs), n_replicas=n, max_batch=4, device="cpu", **kw)


def _load_checker():
    spec = importlib.util.spec_from_file_location(
        "check_artifacts_schema",
        os.path.join(os.path.dirname(__file__), "..", "tools", "check_artifacts_schema.py"),
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fleet-bundles")
    return _make_bundle(tmp, 0, "b1"), _make_bundle(tmp, 1, "b2")


# -- against the JAX package -----------------------------------------------------


def _jax_plan(plan):
    from p2pmicrogrid_tpu.serve import faults as jfaults

    return jfaults.FaultPlan.from_json(plan.to_json())


def _decisions(history):
    return [
        None if d is None else (d.kind, d.event_index, d.request_index, d.stall_s)
        for d in history
    ]


def test_fault_plan_json_both_ways():
    from p2pmicrogrid_tpu.serve import faults as jfaults

    plan = kill_restart_plan(
        "replica-2", 0.25, 0.75, seed=3,
        extra_events=(
            FaultEvent(kind="drop", rate=0.05),
            FaultEvent(kind="stall", replica="replica-1", at_s=0.1, until_s=0.4,
                       stall_s=0.8, scope="health"),
        ),
    )
    back = jfaults.FaultPlan.from_json(plan.to_json())
    assert back.to_json() == plan.to_json()
    assert [e.kind for e in back.lifecycle_events()] == ["kill", "restart"]
    jplan = jfaults.kill_restart_plan(
        "replica-0", 1.0, 2.0, seed=9,
        extra_events=(jfaults.FaultEvent(kind="error", rate=0.3, scope="all"),),
    )
    mine = FaultPlan.from_json(jplan.to_json())
    assert mine.to_json() == jplan.to_json()
    assert mine == FaultPlan(seed=9, events=[
        FaultEvent(kind="kill", replica="replica-0", at_s=1.0),
        FaultEvent(kind="restart", replica="replica-0", at_s=2.0),
        FaultEvent(kind="error", rate=0.3, scope="all"),
    ])


_PLANS = {
    "act": FaultPlan(seed=7, events=[
        FaultEvent(kind="error", rate=0.25), FaultEvent(kind="corrupt", rate=0.1),
        FaultEvent(kind="stall", rate=0.2, stall_s=0.3),
    ]),
    "scopes": FaultPlan(seed=1, events=[
        FaultEvent(kind="error", scope="health", rate=0.5),
        FaultEvent(kind="drop", scope="all", rate=0.1),
        FaultEvent(kind="stall", replica="replica-1", rate=0.4, stall_s=0.2),
    ]),
    "lifecycle_edited": FaultPlan(seed=5, events=[
        FaultEvent(kind="kill", replica="replica-1", at_s=1.0),
        FaultEvent(kind="error", rate=0.3),
        FaultEvent(kind="restart", replica="replica-1", at_s=2.0),
        FaultEvent(kind="corrupt", scope="all", rate=0.15),
    ]),
}


@pytest.mark.parametrize("replica", ["replica-0", "replica-1"])
@pytest.mark.parametrize("name", sorted(_PLANS))
def test_injector_history_matches_jax(name, replica):
    """200 decisions over a fixed mix of scopes: the port's coins and
    history equal the JAX injector's for the same plan and replica."""
    from p2pmicrogrid_tpu.serve import faults as jfaults

    plan = _PLANS[name]
    scopes = [("act", "health", "other", "act")[i % 4] for i in range(200)]
    clock = lambda: 0.0  # noqa: E731 — every event's window is open at 0
    mine = FaultInjector(plan, replica, clock=clock)
    ref = jfaults.FaultInjector(_jax_plan(plan), replica, clock=clock)
    for scope in scopes:
        mine.decide(scope)
        ref.decide(scope)
    assert _decisions(mine.history) == _decisions(ref.history)
    assert mine.stats() == ref.stats()
    assert any(d is not None for d in mine.history)


@pytest.mark.parametrize("vnodes", [64, 4096])
def test_hash_ring_matches_jax(vnodes):
    from p2pmicrogrid_tpu.serve import router as jrouter

    mine, ref = ConsistentHashRing(vnodes=vnodes), jrouter.ConsistentHashRing(vnodes=vnodes)
    for r in ("replica-0", "replica-1", "replica-2"):
        mine.add(r)
        ref.add(r)
    keys = [f"house-{i:05d}" for i in range(10_000)]
    before = [mine.lookup(k) for k in keys]
    assert before == [ref.lookup(k) for k in keys]
    mine.remove("replica-1")
    ref.remove("replica-1")
    after = [mine.lookup(k) for k in keys]
    assert after == [ref.lookup(k) for k in keys]
    moved = {k for k, b, a in zip(keys, before, after) if a != b}
    assert moved and moved == {k for k, b in zip(keys, before) if b == "replica-1"}


def test_serve_bench_fleet_rows_carry_the_jax_keys(bundles, tmp_path):
    """One in-process replica in each package, the same schedule: the
    port's rows have the JAX rows' metrics and keys."""
    import jax
    from p2pmicrogrid_tpu.config import SimConfig, TrainConfig, default_config
    from p2pmicrogrid_tpu.serve import export_policy_bundle as j_export
    from p2pmicrogrid_tpu.serve import router as jrouter
    from p2pmicrogrid_tpu.serve.gateway import AdmissionConfig as JAdmission
    from p2pmicrogrid_tpu.serve.loadgen import RetryPolicy as JRetry
    from p2pmicrogrid_tpu.train import init_policy_state as j_init

    cfg = default_config(sim=SimConfig(n_agents=A), train=TrainConfig(implementation="tabular"))
    jbundle = j_export(cfg, j_init(cfg, jax.random.PRNGKey(0)), str(tmp_path / "jb"))
    kw = dict(n_agents=A, rate_hz=200.0, n_requests=6, n_households=3, seed=0,
              probe_interval_s=0.05)
    plan = kill_restart_plan("replica-0", 5.0, 6.0)  # after the run: never applied

    fleet = LocalFleet([bundles[0]], n_replicas=1, max_batch=1, device="cpu",
                       admission=_OPEN_ADMISSION)
    fleet.start()
    try:
        rows = serve_bench_fleet(
            FleetRouter(fleet.replicas, retry=RetryPolicy()), fleet=fleet,
            fault_plan=plan, reference_engine=fleet.reference_engine(),
            chaos_join_grace_s=0.0, **kw,
        )
    finally:
        fleet.stop_all()
    jfleet = jrouter.LocalFleet(
        [jbundle], n_replicas=1, max_batch=1, device="cpu",
        admission=JAdmission(max_queue_depth=100_000, wait_budget_ms=100_000.0),
        fault_plan=_jax_plan(plan),
    )
    jfleet.start()
    try:
        ref = jrouter.serve_bench_fleet(
            jrouter.FleetRouter(jfleet.replicas, retry=JRetry()), fleet=jfleet,
            fault_plan=_jax_plan(plan), reference_engine=jfleet.reference_engine(),
            chaos_join_grace_s=0.0, **kw,
        )
    finally:
        jfleet.stop_all()
    assert [r["metric"] for r in rows] == [r["metric"] for r in ref]
    assert [sorted(r) for r in rows] == [sorted(r) for r in ref]
    assert rows[-1]["bit_exact"] is True and rows[-1]["availability"] == 1.0


# -- fault plans and injection -----------------------------------------------------


class TestHashRing:
    def test_deterministic_and_balanced(self):
        ring = ConsistentHashRing(vnodes=64)
        for r in ("replica-0", "replica-1", "replica-2"):
            ring.add(r)
        keys = [f"house-{i}" for i in range(1500)]
        routed = {k: ring.lookup(k) for k in keys}
        ring2 = ConsistentHashRing(vnodes=64)
        for r in ("replica-0", "replica-1", "replica-2"):
            ring2.add(r)
        assert all(ring2.lookup(k) == routed[k] for k in keys)
        counts = collections.Counter(routed.values())
        assert set(counts) == {"replica-0", "replica-1", "replica-2"}
        assert min(counts.values()) > 1500 / 3 * 0.6

    def test_remove_moves_only_owned_keys(self):
        ring = ConsistentHashRing(vnodes=64)
        for r in ("replica-0", "replica-1", "replica-2"):
            ring.add(r)
        keys = [f"house-{i}" for i in range(1500)]
        before = {k: ring.lookup(k) for k in keys}
        ring.remove("replica-1")
        moved = [k for k in keys if ring.lookup(k) != before[k]]
        assert moved
        assert all(before[k] == "replica-1" for k in moved)
        ring.add("replica-1")
        assert all(ring.lookup(k) == before[k] for k in keys)

    def test_predicate_walks_clockwise(self):
        ring = ConsistentHashRing(vnodes=8)
        ring.add("a")
        ring.add("b")
        assert ring.lookup("key", accept=lambda r: r == "b") == "b"
        assert ring.lookup("key", accept=lambda r: False) is None
        with pytest.raises(ValueError):
            ring.add("a")
        with pytest.raises(KeyError):
            ring.remove("zzz")


class TestRetryPrimitives:
    def test_backoff_capped_jittered_honors_retry_after(self):
        policy = RetryPolicy(backoff_base_s=0.1, backoff_cap_s=0.5, jitter=0.5)
        rng = random.Random(0)
        for attempt in range(8):
            d = policy.backoff_s(attempt, rng)
            cap = min(0.5, 0.1 * 2 ** attempt)
            assert cap * 0.5 <= d <= cap
        assert policy.backoff_s(0, rng, retry_after_s=2.0) == 2.0
        no_honor = RetryPolicy(backoff_base_s=0.1, jitter=0.0, honor_retry_after=False)
        assert no_honor.backoff_s(0, rng, retry_after_s=2.0) == 0.1

    def test_budget_tokens(self):
        budget = RetryBudget(ratio=0.5, min_tokens=1.0, cap=2.0)
        assert budget.try_spend()
        assert not budget.try_spend()
        for _ in range(4):
            budget.on_attempt()
        assert budget.tokens == 2.0
        assert budget.try_spend() and budget.try_spend()
        assert not budget.try_spend()
        assert budget.spent == 3 and budget.denied == 2


class TestFaultPlan:
    def test_same_seed_same_faults(self):
        plan = FaultPlan(seed=7, events=[
            FaultEvent(kind="error", rate=0.25), FaultEvent(kind="corrupt", rate=0.1),
        ])

        def seq(p, rid):
            inj = FaultInjector(p, rid)
            return [d.kind if d else None for d in (inj.decide() for _ in range(300))]

        seq_a = seq(plan, "replica-0")
        assert seq_a == seq(plan, "replica-0")
        assert "error" in seq_a and "corrupt" in seq_a
        assert seq_a != seq(FaultPlan(seed=8, events=plan.events), "replica-0")
        assert seq_a != seq(plan, "replica-1")

    def test_replica_and_scope_filters(self):
        plan = FaultPlan(seed=0, events=[
            FaultEvent(kind="error", replica="replica-1", rate=1.0),
            FaultEvent(kind="stall", scope="health", rate=1.0, stall_s=0.5),
        ])
        other = FaultInjector(plan, "replica-0")
        assert other.decide(scope="act") is None
        assert other.decide(scope="health").kind == "stall"
        assert FaultInjector(plan, "replica-1").decide(scope="act").kind == "error"

    def test_json_round_trip_and_validation(self):
        plan = kill_restart_plan(
            "replica-2", 0.25, 0.75, seed=3, extra_events=(FaultEvent(kind="drop", rate=0.05),),
        )
        back = FaultPlan.from_json(plan.to_json())
        assert back == plan
        assert [e.kind for e in back.lifecycle_events()] == ["kill", "restart"]
        with pytest.raises(ValueError, match="unknown fault kind"):
            FaultEvent(kind="meteor")
        with pytest.raises(ValueError, match="rate"):
            FaultEvent(kind="error", rate=1.5)
        with pytest.raises(ValueError, match="name a replica"):
            FaultEvent(kind="kill")
        with pytest.raises(ValueError, match="restart_at_s"):
            kill_restart_plan("r", 1.0, 0.5)
        with pytest.raises(ValueError, match="fault_plan"):
            FaultPlan.from_json("{}")

    def test_act_coins_independent_of_health_probes(self):
        plan = FaultPlan(seed=9, events=[FaultEvent(kind="error", rate=0.4)])
        clean = FaultInjector(plan, "replica-0")
        want = [clean.decide("act") is not None for _ in range(120)]
        noisy = FaultInjector(plan, "replica-0")
        got = []
        for i in range(120):
            if i % 3 == 0:
                noisy.decide("health")
            got.append(noisy.decide("act") is not None)
        assert got == want

    def test_request_coins_stable_under_lifecycle_edits(self):
        base = FaultPlan(seed=5, events=[FaultEvent(kind="error", rate=0.3)])
        edited = FaultPlan(seed=5, events=[
            FaultEvent(kind="error", rate=0.3),
            FaultEvent(kind="kill", replica="r0", at_s=1.0),
        ])
        a, b = FaultInjector(base, "replica-0"), FaultInjector(edited, "replica-0")
        assert [d is not None for d in (a.decide() for _ in range(100))] == [
            d is not None for d in (b.decide() for _ in range(100))
        ]


class TestGatewayFaultHooks:
    """Request-level fault injection through one port gateway."""

    def _gateway(self, bundles, plan):
        injector = FaultInjector(plan, "replica-0")
        gateway = build_gateway(
            [bundles[0]], max_batch=4, admission=_OPEN_ADMISSION,
            fault_injector=injector, replica_id="replica-0", device="cpu",
        )
        return gateway, injector

    def _post_act(self, host, port, obs_row, timeout=30):
        conn = http.client.HTTPConnection(host, port, timeout=timeout)
        try:
            conn.request(
                "POST", "/v1/act",
                body=json.dumps({"household": "h", "obs": obs_row.tolist()}),
                headers={"Content-Type": "application/json"},
            )
            resp = conn.getresponse()
            raw = resp.read()
            try:
                doc = json.loads(raw) if raw else {}
            except (json.JSONDecodeError, UnicodeDecodeError):
                doc = None
            return resp.status, doc, raw
        finally:
            conn.close()

    def test_injected_error_and_stats(self, bundles):
        gateway, injector = self._gateway(
            bundles, FaultPlan(seed=0, events=[FaultEvent(kind="error", rate=1.0)])
        )
        with GatewayServer(gateway):
            status, doc, _ = self._post_act(gateway.host, gateway.port, _obs(1)[0])
            assert status == 500 and "injected fault" in doc["error"]
            assert gateway.stats["faults_injected"] == 1
            assert injector.injected["error"] == 1

    def test_injected_corruption_is_detectable(self, bundles):
        gateway, _ = self._gateway(
            bundles, FaultPlan(seed=0, events=[FaultEvent(kind="corrupt", rate=1.0)])
        )
        with GatewayServer(gateway):
            status, doc, raw = self._post_act(gateway.host, gateway.port, _obs(1)[0])
            assert status == 200 and doc is None and raw.startswith(b"\xff")

    def test_injected_stall_delays_response(self, bundles):
        gateway, _ = self._gateway(bundles, FaultPlan(seed=0, events=[
            FaultEvent(kind="stall", rate=1.0, stall_s=0.2)
        ]))
        with GatewayServer(gateway):
            t0 = time.monotonic()
            status, _, _ = self._post_act(gateway.host, gateway.port, _obs(1)[0])
            assert status == 200
            assert time.monotonic() - t0 >= 0.2

    def test_injected_drop_closes_without_response(self, bundles):
        gateway, _ = self._gateway(
            bundles, FaultPlan(seed=0, events=[FaultEvent(kind="drop", rate=1.0)])
        )
        with GatewayServer(gateway):
            with pytest.raises((http.client.HTTPException, OSError)):
                self._post_act(gateway.host, gateway.port, _obs(1)[0])

    def test_health_scope_only_hits_health_endpoints(self, bundles):
        gateway, _ = self._gateway(bundles, FaultPlan(seed=0, events=[
            FaultEvent(kind="error", scope="health", rate=1.0)
        ]))
        with GatewayServer(gateway):
            conn = http.client.HTTPConnection(gateway.host, gateway.port, timeout=30)
            try:
                conn.request("GET", "/readyz")
                assert conn.getresponse().status == 500
            finally:
                conn.close()
            status, _, _ = self._post_act(gateway.host, gateway.port, _obs(1)[0])
            assert status == 200


class TestGatewayHardening:
    def test_readyz_reports_config_hash_and_replica_id(self, bundles):
        gateway = build_gateway([bundles[0]], max_batch=4, replica_id="replica-7", device="cpu")
        with GatewayServer(gateway):
            conn = http.client.HTTPConnection(gateway.host, gateway.port, timeout=30)
            try:
                conn.request("GET", "/readyz")
                resp = conn.getresponse()
                doc = json.loads(resp.read())
            finally:
                conn.close()
            assert resp.status == 200
            assert doc["config_hash"] == gateway.registry.default_hash
            assert doc["replica_id"] == "replica-7"
            assert gateway.stats_snapshot()["replica_id"] == "replica-7"

    def test_stop_idempotent_repeated_and_concurrent(self, bundles):
        gateway = build_gateway([bundles[0]], max_batch=4, device="cpu")
        server = GatewayServer(gateway)
        server.start()
        errors = []

        def stopper():
            try:
                server.stop()
            except Exception as err:  # noqa: BLE001
                errors.append(err)

        threads = [threading.Thread(target=stopper) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert errors == [] and not any(t.is_alive() for t in threads)
        server.stop()
        asyncio.run(gateway.stop())
        asyncio.run(gateway.stop())
        for h in gateway.registry.hashes:
            assert gateway.registry.get(h).queue._closed

    def test_stop_does_not_wait_on_an_idle_client_connection(self, bundles):
        """An open keep-alive client with no request in flight does not
        hold ``stop``: the connections left after the drain are closed
        before the listeners are waited on."""
        gateway = build_gateway([bundles[0]], max_batch=4, device="cpu")
        server = GatewayServer(gateway)
        host, port = server.start()
        conn = http.client.HTTPConnection(host, port, timeout=30)
        try:
            conn.request("GET", "/healthz")
            assert conn.getresponse().read() is not None
            t0 = time.monotonic()
            server.stop()
            assert time.monotonic() - t0 < 3.0
        finally:
            conn.close()


# -- the fleet ---------------------------------------------------------------------


@pytest.fixture
def fleet3(bundles):
    """A running 3-replica fleet over one bundle and a router with fast
    health thresholds (ejection after 2 failures, readmission after 1)."""
    fleet = _fleet([bundles[0]])
    fleet.start()
    router = FleetRouter(
        fleet.replicas, retry=RetryPolicy(max_attempts=5, deadline_s=30.0),
        fail_threshold=2, ok_threshold=1,
    )
    try:
        yield fleet, router
    finally:
        fleet.stop_all()


def test_local_fleet_defaults_to_the_card(bundles, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LocalFleet([bundles[0]])


class TestFleetFailover:
    def test_kill_mid_traffic_zero_lost_repinned_bit_exact(self, fleet3):
        fleet, router = fleet3
        engine = fleet.reference_engine()
        obs = _obs(24, seed=3)
        homes = [f"house-{i}" for i in range(8)]
        first = {}
        for i, h in enumerate(homes):
            r = _act(router, h, obs[i])
            assert r.status == 200
            first[h] = r.replica_id
        victim = first[homes[0]]
        affected = [h for h, rid in first.items() if rid == victim]
        engines = fleet.entry(victim)["registry"].get(
            fleet.entry(victim)["registry"].default_hash
        ).engine
        fleet.kill(victim)
        results = {}
        for i, h in enumerate(homes):
            r = _act(router, h, obs[8 + i])
            assert r.status == 200, (h, r.status, r.error)
            results[h] = r
        pins = router.pinned_households()
        for h in affected:
            assert results[h].replica_id != victim
            assert pins.get(h) == results[h].replica_id
            assert router.is_healthy(results[h].replica_id)
        for h in homes:
            if h not in affected:
                assert results[h].replica_id == first[h]
        assert router.counters["failovers"] >= 1
        got = np.asarray([results[h].actions for h in homes], dtype=np.float32)
        np.testing.assert_array_equal(got, engine.act(obs[8:8 + len(homes)]))
        # The restart rebinds the original port over the warm registry:
        # the same engine object serves (no rebuild, no recapture).
        fleet.restart(victim)
        router.probe_once()
        assert router.is_healthy(victim)
        registry = fleet.entry(victim)["registry"]
        assert registry.get(registry.default_hash).engine is engines
        assert _act(router, "brand-new-house", _obs(1, seed=9)[0]).status == 200

    def test_probe_ejects_and_readmits(self, fleet3):
        fleet, router = fleet3
        victim = router.replica_ids[1]
        fleet.kill(victim)
        assert router.is_healthy(victim)
        router.probe_once()
        assert router.is_healthy(victim)
        router.probe_once()
        assert not router.is_healthy(victim)
        assert router.counters["ejections"] == 1
        assert set(router.healthy_ids()) == set(router.replica_ids) - {victim}
        fleet.restart(victim)
        router.probe_once()
        assert router.is_healthy(victim)
        assert router.counters["readmissions"] == 1

    def test_all_replicas_down_sheds_immediately(self, fleet3):
        fleet, router = fleet3
        for rid in router.replica_ids:
            fleet.kill(rid)
        for _ in range(2):
            router.probe_once()
        assert router.healthy_ids() == []
        t0 = time.monotonic()
        r = _act(router, "h", _obs(1)[0])
        assert r.status == 503 and r.shed
        assert r.retry_after_s == router.shed_retry_after_s
        assert time.monotonic() - t0 < 5.0
        assert router.counters["shed"] >= 1

    def test_retry_budget_exhaustion_degrades_503(self, bundles):
        plan = FaultPlan(seed=0, events=[FaultEvent(kind="error", rate=1.0)])
        fleet = _fleet([bundles[0]], n=2, fault_plan=plan)
        fleet.start()
        router = FleetRouter(
            fleet.replicas,
            retry=RetryPolicy(max_attempts=10, deadline_s=30.0,
                              backoff_base_s=0.001, backoff_cap_s=0.002),
            budget=RetryBudget(ratio=0.0, min_tokens=2.0),
            fail_threshold=100, ok_threshold=1,
        )
        try:
            r = _act(router, "h", _obs(1)[0])
            assert r.status == 503 and r.shed and r.gave_up
            assert "retry budget" in r.error
            assert r.retry_after_s == router.shed_retry_after_s
            assert router.counters["budget_denied"] == 1
            assert router.budget.spent == 2
        finally:
            fleet.stop_all()

    def test_retries_recover_from_injected_errors(self, bundles):
        plan = FaultPlan(seed=11, events=[
            FaultEvent(kind="error", replica="replica-0", rate=0.5)
        ])
        fleet = _fleet([bundles[0]], n=2, fault_plan=plan)
        fleet.start()
        router = FleetRouter(
            fleet.replicas,
            retry=RetryPolicy(max_attempts=6, deadline_s=30.0,
                              backoff_base_s=0.001, backoff_cap_s=0.01),
            fail_threshold=1000,
        )
        engine = fleet.reference_engine()
        obs = _obs(12, seed=4)
        try:
            actions = []
            for i in range(12):
                r = _act(router, f"house-{i}", obs[i])
                assert r.status == 200, (i, r.status, r.error)
                actions.append(r.actions)
            assert router.counters["retries"] >= 1
            np.testing.assert_array_equal(np.asarray(actions, dtype=np.float32), engine.act(obs))
        finally:
            fleet.stop_all()


class TestRouterAccounting:
    def test_429_retry_is_not_a_failover(self, bundles):
        admission = AdmissionConfig(
            wait_budget_ms=5.0, min_wait_samples=8, retry_after_s=0.3, wait_window_s=0.15,
        )
        fleet = _fleet([bundles[0]], n=2, admission=admission)
        fleet.start()
        now = time.monotonic()
        for rid in ("replica-0", "replica-1"):
            reg = fleet.entry(rid)["registry"]
            bundle = reg.get(reg.default_hash)
            for _ in range(16):
                bundle.queue.recent_wait_ms.append((now, 100.0))
        router = FleetRouter(fleet.replicas, retry=RetryPolicy(max_attempts=5, deadline_s=20.0))
        try:
            r = _act(router, None, _obs(1)[0])
            assert r.status == 200 and r.retries >= 1
            assert router.counters["retries"] >= 1
            assert router.counters["failovers"] == 0
            assert r.failovers == 0
        finally:
            fleet.stop_all()

    def test_injector_anchoring_is_harness_owned(self, bundles):
        plan = FaultPlan(seed=0, events=[FaultEvent(kind="error", rate=1.0)])
        fleet = _fleet([bundles[0]], n=2, fault_plan=plan)
        fleet.start()
        try:
            injectors = [fleet.entry(rid)["injector"] for rid in ("replica-0", "replica-1")]
            assert all(i._t0 is None for i in injectors)
            t0 = time.monotonic()
            fleet.activate_faults(t0)
            assert all(i._t0 == t0 for i in injectors)
        finally:
            fleet.stop_all()


def _readyz(rep):
    conn = http.client.HTTPConnection(rep.host, rep.port, timeout=30)
    try:
        conn.request("GET", "/readyz")
        return json.loads(conn.getresponse().read())
    finally:
        conn.close()


class TestFleetSwap:
    def test_two_phase_swap_zero_drops(self, bundles):
        fleet = _fleet(bundles, n=2)
        fleet.start()
        router = FleetRouter(fleet.replicas, retry=RetryPolicy())
        try:
            entry = fleet.entry("replica-0")
            h1 = entry["registry"].default_hash
            h2 = [h for h in entry["registry"].hashes if h != h1][0]
            obs = _obs(1)[0]
            results = []

            def traffic():
                results.append(run_fleet_loadgen(
                    router, np.stack([obs] * 40), np.arange(40) * 0.005,
                    [f"house-{i}" for i in range(10)],
                ))

            t = threading.Thread(target=traffic)
            t.start()
            time.sleep(0.05)
            out = asyncio.run(router.swap_fleet(h2))
            t.join(timeout=60)
            assert out["config_hash"] == h2
            assert sorted(out["replicas"]) == sorted(router.replica_ids)
            result = results[0]
            assert result.n_ok == result.n_requests
            assert set(result.config_hashes) <= {h1, h2}
            for rid in router.replica_ids:
                assert _readyz(router.replica(rid))["config_hash"] == h2
            assert router.fleet_config_hash == h2
            assert router.pinned_count == 0
            r = _act(router, "post-swap-house", obs)
            assert r.status == 200 and r.config_hash == h2
        finally:
            fleet.stop_all()

    def test_stale_replica_realigned_not_readmitted(self, bundles):
        fleet = _fleet(bundles, n=2)
        fleet.start()
        router = FleetRouter(fleet.replicas, fail_threshold=2, ok_threshold=1)
        try:
            entry = fleet.entry("replica-0")
            h1 = entry["registry"].default_hash
            h2 = [h for h in entry["registry"].hashes if h != h1][0]
            fleet.kill("replica-1")
            for _ in range(2):
                router.probe_once()
            assert not router.is_healthy("replica-1")
            asyncio.run(router.swap_fleet(h2))
            fleet.restart("replica-1")
            assert fleet.entry("replica-1")["registry"].default_hash == h1
            assert router.probe_once()["replica-1"] is False
            assert not router.is_healthy("replica-1")
            assert router.counters["swap_aligns"] == 1
            assert fleet.entry("replica-1")["registry"].default_hash == h2
            assert router.probe_once()["replica-1"] is True
            assert router.is_healthy("replica-1")
        finally:
            fleet.stop_all()

    def test_swap_unknown_hash_rolls_back(self, bundles):
        fleet = _fleet(bundles, n=2)
        fleet.start()
        router = FleetRouter(fleet.replicas)
        try:
            h1 = fleet.entry("replica-0")["registry"].default_hash
            with pytest.raises(FleetSwapError, match="push answered 404"):
                asyncio.run(router.swap_fleet("deadbeef0000"))
            for rid in router.replica_ids:
                assert fleet.entry(rid)["registry"].default_hash == h1
            assert router.fleet_config_hash is None
        finally:
            fleet.stop_all()


class TestLoadgenRetry:
    def _shedding_gateway(self, bundles, wait_window_s):
        gateway = build_gateway(
            [bundles[0]], max_batch=4, device="cpu",
            admission=AdmissionConfig(
                wait_budget_ms=5.0, min_wait_samples=8,
                retry_after_s=0.3, wait_window_s=wait_window_s,
            ),
        )
        default = gateway.registry.get(gateway.registry.default_hash)
        now = time.monotonic()
        for _ in range(16):
            default.queue.recent_wait_ms.append((now, 100.0))
        return gateway

    def test_no_retry_preserves_shed_semantics(self, bundles):
        gateway = self._shedding_gateway(bundles, wait_window_s=0.15)
        with GatewayServer(gateway):
            result = run_network_loadgen(
                gateway.host, gateway.port, _obs(4), np.zeros(4), ["h0", "h1", "h2", "h3"],
            )
        assert result.n_shed == 4
        assert result.total_retries == 0
        assert result.retry_rate == 0.0 and result.n_gave_up == 0

    def test_retry_honors_retry_after_and_recovers(self, bundles):
        gateway = self._shedding_gateway(bundles, wait_window_s=0.15)
        with GatewayServer(gateway):
            result = run_network_loadgen(
                gateway.host, gateway.port, _obs(4), np.zeros(4), ["h0", "h1", "h2", "h3"],
                retry=RetryPolicy(max_attempts=5, deadline_s=20.0),
            )
        assert result.n_ok == 4
        assert result.total_retries >= 4
        assert result.retry_rate >= 1.0
        assert result.n_gave_up == 0
        assert float(result.latencies_s.min()) >= 0.3

    def test_retry_attempts_capped_by_deadline_under_stall(self, bundles):
        """A stalled replica must not let one attempt overrun the retry
        policy's per-request deadline by the full transport timeout, and
        the gateway's teardown must not wait out the stall."""
        plan = FaultPlan(seed=0, events=[FaultEvent(kind="stall", rate=1.0, stall_s=5.0)])
        gateway = build_gateway(
            [bundles[0]], max_batch=4, admission=_OPEN_ADMISSION, device="cpu",
            fault_injector=FaultInjector(plan, "replica-0"),
        )
        with GatewayServer(gateway):
            t0 = time.monotonic()
            result = run_network_loadgen(
                gateway.host, gateway.port, _obs(1), np.zeros(1), ["h0"],
                timeout_s=30.0, retry=RetryPolicy(max_attempts=3, deadline_s=0.5),
            )
        assert time.monotonic() - t0 < 3.0
        assert result.statuses[0] == -1
        assert float(result.latencies_s[0]) < 2.0

    def test_retry_gives_up_against_persistent_shed(self, bundles):
        gateway = self._shedding_gateway(bundles, wait_window_s=1e6)
        with GatewayServer(gateway):
            result = run_network_loadgen(
                gateway.host, gateway.port, _obs(2), np.zeros(2), ["h0", "h1"],
                retry=RetryPolicy(max_attempts=2, deadline_s=5.0),
            )
        assert result.n_shed == 2
        assert result.n_gave_up == 2
        assert result.total_retries == 2


class TestFleetBenchAndSchema:
    def test_chaos_bench_acceptance(self, bundles, tmp_path):
        """Kill/restart mid-bench: availability >= 0.99 of admitted
        requests, every pinned household on a healthy replica, answers
        bit-identical to the direct engine, the rows pass the schema
        checker, and the warehouse's fleet view joins the replicas' runs
        and the router's."""
        from p2pmicrogrid_tpu_torch.data.results import ResultsStore
        from p2pmicrogrid_tpu_torch.telemetry import SqliteSink, Telemetry, run_manifest

        n_requests, rate = 160, 320.0
        duration = n_requests / rate
        plan = kill_restart_plan("replica-1", kill_at_s=0.3 * duration,
                                 restart_at_s=0.6 * duration, seed=0)
        db = str(tmp_path / "fleet.db")
        fleet = _fleet([bundles[0]], fault_plan=plan, results_db=db)
        fleet.start()
        engine = fleet.reference_engine()
        tel = Telemetry(
            run_id="fleet-router-test", sinks=[SqliteSink(db)],
            manifest=run_manifest(extra={
                "config_hash": engine.manifest.get("config_hash"),
                "serve_role": "router", "fleet_size": 3,
            }),
        )
        router = FleetRouter(
            fleet.replicas, retry=RetryPolicy(max_attempts=6, deadline_s=30.0),
            fail_threshold=2, ok_threshold=1, telemetry=tel,
        )
        try:
            rows = serve_bench_fleet(
                router, n_agents=A, fleet=fleet, fault_plan=plan, reference_engine=engine,
                rate_hz=rate, n_requests=n_requests, n_households=12, seed=0,
                probe_interval_s=0.05,
            )
        finally:
            fleet.stop_all()
            tel.close()
        head = rows[-1]
        assert head["metric"] == "serve_bench_fleet"
        assert head["chaos"]["kills"] == ["replica-1"]
        assert head["chaos"]["restarts"] == ["replica-1"]
        assert head["failover_count"] >= 1
        assert head["availability"] >= 0.99
        assert head["bit_exact"] is True
        assert head["n_healthy"] == 3
        for h, rid in router.pinned_households().items():
            assert router.is_healthy(rid), (h, rid)
        path = tmp_path / "FLEET_r00.jsonl"
        path.write_text("".join(json.dumps(r) + "\n" for r in rows))
        problems: list = []
        _load_checker().check_fleet_jsonl(str(path), problems)
        assert problems == []
        with ResultsStore(db) as store:
            view = store.query_fleet_view()
        assert len(view) == 1
        row = view[0]
        assert row["config_hash"] == engine.manifest.get("config_hash")
        assert row["n_runs"] == 4
        assert row["n_router_runs"] == 1
        assert row["n_serve_traces"] > 0
        assert row["router_failovers"] >= 1

    def test_serve_bench_fleet_cli_one_json_per_line(self, capfd, tmp_path, monkeypatch):
        """The command line's fleet mode at a small size (A=2, 2 replicas,
        24 requests): one JSON object a stdout line, the headline last."""
        from p2pmicrogrid_tpu_torch.cli import main

        monkeypatch.setenv("P2P_TELEMETRY_DIR", str(tmp_path / "runs"))
        rc = main([
            "serve-bench", "--fleet", "--chaos", "--agents", "2",
            "--implementation", "tabular", "--requests", "24",
            "--rate", "120", "--max-batch", "4", "--max-wait-ms", "1",
            "--households", "6", "--replicas", "2",
            "--max-queue-depth", "100000", "--wait-budget-ms", "100000",
            "--device", "cpu",
        ])
        assert rc == 0
        out, err = capfd.readouterr()
        rows = [json.loads(line) for line in out.splitlines() if line.strip()]
        head = rows[-1]
        assert head["metric"] == "serve_bench_fleet"
        assert head["chaos"]["kills"] and head["chaos"]["restarts"]
        assert head["availability"] >= 0.99
        assert head["bit_exact"] is True
        assert "fleet of 2 replicas" in err

    def test_population_waits_for_the_scale_tier(self):
        from p2pmicrogrid_tpu_torch.cli import main

        with pytest.raises(SystemExit, match="item 15") as err:
            main(["serve-bench", "--fleet", "--population", "1000", "--device", "cpu"])
        assert err.value.code not in (0, None)


# -- the router proxy ----------------------------------------------------------------


@pytest.fixture(scope="module")
def proxied_fleet(bundles):
    from p2pmicrogrid_tpu_torch.serve import ProxyServer, RouterProxy, TokenAuthenticator, generate_secret

    auth = TokenAuthenticator(generate_secret())
    fleet = _fleet(bundles, n=2, mux=True, authenticator=auth)
    fleet.start()
    router = FleetRouter(
        fleet.replicas, retry=RetryPolicy(max_attempts=3, deadline_s=10.0), token=auth.mint("*"),
    )
    proxy = RouterProxy(router, mux_port=0, authenticator=auth)
    server = ProxyServer(proxy)
    host, port = server.start()
    yield {"fleet": fleet, "router": router, "proxy": proxy, "auth": auth,
           "host": host, "port": port}
    server.stop()
    fleet.stop_all()


def _proxy_call(pf, body, token=None, path="/v1/act", method="POST", port=None):
    from p2pmicrogrid_tpu_torch.serve.loadgen import _http_request_json

    async def run():
        return await _http_request_json(
            pf["host"], port or pf["port"], method, path, body, 10.0, token=token,
        )

    return asyncio.run(run())


class TestRouterProxy:
    def test_act_through_proxy_bit_exact(self, proxied_fleet):
        pf = proxied_fleet
        obs = _obs(1)[0]
        status, doc, _ = _proxy_call(
            pf, {"household": "house-1", "obs": obs.tolist()}, token=pf["auth"].mint("house-1"),
        )
        assert status == 200
        engine = pf["fleet"].reference_engine()
        assert (np.asarray(doc["actions"], dtype=np.float32) == engine.act(obs[None])[0]).all()
        assert doc["replica_id"] in {"replica-0", "replica-1"}

    def test_proxy_terminates_auth(self, proxied_fleet):
        pf = proxied_fleet
        status, _, _ = _proxy_call(pf, {"household": "house-1", "obs": _obs(1)[0].tolist()})
        assert status == 401
        assert pf["proxy"].stats["auth_401"] >= 1
        status, _, _ = _proxy_call(
            pf, {"household": "house-2", "obs": _obs(1)[0].tolist()},
            token=pf["auth"].mint("house-1"),
        )
        assert status == 403

    def test_batched_obs(self, proxied_fleet):
        pf = proxied_fleet
        status, doc, _ = _proxy_call(
            pf, {"household": "house-1", "obs": _obs(3).tolist()}, token=pf["auth"].mint("house-1"),
        )
        assert status == 200 and len(doc["actions"]) == 3

    def test_readyz_and_stats(self, proxied_fleet):
        pf = proxied_fleet
        status, doc, _ = _proxy_call(pf, None, path="/readyz", method="GET")
        assert status == 200 and doc["n_healthy"] == 2
        status, _, _ = _proxy_call(pf, None, path="/stats", method="GET")
        assert status == 401
        status, doc, _ = _proxy_call(pf, None, path="/stats", method="GET", token=pf["auth"].mint("*"))
        assert status == 200
        assert doc["kind"] == "fleet_stats"
        assert set(doc["processes"]) == {"replica-0", "replica-1"}
        assert doc["proxy"]["act_ok"] >= 1

    def test_admin_swap_flips_the_fleet(self, proxied_fleet):
        """``/admin/swap`` needs the wildcard, flips every replica two-phase,
        and ``/readyz`` then reports the new hash; an unknown hash is 502
        and moves nothing."""
        pf = proxied_fleet
        reg = pf["fleet"].entry("replica-0")["registry"]
        h1 = reg.default_hash
        h2 = [h for h in reg.hashes if h != h1][0]
        wildcard = pf["auth"].mint("*")
        status, _, _ = _proxy_call(pf, {"config_hash": h2}, path="/admin/swap",
                                   token=pf["auth"].mint("house-1"))
        assert status == 403
        status, doc, _ = _proxy_call(pf, {"config_hash": "deadbeef0000"}, path="/admin/swap",
                                     token=wildcard)
        assert status == 502
        try:
            status, doc, _ = _proxy_call(pf, {"config_hash": h2}, path="/admin/swap", token=wildcard)
            assert status == 200 and doc["config_hash"] == h2
            status, doc, _ = _proxy_call(pf, None, path="/readyz", method="GET")
            assert status == 200 and doc["config_hash"] == h2
            for rid in ("replica-0", "replica-1"):
                assert pf["fleet"].entry(rid)["registry"].default_hash == h2
            status, doc, _ = _proxy_call(
                pf, {"household": "house-9", "obs": _obs(1)[0].tolist()},
                token=pf["auth"].mint("house-9"),
            )
            assert status == 200 and doc["config_hash"] == h2
        finally:
            asyncio.run(pf["router"].swap_fleet(h1))

    def test_auth_rejection_skips_retry_budget(self, proxied_fleet):
        pf = proxied_fleet
        unauth = FleetRouter(pf["fleet"].replicas, retry=RetryPolicy(max_attempts=4, deadline_s=10.0))
        obs = _obs(4)

        async def run():
            try:
                return await asyncio.gather(*(unauth.act(f"house-{i}", obs[i]) for i in range(4)))
            finally:
                await unauth.close_pools()

        results = asyncio.run(run())
        assert all(r.status == 401 and r.retries == 0 for r in results)
        assert unauth.budget.spent == 0
        assert unauth.counters["auth_denied"] == 4


def test_serve_router_command(bundles, tmp_path):
    """``python -m p2pmicrogrid_tpu_torch serve-router`` in front of a fleet:
    its ``router_listening`` line, an act through it, ``/readyz``, and the
    final fleet stats written on exit. It runs no model, so it takes no
    ``--device``."""
    import subprocess
    import sys

    import p2pmicrogrid_tpu_torch

    repo = os.path.dirname(os.path.dirname(os.path.abspath(p2pmicrogrid_tpu_torch.__file__)))
    fleet = _fleet([bundles[0]], n=2, mux=True)
    fleet.start()
    stats = tmp_path / "stats.json"
    argv = [sys.executable, "-m", "p2pmicrogrid_tpu_torch", "serve-router", "--port", "0",
            "--serve-seconds", "4", "--stats-out", str(stats)]
    for rep in fleet.replicas:
        argv += ["--replica", f"{rep.host}:{rep.port}/{rep.mux_port}"]
    proc = subprocess.Popen(argv, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            cwd=str(tmp_path), env=dict(os.environ, PYTHONPATH=repo))
    try:
        listening = json.loads(proc.stdout.readline())
        assert listening["kind"] == "router_listening"
        assert [r["replica_id"] for r in listening["replicas"]] == ["replica-0", "replica-1"]
        pf = {"host": listening["host"], "port": listening["port"]}
        obs = _obs(1)[0]
        status, doc, _ = _proxy_call(pf, {"household": "house-1", "obs": obs.tolist()})
        assert status == 200
        assert (np.asarray(doc["actions"], np.float32) == fleet.reference_engine().act(obs[None])[0]).all()
        status, doc, _ = _proxy_call(pf, None, path="/readyz", method="GET")
        assert status == 200 and doc["ready"] is True
        assert proc.wait(timeout=60) == 0, proc.stderr.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        fleet.stop_all()
    assert json.loads(stats.read_text())["n_replicas"] == 2
