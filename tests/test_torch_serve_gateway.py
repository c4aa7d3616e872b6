"""The port's bundle registry and HTTP gateway on the CPU (torch only).

A real socket server over the port's engines: the registry registers,
routes, swaps, splits and pins; ``/healthz``, ``/readyz`` and ``/stats``
answer; concurrent households get ``engine.act``'s answers bit for bit on
both fronts; a hot swap mid-traffic fails no request; the gateway sheds
with 429, refuses malformed input with 400 and oversize with 413, answers
503 while draining; bearer tokens are minted and verified; wire frames
round-trip and the multiplexed listener answers as HTTP does. Every socket
and future wait has a timeout.
"""

import asyncio
import http.client
import json
import threading
import time

import numpy as np
import pytest
import torch

from p2pmicrogrid_tpu_torch import config as tc
from p2pmicrogrid_tpu_torch.serve import (
    AdmissionConfig,
    BundleRegistry,
    GatewayServer,
    MicroBatchQueue,
    MuxConnection,
    PolicyEngine,
    TokenAuthenticator,
    build_gateway,
    build_registry,
    calibration_obs,
    encode_frame,
    export_policy_bundle,
    generate_secret,
    mint_token,
    read_frame,
    verify_token,
)
from p2pmicrogrid_tpu_torch.serve.auth import AuthError
from p2pmicrogrid_tpu_torch.train.policies import init_policy_state

A = 3
TIMEOUT = 30.0
PERMISSIVE = AdmissionConfig(max_queue_depth=100_000, wait_budget_ms=100_000.0)


def _make_bundle(tmp_path, seed, name):
    """A tabular bundle with a randomly drawn table; distinct
    seeds give distinct config_hashes (the registry key)."""
    cfg = tc.default_config(
        sim=tc.SimConfig(n_agents=A),
        train=tc.TrainConfig(implementation="tabular", seed=seed),
    )
    gen = torch.Generator().manual_seed(seed)
    ps = init_policy_state(cfg, "cpu", gen)
    ps = ps._replace(q_table=torch.randn(ps.q_table.shape, generator=gen))
    return export_policy_bundle(cfg, ps, str(tmp_path / name), device="cpu")


def _request(host, port, method, path, body=None, headers=None):
    """(status, parsed JSON, headers) over stdlib http.client."""
    conn = http.client.HTTPConnection(host, port, timeout=TIMEOUT)
    try:
        conn.request(
            method, path,
            body=json.dumps(body) if isinstance(body, dict) else body,
            headers={"Content-Type": "application/json", **(headers or {})},
        )
        resp = conn.getresponse()
        raw = resp.read()
        return resp.status, (json.loads(raw) if raw else {}), dict(resp.getheaders())
    finally:
        conn.close()


def _act(host, port, household, obs, headers=None):
    return _request(host, port, "POST", "/v1/act", {"household": household, "obs": obs.tolist()},
                    headers=headers)


@pytest.fixture
def bundles(tmp_path):
    return _make_bundle(tmp_path, 0, "b1"), _make_bundle(tmp_path, 1, "b2")


@pytest.fixture
def server(bundles):
    gateway = build_gateway(list(bundles), max_batch=4, max_wait_s=0.02, device="cpu",
                            admission=PERMISSIVE, mux_port=0)
    with GatewayServer(gateway):
        yield gateway, gateway.host, gateway.port


def _engine_queue(bundle):
    engine = PolicyEngine(bundle_dir=bundle, max_batch=4, device="cpu")
    return engine, MicroBatchQueue(engine, max_wait_s=0.005)


def test_registry_route_swap_split_pins(bundles):
    (e1, q1), (e2, q2) = (_engine_queue(b) for b in bundles)
    reg = BundleRegistry()
    h1, h2 = reg.register(e1, q1), reg.register(e2, q2)
    try:
        assert h1 != h2 and reg.default_hash == h1
        with pytest.raises(ValueError, match="already registered"):
            reg.register(e1, q1)
        # No split: every route serves the default and records no pin.
        assert reg.route("house-1").config_hash == h1 and reg.pinned_count == 0
        reg.set_split(h2, 30.0)
        homes = [f"house-{i}" for i in range(64)]
        first = {h: reg.route(h).config_hash for h in homes}
        assert set(first.values()) == {h1, h2}
        reg.set_split(h2, 90.0)  # pins hold across a new percent
        assert all(reg.route(h).config_hash == first[h] for h in homes)
        assert reg.route(None).config_hash == h1  # anonymous -> default
        with pytest.raises(ValueError, match="split"):
            reg.remove(h2)
        reg.clear_split()
        assert reg.swap(h2) == h1  # a swap clears the pins
        assert all(reg.route(h).config_hash == h2 for h in homes)
        s = reg.stats()
        assert s["default"] == h2 and s["bundles"][h1]["implementation"] == "tabular"
        assert reg.remove(h1).config_hash == h1
        with pytest.raises(KeyError):
            reg.swap(h1)
        with pytest.raises(ValueError, match="default"):
            reg.remove(h2)
    finally:
        q1.close()
        q2.close()


def test_health_ready_stats(server):
    gateway, host, port = server
    status, doc, _ = _request(host, port, "GET", "/healthz")
    assert status == 200 and doc["ok"] is True
    status, doc, _ = _request(host, port, "GET", "/readyz")
    assert status == 200 and doc["ready"] is True
    assert doc["config_hash"] == gateway.registry.default_hash
    status, doc, _ = _request(host, port, "GET", "/stats")
    assert status == 200 and doc["kind"] == "gateway_stats"
    assert doc["default"] in doc["bundles"] and len(doc["bundles"]) == 2
    assert doc["wire"]["mux_port"] == gateway.mux_port


@pytest.mark.parametrize("batching", ["micro", "continuous"])
def test_concurrent_households_bit_exact(bundles, batching):
    """A lone household (bucket 1), then three fired together (bucket 4)
    and one batched request: every answer equals ``engine.act``."""
    gateway = build_gateway(list(bundles), max_batch=4, max_wait_s=0.05, device="cpu",
                            admission=PERMISSIVE, batching=batching)
    with GatewayServer(gateway):
        host, port = gateway.host, gateway.port
        engine = gateway.registry.get(gateway.registry.default_hash).engine
        obs = calibration_obs(7, A, seed=7)
        status, solo, _ = _act(host, port, "house-solo", obs[0])
        assert status == 200
        results = [None] * 3

        def fire(i):
            results[i] = _act(host, port, f"house-{i}", obs[1 + i])

        threads = [threading.Thread(target=fire, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(TIMEOUT)
        assert not any(t.is_alive() for t in threads)
        assert all(r[0] == 200 for r in results)
        status, batched, _ = _act(host, port, "house-b", obs[4:])
        assert status == 200
        assert engine.stats["rows"] == 7 and engine.stats["padded_rows"] >= 1
        got = np.asarray([solo["actions"]] + [r[1]["actions"] for r in results]
                         + batched["actions"], np.float32)
        np.testing.assert_array_equal(got, engine.act(obs))


def test_hot_swap_mid_traffic_zero_failures(server):
    gateway, host, port = server
    h1, h2 = gateway.registry.hashes
    obs = calibration_obs(1, A, seed=3)[0]
    statuses, hashes, lock = [], [], threading.Lock()

    def fire(i):
        s, doc, _ = _act(host, port, f"house-{i}", obs)
        with lock:
            statuses.append(s)
            hashes.append(doc.get("config_hash"))

    wave1 = [threading.Thread(target=fire, args=(i,)) for i in range(8)]
    for t in wave1:
        t.start()
    status, doc, _ = _request(host, port, "POST", "/admin/swap", {"config_hash": h2})
    assert status == 200 and doc["default"] == h2
    wave2 = [threading.Thread(target=fire, args=(100 + i,)) for i in range(8)]
    for t in wave2:
        t.start()
    for t in wave1 + wave2:
        t.join(TIMEOUT)
    assert statuses == [200] * 16
    assert h2 in hashes and set(hashes) <= {h1, h2}
    assert gateway.stats["swaps"] == 1
    after = _act(host, port, "house-late", obs)[1]
    want = gateway.registry.get(h2).engine.act(obs[None])[0]
    assert after["config_hash"] == h2
    np.testing.assert_array_equal(np.asarray(after["actions"], np.float32), want)


def test_admission_sheds_with_429(bundles):
    gateway = build_gateway([bundles[0]], max_batch=4, max_wait_s=0.25, device="cpu",
                            admission=AdmissionConfig(max_queue_depth=1, retry_after_s=2.5,
                                                      min_wait_samples=10_000))
    with GatewayServer(gateway):
        host, port = gateway.host, gateway.port
        obs = calibration_obs(1, A)[0]
        results = [None] * 6

        def fire(i):
            results[i] = _act(host, port, f"h{i}", obs)

        threads = [threading.Thread(target=fire, args=(i,)) for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(TIMEOUT)
        statuses = [r[0] for r in results]
        shed = [r for r in results if r[0] == 429]
        assert 200 in statuses and shed
        _, doc, headers = shed[0]
        assert headers.get("Retry-After") == "2.5" and "queue depth" in doc["error"]
        assert gateway.stats["shed"] == len(shed)
        # A saturated wait window sheds too, and ages out.
        gateway.admission = AdmissionConfig(wait_budget_ms=5.0, min_wait_samples=8)
        default = gateway.registry.get(gateway.registry.default_hash)
        now = time.monotonic()
        for _ in range(16):
            default.queue.recent_wait_ms.append((now, 100.0))
        status, doc, _ = _act(host, port, "h", obs)
        assert status == 429 and "p95 queue wait" in doc["error"]
        default.queue.recent_wait_ms.clear()
        for _ in range(16):
            default.queue.recent_wait_ms.append((now - 2 * gateway.admission.wait_window_s, 100.0))
        assert _act(host, port, "h", obs)[0] == 200


def test_bad_requests_400_413_404_405(bundles):
    gateway = build_gateway([bundles[0]], max_batch=4, device="cpu", admission=AdmissionConfig(
        max_queue_depth=100_000, wait_budget_ms=100_000.0, max_request_rows=2, max_body_bytes=4096))
    with GatewayServer(gateway):
        host, port = gateway.host, gateway.port
        status, doc, _ = _request(host, port, "POST", "/v1/act", body="{not json")
        assert status == 400 and "JSON" in doc["error"]
        status, doc, _ = _request(host, port, "POST", "/v1/act",
                                  {"household": "h", "obs": [[0.0] * 4] * (A + 2)})
        assert status == 400 and "obs must be" in doc["error"]
        status, doc, _ = _request(host, port, "POST", "/v1/act", {"household": "h"})
        assert status == 400 and "missing 'obs'" in doc["error"]
        status, doc, _ = _request(host, port, "POST", "/v1/act", {"household": 5, "obs": []})
        assert status == 400 and "household" in doc["error"]
        status, doc, _ = _act(host, port, "h", calibration_obs(3, A))
        assert status == 413 and "row request limit" in doc["error"]
        status, doc, _ = _request(host, port, "POST", "/v1/act", body="x" * 5000)
        assert status == 413
        status, doc, _ = _request(host, port, "POST", "/admin/swap", {"config_hash": "nope"})
        assert status == 404
        assert _request(host, port, "GET", "/nowhere")[0] == 404
        assert _request(host, port, "GET", "/v1/act")[0] == 405


def test_drain_answers_503(server):
    gateway, host, port = server
    status, doc, _ = _request(host, port, "POST", "/admin/drain", {})
    assert status == 200 and doc["draining"] is True
    status, doc, headers = _act(host, port, "h", calibration_obs(1, A)[0])
    assert status == 503 and "draining" in doc["error"] and "Retry-After" in headers
    status, doc, _ = _request(host, port, "GET", "/readyz")
    assert status == 503 and doc["reason"] == "draining"


def test_register_and_unregister_at_runtime(server, tmp_path):
    gateway, host, port = server
    b3 = _make_bundle(tmp_path, 2, "b3")
    status, doc, _ = _request(host, port, "POST", "/admin/register", {"bundle_dir": b3})
    assert status == 200 and doc["already_registered"] is False and len(doc["bundles"]) == 3
    status, doc, _ = _request(host, port, "POST", "/admin/register", {"bundle_dir": b3})
    assert status == 200 and doc["already_registered"] is True
    new = [h for h in doc["bundles"] if h not in gateway.registry.hashes[:2]][0]
    status, doc, _ = _request(host, port, "POST", "/admin/unregister", {"config_hash": new})
    assert status == 200 and doc["was_registered"] is True


def test_tokens_minted_and_verified(bundles, tmp_path):
    secret = generate_secret(str(tmp_path / "fleet.secret"))
    token = mint_token(secret, "h1")
    assert verify_token(secret, token)["household"] == "h1"
    with pytest.raises(AuthError):
        verify_token(generate_secret(), token)
    auth = TokenAuthenticator(secret)
    gateway = build_gateway([bundles[0]], max_batch=4, device="cpu", admission=PERMISSIVE,
                            authenticator=auth)
    with GatewayServer(gateway):
        host, port = gateway.host, gateway.port
        obs = calibration_obs(1, A)[0]
        assert _act(host, port, "h1", obs)[0] == 401
        bearer = {"Authorization": f"Bearer {token}"}
        assert _act(host, port, "h2", obs, headers=bearer)[0] == 403
        status, doc, _ = _act(host, port, "h1", obs, headers=bearer)
        assert status == 200
        assert _request(host, port, "GET", "/stats", headers=bearer)[0] == 403
        wildcard = {"Authorization": f"Bearer {auth.mint('*')}"}
        assert _request(host, port, "GET", "/stats", headers=wildcard)[0] == 200
        assert _request(host, port, "GET", "/healthz")[0] == 200
        assert gateway.stats["auth_401"] == 1 and gateway.stats["auth_403"] == 2


def test_wire_frames_round_trip_and_mux_acts(server):
    gateway, host, port = server
    doc = {"id": 7, "method": "POST", "path": "/v1/act", "body": {"x": [1.5, -0.25]}}

    async def frames():
        reader = asyncio.StreamReader()
        reader.feed_data(encode_frame(doc) + encode_frame({"id": 8}))
        reader.feed_eof()
        return [await read_frame(reader), await read_frame(reader), await read_frame(reader)]

    assert asyncio.run(frames()) == [doc, {"id": 8}, None]
    obs = calibration_obs(2, A, seed=4)

    async def mux():
        conn = await MuxConnection.open(host, gateway.mux_port)
        try:
            return await asyncio.gather(*(
                conn.request("/v1/act", {"household": f"m{i}", "obs": obs[i].tolist()},
                             timeout_s=TIMEOUT)
                for i in range(2)
            ))
        finally:
            await conn.close()

    answers = asyncio.run(asyncio.wait_for(mux(), TIMEOUT))
    engine = gateway.registry.get(gateway.registry.default_hash).engine
    assert [s for s, _, _ in answers] == [200, 200]
    got = np.asarray([body["actions"] for _, body, _ in answers], np.float32)
    np.testing.assert_array_equal(got, engine.act(obs))
    assert gateway.stats["mux_requests"] == 2


def test_mux_request_on_a_lost_tls_connection_is_a_transport_error():
    """A request queued behind the write lock when its TLS connection is
    lost and closed fails with ConnectionResetError, the error the pool and
    the router fail over on; writing to the closed TLS transport would
    raise AttributeError out of the router's act instead."""
    from p2pmicrogrid_tpu_torch.serve.auth import (
        client_ssl_context,
        ensure_test_certs,
        server_ssl_context,
    )

    cert, key = ensure_test_certs()

    async def scenario():
        accepted: list = []

        async def hold(reader, writer):
            accepted.append(writer)
            await reader.read()

        server = await asyncio.start_server(
            hold, "127.0.0.1", 0, ssl=server_ssl_context(cert, key)
        )
        port = server.sockets[0].getsockname()[1]
        conn = await MuxConnection.open(
            "127.0.0.1", port, ssl=client_ssl_context(cert)
        )
        try:
            while not accepted:
                await asyncio.sleep(0.01)
            async with conn._write_lock:
                queued = asyncio.ensure_future(
                    conn.request("/v1/act", {"obs": [0.0]}, timeout_s=TIMEOUT)
                )
                await asyncio.sleep(0)  # past its closed check, at the lock
                accepted[0].transport.abort()
                while not conn.closed:  # the read loop saw the loss
                    await asyncio.sleep(0.01)
                await conn.close()
            with pytest.raises(ConnectionResetError):
                await queued
        finally:
            await conn.close()
            server.close()
            await server.wait_closed()

    asyncio.run(asyncio.wait_for(scenario(), TIMEOUT))


def test_results_db_streams_serve_requests(bundles, tmp_path):
    """With ``results_db`` every answered request lands in the warehouse as
    one ``serve_request`` point under the serving bundle's config_hash."""
    import sqlite3

    db = str(tmp_path / "results.db")
    gateway = build_gateway([bundles[0]], max_batch=4, device="cpu", results_db=db,
                            admission=PERMISSIVE)
    with GatewayServer(gateway):
        obs = calibration_obs(5, A, seed=6)
        for i in range(5):
            status, body, _ = _act(gateway.host, gateway.port, f"h{i}", obs[i])
            assert status == 200, body
        config_hash = gateway.registry.default_hash
    con = sqlite3.connect(db)
    try:
        (n,) = con.execute(
            "SELECT COUNT(*) FROM telemetry_points p JOIN telemetry_runs r USING (run_id) "
            "WHERE p.kind = 'serve_request' AND r.config_hash = ?",
            (config_hash,),
        ).fetchone()
        (role,) = con.execute(
            "SELECT json_extract(manifest_json, '$.serve_role') FROM telemetry_runs "
            "WHERE config_hash = ?", (config_hash,),
        ).fetchone()
    finally:
        con.close()
    assert n == 5
    assert role == "default"
