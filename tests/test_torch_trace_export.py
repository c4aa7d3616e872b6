"""The port's trace export against the JAX package's (CPU).

* ``trace_reward``, ``decision_cost`` and the billed energy settlement on the
  same seeded observations and actions at ``rtol=1e-6``
  (tests/test_torch_ops.py's tolerance for the ops they run).
* ``export_serve_traces`` on one warehouse that the port's gateway wrote at
  A=3 equals the JAX package's reader on the same file: the transitions bit
  for bit, their provenance, counts and window, the rewards at
  ``rtol=1e-6``; filtered by config hash and by ``since_ts`` too; and both
  refuse a compacted warehouse.
* The port's meter (``bill_decisions``) writes settlement rows that both
  packages' ``settlement_reward_fn`` join the same way, the unbilled
  transitions falling back to the tariff model loudly.
* ``to_replay_state``'s ring equals the JAX package's, overflow included.
"""

import io

import numpy as np
import pytest

from p2pmicrogrid_tpu import config as jcfg
from p2pmicrogrid_tpu.data import trace_export as jte
from p2pmicrogrid_tpu_torch import config as tcfg
from p2pmicrogrid_tpu_torch.data import trace_export as tte
from p2pmicrogrid_tpu_torch.data.results import ResultsStore
from p2pmicrogrid_tpu_torch.serve.gateway import AdmissionConfig, GatewayServer, build_gateway
from p2pmicrogrid_tpu_torch.serve.loadgen import synthetic_obs
from p2pmicrogrid_tpu_torch.serve.promotion import _drive_wire_stage, make_crafted_bundle

A = 3


def _cfgs():
    kw = lambda mod: dict(sim=mod.SimConfig(n_agents=A), train=mod.TrainConfig(implementation="tabular"))  # noqa: E731
    return jcfg.default_config(**kw(jcfg)), tcfg.default_config(**kw(tcfg))


def _obs_actions(n, seed):
    obs = synthetic_obs(n, A, seed=seed)
    act = np.random.default_rng(seed).choice([0.0, 0.5, 1.0], (n, A)).astype(np.float32)
    return obs, act


@pytest.mark.parametrize("seed", [0, 1])
def test_reward_attributions_match_jax(seed):
    cfg_j, cfg_t = _cfgs()
    obs, act = _obs_actions(96, seed)
    for name, kw in (("trace_reward", {}), ("decision_cost", {}), ("decision_cost", {"t_out": 2.5}),
                     ("_energy_settlement_eur", {})):
        got = getattr(tte, name)(cfg_t, obs, act, device="cpu", **kw)
        ref = getattr(jte, name)(cfg_j, obs, act, **kw)
        assert got.dtype == np.float32 and got.shape == (96, A)
        np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-6, err_msg=name)


@pytest.fixture(scope="module")
def warehouse(tmp_path_factory):
    """A results DB the port's gateway wrote: 40 requests from 8
    households, served by a crafted thermostat bundle."""
    _, cfg_t = _cfgs()
    root = tmp_path_factory.mktemp("trace-export")
    bundle = make_crafted_bundle(cfg_t, "incumbent", str(root / "inc"), device="cpu")
    db = str(root / "wh.db")
    gateway = build_gateway([bundle], max_batch=8, max_wait_s=0.005, results_db=db, device="cpu",
                            admission=AdmissionConfig(max_queue_depth=100_000, wait_budget_ms=1e9),
                            run_name="trace-test")
    server = GatewayServer(gateway)
    host, port = server.start()
    try:
        traffic = _drive_wire_stage(host, port, synthetic_obs(40, A, seed=11),
                                    [f"house-{i:02d}" for i in range(8)])
        assert (traffic.statuses == 200).all()
    finally:
        server.stop()
    return db, gateway.registry.default_hash


def _assert_same_dataset(got, ref):
    for name in ("obs", "action", "next_obs"):
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name), err_msg=name)
    np.testing.assert_allclose(got.reward, ref.reward, rtol=1e-6)
    for name in ("config_hash", "run_ids", "households", "n_decisions", "n_dropped", "meta",
                 "window_start_ts", "window_end_ts"):
        assert getattr(got, name) == getattr(ref, name), name


def test_export_matches_the_jax_reader(warehouse):
    db, config_hash = warehouse
    cfg_j, cfg_t = _cfgs()
    got = tte.export_serve_traces(db, cfg=cfg_t, device="cpu")
    ref = jte.export_serve_traces(db, cfg=cfg_j)
    assert got.n_decisions == 40 and got.n_transitions == 40 - 8
    _assert_same_dataset(got, ref)
    assert got.summary() == ref.summary()
    since = sorted(m["ts"] for m in ref.meta)[10]
    _assert_same_dataset(
        tte.export_serve_traces(db, config_hash=config_hash, cfg=cfg_t, since_ts=since, device="cpu"),
        jte.export_serve_traces(db, config_hash=config_hash, cfg=cfg_j, since_ts=since),
    )
    with pytest.raises(ValueError, match="no serve-role"):
        tte.export_serve_traces(db, config_hash="nope", cfg=cfg_t, device="cpu")
    with pytest.raises(ValueError, match="pass cfg"):
        tte.export_serve_traces(db)


def test_settlement_join_matches_jax(warehouse, tmp_path):
    import shutil

    db = str(tmp_path / "billed.db")
    shutil.copy(warehouse[0], db)
    cfg_j, cfg_t = _cfgs()
    ds = tte.export_serve_traces(db, cfg=cfg_t, device="cpu")
    # Bill the later half of the decisions: the earlier transitions fall back.
    since = sorted(m["ts"] for m in ds.meta)[len(ds.meta) // 2]
    n_billed = tte.bill_decisions(db, cfg_t, since_ts=since, device="cpu")
    assert 0 < n_billed < 40
    warn_t, warn_j = io.StringIO(), io.StringIO()
    got = tte.settlement_reward_fn(db, cfg_t, warn_stream=warn_t, device="cpu")(ds.obs, ds.action, ds.meta)
    ref = jte.settlement_reward_fn(db, cfg_j, warn_stream=warn_j)(ds.obs, ds.action, ds.meta)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-6)
    assert warn_t.getvalue() == warn_j.getvalue() and "settlement WARNING" in warn_t.getvalue()
    # Through the export's 3-argument hook, both readers.
    hook = tte.export_serve_traces(db, cfg=cfg_t, device="cpu",
                                   reward_fn=tte.settlement_reward_fn(db, cfg_t, warn_stream=io.StringIO(),
                                                                      device="cpu"))
    np.testing.assert_allclose(hook.reward, got, rtol=0)


def test_compacted_warehouse_fails_loud_in_both(warehouse, tmp_path):
    import shutil

    db = str(tmp_path / "compacted.db")
    shutil.copy(warehouse[0], db)
    with ResultsStore(db) as store:
        out = store.compact_serve_telemetry(older_than_hours=0.0)
    assert out["decisions_compacted"] > 0
    cfg_j, cfg_t = _cfgs()
    with pytest.raises(tte.TracesCompactedError, match="older-than-hours"):
        tte.export_serve_traces(db, cfg=cfg_t, device="cpu")
    with pytest.raises(jte.TracesCompactedError, match="older-than-hours"):
        jte.export_serve_traces(db, cfg=cfg_j)


@pytest.mark.parametrize("capacity", [None, 4, 50])
def test_replay_ring_matches_jax(capacity):
    obs, act = _obs_actions(12, 3)
    rew = np.random.default_rng(4).normal(size=(12, A)).astype(np.float32)
    nxt = np.roll(obs, -1, axis=0)
    ref = jte.to_replay_state(jte.TraceDataset(obs=obs, action=act, reward=rew, next_obs=nxt), capacity)
    got = tte.to_replay_state(tte.TraceDataset(obs=obs, action=act, reward=rew, next_obs=nxt), capacity,
                              device="cpu")
    for name in ("obs", "action", "reward", "next_obs"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)), err_msg=name)
    assert (got.cursor, got.count) == (int(ref.cursor), int(ref.count))
