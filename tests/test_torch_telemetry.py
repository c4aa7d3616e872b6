"""The port's device counters, telemetry registry and async drain against
the JAX package on the CPU.

* ``run_episode(collect_device_metrics=True)``: the single community's
  counters, unfused and fused (K7's plain version), against the jitted JAX
  ``run_episode``'s from the same draws (``test_torch_single_episode.py``'s
  key chain, 24 slots of day 11 where the community trades).
* The shared episode's counters and the chunked runner's counters and
  replay fill against ``make_shared_episode_fn``/``make_chunked_episode_runner
  (collect_device_metrics=True)``, fed the JAX chunk keys' own draws
  (``test_torch_chunked.py``).

Integer counters are held equal; the energies (float32 sums over every axis,
summed in another order than XLA's) at ``rtol=1e-5`` where the actions are
discrete and equal. DDPG's actions differ from the JAX package's within
``atol=1e-5`` (``tests/test_torch_ddpg.py``), and its energies follow them:
there they are held at the episodes' ``rtol=2e-4``.

* ``Telemetry``'s records on a ``MemorySink`` and ``config_hash`` equal to
  the JAX package's for the same calls.
* ``AsyncDrain``: FIFO consumption; the chunked trainer at depth 1 and depth
  2 gives identical records and final state.
"""

import json

import jax
import numpy as np
import pytest
import torch
from test_torch_chunked import _cfg as chunk_cfg
from test_torch_chunked import _chunk_draws, _jax_chunk_arrays
from test_torch_single_episode import BINS, jax_init_normals, jax_single_draws, jcom_tabular_state

from p2pmicrogrid_tpu import config as jcfg
from p2pmicrogrid_tpu.data import synthetic_traces as j_synthetic_traces
from p2pmicrogrid_tpu.envs import community as jcom
from p2pmicrogrid_tpu.parallel import scenarios as jsc
from p2pmicrogrid_tpu.parallel.device_gen import device_episode_arrays as j_device_episode_arrays
from p2pmicrogrid_tpu.telemetry import MemorySink as JMemorySink
from p2pmicrogrid_tpu.telemetry import Telemetry as JTelemetry
from p2pmicrogrid_tpu.telemetry import config_hash as j_config_hash
from p2pmicrogrid_tpu.train import make_policy as j_make_policy
from p2pmicrogrid_tpu_torch import config as tcfg
from p2pmicrogrid_tpu_torch.convert import state_from_jax, state_to_numpy
from p2pmicrogrid_tpu_torch.data.traces import synthetic_traces
from p2pmicrogrid_tpu_torch.envs import community as tcom
from p2pmicrogrid_tpu_torch.models.tabular import tabular_init
from p2pmicrogrid_tpu_torch.parallel import scenarios as tsc
from p2pmicrogrid_tpu_torch.telemetry import (
    AsyncDrain,
    DeviceCounters,
    MemorySink,
    SlotTally,
    Telemetry,
    config_hash,
    dc_add,
    dc_from_slot,
    dc_from_tally,
    dc_tally_slot_,
    dc_to_dict,
    dc_zero,
    replay_fill_fraction,
)
from p2pmicrogrid_tpu_torch.train import make_policy as t_make_policy
from p2pmicrogrid_tpu_torch.train.loop import train_community
from p2pmicrogrid_tpu_torch.train.policies import init_policy_state

A = 3
WINDOW = slice(36, 60)  # 09:00-15:00 of day 11: PV, batteries, trades


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def assert_counters_match(got: dict, ref: dict, rtol=1e-5):
    """Integer counters equal; the float32 energies at ``rtol``."""
    assert set(got) == set(ref) == set(DeviceCounters._fields)
    for name in ("nonfinite_q", "nonfinite_loss", "comfort_violations"):
        assert isinstance(got[name], int) and got[name] == ref[name], name
    for name in ("market_residual_wh", "trade_wh"):
        np.testing.assert_allclose(got[name], ref[name], rtol=rtol, err_msg=name)


# --- the single community's episode -------------------------------------------


def _single_cfg(mod):
    return mod.default_config(
        sim=mod.SimConfig(n_agents=A),
        battery=mod.BatteryConfig(enabled=True),
        qlearning=mod.QLearningConfig(**BINS),
        train=mod.TrainConfig(implementation="tabular"),
    )


@pytest.fixture(scope="module")
def jax_single():
    cfg = _single_cfg(jcfg)
    traces = j_synthetic_traces(n_days=1, start_day=11).normalized()
    ratings = jcom.make_ratings(cfg, np.random.default_rng(3))
    arrays = jcom.build_episode_arrays(cfg, traces, ratings)
    arrays = type(arrays)(*(x[WINDOW] for x in arrays))
    ps = jcom_tabular_state(cfg)
    phys = jcom.init_physical(cfg, jax.random.PRNGKey(1))
    key = jax.random.PRNGKey(2)
    policy = j_make_policy(cfg)
    out = jax.jit(
        lambda ps, phys, arrays, key: jcom.run_episode(
            cfg, policy, ps, phys, arrays, ratings, key, training=True, collect_device_metrics=True
        )
    )(ps, phys, arrays, key)
    from p2pmicrogrid_tpu.telemetry import dc_to_dict as j_dc_to_dict

    return dict(traces=traces, ratings=ratings, q=np.asarray(ps.q_table), key=key,
                outputs=out[2], counters=j_dc_to_dict(out[3]))


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_run_episode_counters_match_jax(jax_single, fused):
    cfg = _single_cfg(tcfg)
    arrays = tcom.build_episode_arrays(cfg, jax_single["traces"], jax_single["ratings"], device="cpu")
    arrays = type(arrays)(*(x[WINDOW] for x in arrays))
    ps = tabular_init(cfg.qlearning, A, device="cpu")._replace(
        q_table=torch.from_numpy(jax_single["q"].copy()), epsilon=torch.tensor(0.5)
    )
    phys = tcom.init_physical(cfg, jax_init_normals(jax.random.PRNGKey(1), A), device="cpu")
    draws = jax_single_draws(jax_single["key"], WINDOW.stop - WINDOW.start, A, "tabular")
    out = tcom.run_episode(
        cfg, t_make_policy(cfg), ps, phys, arrays, jax_single["ratings"], training=True,
        draws=draws, collect_device_metrics=True, fused=fused,
    )
    assert len(out) == 4 and all(x.shape == () for x in out[3])
    assert [x.dtype for x in out[3]] == [torch.int32] * 3 + [torch.float32] * 2
    np.testing.assert_array_equal(out[2].decisions.numpy(), np.asarray(jax_single["outputs"].decisions))
    got = dc_to_dict(out[3])
    assert_counters_match(got, jax_single["counters"])
    assert got["trade_wh"] > 0 and got["comfort_violations"] > 0


# --- the shared episode and the chunked runner ----------------------------------


K = 2


@pytest.fixture(scope="module")
def jax_chunks():
    """The JAX package's counters: each chunk's shared episode (tabular),
    and a K=2 chunked episode (DDPG, whose rings fill), with each chunk's
    draws."""
    out = {}
    for impl in ("tabular", "ddpg"):
        cfg = chunk_cfg(jcfg, impl)
        ratings = jcom.make_ratings(cfg, np.random.default_rng(0))
        policy = j_make_policy(cfg)
        pol0 = jax.jit(lambda k: jsc.init_shared_pol_state(cfg, k))(jax.random.PRNGKey(0))
        keys = jsc.chunk_key_schedule(jax.random.PRNGKey(1), 0, 1, K)[0]
        arrays_fn = lambda k: j_device_episode_arrays(cfg, k, ratings, cfg.sim.n_scenarios)
        episode_fn = jsc.make_shared_episode_fn(
            cfg, policy, None, ratings, arrays_fn=arrays_fn, n_scenarios=cfg.sim.n_scenarios,
            collect_device_metrics=True,
        )
        from p2pmicrogrid_tpu.telemetry import dc_to_dict as j_dc_to_dict

        chunk = jax.jit(lambda k: _jax_chunk_arrays(cfg, k))
        run = dict(ratings=ratings, pol0=jax.tree.map(np.asarray, pol0),
                   draws=[_chunk_draws(impl, chunk(kc)) for kc in keys])
        if impl == "tabular":
            run["counters"] = []
            for kc in keys:
                _, k_ep = jax.random.split(kc)
                _, ys = episode_fn((pol0, None), k_ep)
                run["counters"].append(j_dc_to_dict(ys[2]))
        else:
            runner = jsc.make_chunked_episode_runner(cfg, episode_fn, K, collect_device_metrics=True)
            _, _, _, dc, fills = runner(pol0, keys)
            run["counters"], run["fills"] = j_dc_to_dict(dc), np.asarray(fills)
        out[impl] = run
    return out


def _port_chunk(run, impl):
    cfg = chunk_cfg(tcfg, impl)
    sub = cfg.ddpg if impl == "ddpg" else None
    policy = t_make_policy(cfg)
    episode_fn = tsc.make_device_episode_fn(cfg, policy, run["ratings"], device="cpu", collect_device_metrics=True)
    return cfg, state_from_jax(run["pol0"], device="cpu", cfg=sub), episode_fn


def test_shared_episode_counters_match_jax(jax_chunks):
    run = jax_chunks["tabular"]
    cfg, pol0, episode_fn = _port_chunk(run, "tabular")
    firsts = []
    for cd, ref in zip(run["draws"], run["counters"]):
        # Each from the episode's starting table (the learner updates in place).
        pol0 = state_from_jax(run["pol0"], device="cpu")
        (_, _), ys = episode_fn((pol0, None), draws=cd.episode)
        assert len(ys) == 3
        assert_counters_match(dc_to_dict(ys[2]), ref)
        firsts.append(ys[2])
    # Each slot overwrites its row of the episode function's one tally (what
    # a CUDA graph of the episode needs), so the second episode matched with
    # no zeroing between; the first episode's counters are its own tensors.
    assert firsts[0] is not firsts[1]
    assert_counters_match(dc_to_dict(firsts[0]), run["counters"][0])


@pytest.mark.parametrize("impl", ["tabular", "ddpg"])
def test_chunked_counters_and_fill_match_jax(jax_chunks, impl):
    """The runner's counters are the sum of its chunks' (tabular: the JAX
    shared episodes' sum; DDPG: the JAX runner's), its fills each chunk's
    ring at the end of the chunk."""
    run = jax_chunks[impl]
    cfg, pol0, episode_fn = _port_chunk(run, impl)
    runner = tsc.make_chunked_episode_runner(cfg, episode_fn, K, collect_device_metrics=True)
    out = runner(pol0, draws=run["draws"])
    assert len(out) == 5 and out[4].shape == (K,)
    if impl == "tabular":
        ref = {k: sum(c[k] for c in run["counters"]) for k in run["counters"][0]}
        assert_counters_match(dc_to_dict(out[3]), ref)
        assert (out[4] == 0).all()
        return
    assert_counters_match(dc_to_dict(out[3]), run["counters"], rtol=2e-4)
    np.testing.assert_array_equal(out[4].numpy(), run["fills"])
    assert float(out[4][0]) == 1.0
    ring = tsc.lockstep_replay_init(2, 3, 8, 4, 1, device="cpu")._replace(count=6)
    assert replay_fill_fraction(ring) == 0.75 and replay_fill_fraction(None) is None
    with pytest.raises(ValueError, match="collect_device_metrics"):
        plain = tsc.make_device_episode_fn(cfg, t_make_policy(cfg), run["ratings"], device="cpu")
        tsc.make_chunked_episode_runner(cfg, plain, K, collect_device_metrics=True)(
            pol0, draws=run["draws"]
        )


# --- the registry --------------------------------------------------------------


def _drive(tel_cls, sink_cls):
    sink = sink_cls()
    tel = tel_cls(run_id="r", sinks=[sink], manifest={"config_hash": "x"})
    tel.event("progress", episode=3, avg_reward=-1.5, avg_error=0.25)
    tel.counter("train.episodes", 2)
    tel.counter("train.episodes")
    tel.gauge("replay.fill_fraction", 0.5)
    for v in (1.0, 3.0, 2.0):
        tel.histogram("train.dispatch_gap_ms", v)
    with tel.span("train_block", episode0=0, episodes=2):
        with tel.span("pipeline_dispatch", episode=0):
            pass
    tel.record_device_counters({"nonfinite_q": 1, "nonfinite_loss": 0, "comfort_violations": 7,
                                "market_residual_wh": 2.5, "trade_wh": 0.5})
    summary = tel.summary()
    tel.close()
    return sink.records, summary


def test_telemetry_records_match_jax():
    got, got_summary = _drive(Telemetry, MemorySink)
    ref, ref_summary = _drive(JTelemetry, JMemorySink)
    assert [r["kind"] for r in got] == [r["kind"] for r in ref] == ["progress", "summary"]
    for g, r in zip(got, ref):
        assert sorted(g) == sorted(r)
    strip = lambda s: json.loads(json.dumps({k: v for k, v in s.items() if k != "spans"}))
    assert strip(got_summary) == strip(ref_summary)
    assert {k: v["count"] for k, v in got_summary["spans"].items()} == {
        k: v["count"] for k, v in ref_summary["spans"].items()
    }
    for mod, fn in ((tcfg, config_hash), (jcfg, j_config_hash)):
        assert fn(mod.default_config(sim=mod.SimConfig(n_agents=5))) == j_config_hash(
            jcfg.default_config(sim=jcfg.SimConfig(n_agents=5))
        )


def test_telemetry_run_dir(tmp_path, monkeypatch):
    """``maybe_create`` writes the manifest (device facts from torch, no
    device started), and ``close`` the summary and the Chrome trace;
    ``P2P_TELEMETRY=0`` turns it off."""
    monkeypatch.setenv("P2P_TELEMETRY_DIR", str(tmp_path))
    monkeypatch.delenv("P2P_TELEMETRY", raising=False)
    tel = Telemetry.maybe_create("t", cfg=tcfg.default_config())
    with tel.span("eval"):
        tel.event("health", episode=0)
    tel.close()
    manifest = json.load(open(f"{tel.run_dir}/manifest.json"))
    assert manifest["backend"] == "cpu" and manifest["torch"] == torch.__version__
    assert manifest["config_hash"] == config_hash(tcfg.default_config())
    trace = json.load(open(f"{tel.run_dir}/trace.json"))
    assert [e["name"] for e in trace["traceEvents"]] == ["eval"]
    lines = [json.loads(l) for l in open(f"{tel.run_dir}/metrics.jsonl")]
    assert [l["kind"] for l in lines] == ["health", "summary"]
    monkeypatch.setenv("P2P_TELEMETRY", "0")
    assert Telemetry.maybe_create("t") is None


def test_slot_tally_matches_dc_from_slot():
    """A ``SlotTally`` totals to the sum of each slot's ``dc_from_slot``,
    non-finite values (NaN, +inf, -inf) and the loss override included."""
    from types import SimpleNamespace

    cfg = _single_cfg(tcfg)
    rng = np.random.default_rng(0)
    T, S, A = 5, 3, 4
    tally, ref = SlotTally(T), dc_zero("cpu")
    for t in range(T):
        q = rng.standard_normal((S, A)).astype(np.float32)
        loss = rng.standard_normal((S,)).astype(np.float32)
        q.flat[rng.choice(q.size, t, replace=False)] = [np.nan, np.inf, -np.inf, np.nan][:t]
        loss[: t % 3] = np.inf
        outputs = SimpleNamespace(
            q=torch.from_numpy(q), loss=torch.zeros(S),
            t_in=torch.from_numpy(rng.uniform(17.0, 25.0, (S, A)).astype(np.float32)),
            p_grid=torch.from_numpy(rng.normal(0.0, 900.0, (S, A)).astype(np.float32)),
            p_p2p=torch.from_numpy(rng.normal(0.0, 400.0, (S, A)).astype(np.float32)),
        )
        dc_tally_slot_(tally, t, cfg, outputs, loss=torch.from_numpy(loss))
        ref = dc_add(ref, dc_from_slot(cfg, outputs, loss=torch.from_numpy(loss)))
    got, want = dc_to_dict(dc_from_tally(cfg, tally)), dc_to_dict(ref)
    assert want["nonfinite_q"] == 10 and want["nonfinite_loss"] == 4 and want["comfort_violations"] > 0
    assert_counters_match(got, want, rtol=1e-6)


# --- the async drain -------------------------------------------------------------


def test_async_drain_fifo():
    """Consumption in push order; depth 2 holds one item back; host values
    copied at push (a later in-place change does not reach them)."""
    seen = []
    drain = AsyncDrain(depth=2)
    x = torch.zeros(3)
    for i in range(3):
        x.fill_(i)
        drain.push(i, (x, float(i)), lambda tag, host: seen.append((tag, host[0].tolist(), host[1])))
        assert [t for t, _, _ in seen] == list(range(i))
    drain.flush()
    assert seen == [(i, [float(i)] * 3, float(i)) for i in range(3)]
    sync = AsyncDrain(depth=1)
    sync.push("a", (), lambda tag, host: seen.append(tag))
    assert seen[-1] == "a"
    with pytest.raises(ValueError, match="depth"):
        AsyncDrain(depth=0)


def test_chunked_pipeline_depths_agree():
    """The chunked trainer through depth 2 and depth 1: the same rewards,
    the same callbacks in the same order, the same final state."""
    cfg = chunk_cfg(tcfg, "tabular")
    ratings = tcom.make_ratings(cfg, np.random.default_rng(0))
    runs = []
    for pipeline in (True, False):
        seen = []
        sink = MemorySink()
        tel = Telemetry(run_id="p", sinks=[sink])
        pol0 = tsc.init_shared_pol_state(cfg, "cpu", torch.Generator().manual_seed(0))
        pol, rewards, losses, _ = tsc.train_scenarios_chunked(
            cfg, t_make_policy(cfg), pol0, ratings, 3, 3, 1, telemetry=tel, pipeline=pipeline,
            episode_cb=lambda ep, r, l, c: seen.append((ep, r.copy())), carry_sync=lambda ep: False,
            device="cpu",
        )
        counters = [r for r in sink.records if r["kind"] == "device_counters"]
        runs.append((state_to_numpy(pol), rewards, losses, seen, counters, tel.summary()["gauges"]))
    (p2, r2, l2, s2, c2, g2), (p1, r1, l1, s1, c1, g1) = runs
    np.testing.assert_array_equal(r2, r1)
    np.testing.assert_array_equal(l2, l1)
    np.testing.assert_array_equal(p2.q_table, p1.q_table)
    assert [e for e, _ in s2] == [e for e, _ in s1] == [0, 1, 2]
    for (_, a), (_, b) in zip(s2, s1):
        np.testing.assert_array_equal(a, b)
    strip = lambda cs: [{k: v for k, v in c.items() if k != "ts"} for c in cs]
    assert strip(c2) == strip(c1) and len(c1) == 3
    assert g2["train.pipeline_depth"] == 2 and g1["train.pipeline_depth"] == 1
    assert 0 <= g2["train.host_blocked_fraction"] <= 1


def test_train_community_pipeline_depths_agree():
    """``train_community`` through depth 2 (``pipeline=True``) and depth 1:
    the same rewards, progress, checkpoints (each taken after exactly its
    episode) and device counters, and the same final table."""
    cfg = tcfg.default_config(
        sim=tcfg.SimConfig(n_agents=2),
        qlearning=tcfg.QLearningConfig(**BINS),
        train=tcfg.TrainConfig(
            implementation="tabular", max_episodes=5, episodes_per_jit_block=1,
            save_episodes=2, min_episodes_criterion=2,
        ),
    )
    traces = synthetic_traces(n_days=1, seed=0, start_day=11).normalized()
    ratings = tcom.make_ratings(cfg, np.random.default_rng(0))
    runs = []
    for pipeline in (True, False):
        saved = []
        tel = Telemetry(run_id="c", sinks=[MemorySink()])
        pol = init_policy_state(cfg, "cpu", torch.Generator().manual_seed(0))
        res = train_community(
            cfg, t_make_policy(cfg), pol, traces, ratings, torch.Generator().manual_seed(2),
            checkpoint_cb=lambda ep, ps: saved.append((ep, ps.q_table.clone())),
            telemetry=tel, pipeline=pipeline, device="cpu",
        )
        counts = {k: v for k, v in tel.summary()["counters"].items() if k.startswith("device.")}
        runs.append((res, saved, counts, tel.summary()["gauges"]["train.pipeline_depth"]))
    (r2, s2, c2, d2), (r1, s1, c1, d1) = runs
    assert (d2, d1) == (2, 1)
    assert r2.episode_rewards == r1.episode_rewards and r2.episode_losses == r1.episode_losses
    assert r2.progress == r1.progress and len(r1.progress) == 3
    assert [e for e, _ in s2] == [e for e, _ in s1] == [1, 3]
    for (_, a), (_, b) in zip(s2, s1):
        assert torch.equal(a, b)
    assert not torch.equal(s1[0][1], s1[1][1])
    assert c2 == c1 and set(c1) == {f"device.{k}" for k in DeviceCounters._fields}
    assert torch.equal(r2.pol_state.q_table, r1.pol_state.q_table)


@pytest.mark.parametrize("trainer", ["shared", "independent", "multi_community"])
def test_scenario_trainers_take_telemetry(trainer):
    """``telemetry=`` of the shared, independent and multi-community
    trainers: the readback's spans and gauges land in it, and the results
    equal the run without it."""
    from p2pmicrogrid_tpu_torch.envs import multi_community as tmc

    cfg = tcfg.default_config(
        sim=tcfg.SimConfig(n_agents=3, n_scenarios=2),
        qlearning=tcfg.QLearningConfig(**BINS),
        train=tcfg.TrainConfig(implementation="tabular"),
    )
    ratings = tcom.make_ratings(cfg, np.random.default_rng(0))
    arrays = tsc.stack_scenario_arrays(cfg, tsc.make_scenario_traces(cfg), ratings, "cpu")
    arrays = type(arrays)(*(x[:, 40:44] for x in arrays))
    policy = t_make_policy(cfg)
    runs = []
    for tel in (Telemetry(run_id="t", sinks=[MemorySink()]), None):
        gen = torch.Generator().manual_seed(1)
        if trainer == "independent":
            state = tsc.init_independent_state(cfg, 2, "cpu")
            out = tsc.train_scenarios_independent(cfg, policy, state, arrays, ratings, gen, 2, telemetry=tel)
        else:
            train = tsc.train_scenarios_shared if trainer == "shared" else tmc.train_multi_community
            out = train(cfg, policy, tsc.init_shared_pol_state(cfg, "cpu"), arrays, ratings, gen, 2, telemetry=tel)
        runs.append((out[-3], tel))
    (r_tel, tel), (r_plain, _) = runs
    np.testing.assert_array_equal(r_tel, r_plain)
    summary = tel.summary()
    assert summary["gauges"]["train.pipeline_depth"] == 2
    assert summary["spans"]["pipeline_dispatch"]["count"] == 2
    assert summary["spans"]["pipeline_drain"]["count"] == 2
