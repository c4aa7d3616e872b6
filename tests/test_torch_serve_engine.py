"""The port's serving engine and its fronts on the CPU (torch only).

``PolicyEngine`` serves what the training greedy paths compute (tabular,
DQN and DDPG, from the port's own functions), pads to power-of-two buckets
and splits above ``max_batch``, carries sessions through ``step``;
``MicroBatchQueue`` coalesces and a cancelled future does not starve its
batchmates; ``ContinuousBatcher`` answers what the microbatch queue answers,
bit for bit, with its slots, generations, scratch overflow and
``end_session``; recurrent bundles are refused, naming ROADMAP item 9.
"""


import numpy as np
import pytest
import torch

from p2pmicrogrid_tpu_torch import config as tc
from p2pmicrogrid_tpu_torch.models.ddpg import ddpg_shared_act
from p2pmicrogrid_tpu_torch.models.dqn import ACTION_VALUES, dqn_act
from p2pmicrogrid_tpu_torch.models.tabular import tabular_act
from p2pmicrogrid_tpu_torch.serve import (
    ContinuousBatcher,
    MicroBatchQueue,
    PolicyEngine,
    calibration_obs,
    export_policy_bundle,
)
from p2pmicrogrid_tpu_torch.telemetry import Telemetry
from p2pmicrogrid_tpu_torch.train.policies import init_policy_state

A = 3
WAIT = 30.0  # every future wait is bounded


def _cfg(impl):
    return tc.default_config(
        sim=tc.SimConfig(n_agents=A),
        train=tc.TrainConfig(implementation=impl),
        dqn=tc.DQNConfig(hidden=8, buffer_size=16, batch_size=2),
        ddpg=tc.DDPGConfig(actor_hidden=8, critic_hidden=8, buffer_size=16, batch_size=2),
    )


def _state(cfg, seed=0):
    gen = torch.Generator().manual_seed(seed)
    ps = init_policy_state(cfg, "cpu", gen)
    if cfg.train.implementation == "tabular":
        ps = ps._replace(q_table=torch.randn(ps.q_table.shape, generator=gen))
    return ps


def _bundle(tmp_path, impl, name=None, dtype="float32"):
    cfg = _cfg(impl)
    ps = _state(cfg)
    path = export_policy_bundle(cfg, ps, str(tmp_path / (name or impl)), dtype=dtype, device="cpu")
    return cfg, ps, path


def _training_greedy(cfg, ps, obs):
    """The training-side greedy actions (explore=False) of the port."""
    obs_t = torch.from_numpy(obs)
    impl = cfg.train.implementation
    values = torch.tensor(ACTION_VALUES)
    if impl == "tabular":
        action, _ = tabular_act(cfg.qlearning, ps, obs_t, None, None, explore=False)
        return values[action].numpy()
    if impl == "dqn":
        action, _ = dqn_act(cfg.dqn, ps, obs_t, None, None, explore=False)
        return values[action].numpy()
    with torch.no_grad():
        a, _, _ = ddpg_shared_act(cfg.ddpg, ps, obs_t, torch.zeros(obs.shape[:2]), None,
                                  explore=False)
    return a.numpy()


@pytest.mark.parametrize("impl", ["tabular", "dqn", "ddpg"])
def test_act_is_the_training_greedy_path(impl, tmp_path):
    """Two buckets (3 -> 4, 8) and a split above max_batch (11 rows -> 8 +
    3): discrete actions equal the training path's, DDPG within 1e-6."""
    cfg, ps, path = _bundle(tmp_path, impl)
    engine = PolicyEngine(bundle_dir=path, max_batch=8, device="cpu")
    obs = calibration_obs(11, A, seed=1)
    want = _training_greedy(cfg, ps, obs)
    for rows in (3, 8, 11):
        got = engine.act(obs[:rows])
        assert got.dtype == np.float32 and got.shape == (rows, A)
        if impl == "ddpg":
            np.testing.assert_allclose(got, want[:rows], rtol=1e-6)
        else:
            np.testing.assert_array_equal(got, want[:rows])
    assert engine.stats["batches"] == 4  # 3 -> 4, 8, and 11 = 8 + 3 -> 8 + 4
    assert engine.stats["rows"] == 22
    assert engine.stats["padded_rows"] == 1 + 0 + 1
    assert engine.padding_waste == pytest.approx(2 / 24)


def test_buckets_and_warmup(tmp_path):
    _, _, path = _bundle(tmp_path, "tabular")
    engine = PolicyEngine(bundle_dir=path, max_batch=8, device="cpu")
    assert engine.buckets == [1, 2, 4, 8]
    assert [engine.bucket_for(n) for n in (1, 2, 3, 5, 8, 9)] == [1, 2, 4, 8, 8, 8]
    assert engine.warmup() == [1, 2, 4, 8]
    assert engine.stats["aot_compiles"] == 0 and engine.stats["aot_hits"] == 0  # nothing captured on the CPU
    assert engine.capture_s == {}
    with pytest.raises(ValueError, match=">= 1"):
        engine.bucket_for(0)
    assert engine.act(np.zeros((0, A, 4), np.float32)).shape == (0, A)


def test_refusals(tmp_path):
    _, _, path = _bundle(tmp_path, "tabular")
    with pytest.raises(ValueError, match="power of two"):
        PolicyEngine(bundle_dir=path, max_batch=6, device="cpu")
    with pytest.raises(ValueError, match="auto"):
        PolicyEngine(bundle_dir=path, device="auto")
    with pytest.raises(ValueError, match="manifest and params"):
        PolicyEngine(device="cpu")
    engine = PolicyEngine(bundle_dir=path, max_batch=4, device="cpu")
    with pytest.raises(ValueError, match=r"\[B, 3, 4\]"):
        engine.act(np.zeros((2, A + 1, 4), np.float32))


def test_float16_bundle_serves_in_float32(tmp_path):
    cfg, ps, path = _bundle(tmp_path, "ddpg", dtype="float16")
    engine = PolicyEngine(bundle_dir=path, max_batch=4, device="cpu")
    obs = calibration_obs(4, A, seed=2)
    assert engine.act(obs).dtype == np.float32
    # Quantized parameters, float32 arithmetic: the same policy to f16
    # tolerance.
    np.testing.assert_allclose(engine.act(obs), _training_greedy(cfg, ps, obs), atol=2e-3)


def test_step_is_repeated_act_with_carried_sessions(tmp_path):
    _, _, path = _bundle(tmp_path, "dqn")
    engine = PolicyEngine(bundle_dir=path, max_batch=4, device="cpu")
    sessions = engine.init_sessions(3)
    assert sessions.hp_frac.shape == (3, A) and sessions.slots.dtype == torch.int32
    for seed in (1, 2, 3):
        obs = calibration_obs(3, A, seed=seed)
        sessions, hp = engine.step(sessions, obs)
        np.testing.assert_array_equal(hp, engine.act(obs))
        np.testing.assert_array_equal(sessions.hp_frac.numpy(), hp)
    assert sessions.slots.tolist() == [3, 3, 3]
    with pytest.raises(ValueError, match="sessions"):
        engine.step(sessions, calibration_obs(2, A))
    with pytest.raises(ValueError, match="exceeds max_batch"):
        engine.step(engine.init_sessions(5), calibration_obs(5, A))


def test_serve_counters_reach_telemetry(tmp_path):
    _, _, path = _bundle(tmp_path, "tabular")
    tel = Telemetry(run_id="t")
    engine = PolicyEngine(bundle_dir=path, max_batch=4, telemetry=tel, device="cpu")
    engine.act(calibration_obs(3, A))
    s = tel.summary()
    assert s["counters"]["serve.requests"] == 3
    assert s["counters"]["serve.batches"] == 1
    assert s["counters"]["serve.padded_rows"] == 1
    assert s["histograms"]["serve.batch_ms"]["count"] == 1


def test_microbatch_queue_coalesces(tmp_path):
    _, _, path = _bundle(tmp_path, "tabular")
    tel = Telemetry(run_id="q")
    engine = PolicyEngine(bundle_dir=path, max_batch=8, telemetry=tel, device="cpu")
    obs = calibration_obs(6, A, seed=9)
    want = engine.act(obs)
    with MicroBatchQueue(engine, max_wait_s=0.5) as q:
        futs = [q.submit(obs[i]) for i in range(6)]
        got = np.stack([f.result(timeout=WAIT) for f in futs])
    np.testing.assert_array_equal(got, want)
    # The six rows waited out one window together: one padded batch of 8.
    assert engine.stats["batches"] == 2 and engine.stats["padded_rows"] == 2 + 2
    assert len(q.recent_wait_ms) == 6
    assert tel.summary()["histograms"]["serve.queue_wait_ms"]["count"] == 6


def test_cancelled_future_does_not_starve_batchmates(tmp_path):
    _, _, path = _bundle(tmp_path, "tabular")
    engine = PolicyEngine(bundle_dir=path, max_batch=4, device="cpu")
    obs = calibration_obs(3, A, seed=2)
    want = engine.act(obs)
    with MicroBatchQueue(engine, max_wait_s=0.2) as q:
        futs = [q.submit(obs[i]) for i in range(3)]
        assert futs[1].cancel()  # abandoned while still queued
        np.testing.assert_array_equal(futs[0].result(timeout=WAIT), want[0])
        np.testing.assert_array_equal(futs[2].result(timeout=WAIT), want[2])
        assert futs[1].cancelled()
    with pytest.raises(RuntimeError, match="queue is closed"):
        q.submit(obs[0])


def test_continuous_bit_exact_vs_microbatch(tmp_path):
    """Manual stepping over two buckets (5 rows -> 8, then 2 -> 2): every
    answer equals the microbatch queue's for the same rows."""
    _, _, path = _bundle(tmp_path, "dqn")
    engine = PolicyEngine(bundle_dir=path, max_batch=8, device="cpu")
    obs = calibration_obs(7, A, seed=4)
    with MicroBatchQueue(engine, max_wait_s=0.01) as q:
        micro = np.stack([q.submit(o).result(timeout=WAIT) for o in obs])
    cb = ContinuousBatcher(engine, autostart=False, max_slots=4)
    futs = [cb.submit(obs[i], household=f"h{i % 3}") for i in range(5)]
    assert cb.depth == 5 and cb.step_once() == 5
    futs += [cb.submit(obs[i], household=f"h{i}") for i in (5, 6)]
    assert cb.step_once() == 2 and cb.step_once() == 0
    got = np.stack([f.result(timeout=WAIT) for f in futs])
    np.testing.assert_array_equal(got, micro)
    cb.close()


def test_continuous_slots_generations_and_overflow(tmp_path):
    _, _, path = _bundle(tmp_path, "tabular")
    tel = Telemetry(run_id="c")
    engine = PolicyEngine(bundle_dir=path, max_batch=4, telemetry=tel, device="cpu")
    obs = calibration_obs(4, A, seed=3)
    cb = ContinuousBatcher(engine, autostart=False, max_slots=2)
    # Three households, two slots, all queued: the third overflows to the
    # scratch row (nothing idle to evict) and still gets its answer.
    futs = [cb.submit(obs[i], household=f"h{i}") for i in range(3)]
    assert cb.step_once() == 3
    np.testing.assert_array_equal(np.stack([f.result(timeout=WAIT) for f in futs]),
                                  engine.act(obs[:3]))
    assert cb.stats["scratch_rows"] == 1 and cb.occupancy == 2
    info = cb.session_info("h0")
    assert info["served"] == 1 and info["gen"] == 0
    np.testing.assert_array_equal(info["hp_frac"], futs[0].result())
    assert cb.session_info("h2") is None
    # end_session retires the slot under a new generation.
    assert cb.end_session("h0") and not cb.end_session("h0")
    assert cb.stats["retired"] == 1 and cb.occupancy == 1
    # h2 now takes the freed slot under its new generation; a later
    # newcomer evicts the least recently used idle household (h1).
    cb.submit(obs[3], household="h2")
    cb.step_once()
    assert cb.session_info("h2")["gen"] == 1
    cb.submit(obs[3], household="h3")
    cb.step_once()
    assert cb.session_info("h1") is None and cb.stats["evictions"] == 1
    cb.submit(obs[0], household="h1")
    cb.step_once()
    assert cb.stats["spill_rejoins"] == 1
    # A cancelled request is pruned, never stepped.
    fut = cb.submit(obs[0], household="h9")
    fut.cancel()
    assert cb.step_once() == 0 and cb.stats["cancelled_drops"] == 1
    hists = tel.summary()["histograms"]
    assert hists["serve.batch_occupancy"]["count"] == cb.stats["steps"] == 4
    assert hists["serve.batch_occupancy"]["min"] == 0.75  # 3 rows in bucket 4
    assert hists["serve.slot_wait_ms"]["count"] == 6
    cb.close()


def test_continuous_worker_thread_serves(tmp_path):
    _, _, path = _bundle(tmp_path, "tabular")
    engine = PolicyEngine(bundle_dir=path, max_batch=4, device="cpu")
    obs = calibration_obs(9, A, seed=8)
    with ContinuousBatcher(engine, max_slots=4) as cb:
        assert cb.warmup() == [1, 2, 4]
        futs = [cb.submit(o, household=f"h{i % 5}") for i, o in enumerate(obs)]
        got = np.stack([f.result(timeout=WAIT) for f in futs])
    np.testing.assert_array_equal(got, engine.act(obs))
