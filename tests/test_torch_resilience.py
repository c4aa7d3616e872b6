"""The port's checkpoints, fault injection and rollback against the JAX
package on the CPU, and its exact resume.

* A learner state converted with ``convert.state_from_jax`` and saved by the
  port has the manifest digest and leaf spec that the JAX package's
  ``tree_digest`` gives the same state (tabular, per-agent DQN, shared
  DDPG).
* The checkpoint contracts of ``tests/test_resilience.py:194-291``: the
  corrupt newest step falls back to a verified one, malformed names are
  skipped, a failed read-back leaves the older steps, the prune keeps a
  fallback and removes stale higher steps, a digest skew is caught; and a
  restore writes into the state's own tensors.
* Kill and resume, bit for bit against the uninterrupted run:
  ``train_community`` (tabular, A=2) and ``train_scenarios_chunked``
  (shared DDPG, A=4, S=2, K=2).
* ``train_community_with_rollback`` on an injected NaN: the JAX package's
  ``RollbackRecord``s; fault plans' JSON and ``kill_plan`` equal to the JAX
  package's; ``supervise``'s restarts.
* The seed-0 draws' digests, pinned (``draw_digests.py``).
"""

import dataclasses
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from p2pmicrogrid_tpu import config as jcfg
from p2pmicrogrid_tpu.data import synthetic_traces as j_synthetic_traces
from p2pmicrogrid_tpu.envs import make_ratings as j_make_ratings
from p2pmicrogrid_tpu.parallel import scenarios as jsc
from p2pmicrogrid_tpu.train import init_policy_state as j_init_policy_state
from p2pmicrogrid_tpu.train import checkpoint as jck
from p2pmicrogrid_tpu.train import faults as jfaults
from p2pmicrogrid_tpu.train import resilience as jres
from p2pmicrogrid_tpu_torch import config as tcfg
from p2pmicrogrid_tpu_torch.convert import state_from_jax, state_to_numpy
from p2pmicrogrid_tpu_torch.data.traces import synthetic_traces
from p2pmicrogrid_tpu_torch.draw_digests import PINNED, seed0_digests
from p2pmicrogrid_tpu_torch.envs.community import make_ratings
from p2pmicrogrid_tpu_torch.parallel import scenarios as tsc
from p2pmicrogrid_tpu_torch.telemetry import MemorySink, Telemetry
from p2pmicrogrid_tpu_torch.train import checkpoint as tck
from p2pmicrogrid_tpu_torch.train import faults as tfaults
from p2pmicrogrid_tpu_torch.train import resilience as tres
from p2pmicrogrid_tpu_torch.train.loop import train_community
from p2pmicrogrid_tpu_torch.train.policies import init_policy_state, make_policy

BINS = dict(num_time_states=8, num_temp_states=8, num_balance_states=8, num_p2p_states=8)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(mod, impl="tabular", **train):
    train = {"max_episodes": 4, "episodes_per_jit_block": 2, "save_episodes": 1,
             "min_episodes_criterion": 2, **train}
    return mod.default_config(
        sim=mod.SimConfig(n_agents=2),
        qlearning=mod.QLearningConfig(**BINS),
        train=mod.TrainConfig(implementation=impl, **train),
        dqn=mod.DQNConfig(buffer_size=32, warmup_passes=1),
        ddpg=mod.DDPGConfig(buffer_size=32, batch_size=4, share_across_agents=True),
    )


def _traces():
    return synthetic_traces(n_days=1, seed=0, start_day=11).normalized()


def _tabular(seed):
    cfg = _cfg(tcfg)
    return init_policy_state(cfg, "cpu", torch.Generator().manual_seed(seed))


def _assert_states_equal(a, b):
    fa, fb = dict(tck._walk_leaves(tck._plain(state_to_numpy(a)))), dict(
        tck._walk_leaves(tck._plain(state_to_numpy(b)))
    )
    assert fa.keys() == fb.keys()
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


# --- the manifest's digest against the JAX package's ------------------------


@pytest.mark.parametrize("impl", ["tabular", "dqn", "ddpg"])
def test_manifest_digest_matches_jax(tmp_path, impl):
    cfg_j, cfg_t = _cfg(jcfg, impl), _cfg(tcfg, impl)
    key = jax.random.PRNGKey(3)
    if impl == "ddpg":
        state_j = jax.jit(lambda k: jsc.init_shared_pol_state(cfg_j, k))(key)
    else:
        state_j = j_init_policy_state(cfg_j, key)
    np_tree = jax.tree.map(np.asarray, state_j)
    sub = {"dqn": cfg_t.dqn, "ddpg": cfg_t.ddpg}.get(impl)
    state_t = state_from_jax(np_tree, "cpu", cfg=sub)
    step = tck.save_checkpoint(str(tmp_path), state_t, 3, cfg=cfg_t)
    manifest = tck.verify_checkpoint(step)
    digest, spec = jck.tree_digest({"pol_state": np_tree, "episode": 3})
    assert manifest["digest"] == digest
    assert manifest["tree"] == spec
    from p2pmicrogrid_tpu.telemetry import config_hash as j_config_hash

    assert manifest["config_hash"] == j_config_hash(cfg_j)


# --- the checkpoint contracts ---------------------------------------------------


def test_corrupt_newest_falls_back_to_verified(tmp_path):
    path = str(tmp_path / "ckpt")
    ps3, ps5 = _tabular(3), _tabular(5)
    gen = torch.Generator().manual_seed(3)
    tck.save_checkpoint(path, ps3, episode=3, rng_key=gen.get_state())
    step5 = tck.save_checkpoint(path, ps5, episode=5)
    assert tck.latest_checkpoint(path).endswith("ep_5")
    assert tfaults.corrupt_step_files(step5).endswith(tck.PAYLOAD_NAME)
    with pytest.warns(UserWarning, match="corrupt"):
        assert tck.latest_checkpoint(path).endswith("ep_3")
    assert tck.latest_checkpoint(path, verify=False).endswith("ep_5")
    live = _tabular(99)
    table = live.q_table
    with pytest.warns(UserWarning, match="corrupt"):
        st = tck.restore_resume_state(path, live)
    assert st.episode == 3 and st.pol_state.q_table is table
    _assert_states_equal(st.pol_state, ps3)
    np.testing.assert_array_equal(st.rng_key, gen.get_state().numpy())


def test_all_steps_corrupt_raises(tmp_path):
    path = str(tmp_path / "ckpt")
    step = tck.save_checkpoint(path, _tabular(0), episode=1)
    tfaults.corrupt_step_files(step)
    with pytest.warns(UserWarning, match="corrupt"):
        with pytest.raises(tck.CheckpointCorrupt):
            tck.restore_checkpoint(path, _tabular(1))
    with pytest.raises(FileNotFoundError):
        tck.restore_checkpoint(str(tmp_path / "none"), _tabular(1))


def test_malformed_step_dir_skipped_with_warning(tmp_path):
    path = str(tmp_path / "ckpt")
    tck.save_checkpoint(path, _tabular(0), episode=2)
    os.makedirs(os.path.join(path, "ep_banana"))
    os.makedirs(os.path.join(path, "ep_7"))  # no manifest: incomplete
    with pytest.warns(UserWarning, match="malformed"):
        assert tck.latest_checkpoint(path).endswith("ep_2")


def test_prune_waits_for_readback_verification(tmp_path, monkeypatch):
    path = str(tmp_path / "ckpt")
    ps = _tabular(0)
    tck.save_checkpoint(path, ps, episode=1)

    def broken(tmp_path_, digest_):
        raise tck.CheckpointCorrupt("simulated torn write")

    monkeypatch.setattr(tck, "_verify_readback", broken)
    with pytest.raises(tck.CheckpointCorrupt, match="torn write"):
        tck.save_checkpoint(path, ps, episode=3)
    monkeypatch.undo()
    assert tck.latest_checkpoint(path).endswith("ep_1")
    assert tck.restore_checkpoint(path, ps)[1] == 1
    tck.save_checkpoint(path, ps, episode=3)
    assert not [d for d in os.listdir(path) if d.startswith("_tmp_ep_")]
    assert tck.latest_checkpoint(path).endswith("ep_3")


def test_prune_keeps_fallback_and_removes_stale_higher(tmp_path):
    path = str(tmp_path / "ckpt")
    ps = _tabular(0)
    for ep in (1, 3, 5):
        tck.save_checkpoint(path, ps, episode=ep)
    assert sorted(d for d in os.listdir(path) if d.startswith("ep_")) == ["ep_3", "ep_5"]
    tck.save_checkpoint(path, ps, episode=2)
    assert sorted(d for d in os.listdir(path) if d.startswith("ep_")) == ["ep_2"]


def test_verify_checkpoint_detects_manifest_payload_skew(tmp_path):
    step = tck.save_checkpoint(str(tmp_path / "ckpt"), _tabular(0), episode=4)
    assert tck.verify_checkpoint(step)["episode"] == 4
    m = tck.load_manifest(step)
    m["digest"] = "sha256:" + "0" * 64
    with open(os.path.join(step, tck.MANIFEST_NAME), "w") as f:
        json.dump(m, f)
    with pytest.raises(tck.CheckpointCorrupt, match="digest mismatch"):
        tck.verify_checkpoint(step)


def test_restore_writes_into_the_state(tmp_path):
    """A DDPG restore copies into the live parameters and Adam's own
    tensors (step counts included), as a captured graph needs."""
    cfg = _cfg(tcfg, "ddpg")
    a = tsc.init_shared_pol_state(cfg, "cpu", torch.Generator().manual_seed(0))
    b = tsc.init_shared_pol_state(cfg, "cpu", torch.Generator().manual_seed(1))
    for x, is_count in tsc.learner_leaves(a):
        x.add_(3.0 if is_count else 0.5)  # Adam's moments and counts away from their zeros
    tck.save_checkpoint(str(tmp_path), a, 0)
    before = [x.data_ptr() for x, _ in tsc.learner_leaves(b)]
    restored, episode = tck.restore_checkpoint(str(tmp_path), b)
    assert episode == 0 and before == [x.data_ptr() for x, _ in tsc.learner_leaves(restored)]
    for (x, _), (y, _) in zip(tsc.learner_leaves(a), tsc.learner_leaves(restored)):
        assert torch.equal(x, y)


# --- kill and resume ------------------------------------------------------------


def test_train_community_kill_resume_bit_exact(tmp_path):
    cfg = _cfg(tcfg)
    ratings = make_ratings(cfg, np.random.default_rng(0))
    policy = make_policy(cfg)
    full = train_community(
        cfg, policy, _tabular(1), _traces(), ratings, torch.Generator().manual_seed(2), device="cpu"
    )
    ckpt = str(tmp_path / "ckpt")
    plan = tfaults.TrainFaultPlan(seed=0, events=(tfaults.TrainFaultEvent(kind="kill", episode=2),))
    injector = tfaults.TrainFaultInjector(plan, kill_mode="raise")
    with pytest.raises(tfaults.SimulatedPreemption):
        train_community(
            cfg, policy, _tabular(1), _traces(), ratings, torch.Generator().manual_seed(2),
            checkpoint_cb=tres.checkpoint_callback(ckpt, cfg, injector=injector),
            fault_hook=injector.on_block_start, device="cpu",
        )
    assert injector.history == [("kill", 2, 0)]
    resume = tres.prepare_resume(cfg, ckpt, _tabular(7), torch.Generator())
    assert resume.resumed and resume.exact and not resume.warmup and resume.episode == 1
    resumed = train_community(
        resume.cfg, policy, resume.pol_state, _traces(), ratings, resume.key,
        warmup=resume.warmup, device="cpu",
    )
    assert resumed.episode_rewards == full.episode_rewards[2:]
    assert torch.equal(resumed.pol_state.q_table, full.pol_state.q_table)
    fresh = tres.prepare_resume(cfg, str(tmp_path / "none"), _tabular(7), torch.Generator())
    assert not fresh.resumed and fresh.warmup and fresh.cfg.train.starting_episodes == 0


def test_chunked_kill_resume_bit_exact(tmp_path):
    """Two episodes of shared DDPG (A=4, S=2, K=2) in one run, and with a
    kill before episode 1 and a resume from episode 0's checkpoint into a
    fresh state: the same final state, bit for bit."""
    cfg = tcfg.default_config(
        sim=tcfg.SimConfig(n_agents=4, n_scenarios=2),
        battery=tcfg.BatteryConfig(enabled=True),
        train=tcfg.TrainConfig(implementation="ddpg"),
        ddpg=tcfg.DDPGConfig(share_across_agents=True, buffer_size=96, batch_size=4),
    )
    ratings = make_ratings(cfg, np.random.default_rng(42))
    policy = make_policy(cfg)
    fresh = lambda seed: tsc.init_shared_pol_state(cfg, "cpu", torch.Generator().manual_seed(seed))
    full, rewards, _, _ = tsc.train_scenarios_chunked(cfg, policy, fresh(0), ratings, 5, 2, 2, device="cpu")
    ckpt = str(tmp_path / "ckpt")
    plan = tfaults.TrainFaultPlan(seed=0, events=(tfaults.TrainFaultEvent(kind="kill", episode=1),))
    injector = tfaults.TrainFaultInjector(plan, kill_mode="raise")
    save = lambda ep, r, l, state: tck.save_checkpoint(ckpt, state, ep, cfg=cfg)
    pol = fresh(0)
    with pytest.raises(tfaults.SimulatedPreemption):
        for e in range(2):
            injector.on_block_start(e, pol)
            pol, _, _, _ = tsc.train_scenarios_chunked(
                cfg, policy, pol, ratings, 5, 1, 2, episode0=e, episode_cb=save, device="cpu"
            )
    resume = tres.prepare_resume(cfg, ckpt, fresh(9), 5)
    assert resume.resumed and resume.episode == 0
    pol, r1, _, _ = tsc.train_scenarios_chunked(
        cfg, policy, resume.pol_state, ratings, 5, 1, 2, episode0=1, device="cpu"
    )
    np.testing.assert_array_equal(r1[0], rewards[1])
    _assert_states_equal(pol, full)


# --- rollback, fault plans, supervision -------------------------------------------


def test_rollback_records_match_jax(tmp_path):
    """A NaN poisoned into the state at episode 2's block: the guard trips
    on the device counters, the run restores the last verified step and
    finishes at half the learning rate; the records are the JAX package's."""
    plan = dict(seed=0, events=({"kind": "poison_nan", "episode": 2},))
    kw = dict(max_episodes=6)
    cfg_j = _cfg(jcfg, **kw)
    traces_j = j_synthetic_traces(n_days=1, seed=0, start_day=11).normalized()
    injector_j = jfaults.TrainFaultInjector(jfaults.TrainFaultPlan.from_json(json.dumps(
        {"kind": "train_fault_plan", **plan})), kill_mode="raise")
    _, ref = jres.train_community_with_rollback(
        cfg_j, j_init_policy_state(cfg_j, jax.random.PRNGKey(1)), traces_j,
        j_make_ratings(cfg_j, np.random.default_rng(0)), jax.random.PRNGKey(2),
        str(tmp_path / "jax"), guard_policy=jres.GuardPolicy(max_rollbacks=2),
        fault_injector=injector_j,
    )
    cfg_t = _cfg(tcfg, **kw)
    injector = tfaults.TrainFaultInjector(tfaults.TrainFaultPlan.from_json(json.dumps(
        {"kind": "train_fault_plan", **plan})), kill_mode="raise")
    sink = MemorySink()
    tel = Telemetry(run_id="rollback", sinks=[sink])
    result, got = tres.train_community_with_rollback(
        cfg_t, _tabular(1), _traces(), make_ratings(cfg_t, np.random.default_rng(0)),
        torch.Generator().manual_seed(2), str(tmp_path / "port"),
        guard_policy=tres.GuardPolicy(max_rollbacks=2), telemetry=tel, fault_injector=injector,
        device="cpu",
    )
    assert [dataclasses.asdict(r) for r in got] == [dataclasses.asdict(r) for r in ref]
    assert len(got) == 1 and got[0].restored_episode == 1 and got[0].lr_scale == 0.5
    assert torch.isfinite(result.pol_state.q_table).all()
    assert len(result.episode_rewards) == 4  # episodes 2-5, retrained
    assert tel.counters["train.rollback"] == 1
    assert {"divergence", "rollback"} <= {r["kind"] for r in sink.records}


def test_rollback_exhausted_raises(tmp_path):
    class AlwaysPoison:
        def on_block_start(self, ep, pol_state=None):
            return tfaults.poison_pol_state(pol_state) if ep >= 2 else None

        def on_checkpoint_saved(self, ep, step):
            pass

        def on_callback(self, ep):
            pass

    cfg = _cfg(tcfg)
    with pytest.raises(tres.RollbackExhausted):
        tres.train_community_with_rollback(
            cfg, _tabular(1), _traces(), make_ratings(cfg, np.random.default_rng(0)),
            torch.Generator().manual_seed(2), str(tmp_path / "ckpt"),
            guard_policy=tres.GuardPolicy(max_rollbacks=1), fault_injector=AlwaysPoison(),
            device="cpu",
        )


def test_chunked_rollback_restores_and_reenters(tmp_path):
    """A trip at a block-boundary eval (raised from the health callback, the
    path a guard trip takes) restores the newest verified checkpoint into
    the live state, drops the learning rate and re-enters: the chunked
    mirror of ``train_community_with_rollback`` (tests/test_resilience.py:
    680)."""
    cfg = tcfg.default_config(
        sim=tcfg.SimConfig(n_agents=3, n_scenarios=2),
        qlearning=tcfg.QLearningConfig(**BINS),
        train=tcfg.TrainConfig(implementation="tabular", save_episodes=2),
    )
    ratings = make_ratings(cfg, np.random.default_rng(0))
    pol = tsc.init_shared_pol_state(cfg, "cpu", torch.Generator().manual_seed(0))
    table = pol.q_table
    trips = []

    def health_cb(point):
        if point.episode >= 4 and not trips:
            trips.append(point.episode)
            raise tres.DivergenceTripped(point.episode, "injected test trip")

    sink = MemorySink()
    tel = Telemetry(run_id="chunked-rollback", sinks=[sink])
    result, rollbacks = tres.train_chunked_with_rollback(
        cfg, pol, ratings, 0, str(tmp_path / "ckpt"), n_episodes=6, n_chunks=1, eval_every=2,
        guard_policy=tres.GuardPolicy(max_rollbacks=2), telemetry=tel, health_cb=health_cb,
        s_eval=2, device="cpu",
    )
    pol_state, rewards, _, _, monitor = result
    assert [(r.tripped_episode, r.restored_episode, r.lr_scale) for r in rollbacks] == [(4, 3, 0.5)]
    assert rewards.shape == (2, 2) and np.isfinite(rewards).all()  # episodes 4-5, retrained
    assert pol_state.q_table.data_ptr() == table.data_ptr()  # restored in place
    assert tel.counters["train.rollback"] == 1 and "rollback" in {r["kind"] for r in sink.records}


def test_fault_plans_match_jax():
    for seed, n, kills in ((0, 10, 1), (7, 40, 3), (123, 2, 2)):
        assert tfaults.kill_plan(seed, n, kills).to_json() == jfaults.kill_plan(seed, n, kills).to_json()
    events = (("kill", 3, 0, 0.0), ("corrupt_checkpoint", 4, None, 0.0), ("stall_callback", 5, 1, 0.25),
              ("poison_nan", 6, 0, 0.0))
    t_plan = tfaults.TrainFaultPlan(7, tuple(tfaults.TrainFaultEvent(*e) for e in events))
    j_plan = jfaults.TrainFaultPlan(7, tuple(jfaults.TrainFaultEvent(*e) for e in events))
    assert t_plan.to_json() == j_plan.to_json()
    assert tfaults.TrainFaultPlan.from_json(j_plan.to_json()) == t_plan
    with pytest.raises(ValueError, match="unknown"):
        tfaults.TrainFaultEvent("melt", 1)


def test_poison_keeps_integers():
    cfg = _cfg(tcfg, "ddpg")
    state = tsc.init_shared_pol_state(cfg, "cpu", torch.Generator().manual_seed(0))
    tsc.learner_leaves(state)  # makes Adam's state
    tfaults.poison_pol_state(state)
    for x, is_count in tsc.learner_leaves(state):
        assert bool(torch.isnan(x).all()) != is_count


def test_supervise_restarts_with_resume(tmp_path):
    """A child that kills itself on attempt 0 and checks for ``--resume`` on
    attempt 1: one kill, one resume, exit 0, the attempt rows."""
    child = (
        "import os, signal, sys\n"
        "a = int(os.environ['P2P_TRAIN_ATTEMPT'])\n"
        "print('{\"metric\": \"train_rollback\", \"value\": 1}' if a else 'starting', flush=True)\n"
        "if a == 0: os.kill(os.getpid(), signal.SIGKILL)\n"
        "sys.exit(0 if sys.argv[-1] == '--resume' else 3)\n"
    )
    rows, sleeps = [], []
    out = open(tmp_path / "out.txt", "w")
    res = tres.supervise([sys.executable, "-c", child], emit=rows.append, sleep=sleeps.append, passthrough=out)
    assert res.succeeded and res.kills == 1 and res.resumes == 1 and res.rollbacks == 1
    assert [r["exit_code"] for r in rows] == [-9, 0] and sleeps == [0.5]


def test_seed0_draw_digests_pinned():
    """The seed-0 CPU draws (the DDPG actor and critic, the synthetic
    traces, device_gen's trace draws) hash to the pinned values, which the
    card's machine (another torch version) reproduces too (chip_smoke.py)."""
    assert seed0_digests() == PINNED
