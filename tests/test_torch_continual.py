"""The port's continual training against the JAX package (CPU).

* ``state_from_bundle`` on a bundle the JAX package exported (tabular, DQN,
  shared DDPG) gives the JAX state's greedy actions: discrete actions equal,
  DDPG's within the act tolerance of ``tests/test_torch_ddpg.py``
  (``rtol=1e-5, atol=1e-6``); targets equal their online twins.
* One ``make_trace_update_fn`` step and a 3-step ``offpolicy_pretrain``,
  fed the JAX key chain's minibatch indices (``jax.random.randint`` per
  step key, ``train/continual.py:169,205,243``): tabular tables bit for
  bit, DQN and DDPG parameters at the episode tolerances of
  ``tests/test_torch_dqn.py``/``tests/test_torch_ddpg.py`` (``rtol=1e-4,
  atol=1e-6``), losses ``rtol=1e-4``.
* ``continual_cfg``'s ``config_hash`` equals the JAX function's, the
  collision bump included.
* ``train_continual`` at A=3 with ``n_episodes=0`` (the JAX run's indices
  injected: the candidate's table and hash equal the JAX candidate's) and
  with ``n_episodes=1`` (one guarded chunk episode, S=2): the JAX package's
  ``load_policy_bundle`` opens the candidate and its engine serves it.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from p2pmicrogrid_tpu import config as jcfg
from p2pmicrogrid_tpu.data.trace_export import TraceDataset as JTraceDataset
from p2pmicrogrid_tpu.parallel import scenarios as jsc
from p2pmicrogrid_tpu.serve import PolicyEngine as JaxEngine
from p2pmicrogrid_tpu.serve.export import export_policy_bundle as jax_export
from p2pmicrogrid_tpu.serve.export import load_policy_bundle as jax_load
from p2pmicrogrid_tpu.telemetry import config_hash as jax_config_hash
from p2pmicrogrid_tpu.train import continual as jcont
from p2pmicrogrid_tpu_torch import config as tcfg
from p2pmicrogrid_tpu_torch.convert import state_from_jax, state_to_numpy
from p2pmicrogrid_tpu_torch.data.trace_export import TraceDataset
from p2pmicrogrid_tpu_torch.models.dqn import dqn_act
from p2pmicrogrid_tpu_torch.models.tabular import tabular_act
from p2pmicrogrid_tpu_torch.serve.export import load_policy_bundle
from p2pmicrogrid_tpu_torch.telemetry import config_hash
from p2pmicrogrid_tpu_torch.train import continual as tcont

A, N, STEPS = 3, 24, 3
CASES = ["tabular", "dqn", "ddpg"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(mod, impl, seed=0, scenarios=1):
    return mod.default_config(
        sim=mod.SimConfig(n_agents=A, n_scenarios=scenarios),
        train=mod.TrainConfig(implementation=impl, seed=seed),
        qlearning=mod.QLearningConfig(
            num_time_states=8, num_temp_states=8, num_balance_states=8, num_p2p_states=8
        ),
        dqn=mod.DQNConfig(hidden=8, buffer_size=16, batch_size=8),
        ddpg=mod.DDPGConfig(actor_hidden=8, critic_hidden=8, buffer_size=16, batch_size=8,
                            share_across_agents=True),
    )


def _dataset(seed=0):
    """Seeded transitions in the serving contract (the JAX test's
    ``_fake_dataset``)."""
    rng = np.random.default_rng(seed)
    obs = np.empty((N, A, 4), np.float32)
    obs[..., 0] = rng.uniform(0, 1, (N, A))
    obs[..., 1:] = rng.uniform(-1, 1, (N, A, 3))
    act = rng.choice([0.0, 0.5, 1.0], (N, A)).astype(np.float32)
    rew = rng.normal(0, 1, (N, A)).astype(np.float32)
    nxt = np.roll(obs, -1, axis=0)
    return (JTraceDataset(obs=obs, action=act, reward=rew, next_obs=nxt),
            TraceDataset(obs=obs, action=act, reward=rew, next_obs=nxt))


def _jax_state(cfg_j, impl):
    st = jax.jit(lambda k: jsc.init_shared_pol_state(cfg_j, k))(jax.random.PRNGKey(0))
    if impl == "tabular":  # a table that is not all ties
        q = np.random.default_rng(4).standard_normal(st.q_table.shape, dtype=np.float32)
        st = st._replace(q_table=jax.numpy.asarray(q))
    return st


def _sub(cfg, impl):
    return {"dqn": cfg.dqn, "ddpg": cfg.ddpg}.get(impl)


def _jax_indices(key, steps, b, n):
    return np.stack([np.asarray(jax.random.randint(k, (b,), 0, n)) for k in jax.random.split(key, steps)])


def _assert_state(got, ref, impl, rtol, atol):
    got, ref = state_to_numpy(got), jax.tree.map(np.asarray, ref)
    if impl == "tabular":
        np.testing.assert_array_equal(got.q_table, ref.q_table)
        return
    names = ("online", "target") if impl == "dqn" else ("actor", "critic", "actor_target", "critic_target")
    for name in names:
        for g, r in zip(jax.tree.leaves(getattr(got, name)), jax.tree.leaves(getattr(ref, name))):
            np.testing.assert_allclose(g, r, rtol=rtol, atol=atol, err_msg=name)


@pytest.mark.parametrize("impl", CASES)
def test_state_from_bundle_gives_the_jax_greedy_actions(impl, tmp_path):
    cfg_j, cfg_t = _cfg(jcfg, impl), _cfg(tcfg, impl)
    bundle = jax_export(cfg_j, _jax_state(cfg_j, impl), str(tmp_path / "b"))
    manifest, params = load_policy_bundle(bundle)
    st = tcont.state_from_bundle(cfg_t, manifest, params, torch.Generator().manual_seed(1), device="cpu")
    obs = np.random.default_rng(5).uniform(-1, 1, (4, A, 4)).astype(np.float32)
    want = JaxEngine(bundle_dir=bundle, max_batch=4, device="cpu").act(obs)
    x = torch.from_numpy(obs)
    with torch.no_grad():
        if impl == "tabular":
            got = tabular_act(cfg_t.qlearning, st, x, None, None, explore=False)[0].double() * 0.5
        elif impl == "dqn":
            got = dqn_act(cfg_t.dqn, st, x, None, None, explore=False)[0].double() * 0.5
            for o, t in zip(st.online.parameters(), st.target.parameters()):
                assert torch.equal(o, t)
        else:
            got = st.actor(x.reshape(-1, 4)).reshape(4, A)
            for o, t in zip(st.actor.parameters(), st.actor_target.parameters()):
                assert torch.equal(o, t)
            for o, t in zip(st.critic.parameters(), st.critic_target.parameters()):
                assert torch.equal(o, t)
    if impl == "ddpg":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_array_equal(got.numpy().astype(np.float32), want)
    with pytest.raises(ValueError, match="SAME policy class"):
        tcont.state_from_bundle(_cfg(tcfg, "dqn" if impl == "tabular" else "tabular"),
                                manifest, params, device="cpu")


@pytest.mark.parametrize("impl", CASES)
def test_trace_update_and_pretrain_match_jax(impl):
    cfg_j, cfg_t = _cfg(jcfg, impl), _cfg(tcfg, impl)
    ds_j, ds_t = _dataset()
    st_j = _jax_state(cfg_j, impl)
    st_t = state_from_jax(jax.tree.map(np.asarray, st_j), "cpu", cfg=_sub(cfg_t, impl))
    b = tcont.trace_batch_size(cfg_t, N)
    # One step.
    key = jax.random.PRNGKey(3)
    st1_j, loss_j = jcont.make_trace_update_fn(cfg_j, ds_j)(st_j, key)
    idx = torch.from_numpy(np.array(jax.random.randint(key, (b,), 0, N)))
    st1_t, loss_t = tcont.make_trace_update_fn(cfg_t, ds_t, device="cpu")(st_t, idx)
    _assert_state(st1_t, st1_j, impl, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-4)
    # A 3-step pretrain from the stepped state.
    key = jax.random.PRNGKey(4)
    st3_j, losses_j = jcont.offpolicy_pretrain(cfg_j, st1_j, ds_j, key, steps=STEPS)
    idx = torch.from_numpy(_jax_indices(key, STEPS, b, N))
    st3_t, losses_t = tcont.offpolicy_pretrain(cfg_t, st1_t, ds_t, None, STEPS, indices=idx, device="cpu")
    _assert_state(st3_t, st3_j, impl, rtol=1e-4, atol=1e-6)
    assert losses_t.shape == (STEPS,) and losses_t.dtype == np.float32
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-4)
    # The drawn path: [steps, b] indices from a generator, finite losses.
    _, drawn = tcont.offpolicy_pretrain(cfg_t, st3_t, ds_t, torch.Generator().manual_seed(0), 2,
                                        device="cpu")
    assert drawn.shape == (2,) and np.isfinite(drawn).all()


def test_frac_to_action_index_rounds_half_to_even():
    frac = torch.tensor([0.0, 0.24, 0.25, 0.5, 0.75, 0.76, 1.0, 1.4, -0.3])
    got = tcont._frac_to_action_index(frac).numpy()
    want = np.asarray(jcont._frac_to_action_index(frac.numpy()))
    np.testing.assert_array_equal(got, want)
    assert got.tolist() == [0, 0, 0, 1, 2, 2, 2, 2, 0]


def test_continual_cfg_hash_matches_jax():
    cfg_j, cfg_t = _cfg(jcfg, "tabular"), _cfg(tcfg, "tabular")
    inc = jax_config_hash(cfg_j)
    assert config_hash(cfg_t) == inc
    for ep0 in (0, 5):  # 0 collides with the incumbent and bumps
        cand_j, cand_t = jcont.continual_cfg(cfg_j, ep0, inc), tcont.continual_cfg(cfg_t, ep0, inc)
        assert cand_t.train.starting_episodes == cand_j.train.starting_episodes
        assert config_hash(cand_t) == jax_config_hash(cand_j) != inc


def test_train_continual_trace_only_matches_jax(tmp_path):
    cfg_j, cfg_t = _cfg(jcfg, "tabular"), _cfg(tcfg, "tabular")
    ds_j, ds_t = _dataset(1)
    inc = jax_export(cfg_j, _jax_state(cfg_j, "tabular"), str(tmp_path / "inc"))
    res_j = jcont.train_continual(cfg_j, inc, ds_j, str(tmp_path / "cand_j"), str(tmp_path / "ck_j"),
                                  n_episodes=0, trace_steps=4)
    # The JAX run's trace key: split(PRNGKey(seed), 4)[2].
    k_trace = jax.random.split(jax.random.PRNGKey(cfg_j.train.seed), 4)[2]
    idx = torch.from_numpy(_jax_indices(k_trace, 4, tcont.trace_batch_size(cfg_t, N), N))
    res_t = tcont.train_continual(cfg_t, inc, ds_t, str(tmp_path / "cand_t"), str(tmp_path / "ck_t"),
                                  n_episodes=0, trace_steps=4, indices=idx, device="cpu")
    assert res_t.candidate_hash == res_j.candidate_hash != res_t.incumbent_hash
    assert res_t.summary() == {**res_j.summary(), "candidate_dir": res_t.candidate_dir}
    (m_j, p_j), (m_t, p_t) = jax_load(res_j.candidate_dir), jax_load(res_t.candidate_dir)
    np.testing.assert_array_equal(p_t["q_table"], p_j["q_table"])
    assert m_t["config_hash"] == m_j["config_hash"]
    assert m_t["source"]["kind"] == "continual" and m_t["source"]["incumbent"] == res_t.incumbent_hash
    assert set(res_t.phase_seconds) == {"pretrain", "fine_tune", "export"}


@pytest.mark.parametrize("impl", ["tabular", "ddpg"])
def test_train_continual_one_guarded_episode_opens_in_jax(impl, tmp_path):
    cfg_j, cfg_t = _cfg(jcfg, impl, scenarios=2), _cfg(tcfg, impl, scenarios=2)
    cfg_j = cfg_j.replace(sim=dataclasses.replace(cfg_j.sim, n_scenarios=2))
    inc = jax_export(cfg_j, _jax_state(cfg_j, impl), str(tmp_path / "inc"))
    _, ds_t = _dataset(2)
    res = tcont.train_continual(cfg_t, inc, ds_t, str(tmp_path / "cand"), str(tmp_path / "ck"),
                                n_episodes=1, eval_every=1, trace_steps=2, s_eval=2, device="cpu")
    assert res.episodes == 1 and res.rollbacks == []
    manifest, _ = jax_load(res.candidate_dir)
    assert manifest["config_hash"] == res.candidate_hash != res.incumbent_hash
    assert manifest["source"]["sim_episodes"] == 1
    obs = np.random.default_rng(6).uniform(-1, 1, (2, A, 4)).astype(np.float32)
    out = JaxEngine(bundle_dir=res.candidate_dir, max_batch=2, device="cpu").act(obs)
    assert out.shape == (2, A) and np.isfinite(out).all()
