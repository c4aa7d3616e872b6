"""The single community's training and evaluation loops
(``train/loop.py``) against the JAX package's on the CPU.

The port is fed every draw of the JAX loops' key chains
(train/loop.py:356-357 ``key, k_block = split(key)`` and
``split(k_block, block)``, :99 ``k_phys, k_ep = split(key)`` per episode;
:176-177 the DQN warmup's ``split(k_warm, warmup_passes)``; :493-496
evaluation's ``split(key, n_days)``), rebuilt by
``test_torch_single_episode.py``'s helpers. Tolerances: episode rewards
``rtol=2e-4`` (tests/test_golden.py:74-81), losses and the final Q-table
``rtol=1e-3, atol=1e-4`` (tests/test_factored_market.py:203-214), DQN's
online weights ``rtol=1e-4, atol=1e-6`` (tests/test_torch_slot_fused.py's
episodes); evaluation decisions equal, DDPG's within ``atol=1e-5``.
An 8-bin Q-table.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_single_episode import jax_init_normals, jax_single_draws

from p2pmicrogrid_tpu import config as jcfg
from p2pmicrogrid_tpu.data import synthetic_traces
from p2pmicrogrid_tpu.envs import community as jcom
from p2pmicrogrid_tpu.train import init_policy_state as j_init_policy_state
from p2pmicrogrid_tpu.train import loop as jloop
from p2pmicrogrid_tpu.train import make_policy as j_make_policy
from p2pmicrogrid_tpu_torch import config as tcfg
from p2pmicrogrid_tpu_torch.convert import state_from_jax, state_to_numpy
from p2pmicrogrid_tpu_torch.train import init_policy_state as t_init_policy_state
from p2pmicrogrid_tpu_torch.train import loop as tloop
from p2pmicrogrid_tpu_torch.train import make_policy as t_make_policy

A, T = 2, 96
BINS = dict(num_time_states=8, num_temp_states=8, num_balance_states=8, num_p2p_states=8)


def _cfg(mod, impl="tabular", **train):
    train = {"max_episodes": 3, "episodes_per_jit_block": 2, "min_episodes_criterion": 1,
             "save_episodes": 2, **train}
    return mod.default_config(
        sim=mod.SimConfig(n_agents=A),
        qlearning=mod.QLearningConfig(**BINS),
        train=mod.TrainConfig(implementation=impl, **train),
        dqn=mod.DQNConfig(warmup_passes=1, buffer_size=256, batch_size=8),
        ddpg=mod.DDPGConfig(buffer_size=256, batch_size=8),
    )


def _traces(n_days=1):
    return synthetic_traces(n_days=n_days, start_day=11).normalized()


def _ratings(cfg):
    return jcom.make_ratings(cfg, np.random.default_rng(42))


def _episode_draws(cfg, key, impl, count0=0, learn=True):
    """One training episode's draws from its key: the initial normals from
    ``k_phys``, the rest from ``k_ep``'s chain."""
    k_phys, k_ep = jax.random.split(key)
    batch = {"dqn": cfg.dqn.batch_size, "ddpg": cfg.ddpg.batch_size}.get(impl)
    cap = {"dqn": cfg.dqn.buffer_size, "ddpg": cfg.ddpg.buffer_size}.get(impl)
    # A warmup pass draws no replay indices; its draws come from the same
    # compiled program, the indices dropped.
    d = jax_single_draws(k_ep, T, A, impl, rounds=cfg.sim.rounds, n_actions=3, batch=batch,
                         cap=cap, count0=count0)
    return d._replace(normals=jax_init_normals(k_phys, A), replay_idx=d.replay_idx if learn else None)


def _loop_draws(cfg, key, impl):
    """(warmup draws, episode draws) of train_community's key chain."""
    t = cfg.train
    warm = []
    if impl == "dqn":
        key, k_warm = jax.random.split(key)
        warm = [
            _episode_draws(cfg, k, impl, learn=False)
            for k in jax.random.split(k_warm, cfg.dqn.warmup_passes)
        ]
    draws, episode = [], t.starting_episodes
    while episode < t.max_episodes:
        key, k_block = jax.random.split(key)
        step = min(t.episodes_per_jit_block, t.max_episodes - episode,
                   t.save_episodes - episode % t.save_episodes)
        for k in jax.random.split(k_block, step):
            count0 = (len(warm) + len(draws)) * T
            draws.append(_episode_draws(cfg, k, impl, count0=count0))
        episode += step
    return warm, draws


def _jax_policy_state(cfg_j, cfg_t, seed):
    """A fresh DQN or DDPG learner state for both packages: the port's init
    from a seeded generator, in the JAX package's tree (leaf for leaf in
    shape and dtype), which spares a JAX compile of the networks' init."""
    ref, tree = jax.tree.flatten(
        jax.eval_shape(lambda k: j_init_policy_state(cfg_j, k), jax.random.PRNGKey(0))
    )
    leaves = [np.array(x) for x in jax.tree.leaves(
        state_to_numpy(t_init_policy_state(cfg_t, "cpu", torch.Generator().manual_seed(seed))))]
    assert [(r.shape, r.dtype) for r in ref] == [(x.shape, x.dtype) for x in leaves]
    return jax.tree.unflatten(tree, [jnp.asarray(x) for x in leaves])


def _random_q(cfg_j, seed=4):
    """The JAX tabular state with a standard-normal Q-table from numpy."""
    ps = j_init_policy_state(cfg_j, jax.random.PRNGKey(0))
    q = np.random.default_rng(seed).standard_normal(ps.q_table.shape, dtype=np.float32)
    return ps._replace(q_table=jnp.asarray(q))


def _run_both(impl):
    cfg_j, cfg_t = _cfg(jcfg, impl), _cfg(tcfg, impl)
    if impl == "dqn":
        cfg_j, cfg_t = (dataclasses.replace(c, train=dataclasses.replace(c.train, max_episodes=1))
                        for c in (cfg_j, cfg_t))
    ratings = _ratings(cfg_j)
    ps_j = _random_q(cfg_j) if impl == "tabular" else _jax_policy_state(cfg_j, cfg_t, 0)
    ps_np = jax.tree.map(np.asarray, ps_j)
    ckpt_j, ckpt_t = [], []
    key = jax.random.PRNGKey(9)
    ref = jloop.train_community(
        cfg_j, j_make_policy(cfg_j), ps_j, _traces(), ratings, key,
        checkpoint_cb=lambda ep, ps: ckpt_j.append(ep), pipeline=False,
    )
    warm, draws = _loop_draws(cfg_j, key, impl)
    got = tloop.train_community(
        cfg_t, t_make_policy(cfg_t), state_from_jax(ps_np, "cpu", cfg=cfg_t.dqn), _traces(),
        ratings, checkpoint_cb=lambda ep, ps: ckpt_t.append(ep), draws=draws,
        warmup_draws=warm or None, device="cpu",
    )
    return cfg_t, ref, got, ckpt_j, ckpt_t


def test_train_community_tabular_matches_jax():
    """Three episodes in blocks of 2 (the last clamped to 1), decay after
    every episode (``min_episodes_criterion=1``, episode 0 included), a
    checkpoint every 2 episodes (the 2-argument callback)."""
    cfg, ref, got, ckpt_j, ckpt_t = _run_both("tabular")
    np.testing.assert_allclose(got.episode_rewards, ref.episode_rewards, rtol=2e-4)
    np.testing.assert_allclose(got.episode_losses, ref.episode_losses, rtol=1e-3, atol=1e-4)
    assert [p[0] for p in got.progress] == [p[0] for p in ref.progress] == [0, 1, 2]
    np.testing.assert_allclose(np.array(got.progress)[:, 1:], np.array(ref.progress)[:, 1:], rtol=2e-4, atol=1e-4)
    assert ckpt_t == ckpt_j == [1]
    final = state_to_numpy(got.pol_state)
    np.testing.assert_allclose(final.q_table, np.asarray(ref.pol_state.q_table), rtol=1e-3, atol=1e-4)
    assert final.epsilon == np.asarray(ref.pol_state.epsilon)  # decayed three times
    assert got.env_steps == ref.env_steps == 3 * T and got.train_seconds > 0
    assert got.rng_state is None
    for name in got.phys._fields:
        np.testing.assert_allclose(getattr(got.phys, name).numpy(), np.asarray(getattr(ref.phys, name)),
                                   rtol=2e-4, atol=1e-5)


def test_train_community_dqn_matches_jax():
    """DQN: one record-only warmup pass, the hard target copy, then one
    learning episode sampling each agent's ring."""
    cfg, ref, got, _, _ = _run_both("dqn")
    np.testing.assert_allclose(got.episode_rewards, ref.episode_rewards, rtol=2e-4)
    np.testing.assert_allclose(got.episode_losses, ref.episode_losses, rtol=1e-3, atol=1e-4)
    final, ref_np = state_to_numpy(got.pol_state), jax.tree.map(np.asarray, ref.pol_state)
    for g, r in zip(jax.tree.leaves(final.online), jax.tree.leaves(ref_np.online)):
        np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-6)
    assert final.replay.count == ref_np.replay.count == 2 * T
    for g, r in zip(final.replay[:4], ref_np.replay[:4]):
        np.testing.assert_allclose(g, r, rtol=2e-4, atol=1e-5)


def test_checkpoint_with_rng_state_resumes_exactly():
    """The 3-argument callback gets the generator's state after the block:
    restoring the checkpointed state and generator and resuming from the
    next episode replays the uninterrupted run's episodes bit for bit.
    The unported hooks raise."""
    cfg = _cfg(tcfg, max_episodes=4, episodes_per_jit_block=3)
    policy = t_make_policy(cfg)
    ps0 = state_from_jax(jax.tree.map(np.asarray, _random_q(_cfg(jcfg))), "cpu")
    saved = {}

    def ckpt(ep, ps, rng_state):
        # A copy: on the CPU state_to_numpy's arrays share the live tensors.
        saved[ep] = (jax.tree.map(np.copy, state_to_numpy(ps)), rng_state.clone())

    full = tloop.train_community(
        cfg, policy, state_from_jax(state_to_numpy(ps0), "cpu"), _traces(), _ratings(cfg),
        torch.Generator().manual_seed(0), checkpoint_cb=ckpt, device="cpu",
    )
    assert sorted(saved) == [1, 3]
    ps1, rng1 = saved[1]
    gen = torch.Generator()
    gen.set_state(rng1)
    cfg2 = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, starting_episodes=2))
    resumed = tloop.train_community(
        cfg2, policy, state_from_jax(ps1, "cpu"), _traces(), _ratings(cfg), gen, device="cpu",
    )
    assert resumed.episode_rewards == full.episode_rewards[2:]
    assert torch.equal(resumed.pol_state.q_table, full.pol_state.q_table)


@functools.lru_cache(maxsize=None)
def _jax_evaluation(impl):
    """The JAX package's greedy evaluation over 2 days (unfused: its fused
    single slot is held bit-exact to this chain by its own
    tests/test_pallas_slot.py:198)."""
    cfg_j, cfg_t = _cfg(jcfg, impl), _cfg(tcfg, impl)
    ps_j = _random_q(cfg_j) if impl == "tabular" else _jax_policy_state(cfg_j, cfg_t, 1)
    key = jax.random.PRNGKey(11)
    ref = jloop.evaluate_community(cfg_j, j_make_policy(cfg_j), ps_j, _traces(n_days=2), _ratings(cfg_j), key)
    normals = torch.stack([jax_init_normals(jax.random.split(k)[0], A) for k in jax.random.split(key, 2)])
    return jax.tree.map(np.asarray, ps_j), normals, ref


@pytest.mark.parametrize("impl,fused", [("tabular", False), ("tabular", True), ("ddpg", False)],
                         ids=["tabular", "tabular-fused", "ddpg"])
def test_evaluate_community_matches_jax(impl, fused):
    """Greedy evaluation over 2 days as one [2, A] batch: each day's
    redrawn profile scales, fresh state and decisions as the JAX package's
    vmapped days. ``SimConfig(fused_slot=True)`` runs the days through K7's
    plain version at [2, A]."""
    cfg_t = _cfg(tcfg, impl)
    cfg_t = dataclasses.replace(cfg_t, sim=dataclasses.replace(cfg_t.sim, fused_slot=fused))
    ps_np, normals, (days_j, out_j, arr_j) = _jax_evaluation(impl)
    ps_t = state_from_jax(ps_np, "cpu", cfg=cfg_t.ddpg)
    days, out, arr = tloop.evaluate_community(
        cfg_t, t_make_policy(cfg_t), ps_t, _traces(n_days=2), _ratings(cfg_t), normals=normals,
        device="cpu",
    )
    np.testing.assert_array_equal(days, days_j)
    for g, r in zip(arr, arr_j):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6)
    assert out.reward.shape == (2, T, A)
    if impl == "tabular":
        np.testing.assert_array_equal(out.decisions.numpy(), np.asarray(out_j.decisions))
    else:
        np.testing.assert_allclose(out.decisions.numpy(), np.asarray(out_j.decisions), rtol=0,
                                   atol=1e-5 * cfg_t.thermal.hp_max_power)
    for name in ("reward", "cost", "t_in"):
        np.testing.assert_allclose(getattr(out, name).numpy(), np.asarray(getattr(out_j, name)),
                                   rtol=2e-4, atol=1e-5, err_msg=name)
    np.testing.assert_allclose(out.reward.sum(dim=(1, 2)).numpy(), np.asarray(out_j.reward).sum(axis=(1, 2)), rtol=2e-4)
