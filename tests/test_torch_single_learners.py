"""The single community's learners against the JAX package on the CPU: the
per-agent replay rings (``replay_add``/``replay_sample``), DQN's per-slot
``dqn_update``, and DDPG's ``DDPGState`` (``ddpg_init``, ``ddpg_act``,
``ddpg_update``, the converter both ways), at A=3.

Both sides start from the same weights (``convert.state_from_jax``) and the
port is fed the JAX keys' own draws. Tolerances: weights after a learn step
``rtol=1e-4, atol=1e-6``, Adam's moments ``rtol=1e-4`` (the moments square
gradients summed in another order; DDPG's with an atol of 1e-6 of the
leaf's scale, as tests/test_torch_ddpg.py), losses ``rtol=1e-4``; DDPG's actions
``atol=1e-5`` and its OU state bit for bit (``models/ddpg.py::ou_step``
emulates the jitted step's fused multiply-adds); rings exactly equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2pmicrogrid_tpu import config as jcfg
from p2pmicrogrid_tpu.models import ddpg as jddpg
from p2pmicrogrid_tpu.models import dqn as jdqn
from p2pmicrogrid_tpu.models import replay as jrep
from p2pmicrogrid_tpu_torch import config as tcfg
from p2pmicrogrid_tpu_torch.convert import state_from_jax, state_to_numpy
from p2pmicrogrid_tpu_torch.models import ddpg as tddpg
from p2pmicrogrid_tpu_torch.models import replay as trep
from p2pmicrogrid_tpu_torch.parallel.scenarios import init_shared_pol_state
from p2pmicrogrid_tpu_torch.train import init_policy_state, make_policy

A, CAP, B = 3, 8, 4


def _cfg(mod, impl):
    return mod.default_config(
        sim=mod.SimConfig(n_agents=A),
        train=mod.TrainConfig(implementation=impl),
        dqn=mod.DQNConfig(buffer_size=CAP, batch_size=B),
        ddpg=mod.DDPGConfig(buffer_size=CAP, batch_size=B),
    )


def _obs(rng, *shape):
    return rng.uniform(-1.0, 1.0, shape + (4,)).astype(np.float32)


def _transition(rng, impl):
    action = (
        rng.uniform(0.0, 1.0, A) if impl == "ddpg" else rng.integers(0, 3, A)
    ).astype(np.float32 if impl == "ddpg" else np.int32)
    # Rewards of ~30 drive first-layer gradients past DQN's clip at 1.
    return _obs(rng, A), action, rng.normal(0.0, 30.0, A).astype(np.float32), _obs(rng, A)


def _sample_idx(key, count):
    """The indices of JAX's replay_sample for this key, [A, B]."""
    return torch.from_numpy(np.array(jax.random.randint(key, (A, B), 0, max(count, 1))))


def _paths(tree):
    """Every leaf's path (field and key names), whatever the classes."""
    return [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _assert_trees_close(got, ref, rtol, atol, what):
    g_leaves, r_leaves = jax.tree.leaves(got), jax.tree.leaves(ref)
    assert len(g_leaves) == len(r_leaves), what
    for g, r in zip(g_leaves, r_leaves):
        assert np.shape(g) == np.shape(r), what
        np.testing.assert_allclose(g, r, rtol=rtol, atol=atol, err_msg=what)


def test_replay_add_wrap_sample():
    """CAP + 3 adds wrap every agent's ring; the cursor, count and buffers
    match, and a sample at the JAX key's per-agent indices gathers each
    agent's own entries."""
    replay_j = jrep.replay_init(A, CAP)
    replay_t = trep.replay_init(A, CAP, device="cpu")
    rng = np.random.default_rng(4)
    for _ in range(CAP + 3):
        obs, nobs = _obs(rng, A), _obs(rng, A)
        act = rng.uniform(0, 1, (A, 1)).astype(np.float32)
        rew = rng.normal(size=A).astype(np.float32)
        replay_j = jrep.replay_add(replay_j, obs, act, rew, nobs)
        replay_t = trep.replay_add(replay_t, *(torch.from_numpy(x) for x in (obs, act, rew, nobs)))
    got = state_to_numpy(replay_t)
    assert (int(got.cursor), int(got.count)) == (3, CAP)
    for g, r in zip(got, jax.tree.map(np.asarray, replay_j)):
        np.testing.assert_array_equal(g, r)
    key = jax.random.PRNGKey(7)
    ref = jrep.replay_sample(replay_j, key, B)
    idx = _sample_idx(key, CAP)
    assert idx.shape == (A, B) and not (idx == idx[0]).all()  # per-agent indices
    for g, r in zip(trep.replay_sample(replay_t, idx), ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    drawn = trep.sample_indices(2, A, B, torch.Generator().manual_seed(0), "cpu")
    assert drawn.shape == (A, B) and int(drawn.max()) < 2


@functools.lru_cache(maxsize=None)
def _jax_init(impl):
    cfg = _cfg(jcfg, impl)
    init = jdqn.dqn_init(cfg.dqn, A, jax.random.PRNGKey(3)) if impl == "dqn" else jddpg.ddpg_init(
        cfg.ddpg, A, jax.random.PRNGKey(3)
    )
    return jax.tree.map(np.asarray, init)


def _states(impl):
    """The JAX learner state and the port's copy of it (the port updates in
    place, so each test converts its own)."""
    st = _jax_init(impl)
    sub = _cfg(tcfg, impl).dqn if impl == "dqn" else _cfg(tcfg, impl).ddpg
    return jax.tree.map(jnp.asarray, st), state_from_jax(st, device="cpu", cfg=sub)


def test_dqn_update_matches_jax():
    """Three per-slot dqn_update steps on injected transitions at the JAX
    learn keys' per-agent indices: online and target weights, Adam's moments
    and count, the ring and the per-agent loss."""
    cfg_j, cfg_t = _cfg(jcfg, "dqn"), _cfg(tcfg, "dqn")
    st_j, st_t = _states("dqn")
    update = jax.jit(lambda st, o, a, r, n, k: jdqn.dqn_update(cfg_j.dqn, st, o, a, r, n, k))
    policy = make_policy(cfg_t)
    rng = np.random.default_rng(2)
    for step in range(3):
        obs, act, rew, nobs = _transition(rng, "dqn")
        key = jax.random.PRNGKey(10 + step)
        st_j, loss_j = update(st_j, obs, act, rew, nobs, key)
        idx = _sample_idx(key, int(st_j.replay.count))
        st_t, loss_t = policy.learn(
            st_t, *(torch.from_numpy(x) for x in (obs, act.astype(np.float32), rew, nobs)), idx
        )
        got, ref = state_to_numpy(st_t), jax.tree.map(np.asarray, st_j)
        _assert_trees_close((got.online, got.target), (ref.online, ref.target), 1e-4, 1e-6, f"step {step}")
        np.testing.assert_array_equal(got.opt_state[0].count, ref.opt_state[0].count)
        _assert_trees_close(got.opt_state[0][1:], ref.opt_state[0][1:], 1e-4, 1e-12, f"adam {step}")
        for g, r in zip(got.replay, ref.replay):
            np.testing.assert_array_equal(g, r)
        np.testing.assert_allclose(loss_t.numpy(), np.asarray(loss_j), rtol=1e-4)


def test_ddpg_init_matches_jax_structure():
    """ddpg_init: the JAX DDPGState's tree, leaf for leaf in shape and dtype;
    targets equal to the networks; Adam at count 0; the OU noise at
    ``ou_init_sd`` times the generator's normals after the networks'."""
    cfg_t = _cfg(tcfg, "ddpg")
    gen = torch.Generator().manual_seed(0)
    st = init_policy_state(cfg_t, device="cpu", generator=gen)
    assert isinstance(st, tddpg.DDPGState)
    assert isinstance(init_shared_pol_state(cfg_t, "cpu", gen), tddpg.DDPGParams)
    got, ref = state_to_numpy(st), _jax_init("ddpg")
    assert _paths(got) == _paths(ref)
    for g, r in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
        assert np.shape(g) == np.shape(r) and np.asarray(g).dtype == np.asarray(r).dtype
    _assert_trees_close(got.actor_target, got.actor, 0, 0, "actor target")
    assert int(got.actor_opt[0].count[0]) == 0 and got.replay.count == 0
    gen = torch.Generator().manual_seed(0)
    tddpg._params_init(cfg_t.ddpg, A, gen, torch.device("cpu"))
    np.testing.assert_array_equal(got.ou_state, cfg_t.ddpg.ou_init_sd * torch.randn((A,), generator=gen).numpy())


def test_ddpg_act_and_update_match_jax():
    """Three slots of ddpg_act (each with its OU step) and ddpg_update from
    the JAX keys: actions ``atol=1e-5``, the OU state bit for bit, weights,
    targets and Adam after each learn step, the rings, the loss; then the
    greedy act, and the converter's round trip of the final state."""
    cfg_j, cfg_t = _cfg(jcfg, "ddpg"), _cfg(tcfg, "ddpg")
    st_j, st_t = _states("ddpg")
    act_j = jax.jit(lambda st, o, k: jddpg.ddpg_act(cfg_j.ddpg, st, o, k, True))
    update = jax.jit(lambda st, o, a, r, n, k: jddpg.ddpg_update(cfg_j.ddpg, st, o, a, r, n, k))
    policy = make_policy(cfg_t)
    rng = np.random.default_rng(5)
    for step in range(3):
        obs, _, rew, nobs = _transition(rng, "ddpg")
        k_act = jax.random.PRNGKey(20 + step)
        a_j, q_j, st_j = act_j(st_j, obs, k_act)
        normals = torch.from_numpy(np.array(jax.random.normal(k_act, (A,))))
        a_t, q_t, st_t = tddpg.ddpg_act(cfg_t.ddpg, st_t, torch.from_numpy(obs), normals)
        np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), rtol=0, atol=1e-5)
        np.testing.assert_allclose(q_t.numpy(), np.asarray(q_j), rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(st_t.ou_state.numpy(), np.asarray(st_j.ou_state))
        k_learn = jax.random.PRNGKey(30 + step)
        st_j, loss_j = update(st_j, obs, a_j, rew, nobs, k_learn)
        idx = _sample_idx(k_learn, int(st_j.replay.count))
        st_t, loss_t = policy.learn(
            st_t, torch.from_numpy(obs), torch.from_numpy(np.array(a_j)), torch.from_numpy(rew),
            torch.from_numpy(nobs), idx,
        )
        got, ref = state_to_numpy(st_t), jax.tree.map(np.asarray, st_j)
        nets = ("actor", "critic", "actor_target", "critic_target")
        _assert_trees_close([getattr(got, n) for n in nets], [getattr(ref, n) for n in nets],
                            1e-4, 1e-6, f"step {step}")
        for name in ("actor_opt", "critic_opt"):
            np.testing.assert_array_equal(getattr(got, name)[0].count, getattr(ref, name)[0].count)
            # Moments at rtol=1e-4 with an atol of 1e-6 of each leaf's
            # scale, tests/test_torch_ddpg.py's contract for DDPG's Adam.
            for g, r in zip(jax.tree.leaves(getattr(got, name)[0][1:]),
                            jax.tree.leaves(getattr(ref, name)[0][1:])):
                np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-6 * float(np.abs(r).max()), err_msg=name)
        for g, r in zip(got.replay, ref.replay):
            np.testing.assert_array_equal(g, r)
        np.testing.assert_allclose(loss_t.numpy(), np.asarray(loss_j), rtol=1e-4)
    obs = _obs(rng, A)
    a_j, _, _ = jddpg.ddpg_act(cfg_j.ddpg, st_j, obs, jax.random.PRNGKey(0), False)
    a_t, _, st_g = tddpg.ddpg_act(cfg_t.ddpg, st_t, torch.from_numpy(obs), None, explore=False)
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), rtol=0, atol=1e-5)
    assert torch.equal(st_g.ou_state, st_t.ou_state)

    # The converter both ways: JAX -> port -> numpy gives the JAX tree back.
    ref = jax.tree.map(np.asarray, st_j)
    back = state_to_numpy(state_from_jax(ref, device="cpu", cfg=cfg_t.ddpg))
    assert type(back).__name__ == "DDPGState"
    assert _paths(back) == _paths(ref)
    for g, r in zip(jax.tree.leaves(back), jax.tree.leaves(ref)):
        np.testing.assert_array_equal(g, r)
    with pytest.raises(ValueError, match="DDPGConfig"):
        state_from_jax(ref, device="cpu")
