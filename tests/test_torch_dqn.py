"""The port's DQN learner against the JAX package on the CPU: the per-agent
Q-network, the epsilon-greedy act, one shared learn step (Adam, the
first-layer clip, Polyak) and the lockstep replay ring.

Both sides start from the same weights (``convert.state_from_jax``) and the
port is fed the JAX package's own random draws. Tolerances: forwards
``rtol=1e-5, atol=1e-6`` (float32 products summed in another order);
parameters after a learn step ``rtol=1e-5, atol=1e-7``, Adam moments and the
loss ``rtol=1e-4`` (the moments square the gradients, whose sums run in
another order); actions and ring contents exactly equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from p2pmicrogrid_tpu import config as jcfg
from p2pmicrogrid_tpu.envs.community import SlotTransition as JTransition
from p2pmicrogrid_tpu.models import dqn as jdqn
from p2pmicrogrid_tpu.models import replay as jrep
from p2pmicrogrid_tpu.models.networks import QNetwork as JQNetwork
from p2pmicrogrid_tpu.parallel import scenarios as jsc
from p2pmicrogrid_tpu_torch import config as tcfg
from p2pmicrogrid_tpu_torch.convert import state_from_jax, state_to_numpy
from p2pmicrogrid_tpu_torch.envs.community import SlotTransition
from p2pmicrogrid_tpu_torch.models import dqn as tdqn
from p2pmicrogrid_tpu_torch.models import replay as trep
from p2pmicrogrid_tpu_torch.parallel import scenarios as tsc

S, A, CAP, B = 3, 5, 8, 4


def _cfg(mod):
    return mod.default_config(
        sim=mod.SimConfig(n_agents=A, n_scenarios=S),
        train=mod.TrainConfig(implementation="dqn"),
        dqn=mod.DQNConfig(buffer_size=CAP, batch_size=B),
    )


@functools.lru_cache(maxsize=None)
def _jax_state():
    cfg = _cfg(jcfg)
    return jax.tree.map(np.asarray, jax.jit(lambda k: jdqn.dqn_init(cfg.dqn, A, k))(jax.random.PRNGKey(3)))


def _states():
    """The JAX learner state and the port's copy of it (the port updates in
    place, so each test converts its own)."""
    st = _jax_state()
    return _cfg(jcfg), jax.tree.map(jnp.asarray, st), state_from_jax(st, device="cpu", cfg=_cfg(tcfg).dqn)


def _obs(rng, *shape):
    return rng.uniform(-1.0, 1.0, shape + (4,)).astype(np.float32)


def test_qnetwork_forward_matches_jax():
    """Each agent's network on a batch, and the 3-action enumeration over
    [S, A, 4] observations, on converted weights."""
    cfg, st, port = _states()
    rng = np.random.default_rng(0)
    state = _obs(rng, A, 7)
    action = rng.uniform(0.0, 1.0, (A, 7, 1)).astype(np.float32)
    net = JQNetwork(hidden=cfg.dqn.hidden)
    ref = jax.jit(jax.vmap(lambda p, s, a: net.apply({"params": p}, s, a)))(st.online, state, action)
    with torch.no_grad():
        got = port.online(torch.from_numpy(state), torch.from_numpy(action))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)

    obs = _obs(rng, S, A)
    ref = jax.jit(jax.vmap(lambda p, o: jdqn._q_all_actions(cfg.dqn, p, o), (None, 0)))(st.online, obs)
    with torch.no_grad():
        got = tdqn._q_all_actions(_cfg(tcfg).dqn, port.online, torch.from_numpy(obs))
    assert got.shape == (S, A, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_dqn_act_matches_jax():
    """dqn_act fed the draws of the JAX act's own key (k_mask, k_rand), at a
    shared epsilon that explores some agents, and greedily."""
    cfg, st, port = _states()
    st = st._replace(epsilon=jnp.float32(0.5))
    port = port._replace(epsilon=torch.tensor(0.5))
    obs = _obs(np.random.default_rng(1), A)
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        k_mask, k_rand = jax.random.split(key)
        uniform = np.array(jax.random.uniform(k_mask, (A,)))
        rand = np.array(jax.random.randint(k_rand, (A,), 0, 3, dtype=jnp.int32))
        for explore in (True, False):
            a_j, q_j = jdqn.dqn_act(cfg.dqn, st, obs, key, explore)
            a_t, q_t = tdqn.dqn_act(
                _cfg(tcfg).dqn, port, torch.from_numpy(obs), torch.from_numpy(uniform),
                torch.from_numpy(rand), explore,
            )
            np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j))
            np.testing.assert_allclose(q_t.numpy(), np.asarray(q_j), rtol=1e-5, atol=1e-6)


def _transition(rng, mod_cls, to):
    return mod_cls(
        obs=to(_obs(rng, S, A)),
        aux=to(rng.integers(0, 3, (S, A)).astype(np.float32)),
        reward=to(rng.normal(0.0, 30.0, (S, A)).astype(np.float32)),
        next_obs=to(_obs(rng, S, A)),
    )


def test_shared_learn_step_matches_jax():
    """Two _dqn_update_shared steps on injected transitions and the JAX
    learn keys' sample indices: online and target parameters, Adam's moments
    and step count, the ring and the per-scenario loss. Rewards of ~30
    drive first-layer gradients past the clip at 1."""
    cfg, st, port = _states()
    cfg_t = _cfg(tcfg)
    replay_j = jrep.lockstep_replay_init(S, A, CAP)
    replay_t = trep.lockstep_replay_init(S, A, CAP, device="cpu")
    rng = np.random.default_rng(2)
    update = jax.jit(lambda st, rep, tr, key: jsc._dqn_update_shared(cfg, st, rep, tr, key))
    for step in range(2):
        seed = 10 + step
        tr_np = _transition(rng, JTransition, np.asarray)
        key = jax.random.PRNGKey(seed)
        st, replay_j, loss_j = update(st, replay_j, tr_np, key)
        idx = jax.random.randint(key, (B,), 0, max(int(replay_j.count), 1))
        tr_t = SlotTransition(*(torch.from_numpy(np.array(x)) for x in tr_np))
        port, replay_t, loss_t = tsc._dqn_update_shared(
            cfg_t, port, replay_t, tr_t, torch.from_numpy(np.array(idx))
        )
        got, ref = state_to_numpy(port), jax.tree.map(np.asarray, st)
        for name in ("online", "target"):
            for g, r in zip(jax.tree.leaves(getattr(got, name)), jax.tree.leaves(getattr(ref, name))):
                np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-7, err_msg=f"{name} step {step}")
        adam_g, adam_r = got.opt_state[0], ref.opt_state[0]
        np.testing.assert_array_equal(adam_g.count, adam_r.count)
        for g, r in zip(jax.tree.leaves((adam_g.mu, adam_g.nu)), jax.tree.leaves((adam_r.mu, adam_r.nu))):
            np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-12, err_msg=f"adam step {step}")
        np.testing.assert_allclose(loss_t.numpy(), np.asarray(loss_j), rtol=1e-4)
        assert replay_t.count == int(replay_j.count) and replay_t.cursor == int(replay_j.cursor)
    # The clip bit: an entry whose gradient was clipped to 1 in both steps
    # has the first moment (1 - b1) * (b1 * 1 + 1) = 0.19.
    mu0 = np.abs(np.asarray(ref.opt_state[0].mu["Dense_0"]["kernel"])).max()
    np.testing.assert_allclose(mu0, 0.19, rtol=1e-6)


def test_lockstep_replay_add_wrap_sample():
    """CAP + 3 adds wrap the ring; the cursor, count and buffers match, and a
    sample at the JAX key's indices gathers the same slabs."""
    replay_j = jrep.lockstep_replay_init(S, A, CAP)
    replay_t = trep.lockstep_replay_init(S, A, CAP, device="cpu")
    rng = np.random.default_rng(4)
    for _ in range(CAP + 3):
        obs, nobs = _obs(rng, S, A), _obs(rng, S, A)
        act = rng.uniform(0, 1, (S, A, 1)).astype(np.float32)
        rew = rng.normal(size=(S, A)).astype(np.float32)
        replay_j = jrep.lockstep_replay_add(replay_j, obs, act, rew, nobs)
        replay_t = trep.lockstep_replay_add(
            replay_t, *(torch.from_numpy(x) for x in (obs, act, rew, nobs))
        )
    got = state_to_numpy(replay_t)
    assert (int(got.cursor), int(got.count)) == (3, CAP)
    for g, r in zip(got, jax.tree.map(np.asarray, replay_j)):
        np.testing.assert_array_equal(g, r)
    key = jax.random.PRNGKey(7)
    ref = jrep.lockstep_replay_sample(replay_j, key, B)
    idx = jax.random.randint(key, (B,), 0, CAP)
    out = trep.lockstep_replay_sample(replay_t, torch.from_numpy(np.array(idx)))
    for g, r in zip(out, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
