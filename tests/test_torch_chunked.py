"""The port's chunked aggregate-scenario trainer (``parallel/scenarios.py::
train_scenarios_chunked``) against the JAX package's on the CPU, and the
contracts of ``tests/test_chunked.py`` restated on the port.

The JAX side runs ``train_scenarios_chunked`` (one episode, K=2 chunks of
S=2 scenarios, A=3) from ``chunk_key_schedule``; the port is fed the same
chunks' draws, rebuilt from each chunk key as the JAX package splits it
(parallel/scenarios.py:1170-1185: ``k_scen, k_ep``, DDPG's OU normals from
``k_scen``; :982-985: ``k_phys, k_scan, k_gen``; device_gen.py:44-46 the
traces from ``k_gen``; :941 per slot ``key, k_act, k_learn``; the act's and
the learn step's draws as ``tests/test_torch_episode.py`` and
``tests/test_torch_ddpg.py`` rebuild them). Tolerances: rewards
``rtol=2e-4`` (tests/test_golden.py:74-81); the Q-table ``rtol=1e-3,
atol=1e-4`` (tests/test_torch_episode.py); DDPG's networks and targets
``rtol=1e-4, atol=1e-6`` with the rule for Adam's first steps near eps of
``tests/test_torch_ddpg.py``, Adam's counts equal in value and dtype.

The DDPG case runs without batteries: where batteries cover the balance,
XLA's fused battery arithmetic leaves a ~1e-5 W residue where the port has
0 (ROADMAP.md, Queue 3), which Adam amplifies over a day of steps.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2pmicrogrid_tpu import config as jcfg
from p2pmicrogrid_tpu.envs.community import make_ratings
from p2pmicrogrid_tpu.parallel import scenarios as jsc
from p2pmicrogrid_tpu.train import make_policy as j_make_policy
from p2pmicrogrid_tpu_torch import config as tcfg
from p2pmicrogrid_tpu_torch.convert import state_from_jax, state_to_numpy
from p2pmicrogrid_tpu_torch.parallel import scenarios as tsc
from p2pmicrogrid_tpu_torch.train import make_policy as t_make_policy
from test_torch_device_gen import jax_trace_arrays, trace_draws

S, A, K, T = 2, 3, 2, 96
CAP = 32


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's side runs thousands of tiny CPU ops, which PyTorch's
    thread pool slows down when test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(mod, impl, **kw):
    """A=3, S=2 on the factored market; the Q-table at 8 bins a feature (the
    JAX program copies its table every slot: at the default 20 bins a day
    of slots costs it a second)."""
    q = dict(num_time_states=8, num_temp_states=8, num_balance_states=8, num_p2p_states=8)
    return mod.default_config(
        sim=mod.SimConfig(n_agents=A, n_scenarios=S, market_impl="factored"),
        train=mod.TrainConfig(implementation=impl),
        qlearning=mod.QLearningConfig(**q),
        ddpg=mod.DDPGConfig(buffer_size=CAP, batch_size=2, share_across_agents=True),
        **kw,
    )


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _jax_chunk_arrays(cfg, kc):
    """One chunk's draws from its JAX key (traceable under ``jax.jit``):
    (initial normals, the slots' draws, DDPG's initial OU normals, the
    trace draws)."""
    impl = cfg.train.implementation
    R = cfg.sim.rounds + 1
    k_scen, k_ep = jax.random.split(kc)
    k_phys, k_scan, k_gen = jax.random.split(k_ep, 3)

    def init_normals(k):
        k1, k2 = jax.random.split(k)
        return jnp.stack([jax.random.normal(k1, (A,)), jax.random.normal(k2, (A,))])

    def round_draws(round_key):
        def per_scenario(k):
            k_mask, k_rand = jax.random.split(k)
            return (
                jax.random.uniform(k_mask, (A,)),
                jax.random.randint(k_rand, (A,), 0, 3, dtype=jnp.int32),
            )

        return jax.vmap(per_scenario)(jax.random.split(round_key, S))

    def slot(carry, _):
        key, t = carry
        key, k_act, k_learn = jax.random.split(key, 3)
        rounds = jax.random.split(k_act, R)
        if impl == "tabular":
            return (key, t + 1), jax.vmap(round_draws)(rounds)
        ou = jax.vmap(lambda kr: jax.random.normal(kr, (S, A)))(rounds)
        # The sample is drawn from the ring after this slot's add.
        hi = jnp.maximum(jnp.minimum(t + 1, CAP), 1)
        return (key, t + 1), (ou, jax.random.randint(k_learn, (cfg.ddpg.batch_size,), 0, hi))

    _, slots = jax.lax.scan(slot, (k_scan, 0), None, length=T)
    normals = jax.vmap(init_normals)(jax.random.split(k_phys, S))
    ou_init = jax.random.normal(k_scen, (S, A)) if impl == "ddpg" else None
    return normals, slots, ou_init, jax_trace_arrays(k_gen, S)


def _chunk_draws(impl, arrays):
    """The port's ``ChunkDraws`` of ``_jax_chunk_arrays``' result."""
    normals, slots, ou_init, traces = arrays
    if impl == "tabular":
        episode = tsc.EpisodeDraws(uniform=_t(slots[0]), randint=_t(slots[1]), normals=_t(normals))
    else:
        episode = tsc.EpisodeDraws(
            uniform=None, randint=None, normals=_t(normals), replay_idx=_t(slots[1]),
            ou_normals=_t(slots[0]),
        )
    return tsc.ChunkDraws(_t(ou_init), (), episode._replace(traces=trace_draws(traces)))


@functools.lru_cache(maxsize=None)
def _jax_run(impl):
    """One JAX chunked episode (K=2) from its own initial state and key, and
    every chunk's draws."""
    cfg = _cfg(jcfg, impl)
    ratings = make_ratings(cfg, np.random.default_rng(0))
    # One program for the initial state (flax's init runs op by op otherwise).
    pol0 = jax.jit(lambda k: jsc.init_shared_pol_state(cfg, k))(jax.random.PRNGKey(0))
    pol0_np = jax.tree.map(np.asarray, pol0)
    key = jax.random.PRNGKey(1)
    pol, rewards, losses, _ = jsc.train_scenarios_chunked(
        cfg, j_make_policy(cfg), pol0, ratings, key, n_episodes=1, n_chunks=K, pipeline=False
    )
    keys = jsc.chunk_key_schedule(key, 0, 1, K)[0]
    chunk = jax.jit(lambda k: _jax_chunk_arrays(cfg, k))
    draws = [_chunk_draws(impl, chunk(kc)) for kc in keys]
    return dict(
        ratings=ratings, pol0=pol0_np, pol=jax.tree.map(np.asarray, pol),
        rewards=np.asarray(rewards), losses=np.asarray(losses), draws=draws,
    )


@pytest.fixture(scope="module")
def jax_tabular():
    return _jax_run("tabular")


@pytest.fixture(scope="module")
def jax_ddpg():
    return _jax_run("ddpg")


def _port_run(run, impl):
    cfg = _cfg(tcfg, impl)
    sub = cfg.ddpg if impl == "ddpg" else None
    pol0 = state_from_jax(run["pol0"], device="cpu", cfg=sub)
    return cfg, tsc.train_scenarios_chunked(
        cfg, t_make_policy(cfg), pol0, run["ratings"], 0, 1, K, draws=[run["draws"]], device="cpu"
    )


def test_tabular_chunked_matches_jax(jax_tabular):
    _, (pol, rewards, losses, seconds) = _port_run(jax_tabular, "tabular")
    assert rewards.shape == (1, K * S) and seconds > 0
    np.testing.assert_allclose(rewards, jax_tabular["rewards"], rtol=2e-4)
    np.testing.assert_allclose(losses, jax_tabular["losses"], rtol=1e-3, atol=1e-3)
    ref = jax_tabular["pol"]
    np.testing.assert_allclose(pol.q_table.numpy(), ref.q_table, rtol=1e-3, atol=1e-4)
    assert float(pol.epsilon) == float(ref.epsilon)


# Adam's eps: where a gradient entry is within two orders of it, a weight's
# step has a slope of up to lr / (4 * eps) in the gradient (tests/test_torch_ddpg.py).
ADAM_EPS = 1e-8


def test_ddpg_chunked_matches_jax(jax_ddpg):
    cfg, (pol, rewards, losses, _) = _port_run(jax_ddpg, "ddpg")
    np.testing.assert_allclose(rewards, jax_ddpg["rewards"], rtol=2e-4)
    np.testing.assert_allclose(losses, jax_ddpg["losses"], rtol=1e-3)
    got, ref = state_to_numpy(pol), jax_ddpg["pol"]
    lrs = tsc.auto_scale_ddpg_lrs(cfg, S).ddpg
    for name, lr in (("actor", lrs.actor_lr), ("critic", lrs.critic_lr)):
        adam = getattr(ref, f"{name}_opt")[0]
        mine = getattr(got, f"{name}_opt")[0]
        assert mine.count.dtype == adam.count.dtype and mine.count.shape == adam.count.shape
        np.testing.assert_array_equal(mine.count, adam.count)
        t = int(adam.count)
        for g, r, mu in zip(
            jax.tree.leaves(getattr(got, name)), jax.tree.leaves(getattr(ref, name)), jax.tree.leaves(adam.mu)
        ):
            ill = np.abs(mu) / (1.0 - 0.9**t) < 100 * ADAM_EPS
            np.testing.assert_allclose(g[~ill], r[~ill], rtol=1e-4, atol=1e-6, err_msg=name)
            np.testing.assert_allclose(g[ill], r[ill], rtol=0, atol=1e-2 * lr, err_msg=name)
        for g, r in zip(jax.tree.leaves(getattr(got, f"{name}_target")), jax.tree.leaves(getattr(ref, f"{name}_target"))):
            np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-6, err_msg=f"{name}_target")
    assert got.noise_scale == ref.noise_scale


# --- the contracts of tests/test_chunked.py, on the port alone ---------------


def _train(impl, n_chunks, seed=7, chunk_seed_fn=None, **kw):
    cfg = _cfg(tcfg, impl, **kw)
    ratings = make_ratings(cfg, np.random.default_rng(0))
    pol0 = tsc.init_shared_pol_state(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    before = state_to_numpy(pol0)
    pol, rewards, losses, _ = tsc.train_scenarios_chunked(
        cfg, t_make_policy(cfg), pol0, ratings, seed, 1, n_chunks,
        chunk_seed_fn=chunk_seed_fn, device="cpu",
    )
    return before, state_to_numpy(pol), rewards, losses


def _flat(tree):
    return np.concatenate([np.asarray(x, np.float64).ravel() for x in jax.tree.leaves(tree)])


def test_identical_chunks_average_to_single_chunk():
    """theta0 + mean_c(theta_c - theta0) over identical chunks is the
    one-chunk result (tests/test_chunked.py:107)."""
    same = lambda seed, episode, chunk: seed + episode
    _, one, r1, _ = _train("tabular", 1, chunk_seed_fn=same)
    _, many, r3, _ = _train("tabular", 3, chunk_seed_fn=same)
    for a, b in zip(jax.tree.leaves(one), jax.tree.leaves(many)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(np.tile(r1, (1, 3)), r3)


def test_distinct_chunks_differ_from_single_chunk():
    """tests/test_chunked.py:134; the seed schedule gives every (episode,
    chunk) its own seed, the same on every call."""
    _, one, _, _ = _train("tabular", 1)
    _, many, rewards, _ = _train("tabular", 2)
    assert not np.allclose(_flat(one), _flat(many))
    assert len(set(rewards[0].tolist())) == rewards.shape[1]
    seeds = tsc.chunk_seed_schedule(7, 2, 3, 4)
    assert seeds.shape == (3, 4) and seeds.dtype == np.int64 and (seeds >= 0).all()
    assert len(set(seeds.ravel().tolist())) == 12
    np.testing.assert_array_equal(seeds, tsc.chunk_seed_schedule(7, 2, 3, 4))
    np.testing.assert_array_equal(seeds[1:], tsc.chunk_seed_schedule(7, 3, 2, 4))


def test_ddpg_adam_count_preserved():
    """Delta averaging keeps Adam's integer step counts: their dtype and
    shape, and the value, one step a slot (tests/test_chunked.py:197)."""
    before, after, _, _ = _train("ddpg", 2)
    for field in ("actor_opt", "critic_opt"):
        b, a = getattr(before, field)[0].count, getattr(after, field)[0].count
        assert a.dtype == b.dtype == np.int32 and a.shape == b.shape == ()
        assert int(a) == int(b) + T
    for x, y in zip(jax.tree.leaves(before), jax.tree.leaves(after)):
        assert np.asarray(x).dtype == np.asarray(y).dtype


def test_dqn_warmup_changes_training_and_stays_finite():
    """Each DQN chunk warms its fresh replay with record-only passes
    (tests/test_chunked.py:537); an unwarmed runner from the same seeds
    trains to other parameters."""
    dqn = dict(dqn=tcfg.DQNConfig(buffer_size=16, batch_size=2, warmup_passes=1))
    _, warmed, _, losses = _train("dqn", 1, **dqn)
    assert np.isfinite(losses).all() and np.isfinite(_flat(warmed)).all()
    cfg = _cfg(tcfg, "dqn", **dqn)
    policy = t_make_policy(cfg)
    ratings = make_ratings(cfg, np.random.default_rng(0))
    episode_fn = tsc.make_device_episode_fn(cfg, policy, ratings, device="cpu")
    pol0 = tsc.init_shared_pol_state(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    runner = tsc.make_chunked_episode_runner(cfg, episode_fn, 1)
    unwarmed, _, _, _ = tsc.train_scenarios_chunked(cfg, policy, pol0, ratings, 7, 1, 1, runner=runner)
    assert not np.allclose(_flat(warmed), _flat(state_to_numpy(unwarmed)))


def test_chunk_parallel_is_not_ported():
    cfg = _cfg(tcfg, "tabular")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tsc.train_scenarios_chunked(cfg, t_make_policy(cfg), None, None, 0, 1, 4, chunk_parallel=2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tsc.make_chunked_episode_runner(cfg, None, 4, chunk_parallel=2)


def test_graph_needs_the_card():
    """A CUDA graph of a CPU episode is refused, not run eagerly."""
    cfg = _cfg(tcfg, "tabular")
    ratings = make_ratings(cfg, np.random.default_rng(0))
    episode_fn = tsc.make_device_episode_fn(cfg, t_make_policy(cfg), ratings, device="cpu")
    with pytest.raises(ValueError, match="CUDA graph"):
        tsc.make_chunked_episode_runner(cfg, episode_fn, 2, graph=True)
