"""The single community's episode (``envs/community.py::run_episode`` and its
slot chain, ``slot_dynamics`` as the one-scenario lift of
``slot_dynamics_batched``) against the JAX package on the CPU.

* The pinned golden episodes of tests/test_golden.py (``GOLDEN``, greedy;
  ``GOLDEN_TRAIN``, one tabular training episode with ``q_cells_changed ==
  175``) from the same seeds: the JAX package only makes the draws (the
  Q-table, the initial temperatures, the exploration draws of its key
  chain); the port runs the episode, unfused and fused.
* ``run_episode`` greedy and training against the jitted JAX
  ``run_episode`` at A=3, rounds 0, 1 and 2, and without trading, fed the
  JAX key chain's own draws (``jax_single_draws``): every slot's decisions
  equal; rewards, costs and grid powers ``rtol=2e-4``
  (tests/test_golden.py:74-81, ``atol=1e-5``, ``1e-3`` W); the final
  Q-table ``rtol=1e-3, atol=1e-4`` (tests/test_factored_market.py:203-214).
  An 8-bin Q-table, since the golden pins do not fix the bins here.
* ``with_pv_drop`` and both rule baselines against the JAX package.
* Fused against unfused single episodes (K7's plain version against the
  chain), bit-identical on the CPU for tabular, as the JAX package's
  tests/test_pallas_slot.py:198 holds its own.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_golden import GOLDEN, GOLDEN_TRAIN

from p2pmicrogrid_tpu import config as jcfg
from p2pmicrogrid_tpu.data import synthetic_traces as j_synthetic_traces
from p2pmicrogrid_tpu.envs import community as jcom
from p2pmicrogrid_tpu.train import make_policy as j_make_policy
from p2pmicrogrid_tpu_torch import config as tcfg
from p2pmicrogrid_tpu_torch.data.traces import synthetic_traces
from p2pmicrogrid_tpu_torch.envs import community as tcom
from p2pmicrogrid_tpu_torch.models.tabular import tabular_init
from p2pmicrogrid_tpu_torch.train import make_policy as t_make_policy

A = 3
BINS = dict(num_time_states=8, num_temp_states=8, num_balance_states=8, num_p2p_states=8)


def jax_single_draws(key, T, A, impl, trading=True, rounds=1, n_actions=3, batch=None, cap=None, count0=0):
    """Every draw of the JAX ``run_episode``'s key chain, as
    ``SingleEpisodeDraws`` fields: per slot ``key, k_round, k_learn =
    split(key, 3)`` (envs/community.py:805); each round's key from
    ``split(k_round, rounds + 1)`` with trading (:258), ``k_round`` itself
    without (:346); tabular/DQN split it into ``(k_mask, k_rand)``
    (models/tabular.py:88), DDPG draws its OU normals from it
    (models/ddpg.py:89); ``k_learn`` draws each agent's replay indices in
    ``[0, max(count, 1))`` of the ring after the slot's add
    (models/replay.py:206), the ring holding ``count0`` entries before the
    episode."""
    out = _draws_program(T, A, impl, trading, rounds, n_actions, batch, cap)(key, count0)
    to = lambda x: torch.from_numpy(np.array(x))
    return tcom.SingleEpisodeDraws(
        **{k: (to(v).long() if k in ("randint", "replay_idx") else to(v)) for k, v in out.items()}
    )


@functools.lru_cache(maxsize=None)
def _draws_program(T, A, impl, trading, rounds, n_actions, batch, cap):
    """``jax_single_draws``' jitted program, compiled once per shape."""
    R = rounds + 1 if trading else 1

    @jax.jit
    def run(key, count0):
        def slot(k, t):
            k, k_round, k_learn = jax.random.split(k, 3)
            rks = jax.random.split(k_round, R) if trading else k_round[None]
            out = {}
            if impl == "ddpg":
                out["ou_normals"] = jax.vmap(lambda rk: jax.random.normal(rk, (A,)))(rks)
            else:

                def one(rk):
                    k_mask, k_rand = jax.random.split(rk)
                    return (
                        jax.random.uniform(k_mask, (A,)),
                        jax.random.randint(k_rand, (A,), 0, n_actions, dtype=jnp.int32),
                    )

                out["uniform"], out["randint"] = jax.vmap(one)(rks)
            if batch is not None:
                count = jnp.minimum(count0 + t + 1, cap)
                out["replay_idx"] = jax.random.randint(k_learn, (A, batch), 0, jnp.maximum(count, 1))
            return k, out

        return jax.lax.scan(slot, key, jnp.arange(T, dtype=jnp.int32))[1]

    return run


def jax_init_normals(k_phys, A):
    """The normals of the JAX single ``init_physical`` (envs/community.py:
    216-218): ``k1, k2 = split(k_phys)``, one [A] draw each, as [2, A]."""
    k1, k2 = jax.random.split(k_phys)
    return torch.from_numpy(np.stack([np.asarray(jax.random.normal(k1, (A,))),
                                      np.asarray(jax.random.normal(k2, (A,)))]))


# --- the golden episodes -----------------------------------------------------


@functools.lru_cache(maxsize=None)
def _golden_inputs():
    cfg = tcfg.default_config(
        sim=tcfg.SimConfig(n_agents=2, rounds=1), train=tcfg.TrainConfig(implementation="tabular")
    )
    traces = synthetic_traces(n_days=1, start_day=11).normalized()
    ratings = tcom.make_ratings(cfg, np.random.default_rng(42))
    shape = tabular_init(cfg.qlearning, 2, device="cpu").q_table.shape
    q0 = np.asarray(jax.random.normal(jax.random.PRNGKey(5), shape))
    normals = jax_init_normals(jax.random.PRNGKey(0), 2)
    draws = jax_single_draws(jax.random.PRNGKey(7), 96, 2, "tabular")
    return cfg, traces, ratings, q0, normals, draws


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_port_reproduces_golden(fused):
    """GOLDEN's greedy episode and GOLDEN_TRAIN's training episode, from the
    seeds of tests/test_golden.py, to its tolerances."""
    cfg, traces, ratings, q0, normals, draws = _golden_inputs()
    np.testing.assert_allclose(ratings.max_in, GOLDEN["max_in"], rtol=1e-5)
    arrays = tcom.build_episode_arrays(cfg, traces, ratings, device="cpu")
    policy = t_make_policy(cfg)
    phys = tcom.init_physical(cfg, normals, device="cpu")

    ps = tabular_init(cfg.qlearning, 2, device="cpu")._replace(q_table=torch.from_numpy(q0.copy()))
    _, _, out = tcom.run_episode(cfg, policy, ps, phys, arrays, ratings, training=False, fused=fused)
    for name in ("cost", "p_grid", "t_in", "hp_power_w"):
        np.testing.assert_allclose(
            getattr(out, name).numpy()[:4], GOLDEN[name], rtol=2e-4, atol=1e-5, err_msg=name
        )
    np.testing.assert_allclose(out.reward.numpy()[:4], -np.asarray(GOLDEN["cost"]), rtol=2e-4, atol=1e-5)

    ps = tabular_init(cfg.qlearning, 2, device="cpu")._replace(q_table=torch.from_numpy(q0.copy()))
    _, ps2, out = tcom.run_episode(
        cfg, policy, ps, phys, arrays, ratings, training=True, draws=draws, fused=fused
    )
    delta = ps2.q_table.numpy() - q0
    np.testing.assert_allclose(
        out.reward.numpy()[:4].reshape(-1), GOLDEN_TRAIN["reward_first4"], rtol=2e-4, atol=1e-5
    )
    np.testing.assert_allclose(np.abs(delta).sum(), GOLDEN_TRAIN["q_delta_abs_sum"], rtol=1e-3)
    assert int((delta != 0).sum()) == GOLDEN_TRAIN["q_cells_changed"]


# --- run_episode against the jitted JAX run_episode -----------------------------


def _cfg(mod, **sim):
    return mod.default_config(
        sim=mod.SimConfig(n_agents=A, **sim),
        qlearning=mod.QLearningConfig(**BINS),
        train=mod.TrainConfig(implementation="tabular"),
    )


@functools.lru_cache(maxsize=None)
def _jax_arrays():
    traces = j_synthetic_traces(n_days=1, start_day=11).normalized()
    cfg = _cfg(jcfg)
    ratings = jcom.make_ratings(cfg, np.random.default_rng(3))
    return traces, ratings


def _compare_episode(sim, training):
    """One episode of both packages from one Q-table, initial state and key;
    returns the port's outputs."""
    cfg_j, cfg_t = _cfg(jcfg, **sim), _cfg(tcfg, **sim)
    traces, ratings = _jax_arrays()
    arrays_j = jcom.build_episode_arrays(cfg_j, traces, ratings)
    ps_j = jcom_tabular_state(cfg_j)
    phys_j = jcom.init_physical(cfg_j, jax.random.PRNGKey(1))
    key = jax.random.PRNGKey(2)
    policy_j = j_make_policy(cfg_j)
    run = jax.jit(
        lambda ps, phys, arrays, key: jcom.run_episode(
            cfg_j, policy_j, ps, phys, arrays, ratings, key, training=training
        )
    )
    phys_jo, ps_jo, out_j = run(ps_j, phys_j, arrays_j, key)

    arrays_t = tcom.build_episode_arrays(cfg_t, traces, ratings, device="cpu")
    ps_t = tabular_init(cfg_t.qlearning, A, device="cpu")._replace(
        q_table=torch.from_numpy(np.array(ps_j.q_table)), epsilon=torch.tensor(0.5)
    )
    phys_t = tcom.init_physical(cfg_t, jax_init_normals(jax.random.PRNGKey(1), A), device="cpu")
    draws = None
    if training:
        draws = jax_single_draws(
            key, 96, A, "tabular", trading=cfg_t.sim.trading, rounds=cfg_t.sim.rounds
        )
    phys_to, ps_to, out_t = tcom.run_episode(
        cfg_t, t_make_policy(cfg_t), ps_t, phys_t, arrays_t, ratings, training=training, draws=draws
    )
    np.testing.assert_array_equal(out_t.decisions.numpy(), np.asarray(out_j.decisions))
    for name, atol in (("reward", 1e-5), ("cost", 1e-5), ("p_grid", 1e-3), ("p_p2p", 1e-3),
                       ("t_in", 1e-5), ("q", 1e-5)):
        np.testing.assert_allclose(
            getattr(out_t, name).numpy(), np.asarray(getattr(out_j, name)), rtol=2e-4, atol=atol,
            err_msg=name,
        )
    for name in tcom.PhysState._fields:
        np.testing.assert_allclose(
            getattr(phys_to, name).numpy(), np.asarray(getattr(phys_jo, name)), rtol=2e-4, atol=1e-5
        )
    np.testing.assert_allclose(ps_to.q_table.numpy(), np.asarray(ps_jo.q_table), rtol=1e-3, atol=1e-4)
    return out_t


def jcom_tabular_state(cfg_j):
    """The JAX tabular state with a standard-normal 8-bin table from numpy,
    epsilon 0.5 (greedy and explored actions both occur)."""
    from p2pmicrogrid_tpu.models import tabular_init as j_tabular_init

    ps = j_tabular_init(cfg_j.qlearning, A)
    q = np.random.default_rng(4).standard_normal(ps.q_table.shape, dtype=np.float32)
    return ps._replace(q_table=jnp.asarray(q), epsilon=jnp.float32(0.5))


@pytest.mark.parametrize("training", [False, True], ids=["greedy", "training"])
@pytest.mark.parametrize("rounds", [0, 1, 2])
def test_run_episode_matches_jax(rounds, training):
    out = _compare_episode({"rounds": rounds}, training)
    p = out.p_p2p.numpy()
    # The episode trades: the clearing is exercised, buyers and sellers meet.
    assert (p > 0).any() and (p < 0).any()


def test_no_trading_episode_matches_jax():
    """The no-trading community: one decision pass with the round key itself,
    grid-only settlement."""
    out = _compare_episode({"trading": False}, True)
    assert out.decisions.shape == (96, 1, A)
    assert (out.p_p2p.numpy() == 0).all()


def test_with_pv_drop_matches_jax():
    cfg_j, cfg_t = _cfg(jcfg), _cfg(tcfg)
    traces, ratings = _jax_arrays()
    ref = jcom.with_pv_drop(jcom.build_episode_arrays(cfg_j, traces, ratings), 1, 40, 0.25)
    got = tcom.with_pv_drop(tcom.build_episode_arrays(cfg_t, traces, ratings, device="cpu"), 1, 40, 0.25)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert got.pv_w[39, 1] > 0 and got.next_pv_w[39, 1] == got.pv_w[40, 1]
    with pytest.raises(ValueError, match="out of range"):
        tcom.with_pv_drop(got, A, 0)


@pytest.mark.parametrize("which", ["rule", "semi_intelligent"])
def test_baselines_match_jax(which):
    cfg_j = jcfg.default_config(sim=jcfg.SimConfig(n_agents=A), battery=jcfg.BatteryConfig(enabled=True))
    cfg_t = tcfg.default_config(sim=tcfg.SimConfig(n_agents=A), battery=tcfg.BatteryConfig(enabled=True))
    traces, ratings = _jax_arrays()
    fn_j = getattr(jcom, f"{which}_baseline_episode")
    fn_t = getattr(tcom, f"{which}_baseline_episode")
    phys_j = jcom.init_physical(cfg_j, jax.random.PRNGKey(6))
    ref_phys, ref = jax.jit(lambda p, a: fn_j(cfg_j, p, a))(
        phys_j, jcom.build_episode_arrays(cfg_j, traces, ratings)
    )
    phys_t = tcom.init_physical(cfg_t, jax_init_normals(jax.random.PRNGKey(6), A), device="cpu")
    got_phys, got = fn_t(cfg_t, phys_t, tcom.build_episode_arrays(cfg_t, traces, ratings, device="cpu"))
    np.testing.assert_array_equal(got.hp_power_w.numpy(), np.asarray(ref.hp_power_w))
    for name in ("reward", "cost", "t_in", "p_grid"):
        np.testing.assert_allclose(
            getattr(got, name).numpy(), np.asarray(getattr(ref, name)), rtol=2e-4, atol=1e-5,
            err_msg=name,
        )
    np.testing.assert_allclose(got_phys.soc.numpy(), np.asarray(ref_phys.soc), rtol=2e-4, atol=1e-6)
    assert (got.hp_power_w.numpy() > 0).any()


@pytest.mark.parametrize("rounds", [0, 1, 2])
def test_fused_single_episode_bit_identical(rounds):
    """run_episode(fused=True), K7's plain version at [1, A], equals the
    unfused chain bit for bit on the CPU: a training episode with the
    battery on, every output and the final state and Q-table."""
    cfg = tcfg.default_config(
        sim=tcfg.SimConfig(n_agents=A, rounds=rounds),
        battery=tcfg.BatteryConfig(enabled=True),
        qlearning=tcfg.QLearningConfig(**BINS),
        train=tcfg.TrainConfig(implementation="tabular"),
    )
    traces, ratings = _jax_arrays()
    arrays = tcom.build_episode_arrays(cfg, traces, ratings, device="cpu")
    q0 = torch.randn(tabular_init(cfg.qlearning, A, "cpu").q_table.shape, generator=torch.Generator().manual_seed(1))
    runs = []
    for fused in (False, True):
        ps = tabular_init(cfg.qlearning, A, "cpu")._replace(q_table=q0.clone(), epsilon=torch.tensor(0.3))
        phys = tcom.init_physical(cfg, torch.randn((2, A), generator=torch.Generator().manual_seed(2)), device="cpu")
        runs.append(tcom.run_episode(
            cfg, t_make_policy(cfg), ps, phys, arrays, ratings, torch.Generator().manual_seed(3),
            training=True, fused=fused,
        ))
    (phys_u, ps_u, out_u), (phys_f, ps_f, out_f) = runs
    for a, b in zip((*out_u, *phys_u, ps_u.q_table), (*out_f, *phys_f, ps_f.q_table)):
        assert torch.equal(a, b)
    assert (out_u.p_p2p != 0).any()


def test_fused_refuses_ddpg():
    cfg = tcfg.default_config(sim=tcfg.SimConfig(n_agents=A), train=tcfg.TrainConfig(implementation="ddpg"))
    traces, ratings = _jax_arrays()
    arrays = tcom.build_episode_arrays(cfg, traces, ratings, device="cpu")
    phys = tcom.init_physical(cfg, torch.zeros((2, A)), device="cpu")
    with pytest.raises(ValueError, match="tabular/dqn"):
        tcom.run_episode(cfg, t_make_policy(cfg), None, phys, arrays, ratings, training=False, fused=True)
