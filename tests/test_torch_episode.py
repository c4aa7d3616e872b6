"""The slices as a whole: shared-scenario tabular training with the factored
market (rounds=1) and with the matrix negotiation (rounds=2, against the JAX
package's Pallas path), the port against the JAX package on the CPU.

Both start from identical state (``convert.state_from_jax``) and the port is
fed the JAX package's own random draws, rebuilt here from its key chain:
``parallel/scenarios.py:982-985`` (``k_phys, k_scan, k_gen``, then the
per-scenario init splits, ``envs/community.py:212-214``), ``:941`` (per-slot
``key, k_act, k_learn``), ``envs/community.py:636`` (per-round split),
``:591`` (per-scenario split) and ``models/tabular.py:86-88``
(``k_mask, k_rand``). Tolerances: episode rewards ``rtol=2e-4``
(tests/test_golden.py:74-81); losses ``rtol=1e-3, atol=1e-3`` and the final
Q-table ``rtol=1e-3, atol=1e-4`` (tests/test_factored_market.py:203-214);
every slot's tabular actions exactly equal. The episodes run slots 36-59
(``WINDOW``), where the JAX programs step a quarter of the day.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2pmicrogrid_tpu import config as jcfg
from p2pmicrogrid_tpu.envs.community import AgentRatings as JAgentRatings
from p2pmicrogrid_tpu.envs.community import init_physical as j_init_physical
from p2pmicrogrid_tpu.envs.community import make_ratings
from p2pmicrogrid_tpu.envs.community import slot_dynamics_batched as j_slot
from p2pmicrogrid_tpu.parallel import scenarios as jsc
from p2pmicrogrid_tpu.train import make_policy as j_make_policy
from p2pmicrogrid_tpu_torch import config as tcfg
from p2pmicrogrid_tpu_torch.convert import state_from_jax, state_to_numpy
from p2pmicrogrid_tpu_torch.envs import community as tcom
from p2pmicrogrid_tpu_torch.ops import matrix_market as tmm
from p2pmicrogrid_tpu_torch.parallel import scenarios as tsc
from p2pmicrogrid_tpu_torch.train import make_policy as t_make_policy

S, A, E, T = 3, 6, 2, 24
# The episodes run slots 36-59 (9:00-14:45): morning load, the PV peak and
# the battery at work, a quarter of the day the JAX programs step through.
WINDOW = slice(36, 36 + T)
# The matrix negotiation at rounds=2 through the Pallas kernels, which run in
# interpret mode on the CPU.
MATRIX = dict(rounds=2, market_impl="matrix", use_pallas=True)


def _cfg(mod, **sim):
    sim = {"n_agents": A, "n_scenarios": S, "rounds": 1, "market_impl": "factored", **sim}
    return mod.default_config(
        sim=mod.SimConfig(**sim),
        battery=mod.BatteryConfig(enabled=True),
        train=mod.TrainConfig(implementation="tabular"),
    )


def _jax_round_draws(round_key):
    """One decision pass's exploration draws, [S, A] each: the per-scenario
    split, then tabular_act's (k_mask, k_rand)."""

    def per_scenario(k):
        k_mask, k_rand = jax.random.split(k)
        return (
            jax.random.uniform(k_mask, (A,)),
            jax.random.randint(k_rand, (A,), 0, 3, dtype=jnp.int32),
        )

    return jax.vmap(per_scenario)(jax.random.split(round_key, S))


def _jax_slot_draws(k_act, R):
    """The exploration draws of one trading slot, [R, S, A] each."""
    return jax.vmap(_jax_round_draws)(jax.random.split(k_act, R))


def _jax_episode_draws(key, R):
    """(normals [S, 2, A], uniform [T, R, S, A], randint, k_phys, k_acts)."""
    k_phys, k_scan, _ = jax.random.split(key, 3)

    def init_normals(k):
        k1, k2 = jax.random.split(k)
        return jnp.stack([jax.random.normal(k1, (A,)), jax.random.normal(k2, (A,))])

    normals = jax.vmap(init_normals)(jax.random.split(k_phys, S))

    def slot(k, _):
        k, k_act, _ = jax.random.split(k, 3)
        u, r = _jax_slot_draws(k_act, R)
        return k, (u, r, k_act)

    _, (u, r, k_acts) = jax.lax.scan(slot, k_scan, None, length=T)
    return normals, u, r, k_phys, k_acts


def _to_draws(normals, u, r):
    return tsc.EpisodeDraws(
        uniform=torch.from_numpy(np.array(u)),
        randint=torch.from_numpy(np.array(r)),
        normals=torch.from_numpy(np.array(normals)),
    )


def _window(arrays):
    """Episode arrays [S, 96, ...] cut to the tests' slots ``WINDOW``."""
    return type(arrays)(*(x[:, WINDOW] for x in arrays))


def _jax_run(sim):
    """Two JAX episodes of train_scenarios_shared, their draws, and every
    slot's actions from the same slot functions."""
    cfg = _cfg(jcfg, **sim)
    ratings = make_ratings(cfg, np.random.default_rng(0))
    policy = j_make_policy(cfg)
    arrays = _window(jsc.stack_scenario_arrays(cfg, jsc.make_scenario_traces(cfg, seed=0), ratings))
    pol0, scen = jsc.init_shared_state(cfg, jax.random.PRNGKey(0))
    pol0_np = jax.tree.map(np.asarray, pol0)
    pol, _, rewards, losses, _ = jsc.train_scenarios_shared(
        cfg, policy, pol0, arrays, ratings, jax.random.PRNGKey(1),
        n_episodes=E, replay_s=scen, pipeline=False,
    )
    R = cfg.sim.rounds + 1
    keys = jsc._episode_key_schedule(jax.random.PRNGKey(1), E)

    ratings_j = JAgentRatings(*(jnp.asarray(a) for a in ratings))
    xs = tuple(jnp.swapaxes(x, 0, 1) for x in arrays)

    @jax.jit
    def episode_actions(pol_state, key):
        """One episode's draws and its slot-by-slot replay, in one program."""
        normals, u, r, k_phys, k_acts = _jax_episode_draws(key, R)
        phys = jax.vmap(lambda k: j_init_physical(cfg, k))(jax.random.split(k_phys, S))

        def body(carry, x):
            pol_state, phys = carry
            xs_t, k_act = x
            phys, _, out, tr, _ = j_slot(
                cfg, policy, pol_state, phys, xs_t, k_act, ratings_j, explore=True
            )
            pol_state, _ = jsc._tabular_update_shared(cfg, pol_state, tr, None)
            return (pol_state, phys), (tr.aux, jnp.mean(out.reward, axis=-1))

        (pol_state, _), (aux, rew) = jax.lax.scan(body, (pol_state, phys), (xs, k_acts))
        return pol_state, aux, jnp.sum(rew, axis=0), (normals, u, r)

    actions, draws, p = [], [], pol0
    for e, key in enumerate(keys):
        p, aux, rew, d = episode_actions(p, key)
        # The action replay is the same computation as the episode program.
        np.testing.assert_allclose(np.asarray(rew), rewards[e], rtol=1e-6)
        actions.append(np.asarray(aux))
        draws.append(d)
        p = policy.decay(p)
    return dict(
        ratings=ratings,
        arrays=jax.tree.map(np.asarray, arrays),
        pol0=pol0_np,
        pol=jax.tree.map(np.asarray, pol),
        rewards=rewards,
        losses=losses,
        draws=[_to_draws(*d) for d in draws],
        actions=np.stack(actions),  # [E, T, S, A]
    )


@pytest.fixture(scope="module")
def jax_run():
    return _jax_run({})


@pytest.fixture(scope="module")
def jax_run_matrix():
    """The matrix path at rounds=2 through the JAX package's Pallas kernels
    (interpret mode on the CPU)."""
    return _jax_run(MATRIX)


def test_shared_training_matches_jax(jax_run):
    _check_shared_training(jax_run, {})


def test_matrix_shared_training_matches_jax(jax_run_matrix):
    _check_shared_training(jax_run_matrix, MATRIX)


def _check_shared_training(jax_run, sim):
    cfg = _cfg(tcfg, **sim)
    pol0 = state_from_jax(jax_run["pol0"], device="cpu")
    arrays = state_from_jax(jax_run["arrays"], device="cpu")
    policy = t_make_policy(cfg)
    pol, scen, rewards, losses, seconds = tsc.train_scenarios_shared(
        cfg, policy, pol0, arrays, jax_run["ratings"], None, E, draws=jax_run["draws"]
    )
    assert scen is None and seconds > 0
    np.testing.assert_allclose(rewards, jax_run["rewards"], rtol=2e-4)
    np.testing.assert_allclose(losses, jax_run["losses"], rtol=1e-3, atol=1e-3)
    got = state_to_numpy(pol)
    np.testing.assert_allclose(got.q_table, jax_run["pol"].q_table, rtol=1e-3, atol=1e-4)
    assert got.epsilon == jax_run["pol"].epsilon  # decayed after episode 0 only


def test_every_slot_action_matches_jax(jax_run):
    _check_every_slot_action(jax_run, {})


def test_matrix_every_slot_action_matches_jax(jax_run_matrix):
    _check_every_slot_action(jax_run_matrix, MATRIX)


def _check_every_slot_action(jax_run, sim):
    cfg = _cfg(tcfg, **sim)
    policy = t_make_policy(cfg)
    pol = state_from_jax(jax_run["pol0"], device="cpu")
    arrays = state_from_jax(jax_run["arrays"], device="cpu")
    ratings = tcom.ratings_to(jax_run["ratings"], device="cpu")
    xs = [x.transpose(0, 1) for x in arrays]
    for e, d in enumerate(jax_run["draws"]):
        phys = tcom.init_physical(cfg, d.normals, (S,), device="cpu")
        for t in range(T):
            phys, _, _, tr, _ = tcom.slot_dynamics_batched(
                cfg, policy, pol, phys, tuple(x[t] for x in xs),
                (d.uniform[t], d.randint[t]), ratings, explore=True,
            )
            np.testing.assert_array_equal(
                tr.aux.numpy(), jax_run["actions"][e, t], err_msg=f"episode {e} slot {t}"
            )
            pol, _ = tsc._tabular_update_shared(cfg, pol, tr)
        pol = policy.decay(pol)


@pytest.mark.parametrize("sim", [dict(rounds=0), dict(trading=False, market_impl="auto")])
def test_single_slot_branches_match_jax(sim):
    """The rounds=0 factored branch and the no-trading branch, one slot from
    a non-zero Q-table."""
    _check_single_slot(sim)


@pytest.mark.parametrize(
    "sim",
    [
        dict(MATRIX, rounds=0),
        dict(MATRIX, rounds=1),
        dict(MATRIX, rounds=3),
        dict(MATRIX, market_dtype="bfloat16"),
    ],
    ids=["rounds0", "rounds1", "rounds3", "bf16_rounds2"],
)
def test_matrix_single_slot_matches_jax(sim):
    """The matrix branch against the JAX Pallas path, one slot: rounds=0
    clears the broadcast rank-1 matrix, rounds=1 runs K5 then K6, rounds=3
    runs K4 twice; bfloat16 storage at rounds=2 rounds each stored matrix as
    the JAX kernels do."""
    _check_single_slot(sim)


def _check_single_slot(sim):
    cfg_j, cfg_t = _cfg(jcfg, **sim), _cfg(tcfg, **sim)
    rng = np.random.default_rng(3)
    ratings = make_ratings(cfg_j, rng)
    arrays = jsc.stack_scenario_arrays(cfg_j, jsc.make_scenario_traces(cfg_j, seed=5), ratings)
    pol = jsc.init_shared_state(cfg_j, jax.random.PRNGKey(0))[0]
    pol = pol._replace(q_table=jnp.asarray(rng.normal(0, 1e-3, pol.q_table.shape), jnp.float32))
    phys = jax.vmap(lambda k: j_init_physical(cfg_j, k))(jax.random.split(jax.random.PRNGKey(2), S))
    t = 40
    xs = tuple(np.asarray(x)[:, t] for x in arrays)
    k_act = jax.random.PRNGKey(9)
    R = cfg_j.sim.rounds + 1 if cfg_j.sim.trading else 1
    ratings_j = JAgentRatings(*(jnp.asarray(a) for a in ratings))

    @jax.jit
    def run(pol, phys, xs, k_act):
        return j_slot(cfg_j, j_make_policy(cfg_j), pol, phys, xs, k_act, ratings_j, True)[:4]

    phys_j, _, out_j, tr_j = run(pol, phys, xs, k_act)
    # A no-trading slot makes one decision pass straight from the slot key.
    draws_j = _jax_slot_draws(k_act, R) if cfg_j.sim.trading else (
        tuple(d[None] for d in _jax_round_draws(k_act))
    )
    draws = tuple(torch.from_numpy(np.array(d)) for d in draws_j)
    phys_t, _, out_t, tr_t, _ = tcom.slot_dynamics_batched(
        cfg_t, t_make_policy(cfg_t),
        state_from_jax(jax.tree.map(np.asarray, pol), device="cpu"),
        state_from_jax(jax.tree.map(np.asarray, phys), device="cpu"),
        tuple(torch.from_numpy(np.array(x)) for x in xs),
        draws,
        tcom.ratings_to(ratings, device="cpu"),
        explore=True,
    )
    np.testing.assert_array_equal(tr_t.aux.numpy(), np.asarray(tr_j.aux))
    scale = float(np.abs(np.asarray(out_j.p_grid)).max())
    for name in ("p_grid", "p_p2p"):
        np.testing.assert_allclose(
            getattr(out_t, name).numpy(), np.asarray(getattr(out_j, name)),
            rtol=1e-4, atol=2e-4 * scale,
        )
    np.testing.assert_allclose(out_t.reward.numpy(), np.asarray(out_j.reward), rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(out_t.decisions.numpy(), np.asarray(out_j.decisions))
    np.testing.assert_allclose(phys_t.t_in.numpy(), np.asarray(phys_j.t_in), rtol=1e-6)


def test_generator_path_is_deterministic():
    """Draws from a seeded torch.Generator: same seed, same run; rewards are
    finite and epsilon decays once over two episodes."""
    cfg = _cfg(tcfg)
    ratings = tcom.make_ratings(cfg, np.random.default_rng(0))
    arrays = _window(tsc.stack_scenario_arrays(cfg, tsc.make_scenario_traces(cfg, seed=0), ratings, device="cpu"))
    policy = t_make_policy(cfg)

    def run():
        gen = torch.Generator(device="cpu")
        gen.manual_seed(11)
        pol, _ = tsc.init_shared_state(cfg, device="cpu")
        return tsc.train_scenarios_shared(cfg, policy, pol, arrays, ratings, gen, E)

    a, b = run(), run()
    assert np.isfinite(a[2]).all() and a[2].shape == (E, S)
    np.testing.assert_array_equal(a[2], b[2])
    assert torch.equal(a[0].q_table, b[0].q_table)
    assert float(a[0].epsilon) == pytest.approx(cfg.qlearning.epsilon * cfg.qlearning.epsilon_decay)


def test_matrix_episode_matches_jax_jnp_path(jax_run_matrix):
    """One episode at rounds=2 against the JAX package's jnp matrix path
    (``use_pallas=False``: a scan over rounds on the full matrices), at the
    Pallas-vs-jnp episode tolerance of tests/test_pallas.py:102-129."""
    sim = dict(MATRIX, use_pallas=False)
    cfg_j = _cfg(jcfg, **sim)
    ratings = make_ratings(cfg_j, np.random.default_rng(0))
    arrays = _window(jsc.stack_scenario_arrays(cfg_j, jsc.make_scenario_traces(cfg_j, seed=0), ratings))
    pol0, scen = jsc.init_shared_state(cfg_j, jax.random.PRNGKey(0))
    _, _, rewards_j, _, _ = jsc.train_scenarios_shared(
        cfg_j, j_make_policy(cfg_j), pol0, arrays, ratings, jax.random.PRNGKey(1),
        n_episodes=1, replay_s=scen, pipeline=False,
    )
    cfg = _cfg(tcfg, **MATRIX)
    _, _, rewards, _, _ = tsc.train_scenarios_shared(
        cfg, t_make_policy(cfg), state_from_jax(jax_run_matrix["pol0"], device="cpu"),
        state_from_jax(jax_run_matrix["arrays"], device="cpu"), jax_run_matrix["ratings"],
        None, 1, draws=jax_run_matrix["draws"][:1],
    )
    np.testing.assert_allclose(rewards, rewards_j, rtol=1e-4)


def test_auto_market_on_cpu_runs_the_matrix_path():
    """On the CPU ``market_impl="auto"`` resolves to the matrix negotiation
    (as the JAX package does off the TPU), which runs the plain versions of
    K5 and K6 and launches no kernel."""
    cfg = _cfg(tcfg, market_impl="auto")
    assert tcom.resolve_market_impl(cfg, "cpu") == "matrix"
    ratings = tcom.make_ratings(cfg, np.random.default_rng(0))
    arrays = _window(tsc.stack_scenario_arrays(cfg, tsc.make_scenario_traces(cfg, seed=0), ratings, device="cpu"))
    episode = tsc.make_shared_episode_fn(cfg, t_make_policy(cfg), arrays, ratings)
    before = (tmm.divide_rank1_fused.launches, tmm.clear_market_fused.launches)
    _, (rewards, losses) = episode(tsc.init_shared_state(cfg, device="cpu"), torch.Generator().manual_seed(0))
    assert rewards.shape == (S,) and torch.isfinite(rewards).all() and torch.isfinite(losses).all()
    assert (tmm.divide_rank1_fused.launches, tmm.clear_market_fused.launches) == before
