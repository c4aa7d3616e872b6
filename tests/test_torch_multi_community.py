"""Multi-community training with inter-community trading
(``envs/multi_community.py``, BASELINE config 5) against the JAX package on
the CPU.

* ``inter_community_traded_fraction`` and the conservative settlement: the
  cases of tests/test_multi_community.py's ``TestTradedFraction`` and
  ``TestConservativeSettlement``, port against the JAX functions at
  ``rtol=1e-5`` (that file's tolerance).
* A training episode of C = 4 communities of A = 3 agents (tabular, an 8-bin
  table, rounds 1 and 2, slots 36-59) against the JAX package's
  ``make_multi_community_episode_fn``, fed its key chain's draws
  (parallel/scenarios.py:941,982-985; envs/community.py:591,636;
  models/tabular.py:86-88): rewards ``rtol=2e-4`` (tests/test_golden.py:
  74-81), losses and the Q-table ``rtol=1e-3, atol=1e-4``
  (tests/test_factored_market.py:203-214), and identical decisions: the
  shared table's updated cells (each at a scenario's observation and
  action) are the same set.
* Inter-community trading never costs more than isolated communities, on
  the port's own ``train_scenarios_shared`` (tests/test_multi_community.py's
  contract, ``r_inter + 1e-5 >= r_iso``).
* ``evaluate_multi_community`` (tabular; DDPG with one actor-critic for
  every agent) over the test split of ``synthetic_traces()``: shapes, costs
  ``rtol=2e-4``, decisions equal (DDPG's within ``atol=1e-5`` of the heat
  pump's power), re-priced energy equal to matched energy; and two days
  whose residuals would match across days but not within one, where each
  day's communities trade only among themselves.
* The fused slot refuses a settlement hook.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_single_episode import jax_init_normals

from p2pmicrogrid_tpu import config as jcfg
from p2pmicrogrid_tpu.data import synthetic_traces as j_synthetic_traces
from p2pmicrogrid_tpu.data import train_validation_test_split
from p2pmicrogrid_tpu.envs import community as jcom
from p2pmicrogrid_tpu.envs import multi_community as jmc
from p2pmicrogrid_tpu.models import tabular_init as j_tabular_init
from p2pmicrogrid_tpu.parallel import scenarios as jsc
from p2pmicrogrid_tpu_torch import config as tcfg
from p2pmicrogrid_tpu_torch.convert import state_from_jax, state_to_numpy
from p2pmicrogrid_tpu_torch.data.traces import TraceSet
from p2pmicrogrid_tpu_torch.envs import community as tcom
from p2pmicrogrid_tpu_torch.envs import multi_community as tmc
from p2pmicrogrid_tpu_torch.parallel import scenarios as tsc
from p2pmicrogrid_tpu_torch.train import make_policy as t_make_policy
from p2pmicrogrid_tpu.train import make_policy as j_make_policy

C, A = 4, 3
WINDOW = slice(36, 60)
T = WINDOW.stop - WINDOW.start
BINS = dict(num_time_states=8, num_temp_states=8, num_balance_states=8, num_p2p_states=8)


def _cfg(mod, impl="tabular", bins=True, **sim):
    return mod.default_config(
        sim=mod.SimConfig(n_agents=A, n_scenarios=C, **sim),
        qlearning=mod.QLearningConfig(**(BINS if bins else {})),
        train=mod.TrainConfig(implementation=impl),
        ddpg=mod.DDPGConfig(buffer_size=16, batch_size=2, share_across_agents=True),
    )


# --- the traded fraction and the settlement ---------------------------------------


FRACTION_CASES = {
    "opposite": [[600.0, 400.0], [-500.0, -500.0]],
    "same-sign": [[600.0, 400.0], [500.0, 500.0]],
    "partial": [[1000.0], [-250.0], [0.0]],
    "zero": [[0.0, 0.0], [0.0, 0.0], [0.0, 0.0]],
    "lone": [[300.0, -100.0]],
}
FRACTION_EXPECTED = {
    "opposite": [1.0, 1.0],
    "same-sign": [0.0, 0.0],
    "partial": [125.0 / 1000.0, 125.0 / 250.0, 0.0],
    "zero": [0.0, 0.0, 0.0],
    "lone": [0.0],
}


@pytest.mark.parametrize("case", sorted(FRACTION_CASES))
def test_traded_fraction_matches_jax(case):
    p_grid = np.asarray(FRACTION_CASES[case], dtype=np.float32)
    f = tmc.inter_community_traded_fraction(torch.from_numpy(p_grid)).numpy()
    f_j = np.asarray(jmc.inter_community_traded_fraction(jnp.asarray(p_grid)))
    np.testing.assert_allclose(f, f_j, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(f, FRACTION_EXPECTED[case], atol=1e-6)
    assert np.isfinite(f).all()


def _settlement_inputs():
    """tests/test_multi_community.py's fixture: residuals [+800, -500], a
    counter-sign agent (-200) in community 0; plus a 2-day batch of it."""
    p_grid = np.array([[700.0, 300.0, -200.0], [-100.0, -300.0, -100.0]], np.float32)
    p_p2p = np.array([[0.0, 50.0, -50.0], [0.0, 0.0, 0.0]], np.float32)
    prices = [np.array([v, v], np.float32) for v in (0.15, 0.07, 0.11)]
    return p_grid, p_p2p, prices


def test_conservative_settlement_matches_jax():
    """Costs against the JAX hook; the trade-priced share of the grid energy
    equals the matched inter-community power, counter-sign agents settling
    at the plain tariff; a batch of days settles each day alone."""
    cfg_j, cfg_t = _cfg(jcfg), _cfg(tcfg)
    p_grid, p_p2p, (buy, inj, trade) = _settlement_inputs()
    cost = tmc.make_inter_community_settlement(cfg_t)(
        *(torch.from_numpy(x) for x in (p_grid, p_p2p, buy, inj, trade))
    ).numpy()
    cost_j = np.asarray(jmc.make_inter_community_settlement(cfg_j)(
        *(jnp.asarray(x) for x in (p_grid, p_p2p, buy, inj, trade))
    ))
    np.testing.assert_allclose(cost, cost_j, rtol=1e-5)
    hours = cfg_t.sim.slot_hours
    plain = (p_grid * np.where(p_grid >= 0.0, buy[:, None], inj[:, None]) + p_p2p * trade[:, None]) * hours * 1e-3
    r = p_grid.sum(axis=-1)
    matched = tmc.inter_community_traded_fraction(torch.from_numpy(p_grid)).numpy() * r
    expected = matched * (trade - np.where(r >= 0.0, buy, inj)) * hours * 1e-3
    np.testing.assert_allclose((cost - plain).sum(axis=-1), expected, rtol=1e-5)
    assert np.abs(matched).sum() > 0.0
    # Two days: the second day's market is the first's mirrored; each day's
    # costs are the day's alone.
    days = [np.stack([x, -x]) if x.ndim == 2 else np.stack([x, x]) for x in (p_grid, p_p2p, buy, inj, trade)]
    cost2 = tmc.make_inter_community_settlement(cfg_t)(*(torch.from_numpy(x) for x in days)).numpy()
    np.testing.assert_array_equal(cost2[0], cost)


# --- training -----------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _draws_program(S, A_, R, T_):
    """The JAX shared episode's draws from its key: (normals [S, 2, A],
    uniform [T, R, S, A], randint)."""

    @jax.jit
    def run(key):
        k_phys, k_scan, _ = jax.random.split(key, 3)
        normals = jax.vmap(
            lambda k: jnp.stack([jax.random.normal(kk, (A_,)) for kk in jax.random.split(k)])
        )(jax.random.split(k_phys, S))

        def one(k):
            k_mask, k_rand = jax.random.split(k)
            return jax.random.uniform(k_mask, (A_,)), jax.random.randint(k_rand, (A_,), 0, 3, dtype=jnp.int32)

        def slot(k, _):
            k, k_act, _ = jax.random.split(k, 3)
            rounds = jax.vmap(lambda rk: jax.vmap(one)(jax.random.split(rk, S)))(jax.random.split(k_act, R))
            return k, rounds

        _, (u, r) = jax.lax.scan(slot, k_scan, None, length=T_)
        return normals, u, r

    return run


def _shared_draws(key, R):
    normals, u, r = _draws_program(C, A, R, T)(key)
    to = lambda x: torch.from_numpy(np.array(x))
    return tsc.EpisodeDraws(uniform=to(u), randint=to(r).long(), normals=to(normals))


def _random_table(cfg_j, seed=4):
    ps = j_tabular_init(cfg_j.qlearning, A)
    q = np.random.default_rng(seed).standard_normal(ps.q_table.shape, dtype=np.float32)
    return ps._replace(q_table=jnp.asarray(q), epsilon=jnp.float32(0.5))


@pytest.mark.parametrize("rounds", [1, 2])
def test_multi_community_episode_matches_jax(rounds):
    """One training episode of C = 4 trading communities, shared tabular
    learner: the port's matrix negotiation (K5, K6, K4 at rounds=2: plain
    versions on the CPU) and inter-community settlement against the JAX
    package's episode."""
    cfg_j, cfg_t = _cfg(jcfg, rounds=rounds), _cfg(tcfg, rounds=rounds)
    ratings = jcom.make_ratings(cfg_j, np.random.default_rng(42))
    arrays = jsc.stack_scenario_arrays(cfg_j, jsc.make_scenario_traces(cfg_j, seed=0), ratings)
    arrays = type(arrays)(*(x[:, WINDOW] for x in arrays))
    ps0 = _random_table(cfg_j)
    q0 = np.asarray(ps0.q_table)
    key = jax.random.PRNGKey(3)
    episode_j = jmc.make_multi_community_episode_fn(cfg_j, j_make_policy(cfg_j), arrays, ratings)
    (ps_j, _), (rewards_j, losses_j) = episode_j((ps0, None), key)

    episode = tmc.make_multi_community_episode_fn(
        cfg_t, t_make_policy(cfg_t), state_from_jax(jax.tree.map(np.asarray, arrays), "cpu"), ratings
    )
    ps_t = state_from_jax(jax.tree.map(np.asarray, ps0), "cpu")
    (ps_t, _), (rewards, losses) = episode((ps_t, None), None, _shared_draws(key, rounds + 1))
    np.testing.assert_allclose(rewards.numpy(), np.asarray(rewards_j), rtol=2e-4)
    np.testing.assert_allclose(losses.numpy(), np.asarray(losses_j), rtol=1e-3, atol=1e-4)
    q, q_j = ps_t.q_table.numpy(), np.asarray(ps_j.q_table)
    np.testing.assert_array_equal(q != q0, q_j != q0)
    assert (q_j != q0).sum() > A
    np.testing.assert_allclose(q, q_j, rtol=1e-3, atol=1e-4)


def test_inter_trading_never_costs_more_than_isolated():
    """The same seed's episode with and without inter-community trading:
    the blended grid price is never worse than the tariff, so every
    community's reward is at least the isolated run's; and the two differ.
    ``episode_cb`` sees each episode's host values."""
    cfg = _cfg(tcfg, bins=False)
    ratings = tcom.make_ratings(cfg, np.random.default_rng(42))
    arrays = tsc.stack_scenario_arrays(cfg, tsc.make_scenario_traces(cfg), ratings, "cpu")
    policy = t_make_policy(cfg)
    seen = []
    run = lambda train, **kw: train(
        cfg, policy, tsc.init_shared_pol_state(cfg, "cpu"), arrays, ratings,
        torch.Generator().manual_seed(0), 1, **kw,
    )
    _, _, r_inter, _, _ = run(tmc.train_multi_community, episode_cb=lambda *a: seen.append(a[:3]))
    _, _, r_iso, _, _ = run(tsc.train_scenarios_shared)
    assert r_inter.shape == (1, C) and np.isfinite(r_inter).all()
    assert not np.allclose(r_inter, r_iso)
    assert (r_inter + 1e-5 >= r_iso).all()
    assert len(seen) == 1 and seen[0][0] == 0
    np.testing.assert_array_equal(seen[0][1], r_inter[0])


# --- evaluation ----------------------------------------------------------------------


def _port_traces(traces_j):
    return TraceSet(*(np.asarray(x) for x in traces_j))


def _eval_normals(key, D):
    """evaluate_multi_community's initial normals [D, C, 2, A]: per day
    ``k_phys, k_scan = split(k)``, per community ``split(k_phys, C)``."""
    return torch.stack([
        torch.stack([jax_init_normals(kc, A) for kc in jax.random.split(jax.random.split(k)[0], C)])
        for k in jax.random.split(key, D)
    ])


def _learner(cfg_j, cfg_t, impl):
    """The tabular random table, or the port's seeded shared DDPG in the JAX
    package's tree."""
    if impl == "tabular":
        return jax.tree.map(np.asarray, _random_table(cfg_j))
    return state_to_numpy(tsc.init_shared_pol_state(cfg_t, "cpu", torch.Generator().manual_seed(1)))


def _evaluate_both(impl, traces_j, ratings, redraw=True):
    cfg_j, cfg_t = _cfg(jcfg, impl), _cfg(tcfg, impl)
    ps_np = _learner(cfg_j, cfg_t, impl)
    key = jax.random.PRNGKey(11)
    days_j, out_j, arr_j = jmc.evaluate_multi_community(
        cfg_j, j_make_policy(cfg_j), jax.tree.map(jnp.asarray, ps_np), traces_j, ratings, key,
        redraw_profile_scales=redraw,
    )
    D = len(days_j)
    days, out, arr = tmc.evaluate_multi_community(
        cfg_t, t_make_policy(cfg_t), state_from_jax(ps_np, "cpu", cfg=cfg_t.ddpg), _port_traces(traces_j),
        ratings, normals=_eval_normals(key, D), redraw_profile_scales=redraw, device="cpu",
    )
    np.testing.assert_array_equal(days, days_j)
    assert out.cost.shape == (D, 96, C, A) and arr.load_w.shape == (D, C, 96, A)
    for g, r in zip(arr, arr_j):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6)
    if impl == "tabular":
        np.testing.assert_array_equal(out.decisions.numpy(), np.asarray(out_j.decisions))
    else:
        np.testing.assert_allclose(out.decisions.numpy(), np.asarray(out_j.decisions), rtol=0,
                                   atol=1e-5 * cfg_t.thermal.hp_max_power)
    for name in ("cost", "reward", "p_grid", "t_in"):
        np.testing.assert_allclose(getattr(out, name).numpy(), np.asarray(getattr(out_j, name)),
                                   rtol=2e-4, atol=1e-5, err_msg=name)
    return cfg_t, out, arr


@pytest.mark.parametrize("impl", ["tabular", "ddpg"])
def test_evaluate_multi_community_matches_jax(impl):
    """Greedy evaluation over the test split's days, every day's C
    communities in one [D * C, A] batch: redrawn profile scales, fresh
    states and decisions as the JAX package's vmapped days; the re-priced
    energy equals the matched energy in every (day, slot, community)."""
    _, _, test = train_validation_test_split(j_synthetic_traces())
    ratings = jcom.make_ratings(_cfg(jcfg, impl), np.random.default_rng(42))
    cfg, out, arr = _evaluate_both(impl, test, ratings)
    assert not np.allclose(arr.load_w[:, 0].numpy(), arr.load_w[:, 1].numpy())
    p_grid, buy, inj, trade = (x.numpy() for x in (out.p_grid, out.buy_price, out.injection_price, out.trade_price))
    hours = cfg.sim.slot_hours
    tariff = np.where(p_grid >= 0.0, buy[..., None], inj[..., None])
    plain = (p_grid * tariff + out.p_p2p.numpy() * trade[..., None]) * hours * 1e-3
    r = p_grid.sum(axis=-1)
    f = tmc.inter_community_traded_fraction(out.p_grid).numpy()
    expected = f * r * (trade - np.where(r >= 0.0, buy, inj)) * hours * 1e-3
    np.testing.assert_allclose((out.cost.numpy() - plain).sum(axis=-1), expected, rtol=1e-4, atol=1e-7)
    assert (f > 0).any()


def test_evaluation_matches_within_each_day():
    """Two days whose residuals would match across days but not within one
    (no PV on the first, every community's PV above its demand on the
    second): no community trades with another, as in the JAX package; a
    market over both days' communities at once would have matched them."""
    traces = j_synthetic_traces(n_days=2, start_day=11).normalized()
    day = np.asarray(traces.day)
    pv = np.where((day == day.min())[:, None], 0.0, 1.0).astype(np.float32) * np.ones_like(np.asarray(traces.pv))
    traces = traces._replace(pv=pv)
    load_r, pv_r = np.full(A, 0.7, np.float32), np.full(A, 8.0, np.float32)
    ratings = jcom.AgentRatings(
        load_rating_w=load_r * 1e3, pv_rating_w=pv_r * 1e3,
        max_in=np.maximum(load_r, pv_r) * 1.5e3, max_out=-np.maximum(load_r, pv_r) * 1.5e3,
    )
    _, out, _ = _evaluate_both("tabular", traces, ratings, redraw=False)
    r = out.p_grid.sum(dim=-1)  # [D, T, C]
    assert (r[0] > 0).all() and (r[1] < 0).all()
    assert (tmc.inter_community_traded_fraction(out.p_grid) == 0).all()
    across = out.p_grid.transpose(0, 1).flatten(1, 2)  # [T, D * C, A]
    assert (tmc.inter_community_traded_fraction(across) > 0).all()


def test_fused_refuses_settlement_hook():
    """The fused slot owns settlement: a hook is refused by the slot and by
    the shared episode function (JAX source community.py:544-548,
    scenarios.py:913-915)."""
    cfg = _cfg(tcfg)
    ratings = tcom.make_ratings(cfg, np.random.default_rng(0))
    arrays = tsc.stack_scenario_arrays(cfg, tsc.make_scenario_traces(cfg), ratings, "cpu")
    hook = tmc.make_inter_community_settlement(cfg)
    policy = t_make_policy(cfg)
    with pytest.raises(ValueError, match="settlement_hook"):
        tsc.make_shared_episode_fn(cfg, policy, arrays, ratings, settlement_hook=hook, fused=True)
    pol = tsc.init_shared_pol_state(cfg, "cpu")
    phys = tcom.init_physical(cfg, torch.zeros((C, 2, A)), (C,), "cpu")
    xs = tuple(x[:, 0] for x in arrays)
    with pytest.raises(ValueError, match="settlement_hook"):
        tcom.slot_dynamics_batched(
            cfg, policy, pol, phys, xs, None, tcom.ratings_to(ratings, "cpu"), explore=False,
            fused=True, settlement_hook=hook,
        )
    cfg_f = dataclasses.replace(cfg, sim=dataclasses.replace(cfg.sim, fused_slot=True))
    with pytest.raises(ValueError, match="settlement_hook"):
        tmc.make_multi_community_episode_fn(cfg_f, policy, arrays, ratings)
