"""The scenario regime engine and the auction mechanisms: the port against
the JAX package on the CPU.

The mechanism, weather, EV and islanding cases of ``tests/test_regimes.py``
against the JAX functions at those tests' tolerances (bit for bit where
they demand it); ``regime_slot_batched`` against the jitted JAX slot at
S=4, A=3 with the JAX slot's own exploration draws injected; the regime
episode, shared and independent, against the JAX package's
``make_regime_episode_fn`` fed its own draws (rewards ``rtol=2e-4``, the
Q-tables ``rtol=1e-3, atol=1e-4``: tests/test_torch_episode.py's); the
neutral regime equal to the plain shared episode bit for bit; counters
against rewards (``rtol=1e-4``); the chunked trainer with a portfolio swap;
the portfolio trainer's and the evaluation's telemetry; every refusal; and
``evaluate_bundle_regimes`` (tabular and DQN bundles the JAX package
exported, two regimes) against the JAX function fed its held-out draws, one
learner state shared by two bundles.
Episodes run slots 36-43 (``WINDOW``), where the regimes' windows are set
to act.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2pmicrogrid_tpu import config as jcfg
from p2pmicrogrid_tpu import regimes as jreg
from p2pmicrogrid_tpu.envs.community import AgentRatings as JAgentRatings
from p2pmicrogrid_tpu.envs.community import init_physical as j_init_physical
from p2pmicrogrid_tpu.envs.community import make_ratings
from p2pmicrogrid_tpu.ops import auction as jau
from p2pmicrogrid_tpu.parallel import scenarios as jsc
from p2pmicrogrid_tpu.train import init_policy_state as j_init_policy_state
from p2pmicrogrid_tpu.train import make_policy as j_make_policy
from p2pmicrogrid_tpu_torch import config as tcfg
from p2pmicrogrid_tpu_torch import regimes as treg
from p2pmicrogrid_tpu_torch.convert import stacked_state_from_jax, stacked_state_to_numpy, state_from_jax
from p2pmicrogrid_tpu_torch.envs import community as tcom
from p2pmicrogrid_tpu_torch.envs.community import SingleEpisodeDraws
from p2pmicrogrid_tpu_torch.ops import auction as tau
from p2pmicrogrid_tpu_torch.parallel import scenarios as tsc
from p2pmicrogrid_tpu_torch.train import make_policy as t_make_policy

S, A, T = 4, 3, 8
WINDOW = slice(36, 36 + T)


def _t(x):
    return torch.from_numpy(np.array(x))


def _cfg(mod, impl="tabular", **sim):
    return mod.default_config(
        sim=mod.SimConfig(n_agents=A, n_scenarios=S, **sim),
        train=mod.TrainConfig(implementation=impl),
    )


# Regimes whose windows act inside WINDOW (slots 36-43): an outage from 38,
# a spike to 40 with the uniform price, an EV due at slot 41, winter with
# the double auction.
ACTIVE = [
    jreg.RegimeSpec(name="island", outage_start_slot=38, outage_end_slot=42),
    jreg.RegimeSpec(name="spike_uniform", spike_start_slot=36, spike_end_slot=40, spike_mult=3.0,
                    mechanism="uniform"),
    jreg.RegimeSpec(name="ev", ev_present=True, ev_arrival_slot=36, ev_deadline_slot=41,
                    ev_energy_kwh=30.0),
    jreg.RegimeSpec(name="winter_da", temp_offset_c=-8.0, pv_scale=0.6, load_scale=1.2,
                    mechanism="double_auction", auction_k=0.8),
]


def _port_specs(specs):
    return [treg.RegimeSpec(**dataclasses.asdict(s)) for s in specs]


@pytest.fixture(scope="module")
def world():
    cfg = _cfg(jcfg)
    ratings = make_ratings(cfg, np.random.default_rng(42))
    arrays = jsc.stack_scenario_arrays(cfg, jsc.make_scenario_traces(cfg, seed=0), ratings)
    arrays = type(arrays)(*(np.asarray(x)[:, WINDOW] for x in arrays))
    return cfg, ratings, arrays


# -- mechanisms --------------------------------------------------------------


BUY = np.linspace(0.08, 0.17, 7).astype(np.float32)
INJ = np.full((7,), 0.07, np.float32)


def test_symmetric_bids_reduce_bit_for_bit_to_midpoint_and_match_jax():
    d = np.full((7,), 1234.5, np.float32)
    mid = tau.p2p_price(_t(BUY), _t(INJ)).numpy()
    da = tau.double_auction_price(_t(BUY), _t(INJ), _t(d), _t(d), k=0.5).numpy()
    up = tau.uniform_clearing_price(_t(BUY), _t(INJ), _t(d), _t(d)).numpy()
    assert da.tobytes() == mid.tobytes() and up.tobytes() == mid.tobytes()
    ref = np.asarray(jau.uniform_clearing_price(BUY, INJ, d, d))
    assert up.tobytes() == ref.tobytes()


def test_mechanism_prices_match_jax():
    rng = np.random.default_rng(0)
    demand = rng.uniform(0, 5000, 7).astype(np.float32)
    supply = rng.uniform(0, 5000, 7).astype(np.float32)
    supply[0] = demand[0] = 0.0  # the empty book's 1 W floor
    for k in (0.0, 0.3, 0.8, 1.0):
        got = tau.double_auction_price(_t(BUY), _t(INJ), _t(demand), _t(supply), k=k).numpy()
        ref = np.asarray(jau.double_auction_price(BUY, INJ, demand, supply, k=k))
        np.testing.assert_array_equal(got, ref)
    lo = tau.double_auction_price(_t(BUY), _t(INJ), None, None, k=0.0).numpy()
    hi = tau.double_auction_price(_t(BUY), _t(INJ), None, None, k=1.0).numpy()
    np.testing.assert_allclose(lo, INJ, rtol=1e-6)
    np.testing.assert_allclose(hi, BUY, rtol=1e-6)
    got = tau.uniform_clearing_price(_t(BUY), _t(INJ), _t(demand), _t(supply)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jau.uniform_clearing_price(BUY, INJ, demand, supply)))
    assert np.isfinite(got).all()
    heavy_d = tau.uniform_clearing_price(_t(BUY), _t(INJ), _t(np.full(7, 3000.0, np.float32)),
                                         _t(np.full(7, 1000.0, np.float32))).numpy()
    assert (heavy_d > tau.p2p_price(_t(BUY), _t(INJ)).numpy()).all() and (heavy_d <= BUY + 1e-9).all()
    mech = np.array([0, 1, 2, 2, 1, 0, 1], np.int32)
    kk = np.full((7,), 0.8, np.float32)
    got = tau.mechanism_trade_price(_t(mech), _t(BUY), _t(INJ), _t(demand), _t(supply), _t(kk)).numpy()
    ref = np.asarray(jau.mechanism_trade_price(mech, BUY, INJ, demand, supply, kk))
    np.testing.assert_array_equal(got, ref)
    assert tau.MECHANISM_IDS == jau.MECHANISM_IDS


def test_trade_volumes():
    p = np.array([[100.0, -40.0, 0.0], [-10.0, 20.0, 30.0]], np.float32)
    d, s = tau.trade_volumes(_t(p))
    np.testing.assert_allclose(d.numpy(), [100.0, 50.0])
    np.testing.assert_allclose(s.numpy(), [40.0, 10.0])


# -- specs, weather, EV ------------------------------------------------------


def test_portfolio_tensors_match_jax():
    names = ["winter", "ev_evening", "dr_spike", "double_auction", "uniform_price"]
    pj = jreg.build_portfolio(names, 7)
    pt = treg.build_portfolio(names, 7, device="cpu")
    for field, got, ref in zip(pj.params._fields, pt.scenario_params, pj.scenario_params):
        assert got.dtype == torch.from_numpy(np.array(ref)).dtype, field
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref), err_msg=field)
    np.testing.assert_array_equal(pt.one_hot.numpy(), np.asarray(pj.one_hot))
    assert pt.names == pj.names
    assert treg.REGIME_LIBRARY.keys() == jreg.REGIME_LIBRARY.keys()
    with pytest.raises(ValueError, match="unknown regime"):
        treg.resolve_specs(["nope"])
    with pytest.raises(ValueError, match="unknown mechanism"):
        treg.RegimeSpec(mechanism="vickrey")
    with pytest.raises(ValueError, match="EV window"):
        treg.RegimeSpec(ev_arrival_slot=50, ev_deadline_slot=40)
    with pytest.raises(ValueError, match="every regime needs"):
        treg.regime_assignment(2, 3)


def test_weather_transform_matches_jax_and_neutral_is_identity(world):
    cfg, _, arrays = world
    names = ["winter", "summer", "baseline", "heatwave"]
    ref = jreg.apply_weather_regimes(arrays, jreg.build_portfolio(names, S).scenario_params)
    port = state_from_jax(arrays, device="cpu")
    got = treg.apply_weather_regimes(port, treg.build_portfolio(names, S, device="cpu").scenario_params)
    for field, g, r in zip(got._fields, got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6, err_msg=field)
    for field in ("t_out", "load_w", "pv_w", "next_load_w"):
        assert np.array_equal(getattr(got, field)[2].numpy(), getattr(port, field)[2].numpy())


def _ev_run(mod, spec, slots, dial_value, n_agents):
    """Step ev_charge_step over ``slots``: (powers, needs, misses) per slot."""
    cfg = mod.default_config(sim=mod.SimConfig(n_agents=n_agents, n_scenarios=1))
    if mod is jcfg:
        rp = jreg.build_portfolio([spec], 1).scenario_params
        need = jreg.init_ev_need(rp, n_agents)
        dial = jnp.full((1, n_agents), dial_value)
        step = lambda need, s: jreg.ev_charge_step(cfg, rp, need, jnp.asarray([s], jnp.int32), dial)
    else:
        rp = treg.build_portfolio(_port_specs([spec]), 1, device="cpu").scenario_params
        need = treg.init_ev_need(rp, n_agents)
        dial = torch.full((1, n_agents), dial_value)
        step = lambda need, s: treg.ev_charge_step(cfg, rp, need, torch.tensor([s], dtype=torch.int32), dial)
    out = []
    for s in slots:
        ev_w, need, miss = step(need, s)
        out.append(tuple(np.asarray(x, dtype=np.float32) for x in (ev_w, need, miss)))
    return cfg, [np.stack(x) for x in zip(*out)]


def test_ev_floor_guarantees_feasible_delivery():
    spec = jreg.RegimeSpec(name="ev", ev_present=True, ev_arrival_slot=72, ev_deadline_slot=96,
                           ev_energy_kwh=8.0)
    cfg, (ev_w, need, miss) = _ev_run(tcfg, spec, range(96), 0.0, 2)
    _, ref = _ev_run(jcfg, spec, range(96), 0.0, 2)
    for g, r in zip((ev_w, need, miss), ref):
        np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-3)
    assert (ev_w[:72] == 0.0).all() and (ev_w <= spec.ev_max_power_w + 1e-6).all()
    assert (miss == 0.0).all() and (need[-1] == 0.0).all()
    np.testing.assert_allclose(ev_w.sum(axis=0) * cfg.sim.dt_seconds, 8.0 * 3.6e6, rtol=1e-5)


def test_ev_infeasible_window_bills_the_miss():
    spec = jreg.RegimeSpec(name="tight", ev_present=True, ev_arrival_slot=90, ev_deadline_slot=92,
                           ev_energy_kwh=20.0)
    cfg, (ev_w, need, miss) = _ev_run(tcfg, spec, range(88, 96), 1.0, 1)
    _, ref = _ev_run(jcfg, spec, range(88, 96), 1.0, 1)
    for g, r in zip((ev_w, need, miss), ref):
        np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-3)
    feasible_ws = spec.ev_max_power_w * 2 * cfg.sim.dt_seconds
    np.testing.assert_allclose(miss.sum(), 20.0 * 3.6e6 - feasible_ws, rtol=1e-5)
    assert (need[-1] == 0.0).all()


# -- the regime slot -----------------------------------------------------------


def _jax_round_draws(round_key, n_actions):
    def per_scenario(k):
        k_mask, k_rand = jax.random.split(k)
        return jax.random.uniform(k_mask, (A,)), jax.random.randint(k_rand, (A,), 0, n_actions, dtype=jnp.int32)

    return jax.vmap(per_scenario)(jax.random.split(round_key, S))


def _jax_slot_draws(k_act, R, n_actions):
    return jax.vmap(lambda k: _jax_round_draws(k, n_actions))(jax.random.split(k_act, R))


def _random_table(cfg, seed):
    pol = jsc.init_shared_state(cfg, jax.random.PRNGKey(0))[0]
    rng = np.random.default_rng(seed)
    return pol._replace(q_table=jnp.asarray(rng.normal(0, 1e-3, pol.q_table.shape), jnp.float32))


def test_regime_slot_matches_jax(world):
    """One slot (slot 39: islanded, spiked under the uniform price, the EV
    charging toward its deadline, winter's double auction) from a random
    Q-table and mid-window EV needs."""
    cfg_j, ratings, arrays = world
    cfg_t = _cfg(tcfg)
    t = 3  # slot 39
    pol = _random_table(cfg_j, 3)
    phys = jax.vmap(lambda k: j_init_physical(cfg_j, k))(jax.random.split(jax.random.PRNGKey(2), S))
    phys = phys._replace(hp_frac=jnp.asarray(np.random.default_rng(1).uniform(0, 1, (S, A)), jnp.float32))
    rp_j = jreg.build_portfolio(ACTIVE, S, assignment=np.arange(S)).scenario_params
    ev0 = jreg.init_ev_need(rp_j, A) * 0.6
    xs = tuple(np.asarray(x)[:, t] for x in arrays)
    k_act = jax.random.PRNGKey(9)
    ratings_j = JAgentRatings(*(jnp.asarray(a) for a in ratings))

    @jax.jit
    def run(pol, phys, ev0, xs, k_act):
        return jreg.regime_slot_batched(cfg_j, j_make_policy(cfg_j), pol, phys, ev0, xs, k_act,
                                        ratings_j, rp_j, explore=True)

    phys_j, _, out_j, tr_j, _, ev_j, extras_j = run(pol, phys, ev0, xs, k_act)
    R = cfg_j.sim.rounds + 1
    draws = tuple(_t(d) for d in _jax_slot_draws(k_act, R, cfg_j.qlearning.num_actions))
    rp_t = treg.build_portfolio(_port_specs(ACTIVE), S, assignment=np.arange(S), device="cpu").scenario_params
    phys_t, _, out_t, tr_t, _, ev_t, extras_t = treg.regime_slot_batched(
        cfg_t, t_make_policy(cfg_t), state_from_jax(jax.tree.map(np.asarray, pol), device="cpu"),
        state_from_jax(jax.tree.map(np.asarray, phys), device="cpu"), _t(ev0),
        tuple(_t(x) for x in xs), draws, tcom.ratings_to(ratings, device="cpu"), rp_t, explore=True,
    )
    np.testing.assert_array_equal(tr_t.aux.numpy(), np.asarray(tr_j.aux))
    scale = float(np.abs(np.asarray(out_j.p_grid)).max()) + 1.0
    for name in ("p_grid", "p_p2p"):
        np.testing.assert_allclose(getattr(out_t, name).numpy(), np.asarray(getattr(out_j, name)),
                                   rtol=1e-4, atol=2e-4 * scale, err_msg=name)
    for name in ("cost", "reward", "buy_price", "trade_price"):
        np.testing.assert_allclose(getattr(out_t, name).numpy(), np.asarray(getattr(out_j, name)),
                                   rtol=2e-4, atol=1e-6, err_msg=name)
    for name in ("ev_power_w", "curtailed_w", "ev_miss_ws"):
        np.testing.assert_allclose(extras_t[name].numpy(), np.asarray(extras_j[name]),
                                   rtol=1e-5, atol=2e-4 * scale, err_msg=name)
    np.testing.assert_allclose(ev_t.numpy(), np.asarray(ev_j), rtol=1e-5)
    np.testing.assert_allclose(phys_t.t_in.numpy(), np.asarray(phys_j.t_in), rtol=1e-6)
    # Islanded: zero grid exchange, exactly; the spike and the miss bill.
    assert (out_t.p_grid[0] == 0.0).all()
    assert float(out_t.buy_price[1]) == pytest.approx(3.0 * float(out_t.buy_price[0]), rel=1e-6)
    assert float(extras_t["ev_miss_ws"][2].sum()) == 0.0


# -- episodes ----------------------------------------------------------------


def _jax_episode_draws(key, R, n_actions):
    """The JAX regime episode's draws (regimes/train.py:270-304: the shared
    episode's key chain): normals [S, 2, A], uniform and randint [T, R, S, A]."""
    k_phys, k_scan, _ = jax.random.split(key, 3)

    def init_normals(k):
        k1, k2 = jax.random.split(k)
        return jnp.stack([jax.random.normal(k1, (A,)), jax.random.normal(k2, (A,))])

    normals = jax.vmap(init_normals)(jax.random.split(k_phys, S))

    def slot(k, _):
        k, k_act, _ = jax.random.split(k, 3)
        return k, _jax_slot_draws(k_act, R, n_actions)

    _, (u, r) = jax.lax.scan(slot, k_scan, None, length=T)
    return tuple(np.array(x) for x in (normals, u, r))


@pytest.fixture(scope="module")
def jax_regime_episodes(world):
    """One shared and one independent JAX regime episode on ACTIVE, from a
    random table, and their draws."""
    cfg, ratings, arrays = world
    policy = j_make_policy(cfg)
    rp = jreg.build_portfolio(ACTIVE, S, assignment=np.arange(S)).scenario_params
    key = jax.random.PRNGKey(7)
    draws = _jax_episode_draws(key, cfg.sim.rounds + 1, cfg.qlearning.num_actions)
    pol = _random_table(cfg, 4)
    shared = jreg.make_regime_episode_fn(cfg, policy, ratings, rp, arrays_s=arrays)
    (pol_s, _), (rew_s, loss_s) = shared((pol, None), key)
    pol_i0 = jax.vmap(lambda k: j_init_policy_state(cfg, k))(jax.random.split(jax.random.PRNGKey(1), S))
    indep = jreg.make_regime_episode_fn(cfg, policy, ratings, rp, arrays_s=arrays, mode="independent")
    pol_i, (rew_i, loss_i) = indep(pol_i0, key)
    np_ = lambda x: jax.tree.map(np.asarray, x)
    return dict(
        draws=draws, pol0=np_(pol), pol=np_(pol_s), rewards=np.asarray(rew_s), losses=np.asarray(loss_s),
        pol_i0=np_(pol_i0), pol_i=np_(pol_i), rewards_i=np.asarray(rew_i), losses_i=np.asarray(loss_i),
    )


def _port_world(world):
    cfg_j, ratings, arrays = world
    cfg = _cfg(tcfg)
    return cfg, t_make_policy(cfg), ratings, state_from_jax(arrays, device="cpu")


def test_shared_regime_episode_matches_jax(world, jax_regime_episodes):
    cfg, policy, ratings, arrays = _port_world(world)
    jr = jax_regime_episodes
    normals, u, r = jr["draws"]
    pf = treg.build_portfolio(_port_specs(ACTIVE), S, assignment=np.arange(S), device="cpu")
    fn = treg.make_regime_episode_fn(cfg, policy, ratings, pf.scenario_params, arrays_s=arrays)
    pol = state_from_jax(jr["pol0"], device="cpu")
    (pol, _), (rewards, losses) = fn(
        (pol, None), draws=tsc.EpisodeDraws(uniform=_t(u), randint=_t(r), normals=_t(normals))
    )
    np.testing.assert_allclose(rewards.numpy(), jr["rewards"], rtol=2e-4)
    np.testing.assert_allclose(losses.numpy(), jr["losses"], rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(pol.q_table.numpy(), jr["pol"].q_table, rtol=1e-3, atol=1e-4)


def test_independent_regime_episode_matches_jax(world, jax_regime_episodes):
    cfg, policy, ratings, arrays = _port_world(world)
    jr = jax_regime_episodes
    normals, u, r = jr["draws"]
    pf = treg.build_portfolio(_port_specs(ACTIVE), S, assignment=np.arange(S), device="cpu")
    fn = treg.make_regime_episode_fn(cfg, policy, ratings, pf.scenario_params, arrays_s=arrays,
                                     mode="independent")
    pol = stacked_state_from_jax(jr["pol_i0"], device="cpu")
    lead = lambda x: _t(np.transpose(x, (2, 0, 1, 3)))  # [T, R, S, A] -> [S, T, R, A]
    pol, (rewards, losses) = fn(pol, draws=SingleEpisodeDraws(uniform=lead(u), randint=lead(r), normals=_t(normals)))
    np.testing.assert_allclose(rewards.numpy(), jr["rewards_i"], rtol=2e-4)
    np.testing.assert_allclose(losses.numpy(), jr["losses_i"], rtol=1e-3, atol=1e-3)
    got = stacked_state_to_numpy(pol, S)
    np.testing.assert_allclose(got.q_table, jr["pol_i"].q_table, rtol=1e-3, atol=1e-4)
    assert not np.array_equal(got.q_table[0], got.q_table[3])  # different worlds


@pytest.mark.parametrize("impl", ["tabular", "ddpg"])
def test_neutral_regime_equals_plain_shared_episode_bit_for_bit(world, impl):
    _, ratings, arrays_j = world
    cfg = _cfg(tcfg, impl)
    policy = t_make_policy(cfg)
    arrays = state_from_jax(arrays_j, device="cpu")
    pf = treg.build_portfolio(["baseline"], S, device="cpu")

    def run(fn):
        pol, scen = tsc.init_shared_state(cfg, "cpu", generator=torch.Generator().manual_seed(0))
        (pol, scen), ys = fn((pol, scen), torch.Generator().manual_seed(7))
        leaves = [x.clone() for x, _ in tsc.learner_leaves(pol)]
        return leaves, ys

    plain = run(tsc.make_shared_episode_fn(cfg, policy, arrays, ratings))
    regime = run(treg.make_regime_episode_fn(cfg, policy, ratings, pf.scenario_params, arrays_s=arrays))
    for a, b in zip(plain[1], regime[1]):
        assert torch.equal(a, b)
    for a, b in zip(plain[0], regime[0]):
        assert torch.equal(a, b)


def test_counters_match_rewards_and_swap_changes_the_world(world):
    _, ratings, arrays_j = world
    cfg = _cfg(tcfg)
    policy = t_make_policy(cfg)
    arrays = state_from_jax(arrays_j, device="cpu")
    pf = treg.build_portfolio(_port_specs(ACTIVE[:2]), S, device="cpu")
    fn = treg.make_regime_episode_fn(cfg, policy, ratings, pf.scenario_params, arrays_s=arrays,
                                     collect_regime_metrics=True, one_hot=pf.one_hot)
    pol, scen = tsc.init_shared_state(cfg, "cpu")
    _, (rewards, _, rc) = fn((pol, scen), torch.Generator().manual_seed(9))
    np.testing.assert_allclose(rc.reward.numpy(), rewards.numpy() @ pf.one_hot.numpy(), rtol=1e-4)
    assert float(rc.curtailed_wh[0]) > 0.0 and float(rc.curtailed_wh[1]) == 0.0
    pf_b = treg.build_portfolio(["ev_evening", "baseline"], S, device="cpu")
    assert fn.with_regimes(pf_b.scenario_params) is fn
    assert torch.equal(fn.regimes.ev_present, pf_b.scenario_params.ev_present)
    with pytest.raises(ValueError, match="S=4"):
        fn.with_regimes(treg.build_portfolio(["baseline"], 2, device="cpu").scenario_params)


def test_chunked_runner_swaps_portfolios_on_one_episode_function(world):
    """The chunked trainer (eager on the CPU) through a regime runner; a swap
    keeps the runner, and the all-baseline runner equals the plain one."""
    from p2pmicrogrid_tpu_torch.parallel.device_gen import device_episode_arrays

    _, ratings, _ = world
    cfg = _cfg(tcfg)
    policy = t_make_policy(cfg)
    rd = tcom.ratings_to(ratings, "cpu")
    pf = treg.build_portfolio(["baseline"], S, device="cpu")

    def regime_runner():
        fn = treg.make_regime_episode_fn(
            cfg, policy, ratings, pf.scenario_params,
            arrays_fn=lambda d: device_episode_arrays(cfg, rd, S, draws=d), n_scenarios=S, device="cpu",
        )
        return tsc.make_chunked_episode_runner(cfg, fn, 2, graph=False)

    def train(runner):
        pol = tsc.init_shared_pol_state(cfg, "cpu", generator=torch.Generator().manual_seed(0))
        return tsc.train_scenarios_chunked(cfg, policy, pol, ratings, 5, 1, 2, runner=runner, device="cpu")

    runner = regime_runner()
    plain = tsc.make_chunked_episode_runner(cfg, tsc.make_device_episode_fn(cfg, policy, ratings, device="cpu"), 2,
                                            graph=False)
    _, r_reg, l_reg, _ = train(runner)
    _, r_plain, l_plain, _ = train(plain)
    np.testing.assert_array_equal(r_reg, r_plain)
    np.testing.assert_array_equal(l_reg, l_plain)
    runner.episode_fn.with_regimes(
        treg.build_portfolio(["winter", "islanding_noon", "ev_evening", "uniform_price"], S,
                             device="cpu").scenario_params
    )
    _, r_swap, _, _ = train(runner)
    assert r_swap.shape == (1, 2 * S) and np.isfinite(r_swap).all()
    assert not np.array_equal(r_swap, r_reg)


def test_portfolio_trainer_and_evaluation_emit_their_events(world):
    from p2pmicrogrid_tpu_torch.telemetry.registry import MemorySink, Telemetry

    _, ratings, arrays_j = world
    cfg = _cfg(tcfg)
    policy = t_make_policy(cfg)
    arrays = state_from_jax(arrays_j, device="cpu")
    sink = MemorySink()
    tel = Telemetry(sinks=[sink])
    pf = treg.build_portfolio(["winter", "dr_spike"], S, device="cpu")
    pol, scen = tsc.init_shared_state(cfg, "cpu")
    pol, _, rewards, losses, rc_all = treg.train_regime_portfolio(
        cfg, policy, pol, scen, ratings, pf, torch.Generator().manual_seed(1), 2, arrays_s=arrays,
        telemetry=tel, device="cpu",
    )
    assert rewards.shape == (2, S) and losses.shape == (2, S) and len(rc_all) == 2
    assert [d["regime"] for d in rc_all[0]] == ["winter", "dr_spike"]
    rows = treg.evaluate_regimes(cfg, policy, pol, ratings, ["baseline", "islanding_noon"], s_per_regime=2,
                                 telemetry=tel, held_out=True, device="cpu")
    tel.close()
    kinds = [r.get("kind") or r.get("event") for r in sink.records]
    assert kinds.count("regime_counters") == 2 and kinds.count("regime_eval") == 2
    assert [r["regime"] for r in rows] == ["baseline", "islanding_noon"]
    assert rows[1]["held_out"] and rows[1]["n_scenarios"] == 2
    # The outage removes 16 slots of grid exchange; the baseline curtails nothing.
    assert rows[1]["grid_wh"] < rows[0]["grid_wh"] and rows[0]["curtailed_wh"] == 0.0
    assert all(np.isfinite(r["cost_eur"]) for r in rows)


def test_refusals(world):
    _, ratings, arrays_j = world
    cfg = _cfg(tcfg)
    policy = t_make_policy(cfg)
    arrays = state_from_jax(arrays_j, device="cpu")
    pf = treg.build_portfolio(["ev_evening", "islanding_noon"], S, device="cpu")
    rp = pf.scenario_params
    with pytest.raises(ValueError) as err:
        treg.make_regime_episode_fn(cfg, policy, ratings, rp, arrays_s=arrays, fused=True, specs=pf.specs)
    msg = str(err.value)
    assert "EV load" in msg and "islanding masks" in msg and "baseline world" in msg
    cfg_fused = _cfg(tcfg, fused_slot=True)
    pf_da = treg.build_portfolio(["double_auction"], S, device="cpu")
    with pytest.raises(ValueError, match="auction mechanism"):
        treg.make_regime_episode_fn(cfg_fused, policy, ratings, pf_da.scenario_params, arrays_s=arrays,
                                    specs=pf_da.specs)
    cfg_ddpg = _cfg(tcfg, "ddpg")
    with pytest.raises(ValueError, match="independent regime"):
        treg.make_regime_episode_fn(cfg_ddpg, t_make_policy(cfg_ddpg), ratings, rp, arrays_s=arrays,
                                    mode="independent")
    with pytest.raises(ValueError, match="mode must be"):
        treg.make_regime_episode_fn(cfg, policy, ratings, rp, arrays_s=arrays, mode="both")
    with pytest.raises(ValueError, match="record_only"):
        treg.make_regime_episode_fn(cfg, policy, ratings, rp, arrays_s=arrays, record_only=True)
    with pytest.raises(ValueError, match="exactly one"):
        treg.make_regime_episode_fn(cfg, policy, ratings, rp)
    with pytest.raises(ValueError, match="n_scenarios"):
        treg.make_regime_episode_fn(cfg, policy, ratings, rp, arrays_fn=lambda d: None)
    with pytest.raises(ValueError, match="arrays_s"):
        treg.make_regime_episode_fn(cfg, policy, ratings, rp, arrays_fn=lambda d: None, n_scenarios=S,
                                    mode="independent", device="cpu")
    with pytest.raises(ValueError, match=r"\[S\]=4"):
        treg.make_regime_episode_fn(cfg, policy, ratings, pf.params, arrays_s=arrays)
    with pytest.raises(ValueError, match="one_hot"):
        treg.make_regime_episode_fn(cfg, policy, ratings, rp, arrays_s=arrays, collect_regime_metrics=True)
    with pytest.raises(ValueError, match="settlement"):
        treg.train._RegimeSlots(rp, A, None).slot(cfg, policy, None, None, None, None, None, True, fused=True)


# -- bundle evaluation ---------------------------------------------------------


BUNDLE_REGIMES = ["baseline", "islanding_noon"]


@pytest.mark.parametrize("impl", ["tabular", "dqn"])
def test_evaluate_bundle_regimes_matches_jax(impl, tmp_path):
    """Per-regime costs of two bundles the JAX package exported, against
    its ``evaluate_bundle_regimes``: the held-out traces' draws
    (``PRNGKey(REGIME_EVAL_SEED)``) and the initial temperatures'
    (``PRNGKey(1)``) injected; costs at ``rtol=2e-4``
    (tests/test_golden.py). The second bundle is copied into the first's
    learner state in place and one evaluation serves both."""
    from test_torch_device_gen import jax_trace_arrays, trace_draws
    from test_torch_single_episode import jax_init_normals

    from p2pmicrogrid_tpu.regimes.evaluate import evaluate_bundle_regimes as j_eval_bundle
    from p2pmicrogrid_tpu.serve.export import export_policy_bundle as jax_export

    s = 2
    cfg_j, cfg_t = _cfg(jcfg, impl), _cfg(tcfg, impl)
    bundles = []
    for i in range(2):
        pol = jsc.init_shared_pol_state(cfg_j, jax.random.PRNGKey(i))
        if impl == "tabular":
            pol = _random_table(cfg_j, 7 + i)
        bundles.append(jax_export(cfg_j, pol, str(tmp_path / f"b{i}")))
    n = len(BUNDLE_REGIMES) * s
    draws = trace_draws(jax.jit(lambda k: jax_trace_arrays(k, n))(jax.random.PRNGKey(treg.REGIME_EVAL_SEED)))
    k_phys, _ = jax.random.split(jax.random.PRNGKey(1))
    normals = torch.stack([jax_init_normals(k, A) for k in jax.random.split(k_phys, n)])
    ratings = make_ratings(cfg_t, np.random.default_rng(cfg_t.train.seed))
    eval_fn = treg.make_regime_eval(cfg_t, t_make_policy(cfg_t), ratings,
                                    treg.build_portfolio(BUNDLE_REGIMES, 2, device="cpu"),
                                    s_per_regime=s, draws=draws, device="cpu")
    from p2pmicrogrid_tpu_torch.serve.export import load_policy_bundle
    from p2pmicrogrid_tpu_torch.train.continual import state_from_bundle

    manifest, params = load_policy_bundle(bundles[0])
    state = state_from_bundle(cfg_t, manifest, params, torch.Generator().manual_seed(0), device="cpu")
    held = [t.data_ptr() for t in _state_tensors(state, impl)]
    for bundle in bundles:
        ref = j_eval_bundle(cfg_j, bundle, BUNDLE_REGIMES, s_per_regime=s)
        got = treg.evaluate_bundle_regimes(cfg_t, bundle, BUNDLE_REGIMES, s_per_regime=s, eval_fn=eval_fn,
                                           pol_state=state, normals=normals, held_out=True, device="cpu")
        assert sorted(k for k in got if k != "rows") == sorted(BUNDLE_REGIMES)
        for name in BUNDLE_REGIMES:
            np.testing.assert_allclose(got[name], ref[name], rtol=2e-4, err_msg=name)
        for g, r in zip(got["rows"], ref["rows"]):
            assert g["regime"] == r["regime"] and g["held_out"] and g["n_scenarios"] == s
            np.testing.assert_allclose(g["reward"], r["reward"], rtol=2e-4)
    # The shared state holds the second bundle, in the same tensors.
    assert [t.data_ptr() for t in _state_tensors(state, impl)] == held
    assert _holds_last_bundle(state, bundles, cfg_t)


def _holds_last_bundle(state, bundles, cfg_t):
    """The shared state carries the last bundle's parameters."""
    from p2pmicrogrid_tpu_torch.serve.export import load_policy_bundle

    _, params = load_policy_bundle(bundles[-1])
    if "q_table" in params:
        return np.array_equal(state.q_table.numpy(), params["q_table"])
    return np.array_equal(state.online.Dense_0.kernel.detach().numpy(), params["Dense_0"]["kernel"])


def _state_tensors(state, impl):
    if impl == "tabular":
        return [state.q_table]
    return list(state.online.parameters()) + list(state.target.parameters())
