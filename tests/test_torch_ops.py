"""The port's slot ops and config against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and go through the jitted JAX function
and the port's function (``device="cpu"``). Tolerance ``rtol=1e-6``: XLA
contracts multiply-adds into fused multiply-adds that PyTorch rounds as two
operations, a difference of an ulp or two. Where a result cancels towards 0
the comparison adds ``atol = 1e-6 * scale`` of the cancelling operands.
Discrete bins must be exactly equal.
"""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2pmicrogrid_tpu import config as jcfg
from p2pmicrogrid_tpu.ops import battery as jbat
from p2pmicrogrid_tpu.ops import market as jmarket
from p2pmicrogrid_tpu.ops import obs as jobs
from p2pmicrogrid_tpu.ops import tariff as jtar
from p2pmicrogrid_tpu.ops import thermal as jth
from p2pmicrogrid_tpu.telemetry.registry import config_hash
from p2pmicrogrid_tpu_torch import config as tcfg
from p2pmicrogrid_tpu_torch.ops import battery as tbat
from p2pmicrogrid_tpu_torch.ops import market as tmarket
from p2pmicrogrid_tpu_torch.ops import obs as tobs
from p2pmicrogrid_tpu_torch.ops import tariff as ttar
from p2pmicrogrid_tpu_torch.ops import thermal as tth

S, A = 4, 16
RTOL = 1e-6


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(port, ref, atol=0.0):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=RTOL, atol=atol)


@pytest.fixture
def rng():
    return np.random.default_rng(7)


@pytest.mark.parametrize(
    "overrides",
    [
        {},
        dict(
            sim=dict(n_agents=1000, n_scenarios=64, market_impl="factored"),
            battery=dict(enabled=True),
        ),
    ],
)
def test_config_repr_and_hash_match(overrides):
    def build(mod):
        kw = {
            "sim": mod.SimConfig(**overrides.get("sim", {})),
            "battery": mod.BatteryConfig(**overrides.get("battery", {})),
        }
        return mod.default_config(**kw)

    jc, tc = build(jcfg), build(tcfg)
    assert repr(tc) == repr(jc)
    assert hashlib.sha256(repr(tc).encode()).hexdigest()[:12] == config_hash(jc)


def test_grid_prices_and_p2p_price(rng):
    t = rng.uniform(0.0, 1.0, (S,)).astype(np.float32)
    cfg_j, cfg_t = jcfg.TariffConfig(), tcfg.TariffConfig()
    buy_j, inj_j = jax.jit(lambda x: jtar.grid_prices(cfg_j, x))(t)
    buy_t, inj_t = ttar.grid_prices(cfg_t, _t(t))
    _close(buy_t, buy_j)
    _close(inj_t, inj_j)
    _close(ttar.p2p_price(buy_t, inj_t), jax.jit(jtar.p2p_price)(buy_j, inj_j))


def test_thermal_ops(rng):
    cfg_j, cfg_t = jcfg.ThermalConfig(), tcfg.ThermalConfig()
    t_out = rng.uniform(0.0, 15.0, (S, A)).astype(np.float32)
    t_in = rng.uniform(18.5, 23.5, (S, A)).astype(np.float32)
    t_bm = rng.uniform(18.5, 23.5, (S, A)).astype(np.float32)
    hp = (rng.integers(0, 3, (S, A)) * 1500.0).astype(np.float32)
    ref = jax.jit(lambda *a: jth.thermal_step(cfg_j, 900.0, *a))(t_out, t_in, t_bm, hp)
    got = tth.thermal_step(cfg_t, 900.0, *map(_t, (t_out, t_in, t_bm, hp)))
    for g, r in zip(got, ref):
        _close(g, r)
    _close(
        tth.normalized_temperature(cfg_t, _t(t_in)),
        jax.jit(lambda x: jth.normalized_temperature(cfg_j, x))(t_in),
        atol=RTOL * 23.5,  # (t_in - setpoint) cancels
    )
    _close(
        tth.comfort_penalty(cfg_t, _t(t_in)),
        jax.jit(lambda x: jth.comfort_penalty(cfg_j, x))(t_in),
        atol=RTOL * 23.5,
    )


def test_battery_ops(rng):
    cfg_j = jcfg.BatteryConfig(enabled=True)
    cfg_t = tcfg.BatteryConfig(enabled=True)
    soc = rng.uniform(0.0, 1.0, (S, A)).astype(np.float32)
    bal = rng.normal(0.0, 2000.0, (S, A)).astype(np.float32)
    for name in ("available_space", "available_energy"):
        ref = jax.jit(lambda s: getattr(jbat, name)(cfg_j, s))(soc)
        _close(getattr(tbat, name)(cfg_t, _t(soc)), ref, atol=RTOL * cfg_j.capacity)
    soc_j, bal_j = jax.jit(lambda s, b: jbat.battery_rule_update(cfg_j, s, b, 900.0))(
        soc, bal
    )
    soc_t, bal_t = tbat.battery_rule_update(cfg_t, _t(soc), _t(bal), 900.0)
    _close(soc_t, soc_j, atol=RTOL)
    # balance - discharge/dt + charge/dt cancels to ~0 where the battery
    # covers the whole balance.
    _close(bal_t, bal_j, atol=RTOL * float(np.abs(bal).max()))


def test_observation_and_bins(rng):
    q_j, q_t = jcfg.QLearningConfig(), tcfg.QLearningConfig()
    n = 4096
    feats = [
        rng.uniform(0.0, 1.0, n),
        rng.uniform(-2.5, 2.5, n),
        rng.uniform(-1.3, 1.3, n),
        rng.uniform(-1.3, 1.3, n),
    ]
    feats = [f.astype(np.float32) for f in feats]
    obs_j = jax.jit(jobs.make_observation)(*feats)
    obs_t = tobs.make_observation(*map(_t, feats))
    np.testing.assert_array_equal(obs_t.numpy(), np.asarray(obs_j))
    bins_j = jax.jit(lambda o: jobs.discretize(q_j, o))(obs_j)
    bins_t = tobs.discretize(q_t, obs_t)
    for b_t, b_j in zip(bins_t, bins_j):
        assert b_t.dtype == torch.int32
        np.testing.assert_array_equal(b_t.numpy(), np.asarray(b_j))
    # Every bin of every feature is reached, the clamps included.
    assert all(len(np.unique(b.numpy())) == 20 for b in bins_t)


def test_compute_costs(rng):
    p_grid = rng.normal(0.0, 3000.0, (S, A)).astype(np.float32)
    p_grid[0, :4] = 0.0  # the >= 0 branch edge
    p_p2p = rng.normal(0.0, 3000.0, (S, A)).astype(np.float32)
    buy = rng.uniform(0.07, 0.17, (S, 1)).astype(np.float32)
    inj = np.full((S, 1), 0.07, np.float32)
    trade = (0.5 * (buy + inj)).astype(np.float32)
    ref = jax.jit(lambda *a: jmarket.compute_costs(*a, 0.25))(p_grid, p_p2p, buy, inj, trade)
    got = tmarket.compute_costs(*map(_t, (p_grid, p_p2p, buy, inj, trade)), 0.25)
    # grid_cost + p2p_cost cancels between opposite-signed terms.
    scale = float(np.max(np.abs(p_grid * buy) + np.abs(p_p2p * trade))) * 0.25e-3
    _close(got, ref, atol=RTOL * scale)


def test_matrix_market_oracle(rng):
    """The plain matrix chain the factored clearing is held to: zero_diagonal,
    divide_power (with its 0/0 guard) and clear_market."""
    p2p = rng.normal(0.0, 1000.0, (S, A, A)).astype(np.float32)
    p2p[0] = np.abs(p2p[0])  # one-sided book: only buyers
    out = rng.normal(0.0, 2000.0, (S, A)).astype(np.float32)
    out[1, :3] = 0.0
    zd_j = jax.jit(jmarket.zero_diagonal)(p2p)
    zd_t = tmarket.zero_diagonal(_t(p2p))
    np.testing.assert_array_equal(zd_t.numpy(), np.asarray(zd_j))
    powers = -np.swapaxes(np.asarray(zd_j), -1, -2)
    ref = jax.jit(jmarket.divide_power)(out, powers)
    got = tmarket.divide_power(_t(out), _t(powers))
    assert torch.isfinite(got).all()
    _close(got, ref, atol=RTOL * 2000.0)
    g_j, p_j = jax.jit(jmarket.clear_market)(zd_j)
    g_t, p_t = tmarket.clear_market(zd_t)
    _close(g_t, g_j, atol=RTOL * 1000.0 * A)
    _close(p_t, p_j, atol=RTOL * 1000.0 * A)


def test_tabular_act_update_decay_match_jax(rng):
    """tabular_act on a random table (ties included: unvisited rows are all
    zero, and argmax takes the first maximum), tabular_update and
    tabular_decay, fed the JAX key's own draws."""
    from p2pmicrogrid_tpu.models import tabular as jtab
    from p2pmicrogrid_tpu_torch.models import tabular as ttab

    q_j, q_t = jcfg.QLearningConfig(), tcfg.QLearningConfig()
    n = 32
    state_j = jtab.tabular_init(q_j, n)
    table = rng.normal(0.0, 1.0, state_j.q_table.shape).astype(np.float32)
    table[: n // 2] = 0.0  # all-tied rows
    state_j = state_j._replace(q_table=jnp.asarray(table))
    state_t = ttab.TabularState(_t(table), torch.tensor(q_j.epsilon))
    obs = np.stack(
        [rng.uniform(0, 1, n), rng.uniform(-2, 2, n), rng.uniform(-1.2, 1.2, n), rng.uniform(-1.2, 1.2, n)],
        axis=-1,
    ).astype(np.float32)
    key = jax.random.PRNGKey(4)
    k_mask, k_rand = jax.random.split(key)
    uniform = jax.random.uniform(k_mask, (n,))
    rand_action = jax.random.randint(k_rand, (n,), 0, q_j.num_actions, dtype=jnp.int32)
    for explore in (True, False):
        act_j, qv_j = jax.jit(lambda s, o, k: jtab.tabular_act(q_j, s, o, k, explore))(state_j, obs, key)
        act_t, qv_t = ttab.tabular_act(q_t, state_t, _t(obs), _t(uniform), _t(rand_action), explore)
        np.testing.assert_array_equal(act_t.numpy(), np.asarray(act_j))
        np.testing.assert_array_equal(qv_t.numpy(), np.asarray(qv_j))
    reward = rng.normal(-1.0, 0.5, n).astype(np.float32)
    next_obs = obs[::-1].copy()
    new_j = jax.jit(lambda s, o, a, r, o2: jtab.tabular_update(q_j, s, o, a, r, o2))(
        state_j, obs, act_j, reward, next_obs
    )
    new_t = ttab.tabular_update(q_t, state_t, _t(obs), act_t, _t(reward), _t(next_obs))
    np.testing.assert_allclose(new_t.q_table.numpy(), np.asarray(new_j.q_table), rtol=RTOL, atol=1e-12)
    dec_j = jax.jit(lambda s: jtab.tabular_decay(q_j, s))(new_j)
    dec_t = ttab.tabular_decay(q_t, new_t)
    assert float(dec_t.epsilon) == float(dec_j.epsilon)


def test_ratings_traces_and_scenario_arrays_match_jax():
    """The host-side inputs are copies: same numbers from the same seeds."""
    from p2pmicrogrid_tpu.envs.community import make_ratings as j_ratings
    from p2pmicrogrid_tpu.parallel import scenarios as jsc
    from p2pmicrogrid_tpu_torch.envs.community import make_ratings as t_ratings
    from p2pmicrogrid_tpu_torch.parallel import scenarios as tsc

    def cfg(mod):
        return mod.default_config(sim=mod.SimConfig(n_agents=7, n_scenarios=3))

    cj, ct = cfg(jcfg), cfg(tcfg)
    rj, rt = j_ratings(cj, np.random.default_rng(5)), t_ratings(ct, np.random.default_rng(5))
    for a, b in zip(rt, rj):
        np.testing.assert_array_equal(a, b)
    aj = jsc.stack_scenario_arrays(cj, jsc.make_scenario_traces(cj, seed=2), rj)
    at = tsc.stack_scenario_arrays(ct, tsc.make_scenario_traces(ct, seed=2), rt, device="cpu")
    assert at._fields == aj._fields
    for a, b in zip(at, aj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
