"""The port's training-health surface (``train/health.py``) against the JAX
package on the CPU.

* ``classify_health`` and a ``HealthMonitor`` fed the same evaluations give
  the JAX package's verdicts, alerts and ``to_dict`` record; the record
  round-trips through ``from_dict``.
* ``make_greedy_eval`` (tabular and shared DDPG, with counters) against the
  JAX package's, the held-out scenarios' draws and the initial normals
  rebuilt from its keys (``PRNGKey(10_000)`` and ``PRNGKey(1)``): cost and
  reward at ``rtol=2e-4`` (tests/test_golden.py:74-81), integer counters
  equal.
* ``_lr_boosted_cfg``'s learning rates equal to the JAX package's.
* ``train_chunked_with_health`` with ``lr-boost`` held in the basin (shared
  DDPG, A=3, S=2, K=2, one eval an episode): the boosted runner trains every
  block, and the rewards and evaluations equal the JAX run's at
  ``rtol=2e-4``, fed the JAX chunk keys' draws (``test_torch_chunked.py``).
"""

import io

import jax
import numpy as np
import pytest
import torch
from test_torch_chunked import _cfg as chunk_cfg
from test_torch_chunked import _chunk_draws, _jax_chunk_arrays
from test_torch_device_gen import jax_trace_arrays, trace_draws
from test_torch_single_episode import jax_init_normals

from p2pmicrogrid_tpu import config as jcfg
from p2pmicrogrid_tpu.envs.community import make_ratings
from p2pmicrogrid_tpu.parallel import scenarios as jsc
from p2pmicrogrid_tpu.telemetry import dc_to_dict as j_dc_to_dict
from p2pmicrogrid_tpu.train import health as jh
from p2pmicrogrid_tpu.train import make_policy as j_make_policy
from p2pmicrogrid_tpu_torch import config as tcfg
from p2pmicrogrid_tpu_torch.convert import state_from_jax
from p2pmicrogrid_tpu_torch.telemetry import dc_to_dict
from p2pmicrogrid_tpu_torch.train import health as th
from p2pmicrogrid_tpu_torch.train import make_policy as t_make_policy

S_EVAL = 2


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --- the classifier and the monitor ---------------------------------------------

# (episode, cost, reward): untrained, healthy, slide, basin entry, basin,
# recovery, slide again.
EVALS = [(0, 3000.0, -800.0), (10, 1200.0, -120.0), (20, 600.0, -100.0), (30, -50.0, -1500.0),
         (40, 100.0, -1400.0), (50, 1300.0, -150.0), (60, 900.0, -60.0)]


def test_classify_and_monitor_match_jax():
    for _, cost, reward in EVALS:
        for initial in (3000.0, -3000.0, 500.0):
            assert th.classify_health(cost, reward, 96, initial) == jh.classify_health(cost, reward, 96, initial)
    got, ref = th.HealthMonitor(96, warn_stream=io.StringIO()), jh.HealthMonitor(96, warn_stream=io.StringIO())
    statuses = [(got.update(*e), ref.update(*e)) for e in EVALS]
    assert [a for a, _ in statuses] == [b for _, b in statuses]
    assert {"basin", "slide", "healthy"} <= {a for a, _ in statuses}
    assert got.to_dict() == ref.to_dict()
    assert got.warn_stream.getvalue() == ref.warn_stream.getvalue()
    back = th.HealthMonitor.from_dict(got.to_dict())
    assert back.to_dict() == got.to_dict() and back.in_basin == got.in_basin


def test_lr_boosted_cfg_matches_jax():
    for S in (2, 128):
        kw = lambda mod: dict(sim=mod.SimConfig(n_agents=1000, n_scenarios=S),
                              train=mod.TrainConfig(implementation="ddpg"),
                              ddpg=mod.DDPGConfig(share_across_agents=True, batch_size=4))
        got = th._lr_boosted_cfg(tcfg.default_config(**kw(tcfg)), 3.0).ddpg
        ref = jh._lr_boosted_cfg(jcfg.default_config(**kw(jcfg)), 3.0).ddpg
        assert (got.actor_lr, got.critic_lr, got.lr_auto_scale) == (ref.actor_lr, ref.critic_lr, False)


# --- the greedy evaluation -------------------------------------------------------


def _eval_inputs(A):
    """The JAX eval's held-out trace draws and initial normals, as the
    port's injected ones."""
    draws = trace_draws(jax.jit(lambda k: jax_trace_arrays(k, S_EVAL))(jax.random.PRNGKey(10_000)))
    k_phys, _ = jax.random.split(jax.random.PRNGKey(1))
    normals = torch.stack([jax_init_normals(k, A) for k in jax.random.split(k_phys, S_EVAL)])
    return draws, normals


@pytest.mark.parametrize("impl", ["tabular", "ddpg"])
def test_greedy_eval_matches_jax(impl):
    cfg_j, cfg_t = chunk_cfg(jcfg, impl), chunk_cfg(tcfg, impl)
    ratings = make_ratings(cfg_j, np.random.default_rng(0))
    pol_j = jax.jit(lambda k: jsc.init_shared_pol_state(cfg_j, k))(jax.random.PRNGKey(0))
    if impl == "tabular":  # a table that is not all ties
        q = np.random.default_rng(4).standard_normal(pol_j.q_table.shape, dtype=np.float32)
        pol_j = pol_j._replace(q_table=jax.numpy.asarray(q))
    c_j, r_j, dc_j = jh.make_greedy_eval(
        cfg_j, j_make_policy(cfg_j), ratings, s_eval=S_EVAL, collect_device_metrics=True
    )(pol_j, jax.random.PRNGKey(1))
    draws, normals = _eval_inputs(cfg_t.sim.n_agents)
    sub = cfg_t.ddpg if impl == "ddpg" else None
    fn = th.make_greedy_eval(
        cfg_t, t_make_policy(cfg_t), ratings, s_eval=S_EVAL, collect_device_metrics=True,
        draws=draws, normals=normals, device="cpu",
    )
    c, r, dc = fn(state_from_jax(jax.tree.map(np.asarray, pol_j), "cpu", cfg=sub))
    assert c.shape == r.shape == ()
    np.testing.assert_allclose(float(c), float(c_j), rtol=2e-4)
    np.testing.assert_allclose(float(r), float(r_j), rtol=2e-4)
    got, ref = dc_to_dict(dc), j_dc_to_dict(dc_j)
    for name in ("nonfinite_q", "nonfinite_loss", "comfort_violations"):
        assert got[name] == ref[name], name
    # Tabular's greedy actions equal the JAX package's: its energies are held
    # at the counters' rtol=1e-5. DDPG's actions differ within atol=1e-5
    # (tests/test_torch_ddpg.py) and its energies follow them: there they
    # are held at the eval's rtol=2e-4.
    tol = dict(rtol=1e-5, atol=0.0) if impl == "tabular" else dict(rtol=2e-4, atol=1e-3)
    for name in ("market_residual_wh", "trade_wh"):
        np.testing.assert_allclose(got[name], ref[name], err_msg=name, **tol)
    # The default held-out set is drawn on the CPU from the seed: the same
    # on every call and every device.
    a = th.make_greedy_eval(cfg_t, t_make_policy(cfg_t), ratings, s_eval=S_EVAL, device="cpu")
    b = th.make_greedy_eval(cfg_t, t_make_policy(cfg_t), ratings, s_eval=S_EVAL, device="cpu")
    pol = state_from_jax(jax.tree.map(np.asarray, pol_j), "cpu", cfg=sub)
    assert [float(x) for x in a(pol)] == [float(x) for x in b(pol)]


# --- the guarded chunked run ------------------------------------------------------


def _forced_basin(base):
    class ForcedBasin(base):
        """A monitor that stays in the basin: every block trains boosted."""

        @property
        def in_basin(self):
            return True

    return ForcedBasin(96, warn_stream=io.StringIO())


E, K = 2, 2


def test_chunked_with_health_lr_boost_matches_jax():
    cfg_j, cfg_t = chunk_cfg(jcfg, "ddpg"), chunk_cfg(tcfg, "ddpg")
    ratings = make_ratings(cfg_j, np.random.default_rng(0))
    pol_j = jax.jit(lambda k: jsc.init_shared_pol_state(cfg_j, k))(jax.random.PRNGKey(0))
    pol_np = jax.tree.map(np.asarray, pol_j)
    key = jax.random.PRNGKey(1)
    _, r_j, l_j, _, mon_j = jh.train_chunked_with_health(
        cfg_j, j_make_policy(cfg_j), pol_j, ratings, key, E, K, eval_every=1,
        mitigate="lr-boost", monitor=_forced_basin(jh.HealthMonitor), s_eval=S_EVAL,
        telemetry=None, pipeline=False,
    )
    chunk = jax.jit(lambda k: _jax_chunk_arrays(cfg_j, k))
    keys = jsc.chunk_key_schedule(key, 0, E, K)
    draws = [[_chunk_draws("ddpg", chunk(kc)) for kc in keys[e]] for e in range(E)]
    eval_draws, normals = _eval_inputs(cfg_t.sim.n_agents)
    policy = t_make_policy(cfg_t)
    greedy = th.make_greedy_eval(cfg_t, policy, ratings, s_eval=S_EVAL, draws=eval_draws,
                                 normals=normals, device="cpu")
    boosted = []
    _, r, l, secs, mon = th.train_chunked_with_health(
        cfg_t, policy, state_from_jax(pol_np, "cpu", cfg=cfg_t.ddpg), ratings, 1, E, K,
        eval_every=1, mitigate="lr-boost", monitor=_forced_basin(th.HealthMonitor),
        s_eval=S_EVAL, telemetry=None, greedy_eval=greedy, draws=draws,
        episode_cb=lambda ep, r_, l_, c: boosted.append(
            [g["lr"] for opt in (c.actor_opt, c.critic_opt) for g in opt.param_groups]
        ),
        device="cpu",
    )
    assert r.shape == (E, K * cfg_t.sim.n_scenarios) and secs > 0
    np.testing.assert_allclose(r, np.asarray(r_j), rtol=2e-4)
    np.testing.assert_allclose(l, np.asarray(l_j), rtol=1e-3)
    lrs = th._lr_boosted_cfg(cfg_t, 3.0).ddpg
    assert boosted == [[lrs.actor_lr, lrs.critic_lr]] * E
    got, ref = mon.to_dict(), mon_j.to_dict()
    assert [p["episode"] for p in got["points"]] == [p["episode"] for p in ref["points"]] == [0, 1, 2]
    for p, q in zip(got["points"], ref["points"]):
        np.testing.assert_allclose(p["greedy_cost_eur"], q["greedy_cost_eur"], rtol=2e-4)
        np.testing.assert_allclose(p["greedy_reward"], q["greedy_reward"], rtol=2e-4)
    with pytest.raises(ValueError, match="ddpg"):
        th.train_chunked_with_health(chunk_cfg(tcfg, "tabular"), None, None, None, 0, 1, 1,
                                     mitigate="lr-boost", device="cpu")
