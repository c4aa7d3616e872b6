"""The fused slot (``ops/slot_fused.py``, kernel K7's plain version on the
CPU) against the JAX package.

* One slot against the JAX ``slot_step_fused`` in Pallas interpret mode, for
  tabular and DQN, the factored clearing at rounds 0 and 1, the matrix
  negotiation at rounds 2, no trading, and a greedy slot; battery on.
  Decisions and actions equal; continuous outputs ``rtol=1e-5, atol=1e-3``
  (the JAX fused kernel's own contract, tests/test_pallas.py:55-98).
* Whole fused episodes against the JAX package's unfused chain (which
  tests/test_pallas_slot.py holds to the fused kernel): tabular, and DQN
  after one warmup pass, two episodes of T slots each, fed the JAX key
  chain's own draws (exploration, initial temperatures and replay indices).
  Every slot's actions equal, episode rewards ``rtol=2e-4``
  (tests/test_golden.py:74-81), the final Q-table or online parameters
  ``rtol=1e-4``.

Both run in daylight with full batteries: the PV surplus that a full battery
cannot store is sold, so buyers and sellers meet, agents trade peer to peer
and the balance observation is not zero. Each test asserts that before it
compares.
* The matrix-free negotiation of kernel K7: each entry of every round's
  proposal matrix, computed by the pair chain from per-agent vectors alone,
  equals the plain version's materialized rounds bit for bit, and its
  clearing agrees with ``clear_market``.
* ``resolve_use_fused``: off by default, DDPG refused.
"""

import functools

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
from p2pmicrogrid_tpu_torch.parallel import scenarios as tsc
from p2pmicrogrid_tpu_torch.train import make_policy as t_make_policy

S, A, T, B = 4, 6, 8, 4
# The episodes' first slot (11:00) and the slot (15:00): every agent's PV
# exceeds its load, and the heat pump's choice decides who buys and who sells.
MIDDAY, AFTERNOON = 44, 60


def _cfg(mod, impl, **sim):
    sim = {"n_agents": A, "n_scenarios": S, **sim}
    return mod.default_config(
        sim=mod.SimConfig(**sim),
        # Batteries start full (max_soc), so the surplus is sold.
        battery=mod.BatteryConfig(enabled=True, init_soc=0.9),
        train=mod.TrainConfig(implementation=impl),
        # One warmup pass (a cut of depth), and epsilon 0.5 so that greedy
        # DQN actions occur from the first episode.
        dqn=mod.DQNConfig(warmup_passes=1, batch_size=B, epsilon=0.5),
    )


def _round_draws(round_key):
    """One decision pass's draws [S, A]: the per-scenario split, then the
    act's (k_mask, k_rand); the random-action bound is 3 for both learners."""

    def per_scenario(k):
        k_mask, k_rand = jax.random.split(k)
        return (
            jax.random.uniform(k_mask, (A,)),
            jax.random.randint(k_rand, (A,), 0, 3, dtype=jnp.int32),
        )

    return jax.vmap(per_scenario)(jax.random.split(round_key, S))


def _slot_draws(k_act, R, trading):
    """[R, S, A] each: one key per round when trading, the slot key itself
    for the single pass without trading (pallas_slot.py::_chain_explore_draws)."""
    if not trading:
        return tuple(d[None] for d in _round_draws(k_act))
    return jax.vmap(_round_draws)(jax.random.split(k_act, R))


def _t(x):
    return torch.from_numpy(np.array(x))


def _assert_two_sided(p_p2p, min_share):
    """Buyers and sellers both trade peer to peer, and at least
    ``min_share`` of the agents do."""
    p = np.asarray(p_p2p)
    assert (p > 0).any() and (p < 0).any(), "a one-sided market: nothing to compare"
    assert (p != 0).mean() >= min_share, f"only {(p != 0).mean():.3f} of the agents trade"


@functools.lru_cache(maxsize=None)
def _jax_state(impl):
    """The JAX package's initial shared state from ``PRNGKey(0)``, one
    program per learner (flax's init runs op by op otherwise); the market
    settings of the cases do not enter it."""
    cfg = _cfg(jcfg, impl)
    return jax.jit(lambda k: jsc.init_shared_state(cfg, k))(jax.random.PRNGKey(0))


SLOT_CASES = [
    pytest.param("tabular", dict(market_impl="factored"), True, id="tabular-factored-r1"),
    pytest.param("tabular", dict(market_impl="factored", rounds=0), True, id="tabular-factored-r0"),
    pytest.param("tabular", dict(market_impl="matrix", rounds=2), True, id="tabular-matrix-r2"),
    pytest.param("dqn", dict(market_impl="factored"), True, id="dqn-factored-r1"),
    pytest.param("dqn", dict(market_impl="matrix", rounds=2), False, id="dqn-matrix-r2-greedy"),
    pytest.param("dqn", dict(trading=False), True, id="dqn-no-trading"),
]


@pytest.mark.parametrize("impl,sim,explore", SLOT_CASES)
def test_fused_slot_matches_jax_fused(impl, sim, explore):
    cfg_j, cfg_t = _cfg(jcfg, impl, **sim), _cfg(tcfg, impl, **sim)
    rng = np.random.default_rng(5)
    ratings = make_ratings(cfg_j, np.random.default_rng(42))
    arrays = jsc.stack_scenario_arrays(cfg_j, jsc.make_scenario_traces(cfg_j, seed=0), ratings)
    pol = _jax_state(impl)[0]
    if impl == "tabular":
        q = rng.standard_normal(pol.q_table.shape).astype(np.float32) * 0.1
        pol = pol._replace(q_table=jnp.asarray(q))
    pol = pol._replace(epsilon=jnp.float32(0.3))
    phys = jax.vmap(lambda k: j_init_physical(cfg_j, k))(jax.random.split(jax.random.PRNGKey(1), S))
    xs = tuple(np.asarray(x)[:, AFTERNOON] for x in arrays)
    key = jax.random.PRNGKey(3)
    ratings_j = JAgentRatings(*(jnp.asarray(a) for a in ratings))

    @jax.jit
    def fused(pol, phys, xs, key):
        return j_slot(
            cfg_j, j_make_policy(cfg_j), pol, phys, xs, key, ratings_j, explore, fused=True
        )[:4]

    phys_j, _, out_j, tr_j = fused(pol, phys, xs, key)
    R = cfg_j.sim.rounds + 1 if cfg_j.sim.trading else 1
    draws = tuple(_t(d) for d in _slot_draws(key, R, cfg_j.sim.trading))
    pol_t = state_from_jax(jax.tree.map(np.asarray, pol), device="cpu", cfg=cfg_t.dqn)
    phys_t, _, out_t, tr_t, _ = tcom.slot_dynamics_batched(
        cfg_t, t_make_policy(cfg_t), pol_t,
        state_from_jax(jax.tree.map(np.asarray, phys), device="cpu"),
        tuple(_t(x) for x in xs), draws, tcom.ratings_to(ratings, device="cpu"),
        explore, fused=True,
    )
    if cfg_j.sim.trading:
        _assert_two_sided(out_j.p_p2p, 0.1)
    assert (np.abs(np.asarray(tr_j.obs)[..., 2]) > 1e-3).any()  # the balance feature
    np.testing.assert_array_equal(tr_t.aux.numpy(), np.asarray(tr_j.aux))
    np.testing.assert_array_equal(out_t.decisions.numpy(), np.asarray(out_j.decisions))
    np.testing.assert_array_equal(phys_t.hp_frac.numpy(), np.asarray(phys_j.hp_frac))
    pairs = [(phys_t, phys_j, ("t_in", "t_bm", "soc")),
             (out_t, out_j, ("cost", "reward", "p_grid", "p_p2p", "q", "hp_power_w", "buy_price")),
             (tr_t, tr_j, ("obs", "reward", "next_obs"))]
    for got, ref, names in pairs:
        for name in names:
            np.testing.assert_allclose(
                getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                rtol=1e-5, atol=1e-3, err_msg=name,
            )


def _jax_episode_draws(cfg, arrays, ratings_j, learn):
    """One JAX episode of the unfused chain, replayed slot by slot with the
    episode program's key chain (parallel/scenarios.py:941,982-985), as a
    function ``(pol, scen, key) -> (pol, scen, draws, actions, (p_p2p,
    balance feature), episode reward)`` jitted once for every episode it
    replays: the draws as the port's ``EpisodeDraws``, every slot's actions,
    p_p2p and balance feature. ``learn`` is the update: tabular, DQN, or the
    DQN warmup's record-only add."""
    policy = j_make_policy(cfg)
    R = cfg.sim.rounds + 1
    xs = tuple(jnp.swapaxes(x, 0, 1) for x in arrays)

    @jax.jit
    def run(pol, scen, key):
        k_phys, k_scan, _ = jax.random.split(key, 3)

        def init_normals(k):
            k1, k2 = jax.random.split(k)
            return jnp.stack([jax.random.normal(k1, (A,)), jax.random.normal(k2, (A,))])

        ks = jax.random.split(k_phys, S)
        normals = jax.vmap(init_normals)(ks)
        phys = jax.vmap(lambda k: j_init_physical(cfg, k))(ks)

        def body(carry, x_t):
            pol, scen, phys, k = carry
            k, k_act, k_learn = jax.random.split(k, 3)
            phys, _, out, tr, _ = j_slot(cfg, policy, pol, phys, x_t, k_act, ratings_j, True)
            pol, scen, idx = learn(pol, scen, tr, k_learn)
            u, r = _slot_draws(k_act, R, True)
            outs = (u, r, idx, tr.aux, out.p_p2p, tr.obs[..., 2], jnp.mean(out.reward, axis=-1))
            return (pol, scen, phys, k), outs

        (pol, scen, _, _), outs = jax.lax.scan(body, (pol, scen, phys, k_scan), xs)
        u, r, idx, aux, p2p, bal, rew = outs
        return pol, scen, normals, u, r, idx, aux, p2p, bal, jnp.sum(rew, axis=0)

    def episode(pol, scen, key):
        pol, scen, normals, u, r, idx, aux, p2p, bal, rew = run(pol, scen, key)
        draws = tsc.EpisodeDraws(
            uniform=_t(u), randint=_t(r), normals=_t(normals),
            replay_idx=None if idx is None else _t(idx),
        )
        return pol, scen, draws, np.asarray(aux), (np.asarray(p2p), np.asarray(bal)), np.asarray(rew)

    return episode


def _learners(cfg):
    from p2pmicrogrid_tpu.models.dqn import ACTION_VALUES
    from p2pmicrogrid_tpu.models.replay import lockstep_replay_add

    def tabular(pol, scen, tr, k):
        return jsc._tabular_update_shared(cfg, pol, tr, k)[0], scen, None

    def dqn(pol, scen, tr, k):
        pol, scen, _ = jsc._dqn_update_shared(cfg, pol, scen, tr, k)
        return pol, scen, jax.random.randint(k, (B,), 0, jnp.maximum(scen.count, 1))

    def record(pol, scen, tr, k):
        act = ACTION_VALUES[tr.aux.astype(jnp.int32)][..., None]
        return pol, lockstep_replay_add(scen, tr.obs, act, tr.reward, tr.next_obs), None

    return tabular, dqn, record


@pytest.mark.parametrize("impl", ["tabular", "dqn"])
def test_fused_episodes_match_jax_chain(impl):
    sim = dict(market_impl="factored")
    cfg_j, cfg_t = _cfg(jcfg, impl, **sim), _cfg(tcfg, impl, **sim)
    ratings = make_ratings(cfg_j, np.random.default_rng(0))
    arrays = jsc.stack_scenario_arrays(cfg_j, jsc.make_scenario_traces(cfg_j, seed=0), ratings)
    arrays = jax.tree.map(lambda x: x[:, MIDDAY : MIDDAY + T], arrays)
    ratings_j = JAgentRatings(*(jnp.asarray(a) for a in ratings))
    policy_j = j_make_policy(cfg_j)
    pol0, scen0 = _jax_state(impl)
    if impl == "tabular":
        q = np.random.default_rng(1).standard_normal(pol0.q_table.shape).astype(np.float32) * 0.01
        pol0 = pol0._replace(q_table=jnp.asarray(q))
    # The port's learners update in place: each run starts from its own copy.
    to_port = lambda st: None if st is None else state_from_jax(
        jax.tree.map(np.asarray, st), device="cpu", cfg=cfg_t.dqn
    )
    tabular, dqn, record = _learners(cfg_j)

    # The JAX package: (DQN) one warmup pass, then two training episodes of
    # the unfused chain; and the same episodes replayed slot by slot.
    warm, pol_w, scen_w = [], pol0, scen0
    if impl == "dqn":
        # warmup_shared_dqn's one record-only pass (its key chain,
        # parallel/scenarios.py:1003-1010), replayed slot by slot, then the
        # hard target copy.
        from p2pmicrogrid_tpu.models.dqn import dqn_initialize_target

        (k_pass,) = jax.random.split(jax.random.PRNGKey(7), 1)
        pol_w, scen_w, d, aux, (p2p, _), _ = _jax_episode_draws(cfg_j, arrays, ratings_j, record)(
            pol0, scen0, k_pass
        )
        pol_w = dqn_initialize_target(pol_w)
        warm = [(d._replace(replay_idx=None), aux, p2p)]
    pol_j, _, rewards_j, _, _ = jsc.train_scenarios_shared(
        cfg_j, policy_j, pol_w, arrays, ratings, jax.random.PRNGKey(1), n_episodes=2,
        replay_s=scen_w, pipeline=False,
    )
    episodes, p, sc_ = [], pol_w, scen_w
    episode_j = _jax_episode_draws(cfg_j, arrays, ratings_j, tabular if impl == "tabular" else dqn)
    for e, k in enumerate(jsc._episode_key_schedule(jax.random.PRNGKey(1), 2)):
        p, sc_, d, aux, (p2p, bal), rew = episode_j(p, sc_, k)
        np.testing.assert_allclose(rew, rewards_j[e], rtol=1e-6)  # the replay is the episode
        _assert_two_sided(p2p, 0.05)
        assert (np.abs(bal) > 1e-3).mean() >= 0.5  # the balance input is real
        episodes.append((d, aux, p2p))
        p = policy_j.decay(p)

    # The port, fused, on the same draws: the trainer, then a slot-by-slot
    # replay for the actions.
    arrays_t = state_from_jax(jax.tree.map(np.asarray, arrays), device="cpu")
    policy_t = t_make_policy(cfg_t)
    pol_t, scen_t = to_port(pol0), to_port(scen0)
    if impl == "dqn":
        pol_t, scen_t = tsc.warmup_shared_dqn(
            cfg_t, policy_t, pol_t, scen_t, arrays_t, ratings, draws=[warm[0][0]], fused=True
        )
    pol_t, scen_t, rewards_t, _, _ = tsc.train_scenarios_shared(
        cfg_t, policy_t, pol_t, arrays_t, ratings, None, 2, replay_s=scen_t,
        draws=[d for d, _, _ in episodes], fused=True,
    )
    np.testing.assert_allclose(rewards_t, rewards_j, rtol=2e-4)
    got, ref = state_to_numpy(pol_t), jax.tree.map(np.asarray, pol_j)
    if impl == "tabular":
        np.testing.assert_allclose(got.q_table, ref.q_table, rtol=1e-4, atol=1e-6)
    else:
        for layer in ("Dense_0", "Dense_1", "Dense_2"):
            for field in ("kernel", "bias"):
                np.testing.assert_allclose(
                    got.online[layer][field], ref.online[layer][field],
                    rtol=1e-4, atol=1e-6, err_msg=f"{layer}.{field}",
                )
    assert float(got.epsilon) == float(ref.epsilon)

    _check_fused_actions(
        cfg_t, policy_t, to_port(pol0), to_port(scen0), arrays_t, ratings, warm, episodes
    )


def _check_fused_actions(cfg, policy, pol, scen, arrays, ratings, warm, episodes):
    """Every slot's actions and peer-to-peer powers of the port's fused slot
    against the JAX chain's, warmup pass included, learning between slots as
    the trainer does; powers within the slot contract, rtol=1e-5, atol=1e-3."""
    ratings_t = tcom.ratings_to(ratings, device="cpu")
    xs = [x.transpose(0, 1).contiguous() for x in arrays]
    schedule = [(*w, "record") for w in warm] + [(*e, "learn") for e in episodes]
    for n, (d, aux, p2p, mode) in enumerate(schedule):
        if n == len(warm) and cfg.train.implementation == "dqn":
            from p2pmicrogrid_tpu_torch.models.dqn import dqn_initialize_target

            pol = dqn_initialize_target(pol)
        phys = tcom.init_physical(cfg, d.normals, (S,), device="cpu")
        for t in range(T):
            phys, _, out, tr, _ = tcom.slot_dynamics_batched(
                cfg, policy, pol, phys, tuple(x[t] for x in xs),
                (d.uniform[t], d.randint[t]), ratings_t, explore=True, fused=True,
            )
            np.testing.assert_array_equal(tr.aux.numpy(), aux[t], err_msg=f"pass {n} slot {t}")
            np.testing.assert_allclose(
                out.p_p2p.numpy(), p2p[t], rtol=1e-5, atol=1e-3, err_msg=f"pass {n} slot {t}"
            )
            if cfg.train.implementation == "tabular":
                pol, _ = tsc._tabular_update_shared(cfg, pol, tr)
            elif mode == "record":
                scen = tsc._record_shared(scen, tr)
            else:
                pol, scen, _ = tsc._dqn_update_shared(cfg, pol, scen, tr, d.replay_idx[t])
        if mode == "learn":
            pol = policy.decay(pol)


def _blocked_sum(terms):
    """Sum over the last axis in K7's order: a running float32 sum over each
    block of 32 terms, the blocks added in order."""
    total = torch.zeros(terms.shape[:-1])
    for j0 in range(0, terms.shape[-1], 32):
        part = torch.zeros(terms.shape[:-1])
        for j in range(j0, min(terms.shape[-1], j0 + 32)):
            part = part + terms[..., j]
        total = total + part
    return total


def _split(o, t, pw, inv_a):
    """divide_power's split of net power o (opposite-sign total t) for the
    proposal pw, written as K7 writes it."""
    filtered = torch.where(torch.sign(o) != torch.sign(pw), pw, torch.zeros_like(pw))
    safe = torch.where(t > 0, t, torch.ones_like(t))
    return torch.where(t > 0, o * filtered.abs() / safe, o * inv_a)


def _pair_chain(outs, totals, m, inv_a):
    """(N_m[a, b], N_m[b, a]) for every ordered pair [S, a, b], each from the
    vectors of agents a and b alone: N_0[a, b] = out_0[a] / A and
    N_k[a, b] = split(out_k[a], total_k[a], -N_{k-1}[b, a]), with a zero
    proposal on the diagonal. Elementwise over the pairs, so no entry reads
    another pair's."""
    S, A = outs[0].shape
    eye = torch.eye(A, dtype=torch.bool)
    row = lambda v: v[:, :, None].expand(S, A, A)
    col = lambda v: v[:, None, :].expand(S, A, A)
    x, y = row(outs[0]) * inv_a, col(outs[0]) * inv_a
    for k in range(1, m + 1):
        x, y = (
            _split(row(outs[k]), row(totals[k]), torch.where(eye, 0.0, -y), inv_a),
            _split(col(outs[k]), col(totals[k]), torch.where(eye, 0.0, -x), inv_a),
        )
    return x, y


def _matrix_rounds(rounds, seed):
    """Net powers of rounds + 1 decision passes at S=3, A=37 (zero net powers
    in every round, and one scenario whose round-0 powers are all negative
    and round-1 powers positive, so that no proposal opposes its agents with
    a net power: their totals are 0 and they split equally), and the plain
    version's
    materialized rounds (ops/slot_fused.py::slot_step_fused_plain): each
    round's matrix and its per-agent opposite-sign totals."""
    from p2pmicrogrid_tpu_torch.ops.market import divide_power, zero_diagonal

    S, A = 3, 37
    rng = np.random.default_rng(seed)
    outs = [rng.standard_normal((S, A)).astype(np.float32) * 1e3 for _ in range(rounds + 1)]
    for o in outs:
        o[:, :4] = 0.0
    outs[0][1] = -np.abs(outs[0][1])
    outs[1][1] = np.abs(outs[1][1])
    outs = [torch.from_numpy(o) for o in outs]
    p2p = torch.zeros((S, A, A))
    mats, totals = [], []
    for r in range(rounds + 1):
        p2p = zero_diagonal(p2p)
        powers = -p2p.transpose(-1, -2)
        so = torch.sign(outs[r])[..., None]
        totals.append(torch.where(so != torch.sign(powers), powers, 0.0).sum(-1).abs())
        p2p = divide_power(outs[r], powers)
        mats.append(p2p)
    return outs, mats, totals


@pytest.mark.parametrize("rounds", [2, 3])
def test_matrix_free_chain_matches_materialized_rounds(rounds):
    """K7 never stores the [S, A, A] negotiation matrix: given the same
    per-agent totals, the pair chain gives every entry of every round bit for
    bit, and its clearing (row sums in blocks of 32) agrees with
    clear_market at rtol=1e-5, atol=1e-3 (another summation order)."""
    from p2pmicrogrid_tpu_torch.ops._f32 import recip
    from p2pmicrogrid_tpu_torch.ops.market import clear_market

    outs, mats, totals = _matrix_rounds(rounds, seed=rounds)
    assert bool((totals[1][1, 4:] == 0).all())  # the one-signed scenario splits equally
    inv_a = recip(outs[0].shape[-1])
    for m in range(rounds + 1):
        x, y = _pair_chain(outs, totals, m, inv_a)
        assert torch.equal(x, mats[m]), f"round {m}"
        assert torch.equal(y, mats[m].transpose(-1, -2)), f"round {m}"
    differ = torch.sign(x) != torch.sign(y)
    ex = torch.where(differ, torch.sign(x) * torch.minimum(x.abs(), y.abs()), 0.0)
    grid, peer = _blocked_sum(x - ex), _blocked_sum(ex)
    ref_grid, ref_peer = clear_market(mats[-1])
    assert (ref_peer > 0).any() and (ref_peer < 0).any()  # buyers and sellers trade
    torch.testing.assert_close(grid, ref_grid, rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(peer, ref_peer, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("rounds", [2, 3])
def test_opposite_sign_total_from_sign_candidates(rounds):
    """K7 sums each column's round-r terms -N_{r-1}[j, i] once, for all three
    signs out_r[i] can take (pw kept where it is not below, not equal to, not
    above 0), before out_r exists; the candidate of out_r's sign is the
    opposite-sign total bit for bit, and matches divide_power's total."""
    from p2pmicrogrid_tpu_torch.ops._f32 import recip

    outs, _, totals = _matrix_rounds(rounds, seed=10 + rounds)
    A = outs[0].shape[-1]
    inv_a = recip(A)
    eye = torch.eye(A, dtype=torch.bool)
    for r in range(1, rounds + 1):
        _, y = _pair_chain(outs, totals, r - 1, inv_a)
        pw = torch.where(eye, 0.0, -y)  # [S, i, j]: -N_{r-1}[j, i]
        below, zero, above = (
            _blocked_sum(torch.where(cond, 0.0, pw)) for cond in (pw < 0, pw == 0, pw > 0)
        )
        o = outs[r]
        picked = torch.where(o > 0, above, torch.where(o < 0, below, zero))
        direct = _blocked_sum(torch.where(torch.sign(o)[..., None] != torch.sign(pw), pw, 0.0))
        assert torch.equal(picked, direct), f"round {r}"
        torch.testing.assert_close(picked.abs(), totals[r], rtol=1e-5, atol=1e-3)


def test_resolve_use_fused():
    """Off unless asked for, as in the JAX package; DDPG is refused."""
    mk = lambda impl, f: tcfg.default_config(
        sim=tcfg.SimConfig(fused_slot=f), train=tcfg.TrainConfig(implementation=impl)
    )
    assert tcom.resolve_use_fused(mk("tabular", None)) is False
    assert tcom.resolve_use_fused(mk("dqn", False)) is False
    assert tcom.resolve_use_fused(mk("tabular", True)) is True
    assert tcom.resolve_use_fused(mk("dqn", True)) is True
    assert tcom.resolve_use_fused(mk("ddpg", None)) is False
    with pytest.raises(ValueError, match="ddpg"):
        tcom.resolve_use_fused(mk("ddpg", True))


def test_kernel_library_digest_covers_included_headers(tmp_path):
    """A kernel library is named by the digest of its source and of the
    ``csrc/`` headers it includes, so an edited shared header rebuilds K1
    and K7 instead of loading a stale library."""
    import shutil

    from p2pmicrogrid_tpu_torch.ops import _build

    lib = _build.KernelLibrary("slot_fused.cu", lambda _: None)
    assert [p.rsplit("/", 1)[-1] for p in _build.source_closure(lib.source)] == [
        "slot_fused.cu", "slot_ops.cuh",
    ]
    for name in ("slot_fused.cu", "slot_ops.cuh"):
        shutil.copy(lib.source.replace("slot_fused.cu", name), tmp_path / name)
    lib.source = str(tmp_path / "slot_fused.cu")
    before = lib.path()
    with open(tmp_path / "slot_ops.cuh", "a") as f:
        f.write("// edited\n")
    assert lib.path() != before

