"""The port's shared DDPG against the JAX package on the CPU: the actor and
critic forwards, the scenario-batched act with its OU step, one learn step
(``ddpg_learn_batch``) and one shared update (``_ddpg_update_shared``: one
actor-critic for every agent, with and without the striped cap, per-agent
stacks, and the delayed actor across its gate), the pooled-batch lr rule,
the converter, and whole shared-training episodes.

Both sides start from the same weights (``convert.state_from_jax``) and the
port is fed the JAX package's own draws: the act tests inject the OU normals
into both, and the episodes rebuild every draw from the JAX key chain
(``parallel/scenarios.py:941,982-985``: per slot ``key, k_act, k_learn``; per
round ``split(k_act, rounds + 1)`` and ``normal(round_key, (S, A))``,
``models/ddpg.py:87-94,276``; the learn step's sample indices and, under the
cap, ``key, koff = split(k_learn)`` and the stripe offsets,
``parallel/scenarios.py:580-603``). Tolerances: forwards, actions and ``q``
``rtol=1e-5, atol=1e-6``, the OU state bit for bit; after a learn step
parameters and targets ``rtol=1e-5, atol=1e-7``, Adam's moments, the losses
and the per-scenario loss ``rtol=1e-4`` (as ``tests/test_torch_dqn.py``:
Adam's bias correction and the gradient sums round in another order); the
episodes' every slot's actions ``atol=1e-5``, rewards ``rtol=2e-4``
(tests/test_golden.py:74-81), final parameters ``rtol=1e-4, atol=1e-6``.

The episodes run at rounds=1 (the factored clearing) and rounds=2 (the
matrix negotiation, against the JAX package's jnp path on the CPU), on slots
58-65 (14:30-16:15) with full batteries: PV still exceeds every agent's load,
so balances are real and the battery stays idle (where batteries cover the
balance, XLA's fused battery arithmetic leaves a ~1e-5 W residue where the
port has 0, ROADMAP.md, Queue 3), and the heat pump's fraction makes some
agents buyers and others sellers (each episode asserts both).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2pmicrogrid_tpu import config as jcfg
from p2pmicrogrid_tpu.envs.community import AgentRatings as JAgentRatings
from p2pmicrogrid_tpu.envs.community import SlotTransition as JTransition
from p2pmicrogrid_tpu.envs.community import init_physical as j_init_physical
from p2pmicrogrid_tpu.envs.community import make_ratings
from p2pmicrogrid_tpu.envs.community import slot_dynamics_batched as j_slot
from p2pmicrogrid_tpu.models import ddpg as jd
from p2pmicrogrid_tpu.models.networks import Actor as JActor
from p2pmicrogrid_tpu.models.networks import Critic as JCritic
from p2pmicrogrid_tpu.parallel import scenarios as jsc
from p2pmicrogrid_tpu.train import make_policy as j_make_policy
from p2pmicrogrid_tpu_torch import config as tcfg
from p2pmicrogrid_tpu_torch.convert import state_from_jax, state_to_numpy
from p2pmicrogrid_tpu_torch.envs import community as tcom
from p2pmicrogrid_tpu_torch.envs.community import SlotTransition
from p2pmicrogrid_tpu_torch.models import ddpg as td
from p2pmicrogrid_tpu_torch.parallel import scenarios as tsc
from p2pmicrogrid_tpu_torch.train import make_policy as t_make_policy

S, A, CAP, T, E = 3, 6, 16, 8, 2
AFTERNOON = 58
# A cap below the shared pool B * S * A: 8 stripes of 5 rows.
STRIPED_CAP = 40


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's side of these tests runs thousands of tiny CPU ops, which
    PyTorch's thread pool slows down when test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(mod, share=True, batch=4, sim=None, **ddpg):
    sim = {"n_agents": A, "n_scenarios": S, "rounds": 1, "market_impl": "factored", **(sim or {})}
    return mod.default_config(
        sim=mod.SimConfig(**sim),
        # Batteries start full (max_soc), so the surplus is sold.
        battery=mod.BatteryConfig(enabled=True, init_soc=0.9),
        train=mod.TrainConfig(implementation="ddpg"),
        ddpg=mod.DDPGConfig(buffer_size=CAP, batch_size=batch, share_across_agents=share, **ddpg),
    )


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _jax_init(share):
    cfg = _cfg(jcfg, share)
    return _np(jax.jit(lambda k: jsc.init_shared_state(cfg, k))(jax.random.PRNGKey(0)))


def _port(tree, cfg):
    """The port's copy of a numpy JAX state (the port updates in place)."""
    return state_from_jax(tree, device="cpu", cfg=cfg.ddpg)


def _obs(rng, *shape):
    return rng.uniform(-1.0, 1.0, shape + (4,)).astype(np.float32)


def _assert_close_trees(got, ref, rtol, atol, what):
    for (path, g), r in zip(jax.tree_util.tree_leaves_with_path(got), jax.tree.leaves(ref)):
        np.testing.assert_allclose(g, r, rtol=rtol, atol=atol, err_msg=f"{what}{jax.tree_util.keystr(path)}")


# Adam's eps (optax's and the port's): where a gradient entry is within two
# orders of it, the step lr * m / (sqrt(v) + eps) has a slope of up to
# lr / (4 * eps) = 2,500 (lr 1e-4) in the gradient, so the rounding of a batch
# sum that cancels to ~1e-8 (~1e-10, the size of its terms' last bits) moves
# the weight by ~2.5e-7, whatever the tolerance of its moments.
ADAM_EPS = 1e-8


def _assert_network(got, ref, adam, lr, rtol, atol, what, ill):
    """A network's leaves at (rtol, atol), except the entries whose
    bias-corrected first moment in the reference's Adam state ``adam`` is
    below 100 * ADAM_EPS at this step or was at an earlier one (``ill``,
    updated in place): those at 1e-2 of a learning-rate step."""
    t = int(np.asarray(adam.count).reshape(-1)[0])
    for (path, g), r, mu in zip(
        jax.tree_util.tree_leaves_with_path(got), jax.tree.leaves(ref), jax.tree.leaves(adam.mu)
    ):
        err = f"{what}{jax.tree_util.keystr(path)}"
        mask = ill.get(err, np.zeros(mu.shape, bool))
        if t:
            mask = mask | (np.abs(mu) / (1.0 - 0.9**t) < 100 * ADAM_EPS)
        ill[err] = mask
        np.testing.assert_allclose(g[~mask], r[~mask], rtol=rtol, atol=atol, err_msg=err)
        np.testing.assert_allclose(g[mask], r[mask], rtol=0, atol=1e-2 * lr, err_msg=err)


def _assert_params(got, ref, cfg, what, ill, rtol=1e-5, atol=1e-7):
    """Networks (as ``_assert_network``, ``ill`` carried across a test's
    steps) and targets at (rtol, atol); Adam's step counts equal (dtype and
    shape too), its moments at rtol=1e-4 with an atol of 1e-6 of the leaf's
    largest moment: a gradient entry that cancels to near 0 carries the
    rounding of its batch sum, which is the size of the sum's terms, not its
    own."""
    d = cfg.ddpg
    for name, lr in (("actor", d.actor_lr), ("critic", d.critic_lr)):
        adam = getattr(ref, f"{name}_opt")[0]
        _assert_network(getattr(got, name), getattr(ref, name), adam, lr, rtol, atol, name, ill)
        target = f"{name}_target"
        _assert_close_trees(getattr(got, target), getattr(ref, target), rtol, atol, f"{what} {target}")
    for name in ("actor_opt", "critic_opt"):
        g, r = getattr(got, name)[0], getattr(ref, name)[0]
        assert g.count.dtype == r.count.dtype and g.count.shape == r.count.shape
        np.testing.assert_array_equal(g.count, r.count, err_msg=f"{what} {name} count")
        for (path, gm), rm in zip(
            jax.tree_util.tree_leaves_with_path((g.mu, g.nu)), jax.tree.leaves((r.mu, r.nu))
        ):
            np.testing.assert_allclose(
                gm, rm, rtol=1e-4, atol=1e-6 * float(np.abs(rm).max()),
                err_msg=f"{what} {name}{jax.tree_util.keystr(path)}",
            )


@pytest.mark.parametrize("share", [True, False], ids=["shared", "per_agent"])
def test_actor_critic_forward_matches_flax(share):
    """The actor and the critic on converted weights, against flax's Actor
    and Critic: one shared set on [N, 4], or each agent's on its [N, 4]."""
    cfg = _cfg(tcfg, share)
    params = _jax_init(share)[0]
    port = _port(params, cfg)
    rng = np.random.default_rng(0)
    shape = (7,) if share else (A, 7)
    s = _obs(rng, *shape)
    a = rng.uniform(0.0, 1.0, shape + (1,)).astype(np.float32)
    actor, critic = JActor(hidden=cfg.ddpg.actor_hidden), JCritic(hidden=cfg.ddpg.critic_hidden)
    fa = lambda p, s: actor.apply({"params": p}, s)
    fc = lambda p, s, a: critic.apply({"params": p}, s, a)
    if not share:
        fa, fc = jax.vmap(fa), jax.vmap(fc)
    ref_a = jax.jit(fa)(params.actor, s)
    ref_q = jax.jit(fc)(params.critic, s, a)
    with torch.no_grad():
        got_a = port.actor(torch.from_numpy(s))
        got_q = port.critic(torch.from_numpy(s), torch.from_numpy(a))
    assert got_a.shape == shape + (1,) and got_q.shape == shape + (1,)
    np.testing.assert_allclose(got_a.numpy(), np.asarray(ref_a), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_q.numpy(), np.asarray(ref_q), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("share", [True, False], ids=["shared", "per_agent"])
def test_shared_act_matches_jax(monkeypatch, share):
    """ddpg_shared_act with the OU normals injected into both (the JAX act
    draws them from its key, ddpg.py:87-94): actions and q, exploring and
    greedy, and the OU state bit for bit, at noise scale 0.7 with the OU
    state near and past the clip at 0 and 1."""
    cfg_j, cfg_t = _cfg(jcfg, share), _cfg(tcfg, share)
    params = _jax_init(share)[0]._replace(noise_scale=np.float32(0.7))
    port = _port(params, cfg_t)
    rng = np.random.default_rng(1)
    obs = _obs(rng, S, A)
    ou = rng.normal(0.0, 1.0, (S, A)).astype(np.float32)
    normals = rng.standard_normal((S, A)).astype(np.float32)
    box = {}
    monkeypatch.setattr(jax.random, "normal", lambda key, shape: box["n"])

    def act(p, obs, ou, n, explore):
        box["n"] = n
        return jd.ddpg_shared_act(cfg_j.ddpg, p, obs, ou, jax.random.PRNGKey(0), explore)

    for explore in (True, False):
        a_j, q_j, ou_j = jax.jit(act, static_argnums=4)(params, obs, ou, normals, explore)
        a_t, q_t, ou_t = td.ddpg_shared_act(
            cfg_t.ddpg, port, *(torch.from_numpy(x) for x in (obs, ou, normals)), explore
        )
        np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(q_t.numpy(), np.asarray(q_j), rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(ou_t.numpy(), np.asarray(ou_j))
        if explore:
            a_j = np.asarray(a_j)
            assert ((a_j == 0.0) | (a_j == 1.0)).any() and ((a_j > 0.0) & (a_j < 1.0)).any()
            assert not np.array_equal(np.asarray(ou_j), ou)


def _batch(rng, *lead):
    return (
        _obs(rng, *lead),
        rng.uniform(0.0, 1.0, lead + (1,)).astype(np.float32),
        rng.normal(-20.0, 30.0, lead).astype(np.float32),
        _obs(rng, *lead),
    )


@pytest.mark.parametrize("share", [True, False], ids=["shared", "per_agent"])
def test_learn_batch_matches_jax(share):
    """One ddpg_learn_batch step on an injected batch, twice: a shared set on
    [40, ...] rows, or each agent's on its own [40, ...] (vmapped in JAX)."""
    cfg_j, cfg_t = _cfg(jcfg, share), _cfg(tcfg, share)
    params = jax.tree.map(jnp.asarray, _jax_init(share)[0])
    port = _port(_np(params), cfg_t)
    rng = np.random.default_rng(2)
    learn = lambda *args: jd.ddpg_learn_batch(cfg_j.ddpg, *args)
    if not share:
        learn = jax.vmap(learn)
    learn = jax.jit(learn)
    ill = {}
    for step in range(2):
        batch = _batch(rng, *((40,) if share else (A, 40)))
        pa, pc, pat, pct, oa, oc, _, sq_j = learn(
            params.actor, params.critic, params.actor_target, params.critic_target,
            params.actor_opt, params.critic_opt, *batch,
        )
        params = params._replace(
            actor=pa, critic=pc, actor_target=pat, critic_target=pct, actor_opt=oa, critic_opt=oc
        )
        sq_t = td.ddpg_learn_batch(cfg_t.ddpg, port, *(torch.from_numpy(x) for x in batch))
        _assert_params(state_to_numpy(port), _np(params), cfg_t, f"step {step}", ill)
        np.testing.assert_allclose(sq_t.numpy(), np.asarray(sq_j), rtol=1e-4)


def _transition(rng):
    return JTransition(
        obs=_obs(rng, S, A),
        aux=rng.uniform(0.0, 1.0, (S, A)).astype(np.float32),
        reward=rng.normal(-20.0, 30.0, (S, A)).astype(np.float32),
        next_obs=_obs(rng, S, A),
    )


def _learn_draws(cfg, k_learn, count):
    """_ddpg_update_shared's sample indices [B] and, under the cap, stripe
    offsets, from its key (parallel/scenarios.py:580-603)."""
    d = cfg.ddpg
    hi = jnp.maximum(count, 1)
    stripes = tsc.ddpg_stripes(cfg, S, A)
    if stripes is None:
        return jax.random.randint(k_learn, (d.batch_size,), 0, hi), None
    key, koff = jax.random.split(k_learn)
    pool = d.batch_size * S * A
    return (
        jax.random.randint(key, (d.batch_size,), 0, hi),
        jax.random.randint(koff, (stripes[0],), 0, pool),
    )


UPDATE_CASES = [
    pytest.param(dict(share=True, batch=4), id="shared"),
    pytest.param(dict(share=True, batch=4, learn_batch_cap=STRIPED_CAP), id="shared_striped"),
    pytest.param(dict(share=False, batch=4), id="per_agent"),
    pytest.param(dict(share=True, batch=4, actor_delay_updates=2), id="actor_delay"),
]


@pytest.mark.parametrize("kw", UPDATE_CASES)
def test_update_shared_matches_jax(kw):
    """Two _ddpg_update_shared steps on injected transitions, fed the JAX
    learn keys' draws: parameters, targets, Adam, the ring, the OU state
    (untouched) and the per-scenario loss. With actor_delay_updates=2 the
    actor and its Adam hold still at the first step (the critic's count is
    1) and move at the second."""
    cfg_j, cfg_t = _cfg(jcfg, **kw), _cfg(tcfg, **kw)
    stripes = tsc.ddpg_stripes(cfg_t, S, A)
    assert (stripes is not None) == ("learn_batch_cap" in kw)
    params, scen = _jax_init(kw["share"])
    params, scen = jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, scen)
    port_p, port_s = _port(_np(params), cfg_t), _port(_np(scen), cfg_t)
    actor0 = _np(params.actor)
    update = jax.jit(lambda p, sc, tr, k: jsc._ddpg_update_shared(cfg_j, p, sc, tr, k))
    rng = np.random.default_rng(3)
    ill = {}
    for step in range(2):
        tr = _transition(rng)
        key = jax.random.PRNGKey(20 + step)
        params, scen, loss_j = update(params, scen, tr, key)
        idx, starts = _learn_draws(cfg_j, key, scen.replay.count)
        port_p, port_s, loss_t = tsc._ddpg_update_shared(
            cfg_t, port_p, port_s, SlotTransition(*(torch.from_numpy(x) for x in tr)),
            torch.from_numpy(np.array(idx)), None if starts is None else torch.from_numpy(np.array(starts)),
        )
        got, ref = state_to_numpy(port_p), _np(params)
        _assert_params(got, ref, cfg_t, f"step {step}", ill)
        np.testing.assert_allclose(loss_t.numpy(), np.asarray(loss_j), rtol=1e-4)
        assert loss_t.shape == (S,) and float(loss_t.std()) > 0.0
        for g, r in zip(state_to_numpy(port_s.replay), _np(scen.replay)):
            np.testing.assert_array_equal(g, r)
        np.testing.assert_array_equal(port_s.ou.numpy(), np.asarray(scen.ou))
        if kw.get("actor_delay_updates"):
            held = step == 0
            assert int(got.actor_opt[0].count) == (0 if held else 1)
            same = all(np.array_equal(g, r) for g, r in zip(jax.tree.leaves(got.actor), jax.tree.leaves(actor0)))
            assert same == held


LR_CASES = [
    pytest.param(dict(n_agents=100, n_scenarios=64), dict(batch_size=4, share_across_agents=True), id="scaled"),
    pytest.param(dict(n_agents=2, n_scenarios=2), dict(batch_size=4, share_across_agents=True), id="small"),
    pytest.param(dict(n_agents=100, n_scenarios=64), dict(batch_size=4, share_across_agents=False), id="per_agent"),
    pytest.param(
        dict(n_agents=100, n_scenarios=64),
        dict(batch_size=4, share_across_agents=True, lr_auto_scale=False),
        id="opt_out",
    ),
    pytest.param(dict(n_agents=1000, n_scenarios=64), dict(batch_size=4, share_across_agents=True), id="cfg4_capped"),
]


@pytest.mark.parametrize("sim,ddpg", LR_CASES)
def test_pooled_batch_and_lr_scale_match_jax(sim, ddpg):
    """ddpg_pooled_batch and auto_scale_ddpg_lrs equal the JAX package's on
    the configs of tests/test_chunked.py TestLrAutoScale and cfg4's capped
    pool; a non-DDPG config and a small pool come back unchanged."""
    mk = lambda mod, impl="ddpg": mod.default_config(
        sim=mod.SimConfig(**sim), train=mod.TrainConfig(implementation=impl),
        ddpg=mod.DDPGConfig(**ddpg),
    )
    assert tsc.ddpg_pooled_batch(mk(tcfg)) == jsc.ddpg_pooled_batch(mk(jcfg))
    got, ref = tsc.auto_scale_ddpg_lrs(mk(tcfg)).ddpg, jsc.auto_scale_ddpg_lrs(mk(jcfg)).ddpg
    assert (got.actor_lr, got.critic_lr) == (ref.actor_lr, ref.critic_lr)
    small = mk(tcfg)
    if tsc.ddpg_pooled_batch(small) <= tsc.DDPG_LR_REF_POOLED or not ddpg.get("lr_auto_scale", True):
        assert tsc.auto_scale_ddpg_lrs(small) is small
    dqn = mk(tcfg, "dqn")
    assert tsc.auto_scale_ddpg_lrs(dqn) is dqn


def _arrays(cfg_j, ratings):
    arrays = jsc.stack_scenario_arrays(cfg_j, jsc.make_scenario_traces(cfg_j, seed=0), ratings)
    return _np(jax.tree.map(lambda x: x[:, AFTERNOON : AFTERNOON + T], arrays))


def test_episode_applies_scaled_lrs():
    """The episode function learns at auto_scale_ddpg_lrs' rates for its S
    (a pool of 32 * 3 * 6 = 576 scales them by (400 / 576) ** 0.5), which
    init_shared_state alone does not set."""
    cfg = _cfg(tcfg, batch=32)
    scaled = tsc.auto_scale_ddpg_lrs(cfg).ddpg
    assert scaled.actor_lr == cfg.ddpg.actor_lr * (400.0 / 576) ** 0.5
    ratings = make_ratings(cfg, np.random.default_rng(0))
    arrays = state_from_jax(_arrays(_cfg(jcfg, batch=32), ratings), device="cpu")
    pol, scen = tsc.init_shared_state(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    lrs = lambda p: (p.actor_opt.param_groups[0]["lr"], p.critic_opt.param_groups[0]["lr"])
    assert lrs(pol) == (cfg.ddpg.actor_lr, cfg.ddpg.critic_lr)
    episode = tsc.make_shared_episode_fn(cfg, t_make_policy(cfg), arrays, ratings)
    (pol, _), _ = episode((pol, scen), torch.Generator().manual_seed(1))
    assert lrs(pol) == (scaled.actor_lr, scaled.critic_lr)


def _assert_two_sided(p_grid, balance):
    """Buyers and sellers both occur among the agents' final net powers, and
    the balance feature is real. (They rarely trade peer to peer: a one-round
    negotiation matches an agent only where its net power changes sign
    between rounds, and a DDPG agent's action moves by a round's OU step.)"""
    p = np.asarray(p_grid)
    assert (p > 0).mean() >= 0.1 and (p < 0).mean() >= 0.1, "a one-sided market: nothing to compare"
    assert (np.abs(np.asarray(balance)) > 1e-3).all()


# name: (share, batch, cap, sim). One actor-critic for every agent at
# rounds=1 (factored; a pool of 32 * 3 * 6 = 576 scales the lrs) and at
# rounds=2 (the matrix negotiation, the striped cap), per-agent stacks at both.
# Noise anneals by 0.9 after episode 0.
EPISODES = {
    "shared_factored": (True, 32, None, {}),
    "shared_matrix_striped": (True, 32, STRIPED_CAP, dict(rounds=2, market_impl="matrix")),
    "per_agent_factored": (False, 4, None, {}),
    "per_agent_matrix": (False, 4, None, dict(rounds=2, market_impl="matrix")),
}


def _episode_cfg(mod, name):
    share, batch, cap, sim = EPISODES[name]
    return _cfg(mod, share, batch, sim, learn_batch_cap=cap, noise_decay=0.9)


@functools.lru_cache(maxsize=None)
def _jax_episodes(name):
    """E JAX episodes of the shared DDPG slot, replayed slot by slot with the
    episode program's key chain (parallel/scenarios.py:923-1001), its lrs
    scaled as the program scales them: the initial and final states, every
    draw (as the port's EpisodeDraws), every slot's actions, the rewards and
    losses. The slot and the learn step are jitted apart (two small
    programs compile in half the time of the scan)."""
    cfg = _episode_cfg(jcfg, name)
    ratings = make_ratings(cfg, np.random.default_rng(0))
    arrays = _arrays(cfg, ratings)
    ratings_j = JAgentRatings(*(jnp.asarray(a) for a in ratings))
    cfg_s = jsc.auto_scale_ddpg_lrs(cfg, S)
    policy = j_make_policy(cfg)
    R = cfg.sim.rounds + 1
    xs = [tuple(x[:, t] for x in arrays) for t in range(T)]

    def act_fn(params, obs_s, prev_frac_s, round_key, ou_s):
        frac, q, ou_s = jd.ddpg_shared_act(cfg_s.ddpg, params, obs_s, ou_s, round_key)
        return frac, frac, q, ou_s

    slot = jax.jit(
        lambda pol, phys, x_t, k, ou: j_slot(
            cfg_s, policy, pol, phys, x_t, k, ratings_j, True, act_fn=act_fn, explore_state=ou
        )
    )
    update = jax.jit(lambda pol, scen, tr, k: jsc._ddpg_update_shared(cfg_s, pol, scen, tr, k))

    def init_normals(k):
        k1, k2 = jax.random.split(k)
        return jnp.stack([jax.random.normal(k1, (A,)), jax.random.normal(k2, (A,))])

    def init(key):
        k_phys, k_scan, _ = jax.random.split(key, 3)
        ks = jax.random.split(k_phys, S)
        return jax.vmap(lambda k: j_init_physical(cfg_s, k))(ks), jax.vmap(init_normals)(ks), k_scan

    def draws_of(k, count):
        k, k_act, k_learn = jax.random.split(k, 3)
        ou_n = jax.vmap(lambda kr: jax.random.normal(kr, (S, A)))(jax.random.split(k_act, R))
        return k, k_act, k_learn, ou_n, _learn_draws(cfg_s, k_learn, count)

    pol0, scen0 = _jax_init(cfg.ddpg.share_across_agents)
    pol, scen = jax.tree.map(jnp.asarray, (pol0, scen0))
    draws, actions, rewards, losses = [], [], [], []
    t = lambda x: torch.from_numpy(np.array(x))
    for e, key in enumerate(jsc._episode_key_schedule(jax.random.PRNGKey(1), E)):
        phys, normals, k = init(key)
        ep = {n: [] for n in ("ou", "idx", "starts", "aux", "p_grid", "bal", "rew", "loss")}
        for x_t in xs:
            # The sample is drawn from the ring after this slot's add.
            k, k_act, k_learn, ou_n, (idx, starts) = draws_of(k, jnp.minimum(scen.replay.count + 1, CAP))
            phys, _, out, tr, ou = slot(pol, phys, x_t, k_act, scen.ou)
            pol, scen, loss = update(pol, scen._replace(ou=ou), tr, k_learn)
            for n, v in zip(ep, (ou_n, idx, starts, tr.aux, out.p_grid, tr.obs[..., 2], out.reward.mean(-1), loss)):
                ep[n].append(None if v is None else np.asarray(v))
        _assert_two_sided(np.stack(ep["p_grid"]), np.stack(ep["bal"]))
        draws.append(tsc.EpisodeDraws(
            uniform=None, randint=None, normals=t(normals), replay_idx=t(np.stack(ep["idx"])),
            ou_normals=t(np.stack(ep["ou"])),
            stripe_starts=None if ep["starts"][0] is None else t(np.stack(ep["starts"])),
        ))
        actions.append(np.stack(ep["aux"]))
        rewards.append(np.stack(ep["rew"]).sum(axis=0))
        losses.append(np.stack(ep["loss"]).mean(axis=0))
        if e % cfg.train.min_episodes_criterion == 0:
            pol = jd.ddpg_decay(cfg.ddpg, pol)
    return dict(
        cfg=cfg, ratings=ratings, arrays=arrays, pol0=pol0, scen0=scen0, pol=_np(pol),
        draws=draws, actions=np.stack(actions), rewards=np.stack(rewards), losses=np.stack(losses),
    )


@pytest.mark.parametrize("name", list(EPISODES))
def test_shared_training_matches_jax(name):
    """train_scenarios_shared on the JAX draws: episode rewards, per-scenario
    losses (with spread across scenarios, tests/test_parallel.py:307), the
    final parameters and the annealed noise scale."""
    run = _jax_episodes(name)
    cfg = _episode_cfg(tcfg, name)
    pol, scen, rewards, losses, seconds = tsc.train_scenarios_shared(
        cfg, t_make_policy(cfg), _port(run["pol0"], cfg), state_from_jax(run["arrays"], device="cpu"),
        run["ratings"], None, E, replay_s=_port(run["scen0"], cfg), draws=run["draws"],
    )
    assert seconds > 0 and np.isfinite(rewards).all() and np.isfinite(losses).all()
    np.testing.assert_allclose(rewards, run["rewards"], rtol=2e-4)
    assert (losses.std(axis=1) > 0).all()
    got, ref = state_to_numpy(pol), run["pol"]
    for field in ("actor", "critic", "actor_target", "critic_target"):
        _assert_close_trees(getattr(got, field), getattr(ref, field), 1e-4, 1e-6, field)
    assert got.noise_scale == ref.noise_scale
    assert scen.replay.count == min(E * T, CAP)


@pytest.mark.parametrize("name", list(EPISODES))
def test_every_slot_action_matches_jax(name):
    """The port's slot loop, learning between slots as the trainer does, at
    the episode's scaled lrs: every slot's actions (clipped heat-pump
    fractions) within atol=1e-5 of the JAX package's."""
    run = _jax_episodes(name)
    cfg = tsc.auto_scale_ddpg_lrs(_episode_cfg(tcfg, name), S)
    policy = t_make_policy(cfg)
    pol, scen = _port(run["pol0"], cfg), _port(run["scen0"], cfg)
    td.set_learning_rates(cfg.ddpg, pol)
    arrays = state_from_jax(run["arrays"], device="cpu")
    ratings = tcom.ratings_to(run["ratings"], device="cpu")
    xs = [x.transpose(0, 1).contiguous() for x in arrays]
    for e, d in enumerate(run["draws"]):
        phys = tcom.init_physical(cfg, d.normals, (S,), device="cpu")
        for t in range(T):
            phys, _, _, tr, ou = tcom.slot_dynamics_batched(
                cfg, policy, pol, phys, tuple(x[t] for x in xs), (d.ou_normals[t],), ratings,
                explore=True, explore_state=scen.ou,
            )
            np.testing.assert_allclose(
                tr.aux.numpy(), run["actions"][e, t], rtol=0, atol=1e-5, err_msg=f"episode {e} slot {t}"
            )
            starts = None if d.stripe_starts is None else d.stripe_starts[t]
            pol, scen, _ = tsc._ddpg_update_shared(
                cfg, pol, scen._replace(ou=ou), tr, d.replay_idx[t], starts
            )
        if e % cfg.train.min_episodes_criterion == 0:
            pol = policy.decay(pol)


def test_replay_is_the_jax_episode():
    """The replay above computes what the JAX package's own shared episode
    program computes (train_scenarios_shared from the same state and key):
    rewards and losses to float32 rounding, final parameters too."""
    run = _jax_episodes("shared_factored")
    cfg = run["cfg"]
    pol, _, rewards, losses, _ = jsc.train_scenarios_shared(
        cfg, j_make_policy(cfg), jax.tree.map(jnp.asarray, run["pol0"]),
        jax.tree.map(jnp.asarray, run["arrays"]), run["ratings"], jax.random.PRNGKey(1),
        n_episodes=E, replay_s=jax.tree.map(jnp.asarray, run["scen0"]), pipeline=False,
    )
    np.testing.assert_allclose(rewards, run["rewards"], rtol=1e-6)
    np.testing.assert_allclose(losses, run["losses"], rtol=1e-5)
    _assert_close_trees(_np(pol.actor), run["pol"].actor, 1e-6, 1e-9, "actor")


@pytest.mark.parametrize("share", [True, False], ids=["shared", "per_agent"])
def test_converter_round_trip_is_exact(share):
    """DDPGParams (Adam with moments and a step count: a scalar count shared,
    [A] per agent) and DDPGScenState, JAX -> port -> numpy, leaf for leaf."""
    cfg = _cfg(tcfg, share)
    params, scen = _jax_init(share)
    rng = np.random.default_rng(4)
    noisy = lambda x: rng.standard_normal(x.shape).astype(x.dtype) if x.dtype == np.float32 else x + 7
    params = jax.tree.map(noisy, params)
    scen = scen._replace(ou=noisy(scen.ou), replay=scen.replay._replace(obs=noisy(scen.replay.obs)))
    for tree in (params, scen):
        back = state_to_numpy(_port(tree, cfg))
        assert type(back).__name__ == type(tree).__name__
        got, ref = jax.tree.leaves(back), jax.tree.leaves(tree)
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            assert np.asarray(g).dtype == np.asarray(r).dtype and np.shape(g) == np.shape(r)
            np.testing.assert_array_equal(g, r)
    assert np.asarray(params.actor_opt[0].count).shape == (() if share else (A,))


def test_generator_path_and_fused_refusal():
    """Draws from a seeded torch.Generator: same seed, same run, finite, the
    per-scenario losses spread; the fused slot refuses DDPG as the JAX
    package does."""
    cfg = _cfg(tcfg, learn_batch_cap=STRIPED_CAP)
    ratings = make_ratings(cfg, np.random.default_rng(0))
    arrays = state_from_jax(_arrays(_cfg(jcfg), ratings), device="cpu")
    policy = t_make_policy(cfg)

    def run():
        gen = torch.Generator().manual_seed(11)
        pol, scen = tsc.init_shared_state(cfg, device="cpu", generator=gen)
        return tsc.train_scenarios_shared(cfg, policy, pol, arrays, ratings, gen, E, replay_s=scen)

    a, b = run(), run()
    assert np.isfinite(a[2]).all() and a[2].shape == (E, S) and (a[3].std(axis=1) > 0).all()
    np.testing.assert_array_equal(a[2], b[2])
    np.testing.assert_array_equal(a[3], b[3])
    assert torch.equal(a[0].actor.Dense_0.kernel, b[0].actor.Dense_0.kernel)
    assert torch.equal(a[1].ou, b[1].ou)
    with pytest.raises(ValueError, match="tabular/dqn"):
        tsc.make_shared_episode_fn(cfg, policy, arrays, ratings, fused=True)
    fused = dataclasses.replace(cfg, sim=dataclasses.replace(cfg.sim, fused_slot=True))
    with pytest.raises(ValueError, match="ddpg"):
        tsc.make_shared_episode_fn(fused, policy, arrays, ratings)
