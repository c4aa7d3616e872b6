"""The independent-scenario trainer (``parallel/scenarios.py``:
``make_independent_episode_fn``, ``train_scenarios_independent``) and kernel
K7 with one learner per scenario, against the JAX package on the CPU.

The JAX package vmaps the single community's ``run_episode`` over S
scenarios, each with its own learners (parallel/scenarios.py:336-373); the
port runs the S communities as one ``[S, A]`` slot of the single chain with
S * A per-agent learners. Both start from the same learners
(``convert.stacked_state_from_jax``) and the port is fed the JAX key chain's
draws: ``split(key, S)``, then ``k_phys, k_ep = split(k)`` per scenario
(:361-366), rebuilt by ``test_torch_single_episode.py``'s helpers. S = A = 3,
an 8-bin Q-table, slots 36-59 (``WINDOW``).

Tolerances: episode rewards ``rtol=2e-4`` (tests/test_golden.py:74-81),
losses and the Q-tables ``rtol=1e-3, atol=1e-4``
(tests/test_factored_market.py:203-214), and the learners at
tests/test_torch_single_learners.py's: DQN's and DDPG's weights ``rtol=1e-4,
atol=1e-6``, DDPG's stored actions ``atol=1e-5`` and its OU noise
``rtol=1e-6`` (bit for bit over tests/test_torch_single_learners.py's 3
slots; after 24 slots inside the vmapped JAX program one entry of 9 differs
by an ulp, ROADMAP.md, Queue 3).
Identical decisions: the DQN and DDPG rings hold every slot's action; for
tabular the set of Q-cells each learner updated (one per slot, at its
observation and action) is equal. K7's plain version with S * A learners
equals S calls at ``[1, A]`` bit for bit. The port's fused episodes are
held to the JAX package's unfused one, as its own tests/test_pallas_slot.py:198
holds its fused slot to that chain.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_single_episode import jax_init_normals, jax_single_draws

from p2pmicrogrid_tpu import config as jcfg
from p2pmicrogrid_tpu.envs import community as jcom
from p2pmicrogrid_tpu.models import tabular_init as j_tabular_init
from p2pmicrogrid_tpu.parallel import scenarios as jsc
from p2pmicrogrid_tpu.train import init_policy_state as j_init_policy_state
from p2pmicrogrid_tpu.train import make_policy as j_make_policy
from p2pmicrogrid_tpu_torch import config as tcfg
from p2pmicrogrid_tpu_torch.convert import (
    state_from_jax,
    stacked_state_from_jax,
    stacked_state_to_numpy,
)
from p2pmicrogrid_tpu_torch.envs import community as tcom
from p2pmicrogrid_tpu_torch.ops import slot_fused as sf
from p2pmicrogrid_tpu_torch.parallel import scenarios as tsc
from p2pmicrogrid_tpu_torch.train import make_policy as t_make_policy

S, A = 3, 3
WINDOW = slice(36, 60)
T = WINDOW.stop - WINDOW.start
BINS = dict(num_time_states=8, num_temp_states=8, num_balance_states=8, num_p2p_states=8)


def _cfg(mod, impl, **sim):
    return mod.default_config(
        sim=mod.SimConfig(n_agents=A, n_scenarios=S, **sim),
        qlearning=mod.QLearningConfig(**BINS),
        train=mod.TrainConfig(implementation=impl),
        dqn=mod.DQNConfig(buffer_size=64, batch_size=4),
        ddpg=mod.DDPGConfig(buffer_size=64, batch_size=4),
    )


def _jax_state(cfg_j, cfg_t):
    """S fresh learners for both packages, in the JAX package's vmapped tree:
    an 8-bin table drawn with numpy (tabular), or the port's seeded S * A
    learners (DQN, DDPG; leaf for leaf the shape and dtype of the JAX init),
    epsilon 0.5 so that greedy and explored actions both occur."""
    impl = cfg_j.train.implementation
    if impl == "tabular":
        ps = j_tabular_init(cfg_j.qlearning, A)
        q = np.random.default_rng(4).standard_normal((S,) + ps.q_table.shape, dtype=np.float32)
        return ps._replace(q_table=jnp.asarray(q), epsilon=jnp.full((S,), 0.5, jnp.float32))
    keys = jax.random.split(jax.random.PRNGKey(0), S)
    ref, tree = jax.tree.flatten(jax.eval_shape(jax.vmap(lambda k: j_init_policy_state(cfg_j, k)), keys))
    port = tsc.init_independent_state(cfg_t, S, "cpu", torch.Generator().manual_seed(0))
    if impl == "dqn":
        port = port._replace(epsilon=torch.tensor(0.5))
    leaves = [np.array(x) for x in jax.tree.leaves(stacked_state_to_numpy(port, S))]
    assert [(r.shape, r.dtype) for r in ref] == [(x.shape, x.dtype) for x in leaves]
    return jax.tree.unflatten(tree, [jnp.asarray(x) for x in leaves])


def _stacked_draws(cfg, key):
    """The port's stacked ``SingleEpisodeDraws`` of one JAX independent
    episode from its key."""
    impl = cfg.train.implementation
    batch = {"dqn": cfg.dqn.batch_size, "ddpg": cfg.ddpg.batch_size}.get(impl)
    cap = {"dqn": cfg.dqn.buffer_size, "ddpg": cfg.ddpg.buffer_size}.get(impl)
    per = []
    for k in jax.random.split(key, S):
        k_phys, k_ep = jax.random.split(k)
        d = jax_single_draws(k_ep, T, A, impl, rounds=cfg.sim.rounds, n_actions=3, batch=batch, cap=cap)
        per.append(d._replace(normals=jax_init_normals(k_phys, A)))
    return tcom.SingleEpisodeDraws(
        *(None if leaves[0] is None else torch.stack(leaves) for leaves in zip(*per))
    )


@functools.lru_cache(maxsize=None)
def _jax_episode(impl):
    """One JAX independent episode (``make_independent_episode_fn``,
    unfused) from the shared initial learners; numpy leaves."""
    cfg_j, cfg_t = _cfg(jcfg, impl), _cfg(tcfg, impl)
    ratings = jcom.make_ratings(cfg_j, np.random.default_rng(3))
    arrays = jsc.stack_scenario_arrays(cfg_j, jsc.make_scenario_traces(cfg_j, seed=0), ratings)
    arrays = type(arrays)(*(x[:, WINDOW] for x in arrays))
    ps0 = _jax_state(cfg_j, cfg_t)
    episode = jsc.make_independent_episode_fn(cfg_j, j_make_policy(cfg_j), arrays, ratings, fused=False)
    key = jax.random.PRNGKey(7)
    ps1, (rewards, losses) = episode(ps0, key)
    np_ = lambda t: jax.tree.map(np.asarray, t)
    return dict(
        ratings=ratings, arrays=np_(arrays), ps0=np_(ps0), ps1=np_(ps1),
        rewards=np.asarray(rewards), losses=np.asarray(losses), key=key,
    )


def _run_port(impl, fused):
    run = _jax_episode(impl)
    cfg = _cfg(tcfg, impl)
    sub = {"dqn": cfg.dqn, "ddpg": cfg.ddpg}.get(impl)
    ps0 = stacked_state_from_jax(run["ps0"], "cpu", cfg=sub)
    arrays = state_from_jax(run["arrays"], device="cpu")
    episode = tsc.make_independent_episode_fn(cfg, t_make_policy(cfg), arrays, run["ratings"], fused=fused)
    ps1, (rewards, losses) = episode(ps0, draws=_stacked_draws(cfg, run["key"]))
    return run, stacked_state_to_numpy(ps1, S), rewards.numpy(), losses.numpy()


@pytest.mark.parametrize(
    "impl,fused",
    [("tabular", False), ("tabular", True), ("dqn", False), ("dqn", True), ("ddpg", False)],
    ids=["tabular", "tabular-fused", "dqn", "dqn-fused", "ddpg"],
)
def test_independent_episode_matches_jax(impl, fused):
    """One training episode of S = 3 independent communities, unfused (K5
    and K6's plain versions at [S, A]) and fused (K7's plain version with one
    learner per scenario)."""
    run, ps1, rewards, losses = _run_port(impl, fused)
    ref = run["ps1"]
    np.testing.assert_allclose(rewards, run["rewards"], rtol=2e-4)
    np.testing.assert_allclose(losses, run["losses"], rtol=1e-3, atol=1e-4)
    if impl == "tabular":
        q0 = run["ps0"].q_table
        np.testing.assert_array_equal(ps1.q_table != q0, ref.q_table != q0)
        assert (ref.q_table != q0).sum() > S * A
        np.testing.assert_allclose(ps1.q_table, ref.q_table, rtol=1e-3, atol=1e-4)
        np.testing.assert_array_equal(ps1.epsilon, ref.epsilon)
        return
    np.testing.assert_array_equal(ps1.replay.count, ref.replay.count)
    assert (ref.replay.count == T).all()
    if impl == "dqn":
        np.testing.assert_array_equal(ps1.replay.action, ref.replay.action)
        nets = (ps1.online, ref.online), (ps1.target, ref.target)
    else:
        np.testing.assert_allclose(ps1.replay.action, ref.replay.action, rtol=0, atol=1e-5)
        np.testing.assert_allclose(ps1.ou_state, ref.ou_state, rtol=1e-6, atol=0)
        nets = (ps1.actor, ref.actor), (ps1.critic, ref.critic)
    for got, want in nets:
        for g, r in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-6)
    for g, r in zip(ps1.replay[:4], ref.replay[:4]):
        np.testing.assert_allclose(g, r, rtol=2e-4, atol=1e-5)


def test_train_scenarios_independent_loop():
    """The host loop: two episodes from a generator, decay after episode 0
    for every learner at once, ``episode_cb`` per episode on host values,
    reproducible from the seed; the refusals."""
    cfg = _cfg(tcfg, "tabular")
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, min_episodes_criterion=1))
    ratings = tcom.make_ratings(cfg, np.random.default_rng(3))
    arrays = tsc.stack_scenario_arrays(cfg, tsc.make_scenario_traces(cfg, seed=0), ratings, device="cpu")
    arrays = type(arrays)(*(x[:, WINDOW] for x in arrays))
    policy = t_make_policy(cfg)

    def run():
        seen = []
        ps = tsc.init_independent_state(cfg, S, "cpu")
        out = tsc.train_scenarios_independent(
            cfg, policy, ps, arrays, ratings, torch.Generator().manual_seed(5), 2,
            episode_cb=lambda ep, r, l, st: seen.append((ep, r.shape, float(st.epsilon))),
        )
        return out, seen

    (ps, rewards, losses, seconds), seen = run()
    (_, rewards_b, _, _), _ = run()
    assert rewards.shape == losses.shape == (2, S) and seconds > 0
    np.testing.assert_array_equal(rewards, rewards_b)
    eps = cfg.qlearning.epsilon
    decayed = max(eps * cfg.qlearning.epsilon_decay, cfg.qlearning.epsilon_floor)
    assert [(e, shape) for e, shape, _ in seen] == [(0, (S,)), (1, (S,))]
    assert seen[0][2] == pytest.approx(decayed) and seen[1][2] == pytest.approx(
        max(decayed * cfg.qlearning.epsilon_decay, cfg.qlearning.epsilon_floor)
    )
    assert ps.q_table.shape[0] == S * A
    cfg_d = _cfg(tcfg, "ddpg")
    with pytest.raises(ValueError, match="tabular/dqn"):
        tsc.make_independent_episode_fn(cfg_d, t_make_policy(cfg_d), arrays, ratings, fused=True)


def _slot_case(impl, rounds, seed):
    """One slot's inputs at [S, A] with S * A learners (a random Q-table, or
    seeded networks), epsilon 0.3; half of the batteries full, so that the
    market is two-sided."""
    cfg = _cfg(tcfg, impl, rounds=rounds)
    cfg = dataclasses.replace(cfg, battery=tcfg.BatteryConfig(enabled=True))
    gen = torch.Generator().manual_seed(seed)
    ratings = tcom.make_ratings(cfg, np.random.default_rng(seed))
    arrays = tsc.stack_scenario_arrays(cfg, tsc.make_scenario_traces(cfg, seed=seed), ratings, device="cpu")
    xs = tuple(x[:, 44].contiguous() for x in arrays)
    pol = tsc.init_independent_state(cfg, S, "cpu", gen)
    if impl == "tabular":
        pol = pol._replace(q_table=torch.randn(pol.q_table.shape, generator=gen))
    pol = pol._replace(epsilon=torch.tensor(0.3))
    phys = tcom.init_physical(cfg, torch.randn((S, 2, A), generator=gen), (S,), "cpu")
    bat = cfg.battery
    u = torch.rand((S, A), generator=gen)
    phys = phys._replace(soc=torch.clamp(bat.min_soc + (bat.max_soc - bat.min_soc) * 2 * u, max=bat.max_soc))
    R = rounds + 1
    draws = (torch.rand((R, S, A), generator=gen), torch.randint(0, 3, (R, S, A), generator=gen))
    return cfg, pol, phys, xs, draws, tcom.ratings_to(ratings, "cpu")


@pytest.mark.parametrize("rounds", [1, 2])
@pytest.mark.parametrize("impl", ["tabular", "dqn"])
def test_strided_fused_slot_equals_one_scenario(impl, rounds):
    """K7's plain version with one learner per scenario: each scenario's
    slice of the [S, A] call equals ``slot_step_fused_plain`` at [1, A] with
    that scenario's learners, bit for bit (the kernel's contract on the
    card), on a market where agents trade."""
    cfg, pol, phys, xs, draws, ratings = _slot_case(impl, rounds, seed=0)
    assert sf.per_scenario_learners(cfg, pol, S, A)
    raw = sf.slot_step_fused_plain(cfg, pol, phys, xs, draws, ratings, True, "matrix")
    assert (raw.p_p2p != 0).sum() >= 2
    for s in range(S):
        one = lambda tree: type(tree)(*(x[s : s + 1] for x in tree))
        cfg1 = dataclasses.replace(cfg, sim=dataclasses.replace(cfg.sim, n_scenarios=1))
        ref = sf.slot_step_fused_plain(
            cfg1, tsc.scenario_learners(pol, s, A), one(phys), tuple(x[s : s + 1] for x in xs),
            tuple(d[:, s : s + 1] for d in draws), ratings, True, "matrix",
        )
        for name, g, r in zip(raw._fields, raw, ref):
            g = g[s : s + 1]
            assert torch.equal(g, r), (name, s)
    if impl == "tabular":
        with pytest.raises(ValueError, match="learners"):
            bad = pol._replace(q_table=pol.q_table[: 2 * A])
            sf.slot_step_fused_plain(cfg, bad, phys, xs, draws, ratings, True, "matrix")
