"""The recurrent DDPG and its day-granular trainer: the port against the JAX
package on the CPU.

The LSTM cell, the actor and the critic run on converted weights
(``convert.state_from_jax``) against flax (actor ``atol=1e-6``, critic
``rtol=1e-5``); the serving step scanned from a zero carry against the
whole sequence (``atol=1e-6``, ``tests/test_continuous.py:92-109``); one
``recurrent_ddpg_learn`` step against the jitted JAX step (loss
``rtol=1e-5``; parameters ``rtol=1e-5, atol=1e-7``, with the rule of
``tests/test_torch_ddpg.py`` for Adam's first steps near eps); ``rollout_day``
with the JAX rollout's own OU normals injected (``rtol=1e-5``); three days
of ``train_recurrent_community`` (``rtol=2e-4``, the golden episodes'); and
the conversion round trip bit for bit. Sequences are T=8 except the
trainer's days.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flax.linen as fnn

from p2pmicrogrid_tpu import config as jcfg
from p2pmicrogrid_tpu.envs.community import build_episode_arrays as j_build_arrays
from p2pmicrogrid_tpu.envs.community import init_physical as j_init_physical
from p2pmicrogrid_tpu.envs.community import make_ratings
from p2pmicrogrid_tpu.models import ddpg_recurrent as jrec
from p2pmicrogrid_tpu.train import recurrent as jtr
from p2pmicrogrid_tpu_torch import config as tcfg
from p2pmicrogrid_tpu_torch.convert import state_from_jax, state_to_numpy
from p2pmicrogrid_tpu_torch.data.traces import synthetic_traces
from p2pmicrogrid_tpu_torch.envs import community as tcom
from p2pmicrogrid_tpu_torch.models import ddpg_recurrent as trec
from p2pmicrogrid_tpu_torch.train import recurrent as ttr

T, B = 8, 3
ADAM_EPS = 1e-8  # optax's and the port's (tests/test_torch_ddpg.py)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_state():
    """The JAX package's fresh recurrent state at T=8, numpy leaves."""
    st = jrec.recurrent_ddpg_init(jcfg.DDPGConfig(), jax.random.PRNGKey(0), seq_len=T)
    return jax.tree.map(np.asarray, st)


def _port(np_state):
    return state_from_jax(np_state, device="cpu", cfg=tcfg.DDPGConfig())


def _seq(rng, *shape):
    return rng.uniform(-1.0, 1.0, shape).astype(np.float32)


def test_cell_matches_flax(jax_state):
    cp = jax_state.actor["OptimizedLSTMCell_0"]
    rng = np.random.default_rng(0)
    c, h, x = _seq(rng, B, 100), _seq(rng, B, 100), _seq(rng, B, 100)
    cell = fnn.OptimizedLSTMCell(100)
    (c_j, h_j), _ = jax.jit(lambda p, c, h, x: cell.apply({"params": p}, (c, h), x))(cp, c, h, x)
    weights = _port(jax_state).actor.OptimizedLSTMCell_0.weights()
    c_t, h_t = trec.lstm_cell(weights, *(torch.from_numpy(a) for a in (c, h, x)))
    np.testing.assert_allclose(c_t.detach().numpy(), np.asarray(c_j), atol=1e-6)
    np.testing.assert_allclose(h_t.detach().numpy(), np.asarray(h_j), atol=1e-6)


def test_actor_and_critic_match_flax(jax_state):
    rng = np.random.default_rng(1)
    s, a = _seq(rng, B, T, 4), rng.uniform(0, 1, (B, T, 1)).astype(np.float32)
    ref_a = jax.jit(lambda p, s: jrec.RecurrentActor().apply({"params": p}, s))(jax_state.actor, s)
    ref_q = jax.jit(lambda p, s, a: jrec.RecurrentCritic().apply({"params": p}, s, a))(
        jax_state.critic, s, a
    )
    port = _port(jax_state)
    with torch.no_grad():
        got_a = port.actor(torch.from_numpy(s))
        got_q = port.critic(torch.from_numpy(s), torch.from_numpy(a))
    assert got_a.shape == (B, T, 1) and got_q.shape == (B,)
    np.testing.assert_allclose(got_a.numpy(), np.asarray(ref_a), atol=1e-6)
    np.testing.assert_allclose(got_q.numpy(), np.asarray(ref_q), rtol=1e-5)
    # The exploring act: the actor's sequence plus OU noise, clipped.
    ou = rng.normal(0, 0.5, (B, T, 1)).astype(np.float32)
    cfg = jcfg.DDPGConfig()
    ref_act = jax.jit(lambda st, s, ou: jrec.recurrent_ddpg_act(cfg, st, s, ou))(jax_state, s, ou)
    got_act = trec.recurrent_ddpg_act(tcfg.DDPGConfig(), port, torch.from_numpy(s), torch.from_numpy(ou))
    np.testing.assert_allclose(got_act.numpy(), np.asarray(ref_act), atol=1e-6)
    assert float(got_act.min()) >= 0.0 and float(got_act.max()) <= 1.0


def test_step_scan_equals_sequence(jax_state):
    """The serving step from the fresh carry, slot by slot, equals the whole
    sequence, and one step equals the JAX package's step."""
    rng = np.random.default_rng(2)
    s = _seq(rng, B, T, 4)
    port = _port(jax_state)
    with torch.no_grad():
        full = port.actor(torch.from_numpy(s))[..., 0]
        hidden = trec.recurrent_actor_init_hidden((B,), 100, device="cpu")
        steps = []
        for t in range(T):
            a, hidden = trec.recurrent_actor_step(port.actor, torch.from_numpy(s[:, t]), hidden)
            steps.append(a)
    assert hidden.shape == (B, trec.actor_hidden_dim(100))
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(), full.numpy(), atol=1e-6)
    h0 = _seq(rng, B, 400)
    ref_a, ref_h = jax.jit(jrec.recurrent_actor_step)(jax_state.actor, s[:, 0], h0)
    with torch.no_grad():
        got_a, got_h = trec.recurrent_actor_step(port.actor, torch.from_numpy(s[:, 0]), torch.from_numpy(h0))
    np.testing.assert_allclose(got_a.numpy(), np.asarray(ref_a), atol=1e-6)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(ref_h), atol=1e-6)


def _assert_params(got, ref, what, rtol=1e-5, atol=1e-7):
    """``tests/test_torch_ddpg.py``'s rule: every leaf at (rtol, atol), except entries whose
    bias-corrected first moment in the reference's Adam is below 100 eps,
    held at 1e-2 of a learning-rate step; targets at (rtol, atol); Adam's
    counts equal."""
    d = tcfg.DDPGConfig()
    for name, lr in (("actor", d.actor_lr), ("critic", d.critic_lr)):
        adam = getattr(ref, f"{name}_opt")[0]
        t = int(np.asarray(adam.count))
        for (path, g), r, mu in zip(
            jax.tree_util.tree_leaves_with_path(getattr(got, name)),
            jax.tree.leaves(getattr(ref, name)),
            jax.tree.leaves(adam.mu),
        ):
            err = f"{what} {name}{jax.tree_util.keystr(path)}"
            ill = np.abs(mu) / (1.0 - 0.9**t) < 100 * ADAM_EPS
            np.testing.assert_allclose(g[~ill], r[~ill], rtol=rtol, atol=atol, err_msg=err)
            np.testing.assert_allclose(g[ill], r[ill], rtol=0, atol=1e-2 * lr, err_msg=err)
        for (path, g), r in zip(
            jax.tree_util.tree_leaves_with_path(getattr(got, f"{name}_target")),
            jax.tree.leaves(getattr(ref, f"{name}_target")),
        ):
            np.testing.assert_allclose(g, r, rtol=rtol, atol=atol, err_msg=f"{what} target{path}")
        np.testing.assert_array_equal(getattr(got, f"{name}_opt")[0].count, adam.count)


def test_learn_step_matches_jax(jax_state):
    rng = np.random.default_rng(3)
    obs, nxt = _seq(rng, B, T, 4), _seq(rng, B, T, 4)
    act = rng.uniform(0, 1, (B, T, 1)).astype(np.float32)
    r = rng.normal(-2.0, 0.5, (B,)).astype(np.float32)
    cfg_j = jcfg.DDPGConfig()
    ref, ref_loss = jax.jit(lambda st, *a: jrec.recurrent_ddpg_learn(cfg_j, st, *a))(
        jax.tree.map(jnp.asarray, jax_state), obs, act, r, nxt
    )
    port = _port(jax_state)
    port, loss = trec.recurrent_ddpg_learn(
        tcfg.DDPGConfig(), port, *(torch.from_numpy(x) for x in (obs, act, r, nxt))
    )
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    _assert_params(state_to_numpy(port), jax.tree.map(np.asarray, ref), "learn")


def test_lstm_conversion_round_trips_bit_for_bit(jax_state):
    back = state_to_numpy(_port(jax_state))
    assert type(back).__name__ == "RecurrentDDPGState"
    got, ref = jax.tree_util.tree_flatten_with_path(back)[0], jax.tree_util.tree_flatten_with_path(jax_state)[0]
    assert [jax.tree_util.keystr(p) for p, _ in got] == [jax.tree_util.keystr(p) for p, _ in ref]
    for (path, g), (_, r) in zip(got, ref):
        assert np.asarray(g).dtype == np.asarray(r).dtype, jax.tree_util.keystr(path)
        np.testing.assert_array_equal(g, r, err_msg=jax.tree_util.keystr(path))


def _cfg(mod, A):
    return mod.default_config(sim=mod.SimConfig(n_agents=A), train=mod.TrainConfig(seed=3))


def _jax_ou_normals(k_ep, A, n):
    keys = jax.random.split(k_ep, n)
    return np.asarray(jax.vmap(lambda k: jax.random.normal(k, (A,)))(keys))


def test_rollout_day_matches_jax(jax_state):
    """Eight slots of one day (36-43) at A=2 from the trainer's initial
    state, the JAX rollout's OU normals injected."""
    A, window = 2, slice(36, 44)
    cfg_j, cfg_t = _cfg(jcfg, A), _cfg(tcfg, A)
    traces = synthetic_traces(n_days=1)
    ratings = make_ratings(cfg_j, np.random.default_rng(3))
    arrays = j_build_arrays(cfg_j, traces, ratings)
    day = type(arrays)(*(x[window] for x in arrays))
    phys = j_init_physical(cfg_j, jax.random.PRNGKey(4))
    key = jax.random.PRNGKey(5)
    ref = jax.jit(lambda p, ph, d, k: jtr.rollout_day(cfg_j, p, ph, d, ratings, k))(
        jax_state.actor, phys, day, key
    )
    port = _port(jax_state)
    got = ttr.rollout_day(
        cfg_t, port.actor,
        state_from_jax(jax.tree.map(np.asarray, phys), device="cpu"),
        state_from_jax(jax.tree.map(np.asarray, day), device="cpu"),
        tcom.ratings_to(ratings, device="cpu"),
        torch.from_numpy(np.array(_jax_ou_normals(key, A, 8))),
    )
    for name in ("obs_seq", "act_seq", "reward_seq", "cost_eur", "hidden"):
        np.testing.assert_allclose(
            getattr(got, name).numpy(), np.asarray(getattr(ref, name)), rtol=1e-5, atol=1e-6,
            err_msg=name,
        )
    np.testing.assert_allclose(got.phys.t_in.numpy(), np.asarray(ref.phys.t_in), rtol=1e-5)


def test_three_days_of_training_match_jax():
    """train_recurrent_community for 3 days at A=2 from the JAX run's own
    init, initial temperatures and OU normals: day rewards, day costs and
    the two losses at rtol=2e-4."""
    A, E = 2, 3
    cfg_j, cfg_t = _cfg(jcfg, A), _cfg(tcfg, A)
    traces = synthetic_traces(n_days=E)
    key = jax.random.PRNGKey(11)
    ref = jtr.train_recurrent_community(cfg_j, E, key, traces=traces)
    # The JAX trainer's key chain (train/recurrent.py:202-216).
    key2, k_init, k_phys = jax.random.split(key, 3)
    state0 = jax.tree.map(np.asarray, jrec.recurrent_ddpg_init(cfg_j.ddpg, k_init, seq_len=96))
    k1, k2 = jax.random.split(k_phys)
    normals = np.stack([np.asarray(jax.random.normal(k1, (A,))), np.asarray(jax.random.normal(k2, (A,)))])
    ou = np.stack([_jax_ou_normals(jax.random.fold_in(key2, e), A, 96) for e in range(E)])
    got = ttr.train_recurrent_community(
        cfg_t, E, traces=traces, state=_port(state0),
        draws=ttr.RecurrentDraws(torch.from_numpy(normals), torch.from_numpy(ou)), device="cpu",
    )
    np.testing.assert_allclose(got.day_rewards, ref.day_rewards, rtol=2e-4)
    np.testing.assert_allclose(got.day_costs, ref.day_costs, rtol=2e-4)
    np.testing.assert_allclose(got.losses, ref.losses, rtol=2e-4)


def test_trainer_refuses_one_day_and_missing_draws():
    cfg = _cfg(tcfg, 2)
    with pytest.raises(ValueError, match="episodes must be >= 2"):
        ttr.train_recurrent_community(cfg, 1, torch.Generator(), device="cpu")
    with pytest.raises(ValueError, match="Generator or RecurrentDraws"):
        ttr.train_recurrent_community(cfg, 2, device="cpu")


def test_generator_path_is_deterministic_and_checkpoints(tmp_path):
    """Same seed, same run; the state checkpoints under the
    ``ddpg_recurrent`` layout and restores structure-free."""
    from p2pmicrogrid_tpu_torch.train.checkpoint import restore_raw

    cfg = _cfg(tcfg, 2)
    traces = synthetic_traces(n_days=2)
    runs = [
        ttr.train_recurrent_community(cfg, 2, torch.Generator().manual_seed(0), traces=traces, device="cpu")
        for _ in range(2)
    ]
    np.testing.assert_array_equal(runs[0].day_rewards, runs[1].day_rewards)
    np.testing.assert_array_equal(runs[0].losses, runs[1].losses)
    step = ttr.save_recurrent_checkpoint(str(tmp_path), cfg, runs[0].state, 1)
    assert "models_ddpg_recurrent" in step
    raw, episode, _ = restore_raw(ttr.recurrent_checkpoint_dir(str(tmp_path), cfg.setting))
    assert episode == 1
    np.testing.assert_array_equal(
        raw["actor"]["OptimizedLSTMCell_0"]["hf"]["bias"],
        runs[0].state.actor.OptimizedLSTMCell_0.hf.bias.detach().numpy(),
    )


def test_seed0_recurrent_init_is_pinned():
    """The seed-0 recurrent init on this machine's CPU hashes to the digest
    ``chip_smoke.py`` phase 10 compares the card machine's with."""
    from p2pmicrogrid_tpu_torch.draw_digests import PINNED_RECURRENT, recurrent_init_digest

    assert recurrent_init_digest() == PINNED_RECURRENT
