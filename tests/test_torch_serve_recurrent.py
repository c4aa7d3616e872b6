"""Recurrent bundles on the port's CPU engine: the recurrent cases of the JAX
package's ``tests/test_continuous.py`` (the engine's carry contract, the
continuous batcher's hidden-state ring: continuity, serialization,
generations, eviction re-init, slot exhaustion, timeouts, cancellation,
anonymous requests), the gateway's fronts, the train -> checkpoint ->
export -> serve chain, and bundles crossing both ways between the two
packages (``atol=1e-6``, ``tests/test_continuous.py:92-109``).
"""

import jax
import numpy as np
import pytest
import torch

from p2pmicrogrid_tpu import config as jcfg
from p2pmicrogrid_tpu.models.ddpg_recurrent import recurrent_ddpg_init as j_init
from p2pmicrogrid_tpu.serve import PolicyEngine as JPolicyEngine
from p2pmicrogrid_tpu.serve import export_policy_bundle as j_export
from p2pmicrogrid_tpu_torch import config as tc
from p2pmicrogrid_tpu_torch.convert import state_from_jax
from p2pmicrogrid_tpu_torch.models.ddpg_recurrent import recurrent_ddpg_init
from p2pmicrogrid_tpu_torch.serve import (
    ContinuousBatcher,
    MicroBatchQueue,
    PolicyEngine,
    build_bundle,
    export_policy_bundle,
    load_policy_bundle,
)

AR = 2  # community size (the JAX tests' recurrent size)
WAIT = 30


def _cfg(mod, impl="ddpg_recurrent"):
    return mod.default_config(
        sim=mod.SimConfig(n_agents=AR), train=mod.TrainConfig(implementation=impl)
    )


def _obs(n, seed=0):
    rng = np.random.default_rng(seed)
    obs = np.empty((n, AR, 4), dtype=np.float32)
    obs[..., 0] = rng.uniform(0, 1, (n, AR))
    obs[..., 1:] = rng.uniform(-1, 1, (n, AR, 3))
    return obs


@pytest.fixture(scope="module")
def jax_state():
    st = j_init(jcfg.DDPGConfig(), jax.random.PRNGKey(0), seq_len=8)
    return jax.tree.map(np.asarray, st)


@pytest.fixture(scope="module")
def recurrent_bundle(tmp_path_factory, jax_state):
    """One port-exported recurrent bundle and its CPU engine."""
    state = state_from_jax(jax_state, device="cpu", cfg=tc.DDPGConfig())
    path = export_policy_bundle(
        _cfg(tc), state, str(tmp_path_factory.mktemp("rb") / "b"), device="cpu"
    )
    return path, PolicyEngine(bundle_dir=path, max_batch=4, device="cpu"), state


def _fresh(engine, n=1):
    return engine.init_hidden(n)


def test_manifest_records_hidden_state(recurrent_bundle):
    path, engine, _ = recurrent_bundle
    manifest, _ = load_policy_bundle(path)
    hs = manifest["hidden_state"]
    assert hs["shape"] == [400] and hs["dtype"] == "float32" and hs["init"] == "zeros"
    assert hs["layout"] == ["pass1_c", "pass1_h", "pass2_c", "pass2_h"]
    assert manifest["model"] == {
        "actor": "recurrent_lstm", "hidden_pre": 20, "lstm_features": 100, "hidden_post": 20,
    }
    assert engine.is_recurrent and engine.hidden_dim == 400


def test_act_threads_hidden_and_matches_full_sequence(recurrent_bundle):
    _, engine, state = recurrent_bundle
    T = 3
    seq = _obs(T, seed=3)
    h = _fresh(engine)
    acts = []
    for t in range(T):
        a, h = engine.act(seq[t][None], h)
        acts.append(a[0])
    with torch.no_grad():
        ref = state.actor(torch.from_numpy(np.transpose(seq, (1, 0, 2))))[..., 0].T
    np.testing.assert_allclose(np.stack(acts), ref.numpy(), atol=1e-6)


def test_carry_refusals(recurrent_bundle, tmp_path):
    path, engine, _ = recurrent_bundle
    with pytest.raises(ValueError, match="hidden carry"):
        engine.act(_obs(1))
    with pytest.raises(ValueError, match=r"hidden carry must be \[1, 2, 400\]"):
        engine.act(_obs(1), np.zeros((1, AR, 4), np.float32))
    with pytest.raises(ValueError, match="ContinuousBatcher"):
        MicroBatchQueue(engine)
    with pytest.raises(ValueError, match="sessions"):
        ContinuousBatcher(engine, sessions=False, autostart=False)
    with pytest.raises(ValueError, match="ContinuousBatcher"):
        build_bundle(path, device="cpu", batching="micro")
    cfg = _cfg(tc, "tabular")
    from p2pmicrogrid_tpu_torch.train.policies import init_policy_state

    ff = export_policy_bundle(cfg, init_policy_state(cfg, "cpu"), str(tmp_path / "t"), device="cpu")
    ff_engine = PolicyEngine(bundle_dir=ff, max_batch=4, device="cpu")
    with pytest.raises(ValueError, match="feedforward"):
        ff_engine.act(_obs(1), hidden=np.zeros((1, AR, 4), np.float32))
    with pytest.raises(ValueError, match="feedforward"):
        ff_engine.init_hidden(1)


def test_int8_export_refused():
    state = recurrent_ddpg_init(tc.DDPGConfig(), torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="int8"):
        export_policy_bundle(_cfg(tc), state, "never-written", dtype="int8", device="cpu")


def test_sessions_carry_hidden_through_the_step(recurrent_bundle):
    _, engine, _ = recurrent_bundle
    sessions = engine.init_sessions(2)
    assert sessions.hidden.shape == (2, AR, 400)
    obs = _obs(2, seed=5)
    sessions, a1 = engine.step(sessions, obs)
    sessions, a2 = engine.step(sessions, obs)
    assert not np.array_equal(a1, a2)
    assert float(sessions.hidden.abs().max()) > 0
    # The step equals act on the same carry.
    h = _fresh(engine, 2)
    b1, h = engine.act(obs, h)
    b2, h = engine.act(obs, h)
    np.testing.assert_array_equal(a2, b2)
    np.testing.assert_array_equal(sessions.hidden.numpy(), h)


def test_generation_counter_protects_retired_row(recurrent_bundle):
    _, engine, _ = recurrent_bundle
    obs = _obs(4, seed=13)
    with ContinuousBatcher(engine, max_slots=1) as cb:
        a_first = cb.submit(obs[0], household="alice").result(WAIT)
        info0 = cb.session_info("alice")
        assert cb.end_session("alice")
        cb.submit(obs[1], household="bob").result(WAIT)
        info_bob = cb.session_info("bob")
        assert info_bob["slot"] == info0["slot"] and info_bob["gen"] > info0["gen"]
        a_again = cb.submit(obs[0], household="alice").result(WAIT)
        info1 = cb.session_info("alice")
    np.testing.assert_array_equal(a_again, a_first)
    assert info1["gen"] > info0["gen"] and info1["served"] == 1


def test_eviction_reinit_bit_exact(recurrent_bundle):
    _, engine, _ = recurrent_bundle
    obs = _obs(2, seed=17)
    want = [engine.act(obs[i][None], _fresh(engine))[0][0] for i in range(2)]
    with ContinuousBatcher(engine, max_slots=1) as cb:
        for _ in range(2):
            for i, h in enumerate(("a", "b")):
                np.testing.assert_array_equal(cb.submit(obs[i], household=h).result(WAIT), want[i])
        assert cb.stats["evictions"] >= 3


def test_recurrent_continuity_across_request_sequence(recurrent_bundle):
    _, engine, _ = recurrent_bundle
    T = 4
    seq, noise = _obs(T, seed=19), _obs(T, seed=23)
    with ContinuousBatcher(engine, max_slots=4) as cb:
        got = []
        for t in range(T):
            f_main = cb.submit(seq[t], household="main")
            f_other = cb.submit(noise[t], household=f"other-{t % 2}")
            got.append(f_main.result(WAIT))
            f_other.result(WAIT)
        info = cb.session_info("main")
    h, want = _fresh(engine), []
    for t in range(T):
        a, h = engine.act(seq[t][None], h)
        want.append(a[0])
    np.testing.assert_allclose(np.stack(got), np.stack(want), atol=1e-6)
    assert info["served"] == T and info["gen"] == 0


def test_same_household_requests_serialize_in_order(recurrent_bundle):
    _, engine, _ = recurrent_bundle
    T = 3
    seq = _obs(T, seed=29)
    with ContinuousBatcher(engine, max_slots=2, autostart=False) as cb:
        futs = [cb.submit(seq[t], household="hh") for t in range(T)]
        for _ in range(T):
            assert cb.step_once() == 1  # one household never steps twice in a batch
        got = [f.result(1) for f in futs]
        assert cb.session_info("hh")["served"] == T
    h = _fresh(engine)
    for t in range(T):
        a, h = engine.act(seq[t][None], h)
        np.testing.assert_allclose(got[t], a[0], atol=1e-6)


def test_slot_exhaustion_defers_never_scratches(recurrent_bundle):
    _, engine, _ = recurrent_bundle
    obs = _obs(2, seed=61)
    with ContinuousBatcher(engine, max_slots=1, autostart=False) as cb:
        fa = cb.submit(obs[0], household="a")
        fb = cb.submit(obs[1], household="b")
        assert cb.step_once() == 1
        assert cb.stats["slot_deferrals"] == 1 and cb.stats["scratch_rows"] == 0
        a1 = fa.result(1)
        assert not fb.done()
        assert cb.step_once() == 1
        b1 = fb.result(1)
        assert cb.stats["evictions"] == 1 and cb.session_info("b")["served"] == 1
    want = engine.act(obs, _fresh(engine, 2))[0]
    np.testing.assert_array_equal(a1, want[0])
    np.testing.assert_array_equal(b1, want[1])


def test_slot_wait_timeout_fails_loudly_naming_the_fix(recurrent_bundle):
    _, engine, _ = recurrent_bundle
    obs = _obs(2, seed=67)
    with ContinuousBatcher(engine, max_slots=1, autostart=False, slot_wait_timeout_s=0.0) as cb:
        fa = cb.submit(obs[0], household="a")
        fb = cb.submit(obs[1], household="b")
        assert cb.step_once() == 1
        fa.result(1)
        with pytest.raises(RuntimeError, match="max-sessions"):
            fb.result(1)
        assert cb.stats["slot_wait_expired"] == 1 and cb.depth == 0


def test_cancelled_requests_are_pruned_not_stepped(recurrent_bundle):
    _, engine, _ = recurrent_bundle
    obs = _obs(2, seed=71)
    with ContinuousBatcher(engine, max_slots=2, autostart=False) as cb:
        f1 = cb.submit(obs[0], household="h")
        f2 = cb.submit(obs[1], household="h")
        assert f2.cancel()
        assert cb.step_once() == 1
        f1.result(1)
        assert cb.stats["cancelled_drops"] == 1 and cb.depth == 0
        assert cb.session_info("h")["served"] == 1


def test_anonymous_requests_serve_fresh_carry(recurrent_bundle):
    _, engine, _ = recurrent_bundle
    obs = _obs(1, seed=31)
    want = engine.act(obs, _fresh(engine))[0]
    with ContinuousBatcher(engine, max_slots=2) as cb:
        a1 = cb.submit(obs[0]).result(WAIT)
        a2 = cb.submit(obs[0]).result(WAIT)
        assert cb.stats["scratch_rows"] == 2
    np.testing.assert_array_equal(a1, want[0])
    np.testing.assert_array_equal(a2, want[0])


def test_gateway_front_serves_recurrent_households(recurrent_bundle):
    """The gateway's continuous front: two requests of one household answer
    differently (the carry moves), an anonymous one answers as the
    household's first."""
    path, engine, _ = recurrent_bundle
    eng, queue, tel = build_bundle(path, device="cpu", batching="continuous", max_batch=4)
    try:
        obs = _obs(1, seed=41)[0]
        first = queue.submit(obs, household="h1").result(WAIT)
        second = queue.submit(obs, household="h1").result(WAIT)
        anon = queue.submit(obs).result(WAIT)
    finally:
        queue.close()
        tel.close()
    assert not np.array_equal(first, second)
    np.testing.assert_array_equal(anon, first)
    np.testing.assert_array_equal(first, engine.act(obs[None], _fresh(engine))[0][0])


def test_bundles_cross_both_ways(tmp_path, jax_state):
    """A JAX-exported recurrent bundle serves in the port, and a
    port-exported one in the JAX engine: the same carried actions."""
    obs = _obs(3, seed=47)
    j_path = j_export(_cfg(jcfg), jax.tree.map(jax.numpy.asarray, jax_state), str(tmp_path / "j"))
    state = state_from_jax(jax_state, device="cpu", cfg=tc.DDPGConfig())
    t_path = export_policy_bundle(_cfg(tc), state, str(tmp_path / "t"), dtype="float16", device="cpu")
    for served_by_port, path in ((True, j_path), (False, t_path)):
        port = PolicyEngine(bundle_dir=path, max_batch=4, device="cpu")
        ref = JPolicyEngine(bundle_dir=path, max_batch=4, device="cpu")
        assert port.manifest["hidden_state"] == ref.manifest["hidden_state"]
        h_p, h_r = port.init_hidden(3), np.asarray(ref.init_hidden(3))
        for _ in range(2):
            a_p, h_p = port.act(obs, h_p)
            a_r, h_r = ref.act(obs, h_r)
            np.testing.assert_allclose(a_p, np.asarray(a_r), atol=1e-6, err_msg=f"port={served_by_port}")
            np.testing.assert_allclose(h_p, np.asarray(h_r), atol=1e-6)


def test_train_checkpoint_export_serve(tmp_path):
    """train_recurrent_community -> checkpoint -> export_bundle_from_checkpoint
    -> engine: the served action is the trained actor's."""
    from p2pmicrogrid_tpu_torch.data.traces import synthetic_traces
    from p2pmicrogrid_tpu_torch.serve import export_bundle_from_checkpoint
    from p2pmicrogrid_tpu_torch.train.recurrent import (
        recurrent_checkpoint_dir,
        save_recurrent_checkpoint,
        train_recurrent_community,
    )

    cfg = _cfg(tc)
    res = train_recurrent_community(
        cfg, 2, torch.Generator().manual_seed(3), traces=synthetic_traces(n_days=2), device="cpu"
    )
    save_recurrent_checkpoint(str(tmp_path), cfg, res.state, 2)
    path = export_bundle_from_checkpoint(
        cfg, recurrent_checkpoint_dir(str(tmp_path), cfg.setting), str(tmp_path / "b"), device="cpu"
    )
    engine = PolicyEngine(bundle_dir=path, max_batch=2, device="cpu")
    obs = _obs(1, seed=53)
    a, h = engine.act(obs, engine.init_hidden(1))
    with torch.no_grad():
        ref = res.state.actor(torch.from_numpy(obs[0][:, None, :]))[:, 0, 0]
    np.testing.assert_allclose(a[0], ref.numpy(), atol=1e-6)
    assert float(np.abs(h).max()) > 0


def test_ring_under_concurrent_households(recurrent_bundle):
    """16 threads, each one household's stream of 6 requests, against the
    worker thread with a short switch interval: every household's answers
    are its own carry's (``engine.act`` threaded), none lost or crossed."""
    import sys
    import threading

    _, engine, _ = recurrent_bundle
    n_threads, n_steps = 16, 6
    obs = _obs(n_threads * n_steps, seed=83).reshape(n_threads, n_steps, AR, 4)
    got = {}
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with ContinuousBatcher(engine, max_slots=n_threads) as cb:

            def household(i):
                got[i] = [cb.submit(obs[i, t], household=f"h{i}").result(WAIT) for t in range(n_steps)]

            threads = [threading.Thread(target=household, args=(i,)) for i in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(60)
            assert not any(t.is_alive() for t in threads)
            assert cb.stats["evictions"] == 0 and cb.stats["stale_generation_drops"] == 0
    finally:
        sys.setswitchinterval(interval)
    for i in range(n_threads):
        h = _fresh(engine)
        for t in range(n_steps):
            a, h = engine.act(obs[i, t][None], h)
            np.testing.assert_allclose(got[i][t], a[0], atol=1e-6, err_msg=f"household {i} step {t}")
