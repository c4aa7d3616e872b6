"""The port's CUDA kernels on the card against their plain versions: K1
(``ops/merged_min.py``), K2-K6 (``ops/matrix_market.py``) and K7
(``ops/slot_fused.py``); shared DDPG's act and learn step, the chunked
trainer's graph, and the single community's episodes on the card against
the port on the CPU.

Marked ``cuda``: it skips without a CUDA device (a CUDA kernel has no CPU
mode). This file imports neither JAX nor the JAX package, so it also runs on
a machine without them: ``python -m pytest --noconftest tests/test_torch_cuda.py``.
"""

import pytest
import torch

from p2pmicrogrid_tpu_torch.ops import matrix_market as mm
from p2pmicrogrid_tpu_torch.ops.merged_min import merged_min_sums, merged_min_sums_plain


@pytest.fixture
def cuda_generator():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA kernel has no CPU mode")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    return gen


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 1000), (256, 50), (2048, 50), (3, 7)])
def test_merged_min_kernel_matches_plain(cuda_generator, shape):
    """At the main path's shapes and a ragged small one; zero factors give
    exactly 0, and a repeat launch is bit-identical."""
    S, A = shape
    rand = lambda: torch.rand((S, A), generator=cuda_generator, device="cuda")
    args = [rand() for _ in range(4)] + [(rand() > 0.5).float() for _ in range(2)]
    args[0][0] = 0.0
    args[3][0] = 0.0
    before = merged_min_sums.launches
    row, col = merged_min_sums(*args)
    row2, col2 = merged_min_sums(*args)
    torch.cuda.synchronize()
    assert merged_min_sums.launches == before + 2
    for got, ref in zip((row, col), merged_min_sums_plain(*args)):
        scale = float(ref.abs().max())
        # Sums of up to A positive terms in another order than torch.sum's.
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6 * scale)
    assert float(row[0].abs().max()) == 0.0  # alpha = gamma = 0 in scenario 0
    assert torch.equal(row, row2) and torch.equal(col, col2)


@pytest.mark.cuda
def test_wrapper_rejects_bad_inputs(cuda_generator):
    x = torch.rand((4, 8), generator=cuda_generator, device="cuda")
    good = [x] * 6
    with pytest.raises(ValueError, match="float32"):
        merged_min_sums(*good[:5], x.double())
    with pytest.raises(ValueError, match="shape"):
        merged_min_sums(*good[:5], x[:, :4].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        merged_min_sums(*good[:5], x.t().contiguous().t())


def _matrix_inputs(S, A, dtype, gen):
    """Proposals ~1e3 W with the edge cases of tests/test_pallas.py (a zero
    row, an all-same-sign scenario, a zero out_power) and a tied scenario."""
    randn = lambda *shape: torch.randn(shape, generator=gen, device="cuda") * 1e3
    p2p, out, prev = randn(S, A, A), randn(S, A), randn(S, A)
    p2p[0, 0, :] = 0.0
    out[-1, 0] = 0.0
    if S > 1:
        p2p[1] = p2p[1].abs()
        p2p[-1] = p2p[-1] - p2p[-1].t()
        prev[1] = 0.0
    return p2p.to(dtype).contiguous(), out, prev


def _close_sums(got, ref, terms):
    """Sums of A terms in another order than torch.sum's: rtol=1e-5, atol of
    1e-6 times the largest sum of magnitudes (results may cancel to 0)."""
    scale = float(terms.abs().sum(dim=-1).max())
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6 * scale)


def _close_matrix(got, ref):
    # float32: rtol=1e-5, atol=1e-3 (tests/test_pallas.py:55-98); bfloat16:
    # one bfloat16 ulp, since the unrounded values may differ in the last bits.
    assert got.dtype == ref.dtype
    rtol = 1e-5 if got.dtype == torch.float32 else 8e-3
    torch.testing.assert_close(got.float(), ref.float(), rtol=rtol, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape,dtype",
    [
        ((64, 1000), torch.bfloat16),
        ((64, 1000), torch.float32),
        ((256, 50), torch.float32),
        ((3, 7), torch.float32),
        ((3, 7), torch.bfloat16),
        ((5, 257), torch.bfloat16),
        ((5, 257), torch.float32),
        ((2, 65), torch.float32),
    ],
)
def test_matrix_kernels_match_plain(cuda_generator, shape, dtype):
    """K5, K4, K3, K2 and K6 at the matrix path's shapes, ragged small ones,
    and shapes that cross K4's stripe and K6's 64-agent tile edges; each
    launch is counted once, and a repeat launch is bit-identical."""
    S, A = shape
    p2p, out, prev = _matrix_inputs(S, A, dtype, cuda_generator)
    calls = {
        mm.divide_rank1_fused: (prev, out, dtype),
        mm.divide_power_fused_with_mean: (p2p, out),
        mm.divide_power_fused: (p2p, out),
        mm.prep_mean: (p2p,),
        mm.clear_market_fused: (p2p,),
    }
    plain = {
        mm.divide_rank1_fused: mm.divide_rank1_fused_plain,
        mm.divide_power_fused_with_mean: mm.divide_power_fused_with_mean_plain,
        mm.divide_power_fused: mm.divide_power_fused_plain,
        mm.prep_mean: mm.prep_mean_plain,
        mm.clear_market_fused: mm.clear_market_fused_plain,
    }
    for fn, args in calls.items():
        before = fn.launches
        got, again = fn(*args), fn(*args)
        torch.cuda.synchronize()
        assert fn.launches == before + 2
        ref = plain[fn](*args)
        got, again, ref = (x if isinstance(x, tuple) else (x,) for x in (got, again, ref))
        for g, a in zip(got, again):
            assert torch.equal(g, a), fn.__name__
        if fn is mm.clear_market_fused:
            for g, r in zip(got, ref):
                _close_sums(g, r, p2p.float())
        elif fn is mm.prep_mean:
            _close_sums(got[0], ref[0], p2p.float().transpose(-1, -2) / A)
        else:
            _close_matrix(got[0], ref[0])
            if len(got) > 1:
                _close_sums(got[1], ref[1], ref[0].float().transpose(-1, -2) / A)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "A,dtype,rows",
    [(3000, torch.bfloat16, 8), (7100, torch.float32, 8), (7300, torch.float32, 0)],
)
def test_divide_mean_large_a(cuda_generator, A, dtype, rows):
    """K4 where its stripe shrinks to 8 rows (one 16-byte unit a row in
    bfloat16; nearly all of a block's shared memory in float32), and past
    that, where the wrapper takes the two-pass kernel: the same function
    either way."""
    p2p, out, _ = _matrix_inputs(1, A, dtype, cuda_generator)
    config = mm.kernel_config("divide_power_fused_with_mean", 1, A, dtype, p2p.device)
    assert config["rows"] == rows, config
    before = mm.divide_power_fused_with_mean.launches
    new, mean = mm.divide_power_fused_with_mean(p2p, out)
    again = mm.divide_power_fused_with_mean(p2p, out)
    torch.cuda.synchronize()
    assert mm.divide_power_fused_with_mean.launches == before + 2
    assert torch.equal(new, again[0]) and torch.equal(mean, again[1])
    ref_new, ref_mean = mm.divide_power_fused_with_mean_plain(p2p, out)
    _close_matrix(new, ref_new)
    _close_sums(mean, ref_mean, ref_new.float().transpose(-1, -2) / A)


@pytest.mark.cuda
def test_matrix_wrappers_reject_bad_inputs(cuda_generator):
    p2p, out, prev = _matrix_inputs(4, 8, torch.float32, cuda_generator)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        mm.clear_market_fused(p2p.double())
    with pytest.raises(ValueError, match="shape"):
        mm.prep_mean(p2p[:, :, :4].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        mm.divide_power_fused(p2p.transpose(1, 2), out)
    with pytest.raises(ValueError, match="float32"):
        mm.divide_power_fused_with_mean(p2p, out.double())
    with pytest.raises(ValueError, match="shape"):
        mm.divide_rank1_fused(prev, out[:, :4].contiguous())
    with pytest.raises(ValueError, match="out_dtype"):
        mm.divide_rank1_fused(prev, out, torch.float16)


# --- K7: the fused slot ---------------------------------------------------------

SLOT_VARIANTS = [
    dict(rounds=1, market_impl="factored"),
    dict(rounds=1, market_impl="factored", market_dtype="bfloat16"),
    dict(rounds=0, market_impl="factored"),
    dict(rounds=2, market_impl="matrix"),
    dict(trading=False),
    dict(rounds=3, market_impl="matrix"),
]
SLOT_IDS = ["factored_r1", "factored_r1_bf16", "factored_r0", "matrix_r2", "no_trading", "matrix_r3"]


def _slot_inputs(impl, S, A, sim, gen, t=44):
    """One slot's inputs on the card: the path's own traces and ratings at
    11:00, when every agent's PV exceeds its load, a random Q-table (tabular)
    or freshly initialised networks (DQN), random initial temperatures and
    draws, epsilon 0.3 so that both greedy and explored agents occur. Half
    of the batteries are full, the others anywhere in [min_soc, max_soc]: a
    full battery cannot store the surplus, so the market is two-sided."""
    import numpy as np

    from p2pmicrogrid_tpu_torch import config as tc
    from p2pmicrogrid_tpu_torch.envs import community as com
    from p2pmicrogrid_tpu_torch.parallel import scenarios as sc
    from p2pmicrogrid_tpu_torch.train import init_policy_state

    cfg = tc.default_config(
        sim=tc.SimConfig(n_agents=A, n_scenarios=S, **sim),
        battery=tc.BatteryConfig(enabled=True),
        train=tc.TrainConfig(implementation=impl),
    )
    ratings = com.make_ratings(cfg, np.random.default_rng(0))
    arrays = sc.stack_scenario_arrays(cfg, sc.make_scenario_traces(cfg, seed=0), ratings, "cuda")
    xs = tuple(x[:, t].contiguous() for x in arrays)
    pol = init_policy_state(cfg, device="cuda", generator=gen)
    if impl == "tabular":
        pol = pol._replace(q_table=torch.randn(pol.q_table.shape, generator=gen, device="cuda") * 0.1)
    pol = pol._replace(epsilon=torch.tensor(0.3, device="cuda"))
    phys = com.init_physical(cfg, torch.randn((S, 2, A), generator=gen, device="cuda"), (S,), "cuda")
    bat = cfg.battery
    u = torch.rand((S, A), generator=gen, device="cuda")
    phys = phys._replace(soc=torch.clamp(bat.min_soc + (bat.max_soc - bat.min_soc) * 2 * u, max=bat.max_soc))
    R = cfg.sim.rounds + 1 if cfg.sim.trading else 1
    draws = (
        torch.rand((R, S, A), generator=gen, device="cuda"),
        torch.randint(0, 3, (R, S, A), generator=gen, device="cuda"),
    )
    market = sim.get("market_impl") if cfg.sim.trading else None
    dtype = torch.bfloat16 if sim.get("market_dtype") == "bfloat16" else None
    return cfg, (pol, phys, xs, draws, com.ratings_to(ratings, "cuda"), True, market, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["tabular", "dqn"])
@pytest.mark.parametrize("sim", SLOT_VARIANTS, ids=SLOT_IDS)
@pytest.mark.parametrize("shape", [(4, 37), (3, 300)])
def test_slot_kernel_matches_plain(cuda_generator, impl, sim, shape):
    """K7 against its plain version on the same card inputs, where buyers and
    sellers both trade: every decision and action equal, the continuous
    outputs within rtol=1e-5, atol=1e-3 (the sums over agents and the DQN
    forward run in another order), and a repeat launch bit-identical."""
    from p2pmicrogrid_tpu_torch.ops import slot_fused as sf

    S, A = shape
    cfg, args = _slot_inputs(impl, S, A, sim, cuda_generator)
    before = sf.slot_step_fused.launches
    got = sf.slot_raw(cfg, *args)
    again = sf.slot_raw(cfg, *args)
    torch.cuda.synchronize()
    assert sf.slot_step_fused.launches == before + 2
    ref = sf.slot_step_fused_plain(cfg, *args)
    if cfg.sim.trading:
        p = ref.p_p2p
        assert bool((p > 0).any()) and bool((p < 0).any()), "a one-sided market"
        assert float((p != 0).float().mean()) >= 0.02
    for name, g, a, r in zip(sf.SlotRaw._fields, got, again, ref):
        assert torch.equal(g, a), name
        assert g.shape == r.shape and g.dtype == r.dtype, name
        if name in ("aux", "hp_frac", "decisions"):
            assert torch.equal(g, r), name
        else:
            torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-3, msg=name)


@pytest.mark.cuda
def test_slot_wrapper_rejects_bad_inputs(cuda_generator):
    from p2pmicrogrid_tpu_torch.ops import slot_fused as sf

    cfg, args = _slot_inputs("tabular", 2, 8, SLOT_VARIANTS[0], cuda_generator)
    pol, phys, xs, draws, ratings = args[:5]
    rest = args[5:]
    with pytest.raises(ValueError, match="float32"):
        sf.slot_raw(cfg, pol, phys._replace(t_in=phys.t_in.double()), xs, draws, ratings, *rest)
    with pytest.raises(ValueError, match="shape"):
        sf.slot_raw(cfg, pol, phys._replace(soc=phys.soc[:, :4].contiguous()), xs, draws, ratings, *rest)
    with pytest.raises(ValueError, match="cuda"):
        sf.slot_raw(cfg, pol, phys._replace(t_bm=phys.t_bm.cpu()), xs, draws, ratings, *rest)
    with pytest.raises(ValueError, match="contiguous"):
        bad = tuple(x.t().contiguous().t() if x.dim() == 2 else x for x in xs)
        sf.slot_raw(cfg, pol, phys, bad, draws, ratings, *rest)
    with pytest.raises(ValueError, match="shape"):
        sf.slot_raw(cfg, pol, phys, xs, (draws[0][:1].contiguous(), draws[1]), ratings, *rest)


# --- shared DDPG: the act and the learn step ------------------------------------


def _ddpg_pair(share, cap):
    """A=6, S=3 shared DDPG state drawn on the CPU and its copy on the card,
    with a ring of 16 slots already filled with random transitions."""
    import numpy as np

    from p2pmicrogrid_tpu_torch import config as tc
    from p2pmicrogrid_tpu_torch.convert import state_from_jax, state_to_numpy
    from p2pmicrogrid_tpu_torch.parallel import scenarios as sc

    cfg = tc.default_config(
        sim=tc.SimConfig(n_agents=6, n_scenarios=3),
        train=tc.TrainConfig(implementation="ddpg"),
        ddpg=tc.DDPGConfig(buffer_size=16, batch_size=32, share_across_agents=share, learn_batch_cap=cap),
    )
    pol, scen = sc.init_shared_state(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    replay = scen.replay
    for buf in (replay.obs, replay.action, replay.reward, replay.next_obs):
        buf.copy_(torch.from_numpy(rng.uniform(-1.0, 1.0, tuple(buf.shape)).astype(np.float32)))
    scen = scen._replace(replay=replay._replace(cursor=0, count=16))
    move = lambda st: state_from_jax(state_to_numpy(st), device="cuda", cfg=cfg.ddpg)
    return cfg, (pol, scen), (move(pol), move(scen)), rng


@pytest.mark.cuda
@pytest.mark.parametrize("share,cap", [(True, None), (True, 40), (False, None)], ids=["shared", "striped", "per_agent"])
def test_ddpg_act_and_learn_step_match_cpu(cuda_generator, share, cap):
    """ddpg_shared_act and one _ddpg_update_shared step on the card against
    the port on the CPU, from the same state and draws, at the CPU tests'
    tolerances (tests/test_torch_ddpg.py); on the card both optimisers are
    capturable Adam (the step count on the device, the bias correction in
    float32), on the CPU torch's host-count Adam: actions and q rtol=1e-5,
    atol=1e-6, the OU state bit for bit (its fused multiply-adds are emulated
    in float64 on both); after the step parameters and targets rtol=1e-5,
    atol=1e-7 (1e-2 of a learning-rate step where the gradient is within two
    orders of Adam's eps), the per-scenario loss rtol=1e-4."""
    import numpy as np

    from p2pmicrogrid_tpu_torch.envs.community import SlotTransition
    from p2pmicrogrid_tpu_torch.models.ddpg import ddpg_shared_act
    from p2pmicrogrid_tpu_torch.parallel import scenarios as sc

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, (pol_c, scen_c), (pol_g, scen_g), rng = _ddpg_pair(share, cap)
    S, A = 3, 6
    f32 = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    obs, normals = rng.uniform(-1.0, 1.0, (S, A, 4)).astype(np.float32), f32(S, A)
    both = lambda x: (torch.from_numpy(x), torch.from_numpy(x).cuda())
    (obs_c, obs_g), (n_c, n_g) = both(obs), both(normals)
    a_c, q_c, ou_c = ddpg_shared_act(cfg.ddpg, pol_c, obs_c, scen_c.ou, n_c)
    a_g, q_g, ou_g = ddpg_shared_act(cfg.ddpg, pol_g, obs_g, scen_g.ou, n_g)
    torch.testing.assert_close(a_g.cpu(), a_c, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(q_g.cpu(), q_c, rtol=1e-5, atol=1e-6)
    assert torch.equal(ou_g.cpu(), ou_c)

    tr = SlotTransition(
        obs=obs, aux=rng.uniform(0.0, 1.0, (S, A)).astype(np.float32),
        reward=rng.normal(-20.0, 30.0, (S, A)).astype(np.float32), next_obs=f32(S, A, 4),
    )
    idx = rng.integers(0, 16, cfg.ddpg.batch_size)
    stripes = sc.ddpg_stripes(cfg, S, A)
    assert (stripes is not None) == (cap is not None)
    starts = None if stripes is None else rng.integers(0, 32 * S * A, stripes[0])
    results = []
    for dev, pol, scen in (("cpu", pol_c, scen_c), ("cuda", pol_g, scen_g)):
        t = lambda x: None if x is None else torch.from_numpy(np.asarray(x)).to(dev)
        tr_d = SlotTransition(*(t(x) for x in tr))
        results.append(sc._ddpg_update_shared(cfg, pol, scen, tr_d, t(idx), t(starts)))
    (pol_c, _, loss_c), (pol_g, _, loss_g) = results
    torch.testing.assert_close(loss_g.cpu(), loss_c, rtol=1e-4, atol=0.0)
    for name, opt in (("actor", pol_c.actor_opt), ("critic", pol_c.critic_opt)):
        lr = opt.param_groups[0]["lr"]
        for (pname, pc), pg in zip(
            getattr(pol_c, name).named_parameters(), getattr(pol_g, name).parameters()
        ):
            mu = opt.state[pc]["exp_avg"] / (1.0 - 0.9) if opt.state else torch.zeros_like(pc)
            ill = mu.abs() < 100 * 1e-8
            g = pg.detach().cpu()
            torch.testing.assert_close(g[~ill], pc.detach()[~ill], rtol=1e-5, atol=1e-7, msg=f"{name}.{pname}")
            torch.testing.assert_close(g[ill], pc.detach()[ill], rtol=0.0, atol=1e-2 * lr, msg=f"{name}.{pname}")
        for pc, pg in zip(
            getattr(pol_c, f"{name}_target").parameters(), getattr(pol_g, f"{name}_target").parameters()
        ):
            torch.testing.assert_close(pg.cpu(), pc, rtol=1e-5, atol=1e-7)


# --- the chunked trainer: CUDA graph replay against the eager loop -----------


@pytest.mark.cuda
@pytest.mark.parametrize(
    "impl,sim,kernel",
    [
        ("ddpg", dict(rounds=1, market_impl="factored"), "merged_min_sums"),
        ("tabular", dict(rounds=1, market_impl="factored", fused_slot=True), "slot_step_fused"),
        ("tabular", dict(rounds=2, market_impl="matrix"), "clear_market_fused"),
        ("dqn", dict(rounds=1, market_impl="factored", fused_slot=True), "slot_step_fused"),
    ],
    ids=["ddpg_k1", "fused_k7", "matrix_k6", "dqn_fused_warmup"],
)
def test_chunked_graph_matches_eager(cuda_generator, impl, sim, kernel):
    """Two chunks (A=8, S=4) as CUDA graph replays and eagerly, from the same
    state and seeds: rewards, losses and every averaged leaf bit-identical;
    each replay launches the path's kernel once a slot of each of its
    episodes (DQN: one record-only warmup pass, then the learning episode),
    and the count says so."""
    import numpy as np

    from p2pmicrogrid_tpu_torch import config as tc
    from p2pmicrogrid_tpu_torch.convert import state_from_jax, state_to_numpy
    from p2pmicrogrid_tpu_torch.envs.community import make_ratings
    from p2pmicrogrid_tpu_torch.ops.slot_fused import slot_step_fused
    from p2pmicrogrid_tpu_torch.parallel import scenarios as sc
    from p2pmicrogrid_tpu_torch.train import make_policy

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = tc.default_config(
        sim=tc.SimConfig(n_agents=8, n_scenarios=4, **sim),
        battery=tc.BatteryConfig(enabled=True),
        train=tc.TrainConfig(implementation=impl),
        ddpg=tc.DDPGConfig(buffer_size=16, batch_size=4, share_across_agents=True),
        dqn=tc.DQNConfig(buffer_size=256, batch_size=4, warmup_passes=1),
    )
    episodes = 2 if impl == "dqn" else 1  # a chunk's episodes, warmup included
    wrapper = {"merged_min_sums": merged_min_sums, "slot_step_fused": slot_step_fused,
               "clear_market_fused": mm.clear_market_fused}[kernel]
    ratings = make_ratings(cfg, np.random.default_rng(0))
    policy = make_policy(cfg)
    pol0 = sc.init_shared_pol_state(cfg, device="cuda", generator=cuda_generator)
    sub = {"ddpg": cfg.ddpg, "dqn": cfg.dqn}.get(impl)
    out = {}
    for graph in (False, True):
        episode_fn = sc.make_device_episode_fn(cfg, policy, ratings)
        warmup_fn = sc.make_device_episode_fn(cfg, policy, ratings, record_only=True) if impl == "dqn" else None
        runner = sc.make_chunked_episode_runner(cfg, episode_fn, 2, warmup_fn, graph=graph)
        pol = state_from_jax(state_to_numpy(pol0), device="cuda", cfg=sub)
        wrapper.launches = 0
        pol, rew, loss, _ = sc.train_scenarios_chunked(cfg, policy, pol, ratings, 5, 1, 2, runner=runner)
        # The graph's capture runs one chunk eagerly first.
        assert wrapper.launches == (3 if graph else 2) * episodes * 96
        out[graph] = (rew, loss, [x.clone() for x, _ in sc.learner_leaves(pol)])
    (re_, le, pe), (rg, lg, pg) = out[False], out[True]
    assert np.isfinite(rg).all() and np.array_equal(rg, re_) and np.array_equal(lg, le)
    assert all(torch.equal(a, b) for a, b in zip(pg, pe))


# --- the single community: the card against the CPU ---------------------------


@pytest.mark.cuda
@pytest.mark.parametrize(
    "impl,A,rounds,fused",
    [("tabular", 2, 1, False), ("tabular", 2, 1, True), ("tabular", 3, 2, False),
     ("dqn", 2, 1, False), ("dqn", 2, 1, True), ("ddpg", 4, 1, False)],
    ids=["tabular", "tabular_fused", "tabular_r2", "dqn", "dqn_fused", "ddpg"],
)
def test_single_episode_matches_cpu(cuda_generator, impl, A, rounds, fused):
    """One training episode of one community (slots 36-59; DQN after one
    warmup pass, fused where the episode is) on the card and on the CPU
    from one state and the same draws: decisions equal (DDPG's within 1e-5 of the heat pump's power),
    rewards ``rtol=2e-4``. Each slot launches the matrix kernels at [1, A]
    (K5, K4 from round 2, K6) or K7 once, and K1 never: the single chain
    always negotiates through the matrix path in float32."""
    import numpy as np

    from p2pmicrogrid_tpu_torch import config as tc
    from p2pmicrogrid_tpu_torch.convert import state_from_jax, state_to_numpy
    from p2pmicrogrid_tpu_torch.data.traces import synthetic_traces
    from p2pmicrogrid_tpu_torch.envs import community as com
    from p2pmicrogrid_tpu_torch.ops.slot_fused import slot_step_fused
    from p2pmicrogrid_tpu_torch.train import init_dqn_buffers, init_policy_state, make_policy

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = tc.default_config(
        sim=tc.SimConfig(n_agents=A, rounds=rounds, fused_slot=fused or None),
        train=tc.TrainConfig(implementation=impl),
        dqn=tc.DQNConfig(buffer_size=64, batch_size=8, warmup_passes=1, epsilon=0.5),
        ddpg=tc.DDPGConfig(buffer_size=64, batch_size=8),
    )
    T, R = 24, rounds + 1
    ratings = com.make_ratings(cfg, np.random.default_rng(42))
    policy = make_policy(cfg)
    pol0 = init_policy_state(cfg, "cpu", torch.Generator().manual_seed(1))
    if impl == "tabular":
        pol0 = pol0._replace(q_table=torch.randn(pol0.q_table.shape, generator=torch.Generator().manual_seed(2)),
                             epsilon=torch.tensor(0.5))
    gen = torch.Generator().manual_seed(3)
    count = (torch.arange(1, T + 1) + (T if impl == "dqn" else 0))[:, None, None]

    def draws(learn):
        if impl == "ddpg":
            d = dict(ou_normals=torch.randn((T, R, A), generator=gen))
        else:
            d = dict(uniform=torch.rand((T, R, A), generator=gen),
                     randint=torch.randint(0, 3, (T, R, A), generator=gen))
        if learn and impl != "tabular":
            d["replay_idx"] = torch.minimum((torch.rand((T, A, 8), generator=gen) * count).long(), count - 1)
        return com.SingleEpisodeDraws(normals=torch.randn((2, A), generator=gen), **d)

    warm, episode = draws(False), draws(True)
    kernels = (slot_step_fused,) if fused else (
        (mm.divide_rank1_fused, mm.clear_market_fused) + ((mm.divide_power_fused_with_mean,) if rounds > 1 else ())
    )
    everything = (merged_min_sums, mm.divide_rank1_fused, mm.divide_power_fused_with_mean,
                  mm.clear_market_fused, mm.divide_power_fused, mm.prep_mean, slot_step_fused)
    out = {}
    for device in ("cpu", "cuda"):
        to = lambda d: com.SingleEpisodeDraws(*(None if x is None else x.to(device) for x in d))
        traces = synthetic_traces(n_days=1, start_day=11).normalized()
        arrays = com.EpisodeArrays(*(x[36:36 + T] for x in com.build_episode_arrays(cfg, traces, ratings, device)))
        sub = {"dqn": cfg.dqn, "ddpg": cfg.ddpg}.get(impl)
        pol = state_from_jax(state_to_numpy(pol0), device, cfg=sub)
        for fn in everything:
            fn.launches = 0
        passes = 1
        if impl == "dqn":
            pol = init_dqn_buffers(cfg, policy, pol, arrays, ratings, draws=[to(warm)])
            passes = 2
        d = to(episode)
        phys = com.init_physical(cfg, d.normals, device=device)
        _, pol, o = com.run_episode(cfg, policy, pol, phys, arrays, ratings, training=True, draws=d, fused=fused)
        if device == "cuda":
            assert merged_min_sums.launches == 0
            for fn in everything:
                assert fn.launches == (passes * T if fn in kernels else 0), fn.__name__
        out[device] = (o.decisions.cpu().numpy(), o.reward.mean(dim=-1).sum().item())
    (dec_c, rew_c), (dec_g, rew_g) = out["cpu"], out["cuda"]
    if impl == "ddpg":
        np.testing.assert_allclose(dec_g, dec_c, rtol=0, atol=1e-5 * cfg.thermal.hp_max_power)
    else:
        np.testing.assert_array_equal(dec_g, dec_c)
    np.testing.assert_allclose(rew_g, rew_c, rtol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_single_evaluation_matches_cpu(cuda_generator, fused):
    """evaluate_community over 3 days, side by side as a [3, 2] batch (K5 and
    K6 at [3, 2], or K7 with ``fused_slot``; K1 never), on the card and on
    the CPU: decisions equal, day rewards ``rtol=2e-4``."""
    import numpy as np

    from p2pmicrogrid_tpu_torch import config as tc
    from p2pmicrogrid_tpu_torch.convert import state_from_jax, state_to_numpy
    from p2pmicrogrid_tpu_torch.data.traces import synthetic_traces
    from p2pmicrogrid_tpu_torch.envs.community import make_ratings
    from p2pmicrogrid_tpu_torch.ops.slot_fused import slot_step_fused
    from p2pmicrogrid_tpu_torch.train import evaluate_community, init_policy_state, make_policy

    cfg = tc.default_config(
        sim=tc.SimConfig(n_agents=2, fused_slot=fused or None), train=tc.TrainConfig(implementation="tabular")
    )
    pol0 = init_policy_state(cfg, "cpu")
    pol0 = pol0._replace(q_table=torch.randn(pol0.q_table.shape, generator=torch.Generator().manual_seed(2)))
    traces = synthetic_traces(n_days=3, start_day=11).normalized()
    ratings = make_ratings(cfg, np.random.default_rng(42))
    normals = torch.randn((3, 2, 2), generator=torch.Generator().manual_seed(3))
    out = {}
    for device in ("cpu", "cuda"):
        merged_min_sums.launches = mm.clear_market_fused.launches = slot_step_fused.launches = 0
        _, o, _ = evaluate_community(
            cfg, make_policy(cfg), state_from_jax(state_to_numpy(pol0), device), traces, ratings,
            normals=normals.to(device), device=device,
        )
        out[device] = (o.decisions.cpu().numpy(), o.reward.sum(dim=(1, 2)).cpu().numpy())
    assert merged_min_sums.launches == 0
    assert (slot_step_fused.launches, mm.clear_market_fused.launches) == ((96, 0) if fused else (0, 96))
    np.testing.assert_array_equal(out["cuda"][0], out["cpu"][0])
    np.testing.assert_allclose(out["cuda"][1], out["cpu"][1], rtol=2e-4)


# --- one learner per scenario; several trading communities ------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["tabular", "dqn"])
@pytest.mark.parametrize("rounds", [1, 2])
@pytest.mark.parametrize("shape", [(4, 3), (3, 37)])
def test_slot_kernel_per_scenario_learners(cuda_generator, impl, rounds, shape):
    """K7 with one learner per scenario (S * A learners, scenario-major):
    one launch equals its plain version (decisions equal, the rest within
    rtol=1e-5, atol=1e-3) and, scenario by scenario, K7 at [1, A] with that
    scenario's learners bit for bit."""
    from p2pmicrogrid_tpu_torch.ops import slot_fused as sf
    from p2pmicrogrid_tpu_torch.parallel.scenarios import init_independent_state, scenario_learners

    S, A = shape
    # A community of 3 agents trades at some draws only: other hours with PV
    # are drawn until agents trade.
    for t in (44, 40, 48, 36, 52, 42, 46):
        cfg, args = _slot_inputs(impl, S, A, dict(rounds=rounds, market_impl="matrix"), cuda_generator, t)
        pol = init_independent_state(cfg, S, "cuda", cuda_generator)
        if impl == "tabular":
            pol = pol._replace(q_table=torch.randn(pol.q_table.shape, generator=cuda_generator, device="cuda"))
        pol = pol._replace(epsilon=torch.tensor(0.3, device="cuda"))
        args = (pol,) + args[1:]
        ref = sf.slot_step_fused_plain(cfg, *args)
        if bool((ref.p_p2p != 0).any()):
            break
    assert bool((ref.p_p2p != 0).any()), "no agent trades"
    before = sf.slot_step_fused.launches
    got = sf.slot_raw(cfg, *args)
    assert sf.slot_step_fused.launches == before + 1
    for name, g, r in zip(sf.SlotRaw._fields, got, ref):
        if name in ("aux", "hp_frac", "decisions"):
            assert torch.equal(g, r), name
        else:
            torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-3, msg=name)
    _, phys, xs, draws, ratings, *rest = args
    for s in range(S):
        one = lambda tree: type(tree)(*(x[s : s + 1] for x in tree))
        alone = sf.slot_raw(
            cfg, scenario_learners(pol, s, A), one(phys), tuple(x[s : s + 1] for x in xs),
            tuple(d[:, s : s + 1].contiguous() for d in draws), ratings, *rest,
        )
        for name, g, a in zip(sf.SlotRaw._fields, got, alone):
            assert torch.equal(g[s : s + 1], a), (name, s)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "impl,fused", [("tabular", False), ("tabular", True), ("dqn", True)], ids=["tabular", "tabular_fused", "dqn_fused"]
)
def test_independent_episode_matches_cpu(cuda_generator, impl, fused):
    """One independent-scenario episode (S = 3, A = 3, slots 36-59) on the
    card and on the CPU from the same learners and draws: rewards
    ``rtol=2e-4``, the learners' tables or stored actions equal. Each slot
    launches K5 and K6 at [S, A] once, or K7 with one learner per scenario
    once, and K1 never."""
    import numpy as np

    from p2pmicrogrid_tpu_torch import config as tc
    from p2pmicrogrid_tpu_torch.convert import state_from_jax, state_to_numpy
    from p2pmicrogrid_tpu_torch.envs import community as com
    from p2pmicrogrid_tpu_torch.ops.slot_fused import slot_step_fused
    from p2pmicrogrid_tpu_torch.parallel import scenarios as sc
    from p2pmicrogrid_tpu_torch.train import make_policy

    S, A, T = 3, 3, 24
    cfg = tc.default_config(
        sim=tc.SimConfig(n_agents=A, n_scenarios=S),
        train=tc.TrainConfig(implementation=impl),
        dqn=tc.DQNConfig(buffer_size=64, batch_size=8, epsilon=0.5),
    )
    ratings = com.make_ratings(cfg, np.random.default_rng(42))
    pol0 = sc.init_independent_state(cfg, S, "cpu", torch.Generator().manual_seed(1))
    if impl == "tabular":
        pol0 = pol0._replace(q_table=torch.randn(pol0.q_table.shape, generator=torch.Generator().manual_seed(2)),
                             epsilon=torch.tensor(0.5))
    gen = torch.Generator().manual_seed(3)
    count = torch.arange(1, T + 1)[None, :, None, None]
    d = dict(uniform=torch.rand((S, T, 2, A), generator=gen), randint=torch.randint(0, 3, (S, T, 2, A), generator=gen),
             normals=torch.randn((S, 2, A), generator=gen))
    if impl == "dqn":
        d["replay_idx"] = torch.minimum((torch.rand((S, T, A, 8), generator=gen) * count).long(), count - 1)
    draws = com.SingleEpisodeDraws(**d)
    kernels = (slot_step_fused,) if fused else (mm.divide_rank1_fused, mm.clear_market_fused)
    everything = (merged_min_sums, mm.divide_rank1_fused, mm.divide_power_fused_with_mean,
                  mm.clear_market_fused, mm.divide_power_fused, mm.prep_mean, slot_step_fused)
    out = {}
    for device in ("cpu", "cuda"):
        arrays = sc.stack_scenario_arrays(cfg, sc.make_scenario_traces(cfg, seed=0), ratings, device)
        arrays = com.EpisodeArrays(*(x[:, 36:36 + T] for x in arrays))
        pol = state_from_jax(state_to_numpy(pol0), device, cfg=cfg.dqn if impl == "dqn" else None)
        for fn in everything:
            fn.launches = 0
        episode = sc.make_independent_episode_fn(cfg, make_policy(cfg), arrays, ratings, fused=fused)
        pol, (rewards, _) = episode(pol, draws=com.SingleEpisodeDraws(*(None if x is None else x.to(device) for x in draws)))
        if device == "cuda":
            for fn in everything:
                assert fn.launches == (T if fn in kernels else 0), fn.__name__
        learned = pol.q_table if impl == "tabular" else pol.replay.action
        out[device] = (rewards.cpu().numpy(), learned.cpu().numpy())
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=2e-4)
    if impl == "tabular":
        np.testing.assert_allclose(out["cuda"][1], out["cpu"][1], rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_array_equal(out["cuda"][1], out["cpu"][1])


@pytest.mark.cuda
def test_multi_community_matches_cpu(cuda_generator):
    """C = 4 trading communities of A = 6 agents (tabular, the factored
    clearing, K1 at [4, 6] and [8, 6]): a training episode (slots 36-59)
    and the greedy evaluation of 2 days on the card and on the CPU from the
    same table and draws: decisions equal, rewards and costs ``rtol=2e-4``."""
    import numpy as np

    from p2pmicrogrid_tpu_torch import config as tc
    from p2pmicrogrid_tpu_torch.convert import state_from_jax, state_to_numpy
    from p2pmicrogrid_tpu_torch.data.traces import synthetic_traces
    from p2pmicrogrid_tpu_torch.envs import community as com
    from p2pmicrogrid_tpu_torch.envs import multi_community as mc
    from p2pmicrogrid_tpu_torch.parallel import scenarios as sc
    from p2pmicrogrid_tpu_torch.train import make_policy

    C, A, T = 4, 6, 24
    cfg = tc.default_config(
        sim=tc.SimConfig(n_agents=A, n_scenarios=C, market_impl="factored"),
        train=tc.TrainConfig(implementation="tabular"),
    )
    ratings = com.make_ratings(cfg, np.random.default_rng(42))
    pol0 = sc.init_shared_pol_state(cfg, "cpu")
    pol0 = pol0._replace(q_table=torch.randn(pol0.q_table.shape, generator=torch.Generator().manual_seed(2)),
                         epsilon=torch.tensor(0.5))
    gen = torch.Generator().manual_seed(3)
    draws = sc.EpisodeDraws(uniform=torch.rand((T, 2, C, A), generator=gen),
                            randint=torch.randint(0, 3, (T, 2, C, A), generator=gen),
                            normals=torch.randn((C, 2, A), generator=gen))
    normals = torch.randn((2, C, 2, A), generator=gen)
    traces = synthetic_traces(n_days=2, start_day=11).normalized()
    out = {}
    for device in ("cpu", "cuda"):
        arrays = sc.stack_scenario_arrays(cfg, sc.make_scenario_traces(cfg, seed=0), ratings, device)
        arrays = com.EpisodeArrays(*(x[:, 36:36 + T] for x in arrays))
        merged_min_sums.launches = 0
        episode = mc.make_multi_community_episode_fn(cfg, make_policy(cfg), arrays, ratings)
        (pol, _), (rewards, _) = episode(
            (state_from_jax(state_to_numpy(pol0), device), None), None,
            sc.EpisodeDraws(*(None if x is None else x.to(device) for x in draws)),
        )
        _, o, _ = mc.evaluate_multi_community(
            cfg, make_policy(cfg), pol, traces, ratings, normals=normals.to(device), device=device
        )
        if device == "cuda":
            assert merged_min_sums.launches == T + 96
        out[device] = (rewards.cpu().numpy(), pol.q_table.cpu().numpy(), o.decisions.cpu().numpy(),
                       o.cost.cpu().numpy())
    (r_c, q_c, d_c, c_c), (r_g, q_g, d_g, c_g) = out["cpu"], out["cuda"]
    np.testing.assert_allclose(r_g, r_c, rtol=2e-4)
    np.testing.assert_allclose(q_g, q_c, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(d_g, d_c)
    np.testing.assert_allclose(c_g, c_c, rtol=2e-4, atol=1e-7)


# --- device counters and exact resume on the card ------------------------------


def _chunked_cfg():
    from p2pmicrogrid_tpu_torch import config as tc

    return tc.default_config(
        sim=tc.SimConfig(n_agents=8, n_scenarios=4),
        battery=tc.BatteryConfig(enabled=True),
        train=tc.TrainConfig(implementation="ddpg"),
        ddpg=tc.DDPGConfig(buffer_size=32, batch_size=4, share_across_agents=True),
    )


@pytest.mark.cuda
def test_graph_counters_equal_eager(cuda_generator):
    """The chunk graph's device counters and fills equal the eager loop's
    bit for bit, from one state and the same seeds."""
    import numpy as np

    from p2pmicrogrid_tpu_torch.convert import state_from_jax, state_to_numpy
    from p2pmicrogrid_tpu_torch.envs.community import make_ratings
    from p2pmicrogrid_tpu_torch.parallel import scenarios as sc
    from p2pmicrogrid_tpu_torch.telemetry import dc_to_dict
    from p2pmicrogrid_tpu_torch.train import make_policy

    cfg = _chunked_cfg()
    ratings = make_ratings(cfg, np.random.default_rng(0))
    policy = make_policy(cfg)
    pol0 = state_to_numpy(sc.init_shared_pol_state(cfg, device="cuda", generator=cuda_generator))
    out = []
    for graph in (False, True):
        episode_fn = sc.make_device_episode_fn(cfg, policy, ratings, collect_device_metrics=True)
        runner = sc.make_chunked_episode_runner(cfg, episode_fn, 2, graph=graph, collect_device_metrics=True)
        res = runner(state_from_jax(pol0, device="cuda", cfg=cfg.ddpg), seeds=[3, 4])
        out.append((dc_to_dict(res[3]), res[4].numpy(), res[1].cpu().numpy()))
    (dc_e, fill_e, r_e), (dc_g, fill_g, r_g) = out
    assert dc_e == dc_g and np.array_equal(fill_e, fill_g) and np.array_equal(r_e, r_g)
    assert dc_g["market_residual_wh"] > 0 and (fill_g == 1.0).all()


@pytest.mark.cuda
def test_chunked_resume_digest(cuda_generator, tmp_path):
    """Two chunked episodes through the graph in one run, and one, a
    checkpoint, a restore into a fresh state and the second: the final
    states' digests are equal."""
    import numpy as np

    from p2pmicrogrid_tpu_torch.convert import state_to_numpy
    from p2pmicrogrid_tpu_torch.envs.community import make_ratings
    from p2pmicrogrid_tpu_torch.parallel import scenarios as sc
    from p2pmicrogrid_tpu_torch.train import make_policy
    from p2pmicrogrid_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint, tree_digest

    cfg = _chunked_cfg()
    ratings = make_ratings(cfg, np.random.default_rng(0))
    policy = make_policy(cfg)
    fresh = lambda seed: sc.init_shared_pol_state(
        cfg, device="cuda", generator=torch.Generator(device="cuda").manual_seed(seed)
    )
    full, _, _, _ = sc.train_scenarios_chunked(cfg, policy, fresh(0), ratings, 5, 2, 2)
    pol, _, _, _ = sc.train_scenarios_chunked(cfg, policy, fresh(0), ratings, 5, 1, 2)
    save_checkpoint(str(tmp_path), pol, 0)
    pol, episode = restore_checkpoint(str(tmp_path), fresh(1))
    pol, _, _, _ = sc.train_scenarios_chunked(cfg, policy, pol, ratings, 5, 1, 2, episode0=episode + 1)
    digest = lambda s: tree_digest({"pol_state": state_to_numpy(s)})[0]
    assert digest(pol) == digest(full)


def _serving_bundle(tmp_path, impl, A, share=False):
    """A bundle exported on the card from a state drawn there (the tabular
    table drawn too, so its argmax is not trivially 0)."""
    from p2pmicrogrid_tpu_torch import config as tc
    from p2pmicrogrid_tpu_torch.serve import export_policy_bundle
    from p2pmicrogrid_tpu_torch.train.policies import init_policy_state

    cfg = tc.default_config(
        sim=tc.SimConfig(n_agents=A),
        train=tc.TrainConfig(implementation=impl),
        dqn=tc.DQNConfig(buffer_size=16),
        ddpg=tc.DDPGConfig(buffer_size=16, batch_size=2, share_across_agents=share),
    )
    gen = torch.Generator(device="cuda").manual_seed(0)
    ps = init_policy_state(cfg, "cuda", gen)
    if impl == "tabular":
        ps = ps._replace(q_table=torch.randn(ps.q_table.shape, generator=gen, device="cuda"))
    return export_policy_bundle(cfg, ps, str(tmp_path / impl), device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("impl, A", [("tabular", 2), ("dqn", 16), ("ddpg", 16)])
def test_serving_graphs_replay_eager_and_match_cpu(cuda_generator, tmp_path, impl, A):
    """The engine's graph per bucket equals its eager forward on the card
    bit for bit, and the CPU engine's actions (discrete: equal up to Q
    near-ties, at most one; DDPG within 1e-5); a session step on the card
    answers what its act does and counts its slots."""
    import numpy as np

    from p2pmicrogrid_tpu_torch.serve import PolicyEngine, calibration_obs

    path = _serving_bundle(tmp_path, impl, A)
    card = PolicyEngine(bundle_dir=path, max_batch=16, device="cuda")
    cpu = PolicyEngine(bundle_dir=path, max_batch=16, device="cpu")
    assert card.warmup() == [1, 2, 4, 8, 16]
    assert card.stats["aot_compiles"] == 10 and card.stats["aot_hits"] == 0
    assert set(card.capture_s) == {1, 2, 4, 8, 16} and card.graph_pool_bytes > 0
    for b in (1, 3, 8, 16, 21):
        obs = calibration_obs(b, A, seed=b)
        got = card.act(obs)
        eager = np.concatenate([
            card.forward(torch.from_numpy(obs[i:i + 16]).cuda()).cpu().numpy()
            for i in range(0, b, 16)
        ])
        if b in (1, 8, 16):  # an exact bucket: the same shape as the eager pass
            assert np.array_equal(got, eager)
        ref = cpu.act(obs)
        if impl == "ddpg":
            np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
        else:
            assert (got != ref).sum() <= 1
    assert card.stats["aot_compiles"] == 10  # no capture after warmup
    sessions = card.init_sessions(3)
    obs = calibration_obs(3, A, seed=40)
    sessions, hp = card.step(sessions, obs)
    sessions, hp = card.step(sessions, obs)
    assert np.array_equal(hp, card.act(obs))
    assert sessions.slots.cpu().tolist() == [2, 2, 2]
    assert np.array_equal(sessions.hp_frac.cpu().numpy(), hp)


@pytest.mark.cuda
def test_serving_late_capture_and_threads(cuda_generator, tmp_path):
    """A bucket never warmed is captured on first use; calls from several
    threads serialise on the engine's lock and each gets its own copy."""
    import threading

    import numpy as np

    from p2pmicrogrid_tpu_torch.serve import PolicyEngine, calibration_obs

    path = _serving_bundle(tmp_path, "ddpg", 32, share=True)
    card = PolicyEngine(bundle_dir=path, max_batch=8, device="cuda")
    obs = [calibration_obs(b, 32, seed=b) for b in (1, 2, 3, 5, 8)]
    want = [card.act(o) for o in obs]
    assert card.stats["aot_compiles"] == 4  # buckets 1, 2, 4, 8 captured on first use
    got = {}

    def run(i):
        for _ in range(20):
            got[i] = card.act(obs[i % len(obs)])

    threads = [threading.Thread(target=run, args=(i,)) for i in range(10)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not any(t.is_alive() for t in threads)
    for i, out in got.items():
        assert np.array_equal(out, want[i % len(obs)])


# --- recurrent models and serving, regimes: the card against the CPU ---------


def _recurrent_cfg(A):
    from p2pmicrogrid_tpu_torch import config as tc

    return tc.default_config(
        sim=tc.SimConfig(n_agents=A), train=tc.TrainConfig(implementation="ddpg_recurrent")
    )


@pytest.mark.cuda
def test_recurrent_training_and_step_match_cpu(cuda_generator):
    """The step scanned from zeros equals the whole sequence on the card
    (atol 1e-6); two days of train_recurrent_community on the card against
    the CPU from one CPU draw (rtol 2e-4, the golden episodes')."""
    import numpy as np

    from p2pmicrogrid_tpu_torch.convert import state_from_jax, state_to_numpy
    from p2pmicrogrid_tpu_torch.data.traces import synthetic_traces
    from p2pmicrogrid_tpu_torch.models import ddpg_recurrent as rec
    from p2pmicrogrid_tpu_torch.train.recurrent import RecurrentDraws, train_recurrent_community

    torch.backends.cuda.matmul.allow_tf32 = False
    A = 4
    cfg = _recurrent_cfg(A)
    gen = torch.Generator().manual_seed(0)
    state0 = state_to_numpy(rec.recurrent_ddpg_init(cfg.ddpg, gen, device="cpu"))
    draws = RecurrentDraws(torch.randn((2, A), generator=gen), torch.randn((2, 96, A), generator=gen))
    card = state_from_jax(state0, device="cuda", cfg=cfg.ddpg)
    obs = torch.rand((A, 96, 4), generator=cuda_generator, device="cuda")
    with torch.no_grad():
        full = card.actor(obs)[..., 0]
        h = rec.recurrent_actor_init_hidden((A,), 100, device="cuda")
        steps = []
        for t in range(96):
            a, h = rec.recurrent_actor_step(card.actor, obs[:, t], h)
            steps.append(a)
    torch.testing.assert_close(torch.stack(steps, 1), full, atol=1e-6, rtol=0)
    runs = [
        train_recurrent_community(
            cfg, 2, traces=synthetic_traces(n_days=2), state=state_from_jax(state0, device=dev, cfg=cfg.ddpg),
            draws=draws, device=dev,
        )
        for dev in ("cuda", "cpu")
    ]
    for field in ("day_rewards", "day_costs", "losses"):
        np.testing.assert_allclose(getattr(runs[0], field), getattr(runs[1], field), rtol=2e-4)


@pytest.mark.cuda
def test_recurrent_serving_graphs_and_ring_match_eager_and_cpu(cuda_generator, tmp_path):
    """Each bucket's graph carries the hidden state: replays equal the eager
    step bit for bit at an exact bucket and the CPU engine within 1e-5; the
    ring's graphs keep a household's trajectory and re-initialise an
    evicted slot bit for bit."""
    import numpy as np

    from p2pmicrogrid_tpu_torch.models.ddpg_recurrent import recurrent_ddpg_init
    from p2pmicrogrid_tpu_torch.serve import (
        ContinuousBatcher,
        PolicyEngine,
        calibration_obs,
        export_policy_bundle,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    A = 4
    cfg = _recurrent_cfg(A)
    state = recurrent_ddpg_init(cfg.ddpg, torch.Generator().manual_seed(1), device="cpu")
    path = export_policy_bundle(cfg, state, str(tmp_path / "rb"), device="cpu")
    card = PolicyEngine(bundle_dir=path, max_batch=8, device="cuda")
    cpu = PolicyEngine(bundle_dir=path, max_batch=8, device="cpu")
    assert card.warmup() == [1, 2, 4, 8] and card.stats["aot_compiles"] == 8
    obs = calibration_obs(8, A, seed=3)
    h_c, h_p = card.init_hidden(8).cpu().numpy(), np.zeros((8, A, 400), np.float32)
    for _ in range(3):
        with torch.no_grad():
            eager = card.forward(torch.from_numpy(obs).cuda(), torch.from_numpy(h_c).cuda())
        a_c, h_next = card.act(obs, h_c)
        assert np.array_equal(a_c, eager[0].cpu().numpy()) and np.array_equal(h_next, eager[1].cpu().numpy())
        a_p, h_p = cpu.act(obs, h_p)
        np.testing.assert_allclose(a_c, a_p, atol=1e-5, rtol=0)
        h_c = h_next
    sessions = card.init_sessions(3)
    sessions, s1 = card.step(sessions, obs[:3])
    sessions, s2 = card.step(sessions, obs[:3])
    a1, hh = card.act(obs[:3], card.init_hidden(3))
    a2, hh = card.act(obs[:3], hh)
    assert np.array_equal(s2, a2) and np.array_equal(sessions.hidden.cpu().numpy(), hh)
    with ContinuousBatcher(card, max_slots=2, autostart=False) as cb:
        assert cb.warmup() == [1, 2, 4, 8] and cb.graph_pool_bytes > 0
        got = []
        for t in range(3):
            f = cb.submit(obs[t], household="main")
            g = cb.submit(obs[7], household=f"other-{t}")  # evicts the previous other
            assert cb.step_once() == 2
            got.append(f.result(1))
            # Another bucket than act's: cuBLAS may round another way.
            np.testing.assert_allclose(
                g.result(1), card.act(obs[7][None], card.init_hidden(1))[0][0], atol=1e-6, rtol=0
            )
        assert cb.stats["evictions"] >= 1
    h = card.init_hidden(1)
    for t in range(3):
        a, h = card.act(obs[t][None], h)
        np.testing.assert_allclose(got[t], a[0], atol=1e-6, rtol=0)


@pytest.mark.cuda
def test_regime_chunk_graph_captures_once_across_a_portfolio_swap(cuda_generator):
    """Shared DDPG (K1 at [4, 8]) over a 4-regime portfolio through the chunk
    graph, then a swap to another portfolio: one capture; each episode
    equals the eager runner's bit for bit, before and after the swap; K1
    launches once a slot of every chunk run (the capture's eager run
    included)."""
    import numpy as np

    from p2pmicrogrid_tpu_torch import regimes as rg
    from p2pmicrogrid_tpu_torch.convert import state_from_jax, state_to_numpy
    from p2pmicrogrid_tpu_torch.envs.community import make_ratings, ratings_to
    from p2pmicrogrid_tpu_torch.parallel import scenarios as sc
    from p2pmicrogrid_tpu_torch.parallel.device_gen import device_episode_arrays
    from p2pmicrogrid_tpu_torch.train import make_policy

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _chunked_cfg()
    S = cfg.sim.n_scenarios
    ratings = make_ratings(cfg, np.random.default_rng(0))
    rd = ratings_to(ratings, "cuda")
    policy = make_policy(cfg)
    pol0 = state_to_numpy(sc.init_shared_pol_state(cfg, device="cuda", generator=cuda_generator))
    first = rg.build_portfolio(["baseline", "winter", "ev_evening", "double_auction"], S, device="cuda")
    second = rg.build_portfolio(["dr_spike", "islanding_noon", "cold_snap", "uniform_price"], S, device="cuda")
    out = {}
    for graph in (False, True):
        fn = rg.make_regime_episode_fn(
            cfg, policy, ratings, first.scenario_params,
            arrays_fn=lambda d: device_episode_arrays(cfg, rd, S, draws=d), n_scenarios=S,
        )
        runner = sc.make_chunked_episode_runner(cfg, fn, 2, graph=graph)
        pol = state_from_jax(pol0, device="cuda", cfg=cfg.ddpg)
        merged_min_sums.launches = 0
        pol, r1, _, _ = sc.train_scenarios_chunked(cfg, policy, pol, ratings, 5, 1, 2, runner=runner)
        fn.with_regimes(second.scenario_params)
        pol, r2, _, _ = sc.train_scenarios_chunked(cfg, policy, pol, ratings, 5, 1, 2, episode0=1, runner=runner)
        assert merged_min_sums.launches == (5 if graph else 4) * 96
        if graph:
            assert len(runner.graphs) == 1
        out[graph] = (r1, r2, [x.clone() for x, _ in sc.learner_leaves(pol)])
    (e1, e2, pe), (g1, g2, pg) = out[False], out[True]
    assert np.array_equal(g1, e1) and np.array_equal(g2, e2) and not np.array_equal(g1, g2)
    assert all(torch.equal(a, b) for a, b in zip(pg, pe))


@pytest.mark.cuda
def test_command_line_trains_on_the_card(cuda_generator, tmp_path, monkeypatch):
    """``cli.main`` with the card's default device: a single community at
    A=2 for 2 episodes (each the 7 training days, 672 slots) launches K5 and
    K6 once a slot (the single chain's matrix market), no other kernel; the
    same argv with ``--device cpu`` launches none; both write their
    checkpoint and results rows."""
    import contextlib
    import io
    import sqlite3

    from p2pmicrogrid_tpu_torch import cli

    monkeypatch.setenv("P2P_TELEMETRY_DIR", str(tmp_path / "runs"))
    wrappers = [merged_min_sums, mm.divide_rank1_fused, mm.divide_power_fused_with_mean,
                mm.clear_market_fused, mm.divide_power_fused, mm.prep_mean]

    def run(*extra):
        before = [w.launches for w in wrappers]
        with contextlib.redirect_stdout(io.StringIO()) as out:
            rc = cli.main(["train", "--agents", "2", "--episodes", "2", "--model-dir",
                           str(tmp_path / "m"), "--results-db", str(tmp_path / "r.db"), *extra])
        assert rc == 0 and "trained 2 episodes" in out.getvalue()
        return [w.launches - b for w, b in zip(wrappers, before)]

    assert run() == [0, 2 * 7 * 96, 0, 2 * 7 * 96, 0, 0]
    assert run("--device", "cpu") == [0] * len(wrappers)
    con = sqlite3.connect(str(tmp_path / "r.db"))
    try:
        (n,) = con.execute("SELECT COUNT(*) FROM training_progress").fetchone()
    finally:
        con.close()
    assert n == 1


def _flywheel_cfg(impl):
    from p2pmicrogrid_tpu_torch import config as tc

    return tc.default_config(
        sim=tc.SimConfig(n_agents=3),
        train=tc.TrainConfig(implementation=impl, seed=0),
        qlearning=tc.QLearningConfig(num_time_states=8, num_temp_states=8, num_balance_states=8,
                                     num_p2p_states=8),
        dqn=tc.DQNConfig(hidden=8, buffer_size=16, batch_size=8),
        ddpg=tc.DDPGConfig(actor_hidden=8, critic_hidden=8, buffer_size=16, batch_size=8,
                           share_across_agents=True, actor_delay_updates=2),
    )


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["tabular", "dqn", "ddpg"])
def test_pretrain_graph_equals_eager_and_cpu(cuda_generator, impl):
    """The off-policy pretrain with one step captured and replayed equals
    the eager loop on the card bit for bit (DDPG's actor-delayed steps run
    eagerly before the capture), and the CPU's at the CPU tests'
    tolerances (tabular bit for bit)."""
    import numpy as np

    from p2pmicrogrid_tpu_torch.convert import state_from_jax, state_to_numpy
    from p2pmicrogrid_tpu_torch.data.trace_export import TraceDataset
    from p2pmicrogrid_tpu_torch.parallel.scenarios import init_shared_pol_state
    from p2pmicrogrid_tpu_torch.serve.loadgen import synthetic_obs
    from p2pmicrogrid_tpu_torch.train import continual as co

    cfg, n, steps = _flywheel_cfg(impl), 24, 6
    rng = np.random.default_rng(0)
    obs = synthetic_obs(n, 3, seed=1)
    ds = TraceDataset(obs=obs, action=rng.choice([0.0, 0.5, 1.0], (n, 3)).astype(np.float32),
                      reward=rng.normal(size=(n, 3)).astype(np.float32), next_obs=np.roll(obs, -1, 0))
    st = state_to_numpy(init_shared_pol_state(cfg, "cpu", torch.Generator().manual_seed(0)))
    sub = {"dqn": cfg.dqn, "ddpg": cfg.ddpg}.get(impl)
    idx = torch.randint(0, n, (steps, co.trace_batch_size(cfg, n)), generator=torch.Generator().manual_seed(2))
    runs = {}
    for name, dev, graph in (("graph", "cuda", True), ("eager", "cuda", False), ("cpu", "cpu", False)):
        s, losses = co.offpolicy_pretrain(cfg, state_from_jax(st, dev, cfg=sub), ds, None, steps,
                                          indices=idx, graph=graph, device=dev)
        runs[name] = (state_to_numpy(s), losses)

    def leaves(tree):
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in leaves(tree[k])]
        if isinstance(tree, tuple):
            return [x for t in tree for x in leaves(t)]
        return [np.asarray(tree)]

    g, e, c = (leaves(runs[k][0]) for k in ("graph", "eager", "cpu"))
    assert all(np.array_equal(x, y) for x, y in zip(g, e))
    np.testing.assert_array_equal(runs["graph"][1], runs["eager"][1])
    for x, y in zip(g, c):
        if impl == "tabular":
            np.testing.assert_array_equal(x, y)
        elif x.dtype.kind == "f":
            np.testing.assert_allclose(x, y, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(runs["graph"][1], runs["cpu"][1], rtol=1e-4)


@pytest.mark.cuda
def test_trace_rewards_and_gate_on_the_card_match_cpu(cuda_generator, tmp_path):
    """The trace rewards on the card within rtol=1e-6 of the CPU's, and
    the gate over crafted A=3 bundles (evaluations through K1 on the card,
    the matrix path on the CPU) gives the same verdicts."""
    import dataclasses

    import numpy as np

    from p2pmicrogrid_tpu_torch.data import trace_export as te
    from p2pmicrogrid_tpu_torch.serve import promotion as pr
    from p2pmicrogrid_tpu_torch.serve.loadgen import synthetic_obs

    cfg = _flywheel_cfg("tabular")
    obs = synthetic_obs(32, 3, seed=3)
    act = np.random.default_rng(3).choice([0.0, 0.5, 1.0], (32, 3)).astype(np.float32)
    for name in ("trace_reward", "decision_cost"):
        np.testing.assert_allclose(getattr(te, name)(cfg, obs, act, device="cuda"),
                                   getattr(te, name)(cfg, obs, act, device="cpu"), rtol=1e-6)
    good_cfg = cfg.replace(train=dataclasses.replace(cfg.train, starting_episodes=101))
    verdicts = {}
    for dev in ("cuda", "cpu"):
        inc = pr.make_crafted_bundle(cfg, "incumbent", str(tmp_path / dev / "inc"), device=dev)
        good = pr.make_crafted_bundle(good_cfg, "good", str(tmp_path / dev / "good"), device=dev)
        v = pr.run_promotion_gate(cfg, good, inc, service_time_fn=lambda i, j: 5e-4,
                                  bench_requests=64, max_batch=8, device=dev)
        verdicts[dev] = (v.passed, v.candidate_cost)
    assert verdicts["cuda"][0] is verdicts["cpu"][0] is True
    np.testing.assert_allclose(verdicts["cuda"][1], verdicts["cpu"][1], rtol=1e-4)


@pytest.mark.cuda
def test_local_fleet_on_the_card_answers_as_its_engine(cuda_generator, tmp_path):
    """A two-replica ``LocalFleet`` on the card over a discrete (per-agent
    DQN) bundle: every answer through the router equals its reference
    engine's act bit for bit, a kill fails over with no request lost, and
    the restart captures nothing (each engine's ``aot_compiles`` as before)."""
    import asyncio

    import numpy as np

    from p2pmicrogrid_tpu_torch.serve import FleetRouter, LocalFleet, calibration_obs
    from p2pmicrogrid_tpu_torch.serve.gateway import AdmissionConfig
    from p2pmicrogrid_tpu_torch.serve.loadgen import RetryPolicy

    path = _serving_bundle(tmp_path, "dqn", 16)
    fleet = LocalFleet([path], n_replicas=2, max_batch=8,
                       admission=AdmissionConfig(max_queue_depth=100_000, wait_budget_ms=1e5))
    fleet.start()
    try:
        engine = fleet.reference_engine()
        assert engine.device.type == "cuda"
        router = FleetRouter(fleet.replicas, retry=RetryPolicy(max_attempts=5, deadline_s=30.0),
                             fail_threshold=2, ok_threshold=1)
        obs = calibration_obs(12, 16, seed=5)

        def act_all(offset):
            return [asyncio.run(router.act(f"house-{i}", obs[i])) for i in range(offset, offset + 6)]

        first = act_all(0)
        assert all(r.status == 200 for r in first)
        victim = first[0].replica_id
        reg = fleet.entry(victim)["registry"]
        captures = reg.get(reg.default_hash).engine.stats["aot_compiles"]
        fleet.kill(victim)
        second = act_all(6)
        assert all(r.status == 200 for r in second)
        got = np.asarray([r.actions for r in first + second], dtype=np.float32)
        assert np.array_equal(got, engine.act(obs))
        fleet.restart(victim)
        router.probe_once()
        assert router.is_healthy(victim)
        assert reg.get(reg.default_hash).engine.stats["aot_compiles"] == captures
    finally:
        fleet.stop_all()
