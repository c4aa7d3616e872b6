"""The port's on-device scenario generator (``parallel/device_gen.py``)
against the JAX package's on the CPU, from the JAX package's own draws.

``TraceDraws`` are rebuilt from the JAX key as ``device_scenario_traces``
splits it (``jax.random.split(key, 7)``, parallel/device_gen.py:44-75) and
injected into the port. Tolerance: ``rtol=1e-6``,
with an ``atol`` of 2**-22 of each leaf's largest value. The jitted
reference folds each normal's scale into its inverse-error-function
constant (``0.08 * sqrt(2)``) and computes ``exp`` and ``sin`` with its own
polynomials, so an entry can move by an ulp or two of its leaf's scale;
near the PV clip, where ``weather * bell * cloud - 0.02`` cancels, that is a
large relative difference of a value near 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2pmicrogrid_tpu import config as jcfg
from p2pmicrogrid_tpu.envs.community import make_ratings
from p2pmicrogrid_tpu.parallel import device_gen as jdg
from p2pmicrogrid_tpu_torch import config as tcfg
from p2pmicrogrid_tpu_torch.parallel import device_gen as tdg

S, A, T, P = 16, 7, 96, 5


def jax_trace_arrays(key, n_scenarios=S):
    """The seven draws of ``device_scenario_traces(key, S)``, in
    ``TraceDraws`` order (traceable under ``jax.jit``)."""
    ks = jax.random.split(key, 7)
    return (
        jax.random.uniform(ks[0], (n_scenarios, 1, P)),
        jax.random.normal(ks[1], (n_scenarios, T, P)),
        jax.random.uniform(ks[2], (n_scenarios, 1), minval=0.3, maxval=1.0),
        jax.random.uniform(ks[3], (n_scenarios, 1), minval=0.0, maxval=jnp.pi),
        jax.random.uniform(ks[4], (n_scenarios, 1), minval=7.0, maxval=12.0),
        jax.random.uniform(ks[5], (n_scenarios, 1), minval=2.0, maxval=5.0),
        jax.random.normal(ks[6], (n_scenarios, T)),
    )


def trace_draws(arrays):
    """The port's ``TraceDraws`` of ``jax_trace_arrays``' result."""
    return tdg.TraceDraws(*(torch.from_numpy(np.array(x)) for x in arrays))


def _close(got, ref, what):
    ref = np.asarray(ref)
    np.testing.assert_allclose(
        got, ref, rtol=1e-6, atol=2.0**-22 * float(np.abs(ref).max()), err_msg=what
    )


def test_episode_arrays_match_jax():
    """device_episode_arrays from the same key: every leaf, two keys."""
    cfg_j = jcfg.default_config(sim=jcfg.SimConfig(n_agents=A, n_scenarios=S))
    cfg_t = tcfg.default_config(sim=tcfg.SimConfig(n_agents=A, n_scenarios=S))
    ratings = make_ratings(cfg_j, np.random.default_rng(0))
    ref_fn = jax.jit(lambda k: jdg.device_episode_arrays(cfg_j, k, ratings, S))
    for seed in (0, 1):
        key = jax.random.PRNGKey(seed)
        ref = ref_fn(key)
        got = tdg.device_episode_arrays(cfg_t, ratings, S, draws=trace_draws(jax_trace_arrays(key)), device="cpu")
        assert got._fields == ref._fields
        for name, g, r in zip(ref._fields, got, ref):
            assert tuple(g.shape) == r.shape and g.dtype == torch.float32
            _close(g.numpy(), r, f"key {seed} {name}")


def test_traces_shapes_ranges_and_generator():
    """The JAX package's own trace checks (tests/test_chunked.py:38-57) on
    the port's generator path, which is deterministic per seed."""
    run = lambda: tdg.device_scenario_traces(4, generator=torch.Generator().manual_seed(3), device="cpu")
    t, t_out, load, pv = run()
    assert tuple(t.shape) == (96,) and tuple(t_out.shape) == (4, 96)
    assert tuple(load.shape) == (4, 96, 5) and tuple(pv.shape) == (4, 96)
    np.testing.assert_allclose(t.numpy(), np.arange(96) / 96, atol=1e-6)
    assert load.max() <= 1.0 + 1e-6 and load.min() > 0.0
    np.testing.assert_allclose(load.amax(dim=1).numpy(), 1.0, atol=1e-5)
    np.testing.assert_allclose(pv.amax(dim=1).numpy(), 1.0, atol=1e-5)
    assert pv.min() >= 0.0 and 0.0 < float(t_out.mean()) < 20.0
    assert not torch.allclose(load[0], load[1])
    for a, b in zip(run(), (t, t_out, load, pv)):
        assert torch.equal(a, b)


def test_homogeneous_agents_share_profile_zero():
    """Agent i takes profile i % P, or profile 0 in a homogeneous community
    (parallel/device_gen.py:108-113), scaled by its load rating."""
    draws = tdg.draw_traces(3, torch.Generator().manual_seed(1), device="cpu")
    _, _, load, pv = tdg.device_scenario_traces(3, draws=draws, device="cpu")
    for homogeneous in (False, True):
        cfg = tcfg.default_config(sim=tcfg.SimConfig(n_agents=A, n_scenarios=3, homogeneous=homogeneous))
        ratings = make_ratings(cfg, np.random.default_rng(0))
        arrays = tdg.device_episode_arrays(cfg, ratings, 3, draws=draws, device="cpu")
        profile = [0] * A if homogeneous else [i % P for i in range(A)]
        rating = torch.as_tensor(ratings.load_rating_w, dtype=torch.float32)
        assert torch.equal(arrays.load_w, load[:, :, profile] * rating)
        assert torch.equal(arrays.pv_w, pv[:, :, None] * torch.as_tensor(ratings.pv_rating_w, dtype=torch.float32))
        assert torch.equal(arrays.next_load_w, torch.roll(arrays.load_w, -1, dims=1))
