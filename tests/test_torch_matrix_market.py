"""Kernels K2-K6's module against the JAX package's Pallas kernels.

Each plain version runs against the jitted JAX Pallas function (interpret
mode on the CPU), on the fixtures of tests/test_pallas.py:38-52 (a zero row,
an all-same-sign scenario, a zero ``out_power``) plus a scenario of exact
ties ``|p_ij| = |p_ji|``. Tolerances: float32 storage ``rtol=1e-5,
atol=1e-3``, clearing ``atol=1e-2`` (tests/test_pallas.py:55-98); bfloat16
storage: the matrix within one bfloat16 ulp (``rtol=8e-3``), the float32
means at ``rtol=1e-5, atol=1e-3``. On the CPU every wrapper runs its plain
version; the CUDA kernels are held to the plain versions on the card by
tests/test_torch_cuda.py and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2pmicrogrid_tpu.ops import pallas_market as jpm
from p2pmicrogrid_tpu_torch.ops import market as tmarket
from p2pmicrogrid_tpu_torch.ops import matrix_market as tmm

S, A = 5, 6
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def p2p_np():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((S, A, A)).astype(np.float32) * 1e3
    x[0, 0, :] = 0.0
    x[1] = np.abs(x[1])
    m = rng.standard_normal((A, A)).astype(np.float32) * 1e3
    x[4] = m - m.T  # every pair opposite and tied: |p_ij| = |p_ji|
    return x


@pytest.fixture(scope="module")
def out_np():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((S, A)).astype(np.float32) * 1e3
    x[2, 0] = 0.0
    return x


def _pair(x, dtype):
    jd, td = DTYPES[dtype]
    return jnp.asarray(x, dtype=jd), torch.from_numpy(x).to(td)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


def _close_matrix(got, ref, dtype):
    rtol = 1e-5 if dtype == "float32" else 8e-3
    np.testing.assert_allclose(_np(got), _np(ref), rtol=rtol, atol=1e-3)


def _close_mean(got, ref):
    np.testing.assert_allclose(_np(got), _np(ref), rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prep_mean_matches_jax(p2p_np, dtype):
    jx, tx = _pair(p2p_np, dtype)
    got = tmm.prep_mean_plain(tx)
    assert got.dtype == torch.float32
    _close_mean(got, jpm.prep_mean(jx))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_divide_power_fused_matches_jax(p2p_np, out_np, dtype):
    jx, tx = _pair(p2p_np, dtype)
    got = tmm.divide_power_fused_plain(tx, torch.from_numpy(out_np))
    assert got.dtype == tx.dtype
    _close_matrix(got, jpm.divide_power_fused(jx, jnp.asarray(out_np)), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_divide_power_fused_with_mean_matches_jax(p2p_np, out_np, dtype):
    jx, tx = _pair(p2p_np, dtype)
    new, mean = tmm.divide_power_fused_with_mean_plain(tx, torch.from_numpy(out_np))
    new_j, mean_j = jpm.divide_power_fused_with_mean(jx, jnp.asarray(out_np))
    assert new.dtype == tx.dtype and mean.dtype == torch.float32
    _close_matrix(new, new_j, dtype)
    _close_mean(mean, mean_j)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_divide_rank1_fused_matches_jax(out_np, dtype):
    rng = np.random.default_rng(3)
    prev = rng.standard_normal((S, A)).astype(np.float32) * 1e3
    prev[3] = 0.0  # round 0 all zero: every row takes the equal split
    jd, td = DTYPES[dtype]
    new, mean = tmm.divide_rank1_fused_plain(
        torch.from_numpy(prev), torch.from_numpy(out_np), out_dtype=td
    )
    new_j, mean_j = jpm.divide_rank1_fused(jnp.asarray(prev), jnp.asarray(out_np), out_dtype=jd)
    assert new.dtype == td and mean.dtype == torch.float32
    _close_matrix(new, new_j, dtype)
    _close_mean(mean, mean_j)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clear_market_fused_matches_jax(p2p_np, dtype):
    jx, tx = _pair(p2p_np, dtype)
    grid, peer = tmm.clear_market_fused_plain(tx)
    grid_j, peer_j = jpm.clear_market_fused(jx)
    for got, ref in ((grid, grid_j), (peer, peer_j)):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(_np(got), _np(ref), rtol=1e-5, atol=1e-2)
    # The tied scenario matches every pair in full: each side's exchange is
    # its whole proposal off the diagonal.
    np.testing.assert_allclose(
        _np(peer)[4], _np(tx.float()[4].sum(-1) - tx.float()[4].diagonal()), rtol=1e-5, atol=1e-2
    )


def test_wrappers_take_plain_versions_on_cpu(p2p_np, out_np):
    """CPU tensors run the plain versions, bit for bit, and count no launch."""
    p2p, out = torch.from_numpy(p2p_np), torch.from_numpy(out_np)
    prev = out.flip(-1).contiguous()
    wrappers = (
        tmm.prep_mean,
        tmm.divide_power_fused,
        tmm.divide_power_fused_with_mean,
        tmm.divide_rank1_fused,
        tmm.clear_market_fused,
    )
    before = [w.launches for w in wrappers]
    pairs = [
        (tmm.prep_mean(p2p), tmm.prep_mean_plain(p2p)),
        (tmm.divide_power_fused(p2p, out), tmm.divide_power_fused_plain(p2p, out)),
        (tmm.divide_power_fused_with_mean(p2p, out), tmm.divide_power_fused_with_mean_plain(p2p, out)),
        (tmm.divide_rank1_fused(prev, out, torch.bfloat16), tmm.divide_rank1_fused_plain(prev, out, torch.bfloat16)),
        (tmm.clear_market_fused(p2p), tmm.clear_market_fused_plain(p2p)),
    ]
    for got, ref in pairs:
        for g, r in zip(got if isinstance(got, tuple) else (got,), ref if isinstance(ref, tuple) else (ref,)):
            assert g.dtype == r.dtype and torch.equal(g, r)
    assert [w.launches for w in wrappers] == before


def test_plain_versions_match_the_oracle(p2p_np, out_np):
    """K4's plain version is the oracle's divide_power against the
    transposed, diagonal-zeroed matrix, and K6's is clear_market; the rank-1
    shortcut equals K4 on the materialised round-0 matrix."""
    p2p, out = torch.from_numpy(p2p_np), torch.from_numpy(out_np)
    powers = -tmarket.zero_diagonal(p2p).transpose(-1, -2)
    new, mean = tmm.divide_power_fused_with_mean_plain(p2p, out)
    torch.testing.assert_close(new, tmarket.divide_power(out, powers), rtol=0, atol=0)
    torch.testing.assert_close(mean, tmm.prep_mean_plain(new), rtol=1e-6, atol=1e-3)
    grid, peer = tmm.clear_market_fused_plain(p2p)
    ref_grid, ref_peer = tmarket.clear_market(p2p)
    assert torch.equal(grid, ref_grid) and torch.equal(peer, ref_peer)
    prev = out.flip(0).contiguous()
    rank1 = (prev * (1.0 / np.float32(A)))[:, :, None].expand(S, A, A).contiguous()
    for got, ref in zip(
        tmm.divide_rank1_fused_plain(prev, out), tmm.divide_power_fused_with_mean_plain(rank1, out)
    ):
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-3)
