"""Kernel K1's module and the factored clearing against the JAX package.

On the CPU the wrapper ``merged_min_sums`` runs its plain version; the CUDA
kernel itself is held to the plain version on the card by
tests/test_torch_cuda.py and by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2pmicrogrid_tpu.ops import factored_market as jfm
from p2pmicrogrid_tpu.ops.pallas_factored import merged_min_sums_pallas
from p2pmicrogrid_tpu_torch.ops import factored_market as tfm
from p2pmicrogrid_tpu_torch.ops import market as tmarket
from p2pmicrogrid_tpu_torch.ops.merged_min import (
    merged_min_sums,
    merged_min_sums_plain,
)


def _t(x):
    return torch.from_numpy(np.array(x))


def _merged_inputs(rng, S, A):
    vecs = [rng.uniform(0.0, 1.0, (S, A)).astype(np.float32) for _ in range(4)]
    masks = [(rng.uniform(size=(S, A)) > 0.5).astype(np.float32) for _ in range(2)]
    return vecs + masks


def test_merged_min_plain_matches_pallas_kernel():
    """The plain version against the JAX package's Pallas kernel in interpret
    mode, at the shape and tolerance of tests/test_pallas.py:184-212."""
    args = _merged_inputs(np.random.default_rng(0), 3, 50)
    row_j, col_j = merged_min_sums_pallas(*map(jnp.asarray, args), i_tile=16)
    row_t, col_t = merged_min_sums_plain(*map(_t, args))
    np.testing.assert_allclose(row_t.numpy(), np.asarray(row_j), rtol=1e-6)
    np.testing.assert_allclose(col_t.numpy(), np.asarray(col_j), rtol=1e-6)


def test_wrapper_takes_plain_version_on_cpu():
    args = [_t(x) for x in _merged_inputs(np.random.default_rng(1), 2, 9)]
    before = merged_min_sums.launches
    got = merged_min_sums(*args)
    want = merged_min_sums_plain(*args)
    assert merged_min_sums.launches == before  # no kernel launch on the CPU
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _books(rng, S=6, A=40, scale=1500.0):
    """(b0, b1) pairs covering the clearing's branches: random books, zero
    balances, one-sided books (no sellers) and rows whose opposite class is
    empty except for themselves (the equal branch)."""
    b0 = rng.normal(0.0, scale, (S, A)).astype(np.float32)
    b1 = rng.normal(0.0, scale, (S, A)).astype(np.float32)
    b0[1, ::3] = 0.0
    b1[1, ::4] = 0.0
    b0[2] = np.abs(b0[2])
    b1[2] = np.abs(b1[2])  # one-sided: buyers only
    b0[3] = -np.abs(b0[3])
    b0[3, 0] = 500.0  # the only positive b0: its own row is excluded
    b1[3] = np.abs(b1[3])  # buyers whose opp weights are zero -> equal rows
    b0[4] = 0.0  # every row takes the equal branch
    return b0, b1


def _assert_clearing_close(got, ref, scale):
    # Tolerance of tests/test_factored_market.py:49-52.
    for g, r in zip(got, ref):
        np.testing.assert_allclose(
            g.numpy(), np.asarray(r), rtol=1e-4, atol=2e-4 * scale
        )


def test_clear_factored_rounds1_f32():
    b0, b1 = _books(np.random.default_rng(2))
    ref = jax.jit(jfm.clear_factored_rounds1)(b0, b1)
    got = tfm.clear_factored_rounds1(_t(b0), _t(b1))
    scale = max(1.0, float(np.abs(np.asarray(ref[1])).max()))
    _assert_clearing_close(got, ref, scale)


def test_clear_factored_rounds0_f32():
    b0, _ = _books(np.random.default_rng(3))
    ref = jax.jit(jfm.clear_factored_rounds0)(b0)
    got = tfm.clear_factored_rounds0(_t(b0))
    scale = max(1.0, float(np.abs(np.asarray(ref[1])).max()))
    _assert_clearing_close(got, ref, scale)


def test_factored_matches_matrix_chain():
    """The port's clearing against the port's own plain matrix chain (equal
    round 0, proportional divide, sign-opposition clearing)."""
    b0, b1 = (_t(x) for x in _books(np.random.default_rng(4)))
    S, A = b0.shape
    p0 = (b0 / A)[..., None].expand(S, A, A)
    powers = -tmarket.zero_diagonal(p0).transpose(-1, -2)
    ref = tmarket.clear_market(tmarket.divide_power(b1, powers))
    got = tfm.clear_factored_rounds1(b0, b1)
    scale = max(1.0, float(ref[1].abs().max()))
    _assert_clearing_close(got, (r.numpy() for r in ref), scale)


def test_rank1_min_sums_matches_jax():
    rng = np.random.default_rng(5)
    args = [rng.uniform(0.0, 2.0, (3, 30)).astype(np.float32) for _ in range(4)]
    args[0][0, :5] = 0.0
    ref = jax.jit(jfm.rank1_min_sums)(*args)
    got = tfm.rank1_min_sums(*map(_t, args))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6)


@pytest.mark.parametrize("rounds", [0, 1])
def test_bf16_pre_rounding_matches_jax_kernel_path(monkeypatch, rounds):
    """Under a bf16 compute dtype the port pre-rounds the factor vectors
    through bf16 before the f32 min pass: the JAX package's kernel path
    (P2P_FACTORED_PALLAS=1, read when the function is traced) does the same
    for rounds=1. Its rounds=0 pass rounds the two vectors to bf16 and takes
    an exact min, which pre-rounding reproduces."""
    monkeypatch.setenv("P2P_FACTORED_PALLAS", "1")
    b0, b1 = _books(np.random.default_rng(6), A=48)
    if rounds:
        ref = jax.jit(lambda x, y: jfm.clear_factored_rounds1(x, y, jnp.bfloat16))(b0, b1)
        got = tfm.clear_factored_rounds1(_t(b0), _t(b1), torch.bfloat16)
    else:
        ref = jax.jit(lambda x: jfm.clear_factored_rounds0(x, jnp.bfloat16))(b0)
        got = tfm.clear_factored_rounds0(_t(b0), torch.bfloat16)
    scale = float(np.abs(b1).max())
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32
        # p_grid = b - p_p2p cancels where a row is fully matched.
        np.testing.assert_allclose(
            g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-6 * scale
        )


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_conservation(dtype):
    b0, b1 = (_t(x) for x in _books(np.random.default_rng(8)))
    for b, (g, p) in (
        (b1, tfm.clear_factored_rounds1(b0, b1, dtype)),
        (b0, tfm.clear_factored_rounds0(b0, dtype)),
    ):
        # Tolerance of tests/test_factored_market.py:305-308.
        np.testing.assert_allclose((g + p).numpy(), b.numpy(), rtol=1e-5, atol=1e-3)

