"""The merged min kernel K1 (``csrc/merged_min.cu``), emulated in torch in the
kernel's order of every sum, and its folded entry.

K1 computes each entry once: a block owns 64 rows of one scenario, 8 a warp,
and walks the columns, lane L taking j = L, L + 32, ... So row i is each
lane's sum of its columns in order, then the xor-butterfly 16, 8, 4, 2, 1;
column j is each warp's 8 rows in order, then the 8 warps in order, then the
64-row tiles in order. Where the factors are finite with their sign bit
clear, the selects fold into the factors (two fused multiply-adds and a min
an entry), which must give every entry's bits.

On the CPU the emulation is held to ``merged_min_sums_plain`` at ``rtol=1e-5,
atol=1e-6 * scale`` (``chip_smoke.py``'s contract) and to the JAX package's
``merged_min_sums_pallas`` in interpret mode (imported inside that test), and
the fold to the plain entries bit for bit. The ``cuda``-marked tests hold the
kernel to the emulation bit for bit on the card (``python -m pytest
--noconftest tests/test_torch_merged_min_tiles.py -m cuda``); this file
imports neither JAX nor the JAX package at its top.
"""

import numpy as np
import pytest
import torch

from p2pmicrogrid_tpu_torch.ops import merged_min as mmin

CASES = ("random", "bf16", "zero", "no_prop", "one_sided")


def _inputs(S, A, case="random", seed=0, device="cpu"):
    """Six [S, A] float32 factors as the factored market makes them (the
    cases of ``chip_smoke.py``'s K1 phase): nonnegative, exact zeros in
    scenario 0, masks as 0/1."""
    rng = np.random.default_rng(seed)
    alpha, wplus, wminus, gamma = (rng.uniform(0.0, 1.0, (S, A)).astype(np.float32) for _ in range(4))
    pb, ps = ((rng.uniform(size=(S, A)) > 0.5).astype(np.float32) for _ in range(2))
    alpha[0, ::5] = 0.0
    gamma[0, ::7] = 0.0
    if case == "bf16":
        alpha, wplus, wminus, gamma = (
            torch.from_numpy(x).to(torch.bfloat16).float().numpy() for x in (alpha, wplus, wminus, gamma)
        )
    elif case == "zero":
        alpha[:] = 0.0
        gamma[:] = 0.0
    elif case == "no_prop":
        pb[:] = 0.0
        ps[:] = 0.0
    elif case == "one_sided":
        gamma[:] = 0.0  # no sellers
        ps[:] = 0.0
    return [torch.from_numpy(np.ascontiguousarray(x)).to(device) for x in (alpha, wplus, wminus, gamma, pb, ps)]


def _general(S, A, device="cpu"):
    """Factors outside the folded form's domain: negative values, -0, an
    infinity where its select drops it, and a NaN."""
    args = _inputs(S, A, "random", seed=3, device=device)
    alpha, wplus, wminus, gamma, pb, ps = args
    alpha[:, 1::4] *= -1.0
    wminus[:, 2::5] = -0.0
    pb[:, 3] = 0.0
    wplus[:, 3] = float("inf")  # times alpha only where pb is set
    gamma[-1, 2] = float("nan")
    return args


def merged_min_entries(alpha, wplus, wminus, gamma, pb, ps):
    """The plain version's entries, [S, A, A]."""
    lhs = torch.where(pb[..., :, None] > 0.0, alpha[..., :, None] * wplus[..., None, :], alpha[..., :, None])
    rhs = torch.where(ps[..., None, :] > 0.0, wminus[..., :, None] * gamma[..., None, :], gamma[..., None, :])
    return torch.minimum(lhs, rhs)


def _butterfly(lanes: torch.Tensor) -> torch.Tensor:
    idx = torch.arange(32, device=lanes.device)
    for m in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[..., idx ^ m]
    return lanes[..., 0]


def merged_min_emulated(*args):
    """K1's (row, col) in its order of every sum."""
    m = merged_min_entries(*args)
    S, A, _ = m.shape
    n32, n64 = -(-A // 32) * 32, -(-A // 64) * 64
    pad = torch.zeros((S, n64, n32), dtype=torch.float32, device=m.device)
    pad[:, :A, :A] = m
    lanes = torch.zeros((S, n64, 32), dtype=torch.float32, device=m.device)
    for t in range(n32 // 32):
        lanes = lanes + pad[:, :, 32 * t:32 * (t + 1)]
    row = _butterfly(lanes)[:, :A]
    groups = pad[:, :, :A].reshape(S, n64 // 8, 8, A)
    warp = torch.zeros((S, n64 // 8, A), dtype=torch.float32, device=m.device)
    for r in range(8):
        warp = warp + groups[:, :, r]
    warp = warp.reshape(S, n64 // 64, 8, A)
    tile = warp[:, :, 0]
    for w in range(1, 8):
        tile = tile + warp[:, :, w]
    col = torch.zeros((S, A), dtype=torch.float32, device=m.device)
    for t in range(n64 // 64):
        col = col + tile[:, t]
    return row, col


def _fma32(a, b, c):
    """fma(a, b, c) in float32 where one of a * b and c is a zero: the float64
    product is exact, and so is its sum with the other term."""
    return (a.double() * b.double() + c.double()).float()


def _plain_nonneg(x: torch.Tensor) -> torch.Tensor:
    """The kernel's domain test: finite with the sign bit clear."""
    return (x.view(torch.int32) >= 0) & (x.view(torch.int32) < 0x7F800000)


def folded_entries(alpha, wplus, wminus, gamma, pb, ps):
    """The kernel's folded entry: fminf(fma(a1, wplus, a0), fma(wminus, g1,
    g0)), a1 = pb ? alpha : 0, a0 = pb ? -0 : alpha (g1, g0 alike)."""
    zero, neg_zero = torch.zeros_like(alpha), torch.full_like(alpha, -0.0)
    a1 = torch.where(pb > 0.0, alpha, zero)
    a0 = torch.where(pb > 0.0, neg_zero, alpha)
    g1 = torch.where(ps > 0.0, gamma, zero)
    g0 = torch.where(ps > 0.0, neg_zero, gamma)
    lhs = _fma32(a1[..., :, None], wplus[..., None, :], a0[..., :, None])
    rhs = _fma32(wminus[..., :, None], g1[..., None, :], g0[..., None, :])
    return torch.fmin(lhs, rhs)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("shape", [(3, 37), (2, 64), (1, 65)])
def test_emulation_matches_plain(shape, case):
    args = _inputs(*shape, case)
    for got, ref in zip(merged_min_emulated(*args), mmin.merged_min_sums_plain(*args)):
        scale = max(float(ref.abs().max()), 1e-30)
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6 * scale)
    if case == "zero":
        assert all(float(x.abs().max()) == 0.0 for x in merged_min_emulated(*args))


def test_emulation_matches_plain_outside_the_fold():
    args = _general(3, 37)
    for got, ref in zip(merged_min_emulated(*args), mmin.merged_min_sums_plain(*args)):
        assert torch.equal(torch.isnan(got), torch.isnan(ref)) and bool(torch.isnan(got).any())
        keep = ~torch.isnan(ref)
        torch.testing.assert_close(got[keep], ref[keep], rtol=1e-5, atol=1e-6 * float(ref[keep].abs().max()))


def test_emulation_matches_jax_pallas():
    """Against the JAX package's Pallas kernel in interpret mode, at the shape
    and tolerance of tests/test_torch_factored.py (tests/test_pallas.py:184-212)."""
    jnp = pytest.importorskip("jax.numpy")
    from p2pmicrogrid_tpu.ops.pallas_factored import merged_min_sums_pallas

    args = _inputs(3, 50)
    want = merged_min_sums_pallas(*(jnp.asarray(x.numpy()) for x in args), i_tile=16)
    for got, ref in zip(merged_min_emulated(*args), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)


@pytest.mark.parametrize("case", CASES)
def test_fold_gives_every_entry_bit_for_bit(case):
    """Within the domain (finite, sign bit clear: the market's factors, zeros
    included) the folded entry is the plain entry's bits; so are products
    that overflow or fall below the normal range."""
    args = _inputs(3, 37, case)
    if case == "random":
        args[0][1, :5] = torch.tensor([3e38, 1e-38, 1e-45, 0.0, 1.0])
        args[1][1, :5] = torch.tensor([10.0, 1e-3, 0.5, 2.0, 1e-45])
    for x in args[:4]:
        assert bool(_plain_nonneg(x).all())
    got, ref = folded_entries(*args), merged_min_entries(*args)
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    assert bool((ref == 0).any())


def test_fold_needs_its_domain():
    """Outside it the fold differs (an infinity its select drops becomes a
    NaN), which is why such steps take the exact form."""
    args = _general(3, 37)
    got, ref = folded_entries(*args), merged_min_entries(*args)
    assert not torch.equal(torch.isnan(got), torch.isnan(ref))


@pytest.fixture
def cuda_generator():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA kernel has no CPU mode")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    return gen


def _same_bits(got: torch.Tensor, ref: torch.Tensor) -> bool:
    """Bit for bit, NaNs compared by position."""
    nan = torch.isnan(ref)
    return torch.equal(torch.isnan(got), nan) and torch.equal(
        got[~nan].view(torch.int32), ref[~nan].view(torch.int32)
    )


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES + ("general",))
@pytest.mark.parametrize("shape", [(3, 37), (5, 257), (64, 1000), (256, 50), (2, 64), (3, 65)])
def test_kernel_matches_emulation_on_card(cuda_generator, shape, case):
    """The folded steps and, for ``general``, the exact form; one tile
    (A <= 64, no column-sum kernel) and many; a repeat is bit-identical."""
    S, A = shape
    args = _general(S, A, "cuda") if case == "general" else _inputs(S, A, case, device="cuda")
    config = mmin.kernel_config(S, A, "cuda")
    assert config["colsum_kernel"] == (A > 64) and config["cols_per_thread"] == (2 if A <= 64 else 8)
    assert config["grid"][0] == -(-A // mmin._TILE_ROWS)  # the wrapper's partial buffer
    before = mmin.merged_min_sums.launches
    got = mmin.merged_min_sums(*args)
    again = mmin.merged_min_sums(*args)
    torch.cuda.synchronize()
    assert mmin.merged_min_sums.launches == before + 2
    for g, a, r in zip(got, again, merged_min_emulated(*args)):
        assert _same_bits(g, r)
        assert _same_bits(a, g)
