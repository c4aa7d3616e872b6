"""Matrix-free P2P market clearing for the default one-round negotiation.

The reference's negotiation/clearing (community.py:45-54,75-89 via
agent.py:186-195) materialises an A x A proposal matrix per scenario. For
``rounds <= 1`` the final matrix has structure that removes it:

* Round 0 splits against a zero matrix, so every row takes divide_power's
  equal branch: ``P0[i, j] = b0_i / A`` — rank 1.
* Round 1 splits against the rank-1 "powers" ``-b0_j / A``, so each row of
  the final matrix is a rank-1 profile over one sign class of b0:
  ``P1[i, j] = b1_i * w_j / opp_i`` with ``w_j = relu(±b0_j)`` chosen by
  ``sign(b1_i)`` and ``opp_i`` the masked sum of those weights (or the equal
  branch ``b1_i / A`` when ``opp_i = 0``).
* Rows are sign-uniform, so sign-opposition matching reduces to buyer x
  seller class pairs, and each matched block is a rank-1 min whose row and
  column sums the merged min pass (``ops/merged_min.py``, kernel K1)
  computes without the matrix.

Row sums of the final matrix telescope to ``b1`` exactly (both divide
branches are normalized), so ``p_grid = b1 - p_p2p``. The JAX counterpart
is ``p2pmicrogrid_tpu/ops/factored_market.py``; ``clear_factored_rounds1``
here always takes the kernel route of its ``P2P_FACTORED_PALLAS`` branch.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from p2pmicrogrid_tpu_torch.ops._f32 import recip
from p2pmicrogrid_tpu_torch.ops.merged_min import merged_min_sums


def rank1_min_sums(
    a: torch.Tensor,
    delta: torch.Tensor,
    beta: torch.Tensor,
    gamma: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row and column sums of ``M[i, j] = min(a_i * beta_j, delta_i * gamma_j)``.

    The reference form the tests hold the clearing to; it materialises M.
    All inputs are nonnegative ``[..., N]``; entries with a zero factor on
    either side contribute exactly zero.
    """
    lhs = a[..., :, None] * beta[..., None, :]
    rhs = delta[..., :, None] * gamma[..., None, :]
    m = torch.minimum(lhs, rhs)
    return m.sum(dim=-1), m.sum(dim=-2)


def _pre_round(xs, compute_dtype: Optional[torch.dtype]):
    """Round the factor vectors through ``compute_dtype`` and back to f32 —
    the storage rounding of a narrow compute dtype; the kernel then computes
    and accumulates in f32."""
    if compute_dtype is None:
        return xs
    return tuple(x.to(compute_dtype).to(torch.float32) for x in xs)


def _settle(b, buyer, seller, matched_buy, matched_sell):
    p_p2p = torch.where(
        buyer,
        matched_buy,
        torch.where(seller, -matched_sell, torch.zeros_like(matched_sell)),
    )
    return b - p_p2p, p_p2p


def clear_factored_rounds1(
    b0: torch.Tensor,
    b1: torch.Tensor,
    compute_dtype: Optional[torch.dtype] = None,
    min_sums: Callable = merged_min_sums,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(p_grid, p_p2p) of the rounds=1 negotiation chain, matrix-free.

    b0: [S, A] round-0 net powers (equal-split round); b1: [S, A] round-1
    net powers (the final decisions). Equal, to f32 summation order, to
    ``clear_market(divide_power(b1, -P0^T with zero diagonal))``.
    ``compute_dtype`` (``torch.bfloat16``) pre-rounds the four factor
    vectors through it before the f32 min pass. ``min_sums`` is the merged
    min pass (the K1 wrapper, or its plain version).
    """
    A = b0.shape[-1]
    zero = torch.zeros_like(b0)
    wplus = torch.clamp_min(b0, 0.0)     # buyer-row column weights
    wminus = torch.clamp_min(-b0, 0.0)   # seller-row column weights
    sp = wplus.sum(dim=-1, keepdim=True)
    sn = wminus.sum(dim=-1, keepdim=True)

    buyer = b1 > 0.0
    seller = b1 < 0.0
    # opp_i = A * divide_power's |total|: the masked opposite-proposal sum
    # (self excluded) the proportional branch normalizes by.
    opp = torch.where(buyer, sp - wplus, torch.where(seller, sn - wminus, zero))
    prop = opp > 0.0  # proportional rows; opp == 0 -> equal branch

    absb1 = b1.abs()
    safe_opp = torch.where(prop, opp, torch.ones_like(opp))
    a_p = torch.where(buyer & prop, absb1 / safe_opp, zero)
    a_e = torch.where(buyer & ~prop, absb1 * recip(A), zero)
    g_p = torch.where(seller & prop, absb1 / safe_opp, zero)
    g_e = torch.where(seller & ~prop, absb1 * recip(A), zero)

    # The four buyer-type x seller-type blocks have disjoint supports, so one
    # class-selected min per entry reproduces them (JAX source, :176-190).
    alpha, wplus_c, wminus_c, gamma = _pre_round(
        (a_p + a_e, wplus, wminus, g_p + g_e), compute_dtype
    )
    matched_buy, matched_sell = min_sums(
        alpha.contiguous(),
        wplus_c.contiguous(),
        wminus_c.contiguous(),
        gamma.contiguous(),
        (buyer & prop).to(torch.float32),
        (seller & prop).to(torch.float32),
    )
    return _settle(b1, buyer, seller, matched_buy, matched_sell)


def clear_factored_rounds0(
    b0: torch.Tensor,
    compute_dtype: Optional[torch.dtype] = None,
    min_sums: Callable = merged_min_sums,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(p_grid, p_p2p) for a single decision round (rounds == 0): every row
    is the equal branch ``b0_i / A`` — one min(a_e_i, g_e_j) block, which is
    the merged min pass with no proportional rows or columns."""
    A = b0.shape[-1]
    zero = torch.zeros_like(b0)
    buyer = b0 > 0.0
    seller = b0 < 0.0
    absb = b0.abs()
    a_e = torch.where(buyer, absb * recip(A), zero)
    g_e = torch.where(seller, absb * recip(A), zero)
    a_e, g_e = _pre_round((a_e, g_e), compute_dtype)
    row, col = min_sums(a_e, zero, zero, g_e, zero, zero)
    return _settle(b0, buyer, seller, row, col)
