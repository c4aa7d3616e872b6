"""Alternative P2P market mechanisms: drop-in siblings of the midpoint rule.

The port of the JAX package's ``ops/auction.py``. The paper settles every
matched P2P trade at the midpoint of the grid buy/injection spread
(``ops/tariff.p2p_price``, reference community.py:70); the scenario-regime
engine (``regimes/``) composes two standard mechanisms per scenario:

* ``double_auction_price`` — a k-double auction over the community's
  flat-valuation book: buyers bid the grid buy price, sellers ask the
  injection price, and the book clears at ``ask + k * (bid - ask)``. Written
  midpoint-anchored (``mid + (k - 1/2) * spread``) so ``k = 0.5`` reduces
  to the midpoint rule bit for bit.
* ``uniform_clearing_price`` — one uniform price at the crossing of the
  aggregate demand/supply curves, tilted toward the scarce side by the
  book's imbalance: ``mid + spread/2 * (demand - supply) / (demand +
  supply)``. A balanced book reduces to the midpoint bit for bit. The
  denominator is floored at 1 W: ``torch.where``-style selects evaluate
  every branch, so the empty book's 0/0 must not exist in any of them.

Each mechanism only sets the PRICE of trades the clearing already matched,
so per-slot energy conservation holds under all of them.
``mechanism_trade_price`` prices a batch that mixes mechanisms: the
mechanism is an int32 tensor (one per scenario) selected by two nested
``torch.where``s.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from p2pmicrogrid_tpu_torch.ops.tariff import p2p_price

# Mechanism ids (int32 entries on the regime axis).
MECH_MIDPOINT = 0
MECH_DOUBLE_AUCTION = 1
MECH_UNIFORM = 2

MECHANISM_IDS = {
    "midpoint": MECH_MIDPOINT,
    "double_auction": MECH_DOUBLE_AUCTION,
    "uniform": MECH_UNIFORM,
}
MECHANISM_NAMES = {v: k for k, v in MECHANISM_IDS.items()}


def trade_volumes(powers: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The community book's volumes from per-agent net powers [..., A]
    (positive buys, negative sells): ``(demand_w, supply_w)`` [...]. Pass the
    PRE-clearing book (``p_grid + p_p2p``): the matched trades alone balance
    by construction, which would pin the uniform price's tilt at zero."""
    return (
        torch.clamp(powers, min=0.0).sum(dim=-1),
        torch.clamp(-powers, min=0.0).sum(dim=-1),
    )


def double_auction_price(
    buy: torch.Tensor,
    inj: torch.Tensor,
    demand_w: torch.Tensor,
    supply_w: torch.Tensor,
    k=0.5,
) -> torch.Tensor:
    """k-double-auction price: ``mid + (k - 0.5) * (buy - inj)``. ``k`` is
    the seller-surplus share (0: the whole spread to buyers, 1: to
    sellers); the volumes are accepted for the shared signature: a
    flat-valuation book's marginal pair is (buy, inj) whatever they are.
    A Python ``k`` is taken as float32 first, as ``jnp.asarray(k)`` takes
    it."""
    del demand_w, supply_w
    share = k - 0.5 if torch.is_tensor(k) else float(np.float32(k) - np.float32(0.5))
    return p2p_price(buy, inj) + share * (buy - inj)


def uniform_clearing_price(
    buy: torch.Tensor,
    inj: torch.Tensor,
    demand_w: torch.Tensor,
    supply_w: torch.Tensor,
) -> torch.Tensor:
    """Uniform clearing price ``mid + spread/2 * (demand - supply) /
    max(demand + supply, 1 W)``."""
    total = torch.clamp(demand_w + supply_w, min=1.0)
    tilt = (demand_w - supply_w) / total
    return p2p_price(buy, inj) + 0.5 * (buy - inj) * tilt


def mechanism_trade_price(
    mechanism: torch.Tensor,
    buy: torch.Tensor,
    inj: torch.Tensor,
    demand_w: torch.Tensor,
    supply_w: torch.Tensor,
    auction_k=0.5,
) -> torch.Tensor:
    """Mixed-batch dispatch: ``mechanism`` is an int32 tensor (``MECH_*``
    per element, broadcasting with the prices); all three prices are
    computed and two nested selects pick one."""
    mid = p2p_price(buy, inj)
    da = double_auction_price(buy, inj, demand_w, supply_w, auction_k)
    up = uniform_clearing_price(buy, inj, demand_w, supply_w)
    return torch.where(
        mechanism == MECH_DOUBLE_AUCTION, da, torch.where(mechanism == MECH_UNIFORM, up, mid)
    )
