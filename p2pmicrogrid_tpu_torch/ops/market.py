"""P2P market clearing, settlement costs, and proposal splitting.

Reference: microgrid/community.py:45-65 (``_assign_powers``/``_compute_costs``)
and agent.py:186-195 (``_divide_power``). All functions broadcast over leading
batch axes (scenarios); the agent axes are the trailing one or two dims.

Sign convention (inherited from the reference): positive power = consumption
(buy), negative = injection (sell). ``p2p[i, j]`` is agent i's proposed
exchange with agent j; a trade matches where ``p2p[i, j]`` and ``p2p[j, i]``
have opposite signs.

``compute_costs`` is on the slot path. ``clear_market``, ``divide_power`` and
``zero_diagonal`` are the plain semantic oracle of the matrix negotiation:
the factored clearing reproduces them, and the plain versions of the matrix
kernels (``ops/matrix_market.py``) are built from them.
"""

from __future__ import annotations

from typing import Tuple

import torch

from p2pmicrogrid_tpu_torch.ops._f32 import recip


def clear_market(p2p: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pairwise sign-opposition matching (community.py:45-54).

    p2p: [..., A, A] proposals (diagonal zero). Returns (p_grid, p_p2p), each
    [..., A]: matched power settles peer-to-peer, the residual with the grid.
    """
    p2p_t = p2p.transpose(-1, -2)
    p_match = torch.where(
        torch.sign(p2p) != torch.sign(p2p_t), p2p, torch.zeros_like(p2p)
    )
    abs_match = p_match.abs()
    exchange = torch.sign(p_match) * torch.minimum(
        abs_match, abs_match.transpose(-1, -2)
    )
    p_grid = torch.sum(p2p - exchange, dim=-1)
    p_p2p = torch.sum(exchange, dim=-1)
    return p_grid, p_p2p


def compute_costs(
    p_grid: torch.Tensor,
    p_p2p: torch.Tensor,
    buy_price: torch.Tensor,
    injection_price: torch.Tensor,
    p2p_price: torch.Tensor,
    slot_hours: float,
) -> torch.Tensor:
    """Per-agent settlement cost in € for one slot (community.py:56-65).

    Powers in W; ``* slot_hours * 1e-3`` converts W to kWh. Positive grid
    power pays the buy price, negative earns the injection price; matched P2P
    power settles at the midpoint price. Prices broadcast over agents.
    """
    grid_cost = torch.where(
        p_grid >= 0.0, p_grid * buy_price, p_grid * injection_price
    )
    return (grid_cost + p_p2p * p2p_price) * slot_hours * 1e-3


def divide_power(out: torch.Tensor, powers: torch.Tensor) -> torch.Tensor:
    """Split each agent's net power across counterparties (agent.py:186-195).

    out: [...] net power; powers: [..., A] what each counterparty proposed
    toward this agent. Split proportionally to counterparties of opposite
    sign; with none, split equally.
    """
    filtered = torch.where(
        torch.sign(out)[..., None] != torch.sign(powers),
        powers,
        torch.zeros_like(powers),
    )
    total = torch.sum(filtered, dim=-1, keepdim=True).abs()
    n = powers.shape[-1]
    # torch.where evaluates both branches: guard the denominator so the
    # untaken proportional branch cannot produce 0/0 = NaN.
    safe_total = torch.where(total > 0.0, total, torch.ones_like(total))
    proportional = out[..., None] * filtered.abs() / safe_total
    equal = out[..., None] * torch.ones_like(powers) * recip(n)
    return torch.where(total > 0.0, proportional, equal)


def zero_diagonal(p2p: torch.Tensor) -> torch.Tensor:
    """Remove self-trades (community.py:76)."""
    a = p2p.shape[-1]
    eye = torch.eye(a, dtype=p2p.dtype, device=p2p.device)
    return p2p * (1.0 - eye)
