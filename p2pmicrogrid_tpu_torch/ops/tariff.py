"""Time-of-use grid tariff — pure price curve.

Reference: microgrid/agent.py:46-67 (``GridAgent``): sinusoidal buy price in
c€/kWh converted to €/kWh, flat injection price in €/kWh.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from p2pmicrogrid_tpu_torch.config import CENTS_PER_EURO, HOURS_PER_DAY, TariffConfig
from p2pmicrogrid_tpu_torch.ops._f32 import recip


def grid_prices(
    cfg: TariffConfig, time_norm: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Buy and injection price for normalized day-time ``time_norm`` in [0, 1).

    buy(t) = (avg + amp * sin(t * 2*pi*24/period - phase)) / 100   [€/kWh]
    (agent.py:54,60-64); injection price is constant (agent.py:57).
    """
    freq = 2.0 * math.pi * HOURS_PER_DAY / cfg.cost_period
    buy = (
        cfg.cost_avg + cfg.cost_amplitude * torch.sin(time_norm * freq - cfg.cost_phase)
    ) * recip(CENTS_PER_EURO)
    injection = torch.full_like(buy, cfg.injection_price)
    return buy, injection


def p2p_price(buy: torch.Tensor, injection: torch.Tensor) -> torch.Tensor:
    """Midpoint P2P settlement price (community.py:70)."""
    return 0.5 * (buy + injection)
