"""Battery storage with sqrt-efficiency accounting — the rule-based step.

Reference: microgrid/storage.py:36-76 (``BatteryStorage``) and the rule-based
charge/discharge policy at agent.py:138-153 (``RuleAgent._update_storage``).
State is the state of charge ``soc``. Charging ``e`` Ws adds
``sqrt(eta) * e / capacity`` SoC; discharging to deliver ``e`` Ws removes
``(e / sqrt(eta)) / capacity`` SoC. ``sqrt(eta)`` is the float32 square root
of the float32 constant, as ``jnp.sqrt(cfg.efficiency)`` gives it.
"""

from __future__ import annotations

from typing import Tuple

import torch

from p2pmicrogrid_tpu_torch.config import BatteryConfig
from p2pmicrogrid_tpu_torch.ops._f32 import recip, sqrt


def available_space(cfg: BatteryConfig, soc: torch.Tensor) -> torch.Tensor:
    """Input energy [Ws] the battery can still absorb (storage.py:47-50)."""
    return torch.clamp_min(cfg.max_soc - soc, 0.0) * cfg.capacity * recip(
        sqrt(cfg.efficiency)
    )


def available_energy(cfg: BatteryConfig, soc: torch.Tensor) -> torch.Tensor:
    """Output energy [Ws] the battery can still deliver (storage.py:53-55)."""
    return torch.clamp_min(soc - cfg.min_soc, 0.0) * cfg.capacity * sqrt(
        cfg.efficiency
    )


def battery_rule_update(
    cfg: BatteryConfig,
    soc: torch.Tensor,
    balance: torch.Tensor,
    dt: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy rule-based storage policy (agent.py:138-153).

    Positive balance (net consumption) discharges the battery to cover it;
    negative balance (excess PV) charges the battery with the surplus. Returns
    (new_soc, new_balance) with the covered/stored part removed.
    """
    zero = torch.zeros_like(balance)
    energy = balance * dt
    discharge = torch.where(
        balance > 0.0, torch.minimum(energy, available_energy(cfg, soc)), zero
    )
    charge = torch.where(
        balance < 0.0, torch.minimum(-energy, available_space(cfg, soc)), zero
    )
    eta = sqrt(cfg.efficiency)
    new_soc = (
        soc
        + eta * charge * recip(cfg.capacity)
        - discharge * recip(eta * cfg.capacity)
    )
    new_balance = balance - discharge * recip(dt) + charge * recip(dt)
    return new_soc, new_balance
