"""2R2C thermal building model — pure Euler step.

Reference: microgrid/heating.py:37-56 (``temperature_simulation``) and
heating.py:90-124 (comfort band, normalized temperature, HP power scaling).
The heat pump's electrical power is ``frac * hp_max_power`` and injects
``power * cop`` watts of heat, split ``(1 - f_rad)`` into indoor air and
``f_rad`` into the building mass.
"""

from __future__ import annotations

from typing import Tuple

import torch

from p2pmicrogrid_tpu_torch.config import ThermalConfig
from p2pmicrogrid_tpu_torch.ops._f32 import recip


def thermal_step(
    cfg: ThermalConfig,
    dt: float,
    t_out: torch.Tensor,
    t_in: torch.Tensor,
    t_bm: torch.Tensor,
    hp_power: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One Euler step of the 2R2C model (heating.py:37-56), without solar
    gain (the reference always passes 0, heating.py:129-130).

    Returns (t_in_new, t_bm_new) in °C; ``hp_power`` is electrical W.
    """
    heat = hp_power * cfg.cop

    d_tin = (1.0 / cfg.ci) * (
        (t_bm - t_in) * recip(cfg.ri)
        + (t_out - t_in) * recip(cfg.rvent)
        + (1.0 - cfg.f_rad) * heat
    )
    d_tbm = (1.0 / cfg.cm) * (
        (t_in - t_bm) * recip(cfg.ri)
        + (t_out - t_bm) * recip(cfg.re)
        + cfg.f_rad * heat
    )
    return t_in + d_tin * dt, t_bm + d_tbm * dt


def normalized_temperature(cfg: ThermalConfig, t_in: torch.Tensor) -> torch.Tensor:
    """(t_in - setpoint) / margin, the policy observation (heating.py:119-120)."""
    return (t_in - cfg.setpoint) * recip(cfg.margin)


def comfort_penalty(cfg: ThermalConfig, t_in: torch.Tensor) -> torch.Tensor:
    """Comfort-band violation with the reference's +1 offset (agent.py:225-232):
    zero inside [setpoint - margin, setpoint + margin], else the excess in °C
    plus 1."""
    excess = torch.maximum(
        torch.clamp_min(cfg.lower_bound - t_in, 0.0),
        torch.clamp_min(t_in - cfg.upper_bound, 0.0),
    )
    return torch.where(excess > 0.0, excess + 1.0, torch.zeros_like(excess))
