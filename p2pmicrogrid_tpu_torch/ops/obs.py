"""Observation assembly and tabular state discretization.

Reference: microgrid/agent.py:178-184 (``_get_observation_state``) — the policy
observation is ``[time, normalized_temperature, balance, mean_p2p]`` — and
rl.py:89-95 (``QActor._get_state_indices``) for the 20^4 discretizer.
"""

from __future__ import annotations

from typing import Tuple

import torch

from p2pmicrogrid_tpu_torch.config import QLearningConfig

OBS_DIM = 4


def make_observation(
    time_norm: torch.Tensor,
    norm_temp: torch.Tensor,
    balance: torch.Tensor,
    p2p_mean: torch.Tensor,
) -> torch.Tensor:
    """Stack the 4 features on a trailing axis (agent.py:178-184).
    All inputs broadcast; result is [..., 4]."""
    return torch.stack(
        torch.broadcast_tensors(time_norm, norm_temp, balance, p2p_mean), dim=-1
    )


def _bin(x: torch.Tensor, hi: int) -> torch.Tensor:
    # float -> int32 truncates toward zero, as Python int() in the reference
    # and astype(int32) in the JAX package.
    return torch.clamp(x.to(torch.int32), 0, hi)


def discretize_features(
    cfg: QLearningConfig,
    time_norm: torch.Tensor,
    norm_temp: torch.Tensor,
    balance: torch.Tensor,
    p2p_mean: torch.Tensor,
) -> Tuple[torch.Tensor, ...]:
    """``discretize`` on the four unstacked feature tensors (int32 bins)."""
    nt, ntp, nb, np_ = (
        cfg.num_time_states,
        cfg.num_temp_states,
        cfg.num_balance_states,
        cfg.num_p2p_states,
    )
    time_i = _bin(time_norm * nt, nt - 1)
    temp_i = _bin((norm_temp + 1.0) * 0.5 * (ntp - 2) + 1.0, ntp - 1)
    bal_i = _bin((balance + 1.0) * 0.5 * nb, nb - 1)
    p2p_i = _bin((p2p_mean + 1.0) * 0.5 * np_, np_ - 1)
    return time_i, temp_i, bal_i, p2p_i


def discretize(cfg: QLearningConfig, obs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Map a [..., 4] observation to Q-table indices (rl.py:89-95)."""
    return discretize_features(
        cfg, obs[..., 0], obs[..., 1], obs[..., 2], obs[..., 3]
    )
