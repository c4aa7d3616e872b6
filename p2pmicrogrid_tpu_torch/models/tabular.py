"""Batched tabular Q-learning.

One actor per agent, each owning a 20^4 x 3 Q-table (the reference's
``QActor``, microgrid/rl.py:56-132). The community's tables are one
``[A, nt, ntemp, nb, np2p, n_actions]`` float32 tensor, the JAX package's
layout; action selection gathers along the agent axis with any leading batch
(scenario) axes. Updates write the table in place.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from p2pmicrogrid_tpu_torch.config import QLearningConfig
from p2pmicrogrid_tpu_torch.device import resolve_device
from p2pmicrogrid_tpu_torch.ops.obs import discretize

# Heat-pump power fraction of each discrete action (rl.py:153).
ACTION_VALUES = (0.0, 0.5, 1.0)


class TabularState(NamedTuple):
    """Learner state for all agents.

    q_table: [A, nt, ntemp, nb, np2p, n_actions] float32
    epsilon: 0-dim float32 — shared exploration schedule (every reference
        agent decays its own epsilon identically, community.py:283-285).
    """

    q_table: torch.Tensor
    epsilon: torch.Tensor


def tabular_init(cfg: QLearningConfig, n_agents: int, device="cuda") -> TabularState:
    """Zero tables (rl.py:73-74), initial epsilon (agent.py:264)."""
    dev = resolve_device(device)
    shape = (
        n_agents,
        cfg.num_time_states,
        cfg.num_temp_states,
        cfg.num_balance_states,
        cfg.num_p2p_states,
        cfg.num_actions,
    )
    return TabularState(
        q_table=torch.zeros(shape, dtype=torch.float32, device=dev),
        epsilon=torch.tensor(cfg.epsilon, dtype=torch.float32, device=dev),
    )


def cell_index(cfg: QLearningConfig, obs: torch.Tensor) -> torch.Tensor:
    """Flat index of each agent's state cell in the table viewed as
    ``[A * nt * ntemp * nb * np2p, n_actions]``; obs is [..., A, 4]."""
    ti, tpi, bi, pi = (x.to(torch.int64) for x in discretize(cfg, obs))
    a_idx = torch.arange(obs.shape[-2], device=obs.device)
    cell = a_idx * cfg.num_time_states + ti
    cell = (cell * cfg.num_temp_states + tpi) * cfg.num_balance_states + bi
    return cell * cfg.num_p2p_states + pi


def q_rows(cfg: QLearningConfig, q_table: torch.Tensor, obs: torch.Tensor) -> torch.Tensor:
    """Each agent's Q-row for its discretized observation: [..., A, n_actions]."""
    return q_table.view(-1, cfg.num_actions)[cell_index(cfg, obs)]


def tabular_act(
    cfg: QLearningConfig,
    state: TabularState,
    obs: torch.Tensor,
    uniform: torch.Tensor,
    rand_action: torch.Tensor,
    explore: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-agent epsilon-greedy action (rl.py:100-117).

    obs: [..., A, 4]; ``uniform`` [..., A] in [0, 1) and ``rand_action``
    [..., A] in [0, n_actions) are the exploration draws (the caller owns the
    generator). Returns (action int64 [..., A], q [..., A]): q is the greedy
    Q-value, 0 for explored agents (rl.py:111).
    """
    rows = q_rows(cfg, state.q_table, obs)
    # torch.argmax returns the first of tied maxima, as jnp.argmax does.
    greedy = torch.argmax(rows, dim=-1)
    greedy_q = torch.gather(rows, -1, greedy[..., None])[..., 0]
    if not explore:
        return greedy, greedy_q
    explore_mask = uniform < state.epsilon
    action = torch.where(explore_mask, rand_action.to(greedy.dtype), greedy)
    q = torch.where(explore_mask, torch.zeros_like(greedy_q), greedy_q)
    return action, q


def tabular_update(
    cfg: QLearningConfig,
    state: TabularState,
    obs: torch.Tensor,
    action: torch.Tensor,
    reward: torch.Tensor,
    next_obs: torch.Tensor,
) -> TabularState:
    """Per-agent Bellman update (rl.py:119-129), in place.

    obs/next_obs: [A, 4]; action: [A] integer; reward: [A]. Each agent
    touches its own table, so the indices are unique.
    """
    flat = state.q_table.view(-1)
    idx = cell_index(cfg, obs) * cfg.num_actions + action.to(torch.int64)
    q_sa = flat[idx]
    q_next_max = q_rows(cfg, state.q_table, next_obs).amax(dim=-1)
    td = reward + cfg.gamma * q_next_max - q_sa
    flat.index_put_((idx,), cfg.alpha * td, accumulate=True)
    return state


def tabular_decay(cfg: QLearningConfig, state: TabularState) -> TabularState:
    """Exploration decay with floor (rl.py:131-132)."""
    return state._replace(
        epsilon=torch.clamp_min(cfg.epsilon_decay * state.epsilon, cfg.epsilon_floor)
    )
