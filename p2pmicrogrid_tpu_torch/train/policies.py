"""Adapters from the models layer to the env's ``Policy`` interface.

A policy is three closures over the experiment config, selected by
``TrainConfig.implementation`` like the reference's ``setup.implementation``
switch (community.py:241-245). Only the tabular learner is ported; DQN and
DDPG are queued in ROADMAP.md (Queue 1, item 5).
"""

from __future__ import annotations

import torch

from p2pmicrogrid_tpu_torch.config import ExperimentConfig
from p2pmicrogrid_tpu_torch.envs.community import Policy
from p2pmicrogrid_tpu_torch.models.tabular import (
    ACTION_VALUES,
    tabular_act,
    tabular_decay,
    tabular_init,
    tabular_update,
)

_NOT_PORTED = (
    "implementation {!r} is not ported to p2pmicrogrid_tpu_torch yet "
    "(ROADMAP.md, Queue 1: DQN, DDPG and replay)"
)


def make_tabular_policy(cfg: ExperimentConfig) -> Policy:
    """Tabular Q-learning (QAgent, agent.py:255-298).

    ``act(pol_state, obs [S, A, 4], prev_frac, draws, explore)`` takes the
    round's exploration draws ``(uniform [S, A], randint [S, A])`` and
    returns (hp_frac, aux, q, pol_state); ``aux`` is the action index as
    float32.
    """
    q = cfg.qlearning
    values = {}  # ACTION_VALUES as a tensor, one per device

    def act(pol_state, obs, prev_frac, draws, explore):
        uniform, rand_action = draws
        action, qv = tabular_act(q, pol_state, obs, uniform, rand_action, explore)
        if obs.device not in values:
            values[obs.device] = torch.tensor(
                ACTION_VALUES, dtype=torch.float32, device=obs.device
            )
        return values[obs.device][action], action.to(torch.float32), qv, pol_state

    def learn(pol_state, obs, aux, reward, next_obs):
        pol_state = tabular_update(
            q, pol_state, obs, aux.to(torch.int64), reward, next_obs
        )
        return pol_state, torch.zeros_like(reward)  # QAgent.train returns 0 loss

    return Policy(act=act, learn=learn, decay=lambda s: tabular_decay(q, s))


def make_policy(cfg: ExperimentConfig) -> Policy:
    """Select by ``TrainConfig.implementation`` (setup.py:36)."""
    impl = cfg.train.implementation
    if impl == "tabular":
        return make_tabular_policy(cfg)
    if impl in ("dqn", "ddpg"):
        raise NotImplementedError(_NOT_PORTED.format(impl))
    raise ValueError(
        f"unknown implementation {impl!r}; expected one of "
        "['ddpg', 'dqn', 'tabular']"
    )


def init_policy_state(cfg: ExperimentConfig, device="cuda"):
    """Fresh learner state for the configured implementation."""
    impl = cfg.train.implementation
    if impl == "tabular":
        return tabular_init(cfg.qlearning, cfg.sim.n_agents, device=device)
    if impl in ("dqn", "ddpg"):
        raise NotImplementedError(_NOT_PORTED.format(impl))
    raise ValueError(f"unknown implementation {impl!r}")
