"""Adapters from the models layer to the env's ``Policy`` interface.

A policy is three closures over the experiment config, selected by
``TrainConfig.implementation`` like the reference's ``setup.implementation``
switch (community.py:241-245). The tabular and DQN learners are ported;
DDPG is queued in ROADMAP.md (Queue 1: DDPG).
"""

from __future__ import annotations

from typing import Optional

import torch

from p2pmicrogrid_tpu_torch.config import ExperimentConfig
from p2pmicrogrid_tpu_torch.envs.community import Policy
from p2pmicrogrid_tpu_torch.models.dqn import (
    action_values_on,
    dqn_act,
    dqn_decay,
    dqn_init,
)
from p2pmicrogrid_tpu_torch.models.tabular import (
    tabular_act,
    tabular_decay,
    tabular_init,
    tabular_update,
)

_NOT_PORTED = (
    "implementation {!r} is not ported to p2pmicrogrid_tpu_torch yet "
    "(ROADMAP.md, Queue 1: DDPG)"
)


def make_tabular_policy(cfg: ExperimentConfig) -> Policy:
    """Tabular Q-learning (QAgent, agent.py:255-298).

    ``act(pol_state, obs [S, A, 4], prev_frac, draws, explore)`` takes the
    round's exploration draws ``(uniform [S, A], randint [S, A])`` and
    returns (hp_frac, aux, q, pol_state); ``aux`` is the action index as
    float32.
    """
    q = cfg.qlearning

    def act(pol_state, obs, prev_frac, draws, explore):
        uniform, rand_action = draws
        action, qv = tabular_act(q, pol_state, obs, uniform, rand_action, explore)
        return action_values_on(obs.device)[action], action.to(torch.float32), qv, pol_state

    def learn(pol_state, obs, aux, reward, next_obs):
        pol_state = tabular_update(
            q, pol_state, obs, aux.to(torch.int64), reward, next_obs
        )
        return pol_state, torch.zeros_like(reward)  # QAgent.train returns 0 loss

    return Policy(act=act, learn=learn, decay=lambda s: tabular_decay(q, s))


def make_dqn_policy(cfg: ExperimentConfig) -> Policy:
    """Per-agent DQN (DQNAgent, agent.py:301-342).

    ``act`` as the tabular policy's, over the 3 enumerated actions. The
    per-slot single-scenario learn step (``dqn_update``) is not ported yet
    (ROADMAP.md, Queue 1: the single-scenario simulator); the shared trainer
    learns through ``parallel/scenarios.py::_dqn_update_shared``.
    """
    d = cfg.dqn

    def act(pol_state, obs, prev_frac, draws, explore):
        uniform, rand_action = draws
        action, qv = dqn_act(d, pol_state, obs, uniform, rand_action, explore)
        return action_values_on(obs.device)[action], action.to(torch.float32), qv, pol_state

    def learn(pol_state, obs, aux, reward, next_obs):
        raise NotImplementedError(
            "the single-scenario dqn_update is not ported yet (ROADMAP.md, "
            "Queue 1: the single-scenario simulator); shared-scenario training "
            "learns through parallel/scenarios.py"
        )

    return Policy(act=act, learn=learn, decay=lambda s: dqn_decay(d, s))


def make_policy(cfg: ExperimentConfig) -> Policy:
    """Select by ``TrainConfig.implementation`` (setup.py:36)."""
    impl = cfg.train.implementation
    if impl == "tabular":
        return make_tabular_policy(cfg)
    if impl == "dqn":
        return make_dqn_policy(cfg)
    if impl == "ddpg":
        raise NotImplementedError(_NOT_PORTED.format(impl))
    raise ValueError(
        f"unknown implementation {impl!r}; expected one of "
        "['ddpg', 'dqn', 'tabular']"
    )


def init_policy_state(
    cfg: ExperimentConfig, device="cuda", generator: Optional[torch.Generator] = None
):
    """Fresh learner state for the configured implementation; the DQN
    networks draw their initial weights from ``generator``."""
    impl = cfg.train.implementation
    if impl == "tabular":
        return tabular_init(cfg.qlearning, cfg.sim.n_agents, device=device)
    if impl == "dqn":
        return dqn_init(cfg.dqn, cfg.sim.n_agents, generator, device=device)
    if impl == "ddpg":
        raise NotImplementedError(_NOT_PORTED.format(impl))
    raise ValueError(f"unknown implementation {impl!r}")
