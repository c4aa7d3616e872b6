"""Adapters from the models layer to the env's ``Policy`` interface.

A policy is three closures over the experiment config, selected by
``TrainConfig.implementation`` like the reference's ``setup.implementation``
switch (community.py:241-245): tabular Q-learning, DQN and DDPG. Each
policy's ``act`` serves the scenario-batched slot. DQN's and DDPG's
single-scenario ``learn`` steps wait for the single-scenario simulator
(ROADMAP.md, Queue 1, item 4); the shared trainer learns through
``parallel/scenarios.py``.
"""

from __future__ import annotations

from typing import Optional

import torch

from p2pmicrogrid_tpu_torch.config import ExperimentConfig
from p2pmicrogrid_tpu_torch.envs.community import Policy
from p2pmicrogrid_tpu_torch.models.ddpg import (
    ddpg_decay,
    ddpg_params_init,
    ddpg_shared_act,
)
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

def make_tabular_policy(cfg: ExperimentConfig) -> Policy:
    """Tabular Q-learning (QAgent, agent.py:255-298).

    ``act(pol_state, obs [S, A, 4], prev_frac, draws, explore, ex)`` takes
    the round's exploration draws ``(uniform [S, A], randint [S, A])`` and
    returns (hp_frac, aux, q, ex); ``aux`` is the action index as float32.
    """
    q = cfg.qlearning

    def act(pol_state, obs, prev_frac, draws, explore, ex):
        uniform, rand_action = draws
        action, qv = tabular_act(q, pol_state, obs, uniform, rand_action, explore)
        return action_values_on(obs.device)[action], action.to(torch.float32), qv, ex

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

    def act(pol_state, obs, prev_frac, draws, explore, ex):
        uniform, rand_action = draws
        action, qv = dqn_act(d, pol_state, obs, uniform, rand_action, explore)
        return action_values_on(obs.device)[action], action.to(torch.float32), qv, ex

    def learn(pol_state, obs, aux, reward, next_obs):
        raise NotImplementedError(
            "the single-scenario dqn_update is not ported yet (ROADMAP.md, "
            "Queue 1: the single-scenario simulator); shared-scenario training "
            "learns through parallel/scenarios.py"
        )

    return Policy(act=act, learn=learn, decay=lambda s: dqn_decay(d, s))


def make_ddpg_policy(cfg: ExperimentConfig) -> Policy:
    """DDPG, the continuous-action actor-critic (capability of rl_backup.py).

    ``act(pol_state, obs [S, A, 4], prev_frac, draws, explore, ou [S, A])``
    takes the round's OU normals ``(normals [S, A],)``, advances the OU
    state and returns (hp_frac, hp_frac, q, ou'): the action is the heat-pump
    fraction itself. The single-scenario ``ddpg_update`` is not ported yet
    (ROADMAP.md, Queue 1, item 4: the single-scenario simulator); the shared
    trainer learns through ``parallel/scenarios.py::_ddpg_update_shared``.
    """
    d = cfg.ddpg

    def act(pol_state, obs, prev_frac, draws, explore, ou):
        (normals,) = draws
        frac, qv, ou = ddpg_shared_act(d, pol_state, obs, ou, normals, explore)
        return frac, frac, qv, ou

    def learn(pol_state, obs, aux, reward, next_obs):
        raise NotImplementedError(
            "the single-scenario ddpg_update is not ported yet (ROADMAP.md, "
            "Queue 1, item 4: the single-scenario simulator); shared-scenario "
            "training learns through parallel/scenarios.py"
        )

    return Policy(act=act, learn=learn, decay=lambda s: ddpg_decay(d, s))


def make_policy(cfg: ExperimentConfig) -> Policy:
    """Select by ``TrainConfig.implementation`` (setup.py:36)."""
    impl = cfg.train.implementation
    if impl == "tabular":
        return make_tabular_policy(cfg)
    if impl == "dqn":
        return make_dqn_policy(cfg)
    if impl == "ddpg":
        return make_ddpg_policy(cfg)
    raise ValueError(
        f"unknown implementation {impl!r}; expected one of "
        "['ddpg', 'dqn', 'tabular']"
    )


def init_policy_state(
    cfg: ExperimentConfig, device="cuda", generator: Optional[torch.Generator] = None
):
    """Fresh learner state for the configured implementation, as the shared
    trainer carries it (a ``TabularState``, a ``DQNState``, or DDPG's
    ``DDPGParams``; the single-scenario ``DDPGState`` waits for ROADMAP.md
    Queue 1, item 4); the networks draw their initial weights from
    ``generator``."""
    impl = cfg.train.implementation
    if impl == "tabular":
        return tabular_init(cfg.qlearning, cfg.sim.n_agents, device=device)
    if impl == "dqn":
        return dqn_init(cfg.dqn, cfg.sim.n_agents, generator, device=device)
    if impl == "ddpg":
        return ddpg_params_init(cfg.ddpg, cfg.sim.n_agents, generator, device=device)
    raise ValueError(f"unknown implementation {impl!r}")
