"""Adapters from the models layer to the env's ``Policy`` interface.

A policy is three closures over the experiment config, selected by
``TrainConfig.implementation`` like the reference's ``setup.implementation``
switch (community.py:241-245): tabular Q-learning, DQN and DDPG. Each
policy's ``act`` serves the scenario-batched slot (the single community runs
it as a one-scenario batch); its ``learn`` is the single-community learn
step (``envs/community.py::run_episode``). The shared trainer learns through
``parallel/scenarios.py`` instead.
"""

from __future__ import annotations

from typing import Optional

import torch

from p2pmicrogrid_tpu_torch.config import ExperimentConfig
from p2pmicrogrid_tpu_torch.envs.community import Policy
from p2pmicrogrid_tpu_torch.models.ddpg import (
    ddpg_decay,
    ddpg_init,
    ddpg_shared_act,
    ddpg_update,
)
from p2pmicrogrid_tpu_torch.models.dqn import (
    action_values_on,
    dqn_act,
    dqn_decay,
    dqn_init,
    dqn_update,
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
        uniform, rand_action = draws if explore else (None, None)
        action, qv = tabular_act(q, pol_state, obs, uniform, rand_action, explore)
        return action_values_on(obs.device)[action], action.to(torch.float32), qv, ex

    def learn(pol_state, obs, aux, reward, next_obs, idx=None):
        pol_state = tabular_update(
            q, pol_state, obs, aux.to(torch.int64), reward, next_obs
        )
        return pol_state, torch.zeros_like(reward)  # QAgent.train returns 0 loss

    return Policy(act=act, learn=learn, decay=lambda s: tabular_decay(q, s))


def make_dqn_policy(cfg: ExperimentConfig) -> Policy:
    """Per-agent DQN (DQNAgent, agent.py:301-342).

    ``act`` as the tabular policy's, over the 3 enumerated actions. ``learn``
    is the per-slot ``dqn_update`` on the agents' own rings, each sampling
    ``batch_size`` indices ``idx`` [A, B]; the shared trainer learns through
    ``parallel/scenarios.py::_dqn_update_shared``.
    """
    d = cfg.dqn

    def act(pol_state, obs, prev_frac, draws, explore, ex):
        uniform, rand_action = draws if explore else (None, None)
        action, qv = dqn_act(d, pol_state, obs, uniform, rand_action, explore)
        return action_values_on(obs.device)[action], action.to(torch.float32), qv, ex

    def learn(pol_state, obs, aux, reward, next_obs, idx):
        return dqn_update(d, pol_state, obs, aux.to(torch.int64), reward, next_obs, idx)

    return Policy(
        act=act, learn=learn, decay=lambda s: dqn_decay(d, s), replay_batch=d.batch_size
    )


def make_ddpg_policy(cfg: ExperimentConfig) -> Policy:
    """DDPG, the continuous-action actor-critic (capability of rl_backup.py).

    ``act(pol_state, obs [S, A, 4], prev_frac, draws, explore, ou [S, A])``
    takes the round's OU normals ``(normals [S, A],)``, advances the OU
    state and returns (hp_frac, hp_frac, q, ou'): the action is the heat-pump
    fraction itself; ``pol_state`` is a ``DDPGParams`` or a ``DDPGState``.
    ``learn`` is the per-agent ``ddpg_update`` on a ``DDPGState``'s rings,
    each agent sampling ``batch_size`` indices ``idx`` [A, B]; the shared
    trainer learns through ``parallel/scenarios.py::_ddpg_update_shared``.
    """
    d = cfg.ddpg

    def act(pol_state, obs, prev_frac, draws, explore, ou):
        (normals,) = draws if explore else (None,)
        frac, qv, ou = ddpg_shared_act(d, pol_state, obs, ou, normals, explore)
        return frac, frac, qv, ou

    def learn(pol_state, obs, aux, reward, next_obs, idx):
        return ddpg_update(d, pol_state, obs, aux, reward, next_obs, idx)

    return Policy(
        act=act, learn=learn, decay=lambda s: ddpg_decay(d, s), replay_batch=d.batch_size
    )


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
    cfg: ExperimentConfig,
    device="cuda",
    generator: Optional[torch.Generator] = None,
):
    """Fresh learner state for the configured implementation: a
    ``TabularState``, a ``DQNState``, or for DDPG the single community's
    ``DDPGState`` (per-agent networks, rings and OU noise; the shared
    trainer's ``DDPGParams`` come from ``parallel/scenarios.py::
    init_shared_pol_state``). The networks (then DDPG's OU noise) draw from
    ``generator``."""
    impl = cfg.train.implementation
    if impl == "tabular":
        return tabular_init(cfg.qlearning, cfg.sim.n_agents, device=device)
    if impl == "dqn":
        return dqn_init(cfg.dqn, cfg.sim.n_agents, generator, device=device)
    if impl == "ddpg":
        return ddpg_init(cfg.ddpg, cfg.sim.n_agents, generator, device=device)
    raise ValueError(f"unknown implementation {impl!r}")
