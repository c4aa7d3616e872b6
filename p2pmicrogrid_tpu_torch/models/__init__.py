"""Learners: the tabular Q-learner, DQN with its replay rings, and DDPG."""

from p2pmicrogrid_tpu_torch.models.ddpg import (
    DDPGParams,
    ddpg_decay,
    ddpg_params_init,
    ddpg_shared_act,
)
from p2pmicrogrid_tpu_torch.models.dqn import (
    DQNState,
    dqn_act,
    dqn_decay,
    dqn_init,
    dqn_initialize_target,
)
from p2pmicrogrid_tpu_torch.models.networks import Actor, Critic, QNetwork
from p2pmicrogrid_tpu_torch.models.replay import (
    LockstepReplay,
    ReplayState,
    lockstep_replay_add,
    lockstep_replay_init,
    lockstep_replay_sample,
    replay_init,
)
from p2pmicrogrid_tpu_torch.models.tabular import (
    ACTION_VALUES,
    TabularState,
    tabular_act,
    tabular_decay,
    tabular_init,
    tabular_update,
)

__all__ = [
    "ACTION_VALUES",
    "Actor",
    "Critic",
    "DDPGParams",
    "DQNState",
    "LockstepReplay",
    "QNetwork",
    "ReplayState",
    "TabularState",
    "ddpg_decay",
    "ddpg_params_init",
    "ddpg_shared_act",
    "dqn_act",
    "dqn_decay",
    "dqn_init",
    "dqn_initialize_target",
    "lockstep_replay_add",
    "lockstep_replay_init",
    "lockstep_replay_sample",
    "replay_init",
    "tabular_act",
    "tabular_decay",
    "tabular_init",
    "tabular_update",
]
