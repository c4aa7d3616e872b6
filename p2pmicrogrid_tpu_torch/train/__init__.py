"""Policy adapters and the single community's training loops."""

from p2pmicrogrid_tpu_torch.train.loop import (
    TrainResult,
    evaluate_community,
    init_dqn_buffers,
    train_block,
    train_community,
)
from p2pmicrogrid_tpu_torch.train.policies import (
    init_policy_state,
    make_ddpg_policy,
    make_dqn_policy,
    make_policy,
    make_tabular_policy,
)

__all__ = [
    "TrainResult",
    "evaluate_community",
    "init_dqn_buffers",
    "init_policy_state",
    "make_ddpg_policy",
    "make_dqn_policy",
    "make_policy",
    "make_tabular_policy",
    "train_block",
    "train_community",
]
