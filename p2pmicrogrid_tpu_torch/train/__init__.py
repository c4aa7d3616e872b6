"""Policy adapters and training helpers."""

from p2pmicrogrid_tpu_torch.train.policies import (
    init_policy_state,
    make_ddpg_policy,
    make_dqn_policy,
    make_policy,
    make_tabular_policy,
)

__all__ = [
    "init_policy_state",
    "make_ddpg_policy",
    "make_dqn_policy",
    "make_policy",
    "make_tabular_policy",
]
