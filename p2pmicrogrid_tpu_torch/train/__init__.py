"""Policy adapters, the single community's training loops, checkpoints.

The JAX package's names for what is ported; ``checkpoint.py``,
``faults.py``, ``resilience.py``, ``health.py``, ``recurrent.py`` and
``continual.py`` are imported by module (``placement.py`` is not ported,
ROADMAP.md, Queue 1, item 8).
"""

from p2pmicrogrid_tpu_torch.train.checkpoint import (
    checkpoint_dir,
    latest_checkpoint,
    restore_checkpoint,
    restore_raw,
    restore_resume_state,
    save_checkpoint,
    verify_checkpoint,
)
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
    "checkpoint_dir",
    "evaluate_community",
    "init_dqn_buffers",
    "init_policy_state",
    "latest_checkpoint",
    "make_ddpg_policy",
    "make_dqn_policy",
    "make_policy",
    "make_tabular_policy",
    "restore_checkpoint",
    "restore_raw",
    "restore_resume_state",
    "save_checkpoint",
    "train_block",
    "train_community",
    "verify_checkpoint",
]
