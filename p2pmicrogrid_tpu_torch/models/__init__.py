"""Learners. Only the tabular Q-learner is ported so far."""

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
    "TabularState",
    "tabular_act",
    "tabular_decay",
    "tabular_init",
    "tabular_update",
]
