"""The community simulator."""

from p2pmicrogrid_tpu_torch.envs.community import (
    AgentRatings,
    EpisodeArrays,
    PhysState,
    Policy,
    SlotOutputs,
    SlotTransition,
    init_physical,
    make_ratings,
    resolve_use_fused,
    slot_dynamics_batched,
)

__all__ = [
    "AgentRatings",
    "EpisodeArrays",
    "PhysState",
    "Policy",
    "SlotOutputs",
    "SlotTransition",
    "init_physical",
    "make_ratings",
    "resolve_use_fused",
    "slot_dynamics_batched",
]
