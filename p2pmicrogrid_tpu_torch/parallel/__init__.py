"""Scenario-batched training."""

from p2pmicrogrid_tpu_torch.parallel.scenarios import (
    DDPGScenState,
    EpisodeDraws,
    auto_scale_ddpg_lrs,
    ddpg_pooled_batch,
    init_scen_state_only,
    init_shared_pol_state,
    init_shared_state,
    make_scenario_traces,
    make_shared_episode_fn,
    stack_scenario_arrays,
    train_scenarios_shared,
    warmup_shared_dqn,
)

__all__ = [
    "DDPGScenState",
    "EpisodeDraws",
    "auto_scale_ddpg_lrs",
    "ddpg_pooled_batch",
    "init_scen_state_only",
    "init_shared_pol_state",
    "init_shared_state",
    "make_scenario_traces",
    "make_shared_episode_fn",
    "stack_scenario_arrays",
    "train_scenarios_shared",
    "warmup_shared_dqn",
]
