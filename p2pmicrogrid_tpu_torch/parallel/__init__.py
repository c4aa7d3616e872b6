"""Scenario-batched training: shared, independent and chunked
(``scenarios.py``), the
on-device scenario generator (``device_gen.py``) and the chunk episode as a
CUDA graph (``graph.py``)."""

from p2pmicrogrid_tpu_torch.parallel.device_gen import (
    TraceDraws,
    device_episode_arrays,
    device_scenario_traces,
    draw_traces,
)
from p2pmicrogrid_tpu_torch.parallel.scenarios import (
    ChunkDraws,
    DDPGScenState,
    EpisodeDraws,
    auto_scale_ddpg_lrs,
    chunk_seed_schedule,
    ddpg_pooled_batch,
    init_independent_state,
    init_scen_state_only,
    init_shared_pol_state,
    init_shared_state,
    learner_leaves,
    make_chunked_episode_runner,
    make_device_episode_fn,
    make_independent_episode_fn,
    make_scenario_traces,
    make_shared_episode_fn,
    scenario_learners,
    stack_scenario_arrays,
    train_scenarios_chunked,
    train_scenarios_independent,
    train_scenarios_shared,
    warmup_shared_dqn,
)

__all__ = [
    "ChunkDraws",
    "DDPGScenState",
    "EpisodeDraws",
    "TraceDraws",
    "auto_scale_ddpg_lrs",
    "chunk_seed_schedule",
    "ddpg_pooled_batch",
    "device_episode_arrays",
    "device_scenario_traces",
    "draw_traces",
    "init_independent_state",
    "init_scen_state_only",
    "init_shared_pol_state",
    "init_shared_state",
    "learner_leaves",
    "make_chunked_episode_runner",
    "make_device_episode_fn",
    "make_independent_episode_fn",
    "make_scenario_traces",
    "make_shared_episode_fn",
    "scenario_learners",
    "stack_scenario_arrays",
    "train_scenarios_chunked",
    "train_scenarios_independent",
    "train_scenarios_shared",
    "warmup_shared_dqn",
]
