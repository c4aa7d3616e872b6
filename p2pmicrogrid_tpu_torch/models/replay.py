"""Fixed-size replay rings for the DQN and DDPG learners.

The port of the JAX package's ``models/replay.py``: ring buffers of fixed
size with a write cursor shared by every agent (all agents write in
lockstep), in place of the reference's ``collections.deque``
(rl.py:200-248). The cursor and the fill count are Python integers: they
advance by one per slot whatever the data, so the host knows them without
reading the device.

* ``ReplayState``/``replay_init``/``replay_add``/``replay_sample``: the
  per-agent ``[A, cap, ...]`` rings of the single community's learners
  (``DQNState``, ``DDPGState``). Each agent samples its own B indices,
  uniform over the filled region with replacement (``sample_indices``, or
  injected).
* ``LockstepReplay``: the time-major ``[cap, S, A, ...]`` rings of the
  scenario-batched shared trainer. One transition per slot is one contiguous
  slab write at the cursor; a sample of B shared indices gathers B
  contiguous ``[S, A, ...]`` slabs. The B indices are uniform over the filled
  region, with replacement, drawn from a ``torch.Generator`` or injected.
  One index set per learn step is shared by every (scenario, agent) pair,
  as in the JAX package (its docstring gives the reasons).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from p2pmicrogrid_tpu_torch.device import resolve_device


class ReplayState(NamedTuple):
    """Ring buffers for all agents.

    obs:      [A, cap, obs_dim]
    action:   [A, cap, act_dim]
    reward:   [A, cap]
    next_obs: [A, cap, obs_dim]
    cursor:   int — next write slot (shared: all agents write in lockstep)
    count:    int — number of valid entries, <= cap
    """

    obs: torch.Tensor
    action: torch.Tensor
    reward: torch.Tensor
    next_obs: torch.Tensor
    cursor: int
    count: int

    @property
    def capacity(self) -> int:
        return self.obs.shape[1]


def replay_init(
    n_agents: int, capacity: int, obs_dim: int = 4, act_dim: int = 1, device="cuda"
) -> ReplayState:
    dev = resolve_device(device)
    z = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=dev)
    return ReplayState(
        obs=z(n_agents, capacity, obs_dim),
        action=z(n_agents, capacity, act_dim),
        reward=z(n_agents, capacity),
        next_obs=z(n_agents, capacity, obs_dim),
        cursor=0,
        count=0,
    )


def replay_add(
    state: ReplayState,
    obs: torch.Tensor,
    action: torch.Tensor,
    reward: torch.Tensor,
    next_obs: torch.Tensor,
) -> ReplayState:
    """Write one transition per agent at the shared cursor, in place
    (rl.py:209-213).

    obs/next_obs: [A, obs_dim]; action: [A, act_dim]; reward: [A]. Returns
    the state with the cursor and count advanced.
    """
    c = state.cursor
    state.obs[:, c] = obs
    state.action[:, c] = action
    state.reward[:, c] = reward
    state.next_obs[:, c] = next_obs
    cap = state.capacity
    return state._replace(cursor=(c + 1) % cap, count=min(state.count + 1, cap))


def sample_indices(
    count: int, n_agents: int, batch_size: int, generator: Optional[torch.Generator], device
) -> torch.Tensor:
    """Each agent's B uniform indices in ``[0, max(count, 1))``, int64
    [A, B] on ``device`` (``jax.random.randint(key, (A, B), 0, max(count,
    1))``); ``count`` is the ring's fill count when it is sampled."""
    return torch.randint(
        0, max(count, 1), (n_agents, batch_size), generator=generator, device=device
    )


def replay_sample(
    state: ReplayState, idx: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Agent a's entries at ``idx[a]`` (``idx`` [A, B] integer, on the
    buffers' device), from its own ring (rl.py:225-244).

    Returns (obs [A,B,obs_dim], action [A,B,act_dim], reward [A,B],
    next_obs [A,B,obs_dim]).
    """
    idx = idx.to(device=state.obs.device, dtype=torch.int64)
    agent = torch.arange(idx.shape[0], device=idx.device)[:, None]
    take = lambda buf: buf[agent, idx]
    return take(state.obs), take(state.action), take(state.reward), take(state.next_obs)


class LockstepReplay(NamedTuple):
    """Time-major ring buffers for the scenario-batched shared trainer.

    obs:      [cap, S, A, obs_dim]
    action:   [cap, S, A, act_dim]
    reward:   [cap, S, A]
    next_obs: [cap, S, A, obs_dim]
    cursor/count: int
    """

    obs: torch.Tensor
    action: torch.Tensor
    reward: torch.Tensor
    next_obs: torch.Tensor
    cursor: int
    count: int

    @property
    def capacity(self) -> int:
        return self.obs.shape[0]


def lockstep_replay_init(
    n_scenarios: int,
    n_agents: int,
    capacity: int,
    obs_dim: int = 4,
    act_dim: int = 1,
    device="cuda",
) -> LockstepReplay:
    dev = resolve_device(device)
    z = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=dev)
    return LockstepReplay(
        obs=z(capacity, n_scenarios, n_agents, obs_dim),
        action=z(capacity, n_scenarios, n_agents, act_dim),
        reward=z(capacity, n_scenarios, n_agents),
        next_obs=z(capacity, n_scenarios, n_agents, obs_dim),
        cursor=0,
        count=0,
    )


def lockstep_replay_add(
    state: LockstepReplay,
    obs: torch.Tensor,
    action: torch.Tensor,
    reward: torch.Tensor,
    next_obs: torch.Tensor,
) -> LockstepReplay:
    """One slab write at the shared cursor, in place.

    obs/next_obs: [S, A, obs_dim]; action: [S, A, act_dim]; reward: [S, A].
    Returns the state with the cursor and count advanced.
    """
    c = state.cursor
    state.obs[c] = obs
    state.action[c] = action
    state.reward[c] = reward
    state.next_obs[c] = next_obs
    cap = state.capacity
    return state._replace(cursor=(c + 1) % cap, count=min(state.count + 1, cap))


def lockstep_sample_indices(
    count: int, batch_size: int, generator: Optional[torch.Generator], device
) -> torch.Tensor:
    """B uniform indices in ``[0, max(count, 1))``, int64 on ``device``
    (``jax.random.randint(key, (B,), 0, max(count, 1))``); ``count`` is the
    ring's fill count when it is sampled."""
    return torch.randint(
        0, max(count, 1), (batch_size,), generator=generator, device=device
    )


def lockstep_replay_sample(
    state: LockstepReplay, idx: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The B slabs at ``idx`` [B] (integer, on the buffers' device).

    Returns (obs [B,S,A,obs_dim], action [B,S,A,act_dim], reward [B,S,A],
    next_obs [B,S,A,obs_dim]).
    """
    idx = idx.to(device=state.obs.device, dtype=torch.int64)
    take = lambda buf: buf.index_select(0, idx)
    return take(state.obs), take(state.action), take(state.reward), take(state.next_obs)
