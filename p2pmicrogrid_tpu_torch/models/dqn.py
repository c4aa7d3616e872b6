"""Batched per-agent DQN.

The port of the JAX package's ``models/dqn.py`` (the reference's
``ActorModel`` + ``Trainer``, rl.py:151-359): each agent owns a 64-64-1
state-action Q-network (``models/networks.py::QNetwork``, parameters stacked
on a leading ``[A]`` axis), a target copy, Adam moments and a replay ring.

Adam is element-wise, so one ``torch.optim.Adam`` over the stacked
parameters is optax's Adam vmapped over agents; and since agent a's loss
depends on agent a's parameters alone, summing the per-agent mean losses
before ``backward()`` gives each agent exactly its own gradient. Every
forward and the learn step run in full float32 (``QNetwork`` refuses TF32 on
the card).

Exploration starts at epsilon = 1.0: the reference instantiates
``ActorModel(1)`` (agent.py:304), overriding the class default of 0.1.
``dqn_update`` is the single community's per-slot learn step on the agents'
own rings; the shared trainer's lives in ``parallel/scenarios.py``.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from p2pmicrogrid_tpu_torch.config import DQNConfig
from p2pmicrogrid_tpu_torch.device import resolve_device
from p2pmicrogrid_tpu_torch.models.networks import QNetwork, adam
from p2pmicrogrid_tpu_torch.models.replay import (
    ReplayState,
    replay_add,
    replay_init,
    replay_sample,
)

ACTION_VALUES = (0.0, 0.5, 1.0)  # rl.py:153
OBS_DIM = 4


class DQNState(NamedTuple):
    """Learner state for all agents.

    online, target: ``QNetwork`` with ``[A, ...]`` parameters.
    opt_state: ``torch.optim.Adam`` over ``online``'s parameters (optax's
        ``ScaleByAdamState`` moments and step count live in its state).
    replay: ``ReplayState`` (per-agent rings).
    epsilon: 0-dim float32, shared as in the reference's identical
        per-agent schedules.
    """

    online: QNetwork
    target: QNetwork
    opt_state: torch.optim.Adam
    replay: ReplayState
    epsilon: torch.Tensor


def make_optimizer(cfg: DQNConfig, online: QNetwork) -> torch.optim.Adam:
    """optax.adam(learning_rate), capturable on the card
    (``models/networks.py::adam``)."""
    return adam(online, cfg.learning_rate)


def dqn_init(
    cfg: DQNConfig,
    n_agents: int,
    generator: Optional[torch.Generator] = None,
    device="cuda",
) -> DQNState:
    """Independent per-agent online and target networks (flax's default
    init, drawn from ``generator``), fresh Adam, empty replay."""
    dev = resolve_device(device)
    online = QNetwork(n_agents, cfg.hidden, OBS_DIM, device=dev)
    target = QNetwork(n_agents, cfg.hidden, OBS_DIM, device=dev)
    online.reset_parameters(generator)
    target.reset_parameters(generator)
    target.requires_grad_(False)
    return DQNState(
        online=online,
        target=target,
        opt_state=make_optimizer(cfg, online),
        replay=replay_init(n_agents, cfg.buffer_size, OBS_DIM, 1, device=dev),
        epsilon=torch.tensor(cfg.epsilon, dtype=torch.float32, device=dev),
    )


def _q_agent_major(
    action_values: torch.Tensor, params: QNetwork, x: torch.Tensor
) -> torch.Tensor:
    """x [A, N, 4] -> Q [A, N, n_values] of each enumerated action."""
    a, rows, d = x.shape
    n = action_values.shape[0]
    state = x[:, :, None, :].expand(a, rows, n, d).reshape(a, rows * n, d)
    act = action_values.expand(a, rows, n).reshape(a, rows * n, 1)
    return params(state, act).reshape(a, rows, n)


def _q_all_actions_for(
    action_values: torch.Tensor, cfg: DQNConfig, params: QNetwork, obs: torch.Tensor
) -> torch.Tensor:
    """Q-values of each enumerated action for each agent.

    obs [..., A, 4] (any leading batch axes) -> [..., A, n_values]; row a
    uses agent a's network. ``action_values`` [n_values] float32.
    """
    *batch, a, d = obs.shape
    q = _q_agent_major(action_values, params, obs.reshape(-1, a, d).transpose(0, 1))
    return q.transpose(0, 1).reshape(*batch, a, action_values.shape[0])


@functools.lru_cache(maxsize=None)
def action_values_on(device: torch.device) -> torch.Tensor:
    """``ACTION_VALUES`` on ``device``, copied there once (a copy from the
    host waits for the device); callers never write to it."""
    return torch.tensor(ACTION_VALUES, dtype=torch.float32, device=device)


def _q_all_actions(cfg: DQNConfig, params: QNetwork, obs: torch.Tensor) -> torch.Tensor:
    """Q-values of the 3 discrete actions (the action-enumeration argmax of
    rl.py:186-194): obs [..., A, 4] -> [..., A, 3]."""
    return _q_all_actions_for(action_values_on(obs.device), cfg, params, obs)


@torch.no_grad()
def dqn_act(
    cfg: DQNConfig,
    state: DQNState,
    obs: torch.Tensor,
    uniform: torch.Tensor,
    rand_action: torch.Tensor,
    explore: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-agent epsilon-greedy over the 3 enumerated actions (rl.py:173-194).

    obs [..., A, 4]; ``uniform`` [..., A] in [0, 1) and ``rand_action``
    [..., A] in [0, 3) are the exploration draws (the JAX package's
    ``k_mask``/``k_rand`` draws). Returns (action int64 [..., A], q [..., A]):
    q is the greedy Q-value, 0 on explored slots (rl.py:184).
    """
    q = _q_all_actions(cfg, state.online, obs)
    # torch.argmax returns the first of tied maxima, as jnp.argmax does.
    greedy = torch.argmax(q, dim=-1)
    greedy_q = torch.gather(q, -1, greedy[..., None])[..., 0]
    if not explore:
        return greedy, greedy_q
    explore_mask = uniform < state.epsilon
    action = torch.where(explore_mask, rand_action.to(greedy.dtype), greedy)
    q_out = torch.where(explore_mask, torch.zeros_like(greedy_q), greedy_q)
    return action, q_out


def _td_loss(
    cfg: DQNConfig,
    online: QNetwork,
    target: QNetwork,
    s: torch.Tensor,
    a: torch.Tensor,
    r: torch.Tensor,
    ns: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """TD(0) loss against the target net's action-enumerated max
    (rl.py:308-326), no terminal masking. Per-agent batches: s/ns [A, N, 4],
    a [A, N, 1], r [A, N].

    Returns (per-agent mean loss [A], per-sample squared residuals [A, N]).
    """
    with torch.no_grad():
        q_max = _q_agent_major(action_values_on(ns.device), target, ns).amax(dim=-1)
        q_target = r + cfg.gamma * q_max
    q_value = online(s, a)[..., 0]
    sq = torch.square(q_target - q_value)
    return sq.mean(dim=-1), sq.detach()


def _clip_first_layer(cfg: DQNConfig, online: QNetwork) -> None:
    """Clip only the first layer's kernel gradient to [-c, c] (``dl_dw[0]``,
    rl.py:328-329), in place."""
    c = cfg.grad_clip_first_layer
    online.Dense_0.kernel.grad.clamp_(-c, c)


def apply_td_update(
    cfg: DQNConfig,
    loss_fn: Callable[[], Tuple[torch.Tensor, torch.Tensor]],
    online: QNetwork,
    target: QNetwork,
    opt: torch.optim.Adam,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One gradient step and Polyak target update for every agent, in place:
    first-layer kernel clip (rl.py:328-329), Adam, soft update
    ``target = (1 - tau) * target + tau * online`` (rl.py:335-359).

    ``loss_fn() -> (per-agent loss [A], per-sample aux)``; returns both.
    """
    opt.zero_grad(set_to_none=True)
    loss, aux = loss_fn()
    loss.sum().backward()
    _clip_first_layer(cfg, online)
    opt.step()
    with torch.no_grad():
        for t, o in zip(target.parameters(), online.parameters()):
            t.mul_(1.0 - cfg.tau).add_(o * cfg.tau)
    return loss.detach(), aux


def dqn_update(
    cfg: DQNConfig,
    state: DQNState,
    obs: torch.Tensor,
    action: torch.Tensor,
    reward: torch.Tensor,
    next_obs: torch.Tensor,
    idx: torch.Tensor,
) -> Tuple[DQNState, torch.Tensor]:
    """One per-slot learn step for every agent (agent.py:338-342 ->
    rl.py:299-333): add the transition to each agent's ring (the action as
    its heat-pump fraction), sample each agent's batch at ``idx`` [A, B],
    and take one ``apply_td_update`` over the ``[A, ...]`` stacks (clip,
    Adam, Polyak), in place.

    obs/next_obs: [A, 4]; action: [A] integer index; reward: [A].
    Returns (state, loss [A]): each agent's mean squared TD residual.
    """
    act_frac = action_values_on(obs.device)[action.to(torch.int64)][:, None]
    replay = replay_add(state.replay, obs, act_frac, reward, next_obs)
    s, a, r, ns = replay_sample(replay, idx)
    loss, _ = apply_td_update(
        cfg,
        lambda: _td_loss(cfg, state.online, state.target, s, a, r, ns),
        state.online,
        state.target,
        state.opt_state,
    )
    return state._replace(replay=replay), loss


def dqn_initialize_target(state: DQNState) -> DQNState:
    """Hard copy online -> target after buffer warmup (rl.py:272-276,
    community.py:146-147), in place."""
    with torch.no_grad():
        for t, o in zip(state.target.parameters(), state.online.parameters()):
            t.copy_(o)
    return state


def dqn_decay(cfg: DQNConfig, state: DQNState) -> DQNState:
    """Exploration decay, no floor (rl.py:196-197)."""
    return state._replace(epsilon=cfg.epsilon_decay * state.epsilon)
