"""DDPG: a continuous-action actor-critic with Ornstein-Uhlenbeck
exploration.

The port of the JAX package's ``models/ddpg.py`` (the reference carries the
capability as rl_backup.py: actor with a sigmoid head, critic, OU noise,
rl_backup.py:14-85): feed-forward actor and critic over the 4-feature
observation (``models/networks.py``), Polyak targets, one Adam per network.
The learn step updates the networks, the targets and Adam in place.

* The shared-scenario trainer carries ``DDPGParams``:
  ``DDPGConfig.share_across_agents`` selects one actor-critic for the whole
  community (unbatched networks) or one per agent (``[A, ...]`` stacks).
* The single community carries ``DDPGState``: per-agent stacks, each
  agent's replay ring and its OU noise (``ddpg_init``, ``ddpg_act``,
  ``ddpg_update``).

Adam is element-wise, so one ``torch.optim.Adam`` over a stack of per-agent
parameters is optax's Adam vmapped over agents; and since agent a's loss
depends on agent a's parameters alone, summing the per-agent mean losses
before differentiating gives each agent exactly its own gradient.
"""

from __future__ import annotations

import copy
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from p2pmicrogrid_tpu_torch.config import DDPGConfig
from p2pmicrogrid_tpu_torch.device import resolve_device
from p2pmicrogrid_tpu_torch.models.networks import Actor, Critic, adam
from p2pmicrogrid_tpu_torch.models.replay import (
    ReplayState,
    replay_add,
    replay_init,
    replay_sample,
)
from p2pmicrogrid_tpu_torch.ops._f32 import sqrt as f32_sqrt

OBS_DIM = 4


class DDPGParams(NamedTuple):
    """The learnable bundle the shared trainer carries as its policy state.

    actor, critic, actor_target, critic_target: ``Actor``/``Critic`` with
        ``[A, ...]`` parameters in per-agent mode, unbatched when parameters
        are shared across agents.
    actor_opt, critic_opt: ``torch.optim.Adam`` over the actor's and the
        critic's parameters (optax's moments and step count live in their
        state; the learning rate in their param groups).
    noise_scale: 0-dim float32, the exploration annealing factor.
    """

    actor: Actor
    critic: Critic
    actor_target: Actor
    critic_target: Critic
    actor_opt: torch.optim.Adam
    critic_opt: torch.optim.Adam
    noise_scale: torch.Tensor


class DDPGState(NamedTuple):
    """The single community's DDPG learner (JAX source ``models/ddpg.py:41``):
    ``DDPGParams``' fields with per-agent ``[A, ...]`` networks, plus each
    agent's replay ring and OU noise.

    replay: ``ReplayState`` with ``[A, cap, ...]`` rings
    ou_state: [A] float32, the current OU noise of each agent
    noise_scale: 0-dim float32, the exploration annealing factor
    """

    actor: Actor
    critic: Critic
    actor_target: Actor
    critic_target: Critic
    actor_opt: torch.optim.Adam
    critic_opt: torch.optim.Adam
    replay: ReplayState
    ou_state: torch.Tensor
    noise_scale: torch.Tensor


def make_optimizers(
    cfg: DDPGConfig, actor: Actor, critic: Critic
) -> Tuple[torch.optim.Adam, torch.optim.Adam]:
    """One Adam (``adam``) per network at the config's lrs."""
    return adam(actor, cfg.actor_lr), adam(critic, cfg.critic_lr)


def set_learning_rates(cfg: DDPGConfig, params: DDPGParams) -> None:
    """Set both optimizers' learning rates to the config's (optax reads its lr
    when it updates; ``torch.optim.Adam`` keeps it in its param groups)."""
    for opt, lr in ((params.actor_opt, cfg.actor_lr), (params.critic_opt, cfg.critic_lr)):
        for group in opt.param_groups:
            group["lr"] = lr


def ddpg_params_init(
    cfg: DDPGConfig,
    n_agents: int,
    generator: Optional[torch.Generator] = None,
    device="cuda",
) -> DDPGParams:
    """Fresh actor and critic (flax's default init, drawn from ``generator``:
    the actor, then the critic), targets equal to them, fresh Adam: per-agent
    stacks ``[A, ...]``, or one unbatched set when
    ``cfg.share_across_agents``."""
    a = None if cfg.share_across_agents else n_agents
    return _params_init(cfg, a, generator, resolve_device(device))


def ddpg_init(
    cfg: DDPGConfig,
    n_agents: int,
    generator: Optional[torch.Generator] = None,
    device="cuda",
) -> DDPGState:
    """The single community's fresh learner (JAX source :70-84): per-agent
    networks whatever ``share_across_agents`` says, drawn from ``generator``
    (the actor, then the critic), empty rings, and the OU noise at
    ``ou_init_sd`` times standard normals drawn after them
    (rl_backup.py:81,102)."""
    dev = resolve_device(device)
    p = _params_init(cfg, n_agents, generator, dev)
    normals = torch.randn((n_agents,), generator=generator, device=dev)
    return DDPGState(
        actor=p.actor,
        critic=p.critic,
        actor_target=p.actor_target,
        critic_target=p.critic_target,
        actor_opt=p.actor_opt,
        critic_opt=p.critic_opt,
        replay=replay_init(n_agents, cfg.buffer_size, OBS_DIM, 1, device=dev),
        ou_state=cfg.ou_init_sd * normals,
        noise_scale=p.noise_scale,
    )


def _params_init(
    cfg: DDPGConfig, a: Optional[int], generator: Optional[torch.Generator], dev: torch.device
) -> DDPGParams:
    actor = Actor(a, cfg.actor_hidden, OBS_DIM, device=dev)
    critic = Critic(a, cfg.critic_hidden, OBS_DIM, device=dev)
    actor.reset_parameters(generator)
    critic.reset_parameters(generator)
    actor_target = copy.deepcopy(actor).requires_grad_(False)
    critic_target = copy.deepcopy(critic).requires_grad_(False)
    actor_opt, critic_opt = make_optimizers(cfg, actor, critic)
    return DDPGParams(
        actor=actor,
        critic=critic,
        actor_target=actor_target,
        critic_target=critic_target,
        actor_opt=actor_opt,
        critic_opt=critic_opt,
        noise_scale=torch.tensor(1.0, dtype=torch.float32, device=dev),
    )


def ou_step(cfg: DDPGConfig, x: torch.Tensor, normals: torch.Tensor) -> torch.Tensor:
    """One Ornstein-Uhlenbeck step toward mean 0 (rl_backup.py:65-85) from
    the step's standard normals: ``x - theta * x * dt + sigma * sqrt(dt) *
    normals``.

    The JAX package's jitted step folds the constants into float32 ``k =
    theta * dt`` and ``c = sigma * sqrt(dt)`` and contracts both
    multiply-adds: ``fma(c, normals, fma(-x, k, x))``. Each fused
    multiply-add is emulated in float64 (the float32 products are exact
    there) with one rounding to float32, so the OU state is the JAX
    package's bit for bit on the CPU and on the card.
    """
    k = float(np.float32(cfg.ou_theta) * np.float32(cfg.ou_dt))
    c = float(np.float32(cfg.ou_sigma) * np.float32(f32_sqrt(cfg.ou_dt)))
    x64 = x.double()
    decayed = (x64 - x64 * k).float().double()
    return (decayed + normals.double() * c).float()


@torch.no_grad()
def ddpg_shared_act(
    cfg: DDPGConfig,
    params: DDPGParams,
    obs_s: torch.Tensor,
    ou_s: torch.Tensor,
    normals: torch.Tensor,
    explore: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Scenario-batched act: obs_s [S, A, 4], ou_s [S, A] and the round's OU
    normals [S, A] -> (action_frac [S, A], q [S, A], ou_s'); ``params`` is a
    ``DDPGParams`` or a ``DDPGState``.

    Shared parameters run one ``[S * A, 4]`` application; per-agent ones run
    agent-major ``[A, S, 4]`` stacks. ``q`` is the critic's value of the
    action before noise. With ``explore=False`` the action is the actor's and
    the OU state is returned unchanged.
    """
    S, A, F = obs_s.shape
    if params.actor.n_agents is None:
        flat = obs_s.reshape(S * A, F)
        a = params.actor(flat)
        q = params.critic(flat, a)
        a, q = a.reshape(S, A), q.reshape(S, A)
    else:
        x = obs_s.transpose(0, 1)  # [A, S, 4]
        a = params.actor(x)
        q = params.critic(x, a)
        a, q = a[..., 0].transpose(0, 1), q[..., 0].transpose(0, 1)
    if not explore:
        return a, q, ou_s
    ou_s = ou_step(cfg, ou_s, normals)
    return torch.clamp(a + params.noise_scale * ou_s, 0.0, 1.0), q, ou_s


def ddpg_act(
    cfg: DDPGConfig,
    state: DDPGState,
    obs: torch.Tensor,
    normals: Optional[torch.Tensor],
    explore: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, DDPGState]:
    """The single community's act (JAX source :97-123): obs [A, 4] and the
    OU step's normals [A] -> (action_frac [A], q [A], state'). Exploring, the
    OU noise steps once and the action is ``clip(a + noise_scale * ou, 0,
    1)``; greedy, the actor's action and the state unchanged."""
    a, q, ou = ddpg_shared_act(
        cfg, state, obs[None], state.ou_state[None],
        None if normals is None else normals[None], explore,
    )
    return a[0], q[0], state._replace(ou_state=ou[0])


def polyak(tau: float, target: torch.nn.Module, online: torch.nn.Module) -> None:
    """Soft target update ``target = (1 - tau) * target + tau * online``
    (rl.py:170-175), in place."""
    with torch.no_grad():
        ts, os_ = list(target.parameters()), list(online.parameters())
        torch._foreach_mul_(ts, 1.0 - tau)
        torch._foreach_add_(ts, torch._foreach_mul(os_, tau))


def adam_count(opt: torch.optim.Adam) -> int:
    """The optimizer's step count (optax's ``ScaleByAdamState.count``), read
    on the host (a capturable Adam's count is on the device: reading it
    waits for the device)."""
    state = opt.state.get(opt.param_groups[0]["params"][0])
    return int(state["step"]) if state else 0


def ddpg_learn_batch(
    cfg: DDPGConfig,
    params: DDPGParams,
    s: torch.Tensor,
    a: torch.Tensor,
    r: torch.Tensor,
    ns: torch.Tensor,
    actor_step: Optional[bool] = None,
) -> torch.Tensor:
    """One DDPG gradient step on a transition batch, in place: the critic's
    TD(0) step toward the target bootstrap, then the actor's policy gradient
    through the updated critic, then Polyak targets (ddpg.py:126-186).

    Shared parameters take s/ns [N, 4], a [N, 1], r [N]; per-agent ones
    [A, N, 4], [A, N, 1], [A, N]. With ``actor_delay_updates`` the actor and
    its Adam state hold still while the critic's step count, read after its
    step, is below it; the actor target still moves toward the held actor.
    ``actor_step`` gives that decision from a count the caller knows on the
    host; None reads the count, except at ``actor_delay_updates=0``, where
    the actor always steps and nothing is read.

    Returns the per-sample squared critic residual, [N] or [A, N].
    """
    with torch.no_grad():
        q_next = params.critic_target(ns, params.actor_target(ns))[..., 0]
        q_target = r + cfg.gamma * q_next
    sq = torch.square(q_target - params.critic(s, a)[..., 0])
    params.critic_opt.zero_grad(set_to_none=True)
    sq.mean(dim=-1).sum().backward()
    params.critic_opt.step()

    if actor_step is None:
        actor_step = (
            cfg.actor_delay_updates <= 0
            or adam_count(params.critic_opt) >= cfg.actor_delay_updates
        )
    if actor_step:
        actor_params = list(params.actor.parameters())
        q_pi = params.critic(s, params.actor(s))[..., 0]
        grads = torch.autograd.grad(-q_pi.mean(dim=-1).sum(), actor_params)
        for p, g in zip(actor_params, grads):
            p.grad = g
        params.actor_opt.step()

    polyak(cfg.tau, params.actor_target, params.actor)
    polyak(cfg.tau, params.critic_target, params.critic)
    return sq.detach()


def ddpg_update(
    cfg: DDPGConfig,
    state: DDPGState,
    obs: torch.Tensor,
    action_frac: torch.Tensor,
    reward: torch.Tensor,
    next_obs: torch.Tensor,
    idx: torch.Tensor,
) -> Tuple[DDPGState, torch.Tensor]:
    """The single community's per-slot learn step (JAX source :281-324): add
    the transition to each agent's ring, sample each agent's batch at
    ``idx`` [A, B], and take one ``ddpg_learn_batch`` step on the per-agent
    stacks, in place.

    obs/next_obs: [A, 4]; action_frac: [A] in [0, 1]; reward: [A].
    Returns (state, critic loss [A]): each agent's mean squared residual.
    """
    replay = replay_add(state.replay, obs, action_frac[:, None], reward, next_obs)
    s, a, r, ns = replay_sample(replay, idx)
    sq = ddpg_learn_batch(cfg, state, s, a, r, ns)
    return state._replace(replay=replay), sq.mean(dim=-1)


def ddpg_decay(cfg: DDPGConfig, params):
    """Anneal the OU noise on the reference's decay cadence
    (community.py:279-287), on a ``DDPGParams`` or a ``DDPGState``; the
    default ``noise_decay=1.0`` keeps it."""
    return params._replace(noise_scale=params.noise_scale * cfg.noise_decay)
