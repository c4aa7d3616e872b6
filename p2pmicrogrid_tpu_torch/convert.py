"""Move state between the JAX package and the port.

``state_from_jax`` takes one of the JAX package's state NamedTuples with its
leaves already converted to numpy (``jax.tree.map(np.asarray, state)``) and
returns the port's NamedTuple of the same name with tensors on ``device``:
``TabularState``, ``PhysState``, ``AgentRatings``, ``EpisodeArrays``,
``ReplayState``, ``LockstepReplay``, ``DQNState``, ``DDPGParams``,
``DDPGState``, ``DDPGScenState`` or ``RecurrentDDPGState``. The match is by class name and field
names, so this module imports nothing of the JAX package.

A ``DQNState``, ``DDPGParams`` or ``DDPGState`` carries flax parameter trees,
``{"Dense_i": {"kernel", "bias"}}`` with the kernel ``[A, in, out]`` per
agent or ``[in, out]`` shared, which load in place into the port's networks
(the same layout; a ``RecurrentDDPGState``'s LSTM cell adds
``OptimizedLSTMCell_0/{ii,if,ig,io}/kernel`` and ``{hi,hf,hg,ho}/{kernel,
bias}``, ``models/networks.py::flax_leaves`` maps both), and optax's Adam states ``(ScaleByAdamState(count, mu,
nu), EmptyState())``, which become ``torch.optim.Adam`` states at the same
step count (``count`` is ``[A]`` per agent, a scalar shared). Adam's
learning rate is not part of that state, so these need their config
(``DQNConfig``, ``DDPGConfig``). A ``DDPGState`` also carries its per-agent
replay ring, OU noise and noise scale.

``state_to_numpy`` does the reverse for comparisons and checkpoints: these
come back with flax-shaped trees and optax-shaped Adam states (the
NamedTuples below, named as optax names them). ``load_state_`` writes such a
tree back into an existing state, in place.

``stacked_state_from_jax`` and ``stacked_state_to_numpy`` move the JAX
package's S independent learners (``jax.vmap(init_policy_state)``'s output:
a ``TabularState``, ``DQNState`` or ``DDPGState`` with a leading [S] axis on
every leaf) to and from the port's one state of S * A per-agent learners,
scenario-major (``parallel/scenarios.py::init_independent_state``).

``greedy_tree``, ``flat_tree`` and ``nested_tree`` give policy bundles
(``serve/export.py``) the JAX package's layout: a greedy parameter subtree
(the Q-table, the online Q-network, the actor) as a numpy tree of flax's
names and shapes, flattened to '/'-joined paths (``Dense_0/kernel``, ...)
and back; ``network_from_tree`` builds the port's network from such a tree.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from p2pmicrogrid_tpu_torch.config import DDPGConfig, DQNConfig
from p2pmicrogrid_tpu_torch.device import resolve_device
from p2pmicrogrid_tpu_torch.envs.community import AgentRatings, EpisodeArrays, PhysState
from p2pmicrogrid_tpu_torch.models.ddpg import DDPGParams, DDPGState, make_optimizers
from p2pmicrogrid_tpu_torch.models.ddpg_recurrent import (
    RecurrentActor,
    RecurrentCritic,
    RecurrentDDPGState,
)
from p2pmicrogrid_tpu_torch.models.dqn import DQNState, make_optimizer
from p2pmicrogrid_tpu_torch.models.networks import Actor, QNetwork, adam, flax_leaves
from p2pmicrogrid_tpu_torch.models.replay import LockstepReplay, ReplayState
from p2pmicrogrid_tpu_torch.models.tabular import TabularState
from p2pmicrogrid_tpu_torch.parallel.scenarios import DDPGScenState
from p2pmicrogrid_tpu_torch.train.checkpoint import _nest, _walk_leaves

_TENSOR_TYPES = {cls.__name__: cls for cls in (TabularState, PhysState, AgentRatings, EpisodeArrays)}
_RING_TYPES = {cls.__name__: cls for cls in (ReplayState, LockstepReplay)}


class ScaleByAdamState(NamedTuple):
    """optax's Adam state: step ``count`` int32 ([A] per agent, a scalar
    shared) and moments ``mu``/``nu`` as flax-shaped trees."""

    count: np.ndarray
    mu: dict
    nu: dict


class EmptyState(NamedTuple):
    """optax's state of a stateless transformation."""


def _check_fields(np_tree, cls) -> None:
    if tuple(getattr(np_tree, "_fields", ())) != cls._fields:
        raise TypeError(
            f"state_from_jax: {type(np_tree).__name__} must have fields "
            f"{cls._fields}, got {getattr(np_tree, '_fields', None)}"
        )


def _tensor(x, dev) -> torch.Tensor:
    return torch.from_numpy(np.array(x)).to(dev)


def _ring(np_tree, cls, dev):
    _check_fields(np_tree, cls)
    *bufs, cursor, count = np_tree
    return cls(*(_tensor(b, dev) for b in bufs), int(cursor), int(count))


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _put(tree: dict, path, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def network_from_tree(tree: dict, cls, dev: torch.device):
    """A flax parameter tree as the port's module ``cls`` on ``dev``:
    ``QNetwork``/``Critic`` or ``Actor``, per agent for ``[A, in, out]``
    kernels, shared for ``[in, out]`` (the share flag is the kernel's ndim,
    as the JAX package's ``serve/export.py`` reads it); or a recurrent
    network (``RecurrentActor``, ``RecurrentCritic``, the forecaster), its
    widths read off the tree as the JAX package's export reads them."""
    kernel0 = np.asarray(tree["Dense_0"]["kernel"])
    if "OptimizedLSTMCell_0" in tree:
        width = lambda name: np.asarray(tree[name]["bias"]).shape[-1]
        last = max((k for k in tree if k.startswith("Dense_")), key=lambda k: int(k[6:]))
        net = cls(
            kernel0.shape[0] - cls.action_dim, device=dev,
            hidden_pre=width("Dense_0"), hidden_mid=width("Dense_1"),
            lstm_features=np.asarray(tree["OptimizedLSTMCell_0"]["hf"]["bias"]).shape[0],
            hidden_post=width("Dense_2"), n_out=width(last),
        )
    else:
        n_agents = kernel0.shape[0] if kernel0.ndim == 3 else None
        d_in, hidden = kernel0.shape[-2:]
        net = cls(n_agents, hidden, d_in - cls.action_dim, device=dev)
    _load_net_(net, tree)
    return net


def _load_adam(opt: torch.optim.Adam, net, opt_state) -> None:
    """optax's ``(ScaleByAdamState, EmptyState)`` of ``net`` into ``opt``."""
    adam_state, _ = opt_state
    if type(adam_state).__name__ != "ScaleByAdamState":
        raise TypeError(
            f"state_from_jax: opt_state[0] must be ScaleByAdamState, got {type(adam_state).__name__}"
        )
    counts = np.asarray(adam_state.count).reshape(-1)
    if not (counts == counts[0]).all():
        raise ValueError("state_from_jax: per-agent Adam step counts differ")
    for path, p in flax_leaves(net):
        # A capturable Adam (on the card) keeps its count on the device.
        on = p.device if opt.defaults["capturable"] else "cpu"
        opt.state[p] = {
            "step": torch.tensor(float(counts[0]), dtype=torch.float32, device=on),
            "exp_avg": _tensor(_get(adam_state.mu, path), p.device),
            "exp_avg_sq": _tensor(_get(adam_state.nu, path), p.device),
        }


def _target(tree: dict, cls, dev):
    return network_from_tree(tree, cls, dev).requires_grad_(False)


def _dqn_state(np_tree, dev, cfg: DQNConfig) -> DQNState:
    _check_fields(np_tree, DQNState)
    online = network_from_tree(np_tree.online, QNetwork, dev)
    opt = make_optimizer(cfg, online)
    _load_adam(opt, online, np_tree.opt_state)
    return DQNState(
        online=online,
        target=_target(np_tree.target, QNetwork, dev),
        opt_state=opt,
        replay=_ring(np_tree.replay, ReplayState, dev),
        epsilon=_tensor(np_tree.epsilon, dev),
    )


def _ddpg_params(np_tree, dev, cfg: DDPGConfig) -> DDPGParams:
    _check_fields(np_tree, DDPGParams)
    actor = network_from_tree(np_tree.actor, Actor, dev)
    critic = network_from_tree(np_tree.critic, QNetwork, dev)
    actor_opt, critic_opt = make_optimizers(cfg, actor, critic)
    _load_adam(actor_opt, actor, np_tree.actor_opt)
    _load_adam(critic_opt, critic, np_tree.critic_opt)
    return DDPGParams(
        actor=actor,
        critic=critic,
        actor_target=_target(np_tree.actor_target, Actor, dev),
        critic_target=_target(np_tree.critic_target, QNetwork, dev),
        actor_opt=actor_opt,
        critic_opt=critic_opt,
        noise_scale=_tensor(np_tree.noise_scale, dev),
    )


def _ddpg_state(np_tree, dev, cfg: DDPGConfig) -> DDPGState:
    _check_fields(np_tree, DDPGState)
    params = _ddpg_params(
        DDPGParams(*(getattr(np_tree, f) for f in DDPGParams._fields)), dev, cfg
    )
    return DDPGState(
        **params._asdict(),
        replay=_ring(np_tree.replay, ReplayState, dev),
        ou_state=_tensor(np_tree.ou_state, dev),
    )


def _recurrent_state(np_tree, dev, cfg: DDPGConfig) -> RecurrentDDPGState:
    _check_fields(np_tree, RecurrentDDPGState)
    actor = network_from_tree(np_tree.actor, RecurrentActor, dev)
    critic = network_from_tree(np_tree.critic, RecurrentCritic, dev)
    actor_opt, critic_opt = adam(actor, cfg.actor_lr), adam(critic, cfg.critic_lr)
    _load_adam(actor_opt, actor, np_tree.actor_opt)
    _load_adam(critic_opt, critic, np_tree.critic_opt)
    return RecurrentDDPGState(
        actor=actor,
        critic=critic,
        actor_target=_target(np_tree.actor_target, RecurrentActor, dev),
        critic_target=_target(np_tree.critic_target, RecurrentCritic, dev),
        actor_opt=actor_opt,
        critic_opt=critic_opt,
    )


_LEARNER_STATES = {
    "DQNState": (_dqn_state, DQNConfig),
    "DDPGParams": (_ddpg_params, DDPGConfig),
    "DDPGState": (_ddpg_state, DDPGConfig),
    "RecurrentDDPGState": (_recurrent_state, DDPGConfig),
}


def state_from_jax(np_tree, device="cuda", cfg=None):
    """The port's counterpart of a JAX state NamedTuple with numpy leaves;
    ``cfg`` (the ``DQNConfig`` or ``DDPGConfig``) is needed for a
    ``DQNState`` or ``DDPGParams``."""
    dev = resolve_device(device)
    name = type(np_tree).__name__
    if name in _TENSOR_TYPES:
        cls = _TENSOR_TYPES[name]
        _check_fields(np_tree, cls)
        return cls(*(_tensor(x, dev) for x in np_tree))
    if name in _RING_TYPES:
        return _ring(np_tree, _RING_TYPES[name], dev)
    if name == "DDPGScenState":
        _check_fields(np_tree, DDPGScenState)
        return DDPGScenState(
            replay=_ring(np_tree.replay, LockstepReplay, dev), ou=_tensor(np_tree.ou, dev)
        )
    if name in _LEARNER_STATES:
        convert, cfg_type = _LEARNER_STATES[name]
        if not isinstance(cfg, cfg_type):
            raise ValueError(f"state_from_jax: a {name} needs its {cfg_type.__name__} (cfg=)")
        return convert(np_tree, dev, cfg)
    raise TypeError(
        f"state_from_jax converts "
        f"{sorted([*_TENSOR_TYPES, *_RING_TYPES, 'DDPGScenState', *_LEARNER_STATES])}, got {name}"
    )


def _tree_to_numpy(net) -> dict:
    tree: dict = {}
    for path, p in flax_leaves(net):
        _put(tree, path, state_to_numpy(p))
    return tree


def _adam_to_numpy(opt: torch.optim.Adam, net) -> tuple:
    mu, nu = {}, {}
    step = 0
    for path, p in flax_leaves(net):
        st = opt.state.get(p, {})
        zeros = np.zeros(tuple(p.shape), np.float32)
        _put(mu, path, state_to_numpy(st["exp_avg"]) if st else zeros)
        _put(nu, path, state_to_numpy(st["exp_avg_sq"]) if st else zeros)
        step = int(st["step"]) if st else 0
    shape = () if getattr(net, "n_agents", None) is None else (net.n_agents,)
    count = np.full(shape, step, dtype=np.int32)
    return (ScaleByAdamState(count=count, mu=mu, nu=nu), EmptyState())


def state_to_numpy(tree):
    """A port NamedTuple (or tensor) with its tensors copied to numpy; a
    ``DQNState``, ``DDPGParams`` or ``DDPGState`` in the JAX package's tree
    shapes."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, DQNState):
        return DQNState(
            online=_tree_to_numpy(tree.online),
            target=_tree_to_numpy(tree.target),
            opt_state=_adam_to_numpy(tree.opt_state, tree.online),
            replay=state_to_numpy(tree.replay),
            epsilon=state_to_numpy(tree.epsilon),
        )
    if isinstance(tree, RecurrentDDPGState):
        return RecurrentDDPGState(
            actor=_tree_to_numpy(tree.actor),
            critic=_tree_to_numpy(tree.critic),
            actor_target=_tree_to_numpy(tree.actor_target),
            critic_target=_tree_to_numpy(tree.critic_target),
            actor_opt=_adam_to_numpy(tree.actor_opt, tree.actor),
            critic_opt=_adam_to_numpy(tree.critic_opt, tree.critic),
        )
    if isinstance(tree, (DDPGParams, DDPGState)):
        params = dict(
            actor=_tree_to_numpy(tree.actor),
            critic=_tree_to_numpy(tree.critic),
            actor_target=_tree_to_numpy(tree.actor_target),
            critic_target=_tree_to_numpy(tree.critic_target),
            actor_opt=_adam_to_numpy(tree.actor_opt, tree.actor),
            critic_opt=_adam_to_numpy(tree.critic_opt, tree.critic),
            noise_scale=state_to_numpy(tree.noise_scale),
        )
        if isinstance(tree, DDPGParams):
            return DDPGParams(**params)
        return DDPGState(
            **params, replay=state_to_numpy(tree.replay), ou_state=state_to_numpy(tree.ou_state)
        )
    if isinstance(tree, (ReplayState, LockstepReplay)):
        *bufs, cursor, count = tree
        return type(tree)(
            *(state_to_numpy(b) for b in bufs), np.int32(cursor), np.int32(count)
        )
    return type(tree)(*(state_to_numpy(x) for x in tree))


def greedy_tree(node):
    """A greedy parameter subtree as a numpy tree in flax's layout: a
    network (``QNetwork``, ``Actor``) as ``{"Dense_i": {"kernel", "bias"}}``
    (kernels ``[A, in, out]`` per agent, ``[in, out]`` shared), a tensor (the
    Q-table) as its array, and a dict (a structure-free checkpoint read,
    ``train/checkpoint.py::restore_raw``) key by key."""
    if isinstance(node, torch.nn.Module):
        return _tree_to_numpy(node)
    if isinstance(node, dict):
        return {str(k): greedy_tree(v) for k, v in node.items()}
    return state_to_numpy(node) if isinstance(node, torch.Tensor) else np.asarray(node)


def flat_tree(tree: dict) -> dict:
    """A nested dict of arrays as ``{'/'-joined path: array}`` in sorted
    path order, the JAX package's ``jax.tree_util`` flattening of a flax
    tree."""
    return dict(_walk_leaves(tree))


def nested_tree(flat: dict) -> dict:
    """``flat_tree``'s inverse: ``{'a/b': x}`` as ``{'a': {'b': x}}``."""
    return _nest(flat)


def _map_arrays(fn, tree):
    """``tree`` (NamedTuples, tuples, dicts) with ``fn`` applied to each
    numpy array or scalar leaf."""
    if isinstance(tree, dict):
        return {k: _map_arrays(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        items = [_map_arrays(fn, x) for x in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)
    return fn(np.asarray(tree))


def stacked_state_from_jax(np_tree, device="cuda", cfg=None):
    """S stacked JAX learner states (numpy leaves, each [S, ...]) as the
    port's state of S * A learners: every per-agent leaf [S, A, ...] becomes
    [S * A, ...], and every per-scenario leaf [S] (epsilon, the rings'
    cursor and count, the noise scale) one value, which must be equal across
    scenarios: every scenario runs the same slots. ``cfg`` as for
    ``state_from_jax``."""

    def merge(x):
        if x.ndim == 1:
            if not (x == x[0]).all():
                raise ValueError(f"stacked_state_from_jax: per-scenario values differ: {x}")
            return x[0]
        return x.reshape((x.shape[0] * x.shape[1],) + x.shape[2:])

    return state_from_jax(_map_arrays(merge, np_tree), device, cfg)


def stacked_state_to_numpy(state, n_scenarios: int):
    """``stacked_state_from_jax``'s inverse: the port's S * A learners as the
    JAX package's S stacked states with numpy leaves (per-agent leaves [S,
    A, ...], each scalar repeated S times)."""
    S = n_scenarios

    def split(x):
        if x.ndim == 0:
            return np.full((S,), x, dtype=x.dtype)
        return x.reshape((S, x.shape[0] // S) + x.shape[1:])

    return _map_arrays(split, state_to_numpy(state))


def _copy_into(dst: torch.Tensor, src) -> None:
    src = np.asarray(src)
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"load_state_: shape {src.shape} does not fit {tuple(dst.shape)}")
    dst.copy_(torch.from_numpy(np.array(src, dtype=np.asarray(src).dtype)))


def _load_net_(net, tree: dict) -> None:
    with torch.no_grad():
        for path, p in flax_leaves(net):
            _copy_into(p.data, _get(tree, path))


def _load_adam_(opt: torch.optim.Adam, net, opt_state) -> None:
    from p2pmicrogrid_tpu_torch.parallel.scenarios import _adam_leaves

    adam_state, _ = opt_state
    counts = np.asarray(adam_state.count).reshape(-1)
    if not (counts == counts[0]).all():
        raise ValueError("load_state_: per-agent Adam step counts differ")
    _adam_leaves(opt, net)  # the state a first step would make, where there is none
    for path, p in flax_leaves(net):
        st = opt.state[p]
        st["step"].fill_(float(counts[0]))
        _copy_into(st["exp_avg"], _get(adam_state.mu, path))
        _copy_into(st["exp_avg_sq"], _get(adam_state.nu, path))


def load_state_(state, np_tree):
    """Write ``np_tree`` (``state_to_numpy``'s layout) into ``state``'s
    tensors in place: parameters, Adam's moments and step counts (where a
    capturable Adam keeps them on the device too), rings, exploration
    scales. A CUDA graph that captured these tensors, or an optimiser that
    holds them, reads the new values. Returns the state, with its rings'
    host cursor and count replaced (they are Python integers)."""
    if isinstance(state, torch.Tensor):
        _copy_into(state, np_tree)
        return state
    with torch.no_grad():
        if isinstance(state, DQNState):
            _load_net_(state.online, np_tree.online)
            _load_net_(state.target, np_tree.target)
            _load_adam_(state.opt_state, state.online, np_tree.opt_state)
            return state._replace(
                replay=load_state_(state.replay, np_tree.replay),
                epsilon=load_state_(state.epsilon, np_tree.epsilon),
            )
        if isinstance(state, RecurrentDDPGState):
            for net in ("actor", "critic", "actor_target", "critic_target"):
                _load_net_(getattr(state, net), getattr(np_tree, net))
            _load_adam_(state.actor_opt, state.actor, np_tree.actor_opt)
            _load_adam_(state.critic_opt, state.critic, np_tree.critic_opt)
            return state
        if isinstance(state, (DDPGParams, DDPGState)):
            for net in ("actor", "critic", "actor_target", "critic_target"):
                _load_net_(getattr(state, net), getattr(np_tree, net))
            _load_adam_(state.actor_opt, state.actor, np_tree.actor_opt)
            _load_adam_(state.critic_opt, state.critic, np_tree.critic_opt)
            state = state._replace(noise_scale=load_state_(state.noise_scale, np_tree.noise_scale))
            if isinstance(state, DDPGState):
                state = state._replace(
                    replay=load_state_(state.replay, np_tree.replay),
                    ou_state=load_state_(state.ou_state, np_tree.ou_state),
                )
            return state
        if isinstance(state, (ReplayState, LockstepReplay)):
            *bufs, cursor, count = np_tree
            for dst, src in zip(state[:-2], bufs):
                _copy_into(dst, src)
            return state._replace(cursor=int(cursor), count=int(count))
        if isinstance(state, tuple) and hasattr(state, "_fields"):
            return type(state)(*(load_state_(x, y) for x, y in zip(state, np_tree)))
    raise TypeError(f"load_state_: cannot load into {type(state).__name__}")
