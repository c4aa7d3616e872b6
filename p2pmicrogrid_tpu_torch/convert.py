"""Move state between the JAX package and the port.

``state_from_jax`` takes one of the JAX package's state NamedTuples with its
leaves already converted to numpy (``jax.tree.map(np.asarray, state)``) and
returns the port's NamedTuple of the same name with tensors on ``device``:
``TabularState``, ``PhysState``, ``AgentRatings``, ``EpisodeArrays``,
``ReplayState``, ``LockstepReplay`` or ``DQNState``. The match is by class
name and field names, so this module imports nothing of the JAX package.

A ``DQNState`` carries flax parameter trees, ``{"Dense_i": {"kernel",
"bias"}}`` with the kernel ``[A, in, out]``, which load in place into the
port's ``QNetwork`` (the same layout), and optax's Adam state
``(ScaleByAdamState(count, mu, nu), EmptyState())``, which becomes the
``torch.optim.Adam`` state at the same step count. Adam's learning rate is
not part of that state, so a ``DQNState`` needs the ``DQNConfig``.

``state_to_numpy`` does the reverse for comparisons: a ``DQNState`` comes
back with flax-shaped trees and optax-shaped Adam state (the NamedTuples
below, named as optax names them).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from p2pmicrogrid_tpu_torch.config import DQNConfig
from p2pmicrogrid_tpu_torch.device import resolve_device
from p2pmicrogrid_tpu_torch.envs.community import AgentRatings, EpisodeArrays, PhysState
from p2pmicrogrid_tpu_torch.models.dqn import DQNState, make_optimizer
from p2pmicrogrid_tpu_torch.models.networks import QNetwork
from p2pmicrogrid_tpu_torch.models.replay import LockstepReplay, ReplayState
from p2pmicrogrid_tpu_torch.models.tabular import TabularState

_TENSOR_TYPES = {cls.__name__: cls for cls in (TabularState, PhysState, AgentRatings, EpisodeArrays)}
_RING_TYPES = {cls.__name__: cls for cls in (ReplayState, LockstepReplay)}
_LAYERS = ("Dense_0", "Dense_1", "Dense_2")


class ScaleByAdamState(NamedTuple):
    """optax's Adam state: step ``count`` [A] int32 and moments ``mu``/``nu``
    as flax-shaped trees."""

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


def _network(tree: dict, dev) -> QNetwork:
    """A flax ``QNetwork`` parameter tree as the port's module."""
    kernel0 = np.asarray(tree["Dense_0"]["kernel"])
    n_agents, d_in, hidden = kernel0.shape
    net = QNetwork(n_agents, hidden, d_in - 1, device=dev)
    with torch.no_grad():
        for name in _LAYERS:
            layer = getattr(net, name)
            layer.kernel.copy_(_tensor(tree[name]["kernel"], dev))
            layer.bias.copy_(_tensor(tree[name]["bias"], dev))
    return net


def _dqn_state(np_tree, dev, cfg: DQNConfig) -> DQNState:
    _check_fields(np_tree, DQNState)
    online = _network(np_tree.online, dev)
    target = _network(np_tree.target, dev)
    target.requires_grad_(False)
    adam, _ = np_tree.opt_state
    if type(adam).__name__ != "ScaleByAdamState":
        raise TypeError(f"state_from_jax: opt_state[0] must be ScaleByAdamState, got {type(adam).__name__}")
    counts = np.asarray(adam.count)
    if counts.size and not (counts == counts.flat[0]).all():
        raise ValueError("state_from_jax: per-agent Adam step counts differ")
    opt = make_optimizer(cfg, online)
    step = float(counts.flat[0]) if counts.size else 0.0
    for name in _LAYERS:
        for field in ("kernel", "bias"):
            p = getattr(getattr(online, name), field)
            opt.state[p] = {
                "step": torch.tensor(step, dtype=torch.float32),
                "exp_avg": _tensor(adam.mu[name][field], dev),
                "exp_avg_sq": _tensor(adam.nu[name][field], dev),
            }
    return DQNState(
        online=online,
        target=target,
        opt_state=opt,
        replay=_ring(np_tree.replay, ReplayState, dev),
        epsilon=_tensor(np_tree.epsilon, dev),
    )


def state_from_jax(np_tree, device="cuda", cfg: Optional[DQNConfig] = None):
    """The port's counterpart of a JAX state NamedTuple with numpy leaves;
    ``cfg`` (the ``DQNConfig``) is needed for a ``DQNState``."""
    dev = resolve_device(device)
    name = type(np_tree).__name__
    if name in _TENSOR_TYPES:
        cls = _TENSOR_TYPES[name]
        _check_fields(np_tree, cls)
        return cls(*(_tensor(x, dev) for x in np_tree))
    if name in _RING_TYPES:
        return _ring(np_tree, _RING_TYPES[name], dev)
    if name == "DQNState":
        if cfg is None:
            raise ValueError("state_from_jax: a DQNState needs its DQNConfig (cfg=)")
        return _dqn_state(np_tree, dev, cfg)
    raise TypeError(
        f"state_from_jax converts {sorted([*_TENSOR_TYPES, *_RING_TYPES, 'DQNState'])}, "
        f"got {name}"
    )


def _tree_to_numpy(net: QNetwork) -> dict:
    return {
        name: {
            field: state_to_numpy(getattr(getattr(net, name), field))
            for field in ("kernel", "bias")
        }
        for name in _LAYERS
    }


def _adam_to_numpy(opt: torch.optim.Adam, online: QNetwork) -> tuple:
    mu, nu = {}, {}
    step = 0
    for name in _LAYERS:
        mu[name], nu[name] = {}, {}
        for field in ("kernel", "bias"):
            p = getattr(getattr(online, name), field)
            st = opt.state.get(p, {})
            zeros = np.zeros(tuple(p.shape), np.float32)
            mu[name][field] = state_to_numpy(st["exp_avg"]) if st else zeros
            nu[name][field] = state_to_numpy(st["exp_avg_sq"]) if st else zeros
            step = int(st["step"]) if st else 0
    count = np.full((online.n_agents,), step, dtype=np.int32)
    return (ScaleByAdamState(count=count, mu=mu, nu=nu), EmptyState())


def state_to_numpy(tree):
    """A port NamedTuple (or tensor) with its tensors copied to numpy; a
    ``DQNState`` in the JAX package's tree shapes."""
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
    if isinstance(tree, (ReplayState, LockstepReplay)):
        *bufs, cursor, count = tree
        return type(tree)(
            *(state_to_numpy(b) for b in bufs), np.int32(cursor), np.int32(count)
        )
    return type(tree)(*(state_to_numpy(x) for x in tree))
