"""Move state between the JAX package and the port.

``state_from_jax`` takes one of the JAX package's state NamedTuples with its
leaves already converted to numpy (``jax.tree.map(np.asarray, state)``) and
returns the port's NamedTuple of the same name with tensors on ``device``:
``TabularState``, ``PhysState``, ``AgentRatings`` or ``EpisodeArrays``. The
match is by class name and field names, so this module imports nothing of
the JAX package. ``state_to_numpy`` does the reverse for comparisons.
"""

from __future__ import annotations

import numpy as np
import torch

from p2pmicrogrid_tpu_torch.device import resolve_device
from p2pmicrogrid_tpu_torch.envs.community import AgentRatings, EpisodeArrays, PhysState
from p2pmicrogrid_tpu_torch.models.tabular import TabularState

_TYPES = {cls.__name__: cls for cls in (TabularState, PhysState, AgentRatings, EpisodeArrays)}


def state_from_jax(np_tree, device="cuda"):
    """The port's counterpart of a JAX state NamedTuple with numpy leaves."""
    dev = resolve_device(device)
    name = type(np_tree).__name__
    cls = _TYPES.get(name)
    if cls is None or tuple(getattr(np_tree, "_fields", ())) != cls._fields:
        raise TypeError(
            f"state_from_jax converts {sorted(_TYPES)}, got {name} with fields "
            f"{getattr(np_tree, '_fields', None)}"
        )
    return cls(*(torch.from_numpy(np.array(x)).to(dev) for x in np_tree))


def state_to_numpy(tree):
    """A port NamedTuple (or tensor) with its tensors copied to numpy."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return type(tree)(*(state_to_numpy(x) for x in tree))
