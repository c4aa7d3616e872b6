"""The per-agent state-action Q-network of the DQN learner.

The port of the JAX package's ``models/networks.py::QNetwork``
(rl.py:135-148): concat(state [4], action [1]) -> Dense 64 -> ReLU ->
Dense 64 -> ReLU -> Dense 1, one independent network per agent.

Layout: every agent's parameters are stacked on a leading ``[A]`` axis in
flax's ``Dense`` layout, the kernel as ``[A, in, out]`` and the bias as
``[A, out]``, under flax's names (``Dense_0.kernel``, ``Dense_0.bias``, ...).
The converter (``convert.py``), the plain forward here and the fused slot
kernel K7 (``csrc/slot_fused.cu``) all read that one layout in place. The
actor and critic of DDPG are not ported yet (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

# flax's default Dense kernel init, lecun_normal: variance_scaling(1.0,
# "fan_in", "truncated_normal") draws from a normal truncated at two standard
# deviations, with the standard deviation divided by this constant so the
# truncated draw keeps variance 1 / fan_in.
_TRUNCATED_NORMAL_STD = 0.87962566103423978


class BatchedDense(nn.Module):
    """One ``Dense`` layer per agent: ``y[a] = x[a] @ kernel[a] + bias[a]``."""

    def __init__(self, n_agents: int, d_in: int, d_out: int, device=None):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros((n_agents, d_in, d_out), device=device))
        self.bias = nn.Parameter(torch.zeros((n_agents, d_out), device=device))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """flax's defaults: lecun_normal kernel, zero bias."""
        std = (1.0 / self.kernel.shape[1]) ** 0.5 / _TRUNCATED_NORMAL_STD
        with torch.no_grad():
            nn.init.trunc_normal_(
                self.kernel, 0.0, std, -2.0 * std, 2.0 * std, generator=generator
            )
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [A, N, in] -> [A, N, out], full float32 (``torch.baddbmm``)."""
        return torch.baddbmm(self.bias[:, None, :], x, self.kernel)


class QNetwork(nn.Module):
    """Per-agent Q(s, a): ``forward(state [A, N, 4], action [A, N, 1]) ->
    [A, N, 1]``."""

    def __init__(self, n_agents: int, hidden: int = 64, obs_dim: int = 4, device=None):
        super().__init__()
        self.Dense_0 = BatchedDense(n_agents, obs_dim + 1, hidden, device)
        self.Dense_1 = BatchedDense(n_agents, hidden, hidden, device)
        self.Dense_2 = BatchedDense(n_agents, hidden, 1, device)

    @property
    def n_agents(self) -> int:
        return self.Dense_0.kernel.shape[0]

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for layer in (self.Dense_0, self.Dense_1, self.Dense_2):
            layer.reset_parameters(generator)

    def forward(self, state: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
        if state.is_cuda and torch.backends.cuda.matmul.allow_tf32:
            # TF32 keeps ~3 decimal digits: the acts and the learn step, like
            # the JAX reference, run in full float32.
            raise RuntimeError(
                "QNetwork runs in full float32: set "
                "torch.backends.cuda.matmul.allow_tf32 = False"
            )
        x = torch.cat([state, action], dim=-1)
        x = torch.relu(self.Dense_0(x))
        x = torch.relu(self.Dense_1(x))
        return self.Dense_2(x)
