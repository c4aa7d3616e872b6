"""The learners' networks: DQN's state-action Q-network and DDPG's actor and
critic.

The port of the JAX package's ``models/networks.py``:

* ``QNetwork`` (rl.py:135-148): concat(state [4], action [1]) -> Dense 64 ->
  ReLU -> Dense 64 -> ReLU -> Dense 1. DDPG's critic (flax ``Critic``) is the
  same network, so ``Critic`` names it again.
* ``Actor``: state [4] -> Dense 64 -> ReLU -> Dense 64 -> ReLU -> Dense 1 ->
  sigmoid, the heat-pump power fraction in [0, 1].

Each comes in two forms, chosen by ``n_agents``: an integer stacks one
independent network per agent on a leading ``[A]`` axis (``BatchedDense``,
the kernel ``[A, in, out]``, the bias ``[A, out]``); None gives one unbatched
network (``Dense``, the kernel ``[in, out]``, the bias ``[out]``), shared by
every agent. Both keep flax's ``Dense`` layout and names (``Dense_0.kernel``,
``Dense_0.bias``, ...), which the converter (``convert.py``), the plain
forwards here and the fused slot kernel K7 (``csrc/slot_fused.cu``) read in
place. Every forward runs in full float32 and refuses TF32 on the card.
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


def truncated_normal(shape, std: float, generator: Optional[torch.Generator] = None, device=None) -> torch.Tensor:
    """float32 draws of a normal with standard deviation ``std`` truncated
    at two of them: normal draws, each one outside the bounds drawn again
    (all of them together) until none is. ``nn.init.trunc_normal_`` does
    this in torch 2.13 and maps uniform draws through ``erfinv`` in torch
    2.11, so one seed gave two versions two sets of weights; spelled out
    here with ``normal_``, whose stream both share, every version draws
    2.13's."""
    lo, hi = (float(torch.tensor(b, dtype=torch.float32)) for b in (-2.0 * std, 2.0 * std))
    out = torch.empty(shape, device=device).normal_(0.0, std, generator=generator)
    while True:
        outside = (out < lo) | (out > hi)
        if not outside.any():
            return out
        out = torch.where(outside, torch.empty_like(out).normal_(0.0, std, generator=generator), out)


def require_full_float32(x: torch.Tensor, net: nn.Module) -> None:
    """Refuse TF32 for ``net``'s matrix products on the card: TF32 keeps ~3
    decimal digits, and the acts and the learn steps, like the JAX
    reference, run in full float32."""
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            f"{type(net).__name__} runs in full float32: set "
            "torch.backends.cuda.matmul.allow_tf32 = False"
        )


def flax_leaves(net: nn.Module):
    """``(flax path, parameter)`` of every parameter of ``net``: the
    modules keep flax's names, so ``Dense_0.kernel`` is the path
    ``("Dense_0", "kernel")`` of the JAX package's parameter tree."""
    return [(tuple(name.split(".")), p) for name, p in net.named_parameters()]


class Dense(nn.Module):
    """One flax ``Dense`` layer: ``y = x @ kernel + bias``, x ``[N, in]``."""

    def __init__(self, d_in: int, d_out: int, device=None):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros((d_in, d_out), device=device))
        self.bias = nn.Parameter(torch.zeros((d_out,), device=device))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """flax's defaults: lecun_normal kernel (``truncated_normal``), zero
        bias."""
        std = (1.0 / self.kernel.shape[-2]) ** 0.5 / _TRUNCATED_NORMAL_STD
        with torch.no_grad():
            self.kernel.copy_(
                truncated_normal(self.kernel.shape, std, generator, device=self.kernel.device)
            )
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [N, in] -> [N, out] (``torch.addmm``)."""
        return torch.addmm(self.bias, x, self.kernel)


class BatchedDense(Dense):
    """One ``Dense`` layer per agent: ``y[a] = x[a] @ kernel[a] + bias[a]``."""

    def __init__(self, n_agents: int, d_in: int, d_out: int, device=None):
        nn.Module.__init__(self)
        self.kernel = nn.Parameter(torch.zeros((n_agents, d_in, d_out), device=device))
        self.bias = nn.Parameter(torch.zeros((n_agents, d_out), device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [A, N, in] -> [A, N, out] (``torch.baddbmm``)."""
        return torch.baddbmm(self.bias[:, None, :], x, self.kernel)


class _ThreeLayer(nn.Module):
    """Dense_0 (in -> hidden), Dense_1 (hidden -> hidden), Dense_2 (hidden ->
    1), per agent when ``n_agents`` is an integer, shared when None."""

    action_dim = 0  # inputs after the observation (1 for Q(s, a))

    def __init__(self, n_agents: Optional[int], hidden: int, obs_dim: int, device=None):
        super().__init__()
        d_in = obs_dim + self.action_dim
        dense = (
            (lambda i, o: Dense(i, o, device))
            if n_agents is None
            else (lambda i, o: BatchedDense(n_agents, i, o, device))
        )
        self.Dense_0 = dense(d_in, hidden)
        self.Dense_1 = dense(hidden, hidden)
        self.Dense_2 = dense(hidden, 1)

    @property
    def n_agents(self) -> Optional[int]:
        kernel = self.Dense_0.kernel
        return kernel.shape[0] if kernel.dim() == 3 else None

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for layer in (self.Dense_0, self.Dense_1, self.Dense_2):
            layer.reset_parameters(generator)

    def _layers(self, x: torch.Tensor) -> torch.Tensor:
        require_full_float32(x, self)
        x = torch.relu(self.Dense_0(x))
        x = torch.relu(self.Dense_1(x))
        return self.Dense_2(x)


class QNetwork(_ThreeLayer):
    """Q(s, a): ``forward(state, action) -> Q``, state ``[A, N, 4]`` and
    action ``[A, N, 1]`` per agent (-> ``[A, N, 1]``), or ``[N, 4]`` and
    ``[N, 1]`` shared (-> ``[N, 1]``)."""

    action_dim = 1

    def __init__(self, n_agents: Optional[int], hidden: int = 64, obs_dim: int = 4, device=None):
        super().__init__(n_agents, hidden, obs_dim, device)

    def forward(self, state: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
        return self._layers(torch.cat([state, action], dim=-1))


# DDPG's critic (the JAX package's ``Critic``, networks.py:45) is QNetwork's
# network: concat(state, action) -> 64 -> 64 -> 1.
Critic = QNetwork


class Actor(_ThreeLayer):
    """The deterministic policy (rl_backup.py:23-27): ``forward(state) ->
    sigmoid(...)``, the heat-pump fraction, state ``[A, N, 4]`` per agent (->
    ``[A, N, 1]``) or ``[N, 4]`` shared (-> ``[N, 1]``)."""

    def __init__(self, n_agents: Optional[int], hidden: int = 64, obs_dim: int = 4, device=None):
        super().__init__(n_agents, hidden, obs_dim, device)

    def forward(self, state: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(self._layers(state))


def adam(net: torch.nn.Module, lr: float) -> torch.optim.Adam:
    """optax.adam's defaults (b1=0.9, b2=0.999, eps=1e-8) over ``net``'s
    parameters. On the card it is ``capturable``: its step count lives on the
    device and every step is device work, so a CUDA graph can hold it
    (``parallel/graph.py``); its bias correction then rounds in float32 on
    the device rather than in double on the host. On the CPU the step count
    is a host number."""
    on_card = next(net.parameters()).is_cuda
    return torch.optim.Adam(
        net.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8, capturable=on_card
    )
