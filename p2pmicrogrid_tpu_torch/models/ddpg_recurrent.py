"""The recurrent (LSTM) DDPG: day-granular actor-critic over whole days.

The port of the JAX package's ``models/ddpg_recurrent.py`` (the reference's
rl_backup.py:14-62): an LSTM actor, Dense(20)-Dense(100), one LSTM(100)
applied TWICE with one weight set, Dense(20)-Dense(1, sigmoid); and an LSTM
critic on the same trunk whose Dense(20)-Dense(20)-Dense(1) head is summed
over the sequence, so Q values a whole day. Learning is day-granular TD(0)
with Polyak targets (``recurrent_ddpg_learn``).

Everything recurrent goes through ONE cell function, ``lstm_cell``: the
full-sequence modules loop it over T, the serving step
(``recurrent_actor_step``) calls it once a slot, and the trainer's rollout
(``train/recurrent.py``) calls the step. A step scanned from a zero carry
therefore runs the same arithmetic as the whole sequence. ``nn.LSTM`` and
cuDNN are not used: their packed gates and fused kernels would break that
tie.

The cell is flax's ``OptimizedLSTMCell`` in flax's layout: input kernels
``ii if ig io`` ``[in, H]`` without bias, hidden kernels ``hi hf hg ho``
``[H, H]`` with biases ``[H]``, gates concatenated ``[i|f|g|o]``; ``z =
(h @ Wh + bh) + x @ Wi``, ``c' = f*c + i*g``, ``h' = o*tanh(c')`` with
sigmoid on i, f, o and tanh on g. The modules keep flax's names
(``Dense_0`` ... and ``OptimizedLSTMCell_0.hf.bias``), so a JAX tree loads
in place (``convert.py``). The serving carry is one flat vector a agent,
``HIDDEN_LAYOUT`` = (pass1_c, pass1_h, pass2_c, pass2_h); zeros are a fresh
session. Every product runs in full float32 and refuses TF32 on the card.
"""

from __future__ import annotations

import copy
from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from p2pmicrogrid_tpu_torch.config import DDPGConfig
from p2pmicrogrid_tpu_torch.device import resolve_device
from p2pmicrogrid_tpu_torch.models.ddpg import OBS_DIM, polyak
from p2pmicrogrid_tpu_torch.models.networks import (
    _TRUNCATED_NORMAL_STD,
    Dense,
    adam,
    require_full_float32,
    truncated_normal,
)

GATES = ("i", "f", "g", "o")
HIDDEN_LAYOUT = ("pass1_c", "pass1_h", "pass2_c", "pass2_h")
HIDDEN_MULT = len(HIDDEN_LAYOUT)


class _Kernel(nn.Module):
    """One gate's flax ``DenseParams``: ``kernel`` [in, H], ``bias`` [H]
    where the gate has one (the hidden kernels)."""

    def __init__(self, d_in: int, d_out: int, bias: bool, device=None):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros((d_in, d_out), device=device))
        if bias:
            self.bias = nn.Parameter(torch.zeros((d_out,), device=device))


def _orthogonal(n: int, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """flax's ``initializers.orthogonal()`` for an [n, n] kernel: the Q of a
    standard-normal matrix's QR, its columns signed by R's diagonal. The
    factorisation runs in float64 and rounds once, so LAPACK builds that
    differ in their last bits still give the same float32 kernel."""
    a = torch.empty((n, n), device=device).normal_(generator=generator)
    q, r = torch.linalg.qr(a.double())
    return (q * torch.sign(torch.diagonal(r))).float()


class LSTMCell(nn.Module):
    """flax ``OptimizedLSTMCell``'s parameters: submodules ``ii``, ``if``,
    ``ig``, ``io`` (input kernels) and ``hi``, ``hf``, ``hg``, ``ho`` (hidden
    kernels and biases), named as flax names them."""

    def __init__(self, d_in: int, features: int, device=None):
        super().__init__()
        for g in GATES:
            self.add_module(f"i{g}", _Kernel(d_in, features, False, device))
            self.add_module(f"h{g}", _Kernel(features, features, True, device))

    @property
    def features(self) -> int:
        return self.hi.kernel.shape[-1]

    def gate(self, name: str) -> _Kernel:
        return getattr(self, name)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """flax's defaults in its creation order (gate by gate, the input
        kernel then the hidden one): lecun-normal input kernels, orthogonal
        hidden kernels, zero biases."""
        with torch.no_grad():
            for g in GATES:
                k = self.gate(f"i{g}").kernel
                std = (1.0 / k.shape[0]) ** 0.5 / _TRUNCATED_NORMAL_STD
                k.copy_(truncated_normal(k.shape, std, generator, device=k.device))
                h = self.gate(f"h{g}")
                h.kernel.copy_(_orthogonal(h.kernel.shape[0], generator, h.kernel.device))
                h.bias.zero_()

    def weights(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The gates concatenated ``[i|f|g|o]``, as flax's cell concatenates
        them: (input kernel [in, 4H], hidden kernel [H, 4H], bias [4H])."""
        return (
            torch.cat([self.gate(f"i{g}").kernel for g in GATES], dim=-1),
            torch.cat([self.gate(f"h{g}").kernel for g in GATES], dim=-1),
            torch.cat([self.gate(f"h{g}").bias for g in GATES], dim=-1),
        )


def lstm_cell(weights, c: torch.Tensor, h: torch.Tensor, x: torch.Tensor):
    """One step of flax's ``OptimizedLSTMCell`` on the carry ``(c, h)``
    [N, H] and the input ``x`` [N, in], with ``weights`` from
    ``LSTMCell.weights()``. Returns ``(c', h')``; ``h'`` is also the
    output."""
    wi, wh, bh = weights
    z = (h @ wh + bh) + x @ wi
    i, f, g, o = z.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return c, torch.sigmoid(o) * torch.tanh(c)


def _dense(layer: Dense, x: torch.Tensor) -> torch.Tensor:
    """A ``Dense`` over any leading axes."""
    return layer(x.reshape(-1, x.shape[-1])).reshape(x.shape[:-1] + (-1,))


def _lstm_pass(weights, x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.RNN`` over [B, T, in] from a zero carry: the outputs [B, T, H]."""
    B, T, _ = x.shape
    H = weights[1].shape[0]
    c = h = x.new_zeros((B, H))
    outs = []
    for t in range(T):
        c, h = lstm_cell(weights, c, h, x[:, t])
        outs.append(h)
    return torch.stack(outs, dim=1)


class _Recurrent(nn.Module):
    """The shared trunk: Dense_0, Dense_1, one LSTM cell applied twice, then
    the head's Dense layers (``n_post`` of width ``hidden_post``, then one
    of width ``n_out``)."""

    n_post = 1
    action_dim = 0  # inputs after the observation (1 for Q(s, a))

    def __init__(
        self,
        d_in: int,
        hidden_pre: int = 20,
        hidden_mid: int = 100,
        lstm_features: int = 100,
        hidden_post: int = 20,
        n_out: int = 1,
        device=None,
    ):
        super().__init__()
        # Weight sharing across the double pass needs the LSTM's input width
        # (hidden_mid on pass 1) to equal its output width (pass 2's input).
        if hidden_mid != lstm_features:
            raise ValueError("shared double-LSTM pass needs hidden_mid == lstm_features")
        self.Dense_0 = Dense(d_in, hidden_pre, device)
        self.Dense_1 = Dense(hidden_pre, hidden_mid, device)
        self.OptimizedLSTMCell_0 = LSTMCell(hidden_mid, lstm_features, device)
        widths = [lstm_features] + [hidden_post] * self.n_post + [n_out]
        for k in range(self.n_post + 1):
            self.add_module(f"Dense_{k + 2}", Dense(widths[k], widths[k + 1], device))

    @property
    def lstm_features(self) -> int:
        return self.OptimizedLSTMCell_0.features

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """flax's init in its creation order: Dense_0, Dense_1, the cell,
        then the head."""
        self.Dense_0.reset_parameters(generator)
        self.Dense_1.reset_parameters(generator)
        self.OptimizedLSTMCell_0.reset_parameters(generator)
        for k in range(self.n_post + 1):
            getattr(self, f"Dense_{k + 2}").reset_parameters(generator)

    def _trunk(self, x: torch.Tensor) -> torch.Tensor:
        """[B, T, d_in] -> the second LSTM pass's outputs [B, T, H]."""
        require_full_float32(x, self)
        h = torch.relu(_dense(self.Dense_0, x))
        h = torch.relu(_dense(self.Dense_1, h))
        weights = self.OptimizedLSTMCell_0.weights()
        return _lstm_pass(weights, _lstm_pass(weights, h))

    def _head(self, h: torch.Tensor) -> torch.Tensor:
        for k in range(self.n_post):
            h = torch.relu(_dense(getattr(self, f"Dense_{k + 2}"), h))
        return _dense(getattr(self, f"Dense_{self.n_post + 2}"), h)


class RecurrentActor(_Recurrent):
    """[B, T, obs] -> [B, T, 1] in [0, 1] (rl_backup.py:14-37)."""

    def __init__(self, obs_dim: int = OBS_DIM, device=None, **widths):
        super().__init__(obs_dim, device=device, **widths)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(self._head(self._trunk(x)))


class RecurrentCritic(_Recurrent):
    """[B, T, obs] x [B, T, 1] -> [B] day value (rl_backup.py:39-62: the
    head runs per step and is summed over the sequence)."""

    n_post = 2
    action_dim = 1

    def __init__(self, obs_dim: int = OBS_DIM, device=None, **widths):
        super().__init__(obs_dim + 1, device=device, **widths)

    def forward(self, state: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
        q = self._head(self._trunk(torch.cat([state, action], dim=-1)))
        return q.sum(dim=(-2, -1))


def actor_hidden_dim(lstm_features: int = 100) -> int:
    """Per-agent flat hidden width the serving carry needs."""
    return HIDDEN_MULT * lstm_features


def recurrent_actor_init_hidden(
    batch_shape: Tuple[int, ...], lstm_features: int = 100, device="cuda"
) -> torch.Tensor:
    """The fresh-session carry (zeros), ``batch_shape + (4 * H,)``."""
    shape = tuple(batch_shape) + (actor_hidden_dim(lstm_features),)
    return torch.zeros(shape, dtype=torch.float32, device=resolve_device(device))


def recurrent_actor_step(
    actor: RecurrentActor, obs: torch.Tensor, hidden: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One slot through the recurrent actor: obs [N, 4] and the flat carry
    [N, 4 * H] (``HIDDEN_LAYOUT``) -> (action [N], hidden' [N, 4 * H]). The
    per-step body of ``RecurrentActor.forward``: scanning it from a zero
    carry gives the whole sequence's actions."""
    require_full_float32(obs, actor)
    c1, h1, c2, h2 = hidden.chunk(HIDDEN_MULT, dim=-1)
    weights = actor.OptimizedLSTMCell_0.weights()
    x = torch.relu(actor.Dense_0(obs))
    x = torch.relu(actor.Dense_1(x))
    c1, h1 = lstm_cell(weights, c1, h1, x)
    c2, h2 = lstm_cell(weights, c2, h2, h1)
    action = torch.sigmoid(actor.Dense_3(torch.relu(actor.Dense_2(h2))))[:, 0]
    return action, torch.cat([c1, h1, c2, h2], dim=-1)


class RecurrentDDPGState(NamedTuple):
    """The recurrent learner: both networks, their Polyak targets and one
    ``torch.optim.Adam`` each (optax's moments and count in its state)."""

    actor: RecurrentActor
    critic: RecurrentCritic
    actor_target: RecurrentActor
    critic_target: RecurrentCritic
    actor_opt: torch.optim.Adam
    critic_opt: torch.optim.Adam


def recurrent_ddpg_init(
    cfg: DDPGConfig,
    generator: Optional[torch.Generator] = None,
    device="cuda",
) -> RecurrentDDPGState:
    """Fresh actor and critic (flax's default init, drawn from ``generator``
    on ``device``: the actor, then the critic), targets equal to them, fresh
    Adam at the config's rates."""
    dev = resolve_device(device)
    actor = RecurrentActor(device=dev)
    critic = RecurrentCritic(device=dev)
    actor.reset_parameters(generator)
    critic.reset_parameters(generator)
    return RecurrentDDPGState(
        actor=actor,
        critic=critic,
        actor_target=copy.deepcopy(actor).requires_grad_(False),
        critic_target=copy.deepcopy(critic).requires_grad_(False),
        actor_opt=adam(actor, cfg.actor_lr),
        critic_opt=adam(critic, cfg.critic_lr),
    )


@torch.no_grad()
def recurrent_ddpg_act(
    cfg: DDPGConfig,
    state: RecurrentDDPGState,
    obs_seq: torch.Tensor,
    ou_seq: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Day action sequence [B, T, 1]; with ``ou_seq`` ([B, T, 1] OU noise,
    rl_backup.py:65-85) added and clipped to [0, 1]."""
    a = state.actor(obs_seq)
    if ou_seq is not None:
        a = torch.clamp(a + ou_seq, 0.0, 1.0)
    return a


def recurrent_ddpg_learn(
    cfg: DDPGConfig,
    state: RecurrentDDPGState,
    obs_seq: torch.Tensor,
    act_seq: torch.Tensor,
    day_reward: torch.Tensor,
    next_obs_seq: torch.Tensor,
) -> Tuple[RecurrentDDPGState, torch.Tensor]:
    """One episodic DDPG step on a batch of day sequences, in place.

    obs_seq/next_obs_seq [B, T, 4]; act_seq [B, T, 1]; day_reward [B] (the
    day's summed reward). The critic regresses toward ``r_day + gamma *
    Q_target(next day, target policy)``; the actor ascends the updated
    critic; Polyak targets at ``cfg.tau``. Returns (state, critic loss, a
    0-dim tensor)."""
    with torch.no_grad():
        na = state.actor_target(next_obs_seq)
        q_tgt = day_reward + cfg.gamma * state.critic_target(next_obs_seq, na)
    loss = torch.mean(torch.square(q_tgt - state.critic(obs_seq, act_seq)))
    state.critic_opt.zero_grad(set_to_none=True)
    loss.backward()
    state.critic_opt.step()

    actor_params = list(state.actor.parameters())
    q_pi = state.critic(obs_seq, state.actor(obs_seq))
    grads = torch.autograd.grad(-q_pi.mean(), actor_params)
    for p, g in zip(actor_params, grads):
        p.grad = g
    state.actor_opt.step()

    polyak(cfg.tau, state.actor_target, state.actor)
    polyak(cfg.tau, state.critic_target, state.critic)
    return state, loss.detach()
