"""Load/PV forecasting model (reference: microgrid/ml.py).

The port of the JAX package's ``models/forecast.py``: a windowed LSTM
forecaster, Dense(20)-Dense(100), one LSTM(100) applied twice with one
weight set (ml.py:216-228), Dense(20)-Dense(2, sigmoid) predicting the
normalized (load, pv) for each window step; MSE loss, Adam 1e-4, windows
input_width = shift = label_width = 3 (ml.py:198-201).

The network is ``models/ddpg_recurrent.py``'s trunk and LSTM cell (the same
``lstm_cell``, flax's parameter names and layout), so a JAX tree converts
through ``convert.network_from_tree``. Windows are precomputed on the host
(``make_windows``, a numpy copy of the JAX package's); an epoch shuffles
with ``torch.randperm`` from the caller's generator, or takes an injected
permutation, and drops the trailing partial batch.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from p2pmicrogrid_tpu_torch.config import ForecastConfig
from p2pmicrogrid_tpu_torch.device import resolve_device
from p2pmicrogrid_tpu_torch.models.ddpg_recurrent import RecurrentActor
from p2pmicrogrid_tpu_torch.models.networks import adam


class ForecastModel(RecurrentActor):
    """[B, W, F] -> [B, W, n_targets] in [0, 1] (ml.py:209-229): the
    recurrent actor's network with F inputs and ``n_out`` targets."""


class ForecastState(NamedTuple):
    params: ForecastModel
    opt_state: torch.optim.Adam


def make_windows(
    data: np.ndarray,
    input_width: int,
    label_width: int,
    shift: int,
    label_columns: Optional[Tuple[int, ...]] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Sliding (input, label) windows (WindowGenerator.split_window,
    ml.py:119-147).

    data: [T, F] time-major features. Inputs take all F features over
    ``input_width`` steps; labels take ``label_columns`` (default: last 2,
    the load/pv pair, ml.py:253) over the last ``label_width`` steps of each
    ``input_width + shift`` window.

    Returns (inputs [N, input_width, F], labels [N, label_width, C]).
    """
    total = input_width + shift
    data = np.asarray(data, dtype=np.float32)
    T = data.shape[0]
    n = T - total + 1
    if n <= 0:
        raise ValueError(f"need at least {total} steps, have {T}")
    idx = np.arange(n)[:, None] + np.arange(total)[None, :]
    windows = data[idx]  # [N, total, F]
    inputs = windows[:, :input_width, :]
    labels = windows[:, total - label_width :, :]
    cols = label_columns if label_columns is not None else tuple(range(data.shape[1] - 2, data.shape[1]))
    labels = labels[:, :, list(cols)]
    return inputs, labels


def forecast_init(
    cfg: ForecastConfig,
    n_features: int,
    generator: Optional[torch.Generator] = None,
    device="cuda",
) -> ForecastState:
    """A fresh model (flax's default init, drawn from ``generator`` on
    ``device``) and a fresh Adam at ``cfg.learning_rate``."""
    model = ForecastModel(
        n_features, device=resolve_device(device),
        hidden_pre=cfg.hidden_pre, hidden_mid=cfg.hidden_mid,
        lstm_features=cfg.lstm_features, hidden_post=cfg.hidden_post,
        n_out=cfg.n_targets,
    )
    model.reset_parameters(generator)
    return ForecastState(params=model, opt_state=adam(model, cfg.learning_rate))


def forecast_train_epoch(
    cfg: ForecastConfig,
    state: ForecastState,
    inputs: torch.Tensor,
    labels: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    perm: Optional[torch.Tensor] = None,
) -> Tuple[ForecastState, torch.Tensor]:
    """One epoch of MSE/Adam steps (ml.py:242-284), in place.

    inputs [N, W, F], labels [N, W, C] on the model's device. The shuffle is
    ``perm`` ([N] indices) or ``torch.randperm(N)`` from ``generator``;
    batches of ``min(batch_size, N)``, the trailing partial batch dropped.
    Returns (state, the mean of the batch losses, a 0-dim tensor)."""
    n = inputs.shape[0]
    bs = min(cfg.batch_size, n)  # short traces: one smaller batch
    n_batches = n // bs
    if perm is None:
        if generator is None:
            raise ValueError("forecast_train_epoch needs a generator or a permutation")
        perm = torch.randperm(n, generator=generator, device=generator.device)
    perm = perm[: n_batches * bs].to(inputs.device)
    model, opt = state
    losses = []
    for b in range(n_batches):
        rows = perm[b * bs : (b + 1) * bs]
        loss = torch.mean(torch.square(model(inputs[rows]) - labels[rows]))
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    return state, torch.stack(losses).mean()


@torch.no_grad()
def forecast_predict(cfg: ForecastConfig, state: ForecastState, inputs: torch.Tensor) -> torch.Tensor:
    """Predictions [N, W, C] for windows [N, W, F]."""
    return state.params(inputs)


def train_forecaster(
    cfg: ForecastConfig,
    train_inputs: np.ndarray,
    train_labels: np.ndarray,
    generator: Optional[torch.Generator] = None,
    val_inputs: Optional[np.ndarray] = None,
    val_labels: Optional[np.ndarray] = None,
    verbose: bool = False,
    device="cuda",
):
    """The reference's training loop (ml.py:265-284): ``cfg.epochs``
    epochs, each shuffled by ``generator`` (a ``torch.Generator`` on
    ``device``, which also draws the init). Returns (state, history of
    (train mse, val mse or None)); one host read of each per epoch."""
    dev = resolve_device(device)
    to = lambda x: torch.as_tensor(np.asarray(x, dtype=np.float32)).to(dev)
    x, y = to(train_inputs), to(train_labels)
    state = forecast_init(cfg, x.shape[-1], generator, dev)
    history = []
    for epoch in range(cfg.epochs):
        state, loss = forecast_train_epoch(cfg, state, x, y, generator)
        train_l = float(loss)  # host-sync: one progress scalar per epoch
        val_l = None
        if val_inputs is not None:
            pred = forecast_predict(cfg, state, to(val_inputs))
            val_l = float(torch.mean(torch.square(pred - to(val_labels))))
        history.append((train_l, val_l))
        if verbose and epoch % 10 == 0:
            print(f"epoch {epoch}: train mse {train_l:.5f}"
                  + (f", val mse {val_l:.5f}" if val_l is not None else ""))
    return state, history
