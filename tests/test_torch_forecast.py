"""The load/PV forecaster: the port against the JAX package on the CPU.

``make_windows`` equal; the forward pass on converted weights at
``rtol=1e-5``; one training epoch with the JAX epoch's own permutation
injected: the mean loss at ``rtol=1e-5`` and the parameters at
``rtol=1e-4``. One day of synthetic traces, the reference's widths and
batch 32 (two batches an epoch).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2pmicrogrid_tpu.config import ForecastConfig as JForecastConfig
from p2pmicrogrid_tpu.models import forecast as jfc
from p2pmicrogrid_tpu_torch.config import ForecastConfig
from p2pmicrogrid_tpu_torch.convert import network_from_tree
from p2pmicrogrid_tpu_torch.data.traces import synthetic_traces
from p2pmicrogrid_tpu_torch.models import forecast as tfc
from p2pmicrogrid_tpu_torch.models.networks import adam, flax_leaves


def _features():
    tr = synthetic_traces(n_days=1, start_day=11).normalized()
    return np.stack([tr.time, tr.t_out / 20.0, tr.load[:, 0], tr.pv[:, 0]], axis=1)


@pytest.fixture(scope="module")
def jax_epoch():
    """The JAX forecaster's init, one jitted epoch from it, and the epoch's
    permutation."""
    cfg = JForecastConfig()
    x, y = jfc.make_windows(_features(), cfg.input_width, cfg.label_width, cfg.shift)
    st0 = jfc.forecast_init(cfg, x.shape[-1], jax.random.PRNGKey(0))
    key = jax.random.PRNGKey(1)
    st1, loss = jax.jit(lambda s, k: jfc.forecast_train_epoch(cfg, s, jnp.asarray(x), jnp.asarray(y), k))(st0, key)
    return dict(
        x=x, y=y,
        params0=jax.tree.map(np.asarray, st0.params),
        params1=jax.tree.map(np.asarray, st1.params),
        loss=float(loss),
        perm=np.array(jax.random.permutation(key, x.shape[0])),
    )


def _port_state(params):
    model = network_from_tree(params, tfc.ForecastModel, torch.device("cpu"))
    return tfc.ForecastState(model, adam(model, ForecastConfig().learning_rate))


def test_make_windows_equal():
    data = _features()
    for w, l, s in ((3, 3, 3), (4, 2, 1)):
        got, ref = tfc.make_windows(data, w, l, s), jfc.make_windows(data, w, l, s)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)
    with pytest.raises(ValueError, match="at least"):
        tfc.make_windows(np.zeros((4, 2), np.float32), 3, 3, 3)


def test_forward_matches_flax(jax_epoch):
    cfg = JForecastConfig()
    x = jax_epoch["x"][:17]
    ref = jfc.forecast_predict(cfg, jfc.ForecastState(jax_epoch["params0"], None), jnp.asarray(x))
    state = _port_state(jax_epoch["params0"])
    got = tfc.forecast_predict(ForecastConfig(), state, torch.from_numpy(x))
    assert got.shape == (17, 3, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5)


def test_epoch_with_injected_permutation_matches_jax(jax_epoch):
    state = _port_state(jax_epoch["params0"])
    state, loss = tfc.forecast_train_epoch(
        ForecastConfig(), state, torch.from_numpy(jax_epoch["x"]), torch.from_numpy(jax_epoch["y"]),
        perm=torch.from_numpy(jax_epoch["perm"]),
    )
    np.testing.assert_allclose(float(loss), jax_epoch["loss"], rtol=1e-5)
    ref = dict(
        (jax.tree_util.keystr(p), v)
        for p, v in jax.tree_util.tree_leaves_with_path(jax_epoch["params1"])
    )
    for path, p in flax_leaves(state.params):
        key = "".join(f"['{k}']" for k in path)
        np.testing.assert_allclose(p.detach().numpy(), ref[key], rtol=1e-4, atol=1e-7, err_msg=key)


def test_train_forecaster_and_generator_epoch():
    """The training loop's history, and an epoch shuffled by a generator repeats
    under the same seed and needs a generator or a permutation."""
    cfg = ForecastConfig(epochs=2, batch_size=16, hidden_mid=16, lstm_features=16)
    x, y = tfc.make_windows(_features(), 3, 3, 3)
    state, history = tfc.train_forecaster(
        cfg, x, y, torch.Generator().manual_seed(0), val_inputs=x[:10], val_labels=y[:10], device="cpu"
    )
    assert len(history) == 2 and history[-1][1] is not None
    pred = tfc.forecast_predict(cfg, state, torch.from_numpy(x[:5]))
    assert pred.shape == (5, 3, 2) and float(pred.min()) >= 0.0 and float(pred.max()) <= 1.0
    again, _ = tfc.train_forecaster(cfg, x, y, torch.Generator().manual_seed(0), device="cpu")
    for (_, a), (_, b) in zip(flax_leaves(state.params), flax_leaves(again.params)):
        np.testing.assert_array_equal(a.detach().numpy(), b.detach().numpy())
    with pytest.raises(ValueError, match="generator or a permutation"):
        tfc.forecast_train_epoch(cfg, state, torch.from_numpy(x), torch.from_numpy(y))
