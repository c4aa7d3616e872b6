"""Policy bundles cross between the JAX package and the port, both ways.

The port's ``serve/export.py`` writes the JAX package's format: a bundle the
JAX package exports serves in the port's ``PolicyEngine`` and one the port
exports serves in the JAX package's, with equal discrete actions and DDPG
within rtol=1e-6 (tests/test_serve.py's tolerance for the continuous
actor); the float16 and int8 encodings (scales, repaired int tables, the
error-bound block) equal the JAX export of the same state bit for bit,
``config_hash`` agrees and ``check_bundle_dir`` passes. The JAX package's
engines run on the CPU at one bucket each, so as few programs compile as
possible.
"""

import json
import os
import sys
import warnings

import jax
import numpy as np
import pytest

from p2pmicrogrid_tpu import config as jcfg
from p2pmicrogrid_tpu.models.ddpg import ddpg_params_init as jax_ddpg_params_init
from p2pmicrogrid_tpu.serve import PolicyEngine as JaxEngine
from p2pmicrogrid_tpu.serve import export_policy_bundle as jax_export
from p2pmicrogrid_tpu.train import init_policy_state as jax_init_policy_state

from p2pmicrogrid_tpu_torch import config as tc
from p2pmicrogrid_tpu_torch.convert import state_from_jax
from p2pmicrogrid_tpu_torch.serve import (
    PolicyEngine,
    calibration_obs,
    export_bundle_from_checkpoint,
    export_policy_bundle,
    greedy_params,
    load_policy_bundle,
)
from p2pmicrogrid_tpu_torch.train.checkpoint import restore_raw, save_checkpoint

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "tools"))
from check_artifacts_schema import check_bundle_dir  # noqa: E402

A = 3
B = 4  # one padding bucket
CASES = ["tabular", "dqn", "ddpg_per_agent", "ddpg_shared"]


def _cfgs(case):
    impl = case.split("_")[0]
    kw = dict(
        sim=dict(n_agents=A),
        train=dict(implementation=impl),
        dqn=dict(hidden=8, buffer_size=16, batch_size=2),
        ddpg=dict(actor_hidden=8, critic_hidden=8, buffer_size=16, batch_size=2,
                  share_across_agents=case == "ddpg_shared"),
    )

    def build(mod):
        return mod.default_config(
            sim=mod.SimConfig(**kw["sim"]),
            train=mod.TrainConfig(**kw["train"]),
            dqn=mod.DQNConfig(**kw["dqn"]),
            ddpg=mod.DDPGConfig(**kw["ddpg"]),
        )

    return build(jcfg), build(tc)


def _states(case, decisive=True):
    """(cfg, JAX state, the port's state of the same values). The Q-table is
    drawn by numpy; DQN's action-input row is scaled so that int8 weight
    noise cannot flip an argmax (``decisive``), as tests/test_quantized.py
    does."""
    jc, pc = _cfgs(case)
    key = jax.random.PRNGKey(0)
    if case == "ddpg_shared":
        js = jax_ddpg_params_init(jc.ddpg, A, key)
    else:
        js = jax_init_policy_state(jc, key)
    if case == "tabular":
        q = np.random.default_rng(1).standard_normal(js.q_table.shape).astype(np.float32)
        js = js._replace(q_table=q)
    if case == "dqn" and decisive:
        k = np.asarray(js.online["Dense_0"]["kernel"]).copy()
        k[:, -1, :] *= 20.0
        js = js._replace(online=dict(js.online, Dense_0=dict(js.online["Dense_0"], kernel=k)))
    np_state = jax.tree.map(np.asarray, js)
    sub = {"dqn": pc.dqn, "ddpg": pc.ddpg}.get(case.split("_")[0])
    return jc, pc, js, state_from_jax(np_state, "cpu", cfg=sub)


def _close(case, got, want):
    if case.startswith("ddpg"):
        np.testing.assert_allclose(got, want, rtol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)


def _npz(bundle):
    with np.load(os.path.join(bundle, "params.npz")) as z:
        return {k: z[k] for k in z.files}


def _manifest(bundle):
    with open(os.path.join(bundle, "manifest.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("case", CASES)
def test_jax_bundle_serves_in_port(case, tmp_path):
    jc, _, js, _ = _states(case)
    bundle = jax_export(jc, js, str(tmp_path / "jax"))
    obs = calibration_obs(B, A, seed=5)
    want = JaxEngine(bundle_dir=bundle, max_batch=B, device="default").act(obs)
    got = PolicyEngine(bundle_dir=bundle, max_batch=B, device="cpu").act(obs)
    assert got.dtype == np.float32 and got.shape == (B, A)
    _close(case, got, want)


@pytest.mark.parametrize("case", CASES)
def test_port_bundle_serves_in_jax(case, tmp_path):
    """The port's f32 export of the same state: the JAX package's engine
    serves it as the port's does; params, manifest fields and config_hash
    equal the JAX export's; the schema check passes."""
    jc, pc, js, ps = _states(case)
    mine = export_policy_bundle(pc, ps, str(tmp_path / "port"), device="cpu")
    theirs = jax_export(jc, js, str(tmp_path / "jax"))
    problems = []
    check_bundle_dir(mine, problems)
    assert problems == []
    m, t = _manifest(mine), _manifest(theirs)
    for key in ("config_hash", "implementation", "n_agents", "setting", "dtype", "obs_spec",
                "action_spec", "model", "param_count", "param_bytes", "format_version"):
        assert m[key] == t[key], key
    got, want = _npz(mine), _npz(theirs)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    obs = calibration_obs(B, A, seed=6)
    jax_act = JaxEngine(bundle_dir=mine, max_batch=B, device="default").act(obs)
    _close(case, PolicyEngine(bundle_dir=mine, max_batch=B, device="cpu").act(obs), jax_act)


def _comparable_bound(bound):
    """The error-bound block without the measured continuous-action
    numbers, which go through each package's forward (XLA's and torch's
    sums differ by an ulp or so)."""
    return {k: v for k, v in bound.items() if k not in ("max_ulp", "max_abs_action_err")}


@pytest.mark.parametrize("dtype", ["float16", "int8"])
@pytest.mark.parametrize("case", CASES)
def test_quantized_export_equals_jax(case, dtype, tmp_path):
    jc, pc, js, ps = _states(case)
    mine = export_policy_bundle(pc, ps, str(tmp_path / "port"), dtype=dtype, device="cpu")
    theirs = jax_export(jc, js, str(tmp_path / "jax"), dtype=dtype)
    got, want = _npz(mine), _npz(theirs)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    m, t = _manifest(mine), _manifest(theirs)
    assert m["config_hash"] == t["config_hash"] and m["param_bytes"] == t["param_bytes"]
    problems = []
    check_bundle_dir(mine, problems)
    assert problems == []
    if dtype == "int8":
        assert m["quant"]["scales"] == t["quant"]["scales"]
        mb, tb = m["quant"]["error_bound"], t["quant"]["error_bound"]
        assert _comparable_bound(mb) == _comparable_bound(tb)
        if case == "tabular":
            assert mb["rows_repaired"] > 0
        if case.startswith("ddpg"):
            # Each package's f32 and int8 actions move by at most an ulp or
            # two against the other's: 16 ulps of slack out of ~1e4.
            assert abs(mb["max_ulp"] - tb["max_ulp"]) <= 16
            np.testing.assert_allclose(mb["max_abs_action_err"], tb["max_abs_action_err"],
                                       rtol=1e-3, atol=1e-7)
    obs = calibration_obs(B, A, seed=7)
    jax_act = JaxEngine(bundle_dir=theirs, max_batch=B, device="default").act(obs)
    _close(case, PolicyEngine(bundle_dir=mine, max_batch=B, device="cpu").act(obs), jax_act)


def test_int8_dqn_refusal_matches_jax(tmp_path):
    """A fresh-init DQN has near-tied actions on the calibration capture:
    both packages refuse its int8 export, with the same flip count."""
    jc, pc, js, ps = _states("dqn", decisive=False)
    with pytest.raises(ValueError, match="flipped") as theirs:
        jax_export(jc, js, str(tmp_path / "jax"), dtype="int8")
    with pytest.raises(ValueError, match="flipped") as mine:
        export_policy_bundle(pc, ps, str(tmp_path / "port"), dtype="int8", device="cpu")
    count = lambda err: str(err.value).split(":")[1].split()[0]  # noqa: E731
    assert count(mine) == count(theirs) and int(count(mine)) > 0


@pytest.mark.parametrize("case", ["tabular", "dqn", "ddpg_shared"])
def test_export_from_port_checkpoint(case, tmp_path):
    """``export_bundle_from_checkpoint`` reads a port checkpoint
    structure-free (``restore_raw``) and writes the bundle the live state
    gives; a corrupt newest step is skipped with a warning."""
    _, pc, _, ps = _states(case)
    ckpt = str(tmp_path / "ckpt")
    save_checkpoint(ckpt, ps, episode=3, keep_last=3)
    save_checkpoint(ckpt, ps, episode=7, keep_last=3)
    raw, episode, step = restore_raw(ckpt)
    assert episode == 7 and step.endswith("ep_7")
    impl = pc.train.implementation
    assert set(greedy_params(impl, raw)) <= {"q_table", "Dense_0", "Dense_1", "Dense_2"}
    with open(os.path.join(step, "payload.npz"), "r+b") as f:
        f.seek(64)
        f.write(b"\0" * 64)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        bundle = export_bundle_from_checkpoint(pc, ckpt, str(tmp_path / "b"), device="cpu")
    assert any("corrupt" in str(w.message) for w in caught)
    manifest, _ = load_policy_bundle(bundle)
    assert manifest["source"]["episode"] == 3
    live = export_policy_bundle(pc, ps, str(tmp_path / "live"), device="cpu")
    got, want = _npz(bundle), _npz(live)
    assert sorted(got) == sorted(want)
    assert all(np.array_equal(got[k], want[k]) for k in want)


def test_restore_raw_without_steps_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        restore_raw(str(tmp_path / "none"))
