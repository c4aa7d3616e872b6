"""The port's command line against the JAX package's (CPU, ``--device cpu``).

The port registers the JAX command line's subcommands it has ported, with
their options (flag names, ``dest``, default, type, choices, nargs, action;
``--device`` is the port's own); the same argv gives the same
configuration, config hash, setting and checkpoint directory; ``eval`` on a
tabular checkpoint writes the JAX package's ``test_results`` rows at the
golden tolerance; the JAX package's ``telemetry-query`` reads the port's
results file; the supervisor relaunches ``-m p2pmicrogrid_tpu_torch``;
nothing runs on the CPU unasked. Every ported subcommand runs here at a tiny
size (A <= 3, <= 2 episodes).
"""

import argparse
import contextlib
import functools
import io
import json
import os
import sqlite3
import subprocess
import sys
import threading
import time
import urllib.request
from unittest import mock

import jax
import numpy as np
import pytest
import torch
from test_torch_single_episode import jax_init_normals
from test_traces import _make_reference_fixture_db

import p2pmicrogrid_tpu_torch
from p2pmicrogrid_tpu_torch import cli as tcli

PORTED = {
    "train", "single", "multi", "eval", "baseline", "sweep", "forecast", "export-bundle",
    "train-recurrent", "serve-gateway", "serve-token", "telemetry-report", "telemetry-query",
    "continual", "promote", "regime-bench", "serve-bench", "serve-router", "autopilot",
}
NOT_PORTED = {"bench", "analyse"}
PORT_ONLY_OPTIONS = {"--device"}
# Defaults the port sets apart: the autopilot's engines default to the card
# (``auto`` follows ``--device``) where the JAX package defaults to the CPU.
PORT_DEFAULTS = {("autopilot", ("--serve-device",)): "auto"}
# Subcommands that run no model and so take no ``--device``.
NO_DEVICE = ("serve-token", "telemetry-report", "telemetry-query", "serve-router")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(p2pmicrogrid_tpu_torch.__file__)))

_parse_args = argparse.ArgumentParser.parse_args


class _Captured(Exception):
    pass


def _parser(main):
    """The top-level parser ``main`` builds, caught at its ``parse_args``."""
    box = []

    def capture(self, args=None, namespace=None):
        box.append(self)
        raise _Captured

    with mock.patch.object(argparse.ArgumentParser, "parse_args", capture):
        with pytest.raises(_Captured):
            main([])
    return box[0]


@functools.lru_cache(maxsize=None)
def _parsers():
    from p2pmicrogrid_tpu import cli as jcli

    return _parser(jcli.main), _parser(tcli.main)


def _subparsers(parser):
    (action,) = [a for a in parser._actions if isinstance(a, argparse._SubParsersAction)]
    return action.choices


def _options(sub):
    out = {}
    for a in sub._actions:
        if isinstance(a, argparse._HelpAction) or PORT_ONLY_OPTIONS & set(a.option_strings):
            continue
        out[tuple(a.option_strings) or (a.dest,)] = {
            "dest": a.dest,
            "default": a.default,
            "type": getattr(a.type, "__name__", a.type),
            "choices": None if a.choices is None else list(a.choices),
            "nargs": a.nargs,
            "action": type(a).__name__,
            "required": a.required,
            "const": a.const,
        }
    return out, {k: v for k, v in sub._defaults.items() if k != "fn"}


def test_the_ported_subcommands():
    jax_parser, port_parser = _parsers()
    port_subs, jax_subs = set(_subparsers(port_parser)), set(_subparsers(jax_parser))
    assert port_subs == PORTED and len(port_subs) == 19
    assert jax_subs - port_subs == NOT_PORTED


@pytest.mark.parametrize("name", sorted(PORTED))
def test_options_are_the_jax_command_lines(name):
    jax_parser, port_parser = _parsers()
    ref = _options(_subparsers(jax_parser)[name])
    got = _options(_subparsers(port_parser)[name])
    for (sub, option), default in PORT_DEFAULTS.items():
        if sub == name:
            ref[0][option]["default"] = default
    assert got == ref
    has_device = any("--device" in a.option_strings for a in _subparsers(port_parser)[name]._actions)
    assert has_device == (name not in NO_DEVICE)


ARGVS = [
    ["train", "--agents", "1000", "--scenarios", "128", "--shared", "--share-agents",
     "--chunks", "8", "--implementation", "ddpg", "--episodes", "2", "--health-every", "1"],
    ["train", "--agents", "2", "--battery", "--rounds", "2", "--homogeneous", "--save-episodes", "5"],
    ["train", "--scenarios", "4", "--implementation", "dqn", "--no-trading", "--jit-block", "2",
     "--market-impl", "matrix", "--market-dtype", "float32"],
    ["train", "--scenarios", "4", "--shared", "--implementation", "ddpg", "--actor-lr", "3e-4",
     "--learn-batch-cap", "0"],
    ["eval", "--agents", "3", "--scenarios", "2", "--shared", "--chunks", "2", "--test"],
    ["export-bundle", "--implementation", "ddpg_recurrent", "--agents", "2"],
    ["train-recurrent", "--agents", "2", "--seed", "3"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: "-".join(a[:3]))
def test_same_argv_same_configuration(argv):
    from p2pmicrogrid_tpu import cli as jcli
    from p2pmicrogrid_tpu.telemetry import config_hash as j_hash
    from p2pmicrogrid_tpu.train.checkpoint import checkpoint_dir as j_ckpt
    from p2pmicrogrid_tpu_torch.telemetry import config_hash as t_hash
    from p2pmicrogrid_tpu_torch.train.checkpoint import checkpoint_dir as t_ckpt

    jax_parser, port_parser = _parsers()
    jargs, targs = _parse_args(jax_parser, argv), _parse_args(port_parser, argv)
    jc, tc = jcli._build_cfg(jargs), tcli._build_cfg(targs)
    assert repr(tc) == repr(jc)
    assert t_hash(tc) == j_hash(jc)
    setting = tcli._train_setting(targs, tc)
    assert setting == jcli._train_setting(jargs, jc)
    impl = tc.train.implementation
    assert t_ckpt("m", setting, impl) == j_ckpt("m", setting, impl)
    assert tcli._persist_setting(targs, tc) == jcli._persist_setting(jargs, jc)


# --- running the commands -----------------------------------------------------


def _run(argv):
    """``main(argv)``'s return code and standard output."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = tcli.main(argv)
    return rc, buf.getvalue()


def _telemetry_env(root):
    """Telemetry on (the test session turns it off), its run directories
    under ``root``."""
    return {"P2P_TELEMETRY": "1", "P2P_TELEMETRY_DIR": str(root / "runs")}


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """``train`` then ``eval --test`` at A=2 on the CPU, into one results
    file, from a measurement database of the reference's schema with two
    training days, a validation day and a test day (``--db``)."""
    root = tmp_path_factory.mktemp("cli")
    _make_reference_fixture_db(str(root / "measurements.db"))
    env = mock.patch.dict(os.environ, _telemetry_env(root))
    common = ["--agents", "2", "--device", "cpu", "--model-dir", str(root / "m"),
              "--results-db", str(root / "r.db"), "--db", str(root / "measurements.db")]
    with env:
        rc, out = _run(["train", "--episodes", "2", *common])
        assert rc == 0 and "trained 2 episodes" in out
        rc, out = _run(["eval", "--test", "--episodes", "2", *common])
        assert rc == 0 and "results ->" in out
    return root, common


def _query(main, db):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(["telemetry-query", "--results-db", db, "--gauges"]) == 0
    return [json.loads(line) for line in buf.getvalue().splitlines()]


def test_jax_telemetry_query_reads_the_ports_file(trained):
    """The JAX package's ``telemetry-query --gauges`` over the port's train
    and eval prints the port's rows: the run joined to the eval anchor on
    config_hash."""
    from p2pmicrogrid_tpu import cli as jcli

    root, _ = trained
    db = str(root / "r.db")
    port_rows, jax_rows = _query(tcli.main, db), _query(jcli.main, db)
    assert jax_rows == port_rows
    (row,) = port_rows
    assert row["telemetry_setting"] == row["eval_setting"] == "2-multi-agent-com-rounds-1-hetero"
    assert row["is_testing"] == 1 and row["n_days"] == 1
    assert row["backend"] == "cpu" and "train.env_steps_per_sec" in row["gauges"]
    con = sqlite3.connect(db)
    try:
        (n,) = con.execute("SELECT COUNT(*) FROM test_results").fetchone()
        (n_progress,) = con.execute("SELECT COUNT(*) FROM training_progress").fetchone()
    finally:
        con.close()
    assert n == 96 * 2 and n_progress == 1  # episode 0 of the decay window


def test_eval_writes_the_jax_packages_test_results(tmp_path, monkeypatch):
    """``eval --test`` on a tabular checkpoint holding the JAX package's
    Q-table (carried by ``convert.py``) writes the ``test_results`` and
    ``rounds_comparison`` rows of JAX ``evaluate_community`` plus
    ``save_eval_outputs`` at the golden tolerance. The initial temperatures
    are the JAX key chain's, injected (the port draws from a generator)."""
    import p2pmicrogrid_tpu_torch.train as ttrain
    from p2pmicrogrid_tpu import cli as jcli
    from p2pmicrogrid_tpu.data import ResultsStore as JStore
    from p2pmicrogrid_tpu.data import save_eval_outputs as j_save
    from p2pmicrogrid_tpu.envs import make_ratings as j_ratings
    from p2pmicrogrid_tpu.telemetry import config_hash as j_hash
    from p2pmicrogrid_tpu.train import evaluate_community as j_eval
    from p2pmicrogrid_tpu.train import init_policy_state as j_init
    from p2pmicrogrid_tpu.train import make_policy as j_policy
    from p2pmicrogrid_tpu_torch.convert import state_from_jax
    from p2pmicrogrid_tpu_torch.train.checkpoint import checkpoint_dir, save_checkpoint

    A, seed = 2, 42
    jax_argv = ["eval", "--agents", str(A), "--test", "--model-dir", str(tmp_path / "m")]
    argv = jax_argv + ["--device", "cpu", "--results-db", str(tmp_path / "port.db")]
    jax_parser, port_parser = _parsers()
    cfg_j = jcli._build_cfg(_parse_args(jax_parser, jax_argv))
    cfg_t = tcli._build_cfg(_parse_args(port_parser, argv))
    ps_j = j_init(cfg_j, jax.random.PRNGKey(0))
    q = np.random.default_rng(5).standard_normal(ps_j.q_table.shape, dtype=np.float32)
    ps_j = ps_j._replace(q_table=jax.numpy.asarray(q))
    save_checkpoint(
        checkpoint_dir(str(tmp_path / "m"), cfg_t.setting, "tabular"),
        state_from_jax(jax.tree.map(np.asarray, ps_j), "cpu"), 7, cfg=cfg_t,
    )

    _, _, test_traces = jcli._load_traces(_parse_args(jax_parser, jax_argv))
    rng = np.random.default_rng(seed)
    ratings = j_ratings(cfg_j, rng)
    key = jax.random.PRNGKey(seed)
    days, outputs, day_arrays = j_eval(cfg_j, j_policy(cfg_j), ps_j, test_traces, ratings, key, rng=rng)
    with JStore(str(tmp_path / "jax.db")) as store:
        j_save(store, cfg_j.setting, "tabular", True, days, outputs, day_arrays,
               config_hash=j_hash(cfg_j), git_rev=None)

    normals = torch.stack([jax_init_normals(jax.random.split(k)[0], A)
                           for k in jax.random.split(key, len(days))])
    real = ttrain.evaluate_community
    monkeypatch.setattr(ttrain, "evaluate_community",
                        lambda *a, **kw: real(*a, **{**kw, "normals": normals}))
    rc, out = _run(argv)
    assert rc == 0 and "restored" in out and "at episode 7" in out

    def rows(name, table):
        con = sqlite3.connect(str(tmp_path / name))
        try:
            return con.execute(f"SELECT * FROM {table} ORDER BY 1, 2, 3, 4, 5").fetchall()
        finally:
            con.close()

    for table, n_keys in (("test_results", 5), ("rounds_comparison", 5)):
        ref, got = rows("jax.db", table), rows("port.db", table)
        assert len(got) == len(ref) > 0
        assert [r[:n_keys] for r in got] == [r[:n_keys] for r in ref]
        np.testing.assert_allclose(
            np.array([r[n_keys:] for r in got], float), np.array([r[n_keys:] for r in ref], float),
            rtol=2e-4, atol=1e-5, err_msg=table,
        )
    (ref,), (got,) = rows("jax.db", "eval_runs"), rows("port.db", "eval_runs")
    assert got[:4] == ref[:4]  # setting, implementation, is_testing, config_hash
    np.testing.assert_allclose(got[6], ref[6], rtol=2e-4)


def test_supervisor_relaunches_the_ports_command_line(tmp_path):
    from p2pmicrogrid_tpu_torch.train import resilience

    seen = []

    def fake_supervise(child_argv, **kw):
        seen.append(list(child_argv))
        return resilience.SuperviseResult(exit_code=0)

    argv = ["train", "--agents", "2", "--episodes", "1", "--device", "cpu", "--supervise",
            "--max-restarts", "2", "--model-dir", str(tmp_path / "m")]
    with mock.patch.object(resilience, "supervise", fake_supervise):
        rc, out = _run(argv)
    assert rc == 0
    (child,) = seen
    assert child[:3] == [sys.executable, "-m", "p2pmicrogrid_tpu_torch"]
    assert child[3:] == ["train", "--agents", "2", "--episodes", "1", "--device", "cpu",
                         "--model-dir", str(tmp_path / "m")]
    assert json.loads(out.splitlines()[-1])["metric"] == "train_supervised"


def test_no_silent_cpu_run(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["train", "--agents", "2", "--episodes", "1"],
                 ["eval", "--agents", "2", "--device", "default"],
                 ["serve-gateway", "--serve-device", "auto"]):
        with pytest.raises(SystemExit, match="device='cpu'") as err:
            tcli.main(argv + ["--model-dir", str(tmp_path)])
        assert err.value.code not in (0, None)
    with pytest.raises(SystemExit, match="item 8"):
        tcli.main(["train", "--device", "auto"])
    with pytest.raises(SystemExit, match="item 15"):
        tcli.main(["eval", "--device", "cpu", "--figures-dir", str(tmp_path / "f")])
    with pytest.raises(SystemExit, match="item 15"):
        tcli.main(["forecast", "--device", "cpu", "--figures-dir", str(tmp_path / "f")])
    assert not (tmp_path / "f").exists()


def test_module_entry_exits_non_zero_without_a_card():
    """``python -m p2pmicrogrid_tpu_torch train`` on this CPU-only machine:
    the message of ``resolve_device`` and a non-zero exit, nothing trained."""
    proc = subprocess.run(
        [sys.executable, "-m", "p2pmicrogrid_tpu_torch", "train", "--agents", "2",
         "--episodes", "1", "--model-dir", "unused-models"],
        capture_output=True, text=True, timeout=120, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES=""),
    )
    assert proc.returncode != 0
    assert "device='cpu'" in proc.stderr and "trained" not in proc.stdout
    assert not os.path.exists(os.path.join(REPO, "unused-models"))


def test_small_commands_run(trained, tmp_path):
    """``baseline``, ``single``, ``multi`` and its ``eval``, ``sweep``,
    ``telemetry-report`` and ``serve-token`` at A <= 2."""
    root, common = trained
    with mock.patch.dict(os.environ, _telemetry_env(root)):
        rc, out = _run(["baseline", "--test", *common])
        assert rc == 0 and out.count("rule-based community cost") == 1
        m = ["--device", "cpu", "--model-dir", str(tmp_path / "m"), *common[-2:]]
        rc, out = _run(["single", "--episodes", "1", *m])
        summary = json.loads(out.splitlines()[-1])
        assert rc == 0 and summary["days"] == [18] and np.isfinite(summary["rl_cost_eur"])
        rc, out = _run(["multi", "--communities", "2", "--agents", "2", "--episodes", "1",
                        "--results-db", str(root / "r.db"), *m])
        assert rc == 0 and "x 2 communities" in out
        rc, out = _run(["eval", "--communities", "2", "--agents", "2", "--episodes", "1", "--test",
                        "--results-db", str(root / "r.db"), *m])
        assert rc == 0 and out.count("community costs c0:") == 1
        rc, out = _run(["sweep", "--agents", "1", "--episodes", "1", "--actor-lrs", "1e-4",
                        "--results-db", str(root / "r.db"), *m])
        assert rc == 0 and "trial 0 ddpg-lr0.0001" in out
        rc, out = _run(["telemetry-report", "--runs-root", str(root / "runs")])
        assert rc == 0 and "manifest" in out and "config_hash" in out
        secret = str(tmp_path / "secret")
        assert _run(["serve-token", "--new-secret", secret])[0] == 0
        rc, token = _run(["serve-token", "--secret-file", secret, "--household", "h1"])
        rc, out = _run(["serve-token", "--secret-file", secret, "--verify", token.strip()])
        assert rc == 0 and json.loads(out)["household"] == "h1"
    con = sqlite3.connect(str(root / "r.db"))
    try:
        settings = {s for (s,) in con.execute("SELECT setting FROM eval_runs")}
        (n_sweep,) = con.execute("SELECT COUNT(*) FROM hyperparameters_single_day").fetchone()
    finally:
        con.close()
    assert {"multi-2x2-rounds-1-c0", "multi-2x2-rounds-1-c1"} <= settings and n_sweep >= 1


def test_chunked_shared_ddpg_export_and_gateway(tmp_path):
    """The north star's command at A=3, S=2, K=2 (health eval every episode
    streaming into the warehouse), its ``eval`` and ``export-bundle``, then
    ``serve-gateway`` answering requests into the same results file."""
    db = str(tmp_path / "r.db")
    flags = ["--agents", "3", "--scenarios", "2", "--shared", "--share-agents", "--chunks", "2",
             "--implementation", "ddpg", "--episodes", "2", "--device", "cpu",
             "--model-dir", str(tmp_path / "m")]
    with mock.patch.dict(os.environ, _telemetry_env(tmp_path)):
        rc, out = _run(["train", "--health-every", "1", "--results-db", db, *flags])
        assert rc == 0 and out.count("health episode") == 3 and "x 4 scenarios" in out
        rc, out = _run(["eval", "--test", "--results-db", db, *flags])
        assert rc == 0 and out.count("community cost") == 5
        bundle = str(tmp_path / "b")
        rc, out = _run(["export-bundle", "--out", bundle, *flags])
        assert rc == 0 and "bundle -> " in out
    con = sqlite3.connect(db)
    try:
        runs = con.execute("SELECT run_id, config_hash FROM telemetry_runs").fetchall()
        (anchor,) = con.execute("SELECT config_hash FROM eval_runs").fetchone()
        (n_health,) = con.execute("SELECT COUNT(*) FROM training_health").fetchone()
    finally:
        con.close()
    assert [h for r, h in runs if r.startswith("train-chunked")] == [anchor] and n_health == 3

    buf = io.StringIO()
    argv = ["serve-gateway", "--bundle", bundle, "--port", "0", "--device", "cpu",
            "--results-db", db, "--serve-seconds", "6", "--max-batch", "4"]
    with contextlib.redirect_stdout(buf):
        worker = threading.Thread(target=tcli.main, args=(argv,), daemon=True)
        worker.start()
        deadline = time.time() + 60
        while "gateway_listening" not in buf.getvalue() and time.time() < deadline:
            time.sleep(0.05)
    listening = json.loads(buf.getvalue().splitlines()[0])
    assert listening["device"] == "cpu"
    obs = [[0.3, -0.2, 0.5, 0.1]] * 3
    for i in range(3):
        req = urllib.request.Request(
            f"http://{listening['host']}:{listening['port']}/v1/act",
            data=json.dumps({"household": f"h{i}", "obs": obs}).encode(), method="POST",
        )
        with urllib.request.urlopen(req, timeout=30) as resp:
            assert len(json.loads(resp.read())["actions"]) == 3
    worker.join(timeout=60)
    assert not worker.is_alive()
    con = sqlite3.connect(db)
    try:
        (n,) = con.execute(
            "SELECT COUNT(*) FROM telemetry_points p JOIN telemetry_runs r USING (run_id) "
            "WHERE p.kind = 'serve_request' AND r.config_hash = ?", (listening["default"],),
        ).fetchone()
    finally:
        con.close()
    assert n == 3


def test_forecast_and_recurrent_commands(tmp_path):
    m = ["--device", "cpu", "--model-dir", str(tmp_path / "m")]
    rc, out = _run(["forecast", "--epochs", "1", "--results-db", str(tmp_path / "r.db"), *m])
    assert rc == 0 and "validation mse" in out
    rc, out = _run(["train-recurrent", "--agents", "2", "--episodes", "2", *m])
    row = json.loads(out.splitlines()[-1])
    assert rc == 0 and row["metric"] == "train_recurrent" and row["episodes"] == 2
    rc, out = _run(["export-bundle", "--implementation", "ddpg_recurrent", "--agents", "2",
                    "--out", str(tmp_path / "rb"), *m])
    assert rc == 0 and "(ddpg_recurrent," in out
