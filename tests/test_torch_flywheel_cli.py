"""The flywheel's commands of the port's command line, at A=3 on the CPU.

``continual`` turns a warehouse that the port's gateway wrote into a
candidate bundle (one ``continual_result`` row), ``promote`` gates and
canaries a candidate (``--gate-only`` and the full pipeline), and
``regime-bench`` runs the regime harness to its headline; without a card
and without ``--device cpu`` each exits non-zero naming the fix, and
``--device auto`` names ROADMAP item 8.
"""

import json

import numpy as np
import pytest
import torch

from p2pmicrogrid_tpu_torch import cli as tcli
from p2pmicrogrid_tpu_torch.serve.export import load_policy_bundle
from p2pmicrogrid_tpu_torch.serve.gateway import AdmissionConfig, GatewayServer, build_gateway
from p2pmicrogrid_tpu_torch.serve.loadgen import synthetic_obs
from p2pmicrogrid_tpu_torch.serve.promotion import _drive_wire_stage, make_crafted_bundle

A = 3
COMMON = ["--agents", "3", "--implementation", "tabular", "--seed", "0", "--device", "cpu"]


def _rows(capfd):
    return [json.loads(line) for line in capfd.readouterr().out.splitlines() if line.startswith("{")]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Crafted incumbent and good bundles, and a warehouse of the
    incumbent's decisions (32 requests from 8 households)."""
    import dataclasses

    root = tmp_path_factory.mktemp("flywheel")
    cfg = _cfg()
    inc = make_crafted_bundle(cfg, "incumbent", str(root / "inc"), device="cpu")
    good_cfg = cfg.replace(train=dataclasses.replace(cfg.train, starting_episodes=101))
    good = make_crafted_bundle(good_cfg, "good", str(root / "good"), device="cpu")
    db = str(root / "wh.db")
    gateway = build_gateway([inc], max_batch=8, device="cpu", results_db=db,
                            admission=AdmissionConfig(max_queue_depth=1 << 16, wait_budget_ms=1e9))
    server = GatewayServer(gateway)
    host, port = server.start()
    try:
        traffic = _drive_wire_stage(host, port, synthetic_obs(32, A, seed=2),
                                    [f"house-{i}" for i in range(8)])
        assert (traffic.statuses == 200).all()
    finally:
        server.stop()
    return root, inc, good, db


def _cfg():
    from p2pmicrogrid_tpu_torch.config import SimConfig, TrainConfig, default_config

    return default_config(sim=SimConfig(n_agents=A), train=TrainConfig(implementation="tabular", seed=0))


def test_continual_command(served, capfd):
    root, inc, _, db = served
    out = str(root / "cand")
    rc = tcli.main(["continual", *COMMON, "--results-db", db, "--bundle", inc, "--out", out,
                    "--episodes", "0", "--trace-steps", "4", "--model-dir", str(root / "m")])
    (row,) = [r for r in _rows(capfd) if r["metric"] == "continual_result"]
    assert rc == 0 and row["value"] == 4.0 and row["trace_n_transitions"] == 32 - 8
    manifest, params = load_policy_bundle(out)
    assert manifest["config_hash"] == row["candidate_hash"] != row["incumbent_hash"]
    assert np.isfinite(params["q_table"]).all()


def test_promote_command(served, capfd):
    root, inc, good, db = served
    rc = tcli.main(["promote", *COMMON, "--gate-only", "--candidate", good, "--incumbent", inc,
                    "--max-batch", "8"])
    (row,) = _rows(capfd)
    assert rc == 0 and row["metric"] == "promotion_gate" and row["passed"]
    rc = tcli.main(["promote", *COMMON, "--candidate", good, "--incumbent", inc, "--stages", "25,100",
                    "--requests-per-stage", "48", "--households", "16", "--max-batch", "8",
                    "--results-db", db, "--out", str(root / "promo.jsonl")])
    (row,) = _rows(capfd)
    assert rc == 0 and row["metric"] == "promotion_case" and row["promoted"] and row["bit_exact_after"]
    with open(root / "promo.jsonl") as f:
        assert json.loads(f.readlines()[-1])["metric"] == "promotion_case"


def test_regime_bench_command(tmp_path, capfd):
    rc = tcli.main(["regime-bench", "--episodes", "1", "--device", "cpu",
                    "--results-db", str(tmp_path / "r.db")])
    rows = _rows(capfd)
    assert rc == 0 and rows[0]["single_compile"]
    assert rows[-1]["metric"].startswith("regime_generalization") and rows[-1]["gate_blocked_regime_regression"]


def test_flywheel_commands_refuse_a_silent_cpu_run(served, monkeypatch, tmp_path):
    root, inc, good, db = served
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argvs = (
        ["continual", "--agents", "3", "--results-db", db, "--bundle", inc],
        ["promote", "--agents", "3", "--candidate", good, "--incumbent", inc],
        ["regime-bench"],
    )
    for argv in argvs:
        with pytest.raises(SystemExit, match="device='cpu'") as err:
            tcli.main(argv)
        assert err.value.code not in (0, None)
        with pytest.raises(SystemExit, match="item 8"):
            tcli.main(argv + ["--device", "auto"])
