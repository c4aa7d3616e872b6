"""The port stands alone: it imports neither JAX nor the JAX package, and its
entry points never carry on quietly on the CPU."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import p2pmicrogrid_tpu_torch
from p2pmicrogrid_tpu_torch import config as tcfg
from p2pmicrogrid_tpu_torch.envs import community as tcom
from p2pmicrogrid_tpu_torch.envs import multi_community as tmc
from p2pmicrogrid_tpu_torch.data.traces import synthetic_traces
from p2pmicrogrid_tpu_torch import regimes as treg
from p2pmicrogrid_tpu_torch.models import forecast as tfc
from p2pmicrogrid_tpu_torch.models.ddpg import ddpg_init, ddpg_params_init
from p2pmicrogrid_tpu_torch.models.ddpg_recurrent import (
    recurrent_actor_init_hidden,
    recurrent_ddpg_init,
)
from p2pmicrogrid_tpu_torch.models.dqn import dqn_init
from p2pmicrogrid_tpu_torch.models.replay import lockstep_replay_init
from p2pmicrogrid_tpu_torch.models.tabular import tabular_init
from p2pmicrogrid_tpu_torch.parallel import device_gen as tdg
from p2pmicrogrid_tpu_torch.parallel import scenarios as tsc
from p2pmicrogrid_tpu_torch.serve import engine as tengine
from p2pmicrogrid_tpu_torch.serve import export as texport
from p2pmicrogrid_tpu_torch.serve import gateway as tgateway
from p2pmicrogrid_tpu_torch.train import health as thealth
from p2pmicrogrid_tpu_torch.train import loop as tloop
from p2pmicrogrid_tpu_torch.train import make_policy
from p2pmicrogrid_tpu_torch.train import recurrent as trec
from p2pmicrogrid_tpu_torch.train.policies import init_policy_state
from p2pmicrogrid_tpu_torch.data import trace_export as ttrace
from p2pmicrogrid_tpu_torch.regimes import bench as tregbench
from p2pmicrogrid_tpu_torch.serve import continuous as tcontinuous
from p2pmicrogrid_tpu_torch.serve import autopilot as tautopilot
from p2pmicrogrid_tpu_torch.serve import procfleet as tprocfleet
from p2pmicrogrid_tpu_torch.serve import promotion as tpromo
from p2pmicrogrid_tpu_torch.serve import router as trouter
from p2pmicrogrid_tpu_torch.serve.registry import BundleRegistry
from p2pmicrogrid_tpu_torch.train import continual as tcont

REPO = os.path.dirname(os.path.dirname(os.path.abspath(p2pmicrogrid_tpu_torch.__file__)))


def test_every_module_imports_without_jax():
    """In a fresh interpreter where ``import jax``, ``import
    p2pmicrogrid_tpu``, ``import pandas`` and ``import matplotlib`` fail (the
    card's machine has neither of the last two), every module of the port
    imports, and no module of the JAX package was loaded."""
    script = textwrap.dedent(
        """
        import importlib, pkgutil, sys
        sys.modules["jax"] = None
        sys.modules["p2pmicrogrid_tpu"] = None
        sys.modules["pandas"] = None
        sys.modules["matplotlib"] = None
        import p2pmicrogrid_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        assert {"p2pmicrogrid_tpu_torch.parallel.device_gen",
                "p2pmicrogrid_tpu_torch.parallel.graph",
                "p2pmicrogrid_tpu_torch.train.loop",
                "p2pmicrogrid_tpu_torch.envs.multi_community",
                "p2pmicrogrid_tpu_torch.draw_digests",
                "p2pmicrogrid_tpu_torch.telemetry.async_drain",
                "p2pmicrogrid_tpu_torch.telemetry.device_metrics",
                "p2pmicrogrid_tpu_torch.telemetry.profiling",
                "p2pmicrogrid_tpu_torch.telemetry.registry",
                "p2pmicrogrid_tpu_torch.telemetry.spans",
                "p2pmicrogrid_tpu_torch.train.checkpoint",
                "p2pmicrogrid_tpu_torch.train.faults",
                "p2pmicrogrid_tpu_torch.train.health",
                "p2pmicrogrid_tpu_torch.train.resilience",
                "p2pmicrogrid_tpu_torch.telemetry.tracing",
                "p2pmicrogrid_tpu_torch.serve.auth",
                "p2pmicrogrid_tpu_torch.serve.continuous",
                "p2pmicrogrid_tpu_torch.serve.engine",
                "p2pmicrogrid_tpu_torch.serve.export",
                "p2pmicrogrid_tpu_torch.serve.gateway",
                "p2pmicrogrid_tpu_torch.serve.registry",
                "p2pmicrogrid_tpu_torch.serve.wire",
                "p2pmicrogrid_tpu_torch.models.ddpg_recurrent",
                "p2pmicrogrid_tpu_torch.models.forecast",
                "p2pmicrogrid_tpu_torch.train.recurrent",
                "p2pmicrogrid_tpu_torch.ops.auction",
                "p2pmicrogrid_tpu_torch.regimes",
                "p2pmicrogrid_tpu_torch.regimes.spec",
                "p2pmicrogrid_tpu_torch.regimes.engine",
                "p2pmicrogrid_tpu_torch.regimes.train",
                "p2pmicrogrid_tpu_torch.regimes.evaluate",
                "p2pmicrogrid_tpu_torch.data.results",
                "p2pmicrogrid_tpu_torch.telemetry.report",
                "p2pmicrogrid_tpu_torch.cli",
                "p2pmicrogrid_tpu_torch.__main__",
                "p2pmicrogrid_tpu_torch.serve.loadgen",
                "p2pmicrogrid_tpu_torch.serve.promotion",
                "p2pmicrogrid_tpu_torch.data.trace_export",
                "p2pmicrogrid_tpu_torch.train.continual",
                "p2pmicrogrid_tpu_torch.regimes.bench",
                "p2pmicrogrid_tpu_torch.serve.faults",
                "p2pmicrogrid_tpu_torch.serve.router",
                "p2pmicrogrid_tpu_torch.serve.procfleet",
                "p2pmicrogrid_tpu_torch.serve.proxy",
                "p2pmicrogrid_tpu_torch.serve.autopilot"} <= set(names), names
        leaked = sorted(
            n for n, m in sys.modules.items()
            if m is not None and (n == "jax" or n.startswith(("jax.", "jaxlib", "flax", "optax"))
                                  or n == "p2pmicrogrid_tpu" or n.startswith("p2pmicrogrid_tpu.")
                                  or n.split(".")[0] in ("pandas", "matplotlib"))
        )
        assert not leaked, leaked
        print(len(names))
        """
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", script], capture_output=True, text=True, env=env, cwd=REPO,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 15  # every module was walked


def _dataset():
    z = np.zeros((2, 4, 4), np.float32)
    return ttrace.TraceDataset(obs=z, action=z[..., 0], reward=z[..., 0], next_obs=z)


def _cfg(impl="tabular"):
    return tcfg.default_config(
        sim=tcfg.SimConfig(n_agents=4, n_scenarios=2),
        train=tcfg.TrainConfig(implementation=impl),
    )


@pytest.mark.parametrize(
    "call",
    [
        lambda cfg: tsc.init_shared_state(cfg),
        lambda cfg: init_policy_state(cfg),
        lambda cfg: tabular_init(cfg.qlearning, 4),
        lambda cfg: tcom.init_physical(cfg, batch_shape=(2,), normals=torch.zeros(2, 2, 4)),
        lambda cfg: tcom.ratings_to(tcom.make_ratings(cfg, np.random.default_rng(0))),
        lambda cfg: tsc.stack_scenario_arrays(
            cfg, tsc.make_scenario_traces(cfg), tcom.make_ratings(cfg, np.random.default_rng(0))
        ),
        lambda cfg: tsc.init_shared_state(_cfg("dqn")),
        lambda cfg: dqn_init(cfg.dqn, 4),
        lambda cfg: lockstep_replay_init(2, 4, 8),
        lambda cfg: tsc.init_shared_state(_cfg("ddpg")),
        lambda cfg: ddpg_params_init(cfg.ddpg, 4),
        lambda cfg: tdg.draw_traces(2),
        lambda cfg: tdg.device_scenario_traces(2),
        lambda cfg: tdg.device_episode_arrays(cfg, tcom.make_ratings(cfg, np.random.default_rng(0)), 2),
        lambda cfg: tsc.make_device_episode_fn(
            cfg, make_policy(cfg), tcom.make_ratings(cfg, np.random.default_rng(0))
        ),
        lambda cfg: tsc.train_scenarios_chunked(
            cfg, make_policy(cfg), None, tcom.make_ratings(cfg, np.random.default_rng(0)), 0, 1, 2
        ),
        lambda cfg: tcom.build_episode_arrays(
            cfg, synthetic_traces(n_days=1), tcom.make_ratings(cfg, np.random.default_rng(0))
        ),
        lambda cfg: init_policy_state(_cfg("ddpg")),
        lambda cfg: ddpg_init(cfg.ddpg, 4),
        lambda cfg: tloop.train_community(
            cfg, make_policy(cfg), None, synthetic_traces(n_days=1),
            tcom.make_ratings(cfg, np.random.default_rng(0)), torch.Generator(),
        ),
        lambda cfg: tloop.evaluate_community(
            cfg, make_policy(cfg), None, synthetic_traces(n_days=1),
            tcom.make_ratings(cfg, np.random.default_rng(0)), torch.Generator(),
        ),
        lambda cfg: tsc.init_independent_state(cfg, 2),
        lambda cfg: tmc.evaluate_multi_community(
            cfg, make_policy(cfg), None, synthetic_traces(n_days=1),
            tcom.make_ratings(cfg, np.random.default_rng(0)), torch.Generator(),
        ),
        lambda cfg: thealth.make_greedy_eval(
            cfg, make_policy(cfg), tcom.make_ratings(cfg, np.random.default_rng(0))
        ),
        lambda cfg: thealth.train_chunked_with_health(
            cfg, make_policy(cfg), None, tcom.make_ratings(cfg, np.random.default_rng(0)), 0, 1, 2,
            telemetry=None,
        ),
        lambda cfg: tengine.PolicyEngine(manifest={}, params={}),
        lambda cfg: texport.export_policy_bundle(cfg, None, "unused"),
        lambda cfg: texport.export_bundle_from_checkpoint(cfg, "unused", "unused"),
        lambda cfg: texport.aot_compile_bundle({}, {}, [1]),
        lambda cfg: tgateway.build_bundle("unused"),
        lambda cfg: tgateway.make_bundle_factory(),
        lambda cfg: tgateway.build_registry(["unused"]),
        lambda cfg: tgateway.build_gateway(["unused"]),
        lambda cfg: recurrent_ddpg_init(cfg.ddpg),
        lambda cfg: recurrent_actor_init_hidden((2,)),
        lambda cfg: trec.train_recurrent_community(cfg, 2, torch.Generator()),
        lambda cfg: tfc.forecast_init(cfg.forecast, 4),
        lambda cfg: tfc.train_forecaster(cfg.forecast, np.zeros((4, 3, 4)), np.zeros((4, 3, 2))),
        lambda cfg: treg.stack_regime_params([treg.RegimeSpec()]),
        lambda cfg: treg.assignment_one_hot(np.zeros(2, np.int32), 1),
        lambda cfg: treg.build_portfolio(["baseline"], 2),
        lambda cfg: treg.make_regime_episode_fn(
            cfg, make_policy(cfg), tcom.make_ratings(cfg, np.random.default_rng(0)),
            treg.build_portfolio(["baseline"], 2, device="cpu").scenario_params,
            arrays_fn=lambda d: None, n_scenarios=2,
        ),
        lambda cfg: treg.train_regime_portfolio(
            cfg, make_policy(cfg), None, None, tcom.make_ratings(cfg, np.random.default_rng(0)),
            treg.build_portfolio(["baseline"], 2, device="cpu"), torch.Generator(), 1,
            arrays_fn=lambda d: None, n_scenarios=2,
        ),
        lambda cfg: treg.make_regime_eval(
            cfg, make_policy(cfg), tcom.make_ratings(cfg, np.random.default_rng(0)),
            treg.build_portfolio(["baseline"], 2, device="cpu"),
        ),
        lambda cfg: treg.evaluate_regimes(
            cfg, make_policy(cfg), None, tcom.make_ratings(cfg, np.random.default_rng(0)), ["baseline"],
        ),
        lambda cfg: treg.evaluate_bundle_regimes(cfg, "unused", ["baseline"]),
        lambda cfg: tregbench.make_regime_crafted_bundle(cfg, "thermostat", "unused"),
        lambda cfg: tregbench.run_regime_bench(),
        lambda cfg: ttrace.trace_reward(cfg, np.zeros((1, 4, 4)), np.zeros((1, 4))),
        lambda cfg: ttrace.decision_cost(cfg, np.zeros((1, 4, 4)), np.zeros((1, 4))),
        lambda cfg: ttrace.export_serve_traces("unused", cfg=cfg),
        lambda cfg: ttrace.bill_decisions("unused", cfg),
        lambda cfg: ttrace.settlement_reward_fn("unused", cfg),
        lambda cfg: ttrace.to_replay_state(_dataset()),
        lambda cfg: tcont.state_from_bundle(cfg, {"implementation": "tabular", "n_agents": 4}, {}),
        lambda cfg: tcont.make_trace_update_fn(cfg, _dataset()),
        lambda cfg: tcont.offpolicy_pretrain(cfg, None, _dataset(), None, 1),
        lambda cfg: tcont.train_continual(cfg, "unused", _dataset(), "unused", "unused"),
        lambda cfg: tpromo.evaluate_bundle_cost(cfg, "unused"),
        lambda cfg: tpromo.run_promotion_gate(cfg, "unused", "unused"),
        lambda cfg: tpromo.CanaryController(BundleRegistry(), "a", "b"),
        lambda cfg: tpromo.make_crafted_bundle(cfg, "incumbent", "unused"),
        lambda cfg: tpromo.run_promotion_pipeline(cfg, "unused", "unused"),
        lambda cfg: tpromo.promotion_bench(cfg, "unused"),
        lambda cfg: tcontinuous.serve_bench_continuous_compare("unused"),
        lambda cfg: trouter.LocalFleet(["unused"]),
        lambda cfg: tprocfleet.ProcessFleet(["unused"]),
        lambda cfg: tautopilot.Autopilot(cfg, None, "unused", "unused", "unused"),
        lambda cfg: tautopilot.autopilot_bench(cfg, "unused"),
    ],
    ids=["init_shared_state", "init_policy_state", "tabular_init", "init_physical",
         "ratings_to", "stack_scenario_arrays", "init_shared_state_dqn", "dqn_init",
         "lockstep_replay_init", "init_shared_state_ddpg", "ddpg_params_init", "draw_traces",
         "device_scenario_traces", "device_episode_arrays", "make_device_episode_fn",
         "train_scenarios_chunked", "build_episode_arrays", "init_policy_state_ddpg",
         "ddpg_init", "train_community", "evaluate_community", "init_independent_state",
         "evaluate_multi_community", "make_greedy_eval", "train_chunked_with_health",
         "PolicyEngine", "export_policy_bundle", "export_bundle_from_checkpoint",
         "aot_compile_bundle", "build_bundle", "make_bundle_factory", "build_registry",
         "build_gateway", "recurrent_ddpg_init", "recurrent_actor_init_hidden",
         "train_recurrent_community", "forecast_init", "train_forecaster", "stack_regime_params",
         "assignment_one_hot", "build_portfolio", "make_regime_episode_fn",
         "train_regime_portfolio", "make_regime_eval", "evaluate_regimes",
         "evaluate_bundle_regimes", "make_regime_crafted_bundle", "run_regime_bench",
         "trace_reward", "decision_cost", "export_serve_traces", "bill_decisions",
         "settlement_reward_fn", "to_replay_state", "state_from_bundle", "make_trace_update_fn",
         "offpolicy_pretrain", "train_continual", "evaluate_bundle_cost", "run_promotion_gate",
         "CanaryController", "make_crafted_bundle", "run_promotion_pipeline", "promotion_bench",
         "serve_bench_continuous_compare", "LocalFleet", "ProcessFleet", "Autopilot",
         "autopilot_bench"],
)
def test_entry_points_default_to_cuda(monkeypatch, call):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call(_cfg())


@pytest.mark.parametrize(
    "argv",
    [
        ["train", "--agents", "2", "--episodes", "1"],
        ["train", "--scenarios", "2", "--shared", "--chunks", "2", "--episodes", "1"],
        ["train", "--supervise", "--episodes", "1"],
        ["single", "--episodes", "1"],
        ["multi", "--communities", "2", "--episodes", "1"],
        ["eval", "--test"],
        ["baseline", "--test"],
        ["sweep", "--episodes", "1"],
        ["forecast", "--epochs", "1"],
        ["export-bundle"],
        ["train-recurrent", "--episodes", "1"],
        ["serve-gateway", "--port", "0"],
        ["continual", "--results-db", "unused.db", "--bundle", "unused"],
        ["promote", "--candidate", "unused", "--incumbent", "unused"],
        ["serve-bench", "--requests", "4"],
        ["serve-bench", "--fleet", "--process", "--chaos"],
        ["autopilot", "--bench"],
        ["autopilot", "--replica", "127.0.0.1:1", "--state-dir", "unused",
         "--results-db", "unused.db"],
    ],
    ids=lambda a: a[0] if a[1:2] not in (["--scenarios"], ["--fleet"], ["--replica"])
    else {"--scenarios": "train-chunked", "--fleet": "serve-bench-fleet",
          "--replica": "autopilot-daemon"}[a[1]],
)
def test_command_line_exits_non_zero_without_a_card(monkeypatch, tmp_path, argv):
    """``cli.main`` without ``--device cpu`` on a machine without a card:
    ``SystemExit`` with ``resolve_device``'s message (a non-zero exit),
    before anything ran or was written."""
    from p2pmicrogrid_tpu_torch import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match="device='cpu'") as err:
        cli.main(argv + ["--model-dir", str(tmp_path / "m")])
    assert err.value.code not in (0, None)
    assert os.listdir(tmp_path) == []
