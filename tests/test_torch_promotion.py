"""The port's promotion gate and canary against the JAX package's (CPU).

* The crafted harness bundles equal the JAX package's tables bit for bit.
* ``evaluate_bundle_cost`` at ``rtol=2e-4`` (tests/test_golden.py) with the
  JAX eval's held-out draws injected (``PRNGKey(10_000)`` traces,
  ``PRNGKey(1)`` initial temperatures, as tests/test_torch_health.py does).
* The decision matrix of ``tests/test_promotion.py`` (better/worse/tie on eval
  cost x pass/fail SLO on the modeled ``_FAST``/``_SLOW`` clocks): the same
  verdict and the same reasons, word for word, as the JAX gate; a poisoned
  bundle blocked on its parameters; the verdict in the warehouse.
* A canary abort restores the incumbent with zero failed requests, and a
  good candidate promotes end to end, each serving bit for bit afterwards;
  an erroring candidate arm is charged its errors.
"""

import dataclasses
import time

import jax
import numpy as np
import pytest
import torch
from test_torch_device_gen import jax_trace_arrays, trace_draws
from test_torch_single_episode import jax_init_normals

from p2pmicrogrid_tpu import config as jcfg
from p2pmicrogrid_tpu.serve import promotion as jp
from p2pmicrogrid_tpu.serve.export import load_policy_bundle as jax_load
from p2pmicrogrid_tpu_torch import config as tcfg
from p2pmicrogrid_tpu_torch.data.results import ResultsStore
from p2pmicrogrid_tpu_torch.serve import promotion as tp

A, S_EVAL = 3, 4
_FAST = lambda i, j: 0.0005  # noqa: E731 — modeled 0.5 ms batches, inside any budget
_SLOW = lambda i, j: 0.25    # noqa: E731 — modeled 250 ms batches, over every budget
GATE = dict(s_eval=S_EVAL, bench_requests=64, max_batch=8)


def _cfg(mod, bump=0):
    cfg = mod.default_config(sim=mod.SimConfig(n_agents=A), train=mod.TrainConfig(implementation="tabular"))
    return cfg.replace(train=dataclasses.replace(cfg.train, starting_episodes=cfg.train.starting_episodes + bump))


def _eval_inputs():
    draws = trace_draws(jax.jit(lambda k: jax_trace_arrays(k, S_EVAL))(jax.random.PRNGKey(10_000)))
    k_phys, _ = jax.random.split(jax.random.PRNGKey(1))
    normals = torch.stack([jax_init_normals(k, A) for k in jax.random.split(k_phys, S_EVAL)])
    return draws, normals


@pytest.fixture(scope="module")
def crafted(tmp_path_factory):
    """The port's crafted bundles and both packages' held-out evals of each."""
    root = tmp_path_factory.mktemp("promotion")
    cfg_t = _cfg(tcfg)
    dirs = {"incumbent": tp.make_crafted_bundle(cfg_t, "incumbent", str(root / "incumbent"), device="cpu")}
    for i, kind in enumerate(("good", "cost_regressed", "nan_poisoned"), start=1):
        dirs[kind] = tp.make_crafted_bundle(_cfg(tcfg, 100 + i), kind, str(root / kind), device="cpu")
    dirs["tie"] = tp.make_crafted_bundle(_cfg(tcfg, 200), "incumbent", str(root / "tie"), device="cpu")
    draws, normals = _eval_inputs()
    evals = {
        k: (jp.evaluate_bundle_cost(_cfg(jcfg), d, s_eval=S_EVAL),
            tp.evaluate_bundle_cost(cfg_t, d, s_eval=S_EVAL, draws=draws, normals=normals, device="cpu"))
        for k, d in dirs.items() if k in ("incumbent", "good", "cost_regressed")
    }
    return dirs, evals, (draws, normals)


def test_crafted_bundles_are_the_jax_packages(crafted, tmp_path):
    dirs, _, _ = crafted
    for i, kind in enumerate(("incumbent", "good", "cost_regressed", "nan_poisoned")):
        cfg_j = _cfg(jcfg, 100 + i if i else 0)
        ref = jp.make_crafted_bundle(cfg_j, kind, str(tmp_path / kind))
        (m_t, p_t), (m_j, p_j) = jax_load(dirs[kind]), jax_load(ref)
        np.testing.assert_array_equal(p_t["q_table"], p_j["q_table"])
        assert m_t["config_hash"] == m_j["config_hash"] and m_t["source"] == m_j["source"]


def test_bundle_cost_matches_jax(crafted):
    _, evals, _ = crafted
    for kind, ((c_j, r_j), (c_t, r_t)) in evals.items():
        np.testing.assert_allclose(c_t, c_j, rtol=2e-4, err_msg=kind)
        np.testing.assert_allclose(r_t, r_j, rtol=2e-4, err_msg=kind)
    assert evals["good"][1][0] < evals["incumbent"][1][0] < evals["cost_regressed"][1][0]


@pytest.mark.parametrize(
    "candidate,service,expect_pass",
    [("good", _FAST, True), ("good", _SLOW, False), ("cost_regressed", _FAST, False),
     ("cost_regressed", _SLOW, False), ("tie", _FAST, False)],
)
def test_decision_matrix_matches_jax(crafted, candidate, service, expect_pass):
    dirs, evals, (draws, normals) = crafted
    ref = jp.run_promotion_gate(_cfg(jcfg), dirs[candidate], dirs["incumbent"], service_time_fn=service,
                                incumbent_eval=evals["incumbent"][0], device="cpu", **GATE)
    got = tp.run_promotion_gate(_cfg(tcfg), dirs[candidate], dirs["incumbent"], service_time_fn=service,
                                incumbent_eval=evals["incumbent"][1], eval_draws=draws,
                                eval_normals=normals, device="cpu", **GATE)
    assert got.passed is ref.passed is expect_pass
    assert got.reasons == ref.reasons
    assert (got.candidate, got.incumbent) == (ref.candidate, ref.incumbent)
    assert (got.p95_ms, got.p99_ms, got.shed_rate) == (ref.p95_ms, ref.p99_ms, ref.shed_rate)


def test_poisoned_bundle_blocked_and_verdicts_reach_the_warehouse(crafted, tmp_path):
    from p2pmicrogrid_tpu_torch.telemetry import SqliteSink, Telemetry

    dirs, evals, (draws, normals) = crafted
    db = str(tmp_path / "wh.db")
    tel = Telemetry(run_id="gate-test", sinks=[SqliteSink(db)], manifest={"config_hash": "gate-test"})
    kw = dict(service_time_fn=_FAST, incumbent_eval=evals["incumbent"][1], eval_draws=draws,
              eval_normals=normals, telemetry=tel, device="cpu", **GATE)
    poisoned = tp.run_promotion_gate(_cfg(tcfg), dirs["nan_poisoned"], dirs["incumbent"], **kw)
    assert not poisoned.passed and any("non-finite parameter" in r for r in poisoned.reasons)
    assert tp.run_promotion_gate(_cfg(tcfg), dirs["good"], dirs["incumbent"], **kw).passed
    tel.close()
    with ResultsStore(db) as store:
        rows = store.query_promotion_view()
    by_candidate = {r["candidate"]: r for r in rows}
    assert by_candidate[poisoned.candidate]["gate_passes"] == 0
    assert sorted((r["gate_events"], r["gate_passes"], r["last_phase"]) for r in rows) == [
        (1, 0, "gate"), (1, 1, "gate")]


def test_canary_abort_restores_the_incumbent_with_zero_failed_requests(crafted, tmp_path):
    dirs, _, _ = crafted
    fields = tp.run_promotion_pipeline(
        _cfg(tcfg), dirs["cost_regressed"], dirs["incumbent"], stages=(25.0, 100.0),
        results_db=str(tmp_path / "wh.db"), seed=5, requests_per_stage=96, n_households=64,
        skip_gate=True, max_batch=8, device="cpu",
    )
    assert fields["rolled_back"] and not fields["promoted"]
    assert fields["aborted_stage"] == 0 and fields["availability"] == 1.0 and fields["n_failed"] == 0
    assert fields["bit_exact_after"] is True
    assert any("decision cost" in r for r in fields["abort_reasons"])


def test_good_candidate_promotes_end_to_end(crafted, tmp_path):
    dirs, _, (draws, normals) = crafted
    fields = tp.run_promotion_pipeline(
        _cfg(tcfg), dirs["good"], dirs["incumbent"], stages=(25.0, 100.0),
        results_db=str(tmp_path / "wh.db"), seed=6, requests_per_stage=96, n_households=64,
        max_batch=8, gate_service_time_fn=_FAST, eval_draws=draws, eval_normals=normals,
        s_eval=S_EVAL, device="cpu",
    )
    assert fields["promoted"] and not fields["rolled_back"] and fields["gate_verdict"] == "pass"
    assert fields["availability"] == 1.0 and fields["bit_exact_after"] is True
    assert len(fields["canary_stages"]) == 2
    last = fields["canary_stages"][-1]
    assert last["arms"][fields["incumbent"]].get("baseline_decisions", 0) > 0


def test_erroring_candidate_arm_is_charged():
    from p2pmicrogrid_tpu_torch.serve.registry import BundleRegistry, _household_slot

    controller = tp.CanaryController(BundleRegistry(), "cand-hash", "inc-hash",
                                     budgets=tp.CanaryBudgets(max_error_rate=0.0), device="cpu")
    households = [f"house-{i:04d}" for i in range(64)]
    in_arm = [h for h in households if _household_slot(h) < 25.0]
    assert in_arm
    cand = [_household_slot(h) < 25.0 for h in households]
    traffic = tp.StageTraffic(
        statuses=np.asarray([500 if c else 200 for c in cand]),
        latencies_ms=np.ones(len(households)),
        config_hashes=[None if c else "inc-hash" for c in cand],
        actions=[None if c else [0.0] for c in cand],
        households=households,
    )
    report = controller._evaluate_stage(tp.StagePlan(index=0, percent=25.0, is_promote=False), traffic,
                                        time.time())
    assert not report.ok and any("error rate" in r for r in report.reasons)
    assert report.arms["cand-hash"]["errors"] == len(in_arm)
