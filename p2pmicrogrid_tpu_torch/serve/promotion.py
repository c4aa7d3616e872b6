"""Gated promotion + canary auto-rollback: the deployment safety rails.

The port of the JAX package's ``serve/promotion.py``: the gate's rules, the
canary controller and the harness are its host code as it is; the held-out
evaluations graft each bundle into a learner on ``device``
(``train/continual.py::state_from_bundle``) and run the port's greedy
evaluation there (K1 at ``rounds=1``), the SLO bench drives the port's
``PolicyEngine`` (CUDA graphs per bucket on the card), and the pipeline's
gateway serves from ``device``. Entry points default to ``device="cuda"``.

Continual training (train/continual.py) emits candidate bundles on a
cadence; production must be UNABLE to regress no matter what the trainer
produced. Two independent rails stand between a candidate and traffic:

* **The promotion gate** (``run_promotion_gate``) — offline, before any
  traffic. The candidate must (a) BEAT the incumbent on the held-out
  greedy eval cost (train/health.make_greedy_eval over the fixed
  never-trained scenario set; ties lose — "no worse" is not a reason to
  ship), (b) evaluate FINITE (a NaN-poisoned bundle fails here, not in a
  household's heat pump), and (c) meet the serve-bench SLO budgets
  (p95/p99 latency, shed rate) measured on the candidate's own engine.
  Every verdict is a ``promotion`` event in the telemetry warehouse —
  ``telemetry-query --promotions`` answers "what happened the last time
  this config tried to ship".

* **The canary** (``CanaryController``) — online, for candidates the
  gate passed. The controller ramps the candidate through the existing
  ``BundleRegistry`` percentage-split A/B: a stage sets the split,
  live traffic flows, and per-bundle attribution is read back through the
  warehouse join the ``--compare`` tooling uses — each arm's decision
  cost (the trace-reward attribution of what it actually served,
  data/trace_export.trace_reward), latency and error/nonfinite counts,
  keyed by config_hash. A healthy stage ramps up (default 5% → 25% →
  100%, the last stage a swap — fleet-wide two-phase via ``swap_fn`` =
  ``router.swap_fleet`` when fronting a fleet, the registry's atomic swap
  in-process); a regression or guard trip ABORTS the ramp, clears the
  split, restores the incumbent as default and reports ``rolled_back`` —
  all through routing-table mutations that never touch an in-flight
  request, so the abort drops zero traffic (asserted by the harness).

``promotion_bench`` is the seeded acceptance harness behind ``promote
--inject``: crafted tabular candidates — genuinely
better, cost-regressed, NaN-poisoned, SLO-violating-slow — are pushed
through the full pipeline against a live gateway. The bad ones must be
blocked at the gate or rolled back mid-canary with availability 1.0 and
the incumbent serving bit-exact afterward; the good one must promote
end-to-end. Deterministic under its seed: gate SLO times are modeled
(``plan_open_loop``'s virtual clock), traffic obs/households are
seed-derived, and the crafted policies are closed-form.
"""

from __future__ import annotations

import dataclasses
import http.client
import json
import math
import sqlite3
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from p2pmicrogrid_tpu_torch.device import resolve_device


# -- budgets -------------------------------------------------------------------


@dataclass(frozen=True)
class GateBudgets:
    """What the offline gate requires of a candidate.

    ``cost_margin`` is subtracted from the incumbent's eval cost before
    the comparison: the candidate must satisfy ``cost < incumbent_cost -
    cost_margin`` (default 0 — a strict beat; ties and regressions both
    fail). ``max_reward_drop`` is the don't-heat-basin guard
    (train/health.py's measured failure mode: community cost IMPROVES
    while comfort collapses): the candidate's greedy reward may not fall
    more than ``max(|incumbent_reward|, 1) * max_reward_drop`` below the
    incumbent's — a cheaper candidate that stopped heating fails HERE,
    not in a cold house. The SLO half comes from a serve-bench run on the
    candidate's engine: p95/p99 within budget, shed rate at most
    ``max_shed_rate`` (0 for the in-process bench, which cannot shed —
    network/fleet gates report real shed rates).
    """

    cost_margin: float = 0.0
    max_reward_drop: float = 0.5
    slo_p95_ms: float = 100.0
    slo_p99_ms: float = 250.0
    max_shed_rate: float = 0.05
    # Per-regime no-regression rule: when the gate is given a
    # held-out regime set (``run_promotion_gate(regime_specs=...)``), the
    # candidate may not regress ANY regime's held-out eval cost by more
    # than ``max(|incumbent|, 1) * max_regime_regression`` — a candidate
    # that improves the MEAN by winning the easy worlds while losing a
    # cold snap or an islanding event does not ship. 0.0 = any regression
    # beyond float-noise scale blocks.
    max_regime_regression: float = 0.0
    # Quantized-candidate error budget (serve/export.py's int8 contract):
    # a continuous int8 candidate's MEASURED max ulp (manifest
    # quant.error_bound.max_ulp) must stay within this budget; None defers
    # to the budget the bundle itself declared at export (ulp_budget).
    # Discrete int8 candidates must carry bit_exact_argmax=True regardless.
    max_quant_ulp: Optional[float] = None


@dataclass(frozen=True)
class CanaryBudgets:
    """Per-stage regression thresholds for the live canary.

    ``max_cost_regression`` bounds the candidate arm's mean decision
    cost: ``cand <= inc + max(|inc|, 1) * max_cost_regression`` (scale-
    free, sign-safe). Latency is bounded both relatively
    (``max_p95_ratio`` x the incumbent arm's p95) and absolutely
    (``slo_p95_ms``). ANY candidate-arm server error or nonfinite action
    aborts when ``max_error_rate`` is 0. A stage with fewer than
    ``min_requests`` candidate-arm requests is inconclusive for the cost
    check (latency/error checks still apply) — size stages so they are
    not.
    """

    max_cost_regression: float = 0.05
    max_p95_ratio: float = 5.0
    slo_p95_ms: float = 500.0
    max_error_rate: float = 0.0
    min_requests: int = 8


# -- offline gate --------------------------------------------------------------


@dataclass
class GateVerdict:
    """One gate decision (also a ``promotion`` warehouse event)."""

    passed: bool
    candidate: Optional[str]
    incumbent: Optional[str]
    candidate_cost: float
    incumbent_cost: float
    candidate_reward: float
    incumbent_reward: float
    p95_ms: float
    p99_ms: float
    shed_rate: float
    reasons: List[str] = field(default_factory=list)
    # Per-regime held-out eval costs (regime name -> EUR), populated when
    # the gate ran with a regime set; empty otherwise.
    candidate_regime_costs: dict = field(default_factory=dict)
    incumbent_regime_costs: dict = field(default_factory=dict)

    @property
    def verdict(self) -> str:
        return "pass" if self.passed else "fail: " + "; ".join(self.reasons)

    def to_fields(self) -> dict:
        return {
            "passed": self.passed,
            "candidate": self.candidate,
            "incumbent": self.incumbent,
            "candidate_cost": _round_or_none(self.candidate_cost),
            "incumbent_cost": _round_or_none(self.incumbent_cost),
            "candidate_reward": _round_or_none(self.candidate_reward),
            "incumbent_reward": _round_or_none(self.incumbent_reward),
            "p95_ms": round(self.p95_ms, 3),
            "p99_ms": round(self.p99_ms, 3),
            "shed_rate": round(self.shed_rate, 6),
            "reasons": list(self.reasons),
            "candidate_regime_costs": {
                k: _round_or_none(v)
                for k, v in self.candidate_regime_costs.items()
            },
            "incumbent_regime_costs": {
                k: _round_or_none(v)
                for k, v in self.incumbent_regime_costs.items()
            },
        }


def _round_or_none(v: float):
    return round(float(v), 6) if math.isfinite(v) else None


def evaluate_bundle_cost(
    cfg,
    bundle_dir: str,
    s_eval: int = 8,
    eval_key: int = 1,
    draws=None,
    normals: Optional[torch.Tensor] = None,
    device="cuda",
) -> Tuple[float, float]:
    """Held-out greedy eval ``(cost, reward)`` of a BUNDLE: the greedy
    subtree is grafted into a fresh learner state
    (``train/continual.py::state_from_bundle``, its scaffolding drawn from a
    generator seeded ``cfg.train.seed``) and run through the same fixed
    never-trained scenario set training health uses
    (``train/health.py::make_greedy_eval``) — both sides of a gate
    comparison see identical scenarios, physics and initial temperatures,
    so the only free variable is the policy. The initial temperatures'
    normals are drawn on the CPU from ``eval_key`` (the JAX package
    evaluates at ``PRNGKey(eval_key)``); ``draws`` and ``normals`` inject
    the held-out set (the tests pass the JAX package's)."""
    from p2pmicrogrid_tpu_torch.envs import make_ratings
    from p2pmicrogrid_tpu_torch.serve.export import load_policy_bundle
    from p2pmicrogrid_tpu_torch.train import make_policy
    from p2pmicrogrid_tpu_torch.train.continual import state_from_bundle
    from p2pmicrogrid_tpu_torch.train.health import make_greedy_eval

    dev = resolve_device(device)
    manifest, params = load_policy_bundle(bundle_dir)
    ps = state_from_bundle(
        cfg, manifest, params, torch.Generator(device=dev).manual_seed(cfg.train.seed), device=dev
    )
    if normals is None:
        normals = torch.randn(
            (s_eval, 2, cfg.sim.n_agents), generator=torch.Generator().manual_seed(eval_key)
        )
    policy = make_policy(cfg)
    ratings = make_ratings(cfg, np.random.default_rng(cfg.train.seed))
    greedy_eval = make_greedy_eval(
        cfg, policy, ratings, s_eval=s_eval, draws=draws, normals=normals, device=dev
    )
    with torch.no_grad():
        cost, reward = greedy_eval(ps)
    # host-sync: the gate's verdict is a host decision.
    return float(cost), float(reward)


def run_promotion_gate(
    cfg,
    candidate_dir: str,
    incumbent_dir: str,
    budgets: GateBudgets = GateBudgets(),
    telemetry=None,
    s_eval: int = 8,
    bench_rate_hz: float = 256.0,
    bench_requests: int = 512,
    bench_seed: int = 0,
    max_batch: int = 64,
    service_time_fn: Optional[Callable[[int, int], float]] = None,
    device="cuda",
    incumbent_eval: Optional[Tuple[float, float]] = None,
    regime_specs: Optional[Sequence] = None,
    regime_s_per_regime: int = 4,
    regime_eval_fn: Optional[Callable[[str], dict]] = None,
    incumbent_regime_eval: Optional[dict] = None,
    eval_draws=None,
    eval_normals: Optional[torch.Tensor] = None,
) -> GateVerdict:
    """The offline promotion gate (module docstring). ``service_time_fn``
    overrides the SLO bench's batch timing (the deterministic modeled
    clock in tests/harness; None measures the real engine).
    ``incumbent_eval`` (a prior ``evaluate_bundle_cost`` result) skips
    re-evaluating an unchanged incumbent — the harness gates many
    candidates against one. A candidate already condemned by the
    poison/eval checks skips the SLO bench entirely (engine build + capture +
    bench wall-clock buys nothing on a verdict that cannot flip); the
    verdict's SLO fields read 0 in that case.

    ``regime_specs`` (regime names / ``regimes.RegimeSpec``s) turns on the
    per-regime dimension: both bundles run the held-out mixed-regime eval
    (``regimes.evaluate.evaluate_bundle_regimes`` — one evaluation and one
    learner state shared by both sides, each bundle copied into it in
    place) and the candidate may not regress ANY regime
    beyond ``budgets.max_regime_regression``, even when its mean cost
    improves. ``regime_eval_fn(bundle_dir) -> {regime: cost}`` overrides
    the evaluator (tests/harness); ``incumbent_regime_eval`` reuses a
    prior incumbent result across many candidates. ``device`` runs the
    evaluations and the SLO bench's engine; ``eval_draws``/``eval_normals``
    inject the held-out set of ``evaluate_bundle_cost``."""
    from p2pmicrogrid_tpu_torch.serve.engine import PolicyEngine
    from p2pmicrogrid_tpu_torch.serve.export import load_policy_bundle
    from p2pmicrogrid_tpu_torch.serve.loadgen import serve_bench

    dev = resolve_device(device)
    cand_manifest, cand_params = load_policy_bundle(candidate_dir)
    inc_manifest, _ = load_policy_bundle(incumbent_dir)
    candidate = cand_manifest.get("config_hash")
    incumbent = inc_manifest.get("config_hash")
    reasons: List[str] = []

    # Parameter-level poison check BEFORE any eval: a NaN net fails the
    # eval's finiteness check too, but a NaN Q-TABLE does not (argmax
    # over NaN rows still picks a finite action) — the parameters
    # themselves are the only place that poisoning is visible.
    from p2pmicrogrid_tpu_torch.convert import flat_tree

    nonfinite_params = 0
    for arr in flat_tree(cand_params).values():  # bundle params are host arrays
        if np.issubdtype(arr.dtype, np.floating):
            nonfinite_params += int((~np.isfinite(arr)).sum())
    if nonfinite_params:
        reasons.append(
            f"candidate carries {nonfinite_params} non-finite "
            "parameter(s) — poisoned bundle"
        )

    # Quantization error-bound contract (serve/export.py): an int8 candidate
    # must carry its measured error bound and stay inside the budget —
    # discrete policies a bit-exact greedy argmax, continuous actors the
    # measured max-ulp within the enforced budget (the gate's
    # ``max_quant_ulp`` override, else the bundle's own declared budget).
    quant = cand_manifest.get("quant") or {}
    if cand_manifest.get("dtype") == "int8" and not quant:
        reasons.append(
            "int8 candidate manifest carries no quant block (scales + "
            "error_bound) — the bundle cannot be dequantized or its "
            "contract verified"
        )
    if quant:
        eb = quant.get("error_bound") or {}
        discrete = (
            (cand_manifest.get("action_spec") or {}).get("type") == "discrete"
            or eb.get("kind") == "discrete_argmax"
        )
        if discrete:
            if not eb.get("bit_exact_argmax", False):
                reasons.append(
                    "quantized discrete candidate does not certify a "
                    "bit-exact greedy argmax (quant.error_bound."
                    "bit_exact_argmax) — violates the int8 contract"
                )
        else:
            max_ulp = eb.get("max_ulp")
            budget = (
                budgets.max_quant_ulp
                if budgets.max_quant_ulp is not None
                else eb.get("ulp_budget")
            )
            if not isinstance(max_ulp, (int, float)) or not isinstance(
                budget, (int, float)
            ):
                reasons.append(
                    "quantized continuous candidate carries no measured "
                    "max_ulp/ulp_budget (quant.error_bound) — cannot verify "
                    "the int8 contract"
                )
            elif max_ulp > budget:
                reasons.append(
                    f"quantized candidate measured max ulp {max_ulp:.0f} "
                    f"exceeds the enforced budget {budget:.0f}"
                )

    cand_cost = cand_reward = inc_cost = inc_reward = float("nan")
    if not reasons:
        # A candidate the quant-contract checks already condemned skips the
        # eval passes entirely (the stripped-quant case would even eval raw
        # un-dequantized int8 params — a garbage cost number), same
        # rationale as the SLO-bench skip below.
        eval_kw = dict(s_eval=s_eval, draws=eval_draws, normals=eval_normals, device=dev)
        cand_cost, cand_reward = evaluate_bundle_cost(cfg, candidate_dir, **eval_kw)
        inc_cost, inc_reward = incumbent_eval or evaluate_bundle_cost(
            cfg, incumbent_dir, **eval_kw
        )
        if not (math.isfinite(cand_cost) and math.isfinite(cand_reward)):
            reasons.append(
                f"candidate eval is non-finite (cost={cand_cost}, "
                f"reward={cand_reward}) — poisoned parameters"
            )
        else:
            if not cand_cost < inc_cost - budgets.cost_margin:
                word = "ties" if cand_cost == inc_cost else "regresses"
                reasons.append(
                    f"candidate {word} the incumbent on held-out eval cost "
                    f"({cand_cost:.4f} vs {inc_cost:.4f}, margin "
                    f"{budgets.cost_margin:g}) — must BEAT it"
                )
            reward_floor = inc_reward - max(
                abs(inc_reward), 1.0
            ) * budgets.max_reward_drop
            if cand_reward < reward_floor:
                reasons.append(
                    f"candidate greedy reward {cand_reward:.2f} collapsed "
                    f"below the incumbent's {inc_reward:.2f} (floor "
                    f"{reward_floor:.2f}) — the don't-heat basin guard: "
                    "cost savings bought with comfort do not ship"
                )

    # Per-regime no-regression rule: runs only while the
    # candidate is still in the running (a mean-eval failure cannot be
    # flipped by regime wins), BEFORE the SLO bench (regime evals are the
    # cheaper check and a regime regression makes the bench moot).
    cand_regimes: dict = {}
    inc_regimes: dict = {}
    want_regimes = regime_specs is not None or regime_eval_fn is not None
    if not reasons and want_regimes:
        if regime_eval_fn is None:
            from p2pmicrogrid_tpu_torch.envs import make_ratings
            from p2pmicrogrid_tpu_torch.parallel.scenarios import init_shared_pol_state
            from p2pmicrogrid_tpu_torch.regimes import build_portfolio, make_regime_eval
            from p2pmicrogrid_tpu_torch.regimes.evaluate import (
                evaluate_bundle_regimes,
            )
            from p2pmicrogrid_tpu_torch.train import make_policy

            specs = list(regime_specs)
            shared_eval_fn = make_regime_eval(
                cfg, make_policy(cfg),
                make_ratings(cfg, np.random.default_rng(cfg.train.seed)),
                build_portfolio(specs, len(specs), device=dev),
                s_per_regime=regime_s_per_regime, device=dev,
            )
            # One learner state for both bundles: each evaluation copies
            # its bundle's parameters into it in place.
            shared_state = init_shared_pol_state(
                cfg, dev, torch.Generator(device=dev).manual_seed(cfg.train.seed)
            )

            def regime_eval_fn(bundle_dir):
                role = (
                    "candidate" if bundle_dir == candidate_dir
                    else "incumbent"
                )
                return evaluate_bundle_regimes(
                    cfg, bundle_dir, specs,
                    s_per_regime=regime_s_per_regime,
                    eval_fn=shared_eval_fn, held_out=True,
                    telemetry=telemetry, bundle_tag=role,
                    pol_state=shared_state, device=dev,
                )

        cand_regimes = {
            k: v for k, v in regime_eval_fn(candidate_dir).items()
            if isinstance(v, (int, float))
        }
        inc_regimes = {
            k: v
            for k, v in (
                incumbent_regime_eval or regime_eval_fn(incumbent_dir)
            ).items()
            if isinstance(v, (int, float))
        }
        for name in sorted(inc_regimes):
            if name not in cand_regimes:
                reasons.append(
                    f"candidate regime eval is missing held-out regime "
                    f"{name!r}"
                )
                continue
            c, i = cand_regimes[name], inc_regimes[name]
            if not (math.isfinite(c) and math.isfinite(i)):
                reasons.append(
                    f"non-finite held-out eval on regime {name!r} "
                    f"(candidate {c}, incumbent {i})"
                )
                continue
            ceiling = i + max(abs(i), 1.0) * budgets.max_regime_regression
            if c > ceiling:
                reasons.append(
                    f"candidate regresses held-out regime {name!r} "
                    f"({c:.4f} vs incumbent {i:.4f}, ceiling "
                    f"{ceiling:.4f}) — mean-cost wins do not excuse a "
                    "worst-regime loss"
                )

    p95 = p99 = shed_rate = 0.0
    if not reasons:
        # Only a candidate still in the running pays the SLO bench (the
        # engine build + capture + bench run cannot flip a verdict the
        # eval checks already failed).
        engine = PolicyEngine(
            bundle_dir=candidate_dir, max_batch=max_batch, device=dev
        )
        bench_rows = serve_bench(
            engine,
            rate_hz=bench_rate_hz,
            n_requests=bench_requests,
            seed=bench_seed,
            service_time_fn=service_time_fn,
        )
        headline = bench_rows[-1]
        p95 = float(headline.get("p95_ms", 0.0))
        p99 = float(headline.get("p99_ms", 0.0))
        shed_rate = float(headline.get("shed_rate", 0.0))
        if p95 > budgets.slo_p95_ms:
            reasons.append(
                f"p95 {p95:.1f} ms over the {budgets.slo_p95_ms:g} ms budget"
            )
        if p99 > budgets.slo_p99_ms:
            reasons.append(
                f"p99 {p99:.1f} ms over the {budgets.slo_p99_ms:g} ms budget"
            )
        if shed_rate > budgets.max_shed_rate:
            reasons.append(
                f"shed rate {shed_rate:.4f} over the "
                f"{budgets.max_shed_rate:g} budget"
            )

    verdict = GateVerdict(
        passed=not reasons,
        candidate=candidate,
        incumbent=incumbent,
        candidate_cost=cand_cost,
        incumbent_cost=inc_cost,
        candidate_reward=cand_reward,
        incumbent_reward=inc_reward,
        p95_ms=p95,
        p99_ms=p99,
        shed_rate=shed_rate,
        reasons=reasons,
        candidate_regime_costs=cand_regimes,
        incumbent_regime_costs=inc_regimes,
    )
    if telemetry is not None:
        telemetry.event("promotion", phase="gate", **verdict.to_fields())
        telemetry.counter(
            "promotion.gate_pass" if verdict.passed else "promotion.gate_fail"
        )
    return verdict


# -- canary --------------------------------------------------------------------


@dataclass
class StageTraffic:
    """What one canary stage's live traffic looked like from the client.

    The driver (``drive_stage``) fires real requests at the serving
    front and reports per-request outcomes; per-arm COST attribution is
    read from the warehouse separately (the ``--compare`` join — the
    server-side record of what each bundle actually served).
    ``households`` matters for FAILED requests: an error response
    carries no ``config_hash``, so the controller attributes it to the
    arm the household's deterministic split slot routes to — without
    this, a candidate erroring on every request would be invisible to
    its own error guard.
    """

    statuses: np.ndarray                 # [N] final HTTP status (-1 transport)
    latencies_ms: np.ndarray             # [N]
    config_hashes: List[Optional[str]]   # serving bundle per request
    actions: List[Optional[list]]        # served actions per request
    households: List[Optional[str]] = field(default_factory=list)
    n_shed: int = 0                      # honest sheds (429 / router shed)


@dataclass
class StagePlan:
    index: int
    percent: float
    is_promote: bool


@dataclass
class CanaryStageReport:
    percent: float
    n_requests: int
    ok: bool
    arms: dict = field(default_factory=dict)   # config_hash -> metrics
    reasons: List[str] = field(default_factory=list)

    def to_fields(self) -> dict:
        return {
            "percent": self.percent,
            "n_requests": self.n_requests,
            "ok": self.ok,
            "arms": self.arms,
            "reasons": list(self.reasons),
        }


@dataclass
class CanaryResult:
    stages: List[CanaryStageReport] = field(default_factory=list)
    promoted: bool = False
    rolled_back: bool = False
    aborted_stage: Optional[int] = None
    n_requests: int = 0
    n_ok: int = 0
    n_shed: int = 0
    reasons: List[str] = field(default_factory=list)

    @property
    def availability(self) -> float:
        admitted = self.n_requests - self.n_shed
        return self.n_ok / admitted if admitted else 1.0

    @property
    def n_failed(self) -> int:
        return self.n_requests - self.n_ok - self.n_shed


class CanaryController:
    """Ramp a gate-passed candidate through live traffic, auto-rolling
    back on regression (module docstring).

    ``registry`` is the serving gateway's ``BundleRegistry`` (both
    bundles registered; incumbent is the default). ``swap_fn`` overrides
    the 100%-stage promotion mechanism — pass a closure over
    ``router.swap_fleet`` to promote a whole fleet two-phase; the default
    is the registry's atomic in-process swap. Rollback uses the same
    mechanism in reverse, so a fleet canary rolls the fleet back. When
    ``swap_fn`` is given, the pre-promote SPLIT stages need their own
    fleet-wide mechanism too (``split_fn``/``clear_split_fn``/
    ``clear_pins_fn`` — e.g. pushing ``/admin/swap`` splits to every
    replica): the local registry's split never touches fleet-routed
    traffic, so without them the ramp stages would pass VACUOUSLY (zero
    candidate traffic) and the 100% swap would be the first real
    exposure. The constructor refuses that configuration — a multi-stage
    fleet ramp without a ``split_fn`` raises instead of silently
    degrading to a 0→100% jump.
    ``results_db`` + ``flush_fn`` wire the per-stage warehouse
    attribution: ``flush_fn`` pushes the gateway bundles' buffered
    telemetry, then the controller reads each arm's ``serve_decision``
    rows since the stage started and attributes decision cost via
    ``data/trace_export.trace_reward`` — and each arm's ``serve_request``
    spans, whose server-measured p95 REPLACES the client-side latency in
    the SLO guards whenever present (``_arm_server_slo``): the serving
    bundle's own clock judges the canary, not the loadgen's.
    ``device`` runs the decision-cost attribution.
    """

    def __init__(
        self,
        registry,
        candidate_hash: str,
        incumbent_hash: str,
        cfg=None,
        stages: Sequence[float] = (5.0, 25.0, 100.0),
        budgets: CanaryBudgets = CanaryBudgets(),
        telemetry=None,
        results_db: Optional[str] = None,
        flush_fn: Optional[Callable[[], None]] = None,
        swap_fn: Optional[Callable[[str], None]] = None,
        split_fn: Optional[Callable[[str, float], None]] = None,
        clear_split_fn: Optional[Callable[[], None]] = None,
        clear_pins_fn: Optional[Callable[[], None]] = None,
        device="cuda",
    ):
        if not stages or stages[-1] < 100.0:
            raise ValueError(
                f"stages must end at 100 (the promotion), got {stages!r}"
            )
        if any(not 0.0 < s <= 100.0 for s in stages) or list(stages) != sorted(
            set(stages)
        ):
            raise ValueError(
                f"stages must be strictly increasing in (0, 100], got {stages!r}"
            )
        if swap_fn is not None and split_fn is None and any(
            s < 100.0 for s in stages
        ):
            raise ValueError(
                "swap_fn (fleet-wide promotion) with pre-100% stages "
                "needs a fleet-wide split_fn too: the local registry's "
                "split never routes fleet traffic, so the ramp stages "
                "would pass vacuously and the 100% swap would be the "
                "candidate's FIRST real exposure. Pass split_fn/"
                "clear_split_fn (e.g. pushing /admin/swap splits to every "
                "replica) or ramp with stages=(100.0,)"
            )
        self.registry = registry
        self.candidate = candidate_hash
        self.incumbent = incumbent_hash
        self.cfg = cfg
        self.stages = list(stages)
        self.budgets = budgets
        self.telemetry = telemetry
        self.results_db = results_db
        self.flush_fn = flush_fn
        self._swap_fn = swap_fn
        self._split_fn = split_fn or registry.set_split
        self._clear_split_fn = clear_split_fn or registry.clear_split
        self._clear_pins_fn = clear_pins_fn or registry.clear_pins
        self.device = resolve_device(device)
        # Running incumbent decision-cost baseline (sum, n) across stages
        # — the comparator of last resort once the incumbent stops
        # serving (the 100% stage).
        self._inc_baseline: Tuple[float, int] = (0.0, 0)

    # -- routing mutations ---------------------------------------------------

    def _swap_to(self, config_hash: str) -> None:
        if self._swap_fn is not None:
            self._swap_fn(config_hash)
        else:
            self.registry.swap(config_hash)

    def _restore_incumbent(self, swapped: bool) -> None:
        """Abort path: clear the split, UNPIN every canaried household
        and restore the incumbent default. The unpin matters: split pins
        survive ``clear_split``, so without it the households already
        routed to the bad candidate would stay pinned to it forever — a
        "rolled-back" fleet still serving the regression to exactly the
        households the canary exposed. ``swapped`` (did the 100% stage's
        swap run?) drives the swap-back DIRECTLY: a fleet-wide
        ``swap_fn`` promotion never touches the local registry's
        default, so gating the reverse swap on ``registry.default_hash``
        alone would leave the FLEET on the bad candidate while reporting
        a rollback. Routing-table mutations only — in-flight requests
        finish on the bundle that admitted them, so a rollback drops
        zero requests."""
        self._clear_split_fn()
        self._clear_pins_fn()
        if swapped or self.registry.default_hash != self.incumbent:
            self._swap_to(self.incumbent)
        self._clear_split_fn()
        self._clear_pins_fn()

    # -- warehouse attribution -----------------------------------------------

    def _arm_decision_cost(
        self, config_hash: str, since_ts: float
    ) -> Tuple[Optional[float], int, int]:
        """(mean decision cost, n decisions, n nonfinite) for one arm
        from the warehouse's ``serve_decision`` rows since ``since_ts`` —
        the same per-bundle config_hash attribution ``telemetry-report
        --compare`` joins on."""
        if self.results_db is None or self.cfg is None:
            return None, 0, 0
        from p2pmicrogrid_tpu_torch.data.trace_export import decision_cost

        con = sqlite3.connect(f"file:{self.results_db}?mode=ro", uri=True)
        try:
            rows = con.execute(
                "SELECT p.attrs_json FROM telemetry_points p "
                "JOIN telemetry_runs t ON t.run_id = p.run_id "
                "WHERE t.config_hash = ? AND p.kind = 'serve_decision' "
                "AND p.ts >= ?",
                (config_hash, since_ts),
            ).fetchall()
        finally:
            con.close()
        obs_rows, act_rows = [], []
        for (attrs_json,) in rows:
            try:
                attrs = json.loads(attrs_json) if attrs_json else {}
            except ValueError:
                continue
            if attrs.get("obs") is None or attrs.get("action") is None:
                continue
            obs_rows.append(attrs["obs"])
            act_rows.append(attrs["action"])
        if not obs_rows:
            return None, 0, 0
        # host-sync: warehouse JSON payloads, host data throughout.
        obs = np.asarray(obs_rows, dtype=np.float32)
        # host-sync: warehouse JSON payloads, host data throughout.
        act = np.asarray(act_rows, dtype=np.float32)
        nonfinite = int((~np.isfinite(obs)).any() or (~np.isfinite(act)).any())
        # Sanitize before the cost model: a NaN action poisons only its
        # own row's cost, and the nonfinite count above already condemns
        # the arm.
        cost = decision_cost(
            self.cfg, np.nan_to_num(obs), np.nan_to_num(act), device=self.device
        )
        return float(cost.mean()), len(obs_rows), nonfinite

    def _arm_server_slo(
        self, config_hash: str, since_ts: float
    ) -> Tuple[Optional[float], int]:
        """(p95 latency ms, n requests) for one arm from the warehouse's
        ``serve_request`` rows since the stage started — the SERVER-side
        record of what the arm's engines actually did. The microbatch
        queue stamps every request with its measured enqueue->dispatch
        wait + batch service time in the serving bundle's telemetry run
        (keyed by config_hash), so a slow replica is charged by its own
        clock: client-side latencies — measured by whatever drove the
        stage — can under-report a stall the loadgen never waited out,
        and a fast loadgen clock must not be able to hide a slow arm."""
        if self.results_db is None:
            return None, 0
        con = sqlite3.connect(f"file:{self.results_db}?mode=ro", uri=True)
        try:
            rows = con.execute(
                "SELECT p.attrs_json FROM telemetry_points p "
                "JOIN telemetry_runs t ON t.run_id = p.run_id "
                "WHERE t.config_hash = ? AND p.kind = 'serve_request' "
                "AND p.ts >= ?",
                (config_hash, since_ts),
            ).fetchall()
            decision_rows = con.execute(
                "SELECT json_extract(p.attrs_json, '$.request_id') "
                "FROM telemetry_points p "
                "JOIN telemetry_runs t ON t.run_id = p.run_id "
                "WHERE t.config_hash = ? AND p.kind = 'serve_decision' "
                "AND p.ts >= ?",
                (config_hash, since_ts),
            ).fetchall()
        except sqlite3.OperationalError:
            return None, 0  # pre-warehouse DB
        finally:
            con.close()
        decision_ids = {str(r) for (r,) in decision_rows if r}
        latencies: List[float] = []
        id_latencies: List[float] = []
        for (attrs_json,) in rows:
            try:
                attrs = json.loads(attrs_json) if attrs_json else {}
            except ValueError:
                continue
            v = attrs.get("latency_ms")
            if not isinstance(v, (int, float)):
                continue
            latencies.append(float(v))
            rid = attrs.get("request_id")
            if rid and str(rid) in decision_ids:
                id_latencies.append(float(v))
        # Exact join: when requests and this arm's decisions share
        # request_ids, the SLO is computed over exactly the requests
        # that produced a recorded decision for THIS arm — a request
        # misattributed by the timestamp-era heuristics (shared queue,
        # clock skew) can no longer charge the wrong arm. Warehouses
        # written before ids existed fall back to every serve_request
        # row under the arm's config_hash, as before.
        if id_latencies:
            latencies = id_latencies
        if not latencies:
            return None, 0
        # host-sync: warehouse JSON payloads, host data.
        return float(np.percentile(np.asarray(latencies), 95)), len(latencies)

    # -- stage evaluation ----------------------------------------------------

    def _expected_arm(self, plan: StagePlan, household: Optional[str]) -> str:
        """The arm the routing table WOULD serve this household from —
        the attribution of last resort for requests whose response
        carries no config_hash (errors, transport failures). Mirrors
        ``BundleRegistry.route``: the promote stage serves everyone from
        the candidate; a split stage routes by the deterministic
        household slot; anonymous traffic serves the default."""
        from p2pmicrogrid_tpu_torch.serve.registry import _household_slot

        if plan.is_promote:
            return self.candidate
        if household and _household_slot(household) < plan.percent:
            return self.candidate
        return self.incumbent

    def _arm_wire_metrics(
        self, traffic: StageTraffic, config_hash: str, plan: StagePlan
    ) -> dict:
        def arm_of(i: int) -> Optional[str]:
            h = traffic.config_hashes[i]
            if h is not None:
                return h
            household = (
                traffic.households[i]
                if i < len(traffic.households) else None
            )
            return self._expected_arm(plan, household)

        idx = [
            i for i in range(len(traffic.config_hashes))
            if arm_of(i) == config_hash
        ]
        errors = sum(
            1 for i in idx
            if traffic.statuses[i] >= 500 or traffic.statuses[i] < 0
        )
        ok = [i for i in idx if traffic.statuses[i] == 200]
        lat = traffic.latencies_ms[ok] if ok else np.zeros((0,))
        nonfinite = 0
        for i in ok:
            a = traffic.actions[i]
            if a is not None and not np.isfinite(
                # host-sync: wire JSON payloads, host data.
                np.asarray(a, dtype=np.float64)
            ).all():
                nonfinite += 1
        return {
            "requests": len(idx),
            "ok": len(ok),
            "errors": errors,
            "nonfinite_actions": nonfinite,
            "p95_ms": (
                round(float(np.percentile(lat, 95)), 3) if lat.size else 0.0
            ),
        }

    def _evaluate_stage(
        self, plan: StagePlan, traffic: StageTraffic, since_ts: float
    ) -> CanaryStageReport:
        b = self.budgets
        arms = {}
        for hash_ in (self.incumbent, self.candidate):
            m = self._arm_wire_metrics(traffic, hash_, plan)
            cost, n_cost, nonfinite_db = self._arm_decision_cost(
                hash_, since_ts
            )
            m["decision_cost"] = (
                round(cost, 6) if cost is not None else None
            )
            m["decisions"] = n_cost
            m["nonfinite_actions"] += nonfinite_db
            # Server-side SLO attribution: when the
            # warehouse carries the arm's own serve_request spans for this
            # stage, THEY are the latency the guards judge — the wire
            # number demotes to detail. A slow replica cannot hide behind
            # a fast loadgen clock.
            server_p95, server_n = self._arm_server_slo(hash_, since_ts)
            if server_p95 is not None:
                m["client_p95_ms"] = m["p95_ms"]
                m["p95_ms"] = round(server_p95, 3)
                m["server_requests"] = server_n
            arms[hash_] = m
        cand, inc = arms[self.candidate], arms[self.incumbent]
        # The incumbent baseline accumulates ACROSS stages: at the 100%
        # (promote) stage the incumbent serves nothing — without the
        # carried baseline, the final stage's cost check would be
        # inconclusive by construction and a slow-burn regression could
        # ship at full traffic.
        if (
            inc["decision_cost"] is not None and inc["decisions"] > 0
        ):
            s, n = self._inc_baseline
            self._inc_baseline = (
                s + inc["decision_cost"] * inc["decisions"],
                n + inc["decisions"],
            )
        if inc["decisions"] < b.min_requests and self._inc_baseline[1] >= (
            b.min_requests
        ):
            s, n = self._inc_baseline
            inc = dict(inc, decision_cost=round(s / n, 6), decisions=n)
            arms[self.incumbent]["baseline_decision_cost"] = inc[
                "decision_cost"
            ]
            arms[self.incumbent]["baseline_decisions"] = n
        reasons: List[str] = []
        if cand["nonfinite_actions"] > 0:
            reasons.append(
                f"candidate served {cand['nonfinite_actions']} nonfinite "
                "action(s) — poisoned bundle live"
            )
        cand_attempts = max(cand["requests"], 1)
        if cand["errors"] / cand_attempts > b.max_error_rate:
            reasons.append(
                f"candidate error rate {cand['errors']}/{cand['requests']} "
                f"over the {b.max_error_rate:g} budget"
            )
        if cand["p95_ms"] > b.slo_p95_ms:
            reasons.append(
                f"candidate p95 {cand['p95_ms']:.1f} ms over the "
                f"{b.slo_p95_ms:g} ms stage budget"
            )
        if (
            inc["p95_ms"] > 0
            and cand["p95_ms"] > b.max_p95_ratio * inc["p95_ms"]
        ):
            reasons.append(
                f"candidate p95 {cand['p95_ms']:.1f} ms > "
                f"{b.max_p95_ratio:g}x incumbent ({inc['p95_ms']:.1f} ms)"
            )
        if (
            cand["decision_cost"] is not None
            and inc["decision_cost"] is not None
            and min(cand["decisions"], inc["decisions"]) >= b.min_requests
        ):
            tol = max(abs(inc["decision_cost"]), 1.0) * b.max_cost_regression
            if cand["decision_cost"] > inc["decision_cost"] + tol:
                reasons.append(
                    f"candidate decision cost {cand['decision_cost']:.4f} "
                    f"regresses the incumbent's {inc['decision_cost']:.4f} "
                    f"past the {b.max_cost_regression:g} tolerance"
                )
        return CanaryStageReport(
            percent=plan.percent,
            n_requests=int(traffic.statuses.shape[0]),
            ok=not reasons,
            arms=arms,
            reasons=reasons,
        )

    # -- the ramp ------------------------------------------------------------

    def run(
        self, drive_stage: Callable[[StagePlan], StageTraffic]
    ) -> CanaryResult:
        """Execute the ramp. ``drive_stage(plan)`` must push live traffic
        while the stage's routing is in effect and report it as a
        ``StageTraffic``. Returns when the candidate promoted through
        the last stage or the ramp aborted and rolled back."""
        result = CanaryResult()
        swapped = False
        self._inc_baseline = (0.0, 0)
        try:
            for i, pct in enumerate(self.stages):
                plan = StagePlan(
                    index=i, percent=pct, is_promote=pct >= 100.0
                )
                if plan.is_promote:
                    # The final stage IS the promotion: default flips to
                    # the candidate (fleet-wide two-phase via swap_fn),
                    # then full traffic is watched before declaring it.
                    self._swap_to(self.candidate)
                    swapped = True
                else:
                    # Widening the split must re-roll household routing:
                    # pins recorded at the previous stage would freeze
                    # the arm's membership (registry.clear_pins).
                    self._clear_pins_fn()
                    self._split_fn(self.candidate, pct)
                since_ts = time.time()
                if self.flush_fn is not None:
                    self.flush_fn()  # stage boundary: drain pre-stage rows
                traffic = drive_stage(plan)
                if self.flush_fn is not None:
                    self.flush_fn()
                report = self._evaluate_stage(plan, traffic, since_ts)
                result.stages.append(report)
                result.n_requests += report.n_requests
                # host-sync: wire statuses, host data.
                result.n_ok += int((traffic.statuses == 200).sum())
                result.n_shed += traffic.n_shed
                if self.telemetry is not None:
                    self.telemetry.event(
                        "promotion",
                        phase="canary_stage",
                        candidate=self.candidate,
                        incumbent=self.incumbent,
                        stage=i,
                        **report.to_fields(),
                    )
                if not report.ok:
                    result.aborted_stage = i
                    result.reasons = report.reasons
                    self._restore_incumbent(swapped)
                    result.rolled_back = True
                    if self.telemetry is not None:
                        self.telemetry.event(
                            "promotion",
                            phase="rolled_back",
                            candidate=self.candidate,
                            incumbent=self.incumbent,
                            stage=i,
                            reasons=report.reasons,
                        )
                        self.telemetry.counter("promotion.rollbacks")
                    return result
            result.promoted = True
            if self.telemetry is not None:
                self.telemetry.event(
                    "promotion",
                    phase="promoted",
                    candidate=self.candidate,
                    incumbent=self.incumbent,
                    stages=[s.to_fields() for s in result.stages],
                )
                self.telemetry.counter("promotion.promotions")
            return result
        except BaseException:
            # A crashed driver/controller must not strand a half-ramped
            # fleet: restore the incumbent, then re-raise.
            if swapped or self.registry.split is not None:
                self._restore_incumbent(swapped)
                result.rolled_back = True
            raise


# -- seeded acceptance harness -------------------------------------------------

# The crafted tabular policies (closed-form, no training): the Q-table
# axis order is [A, time, temp, balance, p2p, action] with action values
# (0.0, 0.5, 1.0) — ops/obs.discretize maps obs[1] (normalized indoor
# temperature) onto the temp axis with bin 1 at the comfort band's
# center-ish; "cold" is the lower half.
INJECTION_KINDS = (
    "good", "cost_regressed", "nan_poisoned", "slo_violating",
)


def make_crafted_bundle(cfg, kind: str, out_dir: str, device="cuda") -> str:
    """Export a crafted tabular bundle for the harness.

    Closed-form policies over the temp axis (``ops/obs.discretize`` maps
    the normalized indoor temperature onto it; the lower half is "cold"):

    * ``incumbent``       — thermostat: full power when cold, off when
                            warm (the healthy reference policy).
    * ``good``            — eco-thermostat: full power only when VERY
                            cold, half power when mildly cold, off when
                            warm — strictly less energy than the
                            incumbent while still heating, so it beats
                            the incumbent's cost without collapsing
                            comfort (the genuinely-better candidate).
    * ``cost_regressed``  — always heat at full power: comfort is fine,
                            the energy bill is not (the gate's cost rule
                            must block it; forced past the gate, the
                            live decision-cost attribution must catch
                            its overheating waste).
    * ``nan_poisoned``    — the good table with NaNs written through it.
    * ``slo_violating``   — the good table (its latency injection lives
                            in the bench clock, mirroring faults.py's
                            stall kind — a bundle's params cannot carry
                            slowness, its serving measurement can).
    """
    from p2pmicrogrid_tpu_torch.serve.export import export_policy_bundle
    from p2pmicrogrid_tpu_torch.train import init_policy_state

    if cfg.train.implementation != "tabular":
        raise ValueError("crafted harness bundles are tabular-only")
    ps = init_policy_state(cfg, device)
    q = np.zeros(ps.q_table.shape, dtype=np.float32)
    ntp = cfg.qlearning.num_temp_states
    bins = np.arange(ntp)
    mid = ntp // 2
    cold = bins < mid                 # below the setpoint
    very_cold = bins < max(mid - 3, 1)  # well below it
    if kind == "incumbent":
        q[:, :, cold, :, :, 2] = 1.0   # cold -> full power
        q[:, :, ~cold, :, :, 0] = 1.0  # warm -> off
    elif kind in ("good", "nan_poisoned", "slo_violating"):
        q[:, :, very_cold, :, :, 2] = 1.0          # very cold -> full
        q[:, :, cold & ~very_cold, :, :, 1] = 1.0  # mildly cold -> half
        q[:, :, ~cold, :, :, 0] = 1.0              # warm -> off
        if kind == "nan_poisoned":
            q[..., :] = np.nan
    elif kind == "cost_regressed":
        q[..., 2] = 1.0  # always full power: pure energy waste
    else:
        raise ValueError(f"unknown crafted kind {kind!r}")
    ps.q_table.copy_(torch.from_numpy(q))
    return export_policy_bundle(
        cfg, ps, out_dir, source={"kind": f"crafted:{kind}"}, device=device
    )


def _drive_wire_stage(
    host: str,
    port: int,
    obs: np.ndarray,
    households: List[str],
    timeout_s: float = 30.0,
) -> StageTraffic:
    """Fire one request per obs row at a live gateway over real HTTP
    (sequential — the harness measures safety semantics, not throughput;
    serve-bench owns the SLO measurements)."""
    n = obs.shape[0]
    statuses = np.full(n, -1, dtype=np.int64)
    latencies = np.zeros(n)
    hashes: List[Optional[str]] = [None] * n
    actions: List[Optional[list]] = [None] * n
    sent_households: List[Optional[str]] = [
        households[i % len(households)] for i in range(n)
    ]
    n_shed = 0
    for i in range(n):
        body = json.dumps({
            "household": sent_households[i],
            "obs": obs[i].tolist(),
        })
        conn = http.client.HTTPConnection(host, port, timeout=timeout_s)
        t0 = time.perf_counter()
        try:
            conn.request(
                "POST", "/v1/act", body=body,
                headers={"Content-Type": "application/json"},
            )
            resp = conn.getresponse()
            raw = resp.read()
            latencies[i] = (time.perf_counter() - t0) * 1e3
            statuses[i] = resp.status
            if resp.status == 429:
                n_shed += 1
            if resp.status == 200:
                doc = json.loads(raw)
                hashes[i] = doc.get("config_hash")
                actions[i] = doc.get("actions")
        except (OSError, ValueError):
            latencies[i] = (time.perf_counter() - t0) * 1e3
        finally:
            conn.close()
    return StageTraffic(
        statuses=statuses,
        latencies_ms=latencies,
        config_hashes=hashes,
        actions=actions,
        households=sent_households,
        n_shed=n_shed,
    )


def run_promotion_pipeline(
    cfg,
    candidate_dir: str,
    incumbent_dir: str,
    gate_budgets: GateBudgets = GateBudgets(),
    canary_budgets: CanaryBudgets = CanaryBudgets(),
    stages: Sequence[float] = (5.0, 25.0, 100.0),
    results_db: Optional[str] = None,
    telemetry=None,
    seed: int = 0,
    requests_per_stage: int = 256,
    n_households: int = 128,
    skip_gate: bool = False,
    s_eval: int = 8,
    max_batch: int = 16,
    gate_service_time_fn: Optional[Callable[[int, int], float]] = None,
    incumbent_eval: Optional[Tuple[float, float]] = None,
    regime_specs: Optional[Sequence] = None,
    regime_s_per_regime: int = 4,
    batching: str = "continuous",
    device="cuda",
    eval_draws=None,
    eval_normals: Optional[torch.Tensor] = None,
) -> dict:
    """Gate + canary for ONE candidate against a live in-process gateway.

    Builds a gateway over ``[incumbent, candidate]`` (incumbent default),
    runs the offline gate (unless ``skip_gate`` — the operator-override
    path whose misuse the canary exists to survive), then ramps the
    candidate with live wire traffic per stage. Returns the
    ``promotion_case``-row fields: gate verdict, per-stage canary
    reports, availability, rolled_back/promoted flags and a bit-exact
    check of the post-rollback (or post-promote) serving path against
    the bundle that should be serving.

    ``batching`` selects the gateway queue front; the default is now the
    slot-level ``"continuous"`` batcher (bit-exact vs ``"micro"`` for the
    stateless bundles promotion serves, verified per-request here by the
    post-ramp bit-exact check against a direct engine). Pass ``"micro"``
    for the coalescing-window queue.

    ``device`` runs the gate's evaluations and bench, the gateway's engines
    and the reference engine of the post-ramp check. That check sends its
    requests one at a time, so each is served at padding bucket 1, and
    holds each answer to the reference engine's act on that one
    observation: a DDPG answer may differ by an ulp between buckets
    (ROADMAP.md, Queue 3), the same bucket is the same arithmetic.
    """
    from p2pmicrogrid_tpu_torch.serve.engine import PolicyEngine
    from p2pmicrogrid_tpu_torch.serve.export import load_policy_bundle
    from p2pmicrogrid_tpu_torch.serve.gateway import (
        AdmissionConfig,
        GatewayServer,
        build_gateway,
    )
    from p2pmicrogrid_tpu_torch.serve.loadgen import synthetic_obs

    device = resolve_device(device)
    cand_hash = load_policy_bundle(candidate_dir)[0].get("config_hash")
    inc_hash = load_policy_bundle(incumbent_dir)[0].get("config_hash")

    gate_fields = None
    if not skip_gate:
        verdict = run_promotion_gate(
            cfg, candidate_dir, incumbent_dir,
            budgets=gate_budgets, telemetry=telemetry,
            s_eval=s_eval, bench_seed=seed, max_batch=max_batch,
            service_time_fn=gate_service_time_fn,
            incumbent_eval=incumbent_eval,
            regime_specs=regime_specs,
            regime_s_per_regime=regime_s_per_regime,
            device=device,
            eval_draws=eval_draws,
            eval_normals=eval_normals,
        )
        gate_fields = verdict.to_fields()
        if not verdict.passed:
            return {
                "candidate": cand_hash,
                "incumbent": inc_hash,
                "gate_verdict": verdict.verdict,
                "blocked_at_gate": True,
                "canary_stages": [],
                "availability": 1.0,
                "rolled_back": False,
                "promoted": False,
                "n_requests": 0,
                "bit_exact_after": None,
                "gate": gate_fields,
            }

    gateway = build_gateway(
        [incumbent_dir, candidate_dir],
        max_batch=max_batch,
        max_wait_s=0.005,
        results_db=results_db,
        device=device,
        admission=AdmissionConfig(
            max_queue_depth=100_000, wait_budget_ms=1e9
        ),
        run_name="promotion",
        batching=batching,
    )
    server = GatewayServer(gateway)
    host, port = server.start()
    try:
        def flush() -> None:
            for h in gateway.registry.hashes:
                tel = gateway.registry.get(h).telemetry
                if tel is not None:
                    tel.flush()

        households = [f"house-{i:04d}" for i in range(n_households)]

        def drive(plan: StagePlan) -> StageTraffic:
            obs = synthetic_obs(
                requests_per_stage, cfg.sim.n_agents,
                seed=seed + 101 * (plan.index + 1),
            )
            return _drive_wire_stage(host, port, obs, households)

        controller = CanaryController(
            gateway.registry,
            candidate_hash=cand_hash,
            incumbent_hash=inc_hash,
            cfg=cfg,
            stages=stages,
            budgets=canary_budgets,
            telemetry=telemetry,
            results_db=results_db,
            flush_fn=flush if results_db else None,
            device=device,
        )
        result = controller.run(drive)

        # After the ramp settles, the serving default must be the right
        # bundle AND serve bit-exact to a direct engine on that bundle —
        # a rolled-back fleet serving approximately-the-incumbent is
        # still a failed rollback.
        expect_dir = candidate_dir if result.promoted else incumbent_dir
        expect_hash = cand_hash if result.promoted else inc_hash
        check_obs = synthetic_obs(8, cfg.sim.n_agents, seed=seed + 9999)
        check = _drive_wire_stage(host, port, check_obs, households[:1])
        reference = PolicyEngine(
            bundle_dir=expect_dir, max_batch=max_batch, device=device
        )
        want = np.concatenate(
            [reference.act(check_obs[i:i + 1]) for i in range(check_obs.shape[0])]
        )
        bit_exact = bool(
            (check.statuses == 200).all()
            and all(h == expect_hash for h in check.config_hashes)
            # host-sync: wire JSON payloads, host data.
            and (np.asarray(check.actions, dtype=np.float32) == want).all()
        )
    finally:
        server.stop()

    return {
        "candidate": cand_hash,
        "incumbent": inc_hash,
        "gate_verdict": (
            "skipped" if skip_gate else "pass"
        ),
        "blocked_at_gate": False,
        "canary_stages": [s.to_fields() for s in result.stages],
        "availability": round(result.availability, 6),
        "rolled_back": result.rolled_back,
        "promoted": result.promoted,
        "n_requests": result.n_requests,
        "n_failed": result.n_failed,
        "aborted_stage": result.aborted_stage,
        "abort_reasons": result.reasons,
        "bit_exact_after": bit_exact,
        "gate": gate_fields,
    }


def promotion_bench(
    cfg,
    work_dir: str,
    cases: Sequence[str] = INJECTION_KINDS,
    seed: int = 0,
    requests_per_stage: int = 192,
    n_households: int = 128,
    stages: Sequence[float] = (5.0, 25.0, 100.0),
    results_db: Optional[str] = None,
    telemetry=None,
    emit: Optional[Callable[[dict], None]] = None,
    slo_stall_s: float = 0.25,
    gate_budgets: GateBudgets = GateBudgets(),
    canary_budgets: CanaryBudgets = CanaryBudgets(),
    device="cuda",
) -> List[dict]:
    """The seeded bad-candidate injection harness (``promote --inject``).

    One ``promotion_case`` metric row per case (gate verdict, canary
    stages, availability, rolled_back/promoted, bit-exactness after) and
    a final ``promotion_bench`` headline. Case semantics:

    * ``good``           — full pipeline; MUST promote end-to-end.
    * ``cost_regressed`` — gate blocks it; then the same candidate is
      forced past the gate (``skip_gate`` — the operator-override path)
      and MUST be rolled back mid-canary by live cost attribution.
    * ``nan_poisoned``   — gate blocks on a non-finite held-out eval.
    * ``slo_violating``  — gate blocks on the modeled serve-bench SLO
      (``slo_stall_s`` per batch on the virtual clock — the stall-fault
      analogue for a candidate that is correct but too slow).

    Deterministic under ``seed``: crafted closed-form policies, seeded
    obs/household streams, virtual-clock SLO timing.
    """
    import os

    device = resolve_device(device)
    os.makedirs(work_dir, exist_ok=True)
    incumbent_dir = make_crafted_bundle(
        cfg, "incumbent", os.path.join(work_dir, "incumbent"), device=device
    )
    # The incumbent's held-out eval is the same for every case: compute
    # it once instead of once per gate.
    incumbent_eval = evaluate_bundle_cost(cfg, incumbent_dir, device=device)
    rows: List[dict] = []
    outcomes: dict = {}

    def case_row(case: str, fields: dict, expected: str) -> dict:
        ok = {
            "promoted": fields.get("promoted", False)
            and not fields.get("rolled_back", False),
            "blocked": fields.get("blocked_at_gate", False),
            "rolled_back": fields.get("rolled_back", False)
            and not fields.get("promoted", False),
        }[expected]
        outcomes[case] = ok
        return {
            "metric": "promotion_case",
            "value": float(fields.get("availability", 1.0)),
            "unit": "availability",
            "vs_baseline": 1.0 if ok else 0.0,
            "case": case,
            "expected": expected,
            "outcome_ok": ok,
            "seed": seed,
            **fields,
        }

    for case in cases:
        cand_cfg = cfg.replace(
            train=dataclasses.replace(
                cfg.train,
                # Distinct config_hash per crafted candidate: the
                # registry/canary key. Generations continue the episode
                # count exactly like train/continual.py's candidates.
                starting_episodes=cfg.train.starting_episodes + 100
                + INJECTION_KINDS.index(case),
            )
        )
        cand_dir = make_crafted_bundle(
            cand_cfg, case, os.path.join(work_dir, case), device=device
        )
        stall_fn = None
        if case == "slo_violating":
            stall_fn = lambda i, j: slo_stall_s  # noqa: E731
        fields = run_promotion_pipeline(
            cfg, cand_dir, incumbent_dir,
            gate_budgets=gate_budgets,
            canary_budgets=canary_budgets,
            stages=stages,
            results_db=results_db,
            telemetry=telemetry,
            seed=seed + INJECTION_KINDS.index(case),
            requests_per_stage=requests_per_stage,
            n_households=n_households,
            gate_service_time_fn=stall_fn,
            incumbent_eval=incumbent_eval,
            device=device,
        )
        expected = "promoted" if case == "good" else "blocked"
        rows.append(case_row(case, fields, expected))
        if case == "cost_regressed":
            # The dangerous half: force the regressed candidate past the
            # gate (operator override) — the canary must catch it live.
            forced = run_promotion_pipeline(
                cfg, cand_dir, incumbent_dir,
                gate_budgets=gate_budgets,
                canary_budgets=canary_budgets,
                stages=stages,
                results_db=results_db,
                telemetry=telemetry,
                seed=seed + 100,
                requests_per_stage=requests_per_stage,
                n_households=n_households,
                skip_gate=True,
                device=device,
            )
            rows.append(
                case_row("cost_regressed_forced", forced, "rolled_back")
            )

    all_safe = all(outcomes.values())
    rows.append(
        {
            "metric": "promotion_bench",
            "value": float(sum(outcomes.values())),
            "unit": "cases_ok",
            "vs_baseline": 1.0 if all_safe else 0.0,
            "cases": {k: bool(v) for k, v in outcomes.items()},
            "all_safe": all_safe,
            "seed": seed,
            "stages": list(stages),
            "requests_per_stage": requests_per_stage,
        }
    )
    if emit is not None:
        for row in rows:
            emit(row)
    return rows
