"""The regime-portfolio acceptance harness.

The port of the JAX package's ``regimes/bench.py``. ``run_regime_bench``
drives the regime claim end to end on ``device`` and returns it as metric
rows (one JSON object per line through the guarded stdout sink, headline
last):

1. **portfolio training** — a mixed batch of >= 4 regimes trains through ONE
   shared-scenario episode function whose regime fields are data: the [S]
   tensors it reads (``episode.regimes``) keep their addresses across the
   run, so one CUDA graph of the chunk episode serves any portfolio of the
   same S. ``single_compile`` reports that invariant (the JAX package's
   ``jitted._cache_size() == 1``), with per-regime counter attribution per
   episode.
2. **per-regime eval table** — the trained policy's greedy cost/comfort/
   trade breakdown on the TRAIN regime set and on a HELD-OUT regime set
   (``regime_eval`` rows; also warehouse events when a telemetry rides).
3. **the gate case** — a crafted candidate ("siesta": half-power daytime
   heating) that BEATS the incumbent thermostat on mean held-out cost and
   comfort, improves most regimes — and back-loads its heating into the
   evening, regressing the held-out demand-response-spike regime. The
   plain gate passes it; the regime-aware gate blocks it
   (``regime_gate_case`` row records both verdicts).
4. **headline** — the ``regime_generalization`` row: train-set vs
   held-out-set mean cost, the gap, per-regime costs, the single-graph
   verdict.
"""

from __future__ import annotations

import time
from typing import Sequence

import numpy as np
import torch

from p2pmicrogrid_tpu_torch.device import resolve_device

DEFAULT_TRAIN_REGIMES = ("baseline", "winter", "ev_evening", "double_auction")
DEFAULT_HELD_OUT_REGIMES = (
    "dr_spike", "islanding_noon", "cold_snap", "uniform_price"
)


def bench_config(
    n_agents: int, n_scenarios: int, implementation: str, seed: int
):
    """The ExperimentConfig ``run_regime_bench`` trains under — exposed so
    the CLI stamps its warehouse manifest with the SAME config_hash the
    harness actually runs (one builder, no drift)."""
    from p2pmicrogrid_tpu_torch.config import SimConfig, TrainConfig, default_config

    return default_config(
        sim=SimConfig(n_agents=n_agents, n_scenarios=n_scenarios),
        train=TrainConfig(implementation=implementation, seed=seed),
    )


def make_regime_crafted_bundle(cfg, kind: str, out_dir: str, device="cuda") -> str:
    """Crafted tabular bundles for the regime gate case.

    * ``thermostat`` — the incumbent: full power when the temperature bin
      is below the setpoint, off above (serve/promotion.py's incumbent).
    * ``siesta`` — the mean-better / regime-worse candidate: thermostat
      behavior in the morning/night, but during the working-day time bins
      it heats at HALF power and only when very cold, then runs an
      evening RECOVERY with the setpoint raised one temperature bin
      (full power up to one bin past the thermostat's cutoff). It uses
      less energy overall (beats the incumbent's mean held-out cost) and
      holds comfort (no basin-guard trip) — but the heat it skipped by
      day comes back as evening recovery heating, concentrated exactly in
      a demand-response spike window, so the ``dr_spike`` regime's cost
      REGRESSES. The plain mean-cost gate ships it; the per-regime gate
      must not.
    """
    from p2pmicrogrid_tpu_torch.serve.export import export_policy_bundle
    from p2pmicrogrid_tpu_torch.train import init_policy_state

    if cfg.train.implementation != "tabular":
        raise ValueError("crafted regime bundles are tabular-only")
    ps = init_policy_state(cfg, device)
    q = np.zeros(tuple(ps.q_table.shape), dtype=np.float32)
    ql = cfg.qlearning
    bins = np.arange(ql.num_temp_states)
    mid = ql.num_temp_states // 2
    cold = bins < mid
    very_cold = bins < max(mid - 3, 1)
    tb = np.arange(ql.num_time_states)
    # Working-day time bins ~07:00-16:45 at the 20-bin day discretizer;
    # evening bins ~16:45-21:35 straddle the dr_spike window (17:00-21:00).
    day_bins = np.where((tb >= 6) & (tb < 14))[0]
    evening_bins = np.where((tb >= 14) & (tb < 18))[0]
    q[:, :, cold, :, :, 2] = 1.0   # cold -> full power
    q[:, :, ~cold, :, :, 0] = 1.0  # warm -> off
    if kind == "siesta":
        for t in day_bins:
            q[:, t, :, :, :, :] = 0.0
            q[:, t, :, :, :, 0] = 1.0            # day: default off
            q[:, t, very_cold, :, :, :] = 0.0
            q[:, t, very_cold, :, :, 1] = 1.0    # day + very cold: half
        recovery = bins < mid + 1  # setpoint raised one bin
        for t in evening_bins:
            q[:, t, :, :, :, :] = 0.0
            q[:, t, :, :, :, 0] = 1.0            # evening: default off
            q[:, t, recovery, :, :, :] = 0.0
            q[:, t, recovery, :, :, 2] = 1.0     # evening recovery: full
    elif kind != "thermostat":
        raise ValueError(f"unknown crafted regime kind {kind!r}")
    ps.q_table.copy_(torch.from_numpy(q))
    return export_policy_bundle(
        cfg, ps, out_dir, source={"kind": f"crafted-regime:{kind}"}, device=device
    )


def run_regime_bench(
    train_regimes: Sequence = DEFAULT_TRAIN_REGIMES,
    held_out_regimes: Sequence = DEFAULT_HELD_OUT_REGIMES,
    n_agents: int = 3,
    scenarios_per_regime: int = 2,
    episodes: int = 3,
    s_eval_per_regime: int = 4,
    implementation: str = "tabular",
    seed: int = 0,
    telemetry=None,
    gate_case: bool = True,
    emit=None,
    device="cuda",
) -> list:
    """The full harness (module docstring). Returns every metric row in
    emission order, headline last; ``emit(row)`` (when given) streams each
    row as it is produced — the CLI wires the guarded stdout sink here.
    Small by construction (a tiny community, few episodes): the claims
    (one episode function over fixed regime tensors, per-regime attribution,
    gate verdicts) do not depend on the size. Episodes draw from a
    generator on ``device`` seeded ``seed + 100`` (the warm episode), then
    ``seed + 101 + e``, as the JAX package's keys are."""
    import tempfile

    from p2pmicrogrid_tpu_torch.envs import make_ratings
    from p2pmicrogrid_tpu_torch.parallel.scenarios import (
        init_shared_state,
        make_scenario_traces,
        stack_scenario_arrays,
    )
    from p2pmicrogrid_tpu_torch.regimes.engine import rc_to_dicts
    from p2pmicrogrid_tpu_torch.regimes.evaluate import evaluate_regimes
    from p2pmicrogrid_tpu_torch.regimes.train import build_portfolio, make_regime_episode_fn
    from p2pmicrogrid_tpu_torch.train import make_policy

    dev = resolve_device(device)
    gen = lambda s: torch.Generator(device=dev).manual_seed(s)  # noqa: E731
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    rows: list = []

    def push(row):
        rows.append(row)
        if emit is not None:
            emit(row)

    train_regimes = list(train_regimes)
    held_out_regimes = list(held_out_regimes)
    S = scenarios_per_regime * len(train_regimes)
    cfg = bench_config(n_agents, S, implementation, seed)
    ratings = make_ratings(cfg, np.random.default_rng(seed))
    policy = make_policy(cfg)
    traces = make_scenario_traces(cfg, seed=seed)
    arrays = stack_scenario_arrays(cfg, traces, ratings, device=dev)
    slots = int(arrays.time.shape[1])

    # 1. One episode function over the mixed train portfolio.
    pf = build_portfolio(train_regimes, S, device=dev)
    episode_fn = make_regime_episode_fn(
        cfg, policy, ratings, pf.scenario_params, arrays_s=arrays,
        collect_regime_metrics=True, one_hot=pf.one_hot, specs=pf.specs,
        device=dev,
    )
    addresses = [x.data_ptr() for x in episode_fn.regimes]
    carry = init_shared_state(cfg, dev, gen(seed))
    carry, _ = episode_fn(carry, gen(seed + 100))  # warm
    sync()  # host-sync: bench timing boundary
    start = time.time()
    rc = None
    for e in range(episodes):
        carry, ys = episode_fn(carry, gen(seed + 101 + e))
        rc = ys[2]
    sync()  # host-sync: bench timing boundary
    secs = time.time() - start
    single_compile = [x.data_ptr() for x in episode_fn.regimes] == addresses
    rate = episodes * slots * S / max(secs, 1e-9)
    pol_state = carry[0]
    last_counters = rc_to_dicts(rc, list(pf.names))
    push({
        "metric": f"regime_portfolio_train_{len(train_regimes)}regimes",
        "value": round(rate, 1),
        "unit": "env-steps/sec",
        "vs_baseline": 1.0,
        "single_compile": bool(single_compile),
        "train_regimes": list(pf.names),
        "n_scenarios": S,
        "episodes": episodes,
        "implementation": implementation,
        "per_regime_counters": [
            {k: (round(v, 3) if isinstance(v, float) else v)
             for k, v in d.items()}
            for d in last_counters
        ],
    })

    # 2. Per-regime eval tables: train set, then held-out set.
    per_regime_cost: dict = {}
    set_means = {}
    for names, held in ((train_regimes, False), (held_out_regimes, True)):
        table = evaluate_regimes(
            cfg, policy, pol_state, ratings, names,
            generator=gen(seed + 1), s_per_regime=s_eval_per_regime,
            telemetry=telemetry, held_out=held, device=dev,
        )
        costs = []
        for d in table:
            per_regime_cost[d["regime"]] = d["cost_eur"]
            costs.append(d["cost_eur"])
            push({
                "metric": "regime_eval",
                "value": round(d["cost_eur"], 4),
                "unit": "eur/scenario-day",
                "vs_baseline": 1.0,
                **{k: (round(v, 4) if isinstance(v, float) else v)
                   for k, v in d.items()},
            })
        set_means["held_out" if held else "train"] = float(np.mean(costs))

    # 3. The gate case: mean-better / regime-worse candidate.
    gate_row = None
    if gate_case:
        from p2pmicrogrid_tpu_torch.config import (
            SimConfig,
            TrainConfig,
            default_config,
        )
        from p2pmicrogrid_tpu_torch.serve.promotion import (
            GateBudgets,
            run_promotion_gate,
        )

        gate_cfg = default_config(
            sim=SimConfig(n_agents=n_agents),
            train=TrainConfig(implementation="tabular", seed=seed),
        )
        service_time_fn = lambda batch, padded: 1e-3  # noqa: E731 — modeled clock
        with tempfile.TemporaryDirectory() as tmp:
            inc = make_regime_crafted_bundle(
                gate_cfg, "thermostat", f"{tmp}/incumbent", device=dev
            )
            cand = make_regime_crafted_bundle(
                gate_cfg, "siesta", f"{tmp}/candidate", device=dev
            )
            plain = run_promotion_gate(
                gate_cfg, cand, inc, budgets=GateBudgets(),
                service_time_fn=service_time_fn, telemetry=telemetry,
                device=dev,
            )
            gated = run_promotion_gate(
                gate_cfg, cand, inc, budgets=GateBudgets(),
                service_time_fn=service_time_fn, telemetry=telemetry,
                regime_specs=held_out_regimes,
                regime_s_per_regime=s_eval_per_regime,
                # Reuse the plain call's incumbent held-out eval — the
                # gate API shares it so the second verdict only pays the
                # per-regime work.
                incumbent_eval=(
                    plain.incumbent_cost, plain.incumbent_reward
                ),
                device=dev,
            )
        regressed = [
            name for name, c in gated.candidate_regime_costs.items()
            if c > gated.incumbent_regime_costs.get(name, float("inf"))
        ]
        gate_row = {
            "metric": "regime_gate_case",
            "value": 0.0 if gated.passed else 1.0,
            "unit": "blocked",
            "vs_baseline": 1.0,
            "blocked": bool(not gated.passed),
            "mean_improved": bool(
                plain.candidate_cost < plain.incumbent_cost
            ),
            "passed_without_regime_gate": bool(plain.passed),
            "regressed_regime": regressed[0] if regressed else "",
            "candidate_cost": round(float(plain.candidate_cost), 4),
            "incumbent_cost": round(float(plain.incumbent_cost), 4),
            "candidate_regime_costs": {
                k: round(float(v), 4)
                for k, v in gated.candidate_regime_costs.items()
            },
            "incumbent_regime_costs": {
                k: round(float(v), 4)
                for k, v in gated.incumbent_regime_costs.items()
            },
            "reasons": list(gated.reasons),
        }
        push(gate_row)

    # 4. Headline: the regime-generalization row (train on A, eval on B).
    gap = set_means["held_out"] - set_means["train"]
    push({
        "metric": (
            f"regime_generalization_{implementation}_"
            f"{len(train_regimes)}train_{len(held_out_regimes)}held_out"
        ),
        "value": round(set_means["held_out"], 4),
        "unit": "eur/scenario-day",
        "vs_baseline": 1.0,
        "held_out": True,
        "train_regimes": [
            r if isinstance(r, str) else getattr(r, "name", str(r))
            for r in train_regimes
        ],
        "held_out_regimes": [
            r if isinstance(r, str) else getattr(r, "name", str(r))
            for r in held_out_regimes
        ],
        "train_cost_eur": round(set_means["train"], 4),
        "held_out_cost_eur": round(set_means["held_out"], 4),
        "generalization_gap": round(gap, 4),
        "per_regime_cost": {
            k: round(v, 4) for k, v in per_regime_cost.items()
        },
        "single_compile": bool(single_compile),
        "n_regimes": len(train_regimes) + len(held_out_regimes),
        "episodes": episodes,
        "n_scenarios": S,
        "env_steps_per_sec": round(rate, 1),
        "implementation": implementation,
        "gate_blocked_regime_regression": bool(
            gate_row["blocked"] if gate_row else False
        ),
    })
    return rows
