"""Scenario regime engine: composable worlds as data on the scenario axis.

The port of the JAX package's ``regimes/``. One ``RegimeSpec`` composes
weather/season transforms, EV charging as a second schedulable load,
demand-response / islanding event windows and the market mechanism
(``ops/auction.py``); a portfolio of specs becomes ``RegimeParams`` [S]
tensors, so one episode function (and one CUDA graph of the chunk episode)
trains and evaluates a mixed-regime batch; ``regimes/bench.py`` is the
acceptance harness (portfolio training, per-regime eval tables, the
regime-aware promotion gate case).
"""

from p2pmicrogrid_tpu_torch.regimes.engine import (
    RegimeCounters,
    apply_weather_regimes,
    ev_charge_step,
    init_ev_need,
    rc_add,
    rc_from_slot,
    rc_to_dicts,
    rc_zero,
    regime_slot_batched,
)
from p2pmicrogrid_tpu_torch.regimes.evaluate import (
    REGIME_EVAL_SEED,
    evaluate_bundle_regimes,
    evaluate_regimes,
    make_regime_eval,
)
from p2pmicrogrid_tpu_torch.regimes.spec import (
    REGIME_LIBRARY,
    RegimeParams,
    RegimeSpec,
    assign_regimes,
    assignment_one_hot,
    regime_assignment,
    resolve_specs,
    stack_regime_params,
)
from p2pmicrogrid_tpu_torch.regimes.train import (
    RegimePortfolio,
    build_portfolio,
    make_regime_episode_fn,
    refuse_fused_regimes,
    train_regime_portfolio,
)

__all__ = [
    "REGIME_EVAL_SEED",
    "REGIME_LIBRARY",
    "RegimeCounters",
    "RegimeParams",
    "RegimePortfolio",
    "RegimeSpec",
    "apply_weather_regimes",
    "assign_regimes",
    "assignment_one_hot",
    "build_portfolio",
    "ev_charge_step",
    "evaluate_bundle_regimes",
    "evaluate_regimes",
    "init_ev_need",
    "make_regime_episode_fn",
    "make_regime_eval",
    "rc_add",
    "rc_from_slot",
    "rc_to_dicts",
    "rc_zero",
    "refuse_fused_regimes",
    "regime_assignment",
    "regime_slot_batched",
    "resolve_specs",
    "stack_regime_params",
    "train_regime_portfolio",
]
