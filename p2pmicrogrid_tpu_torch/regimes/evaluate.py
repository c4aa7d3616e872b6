"""Per-regime greedy evaluation: the regime dimension of every verdict.

The port of the JAX package's ``regimes/evaluate.py``. ``make_regime_eval``
is the regime-portfolio mirror of ``train/health.py::make_greedy_eval``: a
greedy (explore=False) episode over a FIXED held-out mixed-regime scenario
batch, returning per-regime cost and reward and the per-regime
``RegimeCounters``, whatever the portfolio mixes. ``evaluate_regimes`` is
the host-facing table: one dict per regime, each also emitted as a
``regime_eval`` telemetry event.

``evaluate_bundle_regimes`` grafts a serving bundle into a learner through
``train/continual.py::state_from_bundle`` and evaluates it per regime. The
JAX package shares one compiled program between the bundles a gate
compares; the port shares one evaluation (``eval_fn``) and, given
``pol_state``, one learner state, into whose tensors each bundle's
parameters are copied in place.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from p2pmicrogrid_tpu_torch.config import ExperimentConfig
from p2pmicrogrid_tpu_torch.device import resolve_device
from p2pmicrogrid_tpu_torch.envs.community import init_physical, ratings_to
from p2pmicrogrid_tpu_torch.regimes.engine import (
    apply_weather_regimes,
    init_ev_need,
    rc_add,
    rc_from_slot,
    rc_to_dicts,
    rc_zero,
    regime_slot_batched,
)
from p2pmicrogrid_tpu_torch.regimes.train import RegimePortfolio, build_portfolio

# Held-out eval draws: distinct from the training seeds and from the health
# eval's fixed set (train/health.py uses 10_000).
REGIME_EVAL_SEED = 20_000


def make_regime_eval(
    cfg: ExperimentConfig,
    policy,
    ratings,
    portfolio: RegimePortfolio,
    s_per_regime: int = 4,
    eval_seed: int = REGIME_EVAL_SEED,
    draws=None,
    device="cuda",
):
    """``fn(pol_state, generator=None, rp=None, normals=None) -> (cost_r
    [R], reward_r [R], RegimeCounters)`` over a fixed held-out batch of ``R
    * s_per_regime`` scenarios (regime r owns scenarios [r*s, (r+1)*s), so
    per-regime means are exact segment means), its traces made once on
    ``device`` from a generator seeded ``eval_seed``, or from ``draws`` (a
    ``parallel/device_gen.py::TraceDraws``; the tests inject the JAX
    package's). ``generator`` draws the initial temperatures (default:
    seeded ``eval_seed + 1``) unless ``normals`` [S, 2, A] gives them;
    ``rp`` overrides the portfolio's [S] params (same regimes, other
    values)."""
    from p2pmicrogrid_tpu_torch.parallel.device_gen import device_episode_arrays

    dev = resolve_device(device)
    R = portfolio.n_regimes
    S = R * s_per_regime
    A = cfg.sim.n_agents
    block = np.repeat(np.arange(R), s_per_regime).astype(np.int32)
    pf = build_portfolio(list(portfolio.specs), S, assignment=block, device=dev)
    ratings_d = ratings_to(ratings, dev)
    if draws is None:
        eval_arrays = device_episode_arrays(
            cfg, ratings_d, S, generator=torch.Generator(device=dev).manual_seed(eval_seed), device=dev
        )
    else:
        eval_arrays = device_episode_arrays(
            cfg, ratings_d, S, draws=type(draws)(*(x.to(dev) for x in draws)), device=dev
        )
    counts = pf.one_hot.sum(dim=0)  # [R] scenarios per regime

    @torch.no_grad()
    def eval_fn(pol_state, generator: Optional[torch.Generator] = None, rp=None, normals=None):
        rp = pf.scenario_params if rp is None else rp
        if normals is None:
            if generator is None:
                generator = torch.Generator(device=dev).manual_seed(eval_seed + 1)
            normals = torch.randn((S, 2, A), generator=generator, device=dev)
        phys = init_physical(cfg, normals.to(dev), (S,), device=dev)
        arrs = apply_weather_regimes(eval_arrays, rp)
        xs = tuple(x.transpose(0, 1) for x in arrs)
        ev_need = init_ev_need(rp, A)
        rc = rc_zero(R, dev)
        cost_s = torch.zeros((S,), device=dev)
        reward_s = torch.zeros((S,), device=dev)
        for t in range(xs[0].shape[0]):
            phys, _, out, _, _, ev_need, extras = regime_slot_batched(
                cfg, policy, pol_state, phys, ev_need, tuple(x[t] for x in xs), None,
                ratings_d, rp, explore=False,
            )
            rc = rc_add(rc, rc_from_slot(cfg, out, extras, pf.one_hot))
            cost_s = cost_s + out.cost.sum(dim=-1)
            reward_s = reward_s + out.reward.mean(dim=-1)
        return (cost_s @ pf.one_hot) / counts, (reward_s @ pf.one_hot) / counts, rc

    eval_fn.portfolio = pf
    eval_fn.s_per_regime = s_per_regime
    eval_fn.arrays = eval_arrays
    return eval_fn


def evaluate_regimes(
    cfg: ExperimentConfig,
    policy,
    pol_state,
    ratings,
    regimes: Sequence,
    generator: Optional[torch.Generator] = None,
    s_per_regime: int = 4,
    eval_seed: int = REGIME_EVAL_SEED,
    telemetry=None,
    held_out: bool = False,
    eval_fn=None,
    bundle: Optional[str] = None,
    normals: Optional[torch.Tensor] = None,
    device="cuda",
) -> list:
    """Per-regime greedy eval table: one dict per regime with the cost,
    reward and counter breakdown (counters as per-scenario means), each
    emitted as a ``regime_eval`` telemetry event when ``telemetry`` is
    given. ``eval_fn`` (a ``make_regime_eval`` of the SAME regime list)
    reuses its held-out batch across policies; ``bundle`` tags the events
    with the evaluated policy's identity; ``normals`` replaces the initial
    temperatures' draws."""
    if eval_fn is None:
        names = list(regimes)
        eval_fn = make_regime_eval(
            cfg, policy, ratings, build_portfolio(names, len(names), device=device),
            s_per_regime=s_per_regime, eval_seed=eval_seed, device=device,
        )
    cost_r, reward_r, rc = eval_fn(pol_state, generator, normals=normals)
    names = list(eval_fn.portfolio.names)
    rows = rc_to_dicts(rc, names)
    # host-sync: the eval table is a host artifact.
    cost_r, reward_r = cost_r.cpu().numpy(), reward_r.cpu().numpy()
    s = eval_fn.s_per_regime
    out = []
    for i, row in enumerate(rows):
        d = {
            "regime": names[i],
            "held_out": bool(held_out),
            "cost_eur": float(cost_r[i]),
            "reward": float(reward_r[i]),
            "n_scenarios": s,
            **{k: float(v) / s for k, v in row.items() if k not in ("regime", "cost_eur", "reward")},
        }
        out.append(d)
        if telemetry is not None:
            attrs = {k: (round(v, 6) if isinstance(v, float) else v) for k, v in d.items()}
            if bundle is not None:
                attrs["bundle"] = bundle
            telemetry.event("regime_eval", **attrs)
    return out


def evaluate_bundle_regimes(
    cfg: ExperimentConfig,
    bundle_dir: str,
    regimes: Sequence,
    s_per_regime: int = 4,
    eval_seed: int = REGIME_EVAL_SEED,
    eval_key: int = 1,
    telemetry=None,
    held_out: bool = False,
    eval_fn=None,
    bundle_tag: Optional[str] = None,
    pol_state=None,
    normals: Optional[torch.Tensor] = None,
    device="cuda",
) -> dict:
    """Per-regime held-out eval of a serving BUNDLE:
    ``{regime_name: cost_eur}`` (plus the full rows under ``"rows"``) —
    the comparison input of the promotion gate's per-regime
    no-regression rule. ``bundle_tag`` (default: the bundle dir's
    basename) labels the telemetry events — two bundles of one config
    stay distinguishable in the ``--regimes`` warehouse view.

    The bundle's greedy subtree is grafted by ``state_from_bundle``: into a
    fresh learner drawn from a generator seeded ``cfg.train.seed``, or, with
    ``pol_state``, into that state's tensors in place. The initial
    temperatures come from a generator seeded ``eval_key`` on ``device``
    unless ``normals`` gives them."""
    import os

    from p2pmicrogrid_tpu_torch.envs import make_ratings
    from p2pmicrogrid_tpu_torch.serve.export import load_policy_bundle
    from p2pmicrogrid_tpu_torch.train import make_policy
    from p2pmicrogrid_tpu_torch.train.continual import state_from_bundle

    dev = resolve_device(device)
    manifest, params = load_policy_bundle(bundle_dir)
    ps = state_from_bundle(
        cfg, manifest, params, torch.Generator(device=dev).manual_seed(cfg.train.seed),
        device=dev, into=pol_state,
    )
    policy = make_policy(cfg)
    ratings = make_ratings(cfg, np.random.default_rng(cfg.train.seed))
    if bundle_tag is None:
        bundle_tag = os.path.basename(os.path.normpath(bundle_dir))
    rows = evaluate_regimes(
        cfg, policy, ps, ratings, regimes,
        generator=torch.Generator(device=dev).manual_seed(eval_key), s_per_regime=s_per_regime,
        eval_seed=eval_seed, telemetry=telemetry, held_out=held_out,
        eval_fn=eval_fn, bundle=bundle_tag, normals=normals, device=dev,
    )
    out = {row["regime"]: row["cost_eur"] for row in rows}
    out["rows"] = rows
    return out
