"""Regime-portfolio episode functions for the existing trainers.

The port of the JAX package's ``regimes/train.py``. ``make_regime_episode_fn``
builds ONE episode function over a mixed-regime scenario batch, with the
signature of the trainers the port already has:

* ``mode="shared"`` — ``make_shared_episode_fn`` with the regime engine as
  its slot hooks, carry ``(pol_state, scen_state)``: it plugs into
  ``train_scenarios_shared(episode_fn=...)`` and, given ``arrays_fn`` (traces
  made on the device), into ``make_chunked_episode_runner`` and so
  ``train_scenarios_chunked(runner=...)``.
* ``mode="independent"`` — ``make_independent_episode_fn`` with the same
  hooks, carry the S * A per-agent learners: it plugs into
  ``train_scenarios_independent(episode_fn=...)``. The act is
  ``_per_scenario_policy``'s replaced act (the JAX package passes an
  ``act_fn``).

Regime fields are DATA: the episode reads its own [S] tensors, which
``episode.with_regimes(rp)`` overwrites in place (``copy_``). A CUDA graph
of the chunk episode reads those tensors at their fixed addresses, so a
mixed portfolio, or a swap to another portfolio of the same S, replays the
one captured graph: the port's counterpart of the JAX package's single
compile (``episode.jitted._cache_size() == 1``). Unlike the JAX package's
rebinding, ``with_regimes`` changes the portfolio of the episode it is
called on (and returns it). The weather transform runs inside the episode,
on the arrays ``parallel/device_gen.py`` makes.

The fused slot kernel K7 stages the BASELINE world only: ``fused`` (or
``SimConfig.fused_slot``) with regimes refuses loudly.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from p2pmicrogrid_tpu_torch.config import ExperimentConfig
from p2pmicrogrid_tpu_torch.device import resolve_device
from p2pmicrogrid_tpu_torch.envs.community import EpisodeArrays, resolve_use_fused
from p2pmicrogrid_tpu_torch.regimes.engine import (
    apply_weather_regimes,
    init_ev_need,
    rc_add,
    rc_from_slot,
    rc_to_dicts,
    rc_zero,
    regime_slot_batched,
)
from p2pmicrogrid_tpu_torch.regimes.spec import (
    RegimeParams,
    RegimeSpec,
    assign_regimes,
    assignment_one_hot,
    regime_assignment,
    resolve_specs,
    stack_regime_params,
)


class RegimePortfolio(NamedTuple):
    """A resolved portfolio: R specs spread over S scenarios."""

    specs: tuple                   # (RegimeSpec, ...) length R
    names: tuple                   # regime names, length R
    params: RegimeParams           # [R] tensors
    scenario_params: RegimeParams  # [S] tensors (assigned)
    assignment: np.ndarray         # [S] int32 scenario -> regime index
    one_hot: torch.Tensor          # [S, R] f32 segment matrix

    @property
    def n_regimes(self) -> int:
        return len(self.specs)


def build_portfolio(regimes: Sequence, n_scenarios: int, assignment=None, device="cuda") -> RegimePortfolio:
    """Resolve names/specs into a scenario-assigned portfolio on ``device``
    (round-robin by default, so every regime is covered as evenly as S
    allows)."""
    specs = resolve_specs(regimes)
    if assignment is None:
        assignment = regime_assignment(n_scenarios, len(specs))
    assignment = np.asarray(assignment, dtype=np.int32)
    if assignment.shape != (n_scenarios,):
        raise ValueError(f"assignment shape {assignment.shape} != ({n_scenarios},)")
    params = stack_regime_params(specs, device)
    return RegimePortfolio(
        specs=tuple(specs),
        names=tuple(s.name for s in specs),
        params=params,
        scenario_params=assign_regimes(params, assignment),
        assignment=assignment,
        one_hot=assignment_one_hot(assignment, len(specs), device),
    )


def refuse_fused_regimes(specs: Optional[Sequence[RegimeSpec]] = None):
    """The loud fused-path refusal: the fused slot (kernel K7) stages the
    baseline world only — EV load, islanding masks, price-spike windows and
    auction mechanisms do not exist inside it, so a fused regime episode
    would be silently wrong, not slow."""
    features = None
    if specs is not None:
        found = []
        for s in specs:
            found.extend(f for f in s.fused_unstageable_features() if f not in found)
        features = ", ".join(found) if found else None
    raise ValueError(
        "fused_slot=True / fused=True cannot stage regime features ("
        + (features or "EV load, islanding masks, auction mechanisms")
        + ") — the fused slot kernel (K7) fuses the baseline world only. "
        "Run regime episodes through the op chain: set fused=False and "
        "leave SimConfig.fused_slot unset (None)."
    )


class _RegimeSlots:
    """The regime engine as an episode function's slot hooks: the weather
    over the episode's inputs, then every slot through
    ``regime_slot_batched`` with the EV need carried from slot to slot and,
    with ``one_hot``, the per-regime counters summed."""

    def __init__(self, rp: RegimeParams, n_agents: int, one_hot: Optional[torch.Tensor]):
        self.rp = rp
        self.n_agents = n_agents
        self.one_hot = one_hot
        self.ev_need = self.counters = None

    def begin(self, xs):
        arrs = apply_weather_regimes(EpisodeArrays(*(x.transpose(0, 1) for x in xs)), self.rp)
        self.ev_need = init_ev_need(self.rp, self.n_agents)
        if self.one_hot is not None:
            self.counters = rc_zero(self.one_hot.shape[1], self.one_hot.device)
        return tuple(x.transpose(0, 1).contiguous() for x in arrs)

    def slot(self, cfg, policy, pol_state, phys_s, xs_t, draws, ratings, explore,
             fused=False, explore_state=None, settlement_hook=None):
        if fused or settlement_hook is not None:
            raise ValueError("a regime slot owns settlement: it takes no fused slot and no settlement_hook")
        phys_s, pol_state, out, tr, ex, self.ev_need, extras = regime_slot_batched(
            cfg, policy, pol_state, phys_s, self.ev_need, xs_t, draws, ratings, self.rp,
            explore, explore_state,
        )
        if self.one_hot is not None:
            self.counters = rc_add(self.counters, rc_from_slot(cfg, out, extras, self.one_hot))
        return phys_s, pol_state, out, tr, ex


def make_regime_episode_fn(
    cfg: ExperimentConfig,
    policy,
    ratings,
    regimes: RegimeParams,
    arrays_s: Optional[EpisodeArrays] = None,
    arrays_fn: Optional[Callable] = None,
    n_scenarios: Optional[int] = None,
    mode: str = "shared",
    record_only: bool = False,
    collect_regime_metrics: bool = False,
    one_hot: Optional[torch.Tensor] = None,
    fused: Optional[bool] = None,
    specs: Optional[Sequence[RegimeSpec]] = None,
    device="cuda",
) -> Callable:
    """One mixed-regime training episode function.

    ``regimes`` carries [S] tensors (``build_portfolio(...).scenario_params``
    or ``assign_regimes`` output); the episode keeps its own copy on its
    device. Inputs are fixed ``arrays_s`` ([S, T, ...] on the device) or,
    in shared mode, ``arrays_fn(trace_draws) -> EpisodeArrays`` with
    ``n_scenarios`` (``parallel/device_gen.py::device_episode_arrays``, the
    chunked transport; ``device`` is then the episode's). Callers pass
    baseline-family arrays: the weather runs inside the episode.

    Returns the shared episode function (``make_shared_episode_fn``'s, with
    its ``draw``, ``learning_rates``, ``n_scenarios``, ``n_slots`` and
    ``device``) or the independent one, plus ``episode.regimes`` (the [S]
    tensors it reads) and ``episode.with_regimes(rp)`` (copies ``rp`` into
    them, returns the episode). ``collect_regime_metrics`` (needs
    ``one_hot`` [S, R]) appends the episode's ``RegimeCounters`` to its
    outputs: ``(rewards [S], losses [S], counters)``; leave it off for the
    chunked runner, which reads two outputs.
    """
    from p2pmicrogrid_tpu_torch.parallel.scenarios import (
        make_independent_episode_fn,
        make_shared_episode_fn,
    )

    impl = cfg.train.implementation
    if mode not in ("shared", "independent"):
        raise ValueError(f"mode must be 'shared' or 'independent', got {mode!r}")
    if fused is None:
        fused = resolve_use_fused(cfg)
    if fused:
        refuse_fused_regimes(specs)
    if mode == "independent" and impl == "ddpg":
        raise ValueError(
            "independent regime training supports tabular/dqn only (ddpg "
            "advances OU state inside act, which the batched act hook "
            "cannot thread per-learner); use mode='shared' for ddpg"
        )
    if record_only and (impl != "dqn" or mode != "shared"):
        raise ValueError("record_only warmup applies to shared dqn only")
    if (arrays_s is None) == (arrays_fn is None):
        raise ValueError("pass exactly one of arrays_s or arrays_fn")
    if arrays_fn is not None and n_scenarios is None:
        raise ValueError("arrays_fn requires an explicit n_scenarios")
    if arrays_fn is not None and mode == "independent":
        raise ValueError("independent regime episodes take fixed arrays_s (train_scenarios_independent's)")
    if arrays_s is not None:
        n_scenarios = arrays_s.time.shape[0]
        dev = arrays_s.load_w.device
    else:
        dev = resolve_device(device)
    if regimes.n != n_scenarios:
        raise ValueError(
            f"regimes must carry [S]={n_scenarios} tensors (use "
            f"build_portfolio/assign_regimes), got [{regimes.n}]"
        )
    if collect_regime_metrics and one_hot is None:
        raise ValueError("collect_regime_metrics requires one_hot [S, R]")

    rp = RegimeParams(*(x.to(dev).clone() for x in regimes))
    hooks = _RegimeSlots(rp, cfg.sim.n_agents, one_hot.to(dev) if collect_regime_metrics else None)
    if mode == "shared":
        base = make_shared_episode_fn(
            cfg, policy, arrays_s, ratings, record_only=record_only, fused=False,
            arrays_fn=arrays_fn, n_scenarios=n_scenarios, device=dev, slot_hooks=hooks,
        )
    else:
        base = make_independent_episode_fn(cfg, policy, arrays_s, ratings, fused=False, slot_hooks=hooks)

    if collect_regime_metrics:

        def episode(carry, *args, **kwargs):
            carry, ys = base(carry, *args, **kwargs)
            return carry, ys + (hooks.counters,)

        for name in ("draw", "learning_rates", "n_scenarios", "n_slots", "device"):
            if hasattr(base, name):
                setattr(episode, name, getattr(base, name))
    else:
        episode = base

    def with_regimes(new: RegimeParams):
        """Copy ``new``'s [S] tensors into the ones the episode reads."""
        if new.n != n_scenarios:
            raise ValueError(f"with_regimes: the episode runs S={n_scenarios}, got [{new.n}]")
        for dst, src in zip(rp, new):
            dst.copy_(src)
        return episode

    episode.regimes = rp
    episode.with_regimes = with_regimes
    return episode


def train_regime_portfolio(
    cfg: ExperimentConfig,
    policy,
    pol_state,
    scen_state,
    ratings,
    portfolio: RegimePortfolio,
    generator: Optional[torch.Generator],
    n_episodes: int,
    arrays_s: Optional[EpisodeArrays] = None,
    arrays_fn: Optional[Callable] = None,
    n_scenarios: Optional[int] = None,
    telemetry=None,
    episode_cb: Optional[Callable] = None,
    fused: Optional[bool] = None,
    draws: Optional[Sequence] = None,
    device="cuda",
):
    """Portfolio trainer with per-regime attribution: a synchronous loop
    over a collecting shared-mode episode. Every episode emits one
    ``regime_counters`` telemetry event (per-regime cost, comfort, trade,
    curtailment and EV totals). Exploration decays on the trainers' cadence.
    ``draws`` (one ``EpisodeDraws`` per episode) replaces ``generator``. For
    the pipelined paths, hand a non-collecting episode function to the
    ``train_scenarios_*`` trainers instead.

    Returns ``(pol_state, scen_state, rewards [E, S], losses [E, S],
    per-episode lists of per-regime dicts)``.
    """
    from p2pmicrogrid_tpu_torch.parallel.scenarios import _decays_after

    episode_fn = make_regime_episode_fn(
        cfg, policy, ratings, portfolio.scenario_params,
        arrays_s=arrays_s, arrays_fn=arrays_fn, n_scenarios=n_scenarios,
        mode="shared", collect_regime_metrics=True, one_hot=portfolio.one_hot,
        fused=fused, specs=portfolio.specs, device=device,
    )
    carry = (pol_state, scen_state)
    rewards, losses, rc_all = [], [], []
    for e in range(n_episodes):
        carry, (r, l, rc) = episode_fn(carry, generator, None if draws is None else draws[e])
        if _decays_after(cfg, e):
            carry = (policy.decay(carry[0]), carry[1])
        # host-sync: the synchronous attribution loop, once an episode.
        r, l = r.cpu().numpy(), l.cpu().numpy()
        rewards.append(r)
        losses.append(l)
        dicts = rc_to_dicts(rc, list(portfolio.names))
        rc_all.append(dicts)
        if telemetry is not None:
            telemetry.event(
                "regime_counters", episode=e, phase="train",
                regimes=[
                    {k: (round(v, 4) if isinstance(v, float) else v) for k, v in d.items()}
                    for d in dicts
                ],
            )
        if episode_cb:
            episode_cb(e, r, l, carry)
    pol_state, scen_state = carry
    return pol_state, scen_state, np.stack(rewards), np.stack(losses), rc_all
