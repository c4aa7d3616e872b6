"""Replay warehouse serve traces back into training buffers.

The port of the JAX package's ``data/trace_export.py``: the SQLite reading,
pairing and settlement joins are its host code as it is (the port's
``data/results.py`` writes the same tables), and the reward attributions run
the port's own ops (``ops/tariff.py``, ``ops/market.py``, ``ops/thermal.py``,
with their float32 reciprocals) on ``device`` and return numpy arrays.

The warehouse half of the continual-learning flywheel:
the serve gateway already attributes every request to the bundle that
answered it — per-request ``serve_decision`` events (household, the
observation it sent, the action served) stream into the SQLite warehouse
keyed by the serving bundle's ``config_hash`` (serve/gateway.py). Nothing
read them back until now. This module is the reader:

* ``export_serve_traces`` pulls a config's decisions out of a results DB,
  pairs each household's consecutive decisions into off-policy
  transitions ``(obs_t, action_t, reward_t, obs_{t+1})``, and returns a
  ``TraceDataset`` whose arrays are shape/dtype-exact against the serving
  contract (obs ``[N, A, 4]`` float32 — serve/export.py ``OBS_SPEC``).
* ``trace_reward`` attributes a per-slot reward to each served decision
  from the observation and action alone, using the environment's OWN cost
  pieces (ops/tariff.grid_prices, ops/market.compute_costs,
  ops/thermal.comfort_penalty) under the no-communication settlement rule
  (envs/community.py's no-com branch): the gateway cannot see the
  community's P2P clearing from one household's request, so matched P2P
  power is attributed zero — a documented proxy. Production deployments
  that meter real settlement join it in here (the ``reward_fn`` hook).
* ``to_replay_state`` loads a dataset into the per-agent ring
  (``models/replay.ReplayState``, ``[A, N, ...]``) the off-policy learners
  sample from —
  the seed buffer ``train/continual.py`` fine-tunes the incumbent on.

**Compaction fails loud.** The warehouse retention pass
(``telemetry-query --compact``, data/results.py) rolls old per-request
rows into ``serve_request_agg`` aggregates and DELETES the decision
traces with them. An export over a compacted run would silently train on
an empty or truncated buffer — the worst possible failure mode for a
continual loop, a candidate trained on nothing still looks like a
candidate. ``export_serve_traces`` therefore refuses with
``TracesCompactedError`` the moment any selected run carries aggregate
rows, naming the fix (raise the ``--older-than-hours`` retention window
so the training cadence outruns compaction).
"""

from __future__ import annotations

import json
import sqlite3
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from p2pmicrogrid_tpu_torch.device import resolve_device


def _nominal_max_in_w(cfg) -> float:
    """The population's nominal rating normalizer in W (ops/obs.py's
    ``max_in``): per-household ratings are not on the wire."""
    pop = cfg.population
    return max(pop.load_rating_mean, pop.pv_rating_mean) * pop.safety * 1e3


def _decision_inputs(cfg, obs, action, device):
    """(time_norm, t_in, balance_w, action) float32 tensors on ``device``
    from wire observations [..., A, 4] and served fractions [..., A]."""
    dev = resolve_device(device)
    obs = torch.as_tensor(np.asarray(obs, dtype=np.float32), device=dev)
    action = torch.as_tensor(np.asarray(action, dtype=np.float32), device=dev)
    th = cfg.thermal
    t_in = obs[..., 1] * th.margin + th.setpoint
    # The wire's balance feature is balance_w / max_in (ops/obs.py);
    # invert with the nominal community rating.
    balance_w = obs[..., 2] * _nominal_max_in_w(cfg)
    return obs[..., 0], t_in, balance_w, action


def _no_com_cost(cfg, time_norm, balance_w, hp_power):
    """Grid settlement of balance + heat-pump power under the
    no-communication rule: zero matched P2P power."""
    from p2pmicrogrid_tpu_torch.ops.market import compute_costs
    from p2pmicrogrid_tpu_torch.ops.tariff import grid_prices

    buy, inj = grid_prices(cfg.tariff, time_norm)
    p_grid = balance_w + hp_power
    return compute_costs(
        p_grid, torch.zeros_like(p_grid), buy, inj,
        torch.zeros_like(buy), cfg.sim.slot_hours,
    )


def _host(x: torch.Tensor) -> np.ndarray:
    # host-sync: trace attribution runs offline and returns host arrays.
    return x.cpu().numpy().astype(np.float32)


class TracesCompactedError(RuntimeError):
    """The selected runs' per-request traces were rolled into aggregates
    — there is no raw decision stream left to train on."""


@dataclass
class TraceDataset:
    """Off-policy transitions reconstructed from serve traces.

    Arrays are shape/dtype-exact against the serving contract: obs /
    next_obs ``[N, A, 4]`` float32 (OBS_SPEC feature order), action
    ``[N, A]`` float32 heat-pump fractions, reward ``[N, A]`` float32.
    """

    obs: np.ndarray
    action: np.ndarray
    reward: np.ndarray
    next_obs: np.ndarray
    config_hash: Optional[str] = None
    run_ids: List[str] = field(default_factory=list)
    households: List[str] = field(default_factory=list)
    n_decisions: int = 0          # pairable decisions read (>= transitions)
    n_dropped: int = 0            # anonymous / non-leading batch rows
    # Per-transition provenance of the LEADING decision ({run_id,
    # household, ts}) — what a 3-arg ``reward_fn`` joins settlement rows
    # on (``settlement_reward_fn``), aligned with the array rows.
    meta: List[dict] = field(default_factory=list)
    window_start_ts: Optional[float] = None
    window_end_ts: Optional[float] = None

    @property
    def n_transitions(self) -> int:
        return int(self.obs.shape[0])

    @property
    def n_agents(self) -> int:
        return int(self.obs.shape[1])

    def summary(self) -> dict:
        return {
            "config_hash": self.config_hash,
            "n_decisions": self.n_decisions,
            "n_transitions": self.n_transitions,
            "n_agents": self.n_agents,
            "n_households": len(self.households),
            "n_runs": len(self.run_ids),
            "n_dropped": self.n_dropped,
            "reward_mean": (
                round(float(self.reward.mean()), 6)
                if self.n_transitions else None
            ),
            "window_start_ts": (
                round(self.window_start_ts, 3)
                if self.window_start_ts is not None else None
            ),
            "window_end_ts": (
                round(self.window_end_ts, 3)
                if self.window_end_ts is not None else None
            ),
        }


def trace_reward(cfg, obs: np.ndarray, action: np.ndarray, device="cuda") -> np.ndarray:
    """Per-agent reward attributed to one served decision.

    Mirrors the environment's reward at the decision point — ``-(cost +
    10 * comfort_penalty)`` (envs/community.py) — reconstructed from the
    observation features alone: ``obs[..., 0]`` is the normalized slot
    time (prices via ops/tariff.grid_prices), ``obs[..., 1]`` inverts to
    the indoor temperature through ops/thermal's normalization, and
    ``obs[..., 2]`` inverts to the household balance through the rating
    normalizer (the population's nominal ``max_in`` — per-household
    ratings are not on the wire, so the nominal rating attributes cost;
    the relative candidate-vs-incumbent comparison the promotion gate and
    canary make is unaffected by this common scale). Settlement follows
    the no-communication rule: all power at grid prices, zero matched P2P
    (one household's request cannot see the community clearing).
    """
    from p2pmicrogrid_tpu_torch.ops.thermal import comfort_penalty

    time_norm, t_in, balance_w, action = _decision_inputs(cfg, obs, action, device)
    cost = _no_com_cost(cfg, time_norm, balance_w, action * cfg.thermal.hp_max_power)
    return _host(-(cost + 10.0 * comfort_penalty(cfg.thermal, t_in)))


def decision_cost(
    cfg, obs: np.ndarray, action: np.ndarray, t_out: float = 10.0, device="cuda"
) -> np.ndarray:
    """Per-agent ATTRIBUTABLE cost of one served decision — the canary's
    per-arm comparison metric (serve/promotion.py).

    ``trace_reward`` mirrors the env exactly, but the env charges comfort
    at the PRE-step temperature — a term the action cannot move within
    its own slot (credit flows through the next observation). Two arms
    serving the same obs stream would therefore tie on comfort no matter
    what they served. This variant rolls the building one Euler step
    forward under the SERVED action (ops/thermal.thermal_step with a
    nominal outdoor temperature and the mass pinned to the air — neither
    rides the wire) and charges comfort at the RESULTING temperature:
    idling a cold house or overheating a warm one is visible in the slot
    that decided it. Energy settles exactly as in ``trace_reward``.
    """
    from p2pmicrogrid_tpu_torch.ops.thermal import comfort_penalty, thermal_step

    th = cfg.thermal
    time_norm, t_in, balance_w, action = _decision_inputs(cfg, obs, action, device)
    hp_power = action * th.hp_max_power
    cost = _no_com_cost(cfg, time_norm, balance_w, hp_power)
    t_out_t = torch.tensor(t_out, dtype=torch.float32, device=t_in.device)
    t_next, _ = thermal_step(th, cfg.sim.dt_seconds, t_out_t, t_in, t_in, hp_power)
    return _host(cost + 10.0 * comfort_penalty(th, t_next))


def _serve_run_ids(
    con: sqlite3.Connection, config_hash: Optional[str]
) -> Dict[str, str]:
    """{run_id: config_hash} of serve-role telemetry runs (replica bundle
    runs register ``serve_role`` in their manifests — serve/gateway.py
    build_registry), filtered to ``config_hash`` when given."""
    rows = con.execute(
        "SELECT run_id, config_hash FROM telemetry_runs "
        "WHERE json_extract(manifest_json, '$.serve_role') IS NOT NULL"
    ).fetchall()
    return {
        run_id: ch
        for run_id, ch in rows
        if config_hash is None or ch == config_hash
    }


def _check_not_compacted(
    con: sqlite3.Connection, run_ids, since_ts: Optional[float] = None
) -> None:
    """Refuse an export whose window overlaps compacted history.

    Without ``since_ts`` any aggregate row on a selected run condemns the
    export (the pre-handshake contract: the window is unbounded, so any
    compaction truncated it). With ``since_ts`` — the scheduled-handshake
    path, where the window starts at the last export watermark — only
    aggregates whose compacted window reaches INTO the export window
    (``ts_max >= since_ts``) do: retention rolling up history the
    previous cycle already exported is exactly what the lease/watermark
    handshake (data/results.py) schedules, not a race."""
    marks = ",".join("?" for _ in run_ids)
    where = (
        f"run_id IN ({marks}) AND kind = 'serve_request_agg'"
    )
    params: list = list(run_ids)
    if since_ts is not None:
        where += (
            " AND COALESCE(json_extract(attrs_json, '$.ts_max'), 1e30)"
            " >= ?"
        )
        params.append(float(since_ts))
    (n_agg,) = con.execute(
        f"SELECT COUNT(*) FROM telemetry_points WHERE {where}", params
    ).fetchone()
    if n_agg:
        raise TracesCompactedError(
            f"{n_agg} serve_request_agg row(s) overlap the export window "
            "for the selected runs: their per-request traces were "
            "compacted to aggregates (telemetry-query --compact), so the "
            "decision stream is empty or truncated and exporting it would "
            "train on a partial buffer. Fix: raise the retention window "
            "(--older-than-hours) above your continual-training cadence, "
            "or coordinate the two with an export lease "
            "(data/results.acquire_export_lease — serve/autopilot.py "
            "does this per cycle)."
        )


def export_serve_traces(
    results_db: str,
    config_hash: Optional[str] = None,
    cfg=None,
    n_agents: Optional[int] = None,
    reward_fn: Optional[Callable] = None,
    min_transitions: int = 1,
    since_ts: Optional[float] = None,
    device="cuda",
) -> TraceDataset:
    """Replay a warehouse's gateway decisions into a ``TraceDataset``.

    ``config_hash`` selects the bundle whose decisions to export (None =
    every serve-role run — a fleet's replicas all serving one config).
    ``cfg`` drives the default reward attribution (``trace_reward``);
    pass ``reward_fn(obs [N, A, 4], action [N, A]) -> [N, A]`` to attribute
    from metered outcomes instead — a reward_fn accepting a THIRD
    positional argument additionally receives the per-transition
    provenance (``TraceDataset.meta``: run_id/household/ts of the leading
    decision), which is how ``settlement_reward_fn`` joins billed
    per-household cost rows onto the transitions. ``n_agents`` (default:
    inferred from the first decision) validates every row against the
    serving contract. ``since_ts`` bounds the window to decisions at/after
    it — the scheduled-handshake path where each continual cycle exports
    from the last released export watermark (data/results.py).
    ``device`` runs the default reward attribution.

    Raises ``TracesCompactedError`` when compaction overlaps the export
    window (see ``_check_not_compacted``) and ``ValueError`` when fewer
    than ``min_transitions`` transitions survive pairing — both LOUD,
    because the downstream consumer is a training loop that would
    otherwise silently fine-tune on nothing.
    """
    if cfg is None and reward_fn is None:
        raise ValueError("pass cfg (for trace_reward) or an explicit reward_fn")
    dev = resolve_device(device)
    con = sqlite3.connect(f"file:{results_db}?mode=ro", uri=True)
    try:
        runs = _serve_run_ids(con, config_hash)
        if not runs:
            raise ValueError(
                f"no serve-role telemetry runs in {results_db}"
                + (f" for config_hash {config_hash}" if config_hash else "")
            )
        _check_not_compacted(con, list(runs), since_ts=since_ts)
        marks = ",".join("?" for _ in runs)
        window_sql = ""
        params: List = list(runs)
        if since_ts is not None:
            window_sql = " AND ts >= ?"
            params.append(float(since_ts))
        cursor = con.execute(
            "SELECT run_id, seq, ts, attrs_json FROM telemetry_points "
            f"WHERE run_id IN ({marks}) AND kind = 'serve_decision'"
            f"{window_sql} ORDER BY run_id, seq",
            params,
        )
        # Consecutive decisions of ONE household within ONE run pair into
        # transitions: the gateway serves each household once per slot, so
        # its next decision's observation IS the next-slot observation.
        # Two decision classes CANNOT honor that invariant and are
        # dropped (counted in ``n_dropped``) rather than stitched into
        # fabricated transitions that would silently corrupt training:
        # anonymous decisions (no household — unrelated clients would
        # interleave under one pseudo-key) and the non-leading rows of a
        # batched request (rows 1..B-1 share ONE instant with row 0 —
        # they are parallel observations, not temporal successors).
        per_household: Dict[tuple, list] = {}
        n_decisions = 0
        n_dropped = 0
        window_lo = window_hi = None
        for run_id, seq, ts, attrs_json in cursor:
            try:
                attrs = json.loads(attrs_json) if attrs_json else {}
            except ValueError:
                continue
            obs = attrs.get("obs")
            action = attrs.get("action")
            if obs is None or action is None:
                continue
            obs = np.asarray(obs, dtype=np.float32)
            action = np.asarray(action, dtype=np.float32)
            if obs.ndim != 2 or obs.shape[1] != 4:
                continue
            if n_agents is None:
                n_agents = int(obs.shape[0])
            if obs.shape[0] != n_agents or action.shape != (n_agents,):
                continue
            household = attrs.get("household")
            if not household or attrs.get("row", 0) != 0:
                n_dropped += 1
                continue
            n_decisions += 1
            if ts is not None:
                window_lo = ts if window_lo is None else min(window_lo, ts)
                window_hi = ts if window_hi is None else max(window_hi, ts)
            per_household.setdefault((run_id, household), []).append(
                (obs, action, ts, attrs.get("request_id"))
            )
    finally:
        con.close()

    obs_rows: List[np.ndarray] = []
    act_rows: List[np.ndarray] = []
    next_rows: List[np.ndarray] = []
    meta: List[dict] = []
    households: set = set()
    for (run_id, household), decisions in sorted(per_household.items()):
        for (o, a, ts, rid), (o_next, _, _, _) in zip(
            decisions, decisions[1:]
        ):
            obs_rows.append(o)
            act_rows.append(a)
            next_rows.append(o_next)
            meta.append({
                "run_id": run_id, "household": household, "ts": ts,
                # The gateway's per-row request id (the trace span id when
                # traced): the EXACT settlement join key — household+ts
                # stays only as the legacy-warehouse fallback.
                "request_id": rid,
            })
            households.add(household)
    if len(obs_rows) < max(min_transitions, 1):
        raise ValueError(
            f"only {len(obs_rows)} transition(s) reconstructed from "
            f"{n_decisions} pairable decision(s) ({n_dropped} anonymous/"
            f"batch-row decision(s) dropped; need >= {min_transitions}): "
            "each household needs >= 2 consecutive decisions in one run "
            "to form a transition"
        )
    obs = np.stack(obs_rows).astype(np.float32)
    action = np.stack(act_rows).astype(np.float32)
    next_obs = np.stack(next_rows).astype(np.float32)
    if reward_fn is not None:
        if _reward_fn_takes_meta(reward_fn):
            reward = np.asarray(
                reward_fn(obs, action, meta), dtype=np.float32
            )
        else:
            reward = np.asarray(reward_fn(obs, action), dtype=np.float32)
    else:
        reward = trace_reward(cfg, obs, action, device=dev)
    if reward.shape != action.shape:
        raise ValueError(
            f"reward_fn returned shape {reward.shape}, expected {action.shape}"
        )
    return TraceDataset(
        obs=obs,
        action=action,
        reward=reward,
        next_obs=next_obs,
        config_hash=config_hash,
        run_ids=sorted(runs),
        households=sorted(households),
        n_decisions=n_decisions,
        n_dropped=n_dropped,
        meta=meta,
        window_start_ts=window_lo,
        window_end_ts=window_hi,
    )


def _reward_fn_takes_meta(reward_fn) -> bool:
    """Does the hook accept the per-transition provenance third argument?
    (Settlement joins need household/ts; the plain 2-arg contract stays
    supported.)"""
    import inspect

    try:
        params = [
            p for p in inspect.signature(reward_fn).parameters.values()
            if p.kind in (
                inspect.Parameter.POSITIONAL_ONLY,
                inspect.Parameter.POSITIONAL_OR_KEYWORD,
                inspect.Parameter.VAR_POSITIONAL,
            )
        ]
    except (TypeError, ValueError):
        return False
    return len(params) >= 3 or any(
        p.kind is inspect.Parameter.VAR_POSITIONAL for p in params
    )


# -- metered settlement --------------------------------------------------------
#
# Production reward should come from what households were BILLED, not from
# the environment's own tariff model re-run offline. The contract: a meter
# (or here, ``bill_decisions`` simulating one) writes ``settlement`` points
# into the warehouse — attrs ``{household, decision_ts (the decision's
# timestamp), billed_eur [A]}`` under a run whose manifest carries
# ``settlement_role``
# (NOT ``serve_role``, so settlement runs never select as trace sources).
# ``settlement_reward_fn`` then joins those rows onto exported transitions
# by (household, decision ts) through the 3-arg ``reward_fn`` hook.


def _settlement_key(household: str, ts: Optional[float]) -> tuple:
    # ts rounds to ms: the decision ts is copied verbatim into the
    # settlement row, so the match is exact up to JSON float round-trip
    # (which is itself exact) — rounding only guards representation drift.
    return (household, round(ts, 3) if ts is not None else None)


def bill_decisions(
    results_db: str,
    cfg,
    config_hash: Optional[str] = None,
    since_ts: Optional[float] = None,
    bill_fn: Optional[Callable[[np.ndarray, np.ndarray], np.ndarray]] = None,
    run_name: str = "billing",
    device="cuda",
) -> int:
    """Simulate the settlement meter: read the window's ``serve_decision``
    rows and write one ``settlement`` point per decision (billed energy
    cost under the no-com tariff rule by default; ``bill_fn(obs [A,4],
    action [A]) -> [A]`` overrides — a real deployment replaces this whole
    function with its metering pipeline). Returns the number of decisions
    billed. The autopilot runs this each cycle BEFORE trace export so
    continual training optimizes billed outcomes."""
    from p2pmicrogrid_tpu_torch.telemetry import SqliteSink, Telemetry
    from p2pmicrogrid_tpu_torch.telemetry.registry import run_stamp

    dev = resolve_device(device)
    con = sqlite3.connect(f"file:{results_db}?mode=ro", uri=True)
    decisions: List[tuple] = []
    try:
        runs = _serve_run_ids(con, config_hash)
        if not runs:
            return 0
        marks = ",".join("?" for _ in runs)
        window_sql = ""
        params: List = list(runs)
        if since_ts is not None:
            window_sql = " AND ts >= ?"
            params.append(float(since_ts))
        for _run_id, ts, attrs_json in con.execute(
            "SELECT run_id, ts, attrs_json FROM telemetry_points "
            f"WHERE run_id IN ({marks}) AND kind = 'serve_decision'"
            f"{window_sql}",
            params,
        ):
            try:
                attrs = json.loads(attrs_json) if attrs_json else {}
            except ValueError:
                continue
            household = attrs.get("household")
            obs, action = attrs.get("obs"), attrs.get("action")
            if not household or obs is None or action is None or ts is None:
                continue
            decisions.append(
                (household, ts, obs, action, attrs.get("request_id"))
            )
    finally:
        con.close()
    if not decisions:
        return 0

    if bill_fn is None:
        def bill_fn(obs, action):  # default meter: the energy settlement
            return _energy_settlement_eur(cfg, obs, action, dev)

    tel = Telemetry(
        run_id=f"{run_name}-{run_stamp()}",
        sinks=[SqliteSink(results_db)],
        manifest={"settlement_role": "meter", "config_hash": config_hash},
    )
    try:
        for household, ts, obs, action, request_id in decisions:
            # host-sync: warehouse JSON payloads, host data throughout.
            billed = np.asarray(
                bill_fn(
                    np.asarray(obs, dtype=np.float32),
                    np.asarray(action, dtype=np.float32),
                ),
                dtype=np.float32,
            )
            tel.event(
                "settlement",
                household=household,
                # NOT the reserved ``ts`` kwarg (that would become the
                # point's own timestamp column and vanish from attrs):
                # the join key is the DECISION's timestamp.
                decision_ts=round(float(ts), 3),
                # Copied verbatim from the decision: the exact id join
                # (settlement_reward_fn prefers it over household+ts).
                request_id=request_id,
                billed_eur=[round(float(b), 8) for b in billed],
            )
    finally:
        tel.close()
    return len(decisions)


def _energy_settlement_eur(cfg, obs: np.ndarray, action: np.ndarray, device="cuda"):
    """The energy half of ``trace_reward``'s attribution (no comfort term
    — comfort is never billed): grid settlement of the household balance
    plus the served heat-pump power under the no-com rule."""
    time_norm, _, balance_w, action = _decision_inputs(cfg, obs, action, device)
    return _host(_no_com_cost(cfg, time_norm, balance_w, action * cfg.thermal.hp_max_power))


def settlement_reward_fn(
    results_db: str,
    cfg,
    telemetry=None,
    warn_stream=None,
    device="cuda",
):
    """A 3-arg ``reward_fn`` for ``export_serve_traces`` attributing reward
    from BILLED settlement rows: ``reward = -(billed_eur + 10 x comfort
    penalty at the observed temperature)`` for transitions whose leading
    decision has a settlement row, with a LOUD (never silent) fallback to
    the environment's tariff model (``trace_reward``) for transitions that
    have none — a one-line warning per export naming the miss count, plus
    a ``settlement_fallback`` telemetry event when a telemetry is given.
    A warehouse with NO settlement rows at all falls back entirely (same
    loud path): the flywheel keeps turning while the meter is down, and
    the warning is the operator's cue that training reward is running on
    the model, not the bill."""
    import sys as _sys

    from p2pmicrogrid_tpu_torch.ops.thermal import comfort_penalty

    warn_stream = warn_stream if warn_stream is not None else _sys.stderr
    dev = resolve_device(device)

    def reward_fn(obs, action, meta):
        con = sqlite3.connect(f"file:{results_db}?mode=ro", uri=True)
        billed: Dict[tuple, np.ndarray] = {}
        # Scope the read to the transitions' own time window (plus slack
        # for billing lag): the settlement table spans the warehouse's
        # whole history, and a week of unattended cycles must not re-read
        # and re-parse every bill ever written on each export.
        ts_vals = [
            m.get("ts") for m in meta if m.get("ts") is not None
        ]
        where = "kind = 'settlement'"
        params: List = []
        if ts_vals:
            where += (
                " AND json_extract(attrs_json, '$.decision_ts')"
                " BETWEEN ? AND ?"
            )
            params += [min(ts_vals) - 1.0, max(ts_vals) + 1.0]
        try:
            try:
                rows = con.execute(
                    "SELECT attrs_json FROM telemetry_points "
                    f"WHERE {where}",
                    params,
                ).fetchall()
            except sqlite3.OperationalError:
                rows = []  # pre-warehouse DB
        finally:
            con.close()
        billed_by_id: Dict[str, np.ndarray] = {}
        for (attrs_json,) in rows:
            try:
                attrs = json.loads(attrs_json) if attrs_json else {}
            except ValueError:
                continue
            household = attrs.get("household")
            values = attrs.get("billed_eur")
            if not household or values is None:
                continue
            # host-sync: warehouse JSON payloads, host data.
            arr = np.asarray(values, dtype=np.float32)
            key = _settlement_key(household, attrs.get("decision_ts"))
            billed[key] = arr
            rid = attrs.get("request_id")
            if rid:
                billed_by_id[str(rid)] = arr
        n = obs.shape[0]
        reward = np.zeros(action.shape, dtype=np.float32)
        th = cfg.thermal
        missing: List[int] = []
        for i in range(n):
            m = meta[i] if i < len(meta) else {}
            # Exact join by the decision's request_id (the serving-side
            # trace span_id, carried through decision AND bill) when the
            # warehouse has it; household+timestamp stays as the legacy
            # fallback for warehouses written before ids existed.
            rid = m.get("request_id")
            row = billed_by_id.get(str(rid)) if rid else None
            if row is None:
                row = billed.get(
                    _settlement_key(m.get("household"), m.get("ts"))
                )
            if row is None or row.shape != action[i].shape:
                missing.append(i)
                continue
            t_in = torch.as_tensor(obs[i, :, 1], device=dev) * th.margin + th.setpoint
            reward[i] = -(row + 10.0 * _host(comfort_penalty(th, t_in)))
        if missing:
            fallback = trace_reward(cfg, obs[missing], action[missing], device=dev)
            reward[missing] = fallback
            msg = (
                f"settlement WARNING: {len(missing)}/{n} transition(s) "
                "have no billed settlement row — falling back to the "
                "env tariff model for those (training reward is partly "
                "model-derived until the meter catches up)."
            )
            print(msg, file=warn_stream, flush=True)
            if telemetry is not None:
                telemetry.event(
                    "settlement_fallback",
                    missing=len(missing),
                    total=n,
                )
        return reward

    return reward_fn


def to_replay_state(dataset: TraceDataset, capacity: Optional[int] = None, device="cuda"):
    """Load a ``TraceDataset`` into the per-agent replay ring
    (``models/replay.ReplayState`` — leaves ``[A, cap, ...]`` on
    ``device``), newest transitions kept when the dataset overflows
    ``capacity``. The ring holds ``count = keep`` filled entries and its
    cursor at ``keep % cap``, as if the kept transitions had been
    ``replay_add``-ed in order, so samplers see the standard filled-region
    semantics.
    """
    from p2pmicrogrid_tpu_torch.models.replay import replay_init

    n, a = dataset.n_transitions, dataset.n_agents
    cap = capacity or max(n, 1)
    keep = min(n, cap)
    sl = slice(n - keep, n)  # newest transitions win on overflow
    state = replay_init(a, cap, obs_dim=dataset.obs.shape[-1], act_dim=1, device=device)
    dev = state.obs.device
    # [N, A, ...] -> [A, N, ...] ring layout.
    put = lambda x: torch.as_tensor(np.ascontiguousarray(np.swapaxes(x, 0, 1)), device=dev)
    state.obs[:, :keep] = put(dataset.obs[sl])
    state.action[:, :keep] = put(dataset.action[sl][..., None])
    state.reward[:, :keep] = put(dataset.reward[sl])
    state.next_obs[:, :keep] = put(dataset.next_obs[sl])
    return state._replace(cursor=keep % cap, count=keep)
