"""Autopilot: crash-safe unattended continual-deployment cycles.

The port of the JAX package's ``serve/autopilot.py``: the same journal
(format, digest, phases), cycles, rows and harness, over the port's fleet.
Its engines and evaluations run on ``serve_device="cuda"`` by default (the
JAX package defaults to the CPU), and raise without a card unless
``serve_device="cpu"``. Two things differ. The post-cycle invariant sends
its check requests one at a time and holds each answer to the reference
engine's act on that one observation, still with ``==``: a DDPG answer can
differ by an ulp between padding buckets (cuBLAS picks its kernel by
shape), so a batched reference would compare different buckets. Each
cycle row carries ``kernel_launches``, the card kernels that cycle
launched in this process (the gate's evaluations through K1).

The flywheel's machinery — trace export (data/trace_export.py), continual
fine-tuning (train/continual.py), the gated promotion + canary rails
(serve/promotion.py) — leaves an operator typing ``continual`` then
``promote`` against one in-process gateway. This module is the supervisor
that runs the WHOLE cycle on a cadence against a live multi-replica fleet,
and survives its own death:

* **One cycle** = export → retrain → gate → canary → promote/abort,
  driven over a real ``FleetRouter`` front: candidates reach already-
  running replicas through ``POST /admin/register`` (``router.
  register_fleet``), canary splits push fleet-wide, and the 100% stage
  is ``router.swap_fleet`` — the two-phase zero-drop swap.

* **Crash-safe cycle state.** Every phase transition lands in a journal
  file first (``write_journal``: write-temp → fsync → digest → atomic
  rename — the same integrity contract as ``train/checkpoint.py``),
  recording the phase (exporting / retraining / gating / canarying /
  promoted / aborted), the incumbent and candidate config hashes and the
  cumulative safety counters. A SIGKILL at ANY instant leaves a journal
  a relaunched autopilot recovers from (``Autopilot.recover``): phases
  before traffic exposure (exporting/retraining/gating) re-run the same
  cycle from the top — they are idempotent — while a kill mid-CANARY
  aborts back to the incumbent: split cleared fleet-wide, pins cleared,
  the candidate unregistered, and the fleet default verified to be the
  incumbent before the next cycle starts. The fleet is never left
  half-ramped and an orphaned candidate never keeps serving traffic.

* **Export/retention handshake.** Each cycle takes an export LEASE in
  the warehouse (``data/results.acquire_export_lease``) naming its
  window start (the previous cycle's released watermark);
  ``compact_serve_telemetry`` caps its cutoff at active leases, so the
  retention pass and the export coordinate by schedule instead of racing
  by convention. The ``TracesCompactedError`` contract stays as the loud
  backstop for a FORCED race (expired lease, operator override).

* **Metered-reward settlement.** Before exporting, the cycle bills the
  window's decisions (``data/trace_export.bill_decisions`` — the meter
  stand-in a production deployment replaces) and attributes training
  reward from the billed rows via ``settlement_reward_fn`` — with its
  loud fallback to the env tariff model when rows are missing.

* **Lineage.** Every promotion appends an (incumbent → candidate) link
  to the journal and the warehouse (``promotion`` events), so
  ``telemetry-query --promotions`` renders the ancestry chain a week of
  unattended cycles produced: incumbent → candidate → candidate².

``autopilot_bench`` is the acceptance harness: N unattended cycles over
a real 3-replica ``ProcessFleet`` with a replica SIGKILL mid-run (chaos),
injected bad candidates (cost-regressed, NaN-poisoned) that must never
promote, at least one honest promotion, availability 1.0 throughout, and a
mid-cycle SIGKILL of the autopilot process itself that recovers cleanly.
The injected candidates are the crafted tabular bundles of
``serve/promotion.py::make_crafted_bundle``, so the harness runs a tabular
configuration.

This module runs on the host by construction: every array it touches is
wire or warehouse JSON.
"""

from __future__ import annotations

import asyncio
import dataclasses
import hashlib
import json
import os
import sqlite3
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from p2pmicrogrid_tpu_torch.device import resolve_device
from p2pmicrogrid_tpu_torch.ops._build import kernel_launches

CYCLE_PHASES = (
    "idle", "exporting", "retraining", "gating", "canarying",
    "promoted", "aborted",
)
# Phases with NO candidate traffic exposure: a crash here re-runs the
# cycle (idempotent); a crash in 'canarying' must abort to the incumbent.
_RERUNNABLE_PHASES = ("exporting", "retraining", "gating")

JOURNAL_NAME = "cycle_journal.json"
JOURNAL_KIND = "autopilot_journal"
JOURNAL_FORMAT_VERSION = 1


class JournalCorrupt(RuntimeError):
    """The cycle journal failed its digest/shape verification."""


# -- crash-safe journal --------------------------------------------------------


@dataclass
class AutopilotState:
    """The durable cycle state (one journal file, rewritten atomically)."""

    cycle: int = 0
    phase: str = "idle"
    incumbent_dir: Optional[str] = None
    incumbent_hash: Optional[str] = None
    candidate_dir: Optional[str] = None
    candidate_hash: Optional[str] = None
    inject_kind: Optional[str] = None
    window_start_ts: float = 0.0
    lease_id: Optional[str] = None
    # Cumulative safety ledger (survives restarts — the headline numbers).
    promotions: int = 0
    blocked: int = 0
    rollbacks: int = 0
    crash_aborts: int = 0
    bad_promotions: int = 0
    n_requests: int = 0
    n_ok: int = 0
    n_shed: int = 0
    lineage: List[dict] = field(default_factory=list)
    last_error: Optional[str] = None
    updated_ts: float = 0.0

    @property
    def availability(self) -> float:
        admitted = self.n_requests - self.n_shed
        return self.n_ok / admitted if admitted else 1.0

    def to_doc(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_doc(cls, doc: dict) -> "AutopilotState":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in doc.items() if k in fields})


def _state_digest(doc: dict) -> str:
    payload = json.dumps(doc, sort_keys=True, separators=(",", ":"))
    return f"sha256:{hashlib.sha256(payload.encode()).hexdigest()}"


def journal_path(state_dir: str) -> str:
    return os.path.join(state_dir, JOURNAL_NAME)


def write_journal(state_dir: str, state: AutopilotState) -> str:
    """Persist the cycle state with the checkpoint integrity contract:
    write to a same-directory temp file, fsync, verify the digest reads
    back, atomically rename over the journal, fsync the directory. A
    SIGKILL before the rename leaves the previous journal intact; after
    it, the new one — never a torn file."""
    from p2pmicrogrid_tpu_torch.train.checkpoint import _fsync_dir, _fsync_file

    os.makedirs(state_dir, exist_ok=True)
    state.updated_ts = time.time()
    doc = state.to_doc()
    record = {
        "kind": JOURNAL_KIND,
        "format_version": JOURNAL_FORMAT_VERSION,
        "digest": _state_digest(doc),
        "state": doc,
    }
    path = journal_path(state_dir)
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(record, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    # Digest read-back before the rename: a torn/bit-flipped temp must
    # never replace a good journal.
    with open(tmp) as f:
        back = json.load(f)
    if back.get("digest") != _state_digest(back.get("state", {})):
        os.unlink(tmp)
        raise JournalCorrupt(f"{tmp}: digest mismatch on read-back")
    os.replace(tmp, path)
    _fsync_file(path)
    _fsync_dir(state_dir)
    return path


def read_journal(state_dir: str) -> Optional[AutopilotState]:
    """The verified journal state, or None when none exists. Raises
    ``JournalCorrupt`` on a journal that exists but fails verification —
    loud, because silently starting a fresh cycle over a fleet whose
    real state is unknown is exactly the failure the journal prevents."""
    path = journal_path(state_dir)
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            record = json.load(f)
    except (OSError, json.JSONDecodeError) as err:
        raise JournalCorrupt(f"{path}: unreadable ({err})") from None
    if record.get("kind") != JOURNAL_KIND:
        raise JournalCorrupt(f"{path}: not an autopilot journal")
    doc = record.get("state")
    if not isinstance(doc, dict):
        raise JournalCorrupt(f"{path}: missing state")
    if record.get("digest") != _state_digest(doc):
        raise JournalCorrupt(f"{path}: digest mismatch")
    state = AutopilotState.from_doc(doc)
    if state.phase not in CYCLE_PHASES:
        raise JournalCorrupt(f"{path}: unknown phase {state.phase!r}")
    return state


# -- the supervisor ------------------------------------------------------------


class _FleetRoutingView:
    """Duck-types the two registry attributes ``CanaryController``
    consults when every routing mutation is delegated to fleet-wide
    hooks: the locally-tracked default hash and split."""

    def __init__(self, default_hash: Optional[str]):
        self.default_hash = default_hash
        self.split = None


class Autopilot:
    """The unattended retrain→gate→canary supervisor over a live fleet.

    ``router`` is a ``FleetRouter`` over the serving replicas (the
    autopilot holds the operator token when the fleet enforces auth).
    ``traffic_fn(cycle, n_requests, seed) -> FleetLoadgenResult``
    overrides the baseline traffic source (default: the open-loop
    Poisson loadgen through the router — a production deployment has
    ambient traffic instead). ``hold_s`` maps phase -> seconds slept
    right after that phase's journal write: the deterministic kill
    window the crash tests (and nothing else) use.
    """

    def __init__(
        self,
        cfg,
        router,
        incumbent_dir: str,
        state_dir: str,
        results_db: str,
        telemetry=None,
        gate_budgets=None,
        canary_budgets=None,
        stages: Sequence[float] = (25.0, 100.0),
        requests_per_cycle: int = 128,
        canary_requests: int = 64,
        n_households: int = 16,
        rate_hz: float = 64.0,
        seed: int = 0,
        trace_steps: int = 50,
        sim_episodes: int = 0,
        settlement: bool = True,
        min_transitions: int = 8,
        lease_ttl_s: float = 600.0,
        max_batch: int = 16,
        s_eval: int = 4,
        emit: Optional[Callable[[dict], None]] = None,
        traffic_fn: Optional[Callable] = None,
        hold_s: Optional[Dict[str, float]] = None,
        verify_serving: bool = True,
        serve_device="cuda",
    ):
        from p2pmicrogrid_tpu_torch.serve.promotion import (
            CanaryBudgets,
            GateBudgets,
        )

        self.cfg = cfg
        self.router = router
        self.state_dir = state_dir
        self.results_db = results_db
        self.telemetry = telemetry
        self.gate_budgets = gate_budgets or GateBudgets()
        self.canary_budgets = canary_budgets or CanaryBudgets()
        self.stages = tuple(stages)
        self.requests_per_cycle = requests_per_cycle
        self.canary_requests = canary_requests
        self.n_households = n_households
        self.rate_hz = rate_hz
        self.seed = seed
        self.trace_steps = trace_steps
        self.sim_episodes = sim_episodes
        self.settlement = settlement
        self.min_transitions = min_transitions
        self.lease_ttl_s = lease_ttl_s
        self.max_batch = max_batch
        self.s_eval = s_eval
        self.emit = emit
        self.traffic_fn = traffic_fn
        self.hold_s = dict(hold_s or {})
        self.verify_serving = verify_serving
        # The gate/verify reference engines must run on the SAME backend
        # the fleet serves from, or the bit-exact serving check fails on
        # honest float differences (--no-verify-serving is the
        # mixed-backend escape).
        resolve_device(serve_device)
        self.serve_device = serve_device
        self._incumbent_eval_cache: Dict[str, tuple] = {}

        state = read_journal(state_dir)
        if state is None:
            from p2pmicrogrid_tpu_torch.serve.export import load_policy_bundle

            manifest, _ = load_policy_bundle(incumbent_dir)
            state = AutopilotState(
                incumbent_dir=os.path.abspath(incumbent_dir),
                incumbent_hash=manifest.get("config_hash"),
            )
            write_journal(state_dir, state)
        self.state = state
        # A relaunched autopilot starts with a FRESH router whose
        # known_bundles map is empty — seed it from the journal so the
        # prober can still re-register the (possibly runtime-promoted)
        # incumbent on a replica that relaunches later. Without this, a
        # post-restart replica crash would resurrect its launch-time
        # bundle forever (_push_swap's 404 path has nothing to register).
        if state.incumbent_hash and state.incumbent_dir and hasattr(
            router, "known_bundles"
        ):
            router.known_bundles.setdefault(
                state.incumbent_hash, state.incumbent_dir
            )

    # -- plumbing ------------------------------------------------------------

    def _journal(self, phase: str, **updates) -> None:
        st = self.state
        st.phase = phase
        for k, v in updates.items():
            setattr(st, k, v)
        write_journal(self.state_dir, st)
        if self.telemetry is not None:
            self.telemetry.event(
                "autopilot_phase",
                cycle=st.cycle,
                phase=phase,
                incumbent=st.incumbent_hash,
                candidate=st.candidate_hash,
            )
            # The audit trail must survive the autopilot's own SIGKILL:
            # buffered warehouse rows (gate verdicts, PROMOTED lineage
            # events) die with the process unless flushed at every
            # journaled transition — and a cycle the journal says
            # happened must be visible to `telemetry-query --promotions`.
            try:
                self.telemetry.flush()
            except Exception:  # noqa: BLE001 — telemetry is best-effort
                pass
        hold = self.hold_s.get(phase, 0.0)
        if hold > 0:
            time.sleep(hold)

    def _log(self, msg: str) -> None:
        print(f"autopilot: {msg}", file=sys.stderr, flush=True)

    def _run_async(self, coro):
        return asyncio.run(coro)

    def _record_traffic(self, result) -> None:
        st = self.state
        st.n_requests += result.n_requests
        st.n_ok += result.n_ok
        st.n_shed += result.n_shed

    def _drive_traffic(self, cycle: int, n_requests: int, seed: int):
        """Open-loop traffic through the router (baseline decisions for
        the next export + the canary stages' traffic)."""
        from p2pmicrogrid_tpu_torch.serve.loadgen import (
            poisson_arrivals,
            synthetic_obs,
        )
        from p2pmicrogrid_tpu_torch.serve.router import run_fleet_loadgen

        if self.traffic_fn is not None:
            return self.traffic_fn(cycle, n_requests, seed)
        obs = synthetic_obs(n_requests, self.cfg.sim.n_agents, seed=seed)
        arrivals = poisson_arrivals(self.rate_hz, n_requests, seed=seed)
        households = [f"house-{i:04d}" for i in range(self.n_households)]
        return run_fleet_loadgen(self.router, obs, arrivals, households)

    def _con(self) -> sqlite3.Connection:
        con = sqlite3.connect(self.results_db)
        return con

    # -- recovery ------------------------------------------------------------

    def recover(self) -> Optional[str]:
        """Reconcile a relaunched autopilot with the journal (module
        docstring). Returns a human-readable description of what recovery
        did, or None when the journal was already at rest."""
        st = self.state
        if st.phase in ("idle", "promoted", "aborted"):
            if st.phase in ("promoted", "aborted"):
                st.cycle += 1
                self._journal("idle")
            return None
        if st.phase in _RERUNNABLE_PHASES:
            # No candidate traffic was exposed; the cycle re-runs from the
            # top. Defensive routing reset anyway — register/split pushes
            # may have partially landed right at the kill instant.
            action = (
                f"crash during {st.phase} (cycle {st.cycle}): re-running "
                "the cycle"
            )
            self._reset_fleet_routing(unregister_candidate=True)
            self._journal("idle", last_error=action)
            return action
        # canarying: the candidate may be taking live traffic RIGHT NOW.
        action = (
            f"crash during canary (cycle {st.cycle}): aborting back to "
            f"incumbent {st.incumbent_hash}"
        )
        self._reset_fleet_routing(unregister_candidate=True)
        st.crash_aborts += 1
        st.cycle += 1
        self._journal(
            "idle",
            candidate_dir=None,
            candidate_hash=None,
            last_error=action,
        )
        return action

    def _reset_fleet_routing(self, unregister_candidate: bool) -> None:
        """Clear any split + pins fleet-wide, verify the incumbent is the
        serving default (two-phase swap back when it is not), and drop an
        orphaned candidate registration."""
        st = self.state
        self._run_async(self.router.clear_split_fleet())
        if st.incumbent_hash:
            try:
                self._run_async(
                    self.router.swap_fleet(st.incumbent_hash)
                )
            except Exception as err:  # noqa: BLE001 — recovery is best-
                # effort per step; the serving check below is the verdict
                self._log(f"recovery swap_fleet: {err}")
        if unregister_candidate and st.candidate_hash and (
            st.candidate_hash != st.incumbent_hash
        ):
            self._run_async(
                self.router.unregister_fleet(st.candidate_hash)
            )

    # -- one cycle -----------------------------------------------------------

    def run_cycle(self, inject_kind: Optional[str] = None) -> dict:
        """One full unattended cycle; returns the ``autopilot_cycle`` row."""
        st = self.state
        cycle = st.cycle
        cycle_dir = os.path.join(self.state_dir, f"cycle-{cycle:04d}")
        os.makedirs(cycle_dir, exist_ok=True)
        t0 = time.time()
        self._launches0 = kernel_launches()
        row: dict = {
            "metric": "autopilot_cycle",
            "value": float(cycle),
            "unit": "cycle",
            "cycle": cycle,
            "inject": inject_kind,
            "incumbent": st.incumbent_hash,
        }

        # Phase 1: export (leased window, settlement-billed rewards).
        self._journal(
            "exporting", inject_kind=inject_kind,
            candidate_dir=None, candidate_hash=None,
        )
        traffic = self._drive_traffic(
            cycle, self.requests_per_cycle, seed=self.seed + 977 * cycle
        )
        self._record_traffic(traffic)
        self._run_async(self.router.flush_fleet())
        dataset = self._export_window(cycle, row)

        # Phase 2: retrain (or inject a crafted candidate).
        self._journal("retraining")
        cand_dir, cand_hash = self._make_candidate(
            cycle, cycle_dir, dataset, inject_kind
        )
        row["candidate"] = cand_hash

        # Phase 3: offline gate.
        self._journal(
            "gating", candidate_dir=cand_dir, candidate_hash=cand_hash
        )
        verdict = self._gate(cand_dir)
        row["gate_verdict"] = verdict.verdict
        row["gate"] = verdict.to_fields()
        if not verdict.passed:
            st.blocked += 1
            self._finish_cycle(
                row, promoted=False, blocked=True, rolled_back=False,
                seconds=time.time() - t0,
            )
            return row

        # Phase 4: live canary over the fleet.
        self._journal("canarying")
        result = self._canary(cycle, cand_dir, cand_hash)
        promoted = result.promoted and not result.rolled_back
        row["canary_stages"] = [s.to_fields() for s in result.stages]
        row["aborted_stage"] = result.aborted_stage
        row["abort_reasons"] = result.reasons
        if promoted:
            st.promotions += 1
            if inject_kind in ("cost_regressed", "nan_poisoned"):
                st.bad_promotions += 1
            st.lineage.append({
                "cycle": cycle,
                "incumbent": st.incumbent_hash,
                "candidate": cand_hash,
                "ts": round(time.time(), 3),
            })
            old_incumbent = st.incumbent_hash
            st.incumbent_dir, st.incumbent_hash = cand_dir, cand_hash
        else:
            old_incumbent = None
            st.rollbacks += 1 if result.rolled_back else 0
            self._run_async(self.router.unregister_fleet(cand_hash))
        self._finish_cycle(
            row, promoted=promoted, blocked=False,
            rolled_back=result.rolled_back, seconds=time.time() - t0,
        )
        if promoted and old_incumbent and old_incumbent != cand_hash:
            # The retired incumbent must not stay registered forever on
            # every replica (a week of cycles would accrete bundles) —
            # but it IS the rollback target until the promotion is
            # JOURNALED: unregistering first would strand a SIGKILL in
            # that window with a journal still naming an incumbent no
            # replica knows (recovery's swap-back would 404 everywhere).
            # After the journal records the new incumbent, dropping the
            # old one is pure cleanup; a crash here merely leaks one
            # stale registration until the replica's next relaunch.
            self._run_async(self.router.unregister_fleet(old_incumbent))
        return row

    def _export_window(self, cycle: int, row: dict):
        from p2pmicrogrid_tpu_torch.data.results import (
            ExportLeaseScope,
            last_export_watermark,
        )
        from p2pmicrogrid_tpu_torch.data.trace_export import (
            bill_decisions,
            export_serve_traces,
            settlement_reward_fn,
        )

        st = self.state
        con = self._con()
        try:
            watermark = last_export_watermark(con, st.incumbent_hash)
        finally:
            con.close()
        if watermark is None:
            # A freshly-promoted incumbent has no export history: its
            # window starts at the PROMOTION instant (the lineage
            # link), not at 0 — which keeps since_ts set, so aggregates
            # from the previous incumbent's era read as scheduled
            # history rather than condemning the export.
            watermark = next(
                (
                    link["ts"] for link in reversed(st.lineage)
                    if link["candidate"] == st.incumbent_hash
                ),
                None,
            )
        window_start = watermark if watermark is not None else 0.0
        # A failed export CANCELS the lease on scope exit (retention is
        # not gated for the TTL); a SIGKILL leaves it to expire.
        with ExportLeaseScope(
            self.results_db,
            holder=f"autopilot-cycle-{cycle}",
            window_start_ts=window_start,
            ttl_s=self.lease_ttl_s,
            config_hash=st.incumbent_hash,
        ) as scope:
            st.window_start_ts = window_start
            st.lease_id = scope.lease_id
            write_journal(self.state_dir, st)
            billed = 0
            reward_fn = None
            if self.settlement:
                billed = bill_decisions(
                    self.results_db, self.cfg,
                    config_hash=st.incumbent_hash,
                    since_ts=window_start or None,
                    device=self.serve_device,
                )
                reward_fn = settlement_reward_fn(
                    self.results_db, self.cfg, telemetry=self.telemetry,
                    device=self.serve_device,
                )
            dataset = export_serve_traces(
                self.results_db,
                config_hash=st.incumbent_hash,
                cfg=self.cfg,
                reward_fn=reward_fn,
                min_transitions=self.min_transitions,
                since_ts=window_start or None,
                device=self.serve_device,
            )
            exported_through = dataset.window_end_ts or time.time()
            scope.release(exported_through)
        st.lease_id = None
        row["trace_transitions"] = dataset.n_transitions
        row["settlement_billed"] = billed
        row["window_start_ts"] = round(window_start, 3)
        row["window_end_ts"] = round(exported_through, 3)
        self._log(
            f"cycle {cycle}: exported {dataset.n_transitions} transitions "
            f"({billed} billed) from window >= {window_start:.3f}"
        )
        return dataset

    def _make_candidate(self, cycle, cycle_dir, dataset, inject_kind):
        from p2pmicrogrid_tpu_torch.serve.promotion import make_crafted_bundle
        from p2pmicrogrid_tpu_torch.telemetry import config_hash as cfg_hash
        from p2pmicrogrid_tpu_torch.train.continual import train_continual

        out_dir = os.path.join(cycle_dir, "candidate")
        if inject_kind:
            # Injected candidate (the harness's regression source): a
            # crafted closed-form bundle under a cycle-distinct hash.
            cand_cfg = self.cfg.replace(
                train=dataclasses.replace(
                    self.cfg.train,
                    starting_episodes=(
                        self.cfg.train.starting_episodes + 1000 + cycle
                    ),
                )
            )
            make_crafted_bundle(
                cand_cfg, inject_kind, out_dir, device=self.serve_device
            )
            return out_dir, cfg_hash(cand_cfg)
        result = train_continual(
            self.cfg,
            self.state.incumbent_dir,
            dataset,
            out_dir,
            os.path.join(cycle_dir, "ckpt"),
            n_episodes=self.sim_episodes,
            trace_steps=self.trace_steps,
            telemetry=self.telemetry,
            s_eval=self.s_eval,
            device=self.serve_device,
        )
        return result.candidate_dir, result.candidate_hash

    def _gate(self, cand_dir: str):
        from p2pmicrogrid_tpu_torch.serve.promotion import (
            evaluate_bundle_cost,
            run_promotion_gate,
        )

        st = self.state
        cached = self._incumbent_eval_cache.get(st.incumbent_hash)
        if cached is None:
            cached = evaluate_bundle_cost(
                self.cfg, st.incumbent_dir, s_eval=self.s_eval,
                device=self.serve_device,
            )
            self._incumbent_eval_cache[st.incumbent_hash] = cached
        return run_promotion_gate(
            self.cfg,
            cand_dir,
            st.incumbent_dir,
            budgets=self.gate_budgets,
            telemetry=self.telemetry,
            s_eval=self.s_eval,
            bench_requests=64,
            bench_seed=self.seed,
            max_batch=self.max_batch,
            device=self.serve_device,
            incumbent_eval=cached,
        )

    def _canary(self, cycle: int, cand_dir: str, cand_hash: str):
        from p2pmicrogrid_tpu_torch.serve.promotion import (
            CanaryController,
            StageTraffic,
        )

        st = self.state
        router = self.router
        self._run_async(router.register_fleet(cand_dir))
        view = _FleetRoutingView(st.incumbent_hash)

        def swap_fn(config_hash: str) -> None:
            self._run_async(router.swap_fleet(config_hash))
            view.default_hash = config_hash

        def split_fn(config_hash: str, percent: float) -> None:
            self._run_async(router.split_fleet(config_hash, percent))
            view.split = (config_hash, percent)

        def clear_split_fn() -> None:
            self._run_async(router.clear_split_fleet())
            view.split = None

        def clear_pins_fn() -> None:
            self._run_async(router.clear_pins_fleet())

        def flush_fn() -> None:
            self._run_async(router.flush_fleet())

        def drive_stage(plan) -> StageTraffic:
            result = self._drive_traffic(
                cycle,
                self.canary_requests,
                seed=self.seed + 7919 * cycle + 31 * (plan.index + 1),
            )
            self._record_traffic(result)
            households = [
                f"house-{i:04d}" for i in range(self.n_households)
            ]
            return StageTraffic(
                statuses=result.statuses,
                latencies_ms=result.latencies_s * 1e3,
                config_hashes=result.config_hashes,
                actions=result.actions,
                households=[
                    households[i % len(households)]
                    for i in range(result.n_requests)
                ],
                n_shed=result.n_shed,
            )

        controller = CanaryController(
            view,
            candidate_hash=cand_hash,
            incumbent_hash=st.incumbent_hash,
            cfg=self.cfg,
            stages=self.stages,
            budgets=self.canary_budgets,
            telemetry=self.telemetry,
            results_db=self.results_db,
            flush_fn=flush_fn,
            swap_fn=swap_fn,
            split_fn=split_fn,
            clear_split_fn=clear_split_fn,
            clear_pins_fn=clear_pins_fn,
            device=self.serve_device,
        )
        return controller.run(drive_stage)

    def _finish_cycle(
        self, row: dict, promoted: bool, blocked: bool, rolled_back: bool,
        seconds: float,
    ) -> None:
        st = self.state
        row.update(
            promoted=promoted,
            blocked_at_gate=blocked,
            rolled_back=rolled_back,
            availability=round(st.availability, 6),
            n_requests=st.n_requests,
            incumbent_after=st.incumbent_hash,
            lineage=[link["candidate"] for link in st.lineage],
            seconds=round(seconds, 3),
        )
        now = kernel_launches()
        row["kernel_launches"] = {
            name: n - self._launches0.get(name, 0) for name, n in now.items()
        }
        # Safe outcome per injection contract: crafted regressions must
        # never promote; everything else is the gate/canary's call.
        inject = st.inject_kind
        row["outcome_ok"] = not (
            inject in ("cost_regressed", "nan_poisoned") and promoted
        )
        row["vs_baseline"] = 1.0 if row["outcome_ok"] else 0.0
        if self.verify_serving:
            row["serving_verified"] = self._verify_incumbent_serving()
        self._journal("promoted" if promoted else "aborted")
        if self.telemetry is not None:
            self.telemetry.event(
                "autopilot_cycle",
                **{
                    k: v for k, v in row.items()
                    if k not in ("metric", "value", "unit", "gate")
                },
            )
        if self.emit is not None:
            self.emit(row)
        self._log(
            f"cycle {st.cycle}: "
            + ("PROMOTED" if promoted else
               "blocked at gate" if blocked else
               "rolled back" if rolled_back else "aborted")
            + f" (candidate {st.candidate_hash}, availability "
            f"{st.availability:.4f})"
        )

    def _verify_incumbent_serving(self) -> bool:
        """Bit-exact check: the fleet's default answers MUST match a
        direct engine on the journal's incumbent bundle — the post-cycle
        invariant every cycle (and every recovery) re-establishes.

        The four check requests go one at a time, so each is served alone
        (padding bucket 1), and each answer is held with ``==`` to the
        engine's act on that one observation: a DDPG answer from another
        bucket may differ by an ulp (the GEMM's kernel follows its shape)."""
        from p2pmicrogrid_tpu_torch.serve.engine import PolicyEngine
        from p2pmicrogrid_tpu_torch.serve.loadgen import synthetic_obs
        from p2pmicrogrid_tpu_torch.serve.router import run_fleet_loadgen

        st = self.state
        obs = synthetic_obs(4, self.cfg.sim.n_agents, seed=self.seed + 555)
        results = []
        for i in range(obs.shape[0]):
            result = run_fleet_loadgen(
                self.router, obs[i:i + 1], np.zeros(1), ["verify-house"]
            )
            self._record_traffic(result)
            results.append(result)
        if not all((r.statuses == 200).all() for r in results):
            return False
        if any(
            h != st.incumbent_hash for r in results for h in r.config_hashes
        ):
            return False
        engine = PolicyEngine(
            bundle_dir=st.incumbent_dir, max_batch=self.max_batch,
            device=self.serve_device,
        )
        for i, r in enumerate(results):
            want = engine.act(obs[i:i + 1])
            # host-sync: wire JSON payloads, host data.
            got = np.asarray(r.actions, dtype=np.float32)
            if not (got == want).all():
                return False
        return True

    # -- the cadence loop ----------------------------------------------------

    def run(
        self,
        n_cycles: int,
        cadence_s: float = 0.0,
        inject_plan: Optional[Dict[int, str]] = None,
    ) -> AutopilotState:
        """Recover, then run cycles until ``n_cycles`` TOTAL cycles have
        completed (journal-counted — a relaunched autopilot continues
        where the journal left off, which is what makes the SIGKILL
        harness's 'same command line again' recovery work)."""
        inject_plan = inject_plan or {}
        recovery = self.recover()
        if recovery:
            self._log(f"recovered: {recovery}")
            if self.telemetry is not None:
                self.telemetry.event(
                    "autopilot_recovery", detail=recovery,
                    cycle=self.state.cycle,
                )
        while self.state.cycle < n_cycles:
            self.run_cycle(inject_plan.get(self.state.cycle))
            self.state.cycle += 1
            self._journal("idle")
            if cadence_s > 0 and self.state.cycle < n_cycles:
                time.sleep(cadence_s)
        return self.state

    def summary_row(self) -> dict:
        st = self.state
        all_safe = st.bad_promotions == 0
        return {
            # Same metric name as the bench headline, so a daemon run's
            # rows end in the autopilot_bench headline as the bench's do.
            "metric": "autopilot_bench",
            "value": float(st.cycle),
            "unit": "cycles",
            "vs_baseline": 1.0 if all_safe else 0.0,
            "cycles": st.cycle,
            "promotions": st.promotions,
            "blocked": st.blocked,
            "rollbacks": st.rollbacks,
            "crash_aborts": st.crash_aborts,
            "bad_promotions": st.bad_promotions,
            "availability": round(st.availability, 6),
            "n_requests": st.n_requests,
            "all_safe": all_safe,
            "incumbent": st.incumbent_hash,
            "lineage": [link["candidate"] for link in st.lineage],
        }


def parse_inject_plan(spec: Optional[str]) -> Dict[int, str]:
    """``"1:cost_regressed,2:nan_poisoned"`` -> {1: ..., 2: ...} (the
    ``autopilot --inject`` syntax; ``good`` injects the crafted honest
    improvement, empty/None injects nothing — every cycle retrains)."""
    plan: Dict[int, str] = {}
    if not spec:
        return plan
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        cycle_s, _, kind = part.partition(":")
        kind = kind.strip()
        if kind not in ("good", "cost_regressed", "nan_poisoned", "continual"):
            raise ValueError(
                f"unknown inject kind {kind!r} (good | cost_regressed | "
                "nan_poisoned | continual)"
            )
        plan[int(cycle_s)] = None if kind == "continual" else kind
    return plan


# -- the acceptance harness ----------------------------------------------------


def autopilot_bench(
    cfg,
    work_dir: str,
    n_replicas: int = 3,
    n_cycles: int = 3,
    inject: str = "0:good,1:cost_regressed,2:nan_poisoned",
    seed: int = 0,
    chaos: bool = True,
    chaos_kill_after_s: float = 6.0,
    sigkill_phase: Optional[str] = "retraining",
    sigkill_cycle: int = 1,
    requests_per_cycle: int = 96,
    canary_requests: int = 64,
    n_households: int = 16,
    stages: str = "25,100",
    emit: Optional[Callable[[dict], None]] = None,
    startup_timeout_s: float = 300.0,
    cycle_timeout_s: float = 1200.0,
    extra_cfg_args: Optional[List[str]] = None,
    device="cuda",
) -> List[dict]:
    """The acceptance harness (module docstring): a crafted
    incumbent serves from a real ``ProcessFleet``; the autopilot runs as
    its OWN subprocess (``python -m p2pmicrogrid_tpu_torch autopilot``)
    against the fleet; a replica
    is SIGKILLed mid-run (the supervisor relaunches it); the autopilot
    itself is SIGKILLed in ``sigkill_phase`` of ``sigkill_cycle`` (the
    journal poll gives the deterministic window) and relaunched with the
    SAME command line — recovery must finish the remaining cycles.
    Emits the per-cycle rows the autopilot wrote plus the
    ``autopilot_bench`` headline (LAST).

    ``device`` places the fleet's children, the autopilot's engines and
    evaluations, and the crafted bundles' export (the card by default)."""
    import shutil
    import signal
    import subprocess
    import threading

    from p2pmicrogrid_tpu_torch.serve.procfleet import ProcessFleet
    from p2pmicrogrid_tpu_torch.serve.promotion import make_crafted_bundle

    device = str(resolve_device(device))
    os.makedirs(work_dir, exist_ok=True)
    results_db = os.path.join(work_dir, "warehouse.db")
    state_dir = os.path.join(work_dir, "autopilot")
    out_path = os.path.join(work_dir, "cycles.jsonl")
    for stale in (results_db, out_path):
        if os.path.exists(stale):
            os.unlink(stale)
    if os.path.isdir(state_dir):
        shutil.rmtree(state_dir)
    incumbent_dir = make_crafted_bundle(
        cfg, "incumbent", os.path.join(work_dir, "incumbent"), device=device
    )

    fleet = ProcessFleet(
        [incumbent_dir],
        n_replicas=n_replicas,
        max_batch=16,
        results_db=results_db,
        serve_device=device,
        supervise=True,
        startup_timeout_s=startup_timeout_s,
    )
    rows: List[dict] = []
    sigkills = 0
    chaos_kill: List[str] = []
    replicas = fleet.start()
    try:
        argv = [
            sys.executable, "-m", "p2pmicrogrid_tpu_torch", "autopilot",
            "--incumbent", incumbent_dir,
            "--state-dir", state_dir,
            "--results-db", results_db,
            "--cycles", str(n_cycles),
            "--inject", inject,
            "--out", out_path,
            "--requests-per-cycle", str(requests_per_cycle),
            "--canary-requests", str(canary_requests),
            "--households", str(n_households),
            "--stages", stages,
            "--seed", str(seed),
            "--device", device,
        ] + list(extra_cfg_args or [])
        for rep in replicas:
            spec = f"{rep.host}:{rep.port}"
            if rep.mux_port:
                spec += f"/{rep.mux_port}"
            argv += ["--replica", spec]

        env = dict(os.environ)
        if sigkill_phase:
            # The kill window: the autopilot sleeps right after
            # journaling sigkill_phase, so the poll below always lands.
            env["P2P_AUTOPILOT_HOLD"] = json.dumps({sigkill_phase: 8.0})

        def spawn() -> subprocess.Popen:
            return subprocess.Popen(
                argv, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True,
            )

        def pump(proc, sink: List[str]) -> threading.Thread:
            def run():
                for line in proc.stdout:
                    sink.append(line.rstrip("\n"))
            t = threading.Thread(target=run, daemon=True)
            t.start()
            return t

        if chaos:
            victim = replicas[-1].replica_id

            def chaos_run():
                time.sleep(chaos_kill_after_s)
                fleet.kill(victim)
                chaos_kill.append(victim)

            threading.Thread(target=chaos_run, daemon=True).start()

        proc = spawn()
        log: List[str] = []
        pump(proc, log)
        recovered = True
        if sigkill_phase:
            # Poll the journal for the kill window.
            end = time.monotonic() + cycle_timeout_s
            killed = False
            while time.monotonic() < end and proc.poll() is None:
                try:
                    st = read_journal(state_dir)
                except JournalCorrupt:
                    st = None
                if (
                    st is not None
                    and st.cycle == sigkill_cycle
                    and st.phase == sigkill_phase
                ):
                    proc.send_signal(signal.SIGKILL)
                    proc.wait(timeout=30)
                    sigkills += 1
                    killed = True
                    break
                time.sleep(0.2)
            if killed:
                # Same command line again: the journal drives recovery.
                proc = spawn()
                pump(proc, log)
            else:
                recovered = False  # window never opened — report it
        rc = proc.wait(timeout=cycle_timeout_s)
        if rc != 0:
            tail = "\n".join(log[-30:])
            raise RuntimeError(
                f"autopilot exited rc={rc}; log tail:\n{tail}"
            )

        child_rows: List[dict] = []
        with open(out_path) as f:
            for line in f:
                line = line.strip()
                if line:
                    child_rows.append(json.loads(line))
        # Re-emit only the per-cycle rows: the child's own summary
        # headline would duplicate (and misplace) the bench headline
        # appended below.
        cycles = [
            r for r in child_rows if r.get("metric") == "autopilot_cycle"
        ]
        rows.extend(cycles)
        final = read_journal(state_dir)
        promotions = final.promotions
        all_safe = final.bad_promotions == 0 and all(
            r.get("outcome_ok", False) for r in cycles
        )
        serving_ok = all(
            r.get("serving_verified") in (True, None) for r in cycles
        )
        rows.append({
            "metric": "autopilot_bench",
            "value": float(final.cycle),
            "unit": "cycles",
            "vs_baseline": 1.0 if (all_safe and promotions >= 1) else 0.0,
            "cycles": final.cycle,
            "promotions": promotions,
            "blocked": final.blocked,
            "rollbacks": final.rollbacks,
            "crash_aborts": final.crash_aborts,
            "bad_promotions": final.bad_promotions,
            "availability": round(final.availability, 6),
            "n_requests": final.n_requests,
            "all_safe": bool(all_safe),
            "serving_verified": bool(serving_ok),
            "autopilot_sigkills": sigkills,
            "autopilot_recovered": bool(recovered and sigkills > 0),
            "lineage": [link["candidate"] for link in final.lineage],
            "incumbent_after": final.incumbent_hash,
            "n_replicas": n_replicas,
            "process_mode": True,
            "chaos": {
                "enabled": chaos,
                "kills": list(fleet.kills),
                "restarts": list(fleet.restarts),
            },
            "inject": inject,
            "seed": seed,
            "journal": os.path.abspath(journal_path(state_dir)),
        })
    finally:
        fleet.stop_all()
    if emit is not None:
        for row in rows:
            emit(row)
    return rows
