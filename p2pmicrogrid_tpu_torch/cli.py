"""Command-line interface of the port: ``python -m p2pmicrogrid_tpu_torch``.

The port of the JAX package's ``cli.py`` for the subcommands below, with the
same flags, defaults, ``dest``s, stdout lines and exit codes, and the same
results store (``data/results.py``): one SQLite file holds the runs of both
packages. ``_build_cfg`` is the JAX package's verbatim, so the same argv gives
the same ``repr(cfg)``, ``config_hash``, setting name and checkpoint
directory in both command lines.

Subcommands:
  train     train a community (tabular/dqn/ddpg), checkpoint, log progress;
            --scenarios N batches Monte-Carlo scenarios (--shared for one
            scenario-averaged learner, --chunks K for K chunks of N an
            episode through the chunk graph), --resume continues from a
            checkpoint, --supervise relaunches a crashed child
  single    standalone single-home harness (train one no-trading home, then
            compare the greedy policy against the bang-bang thermostat)
  multi     multi-community training with inter-community trading
  eval      load a checkpoint, run greedy per-day evaluation, persist results
  baseline  run the rule-based thermostat baseline over the test days
  sweep     DDPG hyperparameter sweep
  forecast  train + evaluate the load/PV forecaster
  export-bundle
            freeze a checkpoint's greedy parameters into a versioned
            policy bundle for serving (serve/export.py)
  train-recurrent
            train the recurrent day-granular LSTM DDPG actor
  serve-bench
            open-loop serving benchmark: the engine, one gateway over the
            network, the continuous-vs-microbatch and wire comparisons, or
            a fleet of replicas behind the router (in process or as
            subprocesses, with chaos, TLS, auth and tracing)
  serve-gateway
            run the HTTP serving gateway over one or more policy bundles
            (serve/gateway.py)
  serve-token
            mint fleet auth secrets and per-household bearer tokens
  continual fine-tune the incumbent bundle on warehouse serve traces and
            export a candidate bundle (data/trace_export.py +
            train/continual.py)
  promote   gate a candidate against the incumbent and ramp it through a
            live canary with auto-rollback (serve/promotion.py)
  regime-bench
            the regime-portfolio acceptance harness (regimes/bench.py)
  autopilot unattended retrain -> gate -> canary cycles over a live fleet,
            with a crash-safe cycle journal (serve/autopilot.py); --bench
            runs the acceptance harness
  serve-router
            run the fleet router as a standalone proxy process
            (serve/proxy.py)
  telemetry-report
            render a telemetry run directory into a human-readable summary
  telemetry-query
            SQL over the telemetry warehouse in a results DB

Every command that runs the simulator or a model takes ``--device``: ``cuda``
(the default; ``default`` means the same) runs on the card and exits
non-zero without one, ``cpu`` runs on the CPU. ``auto`` (the JAX package's
crossover placement) exits non-zero: placement waits for a crossover
measured on the card (ROADMAP.md, Queue 1, item 8). Random keys are
``torch.Generator``s on the run's device seeded with ``--seed``; traces and
ratings draw from seeded numpy as in the JAX package.

Not ported yet, and not registered (ROADMAP.md, Queue 1): ``bench`` (item 3,
the port's bench) and ``analyse`` (item 15, with ``--figures-dir`` of
``eval`` and ``forecast``). ``serve-bench --fleet --population`` (the scale
tier) waits for ``scale/`` (item 15) and exits non-zero.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

import numpy as np

from p2pmicrogrid_tpu_torch.data.results import host_array

AUTO_DEVICE_NOT_PORTED = (
    "--device auto (crossover placement) waits for a crossover measured on "
    "the card (ROADMAP.md, Queue 1, item 8); pass --device cuda or --device cpu"
)
FIGURES_NOT_PORTED = (
    "--figures-dir needs the analysis layer and matplotlib, which the port "
    "does not have yet (ROADMAP.md, Queue 1, item 15)"
)
POPULATION_NOT_PORTED = (
    "serve-bench --fleet --population (the scale tier) needs scale/, which "
    "the port does not have yet (ROADMAP.md, Queue 1, item 15)"
)


def _nonneg_int(value: str) -> int:
    i = int(value)
    if i < 0:
        raise argparse.ArgumentTypeError(f"must be >= 0, got {i}")
    return i


def _pow2_int(value: str) -> int:
    i = int(value)
    if i < 1 or i & (i - 1):
        raise argparse.ArgumentTypeError(f"must be a power of two, got {i}")
    return i


def _build_cfg(args) -> "ExperimentConfig":
    from p2pmicrogrid_tpu_torch.config import (
        BatteryConfig,
        DDPGConfig,
        SimConfig,
        TrainConfig,
        default_config,
    )

    return default_config(
        sim=SimConfig(
            n_agents=args.agents,
            rounds=args.rounds,
            homogeneous=args.homogeneous,
            n_scenarios=getattr(args, "scenarios", 1),
            trading=not getattr(args, "no_trading", False),
            market_dtype=getattr(args, "market_dtype", "auto"),
            market_impl=getattr(args, "market_impl", "auto"),
        ),
        battery=BatteryConfig(enabled=args.battery),
        ddpg=DDPGConfig(
            share_across_agents=getattr(args, "share_agents", False),
            # Explicit lr flags pin the lrs exactly: the pooled-batch
            # auto-scaling rule (parallel/scenarios.py:auto_scale_ddpg_lrs)
            # must not rescale a user-chosen value.
            lr_auto_scale=(
                getattr(args, "actor_lr", None) is None
                and getattr(args, "critic_lr", None) is None
            ),
            **{
                k: v
                for k, v in (
                    ("actor_lr", getattr(args, "actor_lr", None)),
                    ("critic_lr", getattr(args, "critic_lr", None)),
                )
                if v is not None
            },
            # --learn-batch-cap 0 disables the cap (full pooled update);
            # unset keeps the DDPGConfig default.
            **(
                {"learn_batch_cap": args.learn_batch_cap or None}
                if getattr(args, "learn_batch_cap", None) is not None
                else {}
            ),
        ),
        train=TrainConfig(
            max_episodes=args.episodes,
            implementation=args.implementation,
            seed=args.seed,
            episodes_per_jit_block=getattr(args, "jit_block", 1),
            # Checkpoint cadence: the preemption exposure window (a crash
            # loses at most save_episodes episodes of work).
            **(
                {"save_episodes": args.save_episodes}
                if getattr(args, "save_episodes", None) is not None
                else {}
            ),
        ),
    )


def _device(choice: str) -> str:
    """The run's device from a ``--device`` choice: ``"cuda"`` (also for
    ``default``), raising ``SystemExit`` with ``resolve_device``'s message
    when there is no card, or ``"cpu"``; ``auto`` exits non-zero."""
    if choice == "auto":
        raise SystemExit(AUTO_DEVICE_NOT_PORTED)
    if choice == "cpu":
        return "cpu"
    from p2pmicrogrid_tpu_torch.device import resolve_device

    try:
        resolve_device("cuda")
    except RuntimeError as err:
        raise SystemExit(str(err)) from None
    return "cuda"


def _generator(seed: int, device: str):
    """The run's random stream: a ``torch.Generator`` on ``device``."""
    import torch

    return torch.Generator(device=device).manual_seed(int(seed))


def _save_times(path: str, setting: str, train_time=None, run_time=None) -> None:
    """Per-setting wall-clock record (the reference's save_times,
    community.py:324-338, fixed: missing file starts an empty record instead
    of crashing)."""
    data = {}
    if os.path.exists(path):
        with open(path) as f:
            data = json.load(f)
    entry = data.setdefault(setting, {})
    if train_time is not None:
        entry["train"] = train_time
    if run_time is not None:
        entry["run"] = run_time
    with open(path, "w") as f:
        json.dump(data, f, indent=2)


def _load_traces(args):
    from p2pmicrogrid_tpu_torch.data import (
        load_reference_db,
        synthetic_traces,
        train_validation_test_split,
    )

    if args.db:
        traces = load_reference_db(args.db)
    else:
        traces = synthetic_traces(seed=args.seed)
    return train_validation_test_split(traces)


@contextlib.contextmanager
def _profile_ctx(args):
    """A ``torch.profiler`` trace of the run, written as Chrome-trace JSON
    into ``--profile-dir`` (SURVEY.md section 5: the reference only has
    wall-clock brackets, community.py:269-316)."""
    out = getattr(args, "profile_dir", None)
    if not out:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    from p2pmicrogrid_tpu_torch.telemetry.registry import run_stamp

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(out, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(out, f"trace-{run_stamp()}.json")
    prof.export_chrome_trace(path)
    print(f"profile -> {path}", file=sys.stderr)


def _strip_cli_flags(argv, flags=(), value_flags=()):
    """Remove ``--flag`` / ``--flag VALUE`` / ``--flag=VALUE`` entries from a
    raw argv (the supervisor rebuilds child command lines from its own)."""
    out = []
    i = 0
    while i < len(argv):
        a = argv[i]
        name = a.split("=", 1)[0]
        if name in flags:
            i += 1
            continue
        if name in value_flags:
            i += 2 if "=" not in a and i + 1 < len(argv) else 1
            continue
        out.append(a)
        i += 1
    return out


def _child_command() -> list:
    """How a training child of this process is launched: this package's
    command line under the same interpreter."""
    return [sys.executable, "-m", "p2pmicrogrid_tpu_torch"]


def _build_fault_injector(args):
    """The deterministic training fault injector (train/faults.py) from
    ``--fault-plan``/``--fault-seed``, scoped to this supervisor attempt
    (``P2P_TRAIN_ATTEMPT``). ``None`` when no faults were requested."""
    plan = None
    if getattr(args, "fault_plan", None):
        from p2pmicrogrid_tpu_torch.train.faults import TrainFaultPlan

        with open(args.fault_plan) as f:
            plan = TrainFaultPlan.from_json(f.read())
    elif getattr(args, "fault_seed", None) is not None:
        from p2pmicrogrid_tpu_torch.train.faults import kill_plan

        plan = kill_plan(
            args.fault_seed, args.episodes,
            n_kills=getattr(args, "fault_kills", 1),
        )
    if plan is None:
        return None
    from p2pmicrogrid_tpu_torch.train.faults import TrainFaultInjector
    from p2pmicrogrid_tpu_torch.train.resilience import ATTEMPT_ENV

    return TrainFaultInjector(
        plan, attempt=int(os.environ.get(ATTEMPT_ENV, "0"))
    )


def _emit_resilience_row(args, row: dict) -> None:
    """One resilience metric row: stdout (the supervisor's scan channel)
    plus the ``--resilience-out`` JSONL capture when set."""
    line = json.dumps(row)
    print(line, flush=True)
    out = getattr(args, "resilience_out", None)
    if out:
        d = os.path.dirname(os.path.abspath(out))
        if d:
            os.makedirs(d, exist_ok=True)
        with open(out, "a") as f:
            f.write(line + "\n")


def _train_setting(args, cfg) -> str:
    """The experiment-identity string the TRAIN command will checkpoint
    under (plain vs scenario-batched naming)."""
    if getattr(args, "scenarios", 1) > 1:
        return _scenario_setting(
            cfg, getattr(args, "shared", False), getattr(args, "chunks", 1)
        )
    return cfg.setting


def _verify_uninterrupted(args, child_args) -> bool:
    """Run the SAME training uninterrupted (no faults, fresh model dir) and
    compare final-checkpoint content digests — the bit-exactness verdict of
    a supervised chaos run (exact resume makes them identical)."""
    import subprocess

    from p2pmicrogrid_tpu_torch.train.checkpoint import (
        checkpoint_dir,
        latest_checkpoint,
        load_manifest,
    )

    base_model_dir = os.path.abspath(args.model_dir) + "_uninterrupted"
    base_args = _strip_cli_flags(
        child_args,
        flags=("--resume",),
        value_flags=(
            "--fault-plan", "--fault-seed", "--fault-kills",
            "--max-rollbacks", "--lr-drop", "--model-dir",
        ),
    ) + ["--model-dir", base_model_dir]
    rc = subprocess.run(_child_command() + base_args).returncode
    if rc != 0:
        print(f"uninterrupted verification run failed (rc {rc})",
              file=sys.stderr)
        return False
    cfg = _build_cfg(args)
    setting = _train_setting(args, cfg)
    impl = cfg.train.implementation
    steps = [
        latest_checkpoint(checkpoint_dir(d, setting, impl))
        for d in (args.model_dir, base_model_dir)
    ]
    if None in steps:
        return False
    manifests = [load_manifest(s) for s in steps]
    if any(m is None for m in manifests):
        return False
    return (
        manifests[0]["episode"] == manifests[1]["episode"]
        and manifests[0]["digest"] == manifests[1]["digest"]
    )


def _cmd_train_supervise(args) -> int:
    """``train --supervise``: crash-supervise a training child, emitting the
    RESILIENCE capture (attempt rows + ``train_supervised`` headline)."""
    from p2pmicrogrid_tpu_torch.train.resilience import supervise

    raw = list(getattr(args, "_argv", None) or sys.argv[1:])
    child_args = _strip_cli_flags(
        raw,
        flags=("--supervise", "--verify-uninterrupted"),
        value_flags=("--resilience-out", "--max-restarts"),
    )
    child_argv = _child_command() + child_args
    result = supervise(
        child_argv,
        max_restarts=getattr(args, "max_restarts", 8),
        emit=lambda row: _emit_resilience_row(args, row),
    )
    if result.succeeded:
        final_episode = args.episodes - 1
    else:
        # The run never completed: report the newest VERIFIED checkpoint's
        # episode (how far training provably got), or -1 with none on disk.
        final_episode = -1
        try:
            from p2pmicrogrid_tpu_torch.train.checkpoint import (
                checkpoint_dir,
                latest_checkpoint,
                load_manifest,
            )

            cfg = _build_cfg(args)
            step = latest_checkpoint(checkpoint_dir(
                args.model_dir, _train_setting(args, cfg),
                cfg.train.implementation,
            ))
            manifest = load_manifest(step) if step else None
            if manifest is not None:
                final_episode = int(manifest["episode"])
        except Exception:  # noqa: BLE001 — headline must emit regardless
            pass
    headline = {
        "metric": "train_supervised",
        "value": len(result.attempts),
        "unit": "attempts",
        "vs_baseline": 0.0,
        "kills": result.kills,
        "resumes": result.resumes,
        "rollbacks": result.rollbacks,
        "final_episode": final_episode,
        "exit_code": result.exit_code,
    }
    ok = result.succeeded
    if ok and getattr(args, "verify_uninterrupted", False):
        bit_exact = _verify_uninterrupted(args, child_args)
        headline["bit_exact"] = bool(bit_exact)
        ok = ok and bit_exact
    _emit_resilience_row(args, headline)
    return 0 if ok else 1


def cmd_train(args) -> int:
    # Without a card and without --device cpu, exit before anything runs
    # (the supervisor too: its children would only fail the same way).
    dev = _device(args.device)
    if getattr(args, "supervise", False):
        # Crash supervisor: relaunch the training child on crash with capped
        # backoff (train/resilience.py) — before any heavy setup, this
        # process only spawns children.
        return _cmd_train_supervise(args)
    if getattr(args, "share_agents", False):
        # DDPGConfig.share_across_agents only reaches the shared-scenario
        # trainer's ddpg_params_init; in any other mode the flag would be
        # silently ignored (per-agent training) — refuse instead.
        problems = []
        if args.implementation != "ddpg":
            problems.append("--implementation ddpg")
        if getattr(args, "scenarios", 1) <= 1:
            problems.append("--scenarios N (N > 1)")
        if not getattr(args, "shared", False):
            problems.append("--shared")
        if problems:
            raise SystemExit(
                "--share-agents (one community-shared actor-critic) only "
                "applies to shared-scenario DDPG training; also pass: "
                + ", ".join(problems)
            )
    if getattr(args, "chunks", 1) > 1 and not (
        getattr(args, "shared", False) and getattr(args, "scenarios", 1) > 1
    ):
        raise SystemExit(
            "--chunks K (aggregate-scenario chunked training) requires "
            "--scenarios N --shared: each chunk of N scenarios reuses one "
            "captured shared-learner program"
        )
    if getattr(args, "scenarios", 1) > 1:
        return _cmd_train_scenarios(args, dev)

    from p2pmicrogrid_tpu_torch.data import ResultsStore
    from p2pmicrogrid_tpu_torch.envs import make_ratings
    from p2pmicrogrid_tpu_torch.train import (
        init_policy_state,
        make_policy,
        train_community,
    )
    from p2pmicrogrid_tpu_torch.train.checkpoint import (
        checkpoint_dir,
        save_checkpoint,
    )

    cfg = _build_cfg(args)
    train_traces, _, _ = _load_traces(args)
    rng = np.random.default_rng(cfg.train.seed)
    ratings = make_ratings(cfg, rng)
    key = _generator(cfg.train.seed, dev)
    policy = make_policy(cfg)
    pol_state = init_policy_state(cfg, dev, key)

    store = ResultsStore(args.results_db) if args.results_db else None
    ckpt_dir = checkpoint_dir(args.model_dir, cfg.setting, cfg.train.implementation)

    from p2pmicrogrid_tpu_torch.train.resilience import (
        checkpoint_callback,
        prepare_resume,
    )

    warmup = True
    if args.resume:
        # Resume semantics of the reference's load_agents=True +
        # starting_episodes (community.py:254-256, setup.py:29): restore the
        # learner and continue the episode/decay schedule where it stopped.
        # A checkpoint that carries its generator state resumes EXACTLY —
        # the surviving episodes replay bit-identically to an uninterrupted
        # run (train/resilience.py); one without continues on a branch of
        # the generator. Integrity (digest) verification happens in the
        # restore itself, corrupt steps falling back to the newest verified
        # one — the "nothing to do" path below therefore only reports
        # success over a VERIFIED final checkpoint.
        plan = prepare_resume(cfg, ckpt_dir, pol_state, key)
        if not plan.resumed:
            print(f"resume: no restorable checkpoint under {ckpt_dir}; "
                  "starting fresh")
        else:
            pol_state, cfg, key, warmup = (
                plan.pol_state, plan.cfg, plan.key, plan.warmup
            )
            mode = "exact RNG state" if plan.exact else "legacy (re-keyed)"
            print(f"resumed {ckpt_dir} at episode {plan.episode} "
                  f"(integrity verified, {mode})")
            if cfg.train.starting_episodes >= cfg.train.max_episodes:
                print("nothing to do: checkpoint is at or past --episodes "
                      "(final checkpoint integrity verified)")
                return 0

    fault_injector = _build_fault_injector(args)

    def progress(ep, r, e):
        if store:
            store.log_training_progress(cfg.setting, cfg.train.implementation, ep, r, e)

    # Resumable checkpoints: the 3-arg callback receives the generator's
    # state after the block from the loop and persists it with the state +
    # config hash, then runs the fault injector's post-save hooks.
    checkpoint = checkpoint_callback(
        ckpt_dir, cfg, injector=fault_injector,
        keep_last=getattr(args, "keep_checkpoints", 2),
    )

    print(f"setting: {cfg.setting} ({cfg.train.implementation})")
    pipeline = getattr(args, "pipeline", True)
    from p2pmicrogrid_tpu_torch.telemetry import SqliteSink, Telemetry

    # With a results DB, the run's telemetry ALSO streams into its SQLite
    # warehouse tables (keyed by config_hash) — the join target for the eval
    # rows the same DB collects (`telemetry-query`).
    extra_sinks = [SqliteSink(args.results_db)] if args.results_db else []
    tel = Telemetry.maybe_create("train", cfg=cfg, extra_sinks=extra_sinks)
    if tel is not None:
        print(f"telemetry run: {tel.run_dir}")
    rollback_records = []
    try:
        with _profile_ctx(args):
            if getattr(args, "max_rollbacks", 0) > 0:
                # Divergence rollback (train/resilience.py): watch the
                # device counters' nonfinite counts, restore the last
                # verified checkpoint on trip, retrain under a deterministic
                # perturbation (LR drop + a branch of the generator).
                from p2pmicrogrid_tpu_torch.train.resilience import (
                    GuardPolicy,
                    train_community_with_rollback,
                )

                def on_rollback(rec):
                    row = {
                        "metric": "train_rollback",
                        "value": rec.index,
                        "unit": "rollback",
                        "vs_baseline": 0.0,
                        "tripped_episode": rec.tripped_episode,
                        "restored_episode": rec.restored_episode,
                        "lr_scale": rec.lr_scale,
                        "reason": rec.reason,
                    }
                    _emit_resilience_row(args, row)

                result, rollback_records = train_community_with_rollback(
                    cfg, pol_state, train_traces, ratings, key, ckpt_dir,
                    guard_policy=GuardPolicy(
                        max_rollbacks=args.max_rollbacks,
                        lr_drop=getattr(args, "lr_drop", 0.5),
                    ),
                    telemetry=tel, fault_injector=fault_injector,
                    on_rollback=on_rollback, warmup=warmup,
                    keep_last=getattr(args, "keep_checkpoints", 2),
                    progress_cb=progress, verbose=True, pipeline=pipeline,
                    device=dev,
                )
            else:
                result = train_community(
                    cfg, policy, pol_state, train_traces, ratings, key,
                    progress_cb=progress, checkpoint_cb=checkpoint,
                    verbose=True, telemetry=tel, pipeline=pipeline,
                    warmup=warmup,
                    fault_hook=(
                        fault_injector.on_block_start
                        if fault_injector is not None else None
                    ),
                    device=dev,
                )
    finally:
        # Close even on a crashed run: the partial record is the evidence.
        if tel is not None:
            tel.close()
    if rollback_records:
        _emit_resilience_row(args, {
            "metric": "train_rollback_total",
            "value": len(rollback_records),
            "unit": "rollbacks",
            "vs_baseline": 0.0,
            "converged": True,
            "final_episode": cfg.train.max_episodes - 1,
        })
    save_checkpoint(
        ckpt_dir, result.pol_state, cfg.train.max_episodes - 1,
        rng_key=result.rng_state, cfg=cfg,
        keep_last=getattr(args, "keep_checkpoints", 2),
    )
    if args.timing_json:
        _save_times(args.timing_json, cfg.setting, train_time=result.train_seconds)
    n_run = cfg.train.max_episodes - cfg.train.starting_episodes
    print(
        f"trained {n_run} episodes in {result.train_seconds:.1f}s "
        f"({result.env_steps_per_sec:.0f} env-steps/s); checkpoint: {ckpt_dir}"
    )
    return 0


def _scenario_setting(cfg, shared: bool, chunks: int = 1) -> str:
    """Experiment identity for scenario-batched runs: the community setting
    plus the Monte-Carlo axis, e.g. ``2-multi-agent-com-rounds-1-hetero-x256-shared``
    (chunked aggregate runs append ``-k{chunks}``). Single source for both
    the train path and eval's checkpoint lookup."""
    mode = "shared" if shared else "indep"
    setting = f"{cfg.setting}-x{cfg.sim.n_scenarios}-{mode}"
    return f"{setting}-k{chunks}" if chunks > 1 else setting


def _windowed_episode_cb(cfg, setting, store, ckpt_dir, carry_is_tuple,
                         extra_fn=None, injector=None, keep_last=2):
    """Per-episode callback shared by the scenario and multi-community
    trainers: min_episodes_criterion-window averages into training_progress
    (same semantics as train_community's records, so analyse treats all
    settings alike) plus periodic checkpointing on the save_episodes cadence.

    ``extra_fn()`` (JSON dict — e.g. the HealthMonitor record) rides into
    each step's integrity manifest for exact resume; ``injector`` (a
    ``train.faults.TrainFaultInjector``) gets the crash-harness hooks:
    kill/poison-free episode boundary + post-save corruption + callback
    stalls (scenario paths support the kill/corrupt/stall kinds — carry
    poisoning needs the single-community loop's fault_hook)."""
    import collections
    import statistics

    from p2pmicrogrid_tpu_torch.train.checkpoint import save_checkpoint

    window_r = collections.deque(maxlen=cfg.train.min_episodes_criterion)
    window_l = collections.deque(maxlen=cfg.train.min_episodes_criterion)

    def episode_cb(ep, r, l, carry):
        if injector is not None:
            injector.on_block_start(ep)
        window_r.append(float(np.mean(r)))
        window_l.append(float(np.mean(l)))
        if ep % cfg.train.min_episodes_criterion == 0:
            avg_r, avg_l = statistics.mean(window_r), statistics.mean(window_l)
            if store:
                store.log_training_progress(
                    setting, cfg.train.implementation, ep, avg_r, avg_l
                )
            print(f"episode {ep}: avg reward {avg_r:.3f}, avg error {avg_l:.3f}")
        if (ep + 1) % cfg.train.save_episodes == 0:
            ps = carry[0] if carry_is_tuple else carry
            step = save_checkpoint(
                ckpt_dir, ps, ep, cfg=cfg,
                extra=extra_fn() if extra_fn else None,
                keep_last=keep_last,
            )
            if injector is not None:
                injector.on_checkpoint_saved(ep, step)
                injector.on_callback(ep)

    return episode_cb


def _cmd_train_scenarios(args, dev: str) -> int:
    """--scenarios N > 1: Monte-Carlo scenario-batched training — the
    card's scaling axis (BASELINE configs 3/4). ``--shared`` trains ONE
    set of policy parameters with per-slot scenario-averaged updates;
    otherwise S independent learners train side by side."""
    from p2pmicrogrid_tpu_torch.data import ResultsStore
    from p2pmicrogrid_tpu_torch.envs import make_ratings
    from p2pmicrogrid_tpu_torch.parallel import (
        init_independent_state,
        init_shared_state,
        make_scenario_traces,
        stack_scenario_arrays,
        train_scenarios_independent,
        train_scenarios_shared,
    )
    from p2pmicrogrid_tpu_torch.train import make_policy
    from p2pmicrogrid_tpu_torch.train.checkpoint import (
        checkpoint_dir,
        save_checkpoint,
    )
    from p2pmicrogrid_tpu_torch.train.resilience import branch_generator

    cfg = _build_cfg(args)
    S = cfg.sim.n_scenarios
    chunks = getattr(args, "chunks", 1)
    chunk_parallel = getattr(args, "chunk_parallel", 1)
    if chunk_parallel > 1 and chunks <= 1:
        # Width only applies to the chunked runner; silently ignoring it
        # would hand the user sequential behavior they didn't ask for.
        raise SystemExit(
            f"--chunk-parallel {chunk_parallel} requires --chunks > 1 "
            "(the width runs chunks of the chunked runner side by side)"
        )
    basin_mitigate = getattr(args, "basin_mitigate", "auto")
    if basin_mitigate == "auto":
        # Default: mitigate where the program switch exists (lr-boost for
        # chunked DDPG, the JAX package's measured default), warn elsewhere.
        basin_mitigate = (
            "lr-boost"
            if cfg.train.implementation == "ddpg" and chunks > 1
            else "warn"
        )
    elif basin_mitigate != "warn":
        # Reject the configurations where the mitigation would crash
        # mid-build (lr-boost scales DDPG lrs only) or silently degrade to
        # 'warn' (the non-chunked path has no program switch to apply).
        if cfg.train.implementation != "ddpg":
            raise SystemExit(
                f"--basin-mitigate {basin_mitigate} requires "
                f"--implementation ddpg (got {cfg.train.implementation}); "
                "the mitigation switches to an lr-boosted DDPG program"
            )
        if chunks <= 1:
            raise SystemExit(
                f"--basin-mitigate {basin_mitigate} requires --chunks > 1 "
                "(mitigation swaps the chunked episode program; the "
                "non-chunked path only supports 'warn')"
            )
    setting = _scenario_setting(cfg, args.shared, chunks)
    rng = np.random.default_rng(cfg.train.seed)
    ratings = make_ratings(cfg, rng)
    key = _generator(cfg.train.seed, dev)
    policy = make_policy(cfg)

    if chunks > 1:
        # Chunked aggregate-scenario mode makes each chunk's traces on the
        # device (parallel/device_gen.py); no host arrays to build.
        arrays = None
    else:
        traces = make_scenario_traces(cfg, seed=cfg.train.seed)
        arrays = stack_scenario_arrays(cfg, traces, ratings, dev)

    if args.shared and chunks > 1:
        # Chunked training seeds fresh per-chunk replay/OU itself; a
        # full-size scen_state here would just pin unused device memory at
        # exactly the north-star scale.
        from p2pmicrogrid_tpu_torch.parallel import init_shared_pol_state

        pol_state = init_shared_pol_state(cfg, dev, key)
        scen_state = None
    elif args.shared:
        pol_state, scen_state = init_shared_state(cfg, dev, key)
    else:
        pol_state = init_independent_state(cfg, S, dev, key)
        scen_state = None

    store = ResultsStore(args.results_db) if args.results_db else None
    ckpt_dir = checkpoint_dir(args.model_dir, setting, cfg.train.implementation)
    episode0 = 0
    resumed_health = None
    if args.resume:
        # Learnable state only: per-scenario replay/OU is transient warm-up
        # state and is rebuilt fresh (the reference's DQN does the same via
        # init_buffers after load, community.py:265-267). The restore
        # digest-verifies each step and falls back past corrupt ones; the
        # manifest's extra record carries the HealthMonitor basin state.
        from p2pmicrogrid_tpu_torch.train.checkpoint import restore_resume_state

        try:
            st = restore_resume_state(ckpt_dir, pol_state)
        except FileNotFoundError:
            st = None
            print(f"resume: no restorable checkpoint under {ckpt_dir}; "
                  "starting fresh")
        if st is not None:
            pol_state, episode = st.pol_state, st.episode
            resumed_health = (st.extra or {}).get("health")
            episode0 = episode + 1
            print(f"resumed {ckpt_dir} at episode {episode} "
                  "(integrity verified)")
            if episode0 >= cfg.train.max_episodes:
                print("nothing to do: checkpoint is at or past --episodes "
                      "(final checkpoint integrity verified)")
                return 0
            # Advance the stream past the trained episodes so the resumed
            # run does not replay the original run's random stream. Chunked
            # mode already keys every chunk by the ABSOLUTE episode index
            # (chunk_seed_schedule) — resuming with the same seed IS the
            # exact schedule there.
            if chunks <= 1:
                key = branch_generator(key, episode0)

    fault_injector = _build_fault_injector(args)
    episode_cb = _windowed_episode_cb(
        cfg, setting, store, ckpt_dir,
        carry_is_tuple=args.shared and chunks <= 1,
        extra_fn=lambda: (
            {"health": monitor.to_dict()} if monitor is not None else {}
        ),
        injector=fault_injector,
        keep_last=getattr(args, "keep_checkpoints", 2),
    )
    n_episodes = cfg.train.max_episodes - episode0
    agg = f", {chunks} chunks = {S * chunks} aggregate" if chunks > 1 else ""
    print(f"setting: {setting} ({cfg.train.implementation}, S={S}{agg})")
    if args.shared and chunks <= 1 and cfg.train.implementation == "dqn":
        # Replay warmup before gradient steps (the reference's init_buffers,
        # community.py:125-147 — it runs after load_agents too, :265-267).
        # Chunked mode re-seeds per-chunk state instead (scenarios.py).
        from p2pmicrogrid_tpu_torch.parallel import warmup_shared_dqn

        pol_state, scen_state = warmup_shared_dqn(
            cfg, policy, pol_state, scen_state, arrays, ratings, key
        )
    health_every = getattr(args, "health_every", 10) if args.shared else 0
    health_cb = None
    monitor = None
    if health_every > 0:
        from p2pmicrogrid_tpu_torch.train.health import HealthMonitor

        if resumed_health:
            # Exact resume of the basin bookkeeping + untrained-cost
            # calibration (saved into the checkpoint manifest's extra).
            monitor = HealthMonitor.from_dict(resumed_health)
            if monitor.in_basin:
                print("resumed INSIDE the don't-heat basin (entry episodes "
                      f"{monitor.basin_entries}); mitigation state restored")
        else:
            monitor = HealthMonitor(cfg.sim.slots_per_day)

        def health_cb(point):
            print(
                f"health episode {point.episode}: greedy cost "
                f"{point.greedy_cost_eur:.1f} EUR, greedy reward "
                f"{point.greedy_reward:.1f} [{point.status}]"
            )
            if store:
                store.log_training_health(
                    setting, cfg.train.implementation, point.episode,
                    point.greedy_cost_eur, point.greedy_reward, point.status,
                )

    pipeline = getattr(args, "pipeline", True)
    # The async trainers lag callback consumption by one episode; episodes
    # whose callback READS the carry (checkpoint saves, in-loop health
    # evals) must drain synchronously so the state they see is
    # episode-exact (parallel/scenarios.py:train_scenarios_chunked).
    save_every = cfg.train.save_episodes

    def carry_sync(ep, _save=save_every, _health=health_every):
        if (ep + 1) % _save == 0:
            return True
        return _health > 0 and chunks <= 1 and ep % _health == 0

    max_rollbacks = getattr(args, "max_rollbacks", 0)
    if max_rollbacks > 0 and (chunks <= 1 or health_every <= 0):
        raise SystemExit(
            "--max-rollbacks on the scenario path requires --chunks > 1 "
            "and --health-every > 0: the divergence guard observes the "
            "chunked block-boundary evals (the single-community `train` "
            "path supports rollback without chunks)"
        )
    with _profile_ctx(args):
        if chunks > 1 and max_rollbacks > 0:
            # Chunked divergence rollback (train/resilience.py): watch the
            # block-boundary eval counters/verdicts, restore the newest
            # verified checkpoint on trip, retrain under a deterministic
            # perturbation (LR drop + re-seeded chunk stream).
            from p2pmicrogrid_tpu_torch.telemetry import SqliteSink, Telemetry
            from p2pmicrogrid_tpu_torch.train.resilience import (
                GuardPolicy,
                train_chunked_with_rollback,
            )

            extra_sinks = (
                [SqliteSink(args.results_db)] if args.results_db else ()
            )
            tel = Telemetry.maybe_create(
                "train-chunked-rollback", cfg=cfg, extra_sinks=extra_sinks
            )

            def on_rollback(rec):
                _emit_resilience_row(args, {
                    "metric": "train_rollback",
                    "value": rec.index,
                    "unit": "rollback",
                    "vs_baseline": 0.0,
                    "tripped_episode": rec.tripped_episode,
                    "restored_episode": rec.restored_episode,
                    "lr_scale": rec.lr_scale,
                    "reason": rec.reason,
                })

            try:
                result, rollback_records = train_chunked_with_rollback(
                    cfg, pol_state, ratings, cfg.train.seed, ckpt_dir,
                    n_episodes=n_episodes,
                    n_chunks=chunks,
                    eval_every=health_every,
                    episode0=episode0,
                    guard_policy=GuardPolicy(
                        max_rollbacks=max_rollbacks,
                        lr_drop=getattr(args, "lr_drop", 0.5),
                    ),
                    telemetry=tel,
                    on_rollback=on_rollback,
                    episode_cb=episode_cb,
                    carry_sync=carry_sync,
                    health_cb=health_cb,
                    monitor=monitor,
                    pipeline=pipeline,
                    chunk_parallel=chunk_parallel,
                    mitigate=basin_mitigate,
                    device=dev,
                )
            finally:
                if tel is not None:
                    tel.close()
            pol_state, rewards, _, seconds, monitor = result
            if rollback_records:
                _emit_resilience_row(args, {
                    "metric": "train_rollback_total",
                    "value": len(rollback_records),
                    "unit": "rollbacks",
                    "vs_baseline": 0.0,
                    "converged": True,
                    "final_episode": cfg.train.max_episodes - 1,
                })
        elif chunks > 1 and health_every > 0:
            from p2pmicrogrid_tpu_torch.train.health import train_chunked_with_health

            pol_state, rewards, _, seconds, monitor = train_chunked_with_health(
                cfg, policy, pol_state, ratings, cfg.train.seed, n_episodes,
                n_chunks=chunks, eval_every=health_every, episode0=episode0,
                episode_cb=episode_cb, chunk_parallel=chunk_parallel,
                mitigate=basin_mitigate,
                health_cb=health_cb, monitor=monitor,
                pipeline=pipeline, carry_sync=carry_sync,
                results_db=args.results_db, device=dev,
            )
        elif chunks > 1:
            from p2pmicrogrid_tpu_torch.parallel import train_scenarios_chunked

            pol_state, rewards, _, seconds = train_scenarios_chunked(
                cfg, policy, pol_state, ratings, cfg.train.seed, n_episodes,
                n_chunks=chunks, episode0=episode0, episode_cb=episode_cb,
                chunk_parallel=chunk_parallel,
                pipeline=pipeline, carry_sync=carry_sync, device=dev,
            )
        elif args.shared:
            if health_every > 0:
                # Non-chunked shared mode: evaluate from the episode callback
                # (the carry's pol_state is the shared bundle).
                from p2pmicrogrid_tpu_torch.train.health import (
                    make_greedy_eval,
                    untrained_reference_cost,
                )

                greedy_eval = make_greedy_eval(cfg, policy, ratings, device=dev)
                # Classifier thresholds are fractions of the UNTRAINED
                # greedy cost; on resume the restored policy can't supply it.
                monitor.initial_cost = untrained_reference_cost(
                    cfg, policy, greedy_eval, seed=cfg.train.seed
                )
                inner_cb = episode_cb

                def episode_cb(ep, r, l, carry):
                    if inner_cb:
                        inner_cb(ep, r, l, carry)
                    if ep % health_every == 0:
                        c, rw = greedy_eval(carry[0])[:2]
                        monitor.update(ep, float(c), float(rw))
                        health_cb(monitor.points[-1])

            pol_state, _, rewards, _, seconds = train_scenarios_shared(
                cfg, policy, pol_state, arrays, ratings, key, n_episodes,
                replay_s=scen_state, episode0=episode0, episode_cb=episode_cb,
            )
        else:
            pol_state, rewards, _, seconds = train_scenarios_independent(
                cfg, policy, pol_state, arrays, ratings, key, n_episodes,
                episode0=episode0, episode_cb=episode_cb,
            )
    if monitor is not None and monitor.basin_entries:
        print(
            f"health summary: basin entered at episodes "
            f"{monitor.basin_entries}, exits at {monitor.basin_exits or '—'} "
            f"(see training_health table / README basin notes)"
        )
    save_checkpoint(
        ckpt_dir, pol_state, cfg.train.max_episodes - 1, cfg=cfg,
        extra={"health": monitor.to_dict()} if monitor is not None else None,
        keep_last=getattr(args, "keep_checkpoints", 2),
    )
    if args.timing_json:
        _save_times(args.timing_json, setting, train_time=seconds)
    steps = n_episodes * cfg.sim.slots_per_day * S * max(chunks, 1)
    print(
        f"trained {n_episodes} episodes x {S * max(chunks, 1)} scenarios in "
        f"{seconds:.1f}s ({steps / seconds:.0f} env-steps/s); "
        f"checkpoint: {ckpt_dir}"
    )
    return 0


def _multi_setting(cfg, C: int) -> str:
    return f"multi-{C}x{cfg.sim.n_agents}-rounds-{cfg.sim.rounds}"


def cmd_multi(args) -> int:
    """Multi-community training with inter-community trading (BASELINE
    config 5): C communities ride the leading batch axis, residuals trade at
    the P2P midpoint price (envs/multi_community.py)."""
    import dataclasses

    from p2pmicrogrid_tpu_torch.data import ResultsStore
    from p2pmicrogrid_tpu_torch.envs import make_ratings
    from p2pmicrogrid_tpu_torch.envs.multi_community import train_multi_community
    from p2pmicrogrid_tpu_torch.parallel import (
        init_shared_state,
        make_scenario_traces,
        stack_scenario_arrays,
    )
    from p2pmicrogrid_tpu_torch.train import make_policy
    from p2pmicrogrid_tpu_torch.train.checkpoint import (
        checkpoint_dir,
        restore_checkpoint,
        save_checkpoint,
    )
    from p2pmicrogrid_tpu_torch.train.resilience import branch_generator

    dev = _device(args.device)
    cfg = _build_cfg(args)
    C = args.communities
    cfg = cfg.replace(sim=dataclasses.replace(cfg.sim, n_scenarios=C))
    setting = _multi_setting(cfg, C)
    rng = np.random.default_rng(cfg.train.seed)
    ratings = make_ratings(cfg, rng)
    key = _generator(cfg.train.seed, dev)
    policy = make_policy(cfg)

    traces = make_scenario_traces(cfg, n_scenarios=C, seed=cfg.train.seed)
    arrays = stack_scenario_arrays(cfg, traces, ratings, dev)
    pol_state, scen_state = init_shared_state(cfg, dev, key)

    store = ResultsStore(args.results_db) if args.results_db else None
    ckpt_dir = checkpoint_dir(args.model_dir, setting, cfg.train.implementation)
    episode0 = 0
    if args.resume:
        pol_state, episode = restore_checkpoint(ckpt_dir, pol_state)
        episode0 = episode + 1
        print(f"resumed {ckpt_dir} at episode {episode}")
        if episode0 >= cfg.train.max_episodes:
            print("nothing to do: checkpoint is at or past --episodes")
            return 0
        key = branch_generator(key, episode0)

    episode_cb = _windowed_episode_cb(
        cfg, setting, store, ckpt_dir, carry_is_tuple=True
    )
    n_episodes = cfg.train.max_episodes - episode0
    print(f"setting: {setting} ({cfg.train.implementation})")
    pol_state, _, rewards, _, seconds = train_multi_community(
        cfg, policy, pol_state, arrays, ratings, key,
        n_episodes=n_episodes, replay_s=scen_state,
        episode0=episode0, episode_cb=episode_cb,
    )
    save_checkpoint(ckpt_dir, pol_state, cfg.train.max_episodes - 1)
    if args.timing_json:
        _save_times(args.timing_json, setting, train_time=seconds)
    per_c = np.asarray(rewards)[-1]
    print(f"final per-community episode rewards: {np.round(per_c, 1).tolist()}")
    steps = n_episodes * int(arrays.time.shape[1]) * C
    print(
        f"trained {n_episodes} episodes x {C} communities in "
        f"{seconds:.1f}s ({steps / seconds:.0f} env-steps/s); checkpoint: {ckpt_dir}"
    )
    return 0


def _cmd_eval_multi(args, dev: str) -> int:
    """Greedy per-day evaluation of a ``multi``-trained checkpoint
    (inter-community trading, BASELINE config 5): restores the shared
    learner, runs every (day, community) episode as one batch, and persists
    per-community rows under ``{setting}-c{c}`` so the analysis layer sees
    each community as its own setting (the reference's load_and_run applies
    to every trained setting, community.py:364-412)."""
    import dataclasses

    from p2pmicrogrid_tpu_torch.data import ResultsStore, save_eval_outputs
    from p2pmicrogrid_tpu_torch.envs import EpisodeArrays, SlotOutputs, make_ratings
    from p2pmicrogrid_tpu_torch.envs.multi_community import evaluate_multi_community
    from p2pmicrogrid_tpu_torch.train import init_policy_state, make_policy
    from p2pmicrogrid_tpu_torch.train.checkpoint import checkpoint_dir, restore_checkpoint

    cfg = _build_cfg(args)
    C = args.communities
    cfg = cfg.replace(sim=dataclasses.replace(cfg.sim, n_scenarios=C))
    setting = _multi_setting(cfg, C)
    impl = cfg.train.implementation

    _, val_traces, test_traces = _load_traces(args)
    traces = test_traces if args.test else val_traces
    rng = np.random.default_rng(cfg.train.seed)
    ratings = make_ratings(cfg, rng)
    key = _generator(cfg.train.seed, dev)
    policy = make_policy(cfg)

    # The multi checkpoint holds the SHARED learner (init_shared_state's
    # pol_state): plain Tabular/DQN state, or a bare DDPGParams bundle.
    if impl == "ddpg":
        from p2pmicrogrid_tpu_torch.models.ddpg import ddpg_params_init

        template = ddpg_params_init(cfg.ddpg, cfg.sim.n_agents, key, device=dev)
    else:
        template = init_policy_state(cfg, dev, key)
    ckpt_dir = checkpoint_dir(args.model_dir, setting, impl)
    pol_state, episode = restore_checkpoint(ckpt_dir, template)
    print(f"restored {ckpt_dir} at episode {episode}")

    days, outputs, day_arrays = evaluate_multi_community(
        cfg, policy, pol_state, traces, ratings, key, rng=rng, device=dev
    )
    costs = host_array(outputs.cost).sum(axis=(1, 3))  # [D, C]
    for i, d in enumerate(days.tolist()):
        per_c = ", ".join(f"c{c}: {v:+.3f}" for c, v in enumerate(costs[i]))
        print(f"day {d}: community costs {per_c} €")

    if args.results_db:
        from p2pmicrogrid_tpu_torch.telemetry import config_hash, git_rev

        store = ResultsStore(args.results_db)
        rev = git_rev()
        for c in range(C):
            out_c = SlotOutputs(*(x[:, :, c] for x in outputs))
            arrays_c = EpisodeArrays(*(x[:, c] for x in day_arrays))
            save_eval_outputs(
                store, f"{setting}-c{c}", impl, args.test, days, out_c,
                arrays_c, config_hash=config_hash(cfg), git_rev=rev,
            )
        print(f"results ({C} communities) -> {args.results_db}")
    return 0


def _agent_rows(template_net, net, rows):
    """``template_net`` with ``net``'s per-agent parameter rows ``rows``
    copied in (a learner stack's slice as a stack of its own)."""
    import torch

    with torch.no_grad():
        for dst, src in zip(template_net.parameters(), net.parameters()):
            dst.copy_(src[rows])
    return template_net


def _restore_eval_state(args, cfg, key, dev: str):
    """Locate and restore the checkpoint the requested training mode produced.

    Plain runs restore the single-community learner state. ``--scenarios N``
    runs live under the scenario setting suffix: shared-mode checkpoints hold
    one learner (tabular/dqn states match the plain template; DDPG stores a
    bare ``DDPGParams`` bundle, which the greedy act takes as it is, shared
    across agents or per agent); independent-mode checkpoints hold S
    learners, scenario-major, of which ``--scenario-index`` selects one for
    evaluation.
    """
    from p2pmicrogrid_tpu_torch.train import init_policy_state
    from p2pmicrogrid_tpu_torch.train.checkpoint import checkpoint_dir, restore_checkpoint

    impl = cfg.train.implementation
    S = getattr(args, "scenarios", 1)
    if S <= 1:
        ckpt_dir = checkpoint_dir(args.model_dir, cfg.setting, impl)
        pol_state, episode = restore_checkpoint(
            ckpt_dir, init_policy_state(cfg, dev, key)
        )
        return pol_state, episode, ckpt_dir

    setting = _scenario_setting(cfg, args.shared, getattr(args, "chunks", 1))
    ckpt_dir = checkpoint_dir(args.model_dir, setting, impl)
    if args.shared:
        if impl == "ddpg":
            from p2pmicrogrid_tpu_torch.models.ddpg import ddpg_params_init

            params, episode = restore_checkpoint(
                ckpt_dir, ddpg_params_init(cfg.ddpg, cfg.sim.n_agents, key, device=dev)
            )
            return params, episode, ckpt_dir
        pol_state, episode = restore_checkpoint(
            ckpt_dir, init_policy_state(cfg, dev, key)
        )
        return pol_state, episode, ckpt_dir

    from p2pmicrogrid_tpu_torch.parallel import init_independent_state, scenario_learners

    stacked, episode = restore_checkpoint(
        ckpt_dir, init_independent_state(cfg, S, dev, key)
    )
    idx = args.scenario_index
    A = cfg.sim.n_agents
    if impl == "ddpg":
        rows = slice(idx * A, (idx + 1) * A)
        one = init_policy_state(cfg, dev, key)
        pol_state = one._replace(
            actor=_agent_rows(one.actor, stacked.actor, rows),
            critic=_agent_rows(one.critic, stacked.critic, rows),
        )
        return pol_state, episode, ckpt_dir
    return scenario_learners(stacked, idx, A), episode, ckpt_dir


def cmd_eval(args) -> int:
    if args.figures_dir:
        raise SystemExit(FIGURES_NOT_PORTED)
    dev = _device(args.device)
    if getattr(args, "communities", 0) > 1:
        return _cmd_eval_multi(args, dev)

    from p2pmicrogrid_tpu_torch.data import ResultsStore, save_eval_outputs
    from p2pmicrogrid_tpu_torch.envs import make_ratings
    from p2pmicrogrid_tpu_torch.train import evaluate_community, make_policy

    cfg = _build_cfg(args)
    _, val_traces, test_traces = _load_traces(args)
    traces = test_traces if args.test else val_traces
    rng = np.random.default_rng(cfg.train.seed)
    ratings = make_ratings(cfg, rng)
    key = _generator(cfg.train.seed, dev)
    policy = make_policy(cfg)

    pol_state, episode, ckpt_dir = _restore_eval_state(args, cfg, key, dev)
    print(f"restored {ckpt_dir} at episode {episode}")

    import time as _time

    t0 = _time.time()
    days, outputs, day_arrays = evaluate_community(
        cfg, policy, pol_state, traces, ratings, key, rng=rng,
        arrays_transform=(lambda a: _maybe_pv_drop(args, a)) if args.pv_drop else None,
        device=dev,
    )
    costs = host_array(outputs.cost).sum(axis=(1, 2))
    if args.timing_json:
        _save_times(args.timing_json, _persist_setting(args, cfg), run_time=_time.time() - t0)
    for d, c in zip(days.tolist(), costs.tolist()):
        print(f"day {d}: community cost {c:+.3f} €")

    if args.results_db:
        from p2pmicrogrid_tpu_torch.telemetry import config_hash, git_rev

        store = ResultsStore(args.results_db)
        save_eval_outputs(
            store,
            _persist_setting(args, cfg),
            cfg.train.implementation,
            args.test,
            days,
            outputs,
            day_arrays,
            # Registers the eval in eval_runs under the config identity —
            # the anchor `telemetry-query` joins telemetry runs against.
            config_hash=config_hash(cfg),
            git_rev=git_rev(),
        )
        print(f"results -> {args.results_db}")
    return 0


def cmd_baseline(args) -> int:
    from p2pmicrogrid_tpu_torch.data import ResultsStore
    from p2pmicrogrid_tpu_torch.envs import (
        build_episode_arrays,
        init_physical,
        make_ratings,
        rule_baseline_episode,
        semi_intelligent_baseline_episode,
    )

    dev = _device(args.device)
    cfg = _build_cfg(args)
    _, val_traces, test_traces = _load_traces(args)
    traces = test_traces if args.test else val_traces
    rng = np.random.default_rng(cfg.train.seed)
    ratings = make_ratings(cfg, rng)
    episode_fn = (
        semi_intelligent_baseline_episode
        if args.kind == "semi-intelligent"
        else rule_baseline_episode
    )

    store = ResultsStore(args.results_db) if args.results_db else None
    for day, day_traces in sorted(traces.split_by_day().items()):
        arrays = build_episode_arrays(cfg, day_traces, ratings, dev)
        arrays = _maybe_pv_drop(args, arrays)
        phys = _initial_physical(cfg, dev)
        _, out = episode_fn(cfg, phys, arrays)
        cost = float(host_array(out.cost).sum())
        print(f"day {day}: {args.kind} community cost {cost:+.3f} €")
        if store:
            # Baseline rows get a non-digit-prefixed setting so the scale /
            # rounds statistics (which collect settings by their leading
            # agent-count digits) never pool them with RL results. Single-agent
            # keeps the reference's 'single-agent' key (data_analysis.py:1301).
            baseline_setting = (
                "single-agent"
                if cfg.sim.n_agents == 1
                else f"baseline-{_persist_setting(args, cfg)}"
            )
            store.log_run_results(
                baseline_setting,
                args.kind,
                args.test,
                day,
                time=arrays.time,
                load=arrays.load_w,
                pv=arrays.pv_w,
                temperature=out.t_in,
                heatpump=out.hp_power_w,
                cost=out.cost,
            )
    return 0


def _initial_physical(cfg, dev: str):
    """A fresh physical state of one community, its initial temperatures
    drawn from a generator seeded with the config's seed (the JAX package
    draws them from ``PRNGKey(seed)`` for every day)."""
    import torch

    from p2pmicrogrid_tpu_torch.envs import init_physical

    normals = torch.randn(
        (2, cfg.sim.n_agents), generator=_generator(cfg.train.seed, dev), device=dev
    )
    return init_physical(cfg, normals, device=dev)


def cmd_single(args) -> int:
    """Standalone single-home harness (the reference's hand-rolled
    single-agent path, rl.py:362-418 ``run_episode`` / :424-440
    ``run_single_trial`` / :443-488 ``test``): train ONE home with no P2P
    negotiation or trading — observation (time, indoor temp, balance, zero
    p2p signal), reward -(cost + 10*penalty^2) with grid-only settlement —
    then immediately evaluate the greedy policy against the bang-bang
    thermostat (``RuleAgent``) on the SAME held-out day arrays and report
    both, the reference's "Price paid" comparison (rl.py:561-563).
    """
    args.agents = 1
    args.no_trading = True
    rc = cmd_train(args)
    if rc:
        return rc

    from p2pmicrogrid_tpu_torch.envs import EpisodeArrays, make_ratings, rule_baseline_episode
    from p2pmicrogrid_tpu_torch.train import evaluate_community, make_policy

    dev = _device(args.device)
    cfg = _build_cfg(args)
    _, val_traces, test_traces = _load_traces(args)
    traces = test_traces if getattr(args, "test", False) else val_traces
    ratings = make_ratings(cfg, np.random.default_rng(cfg.train.seed))
    key = _generator(cfg.train.seed, dev)
    policy = make_policy(cfg)
    pol_state, episode, ckpt_dir = _restore_eval_state(args, cfg, key, dev)
    print(f"restored {ckpt_dir} at episode {episode}")

    days, outputs, day_arrays = evaluate_community(
        cfg, policy, pol_state, traces, ratings, key,
        rng=np.random.default_rng(cfg.train.seed), device=dev,
    )
    rl_cost = host_array(outputs.cost).sum(axis=(1, 2))
    rl_reward = host_array(outputs.reward).sum(axis=(1, 2))

    # Thermostat on the EXACT day arrays the greedy eval saw (same redrawn
    # profile scales), so the comparison is apples-to-apples per day.
    base_cost, base_reward = [], []
    for i in range(len(days)):
        arrays_d = EpisodeArrays(*(x[i] for x in day_arrays))
        _, out = rule_baseline_episode(cfg, _initial_physical(cfg, dev), arrays_d)
        base_cost.append(float(host_array(out.cost).sum()))
        base_reward.append(float(host_array(out.reward).sum()))

    for i, d in enumerate(days.tolist()):
        print(
            f"day {d}: rl cost {rl_cost[i]:+.3f} € (reward {rl_reward[i]:+.1f})"
            f" | thermostat cost {base_cost[i]:+.3f} € "
            f"(reward {base_reward[i]:+.1f})"
        )
    summary = {
        "days": days.tolist(),
        "rl_cost_eur": round(float(rl_cost.sum()), 3),
        "thermostat_cost_eur": round(float(np.sum(base_cost)), 3),
        "rl_reward": round(float(rl_reward.sum()), 2),
        "thermostat_reward": round(float(np.sum(base_reward)), 2),
    }
    print(json.dumps(summary))
    return 0


def _maybe_pv_drop(args, arrays):
    """--pv-drop AGENT[:START_SLOT[:FACTOR]] — fault-inject one agent's PV."""
    spec = getattr(args, "pv_drop", None)
    if not spec:
        return arrays
    from p2pmicrogrid_tpu_torch.envs import with_pv_drop

    parts = spec.split(":")
    agent = int(parts[0])
    start = int(parts[1]) if len(parts) > 1 else 0
    factor = float(parts[2]) if len(parts) > 2 else 0.0
    return with_pv_drop(arrays, agent, start, factor)


def _persist_setting(args, cfg) -> str:
    """Setting string used as the results-store identity. PV-drop runs get
    their own name (the reference's '2-agent-1-pv-drop-{com,no-com}' keys,
    data_analysis.py:1104) so they never clobber the clean run's rows;
    evaluations of scenario-trained policies keep the scenario suffix so they
    never clobber plain-trained results."""
    spec = getattr(args, "pv_drop", None)
    if not spec:
        if getattr(args, "scenarios", 1) > 1:
            return _scenario_setting(cfg, getattr(args, "shared", False))
        return cfg.setting
    agent = spec.split(":")[0]
    com = "com" if cfg.sim.trading else "no-com"
    return f"{cfg.sim.n_agents}-agent-{agent}-pv-drop-{com}"


def cmd_sweep(args) -> int:
    """DDPG hyperparameter sweep (the capability behind the reference's
    commented-out sweep harness, rl.py:553-652, and its
    hyperparameters_single_day result table): grid over actor learning rate,
    tau, and OU sigma on a single-agent community; per-trial training reward
    and greedy validation reward logged per progress window."""
    import dataclasses
    import itertools

    from p2pmicrogrid_tpu_torch.data import ResultsStore
    from p2pmicrogrid_tpu_torch.envs import make_ratings
    from p2pmicrogrid_tpu_torch.train import (
        evaluate_community,
        init_policy_state,
        make_policy,
        train_community,
    )

    dev = _device(args.device)
    cfg0 = _build_cfg(args)
    train_traces, val_traces, _ = _load_traces(args)
    store = ResultsStore(args.results_db) if args.results_db else None

    grid = list(
        itertools.product(
            [float(x) for x in args.actor_lrs.split(",")],
            [float(x) for x in args.taus.split(",")],
            [float(x) for x in args.ou_sigmas.split(",")],
        )
    )
    for trial, (lr, tau, sigma) in enumerate(grid):
        cfg = cfg0.replace(
            ddpg=dataclasses.replace(
                cfg0.ddpg, actor_lr=lr, critic_lr=2 * lr, tau=tau, ou_sigma=sigma
            ),
            train=dataclasses.replace(cfg0.train, implementation="ddpg"),
        )
        settings = f"ddpg-lr{lr:g}-tau{tau:g}-sigma{sigma:g}"
        rng = np.random.default_rng(cfg.train.seed)
        ratings = make_ratings(cfg, rng)
        key = _generator(cfg.train.seed + trial, dev)
        policy = make_policy(cfg)
        ps = init_policy_state(cfg, dev, key)

        res = train_community(cfg, policy, ps, train_traces, ratings, key, device=dev)
        val = float("nan")
        if store:
            # Per-window training rewards from the run, then one greedy
            # validation pass with the final parameters.
            _, outs, _ = evaluate_community(
                cfg, policy, res.pol_state, val_traces, ratings,
                _generator(0, dev), rng=np.random.default_rng(0), device=dev,
            )
            val = float(host_array(outs.reward).sum())
            for ep, train_r, _err in res.progress:
                store.log_sweep_point(settings, trial, ep, train_r, val)
            store.log_sweep_point(
                settings, trial, cfg.train.max_episodes,
                res.episode_rewards[-1], val,
            )
        print(
            f"trial {trial} {settings}: final train reward "
            f"{res.episode_rewards[-1]:.1f}, validation {val:.1f}"
        )
    return 0


def cmd_forecast(args) -> int:
    """Train the windowed LSTM load/PV forecaster end-to-end and persist
    predictions — the counterpart of the reference's ``ml.main()``
    (ml.py:265-314): train on the training days, evaluate on the validation
    day, write predicted-vs-target rows to ``single_day_best_results``
    (database.py:176-193)."""
    if args.figures_dir:
        raise SystemExit(FIGURES_NOT_PORTED)
    import dataclasses

    import torch

    from p2pmicrogrid_tpu_torch.data import ResultsStore
    from p2pmicrogrid_tpu_torch.models.forecast import (
        forecast_predict,
        make_windows,
        train_forecaster,
    )

    dev = _device(args.device)
    cfg = _build_cfg(args)
    fc = dataclasses.replace(cfg.forecast, epochs=args.epochs)
    train_traces, val_traces, _ = _load_traces(args)

    def features(tr):
        # [time, outdoor temp (scaled), load, pv] — the reference's windowed
        # feature set with the (load, pv) pair as the forecast targets
        # (ml.py:30-48,253); profile 0 = the reference's single home.
        return np.stack(
            [
                np.asarray(tr.time),
                np.asarray(tr.t_out) / 20.0,
                np.asarray(tr.load)[:, 0],
                np.asarray(tr.pv)[:, 0],
            ],
            axis=1,
        )

    x_tr, y_tr = make_windows(
        features(train_traces), fc.input_width, fc.label_width, fc.shift
    )
    x_val, y_val = make_windows(
        features(val_traces), fc.input_width, fc.label_width, fc.shift
    )
    key = _generator(cfg.train.seed, dev)
    state, history = train_forecaster(
        fc, x_tr, y_tr, key, val_inputs=x_val, val_labels=y_val, verbose=True,
        device=dev,
    )
    with torch.no_grad():
        pred = host_array(forecast_predict(
            fc, state, torch.as_tensor(np.asarray(x_val, np.float32), device=dev)
        ))  # [N, W, 2]
    # The t+shift forecast = last window step (ml.py label alignment).
    p_load, p_pv = pred[:, -1, 0], pred[:, -1, 1]
    t_load, t_pv = y_val[:, -1, 0], y_val[:, -1, 1]
    mse = float(np.mean((pred - y_val) ** 2))
    train_mse = f"{history[-1][0]:.5f}" if history else "n/a"
    print(f"validation mse {mse:.5f} over {len(p_load)} windows "
          f"({fc.epochs} epochs; final train mse {train_mse})")

    # Forecast timestamps: each prediction lands input_width+shift-1 slots
    # after its window start.
    offset = fc.input_width + fc.shift - 1
    days = np.asarray(val_traces.day)[offset : offset + len(p_load)]
    times = np.asarray(val_traces.time)[offset : offset + len(p_load)]
    dates = [f"2021-10-{int(d):02d}" for d in days]
    hhmm = [f"{int(t * 24):02d}:{int((t * 24 % 1) * 60):02d}" for t in times]

    setting = f"forecast-lstm-w{fc.input_width}s{fc.shift}"
    if args.results_db:
        store = ResultsStore(args.results_db)
        store.log_predictions(setting, dates, hhmm, p_load, p_pv, t_load, t_pv)
        print(f"predictions -> {args.results_db} (single_day_best_results)")
    return 0


def cmd_export_bundle(args) -> int:
    """Freeze a checkpoint's greedy parameters into a serving bundle.

    Locates the checkpoint exactly like ``eval`` does (plain, scenario,
    shared, chunked and share-agents settings all resolve through
    ``_restore_eval_state``), then writes the bundle via serve/export.py.
    """
    from p2pmicrogrid_tpu_torch.serve import export_policy_bundle

    dev = _device(args.device)
    cfg = _build_cfg(args)
    key = _generator(cfg.train.seed, dev)
    if cfg.train.implementation == "ddpg_recurrent":
        # The recurrent day-granular actor (train-recurrent): no learner
        # template exists in init_policy_state, so the checkpoint is read
        # structure-free (restore_raw) — the export touches only the
        # actor subtree anyway.
        from p2pmicrogrid_tpu_torch.train.checkpoint import restore_raw
        from p2pmicrogrid_tpu_torch.train.recurrent import recurrent_checkpoint_dir

        ckpt_dir = recurrent_checkpoint_dir(args.model_dir, cfg.setting)
        pol_state, episode, _step = restore_raw(ckpt_dir)
    elif (
        cfg.train.implementation == "ddpg"
        and getattr(args, "share_agents", False)
        and getattr(args, "scenarios", 1) > 1
        and getattr(args, "shared", False)
    ):
        # Export the BARE community-shared actor: the engine serves it as
        # one flattened [B*A, 4] pass instead of A per-agent copies.
        from p2pmicrogrid_tpu_torch.models.ddpg import ddpg_params_init
        from p2pmicrogrid_tpu_torch.train.checkpoint import (
            checkpoint_dir,
            restore_checkpoint,
        )

        setting = _scenario_setting(cfg, True, getattr(args, "chunks", 1))
        ckpt_dir = checkpoint_dir(
            args.model_dir, setting, cfg.train.implementation
        )
        pol_state, episode = restore_checkpoint(
            ckpt_dir, ddpg_params_init(cfg.ddpg, cfg.sim.n_agents, key, device=dev)
        )
    else:
        pol_state, episode, ckpt_dir = _restore_eval_state(args, cfg, key, dev)
    print(f"restored {ckpt_dir} at episode {episode}")
    out = args.out or os.path.join(
        "bundles", f"{_persist_setting(args, cfg)}-{cfg.train.implementation}"
    )
    export_kw = {}
    if getattr(args, "ulp_budget", None) is not None:
        export_kw["ulp_budget"] = args.ulp_budget
    if getattr(args, "aot_buckets", None):
        export_kw["aot_buckets"] = [
            int(b) for b in str(args.aot_buckets).split(",") if b.strip()
        ]
    path = export_policy_bundle(
        cfg,
        pol_state,
        out,
        source={"checkpoint": os.path.abspath(ckpt_dir), "episode": episode},
        dtype=args.dtype,
        device=dev,
        **export_kw,
    )
    with open(os.path.join(path, "manifest.json")) as f:
        m = json.load(f)
    print(
        f"bundle -> {path} ({m['implementation']}, {m['param_count']} params, "
        f"{m['param_bytes']} bytes, config {m['config_hash']})"
    )
    return 0


def cmd_train_recurrent(args) -> int:
    """Train the recurrent day-granular LSTM DDPG actor (train/recurrent.py)
    and checkpoint it under ``models_ddpg_recurrent/<setting>`` so
    ``export-bundle --implementation ddpg_recurrent`` can freeze it into a
    servable bundle. One episode = one day on the community physics;
    deterministic under --seed."""
    from p2pmicrogrid_tpu_torch.train.recurrent import (
        save_recurrent_checkpoint,
        train_recurrent_community,
    )

    dev = _device(args.device)
    args.implementation = "ddpg_recurrent"
    cfg = _build_cfg(args)
    res = train_recurrent_community(
        cfg, episodes=args.episodes, generator=_generator(cfg.train.seed, dev),
        device=dev,
    )
    path = save_recurrent_checkpoint(
        args.model_dir, cfg, res.state, episode=args.episodes
    )
    print(
        json.dumps(
            {
                "metric": "train_recurrent",
                "value": round(float(res.day_rewards[-1]), 4),
                "unit": "day_reward",
                "vs_baseline": 1.0,
                "episodes": args.episodes,
                "first_day_reward": round(float(res.day_rewards[0]), 4),
                "last_day_reward": round(float(res.day_rewards[-1]), 4),
                "last_day_cost_eur": round(float(res.day_costs[-1]), 4),
                "checkpoint": path,
            }
        ),
        flush=True,
    )
    return 0


def _serve_device(args) -> str:
    """``--serve-device``: ``cpu``, or the card for ``default``; ``auto``
    follows ``--device`` until a crossover measured on the card can place
    engines (ROADMAP.md, Queue 1, item 6)."""
    return _device(args.device if args.serve_device == "auto" else args.serve_device)


def _serve_trace_rows(results_db: str, slo_ms: float) -> list:
    """Post-run warehouse analysis for ``serve-bench --fleet --trace``:
    stitch the slowest exemplar traces back into cross-process trees,
    pick the headline trace (preferring a COMPLETE >=3-process tree with
    a failover hop — the chaos story), and decompose critical paths.

    Returns the rows to append to the capture: one ``trace_tree`` row
    with the stitched spans, then the ``serve_bench_trace`` headline
    (metric/value/unit/vs_baseline) whose ``critical_path`` segments sum
    to the root span's measured wall time by construction."""
    import json as _json

    from p2pmicrogrid_tpu_torch.data.results import ResultsStore
    from p2pmicrogrid_tpu_torch.telemetry.report import (
        aggregate_critical_paths,
        trace_critical_path,
    )

    rows: list = []
    with ResultsStore(results_db) as store:
        seen: set = set()
        candidates = []
        for ex in store.query_slowest_traces(64):
            tid = ex.get("trace_id")
            if tid and tid not in seen:
                seen.add(tid)
                candidates.append(ex)
        best = None
        for ex in candidates:
            tree = store.query_trace_tree(ex["trace_id"])
            cp = trace_critical_path(tree)
            if cp is None:
                continue
            ids = {s["span_id"] for s in tree}
            complete = all(
                s.get("parent_span_id") is None
                or s["parent_span_id"] in ids
                for s in tree
            )
            failover = any(
                s.get("name") == "router.attempt"
                and (s.get("attrs") or {}).get("failover")
                for s in tree
            )
            cand = {
                "exemplar": ex, "tree": tree, "cp": cp,
                "tree_complete": complete, "failover": failover,
            }
            if best is None:
                best = cand
            if cp["n_processes"] >= 3 and failover and complete:
                best = cand
                break
        # Aggregate percentile decomposition over EVERY trace in the
        # warehouse — one query, grouped in memory.
        trees: dict = {}
        for (tid, sid, pid, name, ts, dur, proc, attrs) in store.con.execute(
            "SELECT trace_id, span_id, parent_span_id, name, ts, "
            "duration_s, process, attrs_json FROM trace_spans "
            "ORDER BY trace_id, ts"
        ):
            trees.setdefault(tid, []).append({
                "trace_id": tid, "span_id": sid, "parent_span_id": pid,
                "name": name, "ts": ts, "duration_s": dur,
                "process": proc,
                "attrs": _json.loads(attrs) if attrs else {},
            })
        agg = aggregate_critical_paths(list(trees.values()))
    if best is None:
        rows.append({
            "metric": "serve_bench_trace", "value": 0.0, "unit": "ms",
            "vs_baseline": 0.0, "error": "no traced spans in warehouse",
        })
        return rows
    cp = best["cp"]
    rows.append({
        "kind": "trace_tree",
        "trace_id": cp["trace_id"],
        "n_spans": cp["n_spans"],
        "n_processes": cp["n_processes"],
        "tree_complete": best["tree_complete"],
        "failover": best["failover"],
        "spans": [
            {
                "span_id": s["span_id"],
                "parent_span_id": s.get("parent_span_id"),
                "name": s["name"],
                "process": s.get("process"),
                "ts": s.get("ts"),
                "duration_ms": round((s.get("duration_s") or 0.0) * 1e3, 3),
            }
            for s in best["tree"]
        ],
    })
    measured_ms = float(best["exemplar"].get("latency_ms") or 0.0)
    rows.append({
        "metric": "serve_bench_trace",
        "value": cp["total_ms"],
        "unit": "ms",
        "vs_baseline": round(slo_ms / cp["total_ms"], 2)
        if cp["total_ms"] > 0 else 0.0,
        "trace_id": cp["trace_id"],
        "critical_path": {
            k: cp[k]
            for k in ("wire_ms", "queue_wait_ms", "padding_ms",
                      "execute_ms", "retry_ms", "total_ms")
        },
        "measured_ms": round(measured_ms, 3),
        "n_processes": cp["n_processes"],
        "n_spans": cp["n_spans"],
        "tree_complete": best["tree_complete"],
        "failover": best["failover"],
        "critical_path_percentiles": agg,
        "results_db_traces": len(trees),
    })
    return rows


def cmd_serve_bench(args) -> int:
    """Open-loop serving benchmark against a policy bundle.

    stdout carries strictly one JSON metric row per line (the same
    fd-guarded telemetry sink as ``bench``); the LAST line is the headline
    row with every stat. Without ``--bundle``, a fresh-init bundle for the
    configured setting is exported to a temp dir first — the zero-to-SLO
    smoke path on hosts with no trained checkpoint.

    With ``--results-db``, the run also streams into the SQLite telemetry
    warehouse: per-request ``serve_request`` trace records (enqueue->
    dispatch wait, bucket, padding, batch service span), the per-bucket
    compile profiles and the metric rows — keyed by the bundle's
    config_hash, so serve SLOs are one SQL join away from the training
    telemetry and eval rows of the same config (``telemetry-query``).

    The engines serve from ``--serve-device`` (``auto`` follows
    ``--device``: the card by default). ``--fleet --population`` (the JAX
    package's scale tier) waits for ``scale/`` (ROADMAP.md, Queue 1, item
    15) and exits non-zero.
    """
    from p2pmicrogrid_tpu_torch.serve import PolicyEngine, export_policy_bundle
    from p2pmicrogrid_tpu_torch.serve.loadgen import serve_bench
    from p2pmicrogrid_tpu_torch.telemetry import (
        SqliteSink,
        Telemetry,
        guarded_stdout_sink,
        run_manifest,
        set_current,
    )
    from p2pmicrogrid_tpu_torch.telemetry.registry import run_stamp

    if getattr(args, "population", None):
        if getattr(args, "fleet", False):
            raise SystemExit(POPULATION_NOT_PORTED)
        print(
            "--population needs --fleet (the scale tier benches the "
            "fleet serving path)",
            file=sys.stderr,
        )
        return 2
    dev = _serve_device(args)
    cfg = _build_cfg(args)
    with guarded_stdout_sink() as sink:
        # EVERYTHING that may write to fd 1 runs inside the guard —
        # including the fresh-init export — so native noise cannot precede
        # the metric rows.
        bundle = args.bundle
        if bundle is None:
            import tempfile

            from p2pmicrogrid_tpu_torch.train import init_policy_state

            tmp = tempfile.mkdtemp(prefix="p2p-bundle-")
            ps = init_policy_state(cfg, dev, _generator(cfg.train.seed, dev))
            bundle = export_policy_bundle(cfg, ps, tmp, device=dev)
            print(
                f"serve-bench: no --bundle given; exported a fresh-init "
                f"{cfg.train.implementation} bundle to {bundle}",
                file=sys.stderr,
                flush=True,
            )
        # --burst-factor: None = mode default (plain Poisson everywhere;
        # the continuous-compare exists to exercise the bursty pathology,
        # so IT defaults to 8). An explicit value — including 1.0, plain
        # Poisson — is always honored.
        burst_factor = args.burst_factor if args.burst_factor is not None \
            else 1.0
        if getattr(args, "continuous_compare", False):
            # One-process continuous-vs-microbatch comparison at the mux
            # wire (serve/continuous.py): same bundle, same (bursty)
            # schedule, two gateways.
            from p2pmicrogrid_tpu_torch.serve.continuous import (
                serve_bench_continuous_compare,
            )

            serve_bench_continuous_compare(
                bundle,
                rate_hz=args.rate,
                n_requests=args.requests,
                n_households=args.households,
                seed=args.bench_seed,
                slo_ms=args.slo_ms,
                burst_factor=(
                    args.burst_factor if args.burst_factor is not None
                    else 8.0
                ),
                burst_dwell_s=args.burst_dwell_s,
                max_batch=args.max_batch,
                max_wait_s=args.max_wait_ms / 1e3,
                max_slots=getattr(args, "max_sessions", 256),
                device=dev,
                results_db=args.results_db,
                emit=sink.emit,
            )
            return 0
        if getattr(args, "fleet", False):
            # Fleet mode: N gateway replicas behind the consistent-hash
            # router, the open-loop schedule fired THROUGH the router
            # (retry/failover semantics included), optionally with a
            # deterministic kill/restart fault plan mid-run. --process
            # swaps the in-process LocalFleet for real subprocess
            # replicas (serve/procfleet.py) — kills become SIGKILLs, the
            # supervisor relaunches, and --tls/--auth terminate trust at
            # every replica.
            import os as _os
            import tempfile as _tempfile

            from p2pmicrogrid_tpu_torch.serve import (
                AdmissionConfig,
                FaultEvent,
                FaultPlan,
                FleetRouter,
                LocalFleet,
                ProcessFleet,
                kill_restart_plan,
                serve_bench_fleet,
            )
            from p2pmicrogrid_tpu_torch.serve.loadgen import (
                RetryPolicy,
                serve_bench_wire_compare,
            )

            tracing_on = getattr(args, "trace", False)
            trace_db_tmp = None
            if tracing_on and not args.results_db:
                # The stitched tree lives in the warehouse — without a
                # user-supplied DB the capture still needs one to stitch
                # from; a temp file, deleted after the analysis.
                fd, trace_db_tmp = _tempfile.mkstemp(
                    prefix="p2p-trace-", suffix=".db"
                )
                _os.close(fd)
                args.results_db = trace_db_tmp
            plan = None
            trace_stall = False
            if getattr(args, "chaos_plan", None):
                with open(args.chaos_plan) as f:
                    plan = FaultPlan.from_json(f.read())
            elif getattr(args, "chaos", False):
                duration = args.requests / args.rate
                kill_at = (
                    args.kill_at if args.kill_at is not None
                    else 0.3 * duration
                )
                restart_at = (
                    args.restart_at if args.restart_at is not None
                    else 0.6 * duration
                )
                victim = f"replica-{min(1, args.replicas - 1)}"
                extra = ()
                if tracing_on:
                    # A SIGKILL alone loses the victim's un-flushed spans
                    # for requests in flight AT the kill. A stall window
                    # BEFORE the kill (stall > the tightened per-attempt
                    # router timeout below) forces clean failover hops
                    # whose victim-side spans DO flush before the kill —
                    # the >=3-process trees the TRACE capture commits.
                    trace_stall = True
                    extra = (FaultEvent(
                        kind="stall", replica=victim,
                        at_s=min(0.5, 0.1 * duration),
                        until_s=min(1.0, 0.2 * duration),
                        rate=1.0, stall_s=0.8, scope="act",
                    ),)
                plan = kill_restart_plan(
                    victim, kill_at, restart_at, seed=args.chaos_seed,
                    extra_events=extra,
                )
            process_mode = getattr(args, "process", False)
            transport = getattr(args, "fleet_transport", "auto")
            use_tls = getattr(args, "tls", False)
            use_auth = getattr(args, "auth", False)
            cert = key = server_ctx = client_ctx = None
            authenticator = router_token = secret_file = None
            if use_tls:
                from p2pmicrogrid_tpu_torch.serve import (
                    client_ssl_context,
                    ensure_test_certs,
                    server_ssl_context,
                )

                cert, key = ensure_test_certs()
                server_ctx = server_ssl_context(cert, key)
                client_ctx = client_ssl_context(cert)
                print(f"serve-bench: TLS on (test cert {cert})",
                      file=sys.stderr, flush=True)
            if use_auth:
                from p2pmicrogrid_tpu_torch.serve import (
                    TokenAuthenticator,
                    generate_secret,
                )

                fd, secret_file = _tempfile.mkstemp(prefix="p2p-secret-")
                _os.close(fd)
                authenticator = TokenAuthenticator(
                    generate_secret(secret_file)
                )
                router_token = authenticator.mint("*")
                print("serve-bench: per-household token auth on",
                      file=sys.stderr, flush=True)
            plan_file = None
            has_request_faults = plan is not None and any(
                e.kind not in ("kill", "restart") for e in plan.events
            )
            if getattr(args, "wire_compare", False):
                # Refuse impossible combinations BEFORE paying fleet
                # startup (in process mode: several subprocess spawns).
                if transport == "http":
                    raise SystemExit(
                        "--wire-compare needs the mux wire "
                        "(drop --transport http)"
                    )
                if has_request_faults:
                    # A request-fault injector anchors at the first
                    # request it sees (process children) or first-wins
                    # activate (in-process) — the compare pre-pass would
                    # start replica-0's fault clock, shift its coin
                    # indices and absorb its injected faults, corrupting
                    # both measurements AND seed replay.
                    raise SystemExit(
                        "--wire-compare cannot run in the same "
                        "invocation as a request-fault chaos plan "
                        "(the pre-pass would anchor and consume "
                        "replica-0's fault windows); capture them in "
                        "two runs"
                    )
            if process_mode:
                if has_request_faults:
                    # Request-kind faults execute INSIDE each child's
                    # injector; lifecycle events stay parent-driven.
                    fd, plan_file = _tempfile.mkstemp(
                        prefix="p2p-plan-", suffix=".json"
                    )
                    with _os.fdopen(fd, "w") as f:
                        f.write(plan.to_json())
                fleet = ProcessFleet(
                    [bundle],
                    n_replicas=args.replicas,
                    max_batch=args.max_batch,
                    max_wait_s=args.max_wait_ms / 1e3,
                    max_queue_depth=args.max_queue_depth,
                    wait_budget_ms=args.wait_budget_ms,
                    mux=(transport != "http"),
                    tls_cert=cert,
                    tls_key=key,
                    auth_secret_file=secret_file,
                    fault_plan_file=plan_file,
                    results_db=args.results_db,
                    serve_device=dev,
                    batching=getattr(args, "batching", "micro"),
                    max_slots=getattr(args, "max_sessions", 256),
                    shard_warehouse=getattr(args, "shard_warehouse", False),
                )
                fleet.start()
                # The bit-exactness comparator lives in THIS process: the
                # same bundle the children serve, loaded directly.
                reference = PolicyEngine(
                    bundle_dir=bundle, max_batch=args.max_batch,
                    device=dev,
                )
            else:
                fleet = LocalFleet(
                    [bundle],
                    n_replicas=args.replicas,
                    max_batch=args.max_batch,
                    max_wait_s=args.max_wait_ms / 1e3,
                    admission=AdmissionConfig(
                        max_queue_depth=args.max_queue_depth,
                        wait_budget_ms=args.wait_budget_ms,
                    ),
                    results_db=args.results_db,
                    device=dev,
                    fault_plan=plan,
                    run_name="serve-bench-fleet",
                    mux=(transport != "http"),
                    tls=server_ctx,
                    authenticator=authenticator,
                    batching=getattr(args, "batching", "micro"),
                    max_slots=getattr(args, "max_sessions", 256),
                    shard_warehouse=getattr(args, "shard_warehouse", False),
                )
                fleet.start()
                reference = fleet.reference_engine()
            # The router gets its own warehouse-keyed telemetry: ejection/
            # failover/retry counters and the aggregated fleet_stats event
            # land next to the per-replica bundle traces, joined on the
            # served bundle's config_hash.
            router_tel = Telemetry(
                run_id=f"fleet-router-{run_stamp()}",
                sinks=(
                    [SqliteSink(args.results_db)] if args.results_db else []
                ),
                manifest=run_manifest(
                    extra={
                        "config_hash": reference.manifest.get("config_hash"),
                        "setting": reference.manifest.get("setting"),
                        "serve_role": "router",
                        "fleet_size": args.replicas,
                    }
                ),
            )
            router = FleetRouter(
                fleet.replicas,
                retry=RetryPolicy(
                    max_attempts=args.retry_attempts,
                    deadline_s=args.retry_deadline_s,
                ),
                fail_threshold=2,
                ok_threshold=1,
                telemetry=router_tel,
                ssl_context=client_ctx,
                token=router_token,
                transport=transport,
                # Tighter than the stall window's 0.8s hold: a stalled
                # attempt must TIME OUT client-side and fail over (the
                # traced hop), not drain the stall and answer late.
                **({"request_timeout_s": 0.4} if trace_stall else {}),
            )
            unauth_router = None
            if use_auth:
                # The auth acceptance probe: a second router over the SAME
                # fleet holding NO credential — its requests must 401
                # without a single retry or budget token spent.
                unauth_router = FleetRouter(
                    fleet.replicas,
                    retry=RetryPolicy(
                        max_attempts=args.retry_attempts,
                        deadline_s=args.retry_deadline_s,
                    ),
                    ssl_context=client_ctx,
                    transport=transport,
                )
            print(
                f"serve-bench: {'process' if process_mode else 'in-process'}"
                f" fleet of {args.replicas} replicas on "
                + ", ".join(f"{r.replica_id}:{r.port}" for r in fleet.replicas)
                + (
                    f"; chaos plan: {len(plan.events)} event(s), "
                    f"seed {plan.seed}" if plan is not None else ""
                ),
                file=sys.stderr,
                flush=True,
            )
            try:
                gateway_baseline = None
                if getattr(args, "wire_compare", False):
                    rep0 = fleet.replicas[0]
                    token_fn = (
                        (lambda h: authenticator.mint(h))
                        if authenticator is not None else None
                    )
                    serve_bench_wire_compare(
                        rep0.host, rep0.port, rep0.mux_port,
                        reference.n_agents,
                        rate_hz=args.rate,
                        n_requests=min(args.requests, 512),
                        n_households=args.households,
                        seed=args.bench_seed,
                        ssl=client_ctx,
                        token_fn=token_fn,
                        emit=lambda row: (sink.emit(row),
                                          router_tel.emit(row)),
                    )
                    # Gateway stats are cumulative: snapshot the pre-pass
                    # totals so the chaos headline reports only ITS run.
                    gateway_baseline = router.fleet_stats()[
                        "gateway_totals"
                    ]
                serve_bench_fleet(
                    router,
                    n_agents=reference.n_agents,
                    fleet=fleet,
                    fault_plan=plan,
                    # A recurrent bundle's answers depend on engine-side
                    # hidden state: a stateless direct-act replay is not a
                    # valid comparator, so the bit-exact verdict is
                    # omitted (hidden-state continuity is regression-
                    # tested in tests/test_continuous.py instead).
                    reference_engine=(
                        None if reference.is_recurrent else reference
                    ),
                    rate_hz=args.rate,
                    n_requests=args.requests,
                    n_households=args.households,
                    seed=args.bench_seed,
                    slo_ms=args.slo_ms,
                    burst_factor=burst_factor,
                    burst_dwell_s=args.burst_dwell_s,
                    probe_interval_s=0.05,
                    emit=lambda row: (sink.emit(row), router_tel.emit(row)),
                    unauth_router=unauth_router,
                    # Process relaunches pay a child's full startup; wait
                    # for the supervisor's relaunch so the headline's
                    # fleet stats SHOW the restarted replica.
                    chaos_join_grace_s=180.0 if process_mode else 10.0,
                    recover_wait_s=180.0 if (
                        process_mode and plan is not None
                    ) else 0.0,
                    gateway_baseline=gateway_baseline,
                    trace_seed=args.bench_seed if tracing_on else None,
                    extra_headline={
                        "config_hash": reference.manifest.get("config_hash"),
                        "implementation": reference.manifest.get(
                            "implementation"
                        ),
                        "n_agents": reference.n_agents,
                        "max_batch": args.max_batch,
                        "max_wait_ms": round(args.max_wait_ms, 3),
                        "process_mode": process_mode,
                        "batching": getattr(args, "batching", "micro"),
                    },
                )
            finally:
                fleet.stop_all()
                router_tel.close()
                # The bench minted these credentials/plans for ITS fleet
                # only — a live signing secret must not outlive the
                # processes it authorized.
                for path in (secret_file, plan_file):
                    if path is not None:
                        try:
                            _os.unlink(path)
                        except OSError:
                            pass
            if tracing_on:
                # Everything is flushed (fleet stopped, router telemetry
                # closed): stitch the trees, decompose the p99, and append
                # the trace_tree row + serve_bench_trace headline LAST.
                try:
                    for row in _serve_trace_rows(
                        args.results_db, slo_ms=args.slo_ms
                    ):
                        sink.emit(row)
                finally:
                    if trace_db_tmp is not None:
                        try:
                            _os.unlink(trace_db_tmp)
                        except OSError:
                            pass
            return 0
        if getattr(args, "network", False):
            # Wire-level mode: the same open-loop schedule, fired over real
            # sockets at an in-process gateway (its per-bundle telemetry —
            # per-request serve_request traces keyed by the bundle's
            # config_hash — streams into --results-db via build_gateway).
            from p2pmicrogrid_tpu_torch.serve import (
                AdmissionConfig,
                GatewayServer,
                build_gateway,
            )
            from p2pmicrogrid_tpu_torch.serve.loadgen import (
                RetryPolicy,
                serve_bench_network,
            )

            gateway = build_gateway(
                [bundle],
                max_batch=args.max_batch,
                max_wait_s=args.max_wait_ms / 1e3,
                results_db=args.results_db,
                device=dev,
                admission=AdmissionConfig(
                    max_queue_depth=args.max_queue_depth,
                    wait_budget_ms=args.wait_budget_ms,
                ),
                run_name="serve-bench-net",
                batching=getattr(args, "batching", "micro"),
                max_slots=getattr(args, "max_sessions", 256),
            )
            server = GatewayServer(gateway)
            try:
                host, port = server.start()
                default = gateway.registry.get(gateway.registry.default_hash)
                print(
                    f"serve-bench: gateway on {host}:{port} serving bundle "
                    f"{default.config_hash}",
                    file=sys.stderr,
                    flush=True,
                )

                def emit(row):
                    sink.emit(row)
                    if default.telemetry is not None:
                        default.telemetry.emit(row)

                serve_bench_network(
                    host, port,
                    n_agents=default.engine.n_agents,
                    rate_hz=args.rate,
                    n_requests=args.requests,
                    n_households=args.households,
                    seed=args.bench_seed,
                    slo_ms=args.slo_ms,
                    burst_factor=burst_factor,
                    burst_dwell_s=args.burst_dwell_s,
                    retry=(
                        RetryPolicy(
                            max_attempts=args.retry_attempts,
                            deadline_s=args.retry_deadline_s,
                        )
                        if getattr(args, "retry", False) else None
                    ),
                    emit=emit,
                    extra_headline={
                        "config_hash": default.config_hash,
                        "implementation": default.implementation,
                        "n_agents": default.engine.n_agents,
                        "max_batch": args.max_batch,
                        "max_wait_ms": round(args.max_wait_ms, 3),
                        "batching": getattr(args, "batching", "micro"),
                    },
                )
            finally:
                server.stop()  # drains in-flight, closes queues + telemetry
            return 0
        # The stdout sink carries ONLY metric rows (one JSON row a line);
        # event-stream records (per-request traces, compile profiles) go to
        # the telemetry's own sinks — the SQLite warehouse when requested.
        tel_sinks = []
        if args.results_db:
            tel_sinks.append(SqliteSink(args.results_db))
        tel = Telemetry(
            run_id=f"serve-bench-{run_stamp()}",
            sinks=tel_sinks,
            manifest=run_manifest(cfg),
        )
        set_current(tel)
        try:
            engine = PolicyEngine(
                bundle_dir=bundle, max_batch=args.max_batch, telemetry=tel,
                device=dev,
            )
            print(
                f"serve-bench: engine on {engine.device}",
                file=sys.stderr,
                flush=True,
            )
            # Serve rows join on the BUNDLE's training config identity: the
            # engine serves the exported checkpoint's config, which may
            # differ from the CLI flags' freshly built cfg.
            bundle_hash = engine.manifest.get("config_hash")
            if bundle_hash:
                tel.annotate_manifest(config_hash=bundle_hash)
            serve_bench(
                engine,
                rate_hz=args.rate,
                n_requests=args.requests,
                max_batch=args.max_batch,
                max_wait_s=args.max_wait_ms / 1e3,
                seed=args.bench_seed,
                slo_ms=args.slo_ms,
                burst_factor=burst_factor,
                burst_dwell_s=args.burst_dwell_s,
                emit=lambda row: (sink.emit(row), tel.emit(row)),
            )
        finally:
            set_current(None)
            tel.close()
    return 0


def cmd_serve_gateway(args) -> int:
    """Run the HTTP serving gateway over one or more policy bundles.

    The network front of the serving stack (serve/gateway.py): remote
    households POST observations to ``/v1/act`` and get greedy actions,
    coalesced through the microbatch queue (or the continuous batcher).
    Multiple ``--bundle`` flags register multiple bundles in the hot-swap
    registry (first = default); ``POST /admin/swap`` retargets or splits
    traffic at runtime. Without ``--bundle``, a fresh-init bundle for the
    configured setting is exported first (the smoke path).

    Prints one ``gateway_listening`` JSON line (host, resolved port + mux
    port, registered bundle hashes, the serving device) once the socket
    accepts, then serves until SIGINT/Ctrl-C (or ``--serve-seconds``),
    drains in-flight requests, and optionally writes the final ``/stats``
    snapshot to ``--stats-out`` (the ``GATEWAY_STATS_*.json`` capture
    schema). With ``--results-db`` every bundle's telemetry (one
    ``serve_request`` point a request) streams into the warehouse.

    Process-fleet flags: ``--mux-port`` serves the persistent multiplexed
    wire, ``--tls-cert``/``--tls-key`` terminate TLS on both listeners,
    ``--auth-secret-file`` enforces per-household bearer tokens
    (``serve-token``), ``--replica-id``/``--restarts`` identify the replica
    to fleet stats; ``--chaos-plan`` builds this replica's request-fault
    injector from a fault-plan JSON (serve/faults.py).
    """
    import asyncio

    from p2pmicrogrid_tpu_torch.serve import AdmissionConfig, build_gateway

    dev = _serve_device(args)
    bundles = list(args.bundle or [])
    if not bundles:
        import tempfile

        from p2pmicrogrid_tpu_torch.serve import export_policy_bundle
        from p2pmicrogrid_tpu_torch.train import init_policy_state

        cfg = _build_cfg(args)
        tmp = tempfile.mkdtemp(prefix="p2p-bundle-")
        ps = init_policy_state(cfg, dev, _generator(cfg.train.seed, dev))
        bundles = [export_policy_bundle(cfg, ps, tmp, device=dev)]
        print(
            f"serve-gateway: no --bundle given; exported a fresh-init "
            f"{cfg.train.implementation} bundle to {bundles[0]}",
            file=sys.stderr,
            flush=True,
        )
    tls = None
    if bool(getattr(args, "tls_cert", None)) != bool(
        getattr(args, "tls_key", None)
    ):
        raise SystemExit("pass --tls-cert AND --tls-key together")
    if getattr(args, "tls_cert", None):
        from p2pmicrogrid_tpu_torch.serve import server_ssl_context

        tls = server_ssl_context(args.tls_cert, args.tls_key)
    authenticator = None
    if getattr(args, "auth_secret_file", None):
        from p2pmicrogrid_tpu_torch.serve import TokenAuthenticator

        # from_secret_file honors a rotation's .prev grace window: a
        # gateway (re)started mid-rotation verifies BOTH secrets until
        # the grace expires (serve-token --rotate).
        authenticator = TokenAuthenticator.from_secret_file(
            args.auth_secret_file
        )
    fault_injector = None
    if getattr(args, "chaos_plan", None):
        from p2pmicrogrid_tpu_torch.serve import FaultInjector, FaultPlan

        with open(args.chaos_plan) as f:
            plan = FaultPlan.from_json(f.read())
        fault_injector = FaultInjector(
            plan, getattr(args, "replica_id", None) or "replica-0"
        )
    gateway = build_gateway(
        bundles,
        max_batch=args.max_batch,
        max_wait_s=args.max_wait_ms / 1e3,
        results_db=args.results_db,
        device=dev,
        admission=AdmissionConfig(
            max_queue_depth=args.max_queue_depth,
            wait_budget_ms=args.wait_budget_ms,
            retry_after_s=args.retry_after_s,
        ),
        batching=getattr(args, "batching", "micro"),
        max_slots=getattr(args, "max_sessions", 256),
        shard_id=getattr(args, "shard_id", None),
        host=args.host,
        port=args.port,
        mux_port=getattr(args, "mux_port", None),
        tls=tls,
        authenticator=authenticator,
        replica_id=getattr(args, "replica_id", None),
        restarts=getattr(args, "restarts", 0),
        fault_injector=fault_injector,
    )
    if dev == "cpu":
        device_name = "cpu"
    else:
        import torch

        device_name = torch.cuda.get_device_name(torch.cuda.current_device())

    async def run() -> None:
        host, port = await gateway.start()
        print(
            json.dumps(
                {
                    "kind": "gateway_listening",
                    "host": host,
                    "port": port,
                    "mux_port": gateway.mux_port,
                    "tls": tls is not None,
                    "auth": authenticator is not None,
                    "replica_id": gateway.replica_id,
                    "pid": os.getpid(),
                    "bundles": gateway.registry.hashes,
                    "default": gateway.registry.default_hash,
                    "device": device_name,
                }
            ),
            flush=True,
        )
        try:
            if args.serve_seconds > 0:
                await asyncio.sleep(args.serve_seconds)
            else:
                await asyncio.Event().wait()  # until cancelled (Ctrl-C)
        finally:
            await gateway.stop(drain=True)

    try:
        asyncio.run(run())
    except KeyboardInterrupt:
        pass
    if args.stats_out:
        with open(args.stats_out, "w") as f:
            json.dump(gateway.stats_snapshot(), f, indent=2)
        print(f"serve-gateway: stats -> {args.stats_out}", file=sys.stderr)
    return 0


def cmd_serve_token(args) -> int:
    """Mint fleet secrets and per-household bearer tokens (serve/auth.py).

    ``--new-secret PATH`` writes a fresh 32-byte fleet secret (mode 0600)
    — distribute it to every gateway/router process. ``--rotate`` (with
    ``--secret-file``) replaces the secret in place and parks the old one
    in ``<path>.prev`` with a ``--grace-s`` expiry: verifiers built from
    the file honor BOTH secrets until the grace passes, so the fleet
    rotates without a synchronized restart. With ``--secret-file`` plus
    ``--household`` (or ``--wildcard`` for the operator credential),
    prints one signed bearer token on stdout, optionally bounded by
    ``--ttl-s``. Verification (`--verify TOKEN`) prints the claims,
    checking the full dual-secret chain.
    """
    from p2pmicrogrid_tpu_torch.serve import auth as serve_auth

    if args.new_secret:
        serve_auth.generate_secret(args.new_secret)
        print(f"serve-token: secret -> {args.new_secret}", file=sys.stderr)
        return 0
    if not args.secret_file:
        raise SystemExit("pass --new-secret PATH, or --secret-file PATH")
    if args.rotate:
        serve_auth.rotate_secret(args.secret_file, grace_s=args.grace_s)
        print(
            f"serve-token: rotated {args.secret_file} (old secret honored "
            f"for {args.grace_s:g}s via {args.secret_file}.prev)",
            file=sys.stderr,
        )
        return 0
    if args.verify:
        chain = serve_auth.load_secret_chain(args.secret_file)
        try:
            claims = serve_auth.TokenAuthenticator(chain).verify(args.verify)
        except serve_auth.AuthError as err:
            print(json.dumps({"valid": False, "error": str(err),
                              "status": err.status}))
            return 1
        print(json.dumps({"valid": True, **claims}))
        return 0
    secret = serve_auth.load_secret(args.secret_file)
    household = (
        serve_auth.WILDCARD_HOUSEHOLD if args.wildcard else args.household
    )
    if not household:
        raise SystemExit(
            "pass --household ID (or --wildcard for the operator token)"
        )
    print(serve_auth.mint_token(secret, household, ttl_s=args.ttl_s))
    return 0


def cmd_serve_router(args) -> int:
    """Run the fleet router as a standalone proxy process (serve/proxy.py).

    ``--replica host:port[/muxport]`` (repeat per replica) names the
    gateway fleet; the proxy terminates TLS + per-household auth at its
    own socket and forwards over the persistent multiplexed wire with the
    router's retry/failover/health discipline. Prints one
    ``router_listening`` JSON line, serves until Ctrl-C (or
    ``--serve-seconds``), optionally writing the final fleet-stats
    snapshot to ``--stats-out``.
    """
    import asyncio

    from p2pmicrogrid_tpu_torch.serve import FleetRouter, Replica, RouterProxy
    from p2pmicrogrid_tpu_torch.serve.loadgen import RetryPolicy

    replicas = []
    for i, spec in enumerate(args.replica or []):
        addr, _, mux = spec.partition("/")
        host, _, port = addr.rpartition(":")
        if not host or not port.isdigit() or (mux and not mux.isdigit()):
            raise SystemExit(
                f"--replica must be host:port[/muxport], got {spec!r}"
            )
        replicas.append(Replica(
            replica_id=f"replica-{i}", host=host, port=int(port),
            mux_port=int(mux) if mux else None,
        ))
    if not replicas:
        raise SystemExit("pass at least one --replica host:port[/muxport]")

    if bool(args.tls_cert) != bool(args.tls_key):
        raise SystemExit("pass --tls-cert AND --tls-key together")
    backend_ssl = None
    if args.backend_cafile:
        from p2pmicrogrid_tpu_torch.serve import client_ssl_context

        backend_ssl = client_ssl_context(args.backend_cafile)
    tls = None
    if args.tls_cert:
        from p2pmicrogrid_tpu_torch.serve import server_ssl_context

        tls = server_ssl_context(args.tls_cert, args.tls_key)
    authenticator = router_token = None
    if args.auth_secret_file:
        from p2pmicrogrid_tpu_torch.serve import TokenAuthenticator

        # Rotation-aware (serve-token --rotate): verifies the dual-secret
        # chain, mints with the primary.
        authenticator = TokenAuthenticator.from_secret_file(
            args.auth_secret_file
        )
        # The router's own credential toward the replicas: the operator
        # wildcard (it probes /stats and pushes /admin/swap).
        router_token = authenticator.mint("*")

    router_tel = None
    if getattr(args, "results_db", None):
        # The standalone proxy binds its OWN warehouse shard (ROADMAP
        # item 4): at fleet scale the router's per-request counters and
        # fleet_stats events must not contend on a replica's WAL file.
        from p2pmicrogrid_tpu_torch.telemetry import (
            SqliteSink,
            Telemetry,
            run_manifest,
        )
        from p2pmicrogrid_tpu_torch.telemetry.registry import run_stamp

        shard_id = getattr(args, "shard_id", None) or "router"
        router_tel = Telemetry(
            run_id=f"serve-router-{run_stamp()}",
            sinks=[SqliteSink(args.results_db, shard_id=shard_id)],
            manifest=run_manifest(extra={"serve_role": "router"}),
        )

    router = FleetRouter(
        replicas,
        retry=RetryPolicy(
            max_attempts=args.retry_attempts,
            deadline_s=args.retry_deadline_s,
        ),
        ssl_context=backend_ssl,
        token=router_token,
        telemetry=router_tel,
    )
    proxy = RouterProxy(
        router, host=args.host, port=args.port,
        mux_port=getattr(args, "mux_port", None),
        tls=tls, authenticator=authenticator,
    )

    async def run() -> None:
        import os as _os

        host, port = await proxy.start()
        router.start_probing(args.probe_interval_s)
        print(
            json.dumps({
                "kind": "router_listening",
                "host": host,
                "port": port,
                "mux_port": proxy.mux_port,
                "tls": tls is not None,
                "auth": authenticator is not None,
                "pid": _os.getpid(),
                "replicas": [
                    {"replica_id": r.replica_id, "host": r.host,
                     "port": r.port, "mux_port": r.mux_port}
                    for r in replicas
                ],
            }),
            flush=True,
        )
        try:
            if args.serve_seconds > 0:
                await asyncio.sleep(args.serve_seconds)
            else:
                await asyncio.Event().wait()
        finally:
            router.stop_probing()
            await proxy.stop()

    try:
        asyncio.run(run())
    except KeyboardInterrupt:
        pass
    if args.stats_out:
        with open(args.stats_out, "w") as f:
            json.dump(router.fleet_stats(), f, indent=2)
        print(f"serve-router: stats -> {args.stats_out}", file=sys.stderr)
    if router_tel is not None:
        router_tel.close()
    return 0


def cmd_continual(args) -> int:
    """Continual training: warehouse serve traces -> candidate bundle.

    Closes the train half of the flywheel: exports the
    incumbent bundle's production decisions from the telemetry warehouse
    (``data/trace_export.py`` — refusing compacted runs loudly), warm-
    starts a learner from the incumbent's greedy parameters, fine-tunes
    off-policy on the traces and then through the chunk graph under
    the divergence guard with rollback (``train/continual.py``), and
    exports the result as a CANDIDATE bundle with a fresh config_hash.
    The candidate serves nothing until ``promote`` gates and ramps it.

    stdout carries one ``continual_result`` JSON metric row; telemetry
    (events + rollback counters) streams into ``--results-db``.
    """
    import os

    from p2pmicrogrid_tpu_torch.data.trace_export import export_serve_traces
    from p2pmicrogrid_tpu_torch.telemetry import SqliteSink, Telemetry, run_manifest
    from p2pmicrogrid_tpu_torch.telemetry.registry import run_stamp, set_current
    from p2pmicrogrid_tpu_torch.train.continual import train_continual
    from p2pmicrogrid_tpu_torch.train.resilience import GuardPolicy

    if not args.results_db:
        raise SystemExit("continual needs --results-db (the trace source)")
    if not args.bundle:
        raise SystemExit("pass --bundle (the incumbent bundle directory)")
    dev = _device(args.device)
    cfg = _build_cfg(args)
    # The operator-driven command speaks the same export/retention
    # handshake the autopilot does: --windowed exports from the last
    # released watermark under a lease (compaction cannot race it), and
    # --settlement attributes reward from billed warehouse rows with the
    # loud env-model fallback.
    import contextlib
    import time as _time2

    reward_fn = None
    if args.settlement:
        from p2pmicrogrid_tpu_torch.data.trace_export import settlement_reward_fn

        reward_fn = settlement_reward_fn(args.results_db, cfg, device=dev)
    since_ts = None
    scope = contextlib.nullcontext()
    if args.windowed:
        import sqlite3 as _sqlite3

        from p2pmicrogrid_tpu_torch.data.results import (
            ExportLeaseScope,
            last_export_watermark,
        )

        con = _sqlite3.connect(args.results_db)
        try:
            since_ts = last_export_watermark(con, args.config_hash)
        finally:
            con.close()
        # Shared choreography with the autopilot (ExportLeaseScope): a
        # failed export cancels the lease on exit instead of gating
        # retention for the TTL.
        scope = ExportLeaseScope(
            args.results_db, holder="continual-cli",
            window_start_ts=since_ts or 0.0,
            config_hash=args.config_hash,
        )
    with scope as lease_scope:
        dataset = export_serve_traces(
            args.results_db,
            config_hash=args.config_hash,
            cfg=cfg,
            reward_fn=reward_fn,
            min_transitions=args.min_transitions,
            since_ts=since_ts,
            device=dev,
        )
        if args.windowed:
            lease_scope.release(dataset.window_end_ts or _time2.time())
    print(
        f"continual: exported {dataset.n_transitions} transition(s) from "
        f"{dataset.n_decisions} decision(s) across "
        f"{len(dataset.run_ids)} run(s)",
        file=sys.stderr, flush=True,
    )
    tel = Telemetry(
        run_id=f"continual-{run_stamp()}",
        sinks=[SqliteSink(args.results_db)],
        manifest=run_manifest(cfg, extra={"continual": True}),
    )
    set_current(tel)
    out = args.out or os.path.join(
        "bundles", f"{_persist_setting(args, cfg)}-"
        f"{cfg.train.implementation}-continual"
    )
    ckpt_dir = os.path.join(
        args.model_dir, "continual", cfg.train.implementation
    )
    try:
        result = train_continual(
            cfg, args.bundle, dataset, out, ckpt_dir,
            n_episodes=args.episodes,
            n_chunks=args.chunks,
            eval_every=args.health_every,
            trace_steps=args.trace_steps,
            trace_batch=args.trace_batch,
            guard_policy=GuardPolicy(
                max_rollbacks=args.max_rollbacks, lr_drop=args.lr_drop
            ),
            telemetry=tel,
            dtype=args.dtype,
            pipeline=args.pipeline,
            generator=_generator(cfg.train.seed, dev),
            device=dev,
        )
    finally:
        set_current(None)
        tel.close()
    row = {
        "metric": "continual_result",
        "value": float(result.trace_steps),
        "unit": "trace_steps",
        "vs_baseline": 1.0,
        **result.summary(),
    }
    print(json.dumps(row), flush=True)
    print(
        f"continual: candidate -> {out} (config {result.candidate_hash}, "
        f"incumbent {result.incumbent_hash}, {len(result.rollbacks)} "
        "rollback(s))",
        file=sys.stderr, flush=True,
    )
    return 0


def cmd_promote(args) -> int:
    """Gated promotion + canary for a candidate bundle (serve/promotion.py).

    Default mode gates ``--candidate`` against ``--incumbent`` offline
    (held-out eval cost + reward-collapse guard + serve-bench SLO), then
    — unless ``--gate-only`` — ramps it through a live in-process gateway
    with the canary controller: percentage splits, per-stage warehouse
    cost/latency/error attribution, auto-rollback on regression. Every
    verdict lands as ``promotion`` events in ``--results-db``
    (``telemetry-query --promotions``).

    ``--inject all`` runs the seeded bad-candidate harness instead
    (crafted better / cost-regressed / NaN-poisoned / SLO-violating
    candidates through the full pipeline). stdout carries one JSON
    metric row per line; the LAST line is the headline.
    """
    import tempfile

    from p2pmicrogrid_tpu_torch.serve.promotion import (
        CanaryBudgets,
        GateBudgets,
        promotion_bench,
        run_promotion_gate,
        run_promotion_pipeline,
    )
    from p2pmicrogrid_tpu_torch.telemetry import (
        SqliteSink,
        Telemetry,
        guarded_stdout_sink,
        run_manifest,
    )
    from p2pmicrogrid_tpu_torch.telemetry.registry import run_stamp

    dev = _device(args.device)
    cfg = _build_cfg(args)
    stages = tuple(float(s) for s in args.stages.split(","))
    gate_budgets = GateBudgets(
        cost_margin=args.cost_margin,
        max_reward_drop=args.max_reward_drop,
        slo_p95_ms=args.slo_p95_ms,
        slo_p99_ms=args.slo_p99_ms,
        max_shed_rate=args.max_shed_rate,
        max_regime_regression=getattr(args, "max_regime_regression", 0.0),
    )
    canary_budgets = CanaryBudgets(
        max_cost_regression=args.max_cost_regression,
        slo_p95_ms=args.canary_p95_ms,
        min_requests=args.canary_min_requests,
    )
    out_f = open(args.out, "a") if args.out else None
    tel = Telemetry(
        run_id=f"promote-{run_stamp()}",
        sinks=[SqliteSink(args.results_db)] if args.results_db else [],
        manifest=run_manifest(cfg, extra={"serve_role": "promotion"}),
    )
    try:
        with guarded_stdout_sink() as sink:
            def emit(row: dict) -> None:
                sink.emit(row)
                tel.emit(row)
                if out_f is not None:
                    out_f.write(json.dumps(row) + "\n")
                    out_f.flush()

            if args.inject:
                if getattr(args, "regimes", None):
                    # The seeded harness crafts its own candidates per
                    # case; silently dropping the per-regime rail would
                    # misreport what was exercised — refuse loudly.
                    print(
                        "--inject and --regimes cannot combine (the seeded "
                        "harness does not run the per-regime gate); drop "
                        "one",
                        file=sys.stderr,
                    )
                    return 2
                cases = (
                    ("good", "cost_regressed", "nan_poisoned",
                     "slo_violating")
                    if args.inject == "all" else (args.inject,)
                )
                work = args.work_dir or tempfile.mkdtemp(
                    prefix="p2p-promotion-"
                )
                promotion_bench(
                    cfg, work,
                    cases=cases,
                    seed=args.seed,
                    requests_per_stage=args.requests_per_stage,
                    n_households=args.households,
                    stages=stages,
                    results_db=args.results_db,
                    telemetry=tel,
                    emit=emit,
                    gate_budgets=gate_budgets,
                    canary_budgets=canary_budgets,
                    device=dev,
                )
                return 0
            if not args.candidate or not args.incumbent:
                raise SystemExit(
                    "pass --candidate and --incumbent bundle dirs "
                    "(or --inject for the seeded harness)"
                )
            if args.gate_only:
                verdict = run_promotion_gate(
                    cfg, args.candidate, args.incumbent,
                    budgets=gate_budgets, telemetry=tel,
                    bench_seed=args.seed, max_batch=args.max_batch,
                    regime_specs=(
                        [r for r in args.regimes.split(",") if r]
                        if getattr(args, "regimes", None) else None
                    ),
                    device=dev,
                )
                emit({
                    "metric": "promotion_gate",
                    "value": 1.0 if verdict.passed else 0.0,
                    "unit": "pass",
                    "vs_baseline": 1.0 if verdict.passed else 0.0,
                    "gate_verdict": verdict.verdict,
                    **verdict.to_fields(),
                })
                return 0 if verdict.passed else 1
            fields = run_promotion_pipeline(
                cfg, args.candidate, args.incumbent,
                gate_budgets=gate_budgets,
                canary_budgets=canary_budgets,
                stages=stages,
                results_db=args.results_db,
                telemetry=tel,
                seed=args.seed,
                requests_per_stage=args.requests_per_stage,
                n_households=args.households,
                skip_gate=args.skip_gate,
                max_batch=args.max_batch,
                regime_specs=(
                    [r for r in args.regimes.split(",") if r]
                    if getattr(args, "regimes", None) else None
                ),
                batching=getattr(args, "batching", "continuous"),
                device=dev,
            )
            emit({
                "metric": "promotion_case",
                "value": float(fields.get("availability", 1.0)),
                "unit": "availability",
                "vs_baseline": 1.0 if fields.get("promoted") else 0.0,
                "case": "operator",
                **fields,
            })
            return 0 if fields.get("promoted") else 1
    finally:
        tel.close()
        if out_f is not None:
            out_f.close()


def cmd_regime_bench(args) -> int:
    """Regime-portfolio acceptance harness (regimes/bench.py).

    Trains a mixed batch of >= 4 regimes through ONE episode function over
    fixed regime tensors (one chunk graph on the card), prints
    the per-regime eval table for the train set and a held-out set, runs
    the gate case (a crafted candidate that improves mean cost but
    regresses a held-out regime MUST be blocked by the regime-aware
    gate), and closes with the ``regime_generalization`` headline row —
    one JSON metric row per stdout line through the guarded sink. With
    ``--results-db`` the per-regime ``regime_eval`` events also land in
    the warehouse (``telemetry-query --regimes``).
    """
    from p2pmicrogrid_tpu_torch.regimes.bench import bench_config, run_regime_bench
    from p2pmicrogrid_tpu_torch.telemetry import (
        SqliteSink,
        Telemetry,
        guarded_stdout_sink,
    )
    from p2pmicrogrid_tpu_torch.telemetry.registry import run_manifest, run_stamp

    dev = _device(args.device)
    train_regimes = [r for r in args.train_regimes.split(",") if r]
    held_out = [r for r in args.held_out_regimes.split(",") if r]
    # The cfg run_regime_bench trains under (one builder, no drift) — so
    # the warehouse run carries the config_hash the --regimes view
    # groups by.
    cfg = bench_config(
        args.agents,
        args.scenarios_per_regime * len(train_regimes),
        args.implementation,
        args.seed,
    )
    out_f = open(args.out, "a") if args.out else None
    tel = Telemetry(
        run_id=f"regime-bench-{run_stamp()}",
        sinks=[SqliteSink(args.results_db)] if args.results_db else [],
        manifest=run_manifest(cfg, extra={"serve_role": "regime-bench"}),
    )
    try:
        with guarded_stdout_sink() as sink:
            def emit(row: dict) -> None:
                sink.emit(row)
                tel.emit(row)
                if out_f is not None:
                    out_f.write(json.dumps(row) + "\n")
                    out_f.flush()

            rows = run_regime_bench(
                train_regimes=train_regimes,
                held_out_regimes=held_out,
                n_agents=args.agents,
                scenarios_per_regime=args.scenarios_per_regime,
                episodes=args.episodes,
                s_eval_per_regime=args.eval_scenarios,
                implementation=args.implementation,
                seed=args.seed,
                telemetry=tel if args.results_db else None,
                gate_case=not args.no_gate_case,
                emit=emit,
                device=dev,
            )
        headline = rows[-1]
        ok = bool(headline.get("single_compile")) and (
            args.no_gate_case
            or bool(headline.get("gate_blocked_regime_regression"))
        )
        return 0 if ok else 1
    finally:
        tel.close()
        if out_f is not None:
            out_f.close()


def cmd_autopilot(args) -> int:
    """The operator-less continual-deployment supervisor (serve/autopilot.py).

    Daemon mode (``--replica`` ...): run retrain->gate->canary cycles on a
    cadence against a live fleet through the router, journaling every
    phase crash-safely under ``--state-dir`` — SIGKILL it at any instant
    and the same command line recovers (resume or abort-to-incumbent).
    ``--bench`` runs the acceptance harness instead: a real
    3-replica ``ProcessFleet``, chaos replica kill, injected bad
    candidates and a mid-cycle SIGKILL of the autopilot itself.

    The gate's and the serving check's engines run on ``--serve-device``
    (``auto``, the default, follows ``--device``: the card), which must
    be the fleet's serve device for the bit-exact serving check; the
    ``--bench`` fleet's children serve there too.
    """
    import os
    import tempfile

    from p2pmicrogrid_tpu_torch.serve.autopilot import (
        Autopilot,
        autopilot_bench,
        parse_inject_plan,
    )
    from p2pmicrogrid_tpu_torch.telemetry import guarded_stdout_sink

    dev = _serve_device(args)
    cfg = _build_cfg(args)
    out_f = open(args.out, "a") if args.out else None
    try:
        with guarded_stdout_sink() as sink:
            def emit(row: dict) -> None:
                sink.emit(row)
                if out_f is not None:
                    out_f.write(json.dumps(row) + "\n")
                    out_f.flush()

            if args.bench:
                work = args.work_dir or tempfile.mkdtemp(
                    prefix="p2p-autopilot-"
                )
                # The child autopilot must build the SAME experiment
                # config this process did — forward the cfg flags.
                extra = [
                    "--agents", str(args.agents),
                    "--implementation", args.implementation,
                    "--episodes", str(args.episodes),
                    "--rounds", str(args.rounds),
                ]
                if args.homogeneous:
                    extra.append("--homogeneous")
                if args.no_trading:
                    extra.append("--no-trading")
                rows = autopilot_bench(
                    cfg, work,
                    n_replicas=args.replicas,
                    n_cycles=args.cycles,
                    inject=args.inject or
                    "0:good,1:cost_regressed,2:nan_poisoned",
                    seed=args.seed,
                    chaos=args.chaos,
                    sigkill_phase=args.sigkill_phase or None,
                    sigkill_cycle=args.sigkill_cycle,
                    requests_per_cycle=args.requests_per_cycle,
                    canary_requests=args.canary_requests,
                    n_households=args.households,
                    stages=args.stages,
                    emit=emit,
                    extra_cfg_args=extra,
                    device=dev,
                )
                headline = rows[-1]
                return 0 if headline.get("all_safe") else 1

            # Daemon mode: a live fleet on the other side of --replica.
            from p2pmicrogrid_tpu_torch.serve import FleetRouter, Replica
            from p2pmicrogrid_tpu_torch.serve.loadgen import RetryPolicy
            from p2pmicrogrid_tpu_torch.serve.promotion import (
                CanaryBudgets,
                GateBudgets,
            )
            from p2pmicrogrid_tpu_torch.telemetry import (
                SqliteSink,
                Telemetry,
                run_manifest,
            )
            from p2pmicrogrid_tpu_torch.telemetry.registry import run_stamp

            if not args.results_db:
                raise SystemExit(
                    "autopilot needs --results-db (traces + attribution)"
                )
            if not args.state_dir:
                raise SystemExit("autopilot needs --state-dir (the journal)")
            replicas = []
            for i, spec in enumerate(args.replica or []):
                # host:port[/muxport] (serve-router style) or
                # host:port[:muxport].
                parts = spec.replace("/", ":").split(":")
                if len(parts) < 2 or not parts[1].isdigit():
                    raise SystemExit(
                        f"--replica must be host:port[/muxport], got {spec!r}"
                    )
                replicas.append(Replica(
                    replica_id=f"replica-{i}", host=parts[0],
                    port=int(parts[1]),
                    mux_port=(
                        int(parts[2])
                        if len(parts) > 2 and parts[2].isdigit() else None
                    ),
                ))
            if not replicas:
                raise SystemExit(
                    "pass at least one --replica host:port[/muxport] "
                    "(or --bench)"
                )
            router_token = None
            if args.auth_secret_file:
                from p2pmicrogrid_tpu_torch.serve import TokenAuthenticator

                router_token = TokenAuthenticator.from_secret_file(
                    args.auth_secret_file
                ).mint("*")
            router = FleetRouter(
                replicas,
                retry=RetryPolicy(
                    max_attempts=args.retry_attempts,
                    deadline_s=args.retry_deadline_s,
                ),
                token=router_token,
            )
            hold_s = {}
            hold_env = os.environ.get("P2P_AUTOPILOT_HOLD")
            if hold_env:
                # The crash harness's deterministic kill window: sleep
                # this long right after journaling the named phase.
                hold_s = {
                    str(k): float(v)
                    for k, v in json.loads(hold_env).items()
                }
            tel = Telemetry(
                run_id=f"autopilot-{run_stamp()}",
                sinks=[SqliteSink(args.results_db)],
                manifest=run_manifest(
                    cfg, extra={"autopilot_role": "supervisor"}
                ),
            )
            router.telemetry = tel
            stages = tuple(float(s) for s in args.stages.split(","))
            pilot = Autopilot(
                cfg,
                router,
                incumbent_dir=args.incumbent,
                state_dir=args.state_dir,
                results_db=args.results_db,
                telemetry=tel,
                gate_budgets=GateBudgets(
                    cost_margin=args.cost_margin,
                    max_reward_drop=args.max_reward_drop,
                    slo_p95_ms=args.slo_p95_ms,
                    slo_p99_ms=args.slo_p99_ms,
                ),
                canary_budgets=CanaryBudgets(
                    max_cost_regression=args.max_cost_regression,
                    slo_p95_ms=args.canary_p95_ms,
                    min_requests=args.canary_min_requests,
                ),
                stages=stages,
                requests_per_cycle=args.requests_per_cycle,
                canary_requests=args.canary_requests,
                n_households=args.households,
                rate_hz=args.rate_hz,
                seed=args.seed,
                trace_steps=args.trace_steps,
                sim_episodes=args.sim_episodes,
                settlement=args.settlement,
                min_transitions=args.min_transitions,
                max_batch=args.max_batch,
                emit=emit,
                hold_s=hold_s,
                verify_serving=args.verify_serving,
                serve_device=dev,
            )
            router.start_probing(args.probe_interval_s)
            try:
                state = pilot.run(
                    args.cycles,
                    cadence_s=args.cadence_s,
                    inject_plan=parse_inject_plan(args.inject),
                )
            finally:
                router.stop_probing()
                tel.close()
            summary = pilot.summary_row()
            emit(summary)
            return 0 if state.bad_promotions == 0 else 1
    finally:
        if out_f is not None:
            out_f.close()


def cmd_telemetry_report(args) -> int:
    """Render a telemetry run directory (see telemetry/registry.py for the
    layout) into a plain-text summary: manifest provenance, event counts,
    health trajectory, device-counter totals and span timings."""
    from p2pmicrogrid_tpu_torch.telemetry.report import (
        compare_runs,
        latest_run_dir,
        render_run,
    )

    if getattr(args, "perfetto", None):
        # Merged Chrome-trace (Perfetto-loadable) export of ONE
        # distributed trace: spans pulled by trace_id from every given
        # warehouse DB (one per fleet segment, or one shared), merged,
        # one pid lane per recorded process.
        import sqlite3

        from p2pmicrogrid_tpu_torch.data.results import TRACE_TREE_SQL
        from p2pmicrogrid_tpu_torch.telemetry.report import chrome_trace_export

        spans = []
        for db in args.trace_db or []:
            try:
                con = sqlite3.connect(f"file:{db}?mode=ro", uri=True)
            except sqlite3.Error as err:
                print(f"cannot open {db}: {err}", file=sys.stderr)
                return 1
            try:
                cur = con.execute(TRACE_TREE_SQL, (args.perfetto,))
                cols = [d[0] for d in cur.description]
                for r in cur.fetchall():
                    s = dict(zip(cols, r))
                    s["attrs"] = json.loads(s.pop("attrs_json") or "{}")
                    spans.append(s)
            except sqlite3.Error as err:
                print(f"SQL error in {db}: {err}", file=sys.stderr)
                return 1
            finally:
                con.close()
        if not spans:
            print(
                f"no spans for trace {args.perfetto} in "
                f"{args.trace_db or []}",
                file=sys.stderr,
            )
            return 1
        # De-dup identical spans double-written to multiple DBs.
        unique = {}
        for s in spans:
            unique.setdefault((s.get("span_id"), s.get("run_id")), s)
        doc = chrome_trace_export(list(unique.values()))
        out = getattr(args, "out", None)
        if out:
            with open(out, "w") as f:
                json.dump(doc, f)
            print(
                f"wrote {len(doc['traceEvents'])} event(s) to {out} "
                "(open in Perfetto / chrome://tracing)",
                file=sys.stderr,
            )
        else:
            print(json.dumps(doc))
        return 0

    if getattr(args, "compare", None):
        a, b = args.compare
        for d in (a, b):
            if not os.path.isdir(d):
                print(f"not a telemetry run directory: {d}", file=sys.stderr)
                return 1
        print(compare_runs(a, b), end="")
        return 0

    run_dir = args.run
    if run_dir is None:
        root = (
            args.runs_root
            or os.environ.get("P2P_TELEMETRY_DIR")
            or os.path.join("artifacts", "runs")
        )
        run_dir = latest_run_dir(root)
        if run_dir is None:
            print(f"no telemetry runs found under {root}", file=sys.stderr)
            return 1
    if not os.path.isdir(run_dir):
        print(f"not a telemetry run directory: {run_dir}", file=sys.stderr)
        return 1
    print(render_run(run_dir), end="")
    return 0


def _watch_telemetry_join(con, args) -> int:
    """``telemetry-query --watch``: tail mode over the warehouse join.

    Polls the config-hash join every ``--interval`` seconds and streams
    rows as JSON lines as they appear or CHANGE (a run's point/gauge counts
    grow while its training streams, so an updated join row re-emits with
    the fresh counts). Missing warehouse tables (the DB predates its first
    SqliteSink write) read as empty and polling continues. Runs until
    interrupted, or for ``--max-polls`` polls when set (0 = forever).
    """
    import sqlite3
    import time as _time

    from p2pmicrogrid_tpu_torch.data.results import TELEMETRY_JOIN_SQL

    # Keyed by join identity, storing only the LAST emitted serialization
    # per (telemetry run, eval row) pair — a forever-tail stays bounded by
    # the number of distinct joined pairs, not by how often their
    # point/gauge counts tick.
    last_emitted: dict = {}
    polls = 0
    try:
        while True:
            try:
                cur = con.execute(TELEMETRY_JOIN_SQL)
                cols = [d[0] for d in cur.description]
                rows = [dict(zip(cols, r)) for r in cur.fetchall()]
            except sqlite3.OperationalError as err:
                # Pre-warehouse DB (tables not created yet): keep polling
                # until the first SqliteSink write creates them.
                if "no such table" not in str(err):
                    print(f"SQL error: {err}", file=sys.stderr)
                    return 1
                rows = []
            except sqlite3.Error as err:
                # A corrupted/non-database file must not spin silently.
                print(f"SQL error: {err}", file=sys.stderr)
                return 1
            for row in rows:
                row_key = (
                    row.get("run_id"), row.get("eval_setting"),
                    row.get("implementation"), row.get("is_testing"),
                )
                line = json.dumps(row, sort_keys=True, default=float)
                if last_emitted.get(row_key) != line:
                    last_emitted[row_key] = line
                    print(line, flush=True)
            polls += 1
            if args.max_polls and polls >= args.max_polls:
                return 0
            _time.sleep(max(args.interval, 0.0))
    except KeyboardInterrupt:
        return 0


def cmd_telemetry_query(args) -> int:
    """Query the SQLite telemetry warehouse.

    Default query: the config-hash join — every (telemetry run, eval run)
    pair sharing a ``config_hash``, with the run's point/gauge counts and
    the eval's total cost; ``--gauges`` inlines each joined run's gauge
    points (profiles, throughput, replay saturation). ``--sql`` runs
    arbitrary read-only SQL instead. ``--watch`` polls the join and streams
    new/updated rows as they land (tail mode). Output: one JSON object per
    row (machine-greppable, like the bench suites).
    """
    import sqlite3

    from p2pmicrogrid_tpu_torch.data.results import (
        TELEMETRY_JOIN_SQL,
        TELEMETRY_SCHEMA_VERSION,
    )

    shards = list(getattr(args, "shards", None) or [])
    if not shards and not args.results_db:
        print(
            "pass --results-db and/or at least one --shard",
            file=sys.stderr,
        )
        return 2
    if shards and getattr(args, "compact", False):
        print(
            "--compact and --shard cannot combine: compaction rewrites "
            "ONE real warehouse in place, but the federated view is an "
            "in-memory merge — compact each shard's --results-db "
            "directly",
            file=sys.stderr,
        )
        return 2
    if shards and getattr(args, "watch", False):
        print(
            "--watch and --shard cannot combine: the federated view is "
            "a point-in-time merge, so a tail over it would never see "
            "new rows — watch one shard, or re-run the merge",
            file=sys.stderr,
        )
        return 2

    if getattr(args, "compact", False):
        # Retention pass (the ONE write mode this command has): roll
        # per-request serve telemetry older than the window into
        # per-bucket aggregates so a long-running gateway's warehouse
        # stays bounded. Opens read-write, on an existing DB only.
        from p2pmicrogrid_tpu_torch.data.results import compact_serve_telemetry

        if not os.path.exists(args.results_db):
            print(f"no such results DB: {args.results_db}", file=sys.stderr)
            return 1
        con = sqlite3.connect(args.results_db)
        try:
            try:
                summary = compact_serve_telemetry(
                    con, older_than_s=args.older_than_hours * 3600.0
                )
            except sqlite3.OperationalError as err:
                if "no such table" in str(err):
                    summary = {"rows_compacted": 0, "aggregates_written": 0}
                else:
                    print(f"SQL error: {err}", file=sys.stderr)
                    return 1
            except sqlite3.Error as err:
                print(f"SQL error: {err}", file=sys.stderr)
                return 1
            print(
                json.dumps(
                    {
                        "compacted": summary,
                        "older_than_hours": args.older_than_hours,
                        "results_db": args.results_db,
                    }
                )
            )
            return 0
        finally:
            con.close()

    if shards:
        # Federated view: merge every shard (plus --results-db when also
        # given) into an in-memory warehouse and run the SAME view SQL
        # against it. All warehouse tables carry natural primary keys, so
        # the INSERT OR IGNORE merge is idempotent, and the source files
        # are opened read-only and never touched.
        from p2pmicrogrid_tpu_torch.data.results import merge_warehouse_shards

        sources = (
            [args.results_db] if args.results_db else []
        ) + shards
        missing = [s for s in sources if not os.path.exists(s)]
        if missing:
            print(
                f"no such shard file(s): {', '.join(missing)}",
                file=sys.stderr,
            )
            return 1
        con = sqlite3.connect(":memory:")
        try:
            merge_stats = merge_warehouse_shards(con, sources)
        except sqlite3.Error as err:
            print(f"shard merge failed: {err}", file=sys.stderr)
            con.close()
            return 1
        print(
            json.dumps({"federated": merge_stats, "sources": sources}),
            file=sys.stderr,
        )
    else:
        # Read-only open: querying must never create a DB, run
        # migrations, or let --sql mutate the warehouse.
        try:
            con = sqlite3.connect(
                f"file:{args.results_db}?mode=ro", uri=True
            )
        except sqlite3.Error as err:
            print(
                f"cannot open {args.results_db}: {err}", file=sys.stderr
            )
            return 1

    def select(sql, params=()):
        cur = con.execute(sql, params)
        cols = [d[0] for d in cur.description] if cur.description else []
        return [dict(zip(cols, r)) for r in cur.fetchall()]

    if getattr(args, "watch", False):
        if (
            getattr(args, "fleet", False)
            or getattr(args, "rollbacks", False)
            or getattr(args, "promotions", False)
            or getattr(args, "regimes", False)
            or getattr(args, "continuous", False)
        ):
            # Silently tailing the EVAL join when the user asked for the
            # fleet/rollback/promotion/regime/continuous view would stream
            # unrelated rows; refuse loudly.
            which = (
                "--fleet" if getattr(args, "fleet", False)
                else "--rollbacks" if getattr(args, "rollbacks", False)
                else "--promotions" if getattr(args, "promotions", False)
                else "--regimes" if getattr(args, "regimes", False)
                else "--continuous"
            )
            print(
                f"{which} and --watch cannot combine (the watch tails the "
                "eval join); drop one",
                file=sys.stderr,
            )
            con.close()
            return 2
        try:
            return _watch_telemetry_join(con, args)
        finally:
            con.close()
    try:
        if args.sql:
            rows = select(args.sql)
        elif getattr(args, "trace", None):
            from p2pmicrogrid_tpu_torch.data.results import TRACE_TREE_SQL
            from p2pmicrogrid_tpu_torch.telemetry.report import (
                render_trace_tree,
                trace_critical_path,
            )

            spans = select(TRACE_TREE_SQL, (args.trace,))
            for s in spans:
                s["attrs"] = json.loads(s.pop("attrs_json") or "{}")
            if not spans:
                print(f"no spans for trace {args.trace}", file=sys.stderr)
                return 1
            print(render_trace_tree(spans))
            cp = trace_critical_path(spans)
            if cp is not None:
                print(json.dumps({"critical_path": cp}, default=float))
            return 0
        elif getattr(args, "slowest", None):
            from p2pmicrogrid_tpu_torch.data.results import SLOWEST_TRACES_SQL

            rows = select(SLOWEST_TRACES_SQL, (args.slowest,))
        elif getattr(args, "fleet", False):
            from p2pmicrogrid_tpu_torch.data.results import FLEET_VIEW_SQL

            rows = select(FLEET_VIEW_SQL)
        elif getattr(args, "rollbacks", False):
            from p2pmicrogrid_tpu_torch.data.results import ROLLBACK_VIEW_SQL

            rows = select(ROLLBACK_VIEW_SQL)
        elif getattr(args, "regimes", False):
            from p2pmicrogrid_tpu_torch.data.results import REGIME_VIEW_SQL

            rows = select(REGIME_VIEW_SQL)
        elif getattr(args, "continuous", False):
            from p2pmicrogrid_tpu_torch.data.results import CONTINUOUS_VIEW_SQL

            rows = select(CONTINUOUS_VIEW_SQL)
        elif getattr(args, "promotions", False):
            from p2pmicrogrid_tpu_torch.data.results import (
                PROMOTION_VIEW_SQL,
                promotion_lineage,
            )

            rows = select(PROMOTION_VIEW_SQL)
            # The ancestry chain of promotions (incumbent -> candidate ->
            # candidate²): one extra row AFTER the per-candidate verdicts,
            # with the rendered chain (None marks a segment break between
            # parallel histories).
            lineage = promotion_lineage(con)
            if lineage["links"]:
                chain = lineage["chain"]
                rows.append({
                    "lineage": chain,
                    "rendered": " -> ".join(
                        h if h is not None else "|" for h in chain
                    ),
                    "links": lineage["links"],
                })
        else:
            rows = select(TELEMETRY_JOIN_SQL)
            if args.gauges:
                for row in rows:
                    row["gauges"] = {
                        g["name"]: g["value"]
                        for g in select(
                            "SELECT name, value FROM telemetry_points "
                            "WHERE run_id = ? AND kind = 'gauge' "
                            "AND name IS NOT NULL ORDER BY seq",
                            (row["run_id"],),
                        )
                    }
        for row in rows:
            print(json.dumps(row, default=float))
        if not rows and not args.sql:
            (n_runs,) = con.execute(
                "SELECT COUNT(*) FROM telemetry_runs"
            ).fetchone()
            (n_evals,) = con.execute(
                "SELECT COUNT(*) FROM eval_runs"
            ).fetchone()
            print(
                f"no joined rows: {n_runs} telemetry run(s), {n_evals} eval "
                f"run(s), no config_hash overlap (schema v"
                f"{TELEMETRY_SCHEMA_VERSION}). Train with --results-db to "
                "stream telemetry; eval with --results-db to register the "
                "join anchor.",
                file=sys.stderr,
            )
    except sqlite3.Error as err:
        # Covers bad --sql, a pre-warehouse DB (no telemetry tables), and
        # write attempts through --sql (readonly database).
        print(f"SQL error: {err}", file=sys.stderr)
        return 1
    finally:
        con.close()
    return 0


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--agents", type=int, default=2)
    p.add_argument("--rounds", type=int, default=1)
    p.add_argument("--homogeneous", action="store_true")
    p.add_argument("--no-trading", action="store_true", dest="no_trading",
                   help="no-com community: no P2P negotiation or trading")
    p.add_argument("--battery", action="store_true")
    p.add_argument("--implementation",
                   choices=["tabular", "dqn", "ddpg", "ddpg_recurrent"],
                   default="tabular",
                   help="policy class; ddpg_recurrent (the day-granular "
                        "LSTM actor) trains via train-recurrent and serves "
                        "only through session-carrying continuous batching")
    p.add_argument("--episodes", type=int, default=1000)
    p.add_argument("--save-episodes", type=int, default=None,
                   dest="save_episodes",
                   help="checkpoint cadence in episodes (default 50, the "
                        "reference's setup.py:32); the crash-exposure "
                        "window — a preemption loses at most this many "
                        "episodes of work (README 'Resilient training')")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--db", help="reference SQLite measurement DB (default: synthetic)")
    p.add_argument("--results-db", help="SQLite results store path")
    p.add_argument("--model-dir", default="./models")
    p.add_argument("--timing-json", dest="timing_json",
                   help="append per-setting wall-clock times to this JSON file")
    _add_device(p)


def _add_device(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", choices=["cuda", "cpu", "default", "auto"],
                   default="cuda",
                   help="cuda (default; 'default' is the same): run on the "
                        "card, exiting non-zero without one; 'cpu' runs on "
                        "the CPU; 'auto' (crossover placement) waits for a "
                        "crossover measured on the card (ROADMAP.md, Queue "
                        "1, item 8) and exits non-zero")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="p2pmicrogrid-tpu-torch", description=__doc__)
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("train", help="train a community")
    _add_common(p)
    p.add_argument("--jit-block", type=int, default=1, dest="jit_block")
    p.add_argument("--scenarios", type=int, default=1,
                   help="N>1: Monte-Carlo scenario-batched training")
    p.add_argument("--shared", action="store_true",
                   help="with --scenarios: one shared learner with per-slot "
                        "scenario-averaged updates (default: S independent)")
    p.add_argument("--chunks", type=int, default=1,
                   help="with --scenarios N --shared: train K*N aggregate "
                        "scenarios per episode — K chunks replay one "
                        "captured N-scenario program (a CUDA graph on the "
                        "card) with traces made on the device and "
                        "chunk-averaged parameter deltas (the 10k-scenario "
                        "north-star mode)")
    p.add_argument("--chunk-parallel", type=int, default=1,
                   dest="chunk_parallel", metavar="C",
                   help="with --chunks K: run C chunks side by side; only "
                        "C=1 is ported (ROADMAP.md, Queue 1, item 13: "
                        "other values raise)")
    p.add_argument("--share-agents", action="store_true", dest="share_agents",
                   help="ddpg + --shared: ONE actor-critic for the whole "
                        "community (shared-critic MARL) instead of per-agent "
                        "copies")
    p.add_argument("--health-every", type=int, default=10, dest="health_every",
                   metavar="N",
                   help="with --scenarios --shared: run the greedy held-out "
                        "health eval every N episodes, logging greedy cost "
                        "AND reward (the don't-heat basin shows as reward "
                        "collapse while cost falls — cost-only logging is "
                        "blind to it; train/health.py). 0 disables. "
                        "Default 10.")
    p.add_argument("--basin-mitigate", choices=["auto", "warn", "lr-boost"],
                   default="auto", dest="basin_mitigate",
                   help="on basin detection: 'lr-boost' trains through an "
                        "episode program with the effective lrs boosted "
                        "until the greedy policy recovers; 'warn' alerts "
                        "only; 'auto' (default) is lr-boost for chunked "
                        "ddpg and warn elsewhere (see README basin notes)")
    p.add_argument("--actor-lr", type=float, dest="actor_lr",
                   help="DDPG actor learning rate (default 1e-4, scaled "
                        "automatically with the pooled shared-update batch "
                        "— sqrt(400/(batch*S*A)); passing an explicit "
                        "value pins it exactly and disables the rule)")
    p.add_argument("--critic-lr", type=float, dest="critic_lr",
                   help="DDPG critic learning rate (default 2e-4; see "
                        "--actor-lr)")
    p.add_argument("--learn-batch-cap", type=_nonneg_int,
                   dest="learn_batch_cap",
                   help="max transitions per agent-shared pooled DDPG update "
                        "(default 32768): larger pools are subsampled "
                        "uniformly from the replay rings while the lr rule "
                        "keys on the capped batch; 0 disables (full pooled "
                        "update)")
    p.add_argument("--market-dtype",
                   choices=["auto", "float32", "bfloat16"],
                   default="auto", dest="market_dtype",
                   help="storage dtype of the batched negotiation matrices; "
                        "auto (default) = bfloat16 on the card at >=256 "
                        "agents (halves their memory traffic; compute stays "
                        "f32), float32 elsewhere")
    p.add_argument("--market-impl",
                   choices=["auto", "matrix", "factored"],
                   default="auto", dest="market_impl",
                   help="negotiation/clearing implementation for scenario-"
                        "batched runs: 'factored' clears the one-round "
                        "market from O(A) vectors (no [S,A,A] matrices, "
                        "ops/factored_market.py); auto (default) uses it "
                        "wherever it applies on the card (trading, "
                        "rounds<=1), the matrix path elsewhere")
    p.add_argument("--resume", action="store_true",
                   help="restore the latest checkpoint for this setting and "
                        "continue the episode/decay schedule from there")
    p.add_argument("--profile-dir", dest="profile_dir",
                   help="write a torch.profiler trace (Chrome-trace JSON) "
                        "of the training run here")
    p.add_argument("--pipeline", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="async episode pipeline (default on): launch "
                        "episode e+1 before reading back episode e's "
                        "metrics — the same final policy state, no "
                        "per-episode host round trip; --no-pipeline is the "
                        "synchronous escape hatch")
    p.add_argument("--supervise", action="store_true",
                   help="crash supervisor: run training as a child process "
                        "(python -m p2pmicrogrid_tpu_torch) and relaunch it "
                        "on crash with capped backoff, appending --resume so "
                        "it continues from the newest verified checkpoint")
    p.add_argument("--max-restarts", type=_nonneg_int, default=8,
                   dest="max_restarts",
                   help="--supervise: give up after this many relaunches "
                        "(default 8)")
    p.add_argument("--resilience-out", dest="resilience_out",
                   help="append resilience metric rows (supervise attempts, "
                        "rollbacks, the train_supervised headline) to this "
                        "JSONL capture")
    p.add_argument("--verify-uninterrupted", action="store_true",
                   dest="verify_uninterrupted",
                   help="--supervise: after the supervised run completes, "
                        "run the SAME training uninterrupted into "
                        "<model-dir>_uninterrupted and report bit_exact = "
                        "(final checkpoint digests match) in the headline")
    p.add_argument("--fault-plan", dest="fault_plan",
                   help="JSON train-fault plan (train/faults.py): "
                        "kill-at-episode, corrupt-checkpoint, stall-callback, "
                        "poison-NaN — all deterministic, attempt-scoped")
    p.add_argument("--fault-seed", type=int, dest="fault_seed",
                   help="generate a deterministic kill plan from this seed "
                        "(SIGKILL at a seed-derived episode, once per "
                        "supervisor attempt; see --fault-kills)")
    p.add_argument("--fault-kills", type=_nonneg_int, default=1,
                   dest="fault_kills",
                   help="--fault-seed: number of kills in the generated "
                        "plan (the k-th fires on supervisor attempt k; "
                        "default 1)")
    p.add_argument("--max-rollbacks", type=_nonneg_int, default=0,
                   dest="max_rollbacks",
                   help="divergence rollback budget: watch the device "
                        "counters' nonfinite q/loss counts and, on trip, "
                        "restore the last verified checkpoint with the "
                        "effective lrs dropped and a fresh random branch, "
                        "up to this many times (0 = off; "
                        "train/resilience.py)")
    p.add_argument("--lr-drop", type=float, default=0.5, dest="lr_drop",
                   help="rollback perturbation: effective lrs x this "
                        "factor per rollback (default 0.5)")
    p.add_argument("--keep-checkpoints", type=int, default=2,
                   dest="keep_checkpoints",
                   help="checkpoint steps to keep on disk (default 2: the "
                        "newest plus one verified fallback for corrupt-step "
                        "recovery)")
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser(
        "single",
        help="standalone single-home training + thermostat comparison "
             "(the reference's hand-rolled single-agent harness, "
             "rl.py:362-488)",
    )
    _add_common(p)
    p.add_argument("--jit-block", type=int, default=1, dest="jit_block")
    p.add_argument("--scenarios", type=int, default=1,
                   help="N>1: scenario-batched single-home training "
                        "(sample-efficient on small hardware budgets)")
    p.add_argument("--shared", action="store_true",
                   help="with --scenarios: one shared learner over scenarios")
    p.add_argument("--test", action="store_true",
                   help="compare on test days (default: validation)")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--pipeline", action=argparse.BooleanOptionalAction,
                   default=True, help="see train --pipeline")
    p.set_defaults(fn=cmd_single, scenario_index=0)

    p = sub.add_parser("multi", help="multi-community training with "
                                     "inter-community trading")
    _add_common(p)
    p.add_argument("--communities", type=int, default=8)
    p.add_argument("--resume", action="store_true",
                   help="restore the latest checkpoint for this setting and "
                        "continue from there")
    p.add_argument("--pipeline", action=argparse.BooleanOptionalAction,
                   default=True, help="see train --pipeline")
    p.set_defaults(fn=cmd_multi)

    p = sub.add_parser("eval", help="evaluate a trained community per day")
    _add_common(p)
    p.add_argument("--test", action="store_true", help="test days (default: validation)")
    p.add_argument("--scenarios", type=int, default=1,
                   help="locate the checkpoint of a --scenarios N training run")
    p.add_argument("--shared", action="store_true",
                   help="the checkpoint came from --shared training")
    p.add_argument("--chunks", type=int, default=1,
                   help="the checkpoint came from --chunks K training")
    p.add_argument("--share-agents", action="store_true", dest="share_agents",
                   help="the checkpoint came from --share-agents training")
    p.add_argument("--market-dtype",
                   choices=["auto", "float32", "bfloat16"],
                   default="auto", dest="market_dtype",
                   help=argparse.SUPPRESS)
    p.add_argument("--scenario-index", type=int, default=0, dest="scenario_index",
                   help="which learner to evaluate from an independent-mode "
                        "(non --shared) scenario checkpoint")
    p.add_argument("--communities", type=int, default=0,
                   help="evaluate a `multi`-trained checkpoint of this many "
                        "communities (inter-community trading); persists "
                        "per-community rows under {setting}-c{i}")
    p.add_argument("--figures-dir",
                   help="figures need the analysis layer (ROADMAP.md, "
                        "Queue 1, item 15): exits non-zero")
    p.add_argument("--pv-drop", dest="pv_drop", metavar="AGENT[:START[:FACTOR]]",
                   help="fault-inject one agent's PV production")
    p.set_defaults(fn=cmd_eval)

    p = sub.add_parser("baseline", help="rule-based / semi-intelligent baseline")
    _add_common(p)
    p.add_argument("--test", action="store_true")
    p.add_argument("--kind", choices=["rule-based", "semi-intelligent"],
                   default="rule-based")
    p.add_argument("--pv-drop", dest="pv_drop", metavar="AGENT[:START[:FACTOR]]")
    p.set_defaults(fn=cmd_baseline)

    p = sub.add_parser("sweep", help="DDPG hyperparameter sweep")
    _add_common(p)
    p.add_argument("--actor-lrs", default="1e-4,3e-4", dest="actor_lrs")
    p.add_argument("--taus", default="0.005", dest="taus")
    p.add_argument("--ou-sigmas", default="0.1", dest="ou_sigmas")
    p.set_defaults(fn=cmd_sweep)

    p = sub.add_parser("forecast", help="train + evaluate the load/PV forecaster")
    _add_common(p)
    p.add_argument("--epochs", type=int, default=200,
                   help="training epochs (reference: 200, ml.py:275)")
    p.add_argument("--figures-dir",
                   help="figures need the analysis layer (ROADMAP.md, "
                        "Queue 1, item 15): exits non-zero")
    p.set_defaults(fn=cmd_forecast)

    p = sub.add_parser(
        "telemetry-report",
        help="render a telemetry run directory into a summary "
             "(default: the latest under artifacts/runs)",
    )
    p.add_argument("run", nargs="?",
                   help="run directory (artifacts/runs/<run_id>); omit for "
                        "the most recent run")
    p.add_argument("--runs-root", dest="runs_root",
                   help="root containing run directories (default "
                        "artifacts/runs, or $P2P_TELEMETRY_DIR)")
    p.add_argument("--compare", nargs=2, metavar=("A", "B"),
                   help="diff two run directories' summaries side by side, "
                        "keyed by their manifests' config_hash/git_rev")
    p.add_argument("--perfetto", metavar="TRACE_ID",
                   help="export ONE distributed trace as merged Chrome-"
                        "trace JSON (Perfetto/chrome://tracing loadable): "
                        "spans pulled by trace id from every --trace-db "
                        "warehouse, one pid timeline per process")
    p.add_argument("--trace-db", action="append", dest="trace_db",
                   metavar="DB",
                   help="--perfetto: a warehouse SQLite DB to pull spans "
                        "from; repeat for a fleet whose segments wrote to "
                        "different DBs")
    p.add_argument("--out",
                   help="--perfetto: write the Chrome-trace JSON here "
                        "instead of stdout")
    p.set_defaults(fn=cmd_telemetry_report)

    p = sub.add_parser(
        "export-bundle",
        help="freeze a checkpoint's greedy parameters into a policy bundle "
             "for serving (greedy params only — no optimizer/replay/target "
             "state)",
    )
    _add_common(p)
    p.add_argument("--scenarios", type=int, default=1,
                   help="locate the checkpoint of a --scenarios N training run")
    p.add_argument("--shared", action="store_true",
                   help="the checkpoint came from --shared training")
    p.add_argument("--chunks", type=int, default=1,
                   help="the checkpoint came from --chunks K training")
    p.add_argument("--share-agents", action="store_true", dest="share_agents",
                   help="the checkpoint came from --share-agents training")
    p.add_argument("--scenario-index", type=int, default=0,
                   dest="scenario_index",
                   help="which learner to export from an independent-mode "
                        "scenario checkpoint")
    p.add_argument("--out",
                   help="bundle output directory (default "
                        "bundles/<setting>-<implementation>)")
    p.add_argument("--dtype", choices=["float32", "float16", "int8"],
                   default="float32",
                   help="on-disk dtype for floating parameter leaves "
                        "(float16 halves the bundle, int8 quarters it with "
                        "per-leaf scale calibration and the error-bound "
                        "contract of serve/export.py; the engine computes "
                        "in float32 either way)")
    p.add_argument("--ulp-budget", type=float, dest="ulp_budget",
                   default=None,
                   help="int8 continuous-actor error budget in float32 ulps "
                        "(default: serve/export.py DEFAULT_ULP_BUDGET; the "
                        "export refuses a bundle whose measured max ulp "
                        "exceeds it)")
    p.add_argument("--aot-buckets", dest="aot_buckets", default=None,
                   help="comma-separated padding buckets to prepare at "
                        "export time, e.g. '1,8,64' (each bucket's CUDA "
                        "graph captured in a throwaway engine, the timings "
                        "recorded in the manifest); graphs are not "
                        "serialized, a later process captures its own")
    p.set_defaults(fn=cmd_export_bundle)

    p = sub.add_parser(
        "train-recurrent",
        help="train the recurrent day-granular LSTM DDPG actor on the "
             "community physics and checkpoint it (export with "
             "export-bundle --implementation ddpg_recurrent; serves only "
             "through continuous batching with sessions)",
    )
    _add_common(p)
    p.set_defaults(fn=cmd_train_recurrent, implementation="ddpg_recurrent",
                   episodes=8)

    p = sub.add_parser(
        "serve-bench",
        help="open-loop Poisson load against the batched inference engine; "
             "prints p50/p95/p99 latency, throughput and padding-waste as "
             "one JSON object per line",
    )
    _add_common(p)
    p.add_argument("--bundle",
                   help="policy bundle directory (export-bundle output); "
                        "omitted: export a fresh-init bundle for the "
                        "configured setting to a temp dir and bench that")
    p.add_argument("--rate", type=float, default=256.0,
                   help="offered request rate, requests/sec (default 256)")
    p.add_argument("--requests", type=int, default=2048,
                   help="total requests to generate (default 2048)")
    p.add_argument("--max-batch", type=_pow2_int, default=64, dest="max_batch",
                   help="microbatch coalescing cap; must be a power of two "
                        "(default 64)")
    p.add_argument("--max-wait-ms", type=float, default=2.0,
                   dest="max_wait_ms",
                   help="max time the oldest queued request waits for "
                        "coalescing, ms (default 2)")
    p.add_argument("--slo-ms", type=float, default=100.0, dest="slo_ms",
                   help="latency SLO budget the vs_baseline headroom is "
                        "reported against, ms (default 100)")
    p.add_argument("--bench-seed", type=int, default=0, dest="bench_seed",
                   help="seed for the Poisson arrivals and synthetic "
                        "observations (default 0; --seed stays the model "
                        "config seed)")
    p.add_argument("--serve-device", choices=["auto", "default", "cpu"],
                   default="auto", dest="serve_device",
                   help="engine placement: 'cpu', 'default' (the card), or "
                        "auto (default): --device, until a crossover "
                        "measured on the card places engines (ROADMAP.md, "
                        "Queue 1, item 6)")
    p.add_argument("--network", action="store_true",
                   help="wire-level mode: start an in-process serve gateway "
                        "on an ephemeral port and fire the same open-loop "
                        "schedule over real sockets; the headline row "
                        "carries wire p50/p95/p99 and the admission-control "
                        "shed rate")
    p.add_argument("--households", type=int, default=16,
                   help="--network: distinct simulated household ids cycling "
                        "over the request stream (default 16)")
    p.add_argument("--max-queue-depth", type=int, default=256,
                   dest="max_queue_depth",
                   help="--network: admission-control queue-depth budget "
                        "(429 at/above it; default 256)")
    p.add_argument("--wait-budget-ms", type=float, default=50.0,
                   dest="wait_budget_ms",
                   help="--network: admission-control p95 coalescing-wait "
                        "budget in ms (default 50)")
    p.add_argument("--retry", action="store_true",
                   help="--network: retry shed (429) and transient-failure "
                        "responses client-side, honoring Retry-After with "
                        "capped jittered backoff; off by default (429 "
                        "stays terminal)")
    p.add_argument("--fleet", action="store_true",
                   help="fleet mode: run N in-process gateway replicas "
                        "behind the consistent-hash router and fire the "
                        "open-loop schedule THROUGH the router (retry, "
                        "failover, re-pinning); headline row carries "
                        "availability/failover/retry SLOs")
    p.add_argument("--replicas", type=int, default=3,
                   help="--fleet: gateway replica count (default 3)")
    p.add_argument("--population", type=int, default=None,
                   help="million-household scale tier: synthetic "
                        "population size for the virtual-clock scale "
                        "bench, which needs scale/ (ROADMAP.md, Queue 1, "
                        "item 15): exits non-zero")
    p.add_argument("--scaling-replicas", dest="scaling_replicas",
                   default="3,10,30",
                   help="--population: comma-separated replica counts for "
                        "the scaling sweep; the LARGEST is the headline "
                        "(default 3,10,30)")
    p.add_argument("--population-zipf-s", type=float, default=0.6,
                   dest="population_zipf_s",
                   help="--population: popularity skew exponent "
                        "(default 0.6; 0 = uniform)")
    p.add_argument("--population-churn", type=float, default=0.02,
                   dest="population_churn",
                   help="--population: fraction of requests from cold "
                        "uniform households (default 0.02)")
    p.add_argument("--vnodes", type=int, default=4096,
                   help="--population: consistent-hash virtual nodes per "
                        "replica for the scale sweep (default 4096 — "
                        "spread tightens as 1/sqrt(vnodes))")
    p.add_argument("--duration-s", type=float, default=15.0,
                   dest="duration_s",
                   help="--population: virtual-clock schedule length in "
                        "seconds; requests = rate x duration (default 15)")
    p.add_argument("--shard-warehouse", action="store_true",
                   dest="shard_warehouse",
                   help="--fleet: one WAL-mode SQLite warehouse shard per "
                        "replica next to --results-db (replica telemetry "
                        "fans out instead of funneling into one writer); "
                        "federate with telemetry-query --shard")
    p.add_argument("--chaos", action="store_true",
                   help="--fleet: apply the default deterministic fault "
                        "plan — kill one replica at 30%% of the run, "
                        "restart it at 60%% — while the bench runs")
    p.add_argument("--chaos-seed", type=int, default=0, dest="chaos_seed",
                   help="--chaos: fault-plan seed (same seed = same "
                        "injected faults; default 0)")
    p.add_argument("--chaos-plan", dest="chaos_plan",
                   help="--fleet: JSON fault-plan file (serve/faults.py "
                        "FaultPlan.to_json) overriding the default "
                        "kill/restart plan")
    p.add_argument("--kill-at", type=float, default=None, dest="kill_at",
                   help="--chaos: kill instant in seconds from loadgen "
                        "start (default: 30%% of the expected run)")
    p.add_argument("--restart-at", type=float, default=None,
                   dest="restart_at",
                   help="--chaos: restart instant in seconds (default: "
                        "60%% of the expected run)")
    p.add_argument("--retry-attempts", type=int, default=5,
                   dest="retry_attempts",
                   help="client retry policy: max attempts per request "
                        "(--fleet router / --network --retry; default 5)")
    p.add_argument("--retry-deadline-s", type=float, default=15.0,
                   dest="retry_deadline_s",
                   help="client retry policy: per-request deadline in "
                        "seconds (default 15)")
    p.add_argument("--process", action="store_true",
                   help="--fleet: spawn each replica as a REAL subprocess "
                        "(serve-gateway children) under a relaunch "
                        "supervisor; chaos kills become SIGKILLs")
    p.add_argument("--tls", action="store_true",
                   help="--fleet: terminate TLS at every replica (test "
                        "certs generated under artifacts/tls/, which "
                        "git ignores)")
    p.add_argument("--auth", action="store_true",
                   help="--fleet: enforce per-household bearer tokens "
                        "(fresh fleet secret; the router holds the "
                        "operator wildcard) and run the 401 auth probe "
                        "after the schedule")
    p.add_argument("--transport", choices=["auto", "http", "mux"],
                   default="auto", dest="fleet_transport",
                   help="--fleet: client wire — auto (default) prefers "
                        "each replica's persistent multiplexed listener; "
                        "http forces the per-request-connection client")
    p.add_argument("--wire-compare", action="store_true",
                   dest="wire_compare",
                   help="--fleet: emit a wire_comparison row first — the "
                        "same open-loop schedule through per-request HTTP "
                        "vs the persistent mux wire against replica-0")
    p.add_argument("--batching", choices=["micro", "continuous"],
                   default="micro",
                   help="--network/--fleet: queue front per bundle "
                        "('continuous' = slot-level join/leave sessions; "
                        "required for recurrent bundles)")
    p.add_argument("--max-sessions", type=int, default=256,
                   dest="max_sessions",
                   help="--batching continuous: resident session slots "
                        "per bundle (default 256)")
    p.add_argument("--burst-factor", type=float, default=None,
                   dest="burst_factor",
                   help="bursty arrivals: Markov-modulated on/off Poisson "
                        "with the on-state rate this many times the "
                        "off-state rate, mean rate preserved (1 = plain "
                        "Poisson; default 1, except --continuous-compare "
                        "which defaults to 8 — pass an explicit value to "
                        "override either)")
    p.add_argument("--burst-dwell-s", type=float, default=0.25,
                   dest="burst_dwell_s",
                   help="bursty arrivals: mean dwell in each on/off state, "
                        "seconds (default 0.25)")
    p.add_argument("--continuous-compare", action="store_true",
                   dest="continuous_compare",
                   help="one-process continuous-vs-microbatch comparison: "
                        "the SAME (bursty) open-loop schedule over the "
                        "persistent mux wire through a microbatch gateway "
                        "and a continuous-batching gateway; emits per-arm "
                        "percentile rows and the serve_continuous "
                        "headline")
    p.add_argument("--trace", action="store_true",
                   help="--fleet: distributed tracing — every request "
                        "carries a deterministic trace context (seeded by "
                        "--bench-seed) across HTTP/mux into every replica; "
                        "spans land in the --results-db warehouse (a temp "
                        "DB if none given) and the run appends a stitched "
                        "trace-tree row plus the serve_bench_trace "
                        "headline with the p99 critical path "
                        "With --chaos, a stall "
                        "window on the victim plus a tight per-attempt "
                        "router timeout forces observable failover hops")
    p.set_defaults(fn=cmd_serve_bench)

    p = sub.add_parser(
        "serve-gateway",
        help="run the HTTP serving gateway: POST /v1/act over the "
             "microbatch queue, /healthz /readyz /stats, hot-swap + A/B "
             "via POST /admin/swap, admission control, drain on exit",
    )
    _add_common(p)
    p.add_argument("--bundle", action="append",
                   help="policy bundle directory; repeat to register "
                        "multiple bundles in the hot-swap registry (first "
                        "is the default). Omitted: export a fresh-init "
                        "bundle for the configured setting")
    p.add_argument("--host", default="127.0.0.1",
                   help="bind address (default 127.0.0.1)")
    p.add_argument("--port", type=_nonneg_int, default=8377,
                   help="bind port; 0 picks an ephemeral port, printed in "
                        "the gateway_listening line (default 8377)")
    p.add_argument("--max-batch", type=_pow2_int, default=64,
                   dest="max_batch",
                   help="microbatch coalescing cap per bundle; power of two "
                        "(default 64)")
    p.add_argument("--max-wait-ms", type=float, default=2.0,
                   dest="max_wait_ms",
                   help="max coalescing wait for the oldest queued request, "
                        "ms (default 2)")
    p.add_argument("--max-queue-depth", type=int, default=256,
                   dest="max_queue_depth",
                   help="admission control: shed (429 + Retry-After) when a "
                        "bundle's queue depth reaches this (default 256)")
    p.add_argument("--wait-budget-ms", type=float, default=50.0,
                   dest="wait_budget_ms",
                   help="admission control: shed when the recent p95 "
                        "coalescing wait exceeds this budget, ms "
                        "(default 50)")
    p.add_argument("--retry-after-s", type=float, default=1.0,
                   dest="retry_after_s",
                   help="Retry-After header value on shed responses, "
                        "seconds (default 1)")
    p.add_argument("--serve-device", choices=["auto", "default", "cpu"],
                   default="auto", dest="serve_device",
                   help="engine placement: 'cpu', 'default' (the card), or "
                        "auto (default): --device, until a crossover "
                        "measured on the card places engines (ROADMAP.md, "
                        "Queue 1, item 6)")
    p.add_argument("--serve-seconds", type=float, default=0.0,
                   dest="serve_seconds",
                   help="serve for this many seconds then drain and exit "
                        "(0 = until Ctrl-C; smoke tests use a bounded run)")
    p.add_argument("--stats-out", dest="stats_out",
                   help="write the final /stats snapshot JSON here on exit "
                        "(the GATEWAY_STATS_*.json capture schema)")
    p.add_argument("--mux-port", type=_nonneg_int, default=None,
                   dest="mux_port",
                   help="also serve the persistent multiplexed framed "
                        "wire on this port (0 = ephemeral; resolved port "
                        "rides the gateway_listening line; omitted = "
                        "HTTP/1.1 only)")
    p.add_argument("--tls-cert", dest="tls_cert",
                   help="TLS certificate PEM; terminates TLS on both "
                        "listeners (pair with --tls-key)")
    p.add_argument("--tls-key", dest="tls_key",
                   help="TLS private-key PEM (pair with --tls-cert; keep "
                        "OUT of the repo)")
    p.add_argument("--auth-secret-file", dest="auth_secret_file",
                   help="fleet secret file (serve-token --new-secret): "
                        "enforce per-household bearer tokens on /v1/act "
                        "and the operator wildcard on /stats + /admin/*")
    p.add_argument("--replica-id", dest="replica_id",
                   help="this replica's fleet identity (rides /readyz and "
                        "/stats)")
    p.add_argument("--shard-id", dest="shard_id",
                   help="warehouse shard identity: bind this replica's "
                        "telemetry to its own --results-db file (one "
                        "WAL-mode shard per replica; telemetry-query "
                        "--shard federates the set)")
    p.add_argument("--restarts", type=_nonneg_int, default=0,
                   help="relaunch count (the process-fleet supervisor "
                        "passes it so fleet stats attribute churn)")
    p.add_argument("--chaos-plan", dest="chaos_plan",
                   help="fault-plan JSON (serve/faults.py FaultPlan) for "
                        "this replica's request-fault injector; the "
                        "process-fleet harness passes it so child "
                        "replicas replay the same faults")
    p.add_argument("--batching", choices=["micro", "continuous"],
                   default="micro",
                   help="queue front per bundle: 'micro' (full-batch "
                        "coalescing) or 'continuous' (slot-level "
                        "join/leave with per-household session slots — "
                        "required for recurrent bundles)")
    p.add_argument("--max-sessions", type=int, default=256,
                   dest="max_sessions",
                   help="--batching continuous: resident session slots "
                        "per bundle (LRU eviction + deterministic re-init "
                        "past it; default 256)")
    p.set_defaults(fn=cmd_serve_gateway)

    p = sub.add_parser(
        "serve-token",
        help="mint fleet auth secrets and HMAC-signed per-household "
             "bearer tokens (serve/auth.py)",
    )
    p.add_argument("--new-secret", dest="new_secret",
                   help="write a fresh 32-byte fleet secret here (0600) "
                        "and exit")
    p.add_argument("--secret-file", dest="secret_file",
                   help="existing fleet secret to mint/verify with")
    p.add_argument("--household",
                   help="household id the token authorizes")
    p.add_argument("--wildcard", action="store_true",
                   help="mint the operator wildcard token (any household "
                        "+ the admin surface) instead of --household")
    p.add_argument("--ttl-s", type=float, default=None, dest="ttl_s",
                   help="token lifetime in seconds (default: no expiry)")
    p.add_argument("--verify",
                   help="verify this token against --secret-file and "
                        "print its claims instead of minting")
    p.add_argument("--rotate", action="store_true",
                   help="rotate --secret-file in place: a fresh secret "
                        "replaces it, the old one is honored from "
                        "<path>.prev until --grace-s expires (no "
                        "synchronized fleet restart)")
    p.add_argument("--grace-s", type=float, default=3600.0, dest="grace_s",
                   help="--rotate: how long the rotated-out secret keeps "
                        "verifying (default 3600)")
    p.set_defaults(fn=cmd_serve_token)

    p = sub.add_parser(
        "continual",
        help="continual training: replay warehouse serve traces into "
             "replay buffers, fine-tune the incumbent bundle off-policy "
             "+ through the guarded chunked pipeline, export a candidate "
             "bundle (data/trace_export.py + train/continual.py)",
    )
    _add_common(p)
    p.set_defaults(episodes=20)
    p.add_argument("--bundle",
                   help="the INCUMBENT bundle directory to fine-tune")
    p.add_argument("--config-hash", dest="config_hash",
                   help="export only this config's serve traces "
                        "(default: every serve-role run in the warehouse)")
    p.add_argument("--out",
                   help="candidate bundle output directory (default: "
                        "bundles/<setting>-<impl>-continual)")
    p.add_argument("--scenarios", type=int, default=1,
                   help="scenario batch of the simulator fine-tune phase")
    p.add_argument("--chunks", type=int, default=1,
                   help="chunked aggregate scenarios per episode (the "
                        "chunk graph; train --chunks semantics)")
    p.add_argument("--health-every", type=int, default=10,
                   dest="health_every",
                   help="greedy held-out eval cadence during the simulator "
                        "phase (feeds the divergence guard; default 10)")
    p.add_argument("--trace-steps", type=int, default=200,
                   dest="trace_steps",
                   help="off-policy update steps on the exported traces "
                        "before the simulator phase (default 200)")
    p.add_argument("--trace-batch", type=int, default=None,
                   dest="trace_batch",
                   help="transitions per off-policy update (default: the "
                        "implementation's batch size)")
    p.add_argument("--min-transitions", type=int, default=1,
                   dest="min_transitions",
                   help="refuse to train on fewer exported transitions "
                        "(loud failure beats silent fine-tuning on noise)")
    p.add_argument("--windowed", action="store_true",
                   help="export from the last released export watermark "
                        "under a warehouse LEASE (the autopilot's "
                        "export/retention handshake — compaction cannot "
                        "race the window)")
    p.add_argument("--settlement", action="store_true",
                   help="attribute training reward from billed "
                        "'settlement' warehouse rows (loud fallback to "
                        "the env tariff model for unbilled transitions)")
    p.add_argument("--max-rollbacks", type=_nonneg_int, default=3,
                   dest="max_rollbacks",
                   help="divergence rollback budget for the simulator "
                        "phase (default 3; train/resilience.py)")
    p.add_argument("--lr-drop", type=float, default=0.5, dest="lr_drop",
                   help="rollback perturbation: effective lrs x this "
                        "factor per rollback (default 0.5)")
    p.add_argument("--dtype", choices=["float32", "float16", "int8"],
                   default="float32",
                   help="candidate bundle export dtype (int8 applies the "
                        "quantization error-bound contract at export)")
    p.add_argument("--pipeline", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="async episode pipeline for the simulator phase")
    p.set_defaults(fn=cmd_continual)

    p = sub.add_parser(
        "promote",
        help="gated promotion + canary auto-rollback: candidate must "
             "beat the incumbent on held-out eval cost and meet serve "
             "SLOs before any traffic, then ramps 5%%->25%%->100%% with "
             "live per-bundle attribution and rollback on regression "
             "(serve/promotion.py)",
    )
    _add_common(p)
    p.add_argument("--candidate", help="candidate bundle directory")
    p.add_argument("--incumbent", help="incumbent bundle directory")
    p.add_argument("--out",
                   help="append the promotion metric rows to this JSONL "
                        "capture (schema-checked as "
                        "artifacts/PROMOTION_*.jsonl)")
    p.add_argument("--gate-only", action="store_true", dest="gate_only",
                   help="run the offline gate and exit (rc 0 = pass); "
                        "no traffic")
    p.add_argument("--skip-gate", action="store_true", dest="skip_gate",
                   help="OPERATOR OVERRIDE: go straight to the canary — "
                        "the ramp and auto-rollback still guard the fleet")
    p.add_argument("--inject",
                   choices=["all", "good", "cost_regressed",
                            "nan_poisoned", "slo_violating"],
                   help="seeded bad-candidate harness instead of a real "
                        "candidate: crafted bundles through the full "
                        "pipeline (the PROMOTION_*.jsonl capture driver)")
    p.add_argument("--work-dir", dest="work_dir",
                   help="--inject: where crafted bundles are written "
                        "(default: a temp dir)")
    p.add_argument("--stages", default="5,25,100",
                   help="canary ramp percentages, comma-separated, ending "
                        "at 100 (default 5,25,100)")
    p.add_argument("--requests-per-stage", type=int, default=192,
                   dest="requests_per_stage",
                   help="live requests driven per canary stage "
                        "(default 192)")
    p.add_argument("--households", type=int, default=128,
                   help="distinct household ids in the canary traffic "
                        "(split arms are household-deterministic; "
                        "default 128)")
    p.add_argument("--max-batch", type=_pow2_int, default=16,
                   dest="max_batch",
                   help="engine padding-bucket cap for gate/canary "
                        "serving (default 16)")
    p.add_argument("--cost-margin", type=float, default=0.0,
                   dest="cost_margin",
                   help="gate: candidate eval cost must beat the "
                        "incumbent's by at least this (default 0 — any "
                        "strict improvement)")
    p.add_argument("--max-reward-drop", type=float, default=0.5,
                   dest="max_reward_drop",
                   help="gate: don't-heat basin guard — candidate greedy "
                        "reward may not fall more than this fraction of "
                        "|incumbent reward| below it (default 0.5)")
    p.add_argument("--slo-p95-ms", type=float, default=100.0,
                   dest="slo_p95_ms",
                   help="gate serve-bench p95 budget (default 100)")
    p.add_argument("--slo-p99-ms", type=float, default=250.0,
                   dest="slo_p99_ms",
                   help="gate serve-bench p99 budget (default 250)")
    p.add_argument("--max-shed-rate", type=float, default=0.05,
                   dest="max_shed_rate",
                   help="gate shed-rate budget (default 0.05)")
    p.add_argument("--max-cost-regression", type=float, default=0.05,
                   dest="max_cost_regression",
                   help="canary: candidate arm's mean decision cost may "
                        "exceed the incumbent arm's by at most this "
                        "scale-free tolerance (default 0.05)")
    p.add_argument("--canary-p95-ms", type=float, default=500.0,
                   dest="canary_p95_ms",
                   help="canary: absolute per-stage candidate p95 budget "
                        "(default 500 — wire latency, not engine latency)")
    p.add_argument("--canary-min-requests", type=int, default=8,
                   dest="canary_min_requests",
                   help="canary: candidate-arm decisions needed per stage "
                        "for a cost verdict (default 8)")
    p.add_argument("--regimes",
                   help="gate: comma-separated held-out regime names "
                        "(p2pmicrogrid_tpu_torch/regimes/) — the candidate may "
                        "not regress ANY of them, even when its mean cost "
                        "improves (honored by --gate-only and the full "
                        "pipeline's gate; --skip-gate skips it with the "
                        "rest of the gate)")
    p.add_argument("--max-regime-regression", type=float, default=0.0,
                   dest="max_regime_regression",
                   help="gate: scale-free per-regime regression tolerance "
                        "for --regimes (default 0 — any regression blocks)")
    p.add_argument("--batching", choices=["micro", "continuous"],
                   default="continuous",
                   help="canary gateway queue front (default continuous "
                        "— bit-exact vs micro for the stateless bundles "
                        "promotion serves; pass micro for the coalescing "
                        "queue)")
    p.set_defaults(fn=cmd_promote)

    p = sub.add_parser(
        "regime-bench",
        help="regime-portfolio acceptance harness: mixed >=4-regime "
             "training through one episode function, per-regime eval tables "
             "(train + held-out sets), the mean-better/regime-worse gate "
             "case, and the regime_generalization headline row "
             "(regimes/bench.py; the REGIME_*.jsonl capture driver)",
    )
    p.add_argument("--train-regimes", dest="train_regimes",
                   default="baseline,winter,ev_evening,double_auction",
                   help="comma-separated regime names trained as one "
                        "mixed batch (default: "
                        "baseline,winter,ev_evening,double_auction)")
    p.add_argument("--held-out-regimes", dest="held_out_regimes",
                   default="dr_spike,islanding_noon,cold_snap,"
                           "uniform_price",
                   help="comma-separated held-out regime names for the "
                        "generalization eval and the gate case")
    p.add_argument("--agents", type=int, default=3)
    p.add_argument("--scenarios-per-regime", type=int, default=2,
                   dest="scenarios_per_regime",
                   help="training scenarios per train regime in the "
                        "mixed batch (default 2)")
    p.add_argument("--episodes", type=int, default=3)
    p.add_argument("--eval-scenarios", type=int, default=4,
                   dest="eval_scenarios",
                   help="held-out eval scenarios per regime (default 4)")
    p.add_argument("--implementation",
                   choices=["tabular", "dqn", "ddpg"], default="tabular")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--results-db",
                   help="also stream regime_eval events + metric rows "
                        "into this SQLite warehouse "
                        "(telemetry-query --regimes)")
    p.add_argument("--out",
                   help="append the metric rows to this JSONL capture "
                        "(schema-checked as artifacts/REGIME_*.jsonl)")
    p.add_argument("--no-gate-case", action="store_true",
                   dest="no_gate_case",
                   help="skip the crafted mean-better/regime-worse gate "
                        "case (eval tables + headline only)")
    _add_device(p)
    p.set_defaults(fn=cmd_regime_bench)

    p = sub.add_parser(
        "autopilot",
        help="operator-less continual deployment: retrain->gate->canary "
             "cycles on a cadence over a live fleet, crash-safe cycle "
             "journal, zero-bad-promotion rails (serve/autopilot.py); "
             "--bench runs the ProcessFleet + chaos + SIGKILL capture "
             "harness",
    )
    _add_common(p)
    p.add_argument("--replica", action="append",
                   help="replica address host:port[/muxport]; repeat per "
                        "replica (daemon mode)")
    p.add_argument("--incumbent",
                   help="incumbent bundle directory (seeds a FRESH "
                        "journal; an existing journal's incumbent wins)")
    p.add_argument("--state-dir", dest="state_dir",
                   help="cycle journal + per-cycle candidates live here "
                        "(the crash-recovery state)")
    p.add_argument("--cycles", type=int, default=3,
                   help="total cycles to complete (journal-counted across "
                        "restarts; default 3)")
    p.add_argument("--cadence-s", type=float, default=0.0, dest="cadence_s",
                   help="sleep between cycles, seconds (default 0 — "
                        "back-to-back; production runs hours)")
    p.add_argument("--inject",
                   help="cycle:kind[,cycle:kind...] injection plan (kinds: "
                        "good | cost_regressed | nan_poisoned | continual); "
                        "un-named cycles retrain for real")
    p.add_argument("--out",
                   help="append metric rows to this JSONL file")
    p.add_argument("--bench", action="store_true",
                   help="run the acceptance harness (ProcessFleet "
                        "+ chaos + autopilot SIGKILL) instead of daemon "
                        "mode")
    p.add_argument("--work-dir", dest="work_dir",
                   help="--bench: working directory (default: temp dir)")
    p.add_argument("--replicas", type=int, default=3,
                   help="--bench: fleet size (default 3)")
    p.add_argument("--chaos", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="--bench: SIGKILL a replica mid-run (supervisor "
                        "relaunches it)")
    p.add_argument("--sigkill-phase", default="retraining",
                   dest="sigkill_phase",
                   help="--bench: SIGKILL the autopilot in this phase "
                        "(empty = no autopilot kill; default retraining)")
    p.add_argument("--sigkill-cycle", type=int, default=1,
                   dest="sigkill_cycle",
                   help="--bench: ...of this cycle (default 1)")
    p.add_argument("--requests-per-cycle", type=int, default=96,
                   dest="requests_per_cycle",
                   help="baseline traffic per cycle (the decisions the "
                        "next retrain exports; default 96)")
    p.add_argument("--canary-requests", type=int, default=64,
                   dest="canary_requests",
                   help="live requests per canary stage (default 64)")
    p.add_argument("--households", type=int, default=16,
                   help="distinct household ids in the traffic (default 16)")
    p.add_argument("--rate-hz", type=float, default=64.0, dest="rate_hz",
                   help="open-loop traffic rate (default 64)")
    p.add_argument("--stages", default="25,100",
                   help="canary ramp percentages ending at 100 "
                        "(default 25,100)")
    p.add_argument("--trace-steps", type=int, default=50,
                   dest="trace_steps",
                   help="off-policy pretrain steps on the exported traces "
                        "(default 50)")
    p.add_argument("--sim-episodes", type=int, default=0,
                   dest="sim_episodes",
                   help="chunked simulator fine-tune episodes per cycle "
                        "(default 0 — pure trace fine-tune)")
    p.add_argument("--settlement", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="bill decisions + attribute training reward from "
                        "settlement rows (loud fallback to the env model "
                        "when rows are missing)")
    p.add_argument("--min-transitions", type=int, default=8,
                   dest="min_transitions",
                   help="refuse a cycle with fewer exported transitions "
                        "(default 8)")
    p.add_argument("--max-batch", type=_pow2_int, default=16,
                   dest="max_batch",
                   help="engine padding-bucket cap (default 16)")
    p.add_argument("--serve-device", default="auto", dest="serve_device",
                   choices=["cpu", "default", "auto"],
                   help="backend for the gate/verify reference engines — "
                        "must match the FLEET's serve device for the "
                        "bit-exact serving check: 'cpu', 'default' (the "
                        "card), or auto (default): --device")
    p.add_argument("--verify-serving",
                   action=argparse.BooleanOptionalAction, default=True,
                   dest="verify_serving",
                   help="post-cycle bit-exact check of the fleet default "
                        "vs the journal's incumbent (disable on "
                        "mixed-backend fleets)")
    p.add_argument("--auth-secret-file", dest="auth_secret_file",
                   help="fleet secret: mint the operator wildcard toward "
                        "the replicas")
    p.add_argument("--retry-attempts", type=int, default=5,
                   dest="retry_attempts")
    p.add_argument("--retry-deadline-s", type=float, default=15.0,
                   dest="retry_deadline_s")
    p.add_argument("--probe-interval-s", type=float, default=0.5,
                   dest="probe_interval_s")
    p.add_argument("--cost-margin", type=float, default=0.0,
                   dest="cost_margin")
    p.add_argument("--max-reward-drop", type=float, default=0.5,
                   dest="max_reward_drop")
    p.add_argument("--slo-p95-ms", type=float, default=250.0,
                   dest="slo_p95_ms")
    p.add_argument("--slo-p99-ms", type=float, default=500.0,
                   dest="slo_p99_ms")
    p.add_argument("--max-cost-regression", type=float, default=0.05,
                   dest="max_cost_regression")
    p.add_argument("--canary-p95-ms", type=float, default=2000.0,
                   dest="canary_p95_ms")
    p.add_argument("--canary-min-requests", type=int, default=8,
                   dest="canary_min_requests")
    p.set_defaults(fn=cmd_autopilot)

    p = sub.add_parser(
        "serve-router",
        help="run the fleet router as a standalone proxy process: TLS + "
             "per-household auth terminate here; replicas are reached "
             "over the persistent multiplexed wire with retry/failover",
    )
    p.add_argument("--replica", action="append",
                   help="replica address host:port[/muxport]; repeat per "
                        "replica (port = HTTP endpoint, muxport = its "
                        "persistent framed listener)")
    p.add_argument("--host", default="127.0.0.1",
                   help="bind address (default 127.0.0.1)")
    p.add_argument("--port", type=_nonneg_int, default=8378,
                   help="bind port; 0 picks an ephemeral port, printed in "
                        "the router_listening line (default 8378)")
    p.add_argument("--mux-port", type=_nonneg_int, default=None,
                   dest="mux_port",
                   help="also serve the framed mux wire to clients on "
                        "this port (0 = ephemeral; omitted = HTTP only)")
    p.add_argument("--tls-cert", dest="tls_cert",
                   help="front TLS certificate PEM (pair with --tls-key)")
    p.add_argument("--tls-key", dest="tls_key",
                   help="front TLS private-key PEM")
    p.add_argument("--backend-cafile", dest="backend_cafile",
                   help="CA/cert PEM to verify TLS replicas with")
    p.add_argument("--auth-secret-file", dest="auth_secret_file",
                   help="fleet secret: verify household tokens at the "
                        "proxy and mint the router's wildcard credential "
                        "toward the replicas")
    p.add_argument("--results-db", dest="results_db",
                   help="bind router telemetry (fleet_stats events, "
                        "router counters) to this SQLite warehouse")
    p.add_argument("--shard-id", dest="shard_id",
                   help="warehouse shard identity for the router's own "
                        "telemetry rows (default 'router'); under a "
                        "sharded fleet, point --results-db at the "
                        "router's OWN shard file so the proxy never "
                        "contends with replica writers")
    p.add_argument("--retry-attempts", type=int, default=5,
                   dest="retry_attempts",
                   help="router retry policy: max attempts per request "
                        "(default 5)")
    p.add_argument("--retry-deadline-s", type=float, default=15.0,
                   dest="retry_deadline_s",
                   help="router retry policy: per-request deadline, "
                        "seconds (default 15)")
    p.add_argument("--probe-interval-s", type=float, default=0.5,
                   dest="probe_interval_s",
                   help="/readyz health-probe sweep interval, seconds "
                        "(default 0.5)")
    p.add_argument("--serve-seconds", type=float, default=0.0,
                   dest="serve_seconds",
                   help="serve this long then exit (0 = until Ctrl-C)")
    p.add_argument("--stats-out", dest="stats_out",
                   help="write the final fleet-stats snapshot JSON here "
                        "on exit")
    p.set_defaults(fn=cmd_serve_router)

    p = sub.add_parser(
        "telemetry-query",
        help="query the SQLite telemetry warehouse: default is the "
             "config-hash join of telemetry runs to eval runs, one JSON "
             "object per row; --sql runs arbitrary SQL",
    )
    p.add_argument("--results-db", required=False,
                   help="warehouse DB; optional when --shard files are "
                        "given (the federated view is built from the "
                        "shards alone)")
    p.add_argument("--shard", action="append", dest="shards",
                   metavar="DB", default=None,
                   help="per-replica warehouse shard file; repeat per "
                        "shard. The shards (plus --results-db when also "
                        "given) are merged into an in-memory warehouse "
                        "first, so every view federates the whole fleet. "
                        "Incompatible with --compact")
    p.add_argument("--sql",
                   help="run this SQL instead of the default join "
                        "(tables: telemetry_runs, telemetry_points, "
                        "telemetry_spans, eval_runs + the classic results "
                        "tables)")
    p.add_argument("--gauges", action="store_true",
                   help="inline each joined run's gauge points "
                        "(profile.*, train.*, replay.*) into its row")
    p.add_argument("--fleet", action="store_true",
                   help="fleet view instead of the eval join: serving "
                        "runs grouped by config_hash with serve-trace "
                        "totals and the router's counters")
    p.add_argument("--rollbacks", action="store_true",
                   help="rollback view instead of the eval join: training "
                        "runs grouped by config_hash with their "
                        "train.rollback/train.divergence counter sums and "
                        "per-rollback event details (train/resilience.py)")
    p.add_argument("--promotions", action="store_true",
                   help="promotion view instead of the eval join: every "
                        "candidate config's gate verdicts, promotions and "
                        "canary rollbacks with the newest decision phase")
    p.add_argument("--regimes", action="store_true",
                   help="regime view instead of the eval join: per-regime "
                        "cost/comfort/trade-energy breakdown per "
                        "config_hash out of the regime_eval events "
                        "(regimes/)")
    p.add_argument("--continuous", action="store_true",
                   help="continuous-batching view instead of the eval "
                        "join: per-(config_hash, batching) request/wait "
                        "totals plus the engine-step occupancy and "
                        "slot-wait distribution stats (serve/continuous.py)")
    p.add_argument("--trace", metavar="TRACE_ID",
                   help="render ONE distributed trace as a tree: every "
                        "span recorded under this 128-bit trace id across "
                        "every process that wrote to this warehouse, "
                        "stitched by parent ids, plus its critical-path "
                        "decomposition as a final JSON line")
    p.add_argument("--slowest", type=int, metavar="N",
                   help="the N slowest latency-histogram exemplars "
                        "(value-ordered) with their trace ids — the entry "
                        "points into --trace")
    p.add_argument("--watch", action="store_true",
                   help="tail mode: poll the warehouse join and stream "
                        "new/updated rows as JSON lines until interrupted")
    p.add_argument("--interval", type=float, default=2.0,
                   help="--watch poll interval in seconds (default 2)")
    p.add_argument("--max-polls", type=_nonneg_int, default=0,
                   dest="max_polls",
                   help="--watch: stop after this many polls (0 = forever; "
                        "scripts/tests use it for bounded tails)")
    p.add_argument("--compact", action="store_true",
                   help="retention pass instead of a query: roll "
                        "per-request serve_request telemetry older than "
                        "--older-than-hours into per-bucket aggregate "
                        "points (bounds a long-running gateway's "
                        "warehouse); prints a JSON summary")
    p.add_argument("--older-than-hours", type=float, default=24.0,
                   dest="older_than_hours",
                   help="--compact: keep this many hours of per-request "
                        "rows raw (default 24)")
    p.set_defaults(fn=cmd_telemetry_query)

    args = parser.parse_args(argv)
    # The raw argv backs `train --supervise`'s child-command reconstruction
    # (tests pass argv explicitly; interactive use falls back to sys.argv).
    args._argv = list(sys.argv[1:]) if argv is None else list(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
