"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

Run from the root of a checkout, with one CUDA device:

    python3 chip_smoke.py

Phases (each failure exits non-zero):

1. Device and build: the card's name and power limit, the torch and CUDA
   versions, then every kernel built from ``csrc/`` (one ``nvcc`` per
   source, all started together).
2. Each kernel against its plain PyTorch version on the card, at the main
   paths' shapes and edge cases; a repeat launch must be bit-identical; the
   kernel and the plain version timed with CUDA events, and the device time
   from the profiler. K1 (merged min, timed at [64,1000], [128,1000] (the
   northstar chunk), [256,50] and [2048,50], the DDPG scale row's shape,
   [8,1000] bf16, phase 8's greedy evaluation, and [4,1000] bf16, phase
   14's autopilot gate; its launch logged), then
   K5, K4, K6
   (the matrix path; K5's and K4's dispatch at every case and K5's, K4's and
   K6's grid and shared memory a block logged; K5's matrix held to its
   two-pass kernel's bit for bit, and that kernel timed beside it) and K3,
   K2 (same source, no main path), then
   K7 (the fused slot: tabular and DQN, factored, matrix at rounds 2 and 3,
   and no-trading; one cooperative launch whose grid and blocks per SM are
   logged), whose differing decisions are counted, each explained (a bin
   edge, a Q near-tie, or a cascade from an earlier round), and held below
   1e-4. Each also at the single community's shapes: K5, K4 and K6 in
   float32 at [1,2], [1,10] and [13,2] (the evaluation's 13 days), K7 at
   [1,2] and [1,10] (tabular and DQN, matrix at rounds 1 and 2, no
   trading) and [13,2] (the fused evaluation), a one-community case drawing
   its inputs at other hours until buyers and sellers meet. Phase 7's
   shapes: K1 in float32 at [8,128] and [104,128], K5 and K6 at [64,2] and
   [64,10], and K7 with one learner per scenario (tabular and DQN at [64,2]
   and [8,10], tabular at rounds=2), each scenario of it also held to K7 at
   [1,A] with its own learners, bit for bit.
3. Small-path parity: the A=6, S=3 shared episodes with fixed draws on the
   card against the port on the CPU (rewards, every slot's actions): tabular
   with the factored market (rounds=1) and the matrix negotiation
   (rounds=2), and the fused slot for tabular (factored, and the matrix
   negotiation at rounds=2) and for DQN (one warmup pass); and shared DDPG
   (one actor-critic for every agent, and per-agent stacks, at rounds=1 and
   rounds=2, one case under the striped learn-batch cap) over two episodes
   of slots 58-65, every slot's actions and the rewards held at the CPU
   tests' tolerances.
4. The main paths at full width: ``train_scenarios_shared`` (battery on,
   market "auto") for tabular at rounds=1 (-> factored with bf16
   pre-rounding, K1) and at rounds=2 (-> matrix, K5, K4, K6, bf16 storage at
   A >= 256), and with ``fused=True`` (K7 alone), each at A=1000, S=64 and
   at A=50, S=256, the fused rounds=2 run at A=1000, S=64 only (its peak
   memory within 64 MB of the fused rounds=1 run's: no [S, A, A] buffer);
   DQN at A=1000, S=64 with one warmup pass, fused and unfused from the same
   seed; shared DDPG (unfused, K1) at the JAX bench's cfg4 (A=1000, S=64)
   and scale (A=50, S=2048) rows, each with its learn step's device time
   per slot and share of the device's busy time. Two episodes each and one
   more under the profiler. Every kernel launch counter is set to 0 just
   before each run and read just after; each slot must launch each of its
   path's kernels once and no other kernel.
5. The chunked trainer (``train_scenarios_chunked``, traces made on the
   card, each chunk a CUDA graph replay): K=2 chunks at A=1000, S=128
   through the graph and through the eager loop from the same state and
   seeds, bit-identical rewards, losses and averaged state, for shared DDPG
   at the northstar config (K1), fused tabular (K7) and tabular rounds=2
   (K5, K4, K6), each replay counted as its kernels' launches; A=6, S=3,
   K=2 on the card (graph) against the CPU (eager) from the same injected
   draws; the JAX bench's ``northstar`` row (A=1000, S=128, K=80, shared
   DDPG, B=4, ring 96, battery on, factored bf16): a warm episode with the
   capture, a timed episode, then one chunk under the profiler as a graph
   replay and one eagerly with the learn step's range (env-steps/s, busy,
   idle share, capture and instantiate seconds, the graph's pool, peak
   memory, K1 at [128,1000], the learn step's share of busy); and ``cfg4``
   through the graph (K=1, S=64), timed beside phase 4's eager row.
6. The single community (``train/loop.py``, ``envs/community.py::
   run_episode``; the matrix negotiation in float32 at any round count, K1
   never): tests/test_golden.py's pinned greedy episode reproduced on the
   card, unfused (K5, K6 at [1,2]) and fused (K7 at [1,2]); the card against
   the CPU from one state and the same injected draws (cfg1 tabular A=2 over
   two episodes, unfused and fused; tabular rounds=2 through K4; DQN with
   one warmup pass, unfused and fused; the JAX bench's cfg2 per-agent DDPG
   at A=10, buffer 1024, batch 32), fused against unfused on the card; then
   the timed rows, each one warm, one timed and one profiled
   ``train_community`` episode: cfg1 unfused and fused, DQN at A=2, cfg2;
   and ``evaluate_community`` over the 13 days of the synthetic traces side
   by side (K5, K6 at [13,2]; fused, K7 at [13,2]), held to the CPU's. Each
   run sets the launch counts to 0 first and reads them after: its path's
   kernels once a slot, no other.
7. The remaining scenario trainers. The JAX bench's ``cfg5``
   (``train_multi_community``: 8 communities of 128 agents with
   inter-community trading, tabular, the factored clearing in float32, K1 at
   [8,128], K7 never); its greedy evaluation over the 13 days side by side
   (``evaluate_multi_community``, K1 at [104,128]) with the trained table
   and with a DDPG learner shared by every agent, held to the port on the
   CPU and to the settlement's conservation law; and
   ``train_scenarios_independent`` at S=64 for cfg1's width (A=2 tabular,
   unfused: K5 and K6 at [64,2]; fused: K7 with one learner per scenario)
   and cfg2's (A=10 per-agent DDPG: K5 and K6 at [64,10]). One warm, one
   timed and one profiled episode each, the launch counts set to 0 before
   the timed one and read after.
8. Observable, crash-safe training. (e) The seed-0 draws on this
   machine's CPU hash to the digests the CPU tests pin
   (``draw_digests.py``). (a) ``train.health.train_chunked_with_health`` at
   the northstar row (its depth cut to 8 chunks an episode) with
   telemetry into a temporary run directory, an eval
   of 8 held-out scenarios after every episode (K1 at [8,1000]) and
   ``mitigate="lr-boost"``: a warm episode and two timed ones, then one
   more block with the monitor restored in the basin, so the boosted runner
   is captured and replayed; env-steps/s beside phase 5's bare northstar,
   the eval's seconds, the boosted capture's seconds and pool, peak memory,
   each episode's device counters, the replay fill and the host's blocked
   share; the run directory's manifest, metrics and Chrome trace parsed, the
   profile gauges present, K1's launches (96 x 8 an episode, 96 an eval,
   96 a capture's warm-up; one eval's counted alone) and no other kernel;
   then the first run again with telemetry off (no counters, no records),
   its env-steps/s beside. (b) The device counters of
   the chunk graph equal to the eager loop's at K=2 bit for bit, and the
   card's to the CPU's at A=6, S=3; a chunk's device time with the
   counters and without, each graph's nodes. (c) ``resilience.supervise`` runs the
   port's training child at the northstar width (K=8, 3 episodes, a
   checkpoint every episode) with a fault plan that SIGKILLs it after
   episode 1's save; resumed, its final state's digest equals an
   uninterrupted child's; each attempt's startup seconds logged. (d) The
   single community (cfg1) under ``train_community_with_rollback`` with NaN
   poisoned at one block: the rollback records and the final table equal
   the CPU's from the same CPU-generator draws; then one timed
   ``train_community`` episode with telemetry, the drain at depth 2.
9. Serving on the card (``serve/``), which launches none of K1-K7 (their
   counts set to 0 first and read after). (a) Bundles exported on the card
   as float32, float16 and int8: cfg1's table (A=2, drawn on the card),
   per-agent DQN at A=1000 (hidden 64, drawn on the card; its int8 export
   accepted or refused with its calibration flips, the same verdict as the
   port's CPU engine gives) and the northstar's shared DDPG actor at A=1000
   from CPU seeds 0 and 1 (seed 0's draw held to ``draw_digests.py``'s
   pin). (b) Each bundle's engine on the card (one CUDA graph per bucket)
   against the port's CPU engine at every bucket up to 256 (A=2) or 64
   (A=1000): discrete actions equal up to counted flips, each a Q near tie,
   below 1e-4 of the decisions; DDPG within 1e-5; each replay equal to the
   eager forward on the card bit for bit; four session steps as the CPU's.
   (c) For the float32 bundles, each bucket's latency from host
   observations to host actions (the replay, the eager forward on the card
   and the CPU engine: p50 and p99 of 200 calls), and each engine's capture
   seconds and graph pool bytes. (d) The gateway on 127.0.0.1 over the two
   DDPG bundles, first with the microbatch front, then the continuous one:
   8 clients x 64 requests with household ids, the default swapped to seed
   1 halfway, no request failed, every answer equal bit for bit to the row
   ``engine.act`` of the bundle that answered computed for it in its batch
   (cuBLAS picks its kernel by shape, so against ``engine.act`` on the
   observation alone an answer may differ by an ulp; counted); then 256
   requests to cfg1's table through the microbatch front, each equal to
   ``engine.act`` on its observation. Latency, requests/s, padding waste,
   occupancy and sheds in one ``{"serve": {...}}`` line.
10. The recurrent models (``models/ddpg_recurrent.py``,
   ``train/recurrent.py``, ``models/forecast.py``), which launch none of
   K1-K7 (their counts set to 0 first and read after). (a) The serving step
   scanned over 96 slots from zeros against the whole-sequence actor on the
   card (atol 1e-6) and the card's sequence against the CPU's (1e-5), A=1000
   agents. (b) ``train_recurrent_community`` at A=8 over 3 days on the card
   and on the CPU from one CPU draw (day rewards, costs and losses at rtol
   2e-4), the seed-0 init digest printed only where it equals the CPU
   tests' pin; then at A=1000 over 4 days: seconds a day, one day's rollout
   and learn step timed alone and profiled, peak memory. (c) float32 and
   float16 bundles of that state (int8 refused), each engine on the card
   against the CPU engine at every bucket up to 64 on a live carry (1e-5),
   each replay equal to the eager step bit for bit, four sessions stepped
   over 96 slots against the whole sequence, latency per bucket. (d) The
   continuous batcher's hidden ring stepped by hand (continuity, eviction
   re-initialising bit for bit, slot exhaustion deferring), then the
   gateway's continuous front, 8 clients x 64 requests with household ids,
   each answer against its household's own carry through ``engine.act``;
   latency and the ring's graph pool. (e) The forecaster at the reference's
   widths, two epochs on the card against the CPU from one init and the
   same permutations (loss rtol 1e-4), seconds per epoch.
11. The scenario regime engine (``regimes/``, ``ops/auction.py``). (a) An
   all-baseline portfolio against the plain shared episode, tabular,
   A=1000, S=64, bit for bit. (b) The northstar config (shared DDPG, A=1000,
   128 scenarios a chunk) over ``baseline, winter, ev_evening,
   double_auction`` through ``train_scenarios_chunked(runner=)`` for 4
   chunks, a swap to ``dr_spike, islanding_noon, cold_snap, uniform_price``
   and 4 more: one graph captured, K1's launches counted against (1 + 2K) x
   96, one chunk's replay after the swap equal to the eager episode bit for
   bit, env-steps/s and the idle share beside a bare northstar runner timed
   in the same call. (c) Counters against rewards (rtol 1e-4), zero grid
   exchange in islanded slots, every slot's P2P power netting to zero. (d)
   The card against the CPU at A=6, S=8 over 4 regimes (rewards rtol
   2e-4). (e) ``evaluate_regimes`` over both portfolios at A=1000, 4
   scenarios a regime.
12. The command line (``cli.py``) on the card, in-process through
   ``cli.main`` (where the kernels' counts are read) and as ``python -m
   p2pmicrogrid_tpu_torch`` subprocesses, in a temporary directory. (a) The
   README's north-star command, ``train --agents 1000 --scenarios 128
   --shared --share-agents --chunks 8 --implementation ddpg --episodes 2
   --health-every 1 --seed 0 --results-db DB --model-dir M`` (depth cut
   from 80 chunks to 8): K1's launches against (2 x 8 + captures + 3) x 96,
   then ``train_chunked_with_health`` with the same config, seed and device:
   rewards, losses, health points and the final checkpoint's parameters
   equal bit for bit; both wall times and the seconds of the SQLite
   writes. (b) ``eval --test`` on that checkpoint (a ``test_results`` row
   for every agent and slot of the 5 test days, one ``eval_runs`` row),
   then ``telemetry-query --gauges`` joining the training run to it. (c)
   ``export-bundle``, then ``serve-gateway`` answering 32 POSTs into the
   same warehouse (32 ``serve_request`` records under the bundle's hash,
   the card named in the listening line). (d) ``train``, ``eval --test``
   and ``baseline --test`` at A=2, ``train --scenarios 4 --shared --rounds
   2 --implementation dqn`` at A=8, ``multi`` and its ``eval`` at 8 x 128,
   each one's launches equal to the library path's; ``train --supervise``
   with a one-kill fault plan (the child ``-m p2pmicrogrid_tpu_torch``
   restarted with ``--resume``). (e) ``--device cpu`` launches no kernel.
13. The continual flywheel (``data/trace_export.py``, ``train/continual.py``,
   ``serve/promotion.py``). (a) At A=3, the card against the CPU: the trace
   rewards (rtol 1e-6), a 5-step off-policy pretrain from one state and the
   same indices (tabular bit for bit, DQN and shared DDPG at rtol 1e-4,
   atol 1e-6), and the gate's decision matrix over crafted bundles on the
   modeled clocks: the same verdicts and reasons (the card's evaluations
   through K1 at [8,3]). (b) At the northstar width (A=1000, shared DDPG,
   battery on): a seed-0 actor's bundle served by the gateway on the card
   to 8 households (256 requests into a results store), the decisions
   exported as transitions, ``train_continual`` (50 trace steps, then one
   guarded chunk episode of S=64 through the chunk graph, an eval every
   episode: K1 at [64,1000] and [8,1000]) into a candidate bundle, the
   pretrain profiled for its idle share; ``run_promotion_gate`` (held-out
   evaluations through K1 at [8,1000]) with the default budgets and with
   the evaluation rules waived (the SLO bench on the card's engine), the
   bench's p50/p95 alone; ``run_promotion_pipeline`` over stages 5, 25 and
   100 on a gateway on the card: no request failed, and the bundle serving
   afterwards answers bit for bit as its own engine. K1's launches counted
   per flywheel. One ``{"flywheel": {...}}`` line.
14. The serving fleet and the autopilot (``serve/router.py``, ``faults.py``,
   ``procfleet.py``, ``proxy.py``, ``autopilot.py``); K1-K7's counts set to
   0 before (a) and read after (e): serving launches none. (a) A
   ``LocalFleet`` of three replicas on the card, each with phase 9's
   per-agent DQN (A=1000, hidden 64) and the northstar's shared DDPG actor
   (CPU seed 0): each replica's start seconds, captures and graph pool, the
   peak device memory. (b) ``serve_bench_fleet`` under ``kill_restart_plan``
   (replica-1 killed at 0.3 and restarted at 0.6 of the run), 512 requests
   at 256/s from 16 households: availability 1.0, no request failed or
   shed, the DQN answers bit for bit as its engine's act, the restarted
   replica's captures unchanged. (c) A two-phase swap DQN -> DDPG under
   traffic with no request failed (DQN answers bit for bit, DDPG's
   mismatches against one batched act counted, at most 1e-5 apart); the
   post-cycle invariant's two forms on the DDPG default; a bundle
   registered at run time under traffic (each replica's capture seconds,
   each replica's p99 before and during the captures), then swapped to,
   answers one at a time bit for bit as its engine's act alone. (d) A
   ``ProcessFleet`` of three ``serve-gateway --device cuda`` children with
   TLS and token auth: their startup seconds, the same plan (a SIGKILL and
   the supervisor's relaunch on the original ports) under the fleet bench
   (availability 1.0, bit-exact), and replica-1's answers one at a time
   after the relaunch equal to those before the kill bit for bit. (e)
   ``serve-router`` as a subprocess in front of it: 64 requests through TLS
   and household tokens (bit for bit), ``/admin/swap`` and ``/readyz``.
   (f) ``autopilot_bench`` at A=1000 (battery on; tabular, the harness's
   crafted candidates), on a thread of its own from the end of phase 12's
   north-star commands (from the start of phase 14 without phase 12), its
   fleet and its autopilot child processes beside the phases in between,
   joined after (e): three replicas, cycles ``0:good, 1:cost_regressed,
   2:nan_poisoned``, one replica killed, the autopilot SIGKILLed in
   ``retraining`` of cycle 1 and relaunched: the good candidate promoted,
   both bad ones blocked, availability 1.0, every cycle's post-cycle
   invariant and the journal's final state; K1's launches (the gate's
   evaluations at [4,1000]) summed from the cycles' rows. One ``{"fleet":
   {...}}`` line.
15. One JSON line with the DDPG rows' numbers, one with the chunked rows',
   one with the single rows', one with phase 7's rows, one with phase 8's,
   one with phase 10's (``{"recurrent": ...}``), one with phase 11's
   (``{"regimes": ...}``), phase 12's (``{"cli": ...}``), one with every
   kernel's (K1's phase-11 launches under ``at_128x1000.regime_launches``,
   each kernel's phase-12 launches under ``cli_launches``, phase 13's
   under ``flywheel_launches`` and phase 14's under
   ``autopilot_launches``), then the last
   line ``{"ok": true, "device": {...}}``.

With arguments (a comma-separated list of phase numbers, e.g. ``5``) it
builds and runs only those phases and prints no result line.

It prints no result and exits non-zero without a CUDA device, or when run
outside a checkout of the repository.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# NVIDIA H100 SXM peaks (data sheet, dense): float32 outside the tensor
# cores, and HBM3 bandwidth. Used for each kernel's bound_ms.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# The days of the synthetic traces (``synthetic_traces()``'s default, days
# 8-20), which phase 6's and phase 7's evaluations run side by side.
EVAL_DAYS = 13
# Phase 7: the JAX bench's cfg5 (benchmarks.py:631-661), 8 communities of
# 128 agents, and the independent rows' scenario count (BASELINE config 4's).
MULTI_C, MULTI_A = 8, 128
INDEPENDENT_S = 64


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


_T0 = time.perf_counter()


def log(msg: str) -> None:
    """One line on stdout; a line that is not a JSON object starts with the
    seconds since the script started."""
    print(msg if msg.startswith("{") else f"[{time.perf_counter() - _T0:7.1f}s] {msg}", flush=True)


def import_port():
    """The port from this checkout, never from elsewhere."""
    sys.path.insert(0, HERE)
    try:
        import p2pmicrogrid_tpu_torch
    except ImportError as exc:
        fail(f"the port is not beside this script ({exc}); run from a checkout")
    pkg_dir = os.path.dirname(os.path.abspath(p2pmicrogrid_tpu_torch.__file__))
    if os.path.dirname(pkg_dir) != HERE:
        fail(f"imported the port from {pkg_dir}, not from this checkout")
    return p2pmicrogrid_tpu_torch


def cuda_time_ms(fn, warmup: int = 5, iters: int = 50, reps: int = 5) -> float:
    """Time of one call in ms: CUDA events around ``iters`` back-to-back
    calls, divided by ``iters``; the median of ``reps`` such runs. Where a
    call's host-side work outlasts its device work, this measures the host."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def profile_episode(run_episode, n_slots: int, wall_unprofiled_s: float, span=None):
    """One episode under torch.profiler: device busy time, idle share, the
    kernels by device time. Returns ({kernel name: (count, device ms)}, the
    device ms of the kernels launched inside ``span``'s record_function
    ranges, or None without ``span``), or (None, None) when the profiler saw
    no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    start = time.perf_counter()
    # The host's ops are recorded only where a span needs them: their events
    # outnumber the kernels' and most of the profiler's own time goes to them.
    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if span else [])
    with profile(activities=activities) as prof:
        run_episode()
        torch.cuda.synchronize()
    wall = time.perf_counter() - start
    kernels = {}
    averages = prof.key_averages()
    # record_function ranges (the optimizers' steps, the learn step's span)
    # also show on the device's timeline as spans over their kernels: they
    # are not kernels, and counting them would count their kernels twice.
    annotations = {e.key for e in averages if getattr(e, "is_user_annotation", False)}
    for e in averages:
        if e.device_type != torch.autograd.DeviceType.CUDA or e.key in annotations:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        kernels[e.key] = (e.count, us / 1e3)
    busy_ms = sum(ms for _, ms in kernels.values())
    if busy_ms <= 0:
        log("  profile: the profiler saw no device time (not measured)")
        return None, None
    launches = sum(n for n, _ in kernels.values())
    log(
        f"  profile: device busy {busy_ms:.3f} ms over {wall * 1e3:.3f} ms "
        f"profiled wall (idle share {1 - busy_ms / (wall * 1e3):.4f}; "
        f"{1 - busy_ms / (wall_unprofiled_s * 1e3):.4f} of the unprofiled "
        f"timed episode), {launches / n_slots:.1f} device ops per slot; "
        f"{time.perf_counter() - start:.1f} s with the profiler's own work"
    )
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:8]
    for name, (n, ms) in top:
        log(f"    {ms:10.3f} ms {n:6d}x  {name[:100]}")
    return kernels, (None if span is None else span_device_ms(prof, span))


def span_device_ms(prof, span: str):
    """Device ms of the kernels launched by ops that start inside any
    ``span`` record_function range, on any thread (the backward pass runs
    on autograd's own thread, inside the range's time); None when the
    profile holds no such range."""
    import bisect

    import torch

    events = prof.events()
    cpu = torch.autograd.DeviceType.CPU
    # The range as the host entered and left it (the profiler also keeps its
    # span on the device's timeline, which lags the host's).
    ranges = sorted(
        (e.time_range.start, e.time_range.end)
        for e in events
        if e.name == span and e.device_type == cpu
    )
    if not ranges:
        return None
    starts = [a for a, _ in ranges]
    total_us = 0.0
    by_name = {}
    for e in events:
        if (
            e.device_type != cpu
            or not e.kernels
            or e.name == span
            or getattr(e, "is_user_annotation", False)
        ):
            continue
        t = e.time_range.start
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= ranges[i][1]:
            for k in e.kernels:
                total_us += k.duration
                by_name[k.name] = by_name.get(k.name, 0.0) + k.duration
    log(f"  profile: {span}: {total_us / 1e3:.3f} ms of device time in {len(ranges)} ranges")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
        log(f"    {us / 1e3:10.3f} ms  {name[:100]}")
    return total_us / 1e3


# --- phase 1 ---------------------------------------------------------------


def phase_device_and_build():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(
        f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]} device {torch.cuda.get_device_name(0)}"
    )
    from p2pmicrogrid_tpu_torch.ops import matrix_market, merged_min, slot_fused

    start = time.perf_counter()
    builds = {
        mod.LIBRARY.name: mod.LIBRARY.start_build(("-Xptxas", "-v"))
        for mod in (merged_min, matrix_market, slot_fused)
    }
    for name, proc in builds.items():
        try:
            report = proc()
        except RuntimeError as exc:
            fail(f"kernel {name} did not build: {exc}")
        for line in report.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"[{name}] {line.strip()}")
    log(f"phase 1: built {len(builds)} kernel source(s) in {time.perf_counter() - start:.1f} s")
    return card


# --- phase 2 ---------------------------------------------------------------


def merged_min_inputs(S, A, gen, case="random"):
    import torch

    r = lambda: torch.rand((S, A), generator=gen, device="cuda")
    alpha, wplus, wminus, gamma = r(), r(), r(), r()
    pb = (r() > 0.5).float()
    ps = (r() > 0.5).float()
    if case == "bf16":
        alpha, wplus, wminus, gamma = (
            x.to(torch.bfloat16).to(torch.float32) for x in (alpha, wplus, wminus, gamma)
        )
    elif case == "zero":
        alpha = torch.zeros_like(alpha)
        gamma = torch.zeros_like(gamma)
    elif case == "no_prop":
        pb = torch.zeros_like(pb)
        ps = torch.zeros_like(ps)
    elif case == "one_sided":
        gamma = torch.zeros_like(gamma)  # no sellers
        ps = torch.zeros_like(ps)
    return alpha, wplus, wminus, gamma, pb, ps


# K1's timed shapes: the shared rows' [64,1000] (the record's main shape),
# northstar's [128,1000], cfg3's [256,50], the DDPG scale row's [2048,50],
# phase 7's cfg5 training [8,128] and evaluation [104,128], phase 8's
# greedy evaluation of 8 held-out northstar scenarios, [8,1000] (bf16), and
# phase 13's greedy evaluations of the crafted A=3 bundles, [8,3] (float32).
K1_TIMED = ((64, 1000), (128, 1000), (256, 50), (2048, 50), (MULTI_C, MULTI_A),
            (EVAL_DAYS * MULTI_C, MULTI_A), (8, 1000), (8, 3), (4, 1000))


def phase_kernels():
    """K1 against its plain version; returns the kernel record."""
    import torch

    from p2pmicrogrid_tpu_torch.ops.merged_min import (
        kernel_config,
        merged_min_sums,
        merged_min_sums_plain,
    )

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    cases = [
        (64, 1000, "random"),
        (64, 1000, "bf16"),
        (128, 1000, "random"),
        (128, 1000, "bf16"),
        (256, 50, "random"),
        (2048, 50, "random"),
        (256, 50, "zero"),
        (64, 1000, "no_prop"),
        (64, 1000, "one_sided"),
        (5, 257, "random"),
        # Phase 7's multi-community shapes: cfg5's 8 communities of 128
        # agents, and its 13-day evaluation (104 rows), float32.
        (8, 128, "random"),
        (EVAL_DAYS * MULTI_C, MULTI_A, "random"),
        # Phase 8's greedy evaluation at the northstar width: 8 scenarios of
        # 1000 agents, bf16 pre-rounding (resolve_market_dtype at A >= 256).
        (8, 1000, "bf16"),
        (8, 1000, "random"),
        # Phase 13's gate evaluations of the crafted A=3 bundles: 8 held-out
        # scenarios of 3 agents, float32.
        (8, 3, "random"),
        # Phase 14's autopilot gate: its evaluations' 4 held-out scenarios
        # (Autopilot.s_eval) at the northstar width, bf16 pre-rounding.
        (4, 1000, "bf16"),
        (4, 1000, "random"),
    ]
    max_abs_err = 0.0
    timings = {}
    launch = {}
    for S, A, case in cases:
        args = merged_min_inputs(S, A, gen, case)
        row, col = merged_min_sums(*args)
        row2, col2 = merged_min_sums(*args)
        torch.cuda.synchronize()
        ref_row, ref_col = merged_min_sums_plain(*args)
        for got, ref, what in ((row, ref_row, "row"), (col, ref_col, "col")):
            if not torch.isfinite(got).all():
                fail(f"K1 {case} [{S},{A}] {what}: non-finite output")
            scale = max(float(ref.abs().max()), 1e-30)
            err = float((got - ref).abs().max())
            # Sums of up to A positive terms in another order than the plain
            # version's: rtol 1e-5, atol 1e-6 * scale.
            if not torch.allclose(got, ref, rtol=1e-5, atol=1e-6 * scale):
                fail(f"K1 {case} [{S},{A}] {what}: max abs err {err} (scale {scale})")
            max_abs_err = max(max_abs_err, err)
        if case in ("zero",) and (row.abs().max() != 0 or col.abs().max() != 0):
            fail("K1: zero factors must contribute exactly 0")
        if not (torch.equal(row, row2) and torch.equal(col, col2)):
            fail(f"K1 {case} [{S},{A}]: repeat launch not bit-identical")
        config = kernel_config(S, A, "cuda")
        launch[f"[{S},{A}]"] = config
        if case == "random" and (S, A) in K1_TIMED:
            k_ms = cuda_time_ms(lambda: merged_min_sums(*args))
            p_ms = cuda_time_ms(lambda: merged_min_sums_plain(*args))
            names = ("merged_min_tiles_kernel",) + (
                ("merged_min_colsum_kernel",) if config["colsum_kernel"] else ()
            )
            dev_ms = profiled_device_ms(lambda: merged_min_sums(*args), names)
            ops = 7.0 * S * A * A  # 2 products, 2 selects, min, 2 sums per entry
            nbytes = 4.0 * 8 * S * A  # six [S, A] inputs read, two written
            bound_ops = ops / PEAK_F32_FLOPS * 1e3
            bound_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
            timings[(S, A)] = dict(
                ms=k_ms,
                device_ms=dev_ms,
                plain_ms=p_ms,
                bound_ms=max(bound_ops, bound_bytes),
                bound_by="operations" if bound_ops >= bound_bytes else "bytes",
            )
            # For the log only, at the rate the design issues: 4 float32-pipe
            # instructions an entry (2 fused multiply-adds, 2 adds; a fused
            # multiply-add is one instruction at half the 67 TFLOP/s count),
            # its min on the other pipe.
            bound_issue = max(4.0 * S * A * A / (PEAK_F32_FLOPS / 2) * 1e3, bound_bytes)
            dev = "not measured" if dev_ms is None else f"{dev_ms:.6f} ms"
            log(
                f"K1 [{S},{A}] kernel {k_ms:.6f} ms events, {dev} device  plain "
                f"{p_ms:.6f} ms  bound {timings[(S, A)]['bound_ms']:.6f} ms "
                f"({timings[(S, A)]['bound_by']}), at the design's issue rate "
                f"{bound_issue:.6f} ms"
            )
        log(f"K1 {case:9s} [{S},{A}] ok, max abs err {err:.3e}, bit-identical repeat")
    for shape, config in launch.items():
        log(f"merged_min_sums {shape}: {config}")
    main = timings[(64, 1000)]
    return {
        "name": "merged_min_sums",
        "route": "cuda",
        "source": "p2pmicrogrid_tpu_torch/csrc/merged_min.cu",
        "replaces": "p2pmicrogrid_tpu/ops/pallas_factored.py:81",
        "launches": None,
        "max_abs_err": max_abs_err,
        "ms": main["ms"],
        "kernel_ms": main["ms"],
        "device_ms": main["device_ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": None,  # no single PyTorch call computes this pass
        "shape": [64, 1000],
        "at_128x1000": timings[(128, 1000)],
        "at_256x50": timings[(256, 50)],
        "at_2048x50": timings[(2048, 50)],
        **{f"at_{S}x{A}": timings[(S, A)] for S, A in K1_TIMED[4:]},
        "launch": launch,
    }


def matrix_inputs(S, A, dtype, gen):
    """Proposals ~1e3 W with the edge cases of tests/test_pallas.py (a zero
    row, an all-same-sign scenario, a zero out_power), a tied scenario
    (p = -p^T) and an all-zero round-0 vector."""
    import torch

    randn = lambda *shape: torch.randn(shape, generator=gen, device="cuda") * 1e3
    p2p, out, prev = randn(S, A, A), randn(S, A), randn(S, A)
    p2p[0, 0, :] = 0.0
    out[-1, 0] = 0.0
    if S > 1:
        p2p[1] = p2p[1].abs()
        p2p[-1] = p2p[-1] - p2p[-1].t()
        prev[1] = 0.0
    return p2p.to(dtype).contiguous(), out, prev


def matrix_kernel_specs():
    """K5, K4, K6, K3, K2: wrapper, plain version, arguments, what each
    output is (a matrix or a sum over A terms), the function's work (the
    float32 operations per matrix entry and the bytes it must move, each
    input read once, each output written once) and the kernels it launches
    (profiler names)."""
    from p2pmicrogrid_tpu_torch.ops import matrix_market as mm

    vec = lambda S, A: 4.0 * S * A
    mat = lambda S, A, es: float(es) * S * A * A
    # Per entry: powers (negate/scale, mask), filtered (two signs, compare,
    # select), the row total (add), the split (abs, multiply, divide,
    # select), the column mean (mask, add): 12; without the mean 10. Clearing:
    # two signs, compare, two abs, min, sign product, subtract, two adds: 10.
    return [
        dict(name="divide_rank1_fused", fn=mm.divide_rank1_fused,
             plain=mm.divide_rank1_fused_plain,
             args=lambda p2p, out, prev, dt: (prev, out, dt), outputs=("matrix", "mean"),
             replaces="p2pmicrogrid_tpu/ops/pallas_market.py:254", ops=12,
             nbytes=lambda S, A, es: 2 * vec(S, A) + mat(S, A, es) + vec(S, A),
             kernels=("divide_rank1_stripe_kernel", "column_mean_kernel")),
        dict(name="divide_power_fused_with_mean", fn=mm.divide_power_fused_with_mean,
             plain=mm.divide_power_fused_with_mean_plain,
             args=lambda p2p, out, prev, dt: (p2p, out), outputs=("matrix", "mean"),
             replaces="p2pmicrogrid_tpu/ops/pallas_market.py:227", ops=12,
             nbytes=lambda S, A, es: 2 * mat(S, A, es) + 2 * vec(S, A),
             kernels=("divide_mean_stripe_kernel", "column_mean_kernel")),
        dict(name="clear_market_fused", fn=mm.clear_market_fused,
             plain=mm.clear_market_fused_plain,
             args=lambda p2p, out, prev, dt: (p2p,), outputs=("rowsum", "rowsum"),
             replaces="p2pmicrogrid_tpu/ops/pallas_market.py:282", ops=10,
             nbytes=lambda S, A, es: mat(S, A, es) + 2 * vec(S, A),
             kernels=("clear_tiles_kernel", "clear_sums_kernel")),
        dict(name="divide_power_fused", fn=mm.divide_power_fused,
             plain=mm.divide_power_fused_plain,
             args=lambda p2p, out, prev, dt: (p2p, out), outputs=("matrix",),
             replaces="p2pmicrogrid_tpu/ops/pallas_market.py:211", ops=10,
             nbytes=lambda S, A, es: 2 * mat(S, A, es) + vec(S, A),
             kernels=("split_kernel",)),
        dict(name="prep_mean", fn=mm.prep_mean, plain=mm.prep_mean_plain,
             args=lambda p2p, out, prev, dt: (p2p,), outputs=("colsum",),
             replaces="p2pmicrogrid_tpu/ops/pallas_market.py:194", ops=2,
             nbytes=lambda S, A, es: mat(S, A, es) + vec(S, A),
             kernels=("split_kernel",)),
    ]


def check_matrix_output(label, kind, got, ref, terms):
    """The kernel's output against the plain version's; returns the largest
    absolute difference. Matrices: float32 rtol=1e-5, atol=1e-3
    (tests/test_pallas.py:55-98), bfloat16 one ulp (rtol=8e-3, the unrounded
    values may differ in their last bits). Sums of A terms in another order
    than torch.sum's: rtol=1e-5, atol=1e-6 times the largest sum of
    magnitudes (results may cancel to 0)."""
    import torch

    if got.dtype != ref.dtype or got.shape != ref.shape:
        fail(f"{label}: {got.dtype}{tuple(got.shape)} vs plain {ref.dtype}{tuple(ref.shape)}")
    g, r = got.float(), ref.float()
    if not torch.isfinite(g).all():
        fail(f"{label}: non-finite output")
    if kind == "matrix":
        rtol, atol = (1e-5 if got.dtype == torch.float32 else 8e-3), 1e-3
    else:
        rtol, atol = 1e-5, 1e-6 * float(terms.abs().sum(dim=-1).max())
    err = float((g - r).abs().max())
    if not torch.allclose(g, r, rtol=rtol, atol=atol):
        fail(f"{label}: max abs err {err} (rtol {rtol}, atol {atol})")
    return err


def phase_matrix_kernels():
    """K5, K4, K6, K3 and K2 against their plain versions; returns their
    records, K5, K4, K6 (the matrix path) first. K5's, K4's and K6's records
    also carry each timed shape's launch (design, grid, threads, shared
    memory a block), and K5's and K4's their dispatch at every case (stripe
    rows, or the two-pass kernel). K5's matrix must equal its two-pass
    kernel's bit for bit at every case, its bfloat16 entries that differ
    from the plain version at [64,1000] must stay at or below the two-pass
    kernel's 167 at this seed, and its two-pass kernel is timed beside
    it."""
    import torch

    from p2pmicrogrid_tpu_torch.ops import matrix_market as mm

    gen = torch.Generator(device="cuda")
    gen.manual_seed(4321)
    bf16, f32 = torch.bfloat16, torch.float32
    # The single community's shapes (phase 6): one community of 2 or 10
    # agents, and the evaluation's days side by side; then the independent
    # rows' 64 communities of 2 or 10 agents (phase 7).
    cases = [
        (64, 1000, bf16), (64, 1000, f32), (256, 50, f32), (5, 257, bf16), (5, 257, f32),
        (2, 65, f32), (3, 7, f32), (3, 7, bf16), (1, 50, f32), (2, 1, f32),
        (1, 2, f32), (1, 10, f32), (EVAL_DAYS, 2, f32),
        (INDEPENDENT_S, 2, f32), (INDEPENDENT_S, 10, f32),
    ]
    redesigned = ("divide_rank1_fused", "divide_power_fused_with_mean", "clear_market_fused")
    timed = {
        (64, 1000, bf16): "main", (64, 1000, f32): "at_64x1000_f32", (256, 50, f32): "at_256x50",
        (1, 2, f32): "at_1x2", (1, 10, f32): "at_1x10", (EVAL_DAYS, 2, f32): f"at_{EVAL_DAYS}x2",
        (INDEPENDENT_S, 2, f32): f"at_{INDEPENDENT_S}x2", (INDEPENDENT_S, 10, f32): f"at_{INDEPENDENT_S}x10",
    }
    specs = matrix_kernel_specs()
    records = {
        sp["name"]: {
            "name": sp["name"], "route": "cuda",
            "source": "p2pmicrogrid_tpu_torch/csrc/matrix_market.cu",
            "replaces": sp["replaces"], "launches": None, "max_abs_err": 0.0,
            "library_ms": None,  # no single PyTorch call computes this pass
            "bf16_entries_differ": 0,
        }
        for sp in specs
    }
    for name in redesigned:
        records[name]["launch"] = {}
    k5 = records["divide_rank1_fused"]
    for name in ("divide_rank1_fused", "divide_power_fused_with_mean"):
        records[name]["dispatch"] = {}
    bits = lambda x: x.view(torch.int16 if x.element_size() == 2 else torch.int32)
    for S, A, dt in cases:
        p2p, out, prev = matrix_inputs(S, A, dt, gen)
        for name in ("divide_rank1_fused", "divide_power_fused_with_mean"):
            rows = mm.kernel_config(name, S, A, dt, "cuda")["rows"]
            records[name]["dispatch"][f"[{S},{A}] {str(dt)[6:]}"] = (
                f"stripe of {rows} rows" if rows else "two-pass split_kernel"
            )
        terms = {
            "rowsum": p2p.float(),
            "colsum": p2p.float().transpose(-1, -2) / A,
        }
        for sp in specs:
            rec = records[sp["name"]]
            args = sp["args"](p2p, out, prev, dt)
            got, again = sp["fn"](*args), sp["fn"](*args)
            torch.cuda.synchronize()
            ref = sp["plain"](*args)
            got, again, ref = (x if isinstance(x, tuple) else (x,) for x in (got, again, ref))
            label = f"{sp['name']} [{S},{A}] {str(dt)[6:]}"
            for g, a in zip(got, again):
                if not torch.equal(g, a):
                    fail(f"{label}: repeat launch not bit-identical")
            for kind, g, r in zip(sp["outputs"], got, ref):
                if kind == "mean":
                    t = ref[0].float().transpose(-1, -2) / A
                else:
                    t = terms.get(kind)
                err = check_matrix_output(label, kind, g, r, t)
                rec["max_abs_err"] = max(rec["max_abs_err"], err)
                if kind == "matrix" and g.dtype == bf16:
                    rec["bf16_entries_differ"] += int((g != r).sum())
            if rec is k5:
                two_pass = lambda: mm._divide_rank1(prev, out, dt, two_pass=True)
                if not torch.equal(bits(got[0]), bits(two_pass()[0])):
                    fail(f"{label}: the matrix differs from the two-pass kernel's")
                if (S, A, dt) == (64, 1000, bf16):
                    k5["bf16_entries_differ_64x1000"] = n = int((got[0] != ref[0]).sum())
                    if n > 167:
                        fail(f"{label}: {n} bf16 entries differ from the plain version (two-pass: 167)")
            where = timed.get((S, A, dt))
            if where is not None:
                k_ms = cuda_time_ms(lambda: sp["fn"](*args))
                p_ms = cuda_time_ms(lambda: sp["plain"](*args), iters=10)
                dev_ms = profiled_device_ms(lambda: sp["fn"](*args), sp["kernels"])
                es = torch.finfo(dt).bits // 8
                bound_ops = sp["ops"] * S * A * A / PEAK_F32_FLOPS * 1e3
                bound_bytes = sp["nbytes"](S, A, es) / PEAK_BYTES_PER_S * 1e3
                t = dict(
                    ms=k_ms, device_ms=dev_ms, plain_ms=p_ms,
                    bound_ms=max(bound_ops, bound_bytes),
                    bound_by="operations" if bound_ops >= bound_bytes else "bytes",
                )
                if rec is k5:
                    t["two_pass_ms"] = cuda_time_ms(two_pass)
                    t["two_pass_device_ms"] = profiled_device_ms(
                        two_pass, ("split_kernel", "column_mean_kernel")
                    )
                    log(
                        f"{label}: the two-pass kernel {t['two_pass_ms']:.6f} ms "
                        f"events, {t['two_pass_device_ms']} ms device"
                    )
                if where == "main":
                    rec.update(t, shape=[S, A], dtype="bfloat16")
                else:
                    rec[where] = t
                if sp["name"] in redesigned:
                    rec["launch"][f"[{S},{A}] {str(dt)[6:]}"] = mm.kernel_config(
                        sp["name"], S, A, dt, "cuda"
                    )
                dev = "not measured" if dev_ms is None else f"{dev_ms:.6f} ms"
                log(
                    f"{sp['name']} [{S},{A}] {str(dt)[6:]} kernel {k_ms:.6f} ms events, "
                    f"{dev} device  plain {p_ms:.6f} ms  bound {t['bound_ms']:.3e} ms "
                    f"({t['bound_by']})"
                )
        log(f"matrix kernels [{S},{A}] {str(dt)[6:]} ok, bit-identical repeats")
    for rec in records.values():
        log(
            f"{rec['name']}: max abs err {rec['max_abs_err']:.3e}, bf16 matrix "
            f"entries that differ from the plain version {rec['bf16_entries_differ']}"
        )
    for name in redesigned:
        for shape, config in records[name]["launch"].items():
            log(f"{name} {shape}: {config}")
    for name in ("divide_rank1_fused", "divide_power_fused_with_mean"):
        log(f"{name} dispatch: {records[name]['dispatch']}")
    log(
        f"divide_rank1_fused: {k5['bf16_entries_differ_64x1000']} of {64 * 1000 * 1000} bf16 "
        f"entries differ from the plain version at [64,1000] (the two-pass kernel: 167)"
    )
    return [records[sp["name"]] for sp in specs]


def profiled_device_ms(fn, match, calls: int = 10, attempts: int = 3):
    """Device time per call of ``fn`` over ``calls`` calls under
    torch.profiler: for each name in ``match`` (a string or a tuple), the
    kernels whose name contains it, per launch, summed over the names (each
    launched once per call); None when the profiler saw none of them in
    ``attempts`` profiles (it sometimes records no kernel of a window)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    names = (match,) if isinstance(match, str) else match
    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        per_call = 0.0
        for name in names:
            total, n = 0.0, 0
            for e in prof.key_averages():
                if e.device_type == torch.autograd.DeviceType.CUDA and name in e.key:
                    us = getattr(e, "self_device_time_total", None)
                    total += e.self_cuda_time_total if us is None else us
                    n += e.count
            if not n:
                break
            per_call += total / n / 1e3
        else:
            return per_call
    return None


def slot_config(tc, impl, S, A, rounds, market):
    """K7's configuration; ``market`` None is the no-trading community."""
    return tc.default_config(
        sim=tc.SimConfig(
            n_agents=A, n_scenarios=S, rounds=rounds, trading=market is not None,
            market_impl=market or "auto",
        ),
        battery=tc.BatteryConfig(enabled=True),
        train=tc.TrainConfig(implementation=impl),
    )


def slot_inputs(cfg, gen, t=44, epsilon=0.3, per_scenario=False):
    """One slot's inputs on the card: the path's traces and ratings at slot
    ``t`` (11:00, when every agent's PV exceeds its load), a random Q-table
    (tabular) or freshly initialised networks (DQN), one learner for every
    scenario or, with ``per_scenario``, S * A of them (the independent
    trainer's, scenario-major), random initial
    temperatures and draws; epsilon 0.3, so that greedy and explored agents
    both occur. Half of the batteries are full and the others anywhere in
    [min_soc, max_soc]: a full battery cannot store the surplus, so its agent
    sells unless its heat pump uses it, and the market is two-sided."""
    import numpy as np
    import torch

    from p2pmicrogrid_tpu_torch.envs import community as com
    from p2pmicrogrid_tpu_torch.parallel import (
        init_independent_state,
        make_scenario_traces,
        stack_scenario_arrays,
    )
    from p2pmicrogrid_tpu_torch.train import init_policy_state

    S, A = cfg.sim.n_scenarios, cfg.sim.n_agents
    ratings = com.make_ratings(cfg, np.random.default_rng(cfg.train.seed))
    arrays = stack_scenario_arrays(cfg, make_scenario_traces(cfg, seed=cfg.train.seed), ratings, "cuda")
    xs = tuple(x[:, t].contiguous() for x in arrays)
    if per_scenario:
        pol = init_independent_state(cfg, S, "cuda", gen)
    else:
        pol = init_policy_state(cfg, device="cuda", generator=gen)
    if cfg.train.implementation == "tabular":
        pol = pol._replace(q_table=torch.randn(pol.q_table.shape, generator=gen, device="cuda") * 0.1)
    pol = pol._replace(epsilon=torch.tensor(epsilon, device="cuda"))
    normals = torch.randn((S, 2, A), generator=gen, device="cuda")
    phys = com.init_physical(cfg, normals, (S,), "cuda")
    bat = cfg.battery
    u = torch.rand((S, A), generator=gen, device="cuda")
    phys = phys._replace(soc=torch.clamp(bat.min_soc + (bat.max_soc - bat.min_soc) * 2 * u, max=bat.max_soc))
    R = cfg.sim.rounds + 1 if cfg.sim.trading else 1
    draws = (
        torch.rand((R, S, A), generator=gen, device="cuda"),
        torch.randint(0, 3, (R, S, A), generator=gen, device="cuda"),
    )
    market = com.resolve_market_impl(cfg, "cuda") if cfg.sim.trading else None
    f_dtype = (
        torch.bfloat16
        if market == "factored" and com.resolve_market_dtype(cfg, "cuda") == "bfloat16"
        else None
    )
    return (pol, phys, xs, draws, com.ratings_to(ratings, "cuda"), True, market, f_dtype)


def two_sided(ref):
    """(whether buyers and sellers both trade and at least 2% of the agents
    do, the share that trades) in the plain version's result."""
    p = ref.p_p2p
    share = float((p != 0).float().mean())
    return bool((p > 0).any()) and bool((p < 0).any()) and share >= 0.02, share


def trading_share(what, ref):
    """The share of agents that trade peer to peer in the plain version's
    result; fails unless buyers and sellers both trade and at least 2% of
    the agents do, so that the comparison runs the clearing on real work."""
    ok, share = two_sided(ref)
    if not ok:
        fail(f"{what}: a one-sided market ({share:.4f} of the agents trade): the inputs test nothing")
    return share


def p2p_bin(cfg, feat):
    import torch

    n = cfg.qlearning.num_p2p_states
    return torch.clamp((((feat + 1.0) * 0.5) * n).to(torch.int32), 0, n - 1)


def explain_flips(cfg, args, got, ref):
    """Every decision the kernel and the plain version take differently, each
    with its cause, or "unexplained": "cascade" (an earlier round of the same
    scenario already differs, so its sums differ), "bin edge" (tabular: the
    round's p2p feature, summed in another order, falls in another bin) or
    "near tie" (DQN: the plain version's two Q-values differ by at most 1e-4
    of their size, and the forwards sum in another order)."""
    import torch

    from p2pmicrogrid_tpu_torch.models.dqn import _q_all_actions
    from p2pmicrogrid_tpu_torch.ops import slot_fused as sf
    from p2pmicrogrid_tpu_torch.parallel import scenario_learners

    flips = (got.decisions != ref.decisions).nonzero().tolist()  # [s, r, a]
    causes = {}
    first_round = {}
    for s, r, a in flips:
        first_round[s] = min(first_round.get(s, r), r)
    feats = {}

    def round_features(r):
        # The round-r features of both versions: the same slot cut to r
        # rounds (and its first r + 1 rounds of draws), whose last feature is
        # round r's.
        if r not in feats:
            cut = dataclasses.replace(cfg, sim=dataclasses.replace(cfg.sim, rounds=r))
            u, rand = args[3]
            cut_args = args[:3] + ((u[: r + 1].contiguous(), rand[: r + 1].contiguous()),) + args[4:]
            feats[r] = (sf.slot_raw(cut, *cut_args), sf.slot_step_fused_plain(cut, *cut_args))
        return feats[r]

    for s, r, a in flips:
        if first_round[s] < r:
            cause = "cascade"
        elif cfg.train.implementation == "tabular":
            k, p = round_features(r) if r > 0 else (got, ref)
            kf = k.f_p2p[s, a] if r > 0 else torch.zeros(())
            pf = p.f_p2p[s, a] if r > 0 else torch.zeros(())
            cause = "bin edge" if p2p_bin(cfg, kf) != p2p_bin(cfg, pf) else "unexplained"
        else:
            _, p = round_features(r) if r > 0 else (got, ref)
            p2p = p.f_p2p[s] if r > 0 else torch.zeros_like(p.f_p2p[s])
            obs = torch.stack([p.f_time[s], p.f_temp[s], p.f_bal[s], p2p], dim=-1)
            S, A = p.f_p2p.shape
            pol = args[0]
            if sf.per_scenario_learners(cfg, pol, S, A):
                pol = scenario_learners(pol, s, A)
            with torch.no_grad():
                q = _q_all_actions(cfg.dqn, pol.online, obs[None])[0, a]
            hp = float(cfg.thermal.hp_max_power)
            ia = int(round(float(got.decisions[s, r, a]) / hp * 2))
            ib = int(round(float(ref.decisions[s, r, a]) / hp * 2))
            gap = abs(float(q[ia] - q[ib]))
            cause = "near tie" if gap <= 1e-4 * float(q.abs().max()) else "unexplained"
        causes[(s, r, a)] = cause
    return causes


# (label, implementation, S, A, rounds, market, timed): K7 at the main path's
# shapes (tabular factored with bf16 pre-rounding at [64,1000], float32 at
# [256,50], DQN factored at [64,1000]), the matrix negotiation at rounds=2,
# and small ragged edge cases of every variant (the matrix chain at depth 3
# at rounds=3).
SLOT_CASES = (
    ("tabular factored bf16", "tabular", 64, 1000, 1, "factored", "main"),
    ("tabular factored", "tabular", 256, 50, 1, "factored", "at_256x50"),
    ("dqn factored bf16", "dqn", 64, 1000, 1, "factored", "dqn_64x1000"),
    ("tabular matrix rounds=2", "tabular", 64, 1000, 2, "matrix", "matrix_r2_64x1000"),
    ("dqn matrix rounds=2", "dqn", 4, 300, 2, "matrix", None),
    ("tabular factored rounds=0", "tabular", 3, 257, 0, "factored", None),
    ("dqn factored rounds=0", "dqn", 3, 37, 0, "factored", None),
    ("tabular no trading", "tabular", 5, 33, 1, None, None),
    ("dqn no trading", "dqn", 2, 7, 1, None, None),
    ("tabular matrix rounds=3", "tabular", 3, 129, 3, "matrix", None),
    # The single community (phase 6): one scenario of 2 or 10 agents, the
    # matrix negotiation, and no trading.
    ("single tabular matrix", "tabular", 1, 2, 1, "matrix", "single_1x2"),
    ("single dqn matrix", "dqn", 1, 2, 1, "matrix", None),
    ("single tabular matrix", "tabular", 1, 10, 1, "matrix", "single_1x10"),
    ("single dqn matrix", "dqn", 1, 10, 1, "matrix", None),
    ("single tabular matrix rounds=2", "tabular", 1, 2, 2, "matrix", None),
    ("single tabular matrix rounds=2", "tabular", 1, 10, 2, "matrix", None),
    ("single dqn matrix rounds=2", "dqn", 1, 10, 2, "matrix", None),
    ("single tabular no trading", "tabular", 1, 2, 1, None, None),
    ("single dqn no trading", "dqn", 1, 10, 1, None, None),
    # The fused evaluation's 13 days of 2 agents side by side (phase 6).
    ("evaluation tabular matrix", "tabular", EVAL_DAYS, 2, 1, "matrix", f"single_{EVAL_DAYS}x2"),
)
# K7 with one learner per scenario (the independent trainer, phase 7): the
# rows' 64 communities of 2 agents, and 8 of 10, each held to the plain
# version and, scenario by scenario, to K7 at [1, A] bit for bit.
STRIDED_CASES = (
    ("strided tabular matrix", "tabular", INDEPENDENT_S, 2, 1, "matrix", f"strided_{INDEPENDENT_S}x2"),
    ("strided dqn matrix", "dqn", INDEPENDENT_S, 2, 1, "matrix", f"strided_dqn_{INDEPENDENT_S}x2"),
    ("strided tabular matrix", "tabular", 8, 10, 1, "matrix", None),
    ("strided dqn matrix", "dqn", 8, 10, 1, "matrix", None),
    ("strided tabular matrix rounds=2", "tabular", INDEPENDENT_S, 2, 2, "matrix", None),
)
# The slots a one-community case draws its inputs at, in turn, until buyers
# and sellers meet (11:00 first, then other hours with PV): one community of
# 2 agents trades at a share of its draws only.
TRADING_SLOTS = (44, 48, 40, 52, 36, 56, 42, 46, 50, 54, 38, 58)


def slot_bound(cfg, S, A, R, impl, market, learners=None):
    """K7's least time: each input read once and each output written once
    (the Q-table rows this run reads, not the table; the DQN weights of its
    ``learners`` once, A of them unless given),
    against the float32 operations: the merged min (7 per entry of each
    scenario's A x A), the matrix rounds (about 13 per entry and round after
    the first, 1 for round 0's split, 10 for the clearing), the DQN forwards
    (3 per agent and round, 2 * 4480 each)."""
    vec = 4.0 * S * A
    nbytes = 8 + 8 * S + 4 * A + 6 * vec + 12.0 * R * S * A + 14 * vec + R * vec
    if impl == "tabular":
        nbytes += 12.0 * R * S * A
    else:
        nbytes += 4.0 * (learners or A) * (5 * 64 + 64 + 64 * 64 + 64 + 64 + 1)
    ops = 0.0
    if market == "factored":
        ops += 7.0 * S * A * A
    elif market == "matrix":
        ops += (1 + 13 * (R - 1) + 10) * float(S) * A * A
    if impl == "dqn":
        ops += 3 * 2 * 4480.0 * R * S * A
    bound_ops = ops / PEAK_F32_FLOPS * 1e3
    bound_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(bound_ops, bound_bytes), ("operations" if bound_ops >= bound_bytes else "bytes")


def check_scenario_by_scenario(what, cfg, args, got):
    """K7 with one learner per scenario against K7 at [1, A] with each
    scenario's learners alone: bit for bit."""
    import torch

    from p2pmicrogrid_tpu_torch.ops import slot_fused as sf
    from p2pmicrogrid_tpu_torch.parallel import scenario_learners

    pol, phys, xs, draws, ratings, *rest = args
    S, A = xs[2].shape
    for s in range(S):
        one = lambda tree: type(tree)(*(x[s : s + 1] for x in tree))
        alone = sf.slot_raw(
            cfg, scenario_learners(pol, s, A), one(phys), tuple(x[s : s + 1] for x in xs),
            tuple(d[:, s : s + 1].contiguous() for d in draws), ratings, *rest,
        )
        for name, g, a in zip(sf.SlotRaw._fields, got, alone):
            if not torch.equal(g[s : s + 1], a):
                fail(f"{what}: {name} of scenario {s} differs from K7 at [1,{A}] with its learners")
    log(f"{what}: each of the {S} scenarios equals K7 at [1,{A}] with its learners, bit for bit")


def phase_slot_kernel():
    """K7 against its plain version on the same card inputs; returns its
    record."""
    import torch

    from p2pmicrogrid_tpu_torch import config as tc
    from p2pmicrogrid_tpu_torch.ops import slot_fused as sf

    gen = torch.Generator(device="cuda")
    gen.manual_seed(2468)
    rec = {
        "name": "slot_step_fused", "route": "cuda",
        "source": "p2pmicrogrid_tpu_torch/csrc/slot_fused.cu",
        "replaces": "p2pmicrogrid_tpu/ops/pallas_slot.py:380",
        "launches": None, "max_abs_err": 0.0,
        "library_ms": None,  # no single PyTorch call computes a whole slot
        "decisions": 0, "decisions_differ": 0, "causes": {}, "grids": {},
    }
    cases = [c + (False,) for c in SLOT_CASES] + [c + (True,) for c in STRIDED_CASES]
    for label, impl, S, A, rounds, market, timed, per_scenario in cases:
        cfg = slot_config(tc, impl, S, A, rounds, market)
        # One community, or a batch of communities of few agents each, draws
        # again, at the next slot of TRADING_SLOTS, until its market is
        # two-sided; a batch of larger communities takes its first draw.
        few = (S == 1 or A <= 10) and market is not None
        for t in TRADING_SLOTS if few else TRADING_SLOTS[:1]:
            args = slot_inputs(cfg, gen, t=t, per_scenario=per_scenario)
            ref = sf.slot_step_fused_plain(cfg, *args)
            if market is None or two_sided(ref)[0]:
                break
        got = sf.slot_raw(cfg, *args)
        again = sf.slot_raw(cfg, *args)
        torch.cuda.synchronize()
        what = f"K7 {label} [{S},{A}] slot {t}"
        grid = sf.kernel_grid(cfg, S, A, market, per_scenario)
        rec["grids"][f"{label} [{S},{A}]"] = grid
        log(
            f"{what}: cooperative grid {grid['blocks']} blocks of 256 threads, "
            f"{grid['blocks_per_sm']} per SM on {grid['sms']} SMs, "
            f"{grid['smem_bytes']} B shared memory per block"
        )
        if per_scenario:
            # One learner per scenario, A at most one clearing tile (64): one
            # work item per scenario in every phase, and one per learner in
            # the DQN act (slot_fused.cu, max_items). At [64, 2] that is
            # fewer items than SMs, and the grid is sized to them.
            designed = S * A if impl == "dqn" else S
            if grid["blocks"] != min(designed, grid["blocks_per_sm"] * grid["sms"]):
                fail(f"{what}: a grid of {grid['blocks']} blocks, designed for {designed} work items")
        elif S >= 64 and grid["blocks"] < grid["sms"]:
            fail(f"{what}: the grid of {grid['blocks']} blocks leaves SMs idle")
        traded = "no market" if market is None else f"{trading_share(what, ref):.4f} of the agents trade"
        for name, g, a, r in zip(sf.SlotRaw._fields, got, again, ref):
            if not torch.equal(g, a):
                fail(f"{what}: {name}: repeat launch not bit-identical")
            if g.shape != r.shape or not torch.isfinite(g).all():
                fail(f"{what}: {name}: shape {tuple(g.shape)} vs {tuple(r.shape)} or non-finite")
        causes = explain_flips(cfg, args, got, ref)
        bad = [k for k, c in causes.items() if c == "unexplained"]
        if bad:
            fail(f"{what}: {len(bad)} decisions differ without a bin edge, near tie or cascade: {bad[:5]}")
        n_dec = got.decisions.numel()
        rec["decisions"] += n_dec
        rec["decisions_differ"] += len(causes)
        for c in causes.values():
            rec["causes"][c] = rec["causes"].get(c, 0) + 1
        # Continuous outputs where every decision of the scenario agrees:
        # rtol=1e-5, atol=1e-3 (the JAX fused kernel's contract); sums over
        # agents and the DQN forward run in another order.
        same = ~(got.decisions != ref.decisions).any(dim=(1, 2))
        err = 0.0
        for name in sf.SlotRaw._fields:
            g, r = getattr(got, name)[same], getattr(ref, name)[same]
            if name in ("aux", "hp_frac", "decisions") and not torch.equal(g, r):
                fail(f"{what}: {name} differs in a scenario whose decisions agree")
            if not torch.allclose(g, r, rtol=1e-5, atol=1e-3):
                fail(f"{what}: {name}: max abs err {float((g - r).abs().max())}")
            if g.numel():
                err = max(err, float((g - r).abs().max()))
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        if per_scenario:
            check_scenario_by_scenario(what, cfg, args, got)
        log(
            f"{what}: bit-identical repeat, {len(causes)} of {n_dec} decisions differ "
            f"from the plain version ({sorted(causes.values())}), max abs err {err:.3e} "
            f"in the {int(same.sum())} of {S} scenarios whose decisions agree; {traded}"
        )
        if timed:
            R = got.decisions.shape[1]
            k_ms = cuda_time_ms(lambda: sf.slot_raw(cfg, *args))
            p_ms = cuda_time_ms(lambda: sf.slot_step_fused_plain(cfg, *args), warmup=2, iters=5, reps=3)
            dev_ms = profiled_device_ms(lambda: sf.slot_raw(cfg, *args), "slot_fused_kernel")
            bound, by = slot_bound(cfg, S, A, R, impl, market, S * A if per_scenario else None)
            t = dict(ms=k_ms, plain_ms=p_ms, bound_ms=bound, bound_by=by, profiled_ms=dev_ms,
                     shape=[S, A], config=label)
            if timed == "main":
                rec.update(t)
            else:
                rec[timed] = t
            dev = "not measured" if dev_ms is None else f"{dev_ms:.6f} ms"
            log(
                f"{what}: kernel {k_ms:.6f} ms (events, 50 calls), device {dev}, plain "
                f"{p_ms:.6f} ms, bound {bound:.3e} ms ({by})"
            )
        del args, got, again, ref
        torch.cuda.empty_cache()
    share = rec["decisions_differ"] / rec["decisions"]
    if share >= 1e-4:
        fail(f"K7: {rec['decisions_differ']} of {rec['decisions']} decisions differ (share {share:.2e} >= 1e-4)")
    rec["decisions_differ_share"] = share
    log(f"K7: {rec['decisions_differ']} of {rec['decisions']} decisions differ, share {share:.3e}")
    return rec


# --- phase 3 ---------------------------------------------------------------


def small_config(tc, A, S, rounds, market_impl, impl="tabular"):
    # DQN explores with epsilon 0.5 from the start, so greedy actions occur.
    return tc.default_config(
        sim=tc.SimConfig(n_agents=A, n_scenarios=S, rounds=rounds, market_impl=market_impl),
        battery=tc.BatteryConfig(enabled=True),
        train=tc.TrainConfig(implementation=impl),
        dqn=tc.DQNConfig(warmup_passes=1, epsilon=0.5),
    )


def small_draws(cfg, n_passes, T, seed=0):
    """Numpy draws for ``n_passes`` passes of T slots: per pass (uniform,
    randint, normals, replay indices [T, B] in the ring's filled region)."""
    import numpy as np

    S, A, R = cfg.sim.n_scenarios, cfg.sim.n_agents, cfg.sim.rounds + 1
    rng = np.random.default_rng(seed)
    out = []
    for e in range(n_passes):
        counts = [min(e * T + t + 1, cfg.dqn.buffer_size) for t in range(T)]
        out.append((
            rng.uniform(size=(T, R, S, A)).astype(np.float32),
            rng.integers(0, 3, (T, R, S, A)).astype(np.int64),
            rng.standard_normal((S, 2, A)).astype(np.float32),
            np.stack([rng.integers(0, c, cfg.dqn.batch_size) for c in counts]),
        ))
    return out


def run_slots(cfg, device, draws_np, ratings, n_episodes, fused=False):
    """Per-slot actions, per-episode rewards and the final learner state (the
    Q-table, or DQN's online parameters) of the port's slot loop; DQN runs
    one record-only warmup pass first, on the first of ``draws_np``."""
    import numpy as np
    import torch

    from p2pmicrogrid_tpu_torch.convert import state_from_jax, state_to_numpy
    from p2pmicrogrid_tpu_torch.envs import community as com
    from p2pmicrogrid_tpu_torch.models.dqn import dqn_initialize_target
    from p2pmicrogrid_tpu_torch.parallel import scenarios as sc
    from p2pmicrogrid_tpu_torch.train import make_policy

    S, A = cfg.sim.n_scenarios, cfg.sim.n_agents
    dqn = cfg.train.implementation == "dqn"
    policy = make_policy(cfg)
    # The same initial weights on both devices: drawn on the CPU, copied.
    gen = torch.Generator().manual_seed(5)
    pol, scen = sc.init_shared_state(cfg, device="cpu", generator=gen)
    if device != "cpu":
        move = lambda st: state_from_jax(state_to_numpy(st), device=device, cfg=cfg.dqn)
        pol, scen = move(pol), (None if scen is None else move(scen))
    arrays = sc.stack_scenario_arrays(cfg, sc.make_scenario_traces(cfg, seed=0), ratings, device)
    xs = [x.transpose(0, 1).contiguous() for x in arrays]
    ratings_d = com.ratings_to(ratings, device)
    actions, rewards = [], []
    passes = ["warmup"] * dqn + ["learn"] * n_episodes
    for e, mode in enumerate(passes):
        u, r, z, idx = (torch.from_numpy(x).to(device) for x in draws_np[e])
        phys = com.init_physical(cfg, z, (S,), device=device)
        rew = torch.zeros(S, device=device)
        for t in range(xs[0].shape[0]):
            phys, _, out, tr, _ = com.slot_dynamics_batched(
                cfg, policy, pol, phys, tuple(x[t] for x in xs), (u[t], r[t]),
                ratings_d, explore=True, fused=fused,
            )
            if not dqn:
                pol, _ = sc._tabular_update_shared(cfg, pol, tr)
            elif mode == "warmup":
                scen = sc._record_shared(scen, tr)
            else:
                pol, scen, _ = sc._dqn_update_shared(cfg, pol, scen, tr, idx[t])
            actions.append(tr.aux)
            rew += out.reward.mean(dim=-1)
        if mode == "warmup":
            pol = dqn_initialize_target(pol)
        else:
            rewards.append(rew)
            pol = policy.decay(pol)
    final = pol.online.Dense_0.kernel if dqn else pol.q_table
    return (
        torch.stack(actions).cpu().numpy(),
        torch.stack(rewards).cpu().numpy(),
        final.detach().cpu().numpy(),
    )


def ddpg_small_config(tc, share, batch, cap, rounds, market_impl, A=6, S=3):
    """A=6, S=3 shared DDPG with full batteries (the CPU tests' config)."""
    return tc.default_config(
        sim=tc.SimConfig(n_agents=A, n_scenarios=S, rounds=rounds, market_impl=market_impl),
        battery=tc.BatteryConfig(enabled=True, init_soc=0.9),
        train=tc.TrainConfig(implementation="ddpg"),
        ddpg=tc.DDPGConfig(
            buffer_size=16, batch_size=batch, share_across_agents=share,
            learn_batch_cap=cap, noise_decay=0.9,
        ),
    )


def ddpg_small_draws(cfg, n_passes, T, seed=0):
    """Numpy draws for ``n_passes`` DDPG passes of T slots: per pass the
    initial-temperature normals, OU normals [T, R, S, A], replay indices
    [T, B] in the ring's filled region, and stripe offsets [T, n] where the
    cap stripes the pooled batch."""
    import numpy as np

    from p2pmicrogrid_tpu_torch.parallel import scenarios as sc

    S, A, R = cfg.sim.n_scenarios, cfg.sim.n_agents, cfg.sim.rounds + 1
    d = cfg.ddpg
    stripes = sc.ddpg_stripes(cfg, S, A)
    rng = np.random.default_rng(seed)
    out = []
    for e in range(n_passes):
        counts = [min(e * T + t + 1, d.buffer_size) for t in range(T)]
        out.append(dict(
            normals=rng.standard_normal((S, 2, A)).astype(np.float32),
            ou=rng.standard_normal((T, R, S, A)).astype(np.float32),
            idx=np.stack([rng.integers(0, c, d.batch_size) for c in counts]),
            starts=None if stripes is None else rng.integers(
                0, d.batch_size * S * A, (T, stripes[0])
            ),
        ))
    return out


def run_ddpg_slots(cfg, device, draws_np, ratings, t0):
    """Per-slot actions, per-episode rewards and the final actor's first
    layer of the port's shared DDPG slot loop from slot ``t0``, learning
    between slots at the episode's scaled lrs."""
    import torch

    from p2pmicrogrid_tpu_torch.convert import state_from_jax, state_to_numpy
    from p2pmicrogrid_tpu_torch.envs import community as com
    from p2pmicrogrid_tpu_torch.models.ddpg import set_learning_rates
    from p2pmicrogrid_tpu_torch.parallel import scenarios as sc
    from p2pmicrogrid_tpu_torch.train import make_policy

    S = cfg.sim.n_scenarios
    cfg = sc.auto_scale_ddpg_lrs(cfg, S)
    policy = make_policy(cfg)
    # The same initial weights and OU state on both devices: drawn on the
    # CPU, copied.
    pol, scen = sc.init_shared_state(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    if device != "cpu":
        move = lambda st: state_from_jax(state_to_numpy(st), device=device, cfg=cfg.ddpg)
        pol, scen = move(pol), move(scen)
    set_learning_rates(cfg.ddpg, pol)
    arrays = sc.stack_scenario_arrays(cfg, sc.make_scenario_traces(cfg, seed=0), ratings, device)
    T = draws_np[0]["ou"].shape[0]
    xs = [x.transpose(0, 1)[t0 : t0 + T].contiguous() for x in arrays]
    ratings_d = com.ratings_to(ratings, device)
    to = lambda x: None if x is None else torch.from_numpy(x).to(device)
    actions, rewards = [], []
    for e, d in enumerate(draws_np):
        ou_n, idx, starts = to(d["ou"]), to(d["idx"]), to(d["starts"])
        phys = com.init_physical(cfg, to(d["normals"]), (S,), device=device)
        rew = torch.zeros(S, device=device)
        for t in range(T):
            phys, _, out, tr, ou = com.slot_dynamics_batched(
                cfg, policy, pol, phys, tuple(x[t] for x in xs), (ou_n[t],), ratings_d,
                explore=True, explore_state=scen.ou,
            )
            pol, scen, _ = sc._ddpg_update_shared(
                cfg, pol, scen._replace(ou=ou), tr, idx[t], None if starts is None else starts[t]
            )
            actions.append(tr.aux)
            rew += out.reward.mean(dim=-1)
        rewards.append(rew)
        if e % cfg.train.min_episodes_criterion == 0:
            pol = policy.decay(pol)
    return (
        torch.stack(actions).cpu().numpy(),
        torch.stack(rewards).cpu().numpy(),
        pol.actor.Dense_0.kernel.detach().cpu().numpy(),
    )


def phase_ddpg_parity():
    """Shared DDPG at A=6, S=3 on the card against the port on the CPU, from
    the same draws, at the CPU tests' tolerances (tests/test_torch_ddpg.py:
    every slot's actions atol=1e-5, episode rewards rtol=2e-4): one
    actor-critic for every agent at rounds=1 (factored, K1) and at rounds=2
    (matrix, K5/K4/K6; the cap below the pool, so the update takes its
    stripes), per-agent stacks at both; two episodes of slots 58-65, where
    PV exceeds every load and the heat pumps make buyers and sellers."""
    import numpy as np

    from p2pmicrogrid_tpu_torch import config as tc
    from p2pmicrogrid_tpu_torch.envs.community import make_ratings

    E, T, t0 = 2, 8, 58
    cases = (
        (True, 32, None, 1, "factored"),
        (True, 32, 40, 2, "matrix"),
        (False, 4, None, 1, "factored"),
        (False, 4, None, 2, "matrix"),
    )
    for share, batch, cap, rounds, market_impl in cases:
        cfg = ddpg_small_config(tc, share, batch, cap, rounds, market_impl)
        draws = ddpg_small_draws(cfg, E, T)
        ratings = make_ratings(cfg, np.random.default_rng(0))
        act_g, rew_g, w_g = run_ddpg_slots(cfg, "cuda", draws, ratings, t0)
        act_c, rew_c, w_c = run_ddpg_slots(cfg, "cpu", draws, ratings, t0)
        what = (
            f"small path (ddpg, {'shared' if share else 'per-agent'}, {market_impl}, "
            f"rounds={rounds}, cap={cap})"
        )
        if not (np.isfinite(rew_g).all() and np.isfinite(act_g).all()):
            fail(f"{what}: non-finite actions or rewards on the card")
        if not np.allclose(act_g, act_c, rtol=0.0, atol=1e-5):
            fail(f"{what}: actions differ card vs CPU by {np.abs(act_g - act_c).max()} (atol 1e-5)")
        if not np.allclose(rew_g, rew_c, rtol=2e-4, atol=0.0):
            fail(f"{what}: rewards differ card vs CPU: {rew_g} vs {rew_c}")
        rel = float(np.abs((rew_g - rew_c) / rew_c).max())
        log(
            f"phase 3: {what} A=6 S=3 card vs CPU: {act_g.size} actions, max abs diff "
            f"{np.abs(act_g - act_c).max():.3e}; max reward rel err {rel:.3e}; actor first "
            f"layer max abs diff {np.abs(w_g - w_c).max():.3e}"
        )


def phase_small_parity():
    import numpy as np

    from p2pmicrogrid_tpu_torch import config as tc
    from p2pmicrogrid_tpu_torch.envs.community import make_ratings

    A, S, E, T = 6, 3, 2, 96
    cases = (
        ("tabular", 1, "factored", False),
        ("tabular", 2, "matrix", False),
        ("tabular", 1, "factored", True),
        ("tabular", 2, "matrix", True),
        ("dqn", 1, "factored", True),
    )
    for impl, rounds, market_impl, fused in cases:
        cfg = small_config(tc, A, S, rounds, market_impl, impl)
        draws = small_draws(cfg, E + 1, T)
        ratings = make_ratings(cfg, np.random.default_rng(0))
        act_g, rew_g, q_g = run_slots(cfg, "cuda", draws, ratings, E, fused)
        act_c, rew_c, q_c = run_slots(cfg, "cpu", draws, ratings, E, fused)
        what = f"small path ({impl}, {market_impl}, rounds={rounds}, fused={fused})"
        if not np.isfinite(rew_g).all():
            fail(f"{what}: non-finite rewards on the card")
        if not np.array_equal(act_g, act_c):
            fail(f"{what}: {int((act_g != act_c).sum())} actions differ card vs CPU")
        if not np.allclose(rew_g, rew_c, rtol=2e-4, atol=0.0):
            fail(f"{what}: rewards differ card vs CPU: {rew_g} vs {rew_c}")
        # Q-tables as tests/test_factored_market.py:203-214; DQN's first
        # layer after 192 Adam steps, whose sums run in another order.
        if not np.allclose(q_g, q_c, rtol=1e-3, atol=1e-4):
            fail(f"{what}: learner state differs card vs CPU: max abs {np.abs(q_g - q_c).max()}")
        rel = float(np.abs((rew_g - rew_c) / rew_c).max())
        log(
            f"phase 3: {what} A={A} S={S} card vs CPU: {act_g.size} actions equal, max "
            f"reward rel err {rel:.3e}, learner state max abs diff {np.abs(q_g - q_c).max():.3e}"
        )


# --- phase 4 ---------------------------------------------------------------


# (label, implementation, market, A, S, rounds, fused, the kernels each slot
# launches once): the shipped default (rounds=1 -> factored, K1) and the
# reference's rounds comparison at rounds=2 (-> matrix: K5, K4, K6), the fused
# slot (K7 alone) for tabular at rounds 1 and 2 (-> K7's matrix variant) and
# for DQN, and DQN unfused from the same seed, at
# the north-star community size with BASELINE config 4's scenario count and
# at BASELINE config 3's shape. DQN runs one warmup pass (a cut of depth).
# Then shared DDPG (unfused: K7 refuses it), one actor-critic for every agent,
# at the JAX bench's cfg4 and scale rows (benchmarks.py:553-571,679-685): the
# ninth field is the row's DDPGConfig.
MATRIX_PATH = ("divide_rank1_fused", "divide_power_fused_with_mean", "clear_market_fused")
FUSED_PATH = ("slot_step_fused",)
MAIN_RUNS = (
    ("tabular", "tabular", "factored", 1000, 64, 1, False, ("merged_min_sums",)),
    ("tabular", "tabular", "factored", 50, 256, 1, False, ("merged_min_sums",)),
    ("tabular", "tabular", "matrix", 1000, 64, 2, False, MATRIX_PATH),
    ("tabular", "tabular", "matrix", 50, 256, 2, False, MATRIX_PATH),
    ("fused tabular", "tabular", "factored", 1000, 64, 1, True, FUSED_PATH),
    ("fused tabular", "tabular", "factored", 50, 256, 1, True, FUSED_PATH),
    ("fused tabular", "tabular", "matrix", 1000, 64, 2, True, FUSED_PATH),
    ("fused dqn", "dqn", "factored", 1000, 64, 1, True, FUSED_PATH),
    ("dqn", "dqn", "factored", 1000, 64, 1, False, ("merged_min_sums",)),
    ("ddpg cfg4", "ddpg", "factored", 1000, 64, 1, False, ("merged_min_sums",),
     dict(buffer_size=256, batch_size=4, share_across_agents=True)),
    ("ddpg scale", "ddpg", "factored", 50, 2048, 1, False, ("merged_min_sums",),
     dict(buffer_size=96, batch_size=2, share_across_agents=True)),
)
LEARN_SPAN = "ddpg_learn_step"


def profiled_kernel_ms(kernels, T):
    """Device ms per call of each path kernel in one profiled episode of T
    slots. K5 and K4 each launch the column-mean reduce once per call, so
    each is charged one reduce per call; K6 is its tile and sum kernels."""
    def per_call(match):
        hits = [v for k, v in kernels.items() if match(k)]
        n = sum(c for c, _ in hits)
        return (sum(ms for _, ms in hits) / n if n else 0.0), n

    reduce_ms, _ = per_call(lambda k: "column_mean_kernel" in k)
    k5, n5 = per_call(lambda k: "divide_rank1_stripe_kernel" in k)
    k4, n4 = per_call(lambda k: "divide_mean_stripe_kernel" in k)
    k6, n6 = per_call(lambda k: "clear_tiles_kernel" in k)
    k6_sums, _ = per_call(lambda k: "clear_sums_kernel" in k)
    k7, n7 = per_call(lambda k: "slot_fused_kernel" in k)
    k1 = sum(ms for k, (_, ms) in kernels.items() if "merged_min" in k) / T
    out = {"merged_min_sums": k1}  # both kernels, one call per slot
    if n5:
        out["divide_rank1_fused"] = k5 + reduce_ms
    if n4:
        out["divide_power_fused_with_mean"] = k4 + reduce_ms
    if n6:
        out["clear_market_fused"] = k6 + k6_sums
    if n7:
        out["slot_step_fused"] = k7
    return out


def phase_main_path(counters):
    """train_scenarios_shared at full width; returns each kernel's launches
    summed over the runs, {kernel: {(S, A, impl, rounds): device ms per
    call}}, and the DDPG rows' numbers."""
    import numpy as np
    import torch

    from p2pmicrogrid_tpu_torch import config as tc
    from p2pmicrogrid_tpu_torch.envs.community import (
        make_ratings,
        resolve_market_dtype,
        resolve_market_impl,
    )
    from p2pmicrogrid_tpu_torch.parallel import (
        init_shared_state,
        make_scenario_traces,
        stack_scenario_arrays,
        train_scenarios_shared,
        warmup_shared_dqn,
    )
    from p2pmicrogrid_tpu_torch.parallel import scenarios as sc
    from p2pmicrogrid_tpu_torch.train import make_policy

    totals = {name: 0 for name in counters}
    profiled = {name: {} for name in counters}
    episode_rewards = {}
    fused_peak = {}
    ddpg_rows = []
    for label, impl, market, A, S, rounds, fused, path_kernels, *ddpg_kw in MAIN_RUNS:
        cfg = tc.default_config(
            sim=tc.SimConfig(n_agents=A, n_scenarios=S, rounds=rounds),
            battery=tc.BatteryConfig(enabled=True),
            train=tc.TrainConfig(implementation=impl),
            dqn=tc.DQNConfig(warmup_passes=1),
            ddpg=tc.DDPGConfig(**(ddpg_kw[0] if ddpg_kw else {})),
        )
        resolved = resolve_market_impl(cfg, "cuda")
        mdt = resolve_market_dtype(cfg, "cuda")
        what = f"main path {label} {resolved} rounds={rounds} A={A} S={S}"
        if resolved != market:
            fail(f"{what}: market 'auto' resolved to {resolved}, expected {market}")
        ratings = make_ratings(cfg, np.random.default_rng(cfg.train.seed))
        traces = make_scenario_traces(cfg, seed=cfg.train.seed)
        arrays = stack_scenario_arrays(cfg, traces, ratings, device="cuda")
        policy = make_policy(cfg)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(cfg.train.seed)
        pol, scen = init_shared_state(cfg, device="cuda", generator=gen)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in counters.values():
            fn.launches = 0
        passes = 2
        if impl == "dqn":
            pol, scen = warmup_shared_dqn(
                cfg, policy, pol, scen, arrays, ratings, gen, fused=fused
            )
            passes += cfg.dqn.warmup_passes
        pol, scen, rew0, _, s0 = train_scenarios_shared(
            cfg, policy, pol, arrays, ratings, gen, 1, replay_s=scen, episode0=0, fused=fused
        )
        pol, scen, rew1, loss1, s1 = train_scenarios_shared(
            cfg, policy, pol, arrays, ratings, gen, 1, replay_s=scen, episode0=1, fused=fused
        )
        launches = {name: fn.launches for name, fn in counters.items()}
        peak = torch.cuda.max_memory_allocated()
        T = arrays.time.shape[1]
        rewards = np.concatenate([rew0, rew1])
        if rewards.shape != (2, S) or not np.isfinite(rewards).all():
            fail(f"{what}: rewards {rewards.shape} not finite")
        learned = {
            "tabular": lambda: pol.q_table,
            "dqn": lambda: pol.online.Dense_0.kernel,
            "ddpg": lambda: pol.actor.Dense_0.kernel,
        }[impl]()
        if not np.isfinite(loss1).all() or not torch.isfinite(learned).all():
            fail(f"{what}: non-finite loss or learner state")
        if impl == "ddpg":
            # The OU noise anneals once, after episode 0.
            decayed, expect = float(pol.noise_scale), cfg.ddpg.noise_decay
            lrs = (pol.actor_opt.param_groups[0]["lr"], pol.critic_opt.param_groups[0]["lr"])
            scaled = sc.auto_scale_ddpg_lrs(cfg, S).ddpg
            if lrs != (scaled.actor_lr, scaled.critic_lr):
                fail(f"{what}: learning rates {lrs}, expected {scaled.actor_lr, scaled.critic_lr}")
        else:
            sched = cfg.qlearning if impl == "tabular" else cfg.dqn
            decayed, expect = float(pol.epsilon), sched.epsilon * sched.epsilon_decay
        if abs(decayed - expect) > 1e-6:
            fail(f"{what}: exploration {decayed} != {expect}")
        # Each kernel of the path once per slot of every pass, no other.
        expect = {name: (passes * T if name in path_kernels else 0) for name in counters}
        if launches != expect:
            fail(f"{what}: launches {launches}, expected {expect}")
        if market == "matrix" and mdt != ("bfloat16" if A >= 256 else "float32"):
            fail(f"{what}: market dtype {mdt}")
        for name, n in launches.items():
            totals[name] += n
        if market == "factored":
            episode_rewards[(impl, A, S, fused)] = rewards
        if fused and impl == "tabular" and (A, S) == (1000, 64):
            fused_peak[rounds] = peak
        log(
            f"phase 4: {what} dtype={mdt} env-steps/s {S * T / s1:.1f} (timed "
            f"episode {s1:.4f} s, {s1 / T * 1e3:.3f} ms per slot, first episode "
            f"{s0:.4f} s) mean episode reward {rewards.mean(axis=1).tolist()} "
            f"launches {({k: v for k, v in launches.items() if v})} "
            f"peak device memory {peak / 2**30:.3f} GiB"
        )
        # A third episode, after the counts were read, under the profiler; a
        # DDPG learn step runs inside a record_function range, so its kernels
        # can be told from the rest of the slot's.
        update = sc._ddpg_update_shared

        def labelled_update(*args, **kwargs):
            with torch.profiler.record_function(LEARN_SPAN):
                return update(*args, **kwargs)

        if impl == "ddpg":
            sc._ddpg_update_shared = labelled_update
        try:
            kernels, learn_ms = profile_episode(
                lambda: train_scenarios_shared(
                    cfg, policy, pol, arrays, ratings, gen, 1, replay_s=scen, episode0=2,
                    fused=fused,
                ),
                T,
                s1,
                span=LEARN_SPAN if impl == "ddpg" else None,
            )
        finally:
            sc._ddpg_update_shared = update
        busy_ms = None
        if kernels is not None:
            busy_ms = sum(ms for _, ms in kernels.values())
            per_call = profiled_kernel_ms(kernels, T)
            for name in path_kernels:
                profiled[name][(S, A, impl, rounds)] = per_call.get(name)
                log(f"  profile: {name} device time per call {per_call.get(name, 0) * 1e3:.3f} us")
        if impl == "ddpg":
            row = dict(
                row=label, A=A, S=S, market=resolved, market_dtype=mdt,
                env_steps_per_s=S * T / s1, ms_per_slot=s1 / T * 1e3,
                busy_ms=busy_ms, idle_share=None if busy_ms is None else 1 - busy_ms / (s1 * 1e3),
                device_ops_per_slot=None if kernels is None else sum(n for n, _ in kernels.values()) / T,
                k1_launches=launches["merged_min_sums"],
                k1_device_ms_per_call=None if kernels is None else per_call.get("merged_min_sums"),
                peak_memory_gib=peak / 2**30,
                learn_device_ms_per_slot=None if learn_ms is None else learn_ms / T,
                learn_share_of_busy=None if learn_ms is None or not busy_ms else learn_ms / busy_ms,
                pooled_batch=sc.ddpg_pooled_batch(cfg), lr_scale=sc.auto_scale_ddpg_lrs(cfg, S).ddpg.actor_lr / cfg.ddpg.actor_lr,
                rewards=rewards.mean(axis=1).tolist(), final_loss=loss1.mean().item(),
            )
            ddpg_rows.append(row)
            log(f"phase 4: {label} {json.dumps(row)}")
        del pol, scen, arrays, learned
        torch.cuda.empty_cache()
    # Fused and unfused from one seed draw the same numbers in the same order;
    # the two differ only where a decision flips (phase 2). Episode rewards:
    # rtol=2e-4 (tests/test_golden.py:74-81).
    for (impl, A, S, fused), fused_rew in episode_rewards.items():
        if not fused:
            continue
        plain_rew = episode_rewards[(impl, A, S, False)]
        rel = np.abs(fused_rew - plain_rew) / np.abs(plain_rew)
        log(f"phase 4: {impl} A={A} S={S} fused vs unfused, same seed: max episode reward rel diff {rel.max():.3e}")
        if not np.allclose(fused_rew, plain_rew, rtol=2e-4, atol=0.0):
            fail(f"{impl} A={A} S={S}: fused vs unfused rewards differ by {rel.max():.3e} (rtol 2e-4)")
    # K7's matrix variant keeps no [S, A, A] workspace: at A=1000, S=64 one
    # would be 256 MB of float32.
    extra = (fused_peak[2] - fused_peak[1]) / 2**20
    log(f"phase 4: fused tabular A=1000 S=64 peak memory, rounds=2 minus rounds=1: {extra:.3f} MiB")
    if extra > 64:
        fail(f"fused rounds=2 peak memory exceeds fused rounds=1 by {extra:.1f} MiB (limit 64 MB)")
    return totals, profiled, ddpg_rows


# --- phase 5 ---------------------------------------------------------------


def chunked_config(tc, impl, A, S, rounds=1, fused=False, **ddpg):
    """The chunked trainer's config: battery on, market "auto"; DDPG with
    one actor-critic for every agent and the given replay sizes."""
    return tc.default_config(
        sim=tc.SimConfig(n_agents=A, n_scenarios=S, rounds=rounds, fused_slot=fused or None),
        battery=tc.BatteryConfig(enabled=True),
        train=tc.TrainConfig(implementation=impl),
        ddpg=tc.DDPGConfig(share_across_agents=True, **ddpg),
    )


# The JAX bench's northstar row (benchmarks.py:732-741): A=1000, 80 chunks of
# 128 scenarios, shared DDPG (one actor-critic for every agent), batch 4 per
# (scenario, agent), a 96-slot ring, battery on, market auto (factored bf16,
# K1 at [128,1000]).
NORTHSTAR = dict(A=1000, S=128, K=80, buffer_size=96, batch_size=4)
CHUNK_RUNS = (
    ("ddpg northstar", "ddpg", 1, False, ("merged_min_sums",),
     dict(buffer_size=NORTHSTAR["buffer_size"], batch_size=NORTHSTAR["batch_size"])),
    ("fused tabular", "tabular", 1, True, FUSED_PATH, {}),
    ("tabular rounds=2", "tabular", 2, False, MATRIX_PATH, {}),
)


def chunked_runner(cfg, graph, n_chunks, device="cuda"):
    """The chunked trainer's episode function (traces made on the device)
    and its K-chunk runner, with the policy and the ratings."""
    import numpy as np

    from p2pmicrogrid_tpu_torch.envs.community import make_ratings
    from p2pmicrogrid_tpu_torch.parallel import scenarios as sc
    from p2pmicrogrid_tpu_torch.train import make_policy

    ratings = make_ratings(cfg, np.random.default_rng(42))
    policy = make_policy(cfg)
    episode_fn = sc.make_device_episode_fn(cfg, policy, ratings, device=device)
    return policy, ratings, sc.make_chunked_episode_runner(cfg, episode_fn, n_chunks, graph=graph)


def graph_stats(captured):
    """A capture's seconds, pool, nodes and launches as plain numbers."""
    from p2pmicrogrid_tpu_torch.telemetry.profiling import graph_node_count

    return dict(
        capture_seconds=captured.capture_seconds,
        instantiate_seconds=captured.instantiate_seconds,
        pool_bytes=captured.pool_bytes,
        nodes=graph_node_count(captured.graph),
        launches={w.__name__: n for w, n in captured.launches.items()},
    )


def copy_state(cfg, pol, device):
    from p2pmicrogrid_tpu_torch.convert import state_from_jax, state_to_numpy

    sub = {"ddpg": cfg.ddpg, "dqn": cfg.dqn}.get(cfg.train.implementation)
    return state_from_jax(state_to_numpy(pol), device=device, cfg=sub)


def phase_graph_vs_eager(counters):
    """K=2 chunks at A=1000, S=128 through the graph and through the eager
    loop, from the same state and seeds: rewards, losses and every averaged
    leaf must be bit-identical, and finite. Returns the graphs' stats."""
    import numpy as np
    import torch

    from p2pmicrogrid_tpu_torch import config as tc
    from p2pmicrogrid_tpu_torch.parallel import scenarios as sc

    A, S, K = NORTHSTAR["A"], NORTHSTAR["S"], 2
    stats = {}
    totals = {name: 0 for name in counters}
    for label, impl, rounds, fused, path_kernels, ddpg_kw in CHUNK_RUNS:
        cfg = chunked_config(tc, impl, A, S, rounds, fused, **ddpg_kw)
        what = f"chunked {label} A={A} S={S} K={K}"
        gen = torch.Generator(device="cuda").manual_seed(3)
        pol0 = sc.init_shared_pol_state(cfg, device="cuda", generator=gen)
        results = {}
        for mode in ("eager", "graph"):
            policy, ratings, runner = chunked_runner(cfg, mode == "graph", K)
            for fn in counters.values():
                fn.launches = 0
            pol, rew, loss, secs = sc.train_scenarios_chunked(
                cfg, policy, copy_state(cfg, pol0, "cuda"), ratings, 11, 1, K, runner=runner
            )
            launches = {name: fn.launches for name, fn in counters.items()}
            leaves = [x.detach().clone() for x, _ in sc.learner_leaves(pol)]
            results[mode] = (rew, loss, leaves)
            T = runner.episode_fn.n_slots
            # The graph's warm-up run is a chunk run eagerly before the capture.
            runs = K + (1 if mode == "graph" else 0)
            expect = {name: (runs * T if name in path_kernels else 0) for name in counters}
            if launches != expect:
                fail(f"{what} {mode}: launches {launches}, expected {expect}")
            for name, n in launches.items():
                totals[name] += n
            if not (np.isfinite(rew).all() and np.isfinite(loss).all()):
                fail(f"{what} {mode}: non-finite rewards or losses")
            if not all(bool(torch.isfinite(x).all()) for x in leaves):
                fail(f"{what} {mode}: non-finite learner state")
            log(f"phase 5: {what} {mode}: {secs:.3f} s, launches {({k: v for k, v in launches.items() if v})}")
            if mode == "graph":
                (captured,) = runner.graphs.values()
                if any(captured[0].launches.get(counters[name], 0) != T for name in path_kernels):
                    fail(f"{what}: the captured graph does not launch each path kernel once a slot")
                stats[label] = graph_stats(captured[0])
                log(f"phase 5: {what} graph: {json.dumps(stats[label])}")
            del runner
            torch.cuda.empty_cache()
        (rg, lg, pg), (re_, le, pe) = results["graph"], results["eager"]
        differing = sum(int((a != b).sum()) for a, b in zip(pg, pe))
        if not (np.array_equal(rg, re_) and np.array_equal(lg, le)) or differing:
            fail(
                f"{what}: graph replay differs from the eager loop: rewards max abs "
                f"{np.abs(rg - re_).max()}, losses {np.abs(lg - le).max()}, {differing} state entries"
            )
        log(f"phase 5: {what}: graph replay bit-identical to the eager loop ({len(pg)} leaves)")
    return stats, totals


def phase_chunked_small_parity():
    """A=6, S=3, K=2 chunked training on the card (graph) against the CPU
    (eager) from the same injected draws, tabular and shared DDPG, factored
    float32 market: rewards rtol=2e-4, losses rtol=1e-3 (phase 3's and the
    CPU tests' tolerances)."""
    import numpy as np
    import torch

    from p2pmicrogrid_tpu_torch import config as tc
    from p2pmicrogrid_tpu_torch.parallel import scenarios as sc

    A, S, K = 6, 3, 2
    for impl in ("tabular", "ddpg"):
        cfg = tc.default_config(
            sim=tc.SimConfig(n_agents=A, n_scenarios=S, market_impl="factored"),
            battery=tc.BatteryConfig(enabled=True),
            train=tc.TrainConfig(implementation=impl),
            ddpg=tc.DDPGConfig(buffer_size=16, batch_size=4, share_across_agents=True),
        )
        pol0 = sc.init_shared_pol_state(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
        out = {}
        for device in ("cpu", "cuda"):
            policy, ratings, runner = chunked_runner(cfg, device == "cuda", K, device)
            if device == "cpu":
                gen = torch.Generator().manual_seed(9)
                ep = runner.episode_fn
                draws = [
                    sc.ChunkDraws(
                        torch.randn((S, A), generator=gen) if impl == "ddpg" else None, (), ep.draw(gen)
                    )
                    for _ in range(K)
                ]
            else:
                draws = [sc._map_tensors(lambda x: x.cuda(), d) for d in draws]
            _, rew, loss, _ = sc.train_scenarios_chunked(
                cfg, policy, copy_state(cfg, pol0, device), ratings, 0, 1, K,
                runner=runner, draws=[draws],
            )
            out[device] = (rew, loss)
        (rg, lg), (rc, lc) = out["cuda"], out["cpu"]
        what = f"chunked small path ({impl}, factored, A={A} S={S} K={K})"
        if not np.isfinite(rg).all():
            fail(f"{what}: non-finite rewards on the card")
        if not (np.allclose(rg, rc, rtol=2e-4, atol=0.0) and np.allclose(lg, lc, rtol=1e-3, atol=0.0)):
            fail(f"{what}: card vs CPU rewards {rg} vs {rc}, losses {lg} vs {lc}")
        log(
            f"phase 5: {what} card (graph) vs CPU (eager): max reward rel err "
            f"{float(np.abs((rg - rc) / rc).max()):.3e}, max loss rel err "
            f"{float(np.abs((lg - lc) / lc).max()):.3e}"
        )


def profile_chunk(cfg, runner, policy, pol, ratings, T, span=None):
    """One one-chunk episode of ``runner`` under the profiler, after two runs
    outside it (the first captures, for a graph runner; the second is
    timed): (kernels, span device ms, the timed run's seconds)."""
    from p2pmicrogrid_tpu_torch.parallel import scenarios as sc

    run = lambda: sc.train_scenarios_chunked(cfg, policy, pol, ratings, 21, 1, 1, runner=runner)
    run()
    _, _, _, secs = run()
    kernels, span_ms = profile_episode(run, T, secs, span=span)
    return kernels, span_ms, secs


def phase_northstar(counters, card):
    """The northstar row through the chunked graph path: one warm episode
    (the capture), one timed episode ending in a device synchronisation,
    then one chunk under the profiler (graph replay: busy, idle, K1) and one
    eager chunk (the learn step's share of busy). Returns the row."""
    import numpy as np
    import torch

    from p2pmicrogrid_tpu_torch import config as tc
    from p2pmicrogrid_tpu_torch.envs.community import resolve_market_dtype, resolve_market_impl
    from p2pmicrogrid_tpu_torch.parallel import scenarios as sc

    A, S, K = NORTHSTAR["A"], NORTHSTAR["S"], NORTHSTAR["K"]
    cfg = chunked_config(tc, "ddpg", A, S, buffer_size=NORTHSTAR["buffer_size"],
                         batch_size=NORTHSTAR["batch_size"])
    what = f"northstar A={A} S={S} K={K}"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    policy, ratings, runner = chunked_runner(cfg, True, K)
    T = runner.episode_fn.n_slots
    pol = sc.init_shared_pol_state(cfg, device="cuda", generator=torch.Generator(device="cuda").manual_seed(0))
    pol, rew0, _, warm_s = sc.train_scenarios_chunked(cfg, policy, pol, ratings, 0, 1, K, runner=runner)
    for fn in counters.values():
        fn.launches = 0
    pol, rew1, loss1, secs = sc.train_scenarios_chunked(
        cfg, policy, pol, ratings, 1, 1, K, runner=runner, episode0=1
    )
    launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    expect = {name: (K * T if name == "merged_min_sums" else 0) for name in counters}
    if launches != expect:
        fail(f"{what}: launches {launches}, expected {expect}")
    if rew1.shape != (1, K * S) or not (np.isfinite(rew1).all() and np.isfinite(loss1).all()):
        fail(f"{what}: rewards {rew1.shape} or losses not finite")
    if not all(bool(torch.isfinite(x).all()) for x, _ in sc.learner_leaves(pol)):
        fail(f"{what}: non-finite learner state")
    lrs = sc._learning_rates(pol)
    scaled = sc.auto_scale_ddpg_lrs(cfg, S).ddpg
    if lrs != (scaled.actor_lr, scaled.critic_lr):
        fail(f"{what}: learning rates {lrs}, expected {scaled.actor_lr, scaled.critic_lr}")
    (captured,) = runner.graphs.values()
    graph = graph_stats(captured[0])
    steps = T * S * K
    log(
        f"phase 5: {what} ({card}): env-steps/s {steps / secs:.1f} (timed episode {secs:.3f} s, "
        f"{secs / K:.4f} s per chunk; warm episode with the capture {warm_s:.3f} s), "
        f"peak device memory {peak / 2**30:.3f} GiB, graph {json.dumps(graph)}"
    )
    del runner
    torch.cuda.empty_cache()
    # One chunk under the profiler: the graph's replay, then the eager loop
    # with the learn step inside a record_function range.
    policy, ratings, runner1 = chunked_runner(cfg, True, 1)
    kernels, _, chunk_s = profile_chunk(cfg, runner1, policy, pol, ratings, T)
    del runner1
    torch.cuda.empty_cache()
    busy_ms = k1_ms = None
    if kernels is not None:
        busy_ms = sum(ms for _, ms in kernels.values())
        k1_ms = profiled_kernel_ms(kernels, T)["merged_min_sums"]
    update = sc._ddpg_update_shared

    def labelled_update(*args, **kwargs):
        with torch.profiler.record_function(LEARN_SPAN):
            return update(*args, **kwargs)

    sc._ddpg_update_shared = labelled_update
    try:
        policy, ratings, runner_e = chunked_runner(cfg, False, 1)
        kernels_e, learn_ms, eager_s = profile_chunk(cfg, runner_e, policy, pol, ratings, T, LEARN_SPAN)
    finally:
        sc._ddpg_update_shared = update
    busy_e = None if kernels_e is None else sum(ms for _, ms in kernels_e.values())
    row = dict(
        row="northstar", card=card, A=A, S=S, K=K, T=T, market=resolve_market_impl(cfg, "cuda"),
        market_dtype=resolve_market_dtype(cfg, "cuda"),
        env_steps_per_s=steps / secs, episode_s=secs, s_per_chunk=secs / K,
        warm_episode_s=warm_s, graph=graph,
        busy_ms_per_chunk=busy_ms, one_chunk_episode_s=chunk_s,
        idle_share=None if busy_ms is None else 1 - busy_ms / (chunk_s * 1e3),
        idle_share_of_timed_episode=None if busy_ms is None else 1 - busy_ms / (secs / K * 1e3),
        k1_launches=launches["merged_min_sums"], k1_device_ms_per_call=k1_ms,
        peak_memory_gib=peak / 2**30,
        eager_chunk_s=eager_s, eager_busy_ms=busy_e,
        learn_device_ms_per_slot=None if learn_ms is None else learn_ms / T,
        learn_share_of_busy=None if learn_ms is None or not busy_e else learn_ms / busy_e,
        pooled_batch=sc.ddpg_pooled_batch(cfg),
        rewards_mean=float(rew1.mean()), final_loss=float(loss1.mean()),
    )
    log(f"phase 5: {json.dumps(row)}")
    return row, launches


def phase_cfg4_chunked(counters, card):
    """The DDPG cfg4 row (A=1000, S=64, B=4, ring 256) through the chunked
    graph path at K=1: one warm episode, one timed, beside phase 4's eager
    row in this call."""
    import torch

    from p2pmicrogrid_tpu_torch import config as tc
    from p2pmicrogrid_tpu_torch.parallel import scenarios as sc

    cfg = chunked_config(tc, "ddpg", 1000, 64, buffer_size=256, batch_size=4)
    policy, ratings, runner = chunked_runner(cfg, True, 1)
    T = runner.episode_fn.n_slots
    pol = sc.init_shared_pol_state(cfg, device="cuda", generator=torch.Generator(device="cuda").manual_seed(0))
    pol, _, _, warm_s = sc.train_scenarios_chunked(cfg, policy, pol, ratings, 0, 1, 1, runner=runner)
    for fn in counters.values():
        fn.launches = 0
    pol, rew, _, secs = sc.train_scenarios_chunked(cfg, policy, pol, ratings, 1, 1, 1, runner=runner, episode0=1)
    if counters["merged_min_sums"].launches != T:
        fail(f"cfg4 chunked: K1 launched {counters['merged_min_sums'].launches} times, expected {T}")
    row = dict(row="ddpg cfg4 chunked graph", card=card, A=1000, S=64, K=1, env_steps_per_s=64 * T / secs,
               ms_per_slot=secs / T * 1e3, warm_episode_s=warm_s)
    log(f"phase 5: {json.dumps(row)}")
    del runner
    torch.cuda.empty_cache()
    return row


# --- phase 6 ---------------------------------------------------------------

# tests/test_golden.py's pinned greedy episode (A=2, rounds=1, ratings from
# default_rng(42), traces of day 11): its first 4 slots.
GOLDEN = {
    "cost": [[0.002175, 0.087167], [0.082664, 0.001432], [0.042346, 0.039303],
             [0.037923, 0.036898]],
    "p_grid": [[77.043663, 3087.079102], [3103.469238, 53.755768],
               [1687.529175, 1566.260376], [1604.566772, 1561.177368]],
    "t_in": [[21.301205, 20.728098], [20.790424, 21.540831], [21.560457, 21.001354],
             [21.548647, 21.147606]],
    "hp_power_w": [[0.0, 3000.0], [3000.0, 0.0], [1500.0, 1500.0], [1500.0, 1500.0]],
    "max_in": [4565.099121, 4606.924316],
}
# Its seeds' draws, which the JAX package makes from jax.random keys: the
# initial (t_in, t_bm) normals of PRNGKey(0), and the rows of the Q-table
# (normals of PRNGKey(5)) that the first 4 slots read, by flat row of the
# [2 * 20^4, 3] table; every other row is 0 here.
GOLDEN_NORMALS = [[1.004014253616333, -0.9063372015953064],
                  [-2.442455768585205, -2.0356805324554443]]
GOLDEN_Q_ROWS = {
    3409: [-0.756546139717102, 0.1413765698671341, 0.9392719268798828],
    3410: [1.721746802330017, 1.1290353536605835, 1.130327582359314],
    5008: [1.2963895797729492, -0.2898291349411011, 0.21245968341827393],
    5010: [0.1404062807559967, -0.6803865432739258, -2.2597553730010986],
    5808: [-0.0015089332591742277, 0.33904868364334106, -1.3912242650985718],
    5810: [0.06303822994232178, -0.9245172142982483, 0.34371718764305115],
    6209: [1.0131232738494873, 1.571183443069458, -0.2754097282886505],
    6210: [0.2750616669654846, 0.5095898509025574, -0.8745958209037781],
    163009: [-0.859297513961792, 0.0849846825003624, 1.5183526277542114],
    163010: [-0.29312247037887573, 0.11667506396770477, 0.8300866484642029],
    164209: [0.5862355828285217, 1.3173832893371582, -0.08808014541864395],
    164210: [1.1982723474502563, -1.0902260541915894, 0.7564707398414612],
    164608: [-0.3609241545200348, 1.6176408529281616, -0.3296067416667938],
    164610: [1.011909008026123, 0.4638766646385193, 2.0535407066345215],
    165809: [-0.07881727814674377, -0.8921489715576172, -0.4731638729572296],
    165810: [0.9441831111907959, 0.1661885678768158, 0.8257968425750732],
}
# The kernels one single-community slot launches: the matrix negotiation in
# float32 (K5 for round 1, K4 for each later round, K6), or K7 fused.
SINGLE_R1 = ("divide_rank1_fused", "clear_market_fused")
SINGLE_R2 = MATRIX_PATH


def single_config(tc, impl, A, rounds=1, fused=False, **train):
    """The JAX bench's single-community rows (benchmarks.py:255-260): cfg1's
    defaults (battery off, rounds=1), cfg2's DDPGConfig(buffer_size=1024,
    batch_size=32); DQN with one warmup pass (a cut of depth)."""
    return tc.default_config(
        sim=tc.SimConfig(n_agents=A, rounds=rounds, fused_slot=fused or None),
        train=tc.TrainConfig(implementation=impl, **train),
        dqn=tc.DQNConfig(warmup_passes=1),
        ddpg=tc.DDPGConfig(buffer_size=1024, batch_size=32),
    )


def single_inputs(cfg):
    """cfg1's traces (day 11) and ratings (default_rng(42))."""
    import numpy as np

    from p2pmicrogrid_tpu_torch.data.traces import synthetic_traces
    from p2pmicrogrid_tpu_torch.envs.community import make_ratings

    return synthetic_traces(n_days=1, start_day=11).normalized(), make_ratings(cfg, np.random.default_rng(42))


def expect_launches(what, counters, expected):
    """Each counter's launches since it was set to 0 against ``expected``
    ({name: n}, every other kernel 0); K1's must be 0 on the single path."""
    launches = {name: fn.launches for name, fn in counters.items()}
    want = {name: expected.get(name, 0) for name in counters}
    if launches["merged_min_sums"]:
        fail(f"{what}: K1 launched {launches['merged_min_sums']} times on the single path")
    if launches != want:
        fail(f"{what}: launches {launches}, expected {want}")
    return launches


def reset(counters):
    for fn in counters.values():
        fn.launches = 0


def phase_single_golden(counters):
    """tests/test_golden.py's greedy episode on the card, unfused (K5, K6 at
    [1,2]) and fused (K7 at [1,2]): the first 4 slots at rtol=2e-4,
    atol=1e-5, the reward -cost there. Returns the launches."""
    import numpy as np
    import torch

    from p2pmicrogrid_tpu_torch import config as tc
    from p2pmicrogrid_tpu_torch.envs import community as com
    from p2pmicrogrid_tpu_torch.models.tabular import tabular_init
    from p2pmicrogrid_tpu_torch.train import make_policy

    cfg = single_config(tc, "tabular", 2)
    traces, ratings = single_inputs(cfg)
    if not np.allclose(ratings.max_in, GOLDEN["max_in"], rtol=1e-5):
        fail(f"golden: max_in {ratings.max_in} vs {GOLDEN['max_in']}")
    arrays = com.build_episode_arrays(cfg, traces, ratings, "cuda")
    q = tabular_init(cfg.qlearning, 2, "cpu").q_table
    rows = q.view(-1, cfg.qlearning.num_actions)
    for r, v in GOLDEN_Q_ROWS.items():
        rows[r] = torch.tensor(v)
    ps = tabular_init(cfg.qlearning, 2, "cuda")._replace(q_table=q.cuda())
    phys = com.init_physical(cfg, torch.tensor(GOLDEN_NORMALS), device="cuda")
    totals = {name: 0 for name in counters}
    for fused in (False, True):
        what = f"golden greedy episode ({'fused' if fused else 'unfused'})"
        reset(counters)
        _, _, out = com.run_episode(cfg, make_policy(cfg), ps, phys, arrays, ratings, training=False, fused=fused)
        launches = expect_launches(what, counters, {k: 96 for k in (FUSED_PATH if fused else SINGLE_R1)})
        for name, n in launches.items():
            totals[name] += n
        worst = 0.0
        for name in ("cost", "p_grid", "t_in", "hp_power_w", "reward"):
            got = getattr(out, name)[:4].cpu().numpy()
            ref = -np.asarray(GOLDEN["cost"]) if name == "reward" else np.asarray(GOLDEN[name])
            if not np.allclose(got, ref, rtol=2e-4, atol=1e-5):
                fail(f"{what}: {name} {got.tolist()} vs GOLDEN {ref.tolist()}")
            worst = max(worst, float((np.abs(got - ref) / np.maximum(np.abs(ref), 1e-30)).max()))
        log(f"phase 6: {what} on the card reproduces GOLDEN (max rel err {worst:.3e})")
    return totals


def single_draws(cfg, n_passes, T, count0, learn, seed):
    """CPU draws for ``n_passes`` single-community passes of T slots, each a
    ``SingleEpisodeDraws`` with its normals; replay indices (where ``learn``)
    uniform over the ring after each slot's add, the ring holding ``count0``
    entries before the first pass."""
    import torch

    from p2pmicrogrid_tpu_torch.envs.community import SingleEpisodeDraws

    impl, A, R = cfg.train.implementation, cfg.sim.n_agents, cfg.sim.rounds + 1
    sub = cfg.ddpg if impl == "ddpg" else cfg.dqn
    n_actions = cfg.qlearning.num_actions if impl == "tabular" else 3
    gen = torch.Generator().manual_seed(seed)
    out = []
    for e in range(n_passes):
        d = dict(normals=torch.randn((2, A), generator=gen))
        if impl == "ddpg":
            d["ou_normals"] = torch.randn((T, R, A), generator=gen)
        else:
            d["uniform"] = torch.rand((T, R, A), generator=gen)
            d["randint"] = torch.randint(0, n_actions, (T, R, A), generator=gen)
        if learn and impl != "tabular":
            count = (torch.arange(1, T + 1) + count0 + e * T).clamp(max=sub.buffer_size)[:, None, None]
            u = torch.rand((T, A, sub.batch_size), generator=gen)
            d["replay_idx"] = torch.minimum((u * count).long(), count - 1)
        out.append(SingleEpisodeDraws(**d))
    return out


def run_single(cfg, device, pol0, draws, warm, fused=False):
    """The single community's episodes from one state (``pol0`` on the CPU,
    copied) and injected draws: DQN's warmup passes first; exploration
    decays after episode e when e % min_episodes_criterion == 0. Returns
    (every slot's decisions [E, T, R, A], episode rewards [E], the final
    state's learner weights)."""
    import numpy as np
    import torch

    from p2pmicrogrid_tpu_torch.envs import community as com
    from p2pmicrogrid_tpu_torch.train import init_dqn_buffers, make_policy

    traces, ratings = single_inputs(cfg)
    arrays = com.build_episode_arrays(cfg, traces, ratings, device)
    policy = make_policy(cfg)
    pol = copy_state(cfg, pol0, device)
    to = lambda d: com.SingleEpisodeDraws(*(None if x is None else x.to(device) for x in d))
    if warm:
        pol = init_dqn_buffers(cfg, policy, pol, arrays, ratings, draws=[to(d) for d in warm])
    decisions, rewards = [], []
    for e, d in enumerate(draws):
        d = to(d)
        phys = com.init_physical(cfg, d.normals, device=device)
        _, pol, out = com.run_episode(
            cfg, policy, pol, phys, arrays, ratings, training=True, draws=d, fused=fused
        )
        decisions.append(out.decisions)
        rewards.append(out.reward.mean(dim=-1).sum())
        if e % cfg.train.min_episodes_criterion == 0:
            pol = policy.decay(pol)
    learned = {
        "tabular": lambda: pol.q_table,
        "dqn": lambda: pol.online.Dense_0.kernel,
        "ddpg": lambda: pol.actor.Dense_0.kernel,
    }[cfg.train.implementation]()
    return (
        torch.stack(decisions).cpu().numpy(),
        torch.stack(rewards).cpu().numpy(),
        learned.detach().cpu().numpy(),
    )


# (label, implementation, A, rounds, fused, training episodes): the card
# against the CPU from one seed and the same injected draws.
SINGLE_PARITY = (
    ("cfg1 tabular", "tabular", 2, 1, False, 2),
    ("cfg1 tabular fused", "tabular", 2, 1, True, 2),
    ("tabular rounds=2", "tabular", 2, 2, False, 1),
    ("dqn", "dqn", 2, 1, False, 1),
    ("dqn fused", "dqn", 2, 1, True, 1),
    ("cfg2 ddpg per agent", "ddpg", 10, 1, False, 1),
)


def phase_single_parity(counters):
    """SINGLE_PARITY's runs on the card against the port on the CPU:
    discrete decisions identical (DDPG's within 1e-5 of the heat pump's
    power), episode rewards rtol=2e-4, learner weights rtol=1e-3,
    atol=1e-4; each slot launches its path's kernels once, K1 never. Then
    fused against unfused on the card (tabular and DQN), phase 4's
    convention: episode rewards rtol=2e-4, differing decisions counted.
    Returns the card's launches."""
    import numpy as np
    import torch

    from p2pmicrogrid_tpu_torch import config as tc
    from p2pmicrogrid_tpu_torch.train import init_policy_state

    totals = {name: 0 for name in counters}
    card = {}
    T = 96
    for label, impl, A, rounds, fused, E in SINGLE_PARITY:
        cfg = single_config(tc, impl, A, rounds, fused)
        pol0 = init_policy_state(cfg, "cpu", torch.Generator().manual_seed(5))
        if impl == "tabular":
            # A random table and epsilon 0.5: greedy and explored actions.
            q = torch.randn(pol0.q_table.shape, generator=torch.Generator().manual_seed(6))
            pol0 = pol0._replace(q_table=q, epsilon=torch.tensor(0.5))
        if impl == "dqn":
            pol0 = pol0._replace(epsilon=torch.tensor(0.5))
        n_warm = cfg.dqn.warmup_passes if impl == "dqn" else 0
        warm = single_draws(cfg, n_warm, T, 0, False, seed=7)
        draws = single_draws(cfg, E, T, n_warm * T, True, seed=8)
        reset(counters)
        dec_g, rew_g, w_g = run_single(cfg, "cuda", pol0, draws, warm, fused=fused)
        path = FUSED_PATH if fused else (SINGLE_R1 if rounds == 1 else SINGLE_R2)
        launches = expect_launches(f"single {label}", counters, {k: (E + n_warm) * T for k in path})
        for name, n in launches.items():
            totals[name] += n
        dec_c, rew_c, w_c = run_single(cfg, "cpu", pol0, draws, warm, fused=fused)
        what = f"single {label} A={A} rounds={rounds}"
        if not (np.isfinite(rew_g).all() and np.isfinite(w_g).all()):
            fail(f"{what}: non-finite rewards or weights on the card")
        if impl == "ddpg":
            hp = cfg.thermal.hp_max_power
            if not np.allclose(dec_g, dec_c, rtol=0, atol=1e-5 * hp):
                fail(f"{what}: actions differ card vs CPU by {np.abs(dec_g - dec_c).max() / hp}")
        elif not np.array_equal(dec_g, dec_c):
            fail(f"{what}: {int((dec_g != dec_c).sum())} decisions differ card vs CPU")
        if not np.allclose(rew_g, rew_c, rtol=2e-4, atol=0.0):
            fail(f"{what}: rewards differ card vs CPU: {rew_g} vs {rew_c}")
        if not np.allclose(w_g, w_c, rtol=1e-3, atol=1e-4):
            fail(f"{what}: learner weights differ card vs CPU by {np.abs(w_g - w_c).max()}")
        card[(impl, rounds, fused)] = (dec_g, rew_g)
        log(
            f"phase 6: {what} card vs CPU: {dec_g.size} decisions, max reward rel err "
            f"{float(np.abs((rew_g - rew_c) / rew_c).max()):.3e}, weights max abs diff "
            f"{np.abs(w_g - w_c).max():.3e}; launches {({k: v for k, v in launches.items() if v})}"
        )
    for impl in ("tabular", "dqn"):
        (dec_u, rew_u), (dec_f, rew_f) = card[(impl, 1, False)], card[(impl, 1, True)]
        rel = float(np.abs((rew_f - rew_u) / rew_u).max())
        differ = int((dec_f != dec_u).sum())
        log(f"phase 6: {impl} A=2 fused vs unfused on the card: {differ} of {dec_u.size} decisions differ, "
            f"max episode reward rel diff {rel:.3e}")
        if not np.allclose(rew_f, rew_u, rtol=2e-4, atol=0.0):
            fail(f"single {impl}: fused vs unfused rewards differ by {rel:.3e} (rtol 2e-4)")
    return totals


def single_row_common(label, cfg, secs, env_steps, kernels, peak, base, launches, T):
    """A phase-6 row; ``peak`` and ``base`` are the bytes allocated at the
    timed run's peak and before it (what earlier phases still hold)."""
    busy_ms = None if kernels is None else sum(ms for _, ms in kernels.values())
    per_call = {} if kernels is None else profiled_kernel_ms(kernels, T)
    return dict(
        row=label, A=cfg.sim.n_agents, impl=cfg.train.implementation, rounds=cfg.sim.rounds,
        fused=bool(cfg.sim.fused_slot), env_steps_per_s=env_steps / secs, seconds=secs,
        ms_per_slot=secs / T * 1e3, busy_ms=busy_ms,
        idle_share=None if busy_ms is None else 1 - busy_ms / (secs * 1e3),
        device_ops_per_slot=None if kernels is None else sum(n for n, _ in kernels.values()) / T,
        launches={k: v for k, v in launches.items() if v},
        kernel_device_ms_per_call={k: v for k, v in per_call.items() if k in launches and launches[k]},
        peak_memory_mib=peak / 2**20,
        run_peak_memory_mib=(peak - base) / 2**20,
    )


# (label, implementation, A, fused, path kernels): the timed training rows.
SINGLE_ROWS = (
    ("cfg1", "tabular", 2, False, SINGLE_R1),
    ("cfg1 fused", "tabular", 2, True, FUSED_PATH),
    ("dqn", "dqn", 2, False, SINGLE_R1),
    ("cfg2", "ddpg", 10, False, SINGLE_R1),
)


def phase_single_rows(counters, card):
    """``train_community`` at the JAX bench's single-community rows: one warm
    episode (DQN: with its warmup pass), one timed, one under the profiler;
    then ``evaluate_community`` over every day of the synthetic traces with
    cfg1's trained table (warm, timed, profiled), held to the CPU's. Returns
    (rows, launches, {kernel: {shape: device ms per call}})."""
    import dataclasses

    import numpy as np
    import torch

    from p2pmicrogrid_tpu_torch import config as tc
    from p2pmicrogrid_tpu_torch.data.traces import synthetic_traces
    from p2pmicrogrid_tpu_torch.train import evaluate_community, init_policy_state, make_policy, train_community

    T = 96
    rows, totals, shapes = [], {name: 0 for name in counters}, {}
    trained = None
    for label, impl, A, fused, path in SINGLE_ROWS:
        cfg = single_config(tc, impl, A, 1, fused, max_episodes=1)
        at = lambda e0: dataclasses.replace(
            cfg, train=dataclasses.replace(cfg.train, starting_episodes=e0, max_episodes=e0 + 1)
        )
        traces, ratings = single_inputs(cfg)
        policy = make_policy(cfg)
        gen = torch.Generator(device="cuda").manual_seed(0)
        pol = init_policy_state(cfg, "cuda", gen)
        warm = train_community(cfg, policy, pol, traces, ratings, gen, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset(counters)
        res = train_community(at(1), policy, warm.pol_state, traces, ratings, gen, warmup=False, device="cuda")
        peak = torch.cuda.max_memory_allocated()
        launches = expect_launches(f"single row {label}", counters, {k: T for k in path})
        if not np.isfinite(res.episode_rewards + res.episode_losses).all():
            fail(f"single row {label}: non-finite reward or loss")
        kernels, _ = profile_episode(
            lambda: train_community(at(2), policy, res.pol_state, traces, ratings, gen, warmup=False,
                                    device="cuda"),
            T, res.train_seconds,
        )
        for name, n in launches.items():
            totals[name] += n
        row = single_row_common(label, cfg, res.train_seconds, res.env_steps, kernels, peak, base, launches, T)
        row.update(card=card, episode_reward=res.episode_rewards[0], warm_episode_s=warm.train_seconds)
        for name, ms in row["kernel_device_ms_per_call"].items():
            shapes.setdefault(name, {})[(1, A)] = ms
        rows.append(row)
        log(f"phase 6: {json.dumps(row)}")
        if label == "cfg1":
            trained = res.pol_state

    # Greedy evaluation over every day, days side by side: K5, K6 at [13, 2].
    cfg = single_config(tc, "tabular", 2)
    traces = synthetic_traces().normalized()
    _, ratings = single_inputs(cfg)
    policy = make_policy(cfg)
    normals = torch.randn((EVAL_DAYS, 2, 2), generator=torch.Generator().manual_seed(3))

    def evaluate(device, pol, cfg=cfg):
        _, out, _ = evaluate_community(cfg, policy, pol, traces, ratings, normals=normals.to(device),
                                       device=device)
        return out

    evaluate("cuda", trained)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset(counters)
    start = time.perf_counter()
    out = evaluate("cuda", trained)
    rewards = out.reward.sum(dim=(1, 2)).cpu().numpy()
    secs = time.perf_counter() - start
    peak = torch.cuda.max_memory_allocated()
    launches = expect_launches("single evaluation", counters, {k: T for k in SINGLE_R1})
    for name, n in launches.items():
        totals[name] += n
    if out.reward.shape != (EVAL_DAYS, T, 2) or not np.isfinite(rewards).all():
        fail(f"single evaluation: rewards {tuple(out.reward.shape)} not finite")
    ref = evaluate("cpu", copy_state(cfg, trained, "cpu"))
    ref_rewards = ref.reward.sum(dim=(1, 2)).numpy()
    if not np.array_equal(out.decisions.cpu().numpy(), ref.decisions.numpy()):
        fail("single evaluation: decisions differ card vs CPU")
    if not np.allclose(rewards, ref_rewards, rtol=2e-4, atol=0.0):
        fail(f"single evaluation: day rewards differ card vs CPU: {rewards} vs {ref_rewards}")

    def run_eval():
        evaluate("cuda", trained).reward.sum().item()

    # The fused evaluation (SimConfig.fused_slot): K7 at [13, 2], held to
    # the CPU's and, by phase 4's convention, to the unfused days.
    # One warm run, then the timed run, as the unfused evaluation.
    cfg_f = single_config(tc, "tabular", 2, 1, True)
    evaluate("cuda", trained, cfg_f)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_f = torch.cuda.memory_allocated()
    reset(counters)
    start = time.perf_counter()
    out_f = evaluate("cuda", trained, cfg_f)
    rewards_f = out_f.reward.sum(dim=(1, 2)).cpu().numpy()
    secs_f = time.perf_counter() - start
    peak_f = torch.cuda.max_memory_allocated()
    fused_launches = expect_launches("single evaluation fused", counters, {k: T for k in FUSED_PATH})
    for name, n in fused_launches.items():
        totals[name] += n
    ref_f = evaluate("cpu", copy_state(cfg, trained, "cpu"), cfg_f)
    if not np.array_equal(out_f.decisions.cpu().numpy(), ref_f.decisions.numpy()):
        fail("single evaluation fused: decisions differ card vs CPU")
    if not np.allclose(rewards_f, ref_f.reward.sum(dim=(1, 2)).numpy(), rtol=2e-4, atol=0.0):
        fail(f"single evaluation fused: day rewards differ card vs CPU: {rewards_f}")
    if not np.allclose(rewards_f, rewards, rtol=2e-4, atol=0.0):
        fail(f"single evaluation: fused vs unfused day rewards differ: {rewards_f} vs {rewards}")
    differ = int((out_f.decisions != out.decisions).sum())
    log(f"phase 6: fused evaluation at [{EVAL_DAYS}, 2]: {differ} of {out.decisions.numel()} decisions "
        f"differ from the unfused days, max day reward rel diff "
        f"{float(np.abs((rewards_f - rewards) / rewards).max()):.3e}")

    kernels, _ = profile_episode(run_eval, T, secs)
    row = single_row_common("evaluation", cfg, secs, EVAL_DAYS * T, kernels, peak, base, launches, T)
    row.update(card=card, days=EVAL_DAYS, day_rewards=rewards.tolist())
    # The fused evaluation's K7 at [13, 2] on the path, from its own profile.
    kernels_f, _ = profile_episode(lambda: evaluate("cuda", trained, cfg_f).reward.sum().item(), T, secs_f)
    row_f = single_row_common("evaluation fused", cfg_f, secs_f, EVAL_DAYS * T, kernels_f, peak_f, base_f,
                              fused_launches, T)
    row_f.update(card=card, days=EVAL_DAYS, day_rewards=rewards_f.tolist())
    for r in (row, row_f):
        for name, ms in r["kernel_device_ms_per_call"].items():
            shapes.setdefault(name, {})[(EVAL_DAYS, 2)] = ms
        rows.append(r)
        log(f"phase 6: {json.dumps(r)}")
    return rows, totals, shapes




# --- phase 7 ---------------------------------------------------------------


def expect_path(what, counters, expected):
    """Each counter's launches since it was set to 0 against ``expected``
    ({name: n}, every other kernel 0: K7 never on an unfused path)."""
    launches = {name: fn.launches for name, fn in counters.items()}
    want = {name: expected.get(name, 0) for name in counters}
    if launches != want:
        fail(f"{what}: launches {launches}, expected {want}")
    return launches


def timed_rows(what, counters, path, T, run, env_steps):
    """One warm run, one timed (its launches checked: each of ``path`` once a
    slot), one profiled; ``run()`` trains or evaluates once and returns a
    host array of its rewards. Returns (the row's numbers, launches)."""
    import numpy as np
    import torch

    run()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset(counters)
    start = time.perf_counter()
    rewards = run()
    secs = time.perf_counter() - start
    peak = torch.cuda.max_memory_allocated()
    launches = expect_path(what, counters, {k: T for k in path})
    if not np.isfinite(rewards).all():
        fail(f"{what}: non-finite rewards")
    kernels, _ = profile_episode(run, T, secs)
    busy_ms = None if kernels is None else sum(ms for _, ms in kernels.values())
    per_call = {} if kernels is None else profiled_kernel_ms(kernels, T)
    row = dict(
        row=what, env_steps_per_s=env_steps / secs, seconds=secs, ms_per_slot=secs / T * 1e3,
        busy_ms=busy_ms, idle_share=None if busy_ms is None else 1 - busy_ms / (secs * 1e3),
        device_ops_per_slot=None if kernels is None else sum(n for n, _ in kernels.values()) / T,
        launches={k: v for k, v in launches.items() if v},
        kernel_device_ms_per_call={k: v for k, v in per_call.items() if launches.get(k)},
        peak_memory_mib=peak / 2**20, run_peak_memory_mib=(peak - base) / 2**20,
    )
    log(f"phase 7: {json.dumps(row)}")
    return row, launches


def repriced_vs_matched(cfg, out):
    """The inter-community settlement against its conservation law, per
    (day, slot, community): it must change the community's costs from the
    plain tariff's by exactly the matched energy ``f * r`` re-priced from the
    residual's tariff to the trade price (so the energy re-priced equals the
    energy matched), within float32 rounding of the costs (1e-5 of their
    magnitudes). Outputs' leaves [D, T, C, ...]. Returns (whether every
    entry holds, the matched energy per day in kWh, the change per day in
    euro)."""
    import torch

    from p2pmicrogrid_tpu_torch.envs.multi_community import inter_community_traded_fraction

    p_grid = out.p_grid.double()
    buy, inj, trade = (x.double()[..., None] for x in (out.buy_price, out.injection_price, out.trade_price))
    kwh = cfg.sim.slot_hours * 1e-3
    plain = (p_grid * torch.where(p_grid >= 0, buy, inj) + out.p_p2p.double() * trade) * kwh
    r = p_grid.sum(dim=-1)
    matched = inter_community_traded_fraction(out.p_grid).double() * r
    res_tariff = torch.where(r >= 0, buy[..., 0], inj[..., 0])
    change = (out.cost.double() - plain).sum(dim=-1)
    expected = matched * (trade[..., 0] - res_tariff) * kwh
    tol = 1e-5 * (out.cost.double().abs() + plain.abs()).sum(dim=-1) + 1e-9
    ok = bool(((change - expected).abs() <= tol).all())
    return ok, (matched.abs() * kwh).sum(dim=(1, 2)), change.sum(dim=(1, 2))


def phase_multi_community(counters, card):
    """The JAX bench's cfg5 (benchmarks.py:631-661): 8 communities of 128
    agents with inter-community trading, one shared tabular learner,
    ``SimConfig`` defaults (rounds=1 -> on the card the factored clearing in
    float32, K1 at [8,128]); traces and ratings as benchmarks.py:353-357
    builds them (the numpy trace backend). One warm, one timed and one
    profiled ``train_multi_community`` episode; then the greedy evaluation
    over the 13 days of ``synthetic_traces()`` (K1 at [104,128]) with the
    trained table and with a DDPG learner shared by every agent, each held
    to the port on the CPU (same market: costs rtol=1e-5, decisions equal;
    DDPG's within 1e-5 of the heat pump's power) and the re-priced energy
    to the matched energy, per day; each learner's communities must trade
    with each other on some day. Returns (rows, launches, {kernel:
    {shape: device ms per call}})."""
    import dataclasses

    import numpy as np
    import torch

    from p2pmicrogrid_tpu_torch import config as tc
    from p2pmicrogrid_tpu_torch.data.traces import synthetic_traces
    from p2pmicrogrid_tpu_torch.envs.community import make_ratings, resolve_market_dtype, resolve_market_impl
    from p2pmicrogrid_tpu_torch.envs.multi_community import evaluate_multi_community, train_multi_community
    from p2pmicrogrid_tpu_torch.parallel import (
        init_shared_pol_state,
        make_scenario_traces,
        stack_scenario_arrays,
    )
    from p2pmicrogrid_tpu_torch.train import make_policy

    T, C, A = 96, MULTI_C, MULTI_A
    cfg = tc.default_config(
        sim=tc.SimConfig(n_agents=A, n_scenarios=C, slot_unroll=2),
        train=tc.TrainConfig(implementation="tabular"),
    )
    market = (resolve_market_impl(cfg, "cuda"), resolve_market_dtype(cfg, "cuda"))
    log(f"phase 7: cfg5 [{C},{A}] resolves to the {market[0]} clearing in {market[1]} on the card")
    if market != ("factored", "float32"):
        fail(f"cfg5: the market resolved to {market}, not the factored clearing in float32")
    ratings = make_ratings(cfg, np.random.default_rng(42))
    arrays = stack_scenario_arrays(cfg, make_scenario_traces(cfg), ratings, "cuda")
    policy = make_policy(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    state = {"pol": init_shared_pol_state(cfg, "cuda", gen)}

    def train():
        state["pol"], _, rewards, _, _ = train_multi_community(cfg, policy, state["pol"], arrays, ratings, gen, 1)
        return rewards

    rows, totals, shapes = [], {name: 0 for name in counters}, {}
    row, launches = timed_rows("cfg5", counters, ("merged_min_sums",), T, train, T * C)
    row.update(card=card, C=C, A=A, market=market)
    rows.append(row)
    for name, n in launches.items():
        totals[name] += n
    shapes.setdefault("merged_min_sums", {})[(C, A)] = row["kernel_device_ms_per_call"].get("merged_min_sums")

    # The greedy evaluation of the 13 days, every day's 8 communities trading
    # among themselves: [104, 128] rows a slot.
    traces = synthetic_traces().normalized()
    normals = torch.randn((EVAL_DAYS, C, 2, A), generator=torch.Generator().manual_seed(3))
    cpu_cfg = dataclasses.replace(cfg, sim=dataclasses.replace(cfg.sim, market_impl="factored"))
    ddpg_cfg = dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, implementation="ddpg"),
        ddpg=tc.DDPGConfig(share_across_agents=True),
    )
    # The DDPG actor is drawn on the CPU from seed 0, whose communities trade
    # with each other on some days (the CUDA generator's draw after training
    # made every community a buyer on every day).
    ddpg_pol = init_shared_pol_state(ddpg_cfg, "cpu", torch.Generator().manual_seed(0))
    learners = (
        ("cfg5 evaluation", cfg, state["pol"]),
        ("cfg5 evaluation ddpg", ddpg_cfg, copy_state(ddpg_cfg, ddpg_pol, "cuda")),
    )
    for label, ecfg, pol in learners:
        epolicy = make_policy(ecfg)
        holder = {}

        def evaluate(device="cuda", ecfg=ecfg, pol=pol, epolicy=epolicy, holder=holder):
            _, out, _ = evaluate_multi_community(
                ecfg, epolicy, pol, traces, ratings, normals=normals.to(device), device=device
            )
            holder[device] = out
            return out.reward.sum(dim=(1, 2, 3)).cpu().numpy()

        row, launches = timed_rows(label, counters, ("merged_min_sums",), T, evaluate, EVAL_DAYS * C * T)
        for name, n in launches.items():
            totals[name] += n
        shapes.setdefault("merged_min_sums", {})[(EVAL_DAYS * C, A)] = row["kernel_device_ms_per_call"].get(
            "merged_min_sums"
        )
        out = holder["cuda"]
        if tuple(out.cost.shape) != (EVAL_DAYS, T, C, A):
            fail(f"{label}: costs {tuple(out.cost.shape)}, expected {(EVAL_DAYS, T, C, A)}")
        ccfg = dataclasses.replace(ecfg, sim=cpu_cfg.sim)
        _, ref, _ = evaluate_multi_community(
            ccfg, make_policy(ccfg), copy_state(ecfg, pol, "cpu"), traces, ratings, normals=normals,
            device="cpu",
        )
        dec_g, dec_c = out.decisions.cpu().numpy(), ref.decisions.numpy()
        if ecfg.train.implementation == "ddpg":
            dec_err = float(np.abs(dec_g - dec_c).max())
            if dec_err > 1e-5 * ecfg.thermal.hp_max_power:
                fail(f"{label}: decisions differ card vs CPU by {dec_err} W")
        elif not np.array_equal(dec_g, dec_c):
            fail(f"{label}: {int((dec_g != dec_c).sum())} decisions differ card vs CPU")
        cost_g, cost_c = out.cost.cpu().numpy(), ref.cost.numpy()
        if not np.allclose(cost_g, cost_c, rtol=1e-5, atol=1e-7):
            fail(f"{label}: costs differ card vs CPU, max abs {float(np.abs(cost_g - cost_c).max())}")
        conserved, matched, change = repriced_vs_matched(ecfg, out)
        matched, change = matched.cpu().numpy(), change.cpu().numpy()
        if not conserved:
            fail(f"{label}: the re-priced energy is not the matched energy ({matched} kWh a day matched)")
        if not (matched > 0).any():
            fail(f"{label}: no community traded with another on any day")
        row.update(
            card=card, days=EVAL_DAYS, C=C, A=A,
            cost_max_rel_err_vs_cpu=float(np.abs((cost_g - cost_c) / np.where(cost_c == 0, 1, cost_c)).max()),
            matched_kwh_per_day=matched.tolist(), inter_trade_euro_per_day=change.tolist(),
        )
        log(f"phase 7: {label}: card = CPU (costs within 1e-5, decisions equal), re-priced = matched "
            f"energy in every slot ({float(matched.sum()):.3f} kWh matched over {EVAL_DAYS} days)")
        rows.append(row)
    return rows, totals, shapes


# (label, implementation, A, fused, path kernels): the independent rows, 64
# communities each with its own per-agent learners: cfg1's width
# (A=2 tabular) unfused (K5 and K6 at [64,2]) and fused (K7 with one
# learner per scenario), and cfg2's (A=10 per-agent DDPG, buffer 1024, batch
# 32; K5 and K6 at [64,10]).
INDEPENDENT_ROWS = (
    ("independent cfg1", "tabular", 2, False, SINGLE_R1),
    ("independent cfg1 fused", "tabular", 2, True, FUSED_PATH),
    ("independent cfg2", "ddpg", 10, False, SINGLE_R1),
)


def phase_independent(counters, card):
    """``train_scenarios_independent`` at S=64 (BASELINE config 4's scenario
    count) for each of INDEPENDENT_ROWS: cfg1's and cfg2's SimConfig
    (rounds=1, battery off) at 64 communities, traces of
    ``make_scenario_traces`` and ratings ``default_rng(42)``; one warm, one
    timed and one profiled episode. Returns (rows, launches, {kernel:
    {shape: device ms per call}})."""
    import numpy as np
    import torch

    from p2pmicrogrid_tpu_torch import config as tc
    from p2pmicrogrid_tpu_torch.envs.community import make_ratings
    from p2pmicrogrid_tpu_torch.parallel import (
        init_independent_state,
        make_independent_episode_fn,
        make_scenario_traces,
        stack_scenario_arrays,
        train_scenarios_independent,
    )
    from p2pmicrogrid_tpu_torch.train import make_policy

    T, S = 96, INDEPENDENT_S
    rows, totals, shapes = [], {name: 0 for name in counters}, {}
    for label, impl, A, fused, path in INDEPENDENT_ROWS:
        cfg = tc.default_config(
            sim=tc.SimConfig(n_agents=A, n_scenarios=S),
            train=tc.TrainConfig(implementation=impl),
            ddpg=tc.DDPGConfig(buffer_size=1024, batch_size=32),
        )
        ratings = make_ratings(cfg, np.random.default_rng(42))
        arrays = stack_scenario_arrays(cfg, make_scenario_traces(cfg), ratings, "cuda")
        policy = make_policy(cfg)
        gen = torch.Generator(device="cuda").manual_seed(0)
        state = {"pol": init_independent_state(cfg, S, "cuda", gen)}
        episode_fn = make_independent_episode_fn(cfg, policy, arrays, ratings, fused=fused)

        def train(cfg=cfg, policy=policy, arrays=arrays, ratings=ratings, gen=gen, state=state,
                  episode_fn=episode_fn):
            state["pol"], rewards, _, _ = train_scenarios_independent(
                cfg, policy, state["pol"], arrays, ratings, gen, 1, episode_fn=episode_fn
            )
            return rewards

        row, launches = timed_rows(label, counters, path, T, train, T * S)
        row.update(card=card, S=S, A=A, impl=impl, fused=fused)
        rows.append(row)
        for name, n in launches.items():
            totals[name] += n
        for name, ms in row["kernel_device_ms_per_call"].items():
            shapes.setdefault(name, {})[(S, A)] = ms
    return rows, totals, shapes

# --- phase 8 ---------------------------------------------------------------

# The guarded northstar run as its users run it (the JAX CLI's chunked
# default): train_chunked_with_health with telemetry on, an eval every
# episode on 8 held-out scenarios (K1 at [8,1000] bf16) and the lr-boost
# mitigation; the kill/resume check at the northstar width with its depth
# cut to K=8 chunks and 3 episodes.
HEALTH_S_EVAL = 8
RESUME_K, RESUME_EPISODES = 8, 3
# The guarded run's depth, cut from the northstar's 80 chunks an episode to
# 16 and, since phase 14, to 8 to keep the whole script inside its time
# limit (phase 5 times the 80-chunk episode; the width stays 1000 agents x
# 128 scenarios a chunk).
GUARDED_K = 8


def northstar_config():
    from p2pmicrogrid_tpu_torch import config as tc

    return chunked_config(tc, "ddpg", NORTHSTAR["A"], NORTHSTAR["S"],
                          buffer_size=NORTHSTAR["buffer_size"], batch_size=NORTHSTAR["batch_size"])


def read_run_dir(run_dir):
    """The run directory's manifest, metrics lines and Chrome trace, each
    parsed; fails where one is missing or does not parse."""
    out = {}
    try:
        with open(os.path.join(run_dir, "manifest.json")) as f:
            out["manifest"] = json.load(f)
        with open(os.path.join(run_dir, "metrics.jsonl")) as f:
            out["records"] = [json.loads(line) for line in f]
        with open(os.path.join(run_dir, "trace.json")) as f:
            out["trace"] = json.load(f)
        with open(os.path.join(run_dir, "summary.json")) as f:
            out["summary"] = json.load(f)
    except (OSError, ValueError) as exc:
        fail(f"telemetry run directory {run_dir}: {exc}")
    if not out["trace"].get("traceEvents"):
        fail(f"telemetry run directory {run_dir}: the Chrome trace holds no span")
    return out


def phase_guarded_northstar(counters, card, tmp, bare_env_steps):
    """(a) ``train_chunked_with_health`` at the northstar row: a warm
    episode and two timed ones (an eval after each), then one more block
    with the monitor restored in the basin, so the boosted runner is
    captured and replayed. Returns (row, launches)."""
    import numpy as np
    import torch

    from p2pmicrogrid_tpu_torch.envs.community import make_ratings
    from p2pmicrogrid_tpu_torch.parallel import scenarios as sc
    from p2pmicrogrid_tpu_torch.telemetry import Telemetry
    from p2pmicrogrid_tpu_torch.train import health as th
    from p2pmicrogrid_tpu_torch.train import make_policy

    cfg = northstar_config()
    A, S, K, T = NORTHSTAR["A"], NORTHSTAR["S"], GUARDED_K, 96
    what = f"guarded northstar A={A} S={S} K={K}"
    torch.cuda.synchronize()
    gc_collect()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    root = os.path.join(tmp, "runs")
    tel = Telemetry.create("chip-smoke-health", cfg=cfg, root=root)
    ratings = make_ratings(cfg, np.random.default_rng(42))
    policy = make_policy(cfg)
    pol = sc.init_shared_pol_state(cfg, device="cuda", generator=torch.Generator(device="cuda").manual_seed(0))
    stamps = []
    cb = lambda ep, r, l, c: stamps.append((ep, time.perf_counter(), float(np.mean(r))))
    reset(counters)
    start = time.perf_counter()
    pol, rew, loss, secs, monitor = th.train_chunked_with_health(
        cfg, policy, pol, ratings, 0, 3, K, eval_every=1, mitigate="lr-boost", s_eval=HEALTH_S_EVAL,
        telemetry=tel, episode_cb=cb,
    )
    total_s = time.perf_counter() - start
    launches = {name: fn.launches for name, fn in counters.items()}
    # Each episode: K replays of T K1 launches; each capture's eager warm-up
    # run one chunk's T (the boosted runner's too, where an eval put the
    # policy in the basin); each eval (before the first episode and after
    # each) T at [8,1000].
    captures = 1 + int(any(e < 3 for e in monitor.basin_entries))
    expect = {name: (3 * K * T + captures * T + 4 * T if name == "merged_min_sums" else 0) for name in counters}
    if launches != expect:
        fail(f"{what}: launches {launches}, expected {expect}")
    if rew.shape != (3, K * S) or not (np.isfinite(rew).all() and np.isfinite(loss).all()):
        fail(f"{what}: rewards {rew.shape} or losses not finite")
    if [p.episode for p in monitor.points] != [0, 1, 2, 3]:
        fail(f"{what}: eval points at {[p.episode for p in monitor.points]}")
    episode_s = [b - a for (_, a, _), (_, b, _) in zip(stamps, stamps[1:])]
    timed_s = statistics.mean(episode_s)
    # One eval alone, timed after a synchronisation: its seconds and its
    # launches.
    greedy = th.make_greedy_eval(cfg, policy, ratings, s_eval=HEALTH_S_EVAL)
    greedy(pol)
    torch.cuda.synchronize()
    reset(counters)
    t0 = time.perf_counter()
    c, r = greedy(pol)
    float(c)
    eval_s = time.perf_counter() - t0
    eval_launches = counters["merged_min_sums"].launches
    if {name: fn.launches for name, fn in counters.items()} != {
        name: (T if name == "merged_min_sums" else 0) for name in counters
    }:
        fail(f"{what}: one eval launched {({n: fn.launches for n, fn in counters.items()})}, expected K1 {T}")
    first_peak = torch.cuda.max_memory_allocated() - base
    # The boosted block: the monitor restored from its record into one held
    # in the basin (whatever the block's first eval says), as a run resumed
    # inside the basin would be.
    class HeldInBasin(th.HealthMonitor):
        @property
        def in_basin(self):
            return True

    restored = HeldInBasin.from_dict(monitor.to_dict())
    gc_collect()
    before_boost = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    boost_stamps = []
    reset(counters)
    pol, rew_b, _, _, monitor_b = th.train_chunked_with_health(
        cfg, policy, pol, ratings, 0, 1, K, eval_every=1, episode0=3, mitigate="lr-boost",
        s_eval=HEALTH_S_EVAL, monitor=restored, telemetry=tel,
        episode_cb=lambda ep, r, l, c: boost_stamps.append(
            [g["lr"] for opt in (c.actor_opt, c.critic_opt) for g in opt.param_groups]
        ),
    )
    boost_launches = {name: fn.launches for name, fn in counters.items()}
    boost_peak = torch.cuda.max_memory_allocated() - before_boost
    expect = {name: (K * T + T + 2 * T if name == "merged_min_sums" else 0) for name in counters}
    if boost_launches != expect:
        fail(f"{what} boosted block: launches {boost_launches}, expected {expect}")
    lrs = th._lr_boosted_cfg(cfg, 3.0).ddpg
    if boost_stamps != [[lrs.actor_lr, lrs.critic_lr]]:
        fail(f"{what}: the boosted block trained at {boost_stamps}, not {lrs.actor_lr, lrs.critic_lr}")
    if not np.isfinite(rew_b).all():
        fail(f"{what} boosted block: non-finite rewards")
    tel.close()
    # The first run again with telemetry off (no device counters, no
    # records), the evals kept: what the counters and the records cost.
    gc_collect()
    pol_off = sc.init_shared_pol_state(cfg, device="cuda", generator=torch.Generator(device="cuda").manual_seed(0))
    stamps_off = []
    reset(counters)
    _, rew_off, _, _, monitor_off = th.train_chunked_with_health(
        cfg, policy, pol_off, ratings, 0, 3, K, eval_every=1, mitigate="lr-boost", s_eval=HEALTH_S_EVAL,
        telemetry=None, episode_cb=lambda ep, r, l, c: stamps_off.append(time.perf_counter()),
    )
    captures_off = 1 + int(any(e < 3 for e in monitor_off.basin_entries))
    expect = {name: (3 * K * T + captures_off * T + 4 * T if name == "merged_min_sums" else 0) for name in counters}
    if {name: fn.launches for name, fn in counters.items()} != expect:
        fail(f"{what} with telemetry off: launches {({n: fn.launches for n, fn in counters.items()})}, expected {expect}")
    off_episode_s = [b - a for a, b in zip(stamps_off, stamps_off[1:])]
    run = read_run_dir(tel.run_dir)
    gauges = run["summary"]["gauges"]
    need = [f"profile.{label}.{m}" for label in ("chunk_graph", "chunk_graph_boosted")
            for m in ("graph_nodes", "graph_pool_bytes", "graph_capture_seconds", "peak_allocated_bytes",
                      "kernel_launches")]
    missing = [g for g in need if g not in gauges]
    if missing:
        fail(f"{what}: profile gauges missing: {missing}")
    if gauges.get("profile.chunk_graph.kernel_launches") != K * T:
        fail(f"{what}: the profiled graph launches {gauges.get('profile.chunk_graph.kernel_launches')}, not {K * T}")
    counters_ev = [
        {k: v for k, v in r.items() if k not in ("ts", "kind")}
        for r in run["records"] if r.get("kind") == "device_counters"
    ]
    train_ev = [c for c in counters_ev if c["phase"] == "train"]
    if [c["episode"] for c in train_ev] != [0, 1, 2, 3]:
        fail(f"{what}: device_counters events for episodes {[c['episode'] for c in train_ev]}")
    for c in counters_ev:
        if c["nonfinite_q"] or c["nonfinite_loss"]:
            fail(f"{what}: non-finite counts {c}")
    if run["manifest"].get("device_kind") != torch.cuda.get_device_name(0):
        fail(f"{what}: the manifest names {run['manifest'].get('device_kind')}")
    steps = T * S * K
    row = dict(
        row="guarded northstar", card=card, A=A, S=S, K=K, s_eval=HEALTH_S_EVAL, eval_every=1,
        mitigate="lr-boost", episode_s=episode_s, env_steps_per_s=steps / timed_s,
        bare_northstar_env_steps_per_s=bare_env_steps,
        telemetry_off_episode_s=off_episode_s,
        telemetry_off_env_steps_per_s=steps / statistics.mean(off_episode_s),
        rewards_equal_telemetry_off=bool(np.array_equal(rew, rew_off)),
        call_s=total_s, eval_s=eval_s, eval_env_steps_per_s=T * HEALTH_S_EVAL / eval_s,
        eval_launches=eval_launches,
        boost_capture_s=gauges.get("profile.chunk_graph_boosted.graph_capture_seconds"),
        boost_pool_bytes=gauges.get("profile.chunk_graph_boosted.graph_pool_bytes"),
        graph_pool_bytes=gauges.get("profile.chunk_graph.graph_pool_bytes"),
        graph_nodes=gauges.get("profile.chunk_graph.graph_nodes"),
        peak_gib=first_peak / 2**30, boosted_block_peak_gib=boost_peak / 2**30,
        replay_fill_fraction=gauges.get("replay.fill_fraction"),
        host_blocked_fraction=gauges.get("train.host_blocked_fraction"),
        device_counters=counters_ev, health=[p._asdict() for p in monitor.points + monitor_b.points[-1:]],
        boosted_lrs=boost_stamps[0], k1_launches=launches["merged_min_sums"] + boost_launches["merged_min_sums"],
    )
    log(
        f"phase 8: {what} ({card}): env-steps/s {row['env_steps_per_s']:.1f} with an eval every episode "
        f"({row['telemetry_off_env_steps_per_s']:.1f} with telemetry off; bare northstar in this call: "
        f"{bare_env_steps}), eval {eval_s:.3f} s, boosted runner capture "
        f"{row['boost_capture_s']} s, pool {row['boost_pool_bytes']} B, peak "
        f"{row['peak_gib']:.3f} GiB"
    )
    log(f"phase 8: {json.dumps(row)}")
    totals = {name: launches[name] + boost_launches[name] for name in counters}
    return row, totals


def gc_collect():
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def phase_graph_counters(counters):
    """(b) The chunk graph's device counters against the eager loop's at
    K=2 and the northstar width, from the same state and seeds: integers
    equal, energies bit for bit; and at A=6, S=3, K=2 on the card (graph)
    against the CPU (eager) from the same injected draws: integers equal,
    energies rtol=1e-5; and what the counters cost the device a chunk.
    Returns (the cost, the launches)."""
    import numpy as np
    import torch

    from p2pmicrogrid_tpu_torch import config as tc
    from p2pmicrogrid_tpu_torch.envs.community import make_ratings
    from p2pmicrogrid_tpu_torch.parallel import scenarios as sc
    from p2pmicrogrid_tpu_torch.telemetry import dc_to_dict
    from p2pmicrogrid_tpu_torch.train import make_policy

    totals = {name: 0 for name in counters}

    def run(cfg, device, graph, K, pol0, seeds=None, draws=None):
        ratings = make_ratings(cfg, np.random.default_rng(42))
        policy = make_policy(cfg)
        episode_fn = sc.make_device_episode_fn(cfg, policy, ratings, device=device, collect_device_metrics=True)
        runner = sc.make_chunked_episode_runner(cfg, episode_fn, K, graph=graph, collect_device_metrics=True)
        reset(counters)
        out = runner(copy_state(cfg, pol0, device), seeds=seeds, draws=draws)
        for name, fn in counters.items():
            totals[name] += fn.launches
        return dc_to_dict(out[3]), out[4].numpy(), out[1].cpu().numpy()

    cfg = northstar_config()
    pol0 = sc.init_shared_pol_state(cfg, device="cuda", generator=torch.Generator(device="cuda").manual_seed(3))
    dg, fg, rg = run(cfg, "cuda", True, 2, pol0, seeds=[11, 12])
    gc_collect()
    de, fe, re_ = run(cfg, "cuda", False, 2, pol0, seeds=[11, 12])
    gc_collect()
    what = f"counters in the chunk graph, A={cfg.sim.n_agents} S={cfg.sim.n_scenarios} K=2"
    if dg != de or not np.array_equal(fg, fe) or not np.array_equal(rg, re_):
        fail(f"{what}: graph {dg} {fg} vs eager {de} {fe}")
    if not any(dg.values()):
        fail(f"{what}: every counter is 0")
    log(f"phase 8: {what}: equal to the eager loop's bit for bit: {json.dumps(dg)}, fills {fg.tolist()}")
    # What the counters cost the device: a K=2 call of the graph runner with
    # them and of one without, each after its capture, timed with CUDA
    # events (best of 3), and each graph's nodes.
    cost = {}
    for collect in (True, False):
        episode_fn = sc.make_device_episode_fn(
            cfg, make_policy(cfg), make_ratings(cfg, np.random.default_rng(42)), device="cuda",
            collect_device_metrics=collect,
        )
        runner = sc.make_chunked_episode_runner(cfg, episode_fn, 2, graph=True, collect_device_metrics=collect)
        state = copy_state(cfg, pol0, "cuda")
        reset(counters)
        runner(state, seeds=[11, 12])
        reps = []
        for _ in range(3):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            runner(state, seeds=[11, 12])
            end.record()
            end.synchronize()
            reps.append(start.elapsed_time(end) / 2)
        for name, fn in counters.items():
            totals[name] += fn.launches
        (cap, *_), *_ = runner.graphs.values()
        cost["counters" if collect else "bare"] = dict(chunk_ms=min(reps), nodes=graph_stats(cap)["nodes"])
        del runner, episode_fn, state, cap
        gc_collect()
    cost["counters_ms_per_chunk"] = cost["counters"]["chunk_ms"] - cost["bare"]["chunk_ms"]
    log(f"phase 8: the counters' device cost, a chunk at A={cfg.sim.n_agents} S={cfg.sim.n_scenarios}: "
        f"{json.dumps(cost)}")
    A, S, K = 6, 3, 2
    small = tc.default_config(
        sim=tc.SimConfig(n_agents=A, n_scenarios=S, market_impl="factored"),
        battery=tc.BatteryConfig(enabled=True),
        train=tc.TrainConfig(implementation="tabular"),
    )
    pol0 = sc.init_shared_pol_state(small, device="cpu", generator=torch.Generator().manual_seed(5))
    gen = torch.Generator().manual_seed(9)
    ep = sc.make_device_episode_fn(small, make_policy(small), make_ratings(small, np.random.default_rng(42)),
                                   device="cpu")
    draws = [sc.ChunkDraws(None, (), ep.draw(gen)) for _ in range(K)]
    dc_c, _, _ = run(small, "cpu", False, K, pol0, draws=draws)
    dc_g, _, _ = run(small, "cuda", True, K, pol0, draws=[sc._map_tensors(lambda x: x.cuda(), d) for d in draws])
    what = f"counters card (graph) vs CPU, tabular A={A} S={S} K={K}"
    for name in ("nonfinite_q", "nonfinite_loss", "comfort_violations"):
        if dc_g[name] != dc_c[name]:
            fail(f"{what}: {name} {dc_g[name]} vs {dc_c[name]}")
    for name in ("market_residual_wh", "trade_wh"):
        if not np.isclose(dc_g[name], dc_c[name], rtol=1e-5, atol=0.0):
            fail(f"{what}: {name} {dc_g[name]} vs {dc_c[name]}")
    log(f"phase 8: {what}: integers equal, energies within 1e-5: {json.dumps(dc_g)}")
    return cost, totals


def phase_kill_resume(tmp):
    """(c) The kill/resume check at the northstar width, K=8, 3 episodes:
    ``supervise`` runs the port's training child with a checkpoint every
    episode and a fault plan that SIGKILLs it at episode 2's start (after
    episode 1's save); relaunched with ``--resume`` it finishes, and its
    final state's digest equals an uninterrupted child's. Returns the row."""
    import io
    import threading

    from p2pmicrogrid_tpu_torch.train import faults as tf
    from p2pmicrogrid_tpu_torch.train import resilience as rs

    plan = tf.TrainFaultPlan(seed=0, events=(tf.TrainFaultEvent(kind="kill", episode=2, attempt=0),))
    plan_path = os.path.join(tmp, "kill_plan.json")
    with open(plan_path, "w") as f:
        f.write(plan.to_json())
    argv = [sys.executable, "-m", "p2pmicrogrid_tpu_torch.train.resilience", "--child",
            "--episodes", str(RESUME_EPISODES), "--chunks", str(RESUME_K),
            "--agents", str(NORTHSTAR["A"]), "--scenarios", str(NORTHSTAR["S"])]
    env = {"PYTHONPATH": HERE + os.pathsep + os.environ.get("PYTHONPATH", "")}
    results, runs = {}, {}

    def supervised(label, extra):
        out = io.StringIO()
        start = time.perf_counter()
        res = rs.supervise(argv + ["--ckpt-dir", os.path.join(tmp, label)] + extra,
                           max_restarts=2, backoff_s=0.0, env=env, passthrough=out)
        runs[label] = (res, time.perf_counter() - start, out)

    # The two runs are independent children: side by side (since phase 14
    # needed the time), each on its own checkpoint directory.
    threads = [threading.Thread(target=supervised, args=(label, extra)) for label, extra in
               (("killed", ["--fault-plan", plan_path]), ("uninterrupted", []))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for label in ("killed", "uninterrupted"):
        if label not in runs:
            fail(f"kill/resume {label}: the supervisor raised")
        res, secs, out = runs[label]
        lines = [json.loads(l) for l in out.getvalue().splitlines() if l.startswith("{")]
        startups = [l["child_startup"] for l in lines if "child_startup" in l]
        done = [l["child_done"] for l in lines if "child_done" in l]
        if not res.succeeded or len(done) != 1:
            fail(f"kill/resume {label}: exit {res.exit_code}, attempts {res.attempts}")
        results[label] = dict(
            seconds=secs, attempts=[a["exit_code"] for a in res.attempts], kills=res.kills,
            resumes=res.resumes, startups=startups, digest=done[0]["digest"],
        )
    killed, clean = results["killed"], results["uninterrupted"]
    if killed["attempts"] != [-9, 0] or killed["startups"][-1]["resumed_from"] != 1:
        fail(f"kill/resume: attempts {killed['attempts']}, startups {killed['startups']}")
    if killed["digest"] != clean["digest"]:
        fail(f"kill/resume: the resumed run's digest {killed['digest']} != the uninterrupted {clean['digest']}")
    row = dict(row="kill/resume", A=NORTHSTAR["A"], S=NORTHSTAR["S"], K=RESUME_K, episodes=RESUME_EPISODES,
               **results)
    log(f"phase 8: kill/resume at A={NORTHSTAR['A']} S={NORTHSTAR['S']} K={RESUME_K}: SIGKILL after episode 1's "
        f"save, resumed from ep_1, final digest equal to the uninterrupted run's ({clean['digest'][:23]})")
    log(f"phase 8: {json.dumps(row)}")
    return row


def single_rollback(device, draws_seed=2):
    """cfg1 (A=2 tabular, 6 episodes, a checkpoint every episode) under
    ``train_community_with_rollback`` with NaN poisoned into the table at
    episode 3's block, every draw from a CPU generator: (records, final
    table, rewards)."""
    import tempfile

    import numpy as np
    import torch

    from p2pmicrogrid_tpu_torch import config as tc
    from p2pmicrogrid_tpu_torch.train import faults as tf
    from p2pmicrogrid_tpu_torch.train import init_policy_state
    from p2pmicrogrid_tpu_torch.train import resilience as rs

    cfg = single_config(tc, "tabular", 2, max_episodes=6, episodes_per_jit_block=2, save_episodes=1,
                        min_episodes_criterion=2)
    traces, ratings = single_inputs(cfg)
    pol = copy_state(cfg, init_policy_state(cfg, "cpu", torch.Generator().manual_seed(5)), device)
    plan = tf.TrainFaultPlan(seed=0, events=(tf.TrainFaultEvent(kind="poison_nan", episode=3),))
    injector = tf.TrainFaultInjector(plan, kill_mode="raise")
    with tempfile.TemporaryDirectory() as ckpt:
        result, records = rs.train_community_with_rollback(
            cfg, pol, traces, ratings, torch.Generator().manual_seed(draws_seed), ckpt,
            guard_policy=rs.GuardPolicy(max_rollbacks=2), fault_injector=injector, device=device,
        )
    return records, result.pol_state.q_table.cpu().numpy(), np.array(result.episode_rewards)


def phase_single_resilience(counters, card):
    """(d) The single community's rollback on the card against the CPU, and
    ``train_community(telemetry=...)`` timed at drain depth 2. Returns
    (row, launches)."""
    import dataclasses

    import numpy as np
    import torch

    from p2pmicrogrid_tpu_torch import config as tc
    from p2pmicrogrid_tpu_torch.telemetry import MemorySink, Telemetry
    from p2pmicrogrid_tpu_torch.train import init_policy_state, make_policy, train_community

    totals = {name: 0 for name in counters}
    reset(counters)
    rec_g, q_g, rew_g = single_rollback("cuda")
    for name, fn in counters.items():
        totals[name] += fn.launches
    rec_c, q_c, rew_c = single_rollback("cpu")
    what = "single community rollback (cfg1, NaN at episode 3)"
    if [dataclasses.asdict(r) for r in rec_g] != [dataclasses.asdict(r) for r in rec_c] or len(rec_g) != 1:
        fail(f"{what}: card records {rec_g} vs CPU {rec_c}")
    if not np.isfinite(q_g).all() or not np.allclose(q_g, q_c, rtol=1e-3, atol=1e-4):
        fail(f"{what}: final table card vs CPU max abs diff {np.abs(q_g - q_c).max()}")
    if not np.allclose(rew_g, rew_c, rtol=2e-4, atol=0.0):
        fail(f"{what}: rewards card {rew_g} vs CPU {rew_c}")
    log(f"phase 8: {what}: card = CPU, records {[dataclasses.asdict(r) for r in rec_g]}, "
        f"table max abs diff {np.abs(q_g - q_c).max():.3e}")
    # One timed episode with telemetry, the drain at depth 2.
    cfg = single_config(tc, "tabular", 2, max_episodes=2, episodes_per_jit_block=1)
    traces, ratings = single_inputs(cfg)
    policy = make_policy(cfg)
    pol = copy_state(cfg, init_policy_state(cfg, "cpu", torch.Generator().manual_seed(5)), "cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    warm = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, max_episodes=1))
    train_community(warm, policy, pol, traces, ratings, gen)
    sink = MemorySink()
    tel = Telemetry(run_id="single", sinks=[sink])
    timed = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, starting_episodes=1))
    reset(counters)
    res = train_community(timed, policy, pol, traces, ratings, gen, telemetry=tel, pipeline=True)
    launches = {name: fn.launches for name, fn in counters.items()}
    expect = {name: (96 if name in SINGLE_R1 else 0) for name in counters}
    if launches != expect:
        fail(f"single telemetry episode: launches {launches}, expected {expect}")
    for name in counters:
        totals[name] += launches[name]
    tel.close()
    summary = tel.summary()
    device_counts = {k: v for k, v in summary["counters"].items() if k.startswith("device.")}
    if len(device_counts) != 5 or "profile.episode_scan.kernel_launches" not in summary["gauges"]:
        fail(f"single telemetry episode: counters {device_counts}, gauges {sorted(summary['gauges'])}")
    row = dict(row="cfg1 with telemetry", card=card, episode_s=res.train_seconds,
               env_steps_per_s=res.env_steps_per_sec, pipeline_depth=summary["gauges"]["train.pipeline_depth"],
               host_blocked_fraction=summary["gauges"]["train.host_blocked_fraction"],
               device_counters=device_counts, rollback=[dataclasses.asdict(r) for r in rec_g])
    log(f"phase 8: {json.dumps(row)}")
    return row, totals


def phase_draw_digests():
    """(e) The seed-0 draws on this machine's CPU against the pinned
    digests (tests/test_torch_resilience.py pins the same)."""
    import torch

    from p2pmicrogrid_tpu_torch.draw_digests import PINNED, seed0_digests

    got = seed0_digests()
    if got != PINNED:
        fail(f"seed-0 CPU draws under torch {torch.__version__}: {got}, pinned {PINNED}")
    log(f"phase 8: seed-0 CPU draws under torch {torch.__version__} equal the pinned digests {json.dumps(got)}")
    return got


# --- phase 9 ---------------------------------------------------------------

# Serving at the widths the port trains: cfg1's tabular table (A=2, buckets
# up to 256), per-agent DQN at the shared DQN row's A=1000 (hidden 64) and
# the northstar's shared DDPG actor at A=1000 (buckets up to 64).
SERVE_WIDE_A, SERVE_WIDE_BATCH, SERVE_NARROW_BATCH = 1000, 64, 256
SERVE_DTYPES = ("float32", "float16", "int8")
SERVE_LATENCY_CALLS = 200
SERVE_CLIENTS, SERVE_CLIENT_REQUESTS, SERVE_TABULAR_REQUESTS = 8, 64, 256
# Four session steps of five sessions (bucket 8: three padded rows).
SERVE_SESSION_STEPS, SERVE_SESSIONS = 4, 5
# Admission wide open: the gateway legs measure serving, not shedding (the
# 8 client threads share the gateway's interpreter lock, and under the
# default 50 ms wait budget part of their requests are shed). Each bundle's
# p95 queue wait is logged beside the shed count.
SERVE_ADMISSION = dict(max_queue_depth=1 << 16, wait_budget_ms=1e9)


def serve_states(tc):
    """(label, cfg, seeded state) of each served policy: cfg1's table drawn
    on the card, per-agent DQN drawn on the card, and the northstar's shared
    DDPG actor drawn from CPU seeds 0 and 1 (seed 0's draw held to
    draw_digests.py's pin). The DDPG configs differ in their seed, so their
    bundles' config_hash does too (the registry's key)."""
    import torch

    from p2pmicrogrid_tpu_torch.draw_digests import PINNED, _digest
    from p2pmicrogrid_tpu_torch.models.ddpg import ddpg_params_init
    from p2pmicrogrid_tpu_torch.models.dqn import dqn_init
    from p2pmicrogrid_tpu_torch.models.tabular import tabular_init

    tab_cfg = single_config(tc, "tabular", 2)
    tab = tabular_init(tab_cfg.qlearning, 2, device="cuda")
    card_gen = torch.Generator(device="cuda").manual_seed(0)
    tab = tab._replace(q_table=torch.randn(tab.q_table.shape, generator=card_gen, device="cuda"))
    dqn_cfg = tc.default_config(
        sim=tc.SimConfig(n_agents=SERVE_WIDE_A),
        train=tc.TrainConfig(implementation="dqn"),
        dqn=tc.DQNConfig(hidden=64, buffer_size=16),
    )
    dqn = dqn_init(dqn_cfg.dqn, SERVE_WIDE_A, card_gen, device="cuda")
    out = [("tabular", tab_cfg, tab), ("dqn", dqn_cfg, dqn)]
    for seed in (0, 1):
        cfg = tc.default_config(
            sim=tc.SimConfig(n_agents=SERVE_WIDE_A),
            train=tc.TrainConfig(implementation="ddpg", seed=seed),
            ddpg=tc.DDPGConfig(share_across_agents=True, buffer_size=NORTHSTAR["buffer_size"],
                               batch_size=NORTHSTAR["batch_size"]),
        )
        params = ddpg_params_init(cfg.ddpg, SERVE_WIDE_A, torch.Generator().manual_seed(seed), device="cpu")
        if seed == 0:
            got = _digest([t.detach().numpy() for net in (params.actor, params.critic) for t in net.parameters()])
            if got != PINNED["ddpg_actor_critic"]:
                fail(f"phase 9: the seed-0 DDPG draw digests {got}, pinned {PINNED['ddpg_actor_critic']}")
        out.append((f"ddpg_seed{seed}", cfg, params))
    return out


def flip_count(err):
    """The calibration flips an int8 export's refusal names."""
    return int(str(err).split(":")[1].split()[0])


def serve_export(label, cfg, state, tmp):
    """(a) Each dtype's bundle exported on the card; DQN's int8 verdict held
    to the port's CPU engine's on the same state. Returns ({dtype: path or
    None}, the export record)."""
    from p2pmicrogrid_tpu_torch.serve import export_policy_bundle, load_policy_bundle

    paths, rec = {}, {"label": label}
    for dtype in SERVE_DTYPES:
        path = os.path.join(tmp, f"{label}_{dtype}")
        start = time.perf_counter()
        try:
            export_policy_bundle(cfg, state, path, dtype=dtype, device="cuda")
        except ValueError as exc:
            if dtype != "int8" or cfg.train.implementation != "dqn":
                fail(f"phase 9: {label} {dtype} export refused: {exc}")
            card = flip_count(exc)
            try:
                export_policy_bundle(cfg, state, path + "_cpu", dtype=dtype, device="cpu")
                fail(f"phase 9: {label} int8 refused on the card ({card} flips) but accepted on the CPU")
            except ValueError as cpu_exc:
                cpu = flip_count(cpu_exc)
            rec["int8"] = {"verdict": "refused", "card_flips": card, "cpu_flips": cpu,
                           "calibration_decisions": 64 * cfg.sim.n_agents}
            log(f"phase 9: {label} int8 refused on the card ({card} calibration flips) and on "
                f"the CPU ({cpu}): the same verdict")
            paths[dtype] = None
            continue
        secs = time.perf_counter() - start
        manifest, _ = load_policy_bundle(path)
        rec[dtype] = {"export_s": secs, "param_bytes": manifest["param_bytes"]}
        if dtype == "int8":
            bound = manifest["quant"]["error_bound"]
            rec["int8"]["error_bound"] = bound
            if cfg.train.implementation == "dqn":
                try:
                    export_policy_bundle(cfg, state, path + "_cpu", dtype=dtype, device="cpu")
                except ValueError as cpu_exc:
                    fail(f"phase 9: {label} int8 accepted on the card, refused on the CPU: {cpu_exc}")
                rec["int8"]["verdict"] = "accepted"
            log(f"phase 9: {label} int8 error bound {json.dumps(bound)}")
        paths[dtype] = path
    log(f"phase 9: {label} exported: {json.dumps(rec)}")
    return paths, rec


def q_near_ties(bundle, obs, got, ref):
    """DQN: each flip's Q gap on the CPU and whether it is a near tie (the
    two actions' Q-values within 1e-4 of their size, summed in another
    order on the card); returns (explanations, all explained)."""
    import numpy as np
    import torch

    from p2pmicrogrid_tpu_torch.config import DQNConfig
    from p2pmicrogrid_tpu_torch.convert import network_from_tree
    from p2pmicrogrid_tpu_torch.models.dqn import _q_all_actions
    from p2pmicrogrid_tpu_torch.models.networks import QNetwork
    from p2pmicrogrid_tpu_torch.serve import load_policy_bundle

    _, params = load_policy_bundle(bundle)
    params = {k: {f: np.asarray(v, np.float32) for f, v in d.items()} for k, d in params.items()}
    out, ok = [], True
    for dev in ("cpu", "cuda"):
        net = network_from_tree(params, QNetwork, torch.device(dev))
        with torch.no_grad():
            q = _q_all_actions(DQNConfig(), net, torch.from_numpy(obs).to(dev)).cpu().numpy()
        if dev == "cpu":
            q_cpu = q
        else:
            q_card = q
    for i, a in np.argwhere(got != ref):
        ia, ib = int(round(got[i, a] * 2)), int(round(ref[i, a] * 2))
        row = q_cpu[i, a]
        gap = abs(float(row[ia] - row[ib]))
        tie = gap <= 1e-4 * float(np.abs(row).max())
        ok &= tie
        out.append({"row": int(i), "agent": int(a), "card": ia, "cpu": ib, "q_gap_cpu": gap,
                    "q_card_minus_cpu": float(np.abs(q_card[i, a] - row).max()),
                    "cause": "near tie" if tie else "unexplained"})
    return out, ok


def latency_ms(fn, calls=SERVE_LATENCY_CALLS):
    """(p50, p99) in ms of ``fn()`` over ``calls`` calls after 10 warm ones,
    host clock: each call ends with its actions on the host."""
    import numpy as np

    for _ in range(10):
        fn()
    times = []
    for _ in range(calls):
        start = time.perf_counter()
        fn()
        times.append((time.perf_counter() - start) * 1e3)
    return float(np.percentile(times, 50)), float(np.percentile(times, 99))


def serve_engine_check(label, impl, dtype, path, A, max_batch, timed):
    """(b) The card engine against the port's CPU engine at every bucket,
    each replay against the eager forward on the card; with ``timed`` (the
    float32 bundles) the sessions' four steps and (c) each bucket's
    latency. Returns the record."""
    import numpy as np
    import torch

    from p2pmicrogrid_tpu_torch.serve import PolicyEngine, calibration_obs

    eng = PolicyEngine(bundle_dir=path, max_batch=max_batch, device="cuda")
    cpu = PolicyEngine(bundle_dir=path, max_batch=max_batch, device="cpu")
    eng.warmup(include_step=timed)
    rec = dict(label=label, dtype=dtype, A=A, max_batch=max_batch,
               capture_s={str(b): s for b, s in eng.capture_s.items()},
               capture_s_total=sum(eng.capture_s.values()),
               graph_pool_bytes=eng.graph_pool_bytes, captures=eng.stats["aot_compiles"])
    decisions, flips, max_err, explained, latency = 0, 0, 0.0, [], {}
    for b in eng.buckets:
        obs = calibration_obs(b, A, seed=900 + b)
        got, ref = eng.act(obs), cpu.act(obs)
        eager = eng.forward(torch.from_numpy(obs).cuda()).cpu().numpy()
        if not np.array_equal(got, eager):
            fail(f"phase 9: {label} {dtype} bucket {b}: the graph replay differs from the eager "
                 f"forward (max {np.abs(got - eager).max()})")
        decisions += got.size
        if impl == "ddpg":
            max_err = max(max_err, float(np.abs(got - ref).max()))
        elif not np.array_equal(got, ref):
            if impl == "tabular":
                fail(f"phase 9: {label} {dtype} bucket {b}: a table gather differs from the CPU's")
            why, ok = q_near_ties(path, obs, got, ref)
            flips += len(why)
            explained += why
            if not ok:
                fail(f"phase 9: {label} {dtype} bucket {b}: unexplained flips {why}")
        if timed:
            obs_cuda = lambda: eng.forward(torch.from_numpy(obs).cuda()).cpu().numpy()  # noqa: E731
            latency[str(b)] = dict(
                zip(("replay_p50_ms", "replay_p99_ms"), latency_ms(lambda: eng.act(obs)))
            ) | dict(zip(("eager_p50_ms", "eager_p99_ms"), latency_ms(obs_cuda))) | dict(
                zip(("cpu_p50_ms", "cpu_p99_ms"), latency_ms(lambda: cpu.act(obs))))
    if impl == "ddpg" and max_err > 1e-5:
        fail(f"phase 9: {label} {dtype}: card against CPU max abs err {max_err} > 1e-5")
    if flips / decisions >= 1e-4:
        fail(f"phase 9: {label} {dtype}: {flips} of {decisions} decisions flipped (>= 1e-4)")
    rec.update(decisions=decisions, flips=flips, flip_share=flips / decisions, flip_causes=explained,
               max_abs_err=max_err if impl == "ddpg" else None, replay_equals_eager=True)
    if timed:
        rec["latency"] = latency
        rec["sessions"] = serve_sessions_check(label, impl, eng, cpu, A)
    log(f"phase 9: {json.dumps(rec)}")
    return rec


def serve_sessions_check(label, impl, eng, cpu, A):
    """Four session steps on the card and on the CPU: the same hp_frac
    (discrete equal up to explained flips, DDPG within 1e-5), slots
    [4, ...]; each card step answers what its act does."""
    import numpy as np

    from p2pmicrogrid_tpu_torch.serve import calibration_obs

    s_card, s_cpu = eng.init_sessions(SERVE_SESSIONS), cpu.init_sessions(SERVE_SESSIONS)
    worst = 0.0
    for k in range(SERVE_SESSION_STEPS):
        obs = calibration_obs(SERVE_SESSIONS, A, seed=700 + k)
        s_card, hp = eng.step(s_card, obs)
        s_cpu, hp_cpu = cpu.step(s_cpu, obs)
        if not np.array_equal(hp, eng.act(obs)):
            fail(f"phase 9: {label} session step {k} differs from act on the card")
        if not np.array_equal(s_card.hp_frac.cpu().numpy(), hp):
            fail(f"phase 9: {label} session step {k}: hp_frac is not the served action")
        err = float(np.abs(hp - hp_cpu).max())
        worst = max(worst, err)
        if (impl == "ddpg" and err > 1e-5) or (impl != "ddpg" and (hp != hp_cpu).mean() >= 1e-4):
            fail(f"phase 9: {label} session step {k}: card against CPU differs ({err})")
    slots = s_card.slots.cpu().tolist()
    if slots != [SERVE_SESSION_STEPS] * SERVE_SESSIONS or slots != s_cpu.slots.tolist():
        fail(f"phase 9: {label} session slots {slots}, CPU {s_cpu.slots.tolist()}")
    return {"steps": SERVE_SESSION_STEPS, "sessions": SERVE_SESSIONS, "slots": slots,
            "max_abs_diff_vs_cpu": worst}


def drive_gateway(gateway, obs, households, swap_to=None):
    """8 client threads, each over one keep-alive connection, post their
    requests to ``/v1/act``; with ``swap_to``, once half the requests have
    answered, ``POST /admin/swap`` moves the default there. Returns
    ([(client, i, status, actions, config_hash, sent after the swap)],
    per-request ms, wall seconds, swap record)."""
    import http.client
    import threading

    import numpy as np

    host, port = gateway.host, gateway.port
    total = sum(len(o) for o in obs)
    lock, half = threading.Lock(), threading.Event()
    swapped = threading.Event()
    answers, times = [], []

    def client(c):
        conn = http.client.HTTPConnection(host, port, timeout=60)
        try:
            for i, row in enumerate(obs[c]):
                body = json.dumps({"household": households[c][i], "obs": row.tolist()})
                after = swapped.is_set()
                start = time.perf_counter()
                conn.request("POST", "/v1/act", body, {"Content-Type": "application/json"})
                resp = conn.getresponse()
                doc = json.loads(resp.read())
                ms = (time.perf_counter() - start) * 1e3
                with lock:
                    answers.append((c, i, resp.status, doc.get("actions"), doc.get("config_hash"), after))
                    times.append(ms)
                    if len(answers) >= total // 2:
                        half.set()
        finally:
            conn.close()

    threads = [threading.Thread(target=client, args=(c,), daemon=True) for c in range(len(obs))]
    start = time.perf_counter()
    for t in threads:
        t.start()
    swap = None
    if swap_to is not None:
        if not half.wait(120):
            fail("phase 9: the gateway clients did not reach half their requests in 120 s")
        conn = http.client.HTTPConnection(host, port, timeout=60)
        conn.request("POST", "/admin/swap", json.dumps({"config_hash": swap_to}),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        swap = {"status": resp.status, "answered_before": len(answers), **json.loads(resp.read())}
        conn.close()
        swapped.set()
    for t in threads:
        t.join(300)
        if t.is_alive():
            fail("phase 9: a gateway client did not finish in 300 s")
    wall = time.perf_counter() - start
    return answers, np.asarray(times), wall, swap


def record_batches(engine):
    """Wrap ``engine.act`` so that each row it computes is kept, keyed by
    its observation's bytes: what the engine answered for that request in
    the batch it rode."""
    rows, act = {}, engine.act

    def recorded(obs):
        out = act(obs)
        for o, a in zip(obs, out):
            rows[o.tobytes()] = a.copy()
        return out

    engine.act = recorded
    return rows


def serve_gateway_front(batching, ddpg_paths):
    """(d) One front over the two DDPG bundles: 8 clients x 64 requests, the
    default swapped to seed 1 halfway, every answer held bit for bit to the
    row ``engine.act`` of the bundle that answered computed for it
    (``record_batches``), and to ``engine.act`` on its observation alone
    (bucket 1): cuBLAS picks its kernel by shape, so the actor's sums may
    run in another order from one bucket to the next; those differences
    are counted."""
    import numpy as np

    from p2pmicrogrid_tpu_torch.serve import AdmissionConfig, GatewayServer, build_gateway, calibration_obs

    start = time.perf_counter()
    gateway = build_gateway(ddpg_paths, max_batch=SERVE_WIDE_BATCH, device="cuda", batching=batching,
                            admission=AdmissionConfig(**SERVE_ADMISSION))
    build_s = time.perf_counter() - start
    h0, h1 = gateway.registry.hashes
    engines = {h: gateway.registry.get(h).engine for h in (h0, h1)}
    computed = {h: record_batches(e) for h, e in engines.items()}
    server = GatewayServer(gateway)
    server.start()
    try:
        obs = [calibration_obs(SERVE_CLIENT_REQUESTS, SERVE_WIDE_A, seed=500 + c)
               for c in range(SERVE_CLIENTS)]
        households = [[f"house-{c}-{i % 4}" for i in range(SERVE_CLIENT_REQUESTS)]
                      for c in range(SERVE_CLIENTS)]
        answers, times, wall, swap = drive_gateway(gateway, obs, households, swap_to=h1)
        stats = gateway.stats_snapshot()
        served = {h: (e.padding_waste, e.stats["batches"]) for h, e in engines.items()}
        summaries = {h: b.telemetry.summary() for h, b in
                     ((h, gateway.registry.get(h)) for h in (h0, h1))}
    finally:
        server.stop()
    failed = [a for a in answers if a[2] != 200]
    if failed or len(answers) != SERVE_CLIENTS * SERVE_CLIENT_REQUESTS:
        fail(f"phase 9: {batching} gateway: {len(failed)} failed of {len(answers)}: {failed[:3]}")
    if swap["status"] != 200 or swap["default"] != h1:
        fail(f"phase 9: {batching} gateway swap answered {swap}")
    alone_differs, spread = 0, 0.0
    for c, i, _, actions, config_hash, after in answers:
        if after and config_hash != h1:
            fail(f"phase 9: {batching} gateway: a request sent after the swap answered from {config_hash}")
        got = np.asarray(actions, np.float32)
        row = computed[config_hash].get(obs[c][i].tobytes())
        if row is None or not np.array_equal(got, row):
            fail(f"phase 9: {batching} gateway: an answer is not the row its engine computed")
        alone = engines[config_hash].act(obs[c][i][None])[0]
        alone_differs += int(not np.array_equal(got, alone))
        spread = max(spread, float(np.abs(got - alone).max()))
    occ = summaries[h0]["histograms"].get("serve.batch_occupancy", {})
    rec = dict(
        front=batching, requests=len(answers), failed=0,
        equal_to_the_engines_row=True, differ_from_act_alone=alone_differs,
        max_abs_diff_from_act_alone=spread,
        answered_by={h: sum(a[4] == h for a in answers) for h in (h0, h1)},
        swap_after_requests=swap["answered_before"], p50_ms=float(np.percentile(times, 50)),
        p99_ms=float(np.percentile(times, 99)), requests_per_s=len(answers) / wall,
        padding_waste={h: w for h, (w, _) in served.items()},
        batches={h: n for h, (_, n) in served.items()},
        occupancy_mean=occ.get("mean"), shed=stats["gateway"]["shed"],
        queue_wait_p95_ms={h: b["recent_wait_p95_ms"] for h, b in stats["bundles"].items()},
        build_s=build_s, hot_swap_capture_s=sum(engines[h1].capture_s.values()),
        graph_pool_bytes={h: e.graph_pool_bytes for h, e in engines.items()},
    )
    log(f"phase 9: {json.dumps(rec)}")
    return rec


def serve_gateway_tabular(path):
    """(d) 256 requests to cfg1's table through the micro front, each
    answer held to ``engine.act`` bit for bit."""
    import numpy as np

    from p2pmicrogrid_tpu_torch.serve import AdmissionConfig, GatewayServer, build_gateway, calibration_obs

    gateway = build_gateway([path], max_batch=SERVE_NARROW_BATCH, device="cuda", batching="micro",
                            admission=AdmissionConfig(**SERVE_ADMISSION))
    engine = gateway.registry.get(gateway.registry.default_hash).engine
    per = SERVE_TABULAR_REQUESTS // SERVE_CLIENTS
    obs = [calibration_obs(per, 2, seed=600 + c) for c in range(SERVE_CLIENTS)]
    households = [[f"home-{c}-{i}" for i in range(per)] for c in range(SERVE_CLIENTS)]
    server = GatewayServer(gateway)
    server.start()
    try:
        answers, times, wall, _ = drive_gateway(gateway, obs, households)
        shed = gateway.stats["shed"]
        waste, batches = engine.padding_waste, engine.stats["batches"]
        wait_p95 = gateway.stats_snapshot()["bundles"][gateway.registry.default_hash]["recent_wait_p95_ms"]
    finally:
        server.stop()
    bad = [a for a in answers if a[2] != 200 or not np.array_equal(
        np.asarray(a[3], np.float32), engine.act(obs[a[0]][a[1]][None])[0])]
    if bad or len(answers) != SERVE_TABULAR_REQUESTS:
        fail(f"phase 9: tabular gateway: {len(bad)} failed or differing of {len(answers)}")
    rec = dict(front="micro", bundle="tabular cfg1", requests=len(answers), failed=0,
               bit_exact_vs_engine_act=True, p50_ms=float(np.percentile(times, 50)),
               p99_ms=float(np.percentile(times, 99)), requests_per_s=len(answers) / wall,
               padding_waste=waste, batches=batches, shed=shed, queue_wait_p95_ms=wait_p95)
    log(f"phase 9: {json.dumps(rec)}")
    return rec


def phase_serving(counters):
    """Phase 9: bundles, the engine's graphs against the CPU engine, latency
    per bucket, and the gateway end to end on both fronts; no K1-K7
    launch."""
    import shutil
    import tempfile

    from p2pmicrogrid_tpu_torch import config as tc

    start = time.perf_counter()
    reset(counters)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    out = {"exports": [], "engines": [], "gateway": []}
    try:
        paths = {}
        for label, cfg, state in serve_states(tc):
            paths[label], rec = serve_export(label, cfg, state, tmp)
            out["exports"].append(rec)
        for label, impl, A, mb in (("tabular", "tabular", 2, SERVE_NARROW_BATCH),
                                   ("dqn", "dqn", SERVE_WIDE_A, SERVE_WIDE_BATCH),
                                   ("ddpg_seed0", "ddpg", SERVE_WIDE_A, SERVE_WIDE_BATCH)):
            for dtype in SERVE_DTYPES:
                if paths[label][dtype] is not None:
                    out["engines"].append(serve_engine_check(
                        label, impl, dtype, paths[label][dtype], A, mb, timed=dtype == "float32"))
        ddpg = [paths["ddpg_seed0"]["float32"], paths["ddpg_seed1"]["float32"]]
        for batching in ("micro", "continuous"):
            out["gateway"].append(serve_gateway_front(batching, ddpg))
        out["gateway"].append(serve_gateway_tabular(paths["tabular"]["float32"]))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = {name: fn.launches for name, fn in counters.items()}
    if any(launches.values()):
        fail(f"phase 9: serving launched hand-written kernels: {launches}")
    out["kernel_launches"] = launches
    out["seconds"] = time.perf_counter() - start
    return out


# --- phase 10 ---------------------------------------------------------------

# The recurrent models: the day-granular DDPG at the northstar community's
# size (A=1000, 4 days; card against CPU at A=8 over 3 days), its bundles
# with buckets up to 64 and four sessions stepped over a whole day, the
# continuous batcher's ring and the gateway, and the forecaster at the
# reference's widths (ml.py:198-229: 20/100/100/20, windows 3/3/3, batch 32).
RECURRENT_A, RECURRENT_DAYS = 1000, 4
RECURRENT_SMALL_A, RECURRENT_SMALL_DAYS = 8, 3
RECURRENT_BATCH, RECURRENT_SESSIONS, RECURRENT_LATENCY_CALLS = 64, 4, 20
FORECAST_EPOCHS = 2


def recurrent_config(tc, A):
    return tc.default_config(
        sim=tc.SimConfig(n_agents=A), train=tc.TrainConfig(implementation="ddpg_recurrent")
    )


def synced_seconds(fn):
    """(``fn()``, host seconds ending in a device synchronisation)."""
    import torch

    torch.cuda.synchronize()
    start = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - start


def recurrent_step_check(card, cpu):
    """(a) The step scanned over 96 slots from zeros against the whole
    sequence on the card (atol 1e-6), and the card's sequence against the
    CPU's (TF32 off, atol 1e-5): A=1000 agents' days of random
    observations."""
    import torch

    from p2pmicrogrid_tpu_torch.models.ddpg_recurrent import recurrent_actor_init_hidden, recurrent_actor_step

    obs = torch.rand((RECURRENT_A, 96, 4), generator=torch.Generator().manual_seed(5))
    obs_c = obs.cuda()
    with torch.no_grad():
        full = card.actor(obs_c)[..., 0]
        h = recurrent_actor_init_hidden((RECURRENT_A,), card.actor.lstm_features, device="cuda")
        steps = []
        for t in range(96):
            a, h = recurrent_actor_step(card.actor, obs_c[:, t], h)
            steps.append(a)
        scan_err = float((torch.stack(steps, 1) - full).abs().max())
        cpu_err = float((full.cpu() - cpu.actor(obs)[..., 0]).abs().max())
    if scan_err > 1e-6:
        fail(f"phase 10: the step scanned from zeros differs from the sequence by {scan_err} > 1e-6")
    if cpu_err > 1e-5:
        fail(f"phase 10: the card's sequence differs from the CPU's by {cpu_err} > 1e-5")
    rec = {"A": RECURRENT_A, "T": 96, "scan_max_abs_err": scan_err, "card_vs_cpu_max_abs_err": cpu_err}
    log(f"phase 10: (a) {json.dumps(rec)}")
    return rec


def recurrent_training(tc):
    """(b) ``train_recurrent_community`` at A=8 over 3 days on the card and
    on the CPU from one CPU draw (rtol 2e-4), the seed-0 init digest against
    the pinned one; then A=1000 over 4 days from a CPU-drawn init: seconds
    a day, one day's rollout and one learn step timed alone and profiled,
    peak memory. Returns (record, the trained A=1000 state, its config)."""
    import numpy as np
    import torch

    from p2pmicrogrid_tpu_torch.convert import state_from_jax, state_to_numpy
    from p2pmicrogrid_tpu_torch.data.traces import SLOTS_PER_DAY, synthetic_traces
    from p2pmicrogrid_tpu_torch.draw_digests import PINNED_RECURRENT, recurrent_init_digest
    from p2pmicrogrid_tpu_torch.envs.community import build_episode_arrays, init_physical, make_ratings, ratings_to
    from p2pmicrogrid_tpu_torch.models.ddpg_recurrent import recurrent_ddpg_init, recurrent_ddpg_learn
    from p2pmicrogrid_tpu_torch.train.recurrent import RecurrentDraws, rollout_day, train_recurrent_community

    digest = recurrent_init_digest()
    rec = {"init_digest": digest if digest == PINNED_RECURRENT else "differs from the CPU tests' pin",
           "init_digest_equal": digest == PINNED_RECURRENT}
    A = RECURRENT_SMALL_A
    cfg = recurrent_config(tc, A)
    gen = torch.Generator().manual_seed(0)
    state0 = state_to_numpy(recurrent_ddpg_init(cfg.ddpg, gen, device="cpu"))
    draws = RecurrentDraws(torch.randn((2, A), generator=gen),
                           torch.randn((RECURRENT_SMALL_DAYS, SLOTS_PER_DAY, A), generator=gen))
    runs = {}
    for dev in ("cuda", "cpu"):
        runs[dev] = train_recurrent_community(
            cfg, RECURRENT_SMALL_DAYS, state=state_from_jax(state0, device=dev, cfg=cfg.ddpg),
            draws=draws, device=dev,
        )
    small = {}
    for field in ("day_rewards", "day_costs", "losses"):
        got, ref = getattr(runs["cuda"], field), getattr(runs["cpu"], field)
        rel = float(np.max(np.abs(got - ref) / np.maximum(np.abs(ref), 1e-12)))
        if not np.isfinite(got).all() or rel > 2e-4:
            fail(f"phase 10: A={A} {field} card {got} against CPU {ref}: rel err {rel} > 2e-4")
        small[field] = {"card": got.tolist(), "cpu": ref.tolist(), "max_rel_err": rel}
    rec["card_vs_cpu_A8"] = small

    A = RECURRENT_A
    cfg = recurrent_config(tc, A)
    state = state_from_jax(
        state_to_numpy(recurrent_ddpg_init(cfg.ddpg, torch.Generator().manual_seed(1), device="cpu")),
        device="cuda", cfg=cfg.ddpg,
    )
    card_gen = torch.Generator(device="cuda").manual_seed(2)
    torch.cuda.reset_peak_memory_stats()
    res, secs = synced_seconds(lambda: train_recurrent_community(
        cfg, RECURRENT_DAYS, card_gen, state=state, device="cuda"))
    peak = torch.cuda.max_memory_allocated()
    if not (np.isfinite(res.day_rewards).all() and np.isfinite(res.losses).all()):
        fail(f"phase 10: A={A} training is not finite: {res.day_rewards} {res.losses}")
    # One day's pieces alone, on a copy of the trained state.
    ratings = make_ratings(cfg, np.random.default_rng(cfg.train.seed))
    arrays = build_episode_arrays(cfg, synthetic_traces(), ratings, device="cuda")
    day = type(arrays)(*(x[:SLOTS_PER_DAY] for x in arrays))
    rd = ratings_to(ratings, "cuda")
    copy = state_from_jax(state_to_numpy(res.state), device="cuda", cfg=cfg.ddpg)
    phys = init_physical(cfg, torch.randn((2, A), generator=card_gen, device="cuda"), device="cuda")
    normals = torch.randn((SLOTS_PER_DAY, A), generator=card_gen, device="cuda")
    roll = lambda: rollout_day(cfg, copy.actor, phys, day, rd, normals)  # noqa: E731
    ro, roll_s = synced_seconds(roll)
    learn = lambda: recurrent_ddpg_learn(  # noqa: E731
        cfg.ddpg, copy, ro.obs_seq, ro.act_seq, ro.reward_seq.sum(dim=-1), ro.obs_seq)
    _, learn_s = synced_seconds(learn)
    _, day_s = synced_seconds(lambda: (roll(), learn()))
    kernels, _ = profile_episode(lambda: (roll(), learn()), SLOTS_PER_DAY, day_s)
    busy = None if kernels is None else sum(ms for _, ms in kernels.values())
    rec["A1000"] = dict(
        A=A, days=RECURRENT_DAYS, seconds=secs, s_per_day=secs / RECURRENT_DAYS,
        rollout_s=roll_s, learn_s=learn_s, rollout_plus_learn_s=day_s,
        device_busy_ms_per_day=busy, device_ops_per_day=None if kernels is None else sum(
            n for n, _ in kernels.values()),
        idle_share=None if busy is None else 1 - busy / (day_s * 1e3),
        peak_memory_gib=peak / 2**30, day_rewards=res.day_rewards.tolist(),
        day_costs=res.day_costs.tolist(), losses=res.losses.tolist(),
    )
    log(f"phase 10: (b) {json.dumps(rec)}")
    return rec, res.state, cfg


def recurrent_reference_actor(path):
    """The bundle's actor as the engine loads it (float32), on the card."""
    import torch

    from p2pmicrogrid_tpu_torch.convert import network_from_tree
    from p2pmicrogrid_tpu_torch.models.ddpg_recurrent import RecurrentActor
    from p2pmicrogrid_tpu_torch.serve import load_policy_bundle
    from p2pmicrogrid_tpu_torch.serve.engine import _float32_tree

    _, params = load_policy_bundle(path)
    return network_from_tree(_float32_tree(params), RecurrentActor, torch.device("cuda"))


def recurrent_bundles(cfg, state, tmp):
    """(c) float32 and float16 bundles of the A=1000 state, int8 refused.
    Each engine on the card against the CPU engine at every bucket up to 64
    on a live carry (actions and carry within 1e-5), each replay equal to
    the eager step bit for bit; four sessions stepped over 96 slots against
    the whole sequence; the float32 engine's latency per bucket. Returns
    (record, {dtype: path})."""
    import numpy as np
    import torch

    from p2pmicrogrid_tpu_torch.serve import PolicyEngine, calibration_obs, export_policy_bundle

    A = RECURRENT_A
    try:
        export_policy_bundle(cfg, state, os.path.join(tmp, "rec_int8"), dtype="int8", device="cuda")
        fail("phase 10: an int8 recurrent export was accepted")
    except ValueError as exc:
        if "int8" not in str(exc):
            raise
    rec, paths = {"int8": "refused"}, {}
    for dtype in ("float32", "float16"):
        path = paths[dtype] = export_policy_bundle(cfg, state, os.path.join(tmp, f"rec_{dtype}"),
                                                   dtype=dtype, device="cuda")
        eng = PolicyEngine(bundle_dir=path, max_batch=RECURRENT_BATCH, device="cuda")
        cpu = PolicyEngine(bundle_dir=path, max_batch=RECURRENT_BATCH, device="cpu")
        eng.warmup()
        worst, latency = 0.0, {}
        for b in eng.buckets:
            obs = calibration_obs(b, A, seed=800 + b)
            _, h = cpu.act(obs, np.zeros((b, A, eng.hidden_dim), np.float32))  # a live carry
            got, got_h = eng.act(obs, h)
            with torch.no_grad():
                ea, eh = eng.forward(torch.from_numpy(obs).cuda(), torch.from_numpy(h).cuda())
            if not (np.array_equal(got, ea.cpu().numpy()) and np.array_equal(got_h, eh.cpu().numpy())):
                fail(f"phase 10: {dtype} bucket {b}: the graph replay differs from the eager step")
            ref, ref_h = cpu.act(obs, h)
            worst = max(worst, float(np.abs(got - ref).max()), float(np.abs(got_h - ref_h).max()))
            if dtype == "float32":
                latency[str(b)] = dict(zip(("replay_p50_ms", "replay_p99_ms"),
                                           latency_ms(lambda: eng.act(obs, h), RECURRENT_LATENCY_CALLS)))
        if worst > 1e-5:
            fail(f"phase 10: {dtype} engine: card against CPU max abs err {worst} > 1e-5")
        # Four sessions over a whole day against the whole sequence.
        n = RECURRENT_SESSIONS
        seq = calibration_obs(96 * n, A, seed=77).reshape(96, n, A, 4)
        sessions = eng.init_sessions(n)
        served = []
        for t in range(96):
            sessions, hp = eng.step(sessions, seq[t])
            served.append(hp)
        served = np.stack(served)  # [96, n, A]
        with torch.no_grad():
            x = torch.from_numpy(np.ascontiguousarray(seq.transpose(1, 2, 0, 3)).reshape(n * A, 96, 4)).cuda()
            full = recurrent_reference_actor(path)(x)[..., 0].reshape(n, A, 96).permute(2, 0, 1)
        seq_err = float(np.abs(served - full.cpu().numpy()).max())
        if seq_err > 1e-5 or sessions.slots.cpu().tolist() != [96] * n:
            fail(f"phase 10: {dtype} 96 session steps against the whole sequence: {seq_err} > 1e-5")
        rec[dtype] = dict(
            buckets=eng.buckets, card_vs_cpu_max_abs_err=worst, replay_equals_eager=True,
            sessions=n, session_steps=96, sessions_vs_sequence_max_abs_err=seq_err,
            captures=eng.stats["aot_compiles"], capture_s_total=sum(eng.capture_s.values()),
            graph_pool_bytes=eng.graph_pool_bytes, param_bytes=eng.manifest["param_bytes"],
        )
        if latency:
            rec[dtype]["latency"] = latency
    log(f"phase 10: (c) {json.dumps(rec)}")
    return rec, paths


def recurrent_ring(path):
    """(d) The continuous batcher's ring on the card, stepped by hand:
    households keep their trajectories, an evicted slot re-initialises bit
    for bit, slot exhaustion defers. Then the gateway's continuous front:
    8 clients x 64 requests with household ids, each answer against that
    household's own carry stepped through ``engine.act``; latency and the
    ring's graph pool."""
    import numpy as np

    from p2pmicrogrid_tpu_torch.serve import (
        AdmissionConfig,
        ContinuousBatcher,
        GatewayServer,
        PolicyEngine,
        build_gateway,
        calibration_obs,
    )

    A = RECURRENT_A
    eng = PolicyEngine(bundle_dir=path, max_batch=RECURRENT_BATCH, device="cuda")
    eng.warmup(include_step=False)
    obs = calibration_obs(8, A, seed=91)
    fresh = lambda i: eng.act(obs[i][None], eng.init_hidden(1))[0][0]  # noqa: E731
    rec = {}
    with ContinuousBatcher(eng, max_slots=4, autostart=False) as cb:
        warmed = cb.warmup()
        got = {h: [] for h in ("h0", "h1", "h2")}
        for t in range(5):
            futs = {h: cb.submit(obs[t], household=h) for h in got}
            cb.step_once()
            for h, f in futs.items():
                got[h].append(f.result(5))
        h = eng.init_hidden(1)
        cont = 0.0
        for t in range(5):
            a, h = eng.act(obs[t][None], h)
            cont = max(cont, max(float(np.abs(got[k][t] - a[0]).max()) for k in got))
        if cont > 1e-5:
            fail(f"phase 10: ring continuity against engine.act: {cont} > 1e-5")
        rec.update(warmed=warmed, ring_graph_pool_bytes=cb.graph_pool_bytes, continuity_max_abs_err=cont)
    with ContinuousBatcher(eng, max_slots=1, autostart=False) as cb:
        cb.warmup([1])
        for _ in range(2):
            for i, hh in enumerate(("a", "b")):
                f = cb.submit(obs[i], household=hh)
                cb.step_once()
                if not np.array_equal(f.result(5), fresh(i)):
                    fail("phase 10: an evicted slot's re-init differs from a fresh carry")
        evictions = cb.stats["evictions"]
        fa, fb = cb.submit(obs[2], household="c"), cb.submit(obs[3], household="d")
        cb.step_once()
        deferred = cb.stats["slot_deferrals"]
        if deferred != 1 or cb.stats["scratch_rows"] or fb.done():
            fail(f"phase 10: slot exhaustion did not defer: {cb.stats}")
        cb.step_once()
        fa.result(5), fb.result(5)
        rec.update(eviction_reinit_bit_exact=True, evictions=evictions, deferrals=deferred)
    gateway = build_gateway([path], max_batch=RECURRENT_BATCH, device="cuda", batching="continuous",
                            admission=AdmissionConfig(**SERVE_ADMISSION), max_slots=64)
    bundle = gateway.registry.get(gateway.registry.default_hash)
    server = GatewayServer(gateway)
    server.start()
    try:
        obs_c = [calibration_obs(SERVE_CLIENT_REQUESTS, A, seed=520 + c) for c in range(SERVE_CLIENTS)]
        households = [[f"home-{c}-{i % 4}" for i in range(SERVE_CLIENT_REQUESTS)] for c in range(SERVE_CLIENTS)]
        answers, times, wall, _ = drive_gateway(gateway, obs_c, households)
        occ = bundle.telemetry.summary()["histograms"].get("serve.batch_occupancy", {})
        ring_pool = bundle.queue.graph_pool_bytes
    finally:
        server.stop()
    failed = [a for a in answers if a[2] != 200]
    if failed or len(answers) != SERVE_CLIENTS * SERVE_CLIENT_REQUESTS:
        fail(f"phase 10: recurrent gateway: {len(failed)} failed of {len(answers)}: {failed[:3]}")
    carries, exact, worst = {}, 0, 0.0
    for c, i, _, actions, _, _ in sorted(answers, key=lambda a: (a[0], a[1])):
        hh = households[c][i]
        a, carries[hh] = bundle.engine.act(obs_c[c][i][None], carries.get(hh, bundle.engine.init_hidden(1)))
        got = np.asarray(actions, np.float32)
        exact += int(np.array_equal(got, a[0]))
        worst = max(worst, float(np.abs(got - a[0]).max()))
    if worst > 1e-5:
        fail(f"phase 10: recurrent gateway answers differ from each household's carry by {worst} > 1e-5")
    rec["gateway"] = dict(
        front="continuous", requests=len(answers), households=len(carries), failed=0,
        bit_equal_to_own_carry=exact, max_abs_diff_from_own_carry=worst,
        p50_ms=float(np.percentile(times, 50)), p99_ms=float(np.percentile(times, 99)),
        requests_per_s=len(answers) / wall, occupancy_mean=occ.get("mean"),
        ring_graph_pool_bytes=ring_pool, engine_graph_pool_bytes=bundle.engine.graph_pool_bytes,
    )
    log(f"phase 10: (d) {json.dumps(rec)}")
    return rec


def forecaster_check():
    """(e) The forecaster at the reference's widths: features built from
    ``synthetic_traces()`` as the JAX CLI builds them (cli.py:1518-1529),
    two epochs on the card against the CPU from one init and the same
    permutations (loss rtol 1e-4); seconds per epoch."""
    import numpy as np
    import torch

    from p2pmicrogrid_tpu_torch.config import ForecastConfig
    from p2pmicrogrid_tpu_torch.convert import greedy_tree, network_from_tree
    from p2pmicrogrid_tpu_torch.data.traces import synthetic_traces
    from p2pmicrogrid_tpu_torch.models import forecast as fc
    from p2pmicrogrid_tpu_torch.models.networks import adam

    cfg = ForecastConfig()
    tr = synthetic_traces().normalized()
    feats = np.stack([tr.time, tr.t_out / 20.0, tr.load[:, 0], tr.pv[:, 0]], axis=1)
    x, y = fc.make_windows(feats, cfg.input_width, cfg.label_width, cfg.shift)
    cpu = fc.forecast_init(cfg, x.shape[-1], torch.Generator().manual_seed(0), device="cpu")
    model = network_from_tree(greedy_tree(cpu.params), fc.ForecastModel, torch.device("cuda"))
    card = fc.ForecastState(model, adam(model, cfg.learning_rate))
    data = {dev: (torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)) for dev in ("cuda", "cpu")}
    epochs = []
    for e in range(FORECAST_EPOCHS):
        perm = torch.randperm(x.shape[0], generator=torch.Generator().manual_seed(10 + e))
        (_, loss_c), secs_c = synced_seconds(lambda: fc.forecast_train_epoch(cfg, card, *data["cuda"], perm=perm))
        start = time.perf_counter()
        _, loss_p = fc.forecast_train_epoch(cfg, cpu, *data["cpu"], perm=perm)
        secs_p = time.perf_counter() - start
        loss_c, loss_p = float(loss_c), float(loss_p)
        rel = abs(loss_c - loss_p) / abs(loss_p)
        if rel > 1e-4:
            fail(f"phase 10: forecaster epoch {e}: card loss {loss_c} against CPU {loss_p} (rel {rel} > 1e-4)")
        epochs.append(dict(card_loss=loss_c, cpu_loss=loss_p, rel_err=rel, card_s=secs_c, cpu_s=secs_p))
    rec = dict(windows=int(x.shape[0]), batch=cfg.batch_size, batches_per_epoch=int(x.shape[0]) // cfg.batch_size,
               widths=[cfg.hidden_pre, cfg.hidden_mid, cfg.lstm_features, cfg.hidden_post], epochs=epochs)
    log(f"phase 10: (e) {json.dumps(rec)}")
    return rec


def phase_recurrent(counters):
    """Phase 10: the recurrent models on the card; K1-K7 never launch."""
    import shutil
    import tempfile

    import torch

    from p2pmicrogrid_tpu_torch import config as tc
    from p2pmicrogrid_tpu_torch.convert import state_from_jax, state_to_numpy
    from p2pmicrogrid_tpu_torch.models.ddpg_recurrent import recurrent_ddpg_init

    torch.backends.cuda.matmul.allow_tf32 = False
    start = time.perf_counter()
    reset(counters)
    out = {}
    cfg = recurrent_config(tc, RECURRENT_A)
    cpu = recurrent_ddpg_init(cfg.ddpg, torch.Generator().manual_seed(3), device="cpu")
    card = state_from_jax(state_to_numpy(cpu), device="cuda", cfg=cfg.ddpg)
    out["step_vs_sequence"] = recurrent_step_check(card, cpu)
    out["training"], state, cfg = recurrent_training(tc)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_recurrent_")
    try:
        out["bundles"], paths = recurrent_bundles(cfg, state, tmp)
        out["serving"] = recurrent_ring(paths["float32"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["forecaster"] = forecaster_check()
    launches = {name: fn.launches for name, fn in counters.items()}
    if any(launches.values()):
        fail(f"phase 10: the recurrent models launched hand-written kernels: {launches}")
    out["kernel_launches"] = launches
    out["seconds"] = time.perf_counter() - start
    return out


# --- phase 11 ---------------------------------------------------------------

# The scenario regime engine at the northstar config (shared DDPG, battery
# on, A=1000, 128 scenarios a chunk, K1 bf16 at [128,1000]): 32 scenarios of
# each regime, 4 chunks an episode (8 until phase 14 needed the time), then a
# swap to a held-out portfolio.
REGIME_TRAIN = ("baseline", "winter", "ev_evening", "double_auction")
REGIME_HELD_OUT = ("dr_spike", "islanding_noon", "cold_snap", "uniform_price")
REGIME_K, REGIME_EVAL_S = 4, 4
REGIME_PLAIN_A, REGIME_PLAIN_S = 1000, 64


def regime_baseline_vs_plain(counters, tc):
    """(a) An all-baseline portfolio against the plain shared episode on the
    card: tabular, A=1000, S=64, one episode from one state and seed,
    rewards, losses and the table bit for bit; K1 once a slot each."""
    import numpy as np
    import torch

    from p2pmicrogrid_tpu_torch import regimes as rg
    from p2pmicrogrid_tpu_torch.envs.community import make_ratings, ratings_to
    from p2pmicrogrid_tpu_torch.parallel import scenarios as sc
    from p2pmicrogrid_tpu_torch.parallel.device_gen import device_episode_arrays
    from p2pmicrogrid_tpu_torch.train import make_policy

    A, S = REGIME_PLAIN_A, REGIME_PLAIN_S
    cfg = chunked_config(tc, "tabular", A, S)
    ratings = make_ratings(cfg, np.random.default_rng(42))
    policy = make_policy(cfg)
    arrays = device_episode_arrays(cfg, ratings_to(ratings, "cuda"), S,
                                   generator=torch.Generator(device="cuda").manual_seed(3), device="cuda")
    fns = {
        "plain": sc.make_shared_episode_fn(cfg, policy, arrays, ratings),
        "regime": rg.make_regime_episode_fn(
            cfg, policy, ratings, rg.build_portfolio(["baseline"], S, device="cuda").scenario_params, arrays_s=arrays),
    }
    out = {}
    for name, fn in fns.items():
        pol, scen = sc.init_shared_state(cfg, "cuda", generator=torch.Generator(device="cuda").manual_seed(0))
        reset(counters)
        (pol, _), ys = fn((pol, scen), torch.Generator(device="cuda").manual_seed(7))
        torch.cuda.synchronize()
        out[name] = (ys, pol.q_table.clone(), counters["merged_min_sums"].launches)
    (ys_p, q_p, k_p), (ys_r, q_r, k_r) = out["plain"], out["regime"]
    equal = all(torch.equal(a, b) for a, b in zip(ys_p, ys_r)) and torch.equal(q_p, q_r)
    if not equal or k_p != 96 or k_r != 96:
        fail(f"phase 11: all-baseline regime episode differs from the plain one (K1 {k_p}, {k_r})")
    rec = {"A": A, "S": S, "impl": "tabular", "bit_equal": True, "k1_launches_each": k_r}
    log(f"phase 11: (a) {json.dumps(rec)}")
    return rec


def regime_chunk_runner(cfg, policy, ratings, portfolio, graph):
    """A regime episode over traces made on the card and its chunk runner:
    ``REGIME_K`` chunks through the graph, or one chunk eagerly."""
    from p2pmicrogrid_tpu_torch import regimes as rg
    from p2pmicrogrid_tpu_torch.envs.community import ratings_to
    from p2pmicrogrid_tpu_torch.parallel import scenarios as sc
    from p2pmicrogrid_tpu_torch.parallel.device_gen import device_episode_arrays

    S = cfg.sim.n_scenarios
    rd = ratings_to(ratings, "cuda")
    fn = rg.make_regime_episode_fn(
        cfg, policy, ratings, portfolio.scenario_params,
        arrays_fn=lambda d: device_episode_arrays(cfg, rd, S, draws=d), n_scenarios=S, device="cuda",
    )
    return sc.make_chunked_episode_runner(cfg, fn, REGIME_K if graph else 1, graph=graph)


def regime_northstar(counters, tc, card):
    """(b) The northstar config over the training portfolio through
    ``train_scenarios_chunked(runner=)``: an episode of ``REGIME_K`` chunks (the
    capture), a swap to the held-out portfolio, an episode more (timed);
    one capture in all; K1 once a slot of every chunk run; one chunk's
    replay after the swap against the eager episode with the new regimes,
    bit for bit; env-steps/s and the idle share beside a bare northstar
    runner timed in the same call. Returns (record, trained state, cfg,
    policy, ratings, held-out portfolio, K1 launches on the main path)."""
    import numpy as np
    import torch

    from p2pmicrogrid_tpu_torch import regimes as rg
    from p2pmicrogrid_tpu_torch.envs.community import make_ratings
    from p2pmicrogrid_tpu_torch.parallel import graph as cuda_graph
    from p2pmicrogrid_tpu_torch.parallel import scenarios as sc
    from p2pmicrogrid_tpu_torch.train import make_policy

    cfg = northstar_config()
    S, T, K = cfg.sim.n_scenarios, 96, REGIME_K
    ratings = make_ratings(cfg, np.random.default_rng(42))
    policy = make_policy(cfg)
    pol0 = sc.init_shared_pol_state(cfg, device="cuda", generator=torch.Generator(device="cuda").manual_seed(0))
    train_pf = rg.build_portfolio(list(REGIME_TRAIN), S, device="cuda")
    held_pf = rg.build_portfolio(list(REGIME_HELD_OUT), S, device="cuda")
    # The bare northstar runner, timed in this call; one chunk's replay
    # under the profiler (busy a chunk against the timed episode's share).
    _, _, bare = chunked_runner(cfg, True, K)
    pol = copy_state(cfg, pol0, "cuda")
    sc.train_scenarios_chunked(cfg, policy, pol, ratings, 0, 1, K, runner=bare)
    _, _, _, bare_s = sc.train_scenarios_chunked(cfg, policy, pol, ratings, 1, 1, K, runner=bare, episode0=1)
    (captured,) = bare.graphs.values()
    bare_kernels, _ = profile_episode(lambda: cuda_graph.replay(captured[0]), T, bare_s / K)
    del bare, captured
    torch.cuda.empty_cache()
    # The regime runner: capture, swap, timed episode; K1 counted.
    runner = regime_chunk_runner(cfg, policy, ratings, train_pf, graph=True)
    pol = copy_state(cfg, pol0, "cuda")
    reset(counters)
    pol, r0, _, warm_s = sc.train_scenarios_chunked(cfg, policy, pol, ratings, 0, 1, K, runner=runner)
    runner.episode_fn.with_regimes(held_pf.scenario_params)
    pol, r1, l1, secs = sc.train_scenarios_chunked(cfg, policy, pol, ratings, 1, 1, K, runner=runner, episode0=1)
    k1 = counters["merged_min_sums"].launches
    launches = {name: fn.launches for name, fn in counters.items()}
    if launches != {name: ((1 + 2 * K) * T if name == "merged_min_sums" else 0) for name in counters}:
        fail(f"phase 11: regime northstar launches {launches}, expected K1 {(1 + 2 * K) * T}")
    if len(runner.graphs) != 1:
        fail(f"phase 11: {len(runner.graphs)} graphs captured across the portfolio swap, expected 1")
    if not (np.isfinite(r0).all() and np.isfinite(r1).all() and np.isfinite(l1).all()):
        fail("phase 11: regime northstar rewards or losses are not finite")
    (captured,) = runner.graphs.values()
    graph = graph_stats(captured[0])
    # One chunk's replay after the swap against the eager episode, from one
    # copy of the state (the runner writes its result into ``pol``, the
    # state it captured).
    start = copy_state(cfg, pol, "cuda")
    seeds = sc.chunk_seed_schedule(5, 3, 1, K)[0]
    eager = regime_chunk_runner(cfg, policy, ratings, held_pf, graph=False)
    out_e = eager(copy_state(cfg, start, "cuda"), seeds=seeds[:1])
    out_g = runner(copy_state(cfg, start, "cuda"), seeds=seeds)
    for i, what in ((1, "rewards"), (2, "losses")):
        if not torch.equal(out_g[i][:S], out_e[i]):
            fail(f"phase 11: the chunk replay after the swap differs from the eager episode ({what})")
    regime_kernels, _ = profile_episode(lambda: cuda_graph.replay(captured[0]), T, secs / K)
    busy = lambda k: None if k is None else sum(ms for _, ms in k.values())  # noqa: E731
    steps = T * S * K
    rec = dict(
        card=card, A=cfg.sim.n_agents, S=S, K=K, portfolios=[list(REGIME_TRAIN), list(REGIME_HELD_OUT)],
        scenarios_per_regime=S // 4, captures=len(runner.graphs), graph=graph,
        replay_after_swap_equals_eager=True, k1_launches=k1, k1_expected=(1 + 2 * K) * T,
        env_steps_per_s=steps / secs, episode_s=secs, s_per_chunk=secs / K, warm_episode_s=warm_s,
        bare_env_steps_per_s=steps / bare_s, bare_s_per_chunk=bare_s / K,
        regime_over_bare_chunk_time=secs / bare_s,
        busy_ms_per_chunk=busy(regime_kernels), bare_busy_ms_per_chunk=busy(bare_kernels),
        idle_share=None if busy(regime_kernels) is None else 1 - busy(regime_kernels) * K / (secs * 1e3),
        bare_idle_share=None if busy(bare_kernels) is None else 1 - busy(bare_kernels) * K / (bare_s * 1e3),
        rewards_mean=[float(r0.mean()), float(r1.mean())],
    )
    log(f"phase 11: (b) {json.dumps(rec)}")
    return rec, pol, cfg, policy, ratings, held_pf, k1


def regime_counters_and_physics(cfg, policy, pol, ratings, portfolio):
    """(c) At the northstar width over the held-out portfolio: one
    collecting training episode (counters' rewards against the episode's,
    rtol 1e-4), and one greedy day slot by slot: zero grid exchange in the
    islanded scenarios' window, exactly, and every slot's matched P2P power
    netting to zero (atol 1e-4 of its scale)."""
    import numpy as np
    import torch

    from p2pmicrogrid_tpu_torch import regimes as rg
    from p2pmicrogrid_tpu_torch.envs.community import EpisodeArrays, init_physical, ratings_to
    from p2pmicrogrid_tpu_torch.parallel import scenarios as sc
    from p2pmicrogrid_tpu_torch.parallel.device_gen import device_episode_arrays

    S, A = cfg.sim.n_scenarios, cfg.sim.n_agents
    rd = ratings_to(ratings, "cuda")
    fn = rg.make_regime_episode_fn(
        cfg, policy, ratings, portfolio.scenario_params,
        arrays_fn=lambda d: device_episode_arrays(cfg, rd, S, draws=d), n_scenarios=S,
        collect_regime_metrics=True, one_hot=portfolio.one_hot, device="cuda",
    )
    gen = torch.Generator(device="cuda").manual_seed(11)
    scen = sc.init_scen_state_only(cfg, "cuda", generator=gen)
    _, (rewards, _, rc) = fn((copy_state(cfg, pol, "cuda"), scen), gen)
    want = (rewards @ portfolio.one_hot).cpu().numpy()
    got = rc.reward.cpu().numpy()
    rel = float(np.max(np.abs(got - want) / np.abs(want)))
    if rel > 1e-4:
        fail(f"phase 11: counters' rewards {got} against the episode's {want} (rel {rel} > 1e-4)")
    rp = portfolio.scenario_params
    arrays = rg.apply_weather_regimes(device_episode_arrays(cfg, rd, S, generator=gen, device="cuda"), rp)
    xs = EpisodeArrays(*(x.transpose(0, 1) for x in arrays))
    phys = init_physical(cfg, torch.randn((S, 2, A), generator=gen, device="cuda"), (S,), device="cuda")
    ev = rg.init_ev_need(rp, A)
    island = torch.nonzero(rp.outage_end_slot > rp.outage_start_slot)[:, 0]
    worst, islanded_grid, islanded_slots = 0.0, 0.0, 0
    with torch.no_grad():
        for t in range(96):
            phys, _, out, _, _, ev, _ = rg.regime_slot_batched(
                cfg, policy, pol, phys, ev, tuple(x[t] for x in xs), None, rd, rp, explore=False)
            net = out.p_p2p.sum(dim=-1).abs() / (out.p_p2p.abs().sum(dim=-1) + 1.0)
            worst = max(worst, float(net.max()))
            inside = (t >= rp.outage_start_slot[island]) & (t < rp.outage_end_slot[island])
            if bool(inside.any()):
                islanded_slots += int(inside.sum())
                islanded_grid = max(islanded_grid, float(out.p_grid[island[inside]].abs().max()))
    if islanded_grid != 0.0 or islanded_slots == 0:
        fail(f"phase 11: grid exchange {islanded_grid} in {islanded_slots} islanded scenario-slots")
    if worst > 1e-4:
        fail(f"phase 11: matched P2P power does not net to zero: {worst} > 1e-4 of its scale")
    rec = dict(counters_vs_rewards_max_rel_err=rel, counters=rg.rc_to_dicts(rc, list(portfolio.names)),
               islanded_scenario_slots=islanded_slots, islanded_max_abs_grid_w=islanded_grid,
               p2p_net_max_share=worst)
    log(f"phase 11: (c) {json.dumps(rec)}")
    return rec


def regime_small_parity(tc):
    """(d) A=6, S=8 over 4 regimes, one episode on the card and on the CPU
    from the same CPU draws and state, tabular and shared DDPG: rewards
    rtol 2e-4 (the card's factored clearing against the CPU's matrix
    path)."""
    import numpy as np
    import torch

    from p2pmicrogrid_tpu_torch import regimes as rg
    from p2pmicrogrid_tpu_torch.convert import state_from_jax, state_to_numpy
    from p2pmicrogrid_tpu_torch.envs.community import make_ratings
    from p2pmicrogrid_tpu_torch.parallel import scenarios as sc
    from p2pmicrogrid_tpu_torch.train import make_policy

    names = ["winter", "ev_evening", "islanding_noon", "uniform_price"]
    rec = {}
    for impl in ("tabular", "ddpg"):
        cfg = chunked_config(tc, impl, 6, 8, buffer_size=16, batch_size=4)
        ratings = make_ratings(cfg, np.random.default_rng(42))
        policy = make_policy(cfg)
        arrays = sc.stack_scenario_arrays(cfg, sc.make_scenario_traces(cfg, seed=0), ratings, "cpu")
        pol, scen = sc.init_shared_state(cfg, "cpu", generator=torch.Generator().manual_seed(0))
        pol_np = state_to_numpy(pol)
        scen_np = None if scen is None else state_to_numpy(scen)
        sub = {"ddpg": cfg.ddpg}.get(impl)
        out, draws = {}, None
        for dev in ("cpu", "cuda"):
            arr = type(arrays)(*(x.to(dev) for x in arrays))
            rp = rg.build_portfolio(names, 8, device=dev).scenario_params
            fn = rg.make_regime_episode_fn(cfg, policy, ratings, rp, arrays_s=arr)
            if draws is None:
                draws = fn.draw(torch.Generator().manual_seed(1))
            carry = (state_from_jax(pol_np, device=dev, cfg=sub),
                     None if scen_np is None else state_from_jax(scen_np, device=dev))
            _, (r, _) = fn(carry, draws=sc._map_tensors(lambda x: x.to(dev), draws))
            out[dev] = r.cpu().numpy()
        rel = float(np.max(np.abs(out["cuda"] - out["cpu"]) / np.abs(out["cpu"])))
        if rel > 2e-4:
            fail(f"phase 11: A=6 S=8 {impl} regime rewards card {out['cuda']} against CPU {out['cpu']}: {rel}")
        rec[impl] = {"max_rel_err": rel, "rewards_card": out["cuda"].tolist()}
    log(f"phase 11: (d) {json.dumps(rec)}")
    return rec


def regime_evaluation(cfg, policy, pol, ratings):
    """(e) ``evaluate_regimes`` of the trained northstar learner over the
    training and the held-out portfolios, 4 evaluation scenarios a regime,
    its ``regime_eval`` events counted."""
    from p2pmicrogrid_tpu_torch import regimes as rg
    from p2pmicrogrid_tpu_torch.telemetry.registry import MemorySink, Telemetry

    sink = MemorySink()
    tel = Telemetry(sinks=[sink])
    rec = {}
    for label, names, held in (("train", REGIME_TRAIN, False), ("held_out", REGIME_HELD_OUT, True)):
        start = time.perf_counter()
        rows = rg.evaluate_regimes(cfg, policy, pol, ratings, list(names), s_per_regime=REGIME_EVAL_S,
                                   telemetry=tel, held_out=held, device="cuda")
        rec[label] = {"seconds": time.perf_counter() - start, "rows": rows}
    tel.close()
    events = sum(r.get("kind") == "regime_eval" for r in sink.records)
    if events != len(REGIME_TRAIN) + len(REGIME_HELD_OUT):
        fail(f"phase 11: {events} regime_eval events, expected {len(REGIME_TRAIN) + len(REGIME_HELD_OUT)}")
    rec["regime_eval_events"] = events
    log(f"phase 11: (e) {json.dumps(rec)}")
    return rec


def phase_regimes(counters, card):
    """Phase 11: the regime engine on the card. Returns (record, K1's
    launches on (b)'s main path)."""
    import torch

    from p2pmicrogrid_tpu_torch import config as tc

    torch.backends.cuda.matmul.allow_tf32 = False
    start = time.perf_counter()
    out = {"baseline_vs_plain": regime_baseline_vs_plain(counters, tc)}
    out["northstar"], pol, cfg, policy, ratings, held_pf, k1 = regime_northstar(counters, tc, card)
    out["counters_and_physics"] = regime_counters_and_physics(cfg, policy, pol, ratings, held_pf)
    out["card_vs_cpu"] = regime_small_parity(tc)
    out["evaluation"] = regime_evaluation(cfg, policy, pol, ratings)
    out["seconds"] = time.perf_counter() - start
    return out, k1


# --- phase 12 ---------------------------------------------------------------

# The command line on the card (cli.py). The README's north-star command
# with its depth cut from 80 chunks an episode to 8 (the width stays: 1000
# agents, 128 scenarios a chunk), the DDPG defaults of the command line
# (buffer 10,000, batch 128, learn cap 32,768), two episodes, an eval after
# each.
CLI_NORTHSTAR = dict(A=1000, S=128, K=8, episodes=2)
CLI_GATEWAY_REQUESTS = 32


def cli_argv(*args):
    return [str(a) for a in args]


def run_cli(what, argv, counters=None):
    """``cli.main(argv)`` in this process: (stdout, seconds, launches); a
    non-zero return or exit is fatal. The counts are set to 0 first."""
    import contextlib
    import io

    from p2pmicrogrid_tpu_torch import cli

    if counters is not None:
        reset(counters)
    buf = io.StringIO()
    start = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
    except SystemExit as exc:
        fail(f"phase 12: {what}: exited {exc.code!r}; output: {buf.getvalue()[-2000:]}")
    secs = time.perf_counter() - start
    out = buf.getvalue()
    if rc != 0:
        fail(f"phase 12: {what}: returned {rc}; output: {out[-2000:]}")
    for line in out.splitlines()[-3:]:
        log(f"phase 12: {what} | {line[:300]}")
    launches = None if counters is None else {n: fn.launches for n, fn in counters.items()}
    return out, secs, launches


def run_module(what, args, timeout=600):
    """``python -m p2pmicrogrid_tpu_torch args`` from this checkout; its
    stdout, fatal on a non-zero exit."""
    env = dict(os.environ, PYTHONPATH=HERE + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-m", "p2pmicrogrid_tpu_torch", *args], capture_output=True, text=True,
        env=env, timeout=timeout,
    )
    if proc.returncode != 0:
        fail(f"phase 12: {what}: exit {proc.returncode}: {proc.stderr[-2000:]}")
    return proc.stdout


def nonzero(launches):
    return {n: v for n, v in launches.items() if v}


class SqliteClock:
    """Seconds spent in the results store's writes while installed: the
    telemetry sink's batch flushes, run rows, spans and close, and the
    store's progress and health rows."""

    def __init__(self):
        from p2pmicrogrid_tpu_torch.data.results import ResultsStore
        from p2pmicrogrid_tpu_torch.telemetry.registry import SqliteSink

        self.seconds, self.calls = 0.0, 0
        self.targets = [
            (SqliteSink, name) for name in ("_flush_locked", "_write_run_row", "write_spans", "close")
        ] + [(ResultsStore, name) for name in ("__init__", "log_training_progress", "log_training_health")]
        self.saved = []

    def __enter__(self):
        for cls, name in self.targets:
            orig = getattr(cls, name)

            def timed(*a, _orig=orig, **kw):
                t0 = time.perf_counter()
                try:
                    return _orig(*a, **kw)
                finally:
                    self.seconds += time.perf_counter() - t0
                    self.calls += 1

            self.saved.append((cls, name, orig))
            setattr(cls, name, timed)
        return self

    def __exit__(self, *exc):
        for cls, name, orig in self.saved:
            setattr(cls, name, orig)


def cli_northstar(counters, tmp):
    """(a) The north star through ``cli.main`` and through
    ``train_chunked_with_health`` with the same config, seed and device
    (the library, then the command; two more runs in turns until phase 14
    needed the time): K1's launches against
    (E*K + captures + E + 1) * 96 in every run, rewards, losses, health
    points and the final parameters equal bit for bit, wall and training
    seconds of each."""
    import numpy as np
    import torch

    from p2pmicrogrid_tpu_torch import config as tc
    from p2pmicrogrid_tpu_torch.envs.community import make_ratings
    from p2pmicrogrid_tpu_torch.parallel import scenarios as sc
    from p2pmicrogrid_tpu_torch.telemetry import config_hash
    from p2pmicrogrid_tpu_torch.train import health as th
    from p2pmicrogrid_tpu_torch.train import make_policy
    from p2pmicrogrid_tpu_torch.train.checkpoint import (
        _np_state, checkpoint_dir, latest_checkpoint, load_manifest, tree_digest,
    )

    A, S, K, E = CLI_NORTHSTAR["A"], CLI_NORTHSTAR["S"], CLI_NORTHSTAR["K"], CLI_NORTHSTAR["episodes"]
    T = 96
    what = f"north star A={A} S={S} K={K} E={E}"
    db, models = os.path.join(tmp, "results.db"), os.path.join(tmp, "models")
    flags = cli_argv("--agents", A, "--scenarios", S, "--shared", "--share-agents", "--chunks", K,
                     "--implementation", "ddpg", "--episodes", E, "--seed", 0, "--model-dir", models)
    cfg = tc.default_config(
        sim=tc.SimConfig(n_agents=A, n_scenarios=S),
        ddpg=tc.DDPGConfig(share_across_agents=True),
        train=tc.TrainConfig(max_episodes=E, implementation="ddpg", seed=0),
    )
    ckpt = checkpoint_dir(models, f"{cfg.setting}-x{S}-shared-k{K}", "ddpg")

    def command():
        # The command's own call of the library, observed: its returns.
        seen, real = {}, th.train_chunked_with_health

        def observed(*a, **kw):
            seen["kw"] = {k: v for k, v in kw.items() if k not in ("episode_cb", "health_cb", "carry_sync")}
            seen["out"] = real(*a, **kw)
            return seen["out"]

        th.train_chunked_with_health = observed
        try:
            with SqliteClock() as clock:
                _, wall, launches = run_cli(
                    "north star", ["train", *flags, "--health-every", "1", "--results-db", db], counters
                )
        finally:
            th.train_chunked_with_health = real
        if seen["kw"].get("device") != "cuda" or seen["kw"].get("results_db") != db:
            fail(f"phase 12: {what}: the command called the trainer with {seen['kw']}")
        _, rew, loss, secs, monitor = seen["out"]
        step = latest_checkpoint(ckpt)
        manifest = load_manifest(step) if step else None
        if manifest is None or manifest["config_hash"] != config_hash(cfg) or manifest["episode"] != E - 1:
            fail(f"phase 12: {what}: final checkpoint under {ckpt}: {manifest}")
        return dict(wall=wall, train=secs, launches=launches, rewards=rew, losses=loss, monitor=monitor,
                    digest=manifest["digest"], sqlite_s=clock.seconds, sqlite_calls=clock.calls)

    def library(i):
        reset(counters)
        start = time.perf_counter()
        ratings = make_ratings(cfg, np.random.default_rng(0))
        policy = make_policy(cfg)
        pol = sc.init_shared_pol_state(cfg, "cuda", torch.Generator(device="cuda").manual_seed(0))
        pol, rew, loss, secs, monitor = th.train_chunked_with_health(
            cfg, policy, pol, ratings, 0, E, K, eval_every=1, mitigate="lr-boost",
            results_db=os.path.join(tmp, f"library{i}.db"), device="cuda",
        )
        digest, _ = tree_digest({"pol_state": _np_state(pol), "episode": np.asarray(E - 1)})
        wall = time.perf_counter() - start
        return dict(wall=wall, train=secs, launches={n: fn.launches for n, fn in counters.items()},
                    rewards=rew, losses=loss, monitor=monitor, digest=digest)

    runs = []
    for i, kind in enumerate(("library", "command")):
        gc_collect()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        run = library(i) if kind == "library" else command()
        run["peak_gib"] = (torch.cuda.max_memory_allocated() - base) / 2**30
        gc_collect()
        run["kind"] = kind
        captures = 1 + int(any(e < E for e in run["monitor"].basin_entries))
        expect = {n: ((E * K + captures + E + 1) * T if n == "merged_min_sums" else 0) for n in counters}
        if run["launches"] != expect:
            fail(f"phase 12: {what}: {kind} launched {run['launches']}, expected {expect}")
        ref = runs[0] if runs else run
        if not (np.array_equal(run["rewards"], ref["rewards"]) and np.array_equal(run["losses"], ref["losses"])):
            fail(f"phase 12: {what}: the {kind}'s rewards or losses differ from the library's "
                 f"(max {np.abs(run['rewards'] - ref['rewards']).max():.3e})")
        if run["digest"] != ref["digest"]:
            fail(f"phase 12: {what}: the {kind}'s final parameters' digest {run['digest']} differs "
                 f"from the library's {ref['digest']}")
        if [p._asdict() for p in run["monitor"].points] != [p._asdict() for p in ref["monitor"].points]:
            fail(f"phase 12: {what}: the {kind}'s health points differ from the library's")
        log(f"phase 12: {what}: {kind} {run['wall']:.2f} s wall, {run['train']:.2f} s training "
            f"({E * K * S * T / run['train']:.1f} env-steps/s), K1 {run['launches']['merged_min_sums']}, "
            f"peak {run['peak_gib']:.2f} GiB")
        runs.append(run)
    steps = E * K * S * T
    by = lambda kind, key: [r[key] for r in runs if r["kind"] == kind]
    cli_wall, lib_wall = statistics.mean(by("command", "wall")), statistics.mean(by("library", "wall"))
    cli_train, lib_train = statistics.mean(by("command", "train")), statistics.mean(by("library", "train"))
    row = dict(
        command="train " + " ".join(flags[:-2]) + " --health-every 1 --results-db DB --model-dir M",
        order=[r["kind"] for r in runs], wall_s=[r["wall"] for r in runs], train_s=[r["train"] for r in runs],
        peak_gib=[r["peak_gib"] for r in runs],
        cli_wall_s=cli_wall, library_wall_s=lib_wall, wall_ratio=cli_wall / lib_wall,
        cli_env_steps_per_s=steps / cli_train, library_env_steps_per_s=steps / lib_train,
        train_ratio=cli_train / lib_train, sqlite_write_s=by("command", "sqlite_s"),
        sqlite_write_calls=by("command", "sqlite_calls"),
        k1_launches=runs[1]["launches"]["merged_min_sums"],
        basin_entries=list(runs[1]["monitor"].basin_entries), rewards_equal=True, parameters_equal=True,
        digest=runs[1]["digest"], greedy_costs=[p.greedy_cost_eur for p in runs[1]["monitor"].points],
    )
    log(f"phase 12: {what}: the command {cli_wall:.2f} s wall ({steps / cli_train:.1f} env-steps/s), "
        f"the library {lib_wall:.2f} s ({steps / lib_train:.1f}), ratio {cli_wall / lib_wall:.4f}; SQLite "
        f"writes {row['sqlite_write_s']} s; rewards, losses, health points and parameters equal bit for bit")
    launches = {n: sum(r["launches"][n] for r in runs if r["kind"] == "command") for n in counters}
    return row, launches, flags, db


def cli_eval_and_query(counters, flags, db):
    """(b) ``eval --test`` on the north star's checkpoint: a test_results row
    for every agent and slot of each test day and one eval_runs row; then
    ``telemetry-query --gauges`` as a subprocess joins the training run to
    it on config_hash."""
    import sqlite3

    what = "north star eval --test"
    out, secs, launches = run_cli(what, ["eval", *flags, "--test", "--results-db", db], counters)
    A = CLI_NORTHSTAR["A"]
    con = sqlite3.connect(db)
    try:
        days = con.execute("SELECT day, COUNT(*) FROM test_results GROUP BY day ORDER BY day").fetchall()
        runs = con.execute("SELECT setting, config_hash, n_days, total_cost_eur FROM eval_runs").fetchall()
    finally:
        con.close()
    if [d for d, _ in days] != [8, 9, 10, 19, 20] or any(n != 96 * A for _, n in days):
        fail(f"phase 12: {what}: test_results rows by day {days}")
    if len(runs) != 1 or runs[0][2] != 5:
        fail(f"phase 12: {what}: eval_runs {runs}")
    t0 = time.perf_counter()
    query = run_module("telemetry-query", ["telemetry-query", "--results-db", db, "--gauges"])
    query_s = time.perf_counter() - t0
    rows = [json.loads(line) for line in query.splitlines() if line.startswith("{")]
    joined = [r for r in rows if r["run_id"].startswith("train-chunked") and r["config_hash"] == runs[0][1]]
    if not joined or not joined[0].get("gauges"):
        fail(f"phase 12: telemetry-query joined no training run to the eval: {rows}")
    log(f"phase 12: {what}: {sum(n for _, n in days)} test_results rows over 5 days in {secs:.2f} s, "
        f"launches {nonzero(launches)}; telemetry-query joined {joined[0]['run_id']} to "
        f"{joined[0]['eval_setting']} on {runs[0][1]} ({len(joined[0]['gauges'])} gauges)")
    return dict(eval_s=secs, eval_launches=nonzero(launches), test_rows=sum(n for _, n in days),
                eval_cost_eur=runs[0][3], query_s=query_s, joined_run=joined[0]["run_id"],
                config_hash=runs[0][1], n_gauges=len(joined[0]["gauges"]))


def cli_gateway(counters, flags, db, tmp):
    """(c) ``export-bundle`` of the north star's checkpoint, then
    ``serve-gateway`` as a subprocess answering 32 POSTs to ``/v1/act``
    into the same warehouse: 32 ``serve_request`` points under the bundle's
    config_hash, and the listening line names the card."""
    import sqlite3
    import threading
    import urllib.request

    import numpy as np
    import torch

    bundle = os.path.join(tmp, "bundle")
    out, export_s, launches = run_cli("export-bundle", ["export-bundle", *flags, "--out", bundle], counters)
    if nonzero(launches):
        fail(f"phase 12: export-bundle launched {launches}")
    with open(os.path.join(bundle, "manifest.json")) as f:
        bundle_hash = json.load(f)["config_hash"]
    env = dict(os.environ, PYTHONPATH=HERE + os.pathsep + os.environ.get("PYTHONPATH", ""))
    err_path = os.path.join(tmp, "gateway.err")

    def stderr_tail():
        with open(err_path) as f:
            return f.read()[-2000:]

    start = time.perf_counter()
    with open(err_path, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "p2pmicrogrid_tpu_torch", "serve-gateway", "--bundle", bundle,
             "--port", "0", "--results-db", db, "--serve-seconds", "8"],
            stdout=subprocess.PIPE, stderr=err, text=True, env=env,
        )
    try:
        line = proc.stdout.readline()
        ready_s = time.perf_counter() - start
        try:
            listening = json.loads(line)
        except ValueError:
            fail(f"phase 12: serve-gateway printed {line!r}; stderr {stderr_tail()}")
        if listening.get("device") != torch.cuda.get_device_name(0) or listening.get("default") != bundle_hash:
            fail(f"phase 12: the gateway's listening line {listening}")
        A = CLI_NORTHSTAR["A"]
        obs = np.random.default_rng(0).uniform(-1, 1, (CLI_GATEWAY_REQUESTS, A, 4)).astype(np.float32)
        answers, errors = [None] * CLI_GATEWAY_REQUESTS, []

        def post(i):
            try:
                req = urllib.request.Request(
                    f"http://{listening['host']}:{listening['port']}/v1/act",
                    data=json.dumps({"household": f"h{i}", "obs": obs[i].tolist()}).encode(),
                    method="POST",
                )
                with urllib.request.urlopen(req, timeout=60) as resp:
                    answers[i] = json.loads(resp.read())
            except Exception as exc:  # noqa: BLE001 — reported below
                errors.append(f"{i}: {exc}")

        t0 = time.perf_counter()
        threads = [threading.Thread(target=lambda k=k: [post(i) for i in range(k, CLI_GATEWAY_REQUESTS, 8)])
                   for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        serve_s = time.perf_counter() - t0
        if errors or any(a is None or len(a["actions"]) != A or a["config_hash"] != bundle_hash for a in answers):
            fail(f"phase 12: gateway requests failed: {errors[:4]}")
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if rc != 0:
        fail(f"phase 12: serve-gateway exited {rc}: {stderr_tail()}")
    con = sqlite3.connect(db)
    try:
        (n,) = con.execute(
            "SELECT COUNT(*) FROM telemetry_points p JOIN telemetry_runs r USING (run_id) "
            "WHERE p.kind = 'serve_request' AND r.config_hash = ?", (bundle_hash,),
        ).fetchone()
    finally:
        con.close()
    if n != CLI_GATEWAY_REQUESTS:
        fail(f"phase 12: the warehouse holds {n} serve_request records for {bundle_hash}, "
             f"expected {CLI_GATEWAY_REQUESTS}")
    actions = np.array([a["actions"] for a in answers], np.float32)
    if not np.isfinite(actions).all() or actions.min() < 0 or actions.max() > 1:
        fail("phase 12: gateway actions outside [0, 1]")
    log(f"phase 12: export-bundle {export_s:.2f} s; serve-gateway on {listening['device']} ready after "
        f"{ready_s:.1f} s, {CLI_GATEWAY_REQUESTS} requests of A={A} in {serve_s:.2f} s, "
        f"{n} serve_request records under {bundle_hash}")
    return dict(export_s=export_s, gateway_ready_s=ready_s, requests=CLI_GATEWAY_REQUESTS,
                requests_s=serve_s, serve_request_records=n, bundle_config_hash=bundle_hash,
                listening_device=listening["device"])


def cli_small_commands(counters, tmp):
    """(d) The smaller commands through ``cli.main``, each one's launches
    against the library path's for the same configuration (its calls made
    directly, in the same order)."""
    import numpy as np
    import torch

    from p2pmicrogrid_tpu_torch import cli
    from p2pmicrogrid_tpu_torch.data import synthetic_traces, train_validation_test_split
    from p2pmicrogrid_tpu_torch.envs import (
        build_episode_arrays, make_ratings, rule_baseline_episode,
    )
    from p2pmicrogrid_tpu_torch.envs.multi_community import (
        evaluate_multi_community, train_multi_community,
    )
    from p2pmicrogrid_tpu_torch.parallel import scenarios as sc
    from p2pmicrogrid_tpu_torch.train import evaluate_community, init_policy_state, make_policy
    from p2pmicrogrid_tpu_torch.train import health as th
    from p2pmicrogrid_tpu_torch.train import train_community

    models, db = os.path.join(tmp, "small-models"), os.path.join(tmp, "small.db")
    gen = lambda seed=42: torch.Generator(device="cuda").manual_seed(seed)
    splits = train_validation_test_split(synthetic_traces(seed=42))

    def cfg_of(argv):
        parser = capture_parser(cli.main)
        args = parser.parse_args(argv)
        return args, cli._build_cfg(args)

    def library(run):
        reset(counters)
        run()
        return {n: fn.launches for n, fn in counters.items()}

    rows = []

    def check(what, argv, run_library, expected):
        out, secs, got = run_cli(what, argv, counters)
        want = library(run_library)
        if got != want:
            fail(f"phase 12: {what}: the command launched {nonzero(got)}, the library {nonzero(want)}")
        note = "" if nonzero(got) == expected else f" (PERF.md §6 leads one to expect {expected})"
        log(f"phase 12: {what}: launches {nonzero(got)} = the library's{note}; {secs:.2f} s")
        rows.append(dict(command=" ".join(argv[:1] + [a for a in argv[1:] if not a.startswith("/")]),
                         seconds=secs, launches=nonzero(got), expected=expected, as_expected=not note))
        return out

    T = 96
    base = cli_argv("--agents", 2, "--episodes", 2, "--model-dir", models, "--results-db", db)
    _, cfg = cfg_of(["train", *base])

    def lib_train():
        ratings = make_ratings(cfg, np.random.default_rng(42))
        g = gen()
        train_community(cfg, make_policy(cfg), init_policy_state(cfg, "cuda", g), splits[0], ratings, g,
                        device="cuda")

    # A single-community episode runs the whole training split, 7 days.
    T_train = splits[0].time.shape[0]
    check("train A=2", ["train", *base], lib_train,
          {"divide_rank1_fused": 2 * T_train, "clear_market_fused": 2 * T_train})

    def lib_eval():
        rng = np.random.default_rng(42)
        ratings = make_ratings(cfg, rng)
        g = gen()
        evaluate_community(cfg, make_policy(cfg), init_policy_state(cfg, "cuda", g), splits[2], ratings, g,
                           rng=rng, device="cuda")

    check("eval --test A=2", ["eval", "--test", *base], lib_eval,
          {"divide_rank1_fused": T, "clear_market_fused": T})

    def lib_baseline():
        ratings = make_ratings(cfg, np.random.default_rng(42))
        for _, day in sorted(splits[2].split_by_day().items()):
            rule_baseline_episode(cfg, cli._initial_physical(cfg, "cuda"),
                                  build_episode_arrays(cfg, day, ratings, "cuda"))

    check("baseline --test A=2", ["baseline", "--test", *base], lib_baseline, {})

    argv = ["train", *cli_argv("--agents", 8, "--scenarios", 4, "--shared", "--rounds", 2,
                               "--implementation", "dqn", "--episodes", 1, "--model-dir", models)]
    _, cfg_q = cfg_of(argv)

    def lib_dqn():
        ratings = make_ratings(cfg_q, np.random.default_rng(42))
        g = gen()
        policy = make_policy(cfg_q)
        arrays = sc.stack_scenario_arrays(cfg_q, sc.make_scenario_traces(cfg_q, seed=42), ratings, "cuda")
        pol, scen = sc.init_shared_state(cfg_q, "cuda", g)
        pol, scen = sc.warmup_shared_dqn(cfg_q, policy, pol, scen, arrays, ratings, g)
        greedy = th.make_greedy_eval(cfg_q, policy, ratings, device="cuda")
        th.untrained_reference_cost(cfg_q, policy, greedy, seed=42)
        sc.train_scenarios_shared(cfg_q, policy, pol, arrays, ratings, g, 1, replay_s=scen,
                                  episode_cb=lambda ep, r, l, c: greedy(c[0]))

    passes = cfg_q.dqn.warmup_passes + 1 + 2  # warmup, the episode, two greedy evals
    check("train dqn rounds=2 A=8 S=4", argv, lib_dqn,
          {k: passes * T for k in ("divide_rank1_fused", "divide_power_fused_with_mean", "clear_market_fused")})

    multi = cli_argv("--communities", 8, "--agents", 128, "--episodes", 1, "--model-dir", models,
                     "--results-db", db)
    _, cfg_m = cfg_of(["multi", *multi])
    cfg_m = cfg_m.replace(sim=dataclasses.replace(cfg_m.sim, n_scenarios=8))

    def lib_multi():
        ratings = make_ratings(cfg_m, np.random.default_rng(42))
        g = gen()
        arrays = sc.stack_scenario_arrays(cfg_m, sc.make_scenario_traces(cfg_m, n_scenarios=8, seed=42),
                                          ratings, "cuda")
        pol, scen = sc.init_shared_state(cfg_m, "cuda", g)
        train_multi_community(cfg_m, make_policy(cfg_m), pol, arrays, ratings, g, 1, replay_s=scen,
                              episode_cb=lambda *a: None)

    check("multi C=8 A=128", ["multi", *multi], lib_multi, {"merged_min_sums": T})

    def lib_multi_eval():
        rng = np.random.default_rng(42)
        ratings = make_ratings(cfg_m, rng)
        g = gen()
        evaluate_multi_community(cfg_m, make_policy(cfg_m), init_policy_state(cfg_m, "cuda", g), splits[2],
                                 ratings, g, rng=rng, device="cuda")

    check("eval --communities 8 A=128 --test", ["eval", "--test", *multi], lib_multi_eval,
          {"merged_min_sums": T})
    return rows


def capture_parser(main):
    """The command line's parser, built by ``main`` and caught at its
    ``parse_args``."""
    import argparse

    box = []
    orig = argparse.ArgumentParser.parse_args

    class Captured(Exception):
        pass

    def capture(self, args=None, namespace=None):
        box.append(self)
        raise Captured

    argparse.ArgumentParser.parse_args = capture
    try:
        main([])
    except Captured:
        pass
    finally:
        argparse.ArgumentParser.parse_args = orig
    return box[0]


def cli_supervised(tmp):
    """(d) ``train --supervise`` with a one-kill fault plan at A=2: the
    child, ``python -m p2pmicrogrid_tpu_torch``, is SIGKILLed at episode 2,
    restarted with ``--resume`` and finishes."""
    from p2pmicrogrid_tpu_torch.train import resilience
    from p2pmicrogrid_tpu_torch.train.faults import TrainFaultEvent, TrainFaultPlan

    plan = os.path.join(tmp, "plan.json")
    with open(plan, "w") as f:
        f.write(TrainFaultPlan(seed=0, events=(TrainFaultEvent(kind="kill", episode=2, attempt=0),)).to_json())
    children, real = [], resilience.supervise

    def observed(child_argv, **kw):
        children.append(list(child_argv))
        return real(child_argv, **kw)

    resilience.supervise = observed
    saved_path = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = HERE + os.pathsep + (saved_path or "")
    try:
        out, secs, _ = run_cli("train --supervise", cli_argv(
            "train", "--agents", 2, "--episodes", 4, "--save-episodes", 1, "--supervise", "--fault-plan",
            plan, "--model-dir", os.path.join(tmp, "supervised")))
    finally:
        resilience.supervise = real
        if saved_path is None:
            os.environ.pop("PYTHONPATH", None)
        else:
            os.environ["PYTHONPATH"] = saved_path
    rows = [json.loads(line) for line in out.splitlines() if line.startswith('{"metric"')]
    attempts = [r for r in rows if r["metric"] == "supervise_attempt"]
    head = rows[-1] if rows else {}
    if children[0][1:3] != ["-m", "p2pmicrogrid_tpu_torch"] or children[0][0] != sys.executable:
        fail(f"phase 12: the supervisor's child is {children[0][:4]}")
    if ([a["exit_code"] for a in attempts] != [-9, 0] or head.get("metric") != "train_supervised"
            or (head.get("kills"), head.get("resumes"), head.get("exit_code"), head.get("final_episode"))
            != (1, 1, 0, 3)):
        fail(f"phase 12: supervised run: attempts {attempts}, headline {head}")
    if "resumed" not in out or "at episode 1" not in out:
        fail("phase 12: the restarted child did not resume from episode 1")
    log(f"phase 12: train --supervise: child {' '.join(children[0][1:3])} killed at episode 2, restarted "
        f"with --resume, finished; {secs:.1f} s")
    return dict(child=children[0][1:3], attempts=[a["exit_code"] for a in attempts],
                attempt_s=[a["duration_s"] for a in attempts], seconds=secs)


def phase_cli(counters, card, after_northstar=None):
    """Phase 12: the command line on the card; ``after_northstar`` is
    called once the north-star commands are done."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    saved = {k: os.environ.get(k) for k in ("P2P_TELEMETRY_DIR", "P2P_TELEMETRY")}
    os.environ["P2P_TELEMETRY_DIR"] = os.path.join(tmp, "runs")
    os.environ.pop("P2P_TELEMETRY", None)
    totals = {name: 0 for name in counters}
    try:
        northstar, ns_launches, flags, db = cli_northstar(counters, tmp)
        if after_northstar is not None:
            after_northstar()
        evaluation = cli_eval_and_query(counters, flags, db)
        gateway = cli_gateway(counters, flags, db, tmp)
        small = cli_small_commands(counters, tmp)
        supervised = cli_supervised(tmp)
        # (e) --device cpu on the card's machine launches no kernel.
        _, cpu_s, cpu_launches = run_cli("train --device cpu", cli_argv(
            "train", "--agents", 2, "--episodes", 1, "--device", "cpu", "--model-dir",
            os.path.join(tmp, "cpu-models")), counters)
        if nonzero(cpu_launches):
            fail(f"phase 12: --device cpu launched {cpu_launches}")
        log(f"phase 12: train --device cpu: no kernel launched ({cpu_s:.2f} s)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    for launches in [ns_launches, evaluation["eval_launches"]] + [row["launches"] for row in small]:
        for name, n in launches.items():
            totals[name] += n
    reading = dict(card=card, northstar=northstar, eval=evaluation, gateway=gateway, small=small,
                   supervised=supervised, cpu_launches=nonzero(cpu_launches))
    return reading, totals



# --- phase 13 ---------------------------------------------------------------

# The continual flywheel at the northstar width: a gateway on the card
# serving an A=1000 shared-DDPG bundle to a few households, its decisions
# exported as transitions, a candidate fine-tuned from them (off-policy trace
# steps, then one guarded chunk episode of S=64 through the chunk graph),
# gated (held-out evaluations through K1 at [8,1000], the SLO bench on the
# card's engine) and ramped through a live canary.
FLY = dict(A=1000, S=64, households=8, requests=256, trace_steps=50, stages=(5.0, 25.0, 100.0),
           requests_per_stage=64, canary_households=64, max_batch=16)
# The small card-vs-CPU case: A=3, narrow learners, an 8-bin table.
FLY_SMALL_A = 3


def flywheel_small_config(tc, impl):
    return tc.default_config(
        sim=tc.SimConfig(n_agents=FLY_SMALL_A),
        train=tc.TrainConfig(implementation=impl, seed=0),
        qlearning=tc.QLearningConfig(num_time_states=8, num_temp_states=8, num_balance_states=8,
                                     num_p2p_states=8),
        dqn=tc.DQNConfig(hidden=8, buffer_size=16, batch_size=8),
        ddpg=tc.DDPGConfig(actor_hidden=8, critic_hidden=8, buffer_size=16, batch_size=8,
                           share_across_agents=True),
    )


def synced(fn):
    """(fn(), seconds) with the card synchronised before and after."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def flywheel_small_parity(tmp):
    """The card against the CPU at A=3: the trace rewards (rtol 1e-6), a
    5-step pretrain from one state and the same injected indices (tabular
    bit for bit, DQN and shared DDPG at rtol 1e-4, atol 1e-6: the CPU
    tests' tolerances), and the gate's decision matrix (crafted bundles,
    the modeled clocks) with the same verdicts and the same reasons, their
    numbers aside (the card clears through K1 at [8,3], the CPU through
    the matrix path: rtol 1e-4)."""
    import re

    import numpy as np
    import torch

    from p2pmicrogrid_tpu_torch import config as tc
    from p2pmicrogrid_tpu_torch.convert import state_from_jax, state_to_numpy
    from p2pmicrogrid_tpu_torch.data import trace_export as te
    from p2pmicrogrid_tpu_torch.parallel.scenarios import init_shared_pol_state
    from p2pmicrogrid_tpu_torch.serve import promotion as pr
    from p2pmicrogrid_tpu_torch.serve.loadgen import synthetic_obs
    from p2pmicrogrid_tpu_torch.train import continual as co

    A, n = FLY_SMALL_A, 32
    cfg = flywheel_small_config(tc, "tabular")
    obs = synthetic_obs(n, A, seed=3)
    act = np.random.default_rng(3).choice([0.0, 0.5, 1.0], (n, A)).astype(np.float32)
    for name in ("trace_reward", "decision_cost", "_energy_settlement_eur"):
        got = getattr(te, name)(cfg, obs, act, device="cuda")
        ref = getattr(te, name)(cfg, obs, act, device="cpu")
        if not np.allclose(got, ref, rtol=1e-6, atol=0):
            fail(f"phase 13: {name} card vs CPU: max abs err {np.abs(got - ref).max()}")
    rng = np.random.default_rng(0)
    ds = te.TraceDataset(obs=obs, action=act, reward=rng.normal(size=(n, A)).astype(np.float32),
                         next_obs=np.roll(obs, -1, axis=0))
    pretrain = {}
    for impl in ("tabular", "dqn", "ddpg"):
        cfg = flywheel_small_config(tc, impl)
        st = state_to_numpy(init_shared_pol_state(cfg, "cpu", torch.Generator().manual_seed(0)))
        if impl == "tabular":
            st = st._replace(q_table=rng.standard_normal(st.q_table.shape).astype(np.float32))
        sub = {"dqn": cfg.dqn, "ddpg": cfg.ddpg}.get(impl)
        b = co.trace_batch_size(cfg, n)
        idx = torch.randint(0, n, (5, b), generator=torch.Generator().manual_seed(1))
        out = {}
        for dev in ("cuda", "cpu"):
            s, losses = co.offpolicy_pretrain(cfg, state_from_jax(st, dev, cfg=sub), ds, None, 5,
                                              indices=idx, device=dev)
            out[dev] = (state_to_numpy(s), losses)
        (g, gl), (r, rl) = out["cuda"], out["cpu"]
        if impl == "tabular":
            if not np.array_equal(g.q_table, r.q_table):
                fail("phase 13: tabular pretrain card vs CPU not bit for bit")
            err = 0.0
        else:
            names = ("online", "target") if impl == "dqn" else ("actor", "critic", "actor_target",
                                                                 "critic_target")
            err = 0.0
            for name in names:
                for x, y in zip(_leaves(getattr(g, name)), _leaves(getattr(r, name))):
                    if not np.allclose(x, y, rtol=1e-4, atol=1e-6):
                        fail(f"phase 13: {impl} pretrain {name} card vs CPU: {np.abs(x - y).max()}")
                    err = max(err, float(np.abs(x - y).max()))
            if not np.allclose(gl, rl, rtol=1e-4):
                fail(f"phase 13: {impl} pretrain losses card {gl} vs CPU {rl}")
        pretrain[impl] = err
        log(f"phase 13: pretrain {impl} A={A} card vs CPU: max abs err {err:.3e}")
    cfg = flywheel_small_config(tc, "tabular")
    base = cfg.train.starting_episodes
    bump = lambda k: cfg.replace(train=dataclasses.replace(cfg.train, starting_episodes=base + k))  # noqa: E731
    dirs = {}
    for dev in ("cuda", "cpu"):
        root = os.path.join(tmp, f"crafted-{dev}")
        dirs[dev] = {
            "incumbent": pr.make_crafted_bundle(cfg, "incumbent", f"{root}/inc", device=dev),
            "good": pr.make_crafted_bundle(bump(101), "good", f"{root}/good", device=dev),
            "cost_regressed": pr.make_crafted_bundle(bump(102), "cost_regressed", f"{root}/bad", device=dev),
            "tie": pr.make_crafted_bundle(bump(200), "incumbent", f"{root}/tie", device=dev),
        }
    fast, slow = (lambda i, j: 0.0005), (lambda i, j: 0.25)
    mask = lambda reasons: [re.sub(r"-?\d+\.\d+", "#", r) for r in reasons]  # noqa: E731
    verdicts = []
    for cand, clock, want in (("good", fast, True), ("good", slow, False), ("cost_regressed", fast, False),
                              ("tie", fast, False)):
        got = {}
        for dev in ("cuda", "cpu"):
            got[dev] = pr.run_promotion_gate(cfg, dirs[dev][cand], dirs[dev]["incumbent"],
                                             service_time_fn=clock, bench_requests=64, max_batch=8,
                                             device=dev)
        g, r = got["cuda"], got["cpu"]
        if not (g.passed is r.passed is want) or mask(g.reasons) != mask(r.reasons):
            fail(f"phase 13: gate {cand} card {g.passed} {g.reasons} vs CPU {r.passed} {r.reasons}")
        if not np.isclose(g.candidate_cost, r.candidate_cost, rtol=1e-4):
            fail(f"phase 13: gate {cand} eval cost card {g.candidate_cost} vs CPU {r.candidate_cost}")
        verdicts.append(dict(candidate=cand, passed=g.passed, reasons=mask(g.reasons),
                             cost_card=g.candidate_cost, cost_cpu=r.candidate_cost))
    log(f"phase 13: A={A} gate verdicts card == CPU: {[(v['candidate'], v['passed']) for v in verdicts]}")
    return dict(pretrain_max_abs_err=pretrain, gate=verdicts)


def _leaves(tree):
    import numpy as np

    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, tuple):
        return [x for t in tree for x in _leaves(t)]
    return [np.asarray(tree)]


def flywheel_serve(cfg, bundle, db, obs, households):
    """The gateway on the card over ``bundle`` with ``db`` as its results
    store, every observation sent by one of ``households``; returns the
    seconds and the requests' latencies."""
    import numpy as np

    from p2pmicrogrid_tpu_torch.serve.gateway import AdmissionConfig, GatewayServer, build_gateway
    from p2pmicrogrid_tpu_torch.serve.promotion import _drive_wire_stage

    gateway = build_gateway([bundle], max_batch=FLY["max_batch"], results_db=db, device="cuda",
                            admission=AdmissionConfig(max_queue_depth=1 << 16, wait_budget_ms=1e9),
                            run_name="flywheel")
    server = GatewayServer(gateway)
    host, port = server.start()
    try:
        traffic, secs = synced(lambda: _drive_wire_stage(host, port, obs, households))
    finally:
        server.stop()
    if not (traffic.statuses == 200).all():
        fail(f"phase 13: gateway answered {np.unique(traffic.statuses).tolist()}")
    return secs, traffic.latencies_ms


# The pretrain's step counts timed (phase 13's and the command line's
# default, the JAX package's ``--trace-steps``), each the median of 3 runs.
PRETRAIN_STEPS = (50, 200)
PRETRAIN_REPEATS = 3


def flywheel_pretrain_profile(cfg, bundle, ds):
    """The pretrain from the incumbent with the same indices through its
    CUDA graph and through the eager loop, at 50 and 200 steps: the states
    and losses equal bit for bit at 200; each count timed three times from a
    state built beforehand (the dataset's copy to the card and the capture
    included), the step's marginal milliseconds from the two medians; the
    graph's 200-step run and the eager 50-step run profiled (device busy,
    idle share)."""
    import numpy as np
    import torch

    from p2pmicrogrid_tpu_torch.convert import state_to_numpy
    from p2pmicrogrid_tpu_torch.serve.export import load_policy_bundle
    from p2pmicrogrid_tpu_torch.train import continual as co

    manifest, params = load_policy_bundle(bundle)
    fresh = lambda: co.state_from_bundle(  # noqa: E731
        cfg, manifest, params, torch.Generator(device="cuda").manual_seed(0))
    lo, hi = PRETRAIN_STEPS
    idx = co.trace_indices(ds.n_transitions, hi, co.trace_batch_size(cfg, ds.n_transitions),
                           torch.Generator(device="cuda").manual_seed(1))
    out, reading = {}, {}
    for graph, profiled in ((True, hi), (False, lo)):
        row = {}
        for steps in PRETRAIN_STEPS:
            times = []
            for _ in range(PRETRAIN_REPEATS):
                st = fresh()
                (st, losses), secs = synced(
                    lambda: co.offpolicy_pretrain(cfg, st, ds, None, steps, indices=idx[:steps], graph=graph))
                times.append(secs)
            row[f"seconds_{steps}"] = statistics.median(times)
        out[graph] = (_leaves(state_to_numpy(st)._asdict()), losses)
        row["step_ms"] = (row[f"seconds_{hi}"] - row[f"seconds_{lo}"]) / (hi - lo) * 1e3
        st = fresh()
        kernels, _ = profile_episode(
            lambda: co.offpolicy_pretrain(cfg, st, ds, None, profiled, indices=idx[:profiled], graph=graph),
            profiled, row[f"seconds_{profiled}"])
        if kernels is not None:
            row["profiled_steps"] = profiled
            row["busy_ms"] = sum(ms for _, ms in kernels.values())
            row["idle_share"] = 1 - row["busy_ms"] / (row[f"seconds_{profiled}"] * 1e3)
            row["ops_per_step"] = sum(n for n, _ in kernels.values()) / profiled
        reading["graph" if graph else "eager"] = row
    (g, gl), (e, el) = out[True], out[False]
    if not (np.array_equal(gl, el) and all(np.array_equal(x, y) for x, y in zip(g, e))):
        fail("phase 13: the pretrain's graph replays differ from the eager loop")
    return reading


def phase_flywheel(counters, card):
    """Phase 13: the continual flywheel on the card. Returns (reading, K1
    launches of the flywheel)."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from p2pmicrogrid_tpu_torch import config as tc
    from p2pmicrogrid_tpu_torch.data.trace_export import export_serve_traces
    from p2pmicrogrid_tpu_torch.parallel.scenarios import init_shared_pol_state
    from p2pmicrogrid_tpu_torch.serve import PolicyEngine
    from p2pmicrogrid_tpu_torch.serve import promotion as pr
    from p2pmicrogrid_tpu_torch.serve.export import export_policy_bundle, load_policy_bundle
    from p2pmicrogrid_tpu_torch.serve.loadgen import serve_bench, synthetic_obs
    from p2pmicrogrid_tpu_torch.train.continual import train_continual

    tmp = tempfile.mkdtemp(prefix="chip_smoke_flywheel_")
    saved = os.environ.get("P2P_TELEMETRY_DIR")
    os.environ["P2P_TELEMETRY_DIR"] = os.path.join(tmp, "runs")
    try:
        small = flywheel_small_parity(tmp)
        A, S = FLY["A"], FLY["S"]
        cfg = chunked_config(tc, "ddpg", A, S, buffer_size=NORTHSTAR["buffer_size"],
                             batch_size=NORTHSTAR["batch_size"])
        # The incumbent: a seed-0 actor drawn on the CPU, exported on the card.
        inc = export_policy_bundle(
            cfg, init_shared_pol_state(cfg, "cpu", torch.Generator().manual_seed(0)),
            os.path.join(tmp, "incumbent"), source={"kind": "seed-0"}, device="cuda",
        )
        db = os.path.join(tmp, "warehouse.db")
        households = [f"house-{i}" for i in range(FLY["households"])]
        obs = synthetic_obs(FLY["requests"], A, seed=13)
        serve_s, lat = flywheel_serve(cfg, inc, db, obs, households)
        log(f"phase 13: gateway served {FLY['requests']} requests of A={A} from "
            f"{FLY['households']} households in {serve_s:.2f} s (p50 {np.percentile(lat, 50):.2f} ms, "
            f"p95 {np.percentile(lat, 95):.2f} ms)")
        reset(counters)
        inc_hash = load_policy_bundle(inc)[0]["config_hash"]
        ds, export_s = synced(lambda: export_serve_traces(db, config_hash=inc_hash, cfg=cfg))
        if ds.n_transitions != FLY["requests"] - FLY["households"] or not np.isfinite(ds.reward).all():
            fail(f"phase 13: exported {ds.summary()}")
        cand = os.path.join(tmp, "candidate")
        res, continual_s = synced(lambda: train_continual(
            cfg, inc, ds, cand, os.path.join(tmp, "ckpt"), n_episodes=1, n_chunks=1, eval_every=1,
            trace_steps=FLY["trace_steps"], s_eval=HEALTH_S_EVAL,
        ))
        k1_continual = counters["merged_min_sums"].launches
        if k1_continual <= 0:
            fail("phase 13: the guarded fine-tune launched no K1")
        (m_c, p_c), (m_i, p_i) = load_policy_bundle(cand), load_policy_bundle(inc)
        if m_c["config_hash"] != res.candidate_hash or res.candidate_hash == inc_hash:
            fail(f"phase 13: candidate hash {m_c['config_hash']} / {res.candidate_hash} vs {inc_hash}")
        flat_c, flat_i = _leaves(p_c), _leaves(p_i)
        if not all(np.isfinite(x).all() for x in flat_c) or all(
                np.array_equal(x, y) for x, y in zip(flat_c, flat_i)):
            fail("phase 13: the candidate's actor is not finite or did not move")
        if res.rollbacks:
            fail(f"phase 13: the guarded fine-tune rolled back: {res.rollbacks}")
        profile = flywheel_pretrain_profile(cfg, inc, ds)
        log(f"phase 13: exported {ds.n_transitions} transitions in {export_s:.3f} s; continual "
            f"{continual_s:.2f} s {res.phase_seconds}, loss {res.trace_loss_final}; pretrain profile "
            f"{profile}; K1 launches {k1_continual}")

        reset(counters)
        gate, gate_s = synced(lambda: pr.run_promotion_gate(cfg, cand, inc, s_eval=HEALTH_S_EVAL,
                                                            max_batch=FLY["max_batch"]))
        k1_gate = counters["merged_min_sums"].launches
        # The SLO bench runs only for a candidate the evaluations passed;
        # the same gate with the evaluation rules waived always reaches it.
        slo_only = pr.GateBudgets(cost_margin=-float("inf"), max_reward_drop=float("inf"))
        slo, slo_s = synced(lambda: pr.run_promotion_gate(
            cfg, cand, inc, budgets=slo_only, s_eval=HEALTH_S_EVAL, max_batch=FLY["max_batch"],
            incumbent_eval=(gate.incumbent_cost, gate.incumbent_reward)))
        if not (np.isfinite(gate.candidate_cost) and np.isfinite(gate.incumbent_cost)) or slo.p95_ms <= 0:
            fail(f"phase 13: gate {gate.to_fields()} / {slo.to_fields()}")
        bench = serve_bench(PolicyEngine(bundle_dir=cand, max_batch=FLY["max_batch"]), n_requests=512,
                            max_batch=FLY["max_batch"])[-1]
        log(f"phase 13: gate {gate.verdict} in {gate_s:.2f} s (cost {gate.candidate_cost:.4f} vs "
            f"{gate.incumbent_cost:.4f}; K1 launches {k1_gate}); SLO-only gate {slo.verdict} in "
            f"{slo_s:.2f} s p95 {slo.p95_ms} ms p99 {slo.p99_ms} ms; serve_bench p50 {bench['p50_ms']} "
            f"p95 {bench['p95_ms']} p99 {bench['p99_ms']} ms")

        reset(counters)
        fields, canary_s = synced(lambda: pr.run_promotion_pipeline(
            cfg, cand, inc, stages=FLY["stages"], results_db=os.path.join(tmp, "canary.db"),
            seed=0, requests_per_stage=FLY["requests_per_stage"], n_households=FLY["canary_households"],
            skip_gate=True, max_batch=FLY["max_batch"]))
        if fields["n_failed"] or fields["availability"] != 1.0 or fields["bit_exact_after"] is not True:
            fail(f"phase 13: canary {fields}")
        stages = [
            dict(percent=s["percent"], ok=s["ok"], n_requests=s["n_requests"],
                 arms={h[:12]: dict(requests=a["requests"], p95_ms=a["p95_ms"],
                                    decisions=a["decisions"], decision_cost=a["decision_cost"])
                       for h, a in s["arms"].items()})
            for s in fields["canary_stages"]
        ]
        log(f"phase 13: canary in {canary_s:.2f} s: promoted {fields['promoted']} rolled back "
            f"{fields['rolled_back']} availability {fields['availability']} bit-exact after "
            f"{fields['bit_exact_after']}; stages {json.dumps(stages)}")
        k1 = k1_continual + k1_gate
        reading = dict(
            card=card, small=small, A=A, S=S, serve_s=serve_s, requests=FLY["requests"],
            serve_p50_ms=float(np.percentile(lat, 50)), serve_p95_ms=float(np.percentile(lat, 95)),
            export_s=export_s, transitions=ds.n_transitions, continual_s=continual_s,
            phase_seconds=res.phase_seconds, trace_loss_final=res.trace_loss_final,
            pretrain_profile=profile, gate_s=gate_s, gate_verdict=gate.verdict,
            gate_costs=[gate.candidate_cost, gate.incumbent_cost], slo_gate_s=slo_s,
            slo_p95_ms=slo.p95_ms, slo_p99_ms=slo.p99_ms, bench_p50_ms=bench["p50_ms"],
            bench_p95_ms=bench["p95_ms"], bench_p99_ms=bench["p99_ms"], canary_s=canary_s,
            canary_stages=stages, promoted=fields["promoted"], rolled_back=fields["rolled_back"],
            availability=fields["availability"], bit_exact_after=fields["bit_exact_after"],
            k1_launches=dict(continual=k1_continual, gate=k1_gate, flywheel=k1),
        )
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        if saved is None:
            os.environ.pop("P2P_TELEMETRY_DIR", None)
        else:
            os.environ["P2P_TELEMETRY_DIR"] = saved
    return reading, k1


# --- phase 14 ---------------------------------------------------------------

# The serving fleet and the autopilot: phase 9's per-agent DQN (hidden 64)
# and the northstar's shared DDPG actor (CPU seed 0) at A=1000 in every
# replica, three replicas; the fleet bench at the JAX command line's default
# rate (256/s, 512 requests, 16 households) under kill_restart_plan; the
# autopilot bench over the northstar community's width (A=1000, battery on)
# with the crafted tabular candidates its harness injects.
FLEET = dict(replicas=3, max_batch=64, requests=512, rate=256.0, households=16,
             swap_requests=256, swap_rate=128.0, reg_rate=64.0, reg_before=96, reg_during=384,
             proc_requests=256, proc_rate=128.0, proc_probe=8, proxy_requests=64)
# Its traffic is cut from the harness's 96 requests a cycle and 64 a canary
# stage to 48 and 48 (the export and the billing parse 4,000 floats of JSON
# a decision on the host).
AUTOPILOT = dict(A=1000, replicas=3, cycles=3, inject="0:good,1:cost_regressed,2:nan_poisoned",
                 sigkill_phase="retraining", sigkill_cycle=1, requests_per_cycle=48,
                 canary_requests=48)


def act_one_at_a_time(router, obs, households):
    """Each observation alone through the router (one request in flight,
    so each is served at padding bucket 1): the RouterResults."""
    import asyncio

    async def run():
        try:
            return [await router.act(h, o) for h, o in zip(households, obs)]
        finally:
            await router.close_pools()

    return asyncio.run(run())


def fleet_latency(result, mask=None):
    """p50/p99 ms and requests/s of a FleetLoadgenResult (its served
    requests, or those of ``mask``)."""
    import numpy as np

    ok = result.statuses == 200
    if mask is not None:
        ok &= mask
    lat = result.latencies_s[ok] * 1e3
    return dict(n=int(ok.sum()), p50_ms=float(np.percentile(lat, 50)) if lat.size else None,
                p99_ms=float(np.percentile(lat, 99)) if lat.size else None)


def ddpg_mismatch(engine, obs, got):
    """(rows differing from ``engine.act`` on the same observations in one
    batch, largest absolute difference)."""
    import numpy as np

    want = engine.act(obs)
    got = np.asarray(got, dtype=np.float32)
    return int((got != want).any(axis=-1).sum()), float(np.abs(got - want).max()) if got.size else 0.0


def stream_coupling(small, big, A, calls=50):
    """p50 ms of ``small.act`` on one observation with the card idle, and
    while another replica's engine acts on 64 observations in a loop on
    another thread. Both replay on the card's one stream and share the
    host's interpreter lock, so the small act's result copy also waits for
    the other engine's queued work."""
    import threading

    import numpy as np

    from p2pmicrogrid_tpu_torch.serve.loadgen import synthetic_obs

    one, many = synthetic_obs(1, A, seed=61), synthetic_obs(64, A, seed=62)

    def p50():
        out = []
        for _ in range(calls):
            t0 = time.perf_counter()
            small.act(one)
            out.append((time.perf_counter() - t0) * 1e3)
        return float(np.percentile(out, 50))

    idle = p50()
    stop, loops = threading.Event(), [0]

    def run():
        while not stop.is_set():
            big.act(many)
            loops[0] += 1

    thread = threading.Thread(target=run)
    thread.start()
    try:
        busy = p50()
    finally:
        stop.set()
        thread.join(timeout=60)
    return dict(idle_p50_ms=idle, busy_p50_ms=busy, other_acts=loops[0])


def fleet_engines(fleet):
    """{replica: {hash: engine}} of an in-process fleet."""
    out = {}
    for rep in fleet.replicas:
        reg = fleet.entry(rep.replica_id)["registry"]
        out[rep.replica_id] = {h: reg.get(h).engine for h in reg.hashes}
    return out


def fleet_local(counters, paths, hashes, tmp):
    """(a)-(c): the in-process fleet on the card. Returns its reading."""
    import asyncio
    import threading

    import numpy as np
    import torch

    from p2pmicrogrid_tpu_torch.serve import (
        AdmissionConfig, FleetRouter, LocalFleet, kill_restart_plan, run_fleet_loadgen,
        serve_bench_fleet,
    )
    from p2pmicrogrid_tpu_torch.serve.loadgen import RetryPolicy, poisson_arrivals, synthetic_obs

    A = SERVE_WIDE_A
    out = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    duration = FLEET["requests"] / FLEET["rate"]
    plan = kill_restart_plan("replica-1", 0.3 * duration, 0.6 * duration, seed=0)
    fleet = LocalFleet([paths["dqn"], paths["ddpg"]], n_replicas=FLEET["replicas"],
                       max_batch=FLEET["max_batch"], admission=AdmissionConfig(**SERVE_ADMISSION),
                       fault_plan=plan, run_name="chip-fleet")
    start = time.perf_counter()
    fleet.start()
    try:
        start_s = time.perf_counter() - start
        engines = fleet_engines(fleet)
        replicas = []
        for rid, by_hash in engines.items():
            replicas.append(dict(
                replica=rid, start_s=fleet.entry(rid)["start_s"],
                captures={h[:12]: e.stats["aot_compiles"] for h, e in by_hash.items()},
                capture_s=sum(sum(e.capture_s.values()) for e in by_hash.values()),
                graph_pool_bytes=sum(e.graph_pool_bytes for e in by_hash.values()),
            ))
        peak = torch.cuda.max_memory_allocated()
        out["start"] = dict(seconds=start_s, replicas=replicas, peak_bytes=peak)
        log(f"phase 14 (a): LocalFleet of {FLEET['replicas']} replicas x (DQN, DDPG) at A={A} on "
            f"the card in {start_s:.2f} s, peak {peak / 2**30:.2f} GiB: {json.dumps(replicas)}")
        for rep in replicas:
            if any(n <= 0 for n in rep["captures"].values()):
                fail(f"phase 14 (a): {rep['replica']} captured no graph: {rep}")
        out["stream_coupling"] = stream_coupling(
            engines["replica-0"][hashes["dqn"]], engines["replica-1"][hashes["ddpg"]], A)
        log(f"phase 14 (a): replica-0's DQN act on one observation, idle and beside replica-1's "
            f"DDPG acts on 64: {json.dumps(out['stream_coupling'])}")

        # (b) The fleet bench under the kill/restart plan.
        router = FleetRouter(fleet.replicas, retry=RetryPolicy(max_attempts=5, deadline_s=30.0),
                             fail_threshold=2, ok_threshold=1)
        victim = fleet.entry("replica-1")["registry"]
        before = {h: victim.get(h).engine.stats["aot_compiles"] for h in victim.hashes}
        reference = fleet.reference_engine()
        rows = serve_bench_fleet(
            router, n_agents=A, fleet=fleet, fault_plan=plan, reference_engine=reference,
            rate_hz=FLEET["rate"], n_requests=FLEET["requests"], n_households=FLEET["households"],
            seed=0, probe_interval_s=0.05,
        )
        head = rows[-1]
        after = {h: victim.get(h).engine.stats["aot_compiles"] for h in victim.hashes}
        bench = {k: head[k] for k in ("p50_ms", "p95_ms", "p99_ms", "throughput_rps", "availability",
                                      "failover_count", "retry_rate", "n_requests", "n_ok", "n_shed",
                                      "n_failed", "bit_exact", "bit_exact_mismatches", "ejections",
                                      "readmissions", "repins", "chaos")}
        bench["retries"] = round(head["retry_rate"] * head["n_requests"])
        bench["restart_captures"] = {h[:12]: after[h] - before[h] for h in after}
        out["bench"] = bench
        log(f"phase 14 (b): serve_bench_fleet {json.dumps(bench)}")
        if head["availability"] != 1.0 or head["n_failed"] or head["n_shed"]:
            fail(f"phase 14 (b): availability {head['availability']}, failed {head['n_failed']}, "
                 f"shed {head['n_shed']}")
        if head["bit_exact"] is not True:
            fail(f"phase 14 (b): the DQN bundle's answers are not bit-exact: {head['bit_exact_mismatches']}")
        if head["chaos"]["kills"] != ["replica-1"] or head["chaos"]["restarts"] != ["replica-1"]:
            fail(f"phase 14 (b): the plan did not run: {head['chaos']}")
        if after != before:
            fail(f"phase 14 (b): the restarted replica recaptured: {before} -> {after}")

        # (c) Two fleet swaps under traffic. First DQN -> DDPG mid-traffic.
        ddpg_engine = engines["replica-0"][hashes["ddpg"]]
        obs = synthetic_obs(FLEET["swap_requests"], A, seed=21)
        households = [f"house-{i:04d}" for i in range(FLEET["households"])]
        box = []
        traffic = threading.Thread(target=lambda: box.append(run_fleet_loadgen(
            router, obs, poisson_arrivals(FLEET["swap_rate"], len(obs), seed=21), households)))
        traffic.start()
        time.sleep(0.5 * len(obs) / FLEET["swap_rate"])
        swap, swap_s = synced(lambda: asyncio.run(router.swap_fleet(hashes["ddpg"])))
        traffic.join(timeout=300)
        res = box[0]
        served = np.array([h for h in res.config_hashes], dtype=object)
        dqn_idx = [i for i in range(res.n_requests) if served[i] == hashes["dqn"]]
        ddpg_idx = [i for i in range(res.n_requests) if served[i] == hashes["ddpg"]]
        dqn_exact = bool(np.array_equal(np.asarray([res.actions[i] for i in dqn_idx], np.float32),
                                        reference.act(obs[dqn_idx])))
        ddpg_mis, ddpg_err = ddpg_mismatch(ddpg_engine, obs[ddpg_idx], [res.actions[i] for i in ddpg_idx])
        swap1 = dict(swap_s=swap_s, n_ok=res.n_ok, n_requests=res.n_requests, dqn_answers=len(dqn_idx),
                     ddpg_answers=len(ddpg_idx), dqn_bit_exact=dqn_exact, ddpg_mismatches=ddpg_mis,
                     ddpg_max_abs_diff=ddpg_err, **fleet_latency(res))
        out["swap_dqn_to_ddpg"] = swap1
        log(f"phase 14 (c): two-phase swap DQN -> DDPG mid-traffic: {json.dumps(swap1)}")
        if res.n_ok != res.n_requests or not dqn_idx or not ddpg_idx or not dqn_exact or ddpg_err > 1e-5:
            fail(f"phase 14 (c): swap under traffic {swap1}")
        if swap["config_hash"] != hashes["ddpg"]:
            fail(f"phase 14 (c): swap answered {swap}")

        # The post-cycle invariant's two forms on the DDPG default: four
        # requests at once against one batched act (the JAX package's), and
        # one at a time against the act of each alone (the port's).
        inv_obs = synthetic_obs(4, A, seed=555)
        batched = ddpg_engine.act(inv_obs)
        alone = np.concatenate([ddpg_engine.act(inv_obs[i:i + 1]) for i in range(4)])
        at_once = run_fleet_loadgen(router, inv_obs, np.zeros(4), ["verify-house"])
        one = act_one_at_a_time(router, inv_obs, ["verify-house"] * 4)
        got_once = np.asarray(at_once.actions, np.float32)
        got_one = np.asarray([r.actions for r in one], np.float32)
        invariant = dict(
            engine_bucket1_vs_bucket4_rows=int((alone != batched).any(axis=-1).sum()),
            engine_bucket1_vs_bucket4_max_abs=float(np.abs(alone - batched).max()),
            jax_form_equal=bool((got_once == batched).all()),
            jax_form_rows_differing=int((got_once != batched).any(axis=-1).sum()),
            port_form_equal=bool((got_one == alone).all()),
        )
        out["invariant_ddpg"] = invariant
        log(f"phase 14 (c): the post-cycle invariant on the DDPG default: {json.dumps(invariant)}")
        if not invariant["port_form_equal"]:
            fail(f"phase 14 (c): one-at-a-time answers differ from the engine's act alone: {invariant}")

        # Then a swap to a bundle registered at run time: every replica
        # captures its graphs while traffic flows.
        before_obs = synthetic_obs(FLEET["reg_before"], A, seed=31)
        res_before = run_fleet_loadgen(router, before_obs, poisson_arrivals(
            FLEET["reg_rate"], len(before_obs), seed=31), households)
        during_obs = synthetic_obs(FLEET["reg_during"], A, seed=32)
        box, reg_box = [], []
        traffic = threading.Thread(target=lambda: box.append(run_fleet_loadgen(
            router, during_obs, poisson_arrivals(FLEET["reg_rate"], len(during_obs), seed=32), households)))
        t_traffic = time.perf_counter()
        traffic.start()
        time.sleep(0.5)
        t_reg = time.perf_counter()
        reg_hash = asyncio.run(router.register_fleet(paths["ddpg_seed1"]))
        reg_s = time.perf_counter() - t_reg
        traffic.join(timeout=300)
        res_during = box[0]
        sent = t_traffic + np.asarray(poisson_arrivals(FLEET["reg_rate"], len(during_obs), seed=32))
        in_window = (sent >= t_reg) & (sent <= t_reg + reg_s)
        per_replica = {}
        for rid in engines:
            mask_b = np.array([r == rid for r in res_before.replica_ids])
            mask_d = np.array([r == rid for r in res_during.replica_ids]) & in_window
            per_replica[rid] = dict(before=fleet_latency(res_before, mask_b),
                                    during_capture=fleet_latency(res_during, mask_d))
        new_engines = {rid: fleet.entry(rid)["registry"].get(reg_hash).engine for rid in engines}
        capture_s = {rid: sum(e.capture_s.values()) for rid, e in new_engines.items()}
        swap2, swap2_s = synced(lambda: asyncio.run(router.swap_fleet(reg_hash)))
        check_obs = synthetic_obs(8, A, seed=33)
        check = act_one_at_a_time(router, check_obs, [f"house-{i:04d}" for i in range(8)])
        seed1 = new_engines["replica-0"]
        got = np.asarray([r.actions for r in check], np.float32)
        want = np.concatenate([seed1.act(check_obs[i:i + 1]) for i in range(8)])
        reg = dict(register_s=reg_s, capture_s=capture_s,
                   captures={rid: e.stats["aot_compiles"] for rid, e in new_engines.items()},
                   during_n_ok=res_during.n_ok, during_n_requests=res_during.n_requests,
                   per_replica=per_replica, swap_s=swap2_s,
                   after_swap_hashes=sorted({r.config_hash for r in check}),
                   after_swap_bit_exact=bool((got == want).all()))
        out["register_and_swap"] = reg
        log(f"phase 14 (c): runtime register of a third bundle under traffic: {json.dumps(reg)}")
        if res_during.n_ok != res_during.n_requests or res_before.n_ok != res_before.n_requests:
            fail(f"phase 14 (c): requests failed across the runtime register: {reg}")
        if reg["after_swap_hashes"] != [reg_hash] or not reg["after_swap_bit_exact"] or swap2["config_hash"] != reg_hash:
            fail(f"phase 14 (c): after the swap to the registered bundle: {reg}")
        out["peak_bytes"] = torch.cuda.max_memory_allocated()
    finally:
        fleet.stop_all()
    return out


def fleet_process(paths, hashes, tmp):
    """(d) The process fleet on the card with TLS and token auth, and (e)
    the ``serve-router`` proxy in front of it. Returns the reading."""
    import asyncio
    import signal
    import threading

    import numpy as np

    from p2pmicrogrid_tpu_torch.serve import (
        ConsistentHashRing, FleetRouter, PolicyEngine, ProcessFleet, TokenAuthenticator,
        client_ssl_context, ensure_test_certs, generate_secret, kill_restart_plan, serve_bench_fleet,
    )
    from p2pmicrogrid_tpu_torch.serve.loadgen import RetryPolicy, _http_request_json, synthetic_obs

    A = SERVE_WIDE_A
    cert, key = ensure_test_certs(os.path.join(tmp, "tls"))
    secret_file = os.path.join(tmp, "fleet.secret")
    auth = TokenAuthenticator(generate_secret(secret_file))
    client = client_ssl_context(cert)
    out = {}
    fleet = ProcessFleet(
        [paths["dqn"], paths["ddpg"]], n_replicas=FLEET["replicas"], max_batch=FLEET["max_batch"],
        max_queue_depth=SERVE_ADMISSION["max_queue_depth"], wait_budget_ms=SERVE_ADMISSION["wait_budget_ms"],
        tls_cert=cert, tls_key=key, auth_secret_file=secret_file, serve_device="cuda",
        env={"PYTHONPATH": HERE + os.pathsep + os.environ.get("PYTHONPATH", "")},
    )
    start = time.perf_counter()
    fleet.start()
    proxy = None
    try:
        out["start_s"] = time.perf_counter() - start
        router = FleetRouter(fleet.replicas, retry=RetryPolicy(max_attempts=5, deadline_s=60.0),
                             fail_threshold=2, ok_threshold=1, ssl_context=client, token=auth.mint("*"))
        ring = ConsistentHashRing()
        for rep in fleet.replicas:
            ring.add(rep.replica_id)
        probe_homes = [h for h in (f"probe-{i:04d}" for i in range(1000))
                       if ring.lookup(h) == "replica-1"][:FLEET["proc_probe"]]
        probe_obs = synthetic_obs(len(probe_homes), A, seed=41)
        first = act_one_at_a_time(router, probe_obs, probe_homes)
        if any(r.status != 200 or r.replica_id != "replica-1" for r in first):
            fail(f"phase 14 (d): probes before the kill: {[(r.status, r.replica_id) for r in first]}")
        pid_before = fleet.pid("replica-1")
        duration = FLEET["proc_requests"] / FLEET["proc_rate"]
        plan = kill_restart_plan("replica-1", 0.3 * duration, 0.6 * duration, seed=0)
        reference = PolicyEngine(bundle_dir=paths["dqn"], max_batch=FLEET["max_batch"])
        rows = serve_bench_fleet(
            router, n_agents=A, fleet=fleet, fault_plan=plan, reference_engine=reference,
            rate_hz=FLEET["proc_rate"], n_requests=FLEET["proc_requests"],
            n_households=FLEET["households"], seed=1, probe_interval_s=0.05,
            chaos_join_grace_s=180.0, recover_wait_s=180.0,
        )
        head = rows[-1]
        second = act_one_at_a_time(router, probe_obs, probe_homes)
        same = all(a.status == b.status == 200 and a.actions == b.actions and b.replica_id == "replica-1"
                   for a, b in zip(first, second))
        out["bench"] = {k: head[k] for k in ("p50_ms", "p99_ms", "throughput_rps", "availability",
                                             "failover_count", "retry_rate", "n_failed", "bit_exact",
                                             "chaos", "processes", "reconnects", "tls")}
        out["startups"] = list(fleet.startups)
        out["relaunch_bit_exact"] = same
        out["pids"] = [pid_before, fleet.pid("replica-1")]
        log(f"phase 14 (d): ProcessFleet of {FLEET['replicas']} children on the card with TLS and "
            f"token auth, started in {out['start_s']:.2f} s; startups {json.dumps(out['startups'])}; "
            f"bench {json.dumps(out['bench'])}; {len(probe_homes)} replica-1 answers one at a time "
            f"equal after the relaunch: {same}")
        if head["availability"] != 1.0 or head["n_failed"] or head["bit_exact"] is not True:
            fail(f"phase 14 (d): process bench {out['bench']}")
        if not same or out["pids"][0] == out["pids"][1] or head["processes"]["replica-1"]["restarts"] < 1:
            fail(f"phase 14 (d): the relaunch: {out['pids']} {head['processes']} bit-exact {same}")
        if len([s for s in fleet.startups if s["replica_id"] == "replica-1"]) < 2:
            fail(f"phase 14 (d): no relaunch recorded: {fleet.startups}")

        # (e) The serve-router proxy in front of the fleet.
        argv = [sys.executable, "-m", "p2pmicrogrid_tpu_torch", "serve-router", "--port", "0",
                "--tls-cert", cert, "--tls-key", key, "--backend-cafile", cert,
                "--auth-secret-file", secret_file, "--serve-seconds", "600",
                "--stats-out", os.path.join(tmp, "router-stats.json")]
        for rep in fleet.replicas:
            argv += ["--replica", f"{rep.host}:{rep.port}/{rep.mux_port}"]
        t0 = time.perf_counter()
        proxy = subprocess.Popen(argv, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                 env=dict(os.environ, PYTHONPATH=HERE))
        line = []
        reader = threading.Thread(target=lambda: line.append(proxy.stdout.readline()), daemon=True)
        reader.start()
        reader.join(timeout=120)
        if not line or not line[0].startswith("{"):
            fail(f"phase 14 (e): serve-router printed no listening line: {proxy.poll()}")
        listening = json.loads(line[0])
        ready_s = time.perf_counter() - t0
        host, port = listening["host"], listening["port"]
        obs = synthetic_obs(FLEET["proxy_requests"], A, seed=51)
        homes = [f"house-{i % FLEET['households']:04d}" for i in range(len(obs))]

        async def through_proxy():
            return await asyncio.gather(*(
                _http_request_json(host, port, "POST", "/v1/act",
                                   {"household": h, "obs": o.tolist()}, 60.0, ssl=client,
                                   token=auth.mint(h))
                for h, o in zip(homes, obs)))

        t1 = time.perf_counter()
        answers = asyncio.run(through_proxy())
        proxy_s = time.perf_counter() - t1
        statuses = [s for s, _, _ in answers]
        got = np.asarray([d["actions"] for _, d, _ in answers], np.float32)
        exact = bool(np.array_equal(got, reference.act(obs)))
        swap = asyncio.run(_http_request_json(host, port, "POST", "/admin/swap",
                                              {"config_hash": hashes["ddpg"]}, 120.0, ssl=client,
                                              token=auth.mint("*")))
        ready = asyncio.run(_http_request_json(host, port, "GET", "/readyz", None, 30.0, ssl=client))
        proxy.send_signal(signal.SIGINT)
        rc = proxy.wait(timeout=60)
        out["proxy"] = dict(ready_s=ready_s, requests=len(obs), seconds=proxy_s,
                            statuses=sorted(set(statuses)), bit_exact=exact, swap_status=swap[0],
                            readyz=ready[1], rc=rc)
        log(f"phase 14 (e): serve-router in front of the process fleet: {json.dumps(out['proxy'])}")
        if statuses != [200] * len(obs) or not exact or swap[0] != 200 or ready[0] != 200 \
                or ready[1].get("config_hash") != hashes["ddpg"] or rc != 0:
            fail(f"phase 14 (e): the proxy: {out['proxy']}")
    finally:
        if proxy is not None and proxy.poll() is None:
            proxy.kill()
            proxy.wait(timeout=30)
        fleet.stop_all()
    return out


class Background:
    """``fn`` on a thread of its own: ``start`` once, ``join`` returns what it
    returned or raises, in the calling thread, what it raised (a ``fail``
    on the thread exits the script at the join)."""

    def __init__(self, fn):
        import threading

        self._fn, self._box = fn, {}
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        try:
            self._box["result"] = self._fn()
        except BaseException as exc:  # noqa: BLE001 — re-raised by join
            self._box["error"] = exc

    def start(self):
        if self._thread.ident is None:
            self._thread.start()

    def join(self):
        self.start()
        self._thread.join()
        if "error" in self._box:
            raise self._box["error"]
        return self._box["result"]


def fleet_autopilot():
    """(f) ``autopilot_bench`` on the card over the northstar community's
    width. Its fleet and its autopilot are child processes, so it runs on a
    thread of its own beside the phases from the end of phase 12's
    north-star commands on (``Background``); the K1 launches are the ones
    its cycles' rows report from the autopilot's process. Returns (reading,
    K1 launches)."""
    import shutil
    import tempfile

    from p2pmicrogrid_tpu_torch import cli
    from p2pmicrogrid_tpu_torch.serve.autopilot import autopilot_bench, read_journal

    flags = ["--agents", str(AUTOPILOT["A"]), "--implementation", "tabular", "--episodes", "1",
             "--rounds", "1", "--battery"]
    parser = capture_parser(cli.main)
    cfg = cli._build_cfg(parser.parse_args(["autopilot", "--seed", "0"] + flags))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_autopilot_")
    work = os.path.join(tmp, "autopilot")
    start = time.perf_counter()
    try:
        rows = autopilot_bench(
            cfg, work, n_replicas=AUTOPILOT["replicas"], n_cycles=AUTOPILOT["cycles"],
            inject=AUTOPILOT["inject"], seed=0, chaos=True, sigkill_phase=AUTOPILOT["sigkill_phase"],
            sigkill_cycle=AUTOPILOT["sigkill_cycle"], extra_cfg_args=flags, device="cuda",
            requests_per_cycle=AUTOPILOT["requests_per_cycle"],
            canary_requests=AUTOPILOT["canary_requests"],
        )
        seconds = time.perf_counter() - start
        final = read_journal(os.path.join(work, "autopilot"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    head, cycles = rows[-1], rows[:-1]
    k1 = sum(r.get("kernel_launches", {}).get("merged_min_sums", 0) for r in cycles)
    others = {n: sum(r.get("kernel_launches", {}).get(n, 0) for r in cycles)
              for n in cycles[0].get("kernel_launches", {}) if n != "merged_min_sums"}
    reading = dict(
        seconds=seconds, A=AUTOPILOT["A"], cycles=[
            {k: r.get(k) for k in ("cycle", "inject", "promoted", "blocked_at_gate", "rolled_back",
                                   "gate_verdict", "serving_verified", "availability", "seconds",
                                   "trace_transitions", "kernel_launches")} for r in cycles],
        headline={k: head[k] for k in ("cycles", "promotions", "blocked", "rollbacks", "crash_aborts",
                                       "bad_promotions", "availability", "n_requests", "all_safe",
                                       "serving_verified", "autopilot_sigkills", "autopilot_recovered",
                                       "chaos")},
        journal=dict(phase=final.phase, cycle=final.cycle), k1_launches=k1,
    )
    log(f"phase 14 (f): autopilot_bench at A={AUTOPILOT['A']} in {seconds:.1f} s: {json.dumps(reading)}")
    by_inject = {r["inject"]: r for r in cycles}
    if not (by_inject.get("good", {}).get("promoted") and by_inject.get("cost_regressed", {}).get("blocked_at_gate")
            and by_inject.get("nan_poisoned", {}).get("blocked_at_gate")):
        fail(f"phase 14 (f): cycles {reading['cycles']}")
    if not (head["all_safe"] and head["promotions"] == 1 and head["bad_promotions"] == 0
            and head["availability"] == 1.0 and head["serving_verified"] and head["autopilot_recovered"]
            and head["chaos"]["kills"]):
        fail(f"phase 14 (f): headline {reading['headline']}")
    if not all(r.get("serving_verified") is True for r in cycles) or final.phase != "idle" \
            or final.cycle != AUTOPILOT["cycles"]:
        fail(f"phase 14 (f): invariant or journal: {reading}")
    if k1 <= 0 or any(others.values()):
        fail(f"phase 14 (f): launches K1 {k1}, others {others}")
    return reading, k1


def phase_fleet(counters, card, autopilot):
    """Phase 14: the serving fleet on the card, (a)-(e), then the autopilot
    bench's result, (f), from its thread. Returns (reading, K1 launches of
    the autopilot)."""
    import shutil
    import tempfile

    from p2pmicrogrid_tpu_torch import config as tc
    from p2pmicrogrid_tpu_torch.serve import export_policy_bundle, load_policy_bundle

    start = time.perf_counter()
    autopilot.start()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_fleet_")
    saved = os.environ.get("P2P_TELEMETRY_DIR")
    os.environ["P2P_TELEMETRY_DIR"] = os.path.join(tmp, "runs")
    try:
        states = {label: (cfg, state) for label, cfg, state in serve_states(tc)}
        paths, hashes = {}, {}
        for label, key in (("dqn", "dqn"), ("ddpg_seed0", "ddpg"), ("ddpg_seed1", "ddpg_seed1")):
            cfg, state = states[label]
            paths[key] = export_policy_bundle(cfg, state, os.path.join(tmp, key), device="cuda")
            hashes[key] = load_policy_bundle(paths[key])[0]["config_hash"]
        reset(counters)
        reading = dict(card=card, A=SERVE_WIDE_A, local=fleet_local(counters, paths, hashes, tmp))
        reading["process"] = fleet_process(paths, hashes, tmp)
        launches = {name: fn.launches for name, fn in counters.items()}
        if any(launches.values()):
            fail(f"phase 14: the fleet launched hand-written kernels: {launches}")
        reading["serving_launches"] = launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        if saved is None:
            os.environ.pop("P2P_TELEMETRY_DIR", None)
        else:
            os.environ["P2P_TELEMETRY_DIR"] = saved
    reading["autopilot"], k1 = autopilot.join()
    reading["seconds"] = time.perf_counter() - start
    return reading, k1


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a CUDA device")
    import_port()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from p2pmicrogrid_tpu_torch.ops import matrix_market as mm
    from p2pmicrogrid_tpu_torch.ops.merged_min import merged_min_sums
    from p2pmicrogrid_tpu_torch.ops.slot_fused import slot_step_fused

    counters = {
        "merged_min_sums": merged_min_sums,
        "divide_rank1_fused": mm.divide_rank1_fused,
        "divide_power_fused_with_mean": mm.divide_power_fused_with_mean,
        "clear_market_fused": mm.clear_market_fused,
        "divide_power_fused": mm.divide_power_fused,
        "prep_mean": mm.prep_mean,
        "slot_step_fused": slot_step_fused,
    }
    # With no arguments every phase runs (the check); a comma-separated list
    # of phase numbers (e.g. "2,5") runs only those, builds first, and prints
    # no result line.
    all_phases = {"2", "3", "4", "5", "6", "7", "8", "9", "10", "11", "12", "13", "14"}
    phases = set(sys.argv[1].split(",")) if len(sys.argv) > 1 else all_phases
    start = time.perf_counter()
    card = phase_device_and_build()
    if "2" in phases:
        records = [phase_kernels()] + phase_matrix_kernels() + [phase_slot_kernel()]
        log(f"phase 2: kernels match their plain versions ({time.perf_counter() - start:.1f} s)")
    if "3" in phases:
        phase_small_parity()
        phase_ddpg_parity()
        log(f"phase 3 done ({time.perf_counter() - start:.1f} s)")
    launches, profiled, ddpg_rows = {name: 0 for name in counters}, {}, []
    if "4" in phases:
        launches, profiled, ddpg_rows = phase_main_path(counters)
        log(f"phase 4 done ({time.perf_counter() - start:.1f} s)")
    chunked = {}
    if "5" in phases:
        chunked["graph_vs_eager"], chunk_launches = phase_graph_vs_eager(counters)
        phase_chunked_small_parity()
        chunked["northstar"], northstar_launches = phase_northstar(counters, card)
        chunked["cfg4_chunked_graph"] = phase_cfg4_chunked(counters, card)
        for name in launches:
            launches[name] += chunk_launches[name] + northstar_launches[name]
        log(json.dumps({"chunked": chunked}))
        log(f"phase 5 done ({time.perf_counter() - start:.1f} s)")
    single_rows, single_shapes = [], {}
    if "6" in phases:
        golden_launches = phase_single_golden(counters)
        parity_launches = phase_single_parity(counters)
        single_rows, row_launches, single_shapes = phase_single_rows(counters, card)
        for name in launches:
            launches[name] += golden_launches[name] + parity_launches[name] + row_launches[name]
        log(f"phase 6 done ({time.perf_counter() - start:.1f} s)")
    multi_rows, multi_shapes = [], {}
    if "7" in phases:
        multi_rows, multi_launches, multi_shapes = phase_multi_community(counters, card)
        indep_rows, indep_launches, indep_shapes = phase_independent(counters, card)
        multi_rows += indep_rows
        for name in launches:
            launches[name] += multi_launches[name] + indep_launches[name]
        for name, by_shape in indep_shapes.items():
            multi_shapes.setdefault(name, {}).update(by_shape)
        log(f"phase 7 done ({time.perf_counter() - start:.1f} s)")
    guarded = {}
    if "8" in phases:
        import shutil
        import tempfile

        tmp = tempfile.mkdtemp(prefix="chip_smoke_")
        try:
            guarded["draw_digests"] = phase_draw_digests()
            bare = chunked.get("northstar", {}).get("env_steps_per_s")
            guarded["northstar"], g_launches = phase_guarded_northstar(counters, card, tmp, bare)
            guarded["counters_cost"], c_launches = phase_graph_counters(counters)
            guarded["kill_resume"] = phase_kill_resume(tmp)
            guarded["single"], s_launches = phase_single_resilience(counters, card)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        for name in launches:
            launches[name] += g_launches[name] + c_launches[name] + s_launches[name]
        log(f"phase 8 done ({time.perf_counter() - start:.1f} s)")
    if "9" in phases:
        log(json.dumps({"serve": phase_serving(counters)}))
        log(f"phase 9 done ({time.perf_counter() - start:.1f} s)")
    recurrent, regimes = {}, {}
    if "10" in phases:
        recurrent = phase_recurrent(counters)
        log(f"phase 10 done ({time.perf_counter() - start:.1f} s)")
    if "11" in phases:
        regimes, regime_k1 = phase_regimes(counters, card)
        launches["merged_min_sums"] += regime_k1
        log(f"phase 11 done ({time.perf_counter() - start:.1f} s)")
    # Phase 14's autopilot bench runs its fleet and its autopilot as child
    # processes: it starts on a thread of its own once phase 12's north-star
    # commands are done (or with phase 14), and phase 14 joins it.
    autopilot = None
    if "14" in phases:
        os.environ["PYTHONPATH"] = HERE + (
            os.pathsep + os.environ["PYTHONPATH"] if os.environ.get("PYTHONPATH") else "")
        autopilot = Background(fleet_autopilot)

    def start_autopilot():
        gc_collect()
        autopilot.start()

    cli_launches = {name: 0 for name in counters}
    if "12" in phases:
        cli_reading, cli_launches = phase_cli(
            counters, card, after_northstar=start_autopilot if autopilot is not None else None)
        for name in launches:
            launches[name] += cli_launches[name]
        log(json.dumps({"cli": cli_reading}))
        log(f"phase 12 done ({time.perf_counter() - start:.1f} s)")
    flywheel_k1 = 0
    if "13" in phases:
        flywheel, flywheel_k1 = phase_flywheel(counters, card)
        launches["merged_min_sums"] += flywheel_k1
        log(json.dumps({"flywheel": flywheel}))
        log(f"phase 13 done ({time.perf_counter() - start:.1f} s)")
    autopilot_k1 = 0
    if "14" in phases:
        phase14_start = time.perf_counter()
        fleet, autopilot_k1 = phase_fleet(counters, card, autopilot)
        launches["merged_min_sums"] += autopilot_k1
        log(json.dumps({"fleet": fleet}))
        log(f"phase 14 done in {time.perf_counter() - phase14_start:.1f} s "
            f"({time.perf_counter() - start:.1f} s)")
    if phases != all_phases:
        log(f"partial run of phases {sorted(phases)}: no result ({time.perf_counter() - start:.1f} s)")
        return
    on_path = (
        {name for run in MAIN_RUNS for name in run[7]}
        | {name for run in CHUNK_RUNS for name in run[4]}
        | set(SINGLE_R2) | set(FUSED_PATH)
    )
    for name in on_path:
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched on the main path")
    for rec in records:
        name = rec["name"]
        rec["launches"] = launches[name]
        rec["cli_launches"] = cli_launches[name]
        rec["flywheel_launches"] = flywheel_k1 if name == "merged_min_sums" else 0
        rec["autopilot_launches"] = autopilot_k1 if name == "merged_min_sums" else 0
        rec["on_main_path"] = name in on_path
        # Device time per call from the main path's profiled tabular episode
        # (no host time in it), where the profiler saw the device; K7 keeps
        # its phase-2 profile under profiled_ms.
        if name in on_path:
            key = "main_path_profiled_ms" if name == "slot_step_fused" else "profiled_ms"
            rounds = 2 if name in MATRIX_PATH else 1
            rec[key] = profiled[name].get((64, 1000, "tabular", rounds))
            rec["at_256x50"][key] = profiled[name].get((256, 50, "tabular", rounds))
            if name == "merged_min_sums":
                rec["at_128x1000"]["regime_launches"] = regimes["northstar"]["k1_launches"]
                rec["at_2048x50"][key] = profiled[name].get((2048, 50, "ddpg", 1))
                rec["at_8x1000"]["launches_per_eval"] = guarded["northstar"]["eval_launches"]
                rec["ddpg_64x1000"] = {key: profiled[name].get((64, 1000, "ddpg", 1))}
                rec["at_128x1000"][key] = chunked["northstar"]["k1_device_ms_per_call"]
            if name == "slot_step_fused":
                rec["dqn_64x1000"][key] = profiled[name].get((64, 1000, "dqn", 1))
                rec["matrix_r2_64x1000"][key] = profiled[name].get((64, 1000, "tabular", 2))
        # Phase 6's shapes: device time per call on the single path's
        # profiled episodes (the single community [1,A], the evaluation's
        # days [13,2]).
        prefix = "single" if name == "slot_step_fused" else "at"
        for (S, A), ms in single_shapes.get(name, {}).items():
            rec.setdefault(f"{prefix}_{S}x{A}", {})["main_path_profiled_ms"] = ms
        # Phase 7's shapes: K1 at cfg5's [8,128] and [104,128], K5 and K6 at
        # [64,2] and [64,10], K7 with one learner per scenario at [64,2].
        prefix = "strided" if name == "slot_step_fused" else "at"
        for (S, A), ms in multi_shapes.get(name, {}).items():
            rec.setdefault(f"{prefix}_{S}x{A}", {})["main_path_profiled_ms"] = ms
    log(json.dumps({"ddpg_rows": ddpg_rows}))
    log(json.dumps({"single_rows": single_rows}))
    log(json.dumps({"multi_rows": multi_rows}))
    log(json.dumps({"guarded": guarded}))
    log(json.dumps({"recurrent": recurrent}))
    log(json.dumps({"regimes": regimes}))
    log(json.dumps({"kernels": records}))
    log(f"total {time.perf_counter() - start:.1f} s")
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        ),
        flush=True,
    )


if __name__ == "__main__":
    main()
