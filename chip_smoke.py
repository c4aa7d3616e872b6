"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

Run from the root of a checkout, with one CUDA device:

    python3 chip_smoke.py

Phases (each failure exits non-zero):

1. Device and build: the card's name and power limit, the torch and CUDA
   versions, then every kernel built from ``csrc/`` (one ``nvcc`` per
   source, all started together).
2. Each kernel against its plain PyTorch version on the card, at the main
   paths' shapes and edge cases; a repeat launch must be bit-identical; the
   kernel and the plain version timed with CUDA events. K1 (merged min), then
   K5, K4, K6 (the matrix path) and K3, K2 (same source, no main path).
3. Small-path parity: the A=6, S=3 shared tabular episode with fixed draws on
   the card against the port on the CPU (rewards, every slot's actions), for
   the factored market (rounds=1) and the matrix negotiation (rounds=2).
4. The main paths at full width: ``train_scenarios_shared`` (tabular,
   battery on, market "auto") at rounds=1 (-> factored with bf16
   pre-rounding, K1) and at rounds=2 (-> matrix, K5, K4, K6, bf16 storage at
   A >= 256), each at A=1000, S=64 and at A=50, S=256, two episodes each and
   one more under the profiler. Every kernel launch counter is set to 0
   just before each run and read just after; each episode must launch each
   of its path's kernels once per slot and no other kernel.
5. One JSON line with every kernel's numbers, then the last line
   ``{"ok": true, "device": {...}}``.

It prints no result and exits non-zero without a CUDA device, or when run
outside a checkout of the repository.
"""

from __future__ import annotations

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


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


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


def profile_episode(run_episode, n_slots: int, wall_unprofiled_s: float):
    """One episode under torch.profiler: device busy time, idle share, the
    kernels by device time. Returns {kernel name: (count, device ms)} or None
    when the profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    start = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run_episode()
        torch.cuda.synchronize()
    wall = time.perf_counter() - start
    kernels = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        kernels[e.key] = (e.count, us / 1e3)
    busy_ms = sum(ms for _, ms in kernels.values())
    if busy_ms <= 0:
        log("  profile: the profiler saw no device time (not measured)")
        return None
    launches = sum(n for n, _ in kernels.values())
    log(
        f"  profile: device busy {busy_ms:.3f} ms over {wall * 1e3:.3f} ms "
        f"profiled wall (idle share {1 - busy_ms / (wall * 1e3):.4f}; "
        f"{1 - busy_ms / (wall_unprofiled_s * 1e3):.4f} of the unprofiled "
        f"timed episode), {launches / n_slots:.1f} device ops per slot"
    )
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:8]
    for name, (n, ms) in top:
        log(f"    {ms:10.3f} ms {n:6d}x  {name[:100]}")
    return kernels


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
    from p2pmicrogrid_tpu_torch.ops import matrix_market, merged_min

    start = time.perf_counter()
    builds = {
        mod.LIBRARY.name: mod.LIBRARY.start_build(("-Xptxas", "-v"))
        for mod in (merged_min, matrix_market)
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


def phase_kernels():
    """K1 against its plain version; returns the kernel record."""
    import torch

    from p2pmicrogrid_tpu_torch.ops.merged_min import (
        merged_min_sums,
        merged_min_sums_plain,
    )

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    cases = [
        (64, 1000, "random"),
        (64, 1000, "bf16"),
        (256, 50, "random"),
        (256, 50, "zero"),
        (64, 1000, "no_prop"),
        (64, 1000, "one_sided"),
        (5, 257, "random"),
    ]
    max_abs_err = 0.0
    timings = {}
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
        if case == "random" and (S, A) in ((64, 1000), (256, 50)):
            k_ms = cuda_time_ms(lambda: merged_min_sums(*args))
            p_ms = cuda_time_ms(lambda: merged_min_sums_plain(*args))
            ops = 7.0 * S * A * A  # 2 products, 2 selects, min, 2 sums per entry
            nbytes = 4.0 * 8 * S * A  # six [S, A] inputs read, two written
            bound_ops = ops / PEAK_F32_FLOPS * 1e3
            bound_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
            timings[(S, A)] = dict(
                ms=k_ms,
                plain_ms=p_ms,
                bound_ms=max(bound_ops, bound_bytes),
                bound_by="operations" if bound_ops >= bound_bytes else "bytes",
            )
            log(
                f"K1 [{S},{A}] kernel {k_ms:.6f} ms  plain {p_ms:.6f} ms  "
                f"bound {timings[(S, A)]['bound_ms']:.6f} ms "
                f"({timings[(S, A)]['bound_by']})"
            )
        log(f"K1 {case:9s} [{S},{A}] ok, max abs err {err:.3e}, bit-identical repeat")
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
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": None,  # no single PyTorch call computes this pass
        "shape": [64, 1000],
        "at_256x50": timings[(256, 50)],
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
    output is (a matrix or a sum over A terms), and the function's work: the
    float32 operations per matrix entry and the bytes it must move (each
    input read once, each output written once)."""
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
             nbytes=lambda S, A, es: 2 * vec(S, A) + mat(S, A, es) + vec(S, A)),
        dict(name="divide_power_fused_with_mean", fn=mm.divide_power_fused_with_mean,
             plain=mm.divide_power_fused_with_mean_plain,
             args=lambda p2p, out, prev, dt: (p2p, out), outputs=("matrix", "mean"),
             replaces="p2pmicrogrid_tpu/ops/pallas_market.py:227", ops=12,
             nbytes=lambda S, A, es: 2 * mat(S, A, es) + 2 * vec(S, A)),
        dict(name="clear_market_fused", fn=mm.clear_market_fused,
             plain=mm.clear_market_fused_plain,
             args=lambda p2p, out, prev, dt: (p2p,), outputs=("rowsum", "rowsum"),
             replaces="p2pmicrogrid_tpu/ops/pallas_market.py:282", ops=10,
             nbytes=lambda S, A, es: mat(S, A, es) + 2 * vec(S, A)),
        dict(name="divide_power_fused", fn=mm.divide_power_fused,
             plain=mm.divide_power_fused_plain,
             args=lambda p2p, out, prev, dt: (p2p, out), outputs=("matrix",),
             replaces="p2pmicrogrid_tpu/ops/pallas_market.py:211", ops=10,
             nbytes=lambda S, A, es: 2 * mat(S, A, es) + vec(S, A)),
        dict(name="prep_mean", fn=mm.prep_mean, plain=mm.prep_mean_plain,
             args=lambda p2p, out, prev, dt: (p2p,), outputs=("colsum",),
             replaces="p2pmicrogrid_tpu/ops/pallas_market.py:194", ops=2,
             nbytes=lambda S, A, es: mat(S, A, es) + vec(S, A)),
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
    records, K5, K4, K6 (the matrix path) first."""
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(4321)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [
        (64, 1000, bf16), (64, 1000, f32), (256, 50, f32),
        (5, 257, bf16), (5, 257, f32), (3, 7, f32), (3, 7, bf16), (1, 50, f32), (2, 1, f32),
    ]
    timed = {(64, 1000, bf16): "main", (64, 1000, f32): "at_64x1000_f32", (256, 50, f32): "at_256x50"}
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
    for S, A, dt in cases:
        p2p, out, prev = matrix_inputs(S, A, dt, gen)
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
            where = timed.get((S, A, dt))
            if where is not None:
                k_ms = cuda_time_ms(lambda: sp["fn"](*args))
                p_ms = cuda_time_ms(lambda: sp["plain"](*args), iters=10)
                es = torch.finfo(dt).bits // 8
                bound_ops = sp["ops"] * S * A * A / PEAK_F32_FLOPS * 1e3
                bound_bytes = sp["nbytes"](S, A, es) / PEAK_BYTES_PER_S * 1e3
                t = dict(
                    ms=k_ms, plain_ms=p_ms, bound_ms=max(bound_ops, bound_bytes),
                    bound_by="operations" if bound_ops >= bound_bytes else "bytes",
                )
                if where == "main":
                    rec.update(t, shape=[S, A], dtype="bfloat16")
                else:
                    rec[where] = t
                log(
                    f"{sp['name']} [{S},{A}] {str(dt)[6:]} kernel {k_ms:.6f} ms  "
                    f"plain {p_ms:.6f} ms  bound {t['bound_ms']:.6f} ms ({t['bound_by']})"
                )
        log(f"matrix kernels [{S},{A}] {str(dt)[6:]} ok, bit-identical repeats")
    for rec in records.values():
        log(
            f"{rec['name']}: max abs err {rec['max_abs_err']:.3e}, bf16 matrix "
            f"entries that differ from the plain version {rec['bf16_entries_differ']}"
        )
    return [records[sp["name"]] for sp in specs]


# --- phase 3 ---------------------------------------------------------------


def small_config(tc, A, S, rounds, market_impl):
    return tc.default_config(
        sim=tc.SimConfig(n_agents=A, n_scenarios=S, rounds=rounds, market_impl=market_impl),
        battery=tc.BatteryConfig(enabled=True),
        train=tc.TrainConfig(implementation="tabular"),
    )


def run_slots(cfg, device, draws_np, ratings, n_episodes):
    """Per-slot actions and per-episode rewards of the port's slot loop."""
    import numpy as np
    import torch

    from p2pmicrogrid_tpu_torch.envs import community as com
    from p2pmicrogrid_tpu_torch.parallel import scenarios as sc
    from p2pmicrogrid_tpu_torch.train import make_policy

    S, A = cfg.sim.n_scenarios, cfg.sim.n_agents
    policy = make_policy(cfg)
    pol, _ = sc.init_shared_state(cfg, device=device)
    arrays = sc.stack_scenario_arrays(cfg, sc.make_scenario_traces(cfg, seed=0), ratings, device)
    xs = [x.transpose(0, 1) for x in arrays]
    ratings_d = com.ratings_to(ratings, device)
    actions, rewards = [], []
    for e in range(n_episodes):
        u, r, z = (torch.from_numpy(x).to(device) for x in draws_np[e])
        phys = com.init_physical(cfg, z, (S,), device=device)
        rew = torch.zeros(S, device=device)
        for t in range(xs[0].shape[0]):
            phys, _, out, tr = com.slot_dynamics_batched(
                cfg, policy, pol, phys, tuple(x[t] for x in xs), (u[t], r[t]),
                ratings_d, explore=True,
            )
            pol, _ = sc._tabular_update_shared(cfg, pol, tr)
            actions.append(tr.aux)
            rew += out.reward.mean(dim=-1)
        rewards.append(rew)
        pol = policy.decay(pol)
    return (
        torch.stack(actions).cpu().numpy(),
        torch.stack(rewards).cpu().numpy(),
        pol.q_table.cpu().numpy(),
    )


def phase_small_parity():
    import numpy as np

    from p2pmicrogrid_tpu_torch import config as tc
    from p2pmicrogrid_tpu_torch.envs.community import make_ratings

    A, S, E, T = 6, 3, 2, 96
    for rounds, market_impl in ((1, "factored"), (2, "matrix")):
        cfg = small_config(tc, A, S, rounds, market_impl)
        R = rounds + 1
        rng = np.random.default_rng(0)
        draws = [
            (
                rng.uniform(size=(T, R, S, A)).astype(np.float32),
                rng.integers(0, 3, (T, R, S, A)).astype(np.int64),
                rng.standard_normal((S, 2, A)).astype(np.float32),
            )
            for _ in range(E)
        ]
        ratings = make_ratings(cfg, np.random.default_rng(0))
        act_g, rew_g, q_g = run_slots(cfg, "cuda", draws, ratings, E)
        act_c, rew_c, q_c = run_slots(cfg, "cpu", draws, ratings, E)
        what = f"small path ({market_impl}, rounds={rounds})"
        if not np.isfinite(rew_g).all():
            fail(f"{what}: non-finite rewards on the card")
        if not np.array_equal(act_g, act_c):
            fail(f"{what}: {int((act_g != act_c).sum())} actions differ card vs CPU")
        if not np.allclose(rew_g, rew_c, rtol=2e-4, atol=0.0):
            fail(f"{what}: rewards differ card vs CPU: {rew_g} vs {rew_c}")
        if not np.allclose(q_g, q_c, rtol=1e-3, atol=1e-4):
            fail(f"{what}: Q-tables differ card vs CPU")
        rel = float(np.abs((rew_g - rew_c) / rew_c).max())
        log(
            f"phase 3: {what} A={A} S={S} card vs CPU: actions equal, max reward "
            f"rel err {rel:.3e}"
        )


# --- phase 4 ---------------------------------------------------------------


# (market, A, S, rounds, the kernels each slot launches once): the shipped
# default (rounds=1 -> factored, K1) and the reference's rounds comparison
# at rounds=2 (-> matrix: K5, K4, K6), at the north-star community size with
# BASELINE config 4's scenario count and at BASELINE config 3's shape.
MATRIX_PATH = ("divide_rank1_fused", "divide_power_fused_with_mean", "clear_market_fused")
MAIN_RUNS = (
    ("factored", 1000, 64, 1, ("merged_min_sums",)),
    ("factored", 50, 256, 1, ("merged_min_sums",)),
    ("matrix", 1000, 64, 2, MATRIX_PATH),
    ("matrix", 50, 256, 2, MATRIX_PATH),
)


def profiled_kernel_ms(kernels, T):
    """Device ms per call of each path kernel in one profiled episode of T
    slots. K5 and K4 each launch the column-mean reduce once per call, so
    each is charged one reduce per call."""
    def per_call(match):
        hits = [v for k, v in kernels.items() if match(k)]
        n = sum(c for c, _ in hits)
        return (sum(ms for _, ms in hits) / n if n else 0.0), n

    reduce_ms, _ = per_call(lambda k: "column_mean_kernel" in k)
    rank1 = lambda k: "true" in k or "(bool)1" in k  # K5's template flag
    k5, n5 = per_call(lambda k: "split_kernel" in k and rank1(k))
    k4, n4 = per_call(lambda k: "split_kernel" in k and not rank1(k))
    k6, n6 = per_call(lambda k: "clear_kernel" in k)
    k1 = sum(ms for k, (_, ms) in kernels.items() if "merged_min" in k) / T
    out = {"merged_min_sums": k1}  # both passes, one call per slot
    if n5:
        out["divide_rank1_fused"] = k5 + reduce_ms
    if n4:
        out["divide_power_fused_with_mean"] = k4 + reduce_ms
    if n6:
        out["clear_market_fused"] = k6
    return out


def phase_main_path(counters):
    """train_scenarios_shared at full width; returns each kernel's launches
    summed over the runs, and {kernel: {(S, A): device ms per call}}."""
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
    )
    from p2pmicrogrid_tpu_torch.train import make_policy

    totals = {name: 0 for name in counters}
    profiled = {name: {} for name in counters}
    for market, A, S, rounds, path_kernels in MAIN_RUNS:
        cfg = tc.default_config(
            sim=tc.SimConfig(n_agents=A, n_scenarios=S, rounds=rounds),
            battery=tc.BatteryConfig(enabled=True),
            train=tc.TrainConfig(implementation="tabular"),
        )
        impl = resolve_market_impl(cfg, "cuda")
        mdt = resolve_market_dtype(cfg, "cuda")
        what = f"main path {impl} rounds={rounds} A={A} S={S}"
        if impl != market:
            fail(f"{what}: market 'auto' resolved to {impl}, expected {market}")
        ratings = make_ratings(cfg, np.random.default_rng(cfg.train.seed))
        traces = make_scenario_traces(cfg, seed=cfg.train.seed)
        arrays = stack_scenario_arrays(cfg, traces, ratings, device="cuda")
        policy = make_policy(cfg)
        pol, scen = init_shared_state(cfg, device="cuda")
        gen = torch.Generator(device="cuda")
        gen.manual_seed(cfg.train.seed)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in counters.values():
            fn.launches = 0
        pol, scen, rew0, _, s0 = train_scenarios_shared(
            cfg, policy, pol, arrays, ratings, gen, 1, replay_s=scen, episode0=0
        )
        pol, scen, rew1, loss1, s1 = train_scenarios_shared(
            cfg, policy, pol, arrays, ratings, gen, 1, replay_s=scen, episode0=1
        )
        launches = {name: fn.launches for name, fn in counters.items()}
        peak = torch.cuda.max_memory_allocated()
        T = arrays.time.shape[1]
        rewards = np.concatenate([rew0, rew1])
        if rewards.shape != (2, S) or not np.isfinite(rewards).all():
            fail(f"{what}: rewards {rewards.shape} not finite")
        if not np.isfinite(loss1).all() or not torch.isfinite(pol.q_table).all():
            fail(f"{what}: non-finite loss or Q-table")
        expect_eps = cfg.qlearning.epsilon * cfg.qlearning.epsilon_decay
        if abs(float(pol.epsilon) - expect_eps) > 1e-6:
            fail(f"{what}: epsilon {float(pol.epsilon)} != {expect_eps}")
        # Two episodes: each kernel of the path once per slot, no other.
        expect = {name: (2 * T if name in path_kernels else 0) for name in counters}
        if launches != expect:
            fail(f"{what}: launches {launches}, expected {expect}")
        if market == "matrix" and mdt != ("bfloat16" if A >= 256 else "float32"):
            fail(f"{what}: market dtype {mdt}")
        for name, n in launches.items():
            totals[name] += n
        log(
            f"phase 4: {what} dtype={mdt} env-steps/s {S * T / s1:.1f} (timed "
            f"episode {s1:.4f} s, {s1 / T * 1e3:.3f} ms per slot, first episode "
            f"{s0:.4f} s) mean episode reward {rewards.mean(axis=1).tolist()} "
            f"launches {({k: v for k, v in launches.items() if v})} "
            f"peak device memory {peak / 2**30:.3f} GiB"
        )
        # A third episode, after the counts were read, under the profiler.
        kernels = profile_episode(
            lambda: train_scenarios_shared(
                cfg, policy, pol, arrays, ratings, gen, 1, replay_s=scen, episode0=2
            ),
            T,
            s1,
        )
        if kernels is not None:
            per_call = profiled_kernel_ms(kernels, T)
            for name in path_kernels:
                profiled[name][(S, A)] = per_call.get(name)
                log(f"  profile: {name} device time per call {per_call.get(name, 0) * 1e3:.3f} us")
        del pol, scen, arrays
        torch.cuda.empty_cache()
    return totals, profiled


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a CUDA device")
    import_port()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from p2pmicrogrid_tpu_torch.ops import matrix_market as mm
    from p2pmicrogrid_tpu_torch.ops.merged_min import merged_min_sums

    counters = {
        "merged_min_sums": merged_min_sums,
        "divide_rank1_fused": mm.divide_rank1_fused,
        "divide_power_fused_with_mean": mm.divide_power_fused_with_mean,
        "clear_market_fused": mm.clear_market_fused,
        "divide_power_fused": mm.divide_power_fused,
        "prep_mean": mm.prep_mean,
    }
    start = time.perf_counter()
    phase_device_and_build()
    records = [phase_kernels()] + phase_matrix_kernels()
    log(f"phase 2: kernels match their plain versions ({time.perf_counter() - start:.1f} s)")
    phase_small_parity()
    launches, profiled = phase_main_path(counters)
    on_path = {name for run in MAIN_RUNS for name in run[4]}
    for name in on_path:
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched on the main path")
    for rec in records:
        name = rec["name"]
        rec["launches"] = launches[name]
        rec["on_main_path"] = name in on_path
        # Device time per call from the main path's profiled episode (no
        # host time in it), where the profiler saw the device.
        if name in on_path:
            rec["profiled_ms"] = profiled[name].get((64, 1000))
            rec["at_256x50"]["profiled_ms"] = profiled[name].get((256, 50))
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
