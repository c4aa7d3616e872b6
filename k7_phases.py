"""Where kernel K7's device time goes: the time of each of its phases.

Run from the root of a checkout, with one CUDA device:

    python3 k7_phases.py

K7 (``p2pmicrogrid_tpu_torch/csrc/slot_fused.cu``) runs one slot as one
cooperative launch whose phases are separated by grid-wide barriers. This
script builds a copy of the kernel in which block 0 reads the device's
global timer at the start and after every barrier (and one more barrier
closes the last phase), launches it on the inputs of ``chip_smoke.py``'s
phase 2 (``slot_inputs``) for each case below, and prints one JSON object per
case: the phases by name with their microseconds, from the fourth of four
launches. The copy is built into ``p2pmicrogrid_tpu_torch/_build/`` and
changes nothing else; the extra barrier adds its own time (a few us) to the
total. The phases of a case follow the kernel's order: the battery rule and
features (with the tabular act of round 0), the DQN act of each round, the
factored round-1 mean feature or the matrix rounds, then the clearing.
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

# (label, implementation, S, A, rounds, market): K7's timed cases in
# chip_smoke.py phase 2, and the matrix variant at rounds 0 to 3.
CASES = (
    ("tabular factored bf16", "tabular", 64, 1000, 1, "factored"),
    ("tabular factored", "tabular", 256, 50, 1, "factored"),
    ("dqn factored bf16", "dqn", 64, 1000, 1, "factored"),
    ("tabular matrix rounds=0", "tabular", 64, 1000, 0, "matrix"),
    ("tabular matrix rounds=1", "tabular", 64, 1000, 1, "matrix"),
    ("tabular matrix rounds=2", "tabular", 64, 1000, 2, "matrix"),
    ("tabular matrix rounds=3", "tabular", 64, 1000, 3, "matrix"),
)

_STAMPS = '''
__device__ unsigned long long k7_stamps[64];
__device__ __forceinline__ void k7_stamp(int k) {
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    k7_stamps[k] = t;
  }
}
'''

_READ = '''
extern "C" int slot_fused_stamps(unsigned long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, k7_stamps, sizeof(k7_stamps)));
}
'''


def timed_source(src: str) -> str:
    """The kernel source with a timer read after every grid barrier."""
    head = "slot_fused_kernel(const __grid_constant__ Args g) {"
    k0 = src.index(head)
    k1 = src.index("\n}\n", k0) + 2
    body = src[k0:k1]
    body = body.replace("grid.sync();", "grid.sync(); k7_stamp(n_stamps++);")
    body = body.replace(
        "cg::grid_group grid = cg::this_grid();",
        "cg::grid_group grid = cg::this_grid();\n  int n_stamps = 0;\n  k7_stamp(n_stamps++);",
    )
    closing = "grid.sync(); k7_stamp(n_stamps++);"
    body = body.replace(
        "if (market == kNoTrading) return;", f"if (market == kNoTrading) {{ {closing} return; }}"
    )
    body = body[: body.rindex("}")] + f"  {closing}\n}}"
    marker = "// --- the kernel ---"
    src = src[:k0] + body + src[k1:]
    return src.replace(marker, _STAMPS + marker, 1) + _READ


def phase_names(impl: str, market, R: int):
    """The kernel's phases in order, as slot_fused_kernel runs them."""
    tabular = impl == "tabular"
    names = ["features" + (" + act 0" if tabular else "")]
    if not tabular:
        names.append("act 0" + (" + outputs" if market is None else ""))
    if market is None:
        return names
    rounds = range(1, R) if market == "matrix" else range(1, 2 if R == 2 else 1)
    for r in rounds:
        what = f"round {r} sums" if market == "matrix" else "mean feature"
        names.append(what + (f" + act {r}" if tabular else ""))
        if not tabular:
            names.append(f"act {r}")
    if market == "factored":
        names.append("merged min + outputs")
    else:
        names += ["clearing tiles", "clearing sums + outputs"]
    return names


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        print("k7_phases: FAIL: torch.cuda.is_available() is false", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from p2pmicrogrid_tpu_torch import config as tc
    from p2pmicrogrid_tpu_torch.ops import slot_fused as sf
    from p2pmicrogrid_tpu_torch.ops._build import BUILD_DIR, KernelLibrary

    out_dir = os.path.join(BUILD_DIR, "k7_phases")
    os.makedirs(out_dir, exist_ok=True)
    csrc = os.path.dirname(sf.LIBRARY.source)
    shutil.copy(os.path.join(csrc, "slot_ops.cuh"), out_dir)
    with open(sf.LIBRARY.source) as f:
        src = timed_source(f.read())
    with open(os.path.join(out_dir, "slot_fused_timed.cu"), "w") as f:
        f.write(src)
    lib = KernelLibrary("slot_fused_timed.cu", sf._configure)
    lib.source = os.path.join(out_dir, "slot_fused_timed.cu")
    sf.LIBRARY = lib
    cdll = lib.load()
    cdll.slot_fused_stamps.argtypes = [ctypes.c_void_p]
    cdll.slot_fused_stamps.restype = ctypes.c_int
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed", flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2468)
    for label, impl, S, A, rounds, market in CASES:
        cfg = cs.slot_config(tc, impl, S, A, rounds, market)
        args = cs.slot_inputs(cfg, gen)
        for _ in range(4):
            sf.slot_raw(cfg, *args)
        torch.cuda.synchronize()
        stamps = (ctypes.c_ulonglong * 64)()
        if cdll.slot_fused_stamps(stamps) != 0:
            print("k7_phases: FAIL: reading the timer stamps failed", file=sys.stderr)
            sys.exit(1)
        names = phase_names(impl, market, cfg.sim.rounds + 1 if market else 1)
        us = [(stamps[k + 1] - stamps[k]) / 1e3 for k in range(len(names))]
        print(json.dumps({
            "case": label, "shape": [S, A], "grid": sf.kernel_grid(cfg, S, A, market),
            "phases_us": dict(zip(names, us)), "total_us": sum(us),
        }), flush=True)
        del args
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
