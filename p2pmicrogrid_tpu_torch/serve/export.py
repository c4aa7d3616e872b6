"""Policy bundles: frozen, versioned greedy-parameter exports for serving.

The port of the JAX package's ``serve/export.py``, writing and reading the
same format. A training checkpoint (``train/checkpoint.py``) is the WHOLE
learner state; serving needs one parameter subtree of it (the Q-table, the
online Q-network, the deterministic actor). A *policy bundle* is that
subtree alone, next to a manifest that pins provenance (config hash, git
rev, implementation) and the serving contract (obs/action spec, community
size), so an engine can refuse mismatched inputs instead of mis-serving.

Layout of a bundle directory::

    <dir>/manifest.json   kind="policy_bundle", format_version, provenance,
                          obs/action spec, model arch fields
    <dir>/params.npz      flat '/'-joined flax paths -> arrays

The paths, shapes and manifest fields are the JAX package's (flax's
``Dense_i/kernel`` with ``[A, in, out]`` kernels per agent, ``[in, out]``
shared; ``convert.py::greedy_tree``), and ``config_hash`` is the same
function of the same config (``config.py`` is a copy), so a bundle written
by either package serves in the other. ``tools/check_artifacts_schema.py``
validates manifests.

int8 quantization (the numpy arithmetic below is the JAX package's, so the
scales and the repaired tables are equal bit for bit): each floating leaf
stores ``round(v / scale)`` clipped to [-127, 127] with ``scale = max|v| /
127`` (1.0 for all-zero leaves), scales in the manifest's ``quant.scales``.
Serving dequantizes to float32 at load, so the error lives in the
parameters only. The error-bound contract, recorded in
``quant.error_bound`` and enforced at export:

* discrete policies (tabular, dqn) serve the float32 bundle's greedy argmax
  bit for bit. Tabular by construction: every Q-table row's float32 winner
  is made the strict first-occurrence int winner. DQN cannot be repaired
  row-wise, so the export measures argmax agreement on a seeded calibration
  capture through the port's ``PolicyEngine`` and refuses on any flip.
* continuous actors (ddpg) get a measured ulp bound: the max float32-ulp
  distance between the f32 and dequantized actors' actions over the
  calibration capture must stay within ``ulp_budget``.

The measurement runs on the device the export is given (``"cuda"`` by
default, ``"cpu"`` when asked).

Recurrent bundles (``ddpg_recurrent``, ``models/ddpg_recurrent.py``) export
in float32 and float16 with the manifest's ``hidden_state`` block (the
per-agent flat carry the engine's session ring allocates, and its layout);
their architecture is read off the parameters. int8 is refused: its error
bound is measured on a stateless capture, and quantization error compounds
through the carry across a session.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Optional, Tuple

import numpy as np

from p2pmicrogrid_tpu_torch.convert import flat_tree, greedy_tree, nested_tree
from p2pmicrogrid_tpu_torch.device import resolve_device

BUNDLE_FORMAT_VERSION = 1
MANIFEST_FILE = "manifest.json"
PARAMS_FILE = "params.npz"

# The one parameter subtree each implementation's GREEDY path reads
# (tabular_act -> q_table; dqn_act -> online; ddpg / recurrent ddpg
# greedy -> actor).
GREEDY_FIELD = {
    "tabular": "q_table",
    "dqn": "online",
    "ddpg": "actor",
    "ddpg_recurrent": "actor",
}

# Implementations whose greedy decision reads cross-slot hidden state; their
# bundles carry a ``hidden_state`` manifest block.
RECURRENT_IMPLEMENTATIONS = ("ddpg_recurrent",)

# On-disk dtypes for floating leaves. bfloat16 is deliberately absent: numpy
# cannot persist it natively.
EXPORT_DTYPES = ("float32", "float16", "int8")

QUANT_SCHEME = "symmetric-per-leaf-int8"
# Default continuous-actor budget (the JAX package's): int8 weight noise
# through the 64-wide actors measures ~6e4 float32 ulps on the [0, 1]
# action range; the budget catches regressions (a mis-scaled leaf, a
# corrupted scale table), it does not promise float accuracy.
DEFAULT_ULP_BUDGET = float(2 ** 18)
CALIBRATION_OBS = 64
INT8_MAX = 127

OBS_SPEC = {
    "dim": 4,
    "features": ["time_norm", "norm_temp", "norm_balance", "p2p_mean"],
}


def greedy_params(implementation: str, pol_state):
    """The greedy parameter subtree of a learner state: a port state
    (``TabularState``, ``DQNState``, ``DDPGParams``, ``DDPGState``) or the
    raw field-keyed dict of a structure-free checkpoint read
    (``train/checkpoint.py::restore_raw``). The bare tabular table is
    wrapped as ``{"q_table": ...}`` so the npz leaf paths are never empty."""
    try:
        field = GREEDY_FIELD[implementation]
    except KeyError:
        raise ValueError(
            f"unknown implementation {implementation!r}; "
            f"expected one of {sorted(GREEDY_FIELD)}"
        ) from None
    if isinstance(pol_state, dict):
        node = pol_state.get(field)
    else:
        node = getattr(pol_state, field, None)
    if node is None:
        have = sorted(pol_state) if isinstance(pol_state, dict) else type(pol_state).__name__
        raise ValueError(
            f"state has no {field!r} subtree for implementation "
            f"{implementation!r} (got {have}); is this the right checkpoint?"
        )
    return {field: node} if implementation == "tabular" else node


def _model_spec(cfg, implementation: str, flat_params: dict) -> dict:
    """Architecture fields the engine needs to rebuild the greedy forward
    pass (bin counts for the tabular discretizer, hidden widths for the
    nets, the agent-shared flag for DDPG, read off the kernel's ndim)."""
    if implementation == "tabular":
        return {"qlearning": dataclasses.asdict(cfg.qlearning)}
    if implementation == "dqn":
        return {"hidden": cfg.dqn.hidden}
    if implementation == "ddpg_recurrent":
        # The recurrent actor is not cfg-parameterized: the shared LSTM
        # cell's gate bias width IS lstm_features, and the Dense widths pin
        # the trunk and the head.
        return {
            "actor": "recurrent_lstm",
            "hidden_pre": int(flat_params["Dense_0/bias"].shape[0]),
            "lstm_features": int(flat_params["OptimizedLSTMCell_0/hf/bias"].shape[0]),
            "hidden_post": int(flat_params["Dense_2/bias"].shape[0]),
        }
    kernel = flat_params.get("Dense_0/kernel")
    share = kernel is not None and kernel.ndim == 2
    return {"actor_hidden": cfg.ddpg.actor_hidden, "share_across_agents": share}


def _quantize_leaf(v: np.ndarray):
    """(int8 array, float scale) — symmetric per-leaf quantization."""
    scale = float(np.max(np.abs(v))) / INT8_MAX if v.size else 0.0
    if scale == 0.0:
        scale = 1.0
    q = np.clip(np.rint(v.astype(np.float64) / scale), -INT8_MAX, INT8_MAX)
    return q.astype(np.int8), scale


def _dequantize_leaf(q: np.ndarray, scale: float) -> np.ndarray:
    return q.astype(np.float32) * np.float32(scale)


def _repair_discrete_argmax(q: np.ndarray, f32: np.ndarray):
    """Make the int table's first-occurrence argmax equal the float32
    table's on EVERY row (trailing axis = actions), by construction.

    The float winner ``w`` must strictly beat every earlier action and
    tie-or-beat every later one. The repair raises ``q[w]`` to the smallest
    satisfying value (clipped at +127) and clamps violating neighbours down
    to it. Returns (repaired int8 array, rows repaired)."""
    k = q.shape[-1]
    qi = q.astype(np.int32)
    w = np.argmax(f32, axis=-1)
    deq_w = np.argmax(qi, axis=-1)
    n_bad = int((deq_w != w).sum())
    idx = np.arange(k)
    before = idx < w[..., None]
    after = idx > w[..., None]
    qw = np.take_along_axis(qi, w[..., None], axis=-1)[..., 0]
    max_before = np.max(np.where(before, qi, -INT8_MAX - 1), axis=-1)
    max_after = np.max(np.where(after, qi, -INT8_MAX - 1), axis=-1)
    qw_new = np.minimum(
        np.maximum(qw, np.maximum(max_before + 1, max_after)), INT8_MAX
    )
    qi = np.where(before, np.minimum(qi, (qw_new - 1)[..., None]), qi)
    qi = np.where(after, np.minimum(qi, qw_new[..., None]), qi)
    np.put_along_axis(qi, w[..., None], qw_new[..., None], axis=-1)
    return np.clip(qi, -INT8_MAX, INT8_MAX).astype(np.int8), n_bad


def _ulp_diff(a: np.ndarray, b: np.ndarray) -> float:
    """Max float32-ulp distance between two arrays (sign-magnitude ordered
    int32 representation — the standard total-order trick)."""

    def ordered(x):
        bits = np.ascontiguousarray(x, dtype=np.float32).view(np.int32)
        return np.where(bits < 0, np.int32(-2147483648) - bits, bits).astype(
            np.int64
        )

    if a.size == 0:
        return 0.0
    return float(np.max(np.abs(ordered(a) - ordered(b))))


def calibration_obs(n: int, n_agents: int, seed: int = 0) -> np.ndarray:
    """Seeded synthetic observation capture for quantization calibration:
    time in [0, 1), the normalized temp/balance/p2p features in [-1, 1] —
    the serving contract's obs ranges."""
    rng = np.random.default_rng(seed)
    time_ = rng.uniform(0.0, 1.0, (n, n_agents, 1))
    rest = rng.uniform(-1.0, 1.0, (n, n_agents, 3))
    return np.concatenate([time_, rest], axis=-1).astype(np.float32)


def _measure_quant_error(
    manifest: dict,
    flat_f32: dict,
    flat_deq: dict,
    ulp_budget: float,
    calib_seed: int,
    device,
) -> dict:
    """The error-bound block for an int8 manifest, measured through the
    serving forward on ``device``. Raises ValueError when the contract is
    violated: any greedy-argmax flip for a discrete policy, or a continuous
    actor exceeding its ulp budget."""
    from p2pmicrogrid_tpu_torch.serve.engine import PolicyEngine

    impl = manifest["implementation"]
    obs = calibration_obs(CALIBRATION_OBS, manifest["n_agents"], seed=calib_seed)
    act_f32, act_deq = (
        PolicyEngine(
            manifest=manifest, params=nested_tree(flat), max_batch=CALIBRATION_OBS,
            device=device,
        ).act(obs)
        for flat in (flat_f32, flat_deq)
    )
    max_abs_err = max(
        (float(np.max(np.abs(flat_deq[k] - flat_f32[k]))) if flat_f32[k].size else 0.0)
        for k in flat_f32
    ) if flat_f32 else 0.0

    if impl in ("tabular", "dqn"):
        flips = int((act_f32 != act_deq).sum())
        bound = {
            "kind": "discrete_argmax",
            "bit_exact_argmax": flips == 0,
            "argmax_check": "exhaustive+calibration" if impl == "tabular"
            else "calibration",
            "calibration": {"n_obs": CALIBRATION_OBS, "seed": calib_seed},
            "max_abs_err": max_abs_err,
        }
        if flips:
            raise ValueError(
                f"int8 export violates the discrete greedy contract: "
                f"{flips} calibration action(s) flipped vs float32 "
                f"({impl}; the quantized bundle must serve a bit-exact "
                "argmax — use float16/float32 for this checkpoint)"
            )
        return bound
    max_ulp = _ulp_diff(act_f32, act_deq)
    bound = {
        "kind": "continuous_ulp",
        "max_ulp": max_ulp,
        "ulp_budget": float(ulp_budget),
        "max_abs_action_err": float(np.max(np.abs(act_f32 - act_deq)))
        if act_f32.size else 0.0,
        "calibration": {"n_obs": CALIBRATION_OBS, "seed": calib_seed},
        "max_abs_err": max_abs_err,
    }
    if max_ulp > ulp_budget:
        raise ValueError(
            f"int8 export exceeds the continuous-actor error budget: "
            f"measured max ulp {max_ulp:.0f} > budget {ulp_budget:.0f} "
            "(raise ulp_budget explicitly if this precision is acceptable)"
        )
    return bound


def _hidden_state_spec(model: dict) -> dict:
    """The manifest ``hidden_state`` block of a recurrent bundle: the
    per-agent flat carry's shape and dtype, which the engine's session ring
    is sized from (never from the architecture fields), and its layout."""
    from p2pmicrogrid_tpu_torch.models.ddpg_recurrent import HIDDEN_LAYOUT, actor_hidden_dim

    return {
        "shape": [actor_hidden_dim(model["lstm_features"])],
        "dtype": "float32",
        "layout": list(HIDDEN_LAYOUT),
        "init": "zeros",
        "semantics": "per-agent flat LSTM carry (double shared-weight pass)",
    }


def _action_spec(implementation: str) -> dict:
    if implementation in ("tabular", "dqn"):
        return {
            "type": "discrete",
            "values": [0.0, 0.5, 1.0],  # models/dqn.py ACTION_VALUES
            "semantics": "heat-pump power fraction",
        }
    return {
        "type": "continuous",
        "low": 0.0,
        "high": 1.0,
        "semantics": "heat-pump power fraction",
    }


def export_policy_bundle(
    cfg,
    pol_state,
    out_dir: str,
    source: Optional[dict] = None,
    dtype: str = "float32",
    ulp_budget: float = DEFAULT_ULP_BUDGET,
    calibration_seed: int = 0,
    aot_buckets: Optional[list] = None,
    device="cuda",
) -> str:
    """Freeze ``pol_state``'s greedy parameters into a bundle at ``out_dir``.

    ``source`` (e.g. ``{"checkpoint": dir, "episode": n}``) is recorded
    verbatim in the manifest. ``dtype`` casts floating leaves on disk
    (``float16`` halves the bundle and quantizes the parameters silently —
    a float16 Q-table can collapse near-tied action values; ``int8``
    quarters it under the error-bound contract of this module's docstring,
    measured through ``PolicyEngine`` on ``device``).

    ``aot_buckets`` prepares those padding buckets ahead of traffic
    (``aot_compile_bundle``: each bucket's CUDA graph captured in a
    throwaway engine on ``device``) and records the buckets and their
    capture seconds in the manifest's ``aot`` block. Returns ``out_dir``.
    """
    from p2pmicrogrid_tpu_torch.telemetry.registry import config_hash, git_rev

    device = resolve_device(device)
    if dtype not in EXPORT_DTYPES:
        raise ValueError(f"dtype must be one of {EXPORT_DTYPES}, got {dtype!r}")
    impl = cfg.train.implementation
    if dtype == "int8" and impl in RECURRENT_IMPLEMENTATIONS:
        raise ValueError(
            "int8 export is not defined for recurrent actors: the ulp "
            "error-bound contract is measured on a stateless calibration "
            "capture, and quantization error COMPOUNDS through the hidden "
            "carry across a session — use float32 or float16"
        )
    flat_src = flat_tree(greedy_tree(greedy_params(impl, pol_state)))

    quant = None
    if dtype == "int8":
        flat_f32 = {
            k: (v.astype(np.float32) if np.issubdtype(v.dtype, np.floating) else v)
            for k, v in flat_src.items()
        }
        flat, scales = {}, {}
        for k, v in flat_f32.items():
            if not np.issubdtype(v.dtype, np.floating):
                flat[k] = v
                continue
            q, scale = _quantize_leaf(v)
            flat[k], scales[k] = q, scale
        n_repaired = 0
        if impl == "tabular":
            # Exhaustive argmax repair over the whole table: the greedy
            # contract holds for EVERY reachable observation, not just the
            # calibration capture.
            flat["q_table"], n_repaired = _repair_discrete_argmax(
                flat["q_table"], flat_f32["q_table"]
            )
        flat_deq = {
            k: (_dequantize_leaf(v, scales[k]) if k in scales else v)
            for k, v in flat.items()
        }
        manifest_stub = {
            "implementation": impl,
            "n_agents": cfg.sim.n_agents,
            "model": _model_spec(cfg, impl, flat_f32),
        }
        error_bound = _measure_quant_error(
            manifest_stub, flat_f32, flat_deq, ulp_budget, calibration_seed, device
        )
        if impl == "tabular":
            error_bound["rows_repaired"] = int(n_repaired)
        quant = {
            "scheme": QUANT_SCHEME,
            "scales": {k: float(s) for k, s in scales.items()},
            "error_bound": error_bound,
        }
    else:
        cast = np.dtype(dtype)
        flat = {
            k: (v.astype(cast) if np.issubdtype(v.dtype, np.floating) else v)
            for k, v in flat_src.items()
        }

    os.makedirs(out_dir, exist_ok=True)
    np.savez(os.path.join(out_dir, PARAMS_FILE), **flat)
    manifest = {
        "kind": "policy_bundle",
        "format_version": BUNDLE_FORMAT_VERSION,
        "created": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
        "implementation": impl,
        "n_agents": cfg.sim.n_agents,
        "setting": cfg.setting,
        "config_hash": config_hash(cfg),
        "git_rev": git_rev(),
        "dtype": dtype,
        "obs_spec": dict(OBS_SPEC),
        "action_spec": _action_spec(impl),
        "model": _model_spec(cfg, impl, flat),
        "params_file": PARAMS_FILE,
        "param_count": int(sum(v.size for v in flat.values())),
        "param_bytes": int(sum(v.nbytes for v in flat.values())),
        "source": source,
    }
    if quant is not None:
        manifest["quant"] = quant
    if impl in RECURRENT_IMPLEMENTATIONS:
        # The serving contract of a session-carrying policy: engines size
        # their hidden ring from this block, and the stateless microbatch
        # path refuses any bundle that carries one.
        manifest["hidden_state"] = _hidden_state_spec(manifest["model"])
    if aot_buckets:
        manifest["aot"] = aot_compile_bundle(manifest, flat, aot_buckets, device=device)
    with open(os.path.join(out_dir, MANIFEST_FILE), "w") as f:
        json.dump(manifest, f, indent=2)
    return out_dir


def _dequantize_flat(flat: dict, manifest: dict) -> dict:
    """Reconstruct float32 leaves from an int8 bundle's stored ints +
    manifest scales (identity for unquantized bundles)."""
    scales = (manifest.get("quant") or {}).get("scales") or {}
    return {
        k: (_dequantize_leaf(v, scales[k]) if k in scales else v)
        for k, v in flat.items()
    }


def aot_compile_bundle(
    manifest: dict, flat: dict, buckets: list, max_batch: int = 256, device="cuda"
) -> dict:
    """Prepare the bundle's padding buckets ahead of traffic: a throwaway
    ``PolicyEngine`` on ``device`` captures each bucket's CUDA graph and
    the capture seconds are recorded. Returns the manifest ``aot`` block:
    ``{"buckets", "max_batch", "capture_s": {bucket: seconds}, "device"}``.

    A CUDA graph holds the addresses of the parameters it was captured
    with, so graphs are not shared across engines (the JAX package shares
    its compiled programs process-wide): a serving engine captures its own
    at ``warmup``, and these seconds are what each such warmup costs. On
    the CPU nothing is captured and ``capture_s`` is empty."""
    from p2pmicrogrid_tpu_torch.serve.engine import PolicyEngine

    params = nested_tree(_dequantize_flat(flat, manifest))
    engine = PolicyEngine(
        manifest=manifest, params=params, max_batch=max_batch, device=device,
    )
    warmed = engine.warmup(sorted(set(int(b) for b in buckets)), include_step=False)
    return {
        "buckets": warmed,
        "max_batch": max_batch,
        "capture_s": {str(b): s for b, s in engine.capture_s.items()},
        "device": str(engine.device),
    }


def load_policy_bundle(bundle_dir: str, dequantize: bool = True) -> Tuple[dict, dict]:
    """(manifest, nested params dict of np arrays) from a bundle directory.

    int8 bundles are dequantized to float32 through the manifest's per-leaf
    scales by default; ``dequantize=False`` returns the raw stored ints.
    Refuses bundles written by a NEWER format version — fields this reader
    does not understand could change greedy semantics silently."""
    mpath = os.path.join(bundle_dir, MANIFEST_FILE)
    if not os.path.exists(mpath):
        raise FileNotFoundError(f"no {MANIFEST_FILE} under {bundle_dir}")
    with open(mpath) as f:
        manifest = json.load(f)
    if manifest.get("kind") != "policy_bundle":
        raise ValueError(
            f"{mpath} is not a policy bundle manifest "
            f"(kind={manifest.get('kind')!r})"
        )
    version = manifest.get("format_version")
    if not isinstance(version, int) or version > BUNDLE_FORMAT_VERSION:
        raise ValueError(
            f"bundle {bundle_dir} has format_version {version!r}; this "
            f"reader understands <= {BUNDLE_FORMAT_VERSION} — upgrade the "
            "serving code, do not guess at a newer format"
        )
    ppath = os.path.join(bundle_dir, manifest.get("params_file", PARAMS_FILE))
    with np.load(ppath) as z:
        flat = {k: z[k] for k in z.files}
    if dequantize:
        flat = _dequantize_flat(flat, manifest)
    return manifest, nested_tree(flat)


def export_bundle_from_checkpoint(
    cfg,
    ckpt_dir: str,
    out_dir: str,
    dtype: str = "float32",
    device="cuda",
) -> str:
    """Export the newest verified checkpoint step under ``ckpt_dir`` as a
    bundle, template-free: the step is read structure-free
    (``train/checkpoint.py::restore_raw``) and only the greedy subtree is
    touched."""
    from p2pmicrogrid_tpu_torch.train.checkpoint import restore_raw

    resolve_device(device)
    raw, episode, step_path = restore_raw(ckpt_dir)
    return export_policy_bundle(
        cfg,
        raw,
        out_dir,
        source={"checkpoint": os.path.abspath(step_path), "episode": episode},
        dtype=dtype,
        device=device,
    )
