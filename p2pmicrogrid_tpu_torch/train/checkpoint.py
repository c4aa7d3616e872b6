"""Crash-safe checkpoints of a learner state, with an integrity manifest.

The port of the JAX package's ``train/checkpoint.py``, with its durability
contract and its manifest, without Orbax. The unit of persistence is the
whole learner state, in the JAX package's tree layout
(``convert.state_to_numpy``: flax parameter trees, optax Adam states, rings),
written as one ``payload.npz`` whose keys are the leaves' '/'-joined paths.

* **Steps and payload.** One directory ``ep_<episode>`` a step, holding
  ``payload.npz`` (``pol_state/...``, ``episode`` and, where there is one,
  ``rng_key``: a ``torch.Generator``'s ``get_state()`` as uint8, where the
  JAX package keeps its key) and ``p2p_manifest.json``.
* **Manifest.** The JAX package's fields: the leaf spec and content digest
  (``tree_digest``, the same function, so a state digests as the JAX
  package's does), ``config_hash``, ``git_rev``, the episode, the RNG state
  and JSON ``extra`` (the health monitor's record, ...).
* **Atomic saves.** Temp directory → read-back digest check → manifest →
  fsync → rename → prune (``keep_last`` newest steps; steps of a higher
  episode, left by an earlier and longer run, always go). A kill at any
  instant leaves at least one step that verifies.
* **Verified restores.** ``latest_checkpoint``, ``verify_checkpoint``,
  ``restore_checkpoint``, ``restore_resume_state``: corrupt, incomplete or
  malformed steps are skipped with a warning, and the restore falls back to
  the newest step that verifies; ``CheckpointCorrupt`` when none does.
* **Raw reads.** ``restore_raw`` reads the newest step that verifies
  without a template: the saved state as a nested dict of numpy arrays,
  which is all a policy bundle's export needs (``serve/export.py``).
* **Restores write in place.** A restore copies the saved values into the
  tensors of the state it is given (``convert.load_state_``), so a captured
  CUDA graph and a capturable Adam's on-device step counts keep reading the
  same memory.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import time
import warnings
import zipfile
from typing import NamedTuple, Optional, Tuple

import numpy as np

MANIFEST_NAME = "p2p_manifest.json"
MANIFEST_FORMAT_VERSION = 1
PAYLOAD_NAME = "payload.npz"
_TMP_PREFIX = "_tmp_ep_"


class CheckpointCorrupt(RuntimeError):
    """A step failed integrity verification (digest/manifest/readability)."""


def checkpoint_dir(base_dir: str, setting: str, implementation: str) -> str:
    """``models_{impl}/{setting}``, the reference's layout (rl.py:84-87)."""
    return os.path.join(
        os.path.abspath(base_dir), f"models_{implementation}", setting.replace("-", "_")
    )


# --- content digest ----------------------------------------------------------


def _plain(tree):
    """A payload tree as nested ``{str: ... | np.ndarray}``: NamedTuples by
    field, tuples by index, ``None`` and empty containers as ``{}`` (the
    JAX package's normal form, so the digests agree)."""
    if tree is None:
        return {}
    fields = getattr(tree, "_fields", None)
    if fields is not None:
        return {f: _plain(getattr(tree, f)) for f in fields}
    if isinstance(tree, dict):
        return {str(k): _plain(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): _plain(v) for i, v in enumerate(tree)}
    return np.asarray(tree)


def _walk_leaves(plain, path=""):
    if isinstance(plain, dict):
        for k in sorted(plain):
            yield from _walk_leaves(plain[k], f"{path}/{k}" if path else k)
    else:
        yield path, plain


def tree_digest(payload) -> Tuple[str, dict]:
    """sha256 content digest + shape/dtype spec of a payload tree.

    Leaves are hashed in sorted-path order as (path, dtype, shape, bytes):
    two payloads digest equal iff every leaf is bit-identical. Returns
    ``("sha256:<hex>", {path: {"shape": [...], "dtype": str}})``.
    """
    h = hashlib.sha256()
    spec: dict = {}
    for path, leaf in _walk_leaves(_plain(payload)):
        arr = np.ascontiguousarray(leaf)
        spec[path] = {"shape": list(arr.shape), "dtype": str(arr.dtype)}
        h.update(path.encode())
        h.update(str(arr.dtype).encode())
        h.update(str(arr.shape).encode())
        h.update(arr.tobytes())
    return f"sha256:{h.hexdigest()}", spec


def _nest(flat: dict) -> dict:
    """{'a/b/c': leaf} as {'a': {'b': {'c': leaf}}}."""
    out: dict = {}
    for path, leaf in flat.items():
        node = out
        *parents, last = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return out


# --- fsync helpers (best-effort on filesystems without dir fsync) ------------


def _fsync_file(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _fsync_dir(path: str) -> None:
    _fsync_file(path)


def _fsync_tree(root: str) -> None:
    for dirpath, _dirnames, filenames in os.walk(root):
        for f in filenames:
            _fsync_file(os.path.join(dirpath, f))
        _fsync_dir(dirpath)


# --- payload files -------------------------------------------------------------


def _write_payload(step_path: str, payload: dict) -> None:
    flat = dict(_walk_leaves(_plain(payload)))
    with open(os.path.join(step_path, PAYLOAD_NAME), "wb") as f:
        np.savez(f, **flat)


def _read_payload(step_path: str) -> dict:
    """The step's payload as a nested dict of numpy leaves; raises
    ``CheckpointCorrupt`` when it cannot be read."""
    try:
        with np.load(os.path.join(step_path, PAYLOAD_NAME), allow_pickle=False) as z:
            flat = {k: z[k] for k in z.files}
    except (OSError, ValueError, EOFError, KeyError, zipfile.BadZipFile) as err:
        raise CheckpointCorrupt(f"{step_path}: payload unreadable ({err})")
    return _nest(flat)


# --- manifest ----------------------------------------------------------------


def load_manifest(step_path: str) -> Optional[dict]:
    """The step's integrity manifest, or None when it has none. Raises
    ``CheckpointCorrupt`` on an unreadable or alien manifest."""
    mpath = os.path.join(step_path, MANIFEST_NAME)
    if not os.path.exists(mpath):
        return None
    try:
        with open(mpath) as f:
            m = json.load(f)
    except (OSError, json.JSONDecodeError) as err:
        raise CheckpointCorrupt(f"{step_path}: unreadable manifest ({err})")
    if not isinstance(m, dict) or m.get("kind") != "checkpoint_manifest":
        raise CheckpointCorrupt(f"{step_path}: {MANIFEST_NAME} is not a checkpoint manifest")
    return m


def _verify_step(step_path: str) -> Tuple[dict, dict]:
    """``(manifest, raw_payload)`` after full verification of one step: the
    payload read back from disk, its digest recomputed and compared with the
    manifest's. The port writes every step with a manifest, so a step
    without one is incomplete. Raises ``CheckpointCorrupt``."""
    manifest = load_manifest(step_path)
    if manifest is None:
        raise CheckpointCorrupt(f"{step_path}: no {MANIFEST_NAME} (incomplete step)")
    raw = _read_payload(step_path)
    digest, _ = tree_digest(raw)
    expected = manifest.get("digest")
    if digest != expected:
        raise CheckpointCorrupt(
            f"{step_path}: content digest mismatch (manifest {expected}, disk {digest}) — "
            "corrupted or partially-written step"
        )
    if int(manifest.get("episode", -1)) != int(np.asarray(raw.get("episode", -2))):
        raise CheckpointCorrupt(
            f"{step_path}: manifest episode {manifest.get('episode')} != payload episode "
            f"{raw.get('episode')}"
        )
    return manifest, raw


def verify_checkpoint(step_path: str) -> dict:
    """Full integrity verification of one step directory; returns its
    manifest. Raises ``CheckpointCorrupt``."""
    return _verify_step(step_path)[0]


# --- step listing ------------------------------------------------------------


def _steps_newest_first(path: str):
    """``(episode, step_path)`` for every well-formed ``ep_*`` directory,
    newest first; malformed names are skipped with a warning."""
    if not os.path.isdir(path):
        return []
    steps = []
    for d in os.listdir(path):
        if not d.startswith("ep_"):
            continue
        try:
            ep = int(d.split("_", 1)[1])
        except (IndexError, ValueError):
            warnings.warn(
                f"skipping malformed checkpoint entry {d!r} under {path} "
                "(not an ep_<int> step directory)",
                stacklevel=3,
            )
            continue
        steps.append((ep, os.path.join(path, d)))
    steps.sort(key=lambda t: t[0], reverse=True)
    return steps


def _verified_steps(path: str):
    """``(episode, step_path, manifest, raw)`` newest first over the steps
    that verify; the others are skipped with a warning."""
    for ep, step in _steps_newest_first(path):
        try:
            manifest, raw = _verify_step(step)
        except CheckpointCorrupt as err:
            warnings.warn(
                f"skipping corrupt checkpoint step: {err} — falling back to the next newest step",
                stacklevel=3,
            )
            continue
        yield ep, step, manifest, raw


def latest_checkpoint(path: str, verify: bool = True) -> Optional[str]:
    """Newest restorable step under ``path``, or None; ``verify=False``
    lists by name only."""
    if verify:
        for _ep, step, _m, _raw in _verified_steps(path):
            return step
        return None
    steps = _steps_newest_first(path)
    return steps[0][1] if steps else None


# --- save --------------------------------------------------------------------


def _np_state(pol_state):
    """A port state in the JAX package's tree layout; numpy trees pass."""
    import torch

    from p2pmicrogrid_tpu_torch.convert import state_to_numpy

    items = pol_state if isinstance(pol_state, tuple) else (pol_state,)
    if any(isinstance(x, (torch.Tensor, torch.nn.Module)) for x in items):
        return state_to_numpy(pol_state)
    return pol_state


def save_checkpoint(
    path: str,
    pol_state,
    episode: int,
    keep_old: bool = False,
    rng_key=None,
    extra: Optional[dict] = None,
    cfg=None,
    keep_last: int = 2,
) -> str:
    """Atomically write the learner state and episode; returns the step
    path.

    Write to a temp directory → read back and compare digests → manifest →
    fsync → rename → prune. The older steps are pruned only after the new
    one verified and is in place. ``rng_key`` (a ``torch.Generator``'s
    ``get_state()`` at this episode boundary) and ``extra`` (JSON resume
    state) make the step exactly resumable (``restore_resume_state``);
    ``cfg`` stamps ``config_hash`` and ``git_rev``. ``keep_last`` newest steps
    survive (default 2: this one and a fallback); ``keep_old`` keeps all.
    Steps of a higher episode than this one are always pruned.
    """
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    step_name = f"ep_{episode}"
    step_path = os.path.join(path, step_name)
    tmp_path = os.path.join(path, f"{_TMP_PREFIX}{episode}_{os.getpid()}")

    # Temp directories of crashed saves: this process's, and any an hour
    # stale (a concurrent saver's in-flight temp is left alone).
    for d in os.listdir(path):
        if not d.startswith(_TMP_PREFIX):
            continue
        p = os.path.join(path, d)
        stale = d.endswith(f"_{os.getpid()}")
        if not stale:
            try:
                stale = time.time() - os.path.getmtime(p) > 3600.0
            except OSError:
                pass
        if stale:
            shutil.rmtree(p, ignore_errors=True)

    payload = {"pol_state": _np_state(pol_state), "episode": np.asarray(episode)}
    rng = None
    if rng_key is not None:
        rng = np.asarray(rng_key.cpu() if hasattr(rng_key, "cpu") else rng_key)
        payload["rng_key"] = rng
    digest, spec = tree_digest(payload)

    os.makedirs(tmp_path, exist_ok=True)
    _write_payload(tmp_path, payload)
    _verify_readback(tmp_path, digest)

    manifest = {
        "kind": "checkpoint_manifest",
        "format_version": MANIFEST_FORMAT_VERSION,
        "episode": int(episode),
        "payload_keys": sorted(payload),
        "rng_key": None if rng is None else rng.tolist(),
        "digest": digest,
        "tree": spec,
        "config_hash": None,
        "git_rev": None,
        "extra": extra or {},
    }
    if cfg is not None:
        from p2pmicrogrid_tpu_torch.telemetry.registry import config_hash, git_rev

        manifest["config_hash"] = config_hash(cfg)
        manifest["git_rev"] = git_rev()
    with open(os.path.join(tmp_path, MANIFEST_NAME), "w") as f:
        json.dump(manifest, f, indent=1)
        f.flush()
        try:
            os.fsync(f.fileno())
        except OSError:
            pass
    _fsync_tree(tmp_path)

    if os.path.exists(step_path):
        shutil.rmtree(step_path, ignore_errors=True)
    os.rename(tmp_path, step_path)
    _fsync_file(path)

    survivors = {step_name}
    kept_older = 0
    for ep, step in _steps_newest_first(path):
        if os.path.basename(step) in survivors:
            continue
        if ep > episode:
            shutil.rmtree(step, ignore_errors=True)
            continue
        if keep_old or kept_older < max(keep_last, 1) - 1:
            kept_older += 1
            continue
        shutil.rmtree(step, ignore_errors=True)
    return step_path


def _verify_readback(tmp_path: str, expected_digest: str) -> None:
    """Read the just-written step back from disk and compare digests (the
    write barrier the prune waits on)."""
    try:
        raw = _read_payload(tmp_path)
    except CheckpointCorrupt as err:
        shutil.rmtree(tmp_path, ignore_errors=True)
        raise CheckpointCorrupt(
            f"checkpoint write verification failed: {err}; previous checkpoints left untouched"
        )
    got, _ = tree_digest(raw)
    if got != expected_digest:
        shutil.rmtree(tmp_path, ignore_errors=True)
        raise CheckpointCorrupt(
            f"checkpoint write verification failed: read-back digest {got} != in-memory "
            f"{expected_digest}; previous checkpoints left untouched"
        )


# --- restore -----------------------------------------------------------------


def _rebuild(template, node, path: str):
    """``template`` (a numpy tree of NamedTuples, dicts and tuples) with
    its leaves taken from the nested dict ``node``; a leaf that is missing,
    or of another shape or dtype, raises."""
    if isinstance(template, dict):
        keys, items = list(template), list(template.values())
    elif isinstance(template, tuple):
        keys = list(getattr(template, "_fields", range(len(template))))
        items = list(template)
    else:
        arr = None if isinstance(node, dict) else np.asarray(node)
        tpl = np.asarray(template)
        if arr is None or arr.shape != tpl.shape or arr.dtype != tpl.dtype:
            got = "missing" if arr is None else f"{arr.dtype}{list(arr.shape)}"
            raise RuntimeError(f"checkpoint: {path} is {got}, the state holds {tpl.dtype}{list(tpl.shape)}")
        return arr
    if not isinstance(node, dict):
        raise RuntimeError(f"checkpoint: {path} is a leaf, the state holds a tree")
    built = [_rebuild(t, node.get(str(k), {}), f"{path}/{k}") for t, k in zip(items, keys)]
    if isinstance(template, dict):
        return dict(zip(keys, built))
    return type(template)(*built) if hasattr(template, "_fields") else type(template)(built)


def _restore_into(step_path: str, template_pol_state, raw: dict):
    """Load a verified step's state into ``template_pol_state`` in place."""
    from p2pmicrogrid_tpu_torch.convert import load_state_

    if "pol_state" not in raw:
        raise RuntimeError(f"checkpoint {step_path} has no 'pol_state' tree (keys: {sorted(raw)})")
    np_tree = _rebuild(_np_state(template_pol_state), raw["pol_state"], "pol_state")
    return load_state_(template_pol_state, np_tree)


class ResumeState(NamedTuple):
    """Everything a checkpoint knows, for exact resume (train/resilience.py)."""

    pol_state: object
    episode: int
    rng_key: Optional[np.ndarray]   # the generator's state (uint8), or None
    extra: dict                     # JSON extra state (health record, ...)
    step_path: str
    manifest: Optional[dict]


def restore_resume_state(path: str, template_pol_state) -> ResumeState:
    """The newest verified step under ``path``, loaded into
    ``template_pol_state`` in place, with the generator state and the
    manifest's ``extra``. Falls back past corrupt steps with a warning;
    raises ``FileNotFoundError`` when no step exists and ``CheckpointCorrupt``
    when steps exist but none verifies."""
    any_step = bool(_steps_newest_first(path))
    for _ep, step, manifest, raw in _verified_steps(path):
        pol_state = _restore_into(step, template_pol_state, raw)
        rng_key = raw.get("rng_key")
        return ResumeState(
            pol_state=pol_state,
            episode=int(raw["episode"]),
            rng_key=None if rng_key is None else np.asarray(rng_key),
            extra=(manifest or {}).get("extra") or {},
            step_path=step,
            manifest=manifest,
        )
    if any_step:
        raise CheckpointCorrupt(f"no checkpoint step under {path} verifies")
    raise FileNotFoundError(f"no restorable checkpoint under {path}")


def restore_raw(path: str) -> Tuple[dict, int, str]:
    """Structure-free read of the newest verified step under ``path``:
    ``(pol_state as a nested dict of numpy arrays keyed by field, episode,
    step_path)``, with no learner state built (no optimiser, ring or target
    network). Corrupt steps are skipped with a warning, as
    ``restore_checkpoint`` skips them; raises ``FileNotFoundError`` when no
    step verifies."""
    for _ep, step, _manifest, raw in _verified_steps(path):
        if "pol_state" not in raw:
            raise RuntimeError(f"checkpoint {step} has no 'pol_state' tree (keys: {sorted(raw)})")
        return raw["pol_state"], int(raw["episode"]), step
    raise FileNotFoundError(f"no restorable checkpoint under {path}")


def restore_checkpoint(path: str, template_pol_state) -> Tuple[object, int]:
    """``(pol_state, episode)`` of the newest verified step, loaded into
    ``template_pol_state`` in place (``restore_resume_state``)."""
    st = restore_resume_state(path, template_pol_state)
    return st.pol_state, st.episode
