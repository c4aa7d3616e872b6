"""Continual training: fine-tune the live bundle on fresh serve traces.

The port of the JAX package's ``train/continual.py``, the training half of
the flywheel. Production policies go stale as load/PV/price regimes drift;
the warehouse records every decision the live bundle made
(``data/trace_export.py``); this module turns those decisions back into a
CANDIDATE bundle:

1. **Warm start from the incumbent.** A policy bundle freezes only the
   greedy subtree (``serve/export.py``), so ``state_from_bundle`` rebuilds a
   full learner state around it: fresh optimizer/replay/exploration
   scaffolding, the bundle's greedy parameters copied in place into the
   state's tensors (DQN/DDPG targets hard-copied from the grafted
   online/actor — fine-tuning must not bootstrap against random targets).
   The copy is in place because a captured CUDA graph holds the addresses
   of the tensors it read: rebinding them would leave a graph training the
   old weights.
2. **Off-policy pretraining on the traces.** ``offpolicy_pretrain`` runs
   TD/Bellman/actor-critic steps on minibatches sampled from the exported
   transitions, through the SAME update rules the per-slot learners use
   (``models/tabular.py::tabular_update``, ``models/dqn.py::apply_td_update``,
   ``models/ddpg.py::ddpg_learn_batch``). Every minibatch index is drawn up
   front, ``[steps, b]`` on the run's device (or injected: the tests pass
   the JAX key chain's ``jax.random.randint`` draws), the loop reads
   nothing back until the phase ends, and on the card one step is a CUDA
   graph replayed for every step, the counterpart of the JAX package's
   single ``lax.scan``.
3. **Chunked simulator fine-tune under the guard.** ``train_continual``
   then runs the chunk graph through ``train_chunked_with_rollback``: the
   divergence guard trips on non-finite counters or basin verdicts, rollback
   restores the last verified checkpoint with dropped learning rates on a
   fresh stream — a continually-retrained candidate can never emerge from a
   diverged run.
4. **Candidate export.** The result freezes into a bundle whose config
   carries a bumped ``train.starting_episodes`` (continual generations
   CONTINUE the episode count), giving the candidate a ``config_hash``
   distinct from the incumbent's — the registry/canary routing key — with
   full provenance (incumbent hash, trace window, rollbacks) in the
   manifest ``source``.

Nothing here pushes traffic: the candidate must pass the promotion gate and
canary (``serve/promotion.py``) before a household ever sees it.
"""

from __future__ import annotations

import dataclasses
import os
import time
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

from p2pmicrogrid_tpu_torch.device import resolve_device
from p2pmicrogrid_tpu_torch.train.resilience import GuardPolicy, RollbackRecord


@dataclass
class ContinualResult:
    """What one continual-training run produced. ``phase_seconds`` holds
    the host seconds of each phase (``pretrain``, ``fine_tune``,
    ``export``), each ending in a device sync."""

    candidate_dir: str
    candidate_hash: str
    incumbent_hash: Optional[str]
    episode0: int
    episodes: int
    trace_steps: int
    trace_loss_final: Optional[float]
    trace_summary: dict = field(default_factory=dict)
    rollbacks: List[RollbackRecord] = field(default_factory=list)
    phase_seconds: dict = field(default_factory=dict)

    def summary(self) -> dict:
        return {
            "candidate_dir": self.candidate_dir,
            "candidate_hash": self.candidate_hash,
            "incumbent_hash": self.incumbent_hash,
            "episode0": self.episode0,
            "episodes": self.episodes,
            "trace_steps": self.trace_steps,
            "trace_loss_final": self.trace_loss_final,
            "rollbacks": len(self.rollbacks),
            **{f"trace_{k}": v for k, v in self.trace_summary.items()},
        }


def _check_bundle_matches(cfg, manifest: dict) -> None:
    impl = manifest.get("implementation")
    if impl != cfg.train.implementation:
        raise ValueError(
            f"bundle implements {impl!r} but the config trains "
            f"{cfg.train.implementation!r} — continual training must "
            "fine-tune the SAME policy class it serves"
        )
    n_agents = manifest.get("n_agents")
    if n_agents != cfg.sim.n_agents:
        raise ValueError(
            f"bundle serves {n_agents} agents but the config simulates "
            f"{cfg.sim.n_agents}"
        )


def _copy_net_(dst: torch.nn.Module, src: torch.nn.Module) -> None:
    with torch.no_grad():
        for d, s in zip(dst.parameters(), src.parameters()):
            d.copy_(s)


def state_from_bundle(
    cfg,
    manifest: dict,
    params: dict,
    generator: Optional[torch.Generator] = None,
    device="cuda",
    into=None,
):
    """Full shared learner state (what the chunked trainer carries —
    ``parallel/scenarios.py::init_shared_pol_state``) warm-started from a
    bundle's greedy subtree (``load_policy_bundle``'s nested numpy tree).
    Fresh optimizer/exploration scaffolding drawn from ``generator``;
    bootstrap targets hard-copied from the grafted parameters. DDPG's critic
    stays fresh from init (it was never exported).

    Every graft is a ``copy_`` into the state's own tensors. ``into`` (a
    state of the same config) receives the graft in place of a fresh state:
    its greedy subtree and targets are overwritten, the rest is kept — the
    way one evaluation serves several bundles."""
    from p2pmicrogrid_tpu_torch.convert import _load_net_
    from p2pmicrogrid_tpu_torch.parallel.scenarios import init_shared_pol_state

    _check_bundle_matches(cfg, manifest)
    impl = cfg.train.implementation
    state = into if into is not None else init_shared_pol_state(cfg, device, generator)
    if impl == "tabular":
        q = np.asarray(params["q_table"], dtype=np.float32)
        if tuple(q.shape) != tuple(state.q_table.shape):
            raise ValueError(
                f"bundle q_table {q.shape} != config table "
                f"{tuple(state.q_table.shape)}"
            )
        state.q_table.copy_(torch.from_numpy(q))
        return state
    f32 = lambda tree: {  # noqa: E731
        k: f32(v) if isinstance(v, dict) else np.asarray(v, dtype=np.float32)
        for k, v in tree.items()
    }
    if impl == "dqn":
        online = f32(params)
        _load_net_(state.online, online)
        _load_net_(state.target, online)
        return state
    # ddpg: the bundle is the actor; the critic trains fresh from init,
    # targets copy their live twins.
    share = bool(manifest.get("model", {}).get("share_across_agents"))
    if share != bool(cfg.ddpg.share_across_agents):
        raise ValueError(
            f"bundle share_across_agents={share} but config says "
            f"{cfg.ddpg.share_across_agents}"
        )
    actor = f32(params)
    _load_net_(state.actor, actor)
    _load_net_(state.actor_target, actor)
    _copy_net_(state.critic_target, state.critic)
    return state


def _frac_to_action_index(frac: torch.Tensor) -> torch.Tensor:
    """Served hp fractions {0.0, 0.5, 1.0} back to the discrete action
    index (``models/dqn.py::ACTION_VALUES``); nearest bin, so a float16
    bundle's quantized fractions still map correctly. ``torch.round``
    rounds half to even, as ``jnp.round`` does."""
    return torch.clamp(torch.round(frac * 2.0), 0, 2).to(torch.int64)


def trace_batch_size(cfg, n_transitions: int, batch_size: Optional[int] = None) -> int:
    """Transitions per off-policy step: ``batch_size``, else 32 (tabular)
    or the learner's batch size, at most the dataset's size."""
    impl = cfg.train.implementation
    default = {"tabular": 32, "dqn": cfg.dqn.batch_size, "ddpg": cfg.ddpg.batch_size}
    if impl not in default:
        raise ValueError(f"unknown implementation {impl!r}")
    return min(batch_size or default[impl], n_transitions)


def make_trace_update_fn(cfg, dataset, batch_size: Optional[int] = None, device="cuda"):
    """One-step off-policy update over the trace transitions.

    Returns ``update(pol_state, idx) -> (pol_state, loss)``: ``idx`` [b]
    int64 transition indices on the device (``trace_batch_size``), ``loss``
    a 0-d device tensor. The dataset is copied to the device once. Each step
    applies the implementation's OWN learn rule in place — there is exactly
    one copy of the update semantics in the port and this reuses it. Nothing
    in a step reads the device from the host."""
    dev = resolve_device(device)
    impl = cfg.train.implementation
    put = lambda x: torch.as_tensor(np.asarray(x, dtype=np.float32), device=dev)  # noqa: E731
    obs, action = put(dataset.obs), put(dataset.action)          # [N, A, 4], [N, A]
    reward, next_obs = put(dataset.reward), put(dataset.next_obs)

    if impl == "tabular":
        from p2pmicrogrid_tpu_torch.models.tabular import tabular_update

        act_idx = _frac_to_action_index(action)
        zero = torch.zeros((), device=dev)

        def update(state, idx):
            s, a, r, ns = obs[idx], act_idx[idx], reward[idx], next_obs[idx]
            for k in range(idx.shape[0]):  # b dependent updates, in order
                state = tabular_update(cfg.qlearning, state, s[k], a[k], r[k], ns[k])
            return state, zero

        return update

    if impl == "dqn":
        from p2pmicrogrid_tpu_torch.models.dqn import _td_loss, action_values_on, apply_td_update

        act_frac = action_values_on(dev)[_frac_to_action_index(action)][..., None]  # [N, A, 1]

        def update(state, idx):
            # [B, A, ...] -> per-agent batches [A, B, ...].
            s, a = obs[idx].transpose(0, 1), act_frac[idx].transpose(0, 1)
            r, ns = reward[idx].transpose(0, 1), next_obs[idx].transpose(0, 1)
            loss, _ = apply_td_update(
                cfg.dqn,
                lambda: _td_loss(cfg.dqn, state.online, state.target, s, a, r, ns),
                state.online, state.target, state.opt_state,
            )
            return state, loss.mean()

        return update

    if impl == "ddpg":
        from p2pmicrogrid_tpu_torch.models.ddpg import adam_count, ddpg_learn_batch

        act_col = action[..., None]  # [N, A, 1]
        delay = cfg.ddpg.actor_delay_updates
        # The critic's step count, kept on the host: the actor-delay rule
        # reads it after each critic step, and reading the capturable Adam's
        # device count would wait for the device every step.
        count = [None]

        def update(params, idx):
            if count[0] is None:
                count[0] = adam_count(params.critic_opt)
            count[0] += 1
            s, a, r, ns = obs[idx], act_col[idx], reward[idx], next_obs[idx]  # [B, A, ...]
            if cfg.ddpg.share_across_agents:
                flat = lambda x: x.reshape((-1,) + x.shape[2:])  # noqa: E731
                s, a, r, ns = flat(s), flat(a), flat(r), flat(ns)
            else:
                s, a, r, ns = (x.transpose(0, 1) for x in (s, a, r, ns))  # [A, B, ...]
            sq = ddpg_learn_batch(
                cfg.ddpg, params, s, a, r, ns, actor_step=delay <= 0 or count[0] >= delay
            )
            return params, sq.mean()

        return update

    raise ValueError(f"unknown implementation {impl!r}")


def trace_indices(
    n_transitions: int, steps: int, b: int, generator: Optional[torch.Generator], device="cuda"
) -> torch.Tensor:
    """Every step's minibatch, drawn up front: ``[steps, b]`` int64 uniform
    in ``[0, n_transitions)`` from ``generator`` on ``device`` (the JAX
    package draws ``jax.random.randint(k, (b,), 0, n)`` per step key)."""
    return torch.randint(0, n_transitions, (steps, b), generator=generator, device=resolve_device(device))


def offpolicy_pretrain(
    cfg,
    pol_state,
    dataset,
    generator: Optional[torch.Generator],
    steps: int,
    batch_size: Optional[int] = None,
    indices: Optional[torch.Tensor] = None,
    graph: Optional[bool] = None,
    device="cuda",
) -> Tuple[object, np.ndarray]:
    """``steps`` off-policy updates on the trace transitions, in place;
    returns ``(pol_state, losses [steps])``. The minibatch indices are
    ``indices`` [steps, b] (injected) or ``trace_indices`` drawn from
    ``generator``. The losses stay on the device until the phase ends and
    are read back once, as the JAX package's one scan returns them.

    ``graph`` (default: on the card) captures one step as a CUDA graph
    (``parallel/graph.py``) and replays it for every later step, its
    indices copied into the graph's static index buffer: a step is ~160
    small kernels at A=1000, which the host otherwise launches one by one
    far slower than the card runs them. The capture's warm-up run is the
    first captured step itself. Steps whose control flow can still change
    (DDPG's actor delay, before the critic's count reaches it) run eagerly
    first."""
    if steps <= 0:
        return pol_state, np.zeros((0,), dtype=np.float32)
    dev = resolve_device(device)
    update = make_trace_update_fn(cfg, dataset, batch_size=batch_size, device=dev)
    if indices is None:
        b = trace_batch_size(cfg, dataset.n_transitions, batch_size)
        indices = trace_indices(dataset.n_transitions, steps, b, generator, dev)
    indices = indices.to(device=dev, dtype=torch.int64)
    if indices.shape[0] != steps:
        raise ValueError(f"indices carry {indices.shape[0]} steps, expected {steps}")
    losses = torch.empty((steps,), dtype=torch.float32, device=dev)
    use_graph = dev.type == "cuda" if graph is None else graph
    n_eager = steps
    if use_graph:
        n_eager = 0
        if cfg.train.implementation == "ddpg" and cfg.ddpg.actor_delay_updates > 0:
            from p2pmicrogrid_tpu_torch.models.ddpg import adam_count

            n_eager = max(0, cfg.ddpg.actor_delay_updates - 1 - adam_count(pol_state.critic_opt))
        n_eager = min(n_eager, steps)
    for i in range(n_eager):
        pol_state, loss = update(pol_state, indices[i])
        losses[i] = loss
    if n_eager < steps:
        from p2pmicrogrid_tpu_torch.parallel.graph import capture, replay

        idx_buf = indices[n_eager].clone()
        loss_buf = torch.zeros((), dtype=torch.float32, device=dev)

        def step():
            _, loss = update(pol_state, idx_buf)
            loss_buf.copy_(loss)

        # The warm-up run is step n_eager; the capture itself runs nothing.
        captured = capture(step, stage=lambda: None)
        losses[n_eager] = loss_buf
        for i in range(n_eager + 1, steps):
            idx_buf.copy_(indices[i])
            replay(captured)
            losses[i] = loss_buf
    # host-sync: pretrain result readback at the phase boundary — the
    # chunked fine-tune (and its guard) consumes the finished state.
    return pol_state, losses.cpu().numpy()


def continual_cfg(cfg, episode0: int, incumbent_hash: Optional[str]):
    """The candidate's config: the incumbent's experiment with
    ``train.starting_episodes`` advanced to ``episode0``. Continual
    generations CONTINUE the episode count, which (a) keys the chunked
    trainer's episode streams off fresh absolute episodes and (b) gives
    the candidate a distinct ``config_hash`` — the identity every
    routing/attribution layer keys on. If the hash still collides with
    the incumbent's (an episode0 that matches the incumbent's own
    export), the episode origin is advanced deterministically until it
    does not."""
    from p2pmicrogrid_tpu_torch.telemetry import config_hash

    for bump in range(64):
        candidate = cfg.replace(
            train=dataclasses.replace(
                cfg.train, starting_episodes=episode0 + bump
            )
        )
        if incumbent_hash is None or config_hash(candidate) != incumbent_hash:
            return candidate
    raise RuntimeError("could not derive a distinct candidate config_hash")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def train_continual(
    cfg,
    incumbent_dir: str,
    dataset,
    out_dir: str,
    ckpt_dir: str,
    n_episodes: int = 20,
    n_chunks: int = 1,
    eval_every: int = 10,
    trace_steps: int = 200,
    trace_batch: Optional[int] = None,
    episode0: Optional[int] = None,
    guard_policy: GuardPolicy = GuardPolicy(),
    telemetry=None,
    dtype: str = "float32",
    s_eval: int = 8,
    pipeline: bool = True,
    generator: Optional[torch.Generator] = None,
    indices: Optional[torch.Tensor] = None,
    device="cuda",
) -> ContinualResult:
    """The continual-training driver: incumbent bundle + fresh traces ->
    candidate bundle.

    Phases (module docstring): warm start, ``trace_steps`` off-policy
    updates on ``dataset``, then ``n_episodes`` of the chunk graph under the
    divergence guard with rollback, then export to ``out_dir``.
    ``n_episodes=0`` skips the simulator phase (pure trace fine-tune — the
    fast path for tests and tight retraining cadences).

    ``generator`` (default: seeded with the candidate's ``train.seed`` on
    ``device``) draws the warm start's fresh scaffolding and then the
    minibatch indices, unless ``indices`` injects them; the simulator phase
    runs ``train_chunked_with_rollback`` seeded with the candidate's
    ``train.seed``. The returned ``ContinualResult`` carries the
    candidate's ``config_hash`` — the id the promotion pipeline
    (``serve/promotion.py``) gates and ramps.
    """
    from p2pmicrogrid_tpu_torch.envs import make_ratings
    from p2pmicrogrid_tpu_torch.serve.export import export_policy_bundle, load_policy_bundle
    from p2pmicrogrid_tpu_torch.telemetry import config_hash
    from p2pmicrogrid_tpu_torch.train.resilience import train_chunked_with_rollback

    dev = resolve_device(device)
    manifest, params = load_policy_bundle(incumbent_dir)
    incumbent_hash = manifest.get("config_hash")
    if episode0 is None:
        source = manifest.get("source") or {}
        src_ep = source.get("episode")
        episode0 = (
            src_ep + 1 if isinstance(src_ep, int) and src_ep >= 0
            else cfg.train.starting_episodes
        )
    cand_cfg = continual_cfg(cfg, episode0, incumbent_hash)
    episode0 = cand_cfg.train.starting_episodes
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(cand_cfg.train.seed)
    pol_state = state_from_bundle(cand_cfg, manifest, params, generator, device=dev)

    if telemetry is not None:
        telemetry.event(
            "continual",
            phase="start",
            incumbent=incumbent_hash,
            episode0=episode0,
            trace_transitions=dataset.n_transitions,
            trace_steps=trace_steps,
            n_episodes=n_episodes,
        )
    seconds = {}
    _sync(dev)
    t0 = time.perf_counter()
    pol_state, trace_losses = offpolicy_pretrain(
        cand_cfg, pol_state, dataset, generator,
        steps=trace_steps, batch_size=trace_batch, indices=indices, device=dev,
    )
    seconds["pretrain"] = time.perf_counter() - t0
    trace_loss_final = (
        float(trace_losses[-1]) if trace_losses.size else None
    )
    if telemetry is not None:
        telemetry.event(
            "continual",
            phase="trace_pretrain",
            steps=int(trace_losses.size),
            loss_final=trace_loss_final,
        )
        telemetry.counter("continual.trace_steps", int(trace_losses.size))

    rollbacks: List[RollbackRecord] = []
    t0 = time.perf_counter()
    if n_episodes > 0:
        rng = np.random.default_rng(cand_cfg.train.seed)
        ratings = make_ratings(cand_cfg, rng)
        (pol_state, _, _, _, _), rollbacks = train_chunked_with_rollback(
            cand_cfg, pol_state, ratings, cand_cfg.train.seed, ckpt_dir,
            n_episodes=n_episodes, n_chunks=n_chunks,
            eval_every=eval_every, episode0=episode0,
            guard_policy=guard_policy,
            telemetry=telemetry,
            s_eval=s_eval, pipeline=pipeline, device=dev,
        )
    _sync(dev)
    seconds["fine_tune"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    export_policy_bundle(
        cand_cfg, pol_state, out_dir,
        source={
            "kind": "continual",
            "incumbent": incumbent_hash,
            "incumbent_dir": os.path.abspath(incumbent_dir),
            "episode": episode0 + n_episodes - 1,
            "trace_transitions": dataset.n_transitions,
            "trace_runs": list(dataset.run_ids),
            "trace_steps": int(trace_losses.size),
            # The export window (decision timestamps) this candidate
            # trained on — the audit link between a promoted bundle and
            # the leased warehouse window that produced it.
            "trace_window": [
                getattr(dataset, "window_start_ts", None),
                getattr(dataset, "window_end_ts", None),
            ],
            "sim_episodes": n_episodes,
            "rollbacks": len(rollbacks),
        },
        dtype=dtype,
        device=dev,
    )
    seconds["export"] = time.perf_counter() - t0
    cand_hash = config_hash(cand_cfg)
    if telemetry is not None:
        telemetry.event(
            "continual",
            phase="exported",
            candidate=cand_hash,
            incumbent=incumbent_hash,
            out_dir=os.path.abspath(out_dir),
            rollbacks=len(rollbacks),
        )
    return ContinualResult(
        candidate_dir=out_dir,
        candidate_hash=cand_hash,
        incumbent_hash=incumbent_hash,
        episode0=episode0,
        episodes=n_episodes,
        trace_steps=int(trace_losses.size),
        trace_loss_final=trace_loss_final,
        trace_summary=dataset.summary(),
        rollbacks=rollbacks,
        phase_seconds=seconds,
    )
