"""Batched greedy inference engine over a policy bundle.

The port of the JAX package's ``serve/engine.py``: the serving hot path of
the paper's decision loop. Every 15-minute slot, every household (grouped
per community) needs a greedy heat-pump action from the trained policy given
its observation. Requests arrive as community observation rows ``[A, 4]``;
the engine coalesces them into batches ``[B, A, 4]`` and answers with
heat-pump fractions ``[B, A]``.

Design points:

* **Padding buckets, one CUDA graph each.** The engine rounds every batch
  up to the next power of two (capped at ``max_batch``), so all traffic hits
  a small fixed set of shapes. On the card each bucket's forward pass is one
  CUDA graph (``parallel/graph.py::capture``) with a static observation
  input and a static action output; ``warmup()`` captures them ahead of the
  first request, and a bucket that was never warmed is captured on first
  use under the engine's lock. ``act`` copies the host batch into a pinned
  staging buffer, copies that into the static input without blocking,
  replays the graph and copies the first ``n`` rows out, so no caller ever
  holds a view that the next replay overwrites. Graphs belong to one engine:
  a graph holds the addresses of the parameters it was captured with, so
  engines never share graphs or static buffers (the JAX package shares its
  compiled programs process-wide). ``stats["aot_compiles"]`` counts this
  engine's captures and ``stats["aot_hits"]`` stays 0. On the CPU the
  engine runs ``forward`` eagerly. A capture that fails raises; nothing
  serves eagerly in its place on the card.
* **Captures and threads.** Calls to ``act`` and ``step`` serialise on one
  lock per engine. Captures run in ``thread_local`` mode, one at a time in
  the process, so other engines' worker threads can keep serving while a
  hot-swapped engine warms up.
* **Same greedy math as training.** ``forward`` is the training-side greedy
  path: ``models/tabular.py::q_rows`` with the first of tied maxima,
  ``models/dqn.py::_q_all_actions`` and its argmax, and
  ``models/networks.py::Actor``. Serving computes in float32 whatever the
  bundle's on-disk dtype, and sets no global precision: on the card the
  networks refuse TF32.
* **Sessions.** ``init_sessions``/``step`` carry per-household cross-slot
  state (the previous served action — the env's round-0 ``hp_frac`` carry —
  and a served-slot counter). On the card each bucket's step is its own
  graph, which writes the actions and bumps the slot counters of its static
  session buffers in place; the caller's session tensors are updated in
  place from them. Padded rows get zeros and are sliced away.
* **Recurrent bundles.** A bundle whose manifest carries ``hidden_state``
  (``ddpg_recurrent``, ``models/ddpg_recurrent.py``) threads its per-agent
  flat LSTM carry through every act: ``act(obs, hidden)`` returns
  ``(actions, hidden')``, ``Sessions.hidden`` [N, A, H] rides the session
  step, and on the card the carry is a static input and a static output of
  each bucket's graph, next to the observation. A recurrent bundle refuses
  ``act`` without a carry (a hidden-state policy served statelessly is a
  different policy), and a feed-forward bundle refuses one.
* **Microbatching.** ``MicroBatchQueue`` fronts the engine for concurrent
  callers: single-community requests coalesce until ``max_batch`` or
  ``max_wait_s``, then execute as one padded batch; it refuses recurrent
  bundles. The slot-level ``serve/continuous.py::ContinuousBatcher`` is the
  other front, and the one that serves recurrent bundles.

Entry points default to ``device="cuda"``; the JAX package's
``device="auto"`` placement (a crossover measured on a TPU host) is not
ported.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future, InvalidStateError
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from p2pmicrogrid_tpu_torch.device import resolve_device
from p2pmicrogrid_tpu_torch.serve.export import load_policy_bundle

# One capture at a time in the process: ``parallel/graph.py::capture``
# tallies kernel launches in a module-level slot while it records.
_CAPTURE_LOCK = threading.Lock()


class Sessions(NamedTuple):
    """Per-community serving sessions, tensors on the engine's device."""

    hp_frac: torch.Tensor  # [N, A] last served action fraction
    slots: torch.Tensor    # [N] int32 slots served
    hidden: Optional[torch.Tensor] = None  # [N, A, H] recurrent carry (None: feed-forward)


class _BucketGraph(NamedTuple):
    """One bucket's captured forward (or session step) and its buffers."""

    captured: Any            # parallel/graph.py::Captured; outputs = [b, A] (and [b, A, H])
    static_in: torch.Tensor  # [b, A, 4] on the card
    host_in: torch.Tensor    # [b, A, 4] pinned staging buffer
    slots: Optional[torch.Tensor]  # [b] int32 session counters (step graphs)
    static_hidden: Optional[torch.Tensor] = None  # [b, A, H] carry in (recurrent)
    host_hidden: Optional[torch.Tensor] = None    # [b, A, H] pinned staging


def _bucket_sizes(max_batch: int) -> list:
    sizes, b = [], 1
    while b < max_batch:
        sizes.append(b)
        b *= 2
    sizes.append(max_batch)
    return sizes


def _float32_tree(tree):
    """Floating leaves as float32 (a float16 bundle halves storage, not
    arithmetic precision); other leaves as they are."""
    if isinstance(tree, dict):
        return {k: _float32_tree(v) for k, v in tree.items()}
    arr = np.asarray(tree)
    return arr.astype(np.float32) if np.issubdtype(arr.dtype, np.floating) else arr


class PolicyEngine:
    """Loads a policy bundle and serves batched greedy actions.

    ``act(obs)`` with obs ``[B, A, 4]`` returns hp fractions ``[B, A]``;
    batches larger than ``max_batch`` are split, smaller ones padded up to
    the next power-of-two bucket. ``telemetry`` (a ``telemetry.Telemetry``)
    receives ``serve.*`` counters and per-batch ``serve.batch_ms``
    histograms.

    ``stats``: ``batches``, ``rows``, ``padded_rows`` as the JAX package
    counts them; ``aot_compiles`` counts this engine's graph captures (acts
    and session steps) and ``aot_hits`` stays 0, since no graph is shared
    between engines. ``capture_s`` maps each act bucket to the host seconds
    its capture took (its warm-up run included), and ``graph_pool_bytes``
    sums the device memory its graphs' pools reserved.
    """

    def __init__(
        self,
        bundle_dir: Optional[str] = None,
        manifest: Optional[dict] = None,
        params: Optional[dict] = None,
        max_batch: int = 256,
        telemetry=None,
        device="cuda",
    ):
        if bundle_dir is not None:
            manifest, params = load_policy_bundle(bundle_dir)
        if manifest is None or params is None:
            raise ValueError("pass bundle_dir, or both manifest and params")
        if max_batch < 1 or max_batch & (max_batch - 1):
            raise ValueError(f"max_batch must be a power of two, got {max_batch}")
        if device == "auto":
            raise ValueError(
                "device='auto' (placement from a measured serve crossover) is "
                "not ported; pass 'cuda' or 'cpu'"
            )
        self.device = resolve_device(device)
        self.manifest = manifest
        self.max_batch = max_batch
        self.telemetry = telemetry
        self.n_agents = int(manifest["n_agents"])
        self._impl = manifest["implementation"]
        # The session ring and the carry are sized from the manifest's
        # hidden_state block, never from the architecture fields.
        hidden_spec = manifest.get("hidden_state")
        self.is_recurrent = hidden_spec is not None
        self.hidden_dim = int(hidden_spec["shape"][-1]) if self.is_recurrent else 0
        self.forward = self._build_forward(_float32_tree(params))
        self._lock = threading.Lock()
        self._graphs: dict = {}
        self._step_graphs: dict = {}
        self.capture_s: dict = {}
        self.graph_pool_bytes = 0
        self.stats = {
            "batches": 0, "rows": 0, "padded_rows": 0,
            "aot_hits": 0, "aot_compiles": 0,
        }

    # --- greedy forward passes (the training greedy paths) ------------------

    def _build_forward(self, params: dict):
        """``forward(obs [B, A, 4] float32 on the device) -> [B, A]``; for a
        recurrent bundle ``forward(obs, hidden [B, A, H]) -> ([B, A],
        hidden')``."""
        from p2pmicrogrid_tpu_torch.config import DQNConfig, QLearningConfig
        from p2pmicrogrid_tpu_torch.convert import network_from_tree
        from p2pmicrogrid_tpu_torch.models.dqn import _q_all_actions, action_values_on
        from p2pmicrogrid_tpu_torch.models.networks import Actor, QNetwork
        from p2pmicrogrid_tpu_torch.models.tabular import q_rows

        dev = self.device
        model = self.manifest["model"]
        values = action_values_on(dev)
        if self._impl == "tabular":
            qcfg = QLearningConfig(**model["qlearning"])
            q_table = torch.from_numpy(np.array(params["q_table"])).to(dev)

            def forward(obs):
                # torch.argmax returns the first of tied maxima, as
                # jnp.argmax does.
                return values[torch.argmax(q_rows(qcfg, q_table, obs), dim=-1)]

        elif self._impl == "dqn":
            dcfg = DQNConfig(hidden=model["hidden"])
            net = network_from_tree(params, QNetwork, dev).requires_grad_(False)

            def forward(obs):
                return values[torch.argmax(_q_all_actions(dcfg, net, obs), dim=-1)]

        elif self._impl == "ddpg_recurrent":
            from p2pmicrogrid_tpu_torch.models.ddpg_recurrent import (
                RecurrentActor,
                recurrent_actor_step,
            )

            actor = network_from_tree(params, RecurrentActor, dev).requires_grad_(False)

            # One shared actor across agents AND batch rows: [B, A] flattened
            # into the leading axis, one step of the cell, restored.
            def forward(obs, hidden):
                B, A, F = obs.shape
                a, h = recurrent_actor_step(
                    actor, obs.reshape(B * A, F), hidden.reshape(B * A, hidden.shape[-1])
                )
                return a.reshape(B, A), h.reshape(B, A, -1)

        elif self._impl == "ddpg":
            actor = network_from_tree(params, Actor, dev).requires_grad_(False)
            if actor.n_agents is None:

                def forward(obs):
                    B, A, F = obs.shape
                    return actor(obs.reshape(B * A, F))[:, 0].reshape(B, A)

            else:

                def forward(obs):
                    return actor(obs.transpose(0, 1))[..., 0].transpose(0, 1)

        else:
            raise ValueError(f"bundle has unknown implementation {self._impl!r}")
        return torch.no_grad()(forward)

    # --- buckets and graphs -------------------------------------------------

    def bucket_for(self, n: int) -> int:
        """Smallest power-of-two bucket >= n (capped at max_batch)."""
        if n < 1:
            raise ValueError(f"batch size must be >= 1, got {n}")
        b = 1
        while b < n:
            b *= 2
        return min(b, self.max_batch)

    @property
    def buckets(self) -> list:
        return _bucket_sizes(self.max_batch)

    def _capture(self, bucket: int, step: bool) -> _BucketGraph:
        """Capture one bucket's act graph (or, with ``step``, its session
        step: the act and the slot counters' increment). Lock held."""
        from p2pmicrogrid_tpu_torch.parallel.graph import capture

        start = time.perf_counter()
        static_in = torch.zeros((bucket, self.n_agents, 4), device=self.device)
        host_in = torch.zeros((bucket, self.n_agents, 4), pin_memory=True)
        slots = torch.zeros((bucket,), dtype=torch.int32, device=self.device) if step else None
        static_hidden = host_hidden = None
        if self.is_recurrent:
            shape = (bucket, self.n_agents, self.hidden_dim)
            static_hidden = torch.zeros(shape, device=self.device)
            host_hidden = torch.zeros(shape, pin_memory=True)

        def fn():
            out = self.forward(static_in) if static_hidden is None else self.forward(static_in, static_hidden)
            if slots is not None:
                slots.add_(1)
            return out

        with _CAPTURE_LOCK, torch.cuda.device(self.device):
            captured = capture(fn, lambda: None, capture_error_mode="thread_local")
        g = _BucketGraph(captured, static_in, host_in, slots, static_hidden, host_hidden)
        (self._step_graphs if step else self._graphs)[bucket] = g
        if not step:
            self.capture_s[bucket] = time.perf_counter() - start
        self.graph_pool_bytes += captured.pool_bytes
        self.stats["aot_compiles"] += 1
        if self.telemetry is not None:
            self.telemetry.counter("serve.aot_compile")
        return g

    def warmup(self, buckets=None, include_step: bool = True) -> list:
        """Prepare the buckets before traffic; returns the bucket sizes
        warmed. On the card each bucket's act graph is captured (and, with
        ``include_step``, its session-step graph) so no request pays a
        capture in its latency; capture them all here, before a front's
        worker thread starts. On the CPU there is nothing to prepare."""
        warmed = []
        with self._lock:
            for b in buckets if buckets is not None else self.buckets:
                if self.device.type == "cuda":
                    if b not in self._graphs:
                        self._capture(b, step=False)
                    if include_step and b not in self._step_graphs:
                        self._capture(b, step=True)
                warmed.append(b)
        return warmed

    # --- batched act --------------------------------------------------------

    def _check_obs(self, obs) -> np.ndarray:
        # host-sync: caller-supplied host observations, not device values.
        obs = np.asarray(obs, dtype=np.float32)
        if obs.ndim != 3 or obs.shape[1:] != (self.n_agents, 4):
            raise ValueError(
                f"obs must be [B, {self.n_agents}, 4] for this bundle "
                f"(setting {self.manifest.get('setting')!r}), got {obs.shape}"
            )
        return obs

    def act(self, obs, hidden=None):
        """Greedy actions for a batch of community observations.

        obs [B, A, 4] -> hp fraction [B, A] float32. B may exceed
        ``max_batch`` (the batch is split); sub-bucket batches are padded
        with zeros and the pad rows discarded. A recurrent bundle threads
        its carry: pass ``hidden`` [B, A, H] (``init_hidden`` for fresh
        sessions) and get ``(actions [B, A], hidden' [B, A, H])`` on the
        host; without ``hidden`` it refuses, and a feed-forward bundle
        refuses a ``hidden``."""
        obs = self._check_obs(obs)
        if self.is_recurrent and hidden is None:
            raise ValueError(
                "recurrent bundle: act() needs the hidden carry "
                "([B, A, H]; init_hidden() for fresh sessions) — serve it "
                "through session-carrying paths (ContinuousBatcher with "
                "sessions on), not the stateless act/microbatch path"
            )
        if not self.is_recurrent and hidden is not None:
            raise ValueError(f"{self._impl!r} bundle is feedforward — it takes no hidden carry")
        if hidden is not None:
            hidden = self._check_hidden(hidden, obs.shape[0])
        outs = [
            self._act_one_batch(
                obs[i : i + self.max_batch],
                None if hidden is None else hidden[i : i + self.max_batch],
            )
            for i in range(0, obs.shape[0], self.max_batch)
        ]
        empty = np.zeros((0, self.n_agents), dtype=np.float32)
        if not self.is_recurrent:
            return np.concatenate(outs, axis=0) if outs else empty
        if not outs:
            return empty, np.zeros((0, self.n_agents, self.hidden_dim), np.float32)
        return (
            np.concatenate([a for a, _ in outs], axis=0),
            np.concatenate([h for _, h in outs], axis=0),
        )

    def _check_hidden(self, hidden, n_rows: int) -> np.ndarray:
        # host-sync: a caller-supplied carry, read to the host (the session
        # paths keep theirs on the device instead).
        if isinstance(hidden, torch.Tensor):
            hidden = hidden.detach().cpu().numpy()
        hidden = np.asarray(hidden, dtype=np.float32)
        want = (n_rows, self.n_agents, self.hidden_dim)
        if hidden.shape != want:
            raise ValueError(f"hidden carry must be {list(want)} for this bundle, got {list(hidden.shape)}")
        return hidden

    def _run(self, obs: np.ndarray, bucket: int, step: bool, hidden=None):
        """The bucket's forward on ``obs`` [b <= bucket, A, 4], lock held:
        ``([b, A] actions, [b, A, H] carry or None, the step graph's slot
        counters or None)``, tensors on the device. ``hidden`` is the carry
        [b, A, H] of a recurrent bundle: a host array (``act``) or a tensor
        on the device (``step``); pad rows get zeros."""
        b = obs.shape[0]
        if self.device.type != "cuda":
            padded = np.zeros((bucket,) + obs.shape[1:], np.float32)
            padded[:b] = obs
            if not self.is_recurrent:
                return self.forward(torch.from_numpy(padded))[:b], None, None
            h = torch.zeros((bucket, self.n_agents, self.hidden_dim))
            h[:b] = torch.as_tensor(hidden)
            a, h = self.forward(torch.from_numpy(padded), h)
            return a[:b], h[:b], None
        graphs = self._step_graphs if step else self._graphs
        g = graphs.get(bucket) or self._capture(bucket, step)
        g.host_in[:b].copy_(torch.from_numpy(obs))
        g.host_in[b:].zero_()
        g.static_in.copy_(g.host_in, non_blocking=True)
        if self.is_recurrent:
            if isinstance(hidden, torch.Tensor):
                g.static_hidden[:b].copy_(hidden)
                g.static_hidden[b:].zero_()
            else:
                g.host_hidden[:b].copy_(torch.from_numpy(hidden))
                g.host_hidden[b:].zero_()
                g.static_hidden.copy_(g.host_hidden, non_blocking=True)
        g.captured.graph.replay()
        if not self.is_recurrent:
            return g.captured.outputs[:b], None, g.slots
        a, h = g.captured.outputs
        return a[:b], h[:b], g.slots

    def _act_one_batch(self, obs: np.ndarray, hidden=None):
        b = obs.shape[0]
        bucket = self.bucket_for(b)
        t0 = time.perf_counter()
        with self._lock:
            out, h, _ = self._run(obs, bucket, step=False, hidden=hidden)
            # host-sync: result delivery; serve latency IS this sync. A
            # copy, never a view of a static output.
            out = out.cpu().numpy().copy()
            if h is not None:
                h = h.cpu().numpy().copy()
            self.stats["rows"] += b
            self.stats["batches"] += 1
            self.stats["padded_rows"] += bucket - b
        secs = time.perf_counter() - t0
        if self.telemetry is not None:
            self.telemetry.counter("serve.requests", b)
            self.telemetry.counter("serve.batches")
            self.telemetry.counter("serve.padded_rows", bucket - b)
            self.telemetry.histogram("serve.batch_ms", secs * 1e3)
        return out if h is None else (out, h)

    @property
    def padding_waste(self) -> float:
        """Fraction of computed rows that were padding, lifetime."""
        total = self.stats["rows"] + self.stats["padded_rows"]
        return self.stats["padded_rows"] / total if total else 0.0

    # --- stateful per-community sessions ------------------------------------

    def init_hidden(self, n: int) -> torch.Tensor:
        """The fresh-session carry [n, A, H] (zeros) on the engine's device:
        what a session re-init after eviction resets to."""
        if not self.is_recurrent:
            raise ValueError(f"{self._impl!r} bundle is feedforward — no hidden carry")
        return torch.zeros((n, self.n_agents, self.hidden_dim), dtype=torch.float32, device=self.device)

    def init_sessions(self, n: int) -> Sessions:
        return Sessions(
            hp_frac=torch.zeros((n, self.n_agents), dtype=torch.float32, device=self.device),
            slots=torch.zeros((n,), dtype=torch.int32, device=self.device),
            hidden=self.init_hidden(n) if self.is_recurrent else None,
        )

    def step(self, sessions: Sessions, obs):
        """Advance ``n`` sessions one slot: act on obs [n, A, 4], record the
        served action as each session's new ``hp_frac``, bump slot counters,
        and for a recurrent bundle carry each session's hidden state on.

        The session tensors are updated in place. Returns (sessions,
        hp_frac [n, A] on the host)."""
        obs = self._check_obs(obs)
        n = obs.shape[0]
        if int(sessions.slots.shape[0]) != n:
            raise ValueError(f"{n} obs rows for {int(sessions.slots.shape[0])} sessions")
        if n > self.max_batch:
            raise ValueError(f"sessions batch {n} exceeds max_batch {self.max_batch}")
        if self.is_recurrent and sessions.hidden is None:
            raise ValueError("recurrent bundle: these sessions carry no hidden state (init_sessions)")
        bucket = self.bucket_for(n)
        with self._lock:
            if self.device.type == "cuda":
                g = self._step_graphs.get(bucket) or self._capture(bucket, step=True)
                g.slots[:n].copy_(sessions.slots)
                g.slots[n:].zero_()
            hp, hidden, slots = self._run(obs, bucket, step=True, hidden=sessions.hidden)
            sessions.hp_frac.copy_(hp)
            if hidden is not None:
                sessions.hidden.copy_(hidden)
            if slots is None:
                sessions.slots.add_(1)
            else:
                sessions.slots.copy_(slots[:n])
            out = hp.cpu().numpy().copy()  # host-sync: result delivery
        return sessions, out


class MicroBatchQueue:
    """Coalescing front for concurrent single-community callers.

    ``submit(obs_row [A, 4])`` returns a ``Future`` resolving to the
    household actions ``[A]``. Waiting requests are dispatched as ONE
    padded engine batch when either ``max_batch`` have queued or the oldest
    has waited ``max_wait_s``.
    """

    def __init__(self, engine: PolicyEngine, max_batch=None, max_wait_s=0.002):
        if getattr(engine, "is_recurrent", False):
            # A hidden-state policy served through the stateless full-batch
            # queue would act from a zero carry every slot: a different
            # policy. Refused at construction, with the fix.
            raise ValueError(
                "recurrent bundle cannot serve through MicroBatchQueue "
                "(sessions are disabled on the stateless full-batch path) "
                "— serve it through serve.continuous.ContinuousBatcher "
                "with sessions enabled (gateway: batching='continuous')"
            )
        self.engine = engine
        self.max_batch = min(max_batch or engine.max_batch, engine.max_batch)
        self.max_wait_s = max_wait_s
        self._pending: list = []  # (obs_row, Future, t_enq, trace, request_id, t_enq_epoch)
        self._cv = threading.Condition()
        self._closed = False
        # Bounded window of recent enqueue->dispatch waits, as (monotonic
        # dispatch instant, wait ms) — the admission-control signal the
        # serve gateway sheds on. Timestamped so readers can age samples
        # out: only dispatches refresh this window, and a gateway shedding
        # on a stale p95 would otherwise never admit the traffic that could
        # refresh it.
        self.recent_wait_ms: deque = deque(maxlen=512)
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    @property
    def depth(self) -> int:
        """Requests queued but not yet dispatched (admission signal)."""
        with self._cv:
            return len(self._pending)

    def submit(self, obs_row, household=None, trace=None, request_id=None) -> Future:
        # ``household`` is accepted (and ignored) so the gateway submits
        # through one interface: the continuous batcher uses it for slot
        # affinity. ``trace`` (a TraceContext or None) and ``request_id``
        # ride the pending tuple so _trace can stitch queue-wait/execute
        # spans and id-joinable serve_request events.
        del household
        # host-sync: caller-supplied host observation row.
        obs_row = np.asarray(obs_row, dtype=np.float32)
        fut: Future = Future()
        with self._cv:
            if self._closed:
                raise RuntimeError("queue is closed")
            self._pending.append(
                (obs_row, fut, time.monotonic(), trace, request_id, time.time())
            )
            self._cv.notify()
        return fut

    def _worker(self) -> None:
        while True:
            with self._cv:
                while not self._pending and not self._closed:
                    self._cv.wait()
                if not self._pending and self._closed:
                    return
                # Window anchored at the OLDEST request's enqueue time, not
                # this wake: a backlog that piled up while the engine was
                # busy has already out-waited the window and dispatches
                # immediately.
                deadline = self._pending[0][2] + self.max_wait_s
                while len(self._pending) < self.max_batch and not self._closed:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cv.wait(timeout=remaining)
                batch = self._pending[: self.max_batch]
                del self._pending[: self.max_batch]
            try:
                dispatch_t = time.monotonic()
                dispatch_epoch = time.time()
                for entry in batch:
                    self.recent_wait_ms.append(
                        (dispatch_t, (dispatch_t - entry[2]) * 1e3)
                    )
                out = self.engine.act(np.stack([entry[0] for entry in batch]))
                service_s = time.monotonic() - dispatch_t
                for i, (_, fut, *_rest) in enumerate(batch):
                    # A caller may have given up mid-batch (the gateway's
                    # request timeout cancels through wrap_future);
                    # delivering to a cancelled future raises and must not
                    # abort delivery to the batch's OTHER waiters.
                    if fut.cancelled():
                        continue
                    try:
                        fut.set_result(out[i].copy())
                    except InvalidStateError:
                        pass  # cancelled between the check and delivery
            except Exception as err:  # noqa: BLE001 — fail the waiters, not the loop
                for _, fut, *_rest in batch:
                    if not fut.done():
                        try:
                            fut.set_exception(err)
                        except InvalidStateError:
                            pass  # lost a cancellation race
                continue
            try:
                # AFTER result delivery, and fenced off: a sink hiccup must
                # not fail waiters whose inference succeeded.
                self._trace(batch, dispatch_t, service_s, dispatch_epoch)
            except Exception:  # noqa: BLE001 — telemetry is best-effort
                pass

    def _trace(
        self, batch, dispatch_t: float, service_s: float,
        dispatch_epoch: float = 0.0,
    ) -> None:
        """Per-request trace records through the engine's telemetry: the
        enqueue->dispatch coalescing wait, the bucket the batch padded to,
        and the shared batch-service span. Traced requests additionally get
        real spans: a per-request ``queue.wait`` and ``engine.execute``
        pair, one ``engine.step`` span under the first traced request's
        context that fans in the whole coalesced dispatch, and a synthetic
        ``engine.pad`` span attributing the padded-lane share of the
        batch's service time."""
        from p2pmicrogrid_tpu_torch.telemetry.tracing import record_span

        tel = self.engine.telemetry
        if tel is None:
            return
        n = len(batch)
        bucket = self.engine.bucket_for(n)
        padded = bucket - n
        traced = [e for e in batch if e[3] is not None]
        for row_i, entry in enumerate(batch):
            wait_ms = (dispatch_t - entry[2]) * 1e3
            tel.histogram("serve.queue_wait_ms", wait_ms)
            tel.event(
                "serve_request",
                source="queue",
                row=row_i,
                batch_size=n,
                bucket=bucket,
                padded_rows=padded,
                wait_ms=round(wait_ms, 3),
                service_ms=round(service_s * 1e3, 3),
                latency_ms=round(wait_ms + service_s * 1e3, 3),
                request_id=entry[4],
            )
        if not traced:
            return
        for entry in traced:
            ctx, t_enq_epoch = entry[3], entry[5]
            wait_s = max(0.0, dispatch_epoch - t_enq_epoch)
            record_span(
                tel, ctx.child("queue.wait"), "queue.wait",
                t_enq_epoch, wait_s, batch_size=n,
            )
            record_span(
                tel, ctx.child("engine.execute"), "engine.execute",
                dispatch_epoch, service_s,
                bucket=bucket, batch_size=n, padded_rows=padded,
            )
        first_ctx = traced[0][3]
        record_span(
            tel, first_ctx.child("engine.step"), "engine.step",
            dispatch_epoch, service_s,
            bucket=bucket, batch_size=n, linked=len(traced),
        )
        if padded > 0:
            record_span(
                tel, first_ctx.child("engine.pad"), "engine.pad",
                dispatch_epoch, service_s * padded / bucket,
                bucket=bucket, padded_rows=padded, estimated=True,
            )

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._thread.join(timeout=5.0)

    def __enter__(self) -> "MicroBatchQueue":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
