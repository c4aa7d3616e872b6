"""Process-isolated serve fleet: real subprocess replicas under supervision.

The port of the JAX package's ``serve/procfleet.py``. Each child is the
port's ``serve-gateway`` (``python -m p2pmicrogrid_tpu_torch serve-gateway
--device D``), on the card by default: each holds its own CUDA context and
its own graph captures, so a SIGKILL relaunch pays the torch import, the
context and the captures again. A child that cannot start on the card fails
``start()`` (or its relaunch), and the supervisor relaunches it with the
same flags, never on the CPU. ``startups`` records each child's startup
seconds, from spawn to its ``gateway_listening`` line, for the first launch
and every relaunch.

``LocalFleet`` (serve/router.py) runs N replicas inside ONE interpreter —
perfect for fast deterministic tests, but its replicas share a GIL and a
"kill" is an in-process abort. Every SLO number measured that way carries
an asterisk: the operating system never actually took a replica away.
``ProcessFleet`` removes the asterisk:

* **Each replica is a real OS process** — spawned through the existing
  ``serve-gateway`` CLI,
  its ephemeral HTTP + mux ports read from the ``gateway_listening`` JSON
  line the CLI prints once its sockets accept. TLS cert/key, the fleet
  auth secret and a fault plan ride in as flags, so the child terminates
  trust and injects faults exactly like an in-process gateway.
* **kill() is a real SIGKILL.** No drain, no Python-level cleanup — the
  kernel reclaims the process mid-request, which is the one failure mode
  the in-process harness cannot produce (clients see half-open
  connections, not polite resets).
* **A supervisor relaunches dead replicas** with capped deterministic
  exponential backoff (``min(cap, base * 2**restarts)`` — the same
  no-jitter rule as ``train/resilience.supervise``: replayability over
  thundering herds of one). Relaunches rebind the ORIGINAL ports (the
  router's address book stays valid) and pass ``--restarts N`` so fleet
  stats attribute churn per replica.
* **Fault-plan replay across restarts.** A relaunched child rebuilds its
  ``FaultInjector`` from the same plan + replica id, so a chaos run's
  injected fault sequence is a pure function of (plan seed, per-replica
  request order) in process mode too. Request-fault windows anchor at
  each child's first request (there is no cross-process monotonic clock
  to share).

The harness duck-types ``LocalFleet``'s chaos surface (``replicas``,
``kill``, ``restart``, ``activate_faults``, ``kills``/``restarts``,
``stop_all``, context manager), so ``serve_bench_fleet`` and the
``FaultSchedule`` drive both fleets identically.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence

from p2pmicrogrid_tpu_torch.device import resolve_device
from p2pmicrogrid_tpu_torch.serve.router import Replica

_LOG_TAIL_LINES = 200


class ProcessFleet:
    """N ``serve-gateway`` subprocesses + a relaunch supervisor."""

    def __init__(
        self,
        bundle_dirs: Sequence[str],
        n_replicas: int = 3,
        max_batch: int = 64,
        max_wait_s: float = 0.002,
        max_queue_depth: int = 256,
        wait_budget_ms: float = 50.0,
        host: str = "127.0.0.1",
        mux: bool = True,
        tls_cert: Optional[str] = None,
        tls_key: Optional[str] = None,
        auth_secret_file: Optional[str] = None,
        fault_plan_file: Optional[str] = None,
        results_db: Optional[str] = None,
        serve_device="cuda",
        batching: str = "micro",
        max_slots: int = 256,
        shard_warehouse: bool = False,
        supervise: bool = True,
        backoff_s: float = 0.25,
        backoff_cap_s: float = 4.0,
        startup_timeout_s: float = 180.0,
        python: Optional[str] = None,
        env: Optional[dict] = None,
    ):
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
        if (tls_cert is None) != (tls_key is None):
            raise ValueError("pass --tls cert AND key together, or neither")
        # The children's device, checked here first: a fleet asked for the
        # card on a machine without one raises before spawning anything.
        resolve_device(serve_device)
        self.bundle_dirs = list(bundle_dirs)
        self.n_replicas = n_replicas
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self.max_queue_depth = max_queue_depth
        self.wait_budget_ms = wait_budget_ms
        self.host = host
        self.mux = mux
        self.tls_cert = tls_cert
        self.tls_key = tls_key
        self.auth_secret_file = auth_secret_file
        self.fault_plan_file = fault_plan_file
        self.results_db = results_db
        self.serve_device = str(serve_device)
        self.batching = batching
        self.max_slots = max_slots
        # Sharded warehouse write path: each child binds
        # its own WAL shard file + shard identity instead of contending on
        # one DB across processes. A relaunched replica rebinds the SAME
        # shard — its committed prefix survives the SIGKILL and the next
        # run appends beside it (the merge is keyed by run_id, so torn
        # tails never collide with the relaunch's rows).
        self.shard_warehouse = shard_warehouse
        self.shard_paths: List[str] = []
        if shard_warehouse and results_db:
            from p2pmicrogrid_tpu_torch.data.results import shard_db_path

            self.shard_paths = [
                shard_db_path(results_db, f"replica-{i}")
                for i in range(n_replicas)
            ]
        self.supervise = supervise
        self.backoff_s = backoff_s
        self.backoff_cap_s = backoff_cap_s
        self.startup_timeout_s = startup_timeout_s
        self.python = python or sys.executable
        self.env = env
        self._lock = threading.Lock()
        # rid -> {proc, host, port, mux_port, alive, restarts, log,
        #         listening (threading.Event), deliberate_down}
        self._entries: Dict[str, dict] = {}
        self._supervisor: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.kills: List[str] = []
        self.restarts: List[str] = []
        # One record a launch: {replica_id, restarts, pid, startup_s}.
        self.startups: List[dict] = []

    # -- child lifecycle -----------------------------------------------------

    def _child_argv(self, rid: str, port: int, mux_port: Optional[int],
                    restarts: int) -> List[str]:
        argv = [self.python, "-m", "p2pmicrogrid_tpu_torch", "serve-gateway"]
        for bundle in self.bundle_dirs:
            argv += ["--bundle", bundle]
        argv += [
            "--host", self.host,
            "--port", str(port),
            "--max-batch", str(self.max_batch),
            "--max-wait-ms", str(self.max_wait_s * 1e3),
            "--max-queue-depth", str(self.max_queue_depth),
            "--wait-budget-ms", str(self.wait_budget_ms),
            "--device", self.serve_device,
            "--serve-device", "auto",
            "--batching", self.batching,
            "--max-sessions", str(self.max_slots),
            "--replica-id", rid,
            "--restarts", str(restarts),
        ]
        if self.mux:
            argv += ["--mux-port", str(mux_port if mux_port else 0)]
        if self.tls_cert:
            argv += ["--tls-cert", self.tls_cert, "--tls-key", self.tls_key]
        if self.auth_secret_file:
            argv += ["--auth-secret-file", self.auth_secret_file]
        if self.fault_plan_file:
            argv += ["--chaos-plan", self.fault_plan_file]
        if self.results_db:
            if self.shard_warehouse:
                from p2pmicrogrid_tpu_torch.data.results import shard_db_path

                argv += [
                    "--results-db", shard_db_path(self.results_db, rid),
                    "--shard-id", rid,
                ]
            else:
                argv += ["--results-db", self.results_db]
        return argv

    def _spawn(self, rid: str, port: int = 0,
               mux_port: Optional[int] = None, restarts: int = 0) -> dict:
        child_env = dict(os.environ)
        child_env.update(self.env or {})
        proc = subprocess.Popen(
            self._child_argv(rid, port, mux_port, restarts),
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            env=child_env,
        )
        entry = {
            "proc": proc,
            "host": self.host,
            "port": port,
            "mux_port": mux_port,
            "alive": True,
            "restarts": restarts,
            "log": deque(maxlen=_LOG_TAIL_LINES),
            "listening": threading.Event(),
            "deliberate_down": False,
            "spawned_at": time.monotonic(),
            "startup_s": None,
        }
        reader = threading.Thread(
            target=self._read_child, args=(rid, entry), daemon=True
        )
        entry["reader"] = reader
        reader.start()
        return entry

    def _read_child(self, rid: str, entry: dict) -> None:
        """Stream one child's merged stdout/stderr, capturing a bounded
        log tail and resolving the ``gateway_listening`` line into the
        replica's addresses."""
        proc = entry["proc"]
        assert proc.stdout is not None
        for line in proc.stdout:
            entry["log"].append(line.rstrip("\n"))
            if '"gateway_listening"' in line and not entry["listening"].is_set():
                try:
                    doc = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if doc.get("kind") == "gateway_listening":
                    entry["port"] = int(doc["port"])
                    entry["mux_port"] = doc.get("mux_port")
                    entry["startup_s"] = time.monotonic() - entry["spawned_at"]
                    record = {
                        "replica_id": rid,
                        "restarts": entry["restarts"],
                        "pid": proc.pid,
                        "startup_s": round(entry["startup_s"], 3),
                    }
                    with self._lock:
                        self.startups.append(record)
                    print(
                        f"procfleet: {rid} listening {record['startup_s']:.3f} s "
                        f"after launch (restarts {entry['restarts']}, pid {proc.pid})",
                        file=sys.stderr,
                        flush=True,
                    )
                    entry["listening"].set()

    def _await_listening(self, rid: str, entry: dict) -> None:
        end = time.monotonic() + self.startup_timeout_s
        while not entry["listening"].wait(0.1):
            if entry["proc"].poll() is not None:
                tail = "\n".join(list(entry["log"])[-20:])
                raise RuntimeError(
                    f"{rid} exited rc={entry['proc'].returncode} before "
                    f"listening; log tail:\n{tail}"
                )
            if time.monotonic() >= end:
                entry["proc"].kill()
                raise RuntimeError(
                    f"{rid} did not print gateway_listening within "
                    f"{self.startup_timeout_s:g}s"
                )

    # -- public lifecycle ----------------------------------------------------

    def start(self) -> List[Replica]:
        try:
            for i in range(self.n_replicas):
                rid = f"replica-{i}"
                entry = self._spawn(rid)
                with self._lock:
                    self._entries[rid] = entry
            for rid, entry in list(self._entries.items()):
                self._await_listening(rid, entry)
        except BaseException:
            self.stop_all()
            raise
        if self.supervise:
            self._stop.clear()
            self._supervisor = threading.Thread(
                target=self._supervise, daemon=True
            )
            self._supervisor.start()
        return self.replicas

    @property
    def replicas(self) -> List[Replica]:
        with self._lock:
            return [
                Replica(
                    replica_id=rid, host=e["host"], port=e["port"],
                    mux_port=e.get("mux_port"),
                )
                for rid, e in self._entries.items()
            ]

    def entry(self, replica_id: str) -> dict:
        with self._lock:
            return self._entries[replica_id]

    def pid(self, replica_id: str) -> Optional[int]:
        with self._lock:
            proc = self._entries[replica_id]["proc"]
        return proc.pid if proc.poll() is None else None

    def log_tail(self, replica_id: str, n: int = 40) -> str:
        with self._lock:
            log = list(self._entries[replica_id]["log"])
        return "\n".join(log[-n:])

    def activate_faults(self, t0=None) -> None:
        """No-op on the process fleet: each child's injector self-anchors
        at its first request (no cross-process monotonic clock exists to
        share). The per-scope coin determinism is unaffected."""

    # -- chaos hooks ---------------------------------------------------------

    def kill(self, replica_id: str) -> None:
        """Real SIGKILL: the kernel reclaims the replica mid-request —
        no drain, no resets, clients discover the death as timeouts and
        refused reconnects. The supervisor (when on) relaunches it."""
        with self._lock:
            entry = self._entries[replica_id]
            proc = entry["proc"]
            entry["alive"] = False
            self.kills.append(replica_id)
        if proc.poll() is None:
            proc.send_signal(signal.SIGKILL)
            proc.wait(timeout=10.0)

    def restart(self, replica_id: str) -> None:
        """Manual relaunch on the ORIGINAL ports. With the supervisor on
        this is usually a no-op — it already relaunched the replica (a
        fault plan's restart event is then already satisfied)."""
        with self._lock:
            entry = self._entries[replica_id]
            if entry["proc"].poll() is None:
                return  # already running (supervisor beat us to it)
            self._relaunch_locked(replica_id, entry)
        self._await_listening(replica_id, self._entries[replica_id])

    def _relaunch_locked(self, rid: str, entry: dict) -> None:
        restarts = entry["restarts"] + 1
        fresh = self._spawn(
            rid, port=entry["port"], mux_port=entry.get("mux_port"),
            restarts=restarts,
        )
        fresh["restarts"] = restarts
        self._entries[rid] = fresh
        self.restarts.append(rid)

    def _supervise(self) -> None:
        """Relaunch dead children with capped deterministic backoff —
        the serving mirror of ``train/resilience.supervise``."""
        while not self._stop.wait(0.05):
            with self._lock:
                dead = [
                    (rid, e) for rid, e in self._entries.items()
                    if e["proc"].poll() is not None
                    and not e["deliberate_down"]
                ]
            for rid, entry in dead:
                delay = min(
                    self.backoff_cap_s,
                    self.backoff_s * (2 ** entry["restarts"]),
                )
                if self._stop.wait(delay):
                    return
                with self._lock:
                    # Re-check under the lock: stop_all may have marked
                    # the fleet down while we backed off.
                    if entry["deliberate_down"] or self._stop.is_set():
                        continue
                    if self._entries[rid]["proc"].poll() is None:
                        continue  # someone else already relaunched
                    self._relaunch_locked(rid, self._entries[rid])
                try:
                    self._await_listening(rid, self._entries[rid])
                except RuntimeError:
                    pass  # next sweep backs off longer and retries

    def stop_all(self) -> None:
        """Stop the supervisor, then terminate every child (SIGTERM →
        bounded wait → SIGKILL). Idempotent."""
        self._stop.set()
        if self._supervisor is not None:
            self._supervisor.join(timeout=10.0)
            self._supervisor = None
        with self._lock:
            entries = list(self._entries.values())
            for e in entries:
                e["deliberate_down"] = True
        for e in entries:
            proc = e["proc"]
            if proc.poll() is None:
                proc.terminate()
        end = time.monotonic() + 15.0
        for e in entries:
            proc = e["proc"]
            try:
                proc.wait(timeout=max(0.1, end - time.monotonic()))
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=5.0)
            e["alive"] = False

    def __enter__(self) -> "ProcessFleet":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop_all()
