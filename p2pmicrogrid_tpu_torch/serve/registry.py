"""Hot-swap bundle registry: multi-bundle serving keyed by config_hash.

One gateway process serves MANY policy bundles — the new default rolling
out next to the incumbent, an A/B candidate taking a percentage slice —
and traffic must move between them without dropping a request. The
registry is the routing table that makes that safe:

* **Identity is the manifest ``config_hash``.** A bundle's manifest pins
  the training config that produced it (serve/export.py); the hash is
  what the telemetry warehouse joins on, so routing by it means every
  served request is attributable to the exact config that answered it.
* **Atomic swap.** ``swap(config_hash)`` retargets the default bundle in
  one lock-held assignment. Requests already submitted to the old
  bundle's queue complete there (the queue keeps its engine reference);
  requests routed after the swap go to the new default. Nothing is ever
  torn down mid-request by a swap — ``remove`` is a separate, explicit
  step the operator takes once the old bundle has drained.
* **Percentage-split A/B.** ``set_split(hash_b, percent)`` routes that
  share of households to bundle B, deterministically by household-id
  hash, so a household does not flip arms between slots.
* **Household pinning (bundle affinity).** The first routed request pins
  a household to its bundle; later requests reuse the pin. Serving
  sessions carry cross-slot state (engine.Sessions), so a household must
  see one policy's trajectory, not an interleaving of two. A ``swap``
  clears pins — that is the point of a swap: every household re-routes
  to the new default/split outcome on its next slot. Removing a bundle
  clears only the pins that pointed at it.

Thread-safety: every mutation and ``route`` hold one RLock; the gateway's
asyncio handlers and the microbatch worker threads can hit the registry
concurrently.
"""

from __future__ import annotations

import hashlib
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple


@dataclass
class ServingBundle:
    """One registered bundle: the engine, its coalescing queue front and
    (optionally) the telemetry bound to the bundle's config_hash."""

    config_hash: str
    engine: object          # serve.engine.PolicyEngine
    queue: object           # serve.engine.MicroBatchQueue
    telemetry: object = None

    @property
    def implementation(self) -> Optional[str]:
        return self.engine.manifest.get("implementation")


def _household_slot(household_id: str) -> int:
    """Deterministic [0, 100) slot for a household id — stable across
    processes and restarts (hashlib, not ``hash()``, which is salted)."""
    digest = hashlib.sha256(household_id.encode()).hexdigest()
    return int(digest[:8], 16) % 100


class BundleRegistry:
    """Routing table over >= 1 ``ServingBundle``s with atomic hot-swap,
    percentage-split A/B and per-household bundle affinity."""

    def __init__(self):
        self._lock = threading.RLock()
        self._bundles: Dict[str, ServingBundle] = {}
        self._default: Optional[str] = None
        self._split: Optional[Tuple[str, float]] = None  # (hash_b, percent)
        self._pins: Dict[str, str] = {}
        # Incremental per-bundle pin tallies, maintained on every pin
        # mutation (ROADMAP item 4): stats() must stay O(bundles) — at a
        # million pinned households, re-counting the id-keyed map per
        # snapshot would make every /stats poll iterate the id space.
        self._pin_counts: Dict[str, int] = {}
        self.swap_count = 0

    # -- membership ----------------------------------------------------------

    def register(
        self,
        engine,
        queue,
        telemetry=None,
        default: bool = False,
    ) -> str:
        """Add a bundle; returns its config_hash. The first registered
        bundle becomes the default; ``default=True`` retargets it."""
        config_hash = engine.manifest.get("config_hash")
        if not config_hash:
            raise ValueError("bundle manifest carries no config_hash")
        with self._lock:
            if config_hash in self._bundles:
                raise ValueError(
                    f"bundle {config_hash} already registered — a second "
                    "copy of the same config cannot be routed distinctly"
                )
            self._bundles[config_hash] = ServingBundle(
                config_hash=config_hash,
                engine=engine,
                queue=queue,
                telemetry=telemetry,
            )
            if default or self._default is None:
                self._default = config_hash
        return config_hash

    def remove(self, config_hash: str) -> ServingBundle:
        """Unregister (the caller drains/closes the returned bundle). The
        default and the split arm cannot be removed while active."""
        with self._lock:
            if config_hash not in self._bundles:
                raise KeyError(f"no bundle {config_hash} registered")
            if config_hash == self._default:
                raise ValueError(
                    f"bundle {config_hash} is the default — swap first"
                )
            if self._split and self._split[0] == config_hash:
                raise ValueError(
                    f"bundle {config_hash} is the active split arm — "
                    "clear the split first"
                )
            bundle = self._bundles.pop(config_hash)
            # Control-plane op (not the per-request path): dropping one
            # bundle's pins rebuilds the map once per remove.
            self._pins = {
                h: c for h, c in self._pins.items() if c != config_hash
            }
            self._pin_counts.pop(config_hash, None)
            return bundle

    def get(self, config_hash: str) -> ServingBundle:
        with self._lock:
            return self._bundles[config_hash]

    @property
    def hashes(self) -> List[str]:
        with self._lock:
            return list(self._bundles)

    @property
    def default_hash(self) -> Optional[str]:
        with self._lock:
            return self._default

    @property
    def split(self) -> Optional[Tuple[str, float]]:
        with self._lock:
            return self._split

    # -- routing control -----------------------------------------------------

    def swap(self, config_hash: str) -> str:
        """Atomically make ``config_hash`` the default bundle and clear
        every household pin: a swap means every household re-routes on its
        next request. In-flight requests finish on the bundle that
        admitted them. Returns the PREVIOUS default hash."""
        with self._lock:
            if config_hash not in self._bundles:
                raise KeyError(f"no bundle {config_hash} registered")
            previous, self._default = self._default, config_hash
            if self._split and self._split[0] == config_hash:
                # The candidate just became the default; the experiment
                # routing to it is moot.
                self._split = None
            self._pins.clear()
            self._pin_counts.clear()
            self.swap_count += 1
            return previous

    def set_split(self, config_hash: str, percent: float) -> None:
        """Route ``percent``% of households (deterministic by id hash) to
        ``config_hash``; the rest stay on the default. Existing pins are
        kept — only unpinned households land in the new split."""
        if not 0.0 < percent < 100.0:
            raise ValueError(f"percent must be in (0, 100), got {percent}")
        with self._lock:
            if config_hash not in self._bundles:
                raise KeyError(f"no bundle {config_hash} registered")
            if config_hash == self._default:
                raise ValueError(
                    "split arm must differ from the default bundle"
                )
            self._split = (config_hash, float(percent))

    def clear_split(self) -> None:
        with self._lock:
            self._split = None

    def clear_pins(self) -> None:
        """Drop every household's bundle affinity so the NEXT request
        re-routes against the current default/split. The canary ramp
        (serve/promotion.py) calls this when WIDENING a split: pins
        recorded at 5% would otherwise freeze the arm's membership —
        set_split only assigns unpinned households, so the 25% stage
        would keep serving the 5% population. Re-rolling is monotone for
        the households already in the arm (the split hash is per-
        household deterministic: slot < 5 implies slot < 25), so their
        sessions survive the widening."""
        with self._lock:
            self._pins.clear()
            self._pin_counts.clear()

    # -- routing hot path ----------------------------------------------------

    def route(self, household_id: Optional[str] = None) -> ServingBundle:
        """The bundle serving this household. Households pinned during a
        split keep their bundle (session affinity); new ones are assigned
        by the split (or the default). Pins are only recorded WHILE a
        split is active — with no split every household serves the
        default anyway, and pinning each of millions of household ids
        would grow the pin map without bound for zero routing
        information. Anonymous requests (no id) always serve from the
        DEFAULT: a split is a household experiment, and hashing the empty
        id would send ALL anonymous traffic to one arm (sha256('') is a
        constant slot) instead of a percentage."""
        with self._lock:
            if self._default is None:
                raise RuntimeError("no bundles registered")
            if household_id:
                pinned = self._pins.get(household_id)
                if pinned is not None and pinned in self._bundles:
                    return self._bundles[pinned]
            chosen = self._default
            if self._split is not None and household_id:
                arm, percent = self._split
                if _household_slot(household_id) < percent:
                    chosen = arm
                # O(1) per request: one dict write + tally adjust — the
                # split hash above is constant-time, and nothing on this
                # path scales with how many households exist.
                previous = self._pins.get(household_id)
                if previous != chosen:
                    if previous is not None:
                        self._pin_counts[previous] = (
                            self._pin_counts.get(previous, 1) - 1
                        )
                    self._pin_counts[chosen] = (
                        self._pin_counts.get(chosen, 0) + 1
                    )
                self._pins[household_id] = chosen
            return self._bundles[chosen]

    # -- observability / lifecycle -------------------------------------------

    @property
    def pinned_count(self) -> int:
        with self._lock:
            return len(self._pins)

    def stats(self) -> dict:
        """Per-bundle serving stats snapshot — lock-held and O(bundles),
        NEVER O(pins): the per-bundle pinned tallies are maintained
        incrementally on the route path, so a million-household split does
        not turn every /stats poll into an id-space scan
        (tests/test_scale.py regression-tests this at 1M ids)."""
        import numpy as np

        with self._lock:
            bundles = {}
            for h, b in self._bundles.items():
                # list() first: the queue worker appends concurrently, and
                # a Python-level comprehension over a mutating deque
                # raises ("deque mutated during iteration"); list() is one
                # C call and cannot interleave.
                waits = [w for _, w in list(b.queue.recent_wait_ms)]
                bundles[h] = {
                    "implementation": b.implementation,
                    "n_agents": b.engine.n_agents,
                    "requests": b.engine.stats["rows"],
                    "batches": b.engine.stats["batches"],
                    "padded_rows": b.engine.stats["padded_rows"],
                    "queue_depth": b.queue.depth,
                    "recent_wait_p95_ms": (
                        round(float(np.percentile(waits, 95)), 3)
                        if waits else 0.0
                    ),
                    "pinned_households": self._pin_counts.get(h, 0),
                }
            return {
                "default": self._default,
                "split": (
                    {"config_hash": self._split[0], "percent": self._split[1]}
                    if self._split else None
                ),
                "swap_count": self.swap_count,
                "bundles": bundles,
            }

    def close_all(self) -> None:
        """Close EVERY bundle's queue (waits for its worker; the queue's
        own join timeout bounds a stuck one) and telemetry. Skipping any
        bundle would strand its worker thread and lose the telemetry rows
        still buffered in its warehouse sink, so there is no early-out
        here — every close runs. Idempotent; called by the owner once the
        gateway has drained."""
        with self._lock:
            bundles = list(self._bundles.values())
        for b in bundles:
            b.queue.close()
            if b.telemetry is not None:
                b.telemetry.close()
