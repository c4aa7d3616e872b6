"""Environment and agent traces as time-major numpy arrays.

The port's own copy of the numpy-only part of the JAX package's
``data/traces.py``: ``TraceSet`` (with its per-day split), the seeded
synthetic October-like generator, the reference measurement database's
loader and day split, the per-agent profile assignment and the (state,
next_state) roll. Values are identical to the JAX package's for the same
seed or database. The native C++ generator is not ported yet.
"""

from __future__ import annotations

import sqlite3
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np

SLOTS_PER_DAY = 96

# Reference day splits (dataset.py:17-20): October 2021.
TRAINING_DAYS = list(range(11, 18))
VALIDATION_DAYS = [18]
TESTING_DAYS = [8, 9, 10, 19, 20]


class TraceSet(NamedTuple):
    """Time-major traces for a set of days.

    time:  [T] normalized slot-of-day in [0, 1)   (dataset.py:43-44)
    t_out: [T] outdoor temperature [°C]
    load:  [T, P] normalized household load profiles in [0, 1] (dataset.py:47-48)
    pv:    [T, P] normalized PV production in [0, 1]           (dataset.py:49)
    day:   [T] integer day-of-month tag (for per-day eval grouping,
           community.py:373-383)
    """

    time: np.ndarray
    t_out: np.ndarray
    load: np.ndarray
    pv: np.ndarray
    day: np.ndarray

    @property
    def n_profiles(self) -> int:
        return self.load.shape[1]

    def select_days(self, days: Sequence[int]) -> "TraceSet":
        mask = np.isin(self.day, np.asarray(days))
        return TraceSet(*(a[mask] for a in self))

    def split_by_day(self) -> Dict[int, "TraceSet"]:
        return {int(d): self.select_days([int(d)]) for d in np.unique(self.day)}

    def normalized(self) -> "TraceSet":
        """Per-column divide-by-max of load/pv (dataset.py:47-49).

        The reference normalizes *within each day split* (process_dataframe
        runs on the already-filtered days, dataset.py:61-80), so call this on
        a split, not on the full month.
        """
        return self._replace(
            load=(self.load / self.load.max(axis=0, keepdims=True)).astype(np.float32),
            pv=(self.pv / self.pv.max(axis=0, keepdims=True)).astype(np.float32),
        )


def _daily_profile(rng: np.random.Generator, n_days: int, kind: str) -> np.ndarray:
    """One [n_days * 96] synthetic profile of the requested kind."""
    t = np.arange(SLOTS_PER_DAY) / SLOTS_PER_DAY  # day fraction
    out = np.zeros((n_days, SLOTS_PER_DAY))
    for d in range(n_days):
        if kind == "load":
            base = 0.15 + 0.05 * rng.uniform()
            morning = 0.5 * np.exp(-((t - 7.5 / 24) ** 2) / (2 * (1.2 / 24) ** 2))
            evening = 0.9 * np.exp(-((t - 19.0 / 24) ** 2) / (2 * (2.0 / 24) ** 2))
            noise = 0.08 * rng.standard_normal(SLOTS_PER_DAY)
            out[d] = np.clip(base + morning + evening + noise, 0.02, None)
        elif kind == "pv":
            # October sun: production window ~8h-18h, weather-dependent peak.
            weather = rng.uniform(0.3, 1.0)
            bell = np.exp(-((t - 12.75 / 24) ** 2) / (2 * (2.2 / 24) ** 2))
            cloud = 1.0 - 0.3 * np.abs(np.sin(40 * np.pi * t + rng.uniform(0, np.pi)))
            out[d] = np.clip(weather * bell * cloud - 0.02, 0.0, None)
        elif kind == "temperature":
            mean = rng.uniform(7.0, 12.0)
            swing = rng.uniform(2.0, 5.0)
            # Daily minimum around 3 am, maximum mid-afternoon (3 pm).
            out[d] = mean + swing * np.sin(2 * np.pi * (t - 9.0 / 24)) + 0.3 * rng.standard_normal(SLOTS_PER_DAY)
        else:
            raise ValueError(kind)
    return out.reshape(-1)


def synthetic_traces(
    n_days: int = 13,
    n_profiles: int = 5,
    seed: int = 42,
    start_day: int = 8,
) -> TraceSet:
    """Seeded October-like synthetic traces.

    Defaults give days 8..20 so the reference day splits (train 11-17,
    val 18, test {8, 9, 10, 19, 20}; dataset.py:17-20) apply verbatim. Profiles
    mirror the reference's 5 household load columns l0..l4 (dataset.py:30); PV
    is one shared trace replicated per profile (the reference has a single
    ``pv`` column, dataset.py:29).
    """
    rng = np.random.default_rng(seed)
    T = n_days * SLOTS_PER_DAY

    time = np.tile(np.arange(SLOTS_PER_DAY) / SLOTS_PER_DAY, n_days).astype(np.float32)
    t_out = _daily_profile(rng, n_days, "temperature").astype(np.float32)

    load = np.stack(
        [_daily_profile(rng, n_days, "load") for _ in range(n_profiles)], axis=1
    )
    pv_single = _daily_profile(rng, n_days, "pv")
    pv = np.repeat(pv_single[:, None], n_profiles, axis=1)

    # Raw (unnormalized) traces: normalization is per day-split, matching the
    # reference (process_dataframe runs after day filtering, dataset.py:61-80)
    # — use TraceSet.normalized() on each split.
    load = load.astype(np.float32)
    pv = pv.astype(np.float32)

    day = np.repeat(np.arange(start_day, start_day + n_days), SLOTS_PER_DAY).astype(np.int32)
    assert time.shape[0] == T
    return TraceSet(time=time, t_out=t_out, load=load, pv=pv, day=day)


def _inner_join(left: list, right: list, left_key, right_key) -> list:
    """(left row, right row) pairs whose keys match, in pandas' inner-merge
    order: the left rows in order, each with its matches in the right's
    order."""
    by_key: dict = {}
    for r in right:
        by_key.setdefault(right_key(r), []).append(r)
    return [(l, r) for l in left for r in by_key.get(left_key(l), ())]


def load_reference_db(
    db_path: str,
    month: int = 10,
    days: Optional[Sequence[int]] = None,
    load_cols: Sequence[str] = ("l0", "l1", "l2", "l3", "l4"),
) -> TraceSet:
    """Ingest the reference's SQLite measurement DB (database.py:28-43 schema).

    Joins ``environment`` and ``load`` on (date, time, utc) (database.py:128-147),
    computes the slot-of-day encoding (dataset.py:34-44), and tags rows with
    day-of-month. The JAX package joins with pandas; this loader joins in
    Python over the same two ``SELECT *`` reads, in pandas' inner-merge row
    order, with the same casts, so the traces are equal bit for bit.
    """
    con = sqlite3.connect(db_path)
    try:
        reads = []
        for table in ("environment", "load"):
            cur = con.execute(f"SELECT * FROM {table}")
            cols = [d[0] for d in cur.description]
            reads.append([dict(zip(cols, row)) for row in cur.fetchall()])
    finally:
        con.close()

    key = lambda r: (r["date"], r["time"], r["utc"])
    rows = []
    for env, load in _inner_join(reads[0], reads[1], key, key):
        _, m, d = env["date"].split("-")[:3]
        if int(m) != month or (days is not None and int(d) not in list(days)):
            continue
        rows.append((int(d), env, load))

    def slot(timestr: str) -> float:
        h, m, _ = timestr.split(":")
        return int(m) / 15 + int(h) * 4

    def column(values) -> np.ndarray:
        # pandas' astype(float): strings parse, NULL becomes NaN.
        return np.array(list(values), dtype=np.float64).reshape(-1)

    time = (np.array([slot(e["time"]) for _, e, _ in rows], dtype=np.float64).reshape(-1)
            / SLOTS_PER_DAY).astype(np.float32)
    t_out = column(e["temperature"] for _, e, _ in rows).astype(np.float32)
    load = np.stack(
        [column(l[c] for _, _, l in rows) for c in load_cols], axis=1
    ).astype(np.float32)
    pv_single = column(e["pv"] for _, e, _ in rows).astype(np.float32)
    pv = np.repeat(pv_single[:, None], len(load_cols), axis=1)

    # Raw traces; normalize per split via TraceSet.normalized().
    day = np.array([d for d, _, _ in rows], dtype=np.int64).reshape(-1).astype(np.int32)
    return TraceSet(time=time, t_out=t_out, load=load, pv=pv, day=day)


def train_validation_test_split(
    traces: TraceSet,
) -> Tuple[TraceSet, TraceSet, TraceSet]:
    """Reference day split (dataset.py:17-20,83-95), each split normalized
    within itself exactly as the reference's process_dataframe does (it runs on
    the already-filtered days)."""
    return (
        traces.select_days(TRAINING_DAYS).normalized(),
        traces.select_days(VALIDATION_DAYS).normalized(),
        traces.select_days(TESTING_DAYS).normalized(),
    )


def agent_profiles(
    traces: TraceSet,
    n_agents: int,
    load_ratings_w: np.ndarray,
    pv_ratings_w: np.ndarray,
    homogeneous: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """Denormalized per-agent power traces in W.

    Mirrors community.py:219-224: agent i uses profile ``i % n_profiles``
    (homogeneous: profile 0 for all, community.py:203-204) scaled by its
    rating in W. Returns (load_w, pv_w) each [T, A].
    """
    idx = np.zeros(n_agents, dtype=int) if homogeneous else np.arange(n_agents) % traces.n_profiles
    load_w = traces.load[:, idx] * np.asarray(load_ratings_w)[None, :]
    pv_w = traces.pv[:, idx] * np.asarray(pv_ratings_w)[None, :]
    return load_w.astype(np.float32), pv_w.astype(np.float32)


def next_slot(x: np.ndarray) -> np.ndarray:
    """The reference's (state, next_state) pairing: roll -1 along time
    (dataset.py:98-103); the last slot wraps to the first."""
    return np.roll(x, -1, axis=0)
