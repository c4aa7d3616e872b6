"""Device counters: what a training episode saw, totalled on the device.

The port of the JAX package's ``telemetry/device_metrics.py``. Nothing on the
host sees inside an episode that runs without a synchronisation (or as one
CUDA graph replay): a NaN in the critic, agents below the comfort band for a
whole day, or a market round that leaves most energy unmatched show only in
the episode's reward, if at all. ``DeviceCounters`` holds five 0-d tensors
that each slot adds to on the device; the host reads them once per episode
or block, as a handful of scalars.

Counters (per-episode totals; batched shapes sum over every axis):

* ``nonfinite_q``        NaN/Inf entries in the actor's value estimates.
* ``nonfinite_loss``     NaN/Inf entries in the per-slot learn loss.
* ``comfort_violations`` agent-slots with the pre-step indoor temperature
                         outside the comfort band.
* ``market_residual_wh`` |energy| settled with the grid after P2P clearing.
* ``trade_wh``           P2P-matched energy actually traded.

The counts are int32 and the energies float32, as in the JAX package.
A slot loop keeps its counts in a ``SlotTally``: each slot writes its
partial sums over the agent axis into its own row (``dc_tally_slot_``, 8
small kernels), and ``dc_from_tally`` totals the rows once an episode.
No slot reduces to a single value: on the card that is the dearest of the
small kernels (PERF.md, section 5). An episode captured as a CUDA graph
writes the same memory at every replay. ``dc_psum`` and ``dc_mesh_sum`` wait for the port's mesh
(ROADMAP.md, Queue 1, item 7).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class DeviceCounters(NamedTuple):
    """The five counters, each a 0-d tensor."""

    nonfinite_q: torch.Tensor         # int32
    nonfinite_loss: torch.Tensor      # int32
    comfort_violations: torch.Tensor  # int32 agent-slots outside the band
    market_residual_wh: torch.Tensor  # float32 grid-settled |energy|, Wh
    trade_wh: torch.Tensor            # float32 P2P-matched energy, Wh


_DTYPES = (torch.int32, torch.int32, torch.int32, torch.float32, torch.float32)


def dc_zero(device) -> DeviceCounters:
    """Fresh zero counters on ``device``, which the caller names: no default
    can land counters of a run on the card on the CPU."""
    return DeviceCounters(*(torch.zeros((), dtype=dt, device=device) for dt in _DTYPES))


def dc_reset_(dc: DeviceCounters) -> DeviceCounters:
    """Zero ``dc`` in place."""
    for x in dc:
        x.zero_()
    return dc


def dc_add(a: DeviceCounters, b: DeviceCounters) -> DeviceCounters:
    """The sum of two counter sets, as new tensors."""
    return DeviceCounters(*(x + y for x, y in zip(a, b)))


def dc_add_(acc: DeviceCounters, b: DeviceCounters) -> DeviceCounters:
    """Add ``b`` to ``acc`` in place and return ``acc``."""
    for x, y in zip(acc, b):
        x.add_(y)
    return acc


def dc_from_slot(cfg, outputs, loss=None) -> DeviceCounters:
    """One slot's counts from its ``SlotOutputs`` ([A] or [S, A]; every
    reduction sums all axes). ``loss`` overrides ``outputs.loss`` where the
    learn step runs after the dynamics."""
    th = cfg.thermal
    l = outputs.loss if loss is None else loss
    t = outputs.t_in
    hours = cfg.sim.slot_hours
    return DeviceCounters(
        nonfinite_q=(~torch.isfinite(outputs.q)).sum().to(torch.int32),
        nonfinite_loss=(~torch.isfinite(l)).sum().to(torch.int32),
        comfort_violations=((t < th.lower_bound) | (t > th.upper_bound)).sum().to(torch.int32),
        market_residual_wh=(outputs.p_grid.abs().sum() * hours).to(torch.float32),
        trade_wh=(outputs.p_p2p.clamp_min(0.0).sum() * hours).to(torch.float32),
    )


class SlotTally:
    """Per-slot partial sums of an episode's counters.

    ``rows[t]`` [5, *batch] holds slot t's sums over the agent axis of its
    non-finite q entries, its agents below and above the comfort band, its
    |p_grid| and its max(p_p2p, 0); ``loss_diff[t]`` is ``loss - loss``, NaN
    exactly where the loss is not finite. The buffers are allocated at the
    first slot written (a capture's eager warm-up, outside the graph) and
    every later episode overwrites them, so a tally needs no zeroing.
    """

    def __init__(self, n_slots: int):
        self.n_slots = n_slots
        self.rows = self.loss_diff = self.scratch = self.diff = None

    def _allocate(self, q: torch.Tensor, loss: torch.Tensor) -> None:
        self.scratch = torch.empty((5,) + tuple(q.shape), dtype=torch.float32, device=q.device)
        self.diff = torch.empty_like(q)
        self.rows = torch.empty((self.n_slots, 5) + tuple(q.shape[:-1]), dtype=torch.float32, device=q.device)
        self.loss_diff = torch.empty((self.n_slots,) + tuple(loss.shape), dtype=loss.dtype, device=loss.device)


def dc_tally_slot_(tally: SlotTally, t: int, cfg, outputs, loss=None) -> None:
    """Write slot ``t``'s partial sums into ``tally``: the quantities of
    ``dc_from_slot`` elementwise into one scratch buffer, then one sum over
    the agent axis (8 small kernels, none a reduction to a single value).
    Every agent leaf of ``outputs`` has the shape of ``outputs.q``."""
    th = cfg.thermal
    q = outputs.q
    l = outputs.loss if loss is None else loss
    if tally.rows is None:
        tally._allocate(q, l)
    s = tally.scratch
    torch.sub(q, q, out=tally.diff)  # NaN exactly where q is not finite
    torch.ne(tally.diff, tally.diff, out=s[0])
    # The band's bounds are ordered: below and above never overlap, so the
    # two counts add up to dc_from_slot's comfort count.
    torch.lt(outputs.t_in, th.lower_bound, out=s[1])
    torch.gt(outputs.t_in, th.upper_bound, out=s[2])
    torch.abs(outputs.p_grid, out=s[3])
    torch.clamp_min(outputs.p_p2p, 0.0, out=s[4])
    torch.sum(s, dim=-1, out=tally.rows[t])
    torch.sub(l, l, out=tally.loss_diff[t])


def dc_from_tally(cfg, tally: SlotTally) -> DeviceCounters:
    """The episode's counters from its tally: the counts summed as integers
    (each partial is a whole number of agents), the energies scaled to Wh
    (as ``dc_from_slot`` does) and summed."""
    rows = tally.rows
    over = (0,) + tuple(range(2, rows.dim()))  # every axis but the quantity's
    counts = rows[:, :3].to(torch.int64).sum(dim=over)
    energy = (rows[:, 3:] * cfg.sim.slot_hours).sum(dim=over)
    return DeviceCounters(
        nonfinite_q=counts[0].to(torch.int32),
        nonfinite_loss=torch.isnan(tally.loss_diff).sum().to(torch.int32),
        comfort_violations=(counts[1] + counts[2]).to(torch.int32),
        market_residual_wh=energy[0],
        trade_wh=energy[1],
    )


def replay_fill_fraction(state):
    """Fill fraction (count / capacity) of a replay-carrying state, a Python
    float, or None for a learner without a ring (tabular). Accepts a
    ``LockstepReplay``/``ReplayState`` or a state with a ``.replay`` field
    (``DDPGScenState``, ``DDPGState``, ``DQNState``). The port's rings keep
    their count on the host (``models/replay.py``), so this reads no device
    memory."""
    if state is None:
        return None
    replay = getattr(state, "replay", state)
    count = getattr(replay, "count", None)
    capacity = getattr(replay, "capacity", None)
    if count is None or capacity is None:
        return None
    return float(np.float32(count) / np.float32(capacity))


def dc_to_dict(dc) -> dict:
    """Counters (tensors, or numpy values already read back) as host Python
    numbers; leaves with a leading axis sum over it."""
    out = {}
    for name, v in dc._asdict().items():
        a = v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
        total = a.sum()
        out[name] = int(total) if np.issubdtype(a.dtype, np.integer) else float(total)
    return out
