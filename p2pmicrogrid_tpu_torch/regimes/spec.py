"""RegimeSpec: one world's weather / assets / events / market, as data.

The port of the JAX package's ``regimes/spec.py``. The paper's simulator
knows exactly one world — October Belgian traces, a heat pump as the only
schedulable load, midpoint P2P pricing. A ``RegimeSpec`` names one
alternative world as a flat bundle of numbers:

* **weather/season** — scale/offset transforms over the synthetic trace
  family (host traces and ``parallel/device_gen.py``'s alike): outdoor
  temperature offset, PV and load scales.
* **EV charging** — a second schedulable per-agent load with an energy need
  and a departure deadline; the agent's flexibility dial (the previous
  slot's heat-pump fraction) modulates the charge rate above a
  deadline-feasibility floor, and energy undelivered at the deadline is
  billed at a miss price.
* **event windows** — demand-response price spikes (buy price x mult in
  the window) and grid-outage islanding slots: grid exchange is masked to
  zero and unserved load is curtailed at a value-of-lost-load price.
* **market mechanism** — midpoint / k-double-auction / uniform-price
  clearing (``ops/auction.py``), one per regime.

Specs are host-side dataclasses (the JAX package's, verbatim);
``stack_regime_params`` turns a portfolio of R specs into ``RegimeParams``,
a NamedTuple of [R] tensors on a device, and ``assign_regimes`` gathers them
onto the scenario axis ([S] tensors). From there every regime field is DATA
of the scenario batch: one episode program, one CUDA graph of the chunk
episode, serves any mix of regimes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Sequence

import numpy as np
import torch

from p2pmicrogrid_tpu_torch.config import KWH_TO_WS
from p2pmicrogrid_tpu_torch.device import resolve_device
from p2pmicrogrid_tpu_torch.ops.auction import MECHANISM_IDS


@dataclass(frozen=True)
class RegimeSpec:
    """One composable world. Defaults are the paper's baseline world —
    an all-default spec is the identity transform (the regime engine is
    then bit-exact with the plain episode program; tests pin it)."""

    name: str = "baseline"

    # -- weather / season (applied to the synthetic trace family) --
    temp_offset_c: float = 0.0   # added to the outdoor temperature
    pv_scale: float = 1.0        # multiplies PV production
    load_scale: float = 1.0      # multiplies base household load

    # -- EV charging (second schedulable per-agent load) --
    ev_present: bool = False
    ev_max_power_w: float = 7000.0    # home-charger rating
    ev_arrival_slot: int = 72         # 18:00 at 15-min slots
    ev_deadline_slot: int = 96        # departure (end of day)
    ev_energy_kwh: float = 8.0        # energy to deliver by the deadline
    ev_miss_price_eur_kwh: float = 1.0  # billed per kWh undelivered

    # -- demand-response price spike [start, end) in slots --
    spike_start_slot: int = 0
    spike_end_slot: int = 0           # empty window = no event
    spike_mult: float = 1.0

    # -- grid-outage islanding window [start, end) in slots --
    outage_start_slot: int = 0
    outage_end_slot: int = 0          # empty window = no outage
    curtail_price_eur_kwh: float = 2.0  # value of lost load while islanded

    # -- market mechanism (ops/auction.py) --
    mechanism: str = "midpoint"       # midpoint | double_auction | uniform
    auction_k: float = 0.5

    def __post_init__(self):
        if self.mechanism not in MECHANISM_IDS:
            raise ValueError(
                f"unknown mechanism {self.mechanism!r}; expected one of "
                f"{sorted(MECHANISM_IDS)}"
            )
        if not 0 <= self.ev_arrival_slot < self.ev_deadline_slot <= 96:
            raise ValueError(
                f"EV window [{self.ev_arrival_slot}, {self.ev_deadline_slot}) "
                "must satisfy 0 <= arrival < deadline <= 96"
            )

    @property
    def is_baseline(self) -> bool:
        """True when every field is the identity transform."""
        return self == RegimeSpec(name=self.name)

    def fused_unstageable_features(self) -> list:
        """The regime features the fused slot kernel K7 does not stage
        (ops/slot_fused.py fuses obs→act→clear→settle→integrate for the
        BASELINE world only). Non-empty means ``fused_slot`` must refuse."""
        feats = []
        if self.ev_present:
            feats.append("EV load")
        if self.outage_end_slot > self.outage_start_slot:
            feats.append("islanding masks")
        if self.spike_end_slot > self.spike_start_slot:
            feats.append("price-spike windows")
        if self.mechanism != "midpoint":
            feats.append(f"auction mechanism {self.mechanism!r}")
        return feats


class RegimeParams(NamedTuple):
    """The tensor form of a regime portfolio: every field one float32 or
    int32 tensor with a leading regime axis ([R] stacked, [S] after
    assignment), on one device."""

    temp_offset_c: torch.Tensor      # f32
    pv_scale: torch.Tensor           # f32
    load_scale: torch.Tensor         # f32
    ev_present: torch.Tensor         # f32 0/1
    ev_max_power_w: torch.Tensor     # f32
    ev_arrival_slot: torch.Tensor    # i32
    ev_deadline_slot: torch.Tensor   # i32
    ev_energy_ws: torch.Tensor       # f32 (kWh converted once, host-side)
    ev_miss_price_eur_kwh: torch.Tensor  # f32
    spike_start_slot: torch.Tensor   # i32
    spike_end_slot: torch.Tensor     # i32
    spike_mult: torch.Tensor         # f32
    outage_start_slot: torch.Tensor  # i32
    outage_end_slot: torch.Tensor    # i32
    curtail_price_eur_kwh: torch.Tensor  # f32
    mechanism: torch.Tensor          # i32 (ops/auction.MECH_*)
    auction_k: torch.Tensor          # f32

    @property
    def n(self) -> int:
        return self.temp_offset_c.shape[0]


def stack_regime_params(specs: Sequence[RegimeSpec], device="cuda") -> RegimeParams:
    """[R]-tensor RegimeParams on ``device`` from a portfolio of specs (each
    value rounded to float32 or int32 on the host, as the JAX package
    does)."""
    if not specs:
        raise ValueError("empty regime portfolio")
    dev = resolve_device(device)
    f32 = lambda vals: torch.from_numpy(np.asarray(vals, dtype=np.float32)).to(dev)
    i32 = lambda vals: torch.from_numpy(np.asarray(vals, dtype=np.int32)).to(dev)
    return RegimeParams(
        temp_offset_c=f32([s.temp_offset_c for s in specs]),
        pv_scale=f32([s.pv_scale for s in specs]),
        load_scale=f32([s.load_scale for s in specs]),
        ev_present=f32([1.0 if s.ev_present else 0.0 for s in specs]),
        ev_max_power_w=f32([s.ev_max_power_w for s in specs]),
        ev_arrival_slot=i32([s.ev_arrival_slot for s in specs]),
        ev_deadline_slot=i32([s.ev_deadline_slot for s in specs]),
        ev_energy_ws=f32([s.ev_energy_kwh * KWH_TO_WS for s in specs]),
        ev_miss_price_eur_kwh=f32([s.ev_miss_price_eur_kwh for s in specs]),
        spike_start_slot=i32([s.spike_start_slot for s in specs]),
        spike_end_slot=i32([s.spike_end_slot for s in specs]),
        spike_mult=f32([s.spike_mult for s in specs]),
        outage_start_slot=i32([s.outage_start_slot for s in specs]),
        outage_end_slot=i32([s.outage_end_slot for s in specs]),
        curtail_price_eur_kwh=f32([s.curtail_price_eur_kwh for s in specs]),
        mechanism=i32([MECHANISM_IDS[s.mechanism] for s in specs]),
        auction_k=f32([s.auction_k for s in specs]),
    )


def regime_assignment(n_scenarios: int, n_regimes: int) -> np.ndarray:
    """Round-robin scenario->regime assignment ([S] int32, ``s % R``): a
    mixed batch covers every regime as evenly as S allows."""
    if n_scenarios < n_regimes:
        raise ValueError(
            f"n_scenarios={n_scenarios} < n_regimes={n_regimes}: every "
            "regime needs at least one scenario in the batch"
        )
    return (np.arange(n_scenarios) % n_regimes).astype(np.int32)


def assign_regimes(params: RegimeParams, assignment: np.ndarray) -> RegimeParams:
    """Gather [R] params onto the scenario axis: [S] tensors, scenario ``s``
    simulating regime ``assignment[s]``."""
    idx = torch.as_tensor(np.asarray(assignment, dtype=np.int64), device=params.temp_offset_c.device)
    return RegimeParams(*(leaf.index_select(0, idx) for leaf in params))


def assignment_one_hot(assignment: np.ndarray, n_regimes: int, device="cuda") -> torch.Tensor:
    """[S, R] float32 one-hot of the scenario->regime assignment: the
    segment-sum matrix the per-regime counters reduce through."""
    a = np.asarray(assignment)
    one_hot = (a[:, None] == np.arange(n_regimes)[None, :]).astype(np.float32)
    return torch.from_numpy(one_hot).to(resolve_device(device))


# -- the named portfolio library ----------------------------------------------

# Seasonal/extreme weather anchors: offsets/scales chosen around the
# October base family (mean 7-12 °C, PV weather factor 0.3-1.0) so winter
# sits near freezing, the cold snap well below it, and summer/heatwave
# above the comfort setpoint's neighborhood with long PV days.
REGIME_LIBRARY = {
    "baseline": RegimeSpec(name="baseline"),
    "winter": RegimeSpec(
        name="winter", temp_offset_c=-8.0, pv_scale=0.6, load_scale=1.2
    ),
    "summer": RegimeSpec(
        name="summer", temp_offset_c=8.0, pv_scale=1.4, load_scale=0.9
    ),
    "heatwave": RegimeSpec(
        name="heatwave", temp_offset_c=15.0, pv_scale=1.6, load_scale=1.1
    ),
    "cold_snap": RegimeSpec(
        name="cold_snap", temp_offset_c=-15.0, pv_scale=0.5, load_scale=1.3
    ),
    "ev_evening": RegimeSpec(name="ev_evening", ev_present=True),
    "dr_spike": RegimeSpec(
        # Evening demand-response event: 17:00-21:00, buy price x4.
        name="dr_spike", spike_start_slot=68, spike_end_slot=84,
        spike_mult=4.0,
    ),
    "islanding_noon": RegimeSpec(
        # Midday grid outage: 10:00-14:00, P2P-only clearing.
        name="islanding_noon", outage_start_slot=40, outage_end_slot=56,
    ),
    "double_auction": RegimeSpec(
        name="double_auction", mechanism="double_auction", auction_k=0.8
    ),
    "uniform_price": RegimeSpec(name="uniform_price", mechanism="uniform"),
}


def resolve_specs(names: Sequence) -> list:
    """RegimeSpec list from a mix of names (library lookups) and specs."""
    out = []
    for item in names:
        if isinstance(item, RegimeSpec):
            out.append(item)
        elif item in REGIME_LIBRARY:
            out.append(REGIME_LIBRARY[item])
        else:
            raise ValueError(
                f"unknown regime {item!r}; known: {sorted(REGIME_LIBRARY)}"
            )
    return out
