"""Monte-Carlo scenario synthesis on the device.

The port of the JAX package's ``parallel/device_gen.py``: the chunked trainer
(``scenarios.py::train_scenarios_chunked``) makes each chunk's load, PV and
outdoor-temperature traces on the card from a handful of random draws, so
nothing crosses from the host per chunk and every chunk is a fresh draw.

The profile family is ``data/traces.py``'s: morning and evening load peaks, a
weather-scaled PV bell with cloud flicker, a sinusoidal outdoor temperature,
per-scenario max-normalisation (reference dataset.py:47-49) and the
``roll(-1)`` (state, next state) pairing (dataset.py:98-103).

The seven draws form one ``TraceDraws``. They come from a ``torch.Generator``
or are injected (the tests feed the JAX package's own draws, rebuilt from
``jax.random.split(key, 7)``), as ``EpisodeDraws`` does for an episode.
The JAX package's constants are Python doubles that reach float32 rounded
once; they are written the same way here, and every division by a constant
is a multiplication by its float32 reciprocal (``ops/_f32.py``), as the
jitted reference computes it.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from p2pmicrogrid_tpu_torch.config import ExperimentConfig
from p2pmicrogrid_tpu_torch.data.traces import SLOTS_PER_DAY
from p2pmicrogrid_tpu_torch.device import resolve_device
from p2pmicrogrid_tpu_torch.envs.community import AgentRatings, EpisodeArrays, ratings_to
from p2pmicrogrid_tpu_torch.ops._f32 import recip

N_PROFILES = 5  # load profiles (data/traces.py's default)


class TraceDraws(NamedTuple):
    """The random draws of one chunk's traces, in the JAX package's split
    order (``k_base, k_lnoise, k_weather, k_phase, k_tmean, k_tswing,
    k_tnoise``).

    base:    [S, 1, P] uniform in [0, 1) — each load profile's base level
    lnoise:  [S, T, P] standard normals — load noise
    weather: [S, 1] uniform in [0.3, 1) — the PV peak
    phase:   [S, 1] uniform in [0, pi) — the cloud flicker's phase
    t_mean:  [S, 1] uniform in [7, 12) — mean outdoor temperature
    swing:   [S, 1] uniform in [2, 5) — its daily swing
    tnoise:  [S, T] standard normals — temperature noise
    """

    base: torch.Tensor
    lnoise: torch.Tensor
    weather: torch.Tensor
    phase: torch.Tensor
    t_mean: torch.Tensor
    swing: torch.Tensor
    tnoise: torch.Tensor


def draw_traces(
    n_scenarios: int, generator: Optional[torch.Generator] = None, device="cuda"
) -> TraceDraws:
    """The seven draws from ``generator``, in ``TraceDraws`` order."""
    dev = resolve_device(device)
    S, P, T = n_scenarios, N_PROFILES, SLOTS_PER_DAY

    def uniform(shape, low=0.0, high=1.0):
        return torch.empty(shape, device=dev).uniform_(low, high, generator=generator)

    return TraceDraws(
        base=uniform((S, 1, P)),
        lnoise=torch.randn((S, T, P), generator=generator, device=dev),
        weather=uniform((S, 1), 0.3, 1.0),
        phase=uniform((S, 1), 0.0, math.pi),
        t_mean=uniform((S, 1), 7.0, 12.0),
        swing=uniform((S, 1), 2.0, 5.0),
        tnoise=torch.randn((S, T), generator=generator, device=dev),
    )


def _bell(t: torch.Tensor, center: float, width: float) -> torch.Tensor:
    """``exp(-((t - center) ** 2) / (2 * width ** 2))`` with the JAX
    package's constants (Python doubles, rounded to float32 once); the
    exponential is taken in float64 and rounded once, so the CPU and the card
    agree."""
    return torch.exp((-torch.square(t - center) * recip(2 * width**2)).double()).float()


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """``a * b + c`` rounded once to float32, as the jitted reference
    contracts it; a Python ``b`` or ``c`` is a float32 constant. The float32
    product is exact in float64."""
    f32 = lambda x: x.double() if torch.is_tensor(x) else float(np.float32(x))
    return (a.double() * f32(b) + f32(c)).float()


def device_scenario_traces(
    n_scenarios: int,
    generator: Optional[torch.Generator] = None,
    draws: Optional[TraceDraws] = None,
    device="cuda",
):
    """One day of synthetic traces for S scenarios, made on ``device`` from
    ``draws`` (``TraceDraws``) or, without them, from ``generator``.

    Returns (time [T], t_out [S, T], load [S, T, P], pv [S, T]) with load
    and pv max-normalised per scenario to [0, 1] (dataset.py:47-49). The slot
    grid is shared by every scenario.
    """
    if draws is None:
        draws = draw_traces(n_scenarios, generator, device)
    dev = draws.lnoise.device
    T = SLOTS_PER_DAY
    steps = torch.arange(T, dtype=torch.float32, device=dev)
    t = steps * recip(T)

    # Load: base + morning/evening peaks + noise (traces.py:81-86).
    base = 0.15 + 0.05 * draws.base
    morning = 0.5 * _bell(t, 7.5 / 24, 1.2 / 24)
    evening = 0.9 * _bell(t, 19.0 / 24, 2.0 / 24)
    load = torch.clamp(_fma(draws.lnoise, 0.08, base + (morning + evening)[None, :, None]), min=0.02)
    load = load / torch.clamp(load.amax(dim=1, keepdim=True), min=1e-6)

    # PV: one weather-scaled bell with cloud flicker a scenario (traces.py:87-92).
    # The reference folds 40 * pi / T into one float32 constant and contracts
    # the sine's argument, the cloud and the PV into fused multiply-adds:
    # rounded apart, the argument (up to ~128 rad) moves the sine by up to
    # 7.6e-6, and the PV's difference with 0.02 cancels near the clip.
    freq = float(np.float32(recip(T)) * np.float32(40 * math.pi))
    arg = _fma(steps[None, :], freq, draws.phase)
    sine = torch.sin(arg.double()).float()
    cloud = _fma(torch.abs(sine), -0.3, 1.0)
    bell = _bell(t, 12.75 / 24, 2.2 / 24)
    pv = torch.clamp(_fma(draws.weather * bell[None, :], cloud, -0.02), min=0.0)
    pv = pv / torch.clamp(pv.amax(dim=1, keepdim=True), min=1e-6)

    # Outdoor temperature: minimum ~3 am, maximum mid-afternoon (traces.py:93-97).
    t_out = (
        draws.t_mean
        + draws.swing * torch.sin(2 * math.pi * (t[None, :] - 9.0 / 24))
        + 0.3 * draws.tnoise
    )
    return t, t_out, load, pv


def device_episode_arrays(
    cfg: ExperimentConfig,
    ratings: AgentRatings,
    n_scenarios: int,
    generator: Optional[torch.Generator] = None,
    draws: Optional[TraceDraws] = None,
    device="cuda",
) -> EpisodeArrays:
    """Scenario-stacked ``EpisodeArrays`` ([S, T, ...]) made on the device:
    agent i takes profile ``i % P`` (profile 0 for a homogeneous community)
    scaled by its load rating, and the one PV trace scaled by its PV rating
    (``data/traces.py::agent_profiles``); ``next_*`` is the ``roll(-1)``
    pairing along time."""
    A = cfg.sim.n_agents
    t, t_out, load, pv = device_scenario_traces(n_scenarios, generator, draws, device=device)
    dev = load.device
    # Ratings already on the device (the episode's) are taken as they are, so
    # a captured episode copies nothing from the host.
    r = ratings if torch.is_tensor(ratings.load_rating_w) else ratings_to(ratings, dev)
    if cfg.sim.homogeneous:
        idx = torch.zeros((A,), dtype=torch.int64, device=dev)
    else:
        idx = torch.arange(A, device=dev) % load.shape[2]
    load_w = load.index_select(2, idx) * r.load_rating_w
    pv_w = pv[:, :, None] * r.pv_rating_w
    time = t[None, :].expand(n_scenarios, t.shape[0])
    roll = lambda x: torch.roll(x, -1, dims=1)
    return EpisodeArrays(
        time=time,
        t_out=t_out,
        load_w=load_w,
        pv_w=pv_w,
        next_time=roll(time),
        next_load_w=roll(load_w),
        next_pv_w=roll(pv_w),
    )
