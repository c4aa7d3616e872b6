"""The fused training slot (kernel K7) and its plain version.

The counterpart of the JAX package's ``ops/pallas_slot.py``: one whole
training slot of S scenarios (tariff, battery rule, observation features,
the tabular or DQN act in every negotiation round, the factored, matrix or
no-trading clearing, settlement, reward and the 2R2C thermal step) as one
launch. It is a drop-in for the unfused chain of
``envs/community.py::slot_dynamics_batched`` (``fused=True`` there), and
``slot_step_fused_single`` for the single community's ``slot_dynamics``;
learning stays outside and consumes the returned transition.

* ``slot_step_fused`` launches the CUDA kernel (``csrc/slot_fused.cu``) for
  tensors on a CUDA device, counted in ``slot_step_fused.launches``, and runs
  ``slot_step_fused_plain`` for tensors on the CPU; there is no fallback from
  one to the other, and a failed build or launch raises. Either way the raw
  per-agent results are assembled into the chain's ``(phys', SlotOutputs,
  SlotTransition)`` by ``assemble_outputs`` (pallas_slot.py:528-563).
* ``slot_step_fused_plain`` is the same slot in plain PyTorch, written as
  the JAX fused kernel writes it: the chain's own functions, the plain merged
  min for the factored clearing, and ``ops/market.py``'s
  ``zero_diagonal``/``divide_power``/``clear_market`` for the matrix
  negotiation (always float32, any rounds).

The exploration draws come from outside, as the chain draws them: per round
``uniform`` [R, S, A] float32 and ``randint`` [R, S, A] integer in [0, 3);
an agent explores where ``uniform < epsilon``. The random-action bound is
``num_actions`` for tabular and 3 for DQN (pallas_slot.py:339-341), the same
number here since the tabular learner has 3 actions. DDPG is refused: its
exploration noise advances inside the act.

The learner state holds L learners on its leading axis (the Q-table
``[L, ...]``, the DQN weights ``[L, ...]``): L = A, one learner for every
scenario (the shared trainer), or L = S * A, one for each (scenario, agent)
(the independent trainer, whose learners ``parallel/scenarios.py`` keeps
scenario-major). Agent a of scenario s reads learner ``a`` or ``s * A + a``
(``per_scenario_learners``); at S = 1 the two coincide.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from p2pmicrogrid_tpu_torch.config import CENTS_PER_EURO, HOURS_PER_DAY, ExperimentConfig
from p2pmicrogrid_tpu_torch.models.dqn import _q_all_actions, action_values_on
from p2pmicrogrid_tpu_torch.models.tabular import q_rows
from p2pmicrogrid_tpu_torch.ops._build import KernelLibrary, count_launch, launch
from p2pmicrogrid_tpu_torch.ops._f32 import recip, sqrt
from p2pmicrogrid_tpu_torch.ops.battery import battery_rule_update
from p2pmicrogrid_tpu_torch.ops.factored_market import (
    clear_factored_rounds0,
    clear_factored_rounds1,
)
from p2pmicrogrid_tpu_torch.ops.market import clear_market, compute_costs, divide_power, zero_diagonal
from p2pmicrogrid_tpu_torch.ops.merged_min import merged_min_sums_plain
from p2pmicrogrid_tpu_torch.ops.obs import make_observation
from p2pmicrogrid_tpu_torch.ops.tariff import grid_prices, p2p_price as p2p_price_fn
from p2pmicrogrid_tpu_torch.ops.thermal import (
    comfort_penalty,
    normalized_temperature,
    thermal_step,
)

# The per-agent width the kernel's DQN act is written for (the published
# 5 -> 64 -> 64 -> 1 network, config.py DQNConfig).
KERNEL_DQN_HIDDEN = 64
_N_PTR, _N_CONST, _N_INT, _N_OUT = 22, 31, 14, 14
_MARKETS = {None: 0, "factored": 1, "matrix": 2}


def _configure(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.slot_fused_counts.argtypes = [ctypes.POINTER(ctypes.c_int)] * 4
    lib.slot_fused_counts.restype = i
    lib.slot_fused_scratch_vectors.argtypes = [i, i, i]
    lib.slot_fused_scratch_vectors.restype = i
    lib.slot_fused_grid.argtypes = [p, i, p]
    lib.slot_fused_grid.restype = i
    lib.slot_fused_launch.argtypes = [p, i, p, i, p, i, p]
    lib.slot_fused_launch.restype = i
    counts = [ctypes.c_int() for _ in range(4)]
    lib.slot_fused_counts(*(ctypes.byref(c) for c in counts))
    if tuple(c.value for c in counts) != (_N_PTR, _N_CONST, _N_INT, _N_OUT):
        raise RuntimeError(
            f"slot_fused.cu takes {tuple(c.value for c in counts)} (pointers, "
            f"constants, integers, outputs), the wrapper passes "
            f"{(_N_PTR, _N_CONST, _N_INT, _N_OUT)}"
        )


LIBRARY = KernelLibrary("slot_fused.cu", _configure)


class SlotRaw(NamedTuple):
    """The fused slot's per-agent results, in the order of the Pallas
    kernel's outputs: 14 [S, A] float32 tensors and decisions [S, R, A] (each
    round's heat-pump power in W)."""

    t_in: torch.Tensor
    t_bm: torch.Tensor
    soc: torch.Tensor
    hp_frac: torch.Tensor
    cost: torch.Tensor
    reward: torch.Tensor
    p_grid: torch.Tensor
    p_p2p: torch.Tensor
    q: torch.Tensor
    aux: torch.Tensor
    f_time: torch.Tensor
    f_temp: torch.Tensor
    f_bal: torch.Tensor
    f_p2p: torch.Tensor
    decisions: torch.Tensor


def _check_impl(cfg: ExperimentConfig) -> str:
    impl = cfg.train.implementation
    if impl not in ("tabular", "dqn"):
        raise ValueError(
            f"slot_step_fused supports tabular/dqn policies, got {impl!r} "
            "(ddpg advances exploration state inside act: unfused only)"
        )
    return impl


def _n_rounds(cfg: ExperimentConfig) -> int:
    return cfg.sim.rounds + 1 if cfg.sim.trading else 1


def per_scenario_learners(cfg: ExperimentConfig, pol_state, S: int, A: int) -> bool:
    """Whether the tabular or DQN state holds one learner per (scenario,
    agent), S * A of them on its leading axis, rather than A shared by every
    scenario; raises for any other count."""
    tabular = cfg.train.implementation == "tabular"
    n = pol_state.q_table.shape[0] if tabular else pol_state.online.n_agents
    if n not in (A, S * A):
        raise ValueError(
            f"slot_step_fused: the learner state holds {n} learners; a slot of "
            f"{S} scenarios of {A} agents takes {A} (shared) or {S * A} (one per scenario)"
        )
    return n != A


def _market_code(cfg: ExperimentConfig, market_impl: Optional[str]) -> int:
    """The kernel's market variant; ``None`` is the matrix negotiation, as in
    the plain version."""
    return _MARKETS[(market_impl or "matrix") if cfg.sim.trading else None]


# --- plain version -------------------------------------------------------------


@torch.no_grad()
def slot_step_fused_plain(
    cfg: ExperimentConfig,
    pol_state,
    phys_s,
    xs,
    draws,
    ratings,
    explore: bool,
    market_impl: Optional[str] = None,
    compute_dtype: Optional[torch.dtype] = None,
) -> SlotRaw:
    """The fused slot in plain PyTorch (the JAX fused kernel's body,
    pallas_slot.py:164-359); arguments as ``slot_step_fused``."""
    impl = _check_impl(cfg)
    th = cfg.thermal
    time_s, t_out_s, load_w, pv_w = xs[:4]
    S, A = load_w.shape
    inv_max_in = torch.reciprocal(ratings.max_in)
    if market_impl is None:
        market_impl = "matrix"

    balance_w = load_w - pv_w
    soc = phys_s.soc
    if cfg.battery.enabled:
        soc, balance_w = battery_rule_update(cfg.battery, soc, balance_w, cfg.sim.dt_seconds)
    norm_balance = balance_w * inv_max_in
    norm_temp = normalized_temperature(th, phys_s.t_in)
    f_time = time_s[:, None].expand(S, A)
    if explore:
        uniform, rand_action = draws
        mask = uniform < pol_state.epsilon
    # One learner per scenario: the agents of all scenarios as one [1, S * A]
    # row of learners, scenario-major.
    learners = (1, S * A) if per_scenario_learners(cfg, pol_state, S, A) else (S, A)

    def act(feat, r):
        obs = make_observation(f_time, norm_temp, norm_balance, feat)
        x = obs.reshape(*learners, obs.shape[-1])
        if impl == "tabular":
            rows = q_rows(cfg.qlearning, pol_state.q_table, x)
        else:
            rows = _q_all_actions(cfg.dqn, pol_state.online, x)
        rows = rows.reshape(S, A, -1)
        greedy = torch.argmax(rows, dim=-1)
        qv = torch.gather(rows, -1, greedy[..., None])[..., 0]
        action = greedy
        if explore:
            action = torch.where(mask[r], rand_action[r].to(greedy.dtype), greedy)
            qv = torch.where(mask[r], torch.zeros_like(qv), qv)
        frac = action_values_on(obs.device)[action]
        return frac, action.to(torch.float32), qv

    hp_power_l = []
    if not cfg.sim.trading:
        feat = torch.zeros_like(norm_balance)
        frac, aux, qv = act(feat, 0)
        hp_power_l.append(frac * th.hp_max_power)
        p_grid = balance_w + frac * th.hp_max_power
        p_p2p = torch.zeros_like(p_grid)
    elif market_impl == "factored":
        feat = torch.zeros_like(balance_w)
        frac, aux, qv = act(feat, 0)
        hp_power_l.append(frac * th.hp_max_power)
        out0 = balance_w + frac * th.hp_max_power
        if cfg.sim.rounds == 0:
            p_grid, p_p2p = clear_factored_rounds0(
                out0, compute_dtype, min_sums=merged_min_sums_plain
            )
        else:
            tot = out0.sum(dim=-1, keepdim=True)
            mean_raw = -(tot - out0) * recip(A * A)
            feat = mean_raw * inv_max_in
            frac, aux, qv = act(feat, 1)
            hp_power_l.append(frac * th.hp_max_power)
            out1 = balance_w + frac * th.hp_max_power
            p_grid, p_p2p = clear_factored_rounds1(
                out0, out1, compute_dtype, min_sums=merged_min_sums_plain
            )
    else:
        p2p = torch.zeros((S, A, A), dtype=torch.float32, device=load_w.device)
        for r in range(cfg.sim.rounds + 1):
            p2p = zero_diagonal(p2p)
            powers = -p2p.transpose(-1, -2)
            feat = powers.sum(dim=-1) * recip(A) * inv_max_in
            frac, aux, qv = act(feat, r)
            hp_power_l.append(frac * th.hp_max_power)
            out_power = balance_w + frac * th.hp_max_power
            p2p = divide_power(out_power, powers)
        p_grid, p_p2p = clear_market(p2p)

    buy, inj = grid_prices(cfg.tariff, time_s)
    trade = p2p_price_fn(buy, inj)
    cost = compute_costs(
        p_grid, p_p2p, buy[:, None], inj[:, None], trade[:, None], cfg.sim.slot_hours
    )
    penalty = comfort_penalty(th, phys_s.t_in)
    reward = -(cost + 10.0 * penalty)
    hp_power = frac * th.hp_max_power
    t_in_new, t_bm_new = thermal_step(
        th, cfg.sim.dt_seconds, t_out_s[:, None], phys_s.t_in, phys_s.t_bm, hp_power
    )
    return SlotRaw(
        t_in=t_in_new, t_bm=t_bm_new, soc=soc, hp_frac=frac, cost=cost,
        reward=reward, p_grid=p_grid, p_p2p=p_p2p, q=qv, aux=aux,
        f_time=f_time.contiguous(), f_temp=norm_temp, f_bal=norm_balance,
        f_p2p=feat, decisions=torch.stack(hp_power_l, dim=1),
    )


# --- kernel wrapper --------------------------------------------------------------


def _f32(x: float) -> float:
    return float(np.float32(x))


def slot_constants(cfg: ExperimentConfig, n_agents: int) -> Tuple[float, ...]:
    """The kernel's float32 constants, in ``slot_fused.cu``'s ``ConstArg``
    order, each rounded as the chain's tensor ops round it: a Python float
    multiplies a float32 tensor as its float32 rounding, and a division by a
    constant is a multiplication by the float32 reciprocal (``ops/_f32.py``)."""
    tar, th, bat = cfg.tariff, cfg.thermal, cfg.battery
    eta = sqrt(bat.efficiency)
    return (
        _f32(2.0 * math.pi * HOURS_PER_DAY / tar.cost_period),
        _f32(tar.cost_phase),
        _f32(tar.cost_avg),
        _f32(tar.cost_amplitude),
        recip(CENTS_PER_EURO),
        _f32(tar.injection_price),
        _f32(cfg.sim.dt_seconds),
        _f32(bat.min_soc),
        _f32(bat.max_soc),
        _f32(bat.capacity),
        eta,
        recip(eta),
        recip(bat.capacity),
        recip(eta * bat.capacity),
        recip(cfg.sim.dt_seconds),
        _f32(th.setpoint),
        recip(th.margin),
        _f32(th.lower_bound),
        _f32(th.upper_bound),
        _f32(th.hp_max_power),
        _f32(th.cop),
        _f32(1.0 / th.ci),
        _f32(1.0 / th.cm),
        recip(th.ri),
        recip(th.rvent),
        recip(th.re),
        _f32(1.0 - th.f_rad),
        _f32(th.f_rad),
        _f32(cfg.sim.slot_hours),
        recip(n_agents),
        recip(n_agents * n_agents),
    )


def _check(name: str, x: torch.Tensor, shape, device, dtype=torch.float32) -> None:
    if x.device != device or x.dtype != dtype:
        raise ValueError(
            f"slot_step_fused: {name} must be {dtype} on {device}, got {x.dtype} on {x.device}"
        )
    if tuple(x.shape) != tuple(shape):
        raise ValueError(
            f"slot_step_fused: {name} must have shape {tuple(shape)}, got {tuple(x.shape)}"
        )
    if not x.is_contiguous():
        raise ValueError(f"slot_step_fused: {name} must be contiguous")


def _kernel_ints(cfg: ExperimentConfig, impl: str, S: int, A: int, market: int,
                 explore: bool, compute_dtype: Optional[torch.dtype], per_scenario: bool):
    """The kernel's integer arguments, in ``slot_fused.cu``'s ``IntArg`` order."""
    q = cfg.qlearning
    tab = impl == "tabular"
    nt, ntp, nb, np_, nact = (
        (q.num_time_states, q.num_temp_states, q.num_balance_states, q.num_p2p_states,
         q.num_actions) if tab else (0,) * 5
    )
    return (ctypes.c_int * _N_INT)(
        S, A, _n_rounds(cfg), 0 if tab else 1, market, int(bool(explore)),
        int(cfg.battery.enabled), int(compute_dtype is not None), nt, ntp, nb, np_, nact,
        int(per_scenario),
    )


def kernel_grid(
    cfg: ExperimentConfig,
    S: int,
    A: int,
    market_impl: Optional[str] = None,
    per_scenario: bool = False,
) -> dict:
    """The cooperative grid K7 launches for this configuration at [S, A] on
    the current CUDA device, with one learner per scenario where
    ``per_scenario``: ``blocks``, ``blocks_per_sm``, ``sms`` and
    ``smem_bytes`` (shared memory per block). The kernel sizes its grid to
    what the device holds at once, or to its largest phase's work items if
    fewer."""
    market = _market_code(cfg, market_impl)
    ints = _kernel_ints(cfg, _check_impl(cfg), S, A, market, True, None, per_scenario)
    grid = (ctypes.c_int * 4)()
    err = LIBRARY.load().slot_fused_grid(ints, _N_INT, grid)
    if err != 0:
        raise RuntimeError(f"slot_step_fused grid query failed: CUDA error {err}")
    return dict(zip(("blocks", "blocks_per_sm", "sms", "smem_bytes"), grid))


def _launch_kernel(
    cfg: ExperimentConfig,
    pol_state,
    phys_s,
    xs,
    draws,
    ratings,
    explore: bool,
    market_impl: Optional[str],
    compute_dtype: Optional[torch.dtype],
) -> SlotRaw:
    impl = _check_impl(cfg)
    time_s, t_out_s, load_w = xs[:3]
    device = load_w.device
    if load_w.dim() != 2 or load_w.numel() == 0:
        raise ValueError(f"slot_step_fused: load_w must have shape [S, A], got {tuple(load_w.shape)}")
    S, A = load_w.shape
    R = _n_rounds(cfg)
    market = _market_code(cfg, market_impl)
    if compute_dtype not in (None, torch.bfloat16):
        raise ValueError(f"slot_step_fused: compute_dtype must be None or bfloat16, got {compute_dtype}")
    if market == 1 and cfg.sim.rounds > 1:
        raise ValueError("slot_step_fused: the factored clearing needs rounds <= 1")
    vec = (S, A)
    for name, x, shape in (
        ("time", time_s, (S,)), ("t_out", t_out_s, (S,)), ("load_w", load_w, vec),
        ("pv_w", xs[3], vec), ("t_in", phys_s.t_in, vec), ("t_bm", phys_s.t_bm, vec),
        ("soc", phys_s.soc, vec), ("hp_frac", phys_s.hp_frac, vec),
        ("max_in", ratings.max_in, (A,)), ("epsilon", pol_state.epsilon, ()),
    ):
        _check(name, x, shape, device)
    uniform = rand = None
    if explore:
        uniform, rand = draws
        _check("uniform", uniform, (R, S, A), device)
        rand = rand.to(torch.int64)
        _check("randint", rand, (R, S, A), device, torch.int64)
    q_table = None
    weights = (None,) * 6
    per_scenario = per_scenario_learners(cfg, pol_state, S, A)
    L = S * A if per_scenario else A
    if impl == "tabular":
        q = cfg.qlearning
        if q.num_actions != 3:
            raise ValueError(f"slot_step_fused: the kernel takes 3 actions, got {q.num_actions}")
        q_table = pol_state.q_table
        _check("q_table", q_table, (
            L, q.num_time_states, q.num_temp_states, q.num_balance_states,
            q.num_p2p_states, q.num_actions,
        ), device)
    else:
        net = pol_state.online
        h = KERNEL_DQN_HIDDEN
        weights = (
            net.Dense_0.kernel, net.Dense_0.bias, net.Dense_1.kernel,
            net.Dense_1.bias, net.Dense_2.kernel, net.Dense_2.bias,
        )
        names = ("Dense_0.kernel", "Dense_0.bias", "Dense_1.kernel", "Dense_1.bias",
                 "Dense_2.kernel", "Dense_2.bias")
        for name, w, shape in zip(
            names, weights, ((L, 5, h), (L, h), (L, h, h), (L, h), (L, h, 1), (L, 1)),
        ):
            _check(name, w, shape, device)
        # The kernel copies each agent's weights in 16-byte pieces.
        for name, w in zip(names[:5], weights[:5]):
            if w.data_ptr() % 16:
                raise ValueError(f"slot_step_fused: {name} must be 16-byte aligned")
    lib = LIBRARY.load()
    out = torch.empty((_N_OUT, S, A), dtype=torch.float32, device=device)
    decisions = torch.empty((S, R, A), dtype=torch.float32, device=device)
    # The per-agent vectors between the kernel's phases, and the matrix
    # clearing's sums per block of 32 columns: [S, A] planes, never an
    # [S, A, A] matrix.
    scratch = torch.empty(
        (lib.slot_fused_scratch_vectors(R, A, market), S, A), dtype=torch.float32, device=device
    )
    ptr = lambda x: None if x is None else x.data_ptr()
    ptrs = (ctypes.c_void_p * _N_PTR)(*(
        ptr(x) for x in (
            time_s, t_out_s, load_w, xs[3], phys_s.t_in, phys_s.t_bm, phys_s.soc,
            phys_s.hp_frac, ratings.max_in, uniform, rand, pol_state.epsilon,
            q_table, *weights, out, decisions, scratch,
        )
    ))
    consts = (ctypes.c_float * _N_CONST)(*slot_constants(cfg, A))
    ints = _kernel_ints(cfg, impl, S, A, market, explore, compute_dtype, per_scenario)
    launch(
        "slot_step_fused", device, lib.slot_fused_launch,
        ptrs, _N_PTR, consts, _N_CONST, ints, _N_INT,
    )
    return SlotRaw(*out.unbind(0), decisions)


def slot_raw(
    cfg: ExperimentConfig,
    pol_state,
    phys_s,
    xs,
    draws,
    ratings,
    explore: bool,
    market_impl: Optional[str] = None,
    compute_dtype: Optional[torch.dtype] = None,
) -> SlotRaw:
    """The fused slot's raw results: the kernel on CUDA tensors (counted in
    ``slot_step_fused.launches``), the plain version on CPU tensors."""
    if xs[2].device.type != "cuda":
        return slot_step_fused_plain(
            cfg, pol_state, phys_s, xs, draws, ratings, explore, market_impl, compute_dtype
        )
    raw = _launch_kernel(
        cfg, pol_state, phys_s, xs, draws, ratings, explore, market_impl, compute_dtype
    )
    count_launch(slot_step_fused)
    return raw


def assemble_outputs(cfg: ExperimentConfig, phys_s, xs, ratings, raw: SlotRaw):
    """(phys', SlotOutputs, SlotTransition) from the raw results, with the
    chain's formulas (pallas_slot.py:528-563)."""
    from p2pmicrogrid_tpu_torch.envs.community import PhysState, SlotOutputs, SlotTransition

    th = cfg.thermal
    time_s, _, _, _, next_time_s, next_load_w, next_pv_w = xs
    buy, inj = grid_prices(cfg.tariff, time_s)
    trade = p2p_price_fn(buy, inj)
    obs = make_observation(raw.f_time, raw.f_temp, raw.f_bal, raw.f_p2p)
    next_temp = phys_s.t_in if cfg.sim.stale_next_temp else raw.t_in
    next_balance = (next_load_w - next_pv_w) * torch.reciprocal(ratings.max_in)
    next_obs = make_observation(
        next_time_s[:, None],
        normalized_temperature(th, next_temp),
        next_balance,
        torch.zeros_like(next_balance),
    )
    phys = PhysState(t_in=raw.t_in, t_bm=raw.t_bm, soc=raw.soc, hp_frac=raw.hp_frac)
    outputs = SlotOutputs(
        cost=raw.cost,
        reward=raw.reward,
        loss=torch.zeros_like(raw.reward),
        p_grid=raw.p_grid,
        p_p2p=raw.p_p2p,
        buy_price=buy,
        injection_price=inj,
        trade_price=trade,
        t_in=phys_s.t_in,
        hp_power_w=raw.decisions[:, -1],
        decisions=raw.decisions,
        q=raw.q,
    )
    transition = SlotTransition(obs=obs, aux=raw.aux, reward=raw.reward, next_obs=next_obs)
    return phys, outputs, transition


def slot_step_fused(
    cfg: ExperimentConfig,
    pol_state,
    phys_s,
    xs,
    draws,
    ratings,
    explore: bool,
    market_impl: Optional[str] = None,
    compute_dtype: Optional[torch.dtype] = None,
):
    """One fused training slot over a scenario batch.

    ``xs`` is the chain's 7-tuple of slot inputs (leading scenario axis),
    ``pol_state`` the tabular or DQN learners, A of them shared by every
    scenario or S * A, one per scenario (scenario-major), which one launch
    serves alike, ``phys_s`` the [S, A] physical carries, ``draws`` the ``(uniform,
    randint)`` exploration draws [R, S, A] (ignored when ``explore`` is
    false), ``ratings`` as tensors on the state's device. ``market_impl``
    must be the RESOLVED implementation ("factored" | "matrix"; None is
    "matrix"; ignored without trading); ``compute_dtype`` the factored
    clearing's narrow dtype (``torch.bfloat16``, or None for float32).

    Returns ``(phys', outputs, transition)``, shaped as the unfused chain's.
    """
    raw = slot_raw(
        cfg, pol_state, phys_s, xs, draws, ratings, explore, market_impl, compute_dtype
    )
    return assemble_outputs(cfg, phys_s, xs, ratings, raw)


slot_step_fused.launches = 0


def slot_step_fused_single(
    cfg: ExperimentConfig,
    pol_state,
    phys,
    xs,
    draws,
    ratings,
    explore: bool,
):
    """One fused slot of one community (JAX source pallas_slot.py:566-604):
    the [A] state lifted to a one-scenario batch, the round draws ``draws``
    (each [R, A], as the single chain passes each round's draws straight to
    the act, or None greedy) lifted to [R, 1, A], the matrix negotiation
    (the only market the single chain implements; K7 at [1, A] on the card),
    then squeezed. Returns ``slot_dynamics``' (phys', outputs, transition),
    [A]-shaped."""
    from p2pmicrogrid_tpu_torch.envs.community import lift, lift_slot_inputs, squeeze

    phys1, outputs1, tr1 = slot_step_fused(
        cfg, pol_state, lift(phys), lift_slot_inputs(xs),
        None if draws is None else tuple(d[:, None] for d in draws),
        ratings, explore, market_impl="matrix",
    )
    return squeeze(phys1), squeeze(outputs1), squeeze(tr1)
