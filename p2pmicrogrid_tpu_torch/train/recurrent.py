"""Day-granular training for the recurrent (LSTM) DDPG actor.

The port of the JAX package's ``train/recurrent.py``. The recurrent variant
is the reference's day-episodic design (``models/ddpg_recurrent.py``): the
critic values a WHOLE day and learning happens once a day.

* **Rollouts run the real physics.** Each episode is one day of the
  synthetic October traces the slot-level trainers use
  (``data.synthetic_traces`` -> ``build_episode_arrays``), stepped through
  the env's own pieces (``grid_prices``, ``make_observation``,
  ``normalized_temperature``, ``compute_costs``, ``comfort_penalty``,
  ``thermal_step``) at the no-com granularity: grid-only settlement and a
  zero p2p feature, the ``trading=False`` branch of the slot. The per-slot
  forward is ``recurrent_actor_step``, the function the serving engine
  runs, so a trained bundle serves the policy that was trained.
* **Learning is episodic** (``recurrent_ddpg_learn``) over the [A]-agent
  batch of day sequences. Exploration is the reference's OU noise
  (``models/ddpg.py::ou_step``, the JAX step's rounding), its normals drawn
  per day on the device or injected (``RecurrentDraws``).
* **No host sync inside a day.** The 96 slots write preallocated device
  buffers; the day's three progress scalars (loss, mean reward, cost) come
  back in one read per day, as the JAX trainer reads them.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from p2pmicrogrid_tpu_torch.config import ExperimentConfig
from p2pmicrogrid_tpu_torch.data.traces import SLOTS_PER_DAY, synthetic_traces
from p2pmicrogrid_tpu_torch.device import resolve_device
from p2pmicrogrid_tpu_torch.envs.community import (
    AgentRatings,
    EpisodeArrays,
    PhysState,
    build_episode_arrays,
    init_physical,
    make_ratings,
    ratings_to,
)
from p2pmicrogrid_tpu_torch.models.ddpg import ou_step
from p2pmicrogrid_tpu_torch.models.ddpg_recurrent import (
    RecurrentActor,
    RecurrentDDPGState,
    recurrent_actor_init_hidden,
    recurrent_actor_step,
    recurrent_ddpg_init,
    recurrent_ddpg_learn,
)
from p2pmicrogrid_tpu_torch.ops.market import compute_costs
from p2pmicrogrid_tpu_torch.ops.obs import make_observation
from p2pmicrogrid_tpu_torch.ops.tariff import grid_prices, p2p_price
from p2pmicrogrid_tpu_torch.ops.thermal import (
    comfort_penalty,
    normalized_temperature,
    thermal_step,
)


class DayRollout(NamedTuple):
    """One day under the recurrent actor, agent-major for the learner."""

    obs_seq: torch.Tensor     # [A, T, 4]
    act_seq: torch.Tensor     # [A, T, 1]
    reward_seq: torch.Tensor  # [A, T]
    cost_eur: torch.Tensor    # [] community day cost
    phys: PhysState           # end-of-day physical state
    hidden: torch.Tensor      # [A, H] end-of-day actor carry


class RecurrentDraws(NamedTuple):
    """Every random draw of a ``train_recurrent_community`` run.

    normals: [2, A] the initial (t_in, t_bm) standard normals
    ou_normals: [episodes, T, A] each day's OU noise normals, slot by slot
    """

    normals: torch.Tensor
    ou_normals: torch.Tensor


@torch.no_grad()
def rollout_day(
    cfg: ExperimentConfig,
    actor: RecurrentActor,
    phys: PhysState,
    day: EpisodeArrays,
    ratings: AgentRatings,
    ou_normals: Optional[torch.Tensor] = None,
    explore: bool = True,
    hidden: Optional[torch.Tensor] = None,
) -> DayRollout:
    """Step one day's slots under the recurrent actor (grid-only / no-com
    settlement), threading the flat LSTM carry exactly like serving does.

    ``day``: one day's arrays [T, ...] on the actor's device; ``ratings``
    as tensors there; ``ou_normals`` [T, A] the OU step's normals (needed
    when ``explore``). ``hidden=None`` starts from the fresh carry (zeros),
    the re-init a serving session eviction applies."""
    th = cfg.thermal
    dev = day.load_w.device
    T, A = day.load_w.shape
    if explore and (ou_normals is None or tuple(ou_normals.shape) != (T, A)):
        raise ValueError(f"an exploring rollout needs ou_normals of shape {(T, A)}")
    if hidden is None:
        hidden = recurrent_actor_init_hidden((A,), actor.lstm_features, device=dev)
    inv_max_in = torch.reciprocal(ratings.max_in)
    ou = torch.zeros((A,), dtype=torch.float32, device=dev)
    obs_t = torch.empty((T, A, 4), dtype=torch.float32, device=dev)
    act_t = torch.empty((T, A), dtype=torch.float32, device=dev)
    rew_t = torch.empty((T, A), dtype=torch.float32, device=dev)
    cost_t = torch.empty((T, A), dtype=torch.float32, device=dev)
    for t in range(T):
        buy, inj = grid_prices(cfg.tariff, day.time[t])
        balance_w = day.load_w[t] - day.pv_w[t]
        norm_balance = balance_w * inv_max_in
        obs = make_observation(
            day.time[t], normalized_temperature(th, phys.t_in), norm_balance,
            torch.zeros_like(norm_balance),
        )  # [A, 4]
        action, hidden = recurrent_actor_step(actor, obs, hidden)
        if explore:
            # OU exploration per slot (rl_backup.py:65-85), clipped back to
            # [0, 1].
            ou = ou_step(cfg.ddpg, ou, ou_normals[t])
            action = torch.clamp(action + ou, 0.0, 1.0)
        hp_power = action * th.hp_max_power
        p_grid = balance_w + hp_power
        cost = compute_costs(
            p_grid, torch.zeros_like(p_grid), buy, inj, p2p_price(buy, inj), cfg.sim.slot_hours
        )
        reward = -(cost + 10.0 * comfort_penalty(th, phys.t_in))
        t_in, t_bm = thermal_step(
            th, cfg.sim.dt_seconds, day.t_out[t], phys.t_in, phys.t_bm, hp_power
        )
        phys = PhysState(t_in=t_in, t_bm=t_bm, soc=phys.soc, hp_frac=action)
        obs_t[t], act_t[t], rew_t[t], cost_t[t] = obs, action, reward, cost
    return DayRollout(
        obs_seq=obs_t.transpose(0, 1).contiguous(),
        act_seq=act_t.transpose(0, 1)[..., None].contiguous(),
        reward_seq=rew_t.transpose(0, 1).contiguous(),
        cost_eur=cost_t.sum(),
        phys=phys,
        hidden=hidden,
    )


def _day_arrays(arrays: EpisodeArrays, d: int) -> EpisodeArrays:
    """Day ``d``'s slice of a multi-day episode array set."""
    s = slice(d * SLOTS_PER_DAY, (d + 1) * SLOTS_PER_DAY)
    return EpisodeArrays(*(a[s] for a in arrays))


class RecurrentTrainResult(NamedTuple):
    state: RecurrentDDPGState
    day_rewards: np.ndarray   # [episodes] mean day reward per agent
    day_costs: np.ndarray     # [episodes] community day cost [€]
    losses: np.ndarray        # [episodes - 1] critic loss per learn step


def train_recurrent_community(
    cfg: ExperimentConfig,
    episodes: int,
    generator: Optional[torch.Generator] = None,
    traces=None,
    telemetry=None,
    state: Optional[RecurrentDDPGState] = None,
    draws: Optional[RecurrentDraws] = None,
    device="cuda",
) -> RecurrentTrainResult:
    """Train the recurrent day-granular DDPG on the community physics.

    One episode = one day (cycled over the trace set's days). Day ``e``
    learns from day ``e-1``'s rollout with day ``e``'s observations as the
    bootstrapped next-day sequence. ``state`` (default: ``recurrent_ddpg_init``
    from ``generator``) updates in place. ``draws`` replaces ``generator``
    for the initial temperatures and the OU normals; otherwise they come
    from ``generator`` (a ``torch.Generator`` on ``device``): the initial
    normals, then each day's [T, A] OU normals before its rollout.
    ``telemetry`` gets one ``recurrent_progress`` event a day.
    """
    if episodes < 2:
        raise ValueError(f"episodes must be >= 2 (TD needs a next day), got {episodes}")
    if draws is None and generator is None:
        raise ValueError("train_recurrent_community needs a torch.Generator or RecurrentDraws")
    dev = resolve_device(device)
    if traces is None:
        traces = synthetic_traces()
    ratings_np = make_ratings(cfg, np.random.default_rng(cfg.train.seed))
    ratings = ratings_to(ratings_np, dev)
    arrays = build_episode_arrays(cfg, traces, ratings_np, device=dev)
    n_days = arrays.time.shape[0] // SLOTS_PER_DAY
    if n_days < 1:
        raise ValueError("trace set shorter than one day")
    A = cfg.sim.n_agents
    if state is None:
        state = recurrent_ddpg_init(cfg.ddpg, generator, dev)
    if draws is not None:
        normals = draws.normals.to(dev)
    else:
        normals = torch.randn((2, A), generator=generator, device=dev)
    phys = init_physical(cfg, normals, device=dev)

    day_rewards, day_costs, losses = [], [], []
    prev: Optional[DayRollout] = None
    nan = torch.full((), float("nan"), device=dev)
    for ep in range(episodes):
        day = _day_arrays(arrays, ep % n_days)
        if draws is not None:
            ou = draws.ou_normals[ep].to(dev)
        else:
            ou = torch.randn((SLOTS_PER_DAY, A), generator=generator, device=dev)
        ro = rollout_day(cfg, state.actor, phys, day, ratings, ou)
        phys = ro.phys
        loss = nan
        if prev is not None:
            state, loss = recurrent_ddpg_learn(
                cfg.ddpg, state, prev.obs_seq, prev.act_seq, prev.reward_seq.sum(dim=-1), ro.obs_seq
            )
        # host-sync: the day's three progress scalars in one read.
        loss_h, mean_r, cost = torch.stack(
            [loss, ro.reward_seq.sum(dim=-1).mean(), ro.cost_eur]
        ).tolist()
        if prev is not None:
            losses.append(loss_h)
        day_rewards.append(mean_r)
        day_costs.append(cost)
        if telemetry is not None:
            telemetry.event(
                "recurrent_progress", episode=ep,
                day_reward=round(mean_r, 4), day_cost_eur=round(cost, 4),
            )
        prev = ro
    return RecurrentTrainResult(
        state=state,
        day_rewards=np.asarray(day_rewards, dtype=np.float32),
        day_costs=np.asarray(day_costs, dtype=np.float32),
        losses=np.asarray(losses, dtype=np.float32),
    )


def recurrent_checkpoint_dir(model_dir: str, setting: str) -> str:
    from p2pmicrogrid_tpu_torch.train.checkpoint import checkpoint_dir

    return checkpoint_dir(model_dir, setting, "ddpg_recurrent")


def save_recurrent_checkpoint(
    model_dir: str, cfg: ExperimentConfig, state: RecurrentDDPGState, episode: int
) -> str:
    """Persist under the standard ``models_ddpg_recurrent/<setting>`` layout
    (``train/checkpoint.py``, the JAX package's tree layout), so a bundle
    export resolves it like any other checkpoint
    (``serve/export.py::export_bundle_from_checkpoint``)."""
    from p2pmicrogrid_tpu_torch.train.checkpoint import save_checkpoint

    return save_checkpoint(
        recurrent_checkpoint_dir(model_dir, cfg.setting), state, episode, cfg=cfg
    )
