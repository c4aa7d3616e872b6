"""Typed experiment configuration.

A copy of the JAX package's dataclasses with the same class names, fields and
defaults, so ``repr(cfg)`` and therefore ``config_hash`` (sha256 of the repr)
agree between the two packages. Every default matches the reference value,
cited per field. Where a comment below speaks of TPU or Pallas behaviour it
describes the JAX package; the port's resolution of the "auto" fields is in
``envs/community.py`` (``resolve_market_impl``, ``resolve_market_dtype``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

# --- Time base (reference: setup.py:8-16) ---
SECONDS_PER_MINUTE = 60
MINUTES_PER_HOUR = 60
SECONDS_PER_HOUR = SECONDS_PER_MINUTE * MINUTES_PER_HOUR
HOURS_PER_DAY = 24
CENTS_PER_EURO = 100
KWH_TO_WS = 1e3 * SECONDS_PER_HOUR


@dataclass(frozen=True)
class TariffConfig:
    """Grid tariff: sinusoidal time-of-use buy price, flat injection price.

    Reference: setup.py:21-25 (constants), agent.py:59-67 (price curve).
    """

    cost_avg: float = 12.0          # c€/kWh           (setup.py:21)
    cost_amplitude: float = 5.0     # c€/kWh           (setup.py:22)
    cost_period: float = 12.0       # hours            (setup.py:23)
    cost_phase: float = 3.0         # radians          (setup.py:24)
    injection_price: float = 0.07   # €/kWh            (setup.py:25)


@dataclass(frozen=True)
class ThermalConfig:
    """2R2C thermal building model + heat pump.

    Reference: heating.py:23-29 (RC parameters), heating.py:90-104,158-163
    (setpoint, margin, heat pump), community.py:226 (cop=3, max 3 kW).
    """

    ci: float = 2.44e6 * 2          # indoor-air heat capacity, J/K     (heating.py:23)
    cm: float = 9.4e7               # building-mass heat capacity, J/K  (heating.py:24)
    ri: float = 8.64e-4             # indoor<->mass resistance, K/W     (heating.py:25)
    re: float = 1.05e-2             # mass<->outdoor resistance, K/W    (heating.py:26)
    rvent: float = 7.98e-3          # ventilation resistance, K/W       (heating.py:27)
    ga: float = 11.468              # solar aperture, m^2               (heating.py:28)
    f_rad: float = 0.3              # radiative fraction of HP heat     (heating.py:29)
    setpoint: float = 21.0          # °C                                (community.py:226)
    margin: float = 1.0             # comfort half-band, °C             (heating.py:90)
    cop: float = 3.0                # heat-pump COP                     (community.py:226)
    hp_max_power: float = 3e3       # heat-pump electrical max, W       (community.py:226)
    init_temp_std: float = 0.3      # heterogeneous T0 spread, °C       (heating.py:101-104)

    @property
    def lower_bound(self) -> float:
        return self.setpoint - self.margin

    @property
    def upper_bound(self) -> float:
        return self.setpoint + self.margin


@dataclass(frozen=True)
class BatteryConfig:
    """Battery storage with sqrt-efficiency charge/discharge accounting.

    Reference: storage.py:36-76,108-116. The shipped reference experiments
    instantiate ``NoStorage`` (community.py:225); set ``enabled=False`` for
    exact parity, ``enabled=True`` to activate the modelled-but-dormant asset.
    """

    enabled: bool = False
    capacity: float = 10e3 * 3600.0  # Ws (10 kWh)
    peak_power: float = 5e3          # W
    min_soc: float = 0.1
    max_soc: float = 0.9
    efficiency: float = 0.9
    init_soc: float = 0.5            # reset value (storage.py:73)


@dataclass(frozen=True)
class AgentPopulationConfig:
    """Per-agent heterogeneous ratings.

    Reference: community.py:210-228 — load rating ~ N(0.7, 0.2) kW, PV rating
    ~ N(4, 0.2) kW, scaled x1e3 to W; max_in = max(rating)*safety*1e3.

    ``max_out`` in the reference is ``-(max_power + safety*1e3)``
    (community.py:228) which is almost certainly a typo for ``*``; we use the
    multiplicative form (SURVEY.md section 7 "bugs to not copy").
    """

    load_rating_mean: float = 0.7    # kW   (community.py:210)
    load_rating_std: float = 0.2
    pv_rating_mean: float = 4.0      # kW   (community.py:211)
    pv_rating_std: float = 0.2
    safety: float = 1.1              # (community.py:217)


@dataclass(frozen=True)
class QLearningConfig:
    """Tabular Q-learning actor.

    Reference: rl.py:56-74 (table shape, gamma, alpha), agent.py:257-268
    (20 bins per dim, epsilon=0.81, decay 0.9), rl.py:131-132 (epsilon floor).
    """

    num_time_states: int = 20
    num_temp_states: int = 20
    num_balance_states: int = 20
    num_p2p_states: int = 20
    num_actions: int = 3
    gamma: float = 0.9               # (rl.py:59)
    alpha: float = 1e-5              # (rl.py:60)
    epsilon: float = 0.81            # (agent.py:264)
    epsilon_decay: float = 0.9       # (agent.py:264)
    epsilon_floor: float = 0.1       # (rl.py:132)


@dataclass(frozen=True)
class DQNConfig:
    """DQN actor + trainer.

    Reference: rl.py:135-148 (64-64-1 state-action Q-net), agent.py:306-311
    (buffer 5000, batch 32, gamma 0.95, tau 0.005, Adam 1e-5), rl.py:152
    (epsilon 0.1, decay 0.9), rl.py:329 (first-layer grad clip to [-1, 1]).
    """

    hidden: int = 64
    buffer_size: int = 5000
    batch_size: int = 32
    gamma: float = 0.95
    tau: float = 0.005
    learning_rate: float = 1e-5
    # The reference instantiates ActorModel(1) (agent.py:304), overriding the
    # class default of 0.1 — exploration starts fully random.
    epsilon: float = 1.0
    epsilon_decay: float = 0.9
    grad_clip_first_layer: float = 1.0
    warmup_passes: int = 5           # init_buffers full passes (community.py:126)


@dataclass(frozen=True)
class DDPGConfig:
    """Continuous-action actor-critic with Ornstein-Uhlenbeck exploration.

    Capability represented by the reference's stale rl_backup.py (LSTM
    actor/critic + OU noise, rl_backup.py:14-85,95-103); re-designed here as a
    feed-forward actor-critic over the same 4-feature observation.
    """

    actor_hidden: int = 64
    critic_hidden: int = 64
    buffer_size: int = 10000         # (rl_backup.py:95)
    batch_size: int = 128            # (rl_backup.py:96)
    gamma: float = 0.95
    tau: float = 0.005               # (rl_backup.py:99)
    actor_lr: float = 1e-4
    critic_lr: float = 2e-4          # critic x2 actor lr (rl.py:596-597)
    ou_theta: float = 0.1            # (rl_backup.py:100)
    ou_sigma: float = 0.1            # (rl_backup.py:101)
    ou_dt: float = 1e-2              # (rl_backup.py:66)
    ou_init_sd: float = 1.0          # (rl_backup.py:102)
    # Multiplicative decay of the OU exploration noise applied on the
    # reference's decay cadence (every min_episodes_criterion episodes, like
    # the epsilon schedules). OU noise has a nonzero stationary variance, so
    # without annealing exploration never stops; 1.0 (default) keeps the
    # original always-on behaviour.
    noise_decay: float = 1.0
    # Shared-parameter scenario training only (parallel/scenarios.py): one
    # actor-critic shared by ALL agents instead of per-agent copies — the
    # "shared-critic MARL" of BASELINE.md config 4. Per-agent tiny MLPs run
    # as A vmapped [S, 4] matmuls; agent-shared runs one [S*A, 4] matmul,
    # which is what actually fills the MXU at 1000 agents.
    share_across_agents: bool = False
    # Scale actor/critic lrs down automatically with the pooled update batch
    # (batch_size * n_scenarios * n_agents in agent-shared mode): at the
    # defaults the pooled update over-drives the critic and training diverges
    # once the pool is large (measured, artifacts/LEARNING_chunked_r03.json).
    # The rule lives in parallel/scenarios.py:auto_scale_ddpg_lrs and applies
    # only to shared-parameter scenario training; explicit --actor-lr /
    # --critic-lr on the CLI disables it.
    lr_auto_scale: bool = True
    # Freeze the actor (params and its optimizer) for the first N critic
    # updates while the critic calibrates on the exploration data — delayed
    # policy updates, gated on the critic's Adam step count inside the
    # compiled program. 0 (default) disables. Measured at 1000 agents
    # (round 4): an unlucky init's cost excursion is INVARIANT to this
    # delay (identical trajectories at 0/2/5 episodes of delay) — the knob
    # exists as a standard stabilizer for new configurations, not as a
    # default (artifacts/LEARNING_northstar_seeds_r04.json).
    actor_delay_updates: int = 0
    # Cap on the transition batch consumed by ONE agent-shared scenario-pooled
    # gradient step (parallel/scenarios.py:_ddpg_update_shared). The pooled
    # update reads batch_size*S*A transitions per slot — 512k at the north
    # star — and its HBM traffic (activations of both nets, fwd+bwd) scales
    # linearly with that pool, making learning half the slot time at A=1000.
    # When the pool exceeds the cap, the update instead gathers `cap` uniform
    # (slot, scenario, agent) samples straight from the replay rings — an
    # unbiased minibatch estimator of the same pooled gradient (the
    # reference's own update is a 128-transition replay sample,
    # rl_backup.py:96; the cap keeps ours 256x that). The pooled-batch lr
    # rule keys on the EFFECTIVE (capped) batch, so capping also raises the
    # auto-scaled lrs back toward the measured-stable 32k anchor
    # (artifacts/lr_probe_a100.json). None disables (full pooled update).
    # Default 32768: measured stable across 3 seeds at the 1000-agent
    # north-star proxy AND removes the unlucky-seed cost excursion the
    # uncapped update showed (artifacts/LEARNING_cap_probe_r04.json); 8192
    # is faster still but showed a late instability on one seed.
    learn_batch_cap: Optional[int] = 32768

    def __post_init__(self):
        if self.learn_batch_cap is not None and self.learn_batch_cap <= 0:
            raise ValueError(
                f"learn_batch_cap must be positive or None, "
                f"got {self.learn_batch_cap!r}"
            )


@dataclass(frozen=True)
class ForecastConfig:
    """Windowed load/PV forecaster (reference: microgrid/ml.py).

    Window input_width = shift = label_width = 3 (ml.py:198-201); model
    Dense(20)-Dense(100)-LSTM(100)x2(shared)-Dense(20)-Dense(2, sigmoid)
    (ml.py:209-229); MSE + Adam 1e-4, 200 epochs (ml.py:245-284, batches of
    32 via tf.data default).
    """

    input_width: int = 3
    label_width: int = 3
    shift: int = 3
    hidden_pre: int = 20
    hidden_mid: int = 100
    lstm_features: int = 100
    hidden_post: int = 20
    n_targets: int = 2
    learning_rate: float = 1e-4
    batch_size: int = 32
    epochs: int = 200


@dataclass(frozen=True)
class SimConfig:
    """Simulation time base and community shape.

    Reference: setup.py:16 (15-minute slots), setup.py:33-36 (community knobs).
    """

    time_slot_minutes: int = 15      # (setup.py:16)
    n_agents: int = 2                # (setup.py:33)
    rounds: int = 1                  # negotiation rounds (setup.py:34)
    homogeneous: bool = False        # (setup.py:35)
    n_scenarios: int = 1             # Monte-Carlo scenario batch (TPU-native axis)
    # The reference's "no-com" thesis settings (e.g. 2-multi-agent-no-com-homo,
    # data_analysis.py:1324-1330) were produced by code edits not shipped;
    # here no-communication communities are a first-class knob: False means
    # no P2P negotiation or trading — every agent settles with the grid.
    trading: bool = True
    # Fused Pallas kernels for the negotiation/market matrix passes
    # (ops/pallas_market.py). Exact to float tolerance vs the jnp path.
    # None (default) = auto: on for the scenario-batched path on TPU (+39%
    # at 1000 agents x 64 scenarios, measured round 2), off elsewhere
    # (non-TPU backends would run them in the slow interpreter). True/False
    # forces the choice.
    use_pallas: Optional[bool] = None
    # Reference quirk (agent.py:293-296, community.py:161): the next-state
    # observation reuses the *current* indoor temperature (assets step after
    # training) and a zero p2p signal. True = replicate; False = use the
    # advanced temperature.
    stale_next_temp: bool = True
    # Storage dtype for the [S, A, A] negotiation/market proposal matrices in
    # the scenario-batched Pallas path. The matrices dominate HBM traffic at
    # large A; "bfloat16" halves it (~0.4% relative precision on Watt-scale
    # proposals — compute stays f32 in VMEM, only the carried matrix is
    # compressed). Default keeps full precision.
    # Storage dtype of the batched [S, A, A] negotiation matrices — the
    # dominant HBM stream at large A. "auto" (default) resolves to bfloat16
    # on the fused-Pallas TPU path at n_agents >= 256 (measured ~f32-accurate,
    # tests/test_pallas.py; halves the matrix traffic) and float32 everywhere
    # else; compute is always f32 in VMEM. Resolution:
    # envs/community.py:resolve_market_dtype.
    market_dtype: str = "auto"
    # Fused per-slot Pallas megakernel (ops/pallas_slot.py): the whole slot
    # — obs build, tabular/DQN policy act, market clearing, battery +
    # thermal integration — as ONE kernel with VMEM-resident carries,
    # replacing the per-slot chain of small fusions. None (default)
    # resolves to False (the unfused chain stays the committed-seed
    # reference; the megakernel's TPU capture is ROADMAP measurement
    # debt); True opts in (tabular/dqn only — validated at resolution,
    # envs/community.py:resolve_use_fused). Same-seed bit-exact vs the
    # chain on the interpret-mode CPU path (tests/test_pallas_slot.py).
    fused_slot: Optional[bool] = None
    # Negotiation/clearing implementation for the scenario-batched path
    # (envs/community.py:slot_dynamics_batched):
    #   "matrix"   — materialize the [S, A, A] proposal matrices (jnp ops or
    #                the fused Pallas kernels per use_pallas).
    #   "factored" — matrix-free clearing (ops/factored_market.py): O(A^2)
    #                fused VPU compute over O(A)-memory vectors, exploiting
    #                the rank-1 row structure the default one-round
    #                negotiation guarantees; requires rounds <= 1.
    #   "auto"     — factored wherever it applies on the fused TPU path
    #                (trading, rounds <= 1, same condition as the Pallas
    #                kernels), matrix elsewhere. The CPU/host paths keep the
    #                matrix implementation so every committed CPU-measured
    #                artifact (golden traces, convergence metric) stays
    #                bit-identical.
    market_impl: str = "auto"
    # lax.scan unroll factor for the 96-slot episode scan. Small communities
    # are bound by per-scan-iteration kernel overheads (~0.1-0.4 ms/slot on
    # TPU), which unrolling amortizes; large batched configs are
    # bandwidth-bound and gain nothing while paying compile time. The inner
    # negotiation scan (rounds+1 <= 3 iterations) is always fully unrolled.
    slot_unroll: int = 1

    def __post_init__(self):
        if self.market_dtype not in ("auto", "float32", "bfloat16"):
            raise ValueError(
                f"market_dtype must be 'auto', 'float32' or 'bfloat16', "
                f"got {self.market_dtype!r}"
            )
        if self.market_impl not in ("auto", "matrix", "factored"):
            raise ValueError(
                f"market_impl must be 'auto', 'matrix' or 'factored', "
                f"got {self.market_impl!r}"
            )
        if self.market_impl == "factored" and self.rounds > 1:
            raise ValueError(
                "market_impl='factored' requires rounds <= 1 (the matrix-"
                "free clearing exploits the rank-1 structure of the one-"
                "round negotiation); use 'matrix' or 'auto' for more rounds"
            )

    @property
    def slots_per_day(self) -> int:
        return HOURS_PER_DAY * MINUTES_PER_HOUR // self.time_slot_minutes

    @property
    def dt_seconds(self) -> float:
        return float(self.time_slot_minutes * SECONDS_PER_MINUTE)

    @property
    def slot_hours(self) -> float:
        return self.time_slot_minutes / MINUTES_PER_HOUR


@dataclass(frozen=True)
class TrainConfig:
    """Outer training-loop knobs (reference: setup.py:29-32, community.py:272-298)."""

    max_episodes: int = 1000         # (setup.py:30)
    starting_episodes: int = 0       # (setup.py:29)
    min_episodes_criterion: int = 50 # stats/decay window (setup.py:31)
    save_episodes: int = 50          # checkpoint cadence (setup.py:32)
    seed: int = 42                   # (setup.py:26)
    implementation: str = "tabular"  # 'tabular' | 'dqn' | 'ddpg' (setup.py:36)
    episodes_per_jit_block: int = 1  # episodes fused into one jitted call


@dataclass(frozen=True)
class ExperimentConfig:
    """Top-level bundle; ``setting`` mirrors the reference's experiment-identity
    string (community.py:423) so results stay comparable."""

    sim: SimConfig = SimConfig()
    tariff: TariffConfig = TariffConfig()
    thermal: ThermalConfig = ThermalConfig()
    battery: BatteryConfig = BatteryConfig()
    population: AgentPopulationConfig = AgentPopulationConfig()
    qlearning: QLearningConfig = QLearningConfig()
    dqn: DQNConfig = DQNConfig()
    ddpg: DDPGConfig = DDPGConfig()
    forecast: ForecastConfig = ForecastConfig()
    train: TrainConfig = TrainConfig()

    @property
    def setting(self) -> str:
        """Experiment-identity string (community.py:423). The no-com variant
        follows the reference's result-data naming, which omits the round
        count (data_analysis.py:1324-1330)."""
        s = self.sim
        hom = "homo" if s.homogeneous else "hetero"
        if not s.trading:
            return f"{s.n_agents}-multi-agent-no-com-{hom}"
        return f"{s.n_agents}-multi-agent-com-rounds-{s.rounds}-{hom}"

    def replace(self, **kwargs) -> "ExperimentConfig":
        return dataclasses.replace(self, **kwargs)


def default_config(**overrides) -> ExperimentConfig:
    """Build an ExperimentConfig, overriding nested fields by keyword.

    Accepts top-level section overrides, e.g.
    ``default_config(sim=SimConfig(n_agents=10))``.
    """
    return ExperimentConfig(**overrides)
