"""Serving layer: exported policy bundles + batched greedy inference on the card.

The port of the JAX package's ``serve/``. Each 15-minute slot every
household needs a greedy heat-pump action from the trained policy given its
observation:

* ``export``     freeze a learner state's (or a checkpoint's) GREEDY
                 parameters into a versioned policy bundle (manifest + npz),
                 float32, float16 or int8, in the JAX package's format.
* ``engine``     load a bundle and serve ``act(obs_batch)`` through
                 power-of-two padding buckets, one CUDA graph each, with
                 per-household sessions and a microbatching queue.
* ``continuous`` the slot-level continuous-batching front, and for
                 recurrent bundles (``ddpg_recurrent``) the hidden-state ring.
* ``registry``   multi-bundle routing table keyed by manifest config_hash:
                 atomic hot-swap, percentage-split A/B, household pinning.
* ``gateway``    the network front: asyncio HTTP/1.1 (and the multiplexed
                 wire) bridging remote households into a front, with
                 admission control and drain-before-close.
* ``wire``       the persistent multiplexed transport.
* ``auth``       HMAC-signed per-household bearer tokens and TLS helpers.
* ``router``     the fleet tier: consistent-hash routing of households over
                 N gateway replicas (probes, retry, failover, pins, the
                 two-phase fleet swap), ``LocalFleet`` (in-process
                 replicas) and the fleet bench.
* ``faults``     deterministic, seed-driven fault injection (kill/restart,
                 stall, 500s, drops, corruption).
* ``procfleet``  ``serve-gateway`` subprocess replicas under a relaunch
                 supervisor.
* ``proxy``      the router as a standalone proxy process
                 (``serve-router``).

``loadgen`` (open-loop arrivals, the SLO bench), ``promotion`` (the gate
and the canary) and ``autopilot`` (unattended retrain, gate and canary
cycles over a fleet) are imported from their modules.
"""

from p2pmicrogrid_tpu_torch.serve.auth import (
    AuthError,
    TokenAuthenticator,
    client_ssl_context,
    ensure_test_certs,
    generate_secret,
    load_secret,
    load_secret_chain,
    mint_token,
    rotate_secret,
    server_ssl_context,
    verify_token,
)
from p2pmicrogrid_tpu_torch.serve.continuous import ContinuousBatcher
from p2pmicrogrid_tpu_torch.serve.engine import (
    MicroBatchQueue,
    PolicyEngine,
    Sessions,
)
from p2pmicrogrid_tpu_torch.serve.export import (
    BUNDLE_FORMAT_VERSION,
    EXPORT_DTYPES,
    calibration_obs,
    export_bundle_from_checkpoint,
    export_policy_bundle,
    greedy_params,
    load_policy_bundle,
)
from p2pmicrogrid_tpu_torch.serve.gateway import (
    AdmissionConfig,
    GatewayServer,
    ServeGateway,
    build_bundle,
    build_gateway,
    build_registry,
    make_bundle_factory,
)
from p2pmicrogrid_tpu_torch.serve.faults import (
    FaultEvent,
    FaultInjector,
    FaultPlan,
    FaultSchedule,
    kill_restart_plan,
)
from p2pmicrogrid_tpu_torch.serve.procfleet import ProcessFleet
from p2pmicrogrid_tpu_torch.serve.proxy import ProxyServer, RouterProxy
from p2pmicrogrid_tpu_torch.serve.registry import BundleRegistry, ServingBundle
from p2pmicrogrid_tpu_torch.serve.router import (
    ConsistentHashRing,
    FleetRouter,
    FleetSwapError,
    LocalFleet,
    NoHealthyReplicas,
    Replica,
    RouterResult,
    run_fleet_loadgen,
    serve_bench_fleet,
)
from p2pmicrogrid_tpu_torch.serve.wire import (
    MuxConnection,
    MuxPool,
    SyncMuxProbe,
    WireProtocolError,
    encode_frame,
    read_frame,
)

__all__ = [
    "AdmissionConfig",
    "AuthError",
    "BUNDLE_FORMAT_VERSION",
    "BundleRegistry",
    "ConsistentHashRing",
    "ContinuousBatcher",
    "EXPORT_DTYPES",
    "FaultEvent",
    "FaultInjector",
    "FaultPlan",
    "FaultSchedule",
    "FleetRouter",
    "FleetSwapError",
    "GatewayServer",
    "LocalFleet",
    "MicroBatchQueue",
    "MuxConnection",
    "MuxPool",
    "NoHealthyReplicas",
    "PolicyEngine",
    "ProcessFleet",
    "ProxyServer",
    "Replica",
    "RouterProxy",
    "RouterResult",
    "ServeGateway",
    "ServingBundle",
    "Sessions",
    "SyncMuxProbe",
    "TokenAuthenticator",
    "WireProtocolError",
    "build_bundle",
    "build_gateway",
    "build_registry",
    "calibration_obs",
    "client_ssl_context",
    "encode_frame",
    "ensure_test_certs",
    "export_bundle_from_checkpoint",
    "export_policy_bundle",
    "generate_secret",
    "greedy_params",
    "kill_restart_plan",
    "load_policy_bundle",
    "load_secret",
    "load_secret_chain",
    "make_bundle_factory",
    "mint_token",
    "read_frame",
    "rotate_secret",
    "run_fleet_loadgen",
    "serve_bench_fleet",
    "server_ssl_context",
    "verify_token",
]
