"""Digests of the port's seed-0 draws on the CPU, pinned.

A checkpoint carries a generator's state, and the greedy evaluation's
held-out scenarios are drawn from a seed on the CPU, so a seeded draw must
come out the same under every torch version the port runs with (the card's
machine and the test machine differ). ``seed0_digests`` hashes three such
draws, each from ``torch.Generator().manual_seed(0)`` on the CPU: the shared
DDPG actor and critic (``ddpg_params_init``, the truncated-normal init of
``models/networks.py``), the synthetic traces (numpy), and
``parallel/device_gen.py::draw_traces``. ``PINNED`` holds their values; the
tests and ``chip_smoke.py`` hold every machine to them.

``recurrent_init_digest`` hashes the seed-0 recurrent DDPG init
(``models/ddpg_recurrent.py``), whose orthogonal kernels go through a QR
factorisation: LAPACK builds may round it differently, so it is pinned
apart (``PINNED_RECURRENT``) and ``chip_smoke.py`` reports whether a machine
draws it, without failing on it.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

PINNED = {
    "ddpg_actor_critic": "4c86ff49d7f48ca1",
    "synthetic_traces": "7513ad2a272373a3",
    "draw_traces": "0e290f338e899a27",
}

PINNED_RECURRENT = "1ba0d87172a97d97"


def _digest(arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()[:16]


def seed0_digests() -> dict:
    """{draw: sha256 prefix} of the three seed-0 draws, on the CPU."""
    from p2pmicrogrid_tpu_torch.config import DDPGConfig
    from p2pmicrogrid_tpu_torch.data.traces import synthetic_traces
    from p2pmicrogrid_tpu_torch.models.ddpg import ddpg_params_init
    from p2pmicrogrid_tpu_torch.parallel.device_gen import draw_traces

    params = ddpg_params_init(
        DDPGConfig(share_across_agents=True), 128, torch.Generator().manual_seed(0), device="cpu"
    )
    nets = [t.detach().numpy() for net in (params.actor, params.critic) for t in net.parameters()]
    tr = synthetic_traces()
    draws = draw_traces(8, torch.Generator().manual_seed(0), device="cpu")
    return {
        "ddpg_actor_critic": _digest(nets),
        "synthetic_traces": _digest((tr.time, tr.t_out, tr.load, tr.pv, tr.day)),
        "draw_traces": _digest(x.numpy() for x in draws),
    }


def recurrent_init_digest() -> str:
    """sha256 prefix of the seed-0 recurrent actor and critic, on the CPU,
    drawn on one thread: the float64 QR's last bits depend on LAPACK's
    blocking, which follows the thread count, and one entry of one kernel
    rounds to another float32 between 1 and 8 threads."""
    from p2pmicrogrid_tpu_torch.config import DDPGConfig
    from p2pmicrogrid_tpu_torch.models.ddpg_recurrent import recurrent_ddpg_init

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        state = recurrent_ddpg_init(DDPGConfig(), torch.Generator().manual_seed(0), device="cpu")
    finally:
        torch.set_num_threads(threads)
    return _digest(t.detach().numpy() for net in (state.actor, state.critic) for t in net.parameters())
