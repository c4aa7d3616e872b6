"""What the card says about a training run's program.

The port of the JAX package's ``telemetry/profiling.py``. The JAX package
reads XLA's ``cost_analysis``/``memory_analysis`` of its compiled episode
(flops, bytes accessed, buffer sizes); torch has no counterpart, so those
gauges are not ported (ROADMAP.md, Queue 1, item 7). What the port records
instead is what the card can state:

* a captured CUDA graph's node count (``cuGraphGetNodes`` on the graph that
  ``parallel/graph.py`` keeps) and its private pool's bytes;
* the device's peak allocated bytes so far;
* the hand-written kernels' launches per episode (the wrappers' counts).

``profile_training`` logs them as ``profile.<label>.*`` gauges and one
``compile_profile`` event. As in the JAX package it is gated by an attached
telemetry and the ``P2P_PROFILE=0`` switch, and never raises: profiling must
not stop a training run (callers that need the gauges check for them).
"""

from __future__ import annotations

import ctypes
import os
from typing import Dict, Optional

import torch


def profiling_enabled() -> bool:
    """Profiling switch (``P2P_PROFILE=0`` disables)."""
    return os.environ.get("P2P_PROFILE", "").lower() not in ("0", "off", "false")


def graph_node_count(graph) -> Optional[int]:
    """Nodes of a kept ``torch.cuda.CUDAGraph`` (driver API), or None."""
    try:
        raw = graph.raw_cuda_graph()
        lib = ctypes.CDLL("libcuda.so.1")
        n = ctypes.c_size_t(0)
        rc = lib.cuGraphGetNodes(ctypes.c_void_p(raw), None, ctypes.byref(n))
        return int(n.value) if rc == 0 else None
    except Exception:  # noqa: BLE001 — profiling is best-effort
        return None


def training_metrics(captured=None, launches: Optional[Dict[str, int]] = None) -> dict:
    """The metrics of one episode's program: ``graph_nodes`` and
    ``graph_pool_bytes`` of ``captured`` (a ``graph.Captured``), the card's
    ``peak_allocated_bytes``, and ``kernel_launches`` (the sum of
    ``launches``, {kernel: launches an episode}) with one
    ``launches.<kernel>`` entry each."""
    out: dict = {}
    if captured is not None:
        nodes = graph_node_count(captured.graph)
        if nodes is not None:
            out["graph_nodes"] = float(nodes)
        out["graph_pool_bytes"] = float(captured.pool_bytes)
        out["graph_capture_seconds"] = float(captured.capture_seconds)
    if torch.cuda.is_initialized():
        out["peak_allocated_bytes"] = float(torch.cuda.max_memory_allocated())
    if launches is not None:
        out["kernel_launches"] = float(sum(launches.values()))
        for name, n in launches.items():
            out[f"launches.{name}"] = float(n)
    return out


def profile_training(
    label: str,
    telemetry=None,
    captured=None,
    launches: Optional[Dict[str, int]] = None,
    extra: Optional[dict] = None,
) -> dict:
    """Log ``training_metrics`` as ``profile.<label>.<metric>`` gauges and
    one ``compile_profile`` event (``extra`` rides on the event). Returns
    the metrics; {} when profiling is off or anything fails."""
    if telemetry is None or not profiling_enabled():
        return {}
    try:
        metrics = training_metrics(captured, launches)
        for name, value in metrics.items():
            telemetry.gauge(f"profile.{label}.{name}", value)
        telemetry.event("compile_profile", label=label, **metrics, **(extra or {}))
        return metrics
    except Exception:  # noqa: BLE001 — profiling must never break the run
        return {}
