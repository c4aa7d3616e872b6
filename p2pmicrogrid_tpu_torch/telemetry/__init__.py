"""Telemetry of the port: run-scoped metric sinks, spans, device counters.

The JAX package's names for what is ported (``registry.py`` with
``SqliteSink``, ``spans.py``, ``device_metrics.py``, ``async_drain.py``,
``profiling.py``). Not ported: ``dc_psum``/``dc_mesh_sum`` (the mesh,
ROADMAP.md, Queue 1, item 7). ``tracing.py`` (the serving fronts' trace
context) and ``report.py`` (``telemetry-report``) are imported by module.
"""

from p2pmicrogrid_tpu_torch.telemetry.async_drain import (
    AsyncDrain,
    resolve_host,
    start_host_copy,
)
from p2pmicrogrid_tpu_torch.telemetry.device_metrics import (
    DeviceCounters,
    SlotTally,
    dc_add,
    dc_add_,
    dc_from_slot,
    dc_from_tally,
    dc_reset_,
    dc_tally_slot_,
    dc_to_dict,
    dc_zero,
    replay_fill_fraction,
)
from p2pmicrogrid_tpu_torch.telemetry.profiling import (
    profile_training,
    profiling_enabled,
    training_metrics,
)
from p2pmicrogrid_tpu_torch.telemetry.registry import (
    JsonlSink,
    MemorySink,
    SqliteSink,
    StdoutSink,
    Telemetry,
    config_hash,
    current,
    git_rev,
    guarded_stdout_sink,
    phase_timings,
    run_manifest,
    set_current,
)
from p2pmicrogrid_tpu_torch.telemetry.spans import Span, SpanRecorder

__all__ = [
    "AsyncDrain",
    "resolve_host",
    "start_host_copy",
    "DeviceCounters",
    "SlotTally",
    "dc_add",
    "dc_add_",
    "dc_from_slot",
    "dc_from_tally",
    "dc_reset_",
    "dc_tally_slot_",
    "dc_to_dict",
    "dc_zero",
    "replay_fill_fraction",
    "profile_training",
    "profiling_enabled",
    "training_metrics",
    "phase_timings",
    "JsonlSink",
    "MemorySink",
    "SqliteSink",
    "StdoutSink",
    "Telemetry",
    "config_hash",
    "current",
    "git_rev",
    "guarded_stdout_sink",
    "run_manifest",
    "set_current",
    "Span",
    "SpanRecorder",
]
