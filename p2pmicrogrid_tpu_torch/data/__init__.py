"""Host-side trace data (numpy)."""

from p2pmicrogrid_tpu_torch.data.traces import (
    TraceSet,
    agent_profiles,
    next_slot,
    synthetic_traces,
)

__all__ = ["TraceSet", "agent_profiles", "next_slot", "synthetic_traces"]
