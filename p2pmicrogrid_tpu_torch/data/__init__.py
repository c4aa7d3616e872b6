"""Host-side data: traces (numpy) and the SQLite results store."""

from p2pmicrogrid_tpu_torch.data.results import ResultsStore, save_eval_outputs
from p2pmicrogrid_tpu_torch.data.traces import (
    TESTING_DAYS,
    TRAINING_DAYS,
    VALIDATION_DAYS,
    TraceSet,
    agent_profiles,
    load_reference_db,
    next_slot,
    synthetic_traces,
    train_validation_test_split,
)

__all__ = [
    "TESTING_DAYS",
    "TRAINING_DAYS",
    "VALIDATION_DAYS",
    "ResultsStore",
    "TraceSet",
    "agent_profiles",
    "load_reference_db",
    "next_slot",
    "save_eval_outputs",
    "synthetic_traces",
    "train_validation_test_split",
]
