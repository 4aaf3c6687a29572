"""The training engine: configuration, state, the step and the study
metrics (`byzantinemomentum_tpu/engine/`)."""

from byzantinemomentum_tpu_torch.engine.config import DTYPES, EngineConfig
from byzantinemomentum_tpu_torch.engine.metrics import (
    FAULT_COLUMNS, FORENSIC_COLUMNS, HEALTH_COLUMNS, RECOVERY_COLUMNS,
    STUDY_COLUMNS)
from byzantinemomentum_tpu_torch.engine.state import TrainState
from byzantinemomentum_tpu_torch.engine.step import Engine

__all__ = ["DTYPES", "EngineConfig", "Engine", "TrainState", "STUDY_COLUMNS",
           "FAULT_COLUMNS", "RECOVERY_COLUMNS", "FORENSIC_COLUMNS",
           "HEALTH_COLUMNS"]
