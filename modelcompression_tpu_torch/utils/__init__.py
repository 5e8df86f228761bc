from modelcompression_tpu_torch.utils.logging import MetricsLogger
from modelcompression_tpu_torch.utils.profiling import (
    StepTimer, nan_check, trace,
)
from modelcompression_tpu_torch.utils.timing import time_fn

__all__ = ["MetricsLogger", "StepTimer", "nan_check", "trace", "time_fn"]
