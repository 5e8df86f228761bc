from modelcompression_tpu_torch.utils.logging import MetricsLogger
from modelcompression_tpu_torch.utils.profiling import StepTimer, nan_check
from modelcompression_tpu_torch.utils.timing import time_fn

__all__ = ["MetricsLogger", "StepTimer", "nan_check", "time_fn"]
