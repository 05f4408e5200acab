from agents_tpu_torch.metrics import export_utils, py_metrics, torch_metrics
from agents_tpu_torch.metrics.torch_metrics import (AverageReturnMultiMetric,
                                                    ChosenActionHistogram,
                                                    MaxReturnMetric,
                                                    MinReturnMetric,
                                                    standard_collect_metrics)

__all__ = ["AverageReturnMultiMetric", "ChosenActionHistogram",
           "MaxReturnMetric", "MinReturnMetric", "export_utils",
           "py_metrics", "standard_collect_metrics", "torch_metrics"]
