from agents_tpu_torch.metrics import export_utils, py_metrics, torch_metrics
from agents_tpu_torch.metrics.torch_metrics import (
    AverageEpisodeLengthMetric, AverageReturnMetric, AverageReturnMultiMetric,
    ChosenActionHistogram, DequeState, EnvironmentSteps, MaxReturnMetric,
    Metric, MinReturnMetric, NumberOfEpisodes, standard_collect_metrics)

__all__ = ["AverageEpisodeLengthMetric", "AverageReturnMetric",
           "AverageReturnMultiMetric", "ChosenActionHistogram", "DequeState",
           "EnvironmentSteps", "MaxReturnMetric", "Metric", "MinReturnMetric",
           "NumberOfEpisodes", "export_utils", "py_metrics",
           "standard_collect_metrics", "torch_metrics"]
