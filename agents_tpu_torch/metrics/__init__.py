from agents_tpu_torch.metrics import py_metrics, torch_metrics
from agents_tpu_torch.metrics.torch_metrics import standard_collect_metrics

__all__ = ["py_metrics", "standard_collect_metrics", "torch_metrics"]
