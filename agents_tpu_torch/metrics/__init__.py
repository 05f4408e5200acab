from agents_tpu_torch.metrics import torch_metrics
from agents_tpu_torch.metrics.torch_metrics import standard_collect_metrics

__all__ = ["standard_collect_metrics", "torch_metrics"]
