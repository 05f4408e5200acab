from agents_tpu_torch.bandits.metrics.bandit_metrics import (
    ConstraintViolationsMetric,
    DistanceFromGreedyMetric,
    RegretMetric,
    SuboptimalArmsMetric,
)

__all__ = [
    "ConstraintViolationsMetric", "DistanceFromGreedyMetric",
    "RegretMetric", "SuboptimalArmsMetric",
]
