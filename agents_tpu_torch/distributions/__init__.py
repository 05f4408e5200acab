from agents_tpu_torch.distributions.distributions import Categorical

__all__ = ["Categorical"]
