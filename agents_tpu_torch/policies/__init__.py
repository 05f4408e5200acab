from agents_tpu_torch.policies.policy import Policy
from agents_tpu_torch.policies.q_policy import CategoricalQPolicy, QPolicy
from agents_tpu_torch.policies.wrappers import (EpsilonGreedyPolicy,
                                                GreedyPolicy)

__all__ = ["CategoricalQPolicy", "EpsilonGreedyPolicy", "GreedyPolicy",
           "Policy", "QPolicy"]
