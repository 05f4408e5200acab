from agents_tpu_torch.policies.actor_policy import ActorPolicy
from agents_tpu_torch.policies.policy import Policy
from agents_tpu_torch.policies.q_policy import CategoricalQPolicy, QPolicy
from agents_tpu_torch.policies.wrappers import (EpsilonGreedyPolicy,
                                                GreedyPolicy)

__all__ = ["ActorPolicy", "CategoricalQPolicy", "EpsilonGreedyPolicy",
           "GreedyPolicy", "Policy", "QPolicy"]
