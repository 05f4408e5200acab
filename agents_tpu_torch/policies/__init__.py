from agents_tpu_torch.policies.actor_policy import (ActorPolicy,
                                                   DeterministicActorPolicy)
from agents_tpu_torch.policies.policy import Policy
from agents_tpu_torch.policies.q_policy import CategoricalQPolicy, QPolicy
from agents_tpu_torch.policies.random_policy import RandomPolicy
from agents_tpu_torch.policies.wrappers import (EpsilonGreedyPolicy,
                                                GaussianPolicy, GreedyPolicy,
                                                OUNoisePolicy)

__all__ = ["ActorPolicy", "CategoricalQPolicy", "DeterministicActorPolicy",
           "EpsilonGreedyPolicy", "GaussianPolicy", "GreedyPolicy",
           "OUNoisePolicy", "Policy", "QPolicy", "RandomPolicy"]
