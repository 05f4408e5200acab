from agents_tpu_torch.policies.actor_policy import (ActorPolicy,
                                                   DeterministicActorPolicy)
from agents_tpu_torch.policies.cem_policy import CEMPolicy
from agents_tpu_torch.policies.cem_samplers import (ActionsSampler,
                                                    ConcatenatedSampler,
                                                    GaussianContinuousSampler,
                                                    GaussianHybridSampler,
                                                    GaussianOneHotSampler)
from agents_tpu_torch.policies.policy import Policy, clip_to_spec
from agents_tpu_torch.policies.q_policy import CategoricalQPolicy, QPolicy
from agents_tpu_torch.policies.random_policy import (FixedPolicy,
                                                     RandomPolicy,
                                                     ScriptedPolicy)
from agents_tpu_torch.policies.wrappers import (BoltzmannPolicy,
                                                EpsilonGreedyPolicy,
                                                GaussianPolicy, GreedyPolicy,
                                                OUNoisePolicy)

__all__ = ["ActionsSampler", "ActorPolicy", "BoltzmannPolicy", "CEMPolicy",
           "CategoricalQPolicy", "ConcatenatedSampler",
           "DeterministicActorPolicy",
           "EpsilonGreedyPolicy", "FixedPolicy", "GaussianContinuousSampler",
           "GaussianHybridSampler", "GaussianOneHotSampler", "GaussianPolicy",
           "GreedyPolicy", "OUNoisePolicy", "Policy", "QPolicy",
           "RandomPolicy", "ScriptedPolicy", "clip_to_spec"]
