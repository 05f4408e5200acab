"""Actor policy: actor network -> distribution -> PolicyStep.

Port of `ActorPolicy` of ``agents_tpu/policies/actor_policy.py`` (:16-39).
`params` at act time is the actor network module; with an
`observation_normalizer`, it may instead be ``{"network": module,
"normalizer": normalizer state}``, and the observation is normalized
before the network sees it. `action` samples each leaf of the actor's
distribution nest in turn from the draw site "actor_noise" (the JAX
policy splits its key once per leaf, policy.py:94-97), then clips into
the action spec; `GreedyPolicy(ActorPolicy(...))` acts with the
distributions' modes. With `emit_log_probability`, the step's info holds
the sampled action's log-probability summed over the leaves
(`policy_step.PolicyInfo`), as the JAX policy's does (policy.py:99-106);
`training` is accepted and, as in the JAX package, changes nothing.

`DeterministicActorPolicy` (:42-62), for DDPG and TD3 actors that emit
actions directly: `action` ignores the draws, and `distribution` is a
`Deterministic` at the action with one event dim, so `GreedyPolicy` over
it acts the same.
"""
from __future__ import annotations

from agents_tpu_torch import distributions as dist_lib
from agents_tpu_torch.policies.policy import Policy
from agents_tpu_torch.trajectories import policy_step as ps
from agents_tpu_torch.utils import nest_utils

ACTOR_NOISE_SITE = "actor_noise"


class ActorPolicy(Policy):

  def __init__(self, time_step_spec, action_spec, actor_network,
               info_spec=(), observation_normalizer=None,
               training: bool = False, emit_log_probability: bool = False,
               clip: bool = True):
    del training    # as in the JAX package, the policy acts the same
    super().__init__(time_step_spec, action_spec, info_spec=info_spec,
                     state_spec=actor_network.state_spec,
                     emit_log_probability=emit_log_probability, clip=clip)
    self.actor_network = actor_network
    self.observation_normalizer = observation_normalizer

  def _distribution(self, params, time_step, state):
    obs = time_step.observation
    if self.observation_normalizer is not None and isinstance(params, dict):
      norm_state = params.get("normalizer")
      if norm_state is not None:
        obs = self.observation_normalizer.normalize(norm_state, obs)
        params = params["network"]
    dist, new_state = params(obs, time_step.step_type, state)
    return ps.PolicyStep(action=dist, state=new_state, info=())

  def _action(self, params, time_step, state, draws):
    dstep = self._distribution(params, time_step, state)
    is_dist = lambda d: hasattr(d, "sample")  # noqa: E731
    action = nest_utils.tree_map(
        lambda d: d.sample(draws, site=ACTOR_NOISE_SITE), dstep.action,
        is_leaf=is_dist)
    info = dstep.info
    if self.emit_log_probability:
      lps = nest_utils.flatten(nest_utils.tree_map(
          lambda d, a: d.log_prob(a), dstep.action, action, is_leaf=is_dist))
      info = ps.set_log_probability(info, sum(lps[1:], lps[0]))
    return ps.PolicyStep(action=action, state=dstep.state, info=info)


class DeterministicActorPolicy(Policy):

  def __init__(self, time_step_spec, action_spec, actor_network,
               clip: bool = True):
    super().__init__(time_step_spec, action_spec,
                     state_spec=actor_network.state_spec, clip=clip)
    self.actor_network = actor_network

  def _action(self, params, time_step, state, draws):
    del draws
    action, new_state = params(time_step.observation, time_step.step_type,
                               state)
    return ps.PolicyStep(action=action, state=new_state, info=())

  def _distribution(self, params, time_step, state):
    action, new_state = params(time_step.observation, time_step.step_type,
                               state)
    return ps.PolicyStep(action=dist_lib.Deterministic(action, event_ndims=1),
                         state=new_state, info=())
