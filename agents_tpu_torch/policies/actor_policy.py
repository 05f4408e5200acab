"""Actor policy: actor network -> distribution -> PolicyStep.

Port of `ActorPolicy` of ``agents_tpu/policies/actor_policy.py`` (:16-39).
`params` at act time is the actor network module; with an
`observation_normalizer`, it may instead be ``{"network": module,
"normalizer": normalizer state}``, and the observation is normalized
before the network sees it. `action` samples each leaf of the actor's
distribution nest in turn from the draw site "actor_noise" (the JAX
policy splits its key once per leaf, policy.py:94-97), then clips into
the action spec; `GreedyPolicy(ActorPolicy(...))` acts with the
distributions' modes.

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
               info_spec=(), observation_normalizer=None, clip: bool = True):
    super().__init__(time_step_spec, action_spec, info_spec=info_spec,
                     state_spec=actor_network.state_spec, clip=clip)
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
    action = nest_utils.tree_map(
        lambda d: d.sample(draws, site=ACTOR_NOISE_SITE), dstep.action,
        is_leaf=lambda d: hasattr(d, "sample"))
    return ps.PolicyStep(action=action, state=dstep.state, info=dstep.info)


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
